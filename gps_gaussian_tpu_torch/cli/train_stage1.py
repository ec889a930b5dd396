"""Stage-1 disparity pretraining (counterpart of the root train_stage1.py).

    python -m gps_gaussian_tpu_torch.cli.train_stage1 \
        --config configs/stage1.yaml --data_root /path/to/data \
        [--exp_dir experiments/run1] [--device cpu]

Data-parallel over N cards: `torchrun --nproc_per_node N -m
gps_gaussian_tpu_torch.cli.train_stage1 ...` (the batch size must divide
by N).
"""

from gps_gaussian_tpu_torch.cli.common import train_main


def main(argv=None):
    return train_main("stage1", "configs/stage1.yaml", argv)


if __name__ == "__main__":
    main()
