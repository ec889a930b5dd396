"""Stage-2 end-to-end training (counterpart of the root train_stage2.py).

    python -m gps_gaussian_tpu_torch.cli.train_stage2 \
        --config configs/stage2.yaml --data_root /path/to/data \
        --stage1_ckpt experiments/s1/ckpt [--device cpu]

Data-parallel over N cards: `torchrun --nproc_per_node N -m
gps_gaussian_tpu_torch.cli.train_stage2 ...` (the batch size must divide
by N).
"""

from gps_gaussian_tpu_torch.cli.common import train_main


def main(argv=None):
    return train_main("stage2", "configs/stage2.yaml", argv)


if __name__ == "__main__":
    main()
