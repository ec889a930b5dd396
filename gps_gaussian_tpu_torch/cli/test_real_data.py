"""Fixed-ratio sequence rendering (counterpart of the root
test_real_data.py): every frame of a capture from one novel viewpoint.

    python -m gps_gaussian_tpu_torch.cli.test_real_data \
        --config configs/stage2.yaml --test_data_root /path/to/seq \
        --ckpt_path experiments/s2/ckpt --ratio 0.5 --src_view 0 1

Under `torchrun --nproc_per_node N -m ...` with `--shard_render`, each
view's tile rows are split over the N ranks.
"""

import logging
from pathlib import Path

from gps_gaussian_tpu_torch.cli.common import infer_parser, load_test_renderer


def main(argv=None):
    ap = infer_parser()
    ap.add_argument("--ratio", type=float, default=0.5)
    ap.add_argument("--out_dir", default="test_out")
    args = ap.parse_args(argv)
    renderer, _, writes = load_test_renderer(args)

    from gps_gaussian_tpu_torch.utils.images import write_image

    out = Path(args.out_dir)
    if writes:
        out.mkdir(parents=True, exist_ok=True)
    for name, img in renderer.infer_sequence(args.ratio):
        if writes:
            write_image(out / f"{name}_novel.jpg", img)
            logging.info("rendered %s", name)


if __name__ == "__main__":
    main()
