"""Free-view interpolation (counterpart of the root test_view_interp.py):
render N novel viewpoints per frame between the two source cameras.

    python -m gps_gaussian_tpu_torch.cli.test_view_interp \
        --config configs/stage2.yaml --test_data_root /path/to/data \
        --ckpt_path experiments/s2/ckpt --novel_view_nums 5 --src_view 0 1

Under `torchrun --nproc_per_node N -m ...` with `--shard_render`, each
view's tile rows are split over the N ranks.
"""

import logging
from pathlib import Path

from gps_gaussian_tpu_torch.cli.common import infer_parser, load_test_renderer


def main(argv=None):
    ap = infer_parser()
    ap.add_argument("--novel_view_nums", type=int, default=5)
    ap.add_argument("--out_dir", default="interp_out")
    args = ap.parse_args(argv)
    renderer, dataset, writes = load_test_renderer(args)

    from gps_gaussian_tpu_torch.utils.images import write_image

    out = Path(args.out_dir)
    if writes:
        out.mkdir(parents=True, exist_ok=True)
    for idx in range(len(dataset)):
        images = renderer.infer_static(idx, n_views=args.novel_view_nums)
        if not writes:
            continue
        name = dataset.scans[idx]
        for i, img in enumerate(images):
            write_image(out / f"{name}_novel{i}.jpg", img)
        logging.info("rendered %s (%d views)", name, len(images))


if __name__ == "__main__":
    main()
