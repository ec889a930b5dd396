#!/usr/bin/env python
"""Drive the PyTorch port (gps_gaussian_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, one line of output each:
  1. build   - compile every CUDA kernel of the serving path from csrc/
  2. kernel  - hold each kernel to its plain PyTorch version on a
               silhouette scene (bench.py build_scene) rendered at 512^2
  3. oracle  - the full rasterizer on the GPU against the exact O(pixels x N)
               oracle on a small scene
  4. serving - the free-view serving path at the configs/stage2.yaml width:
               seeded random weights, bf16 convolutions, a 1024^2 stereo pair
               with ~20% silhouette foreground, one stereo forward and three
               2048^2 novel views; the launch counts are zeroed just before
               and read just after
  5. main-shape kernel check - each kernel against its plain version on the
               inputs the serving path gave it, with its time and its bound
With --profile DIR, one more frame (the forward and one view) runs under
torch.profiler after phase 4: it prints the device busy share of that frame
and writes every kernel's device time to DIR/profile.txt.
Then the card's name and power limit, one JSON line describing each kernel,
and last `{"ok": true, "device": {...}}`. Any failed check raises, so the
script exits non-zero and prints no result; it also fails without a GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from gps_gaussian_tpu_torch.geometry import cameras
from gps_gaussian_tpu_torch.infer.freeview import FreeviewRenderer
from gps_gaussian_tpu_torch.kernels import build
from gps_gaussian_tpu_torch.kernels.rasterizer import (
    RasterizeConfig, compact_gaussian_inputs, rasterize)
from gps_gaussian_tpu_torch.kernels.rasterizer.composite import (
    composite_fwd, composite_fwd_plain)
from gps_gaussian_tpu_torch.kernels.rasterizer.pair_sort import (
    sort_pairs, stack_rows)
from gps_gaussian_tpu_torch.kernels.rasterizer.preprocess import \
    project_gaussians
from gps_gaussian_tpu_torch.kernels.rasterizer.reference import \
    composite_reference
from gps_gaussian_tpu_torch.models.layers import init_weights
from gps_gaussian_tpu_torch.testing import (build_scene, scene_camera,
                                            silhouette_stereo_batch)
from gps_gaussian_tpu_torch.train.config import load_config
from gps_gaussian_tpu_torch.train.trainer import make_model
from gps_gaussian_tpu_torch.utils.containers import FlatGaussians

# configs/stage2.yaml written out, so the run needs no PyYAML
# (tests/test_torch_port_package.py holds the two equal)
STAGE2_OVERRIDES = dict(
    name="gps_tpu_stage2", stage="stage2", batch_size=2, lr=0.0002,
    wdecay=0.00001, num_steps=100000,
    raft=dict(mixed_precision=True, train_iters=3, val_iters=3,
              encoder_dims=[32, 48, 96], hidden_dims=[96, 96, 96]),
    gsnet=dict(encoder_dims=[32, 48, 96], decoder_dims=[48, 64, 96],
               parm_head_dim=32),
    raster=dict(max_tiles_per_gaussian=16, max_per_tile=4096, fg_cap=600000,
                pair_budget=6291456),
    dataset=dict(src_res=1024, use_hr_img=True, use_processed_data=True,
                 num_workers=4),
    record=dict(loss_freq=100, eval_freq=2000))

SEED = 1314
TOL = 1e-5            # kernel vs plain version, rgb and T
ORACLE_TOL = 1e-4     # tiled rasterizer vs the exact oracle
# H100 SXM published peaks (dense): HBM bytes/s and f32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per walked (pair, pixel) in composite_fwd.cu, expf as one:
# dx dy (2), power (9), exp and opacity (2), clamp (1), the two include
# tests (2), 1 - alpha and test_T (2), the T_EPS test (1), w (1), rgb (6)
OPS_PER_EVAL = 25


def sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def kernel_inputs(gauss, camera, rcfg, view: int = 0):
    """The (props, start, count) that rasterize() gives composite_fwd for
    one view, rebuilt from the same public steps."""
    if rcfg.fg_cap is not None:
        (xyz, rot, scale, opacity, rgb, valid), _ = \
            compact_gaussian_inputs(gauss, 0, rcfg.fg_cap)
    else:
        xyz, rot, scale, opacity, rgb, valid = (
            gauss.xyz[0], gauss.rot[0], gauss.scale[0], gauss.opacity[0],
            gauss.rgb[0], gauss.valid[0])
    p = project_gaussians(xyz, rot, scale, opacity, rgb, valid,
                          camera.view[view], camera.proj[view],
                          camera.tanfovx[view], camera.tanfovy[view],
                          camera.height, camera.width)
    stacked = stack_rows(p.mean2d, p.conic, p.opacity, p.color, p.depth,
                         p.radius)[None]
    props, start, count, _, _ = sort_pairs(
        stacked, camera.height, camera.width, rcfg.max_tiles_per_gaussian,
        rcfg.max_per_tile, rcfg.pair_budget)
    return props, start, count


def compare_composite(props, start, count, tiles_y, tiles_x):
    """Kernel vs plain on the same inputs: (max abs err rgb, T, work)."""
    launches = build.LAUNCHES.get("composite_fwd", 0)
    out_k = composite_fwd(props, start, count, tiles_y, tiles_x)
    out_p, work = composite_fwd_plain(props, start, count, tiles_y, tiles_x,
                                      return_work=True)
    torch.cuda.synchronize()
    build.LAUNCHES["composite_fwd"] = launches  # comparisons do not count
    err_rgb = float((out_k[..., :3] - out_p[..., :3]).abs().max())
    err_t = float((out_k[..., 3] - out_p[..., 3]).abs().max())
    return err_rgb, err_t, int(work)


def phase_build() -> dict:
    t0 = time.perf_counter()
    path, log = build.build("composite_fwd")
    secs = time.perf_counter() - t0
    ptxas = " | ".join(ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "smem" in ln)
    print(f"[build] composite_fwd.cu -> {path.name} in {secs:.2f} s; "
          f"ptxas: {ptxas}", flush=True)
    return {"build_s": secs}


def phase_kernel(dev) -> dict:
    res = 512
    xyz, q, scale, opacity, color, valid = build_scene(res, 0.15, SEED)
    cam = scene_camera(res)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    p = project_gaussians(t(xyz), t(q), t(scale), t(opacity), t(color),
                          t(valid), t(cam["view"]), t(cam["proj"]),
                          float(cam["tanfovx"]), float(cam["tanfovy"]),
                          res, res)
    stacked = stack_rows(p.mean2d, p.conic, p.opacity, p.color, p.depth,
                         p.radius)[None]
    props, start, count, _, _ = sort_pairs(stacked, res, res, 16, 4096,
                                           None)
    tiles = res // 16
    err_rgb, err_t, _ = compare_composite(props, start, count, tiles, tiles)
    ms = event_ms(lambda: composite_fwd(props, start, count, tiles, tiles),
                  20)
    plain_ms = event_ms(lambda: composite_fwd_plain(props, start, count,
                                                    tiles, tiles), 1)
    build.LAUNCHES["composite_fwd"] = 0
    print(f"[kernel] composite_fwd at {res}^2 (build_scene, "
          f"{int(valid.sum())} fg gaussians, {int(count.sum())} pairs): "
          f"max abs err rgb {err_rgb:.3g} T {err_t:.3g} (tolerance {TOL}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms", flush=True)
    check(err_rgb <= TOL and err_t <= TOL, "composite_fwd vs plain at 512^2")
    return {"err": max(err_rgb, err_t)}


def phase_oracle(dev) -> None:
    res, n = 48, 300
    rng = np.random.default_rng(SEED)
    K = np.array([[0.8 * res, 0, res / 2], [0, 0.8 * res, res / 2],
                  [0, 0, 1]], np.float32)
    E = np.eye(3, 4, dtype=np.float32)
    E[2, 3] = 2.0
    cam = cameras.make_novel_camera(
        [cameras.camera_from_intr_extr(K, E, res, res)], res, res, dev)
    xyz = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    g = FlatGaussians(
        xyz=torch.tensor(xyz[None], device=dev),
        rot=torch.tensor(q[None], device=dev),
        scale=torch.tensor(rng.uniform(0.005, 0.06, (1, n, 3)),
                           dtype=torch.float32, device=dev),
        opacity=torch.tensor(rng.uniform(0.1, 0.95, (1, n, 1)),
                             dtype=torch.float32, device=dev),
        rgb=torch.tensor(rng.uniform(0, 1, (1, n, 3)), dtype=torch.float32,
                         device=dev),
        valid=torch.tensor(rng.uniform(size=(1, n)) > 0.1,
                           dtype=torch.float32, device=dev))
    bg = torch.tensor([0.2, 0.2, 0.2], device=dev)
    img, aux = rasterize(g, cam, bg, RasterizeConfig(16, 512), device=dev)
    p = project_gaussians(g.xyz[0], g.rot[0], g.scale[0], g.opacity[0],
                          g.rgb[0], g.valid[0], cam.view[0], cam.proj[0],
                          cam.tanfovx[0], cam.tanfovy[0], res, res)
    ref = composite_reference(p, bg, res, res)
    err = float((img[0] - ref).abs().max())
    build.LAUNCHES["composite_fwd"] = 0
    print(f"[oracle] rasterize on the GPU vs composite_reference at {res}^2, "
          f"{n} gaussians: max abs err {err:.3g} (tolerance {ORACLE_TOL})",
          flush=True)
    check(err <= ORACLE_TOL and int(aux.num_dropped.sum()) == 0,
          "rasterize vs oracle")


def phase_serving(dev) -> dict:
    cfg = load_config(None, **STAGE2_OVERRIDES)
    model = make_model(cfg, with_gs=True)
    init_weights(model, torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    renderer = FreeviewRenderer(cfg, model.state_dict(), device=dev)
    res = cfg.dataset.src_res
    out_res = 2 * res if cfg.dataset.use_hr_img else res
    batch, sample = silhouette_stereo_batch(res, 0.2, SEED, device=dev)
    ratios = (0.25, 0.5, 0.75)
    cams = [renderer.novel_camera_at(sample, r, out_res, out_res)
            for r in ratios]

    # warm-up frame (allocator, cuDNN algorithm choice), not counted
    renderer.render(renderer.gaussians(batch), cams[0])
    renderer.flush_drop_report()

    build.reset_launch_counts()
    gauss, fwd_ms = sync_ms(lambda: renderer.gaussians(batch))
    renders = []
    for cam in cams:
        (img, aux), ms = sync_ms(lambda: renderer.render(gauss, cam))
        renders.append((img, aux, ms))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    fg_drops, pair_drops = renderer.flush_drop_report()

    live = int(gauss.valid.sum())
    for (img, aux, _), r in zip(renders, ratios):
        check(tuple(img.shape) == (1, out_res, out_res, 3),
              f"image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"finite image at {r}")
        check(bool(torch.isfinite(aux.transmittance).all()),
              f"finite transmittance at {r}")
    drops = [(int(a.num_dropped.sum()), int(a.num_fg_dropped.sum()),
              int(a.num_pair_dropped.sum())) for _, a, _ in renders]
    covered = [float((a.transmittance < 0.5).float().mean())
               for _, a, _ in renders]
    print(f"[serving] stage2 width ({n_params} params, bf16 convs), "
          f"{res}^2 stereo pair -> {out_res}^2 views: forward "
          f"{fwd_ms:.2f} ms; render ms per view "
          f"{[round(m, 2) for _, _, m in renders]}; live gaussians {live}; "
          f"drops (dup, fg, pair) per view {drops}, fg_cap drops {fg_drops},"
          f" flushed pair drops {pair_drops}; covered pixel share "
          f"{[round(c, 4) for c in covered]}; images finite; launches "
          f"{launches}", flush=True)
    check(launches.get("composite_fwd", 0) >= len(ratios),
          "composite_fwd launched on every rendered view")
    return {"renderer": renderer, "gauss": gauss, "cam": cams[1],
            "batch": batch, "launches": launches, "fwd_ms": fwd_ms}


def phase_profile(serv: dict, out_dir: str) -> None:
    """One frame (forward + one view) under torch.profiler: the device busy
    share of the frame and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    renderer, cam = serv["renderer"], serv["cam"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render(renderer.gaussians(serv["batch"]), cam)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    renderer.flush_drop_report()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    busy_ms = sum(by_name.values()) / 1e3
    check(busy_ms > 0, "the profiler saw device time")
    rows = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        f.write(f"one frame: wall {wall_ms:.3f} ms, device busy "
                f"{busy_ms:.3f} ms\nkernel device ms:\n")
        f.writelines(f"{us / 1e3:10.3f}  {name}\n" for name, us in rows)
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    top = "; ".join(f"{name[:60]} {us / 1e3:.2f}" for name, us in rows[:8])
    print(f"[profile] one frame (forward + one view) {wall_ms:.2f} ms wall, "
          f"device busy {busy_ms:.2f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}); top kernels, device ms: {top}",
          flush=True)


def phase_main_shape(serv: dict) -> dict:
    rcfg = serv["renderer"].rcfg
    cam = serv["cam"]
    props, start, count = kernel_inputs(serv["gauss"], cam, rcfg)
    # what the render spends before the composite: projection + pair sort
    prep_ms = event_ms(lambda: kernel_inputs(serv["gauss"], cam, rcfg), 3)
    ty, tx = -(-cam.height // 16), -(-cam.width // 16)
    err_rgb, err_t, work = compare_composite(props, start, count, ty, tx)
    ms = event_ms(lambda: composite_fwd(props, start, count, ty, tx), 20)
    plain_ms = event_ms(lambda: composite_fwd_plain(props, start, count, ty,
                                                    tx), 1)
    build.LAUNCHES["composite_fwd"] = 0
    pairs = int(count.sum())
    num_tiles = start.shape[0]
    nbytes = 36 * pairs + 8 * num_tiles + 16 * num_tiles * 256
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = work * OPS_PER_EVAL / F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"[main-shape] composite_fwd on the serving path's inputs "
          f"({num_tiles} tiles, {pairs} live pairs, {work} pair-pixel "
          f"evaluations needed): max abs err rgb {err_rgb:.3g} T {err_t:.3g}"
          f" (tolerance {TOL}); kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
          f"bound {bound_ms:.4f} ms (bytes {t_bytes:.4f} ms, ops "
          f"{t_ops:.4f} ms); projection + pair sort before it {prep_ms:.3f} "
          f"ms", flush=True)
    check(err_rgb <= TOL and err_t <= TOL,
          "composite_fwd vs plain at the serving shape")
    return {"err": max(err_rgb, err_t), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def main(argv) -> int:
    if argv and (len(argv) != 2 or argv[0] != "--profile"):
        print("usage: python3 chip_smoke.py [--profile DIR]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{smi}", flush=True)

    phase_build()
    k512 = phase_kernel(dev)
    phase_oracle(dev)
    serv = phase_serving(dev)
    if argv[:1] == ["--profile"]:
        phase_profile(serv, argv[1])
    main_k = phase_main_shape(serv)

    kernels = [{
        "name": "composite_fwd", "route": "cuda",
        "source": "gps_gaussian_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "gps_gaussian_tpu/kernels/rasterizer/pallas_kernel.py:767",
        "launches": serv["launches"].get("composite_fwd", 0),
        "max_abs_err": max(k512["err"], main_k["err"]),
        "ms": main_k["ms"], "plain_ms": main_k["plain_ms"],
        "bound_ms": main_k["bound_ms"], "bound_by": main_k["bound_by"],
        "library_ms": None}]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
