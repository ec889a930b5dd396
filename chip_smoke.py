#!/usr/bin/env python
"""Drive the PyTorch port (gps_gaussian_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, one line of output each:
  1. build   - compile every CUDA kernel from csrc/, one nvcc each, together
  2. kernel, kernel-bwd - hold each kernel to its plain PyTorch version on a
               silhouette scene (bench.py build_scene) rendered at 512^2;
               the backward takes seeded random cotangents and is launched
               twice to show that its result is the same bits
  3. oracle, grad-oracle - the full rasterizer on the GPU against the exact
               O(pixels x N) oracle on a small scene: the image, then the
               gradients of a seeded scalar loss with respect to xyz, rot,
               scale, opacity and rgb against autograd through the oracle
  4. serving - the free-view serving path at the configs/stage2.yaml width:
               seeded random weights, bf16 convolutions, a 1024^2 stereo pair
               with ~20% silhouette foreground, one stereo forward and three
               2048^2 novel views; the launch counts are zeroed just before
               and read just after
  5. training - the stage-2 training step at the same width through
               make_train_step: batch 2, three GRU iterations, 2048^2 novel
               targets, the reference loss mix; one warm-up step, then three
               timed steps with the launch counts zeroed just before and
               read just after
  6. main-shape kernel checks - each kernel against its plain version on the
               inputs its path gave it, with its time and its bound
With --profile DIR, one serving frame (the forward and one view) and one
training step run under torch.profiler: each prints its device busy share
and writes every kernel's device time to DIR/profile.txt and
DIR/profile_train.txt.
Then the card's name and power limit, one JSON line describing each kernel,
and last `{"ok": true, "device": {...}}`. Any failed check raises, so the
script exits non-zero and prints no result; it also fails without a GPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gps_gaussian_tpu_torch.geometry import cameras
from gps_gaussian_tpu_torch.infer.freeview import FreeviewRenderer
from gps_gaussian_tpu_torch.kernels import build
from gps_gaussian_tpu_torch.kernels.rasterizer import (
    RasterizeConfig, compact_gaussian_inputs, rasterize)
from gps_gaussian_tpu_torch.kernels.rasterizer.composite import (
    composite_bwd, composite_bwd_plain, composite_fwd, composite_fwd_plain)
from gps_gaussian_tpu_torch.kernels.rasterizer.pair_sort import (
    sort_pairs, stack_rows)
from gps_gaussian_tpu_torch.kernels.rasterizer.preprocess import \
    project_gaussians
from gps_gaussian_tpu_torch.kernels.rasterizer.reference import \
    composite_reference
from gps_gaussian_tpu_torch.models.layers import init_weights
from gps_gaussian_tpu_torch.testing import (build_scene, scene_camera,
                                            silhouette_stereo_batch,
                                            silhouette_train_batch)
from gps_gaussian_tpu_torch.train.config import load_config
from gps_gaussian_tpu_torch.train.state import create_state
from gps_gaussian_tpu_torch.train.trainer import (make_model,
                                                  make_raster_config,
                                                  make_train_step)
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
# composite_bwd vs its plain version, per property row, relative to the
# row's largest gradient: the two add a pair's 256 pixel terms in different
# orders (shuffle tree and warp order against torch.sum), each f32 add
# rounding at 6e-8 of the running sum
BWD_RTOL = 1e-4
# rasterize's gradients vs autograd through the oracle, relative to each
# input's largest gradient: the oracle composes T as exp(cumsum(log1p)),
# the kernels by repeated multiplication
GRAD_ORACLE_RTOL = 1e-3
TRAIN_STEPS = 3       # timed steps after one warm-up step
# H100 SXM published peaks (dense): HBM bytes/s and f32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per walked (pair, pixel) in composite_fwd.cu, expf as one:
# dx dy (2), power (9), exp and opacity (2), clamp (1), the two include
# tests (2), 1 - alpha and test_T (2), the T_EPS test (1), w (1), rgb (6)
OPS_PER_EVAL = 25
# f32 operations in composite_bwd.cu. For each walked (pair, pixel), up to
# the T_EPS test: dx dy (2), power (9), its test (1), exp and opacity (2),
# clamp (1), the alpha test (1), 1 - alpha and test_T (2), the T_EPS test
# (1). For each that blends, also: w (1), gc (5), p_gc (2), the floor of
# 1 - alpha (1), g_alpha (4), the clamp flag (1), gp (2), the five geometry
# terms (4 + 4 + 3 + 2 + 3), opacity (2), rgb (3), and one add for each of
# the nine sums over the tile's pixels (9)
BWD_OPS_PER_WALK = 20
BWD_OPS_PER_BLEND = 46
FWD_SRC = "gps_gaussian_tpu_torch/csrc/composite_fwd.cu"
BWD_SRC = "gps_gaussian_tpu_torch/csrc/composite_bwd.cu"
PALLAS = "gps_gaussian_tpu/kernels/rasterizer/pallas_kernel.py"


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


def compare_composite_bwd(props, start, count, out, g_out, tiles_y, tiles_x):
    """Backward kernel vs plain on the same inputs, the kernel launched
    twice. Returns (per-row max abs err, per-row max abs gradient, the
    two launches bit-equal, walked and blended (pair, pixel) counts, pairs
    that the walk reaches)."""
    launches = dict(build.LAUNCHES)
    g_k = composite_bwd(props, start, count, out, g_out, tiles_y, tiles_x)
    g_k2 = composite_bwd(props, start, count, out, g_out, tiles_y, tiles_x)
    g_p, walked, blended, reached = composite_bwd_plain(
        props, start, count, out, g_out, tiles_y, tiles_x, return_work=True)
    torch.cuda.synchronize()
    build.LAUNCHES.update(launches)  # comparisons do not count
    err = (g_k - g_p).abs().amax(dim=1)
    mag = g_p.abs().amax(dim=1)
    return (err.tolist(), mag.tolist(), bool(torch.equal(g_k, g_k2)),
            int(walked), int(blended), int(reached))


def check_bwd_rows(err, mag, what: str) -> float:
    """Every row within BWD_RTOL of its largest gradient; returns the
    largest error."""
    check(all(m > 0 for m in mag), f"{what}: every property row has gradient")
    check(all(e <= BWD_RTOL * m for e, m in zip(err, mag)),
          f"{what}: composite_bwd vs plain, err {err} against {mag}")
    return max(err)


def fmt(xs) -> str:
    return "[" + ", ".join(f"{x:.3g}" for x in xs) + "]"


def phase_build() -> None:
    t0 = time.perf_counter()
    names = ["composite_fwd", "composite_bwd"]
    # one nvcc process for each source, all started together
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = dict(zip(names, pool.map(build.build, names)))
    secs = time.perf_counter() - t0
    for name, (path, log) in built.items():
        ptxas = " | ".join(ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "smem" in ln)
        print(f"[build] {name}.cu -> {path.parent.name}/{path.name}; "
              f"ptxas: {ptxas}", flush=True)
    print(f"[build] both kernels, built together, in {secs:.2f} s",
          flush=True)


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
    print(f"[kernel] composite_fwd at {res}^2 (build_scene, "
          f"{int(valid.sum())} fg gaussians, {int(count.sum())} pairs): "
          f"max abs err rgb {err_rgb:.3g} T {err_t:.3g} (tolerance {TOL}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms", flush=True)
    check(err_rgb <= TOL and err_t <= TOL, "composite_fwd vs plain at 512^2")

    out = composite_fwd(props, start, count, tiles, tiles)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g_out = torch.randn(out.shape, generator=gen, device=dev)
    err, mag, same, walked, blended, _ = compare_composite_bwd(
        props, start, count, out, g_out, tiles, tiles)
    bwd_ms = event_ms(lambda: composite_bwd(props, start, count, out, g_out,
                                            tiles, tiles), 20)
    bwd_plain_ms = event_ms(lambda: composite_bwd_plain(
        props, start, count, out, g_out, tiles, tiles), 1)
    build.reset_launch_counts()
    print(f"[kernel-bwd] composite_bwd at {res}^2, same pairs, seeded normal "
          f"cotangents for rgb and T ({walked} pair-pixel evaluations, "
          f"{blended} blended): max abs err per row (mx my ca cb cc op r g b)"
          f" {fmt(err)} beside max abs gradient {fmt(mag)} (tolerance "
          f"{BWD_RTOL} of the row's largest gradient); two launches "
          f"bit-equal: {same}; kernel {bwd_ms:.4f} ms, plain "
          f"{bwd_plain_ms:.2f} ms", flush=True)
    check(same, "composite_bwd gives the same bits twice")
    bwd_err = check_bwd_rows(err, mag, "512^2")
    return {"err": max(err_rgb, err_t), "bwd_err": bwd_err}


def oracle_scene(dev):
    """A 48^2 camera and 300 seeded Gaussians, a tenth of them invalid."""
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
    weight = torch.tensor(rng.normal(size=(1, res, res, 3)),
                          dtype=torch.float32, device=dev)
    return res, n, cam, g, weight


def oracle_image(g, cam, bg, res):
    p = project_gaussians(g.xyz[0], g.rot[0], g.scale[0], g.opacity[0],
                          g.rgb[0], g.valid[0], cam.view[0], cam.proj[0],
                          cam.tanfovx[0], cam.tanfovy[0], res, res)
    return composite_reference(p, bg, res, res)


def phase_oracle(dev) -> None:
    res, n, cam, g, weight = oracle_scene(dev)
    bg = torch.tensor([0.2, 0.2, 0.2], device=dev)
    rcfg = RasterizeConfig(16, 512)
    img, aux = rasterize(g, cam, bg, rcfg, device=dev)
    err = float((img[0] - oracle_image(g, cam, bg, res)).abs().max())
    print(f"[oracle] rasterize on the GPU vs composite_reference at {res}^2, "
          f"{n} gaussians: max abs err {err:.3g} (tolerance {ORACLE_TOL})",
          flush=True)
    check(err <= ORACLE_TOL and int(aux.num_dropped.sum()) == 0,
          "rasterize vs oracle")

    names = ("xyz", "rot", "scale", "opacity", "rgb")

    def grads(render):
        leaves = {k: getattr(g, k).clone().requires_grad_(True)
                  for k in names}
        (render(dataclasses.replace(g, **leaves)) * weight).sum().backward()
        return [leaves[k].grad for k in names]

    ours = grads(lambda gl: rasterize(gl, cam, bg, rcfg, device=dev)[0])
    ref = grads(lambda gl: oracle_image(gl, cam, bg, res)[None])
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    build.reset_launch_counts()
    err = [float((a - b).abs().max()) for a, b in zip(ours, ref)]
    mag = [float(b.abs().max()) for b in ref]
    dead = g.valid[0] < 0.5
    dead_zero = all(bool((a[0][dead] == 0).all()) for a in ours)
    print(f"[grad-oracle] gradients of a seeded weighted image sum through "
          f"rasterize on the GPU vs autograd through composite_reference at "
          f"{res}^2: max abs err (xyz rot scale opacity rgb) {fmt(err)} "
          f"beside max abs gradient {fmt(mag)} (tolerance "
          f"{GRAD_ORACLE_RTOL} of each input's largest gradient); invalid "
          f"rows exactly zero: {dead_zero}; launches {launches}", flush=True)
    check(all(e <= GRAD_ORACLE_RTOL * m for e, m in zip(err, mag)),
          "rasterize gradients vs oracle")
    check(dead_zero, "invalid rows get zero gradient")
    check(launches.get("composite_bwd", 0) == 1,
          "rasterize's backward launched composite_bwd")


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


def top_level_groups(model) -> dict:
    groups: dict = {}
    for name, prm in model.named_parameters():
        groups.setdefault(name.split(".")[0], []).append(prm)
    return groups


def phase_training(dev) -> dict:
    cfg = load_config(None, **STAGE2_OVERRIDES)
    model = make_model(cfg, with_gs=True)
    init_weights(model, torch.Generator().manual_seed(SEED))
    state = create_state(cfg, model, device=dev)
    step = make_train_step(model, cfg, "stage2", make_raster_config(cfg),
                           state, device=dev)
    res = cfg.dataset.src_res
    out_res = 2 * res if cfg.dataset.use_hr_img else res
    batch = silhouette_train_batch(cfg.batch_size, res, out_res, 0.2, SEED,
                                   device=dev)
    before = {k: [prm.detach().clone() for prm in v]
              for k, v in top_level_groups(model).items()}

    step(batch)  # warm-up (allocator, cuDNN algorithm choice), not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    rows = []
    for _ in range(TRAIN_STEPS):
        marks = {"start": torch.cuda.Event(enable_timing=True)}

        def mark(name):
            marks[name] = torch.cuda.Event(enable_timing=True)
            marks[name].record()

        marks["start"].record()
        metrics, ms = sync_ms(lambda: step(batch, mark=mark))
        rows.append({
            "ms": ms,
            "forward": marks["start"].elapsed_time(marks["forward"]),
            "backward": marks["forward"].elapsed_time(marks["backward"]),
            "optimizer": marks["backward"].elapsed_time(marks["optimizer"]),
            "metrics": {k: float(v) for k, v in metrics.items()}})
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    finite_grads = all(prm.grad is not None
                       and bool(torch.isfinite(prm.grad).all())
                       for prm in model.parameters())
    changed = {k: any(not torch.equal(a, b.detach())
                      for a, b in zip(before[k], v))
               for k, v in top_level_groups(model).items()}
    last = rows[-1]["metrics"]
    drops = {k: last[k] for k in ("num_dropped", "num_fg_dropped",
                                  "num_pair_dropped")}
    n_params = sum(prm.numel() for prm in model.parameters())
    r2 = lambda key: [round(r[key], 2) for r in rows]  # noqa: E731
    print(f"[training] stage-2 step at stage2 width ({n_params} params, bf16 "
          f"convs, remat {cfg.remat}), batch {cfg.batch_size}, {res}^2 "
          f"silhouette stereo pairs -> {out_res}^2 novel target, "
          f"{cfg.raft.train_iters} GRU iterations, loss {cfg.flow_weight} "
          f"flow + {cfg.l1_weight} L1 + {cfg.ssim_weight} (1 - SSIM); "
          f"{TRAIN_STEPS} steps after 1 warm-up: step ms {r2('ms')} (host "
          f"clock, synchronised), forward {r2('forward')} backward "
          f"{r2('backward')} optimizer {r2('optimizer')} ms (CUDA events); "
          f"peak memory allocated {peak_gib:.2f} GiB; loss "
          f"{[round(r['metrics']['loss'], 5) for r in rows]}; grad norm "
          f"{[round(r['metrics']['grad_norm'], 3) for r in rows]}; last "
          f"step l1 {last['l1']:.4f} ssim {last['ssim']:.4f} flow_loss "
          f"{last['flow_loss']:.4f}; drops {drops}; gradients finite: "
          f"{finite_grads}; groups changed: {changed}; launches {launches}",
          flush=True)
    check(all(np.isfinite(v) for r in rows for v in r["metrics"].values()),
          "every loss and metric finite")
    check(finite_grads, "every gradient finite")
    check(all(changed.values()), "every parameter group changed")
    check(launches.get("composite_fwd", 0) == TRAIN_STEPS
          and launches.get("composite_bwd", 0) == TRAIN_STEPS,
          "composite_fwd and composite_bwd launched once per step")
    return {"step": step, "batch": batch, "launches": launches,
            "step_ms": [r["ms"] for r in rows]}


def profile_block(fn, path: str, what: str, tag: str) -> None:
    """Run fn under torch.profiler: print the device busy share and the
    kernels with the most device time, and write them all to `path`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        # kernels and copies only: a user annotation (the optimizer's step
        # range) spans kernels that are already counted
        if e.device_type == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    busy_ms = sum(by_name.values()) / 1e3
    check(busy_ms > 0, "the profiler saw device time")
    rows = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{what}: wall {wall_ms:.3f} ms, device busy "
                f"{busy_ms:.3f} ms\nkernel device ms:\n")
        f.writelines(f"{us / 1e3:10.3f}  {name}\n" for name, us in rows)
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    top = "; ".join(f"{name[:60]} {us / 1e3:.2f}" for name, us in rows[:8])
    print(f"[{tag}] {what} {wall_ms:.2f} ms wall, device busy "
          f"{busy_ms:.2f} ms (idle share {1 - busy_ms / wall_ms:.3f}); top "
          f"kernels, device ms: {top}", flush=True)


def phase_profile(serv: dict, train: dict, out_dir: str) -> None:
    """One serving frame (forward + one view) and one training step under
    torch.profiler."""
    renderer, cam = serv["renderer"], serv["cam"]
    profile_block(
        lambda: renderer.render(renderer.gaussians(serv["batch"]), cam),
        os.path.join(out_dir, "profile.txt"),
        "one frame (forward + one view)", "profile")
    renderer.flush_drop_report()
    launches = dict(build.LAUNCHES)
    profile_block(lambda: train["step"](train["batch"]),
                  os.path.join(out_dir, "profile_train.txt"),
                  "one stage-2 training step", "profile-train")
    build.LAUNCHES.update(launches)


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


def find_node(root, name: str):
    """The first autograd node of type `name` in the graph under `root`."""
    stack, seen = [root], set()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        if type(node).__name__ == name:
            return node
        seen.add(node)
        stack.extend(fn for fn, _ in node.next_functions)
    raise RuntimeError(f"no {name} node in the graph")


def phase_main_shape_training(train: dict) -> dict:
    """Both kernels on the inputs the training step gives them: one more
    forward and backward of the step's loss (after the launch counts were
    read), with the composite's saved tensors and its incoming cotangent
    taken from its node in the autograd graph."""
    launches = dict(build.LAUNCHES)
    loss, _ = train["step"].loss_fn(train["batch"])
    node = find_node(loss.grad_fn, "_CompositeBackward")
    props, start, count, out = node.saved_tensors
    ty, tx = node.tiles
    seen = {}
    node.register_prehook(lambda grads: seen.update(g_out=grads[0]))
    loss.backward()
    g_out = seen["g_out"].contiguous()
    torch.cuda.synchronize()
    build.LAUNCHES.update(launches)

    # the forward kernel over both samples (the serving shape has one)
    err_rgb, err_t, _ = compare_composite(props, start, count, ty, tx)
    check(bool(torch.equal(out, composite_fwd(props, start, count, ty, tx))),
          "the step's saved output is the forward kernel's on its inputs")
    bwd_args = (props, start, count, out, g_out, ty, tx)
    err, mag, same, walked, blended, reached = compare_composite_bwd(
        *bwd_args)
    ms = event_ms(lambda: composite_bwd(*bwd_args), 20)
    plain_ms = event_ms(lambda: composite_bwd_plain(*bwd_args), 1)
    fwd_ms = event_ms(lambda: composite_fwd(props, start, count, ty, tx), 20)
    build.LAUNCHES.update(launches)
    pairs = int(count.sum())
    num_tiles = start.shape[0]
    batch = num_tiles // (ty * tx)
    # read 36 B per pair that the walk reaches, write 36 B per live pair,
    # 8 B of segment per tile, the saved output and the cotangent at 16 B
    # each per pixel
    nbytes = 36 * reached + 36 * pairs + 8 * num_tiles + 32 * num_tiles * 256
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (walked * BWD_OPS_PER_WALK + blended * BWD_OPS_PER_BLEND) \
        / F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"[main-shape training] on the training step's inputs, {batch} "
          f"samples ({num_tiles} tiles, {pairs} live pairs, {reached} "
          f"reached, {walked} pair-pixel evaluations walked, {blended} "
          f"blended): composite_fwd max abs err rgb {err_rgb:.3g} T "
          f"{err_t:.3g} (tolerance {TOL}), kernel {fwd_ms:.4f} ms; "
          f"composite_bwd max abs err per row (mx my ca cb cc op r g b) "
          f"{fmt(err)} beside max abs gradient {fmt(mag)} (tolerance "
          f"{BWD_RTOL} of the row's largest gradient); two launches "
          f"bit-equal: {same}; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
          f"bound {bound_ms:.4f} ms (bytes {t_bytes:.4f} ms, ops "
          f"{t_ops:.4f} ms)", flush=True)
    check(batch > 1, "the training shape holds more than one sample")
    check(err_rgb <= TOL and err_t <= TOL,
          "composite_fwd vs plain at the training shape")
    check(same, "composite_bwd gives the same bits twice at the training "
          "shape")
    return {"err": check_bwd_rows(err, mag, "training shape"),
            "fwd_err": max(err_rgb, err_t), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
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
    train = phase_training(dev)
    if argv[:1] == ["--profile"]:
        phase_profile(serv, train, argv[1])
    main_f = phase_main_shape(serv)
    main_b = phase_main_shape_training(train)

    def launches(name):
        return {"launches": serv["launches"].get(name, 0)
                + train["launches"].get(name, 0),
                "launches_serving": serv["launches"].get(name, 0),
                "launches_training": train["launches"].get(name, 0)}

    kernels = [{
        "name": "composite_fwd", "route": "cuda", "source": FWD_SRC,
        "replaces": f"{PALLAS}:767", **launches("composite_fwd"),
        "max_abs_err": max(k512["err"], main_f["err"], main_b["fwd_err"]),
        "ms": main_f["ms"], "plain_ms": main_f["plain_ms"],
        "bound_ms": main_f["bound_ms"], "bound_by": main_f["bound_by"],
        "library_ms": None}, {
        "name": "composite_bwd", "route": "cuda", "source": BWD_SRC,
        "replaces": f"{PALLAS}:836", **launches("composite_bwd"),
        "max_abs_err": max(k512["bwd_err"], main_b["err"]),
        "ms": main_b["ms"], "plain_ms": main_b["plain_ms"],
        "bound_ms": main_b["bound_ms"], "bound_by": main_b["bound_by"],
        "library_ms": None}]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
