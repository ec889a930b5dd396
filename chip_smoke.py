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
  7. trained - the dataset-driven path on the committed stage-2 run's
               weights (runs/synth256/stage2/torch, configs/stage2_synth256
               width): the Trainer's val sweep over the run's 8 val scans,
               rendered in memory, held to the JAX package's val PSNR and
               EPE; two train() steps with spawned loader workers; then
               load_renderer on the checkpoint they wrote and infer_static
  8. trained-serving - the serving frame of phase 4 on those weights and a
               synthetic scan rendered at 1024^2: forward, views, the
               composite kernel's time, live pairs and drops
  9. trainer - the Trainer at full width on SilhouetteDataset: stage 2
               (3 steps, the val sweep, a resumed run's step) and stage 1 at
               configs/stage1.yaml width (2 steps, the point-splat preview)
 10. staircase - the JAX package's staircase configuration (bench.py) on
               its 1024^2 scene, forward and backward, against the uniform-K
               path: pair-sort lengths, times, the one-class schedule
               bit-equal, ellipse against circle rects, both kernels against
               their plain versions on its pairs; then the trained frame of
               phase 8 at 2048^2 with a schedule sized from its spans
 11. sharded-render - that frame rendered band by band for 2 and 4 ranks:
               against rasterize at caps that do not bind, and the drops per
               band at the configuration's caps
 12. ddp      - two spawned ranks in one gloo group, both on this card: two
               stage-2 steps at full width, batch 1 each, against one
               process at batch 2; rasterize_tile_sharded against the
               band-by-band render; a world-2 Trainer whose rank-0
               checkpoint resumes at world 1
 13. scans    - two textured humanoid meshes made from a seed (245,760
               triangles each) written as OBJ + png, rendered into a
               dataset tree by data/render_scans.py render_dataset at
               1024^2 with 2048^2 targets on the host's C++ rasterizer
               (its times printed); the val scan read by StereoHumanDataset
               and its view 3 rendered at 2048^2 on the committed trained
               weights, composite_fwd held to its plain version, the PSNR
               against 3_hr.jpg printed (needs Pillow)
 14. reference-import - the committed weights written as a reference .pth
               ({'network': state_dict}) and read by
               utils/torch_import.py load_reference_checkpoint: the frame
               of phase 8 bit-equal to load_renderer's; a stage-1 file
               (no gs_parm_regresser.*) through restore_params_partial
Each of phases 4, 5 and 7-14 zeroes the launch counts just before it
drives its path and reads them just after (the ranks of phase 12 in their
own processes, which send their counts back). The synthetic scans of phases 7
and 8 render in worker processes while phases 1-3 run.
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
import multiprocessing as mp
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

from gps_gaussian_tpu_torch import native
from gps_gaussian_tpu_torch.data import render_scans
from gps_gaussian_tpu_torch.data.loader import collate
from gps_gaussian_tpu_torch.data.synth import ring_camera
from gps_gaussian_tpu_torch.data.thuman import (DatasetConfig,
                                                StereoHumanDataset)
from gps_gaussian_tpu_torch.geometry import cameras
from gps_gaussian_tpu_torch.infer.freeview import (FreeviewRenderer,
                                                   compact_valid,
                                                   load_renderer)
from gps_gaussian_tpu_torch.kernels import build
from gps_gaussian_tpu_torch.kernels.rasterizer import (
    RasterizeConfig, compact_gaussian_inputs, rasterize,
    rasterize_reference_single)
from gps_gaussian_tpu_torch.kernels.rasterizer.composite import (
    composite_bwd, composite_bwd_plain, composite_fwd, composite_fwd_plain,
    kernel_occupancy)
from gps_gaussian_tpu_torch.kernels.rasterizer.pair_sort import (
    sort_pairs, stack_rows, staircase_pairs, tile_rects)
from gps_gaussian_tpu_torch.kernels.rasterizer.sharded import (render_band,
                                                               render_bands)
from gps_gaussian_tpu_torch.kernels.rasterizer.preprocess import \
    project_gaussians
from gps_gaussian_tpu_torch.models.layers import init_weights
from gps_gaussian_tpu_torch.testing import (SilhouetteDataset,
                                            SynthMemoryDataset, build_scene,
                                            humanoid_mesh, scene_camera,
                                            silhouette_stereo_batch,
                                            silhouette_train_batch,
                                            spawn_ranks, synth_scans,
                                            write_scan)
from gps_gaussian_tpu_torch.train import losses
from gps_gaussian_tpu_torch.train.config import load_config
from gps_gaussian_tpu_torch.train.state import (create_state,
                                                onecycle_linear,
                                                restore_params_partial)
from gps_gaussian_tpu_torch.train.trainer import (Trainer, make_model,
                                                  make_raster_config,
                                                  make_train_step)
from gps_gaussian_tpu_torch.utils.containers import FlatGaussians
from gps_gaussian_tpu_torch.utils.torch_import import \
    load_reference_checkpoint

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
# configs/stage1.yaml and configs/stage2_synth256.yaml, likewise
STAGE1_OVERRIDES = dict(
    name="gps_tpu_stage1", stage="stage1", batch_size=6, lr=0.0002,
    wdecay=0.00001, num_steps=40000, scheduler_steps=100100,
    raft=dict(mixed_precision=False, train_iters=3, val_iters=3,
              encoder_dims=[32, 48, 96], hidden_dims=[96, 96, 96]),
    dataset=dict(src_res=1024, use_hr_img=False, use_processed_data=True,
                 num_workers=8),
    record=dict(loss_freq=100, eval_freq=2000))
SYNTH256_OVERRIDES = dict(
    name="gps_tpu_stage2_synth256", stage="stage2", batch_size=2, lr=0.00005,
    wdecay=0.00001, num_steps=1200, scheduler="constant", flow_weight=0.0,
    loader_seed=0,
    raft=dict(mixed_precision=True, train_iters=3, val_iters=3,
              encoder_dims=[32, 48, 96], hidden_dims=[96, 96, 96]),
    gsnet=dict(encoder_dims=[32, 48, 96], decoder_dims=[48, 64, 96],
               parm_head_dim=32),
    raster=dict(max_tiles_per_gaussian=16, max_per_tile=2048, fg_cap=40960,
                pair_budget=393216),
    dataset=dict(src_res=256, use_hr_img=True, use_processed_data=True,
                 num_workers=4),
    record=dict(loss_freq=50, eval_freq=150))
# the committed stage-2 run's weights (runs/synth256/stage2, step 1200) as
# the port's checkpoint, and the JAX package's val sweep on the CPU over the
# same in-memory val set (8 scans, 256^2 sources, 512^2 view 3):
# `tools/export_torch_checkpoint.py runs/synth256/stage2 --val-reference`
TRAINED_CKPT = "runs/synth256/stage2/torch"
JAX_VAL_PSNR = 36.466829
JAX_VAL_EPE = 1.71273
PSNR_TOL_DB = 0.1     # the two frameworks round bf16 convolutions apart
EPE_RTOL = 0.02

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
# bench.py bench_raster_config() (:96-101): the JAX package's staircase on
# build_scene(1024), its schedule sized from that scene's ellipse spans
BENCH_RASTER = dict(max_tiles_per_gaussian=9, max_per_tile=2048,
                    fg_cap=352_256, pair_budget=1_572_864)
BENCH_SCHEDULE = ((9, 6144), (6, 56320), (4, 217088), (2, 65536), (1, 7168))
# the classes of a schedule sized from a frame's spans (K <= 63)
STAIR_KS = (63, 48, 32, 24, 16, 12, 8, 6, 4, 3, 2, 1)
GRAD_FIELDS = ("xyz", "rot", "scale", "opacity", "rgb")
DDP_TRAINER_STEPS = 3  # the world-2 Trainer's steps: the first warms up
# world-2 metrics against one process at batch 2: the JAX package's 5e-3
# between its sharded and one-device steps (valid-masked metrics are
# per-rank means averaged), plus 1e-4 absolute: a batch-2 render packs each
# pair's depth into 15 bits over both samples' range, a batch-1 render into
# 16 over its own (pack_sort_key), so near-equal depths blend in another
# order and the images differ slightly; SSIM against a random target is
# about 0.0026 and moves by 5e-5 (seen at this width, f32)
DDP_RTOL = 5e-3
DDP_ATOL = 1e-4
FWD_SRC = "gps_gaussian_tpu_torch/csrc/composite_fwd.cu"
BWD_SRC = "gps_gaussian_tpu_torch/csrc/composite_bwd.cu"
PALLAS = "gps_gaussian_tpu/kernels/rasterizer/pallas_kernel.py"
# pixel-to-lane mappings whose lockstep cost the plain versions count at the
# main-path shapes: 16x2 strips and compact 8x4 blocks (the kernels' rows)
WARP_SHAPES = ((16, 2), (8, 4))


def sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def event_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean ms of `reps` calls by CUDA events, after one warm-up call. A
    plain version, whose one call takes seconds, is timed cold (its first
    call's allocations are a vanishing part of it)."""
    if warmup:
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


def projected_rows(gauss, camera, rcfg, view: int = 0):
    """The (1, N, 11) rows that rasterize() sorts for one view: sample 0's
    Gaussians compacted to rcfg.fg_cap rows and projected."""
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
    return stack_rows(p.mean2d, p.conic, p.opacity, p.color, p.depth,
                      p.radius)[None]


def kernel_inputs(gauss, camera, rcfg, view: int = 0):
    """The (props, start, count) that rasterize() gives composite_fwd for
    one view, rebuilt from the same public steps (either binning)."""
    stacked = projected_rows(gauss, camera, rcfg, view)
    if rcfg.span_schedule is not None:
        props, start, count, _, _ = staircase_pairs(
            stacked, camera.height, camera.width, rcfg.span_schedule,
            rcfg.max_per_tile, rcfg.pair_budget, rcfg.ellipse_rects)
    else:
        props, start, count, _, _ = sort_pairs(
            stacked, camera.height, camera.width,
            rcfg.max_tiles_per_gaussian, rcfg.max_per_tile,
            rcfg.pair_budget)
    return props.detach(), start, count


def compare_composite(props, start, count, tiles_y, tiles_x,
                      warp_shapes=()):
    """Kernel vs plain on the same inputs: (max abs err rgb, T, work, the
    plain version's lockstep counts for `warp_shapes` or None)."""
    launches = build.LAUNCHES.get("composite_fwd", 0)
    out_k = composite_fwd(props, start, count, tiles_y, tiles_x)
    out_p, work, *lock = composite_fwd_plain(
        props, start, count, tiles_y, tiles_x, return_work=True,
        warp_shapes=warp_shapes)
    torch.cuda.synchronize()
    build.LAUNCHES["composite_fwd"] = launches  # comparisons do not count
    err_rgb = float((out_k[..., :3] - out_p[..., :3]).abs().max())
    err_t = float((out_k[..., 3] - out_p[..., 3]).abs().max())
    return err_rgb, err_t, int(work), (lock[0] if lock else None)


def check_fwd(err_rgb: float, err_t: float, what: str) -> None:
    """rgb within TOL; T bit-equal: the kernel made the plain version's
    include and T_EPS decisions."""
    check(err_rgb <= TOL, f"composite_fwd vs plain {what}: rgb {err_rgb}")
    check(err_t == 0.0, f"composite_fwd vs plain {what}: T differs by "
          f"{err_t}, must be bit-equal")


def fmt_lockstep(lock: dict, needed: int) -> str:
    """The lockstep counts as evaluations spent, beside those needed."""
    parts = [f"a 256-thread block in lockstep spends "
             f"{256 * lock['tile_walked']} evaluations for {needed} needed"]
    for (w, h), c in lock["warps"].items():
        parts.append(f"{w}x{h} warps spend {w * h * c['walked']} "
                     f"({c['walked']} warp-pairs walked, {c['included']} "
                     f"with a lane included, {c['blended']} with a lane "
                     f"blending)")
    return "; ".join(parts)


def compare_composite_bwd(props, start, count, out, g_out, tiles_y, tiles_x,
                          warp_shapes=()):
    """Backward kernel vs plain on the same inputs, the kernel launched
    twice. Returns (per-row max abs err, per-row max abs gradient, the
    two launches bit-equal, walked and blended (pair, pixel) counts, pairs
    that the walk reaches, pairs the plain version left at exactly 0 where
    the kernel did not, the lockstep counts for `warp_shapes` or None)."""
    launches = dict(build.LAUNCHES)
    g_k = composite_bwd(props, start, count, out, g_out, tiles_y, tiles_x)
    g_k2 = composite_bwd(props, start, count, out, g_out, tiles_y, tiles_x)
    g_p, walked, blended, reached, *lock = composite_bwd_plain(
        props, start, count, out, g_out, tiles_y, tiles_x, return_work=True,
        warp_shapes=warp_shapes)
    torch.cuda.synchronize()
    build.LAUNCHES.update(launches)  # comparisons do not count
    err = (g_k - g_p).abs().amax(dim=1)
    mag = g_p.abs().amax(dim=1)
    stray = int(((g_p == 0).all(dim=0) & (g_k != 0).any(dim=0)).sum())
    return (err.tolist(), mag.tolist(), bool(torch.equal(g_k, g_k2)),
            int(walked), int(blended), int(reached), stray,
            (lock[0] if lock else None))


def check_bwd_rows(err, mag, what: str) -> float:
    """Every row within BWD_RTOL of its largest gradient; returns the
    largest error."""
    check(all(m > 0 for m in mag), f"{what}: every property row has gradient")
    check(all(e <= BWD_RTOL * m for e, m in zip(err, mag)),
          f"{what}: composite_bwd vs plain, err {err} against {mag}")
    return max(err)


def fmt(xs) -> str:
    return "[" + ", ".join(f"{x:.3g}" for x in xs) + "]"


def ptxas_summary(log: str) -> str:
    """nvcc's report, one item per kernel instantiation: its template
    argument (pixels per lane), registers, barriers and shared memory."""
    items, ppl = [], None
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '\w*?ILi(\d+)E", ln)
        if entry:
            ppl = entry.group(1)
        elif "registers" in ln:
            used = ln.split(":", 1)[1].strip()
            items.append(f"{ppl} px/lane: {used}" if ppl else used)
            ppl = None
    return " | ".join(items)


def fmt_occupancy(name: str, num_tiles: int) -> str:
    """Which instantiation a launch over `num_tiles` tiles runs, and how
    many of its blocks an SM holds."""
    ppl, blocks, threads = kernel_occupancy(build.load(name), name,
                                            num_tiles)
    return (f"{ppl} px/lane, {blocks} blocks of {threads} threads resident "
            f"per SM")


def phase_build() -> None:
    t0 = time.perf_counter()
    names = ["composite_fwd", "composite_bwd"]
    # one nvcc process for each source, all started together
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = dict(zip(names, pool.map(build.build, names)))
    secs = time.perf_counter() - t0
    view_tiles = (2048 // 16) ** 2
    for name, (path, log) in built.items():
        print(f"[build] {name}.cu -> {path.parent.name}/{path.name}; "
              f"ptxas: {ptxas_summary(log)}; over the {view_tiles} tiles of "
              f"a 2048^2 view: {fmt_occupancy(name, view_tiles)}",
              flush=True)
    print(f"[build] both kernels, built together, in {secs:.2f} s",
          flush=True)


def scene_kernel_inputs(dev, res: int):
    """(props, start, count, foreground Gaussians) of the silhouette scene
    (bench.py build_scene) rendered at res^2."""
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
    return props, start, count, int(valid.sum())


def phase_kernel(dev) -> dict:
    res = 512
    props, start, count, num_fg = scene_kernel_inputs(dev, res)
    tiles = res // 16
    err_rgb, err_t, _, _ = compare_composite(props, start, count, tiles,
                                             tiles)
    ms = event_ms(lambda: composite_fwd(props, start, count, tiles, tiles),
                  20)
    plain_ms = event_ms(lambda: composite_fwd_plain(props, start, count,
                                                    tiles, tiles), 1, False)
    print(f"[kernel] composite_fwd at {res}^2 (build_scene, "
          f"{num_fg} fg gaussians, {int(count.sum())} pairs): "
          f"max abs err rgb {err_rgb:.3g} (tolerance {TOL}) T {err_t:.3g} "
          f"(must be 0); kernel {ms:.4f} ms "
          f"({fmt_occupancy('composite_fwd', tiles * tiles)}), plain "
          f"{plain_ms:.2f} ms", flush=True)
    check_fwd(err_rgb, err_t, "at 512^2")

    out = composite_fwd(props, start, count, tiles, tiles)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g_out = torch.randn(out.shape, generator=gen, device=dev)
    err, mag, same, walked, blended, _, stray, _ = compare_composite_bwd(
        props, start, count, out, g_out, tiles, tiles)
    bwd_ms = event_ms(lambda: composite_bwd(props, start, count, out, g_out,
                                            tiles, tiles), 20)
    bwd_plain_ms = event_ms(lambda: composite_bwd_plain(
        props, start, count, out, g_out, tiles, tiles), 1, False)
    build.reset_launch_counts()
    print(f"[kernel-bwd] composite_bwd at {res}^2, same pairs, seeded normal "
          f"cotangents for rgb and T ({walked} pair-pixel evaluations, "
          f"{blended} blended): max abs err per row (mx my ca cb cc op r g b)"
          f" {fmt(err)} beside max abs gradient {fmt(mag)} (tolerance "
          f"{BWD_RTOL} of the row's largest gradient); two launches "
          f"bit-equal: {same}; pairs not 0 where the plain version has 0: "
          f"{stray}; kernel {bwd_ms:.4f} ms "
          f"({fmt_occupancy('composite_bwd', tiles * tiles)}), plain "
          f"{bwd_plain_ms:.2f} ms", flush=True)
    check(same, "composite_bwd gives the same bits twice")
    check(stray == 0, "pairs without gradient keep exactly 0 at 512^2")
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


def phase_oracle(dev) -> None:
    res, n, cam, g, weight = oracle_scene(dev)
    bg = torch.tensor([0.2, 0.2, 0.2], device=dev)
    rcfg = RasterizeConfig(16, 512)

    def oracle(gl):
        return rasterize_reference_single(
            gl.xyz[0], gl.rot[0], gl.scale[0], gl.opacity[0], gl.rgb[0],
            gl.valid[0], cam.view[0], cam.proj[0], cam.tanfovx[0],
            cam.tanfovy[0], res, res, bg)

    img, aux = rasterize(g, cam, bg, rcfg, device=dev)
    err = float((img[0] - oracle(g)).abs().max())
    print(f"[oracle] rasterize on the GPU vs rasterize_reference_single at "
          f"{res}^2, {n} gaussians: max abs err {err:.3g} (tolerance "
          f"{ORACLE_TOL})", flush=True)
    check(err <= ORACLE_TOL and int(aux.num_dropped.sum()) == 0,
          "rasterize vs oracle")

    names = ("xyz", "rot", "scale", "opacity", "rgb")

    def grads(render):
        leaves = {k: getattr(g, k).clone().requires_grad_(True)
                  for k in names}
        (render(dataclasses.replace(g, **leaves)) * weight).sum().backward()
        return [leaves[k].grad for k in names]

    ours = grads(lambda gl: rasterize(gl, cam, bg, rcfg, device=dev)[0])
    ref = grads(lambda gl: oracle(gl)[None])
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    build.reset_launch_counts()
    err = [float((a - b).abs().max()) for a, b in zip(ours, ref)]
    mag = [float(b.abs().max()) for b in ref]
    dead = g.valid[0] < 0.5
    dead_zero = all(bool((a[0][dead] == 0).all()) for a in ours)
    print(f"[grad-oracle] gradients of a seeded weighted image sum through "
          f"rasterize on the GPU vs autograd through "
          f"rasterize_reference_single at {res}^2: max abs err (xyz rot "
          f"scale opacity rgb) {fmt(err)} beside max abs gradient {fmt(mag)} (tolerance "
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
    err_rgb, err_t, work, lock = compare_composite(props, start, count, ty,
                                                   tx, WARP_SHAPES)
    ms = event_ms(lambda: composite_fwd(props, start, count, ty, tx), 20)
    plain_ms = event_ms(lambda: composite_fwd_plain(props, start, count, ty,
                                                    tx), 1, False)
    pairs = int(count.sum())
    num_tiles = start.shape[0]
    nbytes = 36 * pairs + 8 * num_tiles + 16 * num_tiles * 256
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = work * OPS_PER_EVAL / F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"[main-shape] composite_fwd on the serving path's inputs "
          f"({num_tiles} tiles, {pairs} live pairs, {work} pair-pixel "
          f"evaluations needed): max abs err rgb {err_rgb:.3g} (tolerance "
          f"{TOL}) T {err_t:.3g} (must be 0); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms (bytes {t_bytes:.4f} "
          f"ms, ops {t_ops:.4f} ms); "
          f"{fmt_occupancy('composite_fwd', num_tiles)}; lockstep: "
          f"{fmt_lockstep(lock, work)}; projection + pair sort before it "
          f"{prep_ms:.3f} ms", flush=True)
    check_fwd(err_rgb, err_t, "at the serving shape")
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


def training_kernel_inputs(train: dict):
    """(props, start, count, out, g_out, tiles_y, tiles_x) as the training
    step gives them to the composite: one more forward and backward of the
    step's loss, with the composite's saved tensors and its incoming
    cotangent taken from its node in the autograd graph. The launch counts
    are left as they were."""
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
    return props.detach(), start, count, out, g_out, ty, tx


def phase_main_shape_training(train: dict) -> dict:
    """Both kernels on the inputs the training step gives them, after the
    launch counts were read."""
    launches = dict(build.LAUNCHES)
    bwd_args = training_kernel_inputs(train)
    props, start, count, out, g_out, ty, tx = bwd_args

    # the forward kernel over both samples (the serving shape has one)
    err_rgb, err_t, _, _ = compare_composite(props, start, count, ty, tx)
    check(bool(torch.equal(out, composite_fwd(props, start, count, ty, tx))),
          "the step's saved output is the forward kernel's on its inputs")
    err, mag, same, walked, blended, reached, stray, lock = \
        compare_composite_bwd(*bwd_args, WARP_SHAPES)
    ms = event_ms(lambda: composite_bwd(*bwd_args), 20)
    plain_ms = event_ms(lambda: composite_bwd_plain(*bwd_args), 1, False)
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
          f"blended): composite_fwd max abs err rgb {err_rgb:.3g} (tolerance "
          f"{TOL}) T {err_t:.3g} (must be 0), kernel {fwd_ms:.4f} ms; "
          f"composite_bwd max abs err per row (mx my ca cb cc op r g b) "
          f"{fmt(err)} beside max abs gradient {fmt(mag)} (tolerance "
          f"{BWD_RTOL} of the row's largest gradient); two launches "
          f"bit-equal: {same}; pairs not 0 where the plain version has 0: "
          f"{stray}; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
          f"{bound_ms:.4f} ms (bytes {t_bytes:.4f} ms, ops {t_ops:.4f} ms); "
          f"{fmt_occupancy('composite_bwd', num_tiles)}; lockstep: "
          f"{fmt_lockstep(lock, walked)}", flush=True)
    check(batch > 1, "the training shape holds more than one sample")
    check_fwd(err_rgb, err_t, "at the training shape")
    check(stray == 0, "pairs without gradient keep exactly 0 at the "
          "training shape")
    check(same, "composite_bwd gives the same bits twice at the training "
          "shape")
    return {"err": check_bwd_rows(err, mag, "training shape"),
            "fwd_err": max(err_rgb, err_t), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def synth_ds(res: int, scans: dict, phase: str) -> SynthMemoryDataset:
    return SynthMemoryDataset(DatasetConfig(
        data_root="", src_res=res, val_novel_ids=(3,), use_hr_img=True,
        use_processed_data=False), scans, phase)


def start_renders(pool) -> dict:
    """The in-memory synthetic scans of the [trained] and [trained-serving]
    phases, rendered in `pool`'s worker processes: the committed run's 8
    val scans (256^2 sources, 512^2 view 3), 2 train scans (views 2-4 at
    512^2), one test scan, and one val scan's sources at 1024^2. Returns
    the datasets and a callable that waits for the renders."""
    ds = {"val": synth_ds(256, synth_scans("val", 8), "val"),
          "train": synth_ds(256, synth_scans("train", 2), "train"),
          "test": synth_ds(256, synth_scans("train", 1), "test"),
          "serve": synth_ds(1024, synth_scans("val", 1), "test")}
    waits = [ds["serve"].prerender((0, 1), (), pool),
             ds["val"].prerender((0, 1), (3,), pool),
             ds["train"].prerender((0, 1), (2, 3, 4), pool),
             ds["test"].prerender((0, 1), (), pool)]
    return ds, lambda: [w() for w in waits]


def config_with(overrides: dict, **changes):
    cfg = load_config(None, **overrides)
    record = {k: changes.pop(k) for k in ("loss_freq", "eval_freq")
              if k in changes}
    return dataclasses.replace(
        cfg, record=dataclasses.replace(cfg.record, **record), **changes)


def finite_history(trainer) -> bool:
    return all(np.isfinite(v) for row in trainer.history
               for v in row.values())


def fmt_history(trainer, keys) -> str:
    return "; ".join(
        f"step {row['step']}: " + " ".join(
            f"{k} {row[k]:.4f}" for k in keys if k in row)
        + f", {row['step_ms']:.1f} ms, waited {row['data_wait_ms']:.1f} ms"
        for row in trainer.history)


def sum_launches(parts) -> dict:
    total: dict = {}
    for part in parts:
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_trained(dev, ds: dict, exp_root: str) -> dict:
    """The committed run's weights through the dataset-driven path: the
    Trainer's val sweep against the JAX package's, two training steps, then
    load_renderer on the checkpoint they wrote and infer_static."""
    cfg = config_with(SYNTH256_OVERRIDES, stage1_ckpt=TRAINED_CKPT,
                      loss_freq=1, eval_freq=2)
    launches = {}
    t0 = time.perf_counter()
    trainer = Trainer(cfg, exp_dir=os.path.join(exp_root, "trained"),
                      dataset=ds["train"], val_dataset=ds["val"], device=dev)
    n_tensors = len(trainer.model.state_dict())
    built_s = time.perf_counter() - t0
    build.reset_launch_counts()
    (val, sweep_ms) = sync_ms(lambda: trainer.run_eval(0))
    launches["eval"] = dict(build.LAUNCHES)
    drops = [val[k] for k in ("val_num_dropped", "val_num_fg_dropped",
                              "val_num_pair_dropped")]
    d_psnr = val["val_psnr"] - JAX_VAL_PSNR
    d_epe = val["val_epe"] / JAX_VAL_EPE - 1
    print(f"[trained] {TRAINED_CKPT}: {trainer.n_restored} of {n_tensors} "
          f"tensors restored (Trainer built in {built_s:.1f} s); native "
          f"remap active: {native.available()}; "
          f"val sweep over {len(ds['val'])} in-memory synthetic scans "
          f"(256^2 sources, 512^2 view 3, batch {cfg.batch_size}) in "
          f"{sweep_ms:.1f} ms: val_psnr {val['val_psnr']:.6f} dB (JAX "
          f"package on the CPU {JAX_VAL_PSNR}, difference {d_psnr:+.6f}, "
          f"tolerance {PSNR_TOL_DB}), val_epe {val['val_epe']:.6f} (JAX "
          f"{JAX_VAL_EPE}, {100 * d_epe:+.3f}%, tolerance "
          f"{100 * EPE_RTOL}%), val_1px {val['val_1px']:.6f}; drops "
          f"{drops}; launches {launches['eval']}", flush=True)
    check(trainer.n_restored == n_tensors, "every tensor restored")
    check(abs(d_psnr) <= PSNR_TOL_DB, "val_psnr against the JAX package")
    check(abs(d_epe) <= EPE_RTOL, "val_epe against the JAX package")
    check(drops == [0.0, 0.0, 0.0], "no drops on the val sweep")
    check(launches["eval"].get("composite_fwd", 0) == 4,
          "composite_fwd once per eval batch")

    build.reset_launch_counts()
    t1 = time.perf_counter()
    try:
        trainer.train(num_steps=2)
    finally:
        trainer.close()
    launches["train"] = dict(build.LAUNCHES)
    ckpts = sorted(os.listdir(trainer.exp_dir / "ckpt"))
    print(f"[trained] train(): 2 steps, loss_freq 1, eval_freq 2, "
          f"{cfg.dataset.num_workers} spawned loader workers, "
          f"{time.perf_counter() - t1:.1f} s with the sweep and closing: "
          f"{fmt_history(trainer, ('loss', 'l1', 'ssim', 'grad_norm'))}; "
          f"checkpoints {ckpts}; launches {launches['train']}", flush=True)
    check(finite_history(trainer), "finite training metrics")
    check("ckpt_2.pt" in ckpts, "the final checkpoint written")
    check(launches["train"].get("composite_bwd", 0) == 2
          and launches["train"].get("composite_fwd", 0) == 2 + 4,
          "composite_fwd once per step and eval batch, composite_bwd once "
          "per step")

    n_views = 9
    renderer = load_renderer(cfg, str(trainer.exp_dir / "ckpt"), ds["test"],
                             device=dev)
    build.reset_launch_counts()
    images = renderer.infer_static(0, n_views=n_views)
    launches["infer"] = dict(build.LAUNCHES)
    check(len(images) == n_views and all(
        img.shape == (512, 512, 3) and np.isfinite(img).all()
        for img in images), "infer_static images")
    sample = ds["test"].get_test_sample(0)
    batch = collate([sample])
    gauss, fwd_ms = sync_ms(lambda: renderer.gaussians(batch))
    view_ms = []
    for i in range(n_views):
        cam = renderer.novel_camera_at(sample, (i + 0.5) / n_views, 512, 512)
        view_ms.append(sync_ms(lambda: renderer.render(gauss, cam))[1])
    renderer.flush_drop_report()
    print(f"[trained] load_renderer on the step-2 checkpoint, "
          f"infer_static(0, n_views={n_views}) on test scan "
          f"{ds['test'].scans[0]}: {n_views} finite 512^2 images (mean "
          f"{np.mean([img.mean() for img in images]):.4f}); forward "
          f"{fwd_ms:.2f} ms, render ms per view "
          f"{[round(m, 2) for m in view_ms]}; launches {launches['infer']}; "
          f"whole phase {time.perf_counter() - t0:.1f} s", flush=True)
    check(launches["infer"].get("composite_fwd", 0) == n_views,
          "composite_fwd once per view")
    return {"launches": sum_launches(launches.values()),
            "val_psnr": val["val_psnr"]}


def phase_trained_serving(dev, ds: dict) -> dict:
    """The serving frame at stage-2 width on the trained weights and a
    synthetic scan rendered at 1024^2: the first numbers on trained
    traffic (the weights were trained at 256^2)."""
    cfg = load_config(None, **STAGE2_OVERRIDES)
    serve = ds["serve"]
    renderer = load_renderer(cfg, TRAINED_CKPT, serve, device=dev)
    sample = serve.get_test_sample(0)
    batch = collate([sample]).to(dev)
    out_res = 2 * cfg.dataset.src_res
    ratios = (0.25, 0.5, 0.75)
    cams = [renderer.novel_camera_at(sample, r, out_res, out_res)
            for r in ratios]
    renderer.render(renderer.gaussians(batch), cams[0])   # warm-up
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
    for img, aux, _ in renders:
        check(tuple(img.shape) == (1, out_res, out_res, 3)
              and bool(torch.isfinite(img).all()), "trained-serving image")
    props, start, count = kernel_inputs(gauss, cams[1], renderer.rcfg)
    ty, tx = -(-out_res // 16), -(-out_res // 16)
    err_rgb, err_t, work, _ = compare_composite(props, start, count, ty, tx)
    comp_ms = event_ms(lambda: composite_fwd(props, start, count, ty, tx),
                       20)
    build.LAUNCHES.update(launches)
    drops = [(int(a.num_dropped.sum()), int(a.num_fg_dropped.sum()),
              int(a.num_pair_dropped.sum())) for _, a, _ in renders]
    covered = [float((a.transmittance < 0.5).float().mean())
               for _, a, _ in renders]
    print(f"[trained-serving] stage2 width, {TRAINED_CKPT} weights (trained "
          f"at 256^2), synthetic val scan {serve.scans[0]} rendered at "
          f"{cfg.dataset.src_res}^2 -> {out_res}^2 views: forward "
          f"{fwd_ms:.2f} ms; render ms per view "
          f"{[round(m, 2) for _, _, m in renders]}; live gaussians "
          f"{int(gauss.valid.sum())}; composite_fwd at ratio 0.5: "
          f"{int(count.sum())} live pairs, {work} pair-pixel evaluations, "
          f"{comp_ms:.4f} ms (CUDA events, 20 launches), max abs err rgb "
          f"{err_rgb:.3g} T {err_t:.3g}; drops (dup, fg, pair) per view "
          f"{drops}, fg_cap drops {fg_drops}, flushed pair drops "
          f"{pair_drops}; covered pixel share "
          f"{[round(c, 4) for c in covered]}; launches {launches}",
          flush=True)
    check_fwd(err_rgb, err_t, "on trained traffic")
    check(launches.get("composite_fwd", 0) == len(ratios),
          "composite_fwd once per view")
    return {"launches": launches, "err": max(err_rgb, err_t), "gauss": gauss,
            "cam": cams[1], "rcfg": renderer.rcfg, "drops": drops[1][0]}


def phase_trainer(dev, exp_root: str) -> dict:
    """The Trainer at full width on SilhouetteDataset: stage 2 (3 steps,
    the val sweep at step 3, then a resumed run's step 4) with stage2.yaml's
    spawned loader workers, and stage 1 at stage1.yaml's width (batch 6,
    f32, 2 steps, then the val sweep's point-splat preview)."""
    launches = {}
    cfg = config_with(STAGE2_OVERRIDES, loss_freq=1, eval_freq=3)
    res, out_res = cfg.dataset.src_res, 2 * cfg.dataset.src_res
    train_ds = SilhouetteDataset(res, out_res, 8, seed=SEED)
    val_ds = SilhouetteDataset(res, out_res, 2, seed=SEED + 1)
    s2_dir = os.path.join(exp_root, "stage2")
    trainer = Trainer(cfg, exp_dir=s2_dir, dataset=train_ds,
                      val_dataset=val_ds, device=dev)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        trainer.train(num_steps=3)
    finally:
        trainer.close()
    secs = time.perf_counter() - t0
    launches["stage2"] = dict(build.LAUNCHES)
    keys = ("loss", "l1", "ssim", "flow_loss", "grad_norm", "num_dropped")
    print(f"[trainer] stage 2 at stage2 width on SilhouetteDataset "
          f"({res}^2 sources, {out_res}^2 targets, batch {cfg.batch_size}, "
          f"{cfg.dataset.num_workers} spawned loader workers): 3 steps and "
          f"the val sweep at step 3 in {secs:.1f} s: "
          f"{fmt_history(trainer, keys)}; launches {launches['stage2']}",
          flush=True)
    check(finite_history(trainer) and len(trainer.history) == 3,
          "stage-2 metrics logged and finite")
    check(launches["stage2"].get("composite_bwd", 0) == 3
          and launches["stage2"].get("composite_fwd", 0) == 3 + 1,
          "composite_fwd once per step and eval batch, composite_bwd once "
          "per step")

    resumed = Trainer(dataclasses.replace(
        cfg, restore_ckpt=os.path.join(s2_dir, "ckpt")),
        exp_dir=os.path.join(exp_root, "stage2-resumed"), dataset=train_ds,
        val_dataset=val_ds, device=dev)
    start = resumed.state.step
    build.reset_launch_counts()
    try:
        resumed.train(num_steps=4)
    finally:
        resumed.close()
    launches["resumed"] = dict(build.LAUNCHES)
    print(f"[trainer] resumed from {os.path.basename(s2_dir)}/ckpt at step "
          f"{start}: {fmt_history(resumed, keys)}; launches "
          f"{launches['resumed']}", flush=True)
    check(start == 3 and resumed.state.step == 4, "resume at step 3")
    check(finite_history(resumed), "resumed metrics finite")
    check(launches["resumed"].get("composite_bwd", 0) == 1
          and launches["resumed"].get("composite_fwd", 0) == 1,
          "the resumed step launched both kernels once")

    cfg1 = config_with(STAGE1_OVERRIDES, loss_freq=1, eval_freq=10 ** 9)
    res1 = cfg1.dataset.src_res
    s1 = Trainer(cfg1, exp_dir=os.path.join(exp_root, "stage1"),
                 dataset=SilhouetteDataset(res1, res1, 12, seed=SEED),
                 val_dataset=SilhouetteDataset(res1, res1, cfg1.batch_size,
                                               seed=SEED + 1), device=dev)
    t0 = time.perf_counter()
    try:
        s1.train(num_steps=2)
        val = s1.run_eval(2)
    finally:
        s1.close()
    secs = time.perf_counter() - t0
    preview = s1.last_preview
    print(f"[trainer] stage 1 at stage1 width ({res1}^2, batch "
          f"{cfg1.batch_size}, f32, {cfg1.dataset.num_workers} spawned "
          f"loader workers): 2 steps and the val sweep in {secs:.1f} s: "
          f"{fmt_history(s1, ('loss', 'train_epe', 'grad_norm'))}; val "
          f"{ {k: round(v, 4) for k, v in val.items()} }; splat_points "
          f"preview {None if preview is None else preview.shape}, covered "
          f"share {float((preview.sum(-1) > 0).mean()):.4f}", flush=True)
    check(finite_history(s1) and np.isfinite(val["val_epe"]),
          "stage-1 metrics finite")
    check(preview is not None and preview.shape == (res1, res1, 3)
          and np.isfinite(preview).all(), "stage-1 preview image")
    return {"launches": sum_launches(launches.values())}


def bench_camera(res: int, dev):
    """bench.py's camera for build_scene (:108-116): 2 m in front, the
    principal point 25 px below the centre."""
    K = np.array([[0.8 * res, 0, res / 2],
                  [0, 0.8 * res, res / 2 + 25], [0, 0, 1]], np.float32)
    E = np.eye(3, 4, dtype=np.float32)
    E[1, 3] = -0.85
    E[2, 3] = 2.0
    return cameras.make_novel_camera(
        [cameras.camera_from_intr_extr(K, E, res, res)], res, res, dev)


def grad_render(g, cam, bg, cfg, dev, cot=None):
    """rasterize() of g, and with cotangents (image, T) its backward too:
    (image, aux, the gradients of xyz rot scale opacity rgb or None)."""
    if cot is None:
        with torch.no_grad():
            img, aux = rasterize(g, cam, bg, cfg, device=dev)
        return img, aux, None
    leaves = {k: getattr(g, k).clone().requires_grad_(True)
              for k in GRAD_FIELDS}
    img, aux = rasterize(dataclasses.replace(g, **leaves), cam, bg, cfg,
                         device=dev)
    ((img * cot[0]).sum() + (aux.transmittance * cot[1]).sum()).backward()
    return img.detach(), aux, [leaves[k].grad for k in GRAD_FIELDS]


def counters(aux) -> tuple:
    return tuple(int(getattr(aux, f).sum()) for f in
                 ("num_dropped", "num_fg_dropped", "num_pair_dropped"))


def span_schedule_for(spans: torch.Tensor, rows: int) -> tuple:
    """A staircase schedule that gives every row the slots of its span (up
    to 63): one class per K of STAIR_KS, each counting the live rows whose
    span lies in (next K, K]. `spans` are uncapped tile spans."""
    s = torch.clamp(spans[spans > 0], max=STAIR_KS[0])
    sched = []
    for k, lower in zip(STAIR_KS, STAIR_KS[1:] + (0,)):
        c = int(((s > lower) & (s <= k)).sum())
        if c:
            sched.append((k, c))
    check(sum(c for _, c in sched) <= rows, "the schedule covers the rows")
    return tuple(sched)


def span_histogram(spans: torch.Tensor) -> str:
    live = spans[spans > 0]
    edges = (1, 2, 4, 8, 16, 32, 63, 128, 256)
    parts, lo = [], 0
    for hi in edges:
        parts.append(f"{lo + 1}-{hi}: {int(((live > lo) & (live <= hi)).sum())}")
        lo = hi
    parts.append(f">{lo}: {int((live > lo).sum())}")
    return ", ".join(parts) + f" (max {int(live.max())})"


def phase_staircase(dev, frame: dict, res: int = 1024) -> dict:
    """The JAX package's staircase configuration (bench.py) on its 1024^2
    scene, against the uniform-K path; then the trained frame at 2048^2
    with a schedule sized from its span histogram."""
    arrays = build_scene(res)
    g = FlatGaussians(**{k: torch.as_tensor(a, device=dev)[None] for k, a in
                         zip(("xyz", "rot", "scale", "opacity", "rgb",
                              "valid"), arrays)})
    cam = bench_camera(res, dev)
    bg = torch.zeros(3, device=dev)
    stair = RasterizeConfig(**BENCH_RASTER, ellipse_rects=True,
                            span_schedule=BENCH_SCHEDULE)
    legacy = RasterizeConfig(**BENCH_RASTER)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cot = (torch.randn((1, res, res, 3), generator=gen, device=dev),
           torch.randn((1, res, res, 1), generator=gen, device=dev))

    grad_render(g, cam, bg, stair, dev, cot)          # warm-up
    torch.cuda.synchronize()
    build.reset_launch_counts()
    img_s, aux_s, g_s = grad_render(g, cam, bg, stair, dev, cot)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    img_l, aux_l, g_l = grad_render(g, cam, bg, legacy, dev, cot)
    ms = {name: (event_ms(lambda: grad_render(g, cam, bg, cfg, dev), 5),
                 event_ms(lambda: grad_render(g, cam, bg, cfg, dev, cot), 3))
          for name, cfg in (("uniform K 9", legacy), ("staircase", stair))}
    fg_cap = BENCH_RASTER["fg_cap"]
    sort_len = {"uniform K 9": fg_cap * BENCH_RASTER["max_tiles_per_gaussian"],
                "staircase": sum(k * c for k, c in BENCH_SCHEDULE)}
    props, start, count = kernel_inputs(g, cam, stair)
    live = {"uniform K 9": int(kernel_inputs(g, cam, legacy)[2].sum()),
            "staircase": int(count.sum())}

    # a one-class schedule is the uniform path, bit for bit
    one = RasterizeConfig(**BENCH_RASTER, span_schedule=((9, fg_cap),))
    img_1, aux_1, g_1 = grad_render(g, cam, bg, one, dev, cot)
    bit_equal = (torch.equal(img_1, img_l)
                 and torch.equal(aux_1.transmittance, aux_l.transmittance)
                 and all(torch.equal(a, b) for a, b in zip(g_1, g_l))
                 and counters(aux_1) == counters(aux_l))
    # ellipse rectangles against circles, one class of 16
    circle = RasterizeConfig(max_per_tile=2048, fg_cap=fg_cap,
                             span_schedule=((16, fg_cap),))
    ellipse = dataclasses.replace(circle, ellipse_rects=True)
    pairs_ce = [int(kernel_inputs(g, cam, c)[2].sum())
                for c in (circle, ellipse)]
    diff_ce = float((grad_render(g, cam, bg, circle, dev)[0]
                     - grad_render(g, cam, bg, ellipse, dev)[0]).abs().max())

    # both kernels against their plain versions on the staircase's pairs
    ty = tx = res // 16
    err_rgb, err_t, work, _ = compare_composite(props, start, count, ty, tx)
    out = composite_fwd(props, start, count, ty, tx)
    g_out = torch.randn(out.shape, generator=gen, device=dev)
    err, mag, same, walked, blended, _, stray, _ = compare_composite_bwd(
        props, start, count, out, g_out, ty, tx)
    print(f"[staircase] bench.py bench_raster_config() on build_scene("
          f"{res}) (the camera of bench.py:108-116, {int(g.valid.sum())} fg "
          f"gaussians, fg_cap {fg_cap}): schedule {BENCH_SCHEDULE}, ellipse "
          f"rects; pair-sort length {sort_len} (bench.py's docstring: 2.82M "
          f"uniform, 1.39M staircase); live pairs {live}; drops (dup, fg, "
          f"pair) staircase {counters(aux_s)} uniform {counters(aux_l)}; "
          f"render ms forward / forward+backward (CUDA events) "
          f"{ {k: (round(a, 3), round(b, 3)) for k, (a, b) in ms.items()} }; "
          f"one-class schedule ((9, {fg_cap}),) bit-equal to uniform K 9 "
          f"(image, T, gradients, counters): {bit_equal}; one class of 16, "
          f"ellipse vs circle: live pairs {pairs_ce[1]} vs {pairs_ce[0]}, "
          f"max image difference {diff_ce:.4f} (must be < 0.05); on the "
          f"staircase's pairs ({work} evaluations, {walked} walked and "
          f"{blended} blended backward): composite_fwd max abs err rgb "
          f"{err_rgb:.3g} T {err_t:.3g}, composite_bwd max abs err per row "
          f"{fmt(err)} beside {fmt(mag)}, two launches bit-equal {same}, "
          f"stray {stray}; launches {launches}", flush=True)
    check(bit_equal, "the one-class staircase is the uniform path's bits")
    check(pairs_ce[1] <= pairs_ce[0] and diff_ce < 0.05,
          "ellipse rects: no more pairs than circles, image within 0.05")
    check(bool(torch.isfinite(img_s).all())
          and all(bool(torch.isfinite(x).all()) for x in g_s),
          "finite staircase image and gradients")
    check(launches.get("composite_fwd", 0) == 1
          and launches.get("composite_bwd", 0) == 1,
          "the staircase render launched both kernels once")
    check_fwd(err_rgb, err_t, "on the staircase's pairs")
    check(same and stray == 0, "composite_bwd on the staircase's pairs")
    bwd_err = check_bwd_rows(err, mag, "staircase")

    # the trained frame at 2048^2: a schedule from its own span histogram
    gauss, cam2, rcfg2 = frame["gauss"], frame["cam"], frame["rcfg"]
    stacked = projected_rows(gauss, cam2, rcfg2)
    tiles = -(-cam2.height // 16)
    spans = tile_rects(stacked[0, :, 0:2], stacked[0, :, 10], tiles, tiles,
                       16, 1 << 30)[4]
    sched = span_schedule_for(spans, stacked.shape[1])
    cfg2 = dataclasses.replace(rcfg2, span_schedule=sched)
    img_u, aux_u, _ = grad_render(gauss, cam2, bg, rcfg2, dev)
    img_t, aux_t, _ = grad_render(gauss, cam2, bg, cfg2, dev)
    ms2 = [event_ms(lambda: grad_render(gauss, cam2, bg, c, dev), 5)
           for c in (rcfg2, cfg2)]
    live2 = [int(kernel_inputs(gauss, cam2, c)[2].sum())
             for c in (rcfg2, cfg2)]
    print(f"[staircase] the [trained-serving] frame, view 0.5 at "
          f"{cam2.height}^2, {int((spans > 0).sum())} live rows of "
          f"{stacked.shape[1]}: span histogram {span_histogram(spans)}; "
          f"schedule from it {sched}; pair-sort length uniform K "
          f"{rcfg2.max_tiles_per_gaussian} {stacked.shape[1] * rcfg2.max_tiles_per_gaussian}"
          f" vs staircase {sum(k * c for k, c in sched)}; live pairs "
          f"{live2[0]} vs {live2[1]}; drops (dup, fg, pair) uniform "
          f"{counters(aux_u)} (the same view in [trained-serving]: "
          f"{frame['drops']}) vs staircase {counters(aux_t)}; render ms "
          f"{ms2[0]:.3f} vs {ms2[1]:.3f}; covered share "
          f"{float((aux_u.transmittance < 0.5).float().mean()):.4f} vs "
          f"{float((aux_t.transmittance < 0.5).float().mean()):.4f}",
          flush=True)
    check(counters(aux_t)[0] <= counters(aux_u)[0],
          "the sized staircase drops no more duplicates than K 16")
    check(bool(torch.isfinite(img_t).all()), "finite staircase image")
    return {"launches": launches, "err": max(err_rgb, err_t),
            "bwd_err": bwd_err}


def phase_sharded_render(dev, frame: dict) -> dict:
    """The trained frame at 2048^2 rendered band by band (render_band) for
    2 and 4 ranks on the one card: at caps that do not bind against
    rasterize, at the configuration's caps with the drops per band."""
    gauss, cam, rcfg = frame["gauss"], frame["cam"], frame["rcfg"]
    bg = torch.zeros(3, device=dev)
    # caps that do not bind: the groups of 8 rows with a live row, every
    # rectangle whole, every tile's pairs, every band all rows
    groups = int((gauss.valid[0].reshape(-1, 8) > 0).any(1).sum())
    live, _ = compact_valid(gauss, 8 * groups)
    stacked = projected_rows(live, cam, RasterizeConfig())
    tiles = -(-cam.height // 16)
    k_all = int(tile_rects(stacked[0, :, 0:2], stacked[0, :, 10], tiles,
                           tiles, 16, 1 << 30)[4].max())
    _, _, count = kernel_inputs(live, cam, RasterizeConfig(
        max_tiles_per_gaussian=k_all, max_per_tile=1 << 30))
    free = RasterizeConfig(max_tiles_per_gaussian=k_all,
                           max_per_tile=int(count.max()),
                           fg_cap=8 * groups)
    img_1, aux_1, _ = grad_render(live, cam, bg, free, dev)
    build.reset_launch_counts()
    worlds = {}
    for world in (2, 4):
        (img_w, aux_w), ms = sync_ms(lambda: render_bands(
            live, cam, bg, free, world, device=dev))
        worlds[world] = (img_w, aux_w, ms)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    errs = {w: (float((img_w - img_1).abs().max()),
                float((aux_w.transmittance - aux_1.transmittance)
                      .abs().max()), counters(aux_w))
            for w, (img_w, aux_w, _) in worlds.items()}
    ms_1 = sync_ms(lambda: rasterize(live, cam, bg, free, device=dev))[1]

    # the configuration's caps on the frame as served
    per_band, sums = {}, {}
    for world in (2, 4):
        bands = [counters(render_band(gauss, cam, bg, rcfg, r, world,
                                      device=dev)[1]) for r in range(world)]
        per_band[world] = bands
        sums[world] = tuple(map(sum, zip(*bands)))
    whole = counters(rasterize(gauss, cam, bg, rcfg, device=dev)[1])
    print(f"[sharded-render] the [trained-serving] frame, view 0.5 at "
          f"{cam.height}^2, band by band on one card. Caps that do not bind "
          f"({8 * groups} rows, max_tiles_per_gaussian {k_all} = the widest "
          f"span, max_per_tile {int(count.max())}): unsharded counters "
          f"{counters(aux_1)}, {ms_1:.2f} ms; per world (max abs err image, "
          f"T, counters, ms): "
          f"{ {w: (e[0], e[1], e[2], round(worlds[w][2], 2)) for w, e in errs.items()} } "
          f"(tolerance 1e-5, equal counters); at the configuration's caps "
          f"(K {rcfg.max_tiles_per_gaussian}, max_per_tile "
          f"{rcfg.max_per_tile}, band cap by default), drops (dup, fg, pair)"
          f" per band {per_band}, summed {sums}, unsharded {whole}; "
          f"launches {launches}", flush=True)
    check(counters(aux_1) == (0, 0, 0), "the free caps do not bind")
    for w, (e_img, e_t, c) in errs.items():
        check(e_img <= TOL and e_t <= TOL and c == counters(aux_1),
              f"{w} bands against rasterize")
    check(launches.get("composite_fwd", 0) == 6,
          "composite_fwd once per band")
    return {"launches": launches}


def phase_ddp(dev, frame: dict, exp_root: str) -> dict:
    """Two spawned ranks in one gloo group, both on cuda:0: two stage-2 steps
    at batch 1 each against one process at batch 2, the tile-sharded render
    against the band-by-band one, and a world-2 Trainer whose rank-0
    checkpoint resumes at world 1. The steps compared run f32 convolutions,
    so that only the data parallelism and the render's batch dependence
    (DDP_ATOL) part them from one process; the Trainer runs the
    configuration's bf16 and gives its step times."""
    cfg = load_config(None, **STAGE2_OVERRIDES)
    cfg = dataclasses.replace(cfg, raft=dataclasses.replace(
        cfg.raft, mixed_precision=False))
    model = make_model(cfg, with_gs=True)
    init_weights(model, torch.Generator().manual_seed(SEED))
    init = os.path.join(exp_root, "ddp_init.pt")
    torch.save(model.state_dict(), init)
    batch_spec = ("silhouette_train_batch", dict(
        batch=cfg.batch_size, res=cfg.dataset.src_res,
        novel_res=2 * cfg.dataset.src_res, fg_frac=0.2, seed=SEED))
    # the one-process reference: the same two steps at batch 2
    state = create_state(cfg, model, device=dev)
    step = make_train_step(model, cfg, "stage2", make_raster_config(cfg),
                           state, device=dev)
    batch = silhouette_train_batch(**batch_spec[1], device=dev)
    ref = [{k: float(v) for k, v in step(batch).items()} for _ in range(2)]
    ref_params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model, state, step, batch
    torch.cuda.empty_cache()

    gauss = dataclasses.replace(frame["gauss"], **{
        f.name: getattr(frame["gauss"], f.name).cpu()
        for f in dataclasses.fields(frame["gauss"])})
    cam = frame["cam"].to("cpu")
    rank_dev = "cuda:0" if dev.type == "cuda" else "cpu"
    tcfg = config_with(STAGE2_OVERRIDES, loss_freq=1, eval_freq=10 ** 9)
    tcfg = dataclasses.replace(tcfg, dataset=dataclasses.replace(
        tcfg.dataset, num_workers=0))
    res = tcfg.dataset.src_res
    w2_dir = os.path.join(exp_root, "ddp_trainer")
    payloads = [
        ("rank_train_steps", dict(cfg=cfg, init=init, batch=batch_spec,
                                  steps=2, device=rank_dev,
                                  out=os.path.join(exp_root, "ddp_w2.pt"))),
        ("rank_render", dict(gauss=gauss, camera=cam, bg=torch.zeros(3),
                             cfg=frame["rcfg"], device=rank_dev)),
        ("rank_trainer", dict(
            cfg=tcfg, train_ds=SilhouetteDataset(res, 2 * res, 4, seed=SEED),
            val_ds=SilhouetteDataset(res, 2 * res, 2, seed=SEED + 1),
            device=rank_dev, steps=DDP_TRAINER_STEPS, exp_dir=w2_dir,
            out=os.path.join(exp_root, "ddp_trainer_w2.pt")))]
    t0 = time.perf_counter()
    ranks = spawn_ranks("rank_sequence", 2, dict(steps=payloads,
                                                 device=rank_dev),
                        exp_root, timeout=600)
    secs = time.perf_counter() - t0
    steps_out = [r[0] for r in ranks]
    render_out = [r[1] for r in ranks]
    trainer_out = [r[2] for r in ranks]
    launches = sum_launches(out["launches"] for r in ranks for out in r)

    # the steps: metrics and parameters against the one-process run
    w2 = torch.load(os.path.join(exp_root, "ddp_w2.pt"))
    lr_sum = sum(onecycle_linear(cfg.lr, cfg.num_steps + 100)(i)
                 for i in range(2))
    diffs = torch.cat([(w2[k] - v).abs().reshape(-1)
                       for k, v in ref_params.items()])
    within = {f: float((diffs <= f * lr_sum).float().mean())
              for f in (0.02, 0.1)}
    # each metric's distance beyond DDP_RTOL relative, in units of
    # DDP_ATOL: at most 1 passes
    metric_err = max(max(abs(a[k] - b[k]) - DDP_RTOL * abs(b[k]), 0.0)
                     / DDP_ATOL
                     for a, b in zip(steps_out[0]["metrics"], ref)
                     for k in b)
    # the render: the group's against the band-by-band one
    img_b, aux_b = render_bands(frame["gauss"], frame["cam"],
                                torch.zeros(3, device=dev), frame["rcfg"], 2,
                                device=dev)
    render_same = all(torch.equal(o["img"], img_b.cpu())
                      and torch.equal(o["trans"], aux_b.transmittance.cpu())
                      and tuple(o["counters"]) == counters(aux_b)
                      for o in render_out)
    # the Trainer: rank 0's checkpoint resumed at world 1
    resumed = Trainer(dataclasses.replace(
        tcfg, restore_ckpt=os.path.join(w2_dir, "ckpt")),
        exp_dir=os.path.join(exp_root, "ddp_resumed"),
        dataset=SilhouetteDataset(res, 2 * res, 4, seed=SEED),
        val_dataset=SilhouetteDataset(res, 2 * res, 2, seed=SEED + 1),
        device=dev)
    try:
        saved = torch.load(os.path.join(exp_root, "ddp_trainer_w2.pt"))
        restored = resumed.state.step == DDP_TRAINER_STEPS and all(
            torch.equal(v.cpu(), saved[k])
            for k, v in resumed.model.state_dict().items())
    finally:
        resumed.close()
    keys = ("loss", "l1", "ssim", "flow_loss", "grad_norm")
    trainer_ms = [[(round(row["step_ms"], 1), round(row["data_wait_ms"], 1))
                   for row in o["history"]] for o in trainer_out]
    print(f"[ddp] 2 spawned ranks, one gloo group, both on cuda:0, stage2 "
          f"width, {secs:.1f} s with spawning: f32 steps at batch 1 per rank "
          f"(global batch {cfg.batch_size}), step ms per rank "
          f"{[[round(m, 1) for m in o['step_ms']] for o in steps_out]}, peak "
          f"memory per rank "
          f"{[o['peak_gib'] and round(o['peak_gib'], 2) for o in steps_out]}"
          f" GiB; metrics "
          f"{[{k: round(m[k], 5) for k in keys} for m in steps_out[0]['metrics']]}"
          f" vs one process at batch 2 "
          f"{[{k: round(m[k], 5) for k in keys} for m in ref]} (tolerance "
          f"{DDP_RTOL} relative + {DDP_ATOL} absolute; the largest excess "
          f"over the relative part is {metric_err:.3f} of the absolute); "
          f"parameters after 2 steps: largest difference {float(diffs.max()):.3g}"
          f" against the two steps' learning rates {lr_sum:.3g}, share within"
          f" 2% of them {within[0.02]:.4f}, within 10% {within[0.1]:.4f}; "
          f"rasterize_tile_sharded on the group equals the band-by-band "
          f"render bit for bit: {render_same} (counters "
          f"{render_out[0]['counters']}); world-2 Trainer: checkpoints "
          f"{trainer_out[0]['ckpts']}, history "
          f"{[{k: round(row[k], 4) for k in keys} for row in trainer_out[0]['history']]}"
          f", bf16 step ms and data wait ms per rank {trainer_ms}, peak "
          f"memory per rank "
          f"{[o['peak_gib'] and round(o['peak_gib'], 2) for o in trainer_out]}"
          f" GiB, val "
          f"{trainer_out[0]['val']}, resumed at world 1 with the same "
          f"parameters: {restored}; launches {launches}", flush=True)
    check(all(o["metrics"] == steps_out[0]["metrics"] for o in steps_out),
          "every rank reduces its metrics alike")
    check(metric_err <= 1.0, "world-2 metrics against one process")
    check(float(diffs.max()) <= 1.01 * lr_sum * 3.2 and within[0.1] >= 0.9,
          "world-2 parameters against one process")
    check(render_same, "the group's render is the band-by-band render")
    check(trainer_out[0]["ckpts"] == [f"ckpt_{i + 1}.pt" for i in
                                      range(DDP_TRAINER_STEPS)] and restored,
          "rank-0 checkpoints resume at world 1")
    check(launches.get("composite_fwd", 0) == 2 * (2 + 1 + DDP_TRAINER_STEPS)
          and launches.get("composite_bwd", 0) == 2 * (2 + DDP_TRAINER_STEPS),
          "every rank launched both kernels in each step and the render")
    return {"launches": launches}


def timed_raster(verts, faces, uv, tex, res: int, reps: int = 3):
    """The C++ mesh rasterizer's host ms for one res^2 view of a normalised
    scan from the ring (the median of `reps` calls), as render_scan_views
    calls it."""
    intr, extr = ring_camera(0.3, res)
    color = np.full((len(verts), 3), 0.7, np.float32)
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        native.rasterize_mesh(verts, faces, color, intr, extr, res, res,
                              uv=uv, tex=tex)
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def phase_scans(dev, work_dir: str, res: int = 1024) -> dict:
    """Scan rendering on the host, then the rendered val scan through the
    trained renderer on the card: two seeded textured humanoids (OBJ +
    png), render_dataset at res^2 with (2 res)^2 targets, StereoHumanDataset
    on the tree (v2 cache), view 3 rendered at (2 res)^2 on the committed
    weights, composite_fwd held to its plain version, the PSNR against
    3_hr.jpg printed. Without Pillow, write_scan raises and the run
    fails."""
    check(native.available(), "the C++ mesh rasterizer is built")
    t0 = time.perf_counter()
    scans = os.path.join(work_dir, "scans")
    out = os.path.join(work_dir, "tree")
    meshes = [humanoid_mesh(SEED + i) for i in range(2)]
    for i, mesh in enumerate(meshes):
        write_scan(scans, f"{i:04d}", *mesh)
    made_s = time.perf_counter() - t0
    scan_s, t1 = [], time.perf_counter()
    done = []
    for name, split in render_scans.render_dataset(scans, out, res=res,
                                                   hr=True, val_every=2):
        done.append((name, split))
        scan_s.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
    check(done == [("0000", "train"), ("0001", "val")], "two scans rendered")
    verts, faces, uv = render_scans.read_obj(
        os.path.join(scans, "0001", "0001.obj"))
    verts = render_scans.normalize_scan(verts)
    ms_1k = timed_raster(verts, faces, uv, meshes[1][3], res)
    ms_2k = timed_raster(verts, faces, uv, meshes[1][3], 2 * res)
    n_files = sum(len(f) for _, _, f in os.walk(out))

    cfg = load_config(None, **STAGE2_OVERRIDES)
    cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(
        cfg.dataset, src_res=res))
    ds = StereoHumanDataset(DatasetConfig(
        data_root=out, src_res=res, val_novel_ids=(3,), use_hr_img=True,
        use_processed_data=True), "val")
    check(ds.scans == ["0001"], "the val split holds scan 0001")
    t2 = time.perf_counter()
    sample = ds.get_sample(0, (3,), np.random.default_rng(SEED))
    read_s = time.perf_counter() - t2
    batch = collate([sample])
    renderer = load_renderer(cfg, TRAINED_CKPT, ds, device=dev)
    cam = batch.novel.camera.to(dev)
    out_res = cam.height

    build.reset_launch_counts()
    gauss, fwd_ms = sync_ms(lambda: renderer.gaussians(batch))
    (img, aux), view_ms = sync_ms(lambda: renderer.render(gauss, cam))
    launches = dict(build.LAUNCHES)
    fg_drops, pair_drops = renderer.flush_drop_report()
    target = batch.novel.img.to(dev)
    check(tuple(img.shape) == tuple(target.shape) == (1, 2 * res, 2 * res, 3)
          and bool(torch.isfinite(img).all()), "scan view 3 image")
    psnr = float(losses.psnr(img, target)[0])
    props, start, count = kernel_inputs(gauss, cam, renderer.rcfg)
    tiles = -(-out_res // 16)
    err_rgb, err_t, work, _ = compare_composite(props, start, count, tiles,
                                                tiles)
    print(f"[scans] {len(done)} seeded humanoid scans, {len(faces)} "
          f"triangles and {len(verts)} vertices each, 1024^2 texture, made "
          f"and written as OBJ + png in {made_s:.2f} s; render_dataset(res="
          f"{res}, hr=True, val_every=2) {done}: {n_files} files, "
          f"{[round(x, 2) for x in scan_s]} s a scan (OBJ read, 5 views, 3 "
          f"{2 * res}^2 targets, image writes); C++ rasterizer "
          f"({os.cpu_count()} host cores, min(cores, 16) threads) "
          f"{ms_1k:.1f} ms a {res}^2 view, {ms_2k:.1f} ms a {2 * res}^2 _hr "
          f"view "
          f"(host clock, median of 3); StereoHumanDataset val sample (v2 "
          f"cache built) in {read_s:.2f} s; trained weights {TRAINED_CKPT}: "
          f"forward {fwd_ms:.2f} ms, view 3 at {out_res}^2 {view_ms:.2f} ms, "
          f"{int(gauss.valid.sum())} live gaussians, drops (dup, fg, pair) "
          f"{counters(aux)}, flushed fg {fg_drops} pair {pair_drops}; PSNR "
          f"against 3_hr.jpg {psnr:.4f} dB (printed, not gated); "
          f"composite_fwd {int(count.sum())} live pairs, {work} pair-pixel "
          f"evaluations, max abs err rgb {err_rgb:.3g} T {err_t:.3g}; "
          f"launches {launches}; whole phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(np.isfinite(psnr), "finite PSNR")
    check_fwd(err_rgb, err_t, "on the rendered scan")
    check(launches.get("composite_fwd", 0) == 1, "composite_fwd once")
    return {"launches": launches, "err": max(err_rgb, err_t)}


def phase_reference_import(dev, ds: dict, work_dir: str) -> dict:
    """The committed weights as a reference .pth ({'network': state_dict})
    through load_reference_checkpoint: the [trained-serving] frame's view
    0.5 bit-equal to load_renderer's; then a stage-1 file (no
    gs_parm_regresser.*) through restore_params_partial."""
    cfg = load_config(None, **STAGE2_OVERRIDES)
    params = torch.load(os.path.join(TRAINED_CKPT, "ckpt_1200.pt"),
                        map_location="cpu", weights_only=True)["params"]
    path = os.path.join(work_dir, "reference.pth")
    torch.save({"network": params}, path)
    path1 = os.path.join(work_dir, "reference_stage1.pth")
    torch.save({"network": {k: v for k, v in params.items()
                            if not k.startswith("gs_parm_regresser.")}},
               path1)
    serve = ds["serve"]
    renderers = [load_renderer(cfg, TRAINED_CKPT, serve, device=dev),
                 FreeviewRenderer(cfg, load_reference_checkpoint(path), serve,
                                  device=dev)]
    sample = serve.get_test_sample(0)
    batch = collate([sample]).to(dev)
    out_res = 2 * cfg.dataset.src_res
    cam = renderers[0].novel_camera_at(sample, 0.5, out_res, out_res)

    build.reset_launch_counts()
    outs = []
    for r in renderers:
        outs.append(r.render(r.gaussians(batch), cam))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    (img_a, aux_a), (img_b, aux_b) = outs
    same = (torch.equal(img_a, img_b)
            and torch.equal(aux_a.transmittance, aux_b.transmittance)
            and counters(aux_a) == counters(aux_b))

    model = make_model(cfg, with_gs=True)
    n_stage1 = len(make_model(cfg, with_gs=False).state_dict())
    n = restore_params_partial(load_reference_checkpoint(path1), model)
    print(f"[reference-import] {TRAINED_CKPT}/ckpt_1200.pt written as a "
          f"reference .pth ({{'network': state_dict}}, {len(params)} "
          f"tensors) and read by load_reference_checkpoint: the "
          f"[trained-serving] frame's {out_res}^2 view 0.5 image, T and drop "
          f"counters {counters(aux_b)} bit-equal to load_renderer's: {same}; "
          f"a stage-1 file ({n_stage1} tensors) through "
          f"restore_params_partial into a stage-2 model: {n} of "
          f"{len(model.state_dict())} tensors restored; launches {launches}",
          flush=True)
    check(same, "the imported weights render load_renderer's bits")
    check(n == n_stage1, "every stage-1 tensor restored")
    check(launches.get("composite_fwd", 0) == 2, "composite_fwd per render")
    return {"launches": launches}


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
    try:
        import PIL
        pil = f"Pillow {PIL.__version__} imports"
    except ImportError:
        pil = "no Pillow"
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{smi}; {pil} ([scans] needs it)", flush=True)

    # the synthetic scans of the dataset phases render on the host while the
    # kernels build and are checked; the timed phases start after them
    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(os.cpu_count(),
                               mp_context=mp.get_context("spawn"))
    datasets, wait_renders = start_renders(pool)
    phase_build()
    k512 = phase_kernel(dev)
    phase_oracle(dev)
    wait_renders()
    pool.shutdown()
    print(f"[renders] {sum(len(d._views) for d in datasets.values())} "
          f"synthetic views rendered in worker processes, "
          f"{time.perf_counter() - t0:.1f} s after they started", flush=True)
    serv = phase_serving(dev)
    train = phase_training(dev)
    if argv[:1] == ["--profile"]:
        phase_profile(serv, train, argv[1])
    main_f = phase_main_shape(serv)
    main_b = phase_main_shape_training(train)
    # the training state (13 GiB at batch 2) is not needed again
    del train["step"], train["batch"]
    torch.cuda.empty_cache()
    exp_root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        trained = phase_trained(dev, datasets, exp_root)
        trained_serv = phase_trained_serving(dev, datasets)
        trainer = phase_trainer(dev, exp_root)
        stair = phase_staircase(dev, trained_serv)
        sharded = phase_sharded_render(dev, trained_serv)
        ddp = phase_ddp(dev, trained_serv, exp_root)
        scans = phase_scans(dev, exp_root)
        imported = phase_reference_import(dev, datasets, exp_root)
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    paths = {"serving": serv, "training": train, "trained": trained,
             "trained_serving": trained_serv, "trainer": trainer,
             "staircase": stair, "sharded_render": sharded, "ddp": ddp,
             "scans": scans, "reference_import": imported}

    def launches(name):
        per = {f"launches_{path}": out["launches"].get(name, 0)
               for path, out in paths.items()}
        return {"launches": sum(per.values()), **per}

    kernels = [{
        "name": "composite_fwd", "route": "cuda", "source": FWD_SRC,
        "replaces": f"{PALLAS}:767", **launches("composite_fwd"),
        "max_abs_err": max(k512["err"], main_f["err"], main_b["fwd_err"],
                           trained_serv["err"], stair["err"], scans["err"]),
        "ms": main_f["ms"], "plain_ms": main_f["plain_ms"],
        "bound_ms": main_f["bound_ms"], "bound_by": main_f["bound_by"],
        "library_ms": None}, {
        "name": "composite_bwd", "route": "cuda", "source": BWD_SRC,
        "replaces": f"{PALLAS}:836", **launches("composite_bwd"),
        "max_abs_err": max(k512["bwd_err"], main_b["err"], stair["bwd_err"]),
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
