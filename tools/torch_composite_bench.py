#!/usr/bin/env python
"""Time builds of the PyTorch port's two composite kernels side by side, on
one NVIDIA GPU, on the inputs chip_smoke.py gives them.

    python3 tools/torch_composite_bench.py [--shapes 512|1024|2048|main]
        [--parent-csrc DIR] [--sweep] [--ablate] [--cap-sweep] [--json FILE]

Every build exports the C functions of gps_gaussian_tpu_torch/csrc/
composite_fwd.cu and composite_bwd.cu and is launched through the same
ctypes signature:

  shipped        the sources as they stand, with their default constants
  parent         DIR/composite_fwd.cu and DIR/composite_bwd.cu, an earlier
                 commit's kernels (unpack them with `git archive`), so that
                 before and after come from one card in one process
  --sweep        the shipped sources with other tuning constants
                 (-DCOMPOSITE_*_PPL, -DCOMPOSITE_*_SUB_W,
                 -DCOMPOSITE_*_CULL): pixels per lane, the shape of a warp's
                 row, and the conservative row cull on or off
  --ablate       throw-away copies of the shipped and the parent sources
                 with one part taken out by a textual patch (the reduction,
                 the gradient arithmetic, the stores). Their results are
                 wrong by design; the time that goes missing says what the
                 part costs. The copies live under build/ and are not kept.

With --cap-sweep the forward builds are also timed at the serving shape with
every tile's segment cut to at most 4096 ... 128 pairs, beside the evaluations
each cut still needs: a time that falls faster than the work says that the
kernel waits for its longest tiles.

Shapes: `512` is the silhouette scene at 512^2 (seconds; use it to see that a
new source builds and agrees with the plain version), `1024` the same scene
at 1024^2 (between the two in tiles: which pixels per lane a launch picks
depends on its tile count), `main` the serving
path's inputs (one 2048^2 view) for the forward and the stage-2 training
step's inputs (two 2048^2 samples) for both kernels.

Each build is timed with CUDA events over 20 launches after a warm-up, twice:
once in the listed order and once in reverse, so a drift of the card shows.
A shipped or swept build is held to the plain version (shipped) or to the
shipped build (swept): T bit-equal, rgb within 1e-5, gradient rows within
1e-4 of the row's largest. The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from gps_gaussian_tpu_torch.kernels import build  # noqa: E402
from gps_gaussian_tpu_torch.kernels.rasterizer.composite import (  # noqa: E402
    composite_bwd_plain, composite_fwd_plain, kernel_occupancy, launch_bwd,
    launch_fwd)

REPS = 20
# (pixels per lane, row width, row cull): every count of pixels per lane
# with 8x4 rows, with and without the cull, and 16x2 strips with it
SWEEP = [(ppl, 8, cull) for ppl in (1, 2, 4, 8) for cull in (1, 0)] \
    + [(ppl, 16, 1) for ppl in (1, 2, 4, 8)]
# the forward's independent warps per block, at 1 and 2 pixels per lane
SWEEP_FWD_WARPS = [(ppl, warps) for ppl in (1, 2) for warps in (1, 2, 8)]

# (label, [(old, new), ...]) applied to the shipped composite_bwd.cu
ABLATE_BWD = [
    ("shipped - butterfly (lane keeps its own sum of nine)", [(
        "const float s = butterfly9(v, lane);",
        "const float s = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) "
        "+ (v[6] + v[7])) + v[8];")]),
    ("shipped - gradient arithmetic (decision chain, butterfly of alpha)", [(
        "BLOCK:          any = true;\n:          v[8] = __fmaf_rn(gz[q], w, "
        "v[8]);\n", "          any = true;\n          v[0] += alpha;\n")]),
    ("shipped - gradient stores", [(
        "gprops[k * num_pairs + seg + base + lane] = factor * s;",
        "if (s == 123.456f) gprops[k * num_pairs + seg + base + lane] = s;")]),
]
# applied to the shipped composite_fwd.cu
ABLATE_FWD = [
    ("shipped - colour accumulation", [(
        "BLOCK:        r[q] = __fmaf_rn(w, C.x, r[q]);\n:        b[q] = "
        "__fmaf_rn(w, C.z, b[q]);\n", "        r[q] += w;\n")]),
]
# applied to the parent's composite_bwd.cu (one thread per pixel, nine
# shuffle trees per blending warp and pair)
ABLATE_PARENT_BWD = [
    ("parent - shuffle trees (lane 0 stores its own value)", [(
        "#pragma unroll\n"
        "        for (int off = 16; off > 0; off >>= 1)\n"
        "          x += __shfl_down_sync(kFull, x, off);\n", "")]),
    ("parent - zero stores of warps that do not blend", [
        ("        if (lane < kProps) part[warp][lane][j] = 0.0f;\n", ""),
        ("            part[warp][k][jj] = 0.0f;\n", "")]),
    ("parent - gradient stores", [(
        "gprops[k * num_pairs + seg + base + j] = s;",
        "if (s == 123.456f) gprops[k * num_pairs + seg + base + j] = s;")]),
    ("parent - trees, zero stores and gradient stores", [
        ("#pragma unroll\n"
         "        for (int off = 16; off > 0; off >>= 1)\n"
         "          x += __shfl_down_sync(kFull, x, off);\n", ""),
        ("        if (lane < kProps) part[warp][lane][j] = 0.0f;\n", ""),
        ("            part[warp][k][jj] = 0.0f;\n", ""),
        ("gprops[k * num_pairs + seg + base + j] = s;",
         "if (s == 123.456f) gprops[k * num_pairs + seg + base + j] = s;")]),
]


def patched(src: Path, patches, out: Path) -> Path:
    """Write `src` with every (old, new) applied exactly once to `out`. An
    `old` of the form "BLOCK:<first line>:<last line>" stands for the text
    from the first line through the last."""
    text = src.read_text()
    for old, new in patches:
        if old.startswith("BLOCK:"):
            first, last = old[len("BLOCK:"):].split("\n:")
            first += "\n"
            i = text.index(first)
            old = text[i:text.index(last, i) + len(last)]
        if text.count(old) != 1:
            raise RuntimeError(f"patch does not apply once to {src}: {old!r}")
        text = text.replace(old, new)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def load_variant(name: str, defines=(), src=None):
    """(library, ptxas report) of one build."""
    path, log = build.build(name, defines, src)
    return ctypes.CDLL(str(path)), cs.ptxas_summary(log)


def occupancy(lib, name: str, num_tiles: int):
    """(pixels per lane, blocks per SM, threads per block) of the kernel
    `lib` launches over `num_tiles` tiles, or None: an earlier commit's
    library has no such export."""
    try:
        return kernel_occupancy(lib, name, num_tiles)
    except AttributeError:
        return None


_VARIANTS: dict = {}


def variants(name: str, args) -> list:
    """[(label, lib, ptxas, checked)] for kernel `name`, all
    compiled together, once."""
    if name in _VARIANTS:
        return _VARIANTS[name]
    tag = name.split("_")[1].upper()
    specs = [("shipped", (), None, True)]   # label, defines, source, checked
    scratch = build.BUILD_ROOT / "variants"
    if args.parent_csrc:
        parent = Path(args.parent_csrc) / f"{name}.cu"
        specs.append(("parent", (), parent, False))
        if args.ablate and name == "composite_bwd":
            for i, (label, patches) in enumerate(ABLATE_PARENT_BWD):
                src = patched(parent, patches,
                              scratch / f"parent_{name}_{i}.cu")
                specs.append((label, (), src, False))
    if args.sweep:
        for ppl, sub_w, cull in SWEEP:
            defines = (f"COMPOSITE_{tag}_PPL={ppl}",
                       f"COMPOSITE_{tag}_SUB_W={sub_w}",
                       f"COMPOSITE_{tag}_CULL={cull}")
            specs.append((f"{ppl} px/lane, {sub_w}x{32 // sub_w} rows, "
                          f"{'with' if cull else 'no'} row cull", defines,
                          None, True))
    if args.sweep and name == "composite_fwd":
        for ppl, warps in SWEEP_FWD_WARPS:
            specs.append((f"{ppl} px/lane, {warps} warps per block",
                          (f"COMPOSITE_FWD_PPL={ppl}",
                           f"COMPOSITE_FWD_WARPS={warps}"), None, True))
    if args.ablate:
        shipped = build.CSRC / f"{name}.cu"
        table = ABLATE_BWD if name == "composite_bwd" else ABLATE_FWD
        for i, (label, patches) in enumerate(table):
            src = patched(shipped, patches, scratch / f"{name}_{i}.cu")
            specs.append((label, (), src, False))
    with ThreadPoolExecutor(max_workers=8) as pool:
        built = list(pool.map(
            lambda sp: load_variant(name, sp[1], sp[2]), specs))
    _VARIANTS[name] = [(sp[0], *b, sp[3]) for sp, b in zip(specs, built)]
    return _VARIANTS[name]


def time_rows(rows, launch) -> list:
    """Each row's ms, in the listed order and then in reverse."""
    first = [cs.event_ms(lambda lib=lib: launch(lib), REPS)
             for _, lib, *_ in rows]
    second = [cs.event_ms(lambda lib=lib: launch(lib), REPS)
              for _, lib, *_ in reversed(rows)][::-1]
    return list(zip(first, second))


def bench_fwd(what, inputs, args, results) -> None:
    props, start, count, ty, tx = inputs
    rows = variants("composite_fwd", args)

    def launch(lib):
        return launch_fwd(lib, props, start, count, ty, tx)

    ref = launch(rows[0][1])
    plain = composite_fwd_plain(props, start, count, ty, tx)
    torch.cuda.synchronize()
    cs.check_fwd(float((ref[..., :3] - plain[..., :3]).abs().max()),
                 float((ref[..., 3] - plain[..., 3]).abs().max()),
                 f"shipped, {what}")
    times = time_rows(rows, launch)
    for (label, lib, ptxas, checked), (a, b) in zip(rows, times):
        occ = occupancy(lib, "composite_fwd", start.shape[0])
        out = launch(lib)
        err_rgb = float((out[..., :3] - ref[..., :3]).abs().max())
        t_equal = bool(torch.equal(out[..., 3], ref[..., 3]))
        if checked:
            cs.check(err_rgb <= cs.TOL and t_equal, f"{label}, {what}: rgb "
                     f"{err_rgb}, T equal {t_equal}")
        row = {"kernel": "composite_fwd", "shape": what, "build": label,
               "ms": a, "ms_reverse_order": b, "ptxas": ptxas,
               "pixels_per_lane": occ[0] if occ else None,
               "blocks_per_sm": occ[1] if occ else None,
               "threads": occ[2] if occ else None,
               "max_abs_rgb_vs_shipped": err_rgb, "T_equal": t_equal}
        results.append(row)
        print(f"[fwd {what}] {label}: {a:.4f} ms, {b:.4f} ms in reverse "
              f"order; {ptxas}; (px/lane, blocks/SM, threads) {occ}; rgb vs "
              f"shipped {err_rgb:.3g}, T equal {t_equal}", flush=True)


def bench_bwd(what, inputs, args, results) -> None:
    props, start, count, out, g_out, ty, tx = inputs
    rows = variants("composite_bwd", args)

    def launch(lib):
        return launch_bwd(lib, props, start, count, out, g_out, ty, tx)

    ref = launch(rows[0][1])
    plain = composite_bwd_plain(props, start, count, out, g_out, ty, tx)
    torch.cuda.synchronize()
    mag = plain.abs().amax(dim=1)
    cs.check_bwd_rows((ref - plain).abs().amax(dim=1).tolist(), mag.tolist(),
                      f"shipped, {what}")
    times = time_rows(rows, launch)
    for (label, lib, ptxas, checked), (a, b) in zip(rows, times):
        occ = occupancy(lib, "composite_bwd", start.shape[0])
        got = launch(lib)
        again = launch(lib)
        rel = float(((got - ref).abs().amax(dim=1) / mag).max())
        same = bool(torch.equal(got, again))
        if checked:
            cs.check(rel <= cs.BWD_RTOL and same, f"{label}, {what}: row "
                     f"error {rel}, two launches equal {same}")
        row = {"kernel": "composite_bwd", "shape": what, "build": label,
               "ms": a, "ms_reverse_order": b, "ptxas": ptxas,
               "pixels_per_lane": occ[0] if occ else None,
               "blocks_per_sm": occ[1] if occ else None,
               "threads": occ[2] if occ else None,
               "max_row_rel_err_vs_shipped": rel, "two_launches_equal": same}
        results.append(row)
        print(f"[bwd {what}] {label}: {a:.4f} ms, {b:.4f} ms in reverse "
              f"order; {ptxas}; (px/lane, blocks/SM, threads) {occ}; largest "
              f"row error vs shipped {rel:.3g} of the row's largest gradient; "
              f"two launches equal {same}", flush=True)


def cap_sweep(what, inputs, args, results) -> None:
    """The forward kernels with every segment cut to at most `cap` pairs:
    if the time falls faster than the evaluations needed, the kernel waits
    for its longest tiles (a tile's walk is sequential) more than it works."""
    props, start, count, ty, tx = inputs
    rows = [r for r in variants("composite_fwd", args)
            if r[0] in ("shipped", "parent")]
    for cap in (4096, 2048, 1024, 512, 256, 128):
        capped = torch.clamp_max(count, cap)
        _, work, lock = composite_fwd_plain(
            props, start, capped, ty, tx, return_work=True,
            warp_shapes=((8, 4),))
        longest = int(capped.max())
        times = {label: cs.event_ms(
            lambda lib=lib: launch_fwd(lib, props, start, capped, ty, tx),
            REPS) for label, lib, *_ in rows}
        results.append({"kernel": "composite_fwd", "shape": what,
                        "cap": cap, "longest_segment": longest,
                        "evaluations": int(work),
                        "tile_walked": lock["tile_walked"], "ms": times})
        print(f"[cap {what}] segments cut to {cap} pairs (longest "
              f"{longest}): {int(work)} evaluations needed, "
              f"{lock['tile_walked']} tile-pairs walked; "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", choices=("512", "1024", "2048", "main"),
                    default="main")
    ap.add_argument("--parent-csrc")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--cap-sweep", action="store_true")
    ap.add_argument("--json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_composite_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {smi}",
          flush=True)

    results: list = []
    if args.shapes != "main":
        res = int(args.shapes)
        props, start, count, _ = cs.scene_kernel_inputs(dev, res)
        tiles = res // 16
        what = f"{res}^2 scene"
        bench_fwd(what, (props, start, count, tiles, tiles), args, results)
        out = launch_fwd(build.load("composite_fwd"), props, start, count,
                         tiles, tiles)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        g_out = torch.randn(out.shape, generator=gen, device=dev)
        bench_bwd(what, (props, start, count, out, g_out, tiles, tiles), args,
                  results)
    else:
        serv = cs.phase_serving(dev)
        cam = serv["cam"]
        props, start, count = cs.kernel_inputs(serv["gauss"], cam,
                                               serv["renderer"].rcfg)
        ty, tx = -(-cam.height // 16), -(-cam.width // 16)
        del serv
        bench_fwd("serving shape", (props, start, count, ty, tx), args,
                  results)
        if args.cap_sweep:
            cap_sweep("serving shape", (props, start, count, ty, tx), args,
                      results)
        del props, start, count
        torch.cuda.empty_cache()
        train = cs.phase_training(dev)
        inputs = cs.training_kernel_inputs(train)
        del train
        torch.cuda.empty_cache()
        props, start, count, out, g_out, ty, tx = inputs
        bench_fwd("training shape", (props, start, count, ty, tx), args,
                  results)
        bench_bwd("training shape", inputs, args, results)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "reps": REPS, "rows": results}, f,
                      indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
