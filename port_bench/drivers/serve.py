"""Free-view serving through the inference tools' own path: the port's
`FreeviewRenderer` on the configuration's checkpoint, over the port's
`StereoHumanDataset` in test mode reading the mix's frames from disk.

One closed-loop client: a frame starts when the last one has ended, and
runs from the dataset read (decode and online rectification) to the last
view's image in host memory. The mix's `entry` picks the tool:
`sequence` is `infer_sequence(ratio)` (test_real_data), one view a frame;
`static` is `infer_static(i, n_views)` (test_view_interp), n_views views
at ratios (k + 0.5) / n_views. Frames are cycled in order.

Spans (traced runs) wrap the instances this driver built: the dataset's
`get_test_sample` (host clock, `read`), the renderer's `gaussians`
(`forward`) and `render` (`render`) (CUDA events). The same wrappers keep
the program's answers for the frames the seed picks for the check.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from port_bench import harness, judge, roofline
from port_bench.reference import pipeline, quant
from port_bench.traffic import frames


def drop_half(valid: torch.Tensor) -> torch.Tensor:
    """`valid` (1, N) with its second half of valid rows set to 0: after
    compaction the left view's rows come first, so this is about the right
    view's Gaussians."""
    idx = torch.nonzero(valid[0] > 0.5)[:, 0]
    out = valid.clone()
    out[0, idx[idx.numel() // 2:]] = 0.0
    return out


class ServeRun:
    def __init__(self, cell: harness.Cell, ctx: harness.Ctx):
        self.cell, self.ctx = cell, ctx
        self.mix = cell.traffic
        self.recipe = cell.config["recipe"]
        self.current = None
        self.kept = {}
        self.profiled_views = []
        self.keep_views = False

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        from gps_gaussian_tpu_torch.data.thuman import (DatasetConfig,
                                                        StereoHumanDataset)
        from gps_gaussian_tpu_torch.infer.freeview import load_renderer
        from gps_gaussian_tpu_torch.train.config import load_config

        ctx, mix = self.ctx, self.mix
        phase = harness.Phases()
        self.cfg = cfg = load_config(None, **self.recipe)
        if mix["res"] != cfg.dataset.src_res:
            raise ValueError(f"the mix's frames are {mix['res']}^2, the "
                             f"configuration's sources {cfg.dataset.src_res}^2")
        self.frames_dir = ctx.tmp / "frames"
        self.names = frames.write_sequence(self.frames_dir, mix, ctx.seed,
                                           ctx.device)
        phase("frames")
        n = len(self.names)
        self.checked = sorted(int(i) for i in np.random.default_rng(
            ctx.seed).choice(n, size=min(self.cell.workload["check_frames"],
                                         n), replace=False))
        self.dataset = StereoHumanDataset(DatasetConfig(
            data_root=str(self.frames_dir), src_res=cfg.dataset.src_res,
            source_ids=tuple(mix["source_ids"]),
            use_hr_img=cfg.dataset.use_hr_img, use_processed_data=False),
            "test")
        self.weights = self.cell.weights("serve")
        self.renderer = load_renderer(cfg, str(self.weights), self.dataset,
                                      device=ctx.device)
        phase("renderer")
        self._wrap()
        if mix["entry"] == "sequence":
            self.ratios = [mix["ratio"]]
        else:
            v = mix["n_views"]
            self.ratios = [(k + 0.5) / v for k in range(v)]
        self.frames = self._frames()
        for _ in range(n):          # every frame once: shapes and caches
            next(self.frames)
        phase("warm-up")

    def _wrap(self) -> None:
        spans, ds, r = self.ctx.spans, self.dataset, self.renderer
        get, gaussians, render = ds.get_test_sample, r.gaussians, r.render

        def get_test_sample(index):
            self.current = index
            with spans.host("read"):
                sample = get(index)
            if index in self.checked:
                self.kept[index] = {"sample": sample, "aux": [],
                                    "images": None}
            return sample

        def gaussians_(batch):
            with spans.device("forward"):
                g = gaussians(batch)
            if self.current in self.kept:
                self.kept[self.current]["gauss"] = g
            return g

        def render_(gauss, camera):
            with spans.device("render"):
                img, aux = render(gauss, camera)
            if self.current in self.kept:
                self.kept[self.current]["aux"].append(aux)
            if self.keep_views:
                self.profiled_views.append((gauss, camera))
            return img, aux

        ds.get_test_sample = get_test_sample
        r.gaussians = gaussians_
        r.render = render_

    def _frames(self):
        """Endless frames: each next() is one frame, its images a list."""
        r = self.renderer
        while True:
            if self.mix["entry"] == "sequence":
                outs = ([img] for _, img in r.infer_sequence(self.ratios[0]))
            else:
                outs = (r.infer_static(i, len(self.ratios))
                        for i in range(len(self.dataset)))
            for images in outs:
                if self.current in self.kept:
                    self.kept[self.current]["images"] = images
                yield images

    # ------------------------------------------------------------- window
    def window(self) -> None:
        ctx = self.ctx
        prof = self.cell.workload["profile_frames"]
        skip = self.cell.workload["profile_after"]
        harness.sync(ctx.device)
        ctx.spans.enabled = ctx.trace
        self.setup_s = time.perf_counter() - ctx.t0
        self.times, self.failed = [], 0
        res = self.cfg.dataset.src_res * (
            2 if self.cfg.dataset.use_hr_img else 1)
        t0 = time.perf_counter()
        while True:
            if ctx.profile is not None and len(self.times) == skip:
                ctx.profile.start()
                self.keep_views = True
            ta = time.perf_counter()
            images = next(self.frames)
            tb = time.perf_counter()
            self.times.append(tb - ta)
            self.failed += int(len(images) != len(self.ratios) or any(
                im.shape != (res, res, 3) for im in images))
            if ctx.profile is not None and ctx.profile.running and \
                    len(self.times) == skip + prof:
                ctx.profile.stop()
                self.keep_views = False
            if tb - t0 >= ctx.seconds:
                break
        self.window_s = time.perf_counter() - t0
        ms = np.asarray(self.times) * 1e3
        third = max(1, len(ms) // 3)
        print(f"frame ms: quartiles {np.percentile(ms, [25, 50, 75])}, "
              f"first third {ms[:third].mean():.1f}, last third "
              f"{ms[-third:].mean():.1f}", file=sys.stderr, flush=True)
        if ctx.profile is not None and ctx.profile.running:
            ctx.profile.stop()
            self.keep_views = False
        ctx.spans.enabled = False
        self.memory_peak = harness.peak_bytes(ctx.device)

    # ------------------------------------------------------------- answers
    def program_answers(self) -> list:
        out = []
        for f in self.checked:
            k = self.kept[f]
            s = k["sample"]
            out.append({
                "rect": {v: s[v]["img"] for v in ("lmain", "rmain")},
                "gauss": judge.gauss_dict(k["gauss"]),
                "views": [{"image": im, "drops": int(
                    a.num_dropped.sum() + a.num_fg_dropped.sum()
                    + a.num_pair_dropped.sum())}
                    for im, a in zip(k["images"], k["aux"], strict=True)]})
        return out

    def reference_answers(self, control: bool = False,
                          half_frame: bool = False) -> list:
        """The reference's answers for the checked frames; `control`
        computes them one precision lower, `half_frame` leaves out the
        second half of each frame's valid Gaussians, the right view's (a
        planted fault)."""
        dev, cfg = self.ctx.device, self.cfg
        model = pipeline.build_model(self.recipe, True, dev)
        model.load_state_dict(pipeline.load_params(self.weights))
        model.eval()
        if control:
            c = self.cell.config["control"]
            model.set_control(quant.KINDS[c["kind"]], c["corr"])
        rcfg = pipeline.raster_config(self.recipe)
        hr = 2.0 if cfg.dataset.use_hr_img else 1.0
        res = int(cfg.dataset.src_res * hr)
        bg = torch.tensor(cfg.dataset.bg_color, dtype=torch.float32,
                          device=dev)
        out = []
        for f in self.checked:
            rs = pipeline.test_sample(self.frames_dir, self.names[f],
                                      self.mix["source_ids"])
            g = pipeline.frame_gaussians(
                model, pipeline.stereo_batch(rs, dev), cfg.raft.val_iters,
                rcfg.fg_cap)
            if half_frame:
                g = dataclasses.replace(g, valid=drop_half(g.valid))
            views = []
            for ratio in self.ratios:
                cam = pipeline.novel_camera(rs, ratio, res, hr,
                                            cfg.dataset.znear,
                                            cfg.dataset.zfar, dev)
                img, drops = pipeline.render_view(g, cam, bg, rcfg)
                views.append({"image": img, "drops": drops})
            out.append({"rect": {v: rs[v]["img"] for v in ("lmain", "rmain")},
                        "gauss": judge.gauss_dict(g), "views": views})
        return out

    def profiled_work(self) -> dict:
        """The profiled views' composite work, counted by the reference."""
        if not self.profiled_views:
            return {}
        rcfg = roofline.serve_config(pipeline.raster_config(self.recipe))
        bound = 0.0
        for gauss, cam in self.profiled_views:
            work = roofline.composite_work(
                {k: getattr(gauss, k) for k in ("xyz", "rot", "scale",
                                                "opacity", "rgb", "valid")},
                roofline.camera_dict(cam), cam.height, cam.width, rcfg)
            bound += roofline.fwd_bound_s(work)
        return {"composite_fwd.bound_s": bound,
                "composite_fwd.views": len(self.profiled_views)}

    def release(self) -> None:
        """Free the program's state; the kept answers stay."""
        self.frames.close()
        self.renderer = self.frames = None
        self.dataset = None
        harness.free(self.ctx.device)


def run(cell: harness.Cell, ctx: harness.Ctx) -> harness.Outcome:
    s = ServeRun(cell, ctx)
    s.setup()
    s.window()
    spans = {"read": ctx.spans.host_ms("read"),
             "forward": ctx.spans.device_ms("forward"),
             "render": ctx.spans.device_ms("render")}
    prog = s.program_answers()
    counters = s.profiled_work()
    s.release()
    numbers = judge.serve_numbers(prog, s.reference_answers())
    n = len(s.times)
    # the profiled stretch (the profiler's start and stop in it) is left
    # out of the rate the mfu reads
    n_rate, t_rate = n, s.window_s
    if ctx.profile is not None and ctx.profile.host_s is not None:
        n_rate -= cell.workload["profile_frames"]
        t_rate -= ctx.profile.host_s
    counters.update(frames=n_rate, window_s=t_rate,
                    flops=cell.config["flops"]["serve_forward"] * n_rate,
                    peak_flops=cell.config["peak_flops"])
    return harness.Outcome(
        attempted=n, failed=s.failed,
        end_to_end={"setup_s": s.setup_s,
                    "frames_per_s": n / s.window_s,
                    "frame_p95_ms": float(np.percentile(s.times, 95)) * 1e3},
        record=harness.Record(cell=cell, spans=spans, counters=counters,
                              profile=ctx.profile.read()
                              if ctx.profile else None),
        numbers=numbers, memory_peak_bytes=s.memory_peak)
