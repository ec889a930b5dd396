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
the program's answers for the frames the seed picks for the check, each
filed under the frame that produced it, so that a read that runs ahead of
the card is still compared as its own frame: a sample by the index read,
Gaussians by the order of the reads (the program forwards frames in the
order it reads them), a render's counters by the Gaussians it was given,
and images by the frame's name or index. A frame's answers are kept once
its images are out; a frame read but not yet out when the window closes
leaves its last whole pass kept.

The check compares the rectified sources and the Gaussians with the
reference's own, and every image and drop counter with the reference's
rendering of the program's own Gaussians (`redraw`).
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import time

import numpy as np
import torch

from port_bench import harness, judge, roofline
from port_bench.reference import pipeline, quant
from port_bench.reference.containers import FlatGaussians
from port_bench.traffic import frames


def alter_region(g, field: str, share: float = 0.01):
    """`g` (a batch-1 Gaussian container) with `share` of its valid rows
    altered, a run of rows a third of the way in (pixel-aligned rows in a
    row, so one region of the left view): `rgb` their colours inverted,
    `xyz` their positions moved by 5% of the mean |position| along each
    axis."""
    idx = torch.nonzero(g.valid[0] > 0.5)[:, 0]
    n = max(1, int(idx.numel() * share))
    rows = idx[idx.numel() // 3:idx.numel() // 3 + n]
    x = getattr(g, field).clone()
    if field == "rgb":
        x[0, rows] = 1.0 - x[0, rows]
    else:
        x[0, rows] += 0.05 * x[0, idx].abs().mean()
    return dataclasses.replace(g, **{field: x})


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
        self.kept = {}          # checked frame: its last whole pass
        self.passing = {}       # checked frame: the pass under way
        self.ref_samples = {}
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
        self.frame_of = {name: i for i, name in enumerate(self.names)}
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
        read = collections.deque()      # frames read and not yet forwarded

        def get_test_sample(index):
            with spans.host("read"):
                sample = get(index)
            read.append(index)
            if index in self.checked:
                self.passing[index] = {"sample": sample, "aux": []}
            return sample

        def gaussians_(batch):
            frame = read.popleft()
            with spans.device("forward"):
                g = gaussians(batch)
            if frame in self.passing:
                self.passing[frame]["gauss"] = g
            return g

        def render_(gauss, camera):
            with spans.device("render"):
                img, aux = render(gauss, camera)
            for k in self.passing.values():
                if k.get("gauss") is gauss:
                    k["aux"].append(aux)
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
                outs = ((self.frame_of[name], [img]) for name, img
                        in r.infer_sequence(self.ratios[0]))
            else:
                outs = ((i, r.infer_static(i, len(self.ratios)))
                        for i in range(len(self.dataset)))
            for frame, images in outs:
                if frame in self.passing:
                    self.kept[frame] = dict(self.passing.pop(frame),
                                            images=images)
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

    def reference_sample(self, frame: int) -> dict:
        """The reference's own read and rectification of `frame` (kept:
        every answer of the reference reads the same)."""
        if frame not in self.ref_samples:
            self.ref_samples[frame] = pipeline.test_sample(
                self.frames_dir, self.names[frame], self.mix["source_ids"])
        return self.ref_samples[frame]

    def reference_views(self, gauss, rs: dict) -> list:
        """The reference's rendering of `gauss` (its container) from each
        of the mix's ratios between the sample's source cameras."""
        cfg, dev = self.cfg, self.ctx.device
        rcfg = pipeline.raster_config(self.recipe)
        hr = 2.0 if cfg.dataset.use_hr_img else 1.0
        res = int(cfg.dataset.src_res * hr)
        bg = torch.tensor(cfg.dataset.bg_color, dtype=torch.float32,
                          device=dev)
        views = []
        for ratio in self.ratios:
            cam = pipeline.novel_camera(rs, ratio, res, hr, cfg.dataset.znear,
                                        cfg.dataset.zfar, dev)
            img, drops = pipeline.render_view(gauss, cam, bg, rcfg)
            views.append({"image": img, "drops": drops})
        return views

    def reference_answers(self, control: bool = False,
                          half_frame: bool = False, region: str = None,
                          variant: str = None) -> list:
        """The reference's answers for the checked frames; `control`
        computes them one precision lower, `variant` is a sound variant of
        the reference (reference/layers.py VARIANTS). Planted faults in the
        network's output, rendered as served: `half_frame` leaves out the
        second half of each frame's valid Gaussians, the right view's;
        `region` ("rgb" or "xyz") alters that field of 1% of them
        (`alter_region`)."""
        dev, cfg = self.ctx.device, self.cfg
        model = pipeline.build_model(self.recipe, True, dev)
        model.load_state_dict(pipeline.load_params(self.weights))
        model.eval()
        if control:
            c = self.cell.config["control"]
            model.set_control(quant.KINDS[c["kind"]], c["corr"])
        model.set_variant(variant)
        out = []
        for f in self.checked:
            rs = self.reference_sample(f)
            g = pipeline.frame_gaussians(
                model, pipeline.stereo_batch(rs, dev), cfg.raft.val_iters,
                pipeline.raster_config(self.recipe).fg_cap)
            if half_frame:
                g = dataclasses.replace(g, valid=drop_half(g.valid))
            if region:
                g = alter_region(g, region)
            out.append({"rect": {v: rs[v]["img"] for v in ("lmain", "rmain")},
                        "gauss": judge.gauss_dict(g),
                        "views": self.reference_views(g, rs)})
        return out

    def redraw(self, answers: list) -> list:
        """For each checked frame, the reference's rendering of the
        answer's own Gaussians: what its images and drops are held to."""
        out = []
        for f, a in zip(self.checked, answers, strict=True):
            g = FlatGaussians(**{k: a["gauss"][k][None]
                                 for k in judge.GAUSS_FIELDS + ("valid",)})
            out.append(self.reference_views(g, self.reference_sample(f)))
        return out

    def numbers(self, answers: list, ref: list, redrawn=None) -> dict:
        """judge.serve_numbers of `answers` against the reference's `ref`.
        The images are held to `redrawn`, by default `redraw(answers)`."""
        if redrawn is None:
            redrawn = self.redraw(answers)
        return judge.serve_numbers(answers, ref, redrawn)

    def own_numbers(self, answers: list, ref: list) -> dict:
        """`numbers` of answers the reference made (a variant, the control,
        a fault in the network's output): they render the Gaussians they
        hold, so they are their own redrawing."""
        return self.numbers(answers, ref, [a["views"] for a in answers])

    def faults(self, ref: list) -> dict:
        """The numbers of each planted fault, made in the reference's
        answers: `altered` one pixel row of one image set to 0 where it is
        produced, `uncounted` the pairs one view's caps dropped reported as
        none, `altered_rect` one row of a rectified source raised by 0.5
        where the dataset produces it, `half_frame` the right view's
        Gaussians left out, `region_rgb` and `region_xyz` the colours or
        positions of 1% of the Gaussians altered (`alter_region`)."""
        plain = [f["views"] for f in ref]
        altered = [dict(f, views=[dict(v) for v in f["views"]]) for f in ref]
        uncounted = [dict(f, views=[dict(v) for v in f["views"]])
                     for f in ref]
        img = altered[0]["views"][0]["image"].copy()
        img[img.shape[0] // 2] = 0.0
        altered[0]["views"][0]["image"] = img
        uncounted[0]["views"][0]["drops"] = 0
        rect = [dict(f, rect=dict(f["rect"])) for f in ref]
        src = rect[0]["rect"]["lmain"].copy()
        src[src.shape[0] // 2] += 0.5
        rect[0]["rect"]["lmain"] = src
        return {"altered": self.numbers(altered, ref, redrawn=plain),
                "uncounted": self.numbers(uncounted, ref, redrawn=plain),
                "altered_rect": self.numbers(rect, ref, redrawn=plain),
                "half_frame": self.own_numbers(
                    self.reference_answers(half_frame=True), ref),
                **{f"region_{f}": self.own_numbers(
                    self.reference_answers(region=f), ref)
                   for f in ("rgb", "xyz")}}

    def details(self) -> dict:
        return {"frames": len(self.times), "setup_s": self.setup_s}

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


Run = ServeRun


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
    numbers = s.numbers(prog, s.reference_answers())
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
