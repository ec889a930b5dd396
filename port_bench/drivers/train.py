"""Training steps through the port's own step: `make_train_step(model,
cfg, stage, ...)` over a `TrainState` (AdamW, the one-cycle schedule,
clipping), on a pool of seeded batches kept on the device and cycled.

Set-up builds the one step object the window drives, with weights drawn
from the seed on the device, and takes its first three steps on the
pool's first three batches (all differ): they warm every shape, and they are
what the reference follows. One closed-loop client: the window enqueues
steps until its seconds have passed and ends in a synchronisation.

Spans (traced runs) are CUDA events at the step's start and at its own
`mark` hook ("forward", "backward", "optimizer").
"""

from __future__ import annotations

import contextlib
import math
import time

import torch

from port_bench import harness, judge, roofline
from port_bench.reference import pipeline, quant
from port_bench.traffic import silhouette


@torch.no_grad()
def seeded_weights(model: torch.nn.Module, seed: int, device) -> None:
    """Convolutions U(+-1/sqrt(fan_in)) for weight and bias, GroupNorm
    weight 1 and bias 0 (the port's `init_weights` rule), all convolution
    values from one draw of a generator on `device`."""
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    norms = [m for m in model.modules() if isinstance(m, torch.nn.GroupNorm)]
    owned = {id(p) for m in convs + norms for p in m.parameters(False)}
    if owned != {id(p) for p in model.parameters()}:
        raise ValueError("a parameter is neither a convolution's nor a "
                         "GroupNorm's")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    leaves = [(p, 1.0 / math.sqrt(m.weight.shape[1]
                                  * m.weight[0, 0].numel()))
              for m in convs for p in (m.weight, m.bias)]
    u = torch.rand(sum(p.numel() for p, _ in leaves), generator=gen,
                   device=device)
    off = 0
    for p, bound in leaves:
        n = p.numel()
        p.copy_(((u[off:off + n] * 2 - 1) * bound).view_as(p))
        off += n
    for m in norms:
        m.weight.fill_(1.0)
        m.bias.zero_()


def program_batch(t: dict):
    """The port's StereoSample over the benchmark's batch tensors."""
    from gps_gaussian_tpu_torch.utils.containers import (NovelCamera,
                                                         NovelView,
                                                         SourceView,
                                                         StereoSample)
    novel = None
    if "novel" in t:
        n = t["novel"]
        novel = NovelView(camera=NovelCamera(height=n["height"],
                                             width=n["width"],
                                             **n["camera"]),
                          img=n["img"], intr=n["intr"], extr=n["extr"])
    return StereoSample(lmain=SourceView(**t["lmain"]),
                        rmain=SourceView(**t["rmain"]), novel=novel)


def first_gradients(model: torch.nn.Module, state) -> dict:
    """Each parameter's first gradient as the optimizer got it, on the
    host: exp_avg is (1 - beta1) * g after one step (a parameter the
    optimizer never stepped has none: 0)."""
    st = state.optimizer.state
    return {k: st[p]["exp_avg"].float().cpu() / (1.0 - pipeline.BETAS[0])
            if "exp_avg" in st.get(p, {}) else torch.zeros(p.shape)
            for k, p in model.named_parameters()}


def _drops(metrics: dict) -> float:
    return float(sum(metrics[k] for k in ("num_dropped", "num_fg_dropped",
                                          "num_pair_dropped")
                     if k in metrics))


class TrainRun:
    CHECKED_STEPS = 3

    def __init__(self, cell: harness.Cell, ctx: harness.Ctx):
        self.cell, self.ctx = cell, ctx
        self.recipe = cell.config["recipe"]
        self.stage = cell.config["stage"]
        self.captured = []
        self.capture = False

    def setup(self) -> None:
        from gps_gaussian_tpu_torch.train.config import load_config
        from gps_gaussian_tpu_torch.train.state import create_state
        from gps_gaussian_tpu_torch.train.trainer import (make_model,
                                                          make_raster_config,
                                                          make_train_step)

        ctx = self.ctx
        dev = ctx.device
        phase = harness.Phases()
        self.cfg = cfg = load_config(None, **self.recipe)
        self.model = make_model(cfg, with_gs=self.stage == "stage2").to(dev)
        seeded_weights(self.model, ctx.seed, dev)
        self.init = {k: v.detach().clone()
                     for k, v in self.model.state_dict().items()}
        self.state = create_state(cfg, self.model, dev)
        self.step = make_train_step(self.model, cfg, self.stage,
                                    make_raster_config(cfg), self.state,
                                    device=dev)
        self.pool = silhouette.make_pool(self.cell.traffic, ctx.seed + 1, dev)
        self.batches = [program_batch(t) for t in self.pool]
        phase("model and batches")
        if ctx.trace and self.stage == "stage2":
            self.model.register_forward_hook(self._hook)
        metrics = []
        for i in range(self.CHECKED_STEPS):
            metrics.append(self.step(self.batches[i]))
            if i == 0:
                self.grads = first_gradients(self.model, self.state)
        self.change_norms = {
            k: torch.linalg.vector_norm(p.detach() - self.init[k])
            for k, p in self.model.named_parameters()}
        self.first = metrics
        self.setup_peak = harness.peak_bytes(dev)
        phase("first steps")

    def _hook(self, module, args, out):
        if self.capture:
            self.captured.append((out.lmain_gs, out.rmain_gs))

    def window(self) -> None:
        ctx, spans = self.ctx, self.ctx.spans
        prof = self.cell.workload["profile_steps"]
        skip = self.cell.workload["profile_after"]
        harness.sync(ctx.device)
        spans.enabled = ctx.trace
        self.setup_s = time.perf_counter() - ctx.t0
        harness.reset_peak(ctx.device)
        marks = {}

        def mark(name):
            marks[name] = spans.event()

        losses, self.profiled_batches = [], []
        i = self.CHECKED_STEPS
        t0 = time.perf_counter()
        while True:
            n = len(losses)
            if ctx.profile is not None and n == skip:
                ctx.profile.start()
                self.capture = True
            batch = self.batches[i % len(self.batches)]
            if self.capture:
                self.profiled_batches.append(batch)
            with torch.profiler.record_function("pb.step") \
                    if ctx.trace else contextlib.nullcontext():
                start = spans.event()
                losses.append(self.step(
                    batch, mark=mark if ctx.trace else None)["loss"])
            spans.add_device("forward", start, marks.get("forward"))
            spans.add_device("backward", marks.get("forward"),
                             marks.get("backward"))
            i += 1
            if ctx.profile is not None and ctx.profile.running and \
                    len(losses) == skip + prof:
                ctx.profile.stop()
                self.capture = False
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        harness.sync(ctx.device)
        self.window_s = time.perf_counter() - t0
        if ctx.profile is not None and ctx.profile.running:
            ctx.profile.stop()
        self.capture = False
        spans.enabled = False
        self.steps = len(losses)
        self.failed = int((~torch.isfinite(torch.stack(losses))).sum())
        self.window_peak = harness.peak_bytes(ctx.device)

    def program_answers(self) -> dict:
        out = {"losses": [float(m["loss"]) for m in self.first],
               "grads": self.grads,
               "grad_norms": {k: float(torch.linalg.vector_norm(g))
                              for k, g in self.grads.items()},
               "change_norms": {k: float(v) for k, v in
                                self.change_norms.items()}}
        if self.stage == "stage2":
            out["drops"] = [_drops(m) for m in self.first]
        return out

    def profiled_work(self) -> dict:
        """Forward and backward composite bounds of the profiled steps'
        renders, counted by the reference on the Gaussians each step made."""
        if self.stage != "stage2" or not self.captured:
            return {}
        rcfg = pipeline.raster_config(self.recipe)
        fwd = bwd = 0.0
        for (lg, rg), batch in zip(self.captured, self.profiled_batches):
            g = lg.flatten().concat(rg.flatten())
            cam = batch.novel.camera
            work = roofline.composite_work(
                {k: getattr(g, k) for k in ("xyz", "rot", "scale", "opacity",
                                            "rgb", "valid")},
                roofline.camera_dict(cam), cam.height, cam.width, rcfg)
            fwd += roofline.fwd_bound_s(work)
            bwd += roofline.bwd_bound_s(work)
        return {"composite_fwd.bound_s": fwd, "composite_bwd.bound_s": bwd,
                "composite.steps": len(self.captured)}

    def release(self) -> None:
        self.step = self.state = self.model = None
        self.captured = self.profiled_batches = []
        harness.free(self.ctx.device)

    def reference_model(self):
        """The reference network from the same initial weights."""
        model = pipeline.build_model(self.recipe, self.stage == "stage2",
                                     self.ctx.device)
        model.load_state_dict(self.init)
        return model

    def reference_answers(self, control: bool = False,
                          half_batch: bool = False, half_loss: bool = False,
                          variant: str = None) -> dict:
        """The reference's three steps from the same weights on the same
        three batches; `control` computes them one precision lower,
        `variant` is a sound variant of the reference
        (reference/layers.py VARIANTS). Planted faults: `half_batch` leaves
        out the second half of every batch, `half_loss` takes the loss over
        the first half alone while the forward runs over all of it. The
        plain reference also gives `half_grads`, its first gradient over
        the first half of the first batch: the direction judge's
        `grad_half` reads along."""
        dev = self.ctx.device
        model = self.reference_model()
        if control:
            c = self.cell.config["control"]
            model.set_control(quant.KINDS[c["kind"]], c["corr"])
        model.set_variant(variant)
        half = max(1, self.cell.traffic["batch"] // 2)
        batches = []
        for t in self.pool[:self.CHECKED_STEPS]:
            if half_batch:
                t = _rows(t, slice(0, half))
            batches.append(pipeline.train_batch(t, dev))
        res = pipeline.train_steps(model, batches, self.recipe, self.stage,
                                   loss_rows=half if half_loss else None)
        out = {k: res[k] for k in ("losses", "grads", "grad_norms",
                                   "change_norms")}
        if not (control or variant or half_batch or half_loss):
            out["half_grads"] = pipeline.first_gradient(
                self.reference_model(),
                pipeline.train_batch(_rows(self.pool[0], slice(0, half)),
                                     dev), self.recipe, self.stage)
        if self.stage == "stage2":
            out["drops"] = [_drops(m) for m in res["metrics"]]
        return out

    def numbers(self, answers: dict, ref: dict) -> dict:
        """judge.train_numbers of `answers` against the reference's `ref`."""
        return judge.train_numbers(answers, ref)

    # answers the reference made (a variant, the control) are judged alike
    own_numbers = numbers

    def faults(self, ref: dict) -> dict:
        """The numbers of each planted fault, made in the reference's
        place: `half_batch` the second half of every batch left out, the
        mean taken over the rest; `half_loss` the loss over the first half
        of every batch, the forward over all of it; `unchanged` a step that
        returns its state unchanged (1 on change_gap by definition)."""
        unchanged = dict(ref, change_norms={k: 0.0 for k in
                                            ref["change_norms"]})
        return {"half_batch": self.numbers(
                    self.reference_answers(half_batch=True), ref),
                "half_loss": self.numbers(
                    self.reference_answers(half_loss=True), ref),
                "unchanged": self.numbers(unchanged, ref)}

    def details(self) -> dict:
        return {"steps": self.steps, "setup_s": self.setup_s,
                "losses": [float(m["loss"]) for m in self.first]}


Run = TrainRun


def _rows(t, rows: slice):
    """A batch's samples `rows` (nested dicts of batched tensors)."""
    if isinstance(t, dict):
        return {k: _rows(v, rows) for k, v in t.items()}
    if isinstance(t, torch.Tensor) and t.dim() > 0:
        return t[rows]
    return t


def run(cell: harness.Cell, ctx: harness.Ctx) -> harness.Outcome:
    t = TrainRun(cell, ctx)
    t.setup()
    t.window()
    spans = {"forward": ctx.spans.device_ms("forward"),
             "backward": ctx.spans.device_ms("backward")}
    prog = t.program_answers()
    counters = t.profiled_work()
    t.release()
    numbers = t.numbers(prog, t.reference_answers())
    # the profiled stretch (the profiler's start and stop in it) is left
    # out of the rate the mfu reads
    n_rate, t_rate = t.steps, t.window_s
    if ctx.profile is not None and ctx.profile.host_s is not None:
        n_rate -= cell.workload["profile_steps"]
        t_rate -= ctx.profile.host_s
    counters.update(steps=n_rate, window_s=t_rate,
                    flops=cell.config["flops"]["train_step_per_sample"]
                    * cell.traffic["batch"] * n_rate,
                    peak_flops=cell.config["peak_flops"])
    return harness.Outcome(
        attempted=t.steps, failed=t.failed,
        end_to_end={"setup_s": t.setup_s,
                    "train_step_ms": t.window_s * 1e3 / t.steps,
                    "train_peak_gib": t.window_peak / 2 ** 30},
        record=harness.Record(cell=cell, spans=spans, counters=counters,
                              profile=ctx.profile.read()
                              if ctx.profile else None),
        numbers=numbers,
        memory_peak_bytes=max(t.setup_peak, t.window_peak))

