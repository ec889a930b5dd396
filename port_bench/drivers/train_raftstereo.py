"""Training steps of RAFT-Stereo (`raftstereo_stage1`) through the port's own
stage-1 step, as drivers/train.py takes them for GPS-Gaussian: the same
window, checked steps, answers and counters (`TrainRun`), with what differs
for this network:

* weights: convolutions as drivers/train.py draws them; BatchNorm weight 1
  and bias 0, its running mean and variance drawn from the seed too, so
  that a step that ran BatchNorm in training mode (or moved its
  statistics) would show; InstanceNorm has none;
* the reference: reference/raft_stereo.py, BatchNorm frozen, stepped by
  reference/pipeline.py `train_steps`;
* in a traced run, the counter `update_kernel_ms`: the device time of the
  kernels, copies and sets launched inside the program's `net.update`
  spans (the forward's GRU iterations) a profiled step, read from the
  profiler's trace (`read_profile`). The span's own CUDA-event time
  (`train.net.update_ms`) also holds the card's waits for the host.

A configuration the program cannot build (its `make_model` or
`load_config` refuses the recipe) fails the run at set-up, before any
step.
"""

from __future__ import annotations

import bisect
import math
from typing import Optional

import torch

from port_bench import harness
from port_bench.drivers import train
from port_bench.reference import raft_stereo
from port_bench.traffic import silhouette


@torch.no_grad()
def seeded_weights(model: torch.nn.Module, seed: int, device) -> None:
    """Convolutions U(+-1/sqrt(fan_in)) for weight and bias, all from one
    draw of a generator on `device` (drivers/train.py's rule); then every
    BatchNorm's running mean U(-0.5, 0.5) and variance U(0.5, 2) from a
    second draw, its weight 1 and bias 0."""
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    norms = [m for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    owned = {id(p) for m in convs + norms for p in m.parameters(False)}
    if owned != {id(p) for p in model.parameters()}:
        raise ValueError("a parameter is neither a convolution's nor a "
                         "BatchNorm's")
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
    u = torch.rand(2 * sum(m.num_features for m in norms), generator=gen,
                   device=device)
    off = 0
    for m in norms:
        n = m.num_features
        m.running_mean.copy_(u[off:off + n] - 0.5)
        m.running_var.copy_(0.5 + 1.5 * u[off + n:off + 2 * n])
        off += 2 * n
        m.weight.fill_(1.0)
        m.bias.zero_()


def kernel_ms_within(trace: dict, name: str) -> Optional[float]:
    """Device ms of the kernels, copies and sets whose launch (a runtime or
    driver call, matched by its correlation id) lies inside a host range
    `name` of the chrome trace `trace` (non-overlapping ranges, as the
    program's sequential spans are); None where the trace has no such
    range or no device operation was launched in one."""
    events = [e for e in trace.get("traceEvents", ())
              if e.get("ph") == "X" and "dur" in e]
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("name") == name
                    and e.get("cat") == "user_annotation")
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    starts = [a for a, _ in ranges]
    total, seen = 0.0, False
    for e in events:
        if e.get("cat") not in harness.DEVICE_CATS:
            continue
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < ranges[i][1]:
            total += float(e["dur"])
            seen = True
    return total * 1e-3 if seen else None


def read_profile(ctx: harness.Ctx, steps: int):
    """`Profile.read` (the stretch's summary) and, from the same trace,
    `kernel_ms_within` the program's `net.update` spans a profiled step:
    (summary, ms or None). The profiler exports its trace once."""
    prof = ctx.profile
    path = prof.out_dir / "pb_trace.json"
    prof.prof.export_chrome_trace(str(path))
    trace = harness.load_json(path)
    path.unlink()
    prof.summary = harness.summarize_trace(trace)
    ms = kernel_ms_within(trace, "net.update")
    return prof.summary, None if ms is None else ms / steps


class RaftStereoTrainRun(train.TrainRun):
    def setup(self) -> None:
        from gps_gaussian_tpu_torch.train.config import load_config
        from gps_gaussian_tpu_torch.train.state import create_state
        from gps_gaussian_tpu_torch.train.trainer import (make_model,
                                                          make_train_step)

        ctx = self.ctx
        dev = ctx.device
        phase = harness.Phases()
        self.cfg = cfg = load_config(None, **self.recipe)
        self.model = make_model(cfg, with_gs=False).to(dev)
        seeded_weights(self.model, ctx.seed, dev)
        self.init = {k: v.detach().clone()
                     for k, v in self.model.state_dict().items()}
        self.state = create_state(cfg, self.model, dev)
        self.step = make_train_step(self.model, cfg, self.stage, None,
                                    self.state, device=dev)
        self.pool = silhouette.make_pool(self.cell.traffic, ctx.seed + 1, dev)
        self.batches = [train.program_batch(t) for t in self.pool]
        phase("model and batches")
        metrics = []
        for i in range(self.CHECKED_STEPS):
            metrics.append(self.step(self.batches[i]))
            if i == 0:
                self.grads = train.first_gradients(self.model, self.state)
        self.change_norms = {
            k: torch.linalg.vector_norm(p.detach() - self.init[k])
            for k, p in self.model.named_parameters()}
        self.first = metrics
        self.setup_peak = harness.peak_bytes(dev)
        phase("first steps")

    def reference_model(self):
        model = raft_stereo.build_model(self.recipe, self.ctx.device)
        model.load_state_dict(self.init)
        return model


Run = RaftStereoTrainRun


def run(cell: harness.Cell, ctx: harness.Ctx) -> harness.Outcome:
    t = RaftStereoTrainRun(cell, ctx)
    t.setup()
    t.window()
    spans = {"forward": ctx.spans.device_ms("forward"),
             "backward": ctx.spans.device_ms("backward")}
    prog = t.program_answers()
    t.release()
    numbers = t.numbers(prog, t.reference_answers())
    # the profiled stretch is left out of the rate the mfu reads
    n_rate, t_rate = t.steps, t.window_s
    if ctx.profile is not None and ctx.profile.host_s is not None:
        n_rate -= cell.workload["profile_steps"]
        t_rate -= ctx.profile.host_s
    counters = dict(steps=n_rate, window_s=t_rate,
                    flops=cell.config["flops"]["train_step_per_sample"]
                    * cell.traffic["batch"] * n_rate,
                    peak_flops=cell.config["peak_flops"])
    profile = None
    if ctx.profile is not None:
        profile, kernel_ms = read_profile(ctx,
                                          cell.workload["profile_steps"])
        if kernel_ms is not None:
            counters["update_kernel_ms"] = kernel_ms
    return harness.Outcome(
        attempted=t.steps, failed=t.failed,
        end_to_end={"setup_s": t.setup_s,
                    "train_step_ms": t.window_s * 1e3 / t.steps,
                    "train_peak_gib": t.window_peak / 2 ** 30},
        record=harness.Record(cell=cell, spans=spans, counters=counters,
                              profile=profile),
        numbers=numbers,
        memory_peak_bytes=max(t.setup_peak, t.window_peak))
