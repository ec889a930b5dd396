"""Device ms of the kernels, copies and sets that a training step's
RAFT-Stereo iterations launch in the forward: those launched inside the
program's `net.update` spans, from the profiler's trace
(drivers/train_raftstereo.py `kernel_ms_within`), mean over the profiled
steps. Beside `train.net.update_ms`, the same spans on CUDA events, it
separates the iterations' device work from the card's waits for the
host."""


def read(run):
    return run.counters.get("update_kernel_ms")
