"""Device ms of a training step's RAFT-Stereo iterations in the forward:
every `net.update` span of the program in a `step` (CUDA events; each
iteration's correlation lookup, GRU levels, heads and upsampling), summed
per step, mean over the profiled steps."""

from port_bench.program_spans import per_request


def read(run):
    return per_request(run, "step", ["net.update"])
