"""Device ms of a training step's GroupNorms in the forward: every
`net.groupnorm` span of the program in a `step` (CUDA events), summed per
step, mean over the profiled steps."""

from port_bench.program_spans import per_request


def read(run):
    return per_request(run, "step", ["net.groupnorm"])
