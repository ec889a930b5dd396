"""Device ms of a training step's InstanceNorms in the forward: every
`net.instancenorm` span of the program in a `step` (CUDA events, the f32
casts included), summed per step, mean over the profiled steps."""

from port_bench.program_spans import per_request


def read(run):
    return per_request(run, "step", ["net.instancenorm"])
