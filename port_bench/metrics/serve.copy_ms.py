"""Device ms of a served frame's image copies to host memory: the
program's `frame.copy` spans (CUDA events), summed per frame, mean over
the profiled frames."""

from port_bench.program_spans import per_request


def read(run):
    return per_request(run, "frame", ["frame.copy"])
