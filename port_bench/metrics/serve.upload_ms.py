"""Device ms of a served frame's batch upload to the card: the program's
`frame.upload` span (CUDA events), mean over the profiled frames."""

from port_bench.program_spans import per_request


def read(run):
    return per_request(run, "frame", ["frame.upload"])
