"""Host ms a served frame spends turning the rectified sources into the
sample's float images and masks: the program's `read.normalize` span,
mean over the profiled frames."""

from port_bench.program_spans import per_request


def read(run):
    return per_request(run, "frame", ["read.normalize"])
