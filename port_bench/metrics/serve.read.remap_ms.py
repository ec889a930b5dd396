"""Host ms a served frame spends in the four remaps of its sources and
masks: the program's `read.remap` span, mean over the profiled frames."""

from port_bench.program_spans import per_request


def read(run):
    return per_request(run, "frame", ["read.remap"])
