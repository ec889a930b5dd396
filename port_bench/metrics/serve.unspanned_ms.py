"""Host ms of a served frame outside every span under it: the self time
of the program's `frame` span (collation, the novel camera, the drop
checks, the loop), mean over the profiled frames."""

from port_bench.program_spans import per_request


def read(run):
    return per_request(run, "frame", ["frame"], field="self_ms")
