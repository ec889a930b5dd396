"""Share of the served frames' source views that the fused native pass
made, %: 100 x the program's counter `read.views_fused` over `read.views`
in the profiled frames (0 where the NumPy fallback ran; left out where
the program counts neither)."""

from port_bench.program_spans import counter_share


def read(run):
    return counter_share("read.views_fused", "read.views")
