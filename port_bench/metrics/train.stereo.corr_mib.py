"""MiB of correlation pyramid a training step builds: the program's counter
`stereo.corr_bytes` over the profiled steps, over 2^20 (None where the
program keeps no such counter)."""

from port_bench.program_spans import _tracer, stretch


def read(run):
    tracer = _tracer()
    n = stretch(run)
    if tracer is None or n <= 0:
        return None
    total = tracer.counters().get("stereo.corr_bytes")
    return None if total is None else total / n / 2 ** 20
