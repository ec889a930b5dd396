"""Device ms of a served frame's GroupNorms: every `net.groupnorm` span of
the program (`GroupNorm32`, its f32 casts included; CUDA events), summed
per frame, mean over the profiled frames."""

from port_bench.program_spans import per_request


def read(run):
    return per_request(run, "frame", ["net.groupnorm"])
