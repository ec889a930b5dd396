"""Device ms of a served frame's render before the composite: the
program's `raster.project` (compaction, projection) and `raster.sort`
(binning, the pair sort) spans, summed per frame, mean over the profiled
frames."""

from port_bench.program_spans import per_request


def read(run):
    return per_request(run, "frame", ["raster.project", "raster.sort"])
