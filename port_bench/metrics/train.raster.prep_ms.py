"""Device ms of a training step's render before the composite, forward:
the program's `raster.project` and `raster.sort` spans in a `step`,
summed per step, mean over the profiled steps."""

from port_bench.program_spans import per_request


def read(run):
    return per_request(run, "step", ["raster.project", "raster.sort"])
