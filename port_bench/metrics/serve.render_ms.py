"""Device ms of `FreeviewRenderer.render` a view (projection, binning,
pair sort, composite): CUDA events around the wrapped call, mean over the
window's views."""


def read(run):
    return run.mean("render")
