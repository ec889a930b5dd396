"""Device ms of `FreeviewRenderer.gaussians` a frame (upload, stereo
network, GSRegresser, compaction): CUDA events around the wrapped call,
mean over the window's frames."""


def read(run):
    return run.mean("forward")
