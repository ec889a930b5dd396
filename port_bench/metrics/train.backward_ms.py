"""Device ms of a training step's backward (the rasterizer's included):
CUDA events from mark("forward") to mark("backward"), mean over the
window's steps."""


def read(run):
    return run.mean("backward")
