"""Device ms of a training step's forward and loss: CUDA events from the
step's start to its own mark("forward"), mean over the window's steps."""


def read(run):
    return run.mean("forward")
