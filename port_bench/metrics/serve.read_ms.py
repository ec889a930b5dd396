"""Host ms a frame spends in the dataset: `get_test_sample` of the run's
StereoHumanDataset (decode, online rectification), host clock around the
wrapped call, mean over the window's frames."""


def read(run):
    return run.mean("read")
