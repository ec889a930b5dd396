"""The whole step's share of the chip's peak, %: the configuration's
forward-plus-backward FLOPs a sample times the batch and the window's
steps, over the window's seconds times the configuration's published
peak."""


def read(run):
    c = run.counters
    if not c.get("steps") or not c.get("window_s"):
        return None
    return 100.0 * c["flops"] / (c["window_s"] * c["peak_flops"])
