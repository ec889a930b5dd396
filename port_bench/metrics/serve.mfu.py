"""The whole frame's share of the chip's peak, %: the configuration's
FLOPs of one stereo forward times the window's frames, over the window's
seconds times the configuration's published peak."""


def read(run):
    c = run.counters
    if not c.get("frames") or not c.get("window_s"):
        return None
    return 100.0 * c["flops"] / (c["window_s"] * c["peak_flops"])
