"""Device ms of a served frame's stereo network: the program's
`net.encoder` and `net.stereo` spans (the image encoder and RAFT-Stereo,
CUDA events), summed per frame, mean over the profiled frames."""

from port_bench.program_spans import per_request


def read(run):
    return per_request(run, "frame", ["net.encoder", "net.stereo"])
