"""Host ms a served frame spends decoding its files: the program's
`read.decode` spans (each image, mask and camera file of
`StereoHumanDataset.load_view`), summed per frame, mean over the profiled
frames."""

from port_bench.program_spans import per_request


def read(run):
    return per_request(run, "frame", ["read.decode"])
