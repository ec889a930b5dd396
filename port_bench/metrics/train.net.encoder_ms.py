"""Device ms of a training step's encoders in the forward: the program's
`net.encoder` span in a `step` (CUDA events; RAFT-Stereo's feature and
context nets and the context convolutions), mean over the profiled
steps."""

from port_bench.program_spans import per_request


def read(run):
    return per_request(run, "step", ["net.encoder"])
