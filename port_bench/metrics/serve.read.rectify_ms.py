"""Host ms a served frame spends solving the rectification and building
its maps: the program's `read.rectify` span (`rectify_stereo_pair` in
`_build_rectified`), mean over the profiled frames."""

from port_bench.program_spans import per_request


def read(run):
    return per_request(run, "frame", ["read.rectify"])
