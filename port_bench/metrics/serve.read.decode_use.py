"""Share of the decoded image and mask files that reach the sample, %:
100 x the program's counter `read.files_needed` over `read.files_decoded`
in the profiled frames (50 while each source is decoded twice)."""

from port_bench.program_spans import counter_share


def read(run):
    return counter_share("read.files_needed", "read.files_decoded")
