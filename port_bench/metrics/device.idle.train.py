"""Share of the profiled stretch of training steps in which no kernel,
copy or set ran on the card, %."""


def read(run):
    return run.idle_pct()
