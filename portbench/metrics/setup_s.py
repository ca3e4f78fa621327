"""``setup_s``: the seconds from the start of the process to the first timed
job: imports, the card's start, the data made from the seed, and every shape
the window uses warmed (on a checkout's first run, the kernels' build and the
autotune measurements too)."""


def read(ctx: dict):
    return ctx["setup_s"]
