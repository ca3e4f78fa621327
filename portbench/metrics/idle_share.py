"""``idle_share.<job>``: the share of the traced window in which no
operation ran on the device (the union of the device's kernels, copies and
fills, against the window's length on the host clock)."""


def read(ctx: dict):
    s = ctx["summary"]
    if not s["ops"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / ctx["window_s"])
