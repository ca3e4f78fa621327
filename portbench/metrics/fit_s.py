"""``fit_s``: the measured window's seconds over the fits it completed, one
client in a closed loop."""


def read(ctx: dict):
    return ctx["window_s"] / ctx["jobs"] if ctx["jobs"] else None
