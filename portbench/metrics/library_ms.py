"""``library_ms.<job>``: the device milliseconds a job spends outside the
program's own kernels (the PyTorch library's GEMMs, solvers, reductions and
copies): the traced window's device time, less the device time inside the
``launch:<wrapper>`` ranges of the program's kernel wrappers, over the jobs
the window completed."""


def read(ctx: dict):
    s, jobs = ctx["summary"], ctx["jobs"]
    if not s["ops"] or not jobs:
        return None
    own = sum(ns for ns, _ in s["ranges"].values()) / 1e9
    return 1e3 * (s["device_s"] - own) / jobs
