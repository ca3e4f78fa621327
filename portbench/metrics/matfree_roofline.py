"""``matfree_roofline.<job>``: the share of its roofline at which the
program's ``matfree_apply`` kernel ran: the least time its calls' work
needs (``yardstick.work.matfree``: bytes at the HBM rate or FLOPs at the
TF32 rate, whichever is larger) over the device time inside its
``launch:matfree_apply`` ranges.  Nothing is read when the ranges do not
number the calls the window's jobs made (a lost record would read high)."""
from portbench.yardstick import work


def read(ctx: dict):
    ns, calls = ctx["summary"]["ranges"].get("matfree_apply", (0, 0))
    shapes = [shape for w in ctx["work"] for shape in w["matfree"]]
    if ns <= 0 or calls != len(shapes):
        return None
    bound = sum(work.bound_s(*work.matfree(*shape)) for shape in shapes)
    return 100.0 * bound / (ns / 1e9)
