"""``mfu.<job>``: the whole job's share of the card's peak: the FLOPs the
window's jobs need, counted from their shapes (``yardstick.work``), over the
traced window's seconds at the TF32 tensor-core rate."""
from portbench.yardstick import peaks


def read(ctx: dict):
    flops = sum(w["flops"] for w in ctx["work"])
    if flops <= 0 or ctx["window_s"] <= 0:
        return None
    return 100.0 * flops / (ctx["window_s"] * peaks.TF32_FLOPS_PER_S)
