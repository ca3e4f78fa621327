"""The work counts and bounds against hand counts at a tiny shape, and the
readers that turn a trace into per-layer metrics."""
from __future__ import annotations

import pytest

from portbench import harness
from portbench.yardstick import peaks, work


def test_matfree_counts_by_hand():
    # 10 rows of 3 features, m = 2 slabs of d = 4 columns: 80 kernel entries
    # of 2·3 + 3 = 9 FLOPs; X 30, L 24, coef 8 floats read, C 40 written
    flops, nbytes = work.matfree(10, 3, 2, 4)
    assert flops == 80 * 9
    assert nbytes == 4 * (30 + 24 + 8 + 40)


def test_bound_is_the_larger_of_bytes_and_flops():
    assert work.bound_s(0.0, peaks.HBM_BYTES_PER_S) == pytest.approx(1.0)
    assert work.bound_s(peaks.TF32_FLOPS_PER_S, 1.0) == pytest.approx(1.0)
    assert work.bound_s(2 * peaks.TF32_FLOPS_PER_S, peaks.HBM_BYTES_PER_S) == pytest.approx(2.0)


def test_job_counts_by_hand():
    n, p, m, d, k = 10, 3, 2, 4, 2
    mf = 80 * 9
    assert work.gram(n, d) == 10 * 4 * 5
    assert work.eigh(d) == pytest.approx((4 / 3 + 2) * 64)
    assert work.krr_pcg_fit(n, p, m, d, 3) == pytest.approx(
        mf + 64 + 64 / 3 + 80 + 3 * (160 + 64 + 40) + 80)
    embed = (mf + 64 + 2 * (4 / 3 + 2) * 64 + 160 + 64 + 40 + 200 + 160 + 60)
    lloyd = 1 * (2 * 3 * 10 * 2 + 5 * (4 * 10 * 4 + 2 * 10 * 2))
    assert work.spectral_cluster(n, p, m, d, k, 1, 5) == pytest.approx(embed + lloyd + 80)


def _summary(ops, ranges, window_s):
    from portbench.yardstick.trace import _union_ns

    return {"ops": ops, "ranges": ranges, "host": [],
            "busy_s": _union_ns([(a, b) for a, b, _ in ops]) / 1e9,
            "device_s": sum(b - a for a, b, _ in ops) / 1e9, "window_s": window_s}


def test_readers_by_hand():
    ms = 1_000_000
    ops = [(0, 40 * ms, "matfree"), (40 * ms, 100 * ms, "gemm"), (150 * ms, 200 * ms, "gemm")]
    s = _summary(ops, {"matfree_apply": [40 * ms, 2]}, 0.25)
    shape = (1000, 90, 8, 6144)
    ctx = {"summary": s, "setup_s": 9.5, "window_s": 0.25, "jobs": 2,
           "work": [{"flops": 1e12, "matfree": [shape]}] * 2}
    assert harness.reader("library_ms.fit")(ctx) == pytest.approx((40 + 60 + 50 - 40) / 2)
    assert harness.reader("idle_share.cluster")(ctx) == pytest.approx(100 * (1 - 0.15 / 0.25))
    assert harness.reader("mfu.fit")(ctx) == pytest.approx(100 * 2e12 / (0.25 * peaks.TF32_FLOPS_PER_S))
    bound = 2 * work.bound_s(*work.matfree(*shape))
    assert harness.reader("matfree_roofline.fit")(ctx) == pytest.approx(100 * bound / 0.04)
    assert harness.reader("setup_s")(ctx) == 9.5
    assert harness.reader("fit_s")(ctx) == harness.reader("cluster_s")(ctx) == 0.125


def test_roofline_reads_nothing_when_ranges_miss_calls():
    ctx = {"summary": _summary([(0, 10, "x")], {"matfree_apply": [10, 1]}, 1.0),
           "window_s": 1.0, "jobs": 2,
           "work": [{"flops": 1.0, "matfree": [(1, 1, 1, 1)]}] * 2}
    assert harness.reader("matfree_roofline.cluster")(ctx) is None
    ctx["summary"] = _summary([(0, 10, "x")], {}, 1.0)
    assert harness.reader("matfree_roofline.cluster")(ctx) is None
    assert harness.reader("fit_s")({"window_s": 1.0, "jobs": 0}) is None


def test_union_counts_overlaps_once():
    from portbench.yardstick.trace import _union_ns

    assert _union_ns([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
