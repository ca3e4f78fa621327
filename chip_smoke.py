#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the nvcc version,
   and builds the CUDA kernels from ``src/repro_torch/kernels/*/csrc``.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and times both beside the kernel's bound:
   CUDA events around a run of back-to-back calls, and the device's own
   time for the same run from ``torch.profiler`` (see ``timed``).
3. Runs the two main paths, each with every launch count set to 0 just
   before it and read just after.  Sketched kernel ridge regression, fit
   and predict:
   (a) quickstart §1 (n=2000, d=40): Nyström m=1 and accumulation m=8
       matrix-free fits against exact float64 KRR;
   (b) operator fit and predict at n = 2^21, d=64, m=4;
   (c) dense-K fit at n = 32768 against the operator fit on the same data;
   (d) preconditioned CG on (b)'s data, 30 iterations.
   The progressive engine, with an error target in place of m:
   (e) quickstart §2 (n=2000, d=32): adaptive fits at three targets;
   (f) adaptive KRR on a dense K at n = 32768, doubling and unit schedules;
   (g) the unit schedule on a dense K at n = 8192;
   (h) adaptive KRR on the operator at n = 2^21;
   (i) spectral clustering of planted blobs at n = 32768, fixed m and tol.
4. Prints one ``{"kernels": [...]}`` line, the card line, and as the last
   line ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
   before the last line is printed.  Without a CUDA device it exits 2.

Comparisons use allclose with rtol = tol and atol = tol · max|plain|: the
main path's outputs are of order 10²–10⁵ (coefficients r/sqrt(d·m·p) ≈ 90 at
n = 2^21), so an absolute tolerance alone would measure their magnitude.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# the main paths' sizes: operator fit (C is 512 MiB), predict rows, dense K,
# the dense K of the unit schedule (the widest K of one accum_step_slab)
N_OP, N_TEST, N_DENSE, N_STEP = 2**21, 65536, 32768, 8192
DEVICE = "cuda"
DRAWS = 8          # sketch draws of each kind in phase (a)
SEED = 0           # the engine's seed in phases (e)-(i)
# error target of the adaptive fits in phases (f), (g) and (h): below what
# d = 64 columns reach on this data, so the growth runs to m_max and every
# batch size of the doubling ladder is driven
TOL_F = TOL_G = TOL_H = 1e-4

SRC = "src/repro_torch/kernels/accum_apply/csrc/accum_apply.cu"
TPU = "src/repro/kernels/accum_apply/kernel.py"
FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    """Print one check's outcome and remember a failure."""
    print(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        FAILURES.append(what)


def close(out, plain, tol: float):
    """(max abs err, max err / max|plain|, allclose with atol = tol·max|plain|)."""
    out, plain = out.double(), plain.double()
    err = (out - plain).abs()
    scale = max(plain.abs().max().item(), 1e-30)
    ok = bool((err <= tol * scale + tol * plain.abs()).all()) and bool(
        out.isfinite().all())
    return err.max().item(), err.max().item() / scale, ok


def timed(torch, fn, reps: int = 5, run_ms: float = 20.0,
          max_calls: int = 200) -> tuple[float, float | None]:
    """(ms, device ms) of one call of ``fn``, from runs of back-to-back calls.

    ms: CUDA events around a run of ``calls`` calls, over ``calls``; the
    median of ``reps`` runs, after warm-up.  ``calls`` is sized from one call
    so that a run lasts about ``run_ms``.  Where the host takes longer to
    issue a call than the device to run it, this measures the host.
    device ms: the summed duration of the device's kernels and copies in one
    such run under ``torch.profiler``, over ``calls``; None where the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / calls

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    calls = max(1, min(max_calls, round(run_ms / max(run(1), 1e-3))))
    ms = statistics.median(run(calls) for _ in range(reps))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return ms, (us / 1e3 / calls if us > 0 else None)


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    """The least time for the work in ms, and whether bytes or operations set it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def wall(torch, fn):
    """(fn(), seconds on the host clock between two device synchronizations)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sketch_csr(torch, idx, coef, n: int, *, transposed: bool = False):
    """The sketch S (n, d), or Sᵀ, as one sparse CSR matrix; draws that hit
    one row of a column are summed, as in S."""
    m, d = idx.shape
    cols = torch.arange(d, device=idx.device).repeat(m)
    ij = torch.stack([idx.reshape(-1).long(), cols])
    shape = (n, d)
    if transposed:
        ij, shape = ij.flip(0), (d, n)
    return torch.sparse_coo_tensor(ij, coef.reshape(-1), shape).coalesce().to_sparse_csr()


def pairwise_agreement(torch, truth, labels) -> float:
    """Share of ordered point pairs (i, j) on which two labelings agree about
    being in one cluster, from their contingency table: n² − T − L + 2·S11
    over n², with T, L the same-cluster pair counts of each labeling and S11
    those of both."""
    n = truth.numel()
    k = int(max(truth.max(), labels.max())) + 1
    table = torch.bincount(truth.long() * k + labels.long(),
                           minlength=k * k).reshape(k, k).double()
    s11 = (table ** 2).sum()
    t, l_ = (table.sum(1) ** 2).sum(), (table.sum(0) ** 2).sum()
    return float((n * n - t - l_ + 2 * s11) / (n * n))


def main() -> int:
    """Run the checks and the main path; return the exit code."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import apply as A
    from repro_torch.core import (
        KernelOperator, get_kernel, insample_error, krr_exact_fitted,
        krr_sketched_fit, krr_sketched_fit_adaptive, krr_sketched_fit_matfree,
        krr_sketched_fit_pcg, make_accum_sketch, make_nystrom_sketch,
        spectral_cluster)
    from repro_torch._util import stream_generator
    from repro_torch.kernels.accum_apply import kernel as KN
    from repro_torch.kernels.accum_apply import ops as OPS
    from repro_torch.kernels.accum_apply import ref

    dev = torch.device(DEVICE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([KN._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {nvcc}")
    t0 = time.perf_counter()
    KN._lib()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {KN.BUILD_INFO['seconds']:.1f} s) -> {KN.BUILD_INFO['path']}")
    for line in KN.BUILD_INFO["ptxas"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    lam, bw = 1e-3, 0.5
    gauss = get_kernel("gaussian", bw)

    def regression(n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        X = torch.rand((n, 3), generator=g, device=dev)
        f = torch.sin(3 * X[:, 0]) + X[:, 1] ** 2 - X[:, 2]
        y = f + 0.3 * torch.randn((n,), generator=g, device=dev)
        return g, X, f, y

    # ---- 2. kernels against their plain versions -------------------------- #
    print("\n== kernels vs plain (on the card) ==")
    rows = {}
    nb, d, m = N_OP, 64, 4
    gb, Xb, fb, yb = regression(nb, 2)
    skb = make_accum_sketch(gb, nb, d, m, device=dev)
    Lb = Xb.index_select(0, skb.indices.reshape(-1)).contiguous()
    cf = skb.coef.float().contiguous()

    out = KN.matfree_apply(Xb, Lb, cf, kernel="gaussian", bandwidth=bw)
    plain = ref.landmark_cols_ref(Xb, Lb, cf, gauss)
    ea, er, ok = close(out, plain, 1e-5)
    check(ok, f"matfree_apply gaussian f32 n={nb} d={d} m={m}: max abs "
              f"{ea:.3e}, /max|plain| {er:.3e} (tol 1e-5)")
    ms, dms = timed(torch, lambda: KN.matfree_apply(Xb, Lb, cf, kernel="gaussian",
                                                   bandwidth=bw))
    pms, _ = timed(torch, lambda: ref.landmark_cols_ref(Xb, Lb, cf, gauss))
    nbytes = Xb.numel() * 4 + Lb.numel() * 4 + cf.numel() * 4 + nb * d * 4
    b, by = bound_ms(nbytes, nb * m * d * (2 * 3 + 7))
    rows["matfree_apply"] = dict(replaces=f"{TPU}:474", max_abs_err=ea,
                                 max_rel_err=er, ms=ms, device_ms=dms,
                                 plain_ms=pms, bound_ms=b, bound_by=by,
                                 library_ms=None)
    del plain
    for kern, nu in [("laplacian", 1.5), ("matern", 0.5), ("matern", 1.5),
                     ("matern", 2.5)]:
        out = KN.matfree_apply(Xb, Lb, cf, kernel=kern, bandwidth=bw, nu=nu)
        plain = ref.landmark_cols_ref(Xb.double(), Lb.double(), cf.double(),
                                      get_kernel(kern, bw, nu))
        ea, er, ok = close(out, plain, 5e-3)
        check(ok, f"matfree_apply {kern} nu={nu} f32 vs f64 plain: max abs "
                  f"{ea:.3e}, /max|plain| {er:.3e} (tol 5e-3, self-pair cusp)")
        del plain
    Xh, Lh = Xb.bfloat16(), Lb.bfloat16()
    out = KN.matfree_apply(Xh, Lh, cf, kernel="gaussian", bandwidth=bw)
    ea, er, ok = close(out, ref.landmark_cols_ref(Xh.float(), Lh.float(), cf,
                                                  gauss), 5e-2)
    check(ok, f"matfree_apply gaussian bf16: max abs {ea:.3e}, /max|plain| "
              f"{er:.3e} (tol 5e-2)")

    Cb = KN.matfree_apply(Xb, Lb, cf, kernel="gaussian", bandwidth=bw)
    idx = skb.indices.contiguous()
    out = KN.accum_apply_left(Cb, idx, cf)
    ea, er, ok = close(out, ref.sketch_left_ref(idx, cf, Cb), 1e-5)
    check(ok, f"accum_apply_left f32 M=({nb}, {d}): max abs {ea:.3e}, "
              f"/max|plain| {er:.3e} (tol 1e-5)")
    ms, dms = timed(torch, lambda: KN.accum_apply_left(Cb, idx, cf))
    pms, _ = timed(torch, lambda: ref.sketch_left_ref(idx, cf, Cb))
    St = sketch_csr(torch, idx, cf, nb, transposed=True)
    lib = torch.sparse.mm(St, Cb)
    print(f"  torch.sparse.mm(Sᵀ, C) vs plain: max abs "
          f"{(lib - ref.sketch_left_ref(idx, cf, Cb)).abs().max().item():.3e}")
    lms, ldms = timed(torch, lambda: torch.sparse.mm(St, Cb))
    print(f"  torch.sparse.mm(Sᵀ, C): device {ldms} ms per call")
    b, by = bound_ms(m * d * d * 4 + m * d * 8 + d * d * 4, 2 * m * d * d)
    rows["accum_apply_left"] = dict(replaces=f"{TPU}:229", max_abs_err=ea,
                                    max_rel_err=er, ms=ms, device_ms=dms,
                                    plain_ms=pms, bound_ms=b, bound_by=by,
                                    library_ms=lms)
    out = KN.accum_apply_left(Cb.bfloat16(), idx, cf)
    ea, er, ok = close(out, ref.sketch_left_ref(idx, cf, Cb.bfloat16()), 3e-2)
    check(ok, f"accum_apply_left bf16: max abs {ea:.3e}, /max|plain| {er:.3e} "
              "(tol 3e-2)")
    del Cb, out

    nc = N_DENSE
    gc, Xc, fc, yc = regression(nc, 3)
    skc = make_accum_sketch(gc, nc, d, m, device=dev)
    opc = KernelOperator(Xc, "gaussian", bw)
    Kc = opc.dense()
    idc, cfc = skc.indices.contiguous(), skc.coef.float().contiguous()
    for dt, tol in [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)]:
        Kt = Kc.to(dt)
        C, W = KN.accum_sketch_both(Kt, idc, cfc)
        Cr, Wr = ref.sketch_both_ref(Kt, idc, cfc)
        eC, rC, okC = close(C, Cr, tol)
        eW, rW, okW = close(W, Wr, tol)
        check(okC and okW and C.dtype == dt,
              f"accum_sketch_both {dt} n={nc}: C max abs {eC:.3e} (/max "
              f"{rC:.3e}), W max abs {eW:.3e} (/max {rW:.3e}) (tol {tol})")
        if dt == torch.float32:
            ms, dms = timed(torch, lambda: KN.accum_sketch_both(Kt, idc, cfc))
            pms, _ = timed(torch, lambda: ref.sketch_both_ref(Kt, idc, cfc))
            b, by = bound_ms(nc * m * d * 4 + m * d * 8 + nc * d * 4 + d * d * 4,
                             2 * nc * m * d + 2 * m * d * d)
            rows["accum_sketch_both"] = dict(
                replaces=f"{TPU}:164", max_abs_err=max(eC, eW),
                max_rel_err=max(rC, rW), ms=ms, device_ms=dms, plain_ms=pms,
                bound_ms=b, bound_by=by, library_ms=None)
        del Kt, C, W, Cr, Wr

    # the engine's kernels: accum_apply (the unit step on a wide K) at m = 1,
    # accum_grow_slabs (every batch on a dense K) at B = 1 and 16
    def distinct(idx):
        return int(torch.unique(idx).numel())

    ska = make_accum_sketch(gc, nc, d, 1, device=dev)
    ida, cfa = ska.indices.contiguous(), ska.coef.float().contiguous()
    for dt, tol in [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]:
        Kt = Kc.to(dt)
        out = KN.accum_apply(Kt, ida, cfa)
        ea, er, ok = close(out, ref.accum_apply_ref(Kt, ida, cfa), tol)
        check(ok and out.dtype == dt, f"accum_apply {dt} R=N={nc} m=1 d={d}: max "
                                      f"abs {ea:.3e}, /max|plain| {er:.3e} (tol {tol})")
        ms, dms = timed(torch, lambda: KN.accum_apply(Kt, ida, cfa))
        pms, _ = timed(torch, lambda: ref.accum_apply_ref(Kt, ida, cfa))
        isz = Kt.element_size()
        b, by = bound_ms(nc * distinct(ida) * isz + nc * d * isz + d * 8, 2 * nc * d)
        print(f"  accum_apply {dt}: {ms:.4f} ms (device {dms}), plain {pms:.4f} ms, "
              f"bound {b:.5f} ms")
        if dt == torch.float32:
            # K S as (Sᵀ Kᵀ)ᵀ through cuSPARSE, with Sᵀ one CSR (d, N) matrix
            St = sketch_csr(torch, ida, cfa, nc, transposed=True)
            lib = torch.sparse.mm(St, Kt.T)
            print(f"  torch.sparse.mm(Sᵀ, Kᵀ)ᵀ vs plain: max abs "
                  f"{(lib.T - out).abs().max().item():.3e}")
            lms, ldms = timed(torch, lambda: torch.sparse.mm(St, Kt.T))
            print(f"  torch.sparse.mm(Sᵀ, Kᵀ): {lms:.4f} ms (device {ldms})")
            rows["accum_apply"] = dict(replaces=f"{TPU}:84", max_abs_err=ea,
                                       max_rel_err=er, ms=ms, device_ms=dms,
                                       plain_ms=pms, bound_ms=b, bound_by=by,
                                       library_ms=lms)
        del Kt, out

    # accum_step_slab at N = 32768 beside the route the engine takes there
    # (accum_apply, then a·C + G): data for the MAX_COLS question, off path
    Cw = torch.randn((nc, d), generator=gc, device=dev)
    aw = math.sqrt(3 / 4)
    wide = {"accum_step_slab": lambda: KN.accum_step_slab(Kc, ida, cfa, Cw, aw),
            "accum_apply + a·C": lambda: OPS.sketch_step_kernel(Kc, ida[0], cfa[0],
                                                                Cw, aw)}
    ea, _, ok = close(wide["accum_step_slab"](), wide["accum_apply + a·C"](), 1e-5)
    check(ok, f"accum_step_slab at N={nc} vs the accum_apply route: max abs "
              f"{ea:.3e} (tol 1e-5)")
    for name, fn in wide.items():
        ms, dms = timed(torch, fn)
        print(f"  unit step at N={nc} through {name}: {ms:.4f} ms (device {dms})")

    for B in (1, 16):
        skg = make_accum_sketch(gc, nc, d, B, device=dev)
        idg, cfg = skg.indices.contiguous(), skg.coef.float().contiguous()
        for dt, tol in [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)]:
            Kt = Kc.to(dt)
            got = KN.accum_grow_slabs(Kt, idg, cfg, Cw, aw)
            plain = ref.accum_grow_ref(Kt, idg, cfg, Cw, aw)
            errs = [close(x, y, tol) for x, y in zip(got, plain)]
            C2 = Cw.clone()
            again = KN.accum_grow_slabs(Kt, idg, cfg, C2, aw, out=C2)
            same = all(torch.equal(x, y) for x, y in zip(again, got))
            check(all(e[2] for e in errs) and same,
                  f"accum_grow_slabs {dt} n={nc} d={d} B={B}: C_new, TᵀG, TᵀC max "
                  f"abs {', '.join(f'{e[0]:.3e}' for e in errs)} (tol {tol}); "
                  f"written over Cin: {'same bits' if same else 'DIFFERENT'}")
            ms, dms = timed(torch, lambda: KN.accum_grow_slabs(Kt, idg, cfg, Cw, aw))
            pms, _ = timed(torch, lambda: ref.accum_grow_ref(Kt, idg, cfg, Cw, aw))
            isz = Kt.element_size()
            b, by = bound_ms(nc * distinct(idg) * isz + 2 * nc * d * 4 + B * d * 8
                             + 2 * d * d * 4,
                             2 * nc * B * d + 2 * nc * d + 4 * B * d * d)
            print(f"  accum_grow_slabs {dt} B={B}: {ms:.4f} ms (device {dms}), "
                  f"plain {pms:.4f} ms, bound {b:.5f} ms")
            if dt == torch.float32 and B == 16:
                # no one PyTorch call returns C_new with both d×d pieces
                rows["accum_grow_slabs"] = dict(
                    replaces=f"{TPU}:370", max_abs_err=max(e[0] for e in errs),
                    max_rel_err=max(e[1] for e in errs), ms=ms, device_ms=dms,
                    plain_ms=pms, bound_ms=b, bound_by=by, library_ms=None)
            del Kt, got, plain, again, C2
    del Kc, Cw

    # accum_step_slab at the unit schedule's N = 8192 (phase (g)'s K)
    g8, X8, f8, y8 = regression(N_STEP, 5)
    K8 = KernelOperator(X8, "gaussian", bw).dense()
    sk8 = make_accum_sketch(g8, N_STEP, d, 1, device=dev)
    id8, cf8 = sk8.indices.contiguous(), sk8.coef.float().contiguous()
    C8 = torch.randn((N_STEP, d), generator=g8, device=dev)
    out = KN.accum_step_slab(K8, id8, cf8, C8, aw)
    ea, er, ok = close(out, ref.accum_step_ref(K8, id8, cf8, C8, aw), 1e-5)
    check(ok, f"accum_step_slab f32 N={N_STEP} d={d}: max abs {ea:.3e}, /max|plain| "
              f"{er:.3e} (tol 1e-5)")
    ea16, _, ok = close(KN.accum_step_slab(K8.bfloat16(), id8, cf8, C8, aw),
                        ref.accum_step_ref(K8.bfloat16(), id8, cf8, C8, aw), 1e-5)
    check(ok, f"accum_step_slab bf16 K: max abs {ea16:.3e} (tol 1e-5)")
    ms, dms = timed(torch, lambda: KN.accum_step_slab(K8, id8, cf8, C8, aw))
    pms, _ = timed(torch, lambda: ref.accum_step_ref(K8, id8, cf8, C8, aw))
    S8 = sketch_csr(torch, id8, cf8, N_STEP)
    lib = torch.addmm(C8, K8, S8, beta=aw)
    print(f"  torch.addmm(C, K, S, beta=a) vs kernel: max abs "
          f"{(lib - out).abs().max().item():.3e}")
    lms, ldms = timed(torch, lambda: torch.addmm(C8, K8, S8, beta=aw))
    print(f"  torch.addmm(C, K, S, beta=a): {lms:.4f} ms (device {ldms})")
    b, by = bound_ms(N_STEP * distinct(id8) * 4 + 2 * N_STEP * d * 4 + d * 8,
                     3 * N_STEP * d)
    rows["accum_step_slab"] = dict(replaces=f"{TPU}:277", max_abs_err=ea,
                                   max_rel_err=er, ms=ms, device_ms=dms,
                                   plain_ms=pms, bound_ms=b, bound_by=by,
                                   library_ms=lms)
    del out, lib, C8
    torch.cuda.synchronize()

    # ---- 3. the main path ------------------------------------------------- #
    print("\n== main path ==")
    KN.reset_launches()
    phase_launches = {}

    def counts():
        return {f.__name__: f.launches for f in KN.KERNELS}

    @contextlib.contextmanager
    def off_path():
        """Calls made only to check the main path: their launches are undone."""
        saved = counts()
        yield
        for f in KN.KERNELS:
            f.launches = saved[f.__name__]

    # (a) quickstart §1.  One draw does not order the two (the reference's
    # own key-0 draw gives Nyström the lower error), so the claim is held as
    # the median over DRAWS draws of each sketch.
    n, da = 2000, 40
    ga, Xa, _, ya = regression(n, 0)
    fitted_exact = krr_exact_fitted(gauss(Xa.double(), Xa.double()),
                                    ya.double(), lam)
    errs = {"nystrom m=1": [], "accumulation m=8": []}
    for _ in range(DRAWS):
        for name, sk in {
                "nystrom m=1": make_nystrom_sketch(ga, n, da, device=dev),
                "accumulation m=8": make_accum_sketch(ga, n, da, m=8,
                                                      device=dev)}.items():
            model = krr_sketched_fit_matfree(Xa, ya, lam, sk, gauss)
            errs[name].append(
                insample_error(model.fitted.double(), fitted_exact).item())
    med = {k: statistics.median(v) for k, v in errs.items()}
    for name, v in med.items():
        print(f"  (a) {name:17s} median ‖f̂_S − f̂_n‖²_n over {DRAWS} draws = "
              f"{v:.3e}")
    check(all(math.isfinite(e) for v in errs.values() for e in v)
          and med["accumulation m=8"] < med["nystrom m=1"],
          "(a) accumulation m=8 beats Nyström m=1 against exact KRR (median)")
    phase_launches["a"] = counts()

    # (b) operator fit + predict at n = 2^21
    opb = KernelOperator(Xb, "gaussian", bw)
    model_b, tb = wall(torch, lambda: krr_sketched_fit(opb, yb, lam, skb))
    gt = torch.Generator(device=dev).manual_seed(4)
    Xt = torch.rand((N_TEST, 3), generator=gt, device=dev)
    pred, tp = wall(torch, lambda: model_b.predict(Xt))
    with off_path():
        pred_plain = opb.cross_cols(Xt, skb, use_kernel=False) @ model_b.theta
    rel = ((pred - pred_plain).norm() / pred_plain.norm()).item()
    mse = torch.mean((model_b.fitted - fb) ** 2).item()
    print(f"  (b) fit n={nb} d={d} m={m}: {tb * 1e3:.1f} ms; predict {N_TEST} rows:"
          f" {tp * 1e3:.1f} ms; C {nb * d * 4 / 2**20:.0f} MiB on the card")
    check(bool(model_b.fitted.isfinite().all()) and bool(pred.isfinite().all())
          and tuple(pred.shape) == (N_TEST,),
          f"(b) fitted and predictions finite; MSE to f_true {mse:.3e}")
    check(rel <= 1e-4, f"(b) predict vs plain route: rel {rel:.3e} (tol 1e-4)")
    phase_launches["b"] = counts()

    # (c) dense-K fit at n = 32768 vs the operator fit on the same data
    def dense_fit():
        return krr_sketched_fit(opc.dense(), yc, lam, skc)

    model_c, tc = wall(torch, dense_fit)
    with off_path():
        Kc = opc.dense()
        Cd, Wd = A.sketch_both(Kc, skc)
        del Kc
        Co, Wo = opc.sketch_both(skc)
        model_o = krr_sketched_fit(opc, yc, lam, skc)
    rC = ((Cd - Co).norm() / Co.norm()).item()
    rW = ((Wd - Wo).norm() / Wo.norm()).item()
    Mo = Co.T @ Co + nc * lam * Wo
    rhs = Co.T @ yc
    res = ((Mo @ model_c.theta - rhs).norm() / rhs.norm()).item()
    res_own = ((Mo @ model_o.theta - rhs).norm() / rhs.norm()).item()
    rf = ((model_c.fitted - model_o.fitted).norm() / model_o.fitted.norm()).item()
    # the kernels are deterministic, so the C compared here is the timed
    # fit's own: its fitted values are this C times its θ
    rown = ((Cd @ model_c.theta - model_c.fitted).norm()
            / model_c.fitted.norm()).item()
    print(f"  (c) dense-K fit n={nc} (K built on the card): {tc * 1e3:.1f} ms")
    check(rC <= 1e-4 and rW <= 1e-4,
          f"(c) dense ≡ operator: C rel {rC:.3e}, W rel {rW:.3e} (tol 1e-4)")
    check(res <= 1e-4, f"(c) dense θ in the operator's d×d system: relative "
                       f"residual {res:.3e} (operator θ: {res_own:.3e}; tol "
                       f"1e-4); fitted rel diff {rf:.3e}")
    check(bool(model_c.fitted.isfinite().all()) and rown <= 1e-6,
          f"(c) fitted finite and equal to C·θ of the compared C: rel "
          f"{rown:.3e} (tol 1e-6)")
    phase_launches["c"] = counts()

    # (d) PCG on (b)'s data
    model_d, td = wall(torch, lambda: krr_sketched_fit_pcg(opb, yb, lam, skb,
                                                           iters=30))
    rd = ((model_d.fitted - model_b.fitted).norm()
          / model_b.fitted.norm()).item()
    mse_d = torch.mean((model_d.fitted - fb) ** 2).item()
    print(f"  (d) PCG fit n={nb}, 30 iterations: {td * 1e3:.1f} ms")
    check(bool(model_d.fitted.isfinite().all()),
          f"(d) PCG fitted finite; rel diff to the direct solve {rd:.3e}; MSE "
          f"to f_true {mse_d:.3e} (direct {mse:.3e})")
    phase_launches["d"] = counts()
    launches = {"krr": counts()}
    print(f"  launches after each phase (cumulative): {phase_launches}")
    for name in ("matfree_apply", "accum_apply_left", "accum_sketch_both"):
        cnt = launches["krr"][name]
        check(cnt > 0, f"{name} launched {cnt} times on the KRR path (a)-(d)")
    del model_b, model_c, model_d, model_o, Cd, Co, pred, pred_plain

    # ---- 4. the progressive engine's path ----------------------------------- #
    print("\n== main path: the progressive engine ==")
    KN.reset_launches()
    phase_launches = {}

    def rel(x, y):
        return ((x - y).norm() / y.norm()).item()

    # (e) quickstart §2: error targets in place of m on a precomputed K; one
    # seed, so a smaller target walks further along the same trajectory
    de, lam_e = 32, 1e-3
    Ke = get_kernel("gaussian", 0.4)(Xa, Xa)
    exact_e = krr_exact_fitted(Ke.double(), ya.double(), lam_e)
    chosen = []
    for tol in (0.2, 0.05, 0.02):
        model = krr_sketched_fit_adaptive(Ke, ya, lam_e, SEED, de, tol=tol, m_max=32)
        info = model.info
        chosen.append(info["m"])
        err = insample_error(model.fitted.double(), exact_e).item()
        print(f"  (e) tol={tol:5.2f}: m={info['m']:2d} in {info['passes']} passes "
              f"(est err {info['err']:.3f}), ‖f̂_S − f̂_n‖²_n = {err:.3e}")
        check(math.isfinite(err) and (info["err"] <= tol or info["m"] == 32),
              f"(e) tol={tol}: the estimate clears the target or m = m_max")
    check(chosen == sorted(chosen), f"(e) chosen m {chosen} does not shrink as tol shrinks")
    del Ke
    phase_launches["e"] = counts()

    # (f) adaptive KRR on a dense K at n = 32768, doubling then unit schedule
    Kf, tk = wall(torch, opc.dense)
    before = KN.accum_grow_slabs.launches
    model_f, tf = wall(torch, lambda: krr_sketched_fit_adaptive(
        Kf, yc, lam, SEED, d, tol=TOL_F, m_max=32))
    info = model_f.info
    grows = KN.accum_grow_slabs.launches - before
    print(f"  (f) doubling fit n={nc} d={d}: {tf * 1e3:.1f} ms (K built in "
          f"{tk * 1e3:.1f} ms): m={info['m']} in {info['passes']} passes, est err "
          f"{info['err']:.4f} (tol {TOL_F}); accum_grow_slabs launches {grows}")
    check(grows == info["passes"] <= 6 and bool(model_f.fitted.isfinite().all()),
          "(f) one accum_grow_slabs launch per executed batch, at most 6")
    _, Cf, Wf, info_g = A.grow_sketch_both(SEED, Kf, d, m_max=32, tol=TOL_F)
    rown = rel(Cf @ model_f.theta, model_f.fitted)
    check(info_g["m"] == info["m"] and rown <= 1e-6,
          f"(f) the fit's fitted values are C·θ of the engine's C: rel {rown:.3e}")
    with off_path():
        st = A.accum_grow(Kf, A.accum_init(stream_generator(SEED), nc, d, 32,
                                           device=dev), info["m"])
    rC, rW = rel(Cf, st.C), rel(Wf, st.W)
    check(rC <= 1e-5 and rW <= 1e-5,
          f"(f) doubling ≡ unit growth (accum_apply route) to m={info['m']}: "
          f"C rel {rC:.3e}, W rel {rW:.3e} (tol 1e-5)")
    del st, Cf, Wf
    model_u, tu = wall(torch, lambda: krr_sketched_fit_adaptive(
        Kf, yc, lam, SEED, d, tol=TOL_F, m_max=32, schedule="unit"))
    print(f"  (f) unit fit: {tu * 1e3:.1f} ms: m={model_u.info['m']} in "
          f"{model_u.info['passes']} passes, est err {model_u.info['err']:.4f}")
    check(bool(model_u.fitted.isfinite().all())
          and (model_u.info["err"] <= TOL_F or model_u.info["m"] == 32),
          "(f) unit fit finite; the estimate clears the target or m = m_max")
    del Kf, model_f, model_u
    phase_launches["f"] = counts()

    # (g) the unit schedule at n = 8192, one accum_step_slab per slab
    (skg, Cg, Wg, info), tg = wall(torch, lambda: A.grow_sketch_both(
        SEED, K8, d, m_max=16, tol=TOL_G, schedule="unit"))
    print(f"  (g) unit growth n={N_STEP}: {tg * 1e3:.1f} ms, m={info['m']}, est err "
          f"{info['err']:.4f} (tol {TOL_G})")
    with off_path():
        st = A.accum_grow_batched(K8, A.accum_init(stream_generator(SEED), N_STEP, d,
                                                   16, device=dev), info["m"])
    rC, rW = rel(Cg, st.C), rel(Wg, st.W)
    check(info["passes"] == info["m"] and rC <= 1e-5 and rW <= 1e-5,
          f"(g) unit ≡ batched growth to m={info['m']}: C rel {rC:.3e}, W rel "
          f"{rW:.3e} (tol 1e-5)")
    del K8, st, Cg, Wg
    phase_launches["g"] = counts()

    # (h) the engine on the operator at n = 2^21: matfree_apply on (B, d) blocks
    model_h, th = wall(torch, lambda: krr_sketched_fit_adaptive(
        opb, yb, lam, SEED, d, tol=TOL_H, m_max=16))
    info = model_h.info
    pred = model_h.predict(Xt)
    with off_path():
        pred_plain = opb.cross_cols(Xt, model_h.sk, use_kernel=False) @ model_h.theta
    rp = rel(pred, pred_plain)
    mse_h = torch.mean((model_h.fitted - fb) ** 2).item()
    print(f"  (h) operator fit n={nb} d={d}: {th * 1e3:.1f} ms, m={info['m']} in "
          f"{info['passes']} passes, est err {info['err']:.4f} (tol {TOL_H}); MSE "
          f"to f_true {mse_h:.3e}")
    check(bool(model_h.fitted.isfinite().all()) and rp <= 1e-4,
          f"(h) predict vs plain route: rel {rp:.3e} (tol 1e-4)")
    del model_h, pred, pred_plain
    phase_launches["h"] = counts()

    # (i) spectral clustering of four planted blobs (examples/
    # sketched_pca_kmeans.py: centres 4·e_j in p = 32, spread 0.5, bandwidth 4)
    gi = torch.Generator(device=dev).manual_seed(6)
    truth = torch.arange(nc, device=dev) % 4
    Xi = 0.5 * torch.randn((nc, 32), generator=gi, device=dev)
    Xi[torch.arange(nc, device=dev), truth] += 4.0
    Ki = get_kernel("gaussian", 4.0)(Xi, Xi)
    res_fix, tfix = wall(torch, lambda: spectral_cluster(SEED, Ki, 4, d=32, m=8))
    res_tol, ttol = wall(torch, lambda: spectral_cluster(SEED, Ki, 4, d=32,
                                                         tol=0.2, m_max=16))
    pa_fix = pairwise_agreement(torch, truth, res_fix.labels)
    pa_tol = pairwise_agreement(torch, truth, res_tol.labels)
    print(f"  (i) spectral n={nc}: fixed m=8 {tfix * 1e3:.1f} ms, agreement "
          f"{pa_fix:.4f}; tol=0.2 {ttol * 1e3:.1f} ms, m={res_tol.info['m']} "
          f"(est err {res_tol.info['err']:.3f}), agreement {pa_tol:.4f}")
    check(pa_tol >= pa_fix, "(i) the tol route agrees with the planted labels at "
                            "least as well as fixed m=8")
    del Ki, Xi
    phase_launches["i"] = counts()
    launches["engine"] = counts()
    print(f"  launches after each phase (cumulative): {phase_launches}")
    for name in ("accum_apply", "accum_step_slab", "accum_grow_slabs"):
        cnt = launches["engine"][name]
        check(cnt > 0, f"{name} launched {cnt} times on the engine path (e)-(i)")

    for name, row in rows.items():
        print(f"  {name}: {row['ms']:.4f} ms, device {row['device_ms']} ms "
              f"(plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.5f} ms by {row['bound_by']}, library "
              f"{row['library_ms']})")
    # launches: the sum over the two main paths, each counted from 0
    kernels = [dict(name=f.__name__, route="cuda", source=SRC,
                    launches=sum(c[f.__name__] for c in launches.values()),
                    launches_by_path={p: c[f.__name__] for p, c in launches.items()},
                    **rows[f.__name__])
               for f in KN.KERNELS]
    if FAILURES:
        print(f"\nchip_smoke: {len(FAILURES)} check(s) failed:", file=sys.stderr)
        for f in FAILURES:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
