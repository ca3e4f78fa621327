#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the nvcc version,
   and builds the CUDA kernels from ``src/repro_torch/kernels/*/csrc``.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and times both beside the kernel's bound:
   CUDA events around a run of back-to-back calls, and the device's own
   time for the same run from ``torch.profiler`` (see ``timed``).
3. Runs the main path — sketched kernel ridge regression, fit and predict —
   with every launch count set to 0 just before and read just after:
   (a) quickstart §1 (n=2000, d=40): Nyström m=1 and accumulation m=8
       matrix-free fits against exact float64 KRR;
   (b) operator fit and predict at n = 2^21, d=64, m=4;
   (c) dense-K fit at n = 32768 against the operator fit on the same data;
   (d) preconditioned CG on (b)'s data, 30 iterations.
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

# the main path's sizes: operator fit (C is 512 MiB), predict rows, dense K
N_OP, N_TEST, N_DENSE = 2**21, 65536, 32768
DEVICE = "cuda"
DRAWS = 8          # sketch draws of each kind in phase (a)

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
        krr_sketched_fit, krr_sketched_fit_matfree, krr_sketched_fit_pcg,
        make_accum_sketch, make_nystrom_sketch)
    from repro_torch.kernels.accum_apply import kernel as KN
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
    # Sᵀ as one sparse CSR (d, n) matrix: duplicates summed, as in S
    cols = torch.arange(d, device=dev).repeat(m)
    St = torch.sparse_coo_tensor(
        torch.stack([cols, idx.reshape(-1).long()]), cf.reshape(-1),
        (d, nb)).coalesce().to_sparse_csr()
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
    del Kc
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
    launches = counts()
    print(f"  launches after each phase (cumulative): {phase_launches}")
    for name, cnt in launches.items():
        check(cnt > 0, f"{name} launched {cnt} times on the main path")

    for name, row in rows.items():
        print(f"  {name}: {row['ms']:.4f} ms, device {row['device_ms']} ms "
              f"(plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.5f} ms by {row['bound_by']}, library "
              f"{row['library_ms']})")
    kernels = [dict(name=name, route="cuda", source=SRC,
                    tpu=row["replaces"], launches=launches[name], **row)
               for name, row in rows.items()]
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
