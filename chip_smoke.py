#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the nvcc version,
   and builds the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` (one
   nvcc for each source, started together).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and times both beside the kernel's bound:
   CUDA events around a run of back-to-back calls, and the device's own
   time for the same run from ``torch.profiler`` (see ``timed``).  The
   tensor-core attention sweeps also print their TFLOP/s and their share of
   the IEEE-FMA bound and of the 3×TF32 bound (``bound_tc_ms``, ``rate``);
   the decode sweep its share of the byte bound, its TB/s, the device
   operations a call (one launch), float32 and bfloat16.
   Each autotuned kernel's candidate geometries (rows a block) are held
   against its static geometry bit for bit and timed, and the measured
   autotune cache chooses one at the row's shape (``geometry``).
3. Runs the three main paths twice, each with every launch count set to 0
   just before it and read just after: pass 1 with ``REPRO_AUTOTUNE=0`` and
   no cache file (the static geometry), pass 2 with the cache on and empty
   (each key's first call measures; the fit of (b) is timed cold and warm).
   Both passes keep every check; their launch counts must agree, and their
   outputs must agree bit for bit.  A third pass runs the paths again on
   pass 2's cache (warm) under ``torch.profiler``, with every kernel
   wrapper's launch in a range of its own (``autotune.PROFILE_RANGES``) and
   the checks' own calls left out, and sums each wrapper's device time on
   each path (``PathTrace``).  Sketched kernel ridge regression, fit and
   predict:
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
   Serving minitron-8b at full width (bfloat16 weights from a seed):
   (j) batch 4, an 8192-token prompt, 64 greedy tokens, with the exact and
       the sketched cache (d_slots 1024, m_r 2): prefill time, decode
       tokens/s, cache bytes, 32 × 63 landmark_attention launches, and the
       decode sweep's device time a step under the profiler;
   (k) the sketched prefill ≡ the sequential fold bitwise (bfloat16 and
       float32 caches), sketched ≡ exact decode with identity slots
       (teacher-forced logits), and a killed generate resumed bitwise;
   (l) accum_attention at B·H = 32, S = 32768, d = 1024, m = 8: the kernel
       route against the plain one, and the kernel route's device time by
       kernel under the profiler.
   Then path (m), the K·S baseline of benchmarks/kernel_bench.py:
   ``sketch_right_kernel`` (accum_apply at the cache's geometry) against
   ``accum_apply_scalar`` (the seed's scalar loop, bm=256, bd=8) at the
   anchor R=4096, N=8192, d=64, m=4 and on (c)'s dense K at n = 32768 in
   float32 and bfloat16, beside the static geometry, torch.sparse.mm and the
   plain version; and a corrupt cache file, which falls back to the static
   geometry with a health record.  The autotune caches live in a temporary
   directory, so every run starts cold.
4. Prints one ``{"kernels": [...]}`` line (with each kernel's device ms
   summed on the paths of pass 3 and (m)), the card line, and as the last
   line ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
   before the last line is printed.  Without a CUDA device it exits 2.

Comparisons use allclose with rtol = tol and atol = tol · max|plain|: the
main path's outputs are of order 10²–10⁵ (coefficients r/sqrt(d·m·p) ≈ 90 at
n = 2^21), so an absolute tolerance alone would measure their magnitude.
"""
from __future__ import annotations

import bisect
import collections
import concurrent.futures
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s,
# float32 operations/s outside the tensor cores, and TF32 operations/s on
# the tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 494.7e12

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

# the serving path: minitron-8b's full width, batch, prompt and new tokens;
# the prompt of the identity-slot check (max_len ≤ d_slots) and its tokens;
# accum_attention's sequence length and heads
ARCH, BATCH, PROMPT, NEW = "minitron-8b", 4, 8192, 64
PROMPT_ID, NEW_ID = 512, 32
PROFILED = 4       # decode steps profiled after each serving run of (j)
S_ATT, H_ATT = 32768, 32
# path (m): the K·S microbenchmark's anchor (benchmarks/kernel_bench.py:41)
R_ANCHOR, N_ANCHOR = 4096, 8192

SRC = "src/repro_torch/kernels/accum_apply/csrc/accum_apply.cu"
LSRC = "src/repro_torch/kernels/landmark_attention/csrc/landmark_attention.cu"
TPU = "src/repro/kernels/accum_apply/kernel.py"
LTPU = "src/repro/kernels/landmark_attention/kernel.py"
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
    device ms: the summed duration of the device's kernels and copies in a
    run under ``torch.profiler``, over ``calls``: the larger of two such
    runs, as the profiler now and then misses a record; None where it saw
    no device activity."""
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
    us = 0.0
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = max(us, sum(e.time_range.elapsed_us() for e in prof.events()
                         if e.device_type == DeviceType.CUDA))
    return ms, (us / 1e3 / calls if us > 0 else None)


def profiled(torch, fn) -> tuple[float, float, list, dict]:
    """(wall ms, device ms, the four kernels with the most device time, the
    device ms of every kernel by name) of one ``fn()`` under
    ``torch.profiler``, between device synchronizations.  The profiler's
    own host cost inflates the wall time, not the device's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
    return wall * 1e3, sum(by.values()), [(n[:60], round(t, 3)) for n, t in top], by


def device_ops_per_call(torch, fn, calls: int = 20) -> int:
    """Operations the device ran (kernels, copies, fills) per warm call of
    ``fn``: their count under ``torch.profiler`` over ``calls`` calls, over
    ``calls``, rounded (the profiler now and then misses a record)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return round(sum(e.device_type == DeviceType.CUDA for e in prof.events()) / calls)


class PathTrace:
    """The device time of each kernel wrapper's launches on a main path,
    under ``torch.profiler`` (pass 3); a no-op where ``on`` is false.

    ``begin(path)`` starts one profiler session for the path, with every
    wrapper launching inside a ``launch:<wrapper>`` range
    (``autotune.PROFILE_RANGES``), except the calls made only to check the
    path (``off_path``), which launch outside ranges and so count for no
    wrapper; ``end()`` stops the session and keeps, for the path, each
    wrapper's summed device time and range count (``by_wrapper``) and the
    device ms of every CUDA kernel by name, the checks' included
    (``by_kernel``).  The profiler mirrors each range on the device's
    timeline, spanning the kernels launched inside it; a wrapper's device
    time is the sum of the kernels that lie within its ranges there (on the
    H100 the host-side ranges get no device time of the port's kernels
    linked to them).  The raw kineto events are read rather than
    ``prof.events()``, which builds a Python event, and a tree of them, for
    every host operation of the path."""

    def __init__(self, torch, autotune, on: bool):
        self.torch, self.at, self.on = torch, autotune, on
        self.path, self.prof = None, None
        self.by_wrapper: dict[str, dict[str, list]] = {}
        self.by_kernel: dict[str, dict[str, float]] = {}
        self.seconds: dict[str, float] = {}

    def begin(self, path: str) -> None:
        from torch.profiler import ProfilerActivity, profile

        if not self.on:
            return
        self.path, self.seconds[path] = path, time.perf_counter()
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.at.PROFILE_RANGES = True

    def end(self) -> None:
        from torch.autograd import DeviceType

        if self.prof is None:
            return
        self.torch.cuda.synchronize()
        self.at.PROFILE_RANGES = False
        self.prof.stop()
        ranges, ops, kernels = [], [], {}
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            span, name = (e.start_ns(), e.end_ns()), e.name()
            if name.startswith("launch:"):
                ranges.append((*span, name.removeprefix("launch:")))
            else:
                ops.append(span)
                kernels[name] = kernels.get(name, 0.0) + (span[1] - span[0]) / 1e6
        ops.sort()
        starts = [a for a, _ in ops]
        wrappers: dict[str, list] = {}
        for a, b, name in ranges:
            i, ns = bisect.bisect_left(starts, a), 0
            while i < len(ops) and ops[i][0] <= b:
                if ops[i][1] <= b:
                    ns += ops[i][1] - ops[i][0]
                i += 1
            acc = wrappers.setdefault(name, [0.0, 0])
            acc[0] += ns / 1e6
            acc[1] += 1
        self.by_wrapper[self.path], self.by_kernel[self.path] = wrappers, kernels
        self.seconds[self.path] = time.perf_counter() - self.seconds[self.path]
        self.prof, self.path = None, None


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    """The least time for the work in ms, and whether bytes or operations set it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def rate(name: str, ms: float, flops: float, b_fma: float, b_tc: float) -> dict:
    """Achieved TFLOP/s of a tensor-core sweep and its share of both bounds:
    IEEE float32 FMA, and 3×TF32 (three tensor-core products a product)."""
    tflops = flops / ms / 1e9
    print(f"  {name}: {tflops:.2f} TFLOP/s of float32-accurate work; "
          f"{b_fma / ms:.1%} of the FMA bound ({b_fma:.3f} ms), {b_tc / ms:.1%} of the "
          f"3×TF32 bound ({b_tc:.3f} ms)")
    return dict(bound_tc_ms=b_tc, tflops=tflops, share_of_bound=b_fma / ms,
                share_of_bound_tc=b_tc / ms)


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
    from repro_torch._util import stream_generator, tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.core.sketched_attention import (
        accum_attention, decode_slot_table, decode_slots, init_sketch_cache,
        make_seq_sketch, prefill_sketch_cache, update_sketch_cache)
    from repro_torch.kernels.accum_apply import autotune as AT
    from repro_torch.kernels.accum_apply import kernel as KN
    from repro_torch.kernels.accum_apply import ops as OPS
    from repro_torch.kernels.accum_apply import ref
    from repro_torch.kernels.landmark_attention import kernel as LK
    from repro_torch.kernels.landmark_attention import ops as LO
    from repro_torch.kernels.landmark_attention import ref as LR
    from repro_torch.models.model import decode_step, init_params, param_count
    from repro_torch.resilience import faults
    from repro_torch.resilience.degrade import global_health
    from repro_torch.serve.engine import Engine, ServeConfig

    dev = torch.device(DEVICE)
    # every run starts from empty autotune caches of its own
    tmpdir = tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_")
    tmp = Path(tmpdir.name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([KN._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {nvcc}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        list(pool.map(lambda build: build(), (KN.build, LK.build)))
    KN._lib()
    LK._lib()
    print(f"kernel builds: {time.perf_counter() - t0:.1f} s, in parallel")
    for mod in (KN, LK):
        print(f"  nvcc {mod.BUILD_INFO['seconds']:.1f} s -> {mod.BUILD_INFO['path']}")
        for line in mod.BUILD_INFO["ptxas"].splitlines():
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
    # the cache chooses each row's geometry here from a file of its own, so
    # that the main paths below start from an empty one
    os.environ[AT.ENV_GATE] = "1"
    os.environ[AT.ENV_CACHE] = str(tmp / "kernels.json")

    def geometry(name, kind, key, dtype, cands, launch, choose=None):
        """The launch geometry of ``name`` at this row's shape: every
        candidate's outputs held against the static geometry's
        (``cands[0]``) bit for bit, each candidate's ms, and the geometry
        the cache chose — by one entry-point call, ``choose``, that measures
        at this key (None: the kernel takes the table's geometry alone) —
        timed beside the static one.  Returns the fields for the row."""
        static = cands[0]
        want = launch(static)
        same = all(torch.equal(x, y) for c in cands[1:] for x, y in zip(launch(c), want))
        check(same, f"{name}: every candidate geometry {[c[0] for c in cands]} gives "
                    f"the static geometry's bits")
        cand_ms = {c[0]: timed(torch, lambda c=c: launch(c))[0] for c in cands}
        geo = static
        if choose is not None:
            choose()
            src = LK.source_hash() if kind.startswith("landmark") else KN.source_hash()
            geo = AT.lookup(kind, key, dtype, dev, arity=1, source=src) or static
        ms, dms = timed(torch, lambda: launch(geo))
        print(f"  {name} {key}: candidates (rows a block: ms) "
              f"{ {k: round(v, 4) for k, v in cand_ms.items()} }; chosen by the "
              f"{'cache' if choose else 'table'}: {geo[0]}, {ms:.4f} ms (device {dms}) "
              f"against the static {static[0]}'s {cand_ms[static[0]]:.4f} ms")
        return dict(static_geometry=static[0], geometry=geo[0],
                    geometry_by="cache" if choose else "table", geometry_ms=ms,
                    geometry_device_ms=dms, static_geometry_ms=cand_ms[static[0]],
                    candidate_ms=cand_ms)
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
    rows["matfree_apply"].update(geometry(
        "matfree_apply", "matfree_cols", (nb, 3, d, m, "gaussian"), torch.float32,
        OPS._rows_candidates(OPS.MATFREE_ROWS, nb, AT.STATIC_TABLE["matfree_cols"]),
        lambda c: (KN.matfree_apply(Xb, Lb, cf, kernel="gaussian", bandwidth=bw, bm=c[0]),),
        lambda: OPS.matfree_cols_kernel(Xb, Lb, cf, kernel="gaussian", bandwidth=bw)))
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
    # one fixed geometry (one block per output row), not autotuned: the
    # reference does not autotune accum_apply_left either
    rows["accum_apply_left"] = dict(replaces=f"{TPU}:229", max_abs_err=ea,
                                    max_rel_err=er, ms=ms, device_ms=dms,
                                    plain_ms=pms, bound_ms=b, bound_by=by,
                                    library_ms=lms, library_device_ms=ldms,
                                    geometry_by="fixed")
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
            rows["accum_sketch_both"].update(geometry(
                "accum_sketch_both", "sketch_both", (nc, d, m), dt,
                OPS._gemm_candidates(nc, AT.STATIC_TABLE["sketch_both"]),
                lambda c: KN.accum_sketch_both(Kt, idc, cfc, bm=c[0]),
                lambda: OPS.sketch_both_kernel(Kt, skc)))
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
            rows["accum_apply"].update(geometry(
                "accum_apply", "accum_apply", (nc, nc, d, 1), dt,
                OPS._gemm_candidates(nc, AT.STATIC_TABLE["accum_apply"]),
                lambda c: (KN.accum_apply(Kt, ida, cfa, bm=c[0]),),
                lambda: OPS.sketch_right_kernel(Kt, ska)))
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
                rows["accum_grow_slabs"].update(geometry(
                    "accum_grow_slabs", "accum_grow", (nc, nc, d, B), dt,
                    OPS._gemm_candidates(nc, AT.STATIC_TABLE["accum_grow"]),
                    lambda c: KN.accum_grow_slabs(Kt, idg, cfg, Cw, aw, bm=c[0]),
                    lambda: OPS.accum_grow_kernel(Kt, idg, cfg, Cw, aw)))
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
    # the unit step's geometry is the table's alone, as in the reference
    rows["accum_step_slab"].update(geometry(
        "accum_step_slab", "accum_apply", (N_STEP, N_STEP, d, 1), torch.float32,
        OPS._gemm_candidates(N_STEP, AT.STATIC_TABLE["accum_apply"]),
        lambda c: (KN.accum_step_slab(K8, id8, cf8, C8, aw, bm=c[0]),)))
    del out, lib, C8

    # the serving path's kernels: landmark_attention at the decode shape
    # (B·Hkv = 32 problems of G = 4 query rows over d_slots = 1024 slots)
    # and at the F-stage shape of accum_attention, landmark_stats at S = 32768
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gl = torch.Generator(device=dev).manual_seed(7)
    P, G, Lm, Dh = 32, 4, 1024, 128

    def randn(*shape):
        return torch.randn(shape, generator=gl, device=dev)

    qd, ktd, Md = randn(P, G, Dh), randn(P, Lm, Dh), randn(P, Lm, Dh)
    # the bias lane of a decode: log(mass) of the filled slots, −1e30 for
    # the empty ones (about a tenth here)
    mass = 3 * torch.rand((P, Lm), generator=gl, device=dev)
    bias = torch.where(mass < 0.3, -1e30, torch.log(mass))
    out = LK.landmark_attention(qd, ktd, Md, bias)
    ea, er, ok = close(out, LR.landmark_attention_ref(qd, ktd, Md, bias), 1e-5)
    check(ok, f"landmark_attention f32 decode P={P} G={G} L={Lm} Dh={Dh}: max abs "
              f"{ea:.3e}, /max|plain| {er:.3e} (tol 1e-5)")
    check(torch.equal(LK.landmark_attention(qd, ktd, Md, bias), out),
          "landmark_attention decode: a second call gives the same bits")
    ms, dms = timed(torch, lambda: LK.landmark_attention(qd, ktd, Md, bias))
    pms, _ = timed(torch, lambda: LR.landmark_attention_ref(qd, ktd, Md, bias))
    mask = bias[:, None, :]
    print(f"  SDPA(q, k̃, M, attn_mask=bias) vs kernel: max abs "
          f"{(sdpa(qd, ktd, Md, attn_mask=mask) - out).abs().max().item():.3e}")
    lms, ldms = timed(torch, lambda: sdpa(qd, ktd, Md, attn_mask=mask))
    nbytes = (qd.numel() + ktd.numel() + Md.numel() + bias.numel() + out.numel()) * 4
    b, by = bound_ms(nbytes, 2 * P * G * Lm * 2 * Dh)
    per_call = device_ops_per_call(torch, lambda: LK.landmark_attention(qd, ktd, Md, bias))
    nsplit, run = LK.plan(P, G, Lm, Dh, Dh, torch.float32)
    print(f"  landmark_attention decode: {ms:.4f} ms (device {dms}), plain {pms:.4f} ms, "
          f"bound {b:.5f} ms by {by}, SDPA {lms:.4f} ms (device {ldms}); "
          f"{b / dms:.1%} of the byte bound on device time ({b / ms:.1%} on CUDA events), "
          f"{nbytes / dms / 1e9:.3f} TB/s; {per_call:g} device operations a call; "
          f"{nsplit} splits × {LK.DECODE_WARPS} warps × {run} keys")
    qh, kh, Mh = qd.bfloat16(), ktd.bfloat16(), Md.bfloat16()
    outh = LK.landmark_attention(qh, kh, Mh, bias)
    eh, rh, okh = close(outh, LR.landmark_attention_ref(qh, kh, Mh, bias), 2e-2)
    check(okh and outh.dtype == torch.bfloat16,
          f"landmark_attention bf16 decode: max abs {eh:.3e}, /max|plain| {rh:.3e} "
          f"(tol 2e-2)")
    hms, hdms = timed(torch, lambda: LK.landmark_attention(qh, kh, Mh, bias))
    hbytes = (qh.numel() + kh.numel() + Mh.numel() + outh.numel()) * 2 + bias.numel() * 4
    hb, _ = bound_ms(hbytes, 2 * P * G * Lm * 2 * Dh)
    print(f"  landmark_attention bf16 decode: {hms:.4f} ms (device {hdms}), bound "
          f"{hb:.5f} ms, {hb / hdms:.1%} of it on device time")
    rows["landmark_attention"] = dict(replaces=f"{LTPU}:54", max_abs_err=ea,
                                      max_rel_err=er, ms=ms, device_ms=dms,
                                      plain_ms=pms, bound_ms=b, bound_by=by,
                                      library_ms=lms, library_device_ms=ldms,
                                      library="SDPA with the bias as attn_mask",
                                      shape="decode P=32 G=4 L=1024",
                                      share_of_bound=b / dms, tb_per_s=nbytes / dms / 1e9,
                                      device_ops_per_call=per_call,
                                      plan=dict(splits=nsplit, warps=LK.DECODE_WARPS,
                                                keys_a_warp=run),
                                      bf16=dict(max_abs_err=eh, ms=hms, device_ms=hdms,
                                                bound_ms=hb),
                                      bound_tc_ms=None)   # the decode sweep: bytes
    rows["landmark_attention"].update(geometry(
        "landmark_attention decode", "landmark_attention", (P, G, Dh, Lm, Dh), torch.float32,
        LO._bq_candidates(G, (LK.static_bq(G),), Dh, torch.float32, torch.float32, dev),
        lambda c: (LK.landmark_attention(qd, ktd, Md, bias, bq=c[0]),),
        lambda: LO.landmark_attend(qd, ktd, Md, bias)))
    qf, Mf = randn(P, S_ATT, Dh), randn(P, Lm, Dh)
    out = LK.landmark_attention(qf, ktd, Mf)
    plain = LR.landmark_attention_ref(qf, ktd, Mf)
    ea, er, ok = close(out, plain, 1e-5)
    check(ok, f"landmark_attention f32 F-stage P={P} S={S_ATT} L={Lm}: max abs {ea:.3e}, "
              f"/max|plain| {er:.3e} (tol 1e-5)")
    del plain
    ms, dms = timed(torch, lambda: LK.landmark_attention(qf, ktd, Mf))
    pms, _ = timed(torch, lambda: LR.landmark_attention_ref(qf, ktd, Mf))
    lms, ldms = timed(torch, lambda: sdpa(qf, ktd, Mf))
    flops = 2 * P * S_ATT * Lm * 2 * Dh
    b, by = bound_ms((qf.numel() + ktd.numel() + Mf.numel() + out.numel()) * 4, flops)
    print(f"  landmark_attention F-stage: {ms:.4f} ms (device {dms}), plain {pms:.4f} ms, "
          f"bound {b:.5f} ms by {by}, SDPA {lms:.4f} ms (device {ldms})")
    rows["landmark_attention"]["f_stage"] = dict(
        shape=f"P={P} S={S_ATT} L={Lm}", max_abs_err=ea, ms=ms, device_ms=dms,
        plain_ms=pms, bound_ms=b, bound_by=by, library_ms=lms, library_device_ms=ldms,
        **rate("landmark_attention F-stage", ms, flops, b,
               3 * flops / TF32_OPS_PER_S * 1e3))
    rows["landmark_attention"]["f_stage"].update(geometry(
        "landmark_attention F-stage", "landmark_attention", (P, S_ATT, Dh, Lm, Dh),
        torch.float32,
        LO._bq_candidates(S_ATT, (LK.static_bq(S_ATT),), Dh, torch.float32, torch.float32,
                          dev),
        lambda c: (LK.landmark_attention(qf, ktd, Mf, bq=c[0]),),
        lambda: LO.landmark_attend(qf, ktd, Mf)))
    del qf, Mf, out
    nv, lv = S_ATT - 1000, Lm - 24
    qt, kk, vv = randn(P, Lm, Dh), randn(P, S_ATT, Dh), randn(P, S_ATT, Dh)
    W, BmV = LK.landmark_stats(qt, ktd, kk, vv, n_valid=nv, l_valid=lv)
    Wr, Br = LR.landmark_stats_ref(qt, ktd, kk, vv, n_valid=nv, l_valid=lv)
    eW, rW, okW = close(W, Wr, 1e-5)
    eB, rB, okB = close(BmV, Br, 1e-5)
    check(okW and okB, f"landmark_stats f32 P={P} L={Lm} S={S_ATT} n_valid={nv} "
                       f"l_valid={lv}: W max abs {eW:.3e} (/max {rW:.3e}), BmV max abs "
                       f"{eB:.3e} (/max {rB:.3e}) (tol 1e-5)")
    del Wr, Br
    ms, dms = timed(torch, lambda: LK.landmark_stats(qt, ktd, kk, vv, n_valid=nv,
                                                     l_valid=lv))
    pms, _ = timed(torch, lambda: LR.landmark_stats_ref(qt, ktd, kk, vv, n_valid=nv,
                                                        l_valid=lv))
    kv_, vv_ = kk[:, :nv], vv[:, :nv]
    lms, ldms = timed(torch, lambda: sdpa(qt, kv_, vv_))
    # the BmV sweep on the tensor cores, the W half on IEEE FMA
    flops_b, flops_w = 2 * P * Lm * nv * 2 * Dh, 2 * P * Lm * lv * Dh
    b, by = bound_ms((2 * P * Lm * Dh + 2 * P * nv * Dh + P * Lm * Lm + P * Lm * Dh) * 4,
                     flops_b + flops_w)
    print(f"  landmark_stats: {ms:.4f} ms (device {dms}), plain {pms:.4f} ms, bound "
          f"{b:.5f} ms by {by}; SDPA(q̃, K, V), the BmV half only: {lms:.4f} ms "
          f"(device {ldms})")
    rows["landmark_stats"] = dict(replaces=f"{LTPU}:138", max_abs_err=max(eW, eB),
                                  max_rel_err=max(rW, rB), ms=ms, device_ms=dms,
                                  plain_ms=pms, bound_ms=b, bound_by=by, library_ms=lms,
                                  library_device_ms=ldms,
                                  library="SDPA(q̃, K, V): the BmV half only",
                                  shape=f"P={P} L={Lm} S={S_ATT}",
                                  **rate("landmark_stats", ms, flops_b + flops_w, b,
                                         (3 * flops_b / TF32_OPS_PER_S
                                          + flops_w / F32_OPS_PER_S) * 1e3))
    # the cache chooses at the unmasked shape (its entry point takes no
    # masks); the masked launch is timed at its choice
    rows["landmark_stats"].update(geometry(
        "landmark_stats", "landmark_stats", (P, S_ATT, Dh, Lm, Dh), torch.float32,
        LO._bq_candidates(Lm, AT.STATIC_TABLE["landmark_stats"], Dh, torch.float32,
                          torch.float32, dev),
        lambda c: LK.landmark_stats(qt, ktd, kk, vv, n_valid=nv, l_valid=lv, bs=c[0]),
        lambda: LO.landmark_stats_fused(qt, ktd, kk, vv)))
    del qt, kk, vv, kv_, vv_, W, BmV, qd, ktd, Md
    torch.cuda.synchronize()

    # ---- 3. the main paths, run twice -------------------------------------- #
    ALL = KN.KERNELS + LK.KERNELS

    def reset_counts():
        for f in ALL:
            f.launches = 0

    def counts():
        return {f.__name__: f.launches for f in ALL}

    @contextlib.contextmanager
    def off_path():
        """Calls made only to check the main path: their launches are undone,
        and under pass 3's profiler they launch outside the wrappers' ranges."""
        saved, ranges = counts(), AT.PROFILE_RANGES
        AT.PROFILE_RANGES = False
        yield
        AT.PROFILE_RANGES = ranges
        for f in ALL:
            f.launches = saved[f.__name__]

    trace = PathTrace(torch, AT, False)

    def run_paths(label):
        """Drive the three main paths (a)–(l), each with the launch counts
        set to 0 just before it; return (launches by path, outputs to hold
        across passes).  The data are drawn anew from the seeds of section 2."""
        print(f"\n== main path ({label}) ==")
        gb, Xb, fb, yb = regression(nb, 2)
        skb = make_accum_sketch(gb, nb, d, m, device=dev)
        gc, Xc, fc, yc = regression(nc, 3)
        skc = make_accum_sketch(gc, nc, d, m, device=dev)
        opc = KernelOperator(Xc, "gaussian", bw)
        g8, X8, f8, y8 = regression(N_STEP, 5)
        K8 = KernelOperator(X8, "gaussian", bw).dense()
        held = {}
        reset_counts()
        trace.begin("krr")
        phase_launches = {}

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
        # the same fit again: with the cache on, the first call measured
        # matfree_apply's candidates (cold) and this one is a cache hit (warm)
        with off_path():
            _, tw = wall(torch, lambda: krr_sketched_fit(opb, yb, lam, skb))
        geo = AT.lookup("matfree_cols", (nb, 3, d, m, "gaussian"), torch.float32, dev,
                        arity=1, source=KN.source_hash())
        print(f"  (b) fit: first call {tb * 1e3:.1f} ms, the same fit again {tw * 1e3:.1f} "
              f"ms; matfree_apply geometry {geo or 'static'} (rows a block)")
        held.update(b=model_b.fitted, b_pred=pred)
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
        held["c"] = model_c.fitted
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
        trace.end()
        launches = {"krr": counts()}
        print(f"  launches after each phase (cumulative): {phase_launches}")
        for name in ("matfree_apply", "accum_apply_left", "accum_sketch_both"):
            cnt = launches["krr"][name]
            check(cnt > 0, f"{name} launched {cnt} times on the KRR path (a)-(d)")
        del model_b, model_c, model_d, model_o, Cd, Co, pred, pred_plain

        # ---- 4. the progressive engine's path ----------------------------------- #
        print("\n== main path: the progressive engine ==")
        reset_counts()
        trace.begin("engine")
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
        held.update(f=model_f.fitted, f_unit=model_u.fitted)
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
        held.update(g_C=Cg, g_W=Wg)
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
        held["h"] = model_h.fitted
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
        held.update(i_fix=res_fix.labels, i_tol=res_tol.labels)
        del Ki, Xi
        phase_launches["i"] = counts()
        trace.end()
        launches["engine"] = counts()
        print(f"  launches after each phase (cumulative): {phase_launches}")
        for name in ("accum_apply", "accum_step_slab", "accum_grow_slabs"):
            cnt = launches["engine"][name]
            check(cnt > 0, f"{name} launched {cnt} times on the engine path (e)-(i)")
        del opb, Xb, yb, fb, Xt, Xc, yc, opc
        torch.cuda.empty_cache()

        # ---- 5. the serving path: minitron-8b at full width ---------------------- #
        print(f"\n== main path: serving {ARCH} ==")
        reset_counts()
        trace.begin("serve")
        phase_launches = {}
        cfg = get_config(ARCH)
        sa = cfg.sketch_attn
        L_ = cfg.n_layers
        params, tinit = wall(torch, lambda: init_params(SEED, cfg, device=dev))
        print(f"  (j) {ARCH}: {param_count(params) / 1e9:.3f} B parameters, bfloat16, drawn "
              f"from seed {SEED} on the card in {tinit:.1f} s")
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                generator=torch.Generator().manual_seed(SEED)).numpy()
        served = {}
        for mode in ("exact", "sketched"):
            # PROFILED more positions of room: the profiled decode steps below
            eng = Engine(cfg, params, ServeConfig(max_len=PROMPT + NEW + PROFILED,
                                                  use_sketch=mode == "sketched"))
            (cache, logits), tpre = wall(torch, lambda: eng.prefill_tokens(
                eng.new_cache(BATCH), prompts))
            check(bool(logits.isfinite().all()) and logits.dtype == torch.float32
                  and tuple(logits.shape) == (BATCH, cfg.vocab_size),
                  f"(j) {mode} prefill logits finite, float32, ({BATCH}, {cfg.vocab_size})")
            del cache, logits
            torch.cuda.reset_peak_memory_stats()
            before = LK.landmark_attention.launches
            (toks, cache), tgen = wall(torch, lambda: eng.generate(prompts, NEW))
            la = LK.landmark_attention.launches - before
            nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(cache))
            tdec = tgen - tpre
            served[mode] = toks
            held[f"j_{mode}"] = torch.as_tensor(toks)
            print(f"  (j) {mode:8s}: prefill {BATCH}×{PROMPT} tokens {tpre * 1e3:.1f} ms; "
                  f"generate {NEW} tokens {tgen * 1e3:.1f} ms, so decode {NEW - 1} steps "
                  f"{tdec * 1e3:.1f} ms = {BATCH * (NEW - 1) / tdec:.1f} tokens/s; cache "
                  f"{nbytes / 1e9:.3f} GB; peak {torch.cuda.max_memory_allocated() / 1e9:.1f} "
                  f"GB; landmark_attention launches {la}")
            check(toks.shape == (BATCH, NEW) and bool(((toks >= 0) & (toks < cfg.vocab_size))
                                                      .all()),
                  f"(j) {mode}: {BATCH}×{NEW} tokens in the vocabulary")
            want = L_ * (NEW - 1) if mode == "sketched" else 0
            check(la == want, f"(j) {mode}: landmark_attention launched {la} times, "
                              f"n_layers × (n_new − 1) = {want} expected")
            # where a decode step's time goes: PROFILED more steps under the
            # profiler (device time against the unprofiled step time above), and
            # a 1024-token prefill
            last = torch.as_tensor(toks[:, -1], device=dev)

            def steps(cache=cache):
                for i in range(PROFILED):
                    pos = PROMPT + NEW - 1 + i
                    _, cache = decode_step(params, cache, last, pos, cfg, slots=decode_slots(
                        SEED, pos, sa.d_slots, sa.m_r, max_len=eng.sc.max_len))

            if not trace.on:   # pass 3 is under the profiler already
                with off_path():
                    pw, pdev, top, by = profiled(torch, steps)
                    step_ms = tdec * 1e3 / (NEW - 1)
                    attend = sum(t for k, t in by.items() if "attend_decode_kernel" in k)
                    print(f"  (j) {mode}: {PROFILED} profiled decode steps: device "
                          f"{pdev / PROFILED:.2f} ms a step against {step_ms:.2f} ms "
                          f"unprofiled, so the device idles {1 - pdev / PROFILED / step_ms:.2f} "
                          f"of a step; the decode sweep (attend_decode_kernel) "
                          f"{attend / PROFILED:.3f} ms a step; top kernels {top}")
                    pw, pdev, top, _ = profiled(torch, lambda: eng.prefill_tokens(
                        eng.new_cache(BATCH), prompts[:, :1024]))
                    print(f"  (j) {mode}: profiled prefill of {BATCH}×1024 tokens: wall "
                          f"{pw:.1f} ms, device {pdev:.1f} ms; top kernels {top}")
            del cache, eng
        agree = float((served["exact"] == served["sketched"]).mean())
        print(f"  (j) greedy tokens equal in the two modes at {PROMPT} tokens of context: "
              f"{agree:.3f} (the sketched cache holds {sa.d_slots} slots)")
        phase_launches["j"] = counts()

        # (k) the fold at full width: the prefill cache is bitwise the sequential
        # fold; a draw with max_len > d_slots, so slots are shared
        table = decode_slot_table(SEED, 256, sa.d_slots, sa.m_r)
        gk = torch.Generator(device=dev).manual_seed(8)
        for dt in (torch.bfloat16, torch.float32):
            kk = torch.randn((BATCH, cfg.n_kv_heads, 256, cfg.head_dim), generator=gk,
                             device=dev).to(dt)
            vv = torch.randn(kk.shape, generator=gk, device=dev).to(dt)
            seq = init_sketch_cache(BATCH, cfg.n_kv_heads, sa.d_slots, cfg.head_dim, dt,
                                    device=dev)
            bat = prefill_sketch_cache(seq, kk, vv, table)
            for t in range(256):
                seq = update_sketch_cache(seq, kk[:, :, t], vv[:, :, t], table[t])
            same = all(torch.equal(a, b) for a, b in zip(bat, seq))
            check(same, f"(k) {dt} sketched prefill of 256 tokens ≡ the sequential fold "
                        f"bitwise ({BATCH}×{cfg.n_kv_heads}×{sa.d_slots}×{cfg.head_dim})")
            del kk, vv, seq, bat

        # (k) identity slots (max_len ≤ d_slots): sketched decode is exact
        # attention; the same tokens are forced through both caches.  Tolerance:
        # bfloat16 weights — every layer rounds its attention output to bfloat16
        # after float32 sums taken in another order on the two paths, so the
        # logits differ by bfloat16 noise (2⁻⁸ relative) carried through 32 layers
        ml = PROMPT_ID + NEW_ID
        pk = prompts[:, :PROMPT_ID]
        engs = {m: Engine(cfg, params, ServeConfig(max_len=ml, use_sketch=m == "sketched",
                                                   cache_dtype=torch.float32))
                for m in ("exact", "sketched")}
        forced, _ = engs["exact"].generate(pk, NEW_ID)
        forced_t = torch.as_tensor(forced, device=dev)
        logits_by = {}
        for mode, eng in engs.items():
            cache, lg = eng.prefill_tokens(eng.new_cache(BATCH), pk)
            out_l = [lg]
            for i in range(NEW_ID - 1):
                pos = PROMPT_ID + i
                lg, cache = decode_step(params, cache, forced_t[:, i], pos, cfg,
                                        slots=decode_slots(SEED, pos, sa.d_slots, sa.m_r,
                                                           max_len=ml))
                out_l.append(lg)
            logits_by[mode] = torch.stack(out_l, dim=1)
            del cache
        ex, sk_ = logits_by["exact"], logits_by["sketched"]
        dl = ((sk_ - ex).abs().max() / ex.abs().max()).item()
        agree = (sk_.argmax(-1) == ex.argmax(-1)).float().mean().item()
        check(dl <= 5e-2, f"(k) identity slots, {PROMPT_ID}-token prompt, {NEW_ID} forced "
                          f"tokens: sketched vs exact logits max abs diff / max|exact| "
                          f"{dl:.3e} (tol 5e-2); greedy agreement {agree:.4f}")
        del logits_by, ex, sk_, engs

        # (k) a generate killed at its 2nd decode chunk by the fault plan and
        # resumed from its checkpoint emits the same tokens bitwise
        kw = dict(max_len=2 * sa.d_slots, use_sketch=True, temperature=0.7, seed=3,
                  ckpt_every=4)
        pr = prompts[:1, :256]
        ref_toks, _ = Engine(cfg, params, ServeConfig(**kw)).generate(pr, 12)
        with tempfile.TemporaryDirectory() as ckdir:
            os.environ[faults.ENV_PLAN] = '{"decode.step": {"action": "kill", "at": 2}}'
            faults.reset()
            killed = False
            try:
                Engine(cfg, params, ServeConfig(ckpt_dir=ckdir, **kw)).generate(
                    pr, 12, request_id="r")
            except faults.DeviceLost:
                killed = True
            finally:
                del os.environ[faults.ENV_PLAN]
                faults.reset()
            eng = Engine(cfg, params, ServeConfig(ckpt_dir=ckdir, **kw))
            toks, _ = eng.generate(pr, 12, request_id="r")
        check(killed and (toks == ref_toks).all() and eng.health.count("ckpt.resume") == 1,
              f"(k) generate killed by the decode.step plan and resumed: same 12 tokens "
              f"bitwise ({'killed' if killed else 'NOT killed'})")
        del params, eng
        torch.cuda.empty_cache()
        phase_launches["k"] = counts()

        # (l) accum_attention on a make_seq_sketch draw: the kernel route
        # (landmark_stats, Newton–Schulz, landmark_attention) against the plain
        # one.  Tolerance 1e-3 relative: the six Newton–Schulz steps amplify the
        # float32 sum-order noise of W along its small singular directions (each
        # step scales them by up to 13/4)
        d_att, m_att = sa.d_slots, sa.m
        ga = torch.Generator(device=dev).manual_seed(9)
        qa, ka, va = (torch.randn((1, H_ATT, S_ATT, cfg.head_dim), generator=ga, device=dev)
                      for _ in range(3))
        ska = make_seq_sketch(stream_generator(SEED), S_ATT, d_att, m_att, device=dev)
        before = counts()
        out_a, ta = wall(torch, lambda: accum_attention(qa, ka, va, ska))
        n_la = LK.landmark_attention.launches - before["landmark_attention"]
        n_ls = LK.landmark_stats.launches - before["landmark_stats"]
        plain_a, tpa = wall(torch, lambda: accum_attention(qa, ka, va, ska, use_kernel=False))
        ra = ((out_a - plain_a).norm() / plain_a.norm()).item()
        print(f"  (l) accum_attention B·H={H_ATT} S={S_ATT} d={d_att} m={m_att}: kernel route "
              f"{ta * 1e3:.1f} ms ({n_ls} landmark_stats + {n_la} landmark_attention "
              f"launches), plain route {tpa * 1e3:.1f} ms")
        # where the kernel route's time goes, warm: device time by kernel
        if not trace.on:   # pass 3 is under the profiler already
            with off_path():
                wl, dl, top, _ = profiled(torch, lambda: accum_attention(qa, ka, va, ska))
            print(f"  (l) kernel route under the profiler: {wl:.1f} ms wall, {dl:.1f} ms "
                  f"device; top device kernels (ms) {top}")
        check(bool(out_a.isfinite().all()) and ra <= 1e-3 and n_la == n_ls == 1,
              f"(l) kernel route vs plain: rel {ra:.3e} (tol 1e-3)")
        held["l"] = out_a
        del qa, ka, va, out_a, plain_a
        phase_launches["l"] = counts()
        trace.end()
        launches["serve"] = counts()
        print(f"  launches after each phase (cumulative): {phase_launches}")
        for name in ("landmark_attention", "landmark_stats"):
            cnt = launches["serve"][name]
            check(cnt > 0, f"{name} launched {cnt} times on the serving path (j)-(l)")

        return launches, held

    # pass 1: REPRO_AUTOTUNE=0 and no cache file, so every launch takes the
    # static geometry, as before the cache existed.  Pass 2: the cache on and
    # empty, so each key's first call measures its candidates (cold) and
    # every later call is a cache hit (warm).
    os.environ[AT.ENV_GATE] = "0"
    os.environ[AT.ENV_CACHE] = str(tmp / "pass1.json")
    t_pass = time.perf_counter()
    launches_static, held_static = run_paths("pass 1: static geometry, REPRO_AUTOTUNE=0, "
                                             "no cache file")
    print(f"  pass 1: {time.perf_counter() - t_pass:.1f} s")
    check(not (tmp / "pass1.json").exists(), "pass 1 measured nothing and wrote no cache")
    os.environ[AT.ENV_GATE] = "1"
    os.environ[AT.ENV_CACHE] = str(tmp / "pass2.json")
    measured = collections.Counter(AT.MEASURE_LAUNCHES)
    t_pass = time.perf_counter()
    launches, held = run_paths("pass 2: the autotune cache on, from empty")
    print(f"  pass 2: {time.perf_counter() - t_pass:.1f} s")
    measured = AT.MEASURE_LAUNCHES - measured
    print("\n== the two passes ==")
    check(launches == launches_static,
          f"launch counts of the three paths equal in both passes: "
          f"{ {p: {k: v for k, v in c.items() if v} for p, c in launches.items()} }")
    same = {k: torch.equal(held[k], held_static[k]) for k in held}
    check(all(same.values()), f"pass 2's outputs bitwise pass 1's: {same}")
    print(f"  launches made while measuring in pass 2, counted apart: {dict(measured)}")
    print("  the geometry each key's entry holds after pass 2 (rows a block):")
    for k, v in sorted(json.loads((tmp / "pass2.json").read_text()).items()):
        print(f"    {k}: {v}")
    del held
    torch.cuda.empty_cache()

    # pass 3: the paths again on pass 2's cache (warm: nothing is measured),
    # under the profiler, which sums each kernel wrapper's device time on
    # each path (PathTrace); the checks' own calls are left out (off_path)
    trace.on = True
    measured3 = collections.Counter(AT.MEASURE_LAUNCHES)
    # the CUDA kernels the two sources define, by name
    kernel_def = re.compile(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(")
    PORT_KERNELS = {n for mod in (KN, LK) for n in kernel_def.findall(mod.SOURCE.read_text())}
    t_pass = time.perf_counter()
    launches3, held3 = run_paths("pass 3: pass 2's cache, under the profiler")
    trace.on = False
    print(f"  pass 3: {time.perf_counter() - t_pass:.1f} s")
    print("\n== pass 3: device time of each kernel wrapper on each path ==")
    check(launches3 == launches_static and AT.MEASURE_LAUNCHES == measured3,
          "pass 3: the launch counts of passes 1 and 2, nothing measured")
    same = {k: torch.equal(held3[k], held_static[k]) for k in held3}
    print(f"  pass 3's outputs bitwise pass 1's: {same}")
    for path, sums in trace.by_wrapper.items():
        # the profiler may drop an event now and then: at least 99% of each
        # wrapper's launches must have their range on the device's timeline
        ranges = {k: v[1] for k, v in sums.items()}
        want = {k: v for k, v in launches3[path].items() if v}
        check(set(ranges) == set(want) and all(0.99 * n <= ranges[k] <= n for k, n in want.items()),
              f"pass 3 {path}: the launches' ranges on the device {ranges} (launches {want})")
        print(f"  ({path}) device ms by wrapper: "
              f"{ {k: round(v[0], 4) for k, v in sums.items()} }; profiled and read in "
              f"{trace.seconds[path]:.1f} s")
        top = sorted(trace.by_kernel[path].items(), key=lambda kv: -kv[1])[:8]
        print(f"  ({path}) device ms of the path's kernels by name, the checks' included "
              f"(total {sum(trace.by_kernel[path].values()):.3f}): "
              f"{[(n[:70], round(t, 4)) for n, t in top]}")
        ours = {n.split("::")[1].split("(")[0]: round(t, 4)
                for n, t in trace.by_kernel[path].items()
                if any(f"::{k}<" in n for k in PORT_KERNELS)}
        print(f"  ({path}) the port's CUDA kernels by name, the checks' included: {ours}")
    del held3, held_static
    torch.cuda.empty_cache()

    # ---- 6. path (m): the K·S baseline (benchmarks/kernel_bench.py:52-74) ---- #
    # accum_apply with the cache's geometry against the seed's scalar loop at
    # bm=256, bd=8, at the benchmark's anchor and on the engine's dense K
    print("\n== path (m): the K·S baseline, accum_apply against accum_apply_scalar ==")
    reset_counts()
    # the path's device ms by wrapper: each on-path call's shape timed on
    # its own below (the profiler's device time of back-to-back calls)
    ks = {"accum_apply": [0.0, 0], "accum_apply_scalar": [0.0, 0]}
    gm = torch.Generator(device=dev).manual_seed(10)
    Ka = torch.randn((R_ANCHOR, N_ANCHOR), generator=gm, device=dev)
    skm_a = make_accum_sketch(gm, N_ANCHOR, d, 4, device=dev)
    Kd = opc.dense()          # the dense K of (c) and (f), n = 32768, 4.29 GB
    skm_d = make_accum_sketch(gm, nc, d, 4, device=dev)
    bench = json.loads((Path(__file__).resolve().parent / "BENCH_kernels.json").read_text())
    cpu_ratio = bench["results"]["accum_apply_gemm_R4096_N8192_d64_m4_f32"]["speedup_vs_scalar"]
    scalar_rows = {}
    for label, Kb, skm, dt in [("anchor", Ka, skm_a, torch.float32),
                               ("dense", Kd, skm_d, torch.float32),
                               ("dense", Kd, skm_d, torch.bfloat16)]:
        Kt = Kb.to(dt)
        R, N = Kt.shape
        idm, cfm = skm.indices.contiguous(), skm.coef.float().contiguous()
        tol = 1e-5 if dt == torch.float32 else 2e-2
        tuned = OPS.sketch_right_kernel(Kt, skm)
        scalar = OPS.accum_apply_scalar(Kt, idm, cfm, bm=256, bd=8)
        with off_path():
            plain = ref.accum_apply_ref(Kt, idm, cfm)
            et, _, okt = close(tuned, plain, tol)
            es, rs, oks = close(scalar, plain, tol)
            check(okt and oks and scalar.dtype == dt,
                  f"(m) {label} R={R} N={N} d={d} m=4 {dt}: accum_apply max abs {et:.3e}, "
                  f"accum_apply_scalar max abs {es:.3e} against the plain version (tol {tol})")
            geo = (AT.lookup("accum_apply", (R, N, d, 4), dt, dev, arity=1,
                             source=KN.source_hash())
                   or AT.STATIC_TABLE["accum_apply"])
            ms_t, dms_t = timed(torch, lambda: KN.accum_apply(Kt, idm, cfm, bm=geo[0]))
            ms_s, dms_s = timed(torch, lambda: KN.accum_apply(Kt, idm, cfm))
            ms_c, dms_c = timed(torch, lambda: KN.accum_apply_scalar(Kt, idm, cfm, bm=256,
                                                                     bd=8))
            for name, t in (("accum_apply", dms_t), ("accum_apply_scalar", dms_c)):
                ks[name][0] += t if t is not None else math.nan
                ks[name][1] += 1
            pms, _ = timed(torch, lambda: ref.accum_apply_ref(Kt, idm, cfm))
            St = sketch_csr(torch, idm, cfm, N, transposed=True)
            try:
                St = St.to(dt)
                lib = torch.sparse.mm(St, Kt.T).T
                print(f"  (m) torch.sparse.mm(Sᵀ, Kᵀ)ᵀ vs plain: max abs "
                      f"{(lib.float() - plain.float()).abs().max().item():.3e}")
                lms, ldms = timed(torch, lambda: torch.sparse.mm(St, Kt.T))
            except RuntimeError as e:   # the yardstick only: the port never calls it
                print(f"  (m) torch.sparse.mm(Sᵀ, Kᵀ) in {dt}: not run ({e})")
                lms = ldms = None
            isz = Kt.element_size()
            b, by = bound_ms(R * distinct(idm) * isz + R * d * isz + 4 * d * 8, 2 * R * 4 * d)
        print(f"  (m) {label} R={R} N={N} {dt}: accum_apply, cache's geometry {geo[0]} rows "
              f"a block: {ms_t:.4f} ms (device {dms_t}); static 64: {ms_s:.4f} ms (device "
              f"{dms_s}); accum_apply_scalar bm=256 bd=8: {ms_c:.4f} ms (device {dms_c}); "
              f"torch.sparse.mm: {lms} ms (device {ldms}); plain {pms:.4f} ms; bound "
              f"{b:.5f} ms by {by}")
        print(f"  (m) scalar / autotuned on the card: {ms_c / ms_t:.2f}× (device "
              f"{(dms_c or 0) / max(dms_t or 1e-9, 1e-9):.2f}×); interpret-mode Pallas on a "
              f"CPU (BENCH_kernels.json, a CPU figure): {cpu_ratio:.2f}×")
        scalar_rows[f"{label} {str(dt).removeprefix('torch.')}"] = dict(
            shape=f"R={R} N={N} d={d} m=4", max_abs_err=es, max_rel_err=rs, ms=ms_c,
            device_ms=dms_c, plain_ms=pms, bound_ms=b, bound_by=by, library_ms=lms,
            library_device_ms=ldms, accum_apply_geometry=geo[0], accum_apply_ms=ms_t,
            accum_apply_static_ms=ms_s, ratio_scalar_over_autotuned=ms_c / ms_t)
        del Kt, tuned, scalar, plain
    phase_launches = {"m": counts()}
    launches["ks"] = counts()
    trace.by_wrapper["ks"] = ks
    print(f"  (m) device ms by wrapper: { {k: round(v[0], 4) for k, v in ks.items()} }")
    print(f"  launches on path (m): {phase_launches}")
    for name in ("accum_apply", "accum_apply_scalar"):
        cnt = launches["ks"][name]
        check(cnt == 3, f"{name} launched {cnt} times on path (m), 3 expected")
    anchor = scalar_rows.pop("anchor float32")
    rows["accum_apply_scalar"] = dict(
        replaces=f"{TPU}:529", library="torch.sparse.mm(Sᵀ, Kᵀ)ᵀ", geometry_by="fixed",
        geometry="bm=256 bd=8", dense=scalar_rows, **anchor)

    # a corrupt cache file: the static table, recorded in the health report
    bad = tmp / "corrupt.json"
    bad.write_text('{"accum_apply|4096|8192|64|4|float32|cuda')   # cut short
    os.environ[AT.ENV_CACHE] = str(bad)
    before = global_health().count("autotune.load")
    with off_path():
        os.environ[AT.ENV_GATE] = "0"
        out = OPS.sketch_right_kernel(Ka, skm_a)
        ea, _, ok = close(out, ref.accum_apply_ref(Ka, skm_a.indices, skm_a.coef.float()),
                          1e-5)
    rec = global_health().count("autotune.load") - before
    check(rec == 1 and ok, f"a corrupt cache file: K·S still right (max abs {ea:.3e}) at "
                           f"the static geometry; health {global_health().summary()}")
    del Ka, Kd, out

    # device ms on the paths: pass 3's KRR, engine and serving paths summed
    # by wrapper under the profiler, and path (m)'s calls timed one by one
    def on_paths(name):
        return {p: round(w[name][0], 6) for p, w in trace.by_wrapper.items() if name in w}

    for name, row in rows.items():
        print(f"  {name}: device ms summed on the paths {on_paths(name)}")
        print(f"  {name}: {row['ms']:.4f} ms, device {row['device_ms']} ms "
              f"(plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.5f} ms by {row['bound_by']}, library "
              f"{row['library_ms']}); geometry {row.get('geometry')} by "
              f"{row['geometry_by']}")
    # launches: the sum over the main paths of pass 2 and path (m), each
    # counted from 0
    kernels = [dict(name=f.__name__, route="cuda", source=SRC if f in KN.KERNELS else LSRC,
                    launches=sum(c[f.__name__] for c in launches.values()),
                    launches_by_path={p: c[f.__name__] for p, c in launches.items()},
                    launches_measuring=measured[f.__name__],
                    device_ms_on_paths=sum(on_paths(f.__name__).values()),
                    device_ms_by_path=on_paths(f.__name__), **rows[f.__name__])
               for f in ALL]
    tmpdir.cleanup()
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
