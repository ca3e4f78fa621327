#!/usr/bin/env python3
"""Time the column gather and ``matfree_apply`` of ``accum_apply.cu``
against an earlier version of that source, in one process on one NVIDIA GPU.

    python3 scripts/bench_gather.py [--parent REV_OR_FILE] [--matfree] [--diagnose]

The parent is ``git show REV:src/repro_torch/kernels/accum_apply/csrc/
accum_apply.cu`` (default ``HEAD``), or the file of that name where one
exists (a machine without git takes a copy made beforehand).  Both sources
are built with ``kernel.build_source`` (the port's nvcc flags) into
``build/repro_torch/``, and ptxas's register and spill report of the two
kernels is printed.

The column gather (default): the four wrappers that share it, at the main
paths' shapes on a Gaussian K (bandwidth 0.5 on uniform points in 3-d, as
``chip_smoke.py`` builds it): ``accum_grow_slabs`` at n = 32768 with B = 1
and 16, float32 and bfloat16 K; ``accum_apply`` at m = 1, float32 and
bfloat16; ``accum_sketch_both`` at m = 4; ``accum_step_slab`` at N = 8192.
Every output of the change must be the parent's bits (exit 1 otherwise).
Then the card's rate for random sectors (``chip_smoke.sector_rates`` on the
float32 K: 1024 and 64 sampled columns a row, unsorted, sorted, whole
sectors and 64-byte segments) and each shape's sector bound.

``--matfree``: ``matfree_apply`` at n = 2^21, d = 64, p = 3 (Gaussian at
m = 4 and 16, float32 and bfloat16; Laplacian at m = 4), the change held
against the parent (within 1e-5 of max|plain| for the Gaussian) and against
the plain version (1e-5, and 5e-3 of the float64 plain version for the
Laplacian's self-pair cusp, 5e-2 in bfloat16), beside its byte, FP32 and
SFU bounds.

Times are ``chip_smoke.timed``'s (CUDA events, and the profiler's device
time) at each version's default geometry, in the order parent, change,
change, parent; ``--matfree`` also times the change at 64 to 2048 rows a
block, and writing C alone (``torch.zero_``, the floor of its bytes).
``--diagnose`` also times copies of the change (``build/variants/``) with
one part altered, once each: the gather without its sort (``unsorted``),
sorted at every m·d (``sorted_all``), with one load in flight a thread
(``unroll1``) or half the tile (``tile2048``), all with the same bits;
matfree with 4 or 16 rows a warp step (``rb4``, ``rb16``), its ex2 replaced
by an FP32 add (``no_sfu``) or its stores dropped (``no_store``), the last
two wrong by design and unchecked.  The last line is a JSON object of every
time.  Without a CUDA device it exits 2.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC_REL = "src/repro_torch/kernels/accum_apply/csrc/accum_apply.cu"
N_DENSE, N_STEP, N_OP, D = 32768, 8192, 2**21, 64
# the parent's matfree_apply entry: (…, jc, kind, bw, 2·bw², rows, is_bf16, stream)
PARENT_KINDS = {("gaussian", None): 0, ("laplacian", None): 1, ("matern", 0.5): 2,
                ("matern", 1.5): 3, ("matern", 2.5): 4}
DIAGNOSTICS = {
    "unsorted": [("for (int k = 2; k <= np2; k <<= 1) {",
                  "for (int k = 2 * np2; k <= np2; k <<= 1) {")],
    "sorted_all": [("constexpr int GATHER_SORTED_MIN = 256;",
                    "constexpr int GATHER_SORTED_MIN = 1;")],
    "unroll1": [("constexpr int GATHER_UNROLL = 8;", "constexpr int GATHER_UNROLL = 1;")],
    "tile2048": [("constexpr int GATHER_TILE = 4096;", "constexpr int GATHER_TILE = 2048;")],
    "no_store": [("if (rb + q < r_end) out[(size_t)(rb + q) * d + j0 + jj] = acc[q];",
                  "if (acc[q] == -1.2345e-38f) out[(size_t)(rb + q) * d + j0 + jj] = acc[q];")],
    "rb4": [("matfree_apply_kernel<T, Q, (Q > 0 ? 8 : 1), GAUSS>",
             "matfree_apply_kernel<T, Q, (Q > 0 ? 4 : 1), GAUSS>")],
    "rb16": [("matfree_apply_kernel<T, Q, (Q > 0 ? 8 : 1), GAUSS>",
              "matfree_apply_kernel<T, Q, (Q > 0 ? 16 : 1), GAUSS>")],
    "no_sfu": [("if constexpr (GAUSS) return ex2_approx(fminf(-q, 0.0f));",
                "if constexpr (GAUSS) return fminf(-q, 0.0f) + 1.0f;")],
}
GATHER_DIAGNOSTICS = ("unsorted", "sorted_all", "unroll1", "tile2048")
MATFREE_DIAGNOSTICS = ("rb4", "rb16", "no_sfu", "no_store")


def parent_source(arg: str) -> Path:
    """The parent's source: the file ``arg`` where it exists, else
    ``git show arg:SRC_REL`` written under ``build/variants/``."""
    if Path(arg).is_file():
        return Path(arg).resolve()
    text = subprocess.run(["git", "show", f"{arg}:{SRC_REL}"], cwd=ROOT, capture_output=True,
                          text=True, check=True).stdout
    out = ROOT / "build" / "variants" / "accum_apply_parent.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def variant(source: Path, name: str) -> Path:
    """A copy of ``source`` with DIAGNOSTICS[name] applied."""
    text = source.read_text()
    for old, new in DIAGNOSTICS[name]:
        if old not in text:
            raise SystemExit(f"diagnostic {name}: {old!r} is not in {source}")
        text = text.replace(old, new)
    out = ROOT / "build" / "variants" / f"accum_apply_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def same_bits(x, y) -> bool:
    import torch

    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return x.dtype == y.dtype and torch.equal(x.view(ints[x.dtype]), y.view(ints[y.dtype]))


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_gather: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as CS
    from repro_torch.core import KernelOperator, get_kernel, make_accum_sketch
    from repro_torch.kernels.accum_apply import kernel as KN
    from repro_torch.kernels.accum_apply import ref

    parent_arg = argv[argv.index("--parent") + 1] if "--parent" in argv else "HEAD"
    matfree, diagnose = "--matfree" in argv, "--diagnose" in argv
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    sources = {"parent": parent_source(parent_arg), "change": KN.SOURCE}
    if diagnose:
        for name in MATFREE_DIAGNOSTICS if matfree else GATHER_DIAGNOSTICS:
            sources[name] = variant(KN.SOURCE, name)
    infos = {name: {} for name in sources}
    with concurrent.futures.ThreadPoolExecutor() as pool:
        list(pool.map(lambda kv: KN.build_source(kv[1], infos[kv[0]]), sources.items()))
    libs = {}
    for name, src in sources.items():
        KN.SOURCE = src
        KN._lib.cache_clear()
        libs[name] = KN._lib()
        print(f"{name} ({src.name}): nvcc {infos[name]['seconds']:.1f} s")
        lines = infos[name]["ptxas"].splitlines()
        for i, line in enumerate(lines):
            for kern in ("matfree_apply_kernel", "sketch_gather_kernel"):
                if "Compiling entry" in line and kern in line:
                    report = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                              if "registers" in x or "spill" in x]
                    print(f"  {kern}{line.split(kern)[1][:40]}: {'; '.join(report)}")
    KN.SOURCE = sources["change"]
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs["parent"].repro_matfree_apply.argtypes = [P, P, P, P, I, I, I, I, I, I, F, F, I, I, P]

    def use(name):
        KN._lib = lambda lib=libs[name]: lib

    dev = torch.device("cuda")
    times: dict[str, dict] = {}
    failed = False
    clock = CS.sm_clock_hz()
    print(f"SM clock (clocks.max.sm): {clock / 1e6:.0f} MHz")

    def rounds(label, fns, bounds):
        """Time ``fns`` (name → callable) parent, change, change, parent, then
        each diagnostic variant once; print each time and its share of the
        bounds (name → ms)."""
        for order in ([["parent", "change"], ["change", "parent"]]
                      + [[k for k in fns if k not in ("parent", "change")]]):
            for name in order:
                if name in libs:
                    use(name)
                ms, dms = CS.timed(torch, fns[name])
                times.setdefault(label, {}).setdefault(name, []).append(
                    dict(ms=ms, device_ms=dms))
                share = ", ".join(f"{k} {v / dms:.1%}" for k, v in bounds.items()) if dms else ""
                print(f"  {label} {name}: {ms:.4f} ms (device {dms}); of the bounds: {share}")

    g = torch.Generator(device=dev).manual_seed(3)
    if matfree:
        X = torch.rand((N_OP, 3), generator=g, device=dev)
        for kernel, m, dt in (("gaussian", 4, torch.float32), ("gaussian", 16, torch.float32),
                              ("laplacian", 4, torch.float32), ("gaussian", 4, torch.bfloat16)):
            sk = make_accum_sketch(g, N_OP, D, m, device=dev)
            Xt = X.to(dt)
            L = Xt.index_select(0, sk.indices.reshape(-1)).contiguous()
            cf = sk.coef.float().contiguous()
            bw, nu = 0.5, 1.5
            key = (kernel, None)
            jc = max(1, min(D, 48 * 1024 // (m * 5 * 4)))

            def parent_run(Xt=Xt, L=L, cf=cf, m=m, kernel=kernel, key=key):
                out = torch.empty((N_OP, D), device=dev)
                err = libs["parent"].repro_matfree_apply(
                    Xt.data_ptr(), L.data_ptr(), cf.data_ptr(), out.data_ptr(), N_OP, 3, m, D,
                    jc, PARENT_KINDS[key], bw, 2 * bw * bw, 64, int(dt == torch.bfloat16),
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"parent matfree_apply failed with CUDA error {err}")
                return out

            def change_run(Xt=Xt, L=L, cf=cf, kernel=kernel):
                return KN.matfree_apply(Xt, L, cf, kernel=kernel, bandwidth=bw, nu=nu)

            label = f"matfree_apply {kernel} m={m} {str(dt).removeprefix('torch.')}"
            use("change")
            got, was = change_run(), parent_run()
            cusp = kernel != "gaussian"
            if cusp:
                plain = ref.landmark_cols_ref(X.double(), L.double(), cf.double(),
                                              get_kernel(kernel, bw, nu))
            else:
                plain = ref.landmark_cols_ref(Xt.float(), L.float(), cf, get_kernel(kernel, bw, nu))
            tol = 5e-3 if cusp else 1e-5 if dt == torch.float32 else 5e-2
            ea, er, ok = CS.close(got, plain, tol)
            ep, rp, okp = CS.close(was, plain, tol)
            scale = plain.abs().max().item()
            diff = (got.double() - was.double()).abs().max().item()
            agree = cusp or dt != torch.float32 or diff <= 1e-5 * scale
            failed |= not (ok and agree)
            print(f"  [{'ok' if ok and agree else 'FAIL'}] {label}: change vs plain max abs "
                  f"{ea:.3e} (/max {er:.3e}), parent vs plain {ep:.3e} (/max {rp:.3e}) (tol "
                  f"{tol}); change vs parent {diff:.3e} = {diff / scale:.3e} of max|plain|"
                  f"{'' if cusp or dt != torch.float32 else ' (tol 1e-5)'}")
            del plain
            evals = N_OP * m * D
            isz = Xt.element_size()
            nbytes = (Xt.numel() + L.numel()) * isz + cf.numel() * 4 + N_OP * D * 4
            bounds = {"bytes": nbytes / CS.HBM_BYTES_PER_S * 1e3,
                      "fp32": evals * 10 / CS.F32_OPS_PER_S * 1e3,
                      "sfu": CS.sfu_ms(torch, evals * (1 if kernel == "gaussian" else 2))}
            print(f"  {label}: bounds (ms) " + ", ".join(f"{k} {v:.5f}" for k, v in bounds.items()))
            fns = {"parent": parent_run, "change": change_run}
            if kernel == "gaussian" and dt == torch.float32 and m == 4:
                fns.update({k: change_run for k in libs if k not in fns})
            rounds(label, fns, bounds)
            if kernel == "gaussian" and dt == torch.float32:
                use("change")
                for bm in (64, 128, 256, 512, 1024, 2048):
                    ms, dms = CS.timed(torch, lambda bm=bm: KN.matfree_apply(
                        Xt, L, cf, kernel=kernel, bandwidth=bw, bm=bm))
                    times.setdefault(label, {})[f"rows {bm}"] = dict(ms=ms, device_ms=dms)
                    print(f"  {label} change at {bm} rows a block: {ms:.4f} ms (device {dms}); "
                          f"{bounds['bytes'] / dms:.1%} of the byte bound")
                out = torch.empty((N_OP, D), device=dev)
                ms, dms = CS.timed(torch, out.zero_)
                print(f"  writing C alone (torch zero_ of {N_OP}×{D} float32): {ms:.4f} ms "
                      f"(device {dms}); {bounds['bytes'] / dms:.1%} of the byte bound")
                times["write floor"] = dict(ms=ms, device_ms=dms)
            del got, was, L
    else:
        X = torch.rand((N_DENSE, 3), generator=g, device=dev)
        K = KernelOperator(X, "gaussian", 0.5).dense()
        Cw = torch.randn((N_DENSE, D), generator=g, device=dev)
        aw = 0.8660254037844386
        rates = CS.sector_rates(torch, KN, K)
        times["sector_rates"] = rates
        X8 = torch.rand((N_STEP, 3), generator=g, device=dev)
        K8 = KernelOperator(X8, "gaussian", 0.5).dense()
        C8 = torch.randn((N_STEP, D), generator=g, device=dev)
        cases = []
        for B in (16, 8, 4, 2, 1):
            sk = make_accum_sketch(g, N_DENSE, D, B, device=dev)
            idx, cf = sk.indices.contiguous(), sk.coef.float().contiguous()
            for dt in (torch.float32, torch.bfloat16):
                Kt = K.to(dt)
                cases.append((f"accum_grow_slabs B={B} {str(dt).removeprefix('torch.')}",
                              lambda Kt=Kt, idx=idx, cf=cf: KN.accum_grow_slabs(Kt, idx, cf,
                                                                               Cw, aw),
                              idx, N_DENSE, Kt.element_size(), 2 * N_DENSE * D * 4))
                if B == 1:
                    cases.append((f"accum_apply m=1 {str(dt).removeprefix('torch.')}",
                                  lambda Kt=Kt, idx=idx, cf=cf: (KN.accum_apply(Kt, idx, cf),),
                                  idx, N_DENSE, Kt.element_size(), N_DENSE * D * Kt.element_size()))
        sk = make_accum_sketch(g, N_DENSE, D, 4, device=dev)
        idx4, cf4 = sk.indices.contiguous(), sk.coef.float().contiguous()
        cases.append(("accum_sketch_both m=4 float32",
                      lambda: KN.accum_sketch_both(K, idx4, cf4), idx4, N_DENSE, 4,
                      N_DENSE * D * 4))
        sk = make_accum_sketch(g, N_STEP, D, 1, device=dev)
        id8, cf8 = sk.indices.contiguous(), sk.coef.float().contiguous()
        cases.append(("accum_step_slab N=8192 float32",
                      lambda: (KN.accum_step_slab(K8, id8, cf8, C8, aw),), id8, N_STEP, 4,
                      2 * N_STEP * D * 4))
        for label, fn, idx, R, isz, other in cases:
            use("parent")
            was = fn()
            use("change")
            got = fn()
            ok = all(same_bits(x, y) for x, y in zip(got, was))
            failed |= not ok
            print(f"  [{'ok' if ok else 'FAIL'}] {label}: every output the parent's bits")
            distinct = int(torch.unique(idx).numel())
            sb = CS.sector_bound(idx, R, isz, other, rates)
            bounds = {"bytes": (R * distinct * isz + other) / CS.HBM_BYTES_PER_S * 1e3,
                      "sectors": sb["sector_bound_ms"], "sector rate": sb["sector_rate_ms"]}
            print(f"  {label}: {sb['sectors_a_row']} sectors a row; bounds (ms) "
                  + ", ".join(f"{k} {v:.5f}" for k, v in bounds.items()))
            fns = {"parent": fn, "change": fn}
            if label.startswith(("accum_grow_slabs B=16", "accum_grow_slabs B=4 float32",
                                 "accum_grow_slabs B=2 float32", "accum_grow_slabs B=1 float32",
                                 "accum_sketch_both")):
                fns.update({k: fn for k in libs if k not in fns})
            rounds(label, fns, bounds)
    print(smi)
    print(json.dumps(times))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
