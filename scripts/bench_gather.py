#!/usr/bin/env python3
"""Time the column gather and ``matfree_apply`` of ``accum_apply.cu``
against an earlier version of that source, in one process on one NVIDIA GPU.

    python3 scripts/bench_gather.py [--parent REV_OR_FILE] [--scalar | --matfree]
                                    [--diagnose] [--rotate]

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
bfloat16; ``accum_sketch_both`` at m = 4; ``accum_step_slab`` at N = 8192,
float32 and bfloat16 K.  Every output of the change must be the parent's
bits (exit 1 otherwise), and so must the change's at each of ``ROWS`` rows
a block, and each ``--diagnose`` variant's.
Then the card's rate for random sectors (``chip_smoke.sector_rates`` on the
float32 K: 1024 and 64 sampled columns a row, unsorted, sorted, whole
sectors and 64-byte segments) and each shape's sector bound.

``--scalar``: ``accum_apply_scalar`` at path (m)'s shapes (``SCALAR_SHAPES``,
m = 4, d = 64: a normal K at the anchor R = 4096, N = 8192 in float32 and
the sketches, drawn as ``chip_smoke.py`` draws them, and the Gaussian K
above at n = 32768 in float32 and bfloat16), the parent's entry (where it is the seed loop, at
bm = 256, bd = 8) against the change's wrapper and entry: every output
the parent's bits, and so row 9's launch at each of ``SCALAR_ROWS`` rows a
block (``accum_apply``'s at that ``bm``: the same column gather) (exit 1
otherwise); times both C entries (a launch each, the output allocated,
as the parent's wrapper called it) parent, change, change, parent, then
the change's wrapper, each rows count and ``torch.sparse.mm(Sᵀ, Kᵀ)``,
beside the byte bound, the sector bound and the sector probe's random
rate.

``--matfree``: ``matfree_apply`` at n = 2^21, d = 64, p = 3 (Gaussian at
m = 4 and 16, float32 and bfloat16; Laplacian at m = 4), the change held
against the parent (within 1e-5 of max|plain| for the Gaussian) and against
the plain version (1e-5, and 5e-3 of the float64 plain version for the
Laplacian's self-pair cusp, 5e-2 in bfloat16), beside its byte, FP32 and
SFU bounds.

Times are ``chip_smoke.timed``'s (CUDA events, and the profiler's device
time) at each version's default geometry (the parent's: ``PARENT_ROWS``
rows a block), in the order parent, change, change, parent; for the unit
step and ``accum_apply`` at m = 1, then both at each of ``ROWS`` rows a
block; ``--matfree`` also times the change at 64 to 2048 rows a block, and
writing C alone (``torch.zero_``, the floor of its bytes).
``--rotate``: each call of the gather takes the next of ``ROTATE`` sketches
drawn alike (each held parent against change bit for bit), so that the
sectors it samples are not those the calls just before it left in the
card's 50 MB L2; without it every call samples the same columns, and the
unit step's 16 MB of them stay in L2 from call to call.
``--diagnose`` also times copies of the change (``build/variants/``) with
one part altered, once each: the gather without its sort (``unsorted``),
sorted at every m·d (``sorted_all``), with one load in flight a thread
(``unroll1``) or half the tile (``tile2048``), the register gather reading
K through the read-only path (``regs_ldg``; the source's loads are
evict-first), all with the same bits;
matfree with 4 or 16 rows a warp step (``rb4``, ``rb16``), its ex2 replaced
by an FP32 add (``no_sfu``) or its stores dropped (``no_store``), the last
two wrong by design and unchecked.  The last line is a JSON object of every
time.  Without a CUDA device it exits 2.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import math
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
    # the register gather with K read through the read-only path
    "regs_ldg": [("return to_f32(__ldcs(p));", "return to_f32(__ldg(p));")],
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
GATHER_DIAGNOSTICS = ("unsorted", "sorted_all", "unroll1", "tile2048", "regs_ldg")
# the parent's rows a block for every gather (its autotune.STATIC_TABLE)
PARENT_ROWS = 64
# rows a block every gather's bits are checked at, and the unit step and
# accum_apply at m = 1 timed at in both versions
ROWS = (8, 16, 32, 64, 128, 256)
# sketches a call cycles through under --rotate
ROTATE = 12
MATFREE_DIAGNOSTICS = ("rb4", "rb16", "no_sfu", "no_store")
# the C entry points of accum_apply.cu
ENTRIES = ("repro_matfree_apply", "repro_accum_apply_left", "repro_accum_sketch_both",
           "repro_accum_apply", "repro_accum_step_slab", "repro_accum_grow_slabs",
           "repro_accum_apply_scalar")
# how a source whose accum_apply_scalar is the seed loop declares its entry
PARENT_SCALAR_BLOCKS = "int N, int m, int d, int bm, int bd, int is_bf16, void* stream"
# --scalar: path (m)'s shapes, (label, R, N, dtype), m = 4 at d = 64, and the
# rows a block row 9's launch is bit-checked and timed at (through
# accum_apply, which launches the same column gather)
SCALAR_SHAPES = (("anchor", 4096, 8192, "float32"), ("dense", N_DENSE, N_DENSE, "float32"),
                 ("dense", N_DENSE, N_DENSE, "bfloat16"))
SCALAR_ROWS = (8, 16, 32, 64, 128)


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


def parent_lib(path: Path, change, text: str):
    """The parent's library at ``path``, each entry point typed as the
    change's of the same name where the parent has it; the parent's
    ``repro_accum_apply_scalar`` as its source declares it (the seed loop's
    (…, bm, bd, is_bf16, stream) before the column gather took it over)."""
    lib = ctypes.CDLL(str(path))
    for name in ENTRIES:
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = getattr(change, name).argtypes, ctypes.c_int
    if PARENT_SCALAR_BLOCKS in text:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.repro_accum_apply_scalar.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P]
    return lib


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
    matfree, diagnose, rotate = "--matfree" in argv, "--diagnose" in argv, "--rotate" in argv
    scalar = "--scalar" in argv
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
    # the change and its variants bound by kernel.py, then the parent, whose
    # entries may differ from the change's (parent_lib)
    for name, src in sorted(sources.items(), key=lambda kv: kv[0] == "parent"):
        if name == "parent":
            libs[name] = parent_lib(KN.library_path(src), libs["change"], src.read_text())
        else:
            KN.SOURCE = src
            KN._lib.cache_clear()
            libs[name] = KN._lib()
        print(f"{name} ({src.name}): nvcc {infos[name]['seconds']:.1f} s")
        lines = infos[name]["ptxas"].splitlines()
        for i, line in enumerate(lines):
            for kern in ("matfree_apply_kernel", "sketch_gather_kernel",
                         "sketch_gather_regs_kernel"):
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
        """Time ``fns`` (name → callable, run on the library of that name, or
        on the parent's where the name starts with "parent") parent, change,
        change, parent, then the others once each; print each time and its
        share of the bounds (name → ms)."""
        for order in ([["parent", "change"], ["change", "parent"]]
                      + [[k for k in fns if k not in ("parent", "change")]]):
            for name in order:
                use(name if name in libs else "parent" if name.startswith("parent")
                    else "change")
                ms, dms = CS.timed(torch, fns[name])
                times.setdefault(label, {}).setdefault(name, []).append(
                    dict(ms=ms, device_ms=dms))
                share = ", ".join(f"{k} {v / dms:.1%}" for k, v in bounds.items()) if dms else ""
                print(f"  {label} {name}: {ms:.4f} ms (device {dms}); of the bounds: {share}")

    g = torch.Generator(device=dev).manual_seed(3)
    if scalar:
        # path (m)'s draws: a normal K at the anchor, then its sketch, then the
        # dense K's sketch, from one generator seeded 10
        gm = torch.Generator(device=dev).manual_seed(10)
        Ks = {"anchor": torch.randn((4096, 8192), generator=gm, device=dev)}
        sks = {"anchor": make_accum_sketch(gm, 8192, D, 4, device=dev)}
        X = torch.rand((N_DENSE, 3), generator=g, device=dev)
        Ks["dense"] = KernelOperator(X, "gaussian", 0.5).dense()
        sks["dense"] = make_accum_sketch(gm, N_DENSE, D, 4, device=dev)
        rates = CS.sector_rates(torch, KN, Ks["dense"])
        times["sector_rates"] = rates
        old = PARENT_SCALAR_BLOCKS in sources["parent"].read_text()
        for label, R, N, dname in SCALAR_SHAPES:
            dt = getattr(torch, dname)
            Kt = Ks[label].to(dt)
            idx, cf = sks[label].indices.contiguous(), sks[label].coef.float().contiguous()

            def entry_run(who, Kt=Kt, idx=idx, cf=cf, R=R, N=N):
                """One launch through ``who``'s C entry, as a caller of the
                seed loop's called it (at bm = 256, bd = 8 where it takes them)."""
                out = torch.empty((R, D), dtype=Kt.dtype, device=dev)
                geo = (256, 8) if who == "parent" and old else ()
                err = libs[who].repro_accum_apply_scalar(
                    Kt.data_ptr(), idx.data_ptr(), cf.data_ptr(), out.data_ptr(), R, N, 4, D,
                    *geo, int(Kt.dtype == torch.bfloat16),
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"{who}'s accum_apply_scalar failed with CUDA error {err}")
                return out

            def rows_run(rows, Kt=Kt, idx=idx, cf=cf):
                # row 9's launch at ``rows`` rows a block: accum_apply's, the
                # same column gather
                return KN.accum_apply(Kt, idx, cf, bm=rows)

            def change_run(Kt=Kt, idx=idx, cf=cf):
                return KN.accum_apply_scalar(Kt, idx, cf, bm=256, bd=8)

            name = f"accum_apply_scalar {label} R={R} N={N} {dname}"
            use("change")
            was = entry_run("parent")
            ok = (same_bits(change_run(), was) and same_bits(entry_run("change"), was)
                  and all(same_bits(rows_run(r), was) for r in SCALAR_ROWS))
            plain = ref.accum_apply_ref(Kt, idx, cf)
            ea, er, okp = CS.close(change_run(), plain, 1e-5 if dt == torch.float32 else 2e-2)
            failed |= not (ok and okp)
            print(f"  [{'ok' if ok and okp else 'FAIL'}] {name}: every output the parent's "
                  f"bits, at {SCALAR_ROWS} rows a block too; against the plain version max "
                  f"abs {ea:.3e} (/max {er:.3e}); the rule's rows a block "
                  f"{KN.scalar_rows(R, 4, D)}")
            St = CS.sketch_csr(torch, idx, cf, N, transposed=True).to(dt)
            lib_err = (torch.sparse.mm(St, Kt.T).T.float() - plain.float()).abs().max().item()
            print(f"  {name}: torch.sparse.mm(Sᵀ, Kᵀ)ᵀ vs plain max abs {lib_err:.3e}")
            isz = Kt.element_size()
            other = R * D * isz + 4 * D * 8
            sb = CS.sector_bound(idx, R, isz, other, rates)
            bounds = {"bytes": (R * int(torch.unique(idx).numel()) * isz + other)
                      / CS.HBM_BYTES_PER_S * 1e3,
                      "sectors": sb["sector_bound_ms"], "sector rate": sb["sector_rate_ms"]}
            print(f"  {name}: {sb['sectors_a_row']} sectors a row; bounds (ms) "
                  + ", ".join(f"{k} {v:.5f}" for k, v in bounds.items()))
            fns = {"parent": lambda f=entry_run: f("parent"),
                   "change": lambda f=entry_run: f("change"), "change's wrapper": change_run}
            fns.update({f"change rows {r}": lambda r=r, f=rows_run: f(r) for r in SCALAR_ROWS})
            fns["torch.sparse.mm(Sᵀ, Kᵀ)"] = lambda St=St, Kt=Kt: torch.sparse.mm(St, Kt.T)
            rounds(name, fns, bounds)
            del Kt, plain, was, St
    elif matfree:
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
                          f"{bounds['bytes'] / (dms or math.nan):.1%} of the byte bound")
                out = torch.empty((N_OP, D), device=dev)
                ms, dms = CS.timed(torch, out.zero_)
                print(f"  writing C alone (torch zero_ of {N_OP}×{D} float32): {ms:.4f} ms "
                      f"(device {dms}); {bounds['bytes'] / (dms or math.nan):.1%} of the byte "
                      "bound")
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
        def sketches(n, m):
            """(idx, coef) of ROTATE sketches under --rotate, else of one."""
            out = []
            for _ in range(ROTATE if rotate else 1):
                sk = make_accum_sketch(g, n, D, m, device=dev)
                out.append((sk.indices.contiguous(), sk.coef.float().contiguous()))
            return out

        # (label, fn(bm, idx, coef) → outputs, sketches, R, bytes an element
        # of K, other bytes); bm None is the change's default geometry
        cases = []
        for B in (16, 8, 4, 2, 1):
            sks = sketches(N_DENSE, B)
            for dt in (torch.float32, torch.bfloat16):
                Kt = K.to(dt)
                cases.append((f"accum_grow_slabs B={B} {str(dt).removeprefix('torch.')}",
                              lambda bm, idx, cf, Kt=Kt: KN.accum_grow_slabs(
                                  Kt, idx, cf, Cw, aw, bm=bm),
                              sks, N_DENSE, Kt.element_size(), 2 * N_DENSE * D * 4))
                if B == 1:
                    cases.append((f"accum_apply m=1 {str(dt).removeprefix('torch.')}",
                                  lambda bm, idx, cf, Kt=Kt: (KN.accum_apply(Kt, idx, cf, bm=bm),),
                                  sks, N_DENSE, Kt.element_size(), N_DENSE * D * Kt.element_size()))
        cases.append(("accum_sketch_both m=4 float32",
                      lambda bm, idx, cf: KN.accum_sketch_both(K, idx, cf, bm=bm),
                      sketches(N_DENSE, 4), N_DENSE, 4, N_DENSE * D * 4))
        sks = sketches(N_STEP, 1)
        for dt in (torch.float32, torch.bfloat16):
            K8t = K8.to(dt)
            cases.append((f"accum_step_slab N=8192 {str(dt).removeprefix('torch.')}",
                          lambda bm, idx, cf, K8t=K8t: (
                              KN.accum_step_slab(K8t, idx, cf, C8, aw, bm=bm),),
                          sks, N_STEP, K8t.element_size(), 2 * N_STEP * D * 4))
        for label, run, sks, R, isz, other in cases:
            ok = True
            for idx, cf in reversed(sks):
                use("parent")
                was = run(PARENT_ROWS, idx, cf)
                use("change")
                ok &= all(same_bits(x, y) for x, y in zip(run(None, idx, cf), was))
            # the parent's outputs on the first sketch, against every rows
            # count and variant
            for bm in ROWS:
                ok &= all(same_bits(x, y) for x, y in zip(run(bm, idx, cf), was))
            variants = [k for k in libs if k not in ("parent", "change")]
            for name in variants:
                use(name)
                ok &= all(same_bits(x, y) for x, y in zip(run(None, idx, cf), was))
            failed |= not ok
            print(f"  [{'ok' if ok else 'FAIL'}] {label}: every output the parent's bits"
                  + (f" on each of {len(sks)} sketches" if rotate else "")
                  + f", at {ROWS} rows a block too"
                  + (f", and every variant's ({', '.join(variants)})" if variants else ""))
            distinct = int(torch.unique(idx).numel())
            sb = CS.sector_bound(idx, R, isz, other, rates)
            bounds = {"bytes": (R * distinct * isz + other) / CS.HBM_BYTES_PER_S * 1e3,
                      "sectors": sb["sector_bound_ms"], "sector rate": sb["sector_rate_ms"]}
            print(f"  {label}: {sb['sectors_a_row']} sectors a row; bounds (ms) "
                  + ", ".join(f"{k} {v:.5f}" for k, v in bounds.items()))

            def fn(bm, run=run, sks=sks, turn=[0]):
                """One call at ``bm`` rows a block, on the next sketch."""
                turn[0] = (turn[0] + 1) % len(sks)
                return run(bm, *sks[turn[0]])

            fns = {"parent": lambda fn=fn: fn(PARENT_ROWS), "change": lambda fn=fn: fn(None)}
            if label.startswith(("accum_grow_slabs B=16", "accum_grow_slabs B=4 float32",
                                 "accum_grow_slabs B=2 float32", "accum_grow_slabs B=1 float32",
                                 "accum_sketch_both", "accum_step_slab", "accum_apply")):
                fns.update({k: lambda fn=fn: fn(None) for k in libs if k not in fns})
            if label.startswith(("accum_step_slab", "accum_apply")):
                for who in ("parent", "change"):
                    fns.update({f"{who} rows {bm}": lambda fn=fn, bm=bm: fn(bm) for bm in ROWS})
            rounds(label, fns, bounds)
    print(smi)
    print(json.dumps(times))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
