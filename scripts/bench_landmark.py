#!/usr/bin/env python3
"""Time the tensor-core sweep of the landmark-attention kernels on one
NVIDIA GPU, for the repo's CUDA source or other builds of it.

    python3 scripts/bench_landmark.py [SOURCE.cu ...]
    python3 scripts/bench_landmark.py --diagnose
    python3 scripts/bench_landmark.py --mma-peak

``--diagnose`` times the repo's source beside copies of it (under
``build/variants/``) from which one part of the work is taken out, to see
where the time goes: ``one_product`` keeps only the hi·hi product of each
3×TF32 triple, ``fast_exp`` takes ``__expf`` for ``expf``, ``no_pv`` drops
the P·V product (the compiler then drops V's reads and splits).  Their
outputs are wrong by design and are not checked.  ``--mma-peak`` builds
``scripts/mma_peak.cu`` and prints the rate of ``mma.sync`` alone (eight
independent products a warp in a loop) for TF32 m16n8k8 and bfloat16
m16n8k16, at 4, 8 and 16 warps a block and four blocks an SM.

For each source (default: the repo's ``landmark_attention.cu``) it builds
the library with ``kernel.py``'s nvcc flags and prints ptxas's register and
spill report of the tensor-core sweep.  Then it holds ``landmark_attention``
at the F-stage shape of ``accum_attention`` (P = 32 problems of S = 32768
query rows over L = 1024 landmarks, Dh = Dv = 128, float32) and the BmV half
of ``landmark_stats`` (L = 1024 landmark rows over S = 32768 keys) against
their plain versions (1e-5 of max|plain|), and times both at every rows-a-
block candidate with ``chip_smoke.timed`` (CUDA events, and the profiler's
device time).  The sources are timed in turn and then again in reverse
order, so that two builds are compared within one call on one card.  The
last line is a JSON object of every time.  Without a CUDA device it exits 2.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
P, S, L, D = 32, 32768, 1024, 128
DIAGNOSTICS = {
    "one_product": [("mma(part[j], al, bh0, bh1);", ""), ("mma(part[j], ah, bl0, bl1);", ""),
                    ("mma(part[n], pl, bh0, bh1);", ""), ("mma(part[n], ph, bl0, bl1);", "")],
    "fast_exp": [("sc[j][e] = expf(", "sc[j][e] = __expf("), ("c[r] = expf(", "c[r] = __expf(")],
    "no_pv": [("acc[n0 + n][e] = __fadd_rn(acc[n0 + n][e], part[n][e]);", ";")],
}


def diagnostic_sources(source: Path) -> list[Path]:
    """The repo's source and one copy per entry of ``DIAGNOSTICS``."""
    out = [source]
    text = source.read_text()
    for name, edits in DIAGNOSTICS.items():
        t = text
        for old, new in edits:
            if old not in t:
                raise SystemExit(f"diagnostic {name}: {old!r} is not in {source}")
            t = t.replace(old, new)
        path = ROOT / "build" / "variants" / f"{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(t)
        out.append(path)
    return out


def mma_peak(torch, smi: str) -> int:
    """The tensor pipe's rate for mma.sync, in TFLOP/s of the products."""
    import ctypes

    from repro_torch.kernels.accum_apply.kernel import build_source

    info: dict = {}
    lib = ctypes.CDLL(str(build_source(ROOT / "scripts" / "mma_peak.cu", info)))
    lib.repro_mma_peak.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    blocks, iters = 4 * torch.cuda.get_device_properties(0).multi_processor_count, 512
    rates = {}
    for kind, name, flops in ((0, "tf32 m16n8k8", 2 * 16 * 8 * 8),
                              (1, "bf16 m16n8k16", 2 * 16 * 8 * 16)):
        for threads in (128, 256, 512):
            out = torch.empty(blocks * threads, device="cuda")
            ms = ctypes.c_float(0.0)
            err = lib.repro_mma_peak(kind, blocks, threads, iters, out.data_ptr(),
                                     ctypes.byref(ms))
            if err:
                raise RuntimeError(f"mma_peak failed with CUDA error {err}")
            total = blocks * threads // 32 * iters * 8 * flops
            rates[f"{name} {threads // 32} warps"] = total / ms.value / 1e9
            print(f"  mma.sync {name}, {threads // 32} warps a block, {blocks} blocks: "
                  f"{ms.value:.3f} ms, {total / ms.value / 1e9:.1f} TFLOP/s")
    print(smi)
    print(json.dumps(rates))
    return 0


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_landmark: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as CS
    from repro_torch.kernels.landmark_attention import kernel as LK
    from repro_torch.kernels.landmark_attention import ref as LR

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    if argv == ["--mma-peak"]:
        return mma_peak(torch, smi)
    if argv == ["--diagnose"]:
        sources = diagnostic_sources(LK.SOURCE)
    else:
        sources = [Path(a).resolve() for a in argv] or [LK.SOURCE]
    checked = {sources[0]} if argv == ["--diagnose"] else set(sources)
    libs = {}
    for src in sources:
        LK.SOURCE = src
        LK.BUILD_INFO.clear()
        LK._lib.cache_clear()
        libs[src] = LK._lib()
        print(f"{src.name}: nvcc {LK.BUILD_INFO['seconds']:.1f} s")
        lines = LK.BUILD_INFO["ptxas"].splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "attend_mma_kernel" in line:
                name = line.split("attend_mma_kernel")[1][:24]
                report = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                          if "registers" in x or "spill" in x]
                print(f"  attend_mma_kernel{name}: {'; '.join(report)}")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    q, kt, M = randn(P, S, D), randn(P, L, D), randn(P, L, D)
    qt, k, v = randn(P, L, D), randn(P, S, D), randn(P, S, D)
    plain_a = LR.landmark_attention_ref(q, kt, M)
    plain_s = LR.landmark_stats_ref(qt, kt, k, v)[1]
    flops = 2 * P * S * L * 2 * D
    times: dict[str, dict] = {}
    failed = False
    for rnd, order in enumerate((sources, sources[::-1])):
        for src in order:
            LK._lib = lambda lib=libs[src]: lib
            LK._fits.cache_clear()
            for bq in LK.SWEEP_ROWS:
                if not LK.fits(bq, D, torch.float32, torch.float32, dev):
                    print(f"  {src.name} {bq} rows a block: does not fit")
                    continue
                if rnd == 0 and src in checked:
                    for name, out, plain in (
                            ("landmark_attention", LK.landmark_attention(q, kt, M, bq=bq),
                             plain_a),
                            ("landmark_stats", LK.landmark_stats(qt, kt, k, v, bs=bq)[1],
                             plain_s)):
                        ea, er, ok = CS.close(out, plain, 1e-5)
                        failed |= not ok
                        print(f"  [{'ok' if ok else 'FAIL'}] {src.name} {name} {bq} rows: "
                              f"max abs {ea:.3e}, /max|plain| {er:.3e} (tol 1e-5)")
                ms_a, dms_a = CS.timed(torch, lambda: LK.landmark_attention(q, kt, M, bq=bq))
                ms_s, dms_s = CS.timed(torch, lambda: LK.landmark_stats(qt, kt, k, v, bs=bq))
                print(f"  round {rnd} {src.name} {bq} rows a block: F-stage {ms_a:.4f} ms "
                      f"(device {dms_a}, {flops / ms_a / 1e9:.2f} TFLOP/s); landmark_stats "
                      f"{ms_s:.4f} ms (device {dms_s})")
                times.setdefault(f"{src.name} {bq}", {})[rnd] = dict(
                    f_stage_ms=ms_a, f_stage_device_ms=dms_a, stats_ms=ms_s,
                    stats_device_ms=dms_s)
    print(smi)
    print(json.dumps(times))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
