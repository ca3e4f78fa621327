#!/usr/bin/env python3
"""Show, on one NVIDIA GPU, which device records ``torch.profiler`` loses
once a long profiled session has run, and that the pad of ``chip_smoke.py``
(``PAD`` empty spin kernels opening every session) absorbs the loss.

    python3 scripts/profiler_drops.py [--rounds N]

Round 0 runs before any long session; each later round first runs a 20 s
session as pass 3 of ``chip_smoke.py`` profiles a path (CPU and CUDA
activity, a ``record_function`` range around every 50 small elementwise
launches, and one ``accum_apply_scalar`` launch between them).  Then, on
path (m)'s anchor (R = 4096, N = 8192, m = 4, d = 64): a session of 100
back-to-back ``accum_apply_scalar`` calls with CPU activity on, which
prints the launches (by the runtime's correlation id, in launch order) that
have no device record; ``chip_smoke.profiled_calls`` of the same calls,
which prints the calls' records and the pad's records it kept; and
``chip_smoke.timed``.  The last line is a JSON object of every round.
Without a CUDA device it exits 2.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = 100
LONG_S = 20.0


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("profiler_drops: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke as CS
    from repro_torch.core import make_accum_sketch
    from repro_torch.kernels.accum_apply import kernel as KN

    rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv else 3
    dev = torch.device("cuda")
    gm = torch.Generator(device=dev).manual_seed(10)
    K = torch.randn((4096, 8192), generator=gm, device=dev)
    sk = make_accum_sketch(gm, 8192, 64, 4, device=dev)
    idx, cf = sk.indices.contiguous(), sk.coef.float().contiguous()

    def fn():
        return KN.accum_apply_scalar(K, idx, cf)

    for _ in range(3):
        fn()
    x = torch.randn(1 << 16, device=dev)
    report = []
    for r in range(rounds + 1):
        if r:
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                while time.perf_counter() - t0 < LONG_S:
                    with record_function("launch:probe"):
                        for _ in range(50):
                            x = x * 1.0001 + 0.5
                    fn()
                torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        events = list(prof.profiler.kineto_results.events())
        launches = [e.correlation_id() for e in sorted(
            (e for e in events if e.device_type() == DeviceType.CPU
             and "LaunchKernel" in e.name()), key=lambda e: e.start_ns())]
        on_device = [e for e in events if e.device_type() == DeviceType.CUDA]
        seen = ({e.correlation_id() for e in on_device}
                | {e.linked_correlation_id() for e in on_device})
        missing = [i for i, c in enumerate(launches) if c not in seen]
        records, pads = CS.profiled_calls(torch, fn, CALLS)
        ms, dms = CS.timed(torch, fn)
        row = dict(round=r, long_sessions=r, launches=len(launches), missing=missing,
                   padded_records=len(records), pad_kept=pads, pad=CS.PAD, ms=ms,
                   device_ms=dms)
        report.append(row)
        print(f"round {r} (after {r} long sessions): of {len(launches)} launches, "
              f"{len(missing)} without a device record, at launch indices {missing[:8]}"
              f"{'…' if len(missing) > 8 else ''}; padded session: {len(records)} of "
              f"{CALLS} records, {pads} of the pad's {CS.PAD}; timed {ms:.4f} ms "
              f"(device {dms})", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
