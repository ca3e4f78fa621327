#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on this machine's CUDA card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program under ``src/repro_torch``.  Set-up makes the cell's data
from the seed on the card and warms every shape the window uses; the window
then runs the cell's jobs back to back for ``--seconds``; once it has
closed, the plain reference checks the window's answers.  The last line of
standard output is the result, as JSON; the numbers compared, each beside
its limit, are the last lines of standard error and the result's last key.
With ``--trace 1`` the window runs under ``torch.profiler`` and the result
holds the per-layer metrics in place of the end-to-end ones.

Every cache the program and its libraries keep lies at a fixed path inside
the checkout, under ``build/``: the program's kernels build there at the
first run, and its autotune cache is measured at the first run of a shape
and read after.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
ENV = {
    "REPRO_AUTOTUNE": "1",
    "REPRO_AUTOTUNE_CACHE": str(CACHE / "autotune.json"),
    "TORCH_EXTENSIONS_DIR": str(CACHE / "torch_extensions"),
    "TRITON_CACHE_DIR": str(CACHE / "triton"),
    "CUDA_CACHE_PATH": str(CACHE / "cuda"),
    "OMP_NUM_THREADS": "1",
    "MKL_NUM_THREADS": "1",
    "USE_FLAX": "0",
}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.update(ENV)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    bench = harness.spec()
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           t0=T0, bench=bench)
    lat = sorted(out.pop("latency_s"))
    print(f"jobs {len(lat)}: seconds min {lat[0]!r} median {lat[len(lat) // 2]!r} "
          f"max {lat[-1]!r}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
