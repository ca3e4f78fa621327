#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, at the cell's own
size: the control (the plain reference put in the program's place and
computed in the nearest precision below the configuration's: float32 with
TF32 products, for float32 with TF32 off), and with ``--faults`` the program
as it is and with each fault of its kind planted (``FAULTS`` beside the
kind's driver), all compared with the float64 reference by the numbers a run
compares.  The control and every fault should come out as not correct.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 [--faults]

prints one JSON line a seed and reading: its numbers (the worst over the
answers, as a run takes them) beside the limits.  No measured window runs:
the mix's first ``check_jobs`` jobs are drawn as a run draws them, and the
data is made once a seed.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seeds: list[int], device: str = "cuda",
             cfg: dict | None = None, faults: bool = False) -> list[dict]:
    """{"seed", "reading", "numbers", "limits", "correct"} a seed and
    reading: "control", and with ``faults`` "program" and each fault."""
    from portbench import harness
    from portbench.yardstick import data as data_mod

    harness.import_program()
    bench = harness.spec()
    _, cfg_file, mix = harness.cell_of(bench, workload)
    cfg = cfg_file if cfg is None else cfg
    limits = harness.load_json(harness.find("limits", workload))
    kind = harness.kind_of(mix)
    out = []
    for seed in seeds:
        data = data_mod.make(cfg, seed, device)
        driver = kind.Driver(cfg, mix, data, seed, device)
        jobs = list(itertools.islice(harness.jobs_of(kind, mix, cfg, seed),
                                     mix["check_jobs"]))
        runs = [("control", None)]
        if faults:
            runs += [("program", contextlib.nullcontext())]
            runs += [(f, kind.fault(f)) for f in kind.FAULTS]
        for name, planted in runs:
            if planted is None:
                rows = driver.control(jobs)
            else:
                driver.kept = []
                with planted:
                    for job in jobs:
                        driver.run(job)
                rows = driver.check()
            checks, failed = harness.checks_against(rows, limits)
            out.append({"seed": seed, "reading": name,
                        "numbers": {n: v for n, v, _ in checks},
                        "limits": limits, "correct": failed == 0})
        del driver, data
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        for r in readings(args.workload, [seed], faults=args.faults):
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
