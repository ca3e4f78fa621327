#!/usr/bin/env python3
"""Each draw's error in the m sweep of ``examples/krr_m_sweep_torch.py``,
through several routes on the same draws, to tell the port's kernels apart
from the draws and from float32 rounding.

    PYTHONPATH=src python3 scripts/krr_sweep_draws.py [--device cuda] [--seed 0]

Every route fits the twin's draws (data and sketches made in float32 from
``--seed`` on the device's generator, so a CPU run and a CUDA run draw
differently): "kernel" (each (C, W) from ``accum_sketch_both``; on a CUDA
device only), "plain" (the plain gather, float32) and "plain64" (the plain
gather on the same draws cast to float64, K, the solves and the exact fit
in float64).  Prints, for each route, each m's five errors and their mean,
then where the kernel ran the largest relative difference of a draw's
error between "kernel" and "plain", and one JSON line of it all.
"""
import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch


def load_twin():
    path = Path(__file__).resolve().parents[1] / "examples" / "krr_m_sweep_torch.py"
    sys.path.insert(0, str(path.parent))       # the twin's own imports
    spec = importlib.util.spec_from_file_location("krr_m_sweep_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dev = torch.device(args.device)
    twin = load_twin()
    routes = {"plain": dict(use_kernel=False), "plain64": dict(use_kernel=False,
                                                               dtype=torch.float64)}
    if dev.type == "cuda":
        routes = {"kernel": dict(use_kernel=True), **routes}
    out = {}
    for name, kw in routes.items():
        out[name] = twin.sweep(dev, args.seed, **kw)
        print(f"[{name}] n={out[name]['n']} d={out[name]['d']} on {dev.type}")
        for m, e in [*out[name]["errs"].items(), ("∞", out[name]["gauss"])]:
            print(f"  m={m:>3}: mean {np.mean(e):.3e}   [" + " ".join(f"{x:.3e}" for x in e)
                  + "]")
    if "kernel" in out:
        gap = max(abs(a - b) / max(abs(b), 1e-30)
                  for m in out["plain"]["errs"]
                  for a, b in zip(out["kernel"]["errs"][m], out["plain"]["errs"][m]))
        print(f"largest relative difference of a draw's error, kernel against plain: {gap:.3e}")
    print("DRAWS " + json.dumps({k: {"errs": {str(m): e for m, e in v["errs"].items()},
                                     "gauss": v["gauss"]} for k, v in out.items()}))


if __name__ == "__main__":
    main()
