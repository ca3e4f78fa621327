"""The dry run's full sweep: every (architecture × shape) cell on both
production meshes, one ``python -m repro_torch.launch.dryrun`` process a
cell, ``--jobs`` of them at a time (each traces one rank, single-threaded),
then one markdown table of the records.

  python3 scripts/dryrun_sweep.py --out sweep.jsonl [--jobs 8] [--device cpu]

The records are the CLI's own (``--out`` of each process, concatenated);
each process's log goes beside the output, as ``<out>.logs/<arch>.<shape>.log``.
Training cells start first: they take longest.  A cell that has written no
record within CELL_TIMEOUT seconds is recorded as failed.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ORDER = ("train_4k", "prefill_32k", "long_500k", "decode_32k")
# the slowest cell, xlstm-125m's training on 2 × 16 × 16, took 4149 s on a
# shared CPU core
CELL_TIMEOUT = 7200.0


def cells() -> list[tuple[str, str]]:
    """The CLI's own ``--list``, training cells first."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--list"],
                         env=_env(), capture_output=True, text=True, check=True).stdout
    pairs = [tuple(line.split()) for line in out.splitlines() if line.strip()]
    return sorted(pairs, key=lambda p: ORDER.index(p[1]))


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))


def run(arch: str, shape: str, logs: Path, device: str) -> tuple[list, float]:
    """One cell on both meshes: (its records, seconds)."""
    out = logs / f"{arch}.{shape}.jsonl"
    t0 = time.perf_counter()
    with open(logs / f"{arch}.{shape}.log", "w") as log:
        try:
            subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                            "--shape", shape, "--mesh", "both", "--device", device,
                            "--out", str(out)], env=_env(), stdout=log,
                           stderr=subprocess.STDOUT, timeout=CELL_TIMEOUT)
        except subprocess.TimeoutExpired:
            pass
    recs = [json.loads(line) for line in out.read_text().splitlines()] if out.exists() else []
    for mesh in ("16x16", "2x16x16")[len(recs):]:
        recs.append({"arch": arch, "shape": shape, "mesh": mesh, "ok": False,
                     "error": f"no record within {CELL_TIMEOUT:.0f} s"})
    return recs, time.perf_counter() - t0


def table(recs: list) -> str:
    """One row a cell, the two meshes side by side: per-rank TFLOP, HBM
    and collective GB, peak GB (of 80), the dominant term and
    ``useful_fraction``."""
    by = {}
    for r in recs:
        by.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r

    def side(r):
        if r is None:
            return "—"
        if not r["ok"]:
            return f"FAIL: {r['error'].split(':')[0]}"
        over = " **over 80**" if not r["fits_hbm"] else ""
        return (f"{r['flops'] / 1e12:.4g} / {r['hbm_bytes'] / 1e9:.4g} / "
                f"{r['coll_bytes'] / 1e9:.4g} / {r['peak_mem_bytes'] / 1e9:.4g}{over} / "
                f"{r['dominant']} / {r['useful_fraction']:.3g}")

    lines = ["| cell | 16 × 16 | 2 × 16 × 16 |", "| --- | --- | --- |"]
    for (arch, shape), m in by.items():
        lines.append(f"| {arch} {shape} | {side(m.get('16x16'))} | {side(m.get('2x16x16'))} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="the sweep's JSONL")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logs = Path(args.out + ".logs")
    logs.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    todo = cells()
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        done = list(pool.map(lambda c: run(*c, logs, args.device), todo))
    recs = [r for rs, _ in done for r in rs]
    Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in recs))
    for (arch, shape), (_, s) in zip(todo, done):
        print(f"{arch} {shape}: {s:.1f} s")
    print(table(recs))
    failed = sum(not r["ok"] for r in recs)
    print(f"{len(recs)} records, {failed} failed, {time.perf_counter() - t0:.1f} s; "
          f"device {args.device}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
