"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to one configuration, traffic mix, job kind or
per-layer metric sits in a file of its own, found by the name
``BENCHMARK.json`` gives it:

  configs/<config>.json         the configuration as it is run
  datasets/<config "data" kind>.py  the configuration's data, made from the seed
  mixes/<traffic>.json          the traffic mix's parameters
  kinds/<mix "kind">.py         the entry the window drives, its check, and
                                the faults its check has to catch
  metrics/<metric>.py           a metric's reader, end-to-end or per-layer;
                                where there is none, metrics/<name before
                                the first dot>.py
  limits/<workload>.json        the limit of each number the check compares

The program is the package ``repro_torch`` under ``src/`` of the checkout;
the benchmark takes from it only the system under test, its counters and
its profiler ranges.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the top-level modules no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    return load_json(ROOT / "BENCHMARK.json")


def find(folder: str, name: str, exts=(".json",)) -> Path:
    """The file named ``name`` under ``portbench/<folder>``."""
    for ext in exts:
        path = BENCH / folder / f"{name}{ext}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {folder}/{name}{{{','.join(exts)}}} under {BENCH}")


def cell_of(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(the workload entry, its configuration, its mix)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(ROOT / configs[cell["config"]]["file"])
    mix = load_json(find("mixes", cell["traffic"]))
    return cell, cfg, mix


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The ``read(ctx)`` of a metric's reader module."""
    try:
        path = find("metrics", name, (".py",))
    except FileNotFoundError:
        path = find("metrics", name.split(".")[0], (".py",))
    spec_ = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


def refuse_forbidden() -> None:
    """Raise, naming them, if JAX or the JAX package has been loaded."""
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError(f"the run loaded JAX or the JAX package: {', '.join(loaded)}")


def import_program():
    """The program, from ``src/`` of this checkout and nowhere else."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch

    where = Path(repro_torch.__file__).resolve()
    if ROOT / "src" not in where.parents:
        raise ImportError(f"repro_torch loaded from {where}, not from {ROOT / 'src'}")
    return repro_torch


def within(value: float, limit: float | None) -> bool:
    """Whether ``value`` is a number at or below ``limit`` (NaN is not)."""
    return limit is not None and math.isfinite(value) and value <= limit


def checks_against(rows: list[dict], limits: dict) -> tuple[list[list], int]:
    """([[name, worst value, limit]], answers over a limit, not a finite
    number, or without a limit)."""
    failed = sum(1 for r in rows
                 if not all(within(v, limits.get(k)) for k, v in r.items()))
    out = []
    for name in sorted({k for r in rows for k in r}):
        values = [r[name] for r in rows if name in r]
        worst = next((v for v in values if not math.isfinite(v)), max(values))
        out.append([name, worst, limits.get(name)])
    return out, failed


def kind_of(mix: dict):
    """The job kind module that the mix names."""
    return importlib.import_module(f"portbench.kinds.{mix['kind']}")


def jobs_of(kind, mix: dict, cfg: dict, seed: int):
    """The run's jobs: the kind's own generator where it has one, else the
    general one."""
    from portbench.yardstick import traffic

    return getattr(kind, "jobs", traffic.jobs)(mix, cfg, seed)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t0: float | None = None, bench: dict | None = None,
             cfg: dict | None = None) -> dict:
    """One run; returns the result line's object (``checks`` last), with the
    window's job latencies under ``latency_s``.

    ``cfg`` replaces the configuration's file (tests at small sizes)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = spec() if bench is None else bench
    cell, cfg_file, mix = cell_of(bench, workload)
    cfg = cfg_file if cfg is None else cfg
    limits = load_json(find("limits", workload))
    import_program()
    import torch

    from repro_torch.kernels.accum_apply import autotune
    from portbench.yardstick import data as data_mod
    from portbench.yardstick import trace as trace_mod

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    kind = kind_of(mix)
    data = data_mod.make(cfg, seed, device)
    driver = kind.Driver(cfg, mix, data, seed, device)
    driver.warm()
    sync()
    setup_s = time.perf_counter() - t0

    window = trace_mod.Window(torch, autotune) if trace else None
    if window:
        window.start()
    jobs, latency = [], []
    start = time.perf_counter()
    for job in jobs_of(kind, mix, cfg, seed):
        a = time.perf_counter()
        driver.run(job)
        sync()
        b = time.perf_counter()
        latency.append(b - a)
        jobs.append(job)
        if b - start >= seconds:
            break
    window_s = time.perf_counter() - start
    if window:
        window.stop()
        window_s = window.seconds
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    refuse_forbidden()

    # what every metric's reader reads: the window's record, and with
    # ``trace`` its profile reduced, the jobs' work and the driver
    ctx = {"setup_s": setup_s, "window_s": window_s, "jobs": len(jobs),
           "latency_s": latency}
    breakdown = None
    if window:
        ctx.update(summary=window.summary(), work=[driver.work(j) for j in jobs],
                   driver=driver)
        breakdown = {"device_ops": trace_mod.top_ops(ctx["summary"]),
                     "idle_gaps": trace_mod.idle_gaps(ctx["summary"])}
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    busy_s = ctx["summary"]["busy_s"] if window else None
    driver.release()
    del data, ctx
    if on_card:
        torch.cuda.empty_cache()
    rows_checked = driver.check()
    checks, failed = checks_against(rows_checked, limits)
    correct = failed == 0 and bool(rows_checked)
    out = {"correct": correct, "attempted": len(jobs), "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": torch.cuda.get_device_name() if on_card else "cpu",
                      "count": cell["chips"], "memory_peak_bytes": peak}}
    if window:
        out["device"]["busy_s"] = busy_s
        out["device"]["window_s"] = window_s
        out["breakdown"] = breakdown
    out["latency_s"] = latency
    # a number that is not finite is printed as its name: the line stays JSON
    out["checks"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                     for name, v, lim in checks}
    refuse_forbidden()
    return out
