"""Trace contracts: machine-checked memory, dispatch and sync budgets per
entry point (the twin of ``repro.analysis.contracts``).

A contract pins the invariants one public entry point keeps when called at
a small probe shape (``contracts.toml``, next to this file):

  * ``budget`` — the largest single intermediate, in bytes, as an
    expression of the probe variables (``"4*n*(m*d + p) + 16*MiB"``): the
    no-quadratic-buffer rule.  The reference's 14 expressions are kept;
  * ``measured_peak_bytes`` — the port's own ratchet: the peak the recorded
    call makes today.  ``check`` fails if it rises; ``check --update``
    re-measures and only ever lowers it;
  * ``kernel_dispatches`` — the EXACT number of kernel-router calls
    (``trace.TraceReport.kernel_dispatches``; the reference's
    ``pallas_calls``), the port's own numbers: a loop counts every trip;
  * ``host_syncs`` — the EXACT number of host syncs the recorder sees
    (absent: none allowed, the reference's default ban on host callbacks).
    Entry points that read a device value on the host by design (the
    eager adaptive engine's stopping test, the PSD ladder's checks, the
    k-means seeding) pin their count, so a new sync fails the contract;
  * ``copies_to_cpu`` — the EXACT number of copies from the card to the
    CPU (absent: none), checked on a card alone (on the CPU a copy to the
    CPU dispatches nothing);
  * ``forbid`` — further aten op names that must not appear;
  * ``donation = true`` — the probe's donated input buffers are its
    output's (``trace.verify_donation``);
  * ``rng = true`` — the RNG-lineage checker finds no reused seed
    (``repro_torch.analysis.rng``);
  * ``devices`` — the number of ranks the probe needs (8 for the sharded
    twins, which report ``skipped`` with fewer, as the reference does on
    one device).

On a card (``run_check(device="cuda")``) each probe runs once to warm up,
then is recorded with autotuning off (``REPRO_AUTOTUNE=0``), under
``torch.cuda.set_sync_debug_mode("error")`` where its ``host_syncs`` and
``copies_to_cpu`` are 0, and two more checks hold: the kernels' ``.launches`` counters rise by
``kernel_dispatches`` × each router's launches (``LAUNCHES_PER_DISPATCH``),
and ``max_memory_allocated`` rises above what was held before by no more
than the budget expression.

``python -m repro_torch.analysis check`` evaluates every contract plus the
source-level RNG sweep.
"""
from __future__ import annotations

import ast
import contextlib
import dataclasses
import os
import pathlib

import torch

from repro_torch.analysis import rng as rng_mod
from repro_torch.analysis import trace as trace_mod

CONTRACTS_PATH = pathlib.Path(__file__).with_name("contracts.toml")

_EXPR_GLOBALS = {"KiB": 1024, "MiB": 1024 * 1024, "min": min, "max": max}

#: the ``.launches`` a router call adds on a card: every router launches one
#: kernel wrapper (``accum_sketch_both``'s one counted launch is two CUDA
#: kernels, kernel.py:319), ``accum_attention_kernel`` two
LAUNCHES_PER_DISPATCH = {
    "matfree_cols_kernel": 1, "sketch_left_kernel": 1, "sketch_both_kernel": 1,
    "sketch_right_kernel": 1, "accum_apply_scalar": 1, "sketch_step_kernel": 1,
    "accum_grow_kernel": 1, "landmark_attend": 1, "landmark_stats_fused": 1,
    "accum_attention_kernel": 2,
}


def eval_budget(expr: str, probe: dict) -> int:
    """Evaluate a budget expression over the probe variables (restricted:
    names resolve to probe variables plus KiB/MiB/min/max only)."""
    tree = ast.parse(expr, mode="eval")
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            if node.id not in probe and node.id not in _EXPR_GLOBALS:
                raise ValueError(f"budget expression {expr!r} uses unknown name {node.id!r}")
        elif isinstance(node, ast.Call):
            if not (isinstance(node.func, ast.Name) and node.func.id in ("min", "max")):
                raise ValueError(f"budget expression {expr!r}: only min/max calls")
        elif isinstance(node, ast.Attribute):
            raise ValueError(f"budget expression {expr!r}: no attribute access")
    return int(eval(compile(tree, "<budget>", "eval"),
                    {"__builtins__": {}}, {**_EXPR_GLOBALS, **probe}))


# --------------------------------------------------------------------------- #
# manifest io: the flat TOML subset the manifest uses (the reference's
# reader; the tests hold it to tomllib on the shipped file)
# --------------------------------------------------------------------------- #

def _parse_value(raw: str):
    raw = raw.strip()
    if raw == "true":
        return True
    if raw == "false":
        return False
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw.strip('"')


def _parse_toml_flat(text: str) -> dict:
    out: dict = {}
    cur = None
    for line in text.splitlines():
        s = "" if line.strip().startswith("#") else line.split("#", 1)[0].strip()
        if not s:
            continue
        if s.startswith("[") and s.endswith("]"):
            cur = s[1:-1].strip().strip('"')
            out[cur] = {}
            continue
        if "=" in s and cur is not None:
            k, v = s.split("=", 1)
            out[cur][k.strip()] = _parse_value(v)
    return out


def load_manifest(path: pathlib.Path | str = CONTRACTS_PATH) -> dict:
    """Read contracts.toml into {name: {key: value}}."""
    return _parse_toml_flat(pathlib.Path(path).read_text())


def _emit_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_emit_value(x) for x in v) + "]"
    return '"' + str(v).replace('"', '\\"') + '"'


def dump_manifest(manifest: dict, path: pathlib.Path | str = CONTRACTS_PATH) -> None:
    """Write the manifest back out (``check --update``'s ratchet writer)."""
    lines = [
        "# Trace-contract manifest of the PyTorch port — evaluated by",
        "# `python -m repro_torch.analysis check`.  `budget` is the analytic ceiling",
        "# f(probe vars) (the reference's expressions); `measured_peak_bytes` is the",
        "# port's ratchet (update with `check --update` — it only goes DOWN);",
        "# `kernel_dispatches`, `host_syncs` and `copies_to_cpu` (checked on a card)",
        "# are exact dynamic counts.",
        "",
    ]
    for name in sorted(manifest):
        lines.append(f"[{name}]")
        entry = manifest[name]
        for key in sorted(entry, key=lambda k: (k.startswith("probe_"), k)):
            lines.append(f"{key} = {_emit_value(entry[key])}")
        lines.append("")
    pathlib.Path(path).write_text("\n".join(lines))


# --------------------------------------------------------------------------- #
# probe builders — how to call each public entry point
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class Target:
    """One probe: the callable and its arguments, and for a donating entry
    point ``donated(args, result) → (donated buffers, output buffers)``."""

    fn: object
    args: tuple
    donated: object = None


SEED = 0


def _uniform(shape, seed: int, dev) -> torch.Tensor:
    from repro_torch._util import stream_generator

    g = stream_generator(seed)  # rng-stream: probe-data
    return torch.rand(shape, generator=g).to(dev)


def _operator_X(n: int, p: int, dev) -> torch.Tensor:
    return _uniform((n, p), 1, dev)


def _dense_K(n: int, dev) -> torch.Tensor:
    from repro_torch.core.kernel_op import KernelOperator

    return KernelOperator(_operator_X(n, 4, dev), "gaussian", bandwidth=0.6).dense()


def _sketch(n, d, m, dev):
    from repro_torch._util import stream_generator
    from repro_torch.core.sketch import make_accum_sketch

    g = stream_generator(SEED)  # rng-stream: probe-data
    return make_accum_sketch(g, n, d, m, device=dev)


def _op(X):
    from repro_torch.core.kernel_op import KernelOperator

    return KernelOperator(X, "gaussian", bandwidth=0.6)


def _build_sketch_both(probe, dev):
    from repro_torch.core import apply as A

    n, d, m = probe["n"], probe["d"], probe["m"]
    sk = _sketch(n, d, m, dev)
    return Target(lambda K: A.sketch_both(K, sk, use_kernel=True), (_dense_K(n, dev),))


def _build_accum_grow_batched(probe, dev):
    from repro_torch._util import stream_generator
    from repro_torch.core import apply as A

    n, d, B = probe["n"], probe["d"], probe["B"]
    g = stream_generator(SEED)  # rng-stream: probe-data
    state = A.accum_init(g, n, d, B, device=dev)
    return Target(lambda K, s: A.accum_grow_batched(K, s, B, use_kernel=True, donate=True),
                  (_dense_K(n, dev), state),
                  donated=lambda args, out: (args[1].C, out.C))


def _build_grow_sketch_both(probe, dev):
    from repro_torch.core import apply as A

    n, p, d, m_max = probe["n"], probe["p"], probe["d"], probe["m_max"]
    return Target(lambda X: A.grow_sketch_both(SEED, _op(X), d, m_max=m_max, tol=0.5,
                                               use_kernel=False),
                  (_operator_X(n, p, dev),))


def _build_krr_fit(probe, dev):
    from repro_torch.core.krr import krr_sketched_fit

    n, d, m = probe["n"], probe["d"], probe["m"]
    sk = _sketch(n, d, m, dev)
    return Target(lambda K, y: krr_sketched_fit(K, y, 1e-2, sk, use_kernel=True).fitted,
                  (_dense_K(n, dev), torch.zeros((n,), device=dev)))


def _build_krr_fit_matfree(probe, dev):
    from repro_torch.core.krr import krr_sketched_fit_matfree

    n, p, d, m = probe["n"], probe["p"], probe["d"], probe["m"]
    sk = _sketch(n, d, m, dev)
    return Target(lambda X, y: krr_sketched_fit_matfree(_op(X), y, 1e-2, sk,
                                                        use_kernel=False).fitted,
                  (_operator_X(n, p, dev), torch.zeros((n,), device=dev)))


def _build_krr_fit_pcg(probe, dev):
    from repro_torch.core.krr import krr_sketched_fit_pcg

    n, p, d, m = probe["n"], probe["p"], probe["d"], probe["m"]
    sk = _sketch(n, d, m, dev)
    return Target(lambda X, y: krr_sketched_fit_pcg(_op(X), y, 1e-2, sk, iters=8,
                                                    use_kernel=False).fitted,
                  (_operator_X(n, p, dev), torch.zeros((n,), device=dev)))


def _build_krr_fit_adaptive(probe, dev):
    from repro_torch.core.krr import krr_sketched_fit_adaptive

    n, d, m_max = probe["n"], probe["d"], probe["m_max"]
    return Target(lambda K, y: krr_sketched_fit_adaptive(K, y, 1e-2, SEED, d, tol=0.5,
                                                         m_max=m_max,
                                                         use_kernel=False).fitted,
                  (_dense_K(n, dev), torch.zeros((n,), device=dev)))


def _build_spectral_cluster(probe, dev):
    from repro_torch.core.spectral import spectral_cluster

    n, d, k = probe["n"], probe["d"], probe["k"]
    return Target(lambda K: spectral_cluster(SEED, K, k, d=d, m=probe["m"],
                                             use_kernel=False).labels,
                  (_dense_K(n, dev),))


def _serve_setup(probe, dev, use_sketch: bool):
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = reduced(ARCHS[probe.get("arch", "stablelm-3b")])
    params = init_params(SEED, cfg, device=dev)
    sc = ServeConfig(max_len=probe["L"] + probe.get("steps", 4) + 1, use_sketch=use_sketch,
                     temperature=0.7, seed=SEED)
    return cfg, params, Engine(cfg, params, sc)


def _build_prefill(probe, dev):
    from repro_torch.models.model import prefill_with_cache

    cfg, params, eng = _serve_setup(probe, dev, use_sketch=True)
    B, L = probe["B"], probe["L"]
    table = eng._slot_table(L)
    return Target(lambda p, c, t: prefill_with_cache(p, t, cfg, c, slot_table=table),
                  (params, eng.new_cache(B), torch.zeros((B, L), dtype=torch.long,
                                                         device=dev)))


def _build_engine_decode(probe, dev, use_sketch: bool = True):
    """The engine's decode loop (``Engine._decode_loop``) from a fresh
    cache: sketched, or the exact rung a sketched engine degrades to."""
    cfg, params, eng = _serve_setup(probe, dev, use_sketch=True)
    B, L, steps = probe["B"], probe["L"], probe["steps"]
    return Target(lambda c, t: eng._decode_loop(c, t, L, steps),
                  (eng.new_cache(B, use_sketch=use_sketch),
                   torch.zeros((B,), dtype=torch.long, device=dev)))


def _build_engine_decode_degraded(probe, dev):
    return _build_engine_decode(probe, dev, use_sketch=False)


def _build_solve_psd_ladder(probe, dev):
    from repro_torch.resilience.degrade import solve_psd_ladder

    d = probe["d"]
    A_ = _uniform((d, d), 1, dev)
    M = A_ @ A_.T / d + torch.eye(d, device=dev)
    return Target(lambda M, b: solve_psd_ladder(M, b), (M, torch.ones((d,), device=dev)))


def _build_sharded_sketch_both(probe, dev):
    from repro_torch.core import apply as A

    n, p, d, m = probe["n"], probe["p"], probe["d"], probe["m"]
    sk = _sketch(n, d, m, dev)
    return Target(lambda X: A.sketch_both(_op(X), sk, mesh=True, use_kernel=False),
                  (_operator_X(n, p, dev),))


def _build_sharded_grow_sketch_both(probe, dev):
    from repro_torch.core import apply as A

    n, p, d, m_max = probe["n"], probe["p"], probe["d"], probe["m_max"]
    return Target(lambda X: A.grow_sketch_both(SEED, _op(X), d, m_max=m_max, tol=None,
                                               mesh=True, use_kernel=False),
                  (_operator_X(n, p, dev),))


ENTRY_POINTS = {
    "sketch_both": _build_sketch_both,
    "accum_grow_batched": _build_accum_grow_batched,
    "grow_sketch_both": _build_grow_sketch_both,
    "krr_sketched_fit": _build_krr_fit,
    "krr_sketched_fit_matfree": _build_krr_fit_matfree,
    "krr_sketched_fit_pcg": _build_krr_fit_pcg,
    "krr_sketched_fit_adaptive": _build_krr_fit_adaptive,
    "spectral_cluster": _build_spectral_cluster,
    "prefill_with_cache": _build_prefill,
    "engine_decode": _build_engine_decode,
    "engine_decode_degraded": _build_engine_decode_degraded,
    "solve_psd_ladder": _build_solve_psd_ladder,
    "sharded_sketch_both": _build_sharded_sketch_both,
    "sharded_grow_sketch_both": _build_sharded_grow_sketch_both,
}


# --------------------------------------------------------------------------- #
# evaluation
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class ContractResult:
    """Outcome of evaluating one contract at its probe shape."""

    name: str
    status: str                   # "pass" | "fail" | "skipped"
    violations: list = dataclasses.field(default_factory=list)
    report: dict = dataclasses.field(default_factory=dict)
    measured_peak_bytes: int | None = None

    def to_dict(self) -> dict:
        """JSON-ready form (the ``--json`` report)."""
        return dataclasses.asdict(self)


def _probe_vars(entry: dict) -> dict:
    return {k[len("probe_"):]: v for k, v in entry.items() if k.startswith("probe_")}


def _ranks() -> int:
    d = torch.distributed
    return d.get_world_size() if d.is_available() and d.is_initialized() else 1


def _kernel_launches() -> int:
    from repro_torch.kernels.accum_apply import kernel as KA
    from repro_torch.kernels.landmark_attention import kernel as KL

    return sum(f.launches for f in KA.KERNELS + KL.KERNELS)


@contextlib.contextmanager
def _card_probe(device: torch.device, strict_sync: bool):
    """Autotuning off, and on a card the sync debug mode raising at any host
    sync when ``strict_sync``."""
    from repro_torch.kernels.accum_apply import autotune

    prev_env = os.environ.get(autotune.ENV_GATE)
    os.environ[autotune.ENV_GATE] = "0"
    cuda = device.type == "cuda"
    prev_mode = torch.cuda.get_sync_debug_mode() if cuda else None
    try:
        if cuda and strict_sync:
            torch.cuda.set_sync_debug_mode("error")
        yield
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(prev_mode)
        if prev_env is None:
            del os.environ[autotune.ENV_GATE]
        else:
            os.environ[autotune.ENV_GATE] = prev_env


def evaluate_contract(name: str, entry: dict, *, device="cpu") -> ContractResult:
    """Call one entry point at its probe shape under the recorder and check
    every budget."""
    device = torch.device(device)
    devices = int(entry.get("devices", 1))
    if _ranks() < devices:
        return ContractResult(name, "skipped",
                              report={"reason": f"needs {devices} ranks, have {_ranks()}"})
    builder = ENTRY_POINTS.get(name)
    if builder is None:
        return ContractResult(name, "fail", violations=[
            f"no probe builder registered for {name!r} (add one to "
            "repro_torch.analysis.contracts.ENTRY_POINTS)"])
    probe = _probe_vars(entry)
    target = builder(probe, device)
    cuda = device.type == "cuda"
    want_syncs = int(entry.get("host_syncs", 0))
    strict = want_syncs == 0 and int(entry.get("copies_to_cpu", 0)) == 0
    with _card_probe(device, strict_sync=strict):
        if cuda:
            target.fn(*target.args)             # warm-up: handles, workspaces, builds
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            held = torch.cuda.memory_allocated(device)
            launches0 = _kernel_launches()
        (rec, rng_rep) = rng_mod.record(trace_mod.record, target.fn, *target.args)
        if cuda:
            torch.cuda.synchronize(device)
    rep = trace_mod.report_from_jaxpr(rec)

    violations: list[str] = []
    budget = entry.get("budget")
    limit = eval_budget(str(budget), probe) if budget is not None else None
    if limit is not None and rep.peak_bytes > limit:
        violations.append(
            f"peak intermediate {rep.peak_bytes} B (shape {rep.peak_shape}, "
            f"{rep.peak_dtype}) exceeds budget {limit} B = {budget!r}")
    ratchet = entry.get("measured_peak_bytes")
    if ratchet is not None and rep.peak_bytes > int(ratchet):
        violations.append(
            f"peak intermediate {rep.peak_bytes} B regressed above the ratchet {ratchet} B "
            f"(shape {rep.peak_shape}; if intentional, rerun `python -m "
            "repro_torch.analysis check --update` and justify the increase)")
    want = entry.get("kernel_dispatches")
    if want is not None and rep.kernel_dispatches != int(want):
        violations.append(f"kernel dispatch count {rep.kernel_dispatches} != contracted "
                          f"{want} ({rep.kernel_routes})")
    if len(rep.host_syncs) != want_syncs:
        violations.append(f"host syncs {len(rep.host_syncs)} != contracted {want_syncs} "
                          f"({sorted(set(rep.host_syncs))})")
    want_copies = int(entry.get("copies_to_cpu", 0))
    if cuda and rep.host_copies != want_copies:
        violations.append(f"copies to the CPU {rep.host_copies} != contracted {want_copies}")
    found = rep.forbidden(entry.get("forbid", []))
    if found:
        violations.append(f"forbidden ops dispatched: {found}")
    extra: dict = {}
    if entry.get("donation"):
        if target.donated is None:
            violations.append("contract sets donation=true but the probe builder names "
                              "no donated buffer")
        else:
            donated, outputs = target.donated(target.args, rec.result)
            extra["donation_verified"] = trace_mod.verify_donation(outputs, donated)
            if not extra["donation_verified"]:
                violations.append("declared donation did not happen: the output does "
                                  "not reuse the donated input's buffers")
    rng_issues = [str(i) for i in rng_rep.issues] if entry.get("rng") else []
    violations.extend(rng_issues)
    if cuda:
        launched = _kernel_launches() - launches0
        expected = sum(LAUNCHES_PER_DISPATCH[r] * c for r, c in rep.kernel_routes.items())
        rise = torch.cuda.max_memory_allocated(device) - held
        extra.update(kernel_launches=launched, expected_launches=expected,
                     memory_rise_bytes=rise)
        if launched != expected:
            violations.append(f"kernel launches {launched} != {expected} expected from "
                              f"the dispatches {rep.kernel_routes}")
        if limit is not None and rise > limit:
            violations.append(f"device memory rose {rise} B above what was held, over "
                              f"the budget {limit} B = {budget!r}")
    return ContractResult(
        name, "fail" if violations else "pass", violations=violations,
        report={**rep.to_dict(), "host_syncs": len(rep.host_syncs),
                "host_sync_ops": sorted(set(rep.host_syncs)), "rng_issues": rng_issues,
                "rng_generators": rng_rep.consumptions, "probe": probe,
                "device": str(device), **extra},
        measured_peak_bytes=rep.peak_bytes)


def run_check(manifest: dict | None = None, *, only: str | None = None,
              update: bool = False, path: pathlib.Path | str = CONTRACTS_PATH,
              device="cuda"):
    """Evaluate every contract (plus the RNG sweep) on ``device``; returns
    (results, sweep violations, manifest).  With ``update=True`` the
    measured peaks are ratcheted DOWN into the manifest and written back."""
    if manifest is None:
        manifest = load_manifest(path)
    results = []
    for name, entry in sorted(manifest.items()):
        if only is not None and name != only:
            continue
        res = evaluate_contract(name, entry, device=device)
        results.append(res)
        measured = res.measured_peak_bytes
        if update and res.status != "skipped" and measured is not None:
            prev = entry.get("measured_peak_bytes")
            if prev is None or measured < int(prev):
                entry["measured_peak_bytes"] = measured
            # an upward move is NOT written: the ratchet only descends, and
            # raising it is a reviewed edit of contracts.toml
    sweep = rng_mod.check_fold_in_sites() if only is None else []
    if update:
        dump_manifest(manifest, path)
    return results, sweep, manifest
