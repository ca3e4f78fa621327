"""Fault-injection harness: named fault sites + a deterministic trigger plan.

The same sites and plan format as the reference's ``resilience/faults.py``.
Production code declares *fault sites* — named points where the outside
world can fail (a kernel dispatch, a checkpoint write, a decode dispatch).
A JSON *fault plan* in ``REPRO_FAULT_PLAN`` (inline JSON or a file path)
arms any subset of them with an action and a deterministic trigger count:

    REPRO_FAULT_PLAN='{"kernel.dispatch": {"action": "error", "at": 1}}'
    REPRO_FAULT_PLAN=tests/fault_plans/ckpt_kill.json

Per-site spec keys: ``action``; ``at`` — trigger on the Nth arrival (1-based
int or list of ints); ``every`` — every Nth arrival; ``times`` — cap on the
``every`` firings; ``scale`` — magnitude knob for ``indefinite``.

Actions: ``error`` raises :class:`FaultInjected` (a transient backend
error); ``kill`` / ``device_loss`` raise :class:`DeviceLost` (a simulated
preemption: never retried — checkpoint/resume is the recovery path);
``nan`` / ``inf`` / ``zero`` — :func:`poison` overwrites a slab of every
floating tensor; ``indefinite`` — :func:`mangle_matrix` shifts a PSD
matrix's spectrum negative; ``corrupt`` / ``truncate`` — :func:`corrupt`
mangles a byte payload.

On a CUDA tensor the ``kernel.dispatch`` site raises to the caller: the port
has no dispatch ladder, and a kernel never degrades to its plain version.
Arrival counters are process-global and deterministic; :func:`reset` clears
them (tests).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any

import torch

# the reference's six sites; the port visits kernel.dispatch, ckpt.write,
# solve.cholesky and decode.step (the streaming rung and the autotune cache
# are not ported), and accepts plans naming any of the six
SITES: dict[str, str] = {
    "kernel.dispatch": "kernel entry points (kernels/landmark_attention/ops.py)",
    "kernel.stream": "the reference's streaming rung (not ported)",
    "ckpt.write": "one checkpoint tmp-write + rename attempt (checkpoint/ckpt.py)",
    "autotune.load": "the reference's autotune cache load (not ported)",
    "solve.cholesky": "the PSD solve's input (resilience.degrade.solve_psd_ladder)",
    "decode.step": "one decode chunk of Engine.generate (serve/engine.py)",
}

ENV_PLAN = "REPRO_FAULT_PLAN"

_RAISE_ACTIONS = ("error", "kill", "device_loss")
_DATA_ACTIONS = ("nan", "inf", "zero", "indefinite", "corrupt", "truncate")


class FaultInjected(RuntimeError):
    """A transient injected backend error — retry / degrade around it."""

    def __init__(self, site: str, action: str = "error"):
        super().__init__(f"injected fault at {site!r} (action={action!r})")
        self.site, self.action = site, action


class DeviceLost(RuntimeError):
    """A simulated preemption / device loss — fatal to the attempt.

    Deliberately NOT a :class:`FaultInjected` subclass: retry loops and
    degradation ladders catch transient errors but must let this fly (a killed
    process neither retries nor cleans up — checkpoint/resume recovers)."""

    def __init__(self, site: str, action: str = "kill"):
        super().__init__(f"injected device loss at {site!r} (action={action!r})")
        self.site, self.action = site, action


_lock = threading.Lock()
_counts: dict[str, int] = {}
_plan_cache: tuple[str | None, dict[str, dict]] | None = None


def _parse_plan(raw: str) -> dict[str, dict]:
    text = raw
    if not raw.lstrip().startswith(("{", "[")):
        path = raw[1:] if raw.startswith("@") else raw
        with open(path) as f:
            text = f.read()
    obj = json.loads(text)
    if not isinstance(obj, dict):
        raise ValueError(f"{ENV_PLAN} must be a JSON object, got {type(obj).__name__}")
    plan: dict[str, dict] = {}
    for site, spec in obj.items():
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; known: {sorted(SITES)}")
        if not isinstance(spec, dict) or spec.get("action") not in (
            _RAISE_ACTIONS + _DATA_ACTIONS
        ):
            raise ValueError(f"bad spec for fault site {site!r}: {spec!r}")
        plan[site] = spec
    return plan


def active_plan() -> dict[str, dict]:
    """The parsed ``REPRO_FAULT_PLAN`` (env read at call time; cached per
    value).  A malformed plan raises — fault injection is an explicit opt-in
    and a silent typo would fake a green chaos run."""
    global _plan_cache
    raw = os.environ.get(ENV_PLAN)
    if _plan_cache is not None and _plan_cache[0] == raw:
        return _plan_cache[1]
    plan = _parse_plan(raw) if raw else {}
    _plan_cache = (raw, plan)
    return plan


def reset() -> None:
    """Clear all arrival counters (tests — deterministic per-test counts)."""
    with _lock:
        _counts.clear()


def _fires(spec: dict, count: int) -> bool:
    at = spec.get("at")
    if at is not None:
        if count in (at if isinstance(at, list) else [at]):
            return True
    every = spec.get("every")
    if every:
        times = spec.get("times")
        if count % int(every) == 0:
            return times is None or count // int(every) <= int(times)
    return False


def fault_point(site: str) -> dict | None:
    """One arrival at ``site``: count it and fire the armed action, if any.

    Raise-style actions (``error`` / ``kill``) raise here; data-mangling
    actions return the triggered spec so the call site can apply them via
    :func:`poison` / :func:`mangle_matrix` / :func:`corrupt` (which all call
    this themselves — one arrival per call either way).  Returns None when
    nothing fires."""
    if site not in SITES:
        raise KeyError(f"unregistered fault site {site!r}")
    spec = active_plan().get(site)
    if spec is None:
        return None
    with _lock:
        _counts[site] = count = _counts.get(site, 0) + 1
    if not _fires(spec, count):
        return None
    action = spec["action"]
    if action == "error":
        raise FaultInjected(site, action)
    if action in ("kill", "device_loss"):
        raise DeviceLost(site, action)
    return dict(spec)


def _poisoned(x, val):
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        return x
    if x.ndim == 0:
        return torch.full_like(x, val)
    flat = x.reshape(-1).clone()
    flat[: max(1, flat.numel() // 8)] = val
    return flat.reshape(x.shape)


def poison(site: str, tree: Any) -> Any:
    """Arrive at ``site``; on a ``nan``/``inf``/``zero`` trigger overwrite the
    leading eighth of every floating tensor of ``tree`` (a corrupted slab).
    Returns a new tree; the input is left as it was."""
    from repro_torch._util import tree_map

    spec = fault_point(site)
    if spec is None or spec["action"] not in ("nan", "inf", "zero"):
        return tree
    val = {"nan": float("nan"), "inf": float("inf"), "zero": 0.0}[spec["action"]]
    return tree_map(lambda x: _poisoned(x, val), tree)


def mangle_matrix(site: str, M: Any) -> Any:
    """Arrive at ``site``; on a trigger make the square matrix ``M`` hostile.

    ``indefinite`` shifts the spectrum by ``-scale · (tr M / d)`` (default
    scale 2.0 — past any bounded jitter escalation, forcing the lstsq rung;
    a tiny scale like 3e-8 is recoverable by one ×10 escalation).
    ``nan``/``inf``/``zero`` poison the first row."""
    spec = fault_point(site)
    if spec is None:
        return M
    action = spec["action"]
    if action == "indefinite":
        scale = float(spec.get("scale", 2.0))
        d = M.shape[0]
        return M - scale * (torch.trace(M) / d) * torch.eye(d, dtype=M.dtype,
                                                            device=M.device)
    if action in ("nan", "inf", "zero") and M.ndim:
        val = {"nan": float("nan"), "inf": float("inf"), "zero": 0.0}[action]
        M = M.clone()
        M[0] = val
    return M


def corrupt(site: str, data: bytes) -> bytes:
    """Arrive at ``site``; on a trigger mangle the byte payload.

    ``truncate`` keeps the first half (a torn write); ``corrupt`` XOR-flips a
    byte every ~1% (bit rot).  Raise-style actions raise from the shared
    :func:`fault_point` — a ``kill`` here models dying mid-write."""
    spec = fault_point(site)
    if spec is None:
        return data
    action = spec["action"]
    if action == "truncate":
        return data[: len(data) // 2]
    if action == "corrupt":
        b = bytearray(data)
        step = max(1, len(b) // 97)
        for i in range(0, len(b), step):
            b[i] ^= 0xFF
        return bytes(b)
    return data
