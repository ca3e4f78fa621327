"""Structured health reporting and the PSD solve ladder.

Ported from ``repro.resilience.degrade``: ``HealthEvent``, ``HealthReport``
and ``global_health`` record every degradation, and ``solve_psd_ladder`` is
a numerical ladder.  The kernel dispatch ladder of the reference
(``ladder_call``) is not ported, because a tensor on a CUDA device never
falls back from its kernel to the plain version (ROADMAP, north star).
"""
from __future__ import annotations

import dataclasses
import threading

import torch

from repro_torch.resilience import faults


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One recorded degradation: ``site`` fell from ``rung_from`` to ``rung_to``."""

    site: str
    rung_from: str
    rung_to: str
    detail: str = ""


class HealthReport:
    """Thread-safe append-only log of degradation events.

    Engines and module-level consumers record every rung drop here; tests and
    dashboards read ``events`` / ``summary()`` to see *that* and *why*
    numerics took a slower path."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[HealthEvent] = []

    def record(self, site: str, *, rung_from: str, rung_to: str,
               detail: str = "") -> HealthEvent:
        """Append one degradation event and return it."""
        ev = HealthEvent(site, rung_from, rung_to, str(detail))
        with self._lock:
            self._events.append(ev)
        return ev

    @property
    def events(self) -> list[HealthEvent]:
        """Snapshot of all recorded events, oldest first."""
        with self._lock:
            return list(self._events)

    def count(self, site: str | None = None) -> int:
        """Number of events, optionally restricted to one site."""
        return len([e for e in self.events if site is None or e.site == site])

    def summary(self) -> dict[str, int]:
        """Histogram ``{"site: from->to": n}`` — the engine-stats surface."""
        out: dict[str, int] = {}
        for e in self.events:
            key = f"{e.site}: {e.rung_from}->{e.rung_to}"
            out[key] = out.get(key, 0) + 1
        return out

    def clear(self) -> None:
        """Drop all events (tests)."""
        with self._lock:
            self._events.clear()


_GLOBAL = HealthReport()


def global_health() -> HealthReport:
    """The process-wide report used by module-level consumers (checkpoint
    restore).  ``Engine`` instances keep their own report too."""
    return _GLOBAL


def solve_psd_ladder(M: torch.Tensor, b: torch.Tensor, *, escalations: int = 3):
    """Solve ``M x = b`` for PSD ``M`` with a degradation ladder.

    Rungs: Cholesky with base jitter ``j0 = 1e-8·(tr M / d)``; on a failed
    factorization or a non-finite result, escalate the jitter ×10 up to
    ``escalations`` times; if still failing, ``lstsq``.  The
    ``solve.cholesky`` fault site may mangle ``M`` on entry.  Returns
    ``(x, {"solve_escalations": int, "solve_used_lstsq": bool})``.
    """
    M = faults.mangle_matrix("solve.cholesky", M)
    d = M.shape[0]
    eye = torch.eye(d, dtype=M.dtype, device=M.device)
    j0 = 1e-8 * (torch.trace(M) / d + 1e-30)
    rhs = b if b.ndim == 2 else b[:, None]

    def attempt(level: int):
        L, info = torch.linalg.cholesky_ex(M + (j0 * 10.0**level) * eye)
        x = torch.cholesky_solve(rhs, L)
        return x, bool(info == 0) and bool(torch.isfinite(x).all())

    level = 0
    x, ok = attempt(level)
    while not ok and level < escalations:
        level += 1
        x, ok = attempt(level)
    if not ok:
        x = torch.linalg.lstsq(M + j0 * eye, rhs).solution
    x = x if b.ndim == 2 else x[:, 0]
    return x, {"solve_escalations": level, "solve_used_lstsq": not ok}
