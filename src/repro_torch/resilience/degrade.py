"""The PSD solve ladder — a numerical ladder, not a device fallback.

Ported from ``repro.resilience.degrade.solve_psd_ladder``: the kernel
dispatch ladder of the reference (``ladder_call``) is not ported, because a
tensor on a CUDA device never falls back from its kernel to the plain
version (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

import torch


def solve_psd_ladder(M: torch.Tensor, b: torch.Tensor, *, escalations: int = 3):
    """Solve ``M x = b`` for PSD ``M`` with a degradation ladder.

    Rungs: Cholesky with base jitter ``j0 = 1e-8·(tr M / d)``; on a failed
    factorization or a non-finite result, escalate the jitter ×10 up to
    ``escalations`` times; if still failing, ``lstsq``.  Returns
    ``(x, {"solve_escalations": int, "solve_used_lstsq": bool})``.
    """
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
