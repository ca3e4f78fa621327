"""Sampling schemes for accumulation sketches — the ``scheme=`` knob.

Only the name check is ported so far: the uniform scheme and explicit
``probs`` draw in ``core.sketch``; Poisson and sketch-estimated leverage
draws are still to be ported (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

SCHEMES = ("uniform", "leverage", "poisson")


def validate_scheme(scheme: str) -> str:
    """Check ``scheme`` is one of ``SCHEMES`` and return it."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; expected one of {SCHEMES}")
    return scheme
