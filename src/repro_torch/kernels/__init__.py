"""The port's hand-written CUDA kernels (``accum_apply``,
``landmark_attention``), each family with its sources, build and binding,
plain versions and shape-agnostic routers (``ops``).

``routed`` marks each public router of an ``ops`` module: while an observer
is registered in ``ROUTE_OBSERVERS`` (the trace-contract analyzer), every
outermost router call is reported to it by name, whichever implementation
then serves it — the plain version on the CPU, the kernel on a card — so
that a probe counts the same dispatches on both."""
from __future__ import annotations

import functools

#: observers of router calls, each called with the router's name
ROUTE_OBSERVERS: list = []
_depth = 0


def routed(fn):
    """``fn`` reporting each outermost call to ``ROUTE_OBSERVERS`` (a router
    called by another router counts once, as the outer one)."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        global _depth
        if _depth == 0:
            for observe in ROUTE_OBSERVERS:
                observe(name)
        _depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _depth -= 1

    return wrapper
