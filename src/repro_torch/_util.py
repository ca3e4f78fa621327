"""Small shared helpers (copied from ``repro.util``), device resolution, the
RNG streams (their tags are ``repro_torch.analysis.streams``'s), and the
nested-container walks of the serving path's caches and checkpoints."""
from __future__ import annotations

import os
import sys

import torch

# RNG stream tags.  An engine entry point seeded with s draws its slabs from
# s itself and each other consumer from (s, tag), so the holdout rows and
# the leverage redraws are decorrelated from the slabs; the registry
# documents each.
from repro_torch.analysis.streams import (  # noqa: F401
    COMPRESS_STREAM,
    DATA_STREAM,
    HOLDOUT_STREAM,
    KMEANS_STREAM,
    REFINE_STREAM,
    SAMPLE_STREAM,
    SLOT_STREAM,
)

_FALSY = ("0", "false", "False", "FALSE", "off", "no")

#: observers of every generator made here (``repro_torch.analysis.rng``'s
#: lineage checker): each is called with (effective seed, call site), the
#: call site being the first frame outside this module; they draw nothing
RNG_HOOKS: list = []

_MASK64 = (1 << 64) - 1


def _mix(seed: int, tag: int) -> int:
    """splitmix64 of the pair (seed, tag)."""
    z = (seed * 0x9E3779B97F4A7C15 + tag) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _call_site() -> str:
    """``path:line`` of the first caller outside this module."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    return "?" if f is None else f"{f.f_code.co_filename}:{f.f_lineno}"


def stream_generator(seed: int, tag: int | None = None, *,
                     device="cpu") -> torch.Generator:
    """A ``torch.Generator`` for the stream (seed, tag); ``tag=None`` is the
    seed's own stream.  The pair is mixed with splitmix64, so nearby seeds
    and tags give unrelated streams.  Draws are made on the CPU (the
    default ``device``) and moved to the device, so a seed gives the same
    numbers on every device; a generator on a card (``init_params``) gives
    that card's numbers.  Every generator is reported to ``RNG_HOOKS``."""
    s = seed if tag is None else _mix(seed, tag)
    if RNG_HOOKS:
        site = _call_site()
        for hook in RNG_HOOKS:
            hook(s, site)
    return torch.Generator(device=device).manual_seed(s)


def position_generator(seed: int, tag: int, pos: int, *more: int) -> torch.Generator:
    """The stream (seed, tag) folded with a position (and with each further
    counter in ``more``, in turn): every draw made from it is a pure function
    of (seed, tag, pos, *more), which a resumed decode or training run relies
    on."""
    s = _mix(seed, tag)
    for c in (pos, *more)[:-1]:
        s = _mix(s, int(c))
    return stream_generator(s, int((pos, *more)[-1]))


def tree_leaves(tree) -> list:
    """The leaves of nested dicts (sorted keys), lists, tuples and
    NamedTuples, in a fixed order; anything else is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``, containers kept
    (a NamedTuple stays its own type); leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def env_flag(name: str, default: bool) -> bool:
    """Tri-state boolean env override: unset → default, else truthiness."""
    env = os.environ.get(name)
    if env is None:
        return default
    return env not in _FALSY


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``, refusing CUDA on a machine without a
    card so that a constructor never lands on the CPU by accident."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but no CUDA device is available; pass "
            "device='cpu' explicitly to run on the CPU")
    return device
