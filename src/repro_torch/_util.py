"""Small shared helpers (copied from ``repro.util``), device resolution, the
RNG stream tags of ``repro.analysis.streams``, and the nested-container
walks of the serving path's caches and checkpoints."""
from __future__ import annotations

import os

import torch

_FALSY = ("0", "false", "False", "FALSE", "off", "no")

# RNG stream tags (values of repro.analysis.streams).  An engine entry
# point seeded with s draws its slabs from s itself and each other consumer
# from (s, tag), so the holdout rows and the leverage redraws are
# decorrelated from the slabs.
#: holdout-estimator rows of the adaptive growth loops
HOLDOUT_STREAM = 0x5E1D
#: leverage tail redraws; phase i draws from REFINE_STREAM + i
REFINE_STREAM = 0x11E7
#: k-means seeding in ``spectral_cluster`` (the port's own tag: the
#: reference splits its key there instead)
KMEANS_STREAM = 0x4B3A
#: the serving engine's sketched-cache slot draws, one stream per position
SLOT_STREAM = 0x510C
#: the serving engine's temperature sampling, one stream per position
SAMPLE_STREAM = 0x5A3E
#: the synthetic token stream, folded with (step, host) (the port's own tag:
#: the reference folds its data key with the step alone)
DATA_STREAM = 0xDA7A
#: sketched gradient compression, folded with (step, leaf) (the port's own
#: tag, as for the data stream)
COMPRESS_STREAM = 0xC0DE

_MASK64 = (1 << 64) - 1


def _mix(seed: int, tag: int) -> int:
    """splitmix64 of the pair (seed, tag)."""
    z = (seed * 0x9E3779B97F4A7C15 + tag) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def stream_generator(seed: int, tag: int | None = None) -> torch.Generator:
    """A CPU ``torch.Generator`` for the stream (seed, tag); ``tag=None`` is
    the seed's own stream.  The pair is mixed with splitmix64, so nearby
    seeds and tags give unrelated streams.  Draws are made on the CPU and
    moved to the device, so a seed gives the same numbers on every device."""
    g = torch.Generator()
    return g.manual_seed(seed if tag is None else _mix(seed, tag))


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
