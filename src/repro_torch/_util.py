"""Small shared helpers (copied from ``repro.util``), device resolution, and
the RNG stream tags of ``repro.analysis.streams``."""
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

_MASK64 = (1 << 64) - 1


def stream_generator(seed: int, tag: int | None = None) -> torch.Generator:
    """A CPU ``torch.Generator`` for the stream (seed, tag); ``tag=None`` is
    the seed's own stream.  The pair is mixed with splitmix64, so nearby
    seeds and tags give unrelated streams.  Draws are made on the CPU and
    moved to the device, so a seed gives the same numbers on every device."""
    g = torch.Generator()
    if tag is None:
        return g.manual_seed(seed)
    z = (seed * 0x9E3779B97F4A7C15 + tag) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return g.manual_seed(z ^ (z >> 31))


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
