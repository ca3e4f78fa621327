"""Small shared helpers (copied from ``repro.util``, plus device resolution)."""
from __future__ import annotations

import os

import torch

_FALSY = ("0", "false", "False", "FALSE", "off", "no")


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
