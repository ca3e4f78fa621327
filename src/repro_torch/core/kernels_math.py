"""Positive semi-definite kernel functions used by the KRR experiments.

All functions map (n, p), (m, p) -> (n, m).  The squared distance is the
EXPANDED form a² + b² − 2ab clamped at 0, with ``+1e-30`` under the square
root, exactly as the reference (``repro.core.kernels_math``) and its TPU
kernel compute it.
"""
from __future__ import annotations

import math
from functools import lru_cache, partial

import torch


def _sqdist(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    # numerically-guarded pairwise squared distances
    a2 = torch.sum(A * A, dim=-1)[:, None]
    b2 = torch.sum(B * B, dim=-1)[None, :]
    d2 = a2 + b2 - 2.0 * (A @ B.T)
    return torch.clamp_min(d2, 0.0)


def gaussian_kernel(A, B, bandwidth: float = 1.0):
    """exp(-||a-b||² / (2σ²))."""
    return torch.exp(-_sqdist(A, B) / (2.0 * bandwidth**2))


def laplacian_kernel(A, B, bandwidth: float = 1.0):
    """exp(−‖a − b‖ / bandwidth) — the L2 Laplacian (exponential) kernel."""
    d = torch.sqrt(_sqdist(A, B) + 1e-30)
    return torch.exp(-d / bandwidth)


def matern_kernel(A, B, bandwidth: float = 1.0, nu: float = 1.5):
    """Matérn with ν ∈ {0.5, 1.5, 2.5} (closed forms)."""
    r = torch.sqrt(_sqdist(A, B) + 1e-30) / bandwidth
    if nu == 0.5:
        return torch.exp(-r)
    if nu == 1.5:
        c = math.sqrt(3.0)
        return (1.0 + c * r) * torch.exp(-c * r)
    if nu == 2.5:
        c = math.sqrt(5.0)
        return (1.0 + c * r + 5.0 * r * r / 3.0) * torch.exp(-c * r)
    raise ValueError(f"unsupported nu={nu}")


@lru_cache(maxsize=None)
def _get_kernel_cached(name: str, bandwidth: float, nu: float):
    if name == "gaussian":
        return partial(gaussian_kernel, bandwidth=bandwidth)
    if name == "laplacian":
        return partial(laplacian_kernel, bandwidth=bandwidth)
    if name == "matern":
        return partial(matern_kernel, bandwidth=bandwidth, nu=nu)
    raise ValueError(f"unknown kernel {name}")


def get_kernel(name: str, bandwidth: float = 1.0, nu: float = 1.5):
    """Kernel callable for a (name, bandwidth, nu) config — cached, so equal
    configs return the identical object."""
    return _get_kernel_cached(name, float(bandwidth), float(nu))
