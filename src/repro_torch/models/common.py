"""Shared model utilities: init, RMSNorm, RoPE (ported from
``repro.models.common``; ``chunked_xent`` is training and is not ported)."""
from __future__ import annotations

import torch

PARAM_DTYPE = torch.bfloat16


def _trunc_normal(generator: torch.Generator, shape, std) -> torch.Tensor:
    """A float32 draw from N(0, 1) truncated to [−3, 3], times ``std``, on
    the generator's device."""
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return w.mul_(std)


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=PARAM_DTYPE) -> torch.Tensor:
    """Truncated-normal fan-in init, drawn in float32 on the generator's
    device and cast to ``dtype``."""
    std = 1.0 / torch.sqrt(torch.tensor(shape[in_axis], dtype=torch.float32)).item()
    return _trunc_normal(generator, shape, std).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype=PARAM_DTYPE) -> torch.Tensor:
    """Truncated-normal embedding init with std 0.02."""
    return _trunc_normal(generator, shape, 0.02).to(dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with a zero-centred weight, y·(1 + w), in float32, cast back."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(P,) int positions → (P, head_dim/2) sin/cos tables (float32)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions.float()[:, None] * freqs[None, :]
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., P, H, Dh); sin/cos: (P, Dh/2).  In float32, cast back."""
    half = x.shape[-1] // 2
    s = sin[..., :, None, :]   # broadcast over the head axis
    c = cos[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)
