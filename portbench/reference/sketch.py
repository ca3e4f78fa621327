"""Algorithm 1 of the paper, drawn again from the seed.

The accumulation sketch S = Σ_i S_(i): column j of the i-th sub-sampling
matrix holds r_ij / sqrt(d·m·p) at row n_ij, with n_ij uniform over the n
rows (p = 1/n) and r_ij a Rademacher sign.  The draws are torch's: the row
indices first, as one (m, d) ``randint``, then the signs as one (m, d)
``randint`` of bits, both from the generator given, which is what
``make_accum_sketch`` documents for the uniform signed scheme.  The
coefficients are computed in float64.
"""
from __future__ import annotations

import math

import torch

_MASK64 = (1 << 64) - 1


def splitmix64(seed: int, tag: int) -> int:
    """splitmix64 of the pair (seed, tag): the stream (seed, tag) of a seed."""
    z = (seed * 0x9E3779B97F4A7C15 + tag) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def uniform_signed(generator: torch.Generator, n: int, d: int, m: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(indices (m, d) int64, coef (m, d) float64) of the uniform signed
    accumulation sketch, drawn on the generator's device."""
    dev = generator.device
    idx = torch.randint(0, n, (m, d), generator=generator, device=dev)
    bits = torch.randint(0, 2, (m, d), generator=generator, device=dev)
    sign = (2 * bits - 1).to(torch.float64)
    return idx, sign * math.sqrt(n / (d * m))
