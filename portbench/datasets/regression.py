"""YearPredictionMSD's shape: ``n_train`` rows N(0, Σ) in ``features``
dimensions, Σ = Q·diag(λ)·Qᵀ with λ_j ∝ ``spectrum_decay``^j and Q a random
rotation, each column scaled to unit variance (the standardised features);
targets y = sin(2·x·w₁) + 0.5·x·w₂ + ``noise``·ε, standardised."""
from __future__ import annotations

import math

import torch

from portbench.yardstick.data import generator


def make(cfg: dict, seed: int, device) -> dict:
    """{"X", "y"}."""
    g = generator(seed, device)
    spec = cfg["data"]
    p, n = cfg["features"], cfg["n_train"]
    ev = spec["spectrum_decay"] ** torch.arange(p, dtype=torch.float64, device=device)
    ev = ev * (p / ev.sum())
    Q = torch.linalg.qr(torch.randn((p, p), generator=g, device=device,
                                    dtype=torch.float64))[0]
    A = Q * torch.sqrt(ev)[None, :]                      # Σ = A Aᵀ
    A = A / torch.sqrt((A * A).sum(1))[:, None]          # unit column variance
    w = torch.randn((p, 2), generator=g, device=device, dtype=torch.float64) / math.sqrt(p)
    Z = torch.randn((n, p), generator=g, device=device, dtype=torch.float32)
    X = Z @ A.T.float()
    del Z
    xw = X.double() @ w
    eps = torch.randn((n,), generator=g, device=device, dtype=torch.float64)
    y = torch.sin(2.0 * xw[:, 0]) + 0.5 * xw[:, 1] + spec["noise"] * eps
    y = ((y - y.mean()) / y.std()).float()
    return {"X": X, "y": y}
