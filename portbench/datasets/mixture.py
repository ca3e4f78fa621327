"""Covertype's shape: ``class_counts`` rows around as many centres, each
centre ``separation``·N(0, I) and each row its centre plus N(0, I), in
``features`` dimensions, in an order shuffled by the seed.  The Gaussian
bandwidth is the median distance between the rows of a sample of
``median_sample`` of them (the median heuristic)."""
from __future__ import annotations

import torch

from portbench.yardstick.data import generator


def median_distance(X: torch.Tensor, rows: torch.Tensor) -> float:
    """The median of the distances between distinct pairs of ``rows`` of X,
    in float64."""
    S = X.index_select(0, rows).double()
    s2 = (S * S).sum(1)
    d2 = (s2[:, None] + s2[None, :] - 2.0 * S @ S.T).clamp_min(0.0)
    iu = torch.triu_indices(S.shape[0], S.shape[0], offset=1, device=S.device)
    return float(torch.sqrt(d2[iu[0], iu[1]]).median())


def make(cfg: dict, seed: int, device) -> dict:
    """{"X", "truth", "bandwidth"}."""
    g = generator(seed, device)
    spec = cfg["data"]
    p, counts = cfg["features"], cfg["class_counts"]
    n = sum(counts)
    centres = spec["separation"] * torch.randn((len(counts), p), generator=g,
                                               device=device)
    truth = torch.repeat_interleave(torch.arange(len(counts), device=device),
                                    torch.tensor(counts, device=device))
    truth = truth[torch.randperm(n, generator=g, device=device)]
    X = centres[truth] + torch.randn((n, p), generator=g, device=device)
    rows = torch.randperm(n, generator=g, device=device)[:spec["median_sample"]]
    return {"X": X, "truth": truth, "bandwidth": median_distance(X, rows)}
