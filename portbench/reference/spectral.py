"""Sketched spectral clustering, written out plainly.

From C = K S and W = SᵀC: the affinity K̂ = C W⁺ Cᵀ, W's eigenvalues below
1e-7 of its largest counted as zero; its degrees D = K̂·1; the top-k
eigenvectors of D^{-1/2} K̂ D^{-1/2} (Ng, Jordan and Weiss) through the lift
B = D^{-1/2} C U Λ^{-1/2}, whose Gram BᵀB has the same nonzero eigenvalues;
rows scaled to unit length.  Lloyd's k-means with k-means++ seeding, the
configuration's restarts and iterations.  And the comparisons: of two embeddings' spans, and of two
partitions by their inertia on one embedding.
"""
from __future__ import annotations

import torch


def embedding(C: torch.Tensor, W: torch.Tensor, k: int, eps: float = 1e-7
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(top-k eigenvalues, descending; the row-normalised (n, k) embedding)."""
    w, U = torch.linalg.eigh(0.5 * (W + W.T))
    good = w > eps * (torch.clamp_min(w.max(), 0.0) + 1e-30)
    safe = torch.where(good, w, torch.ones_like(w))
    inv = torch.where(good, 1.0 / safe, torch.zeros_like(w))
    inv_sqrt = torch.where(good, 1.0 / torch.sqrt(safe), torch.zeros_like(w))
    deg = C @ (U @ (inv * (U.T @ C.sum(0))))
    Cn = C * (1.0 / torch.sqrt(torch.clamp_min(deg, 1e-12)))[:, None]
    B = (Cn @ U) * inv_sqrt[None, :]
    s2, Q = torch.linalg.eigh(B.T @ B)
    s2, Q = s2.flip(0)[:k], Q.flip(1)[:, :k]
    P = (B @ Q) / torch.sqrt(torch.clamp_min(s2, 1e-300))[None, :]
    emb = P / torch.clamp_min(torch.linalg.norm(P, dim=1, keepdim=True), 1e-12)
    return s2, emb


def subspace_sin(A: torch.Tensor, B: torch.Tensor) -> float:
    """Sine of the largest principal angle between the column spans of A and
    B (n, k), in float64."""
    qa = torch.linalg.qr(A.double())[0]
    qb = torch.linalg.qr(B.double())[0]
    s = torch.linalg.svdvals(qa.T @ qb)
    return float(torch.sqrt(torch.clamp_min(1.0 - s.min() ** 2, 0.0)))


def _sqdist(E: torch.Tensor, centres: torch.Tensor) -> torch.Tensor:
    return ((E * E).sum(1)[:, None] + (centres * centres).sum(1)[None, :]
            - 2.0 * E @ centres.T).clamp_min(0.0)


def _means(E: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    onehot = (labels[:, None] == torch.arange(k, device=E.device)).to(E.dtype)
    return (onehot.T @ E) / onehot.sum(0).clamp_min(1.0)[:, None]


def inertia(E: torch.Tensor, labels: torch.Tensor, k: int) -> float:
    """The partition's inertia on E: the summed squared distance of each row
    to the mean of the rows that share its label."""
    return float(((E - _means(E, labels, k)[labels]) ** 2).sum())


def kmeans(E: torch.Tensor, k: int, generator: torch.Generator, restarts: int,
           iters: int) -> torch.Tensor:
    """The labels of the lowest-inertia run of ``restarts`` runs of Lloyd's
    algorithm, each seeded by k-means++ and then iterated ``iters`` times.

    The seeding draws are those ``spectral_cluster`` documents, from the CPU
    ``generator``: a restart's first centre is one ``randint`` over the rows,
    each next one a ``multinomial`` draw of one row with probability ∝ its
    squared distance to the nearest centre so far, in float64.  A Lloyd step
    assigns every row to its nearest centre and moves each centre to the
    mean of its rows (a centre without rows stays)."""
    n = E.shape[0]
    best, best_cost = None, None
    for _ in range(restarts):
        first = int(torch.randint(n, (), generator=generator))
        centres = E[first][None, :]
        d2 = _sqdist(E, centres)[:, 0]
        for _ in range(1, k):
            nxt = int(torch.multinomial((d2 / d2.sum()).cpu().double(), 1,
                                        generator=generator))
            centres = torch.cat([centres, E[nxt][None, :]])
            d2 = torch.minimum(d2, _sqdist(E, E[nxt][None, :])[:, 0])
        for _ in range(iters):
            labels = torch.argmin(_sqdist(E, centres), dim=1)
            counts = torch.bincount(labels, minlength=k)
            centres = torch.where(counts[:, None] > 0, _means(E, labels, k), centres)
        cost = float(_sqdist(E, centres).min(dim=1).values.sum())
        if best_cost is None or cost < best_cost:
            best, best_cost = centres, cost
    return torch.argmin(_sqdist(E, best), dim=1)


def excess_inertia(E: torch.Tensor, labels: torch.Tensor, ref_labels: torch.Tensor,
                   k: int) -> float:
    """How much more inertia ``labels`` leaves on E than ``ref_labels``, as
    a share of the latter's: (I(labels) − I(ref_labels)) / I(ref_labels),
    in float64.  Below 0 where ``labels`` is the better partition."""
    E = E.double()
    ref = inertia(E, ref_labels.to(E.device), k)
    return (inertia(E, labels.to(E.device), k) - ref) / ref
