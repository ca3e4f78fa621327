"""Sketched eigendecomposition and spectral clustering — the paper's second
application.

Everything here runs off the pair C = K S (n, d), W = Sᵀ K S (d, d), from
the one-shot ``apply.sketch_both`` or the progressive engine
(``apply.grow_sketch_both``), so nothing costs more than O(n·d²) after the
sketch:

  * ``nystrom_eigh`` — eigenpairs of K̂ = C W⁺ Cᵀ through the lift
    B = C W^{-1/2}: K̂ = B Bᵀ, so the thin SVD of B gives them;
  * ``sketched_spectral_embedding`` — the (degree-normalized) top-k
    eigenvector embedding; D = K̂ 1 = C (W⁺ (Cᵀ 1)) costs O(n·d);
  * ``kmeans`` — Lloyd with k-means++ seeding and restarts, on a generator;
  * ``spectral_cluster`` — the pipeline, at a fixed ``m`` or an error
    target ``tol`` that lets the engine choose m.

On a data mesh (``core.distributed``) C holds a rank's rows: the n-sums (the
degrees' Cᵀ1, the lift's BᵀB) are summed over the ranks, and the thin SVD of
the row-sharded B comes from the d×d eigh of BᵀB.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._util import KMEANS_STREAM, stream_generator
from repro_torch.core import apply as A
from repro_torch.core.sketch import AccumSketch, make_accum_sketch


# --------------------------------------------------------------------------- #
# Sketched eigendecomposition
# --------------------------------------------------------------------------- #

def _w_pinv_factors(W: torch.Tensor, eps: float):
    """(U, λ⁺, λ^{-1/2}) of PSD W with eigenvalues below ``eps``·max zeroed:
    one d×d eigh shared by the degree vector and the eigenvector lift."""
    w, U = torch.linalg.eigh(0.5 * (W + W.T))
    good = w > eps * (torch.clamp_min(torch.max(w), 0.0) + 1e-30)
    safe = torch.where(good, w, 1.0)
    return (U, torch.where(good, 1.0 / safe, 0.0),
            torch.where(good, 1.0 / torch.sqrt(safe), 0.0))


def nystrom_eigh(C: torch.Tensor, W: torch.Tensor, k: int | None = None, *,
                 eps: float = 1e-7, w_factors=None, mesh=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k eigenpairs of K̂ = C W⁺ Cᵀ: W = UΛUᵀ gives B = C U Λ^{-1/2}
    with K̂ = B Bᵀ, and the thin SVD B = P Σ Qᵀ gives K̂ = P Σ² Pᵀ.
    Eigenvalues of W below ``eps``·max count as zero.  Returns (eigvals (k,),
    eigvecs (n, k)) in descending order; eigenvectors are fixed up to sign.
    With ``mesh`` (a ``DataMesh``) C and the eigenvectors are this rank's
    rows: BᵀB = Q Σ² Qᵀ summed over the ranks, and P = B Q Σ⁻¹."""
    d = W.shape[0]
    k = d if k is None else k
    U, _, inv_sqrt = (w_factors if w_factors is not None
                      else _w_pinv_factors(W, eps))
    B = (C @ U) * inv_sqrt[None, :]
    if mesh is None:
        P, s, _ = torch.linalg.svd(B, full_matrices=False)
        return s[:k] ** 2, P[:, :k]
    from repro_torch.core.distributed import sharded_gram

    s2, Q = torch.linalg.eigh(sharded_gram(B, B, mesh))
    s2, Q = s2.flip(0)[:k], Q.flip(1)[:, :k]
    return s2, (B @ Q) / torch.sqrt(torch.clamp_min(s2, 1e-30))[None, :]


def sketched_degrees(C: torch.Tensor, W: torch.Tensor, *, eps: float = 1e-7,
                     w_factors=None, mesh=None) -> torch.Tensor:
    """Degree vector of the sketched affinity, D = K̂ 1 = C (W⁺ (Cᵀ 1));
    with ``mesh`` C and D are this rank's rows and Cᵀ1 is summed over the
    ranks."""
    U, inv, _ = w_factors if w_factors is not None else _w_pinv_factors(W, eps)
    v = torch.sum(C, dim=0)
    if mesh is not None:
        from repro_torch.core.distributed import all_reduce

        v = all_reduce(v, mesh)
    return C @ (U @ (inv * (U.T @ v)))


def sketched_spectral_embedding(C: torch.Tensor, W: torch.Tensor, k: int, *,
                                normalized: bool = True, eps: float = 1e-7,
                                mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k spectral embedding of K̂ = C W⁺ Cᵀ; ``normalized`` embeds
    D^{-1/2} K̂ D^{-1/2} (Ng–Jordan–Weiss) by folding D^{-1/2} into C.
    Returns (eigvals (k,), embedding (n, k)); with ``mesh`` C and the
    embedding are this rank's rows."""
    factors = _w_pinv_factors(W, eps)
    if normalized:
        deg = sketched_degrees(C, W, eps=eps, w_factors=factors, mesh=mesh)
        C = C * (1.0 / torch.sqrt(torch.clamp_min(deg, 1e-12)))[:, None]
    return nystrom_eigh(C, W, k, eps=eps, w_factors=factors, mesh=mesh)


# --------------------------------------------------------------------------- #
# k-means (Lloyd + k-means++ seeding)
# --------------------------------------------------------------------------- #

def _sqdist(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    x2 = torch.sum(X * X, dim=1)[:, None]
    c2 = torch.sum(C * C, dim=1)[None, :]
    return torch.clamp_min(x2 + c2 - 2.0 * X @ C.T, 0.0)


def _kmeanspp_init(generator: torch.Generator, X: torch.Tensor,
                   k: int) -> torch.Tensor:
    """k-means++ seeding: each center is drawn with probability ∝ the
    squared distance to the nearest center so far (one host read each)."""
    n = X.shape[0]
    first = int(torch.randint(n, (), generator=generator))
    centers = [X[first]]
    d2min = torch.sum((X - X[first][None, :]) ** 2, dim=1)
    for _ in range(1, k):
        p = d2min / torch.clamp_min(torch.sum(d2min), 1e-30)
        nxt = int(torch.multinomial(p.cpu().double(), 1, generator=generator))
        centers.append(X[nxt])
        d2min = torch.minimum(d2min, torch.sum((X - X[nxt][None, :]) ** 2, dim=1))
    return torch.stack(centers)


def kmeans(generator: torch.Generator, X: torch.Tensor, k: int, *,
           iters: int = 25, restarts: int = 4
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm with k-means++ seeding and ``restarts`` independent
    runs (the lowest inertia wins).  The seeding draws come from the CPU
    ``generator``; the centroid sums are one-hot products, with no atomics,
    so a run gives the same result every time.  Returns (labels (n,),
    centers (k, p), inertia)."""
    best = None
    for _ in range(restarts):
        c = _kmeanspp_init(generator, X, k)
        for _ in range(iters):
            lab = torch.argmin(_sqdist(X, c), dim=1)
            # one_hot's values, without its bounds check (a host read on the CPU)
            onehot = (lab[:, None] == torch.arange(k, device=X.device)).to(X.dtype)
            counts = onehot.sum(dim=0)
            sums = onehot.T @ X
            c = torch.where(counts[:, None] > 0,
                            sums / torch.clamp_min(counts, 1.0)[:, None], c)
        inertia = torch.sum(torch.min(_sqdist(X, c), dim=1).values)
        if best is None or float(inertia) < float(best[1]):
            best = (c, inertia)
    centers, inertia = best
    return torch.argmin(_sqdist(X, centers), dim=1), centers, inertia


# --------------------------------------------------------------------------- #
# Full pipeline
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class SpectralResult:
    """Output of ``spectral_cluster``."""

    labels: torch.Tensor      # (n,) cluster assignments
    eigvals: torch.Tensor     # (k,) top sketched eigenvalues (descending)
    embedding: torch.Tensor   # (n, k) row-normalized spectral embedding
    sketch: AccumSketch       # the sketch that produced (C, W)
    info: dict                # {"m": ..., "err": ...} — engine stats


def spectral_cluster(seed: int, K, n_clusters: int, *, d: int,
                     m: int | None = None, tol: float | None = None,
                     m_max: int = 32, probs=None, normalized: bool = True,
                     use_kernel: bool | None = None, kmeans_restarts: int = 4,
                     kmeans_iters: int = 25, schedule: str = "doubling",
                     scheme: str = "uniform", mesh=None) -> SpectralResult:
    """Sketched spectral clustering of the affinity K — a dense (n, n)
    tensor or a ``KernelOperator``.

    Pipeline: sketch → (C, W) → top-``n_clusters`` eigenvector embedding of
    the (normalized) sketched affinity → row-normalize → k-means.  Give a
    fixed ``m`` (one-shot ``sketch_both``) or an error target ``tol`` (the
    progressive engine picks m ≤ m_max on ``schedule``); neither means the
    fixed path at m = m_max.  ``scheme="leverage"`` takes the engine route
    at fixed size too, so its probabilities refine between batches.

    The slabs are drawn from ``seed``'s stream and the k-means seeding from
    (seed, ``KMEANS_STREAM``).

    ``mesh`` (operator only) computes (C, W) and the embedding on each
    rank's rows, gathers the (n, k) embedding once, and runs k-means on it
    on every rank from the same generator, so the labels are replicated."""
    if tol is not None and m is not None:
        raise ValueError("pass either m= or tol=, not both")
    if mesh is not None:
        from repro_torch.core import distributed as D

        mesh = D.operator_mesh(K, mesh)[1]
    if tol is not None or scheme == "leverage":
        sk, C, W, info = A.grow_sketch_both(
            seed, K, d, m_max=m_max if m is None else m, tol=tol, probs=probs,
            use_kernel=use_kernel, schedule=schedule, scheme=scheme, mesh=mesh)
    else:
        m_fix = m_max if m is None else m
        # rng-stream: slabs
        sk = make_accum_sketch(stream_generator(seed), K.shape[0], d, m_fix,
                               probs, scheme=scheme, device=A._device(K))
        C, W = A.sketch_both(K, sk, use_kernel=use_kernel, mesh=mesh)
        info = {"m": sk.m, "m_max": m_max, "err": float("nan")}
    eigvals, U = sketched_spectral_embedding(C.float(), W.float(), n_clusters,
                                             normalized=normalized, mesh=mesh)
    # row-normalize (NJW step 4): points on the unit sphere of the eigenspace
    emb = U / torch.clamp_min(torch.linalg.norm(U, dim=1, keepdim=True), 1e-12)
    if mesh is not None:
        emb = D.gather_rows(mesh, emb, K.shape[0])
    labels, _, _ = kmeans(stream_generator(seed, KMEANS_STREAM), emb,
                          n_clusters, iters=kmeans_iters,
                          restarts=kmeans_restarts)
    return SpectralResult(labels=labels, eigvals=eigvals, embedding=emb,
                          sketch=sk, info=info)
