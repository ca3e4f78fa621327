"""The paper's §5 extensions on classical ML, on the PyTorch port
(``repro_torch``), as ``examples/sketched_pca_kmeans.py``: accumulation-
sketched AMM for PCA, k-means via the shared ``spectral.kmeans`` solver, and
SKETCHED SPECTRAL CLUSTERING driven by the progressive accumulation engine
(``core.spectral``).

  PYTHONPATH=src python examples/sketched_pca_kmeans_torch.py [--device cpu] [--seed 0]

PCA:      Cov = XᵀX/n ≈ (SᵀX)ᵀ(SᵀX)/n — top eigenspace from an (m·d)-row sketch.
k-means:  centroid updates are AMMs over the big n axis — sketched per Lloyd
          iteration, assignments by ``repro_torch.core.spectral.kmeans``.
spectral: top-k eigenvectors of the sketched affinity K̂ = C W⁺ Cᵀ, where the
          engine grows m until a holdout error target is met, then k-means in
          the eigenspace — never an O(n³) eigendecomposition.

Expected: on well-conditioned (low-incoherence) data even m=1 suffices; the
accumulation knob m pays off where a few heavy rows dominate (high
incoherence): m·d samples cut the AMM variance that uniform sub-sampling
(m=1) suffers.  On a CUDA device the AMMs' Sᵀ·A is the
``accum_apply_left`` kernel, and the engine's growth ``accum_grow_slabs``.
"""
import argparse

import numpy as np
import torch

from claims_torch import check_claims
from repro_torch.core import amm, make_accum_sketch, spectral_cluster
from repro_torch.core.kernels_math import gaussian_kernel
from repro_torch.core.spectral import kmeans


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="assert the printed claims (exit non-zero if one fails)")
    args = ap.parse_args()
    dev = torch.device(args.device)

    def gen(offset: int, device=dev) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(args.seed + offset)

    n, p, rank = 4000, 32, 4
    claims, amm_err = {}, {}

    # ---- AMM error vs m under high incoherence (the paper's regime) ------- #
    heavy = torch.where(torch.arange(n, device=dev) < 20, 15.0, 1.0)
    Xh = torch.randn((n, p), generator=gen(0), device=dev) * heavy[:, None]
    exact = Xh.T @ Xh
    print("AMM ‖ÂᵀB − AᵀB‖_F/‖AᵀB‖_F, 20 heavy rows (high incoherence), d=64:")
    for m in [1, 4, 16]:
        errs = [
            float(torch.linalg.norm(amm(Xh, Xh, make_accum_sketch(
                gen(100 * m + r), n, 64, m=m, device=dev)) - exact)
                / torch.linalg.norm(exact))
            for r in range(20)
        ]
        amm_err[m] = float(np.mean(errs))
        print(f"  m={m:3d}: rel err {amm_err[m]:.2f}")
    claims["the AMM error falls from m = 1 to m = 16"] = amm_err[16] < amm_err[1]
    print()

    # data with a planted rank-4 signal subspace
    U = torch.linalg.qr(torch.randn((p, rank), generator=gen(0), device=dev))[0]
    scales = torch.tensor([6.0, 5.0, 4.0, 3.0], device=dev)
    Z = torch.randn((n, rank), generator=gen(1), device=dev) * scales
    X = Z @ U.T + 0.3 * torch.randn((n, p), generator=gen(2), device=dev)
    X = X - X.mean(0)

    # ---- PCA -------------------------------------------------------------- #
    cov_exact = (X.T @ X) / n
    _, V_exact = torch.linalg.eigh(cov_exact)
    top_exact = V_exact[:, -rank:]

    print(f"sketched PCA   (n={n}, p={p}, top-{rank} subspace affinity vs exact):")
    d = 64
    for m in [1, 2, 8]:
        affs = []
        for r in range(5):
            sk = make_accum_sketch(gen(10 * m + r), n, d, m=m, device=dev)
            cov_s = amm(X, X, sk) / n
            _, V_s = torch.linalg.eigh(0.5 * (cov_s + cov_s.T))
            top_s = V_s[:, -rank:]
            # mean squared canonical correlation between the two subspaces
            s = torch.linalg.svdvals(top_exact.T @ top_s)
            affs.append(float(torch.mean(s**2)))
        print(f"  m={m}: affinity={np.mean(affs):.4f}   ({m * d} of {n} rows touched)")
        claims[f"PCA m={m}: affinity at least 0.99"] = np.mean(affs) >= 0.99

    # ---- k-means (sketched-AMM Lloyd, assignments via the shared solver) -- #
    k, iters = 4, 10
    eye = torch.eye(p, device=dev)
    Xc = torch.cat(
        [torch.randn((n // k, p), generator=gen(7 + j), device=dev) * 0.5 + 4.0 * eye[j]
         for j in range(k)]
    )

    def assign(X, C):
        d2 = torch.sum(X**2, 1)[:, None] - 2 * X @ C.T + torch.sum(C**2, 1)[None]
        return torch.argmin(d2, 1)

    def inertia(X, C):
        return float(torch.sum((X - C[assign(X, C)]) ** 2))

    # the shared solver (k-means++ seeding + restarts; its draws on the host) is
    # a better-initialized baseline than the sketched runs below, which iterate
    # Lloyd's update from random rows (C0): compare m=1 with m=8
    _, C_ref, inert_ref = kmeans(gen(99, "cpu"), Xc, k, iters=iters)
    print(f"\nsketched k-means (k={k}; "
          f"best-of-restarts Lloyd inertia={float(inert_ref):.0f}):")

    C0 = Xc[torch.randperm(n, generator=gen(99, "cpu"))[:k].to(dev)]
    for m in [1, 8]:
        C = C0
        for it in range(iters):
            sk = make_accum_sketch(gen(1000 * m + it), n, d, m=m, device=dev)
            onehot = torch.nn.functional.one_hot(assign(Xc, C), k).to(Xc.dtype)
            sums = amm(onehot, Xc, sk)                               # ≈ onehotᵀ X
            counts = torch.clamp_min(
                amm(onehot, torch.ones((n, 1), device=dev), sk)[:, 0], 1e-3)
            C = sums / counts[:, None]
        print(f"  m={m}: inertia={inertia(Xc, C):.0f} "
              f"(centroid updates from {m * d} sampled rows/iter)")
        claims[f"k-means m={m}: inertia within 1.5× the solver's"] = (
            inertia(Xc, C) <= 1.5 * float(inert_ref))

    # ---- sketched spectral clustering (progressive engine) ---------------- #
    # Four planted clusters; the affinity is only ever touched through (C, W).
    # Blob data is LOW-incoherence (uniform sampling is already near-optimal),
    # so the engine's value here is the opposite direction: it stops at m=1
    # instead of overspending, while matching a fixed m=8 sketch's clustering.
    ns = 1200
    Xs = Xc[torch.randperm(n, generator=gen(123, "cpu"))[:ns].to(dev)]
    truth = torch.argmax(Xs, dim=1).cpu().numpy()  # cluster j is centered at 4·e_j
    K = gaussian_kernel(Xs, Xs, bandwidth=4.0)

    def pairwise_agreement(lab):
        # label-permutation-free: co-clustering indicator accuracy
        same_t = truth[:, None] == truth[None, :]
        same_l = lab[:, None] == lab[None, :]
        return float((same_t == same_l).mean())

    print(f"\nsketched spectral clustering (n={ns}, k={k}):")
    res_fix = spectral_cluster(args.seed + 321, K, k, d=32, m=8)
    print(f"  fixed m=8   : pairwise agreement="
          f"{pairwise_agreement(res_fix.labels.cpu().numpy()):.3f}  ({8 * 32} rows touched)")
    res_ad = spectral_cluster(args.seed + 321, K, k, d=32, tol=0.2, m_max=16)
    print(f"  adaptive    : engine stopped at m={int(res_ad.info['m'])} "
          f"(est err {float(res_ad.info['err']):.3f}), pairwise agreement="
          f"{pairwise_agreement(res_ad.labels.cpu().numpy()):.3f}"
          f"  ({int(res_ad.info['m']) * 32} rows touched)")
    claims["spectral: the engine stops at m = 1 on blob data"] = int(res_ad.info["m"]) == 1
    for name, res in (("fixed", res_fix), ("adaptive", res_ad)):
        claims[f"spectral {name}: pairwise agreement at least 0.99"] = (
            pairwise_agreement(res.labels.cpu().numpy()) >= 0.99)
    check_claims(claims, args.check)


if __name__ == "__main__":
    main()
