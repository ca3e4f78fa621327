"""Paper Fig. 2 in miniature on the PyTorch port (``repro_torch``), as
``examples/krr_m_sweep.py``: approximation error ‖f̂_S − f̂_n‖²_n versus the
accumulation count m, on the paper's bimodal high-incoherence distribution.

  PYTHONPATH=src python examples/krr_m_sweep_torch.py [--device cpu] [--seed 0] [--draws]

Expected output (the reference's): error drops orders of magnitude from m=1
(Nyström) toward the Gaussian-sketch (m=∞) floor by m≈8–32, while the
sketch stays m·d-sparse.  On a CUDA device each fit's (C, W) comes from
the ``accum_sketch_both`` kernel; ``--draws`` prints each draw's error.

A draw's error is heavy-tailed, so a mean of five is set by its worst
draw (on the CPU at seed 0 the five Nyström draws run from 4.8e-5 to
6.2e-3).  A CUDA generator draws other data and
sketches than the CPU's from the same seed: on an H100 at seed 0 no
Nyström draw is bad (mean 1.8e-4) and one m = 4 draw is (7.7e-3, mean
1.6e-3), the same to 0.4% through the kernel, the plain gather and the
plain gather in float64 (``scripts/krr_sweep_draws.py``).  So ``--check``
holds the trend's direction and the floor (the best mean of m = 8–32
below m = 1's and within 10× of the Gaussian's), not its size.
"""
import argparse
import dataclasses

import numpy as np
import torch

from claims_torch import check_claims
from repro_torch.core import (
    get_kernel, insample_error, krr_exact_fitted, krr_sketched_fit,
    krr_sketched_fit_dense, make_accum_sketch, make_gaussian_sketch,
)


def bimodal_data(g: torch.Generator, n: int, gamma: float = 0.6, noise_sd: float = 0.5,
                 device="cpu") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The paper's bimodal distribution over R³ (appendix D.2), the formulas
    of ``benchmarks/common.py::bimodal_data`` drawn from ``g``: with prob
    n/(n+n^γ) Unif[0,1]³; with prob n^γ/(n+n^γ) the linear-pdf block on
    [2, 2.5]³.  True f*(x) = g(‖x‖/3) with the paper's quartic g."""
    p2 = n**gamma / (n + n**gamma)
    n2 = max(int(round(n * p2)), 4)
    x1 = torch.rand((n - n2, 3), generator=g, device=device)
    p = torch.rand((n2, 3), generator=g, device=device)
    x2 = 2.5 - 0.5 * torch.sqrt(1.0 - p * (1.0 - (4.0 / 9.0)))  # linear-pdf inverse
    X = torch.cat([x1, x2], dim=0)

    def quartic(x):
        return 1.6 * torch.abs((x - 0.4) * (x - 0.6)) - x * (x - 1) * (x - 2) - 0.5

    f = quartic(torch.linalg.norm(X, dim=1) / 3.0)
    y = f + noise_sd * torch.randn((n,), generator=g, device=device)
    return X, y, f


def sweep(dev: torch.device, seed: int, *, use_kernel: bool | None = None,
          dtype=torch.float32, reps: int = 5) -> dict:
    """The figure's fits: {"n", "d", "lam", "errs": {m: [reps errors]},
    "gauss": [reps errors]}, each error one draw's ‖f̂_S − f̂_n‖²_n.  Every
    draw (data, sketches) is made in float32 from ``seed`` on ``dev``'s
    generator; ``dtype`` is what the data and sketches are then cast to,
    and ``use_kernel`` picks the route of each (C, W) (None: the kernel on
    a CUDA device)."""
    def gen(offset: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed + offset)

    n, gamma = 2000, 0.6
    X, y, _ = bimodal_data(gen(0), n, gamma=gamma, device=dev)
    X, y = X.to(dtype), y.to(dtype)
    lam = 0.5 * n ** (-4 / 7)
    d = int(1.0 * n ** (3 / 7))
    kern = get_kernel("gaussian", bandwidth=1.5 * n ** (-1 / 7))
    K = kern(X, X)
    fit_exact = krr_exact_fitted(K, y, lam)
    errs = {}
    for m in [1, 2, 4, 8, 16, 32]:
        errs[m] = []
        for r in range(reps):
            sk = make_accum_sketch(gen(100 * m + r), n, d, m=m, device=dev)
            sk = dataclasses.replace(sk, signs=sk.signs.to(dtype), probs=sk.probs.to(dtype),
                                     coef_=sk.coef.to(dtype))
            errs[m].append(float(insample_error(
                krr_sketched_fit(K, y, lam, sk, use_kernel=use_kernel).fitted, fit_exact)))
    gauss = []
    for r in range(reps):
        S = make_gaussian_sketch(gen(999 + r), n, d, device=dev).to(dtype)
        gauss.append(float(insample_error(
            krr_sketched_fit_dense(K, y, lam, S).fitted, fit_exact)))
    return {"n": n, "d": d, "lam": lam, "errs": errs, "gauss": gauss}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--draws", action="store_true", help="print each draw's error too")
    ap.add_argument("--check", action="store_true",
                    help="assert the printed claims (exit non-zero if one fails)")
    args = ap.parse_args()
    out = sweep(torch.device(args.device), args.seed)
    reps = len(out["gauss"])

    def draws(e):
        return "   [" + " ".join(f"{x:.2e}" for x in e) + "]" if args.draws else ""

    print(f"n={out['n']} d={out['d']} λ={out['lam']:.4f}   (‖f̂_S − f̂_n‖²_n, avg of {reps})")
    mean = {m: float(np.mean(e)) for m, e in out["errs"].items()}
    for m, e in out["errs"].items():
        print(f"  m={m:3d}: {mean[m]:.3e}{draws(e)}")
    floor = float(np.mean(out["gauss"]))
    print(f"  m=∞ (gaussian): {floor:.3e}{draws(out['gauss'])}")
    best = min(mean[m] for m in (8, 16, 32))
    check_claims({"by m = 8–32 the error is below m = 1's": best < mean[1],
                  "and within 10× of the Gaussian-sketch floor": best <= 10 * floor},
                 args.check)


if __name__ == "__main__":
    main()
