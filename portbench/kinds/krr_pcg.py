"""Sketched KRR fits by preconditioned conjugate gradients, one a job, each on
a sketch of its own.

Job i draws the uniform signed accumulation sketch (m, d) from the CPU
generator seeded with job i's seed (``make_accum_sketch``), then fits
``krr_sketched_fit_pcg(op, y, λ, sk, iters)`` on the operator of the training
rows: CG on the Woodbury system (CᵀC + nλW) θ = Cᵀy, preconditioned by the
Cholesky of W (FALKON's recipe), for the mix's ``iters`` iterations.

The check draws the sketch again from the job's seed and, with the plain
reference (``reference/krr.py``) in float64, computes C, W, the system M,
its exact solution θ* and the reference's own iterate θ_ref after as many
iterations.  It compares:

* ``sketch_mismatch``: the sketch's row indices, exactly;
* ``cols_rel``: the program's fitted values against the reference's C applied
  to the program's θ, ‖f − C θ‖ / ‖C θ_ref‖: the kernel columns C that the
  fit used;
* ``theta_excess``: how much farther the program's θ lies from θ* than θ_ref
  does, in M's norm, as a share of ‖θ*‖_M: W, the preconditioner and the
  iterations.

θ is not compared with θ_ref directly.  After 20 iterations at λ = 1e-6 CG is
far from converged, and its recurrences in float32, the configuration's
precision, carry the iterate about a tenth of its norm away from the float64
one (so does a plain float32 CG on the reference's float32 C and W, to five
digits), while its distance from θ* grows by a few hundredths.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.kinds import base
from portbench.reference import krr as R
from portbench.reference import sketch as RS
from portbench.yardstick import work
from portbench.yardstick.traffic import stream

WARM_TAG = 0x3A12


class Driver:
    """See the module's docstring."""

    def __init__(self, cfg: dict, mix: dict, data: dict, seed: int, device):
        from repro_torch.core.kernel_op import KernelOperator

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.X, self.y = data["X"], data["y"]
        self.n, self.p = self.X.shape
        self.m, self.d = cfg["sketch"]["m"], cfg["sketch"]["d"]
        self.op = KernelOperator(self.X, cfg["kernel"], bandwidth=cfg["bandwidth"])
        self.kept: list[dict] = []

    def fit(self, job_seed: int):
        from repro_torch.core import krr, sketch

        g = torch.Generator().manual_seed(job_seed)
        sk = sketch.make_accum_sketch(g, self.n, self.d, self.m, device=self.device)
        return krr.krr_sketched_fit_pcg(self.op, self.y, self.cfg["lam"], sk,
                                        iters=self.mix["iters"])

    def warm(self) -> None:
        self.fit(stream(self.seed, WARM_TAG))

    def run(self, job: dict) -> None:
        model = self.fit(job["seed"])
        self.kept.append({"job": job, "idx": model.sk.indices, "theta": model.theta,
                          "fitted": model.fitted})

    def work(self, job: dict) -> dict:
        n, p, m, d = self.n, self.p, self.m, self.d
        return {"flops": work.krr_pcg_fit(n, p, m, d, self.mix["iters"]),
                "matfree": [(n, p, m, d)]}

    def release(self) -> None:
        self.op = None

    def reference(self, job: dict, precision: str) -> dict:
        """The sketch, C, W and the PCG iterate, worked out plainly."""
        with base.precision(precision) as dt:
            g = torch.Generator().manual_seed(job["seed"])
            idx, coef = RS.uniform_signed(g, self.n, self.d, self.m)
            idx, coef = idx.to(self.device), coef.to(self.device, dt)
            X, y = self.X.to(dt), self.y.to(dt)
            C = R.gaussian_cols(X, X.index_select(0, idx.reshape(-1)), coef,
                                self.cfg["bandwidth"])
            W = R.sketch_left(idx, coef, C)
            W = 0.5 * (W + W.T)
            out = R.pcg(C, W, y, self.cfg["lam"], self.mix["iters"])
            return {"idx": idx, "theta": out["theta"], "fitted": out["fitted"],
                    "C": C, "W": W}

    def compare(self, ans: dict, ref: dict) -> dict:
        """The numbers of the answer ``ans`` against the float64 ``ref``."""
        C, W, y = ref["C"], ref["W"], self.y.double()
        M = R.gram(C) + (self.n * self.cfg["lam"]) * W
        exact, _ = R.cholesky_ladder(M, C.T @ y)
        theta = ans["theta"].double()
        base_ = R.m_norm(M, ref["theta"] - exact)
        return {
            "sketch_mismatch": int((ans["idx"].long() != ref["idx"].long()).sum()),
            "cols_rel": float(torch.linalg.norm(ans["fitted"].double() - C @ theta)
                              / torch.linalg.norm(ref["fitted"])),
            "theta_excess": (R.m_norm(M, theta - exact) - base_) / R.m_norm(M, exact),
        }

    def check(self) -> list[dict]:
        rows = []
        for ans in base.sample(self.kept, self.mix["check_jobs"], self.seed):
            ref = self.reference(ans["job"], "float64")
            rows.append(self.compare(ans, ref))
            del ref
        return rows

    def control(self, jobs: list[dict]) -> list[dict]:
        """The numbers of the reference in TF32 put in the program's place."""
        rows = []
        for job in jobs:
            ans = self.reference(job, "tf32")
            del ans["C"], ans["W"]
            rows.append(self.compare(ans, self.reference(job, "float64")))
        return rows


def _half_sketch(real):
    """C and W from the first half of the sketch's slabs only, their
    coefficients scaled by √2: half of the sampled columns left out, the
    mean taken over the rest."""
    def pair(X, sk, *args, **kwargs):
        h = sk.indices.shape[0] // 2
        half = dataclasses.replace(sk, indices=sk.indices[:h], signs=sk.signs[:h],
                                   coef_=sk.coef[:h] * 2 ** 0.5)
        return real(X, half, *args, **kwargs)
    return pair


def _state_unchanged(real):
    """CG's steps leave θ where it starts (zero iterations)."""
    def solve(C, W, y, lam, iters, *args, **kwargs):
        return real(C, W, y, lam, 0, *args, **kwargs)
    return solve


def _theta_altered(real):
    """Every tenth coefficient of θ negated where it is produced."""
    def solve(*args, **kwargs):
        theta = real(*args, **kwargs).clone()
        theta[::10] = -theta[::10]
        return theta
    return solve


def _fitted_altered(real):
    """Every hundredth fitted value scaled by 1.1 where it is produced."""
    def fit(*args, **kwargs):
        model = real(*args, **kwargs)
        fitted = model.fitted.clone()
        fitted[::100] *= 1.1
        return dataclasses.replace(model, fitted=fitted)
    return fit


FAULTS = ("half_sketch", "state_unchanged", "theta_altered", "fitted_altered")


def fault(name: str):
    """A context in which the program has the fault ``name``."""
    from repro_torch.core import krr

    where = {
        "half_sketch": (krr, "_matfree_pair", _half_sketch),
        "state_unchanged": (krr, "_pcg_solve", _state_unchanged),
        "theta_altered": (krr, "_pcg_solve", _theta_altered),
        "fitted_altered": (krr, "krr_sketched_fit_pcg", _fitted_altered),
    }[name]
    return base.patched(*where)
