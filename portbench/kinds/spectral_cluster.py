"""Sketched spectral clustering jobs, one a job, each with a seed of its own.

A job is ``spectral_cluster(job seed, op, k, d=d, m=m)`` on the operator of
the rows (normalised, k-means with the configuration's restarts and
iterations); it draws its sketch from the job's seed and its k-means seeding
from (job seed, the k-means stream), as the entry documents.

The check draws the sketch again, computes C and W, the normalised
embedding and its k-means partition with the plain reference in float64
(the configuration's restarts and iterations, the seeding drawn from the
job's k-means stream as the entry documents it), and compares the sketch's
row indices (exactly), the eigenvalues (worst relative error), the
embedding's span (the sine of the largest principal angle) and the labels:
how much more inertia the program's partition leaves on the reference's
embedding than the reference's partition does, as a share of the latter's
(``kmeans_excess``).  Labels are not compared row by row: rounding moves
rows near a boundary, and no count of moved rows separates a lower precision
from the program.  Nor against a better k-means than the configuration's:
with 7 clusters of Covertype's skew, k-means' local optima differ by up to a
tenth of the inertia, and which one a run finds depends on its draws.

``FAULTS`` names the faults a run of this kind can have, each planted in
the program by ``fault(name)``; each has to come out as not correct.
"""
from __future__ import annotations

import torch

from portbench.kinds import base
from portbench.reference import krr as R
from portbench.reference import sketch as RS
from portbench.reference import spectral as RSp
from portbench.yardstick import work
from portbench.yardstick.traffic import stream

WARM_TAG = 0x3A13
# the tag of the k-means stream (job seed, tag) that ``spectral_cluster``
# documents its seeding draws from
KMEANS_TAG = 0x4B3A


class Driver:
    """See the module's docstring."""

    def __init__(self, cfg: dict, mix: dict, data: dict, seed: int, device):
        from repro_torch.core.kernel_op import KernelOperator

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.X, self.bandwidth = data["X"], data["bandwidth"]
        self.n, self.p = self.X.shape
        self.m, self.d = cfg["sketch"]["m"], cfg["sketch"]["d"]
        self.k = cfg["clusters"]
        self.op = KernelOperator(self.X, cfg["kernel"], bandwidth=self.bandwidth)
        self.kept: list[dict] = []

    def cluster(self, job_seed: int):
        from repro_torch.core import spectral

        return spectral.spectral_cluster(
            job_seed, self.op, self.k, d=self.d, m=self.m,
            normalized=self.cfg["normalized"],
            kmeans_restarts=self.cfg["kmeans_restarts"],
            kmeans_iters=self.cfg["kmeans_iters"])

    def warm(self) -> None:
        self.cluster(stream(self.seed, WARM_TAG))

    def run(self, job: dict) -> None:
        res = self.cluster(job["seed"])
        self.kept.append({"job": job, "idx": res.sketch.indices, "eigvals": res.eigvals,
                          "embedding": res.embedding, "labels": res.labels})

    def work(self, job: dict) -> dict:
        cfg = self.cfg
        return {"flops": work.spectral_cluster(self.n, self.p, self.m, self.d, self.k,
                                               cfg["kmeans_restarts"], cfg["kmeans_iters"]),
                "matfree": [(self.n, self.p, self.m, self.d)]}

    def release(self) -> None:
        self.op = None

    def reference(self, job: dict, precision: str) -> dict:
        with base.precision(precision) as dt:
            g = torch.Generator().manual_seed(job["seed"])
            idx, coef = RS.uniform_signed(g, self.n, self.d, self.m)
            idx, coef = idx.to(self.device), coef.to(self.device, dt)
            X = self.X.to(dt)
            C = R.gaussian_cols(X, X.index_select(0, idx.reshape(-1)), coef, self.bandwidth)
            W = R.sketch_left(idx, coef, C)
            eigvals, emb = RSp.embedding(C, W, self.k)
            del C
            km = torch.Generator().manual_seed(stream(job["seed"], KMEANS_TAG))
            labels = RSp.kmeans(emb, self.k, km, self.cfg["kmeans_restarts"],
                                self.cfg["kmeans_iters"])
            return {"idx": idx, "eigvals": eigvals, "embedding": emb, "labels": labels}

    def compare(self, ans: dict, ref: dict) -> dict:
        ev = ref["eigvals"].double()
        return {
            "sketch_mismatch": int((ans["idx"].long() != ref["idx"].long()).sum()),
            "eigval_rel": float(((ans["eigvals"].double() - ev).abs() / ev.abs()).max()),
            "subspace_sin": RSp.subspace_sin(ans["embedding"], ref["embedding"]),
            "kmeans_excess": RSp.excess_inertia(ref["embedding"], ans["labels"],
                                                ref["labels"], self.k),
        }

    def check(self) -> list[dict]:
        rows = []
        for ans in base.sample(self.kept, self.mix["check_jobs"], self.seed):
            rows.append(self.compare(ans, self.reference(ans["job"], "float64")))
        return rows

    def control(self, jobs: list[dict]) -> list[dict]:
        """The numbers of the reference in TF32 put in the program's place."""
        return [self.compare(self.reference(job, "tf32"), self.reference(job, "float64"))
                for job in jobs]


def _half_sketch(real):
    """``KernelOperator.weighted_cols`` on the first half of the sketch's
    slabs only, their coefficients scaled by √2: half of the sampled
    columns left out, the mean taken over the rest."""
    def cols(self, Xq, idx, coef, **kwargs):
        h = idx.shape[0] // 2
        return real(self, Xq, idx[:h], coef[:h] * 2 ** 0.5, **kwargs)
    return cols


def _eigvals_altered(real):
    """The eigenvalues scaled by 1.01 where they are produced."""
    def embed(*args, **kwargs):
        ev, emb = real(*args, **kwargs)
        return ev * (1 + 1e-2), emb
    return embed


def _embedding_altered(real):
    """Every tenth row turned a quarter of the way to the next direction."""
    def embed(*args, **kwargs):
        ev, emb = real(*args, **kwargs)
        emb = emb.clone()
        emb[::10, 0] += 0.25 * emb[::10, 1]
        return ev, emb
    return embed


def _lloyd_unchanged(real):
    """Lloyd's steps leave the centres where the seeding put them."""
    def kmeans(generator, X, k, **kwargs):
        return real(generator, X, k, **{**kwargs, "iters": 0})
    return kmeans


def _labels_altered(real):
    """Every fiftieth row's label moved to the next cluster."""
    def kmeans(generator, X, k, **kwargs):
        labels, centres, inertia = real(generator, X, k, **kwargs)
        labels = labels.clone()
        labels[::50] = (labels[::50] + 1) % k
        return labels, centres, inertia
    return kmeans


FAULTS = ("half_sketch", "eigvals_altered", "embedding_altered", "lloyd_unchanged",
          "labels_altered")


def fault(name: str):
    """A context in which the program has the fault ``name``."""
    from repro_torch.core import spectral
    from repro_torch.core.kernel_op import KernelOperator

    where = {
        "half_sketch": (KernelOperator, "weighted_cols", _half_sketch),
        "eigvals_altered": (spectral, "sketched_spectral_embedding", _eigvals_altered),
        "embedding_altered": (spectral, "sketched_spectral_embedding", _embedding_altered),
        "lloyd_unchanged": (spectral, "kmeans", _lloyd_unchanged),
        "labels_altered": (spectral, "kmeans", _labels_altered),
    }[name]
    return base.patched(*where)
