"""Algorithm 1 of the paper: sketching matrices as accumulations of m rescaled,
randomly-signed sub-sampling matrices.

The sketch is structural: the n-by-d matrix S is never materialized.  It is
described by

  indices : (m, d) int32   — n_ij, the sampled row of the single non-zero in
                             column j of the i-th sub-sampling matrix S_(i)
  signs   : (m, d) float   — r_ij, i.i.d. Rademacher
  probs   : (n,)   float   — the sampling distribution P (p_k)

so that  S = Σ_i S_(i),  with  (S_(i))[:, j] = r_ij / sqrt(d·m·p_{n_ij}) e_{n_ij}.

Draws come from an explicit ``torch.Generator`` and do not reproduce JAX's
threefry bits; parity with the reference goes through
``repro_torch.interop.sketch_from_numpy``, which carries a JAX draw across.
The draw runs on the generator's device and the result moves to ``device``,
so one seed gives the same sketch on every device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._util import resolve_device
from repro_torch.core.schemes import (
    _rademacher,
    poisson_inclusion,
    poisson_pieces,
    validate_scheme,
)


@dataclasses.dataclass(frozen=True)
class AccumSketch:
    """Structural representation of an accumulation-of-sub-sampling sketch.

    ``coef_`` optionally carries the precomputed (m, d) combination
    coefficients; the constructors populate it, and ``coef`` computes it for
    hand-built sketches that leave it ``None``."""

    indices: torch.Tensor               # (m, d) int32
    signs: torch.Tensor                 # (m, d) — ±1
    probs: torch.Tensor                 # (n,) sampling distribution
    n: int                              # ambient dimension (rows of S)
    coef_: torch.Tensor | None = None   # (m, d) cached r_ij / sqrt(d m p)
    scheme: str = "uniform"

    @property
    def m(self) -> int:
        """Number of accumulated sub-sampling matrices (slabs)."""
        return self.indices.shape[0]

    @property
    def d(self) -> int:
        """Sketch dimension (columns of S)."""
        return self.indices.shape[1]

    @property
    def device(self) -> torch.device:
        """Device the sketch's tensors live on."""
        return self.indices.device

    @property
    def coef(self) -> torch.Tensor:
        """(m, d) combination coefficients r_ij / sqrt(d m p_{n_ij})."""
        if self.coef_ is not None:
            return self.coef_
        return _compute_coef(self.indices, self.signs, self.probs)

    def truncated(self, m: int) -> "AccumSketch":
        """The sketch restricted to its first ``m`` sub-sampling matrices; the
        cached coefficients renormalize by sqrt(M/m)."""
        if not 0 < m <= self.m:
            raise ValueError(f"cannot truncate m={self.m} sketch to m={m}")
        if m == self.m:
            return self
        coef_ = None
        if self.coef_ is not None:
            coef_ = self.coef_[:m] * math.sqrt(self.m / m)
        return AccumSketch(indices=self.indices[:m], signs=self.signs[:m],
                           probs=self.probs, n=self.n, coef_=coef_,
                           scheme=self.scheme)

    def dense(self) -> torch.Tensor:
        """Materialize S (n, d) — O(n d), for tests/small problems only."""
        onehot = torch.nn.functional.one_hot(
            self.indices.long(), self.n).to(self.signs.dtype)     # (m, d, n)
        return torch.einsum("mdn,md->nd", onehot, self.coef)

    def nnz_per_column(self) -> torch.Tensor:
        """Number of distinct non-zeros per column (≤ m), computed O(m²·d)
        from ``indices``/``coef``: colliding draws whose coefficients cancel
        are zeros of S, exactly as in the dense count."""
        coef = self.coef
        eq = self.indices[:, None, :] == self.indices[None, :, :]  # (m, m, d)
        summed = torch.sum(torch.where(eq, coef[None, :, :], 0.0), dim=1)
        # entry i represents its row iff no earlier draw i' < i hit the same row
        earlier = torch.tril(torch.ones((self.m, self.m), dtype=torch.bool,
                                        device=self.device), diagonal=-1)
        seen = torch.any(eq & earlier[:, :, None], dim=1)          # (m, d)
        return torch.sum(~seen & (summed != 0), dim=0)


def _compute_coef(indices: torch.Tensor, signs: torch.Tensor,
                  probs: torch.Tensor) -> torch.Tensor:
    m, d = indices.shape
    p = probs[indices.long()]                                      # (m, d)
    return signs / torch.sqrt(d * m * p)


def _normalize_probs(probs, n: int, dtype=torch.float32,
                     device="cpu") -> torch.Tensor:
    """The one shared probs-normalization path for every sketch constructor:
    ``None`` → uniform; anything else is coerced to ``dtype`` and renormalized
    to sum 1."""
    if probs is None:
        return torch.full((n,), 1.0 / n, dtype=dtype, device=device)
    probs = torch.as_tensor(probs, dtype=dtype, device=device)
    return probs / torch.sum(probs)


def make_accum_sketch(
    generator: torch.Generator, n: int, d: int, m: int = 1, probs=None, *,
    scheme: str = "uniform", signed: bool = True, dtype=torch.float32,
    device="cuda",
) -> AccumSketch:
    """Algorithm 1: draw m·d indices from P with replacement, plus Rademacher
    signs.

    ``probs=None`` means the uniform distribution (classical Nyström when
    m=1); ``signed=False`` drops the signs.  ``scheme="leverage"`` needs an
    explicit ``probs``; ``scheme="poisson"`` draws Poisson slabs with
    π = min(1, d·p) and stores π/d as the per-row probability, so the cached
    coef is the Horvitz–Thompson r/√(m·π) (``core.schemes``).  ``device``
    defaults to ``"cuda"`` and raises on a machine without a card."""
    device = resolve_device(device)
    validate_scheme(scheme)
    gdev = generator.device
    if scheme == "poisson":
        pi = poisson_inclusion(probs, n, d, dtype, gdev)
        indices, signs = poisson_pieces(generator, pi, m, d, dtype=dtype,
                                        signed=signed)
        indices, signs = indices.to(device), signs.to(device)
        probs_eff = (pi / d).to(device, dtype)
        return AccumSketch(indices=indices, signs=signs, probs=probs_eff, n=n,
                           coef_=_compute_coef(indices, signs, probs_eff),
                           scheme=scheme)
    if scheme == "leverage" and probs is None:
        raise ValueError("scheme='leverage' needs an explicit probs vector in "
                         "the one-shot constructor")
    if probs is None:
        indices = torch.randint(0, n, (m, d), generator=generator, device=gdev)
    else:
        p = _normalize_probs(probs, n, torch.float64, gdev)
        indices = torch.multinomial(p, m * d, replacement=True,
                                    generator=generator).reshape(m, d)
    signs = (_rademacher(generator, (m, d), dtype) if signed
             else torch.ones((m, d), dtype=dtype, device=gdev))
    indices = indices.to(device=device, dtype=torch.int32)
    signs = signs.to(device)
    probs = _normalize_probs(probs, n, dtype, device)
    return AccumSketch(indices=indices, signs=signs, probs=probs, n=n,
                       coef_=_compute_coef(indices, signs, probs),
                       scheme=scheme)


def append_subsample(sk: AccumSketch, generator: torch.Generator, *,
                     signed: bool = True) -> AccumSketch:
    """Grow a sketch m → m+1 by drawing ONE new sub-sampling matrix from the
    same distribution, on the generator's device: the survivors' coefficients
    rescale by sqrt(m/(m+1)), S_{m+1} = sqrt(m/(m+1))·S_m + T_{m+1}.

    The grown sketch is a fresh draw, not a prefix of a one-shot draw; use
    ``AccumState`` and ``apply.accum_grow`` for a trajectory that replays one.
    A ``"poisson"`` sketch appends a Poisson slab with the same π = d·probs;
    other schemes draw with replacement from ``sk.probs``."""
    gdev = generator.device
    dt = sk.signs.dtype
    if sk.scheme == "poisson":
        pi = torch.clamp(sk.d * sk.probs, 1e-9, 1.0)   # probs stores π/d
        idx_new, sgn_new = poisson_pieces(generator, pi, 1, sk.d, dtype=dt,
                                          signed=signed)
    else:
        idx_new = torch.multinomial(sk.probs.to(gdev, torch.float64), sk.d,
                                    replacement=True,
                                    generator=generator)[None, :]
        sgn_new = (_rademacher(generator, (1, sk.d), dt) if signed
                   else torch.ones((1, sk.d), dtype=dt, device=gdev))
    indices = torch.cat([sk.indices, idx_new.to(sk.device, torch.int32)])
    signs = torch.cat([sk.signs, sgn_new.to(sk.device)])
    return AccumSketch(indices=indices, signs=signs, probs=sk.probs, n=sk.n,
                       coef_=_compute_coef(indices, signs, sk.probs),
                       scheme=sk.scheme)


def make_nystrom_sketch(generator: torch.Generator, n: int, d: int, probs=None,
                        dtype=torch.float32, *, scheme: str = "uniform",
                        device="cuda") -> AccumSketch:
    """m=1 special case — the classical (or leverage-weighted) Nyström
    sketch: ``make_accum_sketch`` with m=1, unsigned."""
    return make_accum_sketch(generator, n, d, m=1, probs=probs, scheme=scheme,
                             signed=False, dtype=dtype, device=device)


def make_gaussian_sketch(generator: torch.Generator, n: int, d: int,
                         dtype=torch.float32, *, device="cuda") -> torch.Tensor:
    """Dense sub-Gaussian sketch (the m→∞ limit): i.i.d. N(0, 1/d)."""
    device = resolve_device(device)
    S = torch.randn((n, d), generator=generator, dtype=dtype,
                    device=generator.device)
    return (S / d**0.5).to(device)


def make_sparse_rp(generator: torch.Generator, n: int, d: int, s: float | None = None,
                   dtype=torch.float32, *, device="cuda") -> torch.Tensor:
    """Very sparse random projection (Li, Hastie and Church 2006), a dense
    (n, d) baseline: each entry is √(s/d)·(+1 or −1 with probability
    1/(2s) each, 0 otherwise), s defaulting to √n.  Uniforms, then signs,
    are drawn on the generator's device and the result moves to
    ``device``."""
    device = resolve_device(device)
    if s is None:
        s = math.sqrt(n)
    gdev = generator.device
    u = torch.rand((n, d), generator=generator, device=gdev)
    sgn = _rademacher(generator, (n, d), dtype)
    scale = torch.sqrt(torch.full((), s / d, dtype=dtype, device=gdev))
    return (sgn * (u < 1.0 / s).to(dtype) * scale).to(device)


def make_accum_sketch_jit(generator: torch.Generator, n: int, d: int, m: int = 1,
                          probs=None, signed: bool = True, dtype=torch.float32, *,
                          scheme: str = "uniform", device="cuda") -> AccumSketch:
    """The reference's jit'd constructor, with its contract: ``dtype``
    reaches the signs, probs and coef, ``probs`` is normalized as in the
    eager constructor, and ``scheme="leverage"`` without ``probs`` raises
    the eager constructor's ``ValueError``.  PyTorch runs eagerly, so there
    is nothing to trace: this is ``make_accum_sketch`` with the reference's
    positional order, and its draw equals that constructor's for the same
    generator."""
    return make_accum_sketch(generator, n, d, m, probs, scheme=scheme, signed=signed,
                             dtype=dtype, device=device)


# --------------------------------------------------------------------------- #
# Progressive accumulation state
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class AccumState:
    """State of the progressive accumulation engine after ``m`` steps.

    All ``m_max`` sub-sampling matrices are drawn up front (the draw of
    ``make_accum_sketch`` at m_max, so growing to m_max replays it and a stop
    at m < m_max keeps a prefix of it), and each step folds slab ``m`` into
    the running, currently normalized

        C = K S_m   (n, d) float32        W = S_mᵀ K S_m   (d, d) float32

    in O(n·d).  ``err`` is the latest stopping estimate (+inf until first
    evaluated).  ``pdraw`` keeps each entry's probability at draw time: the
    leverage scheme refines ``probs`` while m grows, and accumulated slabs
    keep the normalization they were drawn with.

    The engine runs eagerly, so ``m`` is a Python int and ``err`` a Python
    float (the reference carries both as device scalars through its loops);
    the stopping test reads ``err`` on the host once per estimate."""

    indices: torch.Tensor    # (m_max, d) int32 — rows ≥ m not yet accumulated
    signs: torch.Tensor      # (m_max, d)
    probs: torch.Tensor      # (n,) current sampling distribution
    pdraw: torch.Tensor      # (m_max, d) per-entry probability at draw time
    C: torch.Tensor          # (n, d) float32 running K S_m
    W: torch.Tensor          # (d, d) float32 running Sᵀ K S_m
    m: int                   # slabs folded in so far
    err: float               # latest stopping-rule estimate
    n: int                   # ambient dimension
    scheme: str = "uniform"  # sampling scheme behind the draws

    @property
    def m_max(self) -> int:
        """Number of pre-drawn slabs (upper bound on m)."""
        return self.indices.shape[0]

    @property
    def d(self) -> int:
        """Sketch dimension (columns of S)."""
        return self.indices.shape[1]

    def grow_batched(self, K, B: int, *, use_kernel: bool | None = None,
                     donate: bool = False) -> "AccumState":
        """Fold the next ``B`` pre-drawn slabs into (C, W) in one pass over
        the data (``apply.accum_grow_batched``)."""
        from repro_torch.core.apply import accum_grow_batched

        return accum_grow_batched(K, self, B, use_kernel=use_kernel,
                                  donate=donate)

    def sketch(self) -> AccumSketch:
        """The AccumSketch accumulated so far, normalized for m from the
        at-draw probabilities ``pdraw``."""
        m = self.m
        if m == 0:
            raise ValueError("no sub-sampling matrices accumulated yet")
        coef = self.signs[:m] / torch.sqrt(self.d * m * self.pdraw[:m])
        return AccumSketch(indices=self.indices[:m], signs=self.signs[:m],
                           probs=self.probs, n=self.n, coef_=coef,
                           scheme=self.scheme)

    def masked_sketch(self) -> AccumSketch:
        """The full (m_max, d) sketch with slabs ≥ m zero-masked and the
        survivors normalized for m: every structural application is bilinear
        in ``coef``, so it applies exactly like ``sketch()``.  Its ``.m``
        reads m_max."""
        mf = float(max(self.m, 1))
        coef = self.signs.float() / torch.sqrt(self.d * mf * self.pdraw.float())
        mask = torch.arange(self.m_max, device=self.indices.device)[:, None] < self.m
        return AccumSketch(indices=self.indices,
                           signs=torch.where(mask, self.signs, 0.0),
                           probs=self.probs, n=self.n,
                           coef_=torch.where(mask, coef, 0.0),
                           scheme=self.scheme)
