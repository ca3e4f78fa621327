"""Matrix-free kernel operator — the accumulation sketch applied to a DATASET.

``KernelOperator`` represents K = k(X, X) by the data ``X`` and the kernel's
name and bandwidth (``core/kernels_math.py``) and computes

    C = K S           (n, d)   — row-streamed kernel-eval → contraction
    W = Sᵀ K S = SᵀC  (d, d)   — row gathers of C, no extra kernel evals

straight from X, so the n×n matrix never exists.  Two backends share the
arithmetic: the ``matfree_apply`` CUDA kernel (tensors on a CUDA device) and
a chunked PyTorch loop (``stream_cols``, or ``stream_cols_slabs`` for the
engine's batches), whose peak memory is O(chunk · m·d).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import apply as A
from repro_torch.core.kernels_math import get_kernel
from repro_torch.core.sketch import AccumSketch

# dense() materializes the n×n kernel — refuse above this n unless forced
# (at n = 32768 the f32 matrix is already 4 GiB; the sqdist intermediates
# triple that)
DENSE_GUARD_N = 32768


def _scan_row_chunks(X: torch.Tensor, chunk: int | None, block_fn) -> torch.Tensor:
    """Row-streaming scaffold: ``block_fn`` maps a (b, p) row block to a
    (b, c) result, applied chunk by chunk (the ragged tail is the last
    chunk).  ``chunk=None`` or small inputs take a single block."""
    n = X.shape[0]
    if chunk is None or n <= chunk:
        return block_fn(X)
    return torch.cat([block_fn(X[lo:lo + chunk]) for lo in range(0, n, chunk)])


def stream_cols(Xq: torch.Tensor, landmarks: torch.Tensor, coef: torch.Tensor,
                kernel_fn, *, chunk: int | None = None) -> torch.Tensor:
    """C = K(Xq, ·)·S from raw rows: the (b, m·d) kernel slab of each row
    chunk against the landmark rows, contracted with the combination
    coefficients.  Returns (nq, d), accumulated in float32 at least (float64
    inputs stay float64)."""
    m, d = coef.shape
    acc_t = torch.promote_types(torch.float32,
                                torch.promote_types(Xq.dtype, coef.dtype))
    coef_a = coef.to(acc_t)

    def _block(xb):
        slab = kernel_fn(xb, landmarks).to(acc_t)               # (b, m·d)
        return torch.einsum("bmd,md->bd", slab.reshape(xb.shape[0], m, d),
                            coef_a)

    return _scan_row_chunks(Xq, chunk, _block)


def stream_cols_slabs(Xq: torch.Tensor, landmarks: torch.Tensor,
                      coef: torch.Tensor, kernel_fn, *,
                      chunk: int | None = None) -> torch.Tensor:
    """Multi-slab C = K(Xq, ·)·S accumulated slab by slab — the batched
    engine's plain route: each slab's (chunk, d) kernel block is evaluated
    at the narrow shape and folded into the (nq, d) sum, so the (nq, m·d)
    slab of ``stream_cols`` never exists.  Returns (nq, d), accumulated in
    float32 at least (float64 inputs stay float64)."""
    m, d = coef.shape
    acc_t = torch.promote_types(torch.float32,
                                torch.promote_types(Xq.dtype, coef.dtype))
    if chunk is None:
        # the (chunk, d) kernel block is the transient peak, ~16 MiB
        chunk = max(8, (4 * 1024 * 1024) // max(d, 1))
    lmr = landmarks.reshape(m, d, landmarks.shape[-1])
    cf = coef.to(acc_t)
    acc = torch.zeros((Xq.shape[0], d), dtype=acc_t, device=Xq.device)
    for lm_b, cf_b in zip(lmr, cf):
        blk = _scan_row_chunks(Xq, chunk,
                               lambda xb, lm_b=lm_b: kernel_fn(xb, lm_b).to(acc_t))
        acc = acc + blk * cf_b[None, :]
    return acc


@dataclasses.dataclass(frozen=True)
class KernelOperator:
    """K = k(X, X) as an operator: data + kernel name, never the matrix."""

    X: torch.Tensor               # (n, p) dataset rows
    kernel: str = "gaussian"
    bandwidth: float = 1.0
    nu: float = 1.5               # matern only

    @property
    def n(self) -> int:
        """Number of dataset rows (= both dims of the represented K)."""
        return self.X.shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        """(n, n) — the shape of the never-materialized Gram matrix."""
        return (self.n, self.n)

    @property
    def dtype(self) -> torch.dtype:
        """dtype of the represented K (= the dataset's dtype)."""
        return self.X.dtype

    @property
    def kernel_fn(self):
        """(a, p), (b, p) → (a, b) kernel matrix — ``core.kernels_math``."""
        return get_kernel(self.kernel, self.bandwidth, self.nu)

    def _auto_chunk(self, md: int) -> int:
        # f32 slab (chunk, md) ≤ ~16 MiB
        return max(8, (4 * 1024 * 1024) // max(md, 1))

    def submatrix(self, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """K[rows][:, cols] from |rows|·|cols| kernel evaluations."""
        return self.kernel_fn(self.X.index_select(0, rows),
                              self.X.index_select(0, cols))

    def weighted_cols(self, Xq: torch.Tensor, idx: torch.Tensor,
                      coef: torch.Tensor, *, chunk: int | None = None,
                      use_kernel: bool | None = None, mesh=None) -> torch.Tensor:
        """K(Xq, ·)·S for the sketch described by idx/coef (m, d) — the core
        primitive behind C and prediction.

        ``use_kernel`` (default: whether Xq is on a CUDA device) takes the
        ``matfree_apply`` kernel (float32 or bfloat16 data, float32 result;
        float64 data on a card needs ``use_kernel=False``); otherwise the
        chunked PyTorch loop.  ``mesh`` returns this rank's rows of the
        result for the replicated Xq (``core.distributed``)."""
        if mesh is not None:
            from repro_torch.core import distributed as D

            return D.sharded_weighted_cols(
                self, Xq, idx, coef, D.resolve_mesh(mesh, Xq.device), chunk=chunk,
                use_kernel=use_kernel)
        if use_kernel is None:
            use_kernel = A.default_use_kernel(Xq.device)
        lm = self.X.index_select(0, idx.reshape(-1))
        if use_kernel:
            from repro_torch.kernels.accum_apply.ops import matfree_cols_kernel

            return matfree_cols_kernel(Xq, lm, coef, kernel=self.kernel,
                                       bandwidth=self.bandwidth, nu=self.nu)
        if chunk is None:
            # budget by slab size, not row count
            chunk = self._auto_chunk(idx.numel())
        return stream_cols(Xq, lm, coef, self.kernel_fn, chunk=chunk)

    def sketch_cols(self, sk: AccumSketch, *, chunk: int | None = None,
                    use_kernel: bool | None = None, mesh=None) -> torch.Tensor:
        """C = K S (n, d) — O(n·m·d) kernel evaluations, O(n·d) memory
        (this rank's rows under ``mesh``)."""
        return self.weighted_cols(self.X, sk.indices, sk.coef, chunk=chunk,
                                  use_kernel=use_kernel, mesh=mesh)

    def cross_cols(self, Xq: torch.Tensor, sk: AccumSketch, *,
                   chunk: int | None = None, use_kernel: bool | None = None,
                   mesh=None) -> torch.Tensor:
        """K(Xq, X)·S (nq, d) — the matrix-free predict path: test rows only
        ever meet the m·d landmark rows (this rank's rows under ``mesh``)."""
        return self.weighted_cols(Xq, sk.indices, sk.coef, chunk=chunk,
                                  use_kernel=use_kernel, mesh=mesh)

    def sketch_both(self, sk: AccumSketch, *, chunk: int | None = None,
                    use_kernel: bool | None = None, mesh=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(C, W) = (K S, SᵀK S) without forming K; W = SᵀC is the plain row
        gather of C (``apply.sketch_left``), O(m·d²) on top of C.  ``mesh``
        gives this rank's rows of C and W summed over the ranks."""
        if mesh is not None:
            from repro_torch.core import distributed as D

            return D.sharded_sketch_both(self, sk, D.resolve_mesh(mesh, self.X.device),
                                         chunk=chunk, use_kernel=use_kernel)
        C = self.sketch_cols(sk, chunk=chunk, use_kernel=use_kernel)
        return C, A.sketch_left(sk, C)

    def matvec(self, Z: torch.Tensor, *, chunk: int | None = None,
               mesh=None) -> torch.Tensor:
        """K @ Z streamed over row chunks — O(chunk·n) peak memory; ``mesh``
        gives this rank's rows of it."""
        if mesh is not None:
            from repro_torch.core import distributed as D

            return D.sharded_matvec(self, Z, D.resolve_mesh(mesh, self.X.device),
                                    chunk=chunk)
        return self.matvec_rows(self.X, Z, chunk=chunk)

    def matvec_rows(self, Xr: torch.Tensor, Z: torch.Tensor, *,
                    chunk: int | None = None) -> torch.Tensor:
        """K(Xr, X) @ Z for the rows ``Xr``, streamed over chunks of them."""
        Zm = Z[:, None] if Z.ndim == 1 else Z
        if chunk is None:
            chunk = max(8, (4 * 1024 * 1024) // max(self.n, 1))
        kf = self.kernel_fn
        Z32 = Zm.float()

        def _block(xb):
            return kf(xb, self.X).float() @ Z32

        out = _scan_row_chunks(Xr, chunk, _block)
        return out[:, 0] if Z.ndim == 1 else out

    def dense(self, *, force: bool = False) -> torch.Tensor:
        """Materialize K (n, n) — tests and small problems only; refused
        above ``DENSE_GUARD_N`` rows unless ``force=True``."""
        if self.n > DENSE_GUARD_N and not force:
            raise ValueError(
                f"refusing to materialize the {self.n}×{self.n} kernel matrix "
                f"(~{self.n * self.n * 4 / 2**30:.0f} GiB as f32); use the "
                "matrix-free sketched paths, or pass force=True if you really "
                "have the memory")
        return self.kernel_fn(self.X, self.X)
