"""Shape-agnostic entry points for the accum_apply kernels.

Each wrapper chooses by device alone: a tensor on the CPU takes the kernel's
plain PyTorch version (``ref``), a tensor on a CUDA device launches the CUDA
kernel (``kernel``), whose failures propagate.  Arbitrary shapes are taken
as they are — the CUDA kernels mask their own ragged edges, so nothing is
padded — and inputs are made contiguous, with the coefficients in float32.

Launch geometry (the rows a block takes) comes from the measured autotune
cache (``autotune``), at the reference's call sites and under its kind
names: ``sketch_right_kernel`` ("accum_apply"), ``sketch_both_kernel``
("sketch_both"), ``accum_grow_kernel`` ("accum_grow") and
``matfree_cols_kernel`` ("matfree_cols") measure their candidates on the
caller's tensors at the first call of a key; ``sketch_step_kernel`` only
looks the table up.  Every key carries ``kernel.source_hash()``, the hash of
``csrc/accum_apply.cu`` and its nvcc flags, so a geometry measured on an
earlier version of the source is a miss.  The plain versions have no
geometry, so the CPU route never measures.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_math import get_kernel
from repro_torch.core.sketch import AccumSketch
from repro_torch.kernels import routed
from repro_torch.kernels.accum_apply import autotune
from repro_torch.kernels.accum_apply import kernel as K_
from repro_torch.kernels.accum_apply import ref

# the reference's per-chunk column count (repro ops.py:49): the single-slab
# step takes the right-apply route above it, as the reference does
MAX_COLS = 8192

# rows a block: the candidates of the column gather and of matfree_apply
# (whose eight warps take eight rows a step: 64 rows keep all of them busy),
# beside each one's default
GATHER_ROWS = (16, 64, 256)
MATFREE_ROWS = (64, 256, 1024)


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _rows_candidates(rows: tuple[int, ...], R: int,
                     fallback: tuple[int, ...]) -> list[tuple[int, ...]]:
    """The fallback first, then each row count of ``rows``; counts that give
    R rows the same grid are one candidate (the first of them)."""
    grids = {}
    for bm in (fallback[0], *rows):
        grids.setdefault(-(-R // bm), (bm,))
    return list(grids.values())


def autotune_blocks(R: int, N: int, d: int, m: int, dtype: torch.dtype,
                    device) -> tuple[int]:
    """(bm,) for the column gather: measured-cache hit, else the static
    geometry.  The table side only — it never times anything; the entry
    points below measure on their real tensors and persist the winner."""
    hit = autotune.lookup("accum_apply", (R, N, d, m), dtype, device, arity=1,
                          source=K_.source_hash())
    return hit if hit is not None else autotune.STATIC_TABLE["accum_apply"]


def _gemm_candidates(R: int, fallback: tuple[int]) -> list[tuple[int]]:
    """Candidate (bm,) geometries of the column gather: the fallback and a
    shorter and a taller row tile (``GATHER_ROWS``).  The reference's lane
    dimension bd has no counterpart: a warp's lanes walk all d columns."""
    return _rows_candidates(GATHER_ROWS, R, fallback)


def autotune_both_blocks(n: int, device, d: int = 0, m: int = 0,
                         dtype: torch.dtype = torch.float32) -> tuple[int]:
    """(bm,) for the gather of the fused kernels: measured-cache hit first
    (when ``d``/``m`` identify the shape), else the static geometry."""
    if d and m:
        hit = autotune.lookup("sketch_both", (n, d, m), dtype, device, arity=1,
                              source=K_.source_hash())
        if hit is not None:
            return hit
    return autotune.STATIC_TABLE["sketch_both"]


@routed
def matfree_cols_kernel(Xq: torch.Tensor, landmarks: torch.Tensor,
                        coef: torch.Tensor, *, kernel: str,
                        bandwidth: float = 1.0,
                        nu: float = 1.5) -> torch.Tensor:
    """C = K(Xq, landmarks)·S straight from data rows, no n×n object.

    Xq: (nq, p) query rows; landmarks: (m·d, p) sampled rows X[sk.indices];
    coef: (m, d).  Returns (nq, d) float32.  The plain version evaluates the
    kernel on float32 copies, as the CUDA kernel does."""
    coef32 = coef.float().contiguous()
    if not _on_cuda(Xq):
        kf = get_kernel(kernel, bandwidth, nu)
        return ref.landmark_cols_ref(Xq.float(), landmarks.float(), coef32, kf)
    Xc, Lc = Xq.contiguous(), landmarks.to(Xq.dtype).contiguous()
    nq, p = Xq.shape
    m, d = coef.shape

    def run(blocks):
        return K_.matfree_apply(Xc, Lc, coef32, kernel=kernel, bandwidth=bandwidth,
                                nu=nu, bm=blocks[0])

    fb = (K_.matfree_rows(nq),)
    blocks = autotune.measured_blocks(
        "matfree_cols", (nq, p, d, m, kernel), Xq.dtype, Xq.device,
        _rows_candidates(MATFREE_ROWS, nq, fb), run, fb,
        concrete=autotune.is_concrete(Xc, Lc, coef32), source=K_.source_hash())
    return run(blocks)


@routed
def sketch_left_kernel(sk: AccumSketch, M: torch.Tensor) -> torch.Tensor:
    """Sᵀ M (d, c) through the left-apply kernel.  Returns float32."""
    coef32 = sk.coef.float().contiguous()
    if _on_cuda(M):
        return K_.accum_apply_left(M.contiguous(), sk.indices.contiguous(),
                                   coef32)
    return ref.sketch_left_ref(sk.indices, coef32, M)


@routed
def sketch_both_kernel(K: torch.Tensor, sk: AccumSketch
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, W) = (K S, SᵀK S) for square K (n, n); W folds from the float32
    C.  Returns (C in K's dtype, W float32)."""
    n, n2 = K.shape
    if n != n2:
        raise ValueError(f"sketch_both_kernel expects square K, got {tuple(K.shape)}")
    coef32 = sk.coef.float().contiguous()
    if not _on_cuda(K):
        return ref.sketch_both_ref(K, sk.indices, coef32)
    Kc, idx = K.contiguous(), sk.indices.contiguous()

    def run(blocks):
        return K_.accum_sketch_both(Kc, idx, coef32, bm=blocks[0])

    fb = autotune_both_blocks(n, K.device, sk.d, sk.m, K.dtype)
    blocks = autotune.measured_blocks(
        "sketch_both", (n, sk.d, sk.m), K.dtype, K.device,
        _gemm_candidates(n, fb), run, fb,
        concrete=autotune.is_concrete(Kc, idx, coef32), source=K_.source_hash())
    return run(blocks)


def _apply_right(K: torch.Tensor, idx: torch.Tensor, coef32: torch.Tensor,
                 blocks: tuple[int]) -> torch.Tensor:
    return K_.accum_apply(K.contiguous(), idx.to(torch.int32).contiguous(),
                          coef32, bm=blocks[0])


@routed
def sketch_right_kernel(K: torch.Tensor, sk: AccumSketch) -> torch.Tensor:
    """K S (R, d) for rectangular K (R, N), summed in float32 and returned in
    K's dtype.  One launch for any N (the CUDA gather has no VMEM bound, so
    the reference's chunk scan over N has no counterpart), measured at any
    N."""
    coef32 = sk.coef.float().contiguous()
    if not _on_cuda(K):
        return ref.accum_apply_ref(K, sk.indices, coef32)
    Kc, idx = K.contiguous(), sk.indices.to(torch.int32).contiguous()
    R, N = K.shape
    m, d = idx.shape
    fb = autotune_blocks(R, N, d, m, K.dtype, K.device)
    blocks = autotune.measured_blocks(
        "accum_apply", (R, N, d, m), K.dtype, K.device, _gemm_candidates(R, fb),
        lambda c: _apply_right(Kc, idx, coef32, c), fb,
        concrete=autotune.is_concrete(Kc, idx, coef32), source=K_.source_hash())
    return _apply_right(Kc, idx, coef32, blocks)


@routed
def accum_apply_scalar(K: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor,
                       *, bm: int = 256, bd: int = 8) -> torch.Tensor:
    """K S (R, d) by the seed's scalar per-column gather loop, the naive
    baseline of ``sketch_right_kernel``: no autotune, no padding — (bm, bd)
    clipped to (R, d) must divide them (``ValueError`` otherwise, where the
    reference asserts).  Returns K's dtype, summed in float32."""
    K_.scalar_blocks(K.shape[0], idx.shape[1], bm, bd)
    coef32 = coef.float().contiguous()
    if _on_cuda(K):
        return K_.accum_apply_scalar(K.contiguous(), idx.to(torch.int32).contiguous(),
                                     coef32, bm=bm, bd=bd)
    return ref.accum_apply_ref(K, idx, coef32)


@routed
def sketch_step_kernel(K: torch.Tensor, idx_row: torch.Tensor,
                       coef_row: torch.Tensor, C: torch.Tensor,
                       a: float) -> torch.Tensor:
    """The single-slab step a·C + K·T̃ for the slab idx_row/coef_row (d,);
    C (R, d) float32.

    The reference's two routes are kept: K of at most ``MAX_COLS`` columns
    takes one ``accum_step_slab`` launch; wider K forms G = K·T̃ in K's dtype
    through the right apply and adds a·C outside the kernel, so that a
    bfloat16 K rounds G where the reference does (repro ops.py:236-245).
    Either route takes its geometry from the table at m = 1, never
    measuring, as the reference's does."""
    coef32 = coef_row.float()[None, :].contiguous()
    idx = idx_row.to(torch.int32)[None, :].contiguous()
    R, N = K.shape
    if not _on_cuda(K):
        if N > MAX_COLS:
            return a * C + ref.accum_apply_ref(K, idx, coef32).to(C.dtype)
        return ref.accum_step_ref(K, idx, coef32, C, a)
    blocks = autotune_blocks(R, N, idx.shape[1], 1, K.dtype, K.device)
    if N > MAX_COLS:
        return a * C + _apply_right(K, idx, coef32, blocks).to(C.dtype)
    return K_.accum_step_slab(K.contiguous(), idx, coef32, C.contiguous(), a,
                              bm=blocks[0])


@routed
def accum_grow_kernel(K: torch.Tensor, idx_blk: torch.Tensor,
                      coef_blk: torch.Tensor, C: torch.Tensor, a: float, *,
                      out: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The batched step for the B-slab block idx_blk/coef_blk (B, d):
    ``(C_new, TᵀG, TᵀC)`` with C_new = a·C + K·T, all float32, from one
    sweep over K.  ``out`` receives C_new and may be ``C`` itself; measured
    candidates write scratch outputs, and only the winner's run writes
    ``out``."""
    coef32 = coef_blk.float().contiguous()
    idx = idx_blk.to(torch.int32).contiguous()
    if not _on_cuda(K):
        C_new, TtG, TtC = ref.accum_grow_ref(K, idx, coef32, C, a)
        return (C_new if out is None else out.copy_(C_new)), TtG, TtC
    Kc, Cc = K.contiguous(), C.contiguous()
    R, N = K.shape
    B, d = idx.shape
    fb = autotune.STATIC_TABLE["accum_grow"]
    blocks = autotune.measured_blocks(
        "accum_grow", (R, N, d, B), K.dtype, K.device,
        _gemm_candidates(R, fb),
        lambda c: K_.accum_grow_slabs(Kc, idx, coef32, Cc, a, bm=c[0]), fb,
        concrete=autotune.is_concrete(Kc, idx, coef32, Cc), source=K_.source_hash())
    return K_.accum_grow_slabs(Kc, idx, coef32, Cc, a, out=out, bm=blocks[0])
