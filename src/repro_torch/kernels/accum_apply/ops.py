"""Shape-agnostic entry points for the accum_apply kernels.

Each wrapper chooses by device alone: a tensor on the CPU takes the kernel's
plain PyTorch version (``ref``), a tensor on a CUDA device launches the CUDA
kernel (``kernel``), whose failures propagate.  Arbitrary shapes are taken
as they are — the CUDA kernels mask their own ragged edges, so nothing is
padded — and inputs are made contiguous, with the coefficients in float32.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_math import get_kernel
from repro_torch.core.sketch import AccumSketch
from repro_torch.kernels.accum_apply import kernel as K_
from repro_torch.kernels.accum_apply import ref

# the reference's per-chunk column count (repro ops.py:49): the single-slab
# step takes the right-apply route above it, as the reference does
MAX_COLS = 8192


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def matfree_cols_kernel(Xq: torch.Tensor, landmarks: torch.Tensor,
                        coef: torch.Tensor, *, kernel: str,
                        bandwidth: float = 1.0,
                        nu: float = 1.5) -> torch.Tensor:
    """C = K(Xq, landmarks)·S straight from data rows, no n×n object.

    Xq: (nq, p) query rows; landmarks: (m·d, p) sampled rows X[sk.indices];
    coef: (m, d).  Returns (nq, d) float32.  The plain version evaluates the
    kernel on float32 copies, as the CUDA kernel does."""
    coef32 = coef.float().contiguous()
    if _on_cuda(Xq):
        return K_.matfree_apply(Xq.contiguous(),
                                landmarks.to(Xq.dtype).contiguous(), coef32,
                                kernel=kernel, bandwidth=bandwidth, nu=nu)
    kf = get_kernel(kernel, bandwidth, nu)
    return ref.landmark_cols_ref(Xq.float(), landmarks.float(), coef32, kf)


def sketch_left_kernel(sk: AccumSketch, M: torch.Tensor) -> torch.Tensor:
    """Sᵀ M (d, c) through the left-apply kernel.  Returns float32."""
    coef32 = sk.coef.float().contiguous()
    if _on_cuda(M):
        return K_.accum_apply_left(M.contiguous(), sk.indices.contiguous(),
                                   coef32)
    return ref.sketch_left_ref(sk.indices, coef32, M)


def sketch_both_kernel(K: torch.Tensor, sk: AccumSketch
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, W) = (K S, SᵀK S) for square K (n, n); W folds from the float32
    C.  Returns (C in K's dtype, W float32)."""
    n, n2 = K.shape
    if n != n2:
        raise ValueError(f"sketch_both_kernel expects square K, got {tuple(K.shape)}")
    coef32 = sk.coef.float().contiguous()
    if _on_cuda(K):
        return K_.accum_sketch_both(K.contiguous(), sk.indices.contiguous(),
                                    coef32)
    return ref.sketch_both_ref(K, sk.indices, coef32)


def _apply_right(K: torch.Tensor, idx: torch.Tensor,
                 coef32: torch.Tensor) -> torch.Tensor:
    if _on_cuda(K):
        return K_.accum_apply(K.contiguous(), idx.to(torch.int32).contiguous(),
                              coef32)
    return ref.accum_apply_ref(K, idx, coef32)


def sketch_right_kernel(K: torch.Tensor, sk: AccumSketch) -> torch.Tensor:
    """K S (R, d) for rectangular K (R, N), summed in float32 and returned in
    K's dtype.  One launch for any N."""
    return _apply_right(K, sk.indices, sk.coef.float().contiguous())


def sketch_step_kernel(K: torch.Tensor, idx_row: torch.Tensor,
                       coef_row: torch.Tensor, C: torch.Tensor,
                       a: float) -> torch.Tensor:
    """The single-slab step a·C + K·T̃ for the slab idx_row/coef_row (d,);
    C (R, d) float32.

    The reference's two routes are kept: K of at most ``MAX_COLS`` columns
    takes one ``accum_step_slab`` launch; wider K forms G = K·T̃ in K's dtype
    through the right apply and adds a·C outside the kernel, so that a
    bfloat16 K rounds G where the reference does (repro ops.py:236-245)."""
    coef32 = coef_row.float()[None, :].contiguous()
    idx = idx_row.to(torch.int32)[None, :].contiguous()
    if K.shape[1] > MAX_COLS:
        return a * C + _apply_right(K, idx, coef32).to(C.dtype)
    if _on_cuda(K):
        return K_.accum_step_slab(K.contiguous(), idx, coef32, C.contiguous(), a)
    return ref.accum_step_ref(K, idx, coef32, C, a)


def accum_grow_kernel(K: torch.Tensor, idx_blk: torch.Tensor,
                      coef_blk: torch.Tensor, C: torch.Tensor, a: float, *,
                      out: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The batched step for the B-slab block idx_blk/coef_blk (B, d):
    ``(C_new, TᵀG, TᵀC)`` with C_new = a·C + K·T, all float32, from one
    sweep over K.  ``out`` receives C_new and may be ``C`` itself."""
    coef32 = coef_blk.float().contiguous()
    idx = idx_blk.to(torch.int32).contiguous()
    if _on_cuda(K):
        return K_.accum_grow_slabs(K.contiguous(), idx, coef32, C.contiguous(),
                                   a, out=out)
    C_new, TtG, TtC = ref.accum_grow_ref(K, idx, coef32, C, a)
    return (C_new if out is None else out.copy_(C_new)), TtG, TtC
