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
