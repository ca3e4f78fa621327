"""Plain PyTorch versions of the landmark-attention kernels — the CPU route
of every wrapper in ``ops`` and the oracle the CUDA kernels are held
against.  Leading axes batch independent problems."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _scale(Dh: int) -> torch.Tensor:
    """1/√Dh in float32, as the reference computes it."""
    return 1.0 / torch.sqrt(torch.tensor(Dh, dtype=torch.float32))


def landmark_attention_ref(q: torch.Tensor, kt: torch.Tensor, M: torch.Tensor,
                           bias: torch.Tensor | None = None, *, lse: bool = False):
    """softmax(q k̃ᵀ/√Dh + bias)·M: q (..., S, Dh); kt (..., L, Dh);
    M (..., L, Dv); bias (..., L) or None.  Returns (..., S, Dv) in q's
    dtype, computed in float32; with ``lse`` also each row's log-sum-exp of
    its logits, (..., S) float32."""
    scale = _scale(q.shape[-1]).to(q.device)
    logits = q.float() @ kt.float().transpose(-1, -2) * scale
    if bias is not None:
        logits = logits + bias.float()[..., None, :]
    p = torch.softmax(logits, dim=-1)
    out = (p @ M.float()).to(q.dtype)
    return (out, torch.logsumexp(logits, dim=-1)) if lse else out


def landmark_stats_ref(qt: torch.Tensor, kt: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, *, n_valid: int | None = None,
                       l_valid: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, Bm·V) of the fused sweep: qt, kt (..., L, Dh); k (..., S, Dh);
    v (..., S, Dv) → (softmax(q̃k̃ᵀ/√Dh) (..., L, L), softmax(q̃Kᵀ/√Dh)·V
    (..., L, Dv)), both float32.  Landmark columns ≥ ``l_valid`` and keys
    ≥ ``n_valid`` take the logit −1e30, as in the kernel (LA:105, LA:119)."""
    scale = _scale(qt.shape[-1]).to(qt.device)
    qf = qt.float()
    wl = qf @ kt.float().transpose(-1, -2) * scale
    if l_valid is not None:
        wl[..., l_valid:] = NEG_INF
    bl = qf @ k.float().transpose(-1, -2) * scale
    if n_valid is not None:
        bl[..., n_valid:] = NEG_INF
    return torch.softmax(wl, dim=-1), torch.softmax(bl, dim=-1) @ v.float()
