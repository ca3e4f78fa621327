"""Shared model utilities: init, RMSNorm, RoPE, chunked cross-entropy
(ported from ``repro.models.common``)."""
from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.checkpoint import checkpoint

PARAM_DTYPE = torch.bfloat16


def _trunc_normal(generator: torch.Generator, shape, std) -> torch.Tensor:
    """A float32 draw from N(0, 1) truncated to [−3, 3], times ``std``, on
    the generator's device.  A fake tensor (``FakeTensorMode``: the dry
    run's abstract parameters) has no values, so nothing is drawn into it:
    PyTorch's rejection sampler would read its acceptance mask back."""
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    if isinstance(w, FakeTensor):
        return w
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return w.mul_(std)


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=PARAM_DTYPE) -> torch.Tensor:
    """Truncated-normal fan-in init, drawn in float32 on the generator's
    device and cast to ``dtype``."""
    return _trunc_normal(generator, shape, _fan_in_std(int(shape[in_axis]))).to(dtype)


@functools.lru_cache(maxsize=None)
def _fan_in_std(n: int) -> float:
    """1/√n, the root taken by PyTorch's float32 CPU kernel (whose rounding
    is not always numpy's: 1 ulp apart at n = 267 on an AVX-512 host), on
    a plain host tensor with every dispatch mode and tensor subclass out of
    the way, so that the init also runs under ``FakeTensorMode``
    (``launch.specs.params_abstract``) and reads no fake value back."""
    with torch._C._DisableTorchDispatch():
        return 1.0 / torch.sqrt(torch.tensor(n, dtype=torch.float32)).item()


def embed_init(generator: torch.Generator, shape, dtype=PARAM_DTYPE) -> torch.Tensor:
    """Truncated-normal embedding init with std 0.02."""
    return _trunc_normal(generator, shape, 0.02).to(dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with a zero-centred weight, y·(1 + w), in float32, cast back."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(P,) int positions → (P, head_dim/2) sin/cos tables (float32)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions.float()[:, None] * freqs[None, :]
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., P, H, Dh); sin/cos: (P, Dh/2).  In float32, cast back."""
    half = x.shape[-1] // 2
    s = sin[..., :, None, :]   # broadcast over the head axis
    c = cos[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)


def _xent_chunk(h: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                W: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(masked cross-entropy sum, mask sum) of one chunk: h (B, c, D),
    labels and mask (B, c), W (V, D) float32."""
    logits = h.float() @ W.T
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum((lse - lab) * mask), torch.sum(mask)


def chunked_xent(h: torch.Tensor, emb_out: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None, chunk: int = 512
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over the positions where ``mask`` is 1, without
    holding the full (B, S, V) logits: h (B, S, D) final hidden states,
    emb_out (V, D) the output embedding (logits = h @ emb_out.T), labels
    (B, S) ints, mask (B, S) or None (every position counts).  Returns
    (loss, count).

    The sequence is cut into ``max(S // chunk, 1)`` equal chunks (a length
    they do not divide raises, as the reference's reshape does), each run
    under ``torch.utils.checkpoint`` so that its (B, c, V) logits are
    recomputed in the backward instead of kept; the output embedding is cast
    to float32 once, outside the chunks (and, under a mesh, gathered whole
    once there, so that no chunk re-gathers it)."""
    B, S, D = h.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    nchunk = max(S // chunk, 1)
    chunk = S // nchunk
    hc = h.reshape(B, nchunk, chunk, D)
    lc = labels.reshape(B, nchunk, chunk)
    mc = mask.reshape(B, nchunk, chunk)
    # late import: the models and sharding import each other's modules
    from repro_torch.sharding import constrain
    emb_f = constrain(emb_out.float(), None, None)
    # DTensor may leave h a partial sum over the model axis (the output
    # projections contract a TP-sharded dim); the label gather needs it whole
    hc = constrain(hc, "dp", None, None, None)
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nchunk):
        ls, ct = checkpoint(_xent_chunk, hc[:, i], lc[:, i], mc[:, i], emb_f,
                            use_reentrant=False)
        loss_sum = loss_sum + ls
        count = count + ct
    return loss_sum / torch.clamp(count, min=1.0), count
