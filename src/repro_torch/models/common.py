"""Shared model utilities: init, RMSNorm, RoPE, chunked cross-entropy
(ported from ``repro.models.common``)."""
from __future__ import annotations

import functools
import math

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.sharding import constrain, distribute_like, is_dtensor, reduce_partial

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
    """RMSNorm with a zero-centred weight, y·(1 + w), in float32, cast back.
    On a mesh, x split along its last dim (the Mamba-2 gate's heads), the
    mean of the squares is a partial sum, all-reduced as GSPMD reduces it:
    DTensor left to itself reduce-scatters it along the sequence, and the
    gradient that reaches the input projection then splits the sequence."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    if is_dtensor(var):
        var = reduce_partial(var)
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


class _XentChunk(torch.autograd.Function):
    """(masked cross-entropy sum, mask sum) of one chunk: h (B, c, D),
    labels and mask (B, c), W (V, D) float32.  The reference's chunk body is
    a ``jax.checkpoint`` whose backward XLA fuses into softmax − one-hot;
    so here the forward keeps h, the labels, the mask and the (B, c)
    log-sum-exp, not the (B, c, V) logits, and the backward recomputes the
    logits into one buffer and turns that buffer into the gradient in place
    (``torch.utils.checkpoint`` would rerun the forward under autograd and
    hold the logits, the log-sum-exp's and the gather's gradients and their
    sum at once)."""

    @staticmethod
    def forward(ctx, h, labels, mask, W):
        logits = _split_as(h.float(), labels) @ W.T
        lse = torch.logsumexp(logits, dim=-1)
        lab = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        ctx.save_for_backward(h, labels, mask, W, lse)
        return torch.sum((lse - lab) * mask), torch.sum(mask)

    @staticmethod
    def backward(ctx, g, _):
        h, labels, mask, W, lse = ctx.saved_tensors
        hf = _split_as(h.float(), labels)
        # G = (softmax(logits) − one-hot(labels)) · g · mask, in one buffer
        G = hf @ W.T
        G.sub_(lse[..., None]).exp_()
        _minus_one_at(G, labels[..., None].long())
        G.mul_((g * mask)[..., None])
        dh = torch.einsum("bcv,vd->bcd", G, W).to(h.dtype)
        dW = torch.einsum("bcv,bcd->vd", G, hf)
        if is_dtensor(dh) and dh.placements != h.placements:
            dh = dh.redistribute(h.device_mesh, h.placements)
        return dh, None, None, dW


def _split_as(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``x`` (a chunk's h) placed as the DTensor ``labels`` where the labels
    are split over more ranks.  Under "dp_only" the batch is split over
    every axis while h is split over the data axes alone: the chunk then
    runs on the rank's own rows, as the reference's does, instead of every
    "model" rank computing its data shard's logits whole.  Where the labels'
    split refines h's this is a local slice; else (the 2 × 16 × 16 mesh:
    h over ("pod", "data"), the labels over ("data", "model")) it moves the
    chunk's h, (B, c, D), not its (B, c, V) logits."""
    if not (is_dtensor(x) and is_dtensor(labels)) or labels.placements == x.placements:
        return x
    if _ways(labels) > _ways(x):
        return x.redistribute(x.device_mesh, labels.placements)
    return x


def _ways(x: torch.Tensor) -> int:
    """The ranks a DTensor's shards are spread over (its split mesh axes'
    sizes multiplied)."""
    return math.prod(n for n, pl in zip(x.device_mesh.mesh.shape, x.placements)
                     if pl.is_shard())


def _minus_one_at(G: torch.Tensor, idx: torch.Tensor) -> None:
    """``G[..., idx] −= 1`` in place along the last dim (idx (…, 1)).  A
    DTensor G (its last dim whole) is updated on this rank's shard, the
    labels placed as G first: DTensor takes no in-place scatter."""
    if is_dtensor(G):
        assert all(getattr(pl, "dim", None) != G.ndim - 1 for pl in G.placements)
        idx = (idx.redistribute(G.device_mesh, G.placements) if is_dtensor(idx)
               else distribute_like(idx, G))
        G, idx = G.to_local(), idx.to_local()
    G.scatter_add_(-1, idx, torch.full(idx.shape, -1.0, dtype=G.dtype, device=G.device))


def chunked_xent(h: torch.Tensor, emb_out: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None, chunk: int = 512
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over the positions where ``mask`` is 1, without
    holding the full (B, S, V) logits: h (B, S, D) final hidden states,
    emb_out (V, D) the output embedding (logits = h @ emb_out.T), labels
    (B, S) ints, mask (B, S) or None (every position counts).  Returns
    (loss, count).

    The sequence is cut into ``max(S // chunk, 1)`` equal chunks (a length
    they do not divide raises, as the reference's reshape does), each one
    ``_XentChunk``, so that its (B, c, V) logits are recomputed in the
    backward into one buffer instead of kept; the output embedding is cast
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
    emb_f = constrain(emb_out.float(), None, None)
    # DTensor may leave h a partial sum over the model axis (the output
    # projections contract a TP-sharded dim); the label gather needs it whole
    hc = constrain(hc, "dp", None, None, None)
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nchunk):
        ls, ct = _XentChunk.apply(hc[:, i], lc[:, i], mc[:, i], emb_f)
        loss_sum = loss_sum + ls
        count = count + ct
    return loss_sum / torch.clamp(count, min=1.0), count
