"""Attention blocks: GQA + RoPE, chunked-causal prefill, sliding window,
exact KV-cache decode, and the AccumSketch (paper technique) compressed
decode (ported from ``repro.models.attention``)."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._util import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sketched_attention import (
    SketchCache,
    init_sketch_cache,
    sketch_decode_attend,
    sketch_prefill_attend,
    softmax_scale,
    update_sketch_cache,
)
from repro_torch.models.common import PARAM_DTYPE, apply_rope, dense_init
from repro_torch.sharding import (
    constrain,
    from_local,
    is_dtensor,
    local_box,
    pin_grad,
)

NEG_INF = -1e30


def init_attn(generator: torch.Generator, cfg: ModelConfig, dtype=PARAM_DTYPE) -> dict:
    """q/k/v/o projections drawn from ``generator``; norm (and biases) float32."""
    H, Hkv, Dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    dev = generator.device
    p = {
        "wq": dense_init(generator, (D, H * Dh), dtype=dtype),
        "wk": dense_init(generator, (D, Hkv * Dh), dtype=dtype),
        "wv": dense_init(generator, (D, Hkv * Dh), dtype=dtype),
        "wo": dense_init(generator, (H * Dh, D), dtype=dtype),
        "norm": torch.zeros((D,), dtype=torch.float32, device=dev),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * Dh), ("bk", Hkv * Dh), ("bv", Hkv * Dh)):
            p[name] = torch.zeros((width,), dtype=torch.float32, device=dev)
    return p


def _qkv(p, h, cfg: ModelConfig, sin, cos):
    B, S, _ = h.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = apply_rope(_split_heads(q, H, Dh), sin, cos)
    k = apply_rope(_split_heads(k, Hkv, Dh), sin, cos)
    return q, k, _split_heads(v, Hkv, Dh)


def _split_heads(x: torch.Tensor, n: int, Dh: int) -> torch.Tensor:
    """(B, S, n·Dh) → (B, S, n, Dh)."""
    return _reshape_aligned(x, 2, n, (*x.shape[:2], n, Dh))


def _reshape_aligned(x: torch.Tensor, dim: int, n: int, shape) -> torch.Tensor:
    """``x.reshape(shape)``, where the reshape splits or merges ``dim`` in
    ``n`` equal groups.  A DTensor whose ``dim`` is split over ranks off the
    group boundaries (the model axis does not divide n) is gathered across
    those ranks first, where GSPMD would reshard it too: DTensor refuses to
    reshape such a split.  The result's gradient is pinned to the result's
    layout (``sharding.pin_grad``), so that the backward gathers an incoming
    gradient split so before undoing the reshape."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(x):
        return x.reshape(shape)
    dm = x.device_mesh
    ways = math.prod(k for k, pl in zip(dm.mesh.shape, x.placements) if pl == Shard(dim))
    if n % ways:
        x = x.redistribute(dm, [Replicate() if pl == Shard(dim) else pl for pl in x.placements])
    return pin_grad(x.reshape(shape))


def _chunked_causal(q, k, v, cfg: ModelConfig, *, window: int | None, q_chunk: int,
                    out_dtype) -> torch.Tensor:
    """Chunked-causal attention core shared by ``attn_forward`` and
    ``attn_prefill``: q (B, S, H, Dh), k/v (B, S, Hkv, Dh) → (B, S, H·Dh)
    before the output projection (``_causal_core``).

    Under a mesh q, k and v are pinned head-aligned: the batch on the data
    axes, the KV heads on the model axis (unevenly if it doesn't divide, see
    sharding.constrain), so the QKᵀ/AV contractions stay shard-local.  Each
    (batch row, KV head) attends on its own, so the core then runs on each
    rank's shards, as the reference's einsums run shard-local under the
    same constraints."""
    B, S = q.shape[:2]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Hkv
    pol = cfg.sharding_policy
    head_tp = "tp!" if cfg.attn_head_tp else None
    k = constrain(k, "dp", None, head_tp, None, policy=pol)
    v = constrain(v, "dp", None, head_tp, None, policy=pol)
    q = constrain(_reshape_aligned(q, 2, Hkv, (B, S, Hkv, G, Dh)), "dp", None, head_tp, None,
                  None, policy=pol)
    if not is_dtensor(q):
        return _causal_core(q, k, v, window, q_chunk, out_dtype).reshape(B, S, H * Dh)
    out = _causal_core(q.to_local(), k.to_local(), v.to_local(), window, q_chunk, out_dtype)
    out = from_local(out, q.device_mesh, q.placements, q.shape)
    return _reshape_aligned(out, 2, Hkv, (B, S, H * Dh))


def _causal_core(q, k, v, window: int | None, q_chunk: int, out_dtype) -> torch.Tensor:
    """q (B, S, Hkv, G, Dh), k/v (B, S, Hkv, Dh) → (B, S, Hkv, G, Dh), one
    query chunk at a time (``_CausalChunk``) so peak memory is
    O(B·H·q_chunk·S), in the backward too.  A chunk of positions [s0, s1)
    reads keys [0, s1) only (with the window, [s0 − window + 1, s1)): the
    reference masks the others, and they carry exactly zero weight there.
    The last chunk may be shorter than the others."""
    S = q.shape[1]
    scale = softmax_scale(q.shape[-1])
    qc = S // max(S // q_chunk, 1)
    outs = []
    for s0 in range(0, S, qc):
        s1 = min(S, s0 + qc)
        k0 = 0 if window is None else max(0, s0 - window + 1)
        outs.append(_CausalChunk.apply(q[:, s0:s1], k[:, k0:s1], v[:, k0:s1], s0, k0,
                                       window, scale, out_dtype))
    return torch.cat(outs, dim=1)


def _chunk_probs(q, k, s0: int, k0: int, window: int | None, scale: float) -> torch.Tensor:
    """softmax(q kᵀ·scale) of the query chunk at s0 over the keys from k0,
    causal (and windowed), float32: q (B, c, Hkv, G, Dh), k (B, n, Hkv, Dh)
    → (B, Hkv, G, c, n)."""
    qpos = torch.arange(s0, s0 + q.shape[1], device=q.device)
    kpos = torch.arange(k0, k0 + k.shape[1], device=q.device)
    # out of place: remat="dots" caches the product's result for the recompute
    logits = torch.einsum("bqhgd,bshd->bhgqs", q.float(), k.float()) * scale
    mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    return torch.softmax(logits.masked_fill_(~mask, NEG_INF), dim=-1)


class _CausalChunk(torch.autograd.Function):
    """One query chunk of causal attention, o = softmax(q kᵀ·scale + mask)·v,
    with the reference's memory plan: its chunk body is a ``jax.checkpoint``
    (``repro.models.attention``), so no chunk's scores outlive its forward.
    The forward keeps q's chunk, k and v (views: no new storage) and the
    chunk's output; the backward recomputes the chunk's softmax P and forms
    dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P ⊙ (dP − rowsum(dO ⊙ O)), dQ = dS·K·scale
    and dK = dSᵀ·Q·scale, holding one chunk's scores at a time.  It does not
    rerun the value product, as ``torch.utils.checkpoint`` of the chunk
    would.  Products in float32; the gradients in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, s0, k0, window, scale, out_dtype):
        p = _chunk_probs(q, k, s0, k0, window, scale)
        o = torch.einsum("bhgqs,bshd->bqhgd", p, v.float()).to(out_dtype)
        ctx.save_for_backward(q, k, v, o)
        ctx.chunk = (s0, k0, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        s0, k0, window, scale = ctx.chunk
        p = _chunk_probs(q, k, s0, k0, window, scale)
        dof = do.float()
        dv = torch.einsum("bhgqs,bqhgd->bshd", p, dof)
        rowsum = torch.sum(dof * o.float(), dim=-1).permute(0, 2, 3, 1)   # (B, Hkv, G, c)
        ds = torch.einsum("bqhgd,bshd->bhgqs", dof, v.float())
        ds.sub_(rowsum[..., None]).mul_(p)
        del p
        dq = torch.einsum("bhgqs,bshd->bqhgd", ds, k.float()).mul_(scale)
        dk = torch.einsum("bhgqs,bqhgd->bshd", ds, q.float()).mul_(scale)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None,
                None)


def attn_forward(p, h: torch.Tensor, cfg: ModelConfig, sin, cos, *,
                 window: int | None = None, q_chunk: int = 512) -> torch.Tensor:
    """Causal (optionally sliding-window) attention over query chunks."""
    q, k, v = _qkv(p, h, cfg, sin, cos)
    out = _chunked_causal(q, k, v, cfg, window=window, q_chunk=q_chunk,
                          out_dtype=h.dtype)
    return out @ p["wo"]


# --------------------------------------------------------------------------- #
# Decode: exact KV cache
# --------------------------------------------------------------------------- #

class KVCache(NamedTuple):
    """Exact decode cache of one layer: keys and values by position."""
    k: torch.Tensor  # (B, S_max, Hkv, Dh)
    v: torch.Tensor  # (B, S_max, Hkv, Dh)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
                  device="cuda") -> KVCache:
    """Zero exact cache of ``max_len`` positions."""
    device = resolve_device(device)
    shp = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shp, dtype=dtype, device=device),
                   torch.zeros(shp, dtype=dtype, device=device))


def attn_prefill(p, h: torch.Tensor, cache: KVCache, cfg: ModelConfig, sin, cos, *,
                 window: int | None = None, q_chunk: int = 512
                 ) -> tuple[torch.Tensor, KVCache]:
    """Batched exact-cache prefill: chunked-causal attention for all L prompt
    tokens (positions 0..L-1) plus one bulk cache write into a new cache.  A
    ring-buffer (sliding-window) cache keeps the last S_cache tokens at slot
    t % S_cache.  Returns (out (B, L, D), cache)."""
    L = h.shape[1]
    q, k, v = _qkv(p, h, cfg, sin, cos)
    out = _chunked_causal(q, k, v, cfg, window=window, q_chunk=q_chunk,
                          out_dtype=h.dtype) @ p["wo"]
    S_cache = cache.k.shape[1]
    kc, vc = k.to(cache.k.dtype), v.to(cache.v.dtype)
    nk, nv = cache.k.clone(), cache.v.clone()
    if is_dtensor(nk):
        t0 = max(0, L - S_cache)
        slots = [t % S_cache for t in range(t0, L)]
        _write_shards(nk, t0, slots, kc)
        _write_shards(nv, t0, slots, vc)
    elif L <= S_cache:
        nk[:, :L], nv[:, :L] = kc, vc
    else:
        ring = torch.arange(L - S_cache, L, device=h.device) % S_cache
        nk[:, ring], nv[:, ring] = kc[:, L - S_cache:], vc[:, L - S_cache:]
    return out, KVCache(nk, nv)


def _write_shards(cache_t: torch.Tensor, t0: int, slots: list, x: torch.Tensor) -> None:
    """``cache_t[:, slots[i]] = x[:, t0 + i]`` in place on a mesh: cache_t a
    (B, S, Hkv, Dh) DTensor, its positions split over ranks; x (B, L, Hkv,
    Dh) in its dtype; ``slots`` host ints.  Each rank writes the slots that
    its own shard holds, from x gathered whole.  DTensor's indexing of a
    split dimension writes into a gathered copy, and the shards would keep
    their old values."""
    from torch.distributed.tensor import Replicate

    dm = cache_t.device_mesh
    if is_dtensor(x):
        x = x.redistribute(dm, [Replicate()] * dm.ndim).to_local()
    (b0, b1), (s0, s1), (h0, h1), (d0, d1) = local_box(cache_t.shape, dm, cache_t.placements)
    mine = [i for i, s in enumerate(slots) if s0 <= s < s1]
    if not mine:
        return
    local = cache_t.to_local()
    src = torch.tensor([t0 + i for i in mine], device=local.device)
    dst = torch.tensor([slots[i] - s0 for i in mine], device=local.device)
    local[:, dst] = x[b0:b1, :, h0:h1, d0:d1].index_select(1, src)


def attn_decode(p, h_t: torch.Tensor, cache: KVCache, pos: int, cfg: ModelConfig,
                sin_t, cos_t, *, write_pos: int | None = None
                ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode.  h_t: (B, 1, D); pos: the current absolute index.

    The new key and value are written into the cache tensors IN PLACE at
    ``write_pos`` (default pos; a ring buffer passes pos % window), where
    the reference returns new arrays: at full width a copy of the cache per
    layer and token would move the whole cache every step.  Slot s is valid
    iff s ≤ pos; only those slots are read (the rest carry zero weight).
    On a mesh each rank attends over its own shard of the cache
    (``_on_kv_cache``)."""
    B = h_t.shape[0]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Hkv
    if write_pos is None:
        write_pos = pos
    q, k, v = _qkv(p, h_t, cfg, sin_t, cos_t)                       # (B,1,·,Dh)
    n = min(pos + 1, cache.k.shape[1])
    scale = softmax_scale(Dh)
    if is_dtensor(cache.k):
        _write_shards(cache.k, 0, [write_pos], k.to(cache.k.dtype))
        _write_shards(cache.v, 0, [write_pos], v.to(cache.v.dtype))
        o = _on_kv_cache(q, cache, n, scale)
    else:
        cache.k[:, write_pos] = k[:, 0].to(cache.k.dtype)
        cache.v[:, write_pos] = v[:, 0].to(cache.v.dtype)
        qg = _reshape_aligned(q, 2, Hkv, (B, Hkv, G, Dh)).float()
        logits = torch.einsum("bhgd,bshd->bhgs", qg, cache.k[:, :n].float()) * scale
        o = torch.einsum("bhgs,bshd->bhgd", torch.softmax(logits, dim=-1),
                         cache.v[:, :n].float())
    out = _reshape_aligned(o, 1, Hkv, (B, 1, H * Dh)).to(h_t.dtype) @ p["wo"]
    return out, cache


def _on_kv_cache(q: torch.Tensor, cache: KVCache, n: int, scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v over positions [0, n) of an exact cache on a
    mesh (DTensors), as the reference's partitioned decode computes it: q
    (B, 1, H, Dh) → o (B, Hkv, G, Dh) float32, a DTensor split by batch
    rows and KV heads as the cache is.  Each rank reads its own shard of
    the cache in place, its valid positions [lo, hi) ∩ [0, n) widened to
    float32, with q's rows and heads cut to the same (all G query heads of
    each local KV head).  Where the positions are split, each rank's
    softmax·V over its own positions is combined with the others' by their
    log-sum-exps (``lse_combine``); a rank with no valid position carries
    weight 0, as the reference's NEG_INF mask gives it.  A split of the
    head dim is gathered first."""
    from torch.distributed.tensor import Replicate, Shard

    dm = cache.k.device_mesh
    keep, (k, v), ((b0, b1), (s0, s1), (h0, h1), _) = _cache_shards(cache)
    B, Hkv, Dh = cache.k.shape[0], cache.k.shape[2], cache.k.shape[3]
    G = q.shape[2] // Hkv
    rows = [pl if pl == Shard(0) else Replicate() for pl in keep]
    ql = q.redistribute(dm, rows).to_local()
    qg = ql[:, 0, h0 * G:h1 * G].reshape(b1 - b0, h1 - h0, G, Dh).float()
    m = max(0, min(s1, n) - s0)
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k[:, :m].float()) * scale
    o = torch.einsum("bhgs,bshd->bhgd", torch.softmax(logits, dim=-1), v[:, :m].float())
    pos_dims = tuple(i for i, pl in enumerate(keep) if pl == Shard(1) and dm.mesh.shape[i] > 1)
    if pos_dims:
        o = lse_combine(o, torch.logsumexp(logits, dim=-1), dm, pos_dims)
    pls = [Shard(0) if pl == Shard(0) else Shard(1) if pl == Shard(2) else Replicate()
           for pl in keep]
    return from_local(o, dm, pls, (B, Hkv, G, Dh))


# --------------------------------------------------------------------------- #
# Decode: sketched (compressed) cache — the paper's technique in serving
# --------------------------------------------------------------------------- #

def init_attn_sketch_cache(cfg: ModelConfig, batch: int, dtype, *,
                           device="cuda") -> SketchCache:
    """Sketched attention cache sized from cfg (``dtype`` for k/v sums)."""
    return init_sketch_cache(batch, cfg.n_kv_heads, cfg.sketch_attn.d_slots,
                             cfg.head_dim, dtype, device=device)


def attn_prefill_sketched(p, h: torch.Tensor, cache: SketchCache, cfg: ModelConfig,
                          sin, cos, slot_table, *, chunk: int = 128
                          ) -> tuple[torch.Tensor, SketchCache]:
    """Batched sketched-cache prefill: the fold of all L tokens' (k, v) plus
    evolving-cache attention (position t sees the cache after its own
    token's update — the semantics of L sequential decode steps).
    slot_table: (L, m_r).  Returns (out (B, L, D), cache).  On a mesh each
    rank folds and attends for its own batch rows, KV heads and slots, the
    slot partials combined by their log-sum-exps (``_on_sketch_cache``), as
    the decode's."""
    B, L, _ = h.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(p, h, cfg, sin, cos)

    def attend(q, k, v, cache, shard):
        return sketch_prefill_attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                     cache, slot_table, chunk=chunk, shard=shard)

    o, cache = _on_sketch_cache(attend, q, k, v, cache)
    out = o.transpose(1, 2).reshape(B, L, H * Dh).to(h.dtype) @ p["wo"]
    return out, cache


def attn_decode_sketched(p, h_t: torch.Tensor, cache: SketchCache, cfg: ModelConfig,
                         sin_t, cos_t, slots) -> tuple[torch.Tensor, SketchCache]:
    """One-token decode over the compressed cache: O(d_slots) per token and
    O(d_slots·Dh) memory regardless of context length.  On a mesh each rank
    computes its share, as the reference's partitioned program does: its
    batch rows and KV heads, and of slots split over ranks its own, whose
    partial outputs the ranks combine by their log-sum-exps
    (``_on_sketch_cache``)."""
    B = h_t.shape[0]
    H, Dh = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(p, h_t, cfg, sin_t, cos_t)

    def attend(q, k, v, cache, shard):
        if shard is None:
            cache = update_sketch_cache(cache, k[:, 0], v[:, 0], slots)
            return sketch_decode_attend(q[:, 0], cache), cache
        cache = update_sketch_cache(cache, k[:, 0], v[:, 0], shard.local_slots(slots))
        o, lse = sketch_decode_attend(q[:, 0], cache, lse=True)
        return shard.combine(o, lse).to(q.dtype), cache

    o, cache = _on_sketch_cache(attend, q, k, v, cache)
    out = o.reshape(B, 1, H * Dh).to(h_t.dtype) @ p["wo"]
    return out, cache


class _SlotShard(NamedTuple):
    """This rank's slots [lo, hi) of a sketched cache whose slots are split
    over the mesh dims ``dims`` of ``device_mesh``."""
    lo: int
    hi: int
    device_mesh: object
    dims: tuple

    def local_slots(self, slots) -> np.ndarray:
        """A slot draw (m_r,) or table (L, m_r) in this shard's numbering:
        another shard's slots become the padding marker, which the fold
        drops, so each slot still takes its updates in (pick) order."""
        s = np.asarray(slots.cpu() if isinstance(slots, torch.Tensor) else slots, np.int64)
        return np.where((s >= self.lo) & (s < self.hi), s - self.lo, self.hi - self.lo)

    def combine(self, o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """The ranks' partials over their own slots joined (``lse_combine``)."""
        return lse_combine(o, lse, self.device_mesh, self.dims)


def _cache_shards(cache) -> tuple:
    """(placements, local shards, [lo, hi) of each dim of the first leaf)
    of this rank's share of a cache whose leaves are DTensors alike in their
    first three dims: each split of those dims kept where every leaf has
    it, any other split gathered first."""
    from torch.distributed.tensor import Replicate, Shard

    first = cache[0]
    dm = first.device_mesh
    keep = [pl if isinstance(pl, Shard) and pl.dim in (0, 1, 2)
            and all(x.placements[i] == pl for x in cache) else Replicate()
            for i, pl in enumerate(first.placements)]
    return (keep, [x.redistribute(dm, keep).to_local() for x in cache],
            local_box(first.shape, dm, keep))


def lse_combine(o: torch.Tensor, lse: torch.Tensor, device_mesh, dims) -> torch.Tensor:
    """Σ_r e^{lse_r − m} o_r / Σ_r e^{lse_r − m}, m = max_r lse_r, over the
    ranks of the mesh dims ``dims`` of ``device_mesh``, which split the
    keys (the exact cache's positions, the sketched cache's slots): o (…,
    Dh) this rank's softmax·V over its own keys, lse (…) its rows'
    log-sum-exps (float32).  A rank whose rows hold no key (lse −∞, o 0)
    adds nothing; some rank must hold one of each row's keys."""
    from torch.distributed import _functional_collectives as fc

    m = lse
    for d in dims:
        m = fc.all_reduce(m, "max", (device_mesh, d))
    w = torch.exp(lse - m)
    num, den = o * w[..., None], w
    for d in dims:
        num = fc.all_reduce(num, "sum", (device_mesh, d))
        den = fc.all_reduce(den, "sum", (device_mesh, d))
    return num / den[..., None]


def _on_sketch_cache(attend, q, k, v, cache: SketchCache) -> tuple[torch.Tensor, SketchCache]:
    """``attend(q, k, v, cache, shard) → (o, new cache)``, the sketched
    cache's fold and attention: q (B, L, H, Dh), k/v (B, L, Hkv, Dh), o
    (B, H, …).  Off a mesh it runs as it is (``shard`` None).  On a mesh
    (DTensors) it runs on this rank's share: the cache's local shards,
    split by batch rows, KV heads and slots (``shard`` a ``_SlotShard``
    where the slots are split), with q, k and v (one token's, or the
    prompt's) gathered and cut to the same rows and heads (all G query
    heads of each local KV head).  A split of any other dim, a size-1 mesh
    dim aside, is gathered first.  The output is a DTensor split by batch
    rows as the cache is, whole elsewhere; each rank keeps its own shard of
    the new cache, placed as the old one.  Each rank's products are the
    reference's per-partition share."""
    if not is_dtensor(cache.k_sum):
        return attend(q, k, v, cache, None)
    from torch.distributed.tensor import Replicate, Shard

    dm = cache.k_sum.device_mesh
    keep, local, ((b0, b1), (h0, h1), (s0, s1), _) = _cache_shards(cache)
    local = SketchCache(*local)
    slot_dims = tuple(i for i, pl in enumerate(keep)
                      if pl == Shard(2) and dm.mesh.shape[i] > 1)
    rep = [Replicate()] * dm.ndim
    G = q.shape[2] // k.shape[2]

    def mine(x, g):
        x = x.redistribute(dm, rep).to_local() if is_dtensor(x) else x
        return x[b0:b1, :, h0 * g:h1 * g]

    shard = _SlotShard(s0, s1, dm, slot_dims) if slot_dims else None
    o, new = attend(mine(q, G), mine(k, 1), mine(v, 1), local, shard)
    # the output: (B, Hkv, G, …) split by batch rows and KV heads, the heads
    # then gathered (a KV head split need not be a split of the H query heads)
    B, Hkv = cache.k_sum.shape[:2]
    pls = [pl if pl in (Shard(0), Shard(1)) else Replicate() for pl in keep]
    o = o.reshape(o.shape[0], h1 - h0, G, *o.shape[2:])
    o = from_local(o, dm, pls, (B, Hkv, G, *o.shape[3:]))
    o = o.redistribute(dm, [Replicate() if pl == Shard(1) else pl for pl in pls])
    o = o.reshape(B, Hkv * G, *o.shape[3:])
    return o, SketchCache(*(from_local(n, dm, keep, x.shape).redistribute(dm, x.placements)
                            for n, x in zip(new, cache)))
