"""Attention blocks: GQA + RoPE, chunked-causal prefill, sliding window,
exact KV-cache decode, and the AccumSketch (paper technique) compressed
decode (ported from ``repro.models.attention``)."""
from __future__ import annotations

import math
from typing import NamedTuple

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
    distribute_like,
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
    query chunk at a time so peak memory is O(B·H·q_chunk·S).  A chunk of
    positions [s0, s1) reads keys [0, s1) only (with the window, [s0 −
    window + 1, s1)): the reference masks the others, and they carry
    exactly zero weight there.  The last chunk may be shorter than the
    others."""
    S, Dh = q.shape[1], q.shape[-1]
    scale = softmax_scale(Dh)
    qc = S // max(S // q_chunk, 1)
    outs = []
    for s0 in range(0, S, qc):
        s1 = min(S, s0 + qc)
        k0 = 0 if window is None else max(0, s0 - window + 1)
        qpos = torch.arange(s0, s1, device=q.device)
        kpos = torch.arange(k0, s1, device=q.device)
        qblk = q[:, s0:s1].float()
        kf, vf = k[:, k0:s1].float(), v[:, k0:s1].float()
        logits = torch.einsum("bqhgd,bshd->bhgqs", qblk, kf) * scale
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > (qpos[:, None] - window)
        logits = torch.where(mask, logits, NEG_INF)
        o = torch.einsum("bhgqs,bshd->bqhgd", torch.softmax(logits, dim=-1), vf)
        outs.append(o.to(out_dtype))
    return torch.cat(outs, dim=1)


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
    iff s ≤ pos; only those slots are read (the rest carry zero weight)."""
    B = h_t.shape[0]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Hkv
    if write_pos is None:
        write_pos = pos
    q, k, v = _qkv(p, h_t, cfg, sin_t, cos_t)                       # (B,1,·,Dh)
    if is_dtensor(cache.k):
        _write_shards(cache.k, 0, [write_pos], k.to(cache.k.dtype))
        _write_shards(cache.v, 0, [write_pos], v.to(cache.v.dtype))
    else:
        cache.k[:, write_pos] = k[:, 0].to(cache.k.dtype)
        cache.v[:, write_pos] = v[:, 0].to(cache.v.dtype)
    n = min(pos + 1, cache.k.shape[1])
    scale = softmax_scale(Dh)
    qg = _reshape_aligned(q, 2, Hkv, (B, Hkv, G, Dh)).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, cache.k[:, :n].float()) * scale
    o = torch.einsum("bhgs,bshd->bhgd", torch.softmax(logits, dim=-1),
                     cache.v[:, :n].float())
    out = _reshape_aligned(o, 1, Hkv, (B, 1, H * Dh)).to(h_t.dtype) @ p["wo"]
    return out, cache


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
    slot_table: (L, m_r).  Returns (out (B, L, D), cache)."""
    B, L, _ = h.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(p, h, cfg, sin, cos)

    def attend(q, k, v, cache):
        return sketch_prefill_attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                     cache, slot_table, chunk=chunk)

    o, cache = _on_sketch_cache(attend, q, k, v, cache)
    out = o.transpose(1, 2).reshape(B, L, H * Dh).to(h.dtype) @ p["wo"]
    return out, cache


def attn_decode_sketched(p, h_t: torch.Tensor, cache: SketchCache, cfg: ModelConfig,
                         sin_t, cos_t, slots) -> tuple[torch.Tensor, SketchCache]:
    """One-token decode over the compressed cache: O(d_slots) per token and
    O(d_slots·Dh) memory regardless of context length."""
    B = h_t.shape[0]
    H, Dh = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(p, h_t, cfg, sin_t, cos_t)

    def attend(q, k, v, cache):
        cache = update_sketch_cache(cache, k[:, 0], v[:, 0], slots)
        return sketch_decode_attend(q[:, 0].reshape(B, H, Dh), cache), cache

    o, cache = _on_sketch_cache(attend, q, k, v, cache)
    out = o.reshape(B, 1, H * Dh).to(h_t.dtype) @ p["wo"]
    return out, cache


def _on_sketch_cache(attend, q, k, v, cache: SketchCache) -> tuple[torch.Tensor, SketchCache]:
    """``attend(q, k, v, cache) → (o, new cache)``, the sketched cache's fold
    and attention; on a mesh (DTensors) q, k, v and the compressed cache are
    gathered whole on every rank and the step computed on them as on one
    device (the kernel on a card), the attention's output a replicated
    DTensor and each rank keeping its own shard of the new cache, placed as
    the old one.  The cache is O(d_slots) a layer, and its slots and heads
    may be split over ranks off a KV group's boundary, where DTensor's index
    and reshape rules refuse or misplace the shards; the gather moves what
    the kernel reads.  Every rank computes the whole step: its products
    are the reference's per-partition share times the ranks that split the
    cache."""
    if not is_dtensor(cache.k_sum):
        return attend(q, k, v, cache)
    from torch.distributed.tensor import Replicate

    dm = cache.k_sum.device_mesh
    rep = [Replicate()] * dm.ndim

    def whole(x):
        return x.redistribute(dm, rep).to_local() if is_dtensor(x) else x

    o, new = attend(whole(q), whole(k), whole(v), SketchCache(*map(whole, cache)))
    return (from_local(o, dm, rep, o.shape),
            SketchCache(*(distribute_like(n, like) for n, like in zip(new, cache))))
