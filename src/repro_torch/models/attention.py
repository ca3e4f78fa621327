"""Attention blocks: GQA + RoPE, chunked-causal prefill, sliding window,
exact KV-cache decode, and the AccumSketch (paper technique) compressed
decode (ported from ``repro.models.attention``; the reference's sharding
constraints drop out: the data mesh is ROADMAP queue 1, item 16)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._util import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sketched_attention import (
    SketchCache,
    init_sketch_cache,
    sketch_decode_attend,
    sketch_prefill_attend,
    update_sketch_cache,
)
from repro_torch.models.common import PARAM_DTYPE, apply_rope, dense_init

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
    q = apply_rope(q.reshape(B, S, H, Dh), sin, cos)
    k = apply_rope(k.reshape(B, S, Hkv, Dh), sin, cos)
    return q, k, v.reshape(B, S, Hkv, Dh)


def _chunked_causal(q, k, v, cfg: ModelConfig, *, window: int | None, q_chunk: int,
                    out_dtype) -> torch.Tensor:
    """Chunked-causal attention core shared by ``attn_forward`` and
    ``attn_prefill``: q (B, S, H, Dh), k/v (B, S, Hkv, Dh) → (B, S, H·Dh)
    before the output projection, one query chunk at a time so peak memory
    is O(B·H·q_chunk·S).  A chunk of positions [s0, s1) reads keys [0, s1)
    only (with the window, [s0 − window + 1, s1)): the reference masks the
    others, and they carry exactly zero weight there.  The last chunk may
    be shorter than the others."""
    B, S = q.shape[:2]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Hkv
    scale = 1.0 / torch.sqrt(torch.tensor(Dh, dtype=torch.float32)).to(q.device)
    qc = S // max(S // q_chunk, 1)
    outs = []
    for s0 in range(0, S, qc):
        s1 = min(S, s0 + qc)
        k0 = 0 if window is None else max(0, s0 - window + 1)
        qpos = torch.arange(s0, s1, device=q.device)
        kpos = torch.arange(k0, s1, device=q.device)
        qblk = q[:, s0:s1].reshape(B, s1 - s0, Hkv, G, Dh).float()
        kf, vf = k[:, k0:s1].float(), v[:, k0:s1].float()
        logits = torch.einsum("bqhgd,bshd->bhgqs", qblk, kf) * scale
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > (qpos[:, None] - window)
        logits = torch.where(mask, logits, NEG_INF)
        o = torch.einsum("bhgqs,bshd->bqhgd", torch.softmax(logits, dim=-1), vf)
        outs.append(o.to(out_dtype).reshape(B, s1 - s0, H * Dh))
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
    if L <= S_cache:
        nk[:, :L], nv[:, :L] = kc, vc
    else:
        ring = torch.arange(L - S_cache, L, device=h.device) % S_cache
        nk[:, ring], nv[:, ring] = kc[:, L - S_cache:], vc[:, L - S_cache:]
    return out, KVCache(nk, nv)


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
    cache.k[:, write_pos] = k[:, 0].to(cache.k.dtype)
    cache.v[:, write_pos] = v[:, 0].to(cache.v.dtype)
    n = min(pos + 1, cache.k.shape[1])
    scale = 1.0 / torch.sqrt(torch.tensor(Dh, dtype=torch.float32)).to(h_t.device)
    qg = q.reshape(B, Hkv, G, Dh).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, cache.k[:, :n].float()) * scale
    o = torch.einsum("bhgs,bshd->bhgd", torch.softmax(logits, dim=-1),
                     cache.v[:, :n].float())
    out = o.reshape(B, 1, H * Dh).to(h_t.dtype) @ p["wo"]
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
    o, cache = sketch_prefill_attend(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), cache, slot_table, chunk=chunk)
    out = o.transpose(1, 2).reshape(B, L, H * Dh).to(h.dtype) @ p["wo"]
    return out, cache


def attn_decode_sketched(p, h_t: torch.Tensor, cache: SketchCache, cfg: ModelConfig,
                         sin_t, cos_t, slots) -> tuple[torch.Tensor, SketchCache]:
    """One-token decode over the compressed cache: O(d_slots) per token and
    O(d_slots·Dh) memory regardless of context length."""
    B = h_t.shape[0]
    H, Dh = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(p, h_t, cfg, sin_t, cos_t)
    cache = update_sketch_cache(cache, k[:, 0], v[:, 0], slots)
    o = sketch_decode_attend(q[:, 0].reshape(B, H, Dh), cache)
    out = o.reshape(B, 1, H * Dh).to(h_t.dtype) @ p["wo"]
    return out, cache
