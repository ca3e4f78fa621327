"""The composable LM for dense attention models (ported from
``repro.models.model``): ``pattern`` × ``n_superblocks`` blocks run in a
Python loop.

Params (the reference's names and layout, so the interop map is one-to-one):
  embed      (V, D)            — input embedding (tied output head if cfg.tie)
  lm_head    (V, D) | absent   — untied output head
  final_norm (D,)
  blocks     {pos{i}: subtree with every tensor stacked over n_superblocks}
  shared     {...}             — parameters for ``attn_shared`` kinds

Block kinds ``attn``, ``attn_local`` and ``attn_shared`` with the dense FFN
are ported.  MoE FFNs, Mamba-2 and xLSTM mixers and the audio/vision
frontends raise ``NotImplementedError`` (ROADMAP queue 1, item 13).
Decode caches hold one state per layer: ``DecodeCache.blocks`` maps pos{i}
to a list over superblocks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._util import resolve_device, tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sketched_attention import SketchCache
from repro_torch.models import attention as att
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import PARAM_DTYPE, embed_init, rmsnorm, rope_table

Params = dict
ATTN_KINDS = ("attn", "attn_local", "attn_shared")


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP queue 1, item 13: "
        "MoE, Mamba-2 and xLSTM blocks and the frontends)")


def _check_cfg(cfg: ModelConfig) -> None:
    for kind in cfg.pattern:
        if kind not in ATTN_KINDS:
            raise _unported(f"block kind {kind!r}")
    if cfg.ffn != "dense":
        raise _unported(f"ffn={cfg.ffn!r}")
    if cfg.frontend is not None:
        raise _unported(f"the {cfg.frontend} frontend")


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #

def _init_block(generator, cfg: ModelConfig, dtype) -> Params:
    return {"attn": att.init_attn(generator, cfg, dtype),
            "ffn": ffn_mod.init_ffn(generator, cfg.d_model, cfg.d_ff, dtype)}


def _stacked(n: int, make) -> Params:
    """``make()`` called n times, every tensor stacked along a new leading
    axis, filled one layer at a time (one layer's float32 draw at a time)."""
    out = None
    for i in range(n):
        one = make()
        if out is None:
            out = tree_map(lambda t: torch.empty((n,) + t.shape, dtype=t.dtype,
                                                 device=t.device), one)
        for dst, src in zip(tree_leaves(out), tree_leaves(one)):
            dst[i] = src
    return out


def init_params(seed: int | torch.Generator, cfg: ModelConfig, *, device="cuda",
                dtype=PARAM_DTYPE) -> Params:
    """Parameters from a seed, drawn tensor by tensor on ``device`` (each
    dense weight in float32, then cast to ``dtype``; norms are float32
    zeros).  A seed gives the same weights on one kind of device; they are
    not the reference's weights (``interop.params_from_numpy`` carries
    those across)."""
    _check_cfg(cfg)
    device = resolve_device(device)
    g = seed if isinstance(seed, torch.Generator) else (
        torch.Generator(device=device).manual_seed(int(seed)))
    params: Params = {
        "embed": embed_init(g, (cfg.vocab_size, cfg.d_model), dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(g, (cfg.vocab_size, cfg.d_model), dtype)
    params["blocks"] = {
        f"pos{i}": _stacked(cfg.n_superblocks, lambda: _init_block(g, cfg, dtype))
        for i, kind in enumerate(cfg.pattern) if kind != "attn_shared"}
    params["shared"] = (_init_block(g, cfg, dtype) if "attn_shared" in cfg.pattern
                        else {})
    return params


def param_count(params: Params) -> int:
    """Number of parameters."""
    return sum(x.numel() for x in tree_leaves(params))


def _layer(tree: Params, i: int) -> Params:
    """Superblock i's slice of a stacked parameter subtree (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _block_params(params: Params, kind: str, pos: int, i: int) -> Params:
    if kind == "attn_shared":
        return params["shared"]
    return _layer(params["blocks"][f"pos{pos}"], i)


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings times √d_model, the scale computed in the parameter
    dtype as the reference does."""
    h = params["embed"][tokens]
    return h * torch.sqrt(torch.tensor(cfg.d_model, dtype=h.dtype, device=h.device))


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return h + ffn_mod.ffn_forward(p["ffn"], rmsnorm(h, p["ffn"]["norm"], cfg.norm_eps))


# --------------------------------------------------------------------------- #
# Forward (prefill without a cache)
# --------------------------------------------------------------------------- #

def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            cond: torch.Tensor | None = None, q_chunk: int = 512
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (h_final (B, S, D), aux_loss).  No dense block has an
    auxiliary loss, so aux is 0."""
    _check_cfg(cfg)
    if cond is not None:
        raise _unported("conditioning input (cond)")
    h = _embed(params, tokens, cfg)
    S = h.shape[1]
    sin, cos = rope_table(torch.arange(S, device=h.device), cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.n_superblocks):
        for j, kind in enumerate(cfg.pattern):
            p = _block_params(params, kind, j, i)
            window = cfg.window if kind == "attn_local" else None
            h = h + att.attn_forward(p["attn"], rmsnorm(h, p["attn"]["norm"], cfg.norm_eps),
                                     cfg, sin, cos, window=window, q_chunk=q_chunk)
            h = _ffn(p, h, cfg)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def output_embedding(params: Params) -> torch.Tensor:
    """The output head (the input embedding when tied)."""
    return params.get("lm_head", params["embed"])


def _head_logits(h_last: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """(B, D) @ (V, D)ᵀ → (B, V) float32.  On the card bfloat16 operands go
    to one product with a float32 output (``out_dtype``), so the logits are
    not rounded to bfloat16 before the argmax and no float32 copy of the
    head is made.  On the CPU the operands are widened (every bfloat16
    product is exact in float32)."""
    if h_last.dtype == torch.float32 and emb.dtype == torch.float32:
        return h_last @ emb.T
    if h_last.device.type == "cuda":
        return torch.mm(h_last, emb.T, out_dtype=torch.float32)
    return h_last.float() @ emb.float().T


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            q_chunk: int = 512) -> torch.Tensor:
    """Prefill pass → last-position logits (B, V) float32."""
    h, _ = forward(params, tokens, cfg, q_chunk=q_chunk)
    return _head_logits(h[:, -1], output_embedding(params))


# --------------------------------------------------------------------------- #
# Decode with per-layer caches
# --------------------------------------------------------------------------- #

class DecodeCache(NamedTuple):
    """Per-layer decode states (KVCache or SketchCache) of every block."""
    blocks: dict        # {pos{i}: [state of superblock 0, 1, …]}


def _init_block_cache(kind, cfg: ModelConfig, batch, max_len, dtype, use_sketch, device):
    if kind == "attn_local":
        return att.init_kv_cache(cfg, batch, min(max_len, cfg.window), dtype,
                                 device=device)
    if use_sketch:
        # AccumSketch-compressed cache: O(d_slots) memory; mass stays float32
        return att.init_attn_sketch_cache(cfg, batch, dtype, device=device)
    return att.init_kv_cache(cfg, batch, max_len, dtype, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               use_sketch: bool = False, device="cuda") -> DecodeCache:
    """use_sketch=True → global attention caches are AccumSketch-compressed
    (paper technique): O(d_slots) memory per layer instead of O(max_len)."""
    _check_cfg(cfg)
    return DecodeCache({
        f"pos{i}": [_init_block_cache(kind, cfg, batch, max_len, dtype, use_sketch,
                                      device) for _ in range(cfg.n_superblocks)]
        for i, kind in enumerate(cfg.pattern)})


def _block_decode(kind, p, h, state, cfg, sin_t, cos_t, pos: int, slots):
    x = rmsnorm(h, p["attn"]["norm"], cfg.norm_eps)
    if isinstance(state, SketchCache):
        y, state = att.attn_decode_sketched(p["attn"], x, state, cfg, sin_t, cos_t, slots)
    elif kind == "attn_local":
        # ring-buffer sliding-window cache: write at pos % window
        y, state = att.attn_decode(p["attn"], x, state, pos, cfg, sin_t, cos_t,
                                   write_pos=pos % state.k.shape[1])
    else:
        y, state = att.attn_decode(p["attn"], x, state, pos, cfg, sin_t, cos_t)
    return _ffn(p, h + y, cfg), state


def _block_prefill(kind, p, h, state, cfg, sin, cos, slot_table, q_chunk):
    x = rmsnorm(h, p["attn"]["norm"], cfg.norm_eps)
    if isinstance(state, SketchCache):
        y, state = att.attn_prefill_sketched(p["attn"], x, state, cfg, sin, cos, slot_table)
    else:
        window = cfg.window if kind == "attn_local" else None
        y, state = att.attn_prefill(p["attn"], x, state, cfg, sin, cos, window=window,
                                    q_chunk=q_chunk)
    return _ffn(p, h + y, cfg), state


def _run_blocks(params, cache: DecodeCache, h, cfg: ModelConfig, step
                ) -> tuple[torch.Tensor, DecodeCache]:
    """Every block in order: ``step(kind, p, h, state) → (h, state)``."""
    blocks = {k: list(v) for k, v in cache.blocks.items()}
    for i in range(cfg.n_superblocks):
        for j, kind in enumerate(cfg.pattern):
            key = f"pos{j}"
            h, blocks[key][i] = step(kind, _block_params(params, kind, j, i), h,
                                     blocks[key][i])
    return h, DecodeCache(blocks)


def prefill_with_cache(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                       cache: DecodeCache, *, slot_table=None, q_chunk: int = 512
                       ) -> tuple[torch.Tensor, DecodeCache]:
    """Batched prefill: consume all L prompt tokens and return (last-position
    logits (B, V) float32, the cache the sequential decode loop would reach
    after positions 0..L-1).  Exact caches get a bulk write, sketched caches
    the fold of all L tokens (bitwise the token loop's); ``slot_table``
    (L, m_r) is required when the cache holds sketched states."""
    _check_cfg(cfg)
    h = _embed(params, tokens, cfg)
    L = h.shape[1]
    sin, cos = rope_table(torch.arange(L, device=h.device), cfg.head_dim, cfg.rope_theta)
    h, cache = _run_blocks(params, cache, h, cfg, lambda kind, p, h, st: _block_prefill(
        kind, p, h, st, cfg, sin, cos, slot_table, q_chunk))
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _head_logits(h[:, -1], output_embedding(params)), cache


def decode_step(params: Params, cache: DecodeCache, token_t: torch.Tensor, pos: int,
                cfg: ModelConfig, *, slots=None, use_sketch: bool = False
                ) -> tuple[torch.Tensor, DecodeCache]:
    """One decoding step.  token_t: (B,) ints on the device; pos: the
    current index; slots: (m_r,) host ints for sketched caches.  Returns
    (logits (B, V) float32, updated cache).  ``use_sketch`` is accepted for
    the reference's signature; each state's type decides its path."""
    h = _embed(params, token_t[:, None], cfg)
    sin_t, cos_t = rope_table(torch.tensor([pos], device=h.device), cfg.head_dim,
                              cfg.rope_theta)
    h, cache = _run_blocks(params, cache, h, cfg, lambda kind, p, h, st: _block_decode(
        kind, p, h, st, cfg, sin_t, cos_t, int(pos), slots))
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _head_logits(h[:, 0], output_embedding(params)), cache

