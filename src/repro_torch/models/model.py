"""The composable LM (ported from ``repro.models.model``): ``pattern`` ×
``n_superblocks`` blocks run in a Python loop.

Params (the reference's names and layout, so the interop map is one-to-one):
  embed      (V, D)            — input embedding (tied output head if cfg.tie)
  lm_head    (V, D) | absent   — untied output head
  final_norm (D,)
  blocks     {pos{i}: subtree with every tensor stacked over n_superblocks}
  shared     {...}             — parameters for ``attn_shared`` kinds (Zamba2)

Block kinds ``attn``, ``attn_local`` and ``attn_shared`` with the dense or
the MoE FFN, and the recurrent mixers ``mamba2``, ``mlstm`` and ``slstm``,
are ported, as is the conditioning input ``cond`` of the audio and vision
configs (precomputed embeddings placed before the tokens; the frontends are
stubs in the reference too).  Decode caches hold one state per layer:
``DecodeCache.blocks`` maps pos{i} to a list over superblocks.  Training
(``loss_fn``) checkpoints each superblock as ``remat`` says.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch._util import resolve_device, stream_generator, tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sketched_attention import SketchCache
from repro_torch.models import attention as att
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (
    PARAM_DTYPE,
    chunked_xent,
    embed_init,
    rmsnorm,
    rope_table,
)
from repro_torch.sharding import constrain, from_local, gather_fsdp, is_dtensor, pin_grad

Params = dict
PORTED_KINDS = ("attn", "attn_local", "attn_shared", "mamba2", "mlstm", "slstm")

# the recurrent mixers: init, forward, cache init, per-token decode and the
# token-scan prefill (the state the sequential decode reaches)
_MIXERS = {
    "mamba2": (ssm_mod.init_mamba2, ssm_mod.mamba2_forward, ssm_mod.mamba2_decode,
               ssm_mod.mamba2_prefill),
    "mlstm": (xlstm_mod.init_mlstm, xlstm_mod.mlstm_forward, xlstm_mod.mlstm_decode,
              xlstm_mod.mlstm_prefill),
    "slstm": (xlstm_mod.init_slstm, xlstm_mod.slstm_forward, xlstm_mod.slstm_decode,
              xlstm_mod.slstm_prefill),
}


def _check_cfg(cfg: ModelConfig) -> None:
    for kind in cfg.pattern:
        if kind not in PORTED_KINDS:
            raise ValueError(f"unknown block kind {kind!r}")


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #

def _init_block(generator, kind: str, cfg: ModelConfig, dtype) -> Params:
    if kind in _MIXERS:
        return {"mixer": _MIXERS[kind][0](generator, cfg, dtype)}
    p = {"attn": att.init_attn(generator, cfg, dtype)}
    if cfg.ffn == "dense" or kind == "attn_shared":
        p["ffn"] = ffn_mod.init_ffn(generator, cfg.d_model, cfg.d_ff, dtype)
    elif cfg.ffn == "moe":
        p["ffn"] = moe_mod.init_moe(generator, cfg.d_model, cfg.moe, dtype)
    return p


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
    dense weight in float32, then cast to ``dtype``; norms, the MoE router
    and the Mamba-2 constants are float32).  A seed gives the same weights
    on one kind of device; they are not the reference's weights
    (``interop.params_from_numpy`` carries those across)."""
    _check_cfg(cfg)
    device = resolve_device(device)
    g = seed if isinstance(seed, torch.Generator) else (
        stream_generator(int(seed), device=device))  # rng-stream: init-params
    params: Params = {
        "embed": embed_init(g, (cfg.vocab_size, cfg.d_model), dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(g, (cfg.vocab_size, cfg.d_model), dtype)
    params["blocks"] = {
        f"pos{i}": _stacked(cfg.n_superblocks,
                            lambda kind=kind: _init_block(g, kind, cfg, dtype))
        for i, kind in enumerate(cfg.pattern) if kind != "attn_shared"}
    params["shared"] = (_init_block(g, "attn_shared", cfg, dtype)
                        if "attn_shared" in cfg.pattern else {})
    return params


def param_count(params: Params) -> int:
    """Number of parameters."""
    return sum(x.numel() for x in tree_leaves(params))


def active_param_count(cfg: ModelConfig, params: Params) -> int:
    """Active-per-token parameters (MoE: top_k of n_experts)."""
    total = param_count(params)
    if cfg.moe is None:
        return total
    inactive = 0.0
    for pos in params["blocks"].values():
        ffn = pos.get("ffn", {})
        for n in ("wi_gate", "wi_up", "wo"):
            if n in ffn and ffn[n].ndim == 4:      # (n_sb, E, ·, ·)
                inactive += ffn[n].numel() * (1 - cfg.moe.top_k / cfg.moe.n_experts)
    return int(total - inactive)


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings times √d_model, the scale computed in the parameter
    dtype as the reference does."""
    emb = params["embed"]
    h = _lookup(emb, tokens) if is_dtensor(emb) else emb[tokens]
    return h * torch.sqrt(torch.full((), cfg.d_model, dtype=h.dtype, device=h.device))


def _lookup(emb, tokens) -> torch.Tensor:
    """``emb[tokens]`` for a sharded table (a DTensor) under a mesh: the
    table gathered whole (as FSDP gathers a weight where it is used) and
    indexed on each rank's own tokens; the result is placed as the tokens,
    each row's embedding vector whole.  The table's gradient is each rank's
    sum over its own tokens: a partial sum over the data axes, the same on
    the ranks of one data shard.  (DTensor's own index rules do not carry
    a vocabulary-sharded table's backward on every PyTorch version.)"""
    from torch.distributed.tensor import Partial, Replicate

    dm = emb.device_mesh
    if is_dtensor(tokens):
        tok, pls = tokens.to_local(), list(tokens.placements)
    else:
        tok, pls = tokens, [Replicate()] * dm.ndim
    # the tokens' data split makes the table's gradient partial there
    grad = [Partial() if pl != Replicate() else Replicate() for pl in pls]
    table = emb.redistribute(dm, [Replicate()] * dm.ndim).to_local(grad_placements=grad)
    return from_local(table[tok], dm, pls, (*tokens.shape, emb.shape[1]))


def _ffn(kind: str, p: Params, h: torch.Tensor, cfg: ModelConfig
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """h plus the block's FFN of rmsnorm(h), if it has one: (h, the MoE aux
    loss or None).  ``attn_shared`` keeps the dense FFN in an MoE model, as
    the reference."""
    if "ffn" not in p:
        return h, None
    h = _pin(h, cfg)
    x = rmsnorm(h, p["ffn"]["norm"], cfg.norm_eps)
    if cfg.ffn == "moe" and kind != "attn_shared":
        y, metrics = moe_mod.moe_forward(p["ffn"], x, cfg.moe)
        return h + y, metrics.aux_loss
    return h + ffn_mod.ffn_forward(p["ffn"], x), None


def _cond_input(params: Params, tokens: torch.Tensor, cfg: ModelConfig, cond
                ) -> torch.Tensor:
    """Token embeddings with ``cond`` (B, Sc, D), cast to their dtype, placed
    before them: (B, Sc + S, D)."""
    h = _embed(params, tokens, cfg)
    if cond is None:
        return h
    B, _, D = h.shape
    if cond.ndim != 3 or cond.shape[0] != B or cond.shape[2] != D:
        raise ValueError(f"cond must be (batch {B}, cond_len, d_model {D}) embeddings, "
                         f"got {tuple(cond.shape)}")
    return torch.cat([cond.to(h.dtype), h], dim=1)


# --------------------------------------------------------------------------- #
# Forward (training and prefill without a cache)
# --------------------------------------------------------------------------- #

def _unstack(tree: Params, n: int) -> list[Params]:
    """A stacked parameter subtree as n per-superblock subtrees of views, one
    ``unbind`` a tensor: its backward stacks the n gradients once, where
    indexing layer by layer would write a zero-filled stacked gradient for
    every layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective checkpointing for ``remat="dots"``: keep the matrix
    products' outputs, recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_call(policy: str, fn, *args):
    """``fn(*args)`` under the remat policy: ``"none"`` keeps every
    activation, ``"full"`` keeps only the arguments and recomputes the rest
    in the backward, ``"dots"`` also keeps the matrix products.  None moves
    a bit of the result."""
    if policy == "none":
        return fn(*args)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat must be 'none', 'dots' or 'full', got {policy!r}")


def _pin(h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The residual stream pinned to the batch on the data axes, whole on
    the model axis (the identity off a mesh).  Under GSPMD every op's
    result takes this layout from its neighbours; DTensor keeps a
    tensor-parallel product's partial sums (``Partial``) through the
    residual add and the norm, and then gathers the next block's weights
    whole instead of multiplying by their shards, so each block pins its
    input."""
    return constrain(h, "dp", None, None, policy=cfg.sharding_policy)


def _block_params(p: Params, cfg: ModelConfig) -> Params:
    """A block's parameters as its products take them: under "dp_only" (no
    tensor parallelism) each weight gathered whole from its FSDP shards
    first (``sharding.gather_fsdp``), so that the activations keep the
    batch split alone, as GSPMD gathers them; otherwise as they are."""
    if cfg.sharding_policy != "dp_only":
        return p
    return tree_map(lambda w: gather_fsdp(w, cfg.sharding_policy), p)


def _superblock(h: torch.Tensor, aux: torch.Tensor, sb: Params, shared: Params,
                cfg: ModelConfig, sin, cos, q_chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    for j, kind in enumerate(cfg.pattern):
        h = _pin(h, cfg)  # the carry, then each block's input
        p = _block_params(shared if kind == "attn_shared" else sb[f"pos{j}"], cfg)
        if kind in _MIXERS:
            x = rmsnorm(h, p["mixer"]["norm"], cfg.norm_eps)
            h = h + _MIXERS[kind][1](p["mixer"], x, cfg)
            continue
        window = cfg.window if kind == "attn_local" else None
        h = h + att.attn_forward(p["attn"], rmsnorm(h, p["attn"]["norm"], cfg.norm_eps),
                                 cfg, sin, cos, window=window, q_chunk=q_chunk)
        h, a = _ffn(kind, p, h, cfg)
        if a is not None:
            aux = aux + a
    return h, aux


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            cond: torch.Tensor | None = None, q_chunk: int = 512, remat: str = "dots"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) [+ cond (B, Sc, D)] → (h_final (B, S_tot, D), aux_loss):
    ``cond`` embeddings come first, S_tot = Sc + S.  aux is the sum of every
    MoE layer's load-balancing loss (0 without MoE).  ``remat`` ("none",
    "dots" or "full") is the activation checkpointing of each superblock
    (``_remat_call``)."""
    _check_cfg(cfg)
    h = _cond_input(params, tokens, cfg, cond)
    h = constrain(h, "dp", None, None, policy=cfg.sharding_policy)  # batch on DP axes
    S_tot = h.shape[1]
    sin, cos = rope_table(torch.arange(S_tot, device=h.device), cfg.head_dim,
                          cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for sb in _unstack(params["blocks"], cfg.n_superblocks):
        # on a mesh each view's gradient goes to the view's own (sharded)
        # placements as soon as its superblock's backward has made it, so
        # that the unbind's stack waits on shards, as the reference's scan
        # reduce-scatters each layer's; pinned here, after the superblocks
        # before it, so that the backward runs the pin before them
        sb = tree_map(pin_grad, sb)
        h, aux = _remat_call(remat, _superblock, h, aux, sb, params["shared"], cfg, sin,
                             cos, q_chunk)
    h = rmsnorm(_pin(h, cfg), params["final_norm"], cfg.norm_eps)
    return h, aux


def output_embedding(params: Params, cfg: ModelConfig | None = None) -> torch.Tensor:
    """The output head (the input embedding when tied); on a mesh with
    ``cfg``, its FSDP shards gathered (``sharding.gather_fsdp``), the
    vocabulary kept on the model axis."""
    emb = params.get("lm_head", params["embed"])
    return emb if cfg is None else gather_fsdp(emb, cfg.sharding_policy)


def loss_fn(params: Params, tokens: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig, *,
            cond: torch.Tensor | None = None, q_chunk: int = 512, remat: str = "dots"
            ) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy of ``tokens`` (B, S) against ``labels``
    (B, S) plus the weighted auxiliary loss.  With ``cond`` (B, Sc, D) the
    loss counts only the token positions (the Sc conditioning positions are
    masked, their labels padded with zeros).  Returns (loss, {"xent", "aux",
    "tokens"}); every value is a float32 tensor."""
    h, aux = forward(params, tokens, cfg, cond=cond, q_chunk=q_chunk, remat=remat)
    B, S = tokens.shape
    mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    if cond is not None:
        Sc = cond.shape[1]
        mask = torch.cat([torch.zeros((B, Sc), dtype=torch.float32, device=h.device),
                          mask], dim=1)
        labels = torch.cat([torch.zeros((B, Sc), dtype=labels.dtype,
                                        device=labels.device), labels], dim=1)
    xent, count = chunked_xent(h, output_embedding(params, cfg), labels, mask)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
    return xent + aux_w * aux, {"xent": xent, "aux": aux, "tokens": count}


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
            cond: torch.Tensor | None = None, q_chunk: int = 512) -> torch.Tensor:
    """Prefill pass (``cond`` embeddings first, as in ``forward``) →
    last-position logits (B, V) float32."""
    h, _ = forward(params, tokens, cfg, cond=cond, q_chunk=q_chunk, remat="none")
    return _head_logits(h[:, -1], output_embedding(params, cfg))


# --------------------------------------------------------------------------- #
# Decode with per-layer caches
# --------------------------------------------------------------------------- #

class DecodeCache(NamedTuple):
    """Per-layer decode states (KVCache, SketchCache, SSMState, MLSTMState
    or SLSTMState) of every block."""
    blocks: dict        # {pos{i}: [state of superblock 0, 1, …]}


def _init_block_cache(kind, cfg: ModelConfig, batch, max_len, dtype, use_sketch, device):
    if kind == "mamba2":
        return ssm_mod.init_ssm_state(cfg, batch, dtype, device=device)
    if kind == "mlstm":
        return xlstm_mod.init_mlstm_state(cfg, batch, device=device)
    if kind == "slstm":
        return xlstm_mod.init_slstm_state(cfg, batch, device=device)
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
    h = _pin(h, cfg)
    if kind in _MIXERS:
        x = rmsnorm(h, p["mixer"]["norm"], cfg.norm_eps)
        y, state = _MIXERS[kind][2](p["mixer"], x, state, cfg)
        return h + y, state
    x = rmsnorm(h, p["attn"]["norm"], cfg.norm_eps)
    if isinstance(state, SketchCache):
        y, state = att.attn_decode_sketched(p["attn"], x, state, cfg, sin_t, cos_t, slots)
    elif kind == "attn_local":
        # ring-buffer sliding-window cache: write at pos % window
        y, state = att.attn_decode(p["attn"], x, state, pos, cfg, sin_t, cos_t,
                                   write_pos=pos % state.k.shape[1])
    else:
        y, state = att.attn_decode(p["attn"], x, state, pos, cfg, sin_t, cos_t)
    return _ffn(kind, p, h + y, cfg)[0], state


def _block_prefill(kind, p, h, state, cfg, sin, cos, slot_table, q_chunk):
    h = _pin(h, cfg)
    if kind in _MIXERS:
        # the recurrent mixers have a per-token transition only: their token
        # scan (the state the sequential decode reaches, what does not depend
        # on the state hoisted out of the loop)
        x = rmsnorm(h, p["mixer"]["norm"], cfg.norm_eps)
        y, state = _MIXERS[kind][3](p["mixer"], x, state, cfg)
        return h + y, state
    x = rmsnorm(h, p["attn"]["norm"], cfg.norm_eps)
    if isinstance(state, SketchCache):
        y, state = att.attn_prefill_sketched(p["attn"], x, state, cfg, sin, cos, slot_table)
    else:
        window = cfg.window if kind == "attn_local" else None
        y, state = att.attn_prefill(p["attn"], x, state, cfg, sin, cos, window=window,
                                    q_chunk=q_chunk)
    return _ffn(kind, p, h + y, cfg)[0], state


def _run_blocks(params, cache: DecodeCache, h, cfg: ModelConfig, step, *,
                pin_carry: bool = False) -> tuple[torch.Tensor, DecodeCache]:
    """Every block in order: ``step(kind, p, h, state) → (h, state)``;
    ``pin_carry`` constrains h at each superblock's start, as the
    reference's prefill scan does."""
    blocks = {k: list(v) for k, v in cache.blocks.items()}
    for i, sb in enumerate(_unstack(params["blocks"], cfg.n_superblocks)):
        if pin_carry:
            h = constrain(h, "dp", None, None, policy=cfg.sharding_policy)
        for j, kind in enumerate(cfg.pattern):
            key = f"pos{j}"
            p = _block_params(params["shared"] if kind == "attn_shared" else sb[key], cfg)
            h, blocks[key][i] = step(kind, p, h, blocks[key][i])
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
    h = constrain(_embed(params, tokens, cfg), "dp", None, None,
                  policy=cfg.sharding_policy)
    L = h.shape[1]
    sin, cos = rope_table(torch.arange(L, device=h.device), cfg.head_dim, cfg.rope_theta)
    h, cache = _run_blocks(params, cache, h, cfg, lambda kind, p, h, st: _block_prefill(
        kind, p, h, st, cfg, sin, cos, slot_table, q_chunk), pin_carry=True)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _head_logits(h[:, -1], output_embedding(params, cfg)), cache


def decode_step(params: Params, cache: DecodeCache, token_t: torch.Tensor, pos: int,
                cfg: ModelConfig, *, slots=None, use_sketch: bool = False
                ) -> tuple[torch.Tensor, DecodeCache]:
    """One decoding step.  token_t: (B,) ints on the device; pos: the
    current index; slots: (m_r,) host ints for sketched caches.  Returns
    (logits (B, V) float32, updated cache).  ``use_sketch`` is accepted for
    the reference's signature; each state's type decides its path."""
    h = constrain(_embed(params, token_t[:, None], cfg), "dp", None, None,
                  policy=cfg.sharding_policy)
    # the position made on the device: a decode step copies nothing from the host
    sin_t, cos_t = rope_table(torch.arange(pos, pos + 1, device=h.device), cfg.head_dim,
                              cfg.rope_theta)
    h, cache = _run_blocks(params, cache, h, cfg, lambda kind, p, h, st: _block_decode(
        kind, p, h, st, cfg, sin_t, cos_t, int(pos), slots))
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _head_logits(h[:, 0], output_embedding(params, cfg)), cache

