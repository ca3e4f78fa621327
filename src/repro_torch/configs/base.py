"""Config system: one dataclass describes every supported architecture.

Copied from the reference's ``configs/base.py``: the same dataclasses and
values, so a configuration means the same model in both packages.  A model
is `n_superblocks` repetitions of a `pattern` of layer kinds. Layer kinds:

  attn         — global causal attention (+ FFN per `ffn`)
  attn_local   — sliding-window causal attention (+ FFN)
  attn_shared  — attention with parameters SHARED across all occurrences (Zamba2)
  mamba2       — Mamba-2 SSD mixer block (no separate FFN)
  mlstm        — xLSTM matrix-memory block
  slstm        — xLSTM scalar-memory block
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    dense_residual: bool = False     # Arctic-style parallel dense FFN
    d_ff_dense: int = 0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64                  # SSD intra-chunk length


@dataclasses.dataclass(frozen=True)
class SketchAttnCfg:
    """AccumAttention (paper technique) for long-context serving."""
    d_slots: int = 1024              # landmark slots (projection dimension d)
    m: int = 8                       # accumulations (prefill/landmark path)
    m_r: int = 2                     # streaming picks per token (decode path)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[str, ...]
    n_superblocks: int
    head_dim: int = 0                # 0 → d_model // n_heads
    ffn: str = "dense"               # dense|moe|none
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    window: int = 1024               # attn_local sliding window
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    frontend: Optional[str] = None   # None|audio|vlm
    cond_len: int = 0                # frontend embedding length
    sketch_attn: SketchAttnCfg = SketchAttnCfg()
    norm_eps: float = 1e-6
    # which shapes support the exact long-context path (sub-quadratic mixers)
    native_long_context: bool = False
    # Pin head-aligned (padded) TP sharding on q/k/v inside attention. Wins
    # when flat (H·Dh)-column sharding splits head_dim and the score einsum
    # goes partial (arctic: −40 s/step of score all-reduces); loses when the
    # padded reshard itself triggers SPMD involuntary rematerialization
    # (qwen1.5-110b: +287 s/step). Tuned per arch in §Perf.
    attn_head_tp: bool = True
    # "default": DP/FSDP on (pod,data) + TP/EP on model.
    # "dp_only": no TP; batch and FSDP span every mesh axis. Right for small
    # models with sequential time-scans (xLSTM): TP on the gate projections
    # leaks sharded contractions into the per-timestep scan body, costing one
    # tuple all-reduce per token — DP-only removes every per-step collective.
    sharding_policy: str = "default"

    def __post_init__(self):
        assert len(self.pattern) * self.n_superblocks == self.n_layers, (
            f"{self.name}: pattern×superblocks != n_layers"
        )
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def has_attention(self) -> bool:
        return any(k.startswith("attn") for k in self.pattern)

    @property
    def attention_only(self) -> bool:
        return all(k.startswith("attn") for k in self.pattern)

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (one superblock, narrow)."""
    small_moe = None
    if cfg.moe is not None:
        small_moe = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
            d_ff_dense=64 if cfg.moe.dense_residual else 0,
        )
    small_ssm = dataclasses.replace(cfg.ssm, head_dim=16, d_state=8, chunk=8) if cfg.ssm else None
    n_heads = min(cfg.n_heads, 4)
    n_kv = min(cfg.n_kv_heads, n_heads)
    return cfg.scaled(
        name=cfg.name + "-reduced",
        n_layers=len(cfg.pattern),
        n_superblocks=1,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        moe=small_moe,
        ssm=small_ssm,
        window=16,
        cond_len=8 if cfg.frontend else 0,
        sketch_attn=SketchAttnCfg(d_slots=16, m=2, m_r=2),
    )


# ---------------------------------------------------------------------------
# Input shape suite (assigned to every architecture)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train|prefill|decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
