"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144,
5:1 local:global interleaving, 128k context (sliding window 1024 on local layers).
[hf:google/gemma-3-1b-pt family; unverified]"""
from repro_torch.configs.base import ModelConfig, SketchAttnCfg

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,                  # gemma3 uses wide heads (16×256 ≠ d_model is intentional)
    d_ff=15360,
    vocab_size=262144,
    pattern=("attn_local",) * 5 + ("attn",),
    n_superblocks=8,
    window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    sketch_attn=SketchAttnCfg(d_slots=2048, m=8, m_r=2),
    # local layers are sub-quadratic; global layers use AccumAttention at 500k
    native_long_context=False,
)
