"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

Backbone only per spec: the ViT frontend is a stub; input_specs() provides
precomputed patch embeddings (B, cond_len, d_model) prepended to the text
tokens. M-RoPE is realized as 1-D RoPE over the flattened sequence (the 3-D
position decomposition lives in the stubbed frontend) — noted in DESIGN.md."""
from repro_torch.configs.base import ModelConfig, SketchAttnCfg

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    pattern=("attn",),
    n_superblocks=28,
    qkv_bias=True,
    frontend="vlm",
    cond_len=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    sketch_attn=SketchAttnCfg(d_slots=1024, m=8, m_r=2),
    native_long_context=False,
)
