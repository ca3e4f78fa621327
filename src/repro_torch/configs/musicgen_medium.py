"""musicgen-medium [audio]: 48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 —
decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only per spec: the EnCodec/T5 frontend is a stub; input_specs() provides
precomputed conditioning frame embeddings (B, cond_len, d_model)."""
from repro_torch.configs.base import ModelConfig, SketchAttnCfg

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    pattern=("attn",),
    n_superblocks=48,
    frontend="audio",
    cond_len=256,
    rope_theta=10000.0,
    sketch_attn=SketchAttnCfg(d_slots=1024, m=8, m_r=2),
    native_long_context=False,
)
