"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (MHA kv=16) expert d_ff=1408
vocab=163840, MoE 64 experts top-6 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig, MoECfg, SketchAttnCfg

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    pattern=("attn",),
    n_superblocks=48,
    ffn="moe",
    moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408),
    rope_theta=50000.0,
    sketch_attn=SketchAttnCfg(d_slots=1024, m=8, m_r=2),
    native_long_context=False,
)
