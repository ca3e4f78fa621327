"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) expert d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ModelConfig, MoECfg, SketchAttnCfg

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    pattern=("attn",),
    n_superblocks=35,
    ffn="moe",
    moe=MoECfg(
        n_experts=128, top_k=2, d_ff_expert=4864,
        dense_residual=True, d_ff_dense=4864,
    ),
    rope_theta=10000.0,
    sketch_attn=SketchAttnCfg(d_slots=2048, m=8, m_r=2),
    native_long_context=False,
)
