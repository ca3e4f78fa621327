"""stablelm-3b [dense]: 32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304.
[hf:stabilityai/stablelm-2-1_6b family; unverified]"""
from repro_torch.configs.base import ModelConfig, SketchAttnCfg

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    pattern=("attn",),
    n_superblocks=32,
    rope_theta=10000.0,
    sketch_attn=SketchAttnCfg(d_slots=1024, m=8, m_r=2),
    native_long_context=False,
)
