"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064,
QKV bias. [hf:Qwen/Qwen1.5-0.5B family; hf]"""
from repro_torch.configs.base import ModelConfig, SketchAttnCfg

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    pattern=("attn",),
    n_superblocks=80,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    # padded kv-head TP regresses this arch: the 8-over-16 reshard triggers
    # SPMD involuntary rematerialization (t_coll 68→355 s). §Perf.
    attn_head_tp=False,
    sketch_attn=SketchAttnCfg(d_slots=2048, m=8, m_r=2),
    native_long_context=False,     # pure full attention → long_500k via AccumAttention
)
