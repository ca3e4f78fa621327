"""zamba2-7b [hybrid]: 81L d_model=3584 32H (MHA kv=32) d_ff=14336 vocab=32000,
Mamba2 backbone + shared attention blocks, ssm_state=64. [arXiv:2411.15242; unverified]

Realized pattern: 27 superblocks of (mamba2, mamba2, shared-attention+FFN); the
attention/FFN parameters are shared across all 27 occurrences (Zamba2's weight
sharing), Mamba2 parameters are per-block. Hybrid → long_500k native on Mamba2
path with AccumAttention on the shared-attention blocks."""
from repro_torch.configs.base import ModelConfig, SSMCfg, SketchAttnCfg

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    pattern=("mamba2", "mamba2", "attn_shared"),
    n_superblocks=27,
    ssm=SSMCfg(d_state=64, head_dim=64, expand=2, conv_width=4, chunk=64),
    rope_theta=10000.0,
    sketch_attn=SketchAttnCfg(d_slots=1024, m=8, m_r=2),
    native_long_context=True,
)
