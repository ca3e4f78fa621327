"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — alternating
sLSTM + mLSTM blocks (attention-free). [arXiv:2405.04517; unverified]

The paper's sketching technique is inapplicable to the mixer (no kernel matrix);
long_500k runs natively (recurrent state). See DESIGN.md §Arch-applicability."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=("mlstm", "slstm"),
    n_superblocks=6,
    ffn="none",
    tie_embeddings=True,
    native_long_context=True,
    # 125M params replicate trivially; TP would put per-timestep all-reduces
    # inside the sLSTM/mLSTM time scan (measured: 1.4M collectives/step on the
    # 16×16 mesh). See EXPERIMENTS.md §Perf iteration A1.
    sharding_policy="dp_only",
)
