"""The LM substrate for dense attention models: init, forward, prefill and
decode with exact or sketched caches, and the training loss (ported from
``repro.models``)."""
from repro_torch.models.model import (
    DecodeCache,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    output_embedding,
    param_count,
    prefill,
    prefill_with_cache,
)

__all__ = [n for n in dir() if not n.startswith("_")]
