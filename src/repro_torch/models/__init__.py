"""The LM substrate (dense and MoE attention, Mamba-2 and xLSTM mixers):
init, forward, prefill and decode with exact or sketched caches, and the
training loss (ported from ``repro.models``)."""
from repro_torch.models.model import (
    DecodeCache,
    active_param_count,
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
