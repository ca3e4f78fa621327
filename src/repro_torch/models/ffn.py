"""Dense SwiGLU FFN (ported from ``repro.models.ffn``)."""
from __future__ import annotations

import torch

from repro_torch.models.common import dense_init


def init_ffn(generator: torch.Generator, d_model: int, d_ff: int, dtype=None) -> dict:
    """SwiGLU weights drawn from ``generator`` (``dtype`` defaults to the
    parameter dtype); the norm weight is float32 zeros."""
    kw = {} if dtype is None else {"dtype": dtype}
    return {
        "wi_gate": dense_init(generator, (d_model, d_ff), **kw),
        "wi_up": dense_init(generator, (d_model, d_ff), **kw),
        "wo": dense_init(generator, (d_ff, d_model), **kw),
        "norm": torch.zeros((d_model,), dtype=torch.float32, device=generator.device),
    }


def ffn_forward(p: dict, h: torch.Tensor) -> torch.Tensor:
    """silu(h W_gate) ⊙ (h W_up) W_o, the gate's silu in float32."""
    g = torch.nn.functional.silu((h @ p["wi_gate"]).float()).to(h.dtype)
    u = h @ p["wi_up"]
    return (g * u) @ p["wo"]
