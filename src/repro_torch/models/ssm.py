"""Mamba-2 block (SSD — state space dual), chunked-parallel training form and
single-step recurrent decode form (ported from ``repro.models.ssm``).
Follows the minimal-SSD formulation:

  h_t = exp(dt_t·A) h_{t-1} + dt_t · B_t ⊗ x_t ,   y_t = C_t · h_t + D ⊙ x_t

Training scans over length-Q chunks (intra-chunk parallel, inter-chunk scan
as a Python loop over the chunks), so compute is O(L·Q) with O(L/Q)
sequential steps.  Every dtype cast is the reference's: the projections in
the parameter dtype, the conv in the input's dtype with its SiLU in
float32, dt, the decay, the SSD and the gate in float32, and the gated
output back in the input's dtype before ``gate_norm``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from repro_torch._util import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import PARAM_DTYPE, dense_init, rmsnorm


class SSMState(NamedTuple):
    """Recurrent state of one Mamba-2 layer."""
    conv: torch.Tensor   # (B, W-1, d_conv_ch) rolling conv inputs, the cache dtype
    ssm: torch.Tensor    # (B, H, P, N) recurrent state, float32


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, heads H, head dim P, state size N)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return d_inner, H, s.head_dim, s.d_state


def init_mamba2(generator: torch.Generator, cfg: ModelConfig, dtype=PARAM_DTYPE) -> dict:
    """Projections and conv weights drawn from ``generator``; A_log, D,
    dt_bias, the conv bias and both norms float32 (A = −exp(A_log) = −1)."""
    s = cfg.ssm
    d_inner, H, P, N = _dims(cfg)
    d_conv_ch = d_inner + 2 * N
    dev = generator.device

    def const(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {
        "in_proj": dense_init(generator, (cfg.d_model, 2 * d_inner + 2 * N + H), dtype=dtype),
        "conv_w": dense_init(generator, (s.conv_width, d_conv_ch), dtype=dtype),
        "conv_b": const((d_conv_ch,), 0.0),
        "A_log": const((H,), 0.0),
        "D": const((H,), 1.0),
        "dt_bias": const((H,), 0.0),
        "gate_norm": const((d_inner,), 0.0),
        "out_proj": dense_init(generator, (d_inner, cfg.d_model), dtype=dtype),
        "norm": const((cfg.d_model,), 0.0),
    }


def _split_proj(p: dict, h: torch.Tensor, cfg: ModelConfig):
    """h @ in_proj split into (z, xBC, dt)."""
    d_inner, H, P, N = _dims(cfg)
    zxbcdt = h @ p["in_proj"]
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)


def _causal_conv(p: dict, xBC: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Depthwise causal conv along L in xBC's dtype, SiLU in float32.
    xBC: (B, L, Cch)."""
    W = cfg.ssm.conv_width
    L = xBC.shape[1]
    pad = Fn.pad(xBC, (0, 0, W - 1, 0))
    out = pad[:, 0:L, :] * p["conv_w"][0].to(xBC.dtype)
    for i in range(1, W):
        out = out + pad[:, i:i + L, :] * p["conv_w"][i].to(xBC.dtype)
    return Fn.silu((out + p["conv_b"].to(xBC.dtype)).float()).to(xBC.dtype)


def _gate_out(p: dict, y: torch.Tensor, z: torch.Tensor, dtype, cfg: ModelConfig):
    """y (float32) gated by silu(z) in float32, back to ``dtype``, gate_norm,
    out_proj."""
    gated = y * Fn.silu(z.float())
    return rmsnorm(gated.to(dtype), p["gate_norm"], cfg.norm_eps) @ p["out_proj"]


def mamba2_forward(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, L, D) → (B, L, D); L must be divisible by the chunk length
    Q = min(cfg.ssm.chunk, L).

    The reference's three 3-operand einsums are taken in two explicit steps
    each (``torch.einsum`` would contract them left to right).  The largest
    intermediate is the (B, c, i, j, H) float32 decay and its product with
    the scores: at zamba2-7b's width (H = 112, Q = 64) and B = 4, L = 2048,
    4·32·64·64·112·4 B = 235 MB each."""
    B, L, D = h.shape
    d_inner, H, P, N = _dims(cfg)
    Q = min(cfg.ssm.chunk, L)
    if L % Q:
        raise ValueError(f"mamba2_forward needs the length L = {L} to be a multiple of "
                         f"the chunk length {Q} (cfg.ssm.chunk); pad the sequence")
    nc = L // Q
    f32 = torch.float32

    z, xBC, dt = _split_proj(p, h, cfg)
    xBC = _causal_conv(p, xBC, cfg)
    x, Bm, Cm = torch.split(xBC, [d_inner, N, N], dim=-1)
    x = x.reshape(B, L, H, P)
    dt = Fn.softplus(dt.float() + p["dt_bias"])                       # (B, L, H)
    A = -torch.exp(p["A_log"].float())                                # (H,)

    # chunked SSD
    dA = (dt * A).reshape(B, nc, Q, H)                                # (B,c,q,H) f32
    dA_cs = torch.cumsum(dA, dim=2)                                   # within-chunk cumsum
    dA_sum = dA_cs[:, :, -1, :]                                       # (B,c,H)
    xdt = (x.float() * dt[..., None]).reshape(B, nc, Q, H, P)
    Bc = Bm.float().reshape(B, nc, Q, N)
    Cc = Cm.float().reshape(B, nc, Q, N)

    # intra-chunk (diagonal blocks): Y_ii, first (scores·decay) over (i, j, H),
    # then the product over j
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]           # (B,c,i,j,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=h.device))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)                  # (B,c,i,j)
    sd = (scores[..., None] * decay).permute(0, 1, 4, 2, 3)           # (B,c,H,i,j)
    y_diag = torch.matmul(sd, xdt.permute(0, 1, 3, 2, 4))             # (B,c,H,i,P)
    y_diag = y_diag.permute(0, 1, 3, 2, 4)                            # (B,c,i,H,P)
    del seg, decay, sd

    # chunk states: first the decay into xdt, then the product over j
    decay_out = torch.exp(dA_sum[:, :, None, :] - dA_cs)              # (B,c,j,H)
    xd = (decay_out[..., None] * xdt).reshape(B, nc, Q, H * P)        # (B,c,j,H·P)
    states = torch.matmul(xd.transpose(2, 3), Bc).reshape(B, nc, H, P, N)

    # inter-chunk scan: the state entering each chunk
    s = torch.zeros((B, H, P, N), dtype=f32, device=h.device)
    prevs = []
    for c in range(nc):
        prevs.append(s)
        s = s * torch.exp(dA_sum[:, c])[:, :, None, None] + states[:, c]
    s_prevs = torch.stack(prevs, dim=1)                               # (B,c,H,P,N)

    # off-diagonal: first over n, then the decay
    y_off = torch.matmul(Cc, s_prevs.reshape(B, nc, H * P, N).transpose(2, 3))
    y_off = y_off.reshape(B, nc, Q, H, P) * torch.exp(dA_cs)[..., None]
    y = (y_diag + y_off).reshape(B, L, H, P) + x.float() * p["D"][None, None, :, None]
    return _gate_out(p, y.reshape(B, L, d_inner), z, h.dtype, cfg)


# --------------------------------------------------------------------------- #
# Decode
# --------------------------------------------------------------------------- #

def init_ssm_state(cfg: ModelConfig, batch: int, dtype, *, device="cuda") -> SSMState:
    """Zero state: the conv window in ``dtype``, the SSM state float32."""
    device = resolve_device(device)
    d_inner, H, P, N = _dims(cfg)
    W = cfg.ssm.conv_width
    return SSMState(
        conv=torch.zeros((batch, W - 1, d_inner + 2 * N), dtype=dtype, device=device),
        ssm=torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
    )


def mamba2_decode(p: dict, h_t: torch.Tensor, state: SSMState, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, SSMState]:
    """One-token recurrent step.  h_t: (B, 1, D).  Returns (out (B, 1, D),
    the new state); the input state is not modified."""
    B = h_t.shape[0]
    d_inner, H, P, N = _dims(cfg)

    z, xBC, dt = _split_proj(p, h_t, cfg)                             # (B,1,·)
    window = torch.cat([state.conv, xBC.to(state.conv.dtype)], dim=1)  # (B,W,Cch)
    conv_out = torch.einsum("bwc,wc->bc", window.float(), p["conv_w"].float())
    xBC_t = Fn.silu(conv_out + p["conv_b"])                           # (B,Cch) f32
    new_conv = window[:, 1:, :]

    x, Bv, Cv = torch.split(xBC_t, [d_inner, N, N], dim=-1)
    x = x.reshape(B, H, P)
    dtv = Fn.softplus(dt[:, 0].float() + p["dt_bias"])                # (B,H)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dtv * A)                                           # (B,H)
    s = state.ssm * dA[:, :, None, None] + (
        (dtv[:, :, None] * x)[..., None] * Bv[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", Cv, s) + x * p["D"][None, :, None]
    out = _gate_out(p, y.reshape(B, 1, d_inner), z, h_t.dtype, cfg)
    return out, SSMState(new_conv, s)


def mamba2_prefill(p: dict, h: torch.Tensor, state: SSMState, cfg: ModelConfig
                   ) -> tuple[torch.Tensor, SSMState]:
    """The L tokens of h (B, L, D) through ``mamba2_decode``'s recurrence one
    token after another, from ``state``: returns (out (B, L, D), the state
    the sequential decode reaches after them).

    What does not depend on the state is computed for all L tokens at once
    (the projections, the conv over the rolling window — the same four
    float32 terms a step — dt, the decay and the output gate); the state
    update and C·h run token by token, the reference's scan."""
    B, L, _ = h.shape
    d_inner, H, P, N = _dims(cfg)
    W = cfg.ssm.conv_width

    z, xBC, dt = _split_proj(p, h, cfg)
    seq = torch.cat([state.conv, xBC.to(state.conv.dtype)], dim=1)   # (B, W-1+L, Cch)
    wf = p["conv_w"].float()
    conv_out = seq[:, 0:L].float() * wf[0]
    for i in range(1, W):
        conv_out = conv_out + seq[:, i:i + L].float() * wf[i]
    xBC_t = Fn.silu(conv_out + p["conv_b"])                           # (B,L,Cch) f32
    new_conv = seq[:, L:].clone()

    x, Bv, Cv = torch.split(xBC_t, [d_inner, N, N], dim=-1)
    x = x.reshape(B, L, H, P)
    dtv = Fn.softplus(dt.float() + p["dt_bias"])                      # (B,L,H)
    dA = torch.exp(dtv * -torch.exp(p["A_log"].float()))              # (B,L,H)
    # per-token views, made once: (B,H,1,1), (B,H,P,1), (B,1,1,N), (B,N,1)
    dA_t = dA[..., None, None].unbind(1)
    xdt_t = (dtv[..., None] * x)[..., None].unbind(1)
    B_t = Bv[:, :, None, None, :].unbind(1)
    C_t = Cv[..., None].unbind(1)
    s = state.ssm
    ys = []
    for t in range(L):
        s = torch.addcmul(s * dA_t[t], xdt_t[t], B_t[t])
        ys.append(torch.matmul(s.view(B, H * P, N), C_t[t]))
    y = torch.stack(ys, dim=1).view(B, L, H, P) + x * p["D"][None, None, :, None]
    out = _gate_out(p, y.reshape(B, L, d_inner), z, h.dtype, cfg)
    return out, SSMState(new_conv, s)
