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

On a mesh (DTensors) the parts that are local to a batch row and a head
run on each rank's shards, as GSPMD partitions the reference's program:
the conv's padding (``_pad_front``), the chunked SSD core on the rank's
heads (``_ssd_on_shards``: the chunk and position dims whole, ``Bm`` and
``Cm``, which every head shares, whole on each model rank, their scores
summed over the model ranks' shares of N), and the
decode's and the prefill's reads and scan of the state on the rank's shard
of it (``_read_state``, ``_scan_on_shards``).  DTensor's own rules there
flatten a split dimension behind the first of the flattened ones, or pad,
which DTensor of torch 2.11 refuses (``analysis.trace``'s ``refused``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from repro_torch._util import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import PARAM_DTYPE, dense_init, rmsnorm
from repro_torch.sharding import constrain, from_local, is_dtensor


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
    """h @ in_proj split into (z, xBC, dt).  On a mesh the product's columns
    are pinned on "model", as the weight's are: its gradient then reaches
    the weight's product split so, not whole on every model rank."""
    d_inner, H, P, N = _dims(cfg)
    zxbcdt = constrain(h @ p["in_proj"], "dp", None, "tp", policy=cfg.sharding_policy)
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)


def _causal_conv(p: dict, xBC: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Depthwise causal conv along L in xBC's dtype, SiLU in float32.
    xBC: (B, L, Cch)."""
    W = cfg.ssm.conv_width
    L = xBC.shape[1]
    pad = _pad_front(xBC, W - 1)
    out = pad[:, 0:L, :] * p["conv_w"][0].to(xBC.dtype)
    for i in range(1, W):
        out = out + pad[:, i:i + L, :] * p["conv_w"][i].to(xBC.dtype)
    return Fn.silu((out + p["conv_b"].to(xBC.dtype)).float()).to(xBC.dtype)


def _pad_front(x: torch.Tensor, n: int) -> torch.Tensor:
    """``Fn.pad(x, (0, 0, n, 0))``: x (B, L, C) with n zero positions before
    its first.  A DTensor is padded on each rank's shard, its length whole
    (a split of it, or a partial sum, made whole first)."""
    if not is_dtensor(x):
        return Fn.pad(x, (0, 0, n, 0))
    from torch.distributed.tensor import Replicate, Shard

    pls = [Replicate() if pl == Shard(1) or pl.is_partial() else pl for pl in x.placements]
    if pls != list(x.placements):
        x = x.redistribute(x.device_mesh, pls)
    B, L, C = x.shape
    return from_local(Fn.pad(x.to_local(), (0, 0, n, 0)), x.device_mesh, pls, (B, L + n, C))


def _merge_heads(y: torch.Tensor, shape) -> torch.Tensor:
    """y (…, H, P) reshaped to ``shape`` (…, H·P).  On a mesh a split of P is
    gathered first: DTensor of torch 2.11 refuses to flatten a split
    dimension behind the first of the flattened ones."""
    if is_dtensor(y):
        from torch.distributed.tensor import Replicate, Shard

        pls = [Replicate() if pl == Shard(y.ndim - 1) else pl for pl in y.placements]
        if pls != list(y.placements):
            y = y.redistribute(y.device_mesh, pls)
    return y.reshape(shape)


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

    z, xBC, dt = _split_proj(p, h, cfg)
    xBC = _causal_conv(p, xBC, cfg)
    x, Bm, Cm = torch.split(xBC, [d_inner, N, N], dim=-1)
    x = x.reshape(B, L, H, P)
    dt = Fn.softplus(dt.float() + p["dt_bias"])                       # (B, L, H)
    A = -torch.exp(p["A_log"].float())                                # (H,)

    # chunked SSD
    dA = (dt * A).reshape(B, nc, Q, H)                                # (B,c,q,H) f32
    xdt = (x.float() * dt[..., None]).reshape(B, nc, Q, H, P)
    Bc = Bm.float().reshape(B, nc, Q, N)
    Cc = Cm.float().reshape(B, nc, Q, N)
    if is_dtensor(dA):
        y = _ssd_on_shards(dA, xdt, Bc, Cc, cfg)
    else:
        y = _ssd(dA, xdt, Bc, Cc, torch.einsum("bcin,bcjn->bcij", Cc, Bc))
    y = y.reshape(B, L, H, P) + x.float() * p["D"][None, None, :, None]
    return _gate_out(p, _merge_heads(y, (B, L, d_inner)), z, h.dtype, cfg)


def _ssd(dA: torch.Tensor, xdt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
         scores: torch.Tensor) -> torch.Tensor:
    """The chunked SSD core, float32: dA (B, c, Q, H), xdt (B, c, Q, H, P),
    Bc and Cc (B, c, Q, N) and the intra-chunk scores Cc·Bcᵀ (B, c, Q, Q)
    → y_diag + y_off (B, c, Q, H, P)."""
    B, nc, Q, H, P = xdt.shape
    N = Bc.shape[-1]
    dA_cs = torch.cumsum(dA, dim=2)                                   # within-chunk cumsum
    dA_sum = dA_cs[:, :, -1, :]                                       # (B,c,H)

    # intra-chunk (diagonal blocks): Y_ii, first (scores·decay) over (i, j, H),
    # then the product over j
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]           # (B,c,i,j,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dA.device))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    sd = (scores[..., None] * decay).permute(0, 1, 4, 2, 3)           # (B,c,H,i,j)
    y_diag = torch.matmul(sd, xdt.permute(0, 1, 3, 2, 4))             # (B,c,H,i,P)
    y_diag = y_diag.permute(0, 1, 3, 2, 4)                            # (B,c,i,H,P)
    del seg, decay, sd

    # chunk states: first the decay into xdt, then the product over j
    decay_out = torch.exp(dA_sum[:, :, None, :] - dA_cs)              # (B,c,j,H)
    xd = (decay_out[..., None] * xdt).reshape(B, nc, Q, H * P)        # (B,c,j,H·P)
    states = torch.matmul(xd.transpose(2, 3), Bc).reshape(B, nc, H, P, N)

    # inter-chunk scan: the state entering each chunk
    s = torch.zeros((B, H, P, N), dtype=torch.float32, device=dA.device)
    prevs = []
    for c in range(nc):
        prevs.append(s)
        s = s * torch.exp(dA_sum[:, c])[:, :, None, None] + states[:, c]
    s_prevs = torch.stack(prevs, dim=1)                               # (B,c,H,P,N)

    # off-diagonal: first over n, then the decay
    y_off = torch.matmul(Cc, s_prevs.reshape(B, nc, H * P, N).transpose(2, 3))
    y_off = y_off.reshape(B, nc, Q, H, P) * torch.exp(dA_cs)[..., None]
    return y_diag + y_off


def _ssd_on_shards(dA, xdt, Bc, Cc, cfg: ModelConfig) -> torch.Tensor:
    """``_ssd`` of DTensors on each rank's shards, as the reference's
    partitioned program computes it: dA and xdt pinned with the batch on
    the data axes and the heads on "model" (where it divides them), Bc and
    Cc with the batch alone, whole on each model rank (every head reads
    them); the chunk and position dims whole.  The scores Cc·Bcᵀ, which no
    head splits, contract each model rank's share of N and are summed over
    "model" (the reference's per-partition product).  The core runs on the
    local shards, and its result (made contiguous: the sum takes y_diag's
    permuted strides) is a DTensor placed as xdt.  A rank's gradient of Bc,
    Cc and the scores covers its own heads: a partial sum over the mesh
    dims that split them, which the constraints' gradients reduce."""
    from torch.distributed.tensor import Partial, Shard

    pol = cfg.sharding_policy
    scores = torch.einsum("bcin,bcjn->bcij",
                          *(constrain(t, "dp", None, None, "tp", policy=pol) for t in (Cc, Bc)))
    dA = constrain(dA, "dp", None, None, "tp", policy=pol)
    xdt = constrain(xdt, "dp", None, None, "tp", None, policy=pol)
    Bc, Cc, scores = (constrain(t, "dp", None, None, None, policy=pol) for t in (Bc, Cc, scores))
    shared = [Partial() if hp == Shard(3) else pl for hp, pl in zip(dA.placements, Bc.placements)]
    y = _ssd(dA.to_local(), xdt.to_local(), *(t.to_local(grad_placements=shared)
                                              for t in (Bc, Cc, scores)))
    return from_local(y.contiguous(), xdt.device_mesh, xdt.placements, xdt.shape)


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
    y = _read_state(Cv, s) + x * p["D"][None, :, None]
    out = _gate_out(p, _merge_heads(y, (B, 1, d_inner)), z, h_t.dtype, cfg)
    return out, _placed_as(SSMState(new_conv, s), state)


def _placed_as(new: SSMState, old: SSMState) -> SSMState:
    """``new`` with each DTensor leaf placed as ``old``'s (a decode cache
    keeps its layout from step to step)."""
    return SSMState(*(n.redistribute(o.device_mesh, o.placements)
                      if is_dtensor(n) and n.placements != o.placements else n
                      for n, o in zip(new, old)))


def _state_box(s: torch.Tensor) -> list:
    """The placements that keep a state DTensor s (B, H, P, N) split as it
    is by batch rows, heads and head dims, and whole along N."""
    from torch.distributed.tensor import Replicate, Shard

    return [pl if isinstance(pl, Shard) and pl.dim < 3 else Replicate() for pl in s.placements]


def _cut(x: torch.Tensor, box: list, dims: tuple) -> torch.Tensor:
    """The local shard of the DTensor ``x`` that covers the batch rows (and
    heads, head dims) of a state shard placed by ``box``: ``dims`` maps
    the state's dims 0, 1, 2 to x's, None where x has no such dim."""
    from torch.distributed.tensor import Replicate, Shard

    pls = [Shard(dims[pl.dim]) if isinstance(pl, Shard) and dims[pl.dim] is not None
           else Replicate() for pl in box]
    return x.redistribute(x.device_mesh, pls).to_local()


def _read_state(c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """C·h: ``einsum("bn,bhpn->bhp", c, s)``; on a mesh on each rank's shard
    of the state (its batch rows, heads and head dims, N whole on the rank),
    the result split as the state is."""
    if not is_dtensor(s):
        return torch.einsum("bn,bhpn->bhp", c, s)
    box = _state_box(s)
    y = torch.einsum("bn,bhpn->bhp", _cut(c, box, (0, None, None)), _cut(s, box, (0, 1, 2)))
    return from_local(y, s.device_mesh, box, s.shape[:3])


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
    xdt = dtv[..., None] * x
    if is_dtensor(state.ssm):
        y, s = _scan_on_shards(dA, xdt, Bv, Cv, state.ssm)
    else:
        y, s = _scan(dA, xdt, Bv, Cv, state.ssm)
    y = y + x * p["D"][None, None, :, None]
    out = _gate_out(p, _merge_heads(y, (B, L, d_inner)), z, h.dtype, cfg)
    return out, _placed_as(SSMState(new_conv, s), state)


def _scan(dA, xdt, Bv, Cv, s) -> tuple[torch.Tensor, torch.Tensor]:
    """The state's recurrence token by token: dA (B, L, H), xdt (B, L, H, P),
    Bv and Cv (B, L, N), s (B, H, P, N) → (the C·h of every token (B, L, H,
    P), the last state)."""
    B, L, H, P = xdt.shape
    N = s.shape[-1]
    # per-token views, made once: (B,H,1,1), (B,H,P,1), (B,1,1,N), (B,N,1)
    dA_t = dA[..., None, None].unbind(1)
    xdt_t = xdt[..., None].unbind(1)
    B_t = Bv[:, :, None, None, :].unbind(1)
    C_t = Cv[..., None].unbind(1)
    ys = []
    for t in range(L):
        s = torch.addcmul(s * dA_t[t], xdt_t[t], B_t[t])
        ys.append(torch.matmul(s.view(B, H * P, N), C_t[t]))
    return torch.stack(ys, dim=1).view(B, L, H, P), s


def _scan_on_shards(dA, xdt, Bv, Cv, s) -> tuple[torch.Tensor, torch.Tensor]:
    """``_scan`` of DTensors on each rank's shard of the state s (its batch
    rows, heads and head dims; N whole on the rank), the token inputs cut
    to the same: (the C·h of every token, split as the state is, the last
    state, placed as s)."""
    from torch.distributed.tensor import Shard

    box = _state_box(s)
    y, last = _scan(_cut(dA, box, (0, 2, None)), _cut(xdt, box, (0, 2, 3)),
                    _cut(Bv, box, (0, None, None)), _cut(Cv, box, (0, None, None)),
                    _cut(s, box, (0, 1, 2)))
    dm = s.device_mesh
    y_pls = [Shard((0, 2, 3)[pl.dim]) if isinstance(pl, Shard) else pl for pl in box]
    return (from_local(y, dm, y_pls, xdt.shape),
            from_local(last, dm, box, s.shape).redistribute(dm, s.placements))
