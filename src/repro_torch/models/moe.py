"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch
(ported from ``repro.models.moe``, its single-device path).

Sort-based (MegaBlocks-flavoured) dispatch keeps memory at O(T·k + E·C·D)
instead of the O(T·E·C) one-hot combine tensor.  Expert compute is one
batched product over the (E, C, D) buffer.

The reference fills the buffer with a scatter-add and combines with another
(``zeros.at[tok].add``).  On the card a scatter-add with repeated indices
sums in whatever order the atomics land, which would break the bitwise
guarantees of resumed decode and training.  Here both directions are
gathers: the buffer row (e, c) reads the c-th sorted entry routed to expert
e, and each token reads its K expert outputs through the inverse of the
sort permutation and sums them in a fixed order (ascending expert, the
reference's own order of application).  No float atomics anywhere.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import MoECfg
from repro_torch.models.common import PARAM_DTYPE, dense_init
from repro_torch.models.ffn import ffn_forward, init_ffn


class MoEMetrics(NamedTuple):
    """The load-balancing auxiliary loss and the fraction of the T·K routed
    entries dropped by the capacity, both float32 scalars."""
    aux_loss: torch.Tensor
    dropped_fraction: torch.Tensor


def init_moe(generator: torch.Generator, d_model: int, moe: MoECfg,
             dtype=PARAM_DTYPE) -> dict:
    """Router (float32), stacked expert SwiGLU weights (E, D, F) / (E, F, D)
    drawn from ``generator``, a float32 zero norm, and Arctic's dense
    residual FFN where the config has one."""
    E, F = moe.n_experts, moe.d_ff_expert
    p = {
        "router": dense_init(generator, (d_model, E), dtype=torch.float32),
        "wi_gate": dense_init(generator, (E, d_model, F), dtype=dtype),
        "wi_up": dense_init(generator, (E, d_model, F), dtype=dtype),
        "wo": dense_init(generator, (E, F, d_model), dtype=dtype),
        "norm": torch.zeros((d_model,), dtype=torch.float32, device=generator.device),
    }
    if moe.dense_residual:
        p["dense"] = init_ffn(generator, d_model, moe.d_ff_dense, dtype)
    return p


def capacity(n_tokens: int, moe: MoECfg) -> int:
    """Slots per expert: ⌊T·K·capacity_factor / E⌋, at least 4."""
    c = int(n_tokens * moe.top_k * moe.capacity_factor / moe.n_experts)
    return max(c, 4)


class _Route(NamedTuple):
    pos: torch.Tensor     # (T, K) sorted positions of each token's entries, ascending
    weight: torch.Tensor  # (T·K,) sorted entries' gate weights times keep, float32
    slot: torch.Tensor    # (T·K,) sorted entries' buffer rows (e·C + min(rank, C−1))
    keep: torch.Tensor    # (T·K,) float32 1 for kept entries, 0 for dropped
    tope: torch.Tensor    # (T, K) experts chosen, by descending probability
    probs: torch.Tensor   # (T, E) router softmax, float32


def _dispatch(x: torch.Tensor, router: torch.Tensor, moe: MoECfg, C: int
              ) -> tuple[torch.Tensor, _Route]:
    """Sort-based dispatch of the T local tokens into an (E, C, D) buffer;
    returns (xe, routing).  A kept entry of expert e at rank r within e lands
    in row (e, r); entries of rank ≥ C are dropped, as in the reference."""
    T, D = x.shape
    E, K = moe.n_experts, moe.top_k
    dev = x.device
    logits = x.float() @ router.float()                               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topw, tope = torch.topk(probs, K, dim=-1, sorted=True)            # (T, K)
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)

    e_f = tope.reshape(-1)                                            # (T·K,)
    w_f = topw.reshape(-1)
    tok_f = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.sort(e_f, stable=True).indices
    e_s, w_s, tok_s = e_f[order], w_f[order], tok_f[order]
    # each expert's run in the sorted entries (bincount would read its max
    # back to the host on the card)
    experts = torch.arange(E, device=dev, dtype=e_s.dtype)
    starts = torch.searchsorted(e_s, experts)                         # (E,)
    counts = torch.searchsorted(e_s, experts, right=True) - starts
    pos_s = torch.arange(T * K, device=dev) - starts[e_s]             # rank within expert
    keep = (pos_s < C).float()
    slot = e_s * C + torch.clamp_max(pos_s, C - 1)

    # buffer row (e, c) reads sorted entry starts[e] + c when c < counts[e]
    c_idx = torch.arange(C, device=dev)
    filled = c_idx[None, :] < counts[:, None]                         # (E, C)
    rows = torch.clamp_max(starts[:, None] + c_idx[None, :], T * K - 1)
    xe = torch.where(filled[..., None], x[tok_s[rows]], torch.zeros((), dtype=x.dtype,
                                                                     device=dev))
    # each token's K entries in sorted order: the inverse permutation
    pos = torch.sort(torch.argsort(order).reshape(T, K), dim=1).values
    return xe, _Route(pos, keep * w_s, slot, keep, tope, probs)


def _combine(ye_flat: torch.Tensor, route: _Route, T: int, dtype) -> torch.Tensor:
    """(E·C, D) expert outputs → (T, D): each token's K weighted outputs
    summed one after another in ascending expert order (dropped entries add
    exact zeros), in ``dtype`` — a gather, no scatter."""
    y_s = ye_flat[route.slot] * route.weight[:, None].to(dtype)       # (T·K, D)
    y_tk = y_s[route.pos]                                             # (T, K, D)
    out = torch.zeros((T, ye_flat.shape[-1]), dtype=dtype, device=ye_flat.device)
    for k in range(y_tk.shape[1]):
        out = out + y_tk[:, k]
    return out


def _experts(xe: torch.Tensor, wig: torch.Tensor, wiu: torch.Tensor, wo: torch.Tensor,
             dtype) -> torch.Tensor:
    """SwiGLU of every expert on its (C, D) rows: (E, C, D) → (E, C, D), the
    gate's silu in float32."""
    g = torch.nn.functional.silu(torch.bmm(xe, wig).float())
    u = torch.bmm(xe, wiu)
    return torch.bmm(g.to(dtype) * u, wo)


def _metrics(route: _Route, E: int, T: int, K: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(aux loss E·Σ frac_tokens·frac_probs over the top-1 choices, dropped
    fraction of the T·K entries)."""
    experts = torch.arange(E, device=route.tope.device)
    frac_tokens = torch.mean((route.tope[:, :1] == experts).float(), dim=0)
    frac_probs = torch.mean(route.probs, dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    dropped = 1.0 - torch.sum(route.keep) / (T * K)
    return aux, dropped


def moe_forward_local(p: dict, h: torch.Tensor, moe: MoECfg
                      ) -> tuple[torch.Tensor, MoEMetrics]:
    """Single-device path: dispatch over all T = B·S tokens."""
    B, S, D = h.shape
    T = B * S
    x = h.reshape(T, D)
    xe, route = _dispatch(x, p["router"], moe, capacity(T, moe))
    ye = _experts(xe, p["wi_gate"], p["wi_up"], p["wo"], h.dtype)
    out = _combine(ye.reshape(-1, D), route, T, h.dtype)
    if moe.dense_residual:
        out = out + ffn_forward(p["dense"], x)
    aux, dropped = _metrics(route, moe.n_experts, T, moe.top_k)
    return out.reshape(B, S, D), MoEMetrics(aux, dropped)


def moe_forward(p: dict, h: torch.Tensor, moe: MoECfg) -> tuple[torch.Tensor, MoEMetrics]:
    """h: (B, S, D) → (B, S, D).  Capacity-dropped tokens pass through (residual).

    Uses the a2a expert-parallel path when running under a mesh with a
    non-trivial `model` axis and divisible shapes; otherwise the local path."""
    # The port has no mesh with a `model` axis (launch/mesh.py raises for
    # n_model > 1): the expert-parallel path, _moe_forward_a2a, waits for the
    # 2-D parameter mesh (ROADMAP queue 1, "2-D parameter mesh"), so this is
    # always local.
    return moe_forward_local(p, h, moe)
