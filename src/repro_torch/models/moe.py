"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch
(ported from ``repro.models.moe``).

Sort-based (MegaBlocks-flavoured) dispatch keeps memory at O(T·k + E·C·D)
instead of the O(T·E·C) one-hot combine tensor.  Expert compute is one
batched product over the (E, C, D) buffer, which shards over the `model`
axis (expert parallelism, ``_moe_forward_a2a``).

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

import math
from typing import NamedTuple

import torch

from repro_torch._util import tree_map
from repro_torch.configs.base import MoECfg
from repro_torch.models.common import PARAM_DTYPE, dense_init
from repro_torch.models.ffn import ffn_forward, init_ffn
from repro_torch.sharding import current_mesh, data_axes, from_local, is_dtensor, placements


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
    gate's silu in float32.  Weights of another dtype than the rows (the
    bfloat16 experts the expert-parallel path gathers, against float32
    activations) are promoted with them, as the reference's einsum
    promotes."""
    dt = torch.promote_types(xe.dtype, wig.dtype)
    xe, wig, wiu, wo = (t.to(dt) for t in (xe, wig, wiu, wo))
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


def _sizes(h_shape, moe: MoECfg, dp_size: int, M: int) -> tuple[int, int, int]:
    """(T_loc, T_chunk, C_loc) of the expert-parallel layout: a data shard's
    tokens, each model rank's disjoint 1/M slice of them, and the capacity
    of a slice."""
    B, S, _ = h_shape
    T_loc = (B // dp_size) * S
    T_chunk = T_loc // M
    return T_loc, T_chunk, capacity(T_chunk, moe)


def _moe_forward_a2a(p: dict, h, moe: MoECfg, mesh, dp: tuple, ep: str):
    """Production EP path (GShard/DeepSpeed-MoE pattern) on DTensors, the
    reference's ``shard_map`` body as local tensors and explicit collectives:

      local dispatch → all_to_all over the expert axis → expert GEMMs →
      all_to_all back → local combine.

    Tokens never leave their data shard: only the (E, C, D) expert buffer
    crosses ranks, and only over the `model` (EP) axis.  h is replicated
    over the model axis, so each model rank dispatches a DISJOINT 1/M slice
    of its data shard's tokens at C_loc = capacity(T_chunk) (the tokens
    placed ``Shard(0)`` on the data axes, then on `model`); the combined
    slices are gathered over `model` again by a redistribute, whose
    backward hands each rank its own slice's gradient.

    FSDP composition: expert weights arrive (E_loc, D/|dp|, F)-sharded; they
    are all-gathered over dp in bfloat16 (the reference's explicit cast, half
    the bytes of float32), and their gradients, partial sums over the data
    ranks' tokens, come back reduce-scattered (``grad_placements``
    ``Partial`` on the data axes); the router's gradient sums over every
    rank.  aux and dropped are averaged over all axes.  Returns (out (B, S,
    D), aux, dropped) as DTensors."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate

    B, S, D = h.shape
    E, K = moe.n_experts, moe.top_k
    M = mesh.shape[ep]
    E_loc = E // M
    dp_size = math.prod(mesh.shape[a] for a in dp)
    _, T_chunk, C_loc = _sizes(h.shape, moe, dp_size, M)
    dm = mesh.device_mesh
    dp_spec = None if not dp else dp[0] if len(dp) == 1 else dp
    tok_spec = (dp_spec, None)
    chunk_spec = ((*dp, ep), None)          # a data shard's tokens, split over model
    x = h.redistribute(dm, placements(mesh, (dp_spec, None, None))).reshape(B * S, D)
    x = x.redistribute(dm, placements(mesh, chunk_spec))
    rep = [Replicate()] * len(mesh.axis_names)
    router = p["router"].float().redistribute(dm, rep).to_local(
        grad_placements=[Partial()] * len(mesh.axis_names))

    def expert_weight(name):
        # ZeRO-3 gather over dp, explicitly bfloat16 on the wire
        w = p[name].to(torch.bfloat16) if dp else p[name]
        pl = placements(mesh, (ep, None, None))
        grad = [Partial() if a in dp else q for a, q in zip(mesh.axis_names, pl)]
        return w.redistribute(dm, pl).to_local(grad_placements=grad)

    wig, wiu, wo = (expert_weight(n) for n in ("wi_gate", "wi_up", "wo"))
    group = mesh.group(ep)

    def a2a(t):
        # (M, ...) → (M, ...): block m goes to model rank m, block m of the
        # result came from rank m (its own transpose, which keeps the VJP's
        # shapes aligned)
        return funcol.all_to_all_single_autograd(t.contiguous(), None, None, group)

    xl = x.to_local()
    xe, route = _dispatch(xl, router, moe, C_loc)                  # (E, C_loc, D)
    # dispatch a2a: (M·E_loc, C_loc, D) → (E_loc, M·C_loc, D)
    xe = a2a(xe.reshape(M, E_loc, C_loc, D))
    xe = xe.transpose(0, 1).reshape(E_loc, M * C_loc, D)
    ye = _experts(xe, wig, wiu, wo, xl.dtype)                      # (E_loc, M·C_loc, D)
    # combine a2a: back to (E, C_loc, D) on the source rank
    ye = a2a(ye.reshape(E_loc, M, C_loc, D).transpose(0, 1))
    out = _combine(ye.reshape(E * C_loc, D), route, T_chunk, xl.dtype)
    aux, dropped = _metrics(route, E, T_chunk, K)
    out = from_local(out, dm, placements(mesh, chunk_spec), (B * S, D))
    # restore the replicated-over-model activation layout
    out = out.redistribute(dm, placements(mesh, tok_spec)).reshape(B, S, D)
    n = dp_size * M
    part = [Partial()] * len(mesh.axis_names)
    aux, dropped = (from_local(t, dm, part, ()).redistribute(dm, rep) / n
                    for t in (aux, dropped))
    return out, aux, dropped


def moe_forward_a2a_plain(p: dict, h: torch.Tensor, moe: MoECfg, dp_size: int, M: int
                          ) -> tuple[torch.Tensor, MoEMetrics]:
    """What the expert-parallel path computes on a mesh of ``dp_size`` data
    ranks (the product of the data axes larger than 1) and ``M`` model
    ranks, in one process on whole tensors: the B·S tokens cut into
    dp_size·M slices in rank order, each dispatched at C_loc =
    capacity(T_chunk); a data shard's M buffers concatenated per expert
    (E, M·C_loc, D) through one expert GEMM, as the a2a lays them out; each
    slice combined from its columns; aux and dropped averaged over the
    slices.  The expert weights are cast to bfloat16 once when dp_size > 1
    (the reference gathers them so, float32 parameters included).  A
    reference for the tests and the card's ranks; the model does not call
    it."""
    B, S, D = h.shape
    E, K = moe.n_experts, moe.top_k
    _, T_chunk, C_loc = _sizes(h.shape, moe, dp_size, M)
    x = h.reshape(B * S, D)
    router = p["router"].float()
    ws = [p[n] for n in ("wi_gate", "wi_up", "wo")]
    if dp_size > 1:
        ws = [w.to(torch.bfloat16) for w in ws]
    outs, auxs, drops = [], [], []
    for i in range(dp_size):
        xes, routes = [], []
        for j in range(M):
            c = i * M + j
            xe, route = _dispatch(x[c * T_chunk:(c + 1) * T_chunk], router, moe, C_loc)
            xes.append(xe)
            routes.append(route)
        ye = _experts(torch.cat(xes, dim=1), *ws, h.dtype)         # (E, M·C_loc, D)
        for j, route in enumerate(routes):
            ye_j = ye[:, j * C_loc:(j + 1) * C_loc].reshape(E * C_loc, D)
            outs.append(_combine(ye_j, route, T_chunk, h.dtype))
            aux, dropped = _metrics(route, E, T_chunk, K)
            auxs.append(aux)
            drops.append(dropped)
    out = torch.cat(outs).reshape(B, S, D)
    if moe.dense_residual:
        out = out + ffn_forward(p["dense"], x).reshape(B, S, D)
    n = dp_size * M
    return out, MoEMetrics(sum(auxs) / n, sum(drops) / n)


def _moe_forward_replicated(p: dict, h, moe: MoECfg, mesh
                            ) -> tuple[torch.Tensor, MoEMetrics]:
    """The single-device path under a mesh, on DTensors: h and the weights
    gathered whole on every rank, the dispatch over all T tokens (the
    reference's global semantics under GSPMD), the results replicated.  On a
    mesh of one rank nothing moves."""
    from torch.distributed.tensor import Replicate

    dm = mesh.device_mesh
    rep = [Replicate()] * len(mesh.axis_names)
    out, (aux, dropped) = moe_forward_local(
        tree_map(lambda t: t.redistribute(dm, rep).to_local(), p),
        h.redistribute(dm, rep).to_local(), moe)
    out, aux, dropped = (from_local(t, dm, rep, t.shape) for t in (out, aux, dropped))
    return out, MoEMetrics(aux, dropped)


def _use_a2a(moe: MoECfg, B: int, S: int, D: int, dp_size: int, M: int) -> bool:
    """Whether a mesh of ``dp_size`` data and ``M`` > 1 model ranks takes the
    expert-parallel path: the reference's divisibility conditions."""
    return (M > 1 and moe.n_experts % M == 0 and B % dp_size == 0 and D % dp_size == 0
            and ((B // dp_size) * S) % M == 0)


def moe_forward(p: dict, h: torch.Tensor, moe: MoECfg) -> tuple[torch.Tensor, MoEMetrics]:
    """h: (B, S, D) → (B, S, D).  Capacity-dropped tokens pass through (residual).

    Uses the a2a expert-parallel path when running under a mesh with a
    non-trivial `model` axis and divisible shapes; otherwise the local path
    (on whole tensors under a mesh).  Outside a mesh, and on a tensor that
    is not a DTensor, the single-device path."""
    B, S, D = h.shape
    mesh = current_mesh()
    if mesh is None or not is_dtensor(h):
        return moe_forward_local(p, h, moe)
    use_a2a = False
    if "model" in mesh.shape and mesh.shape["model"] > 1:
        M = mesh.shape["model"]
        dp = tuple(a for a in data_axes(mesh) if mesh.shape[a] > 1)
        use_a2a = _use_a2a(moe, B, S, D, math.prod(mesh.shape[a] for a in dp), M)
    if use_a2a:
        out, aux, dropped = _moe_forward_a2a(p, h, moe, mesh, dp, "model")
        if moe.dense_residual:
            out = out + ffn_forward(p["dense"], h.reshape(B * S, D)).reshape(B, S, D)
        return out, MoEMetrics(aux, dropped)
    return _moe_forward_replicated(p, h, moe, mesh)
