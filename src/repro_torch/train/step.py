"""train_step: loss → gradients → data-parallel mean (optionally through
the sketched compression) → AdamW (ported from ``repro.train.step``).

Microbatches accumulate g / n_micro in float32 one after another, so the
activations of one microbatch are alive at a time; the remat policy is a
config field.  On a ``DataMesh`` of D > 1 ranks each rank holds the
replicated parameters and its slice of the batch, and every gradient is
averaged over the ranks (``core.distributed.all_reduce``: the data axis
pjit reduces implicitly in the reference) — with compression, eligible
leaves through ``compress_leaf`` and the rest as they are.  AdamW then runs
replicated, so the ranks' parameters stay bitwise equal.

On a 2-D ``sharding.Mesh`` the state is DTensors placed by the reference's
rules (``place_train_state``: ``params_shardings``, ZeRO-1
``opt_shardings``, the error feedback replicated) and the batch
``batch_spec``-sharded; the step runs inside ``with mesh:``, each gradient
is redistributed to its parameter's placements — the data-parallel mean is
the one DTensor's reductions imply, as pjit's is — and AdamW updates the
shards.  Compression sketches each gradient whole (the replicated error
feedback's layout, the reference's global arrays) and keeps the result's
shard.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch._util import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed import all_reduce_mean
from repro_torch.models.model import loss_fn
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_update, init_adamw
from repro_torch.optim.compress import CompressConfig, compress_grads, init_error_feedback
from repro_torch.sharding import (
    Mesh,
    batch_spec,
    distribute,
    full,
    is_dtensor,
    opt_shardings,
    params_shardings,
    shard_tree,
)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One training step's settings: ``remat`` is "none", "dots" or "full"
    ("full" keeps each superblock's input as the only cross-layer
    activation)."""

    optimizer: AdamWConfig = AdamWConfig()
    n_micro: int = 1
    remat: str = "full"
    q_chunk: int = 512
    compress: CompressConfig | None = None
    seed: int = 0


class TrainState(NamedTuple):
    """Parameters, optimizer state and error-feedback buffers (None without
    compression)."""

    params: PyTree
    opt: AdamWState
    ef: PyTree | None


def init_train_state(params: PyTree, tc: TrainConfig) -> TrainState:
    """The state a run starts from: fresh AdamW state and, with compression,
    zero error feedback."""
    ef = init_error_feedback(params, tc.compress) if tc.compress is not None else None
    return TrainState(params, init_adamw(params), ef)


def place_train_state(state: TrainState, mesh: Mesh, policy: str = "default") -> TrainState:
    """A whole (unsharded) state on ``mesh``: the parameters placed by
    ``params_shardings``, the AdamW state by ``opt_shardings`` (m, v and
    master inherit the parameters' specs, the step stays on the host), the
    error feedback replicated (a whole tensor on every rank, as the
    reference places it)."""
    psh = params_shardings(mesh, state.params, policy)
    osh = opt_shardings(mesh, state.opt, psh)
    opt = type(state.opt)(state.opt.step, *(shard_tree(t, mesh, sh) for t, sh in
                                              zip(state.opt[1:], osh[1:])))
    return TrainState(shard_tree(state.params, mesh, psh), opt, state.ef)


def _value_and_grad(params, tokens, labels, cond, cfg: ModelConfig, tc: TrainConfig):
    """(loss, metrics, gradients in the parameters' dtypes) of one batch."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    loss, mets = loss_fn(live, tokens, labels, cfg, cond=cond, q_chunk=tc.q_chunk,
                         remat=tc.remat)
    # a leaf the loss does not reach (Arctic's dense residual keeps its FFN's
    # norm, unused) gets a zero gradient, as in the reference
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    it = iter(grads)
    return loss.detach(), {k: v.detach() for k, v in mets.items()}, tree_map(
        lambda _: next(it), params)


def _grads(params, tokens, labels, cond, cfg: ModelConfig, tc: TrainConfig):
    if tc.n_micro == 1:
        return _value_and_grad(params, tokens, labels, cond, cfg, tc)
    B = tokens.shape[0]
    if B % tc.n_micro:
        raise ValueError(f"batch {B} does not split into {tc.n_micro} microbatches")
    mb = B // tc.n_micro
    acc = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), params)
    loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for k in range(tc.n_micro):
        sl = slice(k * mb, (k + 1) * mb)
        c = cond[sl] if cond is not None else None
        lk, mets, g = _value_and_grad(params, tokens[sl], labels[sl], c, cfg, tc)
        for a, gk in zip(tree_leaves(acc), tree_leaves(g)):
            a.add_(gk.float() / tc.n_micro)
        loss = loss + lk / tc.n_micro
    return loss, mets, acc


def train_step(state: TrainState, tokens: torch.Tensor, labels: torch.Tensor, step: int,
               cfg: ModelConfig, tc: TrainConfig, *, cond: torch.Tensor | None = None,
               mesh=None) -> tuple[TrainState, dict]:
    """One step on this rank's (tokens, labels) (B, S).  ``state`` is donated:
    its optimizer and error-feedback tensors are updated in place.  Returns
    (the new state, {"loss" (averaged over the mesh), "xent", "aux",
    "tokens", ["compress_ratio"], "grad_norm", "lr"})."""
    if isinstance(mesh, Mesh):
        return _train_step_sharded(state, tokens, labels, step, cfg, tc, cond, mesh)
    if mesh is not None and mesh.size == 1:
        mesh = None                      # the mean over one rank is the identity
    loss, mets, grads = _grads(state.params, tokens, labels, cond, cfg, tc)
    if mesh is not None:
        loss = all_reduce_mean(loss, mesh)
    ef = state.ef
    if tc.compress is not None:
        grads, ef, cmets = compress_grads(grads, ef, step, tc.seed, tc.compress, mesh=mesh)
        mets = {**mets, **cmets}
    elif mesh is not None:
        grads = tree_map(lambda g: all_reduce_mean(g, mesh), grads)
    new_params, new_opt, omets = adamw_update(grads, state.opt, tc.optimizer)
    return TrainState(new_params, new_opt, ef), {"loss": loss, **mets, **omets}


def _train_step_sharded(state: TrainState, tokens, labels, step: int, cfg: ModelConfig,
                        tc: TrainConfig, cond, mesh: Mesh) -> tuple[TrainState, dict]:
    """``train_step`` on a 2-D mesh: the state DTensors, (tokens, labels)
    the global batch (DTensors, or whole tensors placed here by
    ``batch_spec``).  The metrics come back as whole tensors."""
    def like_param(g, p):
        return g if list(g.placements) == list(p.placements) else g.redistribute(
            p.device_mesh, p.placements)

    def placed(t):
        if t is None or is_dtensor(t):
            return t
        return distribute(t, mesh, batch_spec(mesh, t.shape[0], extra_dims=t.ndim - 1,
                                              policy=cfg.sharding_policy))

    tokens, labels, cond = placed(tokens), placed(labels), placed(cond)
    with mesh:
        loss, mets, grads = _grads(state.params, tokens, labels, cond, cfg, tc)
        # a gradient's partial sums over the data ranks reduce here (the
        # data-parallel mean of the global batch's loss)
        it = iter(tree_leaves(state.params))
        grads = tree_map(lambda g: like_param(g, next(it)), grads)
        ef = state.ef
        if tc.compress is not None:
            # each leaf gathered whole, compressed against the replicated
            # error feedback and placed back, one leaf at a time
            grads, ef, cmets = compress_grads(grads, ef, step, tc.seed, tc.compress,
                                              like=state.params)
            mets = {**mets, **cmets}
        new_params, new_opt, omets = adamw_update(grads, state.opt, tc.optimizer)
    mets = {k: full(v) for k, v in {"loss": loss, **mets, **omets}.items()}
    return TrainState(new_params, new_opt, ef), mets
