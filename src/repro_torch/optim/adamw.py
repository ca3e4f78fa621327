"""AdamW with float32 master copies, global-norm clipping and a cosine
schedule (ported from ``repro.optim.adamw``).

Plain functions over the port's parameter dicts, with the reference's
arithmetic: the update runs on float32 master weights, which are cast back
to ``param_dtype``; the gradient's float32 global norm clips it; the rate
warms up linearly, then decays on a cosine; norms, biases and 1-D leaves
take no weight decay (by the same path names).  ``torch.optim.AdamW`` is
not used: it keeps no master copy and decays every parameter it is given.

On a 2-D mesh the leaves are DTensors and every operation runs on the
shards; the global norm's sums reduce over the mesh.

The state is donated, as the reference's jitted step donates it:
``adamw_update`` writes the new ``m``, ``v`` and ``master`` into the given
state's tensors, one leaf at a time, so the float32 state (12 bytes a
parameter) is never held twice.  The step counter and the schedule live on
the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch._util import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """The optimizer's hyper-parameters (the reference's defaults)."""

    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    """Optimizer state: ``step`` a 0-d int32 tensor on the host; ``m``,
    ``v`` and ``master`` float32 trees shaped like the parameters."""

    step: torch.Tensor
    m: PyTree
    v: PyTree
    master: PyTree


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``lr_min``: a 0-d float32 tensor
    on the host, computed in float32 as the reference does."""
    step_f = torch.as_tensor(step).to(device="cpu", dtype=torch.float32)
    warm = cfg.lr_peak * step_f / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step_f - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (1 + torch.cos(math.pi * prog))
    return torch.where(step_f < cfg.warmup_steps, warm, cos)


def init_adamw(params: PyTree) -> AdamWState:
    """Zero moments and a float32 copy of every parameter (a copy even of a
    float32 leaf, so that the master never aliases a parameter).  Sharded
    parameters (DTensors) give state placed as they are (ZeRO-1)."""
    def zeros(t):
        return torch.zeros_like(t, dtype=torch.float32)

    return AdamWState(torch.zeros((), dtype=torch.int32), tree_map(zeros, params),
                      tree_map(zeros, params),
                      tree_map(lambda t: t.to(torch.float32, copy=True), params))


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt(Σ x² + 1e-30) over every leaf, in float32 (a 0-d tensor on the
    leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
                      + 1e-30)


def _named_leaves(tree: PyTree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in ``tree_leaves`` order; the path joins the dict
    keys with "/" as the reference's key paths do."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))]
    return [(prefix, tree)]


def _decay_mask(name: str, x: torch.Tensor) -> bool:
    """No weight decay on norms, biases and leaves of fewer than 2 dims."""
    return x.ndim >= 2 and "norm" not in name and "bias" not in name.lower()


def adamw_update(grads: PyTree, state: AdamWState, cfg: AdamWConfig,
                 param_dtype=torch.bfloat16) -> tuple[PyTree, AdamWState, dict]:
    """One AdamW step.  Returns (new parameters: every master leaf cast to
    ``param_dtype``, as the reference's cast does; the new state, whose
    ``m``, ``v`` and ``master`` are ``state``'s tensors updated in place;
    metrics {"grad_norm": float32 on the device, "lr": float32 on the
    host})."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
    lr_t = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.to(torch.float32)
    bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** step_f).item()
    bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** step_f).item()
    lr = lr_t.item()
    for (name, g), m, v, w in zip(_named_leaves(grads), tree_leaves(state.m),
                                  tree_leaves(state.v), tree_leaves(state.master)):
        g = g.float() * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        del g
        u = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if _decay_mask(name, w):
            u.add_(w, alpha=cfg.weight_decay)
        w.sub_(u.mul_(lr))
    new_params = tree_map(lambda w: w.to(param_dtype, copy=True), state.master)
    metrics = {"grad_norm": gnorm, "lr": lr_t}
    return new_params, AdamWState(step, state.m, state.v, state.master), metrics
