"""Carry a sketch, an engine state, a fitted model, model parameters or a
decode cache of the JAX package across as numpy arrays, so that the port can
be held against the reference on the same draw and the same weights.

The port's own draws come from a ``torch.Generator`` and do not reproduce
JAX's threefry bits; these builders take the reference's (indices, signs,
probs) instead.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._util import resolve_device, tree_map
from repro_torch.core.kernel_op import KernelOperator
from repro_torch.core.krr import SketchedKRR
from repro_torch.core.sketch import AccumSketch, AccumState, _compute_coef


def sketch_from_numpy(indices, signs, probs, n: int, coef=None, *,
                      device) -> AccumSketch:
    """The port's ``AccumSketch`` for a reference draw.  ``coef`` (the
    reference's cached coefficients, e.g. after ``truncated``) defaults to
    r/sqrt(d·m·p) computed here.  Indices are checked against ``n`` here, on
    the host."""
    device = resolve_device(device)
    indices = np.asarray(indices)
    if indices.ndim != 2 or indices.size and not (
            0 <= indices.min() and indices.max() < n):
        raise ValueError(f"indices must be an (m, d) array in [0, {n})")
    idx = torch.as_tensor(indices.astype(np.int32), device=device)
    sg = torch.tensor(np.asarray(signs), device=device)
    pr = torch.tensor(np.asarray(probs), device=device)
    cf = (_compute_coef(idx, sg, pr) if coef is None
          else torch.tensor(np.asarray(coef), device=device))
    return AccumSketch(indices=idx, signs=sg, probs=pr, n=n, coef_=cf)


def state_from_numpy(indices, signs, probs, pdraw, n: int, *, device,
                     scheme: str = "uniform") -> AccumState:
    """The empty engine state (C and W zero, m = 0, err = +inf) for a
    reference ``accum_init`` draw: its (m_max, d) indices and signs, its
    (n,) probs and its (m_max, d) at-draw probabilities ``pdraw``."""
    device = resolve_device(device)
    sk = sketch_from_numpy(indices, signs, probs, n, device=device)
    m_max, d = sk.indices.shape
    return AccumState(
        indices=sk.indices, signs=sk.signs, probs=sk.probs,
        pdraw=torch.tensor(np.asarray(pdraw), device=device),
        C=torch.zeros((n, d), dtype=torch.float32, device=device),
        W=torch.zeros((d, d), dtype=torch.float32, device=device),
        m=0, err=float("inf"), n=n, scheme=scheme)


def krr_from_numpy(theta, indices, signs, probs, X_train, kernel: str,
                   bandwidth: float, nu: float = 1.5, *,
                   device) -> SketchedKRR:
    """A ``SketchedKRR`` whose ``predict`` equals the reference model's: the
    operator over ``X_train`` with the named kernel, the reference's sketch
    and its θ.  ``fitted`` is left empty."""
    device = resolve_device(device)
    X = torch.tensor(np.asarray(X_train), device=device)
    sk = sketch_from_numpy(indices, signs, probs, X.shape[0], device=device)
    op = KernelOperator(X, kernel, bandwidth, nu)
    th = torch.tensor(np.asarray(theta), device=device)
    return SketchedKRR(th, sk, None, X, op.kernel_fn, None, op=op)


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 from ml_dtypes included) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, cfg, *, device) -> dict:
    """The port's parameters for the reference's ``init_params`` pytree with
    numpy leaves: the same nested names, every tensor carried over in its
    dtype (stacked over superblocks as in the reference).  The layout is
    checked against ``cfg``."""
    from repro_torch.models.model import _check_cfg

    _check_cfg(cfg)
    device = resolve_device(device)
    params = tree_map(lambda a: _tensor(a, device), tree)
    if tuple(params["embed"].shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed has shape {tuple(params['embed'].shape)}, config "
                         f"wants {(cfg.vocab_size, cfg.d_model)}")
    for key, blk in params["blocks"].items():
        if blk["attn"]["wq"].shape[0] != cfg.n_superblocks:
            raise ValueError(f"blocks/{key} is not stacked over {cfg.n_superblocks} "
                             "superblocks")
    return params


def cache_from_numpy(cache, *, device):
    """The port's ``SketchCache`` or ``KVCache`` for a reference cache with
    numpy (or array-like) fields ``(k_sum, v_sum, mass)`` or ``(k, v)``."""
    from repro_torch.core.sketched_attention import SketchCache
    from repro_torch.models.attention import KVCache

    device = resolve_device(device)
    if hasattr(cache, "k_sum"):
        return SketchCache(*(_tensor(x, device) for x in (cache.k_sum, cache.v_sum,
                                                          cache.mass)))
    return KVCache(_tensor(cache.k, device), _tensor(cache.v, device))
