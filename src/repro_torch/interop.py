"""Carry a sketch or a fitted model of the JAX package across as numpy
arrays, so that the port can be held against the reference on the same draw.

The port's own draws come from a ``torch.Generator`` and do not reproduce
JAX's threefry bits; these builders take the reference's (indices, signs,
probs) instead.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._util import resolve_device
from repro_torch.core.kernel_op import KernelOperator
from repro_torch.core.krr import SketchedKRR
from repro_torch.core.sketch import AccumSketch, _compute_coef


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
