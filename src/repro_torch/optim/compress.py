"""Sketched gradient compression with error feedback: the paper's technique
applied to data-parallel training (ported from ``repro.optim.compress``).

Each gradient block G (p, q) with p ≥ ``min_rows`` is compressed before the
data-parallel mean:  Ĝ = Sᵀ(G + E) (d, q), S an AccumSketch over rows.  The
ranks average Ĝ (d/p of the bytes) and unsketch G̃ = S Ĝ, which equals
P_S(G + E) in expectation.  The residual G + E − S Ĝ stays in the rank's
error-feedback buffer E and joins the next step's gradient.

Leaf i's sketch at step t is drawn from the counter-based host stream
(seed, ``COMPRESS_STREAM``, t, i), so every rank draws the same sketch with
no communication, as the reference's ``fold_in(fold_in(key, t), i)`` does;
the draws are not the reference's (``interop.sketch_from_numpy`` carries
those across).  The sketch is applied by the plain ``sketch_left`` and
``unsketch_mat``, as in the reference: no kernel is launched.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch._util import COMPRESS_STREAM, position_generator, tree_leaves, tree_map
from repro_torch.core.apply import sketch_left, unsketch_mat
from repro_torch.core.distributed import all_reduce_mean
from repro_torch.core.sketch import AccumSketch, make_accum_sketch
from repro_torch.sharding import distribute_like, full

PyTree = Any


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    """Sketch size d = ratio·p with m accumulations, for blocks of at least
    ``min_rows`` rows."""

    ratio: float = 0.125
    m: int = 4
    min_rows: int = 1024


def _eligible(x: torch.Tensor, cfg: CompressConfig) -> bool:
    return x.ndim >= 2 and x.shape[0] >= cfg.min_rows


def init_error_feedback(grads: PyTree, cfg: CompressConfig) -> PyTree:
    """Float32 zeros for every eligible leaf, None for the others."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                    if _eligible(g, cfg) else None, grads)


def leaf_sketch(seed: int, step: int, i: int, p: int, cfg: CompressConfig,
                device) -> AccumSketch:
    """Leaf i's sketch at ``step``: (p rows, d = max(⌊p·ratio⌋, 1), m),
    drawn on the host and moved to ``device``."""
    g = position_generator(seed, COMPRESS_STREAM, step, i)
    return make_accum_sketch(g, p, max(int(p * cfg.ratio), 1), cfg.m, device=device)


def compress_leaf(sk: AccumSketch, g: torch.Tensor, e: torch.Tensor, mesh=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One block through the sketch: Ĝ = Sᵀ(g + e), averaged over ``mesh``'s
    ranks when given, and G̃ = S Ĝ.  Returns (G̃ in g's dtype, the new error
    feedback g + e − G̃ in float32)."""
    p = g.shape[0]
    gf = g.float().reshape(p, -1) + e.reshape(p, -1)
    sketched = sketch_left(sk, gf)
    if mesh is not None:
        sketched = all_reduce_mean(sketched, mesh)
    recon = unsketch_mat(sk, sketched)
    return recon.reshape(g.shape).to(g.dtype), gf.sub_(recon).reshape(g.shape)


def compress_grads(grads: PyTree, ef: PyTree, step: int, seed: int, cfg: CompressConfig,
                   *, mesh=None, like: PyTree | None = None) -> tuple[PyTree, PyTree, dict]:
    """Returns (the gradients, eligible leaves through ``compress_leaf`` and
    the others as they are — every leaf averaged over ``mesh``'s ranks when
    given —, the new error-feedback tree, {"compress_ratio": the bytes sent
    over the bytes of the uncompressed float32 gradients}).  With ``like``
    (the parameters, DTensors on a 2-D mesh), each gradient leaf is gathered
    whole, compressed and placed back as its parameter is before the next
    one is gathered, so that a rank holds one whole gradient leaf at a
    time."""
    out, new_ef = [], []
    bytes_full = bytes_comp = 0
    likes = None if like is None else tree_leaves(like)
    for i, (g, e) in enumerate(zip(tree_leaves(grads), tree_leaves(ef))):
        bytes_full += g.numel() * 4
        if likes is not None:
            g = full(g)
        if e is None or not _eligible(g, cfg):
            o = g if mesh is None else all_reduce_mean(g, mesh)
            new_ef.append(None)
            bytes_comp += g.numel() * 4
        else:
            sk = leaf_sketch(seed, int(step), i, g.shape[0], cfg, g.device)
            o, e_new = compress_leaf(sk, g, e, mesh)
            new_ef.append(e_new)
            bytes_comp += sk.d * (g.numel() // g.shape[0]) * 4
        out.append(o if likes is None else distribute_like(o, likes[i]))
        del g, o
    it_out, it_ef = iter(out), iter(new_ef)
    return (tree_map(lambda _: next(it_out), grads), tree_map(lambda _: next(it_ef), grads),
            {"compress_ratio": bytes_comp / max(bytes_full, 1)})
