"""Abstract inputs and shardings for every (architecture × input-shape)
dry-run cell (ported from ``repro.launch.specs``).  Nothing is drawn and
nothing is allocated.

The reference's abstract arguments are ``ShapeDtypeStruct``s; the port's
are fake tensors (``torch._subclasses.FakeTensor``: shape, dtype and
device, no data), made under the cell's ``FakeTensorMode``, which the rank
recorder is given while the cell's step runs (``launch.dryrun.run_cell``).
On a mesh of ranks (``sharding.Mesh``, e.g. the production meshes over the
``"fake"`` process group) a sharded argument is a DTensor built from a
fake local shard of this rank's size (``sharding.from_local``), placed by
the spec the reference's rules give; on a mesh that only has a shape
(``AbstractMesh``), on a mesh of one rank and on None the arguments are
whole fake tensors.
``in_shardings`` holds the reference's spec values (``sharding``'s tuples,
equal to its ``PartitionSpec``s), in the arguments' structure.

Values the port keeps on the host are real host tensors, as its entry
points take them: the optimizer's step counter (a 0-d int32 tensor), the
training step, the decode position and the decode step's slot draw
((m_r,) int32).  The decode position is the cache's last one, S − 1, so
the exact decode reads every cached position, as the reference's masked
read does at any position.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch import sharding as shlib
from repro_torch._util import tree_map
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.core.sketched_attention import decode_slots
from repro_torch.models.common import PARAM_DTYPE
from repro_torch.models.model import DecodeCache, decode_step, init_cache, init_params, prefill
from repro_torch.train.step import TrainConfig, init_train_state, train_step

PyTree = Any


class AbstractMesh:
    """A mesh as the sharding rules see it, without ranks: axis name →
    size, in the mesh's order (the counterpart of ``jax.sharding.
    AbstractMesh``)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    @property
    def size(self) -> int:
        """The number of ranks."""
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


class Cell(NamedTuple):
    """Everything dryrun needs: a step fn, abstract args, and in_shardings,
    plus the ``FakeTensorMode`` the args belong to (``record_rank``'s
    ``fake_mode``; not entered around ``fn``)."""
    fn: Any
    args: tuple
    in_shardings: tuple
    label: str
    fake_mode: Any = None


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    # the host's numpy-made index tensors (the sketch fold's schedule) meet
    # the fake ones inside the step: let them in as fakes
    return FakeTensorMode(allow_non_fake_inputs=True)


def _ranks(mesh) -> bool:
    """Whether ``mesh`` has ranks to shard over: a ``sharding.Mesh`` of more
    than one (on one rank a cell holds whole tensors, as a program on one
    card does: there is nothing to shard)."""
    return isinstance(mesh, shlib.Mesh) and mesh.size > 1


def _mesh(mesh):
    return AbstractMesh({"data": 1, "model": 1}) if mesh is None else mesh


def _place(x: torch.Tensor, mesh, spec: tuple, fm) -> torch.Tensor:
    """The fake ``x`` on ``mesh`` by ``spec``: itself without ranks, else a
    DTensor over a fake shard of this rank's size."""
    if not _ranks(mesh):
        return x
    pls = shlib.placements(mesh, spec)
    box = shlib.local_box(x.shape, mesh.device_mesh, pls)
    with fm:
        local = torch.empty([hi - lo for lo, hi in box], dtype=x.dtype, device=x.device)
    return shlib.from_local(local, mesh.device_mesh, pls, x.shape)


def _spec_leaves(specs: PyTree) -> list:
    """The specs of a spec tree in ``tree_leaves`` order: dicts, lists and
    NamedTuples are containers, a plain tuple is a spec."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, list) or hasattr(specs, "_fields"):
        return [s for t in specs for s in _spec_leaves(t)]
    return [specs]


def _place_tree(tree: PyTree, mesh, specs: PyTree, fm) -> PyTree:
    it = iter(_spec_leaves(specs))
    return tree_map(lambda x: _place(x, mesh, next(it), fm), tree)


def _host_scalar(value: int) -> torch.Tensor:
    """A 0-d int32 host tensor, made outside any fake mode."""
    with torch._C._DisableTorchDispatch():
        return torch.tensor(value, dtype=torch.int32)


def _host_int(t: torch.Tensor) -> int:
    """The value of a host scalar tensor, read past the dispatch modes, so
    that neither a real nor a dry run records the read."""
    with torch._C._DisableTorchDispatch():
        return int(t)


def params_abstract(cfg: ModelConfig, *, device="cuda", fake_mode=None,
                    dtype=PARAM_DTYPE) -> PyTree:
    """The parameters of ``cfg`` as fake tensors: ``init_params`` run under
    ``fake_mode`` (a new one if None)."""
    with fake_mode or _fake_mode():
        return init_params(0, cfg, device=device, dtype=dtype)


def uses_sketch_cache(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """long_500k uses the AccumSketch-compressed cache on attention blocks
    (the paper's technique is what makes 500k-context serving feasible for
    full-attention archs; SSM blocks are natively O(1))."""
    return shape.name == "long_500k" and cfg.has_attention


def _tokens(mesh, B: int, S: int | None, cfg: ModelConfig, device, fm):
    """(B, S) int32 fake tokens (or (B,) when S is None) and their spec."""
    spec = shlib.batch_spec(mesh, B, policy=cfg.sharding_policy)
    if S is None:
        spec = (spec[0],)
    with fm:
        t = torch.empty((B,) if S is None else (B, S), dtype=torch.int32, device=device)
    return _place(t, mesh, spec, fm), spec


def _cond(mesh, B: int, cfg: ModelConfig, device, fm):
    spec = shlib.batch_spec(mesh, B, extra_dims=2, policy=cfg.sharding_policy)
    with fm:
        c = torch.empty((B, cfg.cond_len, cfg.d_model), dtype=torch.bfloat16, device=device)
    return _place(c, mesh, spec, fm), spec


def train_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, tc: TrainConfig, *,
               device="cuda", fake_mode=None, dtype=PARAM_DTYPE) -> Cell:
    """One ``train_step`` on the global batch: (state, tokens, labels, step
    [, cond]); the parameters in ``dtype``."""
    fm = fake_mode or _fake_mode()
    mesh = _mesh(mesh)
    B, S = shape.global_batch, shape.seq_len
    with fm:
        state = init_train_state(init_params(0, cfg, device=device, dtype=dtype), tc)
    state = state._replace(opt=state.opt._replace(step=_host_scalar(0)))
    params_sh = shlib.params_shardings(mesh, state.params, cfg.sharding_policy)
    opt_sh = shlib.opt_shardings(mesh, state.opt, params_sh)
    ef_sh = None if state.ef is None else tree_map(lambda _: shlib.replicated(mesh),
                                                    state.ef)
    state_sh = type(state)(params_sh, opt_sh, ef_sh)
    opt = type(state.opt)(state.opt.step, *(_place_tree(t, mesh, sh, fm) for t, sh in
                                              zip(state.opt[1:], opt_sh[1:])))
    ef = None if state.ef is None else _place_tree(state.ef, mesh, ef_sh, fm)
    state = type(state)(_place_tree(state.params, mesh, params_sh, fm), opt, ef)
    tokens, tok_sh = _tokens(mesh, B, S, cfg, device, fm)
    labels, _ = _tokens(mesh, B, S, cfg, device, fm)
    rep = shlib.replicated(mesh)
    args = [state, tokens, labels, _host_scalar(0)]
    shardings = [state_sh, tok_sh, tok_sh, rep]
    on = mesh if _ranks(mesh) else None
    if cfg.frontend:
        cond, cond_sh = _cond(mesh, B, cfg, device, fm)
        args.append(cond)
        shardings.append(cond_sh)

        def fn(st, t, lab, i, c):
            return train_step(st, t, lab, _host_int(i), cfg, tc, cond=c, mesh=on)
    else:
        def fn(st, t, lab, i):
            return train_step(st, t, lab, _host_int(i), cfg, tc, mesh=on)
    return Cell(fn, tuple(args), tuple(shardings), f"{cfg.name}/{shape.name}", fm)


def prefill_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, q_chunk: int = 512, *,
                 device="cuda", fake_mode=None, dtype=PARAM_DTYPE) -> Cell:
    """One ``prefill`` of the global batch: (params, tokens [, cond]); the
    parameters in ``dtype``."""
    fm = fake_mode or _fake_mode()
    mesh = _mesh(mesh)
    B, S = shape.global_batch, shape.seq_len
    p = params_abstract(cfg, device=device, fake_mode=fm, dtype=dtype)
    p_sh = shlib.params_shardings(mesh, p, cfg.sharding_policy)
    tokens, tok_sh = _tokens(mesh, B, S, cfg, device, fm)
    args = [_place_tree(p, mesh, p_sh, fm), tokens]
    shardings = [p_sh, tok_sh]
    if cfg.frontend:
        cond, cond_sh = _cond(mesh, B, cfg, device, fm)
        args.append(cond)
        shardings.append(cond_sh)

        def fn(p, t, c):
            return prefill(p, t, cfg, cond=c, q_chunk=q_chunk)
    else:
        def fn(p, t):
            return prefill(p, t, cfg, q_chunk=q_chunk)
    return Cell(fn, tuple(args), tuple(shardings), f"{cfg.name}/{shape.name}", fm)


def _cache_specs(mesh, cache: DecodeCache, B: int, cfg: ModelConfig) -> DecodeCache:
    """The spec of every cache leaf: ``cache_shardings``' spec of the
    leaf stacked over the superblocks, as the reference stacks it, less its
    leading (never sharded) superblock entry."""
    n_sb = cfg.n_superblocks

    def one(x):
        stacked = torch.empty((n_sb, *x.shape), device="meta")
        return tuple(shlib.cache_shardings(mesh, stacked, B, cfg.sharding_policy)[1:])

    return tree_map(one, cache)


def decode_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *, sketch: bool | None = None,
                device="cuda", fake_mode=None, dtype=PARAM_DTYPE) -> Cell:
    """One ``decode_step`` at position S − 1 over a cache of S positions
    (sketched where ``uses_sketch_cache``, or as ``sketch`` says): (params,
    cache, token, pos [, slots]); the parameters in ``dtype``."""
    fm = fake_mode or _fake_mode()
    mesh = _mesh(mesh)
    B, S = shape.global_batch, shape.seq_len
    sketch = uses_sketch_cache(cfg, shape) if sketch is None else sketch
    with fm:
        cache = init_cache(cfg, B, S, use_sketch=sketch, device=device)
    p = params_abstract(cfg, device=device, fake_mode=fm, dtype=dtype)
    p_sh = shlib.params_shardings(mesh, p, cfg.sharding_policy)
    cache_sh = _cache_specs(mesh, cache, B, cfg)
    token, tok_sh = _tokens(mesh, B, None, cfg, device, fm)
    rep = shlib.replicated(mesh)
    args = [_place_tree(p, mesh, p_sh, fm), _place_tree(cache, mesh, cache_sh, fm), token,
            _host_scalar(S - 1)]
    shardings = [p_sh, cache_sh, tok_sh, rep]
    if sketch:
        sa = cfg.sketch_attn
        args.append(decode_slots(0, S - 1, sa.d_slots, sa.m_r))
        shardings.append(rep)

        def fn(p, c, t, i, s):
            return decode_step(p, c, t, _host_int(i), cfg, slots=s, use_sketch=True)
    else:
        def fn(p, c, t, i):
            return decode_step(p, c, t, _host_int(i), cfg)
    return Cell(fn, tuple(args), tuple(shardings), f"{cfg.name}/{shape.name}", fm)


def cut(cfg: ModelConfig, superblocks: int | None) -> ModelConfig:
    """``cfg`` cut to its first ``superblocks`` superblocks (None: whole),
    its widths kept."""
    if superblocks is None or superblocks >= cfg.n_superblocks:
        return cfg
    return dataclasses.replace(cfg, n_superblocks=superblocks,
                               n_layers=superblocks * len(cfg.pattern))


def make_cell(arch: str, shape_name: str, mesh, *, tc: TrainConfig | None = None,
              device="cuda", fake_mode=None, superblocks: int | None = None) -> Cell:
    """The cell of ``arch`` × ``shape_name`` on ``mesh`` (a ``sharding.Mesh``,
    an ``AbstractMesh``, or None for one rank), the config cut to
    ``superblocks`` superblocks where given."""
    cfg = cut(get_config(arch), superblocks)
    shape = SHAPES[shape_name]
    kw = {"device": device, "fake_mode": fake_mode}
    if shape.kind == "train":
        # n_micro=4: the scan-over-layers carry stack (n_layers × B·S·D bf16)
        # is the dominant training temp; microbatching divides it by n_micro.
        # dp_only archs keep n_micro=1: their global batch exactly covers the
        # chips, and the models are small enough not to need the carry split.
        if tc is None:
            n_micro = 1 if cfg.sharding_policy == "dp_only" else 4
            tc = TrainConfig(n_micro=n_micro)
        return train_cell(cfg, shape, mesh, tc, **kw)
    if shape.kind == "prefill":
        return prefill_cell(cfg, shape, mesh, **kw)
    return decode_cell(cfg, shape, mesh, **kw)


def input_specs(arch: str, shape_name: str, *, device="cuda") -> tuple:
    """Public helper: the abstract inputs for a cell (mesh-independent: one
    rank, the whole tensors)."""
    return make_cell(arch, shape_name, None, device=device).args
