"""Sharding rules: map (param path, shape) → a spec on the production mesh
(ported from ``repro.sharding``).

Policy (DP/FSDP/TP/EP/SP composed):
  * batch axes            → ("pod","data")  (DP; pod composes with data)
  * parameter "fsdp" dim  → ("pod","data")  (ZeRO-3-style weight sharding:
                            DTensor all-gathers a weight where a product
                            needs it whole)
  * parameter "tensor" dim→ "model"         (TP: heads / FFN inner / vocab)
  * MoE expert dim        → "model"         (EP)
  * long-context KV cache → sequence dim on "model" when head dims don't
                            divide (SP fallback)

Every assignment is divisibility-checked against the mesh; non-divisible dims
fall back to replication (never an error on exotic head counts).

A spec has the reference's ``PartitionSpec`` value domain: a tuple with one
entry a tensor dimension, each None, a mesh axis name or a tuple of axis
names (it compares equal to the reference's ``PartitionSpec``).  In PyTorch
the sharded tensors are DTensors (``torch.distributed.tensor``), the
counterpart of ``NamedSharding`` under GSPMD: ``placements`` turns a spec
into one placement a mesh axis.  The rules read only ``mesh.shape`` (axis
name → size, in the mesh's major-to-minor order), as the reference's do.

``Mesh`` is the port's mesh: a ``DeviceMesh`` over the ranks of the process
group with named axes.  ``with mesh:`` makes it the current mesh of
``constrain`` and of the MoE's expert-parallel path; outside one, both keep
the single-device behaviour.  The current mesh is the process's, not a
thread's: on a card the autograd engine runs the backward, and with it the
recompute of a checkpointed block, on a worker thread of its own, which
must take the same paths as the forward did.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch

from repro_torch._util import tree_map

PyTree = Any

# the meshes of the open ``with mesh:`` blocks, innermost last, and the
# implicit-replication context the outermost one holds
_STACK: list = []
_IMPLICIT: list = []


class Mesh:
    """Named mesh axes over the ranks of the default process group: a
    ``torch.distributed.device_mesh.DeviceMesh`` (``device_mesh``) whose
    dimensions are ``axis_names``, each rank computing on ``device``.
    ``shape`` maps each axis name to its size, in the mesh's order, as
    ``jax.sharding.Mesh.shape`` does.  A context manager: inside ``with
    mesh:`` it is the current mesh (``current_mesh``)."""

    def __init__(self, device_mesh, axis_names: tuple[str, ...], device: torch.device):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.device = device
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))

    @property
    def size(self) -> int:
        """The number of ranks."""
        return math.prod(self.shape.values())

    @property
    def rank(self) -> int:
        """This process's rank in the default group."""
        return torch.distributed.get_rank()

    def group(self, axis: str):
        """The process group of the ranks that differ along ``axis`` alone."""
        return self.device_mesh.get_group(axis)

    def close(self) -> None:
        """Nothing to release: the process group is the caller's."""

    def __enter__(self) -> "Mesh":
        from torch.distributed.tensor.experimental import implicit_replication

        # a plain tensor made inside the block (a RoPE table, a mask, a zero
        # accumulator) meets DTensors as a replicated value, as a value made
        # inside a jitted function is replicated under GSPMD
        if not _STACK:
            ctx = implicit_replication()
            ctx.__enter__()
            _IMPLICIT.append(ctx)
        _STACK.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _STACK.pop()
        if not _STACK:
            _IMPLICIT.pop().__exit__(*exc)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], *,
              device="cuda") -> Mesh:
    """The mesh of ``shape`` over ranks 0..prod(shape)−1 of the initialised
    default process group (row-major: the last axis varies fastest, as
    ``jax.make_mesh`` lays devices out), its subgroups made with the default
    group's backend.  Every rank must call it."""
    from torch.distributed.device_mesh import DeviceMesh

    device = torch.device(device)
    need = math.prod(shape)
    ranks = torch.arange(need).reshape(shape)
    _missing_rules()
    return Mesh(DeviceMesh(device.type, ranks, mesh_dim_names=tuple(axis_names)),
                axis_names, device)


@functools.cache
def _missing_rules() -> None:
    """Sharding rules DTensor lacks (on some PyTorch versions) for ops the
    models run on a mesh: ``log_sigmoid_backward`` (the backward of the
    mLSTM's forget gate), its operands and result placed alike, whole or
    split along any one dimension; and ``mm.dtype`` (the output head's
    product with a float32 result on a card), the rules of ``mm``: rows,
    columns or the contraction split (the last a partial sum); and
    ``cummax`` (the mLSTM's running maximum of its gates) and ``flip``
    (in ``cumsum``'s backward), the operand and the results placed alike,
    whole or split along a dimension they do not scan or flip."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.log_sigmoid_backward.default)
    def _(grad, x, buffer):
        alike = [([Replicate()], [Replicate()] * 3)]
        return alike + [([Shard(d)], [Shard(d)] * 3) for d in range(x.ndim)]

    @register_sharding(torch.ops.aten.mm.dtype)
    def _(a, b, out_dtype):
        return [([Replicate()], [Replicate(), Replicate(), None]),
                ([Shard(0)], [Shard(0), Replicate(), None]),
                ([Shard(1)], [Replicate(), Shard(1), None]),
                ([Partial()], [Shard(1), Shard(0), None])]

    def alike(x, dims, outs):
        # operand and results placed alike, split only along the other dims
        kept = {d % x.ndim for d in dims}
        return [([pl] * outs, [pl, None]) for pl in
                [Replicate()] + [Shard(d) for d in range(x.ndim) if d not in kept]]

    @register_sharding(torch.ops.aten.cummax.default)
    def _(x, dim):
        return alike(x, [dim], 2)

    @register_sharding(torch.ops.aten.flip.default)
    def _(x, dims):
        return alike(x, dims, 1)


def current_mesh() -> Mesh | None:
    """The mesh of the innermost open ``with mesh:`` block, or None."""
    return _STACK[-1] if _STACK else None


# kept under the reference's name, which its model code imports
_current_mesh = current_mesh


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def data_axes(mesh, policy: str = "default"):
    """The combined DP/FSDP axes: ("pod","data") on multi-pod, ("data",) else.
    Under "dp_only" the model axis joins them (no TP anywhere)."""
    names = ("pod", "data", "model") if policy == "dp_only" else ("pod", "data")
    return tuple(a for a in names if a in mesh.shape)


def _fit(mesh, dim: int, axes):
    """Return the contiguous sub-tuple of `axes` with the LARGEST device count
    whose size divides `dim`, else None (replicate). Size-1 results are
    dropped (sharding over them is replication anyway). Largest-first keeps
    the most parallelism — e.g. batch=256 on the 2×16×16 multi-pod mesh under
    dp_only picks ("data","model")=256-way, not ("pod","data")=32-way; earlier
    sub-tuples win ties so the leading (outermost) axes are preferred."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    n = len(axes)
    best, best_sz = None, 1
    for k in range(n, 0, -1):
        for start in range(n - k + 1):
            sub = axes[start:start + k]
            sz = _axis_size(mesh, sub)
            if sz > best_sz and dim % sz == 0:
                best, best_sz = sub, sz
    if best is None:
        return None
    return best if len(best) > 1 else best[0]


def _path_str(path) -> str:
    """A key path (a sequence of dict keys or indices) joined with "/"."""
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def param_spec(mesh, path_str: str, shape: tuple[int, ...],
               policy: str = "default") -> tuple:
    """The spec of the parameter at ``path_str`` with ``shape``: the
    reference's rules (MoE experts EP on E and FSDP on D; xLSTM recurrent
    matrices TP on heads; embeddings vocab on TP and D on FSDP; output
    projections TP on the contracted dim; the conv weight TP on its
    channels; the router FSDP; input projections FSDP × TP; a leading
    superblock axis under ``/blocks/`` never sharded)."""
    fsdp = data_axes(mesh, policy)
    tp = "model" if "model" in mesh.shape and policy != "dp_only" else None
    stacked = "/blocks/" in f"/{path_str}/"  # leading superblock axis
    dims = list(shape[1:]) if stacked else list(shape)
    lead = [None] if stacked else []

    def spec(*entries):
        return (*lead, *entries)

    name = path_str.rsplit("/", 1)[-1]
    nd = len(dims)

    if nd <= 1:
        return spec(*([None] * nd))

    # --- MoE experts: (E, D, F) / (E, F, D) — EP on E, FSDP on D ---------- #
    if nd == 3 and name in ("wi_gate", "wi_up", "wo") and "ffn" in path_str:
        e = _fit(mesh, dims[0], tp)
        if name == "wo":   # (E, F, D)
            return spec(e, None, _fit(mesh, dims[2], fsdp))
        return spec(e, _fit(mesh, dims[1], fsdp), None)

    # --- xLSTM per-head recurrent mats (H, Dh, Dh) ------------------------- #
    if nd == 3 and name.startswith("r"):
        return spec(_fit(mesh, dims[0], tp), None, None)

    # --- embeddings: (V, D) — vocab on TP, D on FSDP ----------------------- #
    if name in ("embed", "lm_head"):
        return spec(_fit(mesh, dims[0], tp), _fit(mesh, dims[1], fsdp))

    # --- 2-D projections ---------------------------------------------------- #
    if nd == 2:
        # output projections: contract dim is TP-sharded
        if name in ("wo", "out_proj"):
            return spec(_fit(mesh, dims[0], tp), _fit(mesh, dims[1], fsdp))
        if name == "conv_w":
            return spec(None, _fit(mesh, dims[1], tp))
        if name == "router":
            return spec(_fit(mesh, dims[0], fsdp), None)
        # input projections (wq/wk/wv/wi_*/in_proj/wz/wi/wf/wog/...):
        return spec(_fit(mesh, dims[0], fsdp), _fit(mesh, dims[1], tp))

    return spec(*([None] * nd))


def _with_paths(fn, tree: PyTree, prefix: tuple = ()) -> PyTree:
    """``tree`` with every leaf x replaced by ``fn(path, x)`` (dict keys in
    the order ``tree_map`` keeps)."""
    if isinstance(tree, dict):
        return {k: _with_paths(fn, tree[k], prefix + (k,)) for k in sorted(tree)}
    return fn(prefix, tree)


def params_shardings(mesh, params: PyTree, policy: str = "default") -> PyTree:
    """The spec of every parameter, in the tree's structure."""
    return _with_paths(lambda path, x: param_spec(mesh, _path_str(path), tuple(x.shape),
                                                  policy), params)


def opt_shardings(mesh, opt_state, params_sh: PyTree):
    """ZeRO-1: m/v/master inherit the param shardings; step is replicated."""
    from repro_torch.optim.adamw import AdamWState

    return AdamWState(step=replicated(mesh), m=params_sh, v=params_sh, master=params_sh)


def batch_spec(mesh, batch: int, *, extra_dims: int = 1,
               policy: str = "default") -> tuple:
    """A batch of ``batch`` rows over the data axes, ``extra_dims`` more
    dims replicated."""
    b = _fit(mesh, batch, data_axes(mesh, policy))
    return (b, *([None] * extra_dims))


def cache_shardings(mesh, cache: PyTree, batch: int,
                    policy: str = "default") -> PyTree:
    """Decode caches: batch → DP axes; if batch doesn't divide, shard the
    sequence/slot axis (SP) or heads on "model".  A leaf is stacked over
    superblocks, (n_sb, B, ...), as the reference's cache leaves are."""
    fsdp = data_axes(mesh, policy)
    tp = "model" if "model" in mesh.shape and policy != "dp_only" else None

    def one(x):
        # leading superblock axis then (B, ...) — cache leaves are stacked
        dims = tuple(x.shape)[1:]
        b = _fit(mesh, dims[0], fsdp)
        rest = [None] * (len(dims) - 1)
        # shard the largest remaining dim on model (seq for KV, slots for
        # sketch caches, heads for states) if divisible
        if len(rest) > 0 and tp is not None:
            sizes = list(dims[1:])
            order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
            for i in order:
                if sizes[i] % _axis_size(mesh, tp) == 0:
                    rest[i] = tp
                    break
        return (None, b, *rest)

    return tree_map(one, cache)


def replicated(mesh) -> tuple:
    """The spec of a replicated value (of any rank)."""
    return ()


# --------------------------------------------------------------------------- #
# Specs as DTensor placements
# --------------------------------------------------------------------------- #

def placements(mesh: Mesh, spec: tuple) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: one a mesh axis, in
    the mesh's order — ``Shard(d)`` on every axis that tensor dimension d is
    split over (a dimension over several axes is split major to minor, the
    mesh's order, as in the reference), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        order = [mesh.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order "
                             f"{mesh.axis_names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"mesh axis {a!r} shards two dims of spec {spec!r}")
            owner[a] = d
    return [Shard(owner[a]) if a in owner else Replicate() for a in mesh.axis_names]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def distribute(x: torch.Tensor, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """``x`` (the same whole tensor on every rank) as a DTensor placed by
    ``spec``: each rank keeps a copy of its shard, with no collective."""
    return _from_whole(x.to(mesh.device), mesh.device_mesh, placements(mesh, spec))


def distribute_like(x: torch.Tensor, like) -> torch.Tensor:
    """The whole tensor ``x`` as a DTensor placed as the DTensor ``like``
    (each rank keeps a copy of its shard)."""
    return _from_whole(x.to(like.device), like.device_mesh, list(like.placements))


def local_box(shape, device_mesh, pls) -> list[tuple[int, int]]:
    """The [lo, hi) range of every dim that this rank's shard covers, under
    DTensor's split (⌈n/k⌉ a shard, the last ones short or empty; a dim
    over several mesh axes split major to minor)."""
    from torch.distributed.tensor import Shard

    coord = device_mesh.get_coordinate()
    box = [(0, n) for n in shape]
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            lo0, hi0 = box[pl.dim]
            n, k = hi0 - lo0, device_mesh.mesh.shape[i]
            per = -(-n // k)
            lo = min(coord[i] * per, n)
            box[pl.dim] = (lo0 + lo, lo0 + min(lo + per, n))
    return box


def _from_whole(x: torch.Tensor, device_mesh, pls: list) -> torch.Tensor:
    """This rank's shard of the whole tensor ``x`` wrapped as a DTensor."""
    out = x
    for d, (lo, hi) in enumerate(local_box(x.shape, device_mesh, pls)):
        out = out.narrow(d, lo, hi - lo)
    return from_local(out.clone(memory_format=torch.contiguous_format), device_mesh, pls,
                      x.shape)


def from_local(local: torch.Tensor, device_mesh, pls, shape) -> torch.Tensor:
    """``local``, this rank's shard, as a DTensor of the contiguous whole
    ``shape`` placed by ``pls`` (no collective, no check)."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    return DTensor.from_local(local, device_mesh, pls, run_check=False, shape=shape,
                              stride=tuple(math.prod(shape[d + 1:]) for d in range(len(shape))))


def shard_tree(tree: PyTree, mesh: Mesh, specs: PyTree) -> PyTree:
    """Every tensor of ``tree`` placed by its spec in ``specs`` (the same
    structure)."""
    it = iter(_spec_leaves(specs))
    return tree_map(lambda x: distribute(x, mesh, next(it)), tree)


def _spec_leaves(specs: PyTree) -> list:
    """The specs of a spec tree in ``tree_leaves`` order (a spec is a tuple,
    so it is a leaf here)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for t in specs for s in _spec_leaves(t)]
    return [specs]


def full(x):
    """The whole tensor of a DTensor (gathered on every rank); anything
    else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


# --------------------------------------------------------------------------- #
# Activation constraints (used inside model code; no-ops without a mesh)
# --------------------------------------------------------------------------- #

def _entries_spec(m: Mesh, shape, entries, policy: str) -> tuple:
    fsdp = data_axes(m, policy)
    tp = "model" if "model" in m.shape and policy != "dp_only" else None
    spec = []
    for dim, e in zip(shape, entries):
        if e == "dp":
            spec.append(_fit(m, dim, fsdp))
        elif e == "tp":
            spec.append(_fit(m, dim, tp))
        elif e == "sp":
            # sequence parallelism: shard the sequence dim over the model
            # axis (Megatron-SP). Dropped under dp_only or when the dim
            # doesn't divide (decode: S=1 → replicated).
            spec.append(_fit(m, dim, tp))
        elif e == "tp!":
            # force model-axis sharding even when the dim doesn't divide. Used
            # to pin HEAD-ALIGNED q/k/v sharding, so that the QKᵀ contraction
            # stays shard-local instead of splitting head_dim.
            spec.append(tp if tp is not None and m.shape.get("model", 1) > 1 else None)
        else:
            spec.append(None)
    spec += [None] * (len(shape) - len(spec))
    return tuple(spec)


def gather_fsdp(w: torch.Tensor, policy: str = "default") -> torch.Tensor:
    """The weight ``w`` with its shards over the data axes gathered and its
    model-axis (tensor-parallel) shards kept: the layout GSPMD gathers an
    FSDP weight to before a product (its backward reduce-scatters the
    gradient).  DTensor left to itself may gather the other operand's batch
    instead.  The identity outside a mesh context and on a tensor that is
    not a DTensor; under "dp_only" every axis is a data axis."""
    from torch.distributed.tensor import Replicate

    m = current_mesh()
    if m is None or not is_dtensor(w):
        return w
    data = set(data_axes(m, policy))
    pls = [Replicate() if a in data else pl for a, pl in zip(m.axis_names, w.placements)]
    return w if pls == list(w.placements) else w.redistribute(w.device_mesh, pls)


def constrain(x: torch.Tensor, *entries, policy: str = "default") -> torch.Tensor:
    """The sharding constraint of the reference: (a) the identity outside a
    mesh context, and on a tensor that is not a DTensor; (b) inside one, a
    ``redistribute`` of the DTensor ``x`` to the placements its entries
    give, axes absent from the mesh and non-divisible dims dropped, its
    gradient redistributed to the same placements (``_Constrain``).  Entries
    use the logical names "dp" (pod+data; +model under dp_only), "tp"
    (model), "sp" (the sequence on model) and "tp!" (model even where the
    dim does not divide), or None.

    "tp!" on a dim the model axis does not divide: XLA pads the trailing
    shards; DTensor's uneven ``Shard`` (⌈n/k⌉ a shard, the last ones short)
    holds the same global values, so the result is the same."""
    m = current_mesh()
    if m is None or not is_dtensor(x):
        return x
    want = placements(m, _entries_spec(m, x.shape, entries, policy))
    if torch.is_grad_enabled() and x.requires_grad:
        return _Constrain.apply(x, m.device_mesh, want, want)
    return x if list(x.placements) == want else x.redistribute(m.device_mesh, want)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """The DTensor ``x`` with its partial sums (or means) reduced, whole on
    the mesh dims that held them, as GSPMD all-reduces a reduction over a
    split dimension; its gradient placed the same (a partial's as
    replicated).  ``x`` itself where nothing is partial."""
    from torch.distributed.tensor import Replicate

    want = [Replicate() if pl.is_partial() else pl for pl in x.placements]
    if want == list(x.placements):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Constrain.apply(x, x.device_mesh, want, want)
    return x.redistribute(x.device_mesh, want)


def pin_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient redistributed in the backward to ``x``'s
    own placements, a partial sum's as replicated (the identity off a mesh
    and where no gradient flows): a reshape's backward then gets the layout
    its forward had, where a constraint after it (``constrain``'s gradient)
    may split a dimension unevenly that DTensor cannot reshape."""
    from torch.distributed.tensor import Replicate

    if not (is_dtensor(x) and torch.is_grad_enabled() and x.requires_grad):
        return x
    grad = [Replicate() if pl.is_partial() else pl for pl in x.placements]
    return _Constrain.apply(x, x.device_mesh, list(x.placements), grad)


class _Constrain(torch.autograd.Function):
    """``redistribute`` to ``want`` whose gradient is redistributed to
    ``grad``: for a constraint both are its placements, as the transpose of
    GSPMD's sharding constraint is the same constraint on the cotangent.
    DTensor's own ``redistribute`` passes a gradient back in whatever
    placement it arrives; a ``Partial`` sum then reaches the products before
    it, and DTensor gathers their weights whole rather than reduce the sum
    (a block's backward computed whole on every model rank)."""

    @staticmethod
    def forward(ctx, x, device_mesh, want, grad):
        ctx.device_mesh, ctx.grad = device_mesh, grad
        if list(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if list(g.placements) != ctx.grad:
            g = g.redistribute(ctx.device_mesh, ctx.grad)
        return g, None, None, None
