"""Observe one eager call into a ``TraceReport``: the trace-contract
analyzer's core (the twin of ``repro.analysis.trace``).

The reference walks a jaxpr, a trace of the whole program.  PyTorch eager
has none, so the port records one call at the probe's size instead: every
aten op it dispatches, seen by a ``TorchDispatchMode`` (which sees the ops
under ``no_grad``, inside ``torch.utils.checkpoint`` and inside a custom
``autograd.Function``), FLOPs from ``torch.utils.flop_counter``, and the
calls into the kernel routers of ``repro_torch.kernels``.  The report:

  * the largest single intermediate (bytes, elements, shape, dtype) — the
    no-quadratic-buffer rule.  Intermediates are the ops' outputs; an output
    that shares storage with an input (a view, an in-place op) is skipped,
    as the reference skips its view primitives, and the call's own
    arguments are not counted (the reference counts every operand);
  * a dtype census of those outputs;
  * FLOPs of the products (mm, bmm, addmm, baddbmm, convolutions,
    attention);
  * kernel dispatches — calls into the routers (``kernels/*/ops.py``),
    counted whichever implementation serves them, so the count is the same
    on the CPU and on a card (``route_as_on_card``).  This is the
    reference's ``pallas_calls``;
  * host syncs (``HOST_SYNC_OPS``) — the reference's host callbacks — and
    copies to the CPU from a device (``host_copies``);
  * aten op counts (``primitives``).

Counts are dynamic: a loop counts every trip, where the reference's static
``pallas_calls`` counts call sites (its ``pallas_dispatches`` multiplies by
trip counts, as this count does by running them).  A host sync is counted
wherever its tensor lies (a read of a CPU tensor costs the same dispatch),
so the count is the same on the CPU and on a card; a copy to the CPU is a
no-op that dispatches nothing on the CPU, so copies are counted on a card
alone.

``record_rank`` records ONE RANK's program on a mesh, the op stream the
dry run (``repro_torch.launch.dryrun``) reckons a roofline from: each op
at the local shapes a rank computes, with its FLOPs, operand and result
bytes and result type, and the high-water mark of the bytes its live
storages hold.  A ``TorchDispatchMode`` sees a DTensor op at its global
shapes, and DTensor's dispatch runs the rank's local op (after any
redistribution) inside the mode's own handler, where the mode is off the
stack.  So the rank recorder declines every op on a tensor subclass other
than ``FakeTensor`` (returns ``NotImplemented``): the subclass's dispatch
then runs with the recorder still on the stack, which sees the local op
and the redistribution's collectives.  DTensor also runs each op once more
at its global shapes, on fake tensors, to learn the output's metadata
(``ShardingPropagator._propagate_tensor_meta*``); those calls compute
nothing on the rank, and the recorder passes them through unrecorded.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref
from typing import Any

import torch
from torch.utils._pytree import tree_leaves as _leaves
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.hlo import type_str

#: aten ops (overload packets) whose result the host must wait for: a
#: device value read on the host, or an output whose size depends on the
#: data.  The serving and fit hot paths should contain none.
HOST_SYNC_OPS = frozenset({
    "_local_scalar_dense", "item", "nonzero", "masked_select", "equal", "is_nonzero",
    "unique", "_unique", "_unique2", "unique_consecutive", "unique_dim",
    "unique_dim_consecutive",
    # a checked linear-algebra call reads its error info on the host
    "_linalg_check_errors",
})

_COPIES = frozenset({"_to_copy", "copy_", "copy"})


def _storage(t: torch.Tensor) -> int | None:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return None


def _storage_key(t: torch.Tensor) -> int | None:
    """The identity of ``t``'s storage (also of a fake tensor's, whose data
    pointer is 0), or None for a tensor without one."""
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError, AttributeError):
        return None


def _is_view(func, ins, outs) -> bool:
    """Whether the op only aliases its inputs: it writes nothing and every
    tensor it returns shares an input's storage (a view, ``detach``,
    ``_unsafe_view``, ``split``)."""
    if func._schema.is_mutable or not outs:
        return False
    keys = {_storage_key(t) for t in ins} - {None}
    return all(_storage_key(t) in keys for t in outs)


@dataclasses.dataclass
class OpEvent:
    """One dispatched op: its name, its outputs (shape, dtype, bytes,
    whether it shares storage with an input), its tensor inputs' shapes and
    whether it only aliases them (``view``).  A rank recording
    (``record_rank``) also keeps the op's namespace, its product FLOPs, its
    operand plus result bytes, its results' type string (the reference's
    syntax, ``analysis.hlo.type_str``) and whether it is host arithmetic
    (on the program's host values, or every tensor a 0-d CPU tensor: the
    optimizer's step and schedule, the decode step's slot draw)."""

    name: str
    outputs: list
    input_shapes: list
    view: bool = False
    namespace: str = "aten"
    flops: float = 0.0
    nbytes: int = 0
    result: str = ""
    host: bool = False


@dataclasses.dataclass
class Recording:
    """The port's traced program: the ops, router calls and FLOPs of one
    eager call, and its result.  A rank recording also holds the peak of
    the bytes its live storages on the recorded device held
    (``peak_bytes``, the call's arguments counted: ``arg_bytes``) and what
    held them then: bytes by the op that made each storage ("arguments"
    for the call's own), taken when the peak last grew by 1%
    (``peak_by_op``)."""

    ops: list = dataclasses.field(default_factory=list)
    routes: list = dataclasses.field(default_factory=list)
    flops: float = 0.0
    result: Any = None
    peak_bytes: int = 0
    arg_bytes: int = 0
    peak_by_op: dict = dataclasses.field(default_factory=dict)


class _Recorder(TorchDispatchMode):
    def __init__(self, rec: Recording):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in _leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
        in_ptrs = {_storage(t) for t in ins} - {None, 0}
        name = func.overloadpacket.__name__
        if name in _COPIES and any(t.device.type == "cpu" for t in outs) and any(
                t.device.type != "cpu" for t in ins):
            name = "copy_to_cpu"
        self.rec.ops.append(OpEvent(
            name,
            [(tuple(t.shape), t.dtype, t.numel() * t.element_size(),
              _storage(t) in in_ptrs) for t in outs],
            [tuple(t.shape) for t in ins], _is_view(func, ins, outs)))
        return out


#: the caching allocator's granule: every block is a multiple of 512 bytes
ALLOC_GRANULE = 512
# ops that read a fake tensor's metadata, dispatched only because a fake
# tensor is a Python subclass: no computation, on a rank or anywhere
_META_QUERIES = frozenset({"is_same_size", "sym_size", "sym_stride", "sym_numel",
                           "sym_storage_offset", "sym_is_contiguous"})


def _caller() -> str:
    """The module that called the op being dispatched: the nearer on the
    Python stack of the program's (a ``repro_torch`` module but this one)
    and torch.distributed's (DTensor's placement bookkeeping); "" where
    neither is, as for a program that calls torch from a file of its own."""
    f = sys._getframe(1)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("torch.distributed") or (
                mod.startswith("repro_torch") and mod != __name__):
            return mod
        f = f.f_back
    return ""


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _RankRecorder(TorchDispatchMode):
    """One rank's ops (see the module's docstring) on the fake tensors of
    ``fake_mode``, with the live bytes of the storages on ``device`` tracked
    through a finalizer on each storage (a storage dies when its last
    tensor, an autograd-saved one included, does).

    The fake mode stays off the mode stack, so that torch.distributed's own
    bookkeeping (shard offsets it computes with host tensors) runs on real
    values, and its sharding-propagation cache works.  Each op is then
    sorted by its inputs:

      * on a tensor subclass other than a fake tensor (a DTensor) —
        declined, so that the subclass's dispatch runs its local ops under
        this mode;
      * on fake tensors of another fake mode — DTensor's sharding
        propagation (``ShardingPropagator._propagate_tensor_meta*``) runs
        the op at its global shapes under a mode of its own to learn the
        output's metadata: passed through, unrecorded;
      * on the cell's fake tensors — recorded;
      * on no fake tensor — called by torch.distributed's own code: run as
        it is, unrecorded; called by the program: on host tensors (the
        decode step's slot draw, the optimizer's step counter) run as it
        is, the program's host arithmetic; a factory or a copy to the
        device run under ``fake_mode``, so that nothing is allocated on the
        device.  Both are recorded."""

    def __init__(self, rec: Recording, fake_mode, device: torch.device):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor

        self.rec, self.fake_mode, self.fake = rec, fake_mode, FakeTensor
        self.device_type = torch.device(device).type
        self.live: dict[int, tuple[int, str]] = {}
        self.held = self.shown = 0

    def hold(self, t: torch.Tensor, origin: str = "arguments") -> None:
        """Count ``t``'s storage, made by the op ``origin``, as live until it
        dies (once a storage)."""
        if t.device.type != self.device_type:
            return
        key = _storage_key(t)
        if key is None or key in self.live:
            return
        st = t.untyped_storage()
        size = -(-st.nbytes() // ALLOC_GRANULE) * ALLOC_GRANULE
        self.live[key] = (size, origin)
        self.held += size
        if self.held > self.rec.peak_bytes:
            self.rec.peak_bytes = self.held
            if self.held > 1.01 * self.shown:
                self.shown = self.held
                by: dict[str, int] = {}
                for b, op in self.live.values():
                    by[op] = by.get(op, 0) + b
                self.rec.peak_by_op = by
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.held -= self.live.pop(key, (0, ""))[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(not issubclass(t, self.fake) for t in types):
            return NotImplemented
        ins = [t for t in _leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        fakes = [t for t in ins if isinstance(t, self.fake)]
        if any(t.fake_mode is not self.fake_mode for t in fakes):
            return func(*args, **kwargs)
        if fakes:
            out = func(*args, **kwargs)
        elif _caller().startswith("torch.distributed"):
            return func(*args, **kwargs)
        elif ins and torch.device(kwargs.get("device") or "cpu").type == "cpu":
            out = func(*args, **kwargs)     # the program's host values
        else:
            with self.fake_mode:            # a factory, a copy to the device
                out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == "prim" or name in _META_QUERIES:
            return out
        outs = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
        flops = flop_registry.get(func.overloadpacket)
        host = (not any(isinstance(t, self.fake) for t in outs)
                or all(t.ndim == 0 and t.device.type == "cpu" for t in ins + outs))
        self.rec.ops.append(OpEvent(
            name, [(tuple(t.shape), t.dtype, _nbytes(t), False) for t in outs],
            [tuple(t.shape) for t in ins], _is_view(func, ins, outs), func.namespace,
            0.0 if flops is None else float(flops(*args, **kwargs, out_val=out)),
            sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)),
            ", ".join(type_str(t.shape, t.dtype) for t in outs), host))
        for t in outs:
            self.hold(t, name)
        return out


@contextlib.contextmanager
def route_as_on_card():
    """The kernel-routing defaults as on a card while a probe runs
    (``core.apply.ROUTE_AS_ON_CARD``): the routers' device check still sends
    CPU tensors to the plain versions."""
    from repro_torch.core import apply as A

    prev, A.ROUTE_AS_ON_CARD = A.ROUTE_AS_ON_CARD, True
    try:
        yield
    finally:
        A.ROUTE_AS_ON_CARD = prev


def record(fn, *args, **kwargs) -> Recording:
    """Run ``fn(*args, **kwargs)`` once under the recorder."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import kernels

    rec = Recording()
    kernels.ROUTE_OBSERVERS.append(rec.routes.append)
    try:
        with route_as_on_card(), FlopCounterMode(display=False) as fc, _Recorder(rec):
            rec.result = fn(*args, **kwargs)
    finally:
        kernels.ROUTE_OBSERVERS.remove(rec.routes.append)
    rec.flops = float(fc.get_total_flops())
    return rec


def record_rank(fn, *args, fake_mode, device="cuda", **kwargs) -> Recording:
    """Run ``fn(*args, **kwargs)`` once on fake tensors of ``fake_mode``
    (DTensors over them, and host values), recording this rank's program:
    its ops at their local shapes (DTensors' shards), each with its FLOPs
    (``torch.utils.flop_counter``'s formulas) and bytes; its router calls;
    and the peak of the bytes held by the live storages on ``device``
    (``device``'s type), the arguments' storages counted from the start.
    ``fake_mode`` must not be entered around the call (``_RankRecorder``)."""
    from repro_torch import kernels

    rec = Recording()
    mode = _RankRecorder(rec, fake_mode, device)
    for t in _leaves((args, kwargs)):
        if isinstance(t, torch.Tensor):
            mode.hold(_local(t))
    rec.arg_bytes = mode.held
    kernels.ROUTE_OBSERVERS.append(rec.routes.append)
    try:
        with route_as_on_card(), mode:
            rec.result = fn(*args, **kwargs)
    finally:
        kernels.ROUTE_OBSERVERS.remove(rec.routes.append)
    rec.flops = sum(ev.flops for ev in rec.ops)
    return rec


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its attribute: ``to_local`` would dispatch
    a view), any other tensor itself."""
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


@dataclasses.dataclass
class TraceReport:
    """What the analyzer saw in one recorded call.

    ``peak_bytes``/``peak_elems`` describe the largest single intermediate;
    ``kernel_dispatches`` counts router calls (``kernel_routes`` by router);
    ``host_syncs`` lists every host-sync op in order and ``host_copies``
    counts the copies to the CPU; ``primitives`` counts aten ops by name and
    ``eqn_count`` all of them."""

    peak_bytes: int = 0
    peak_elems: int = 0
    peak_shape: tuple = ()
    peak_dtype: str = ""
    dtype_census: dict = dataclasses.field(default_factory=dict)
    flops: float = 0.0
    kernel_dispatches: int = 0
    kernel_routes: dict = dataclasses.field(default_factory=dict)
    host_syncs: list = dataclasses.field(default_factory=list)
    host_copies: int = 0
    primitives: dict = dataclasses.field(default_factory=dict)
    eqn_count: int = 0

    def forbidden(self, names) -> list[str]:
        """Which of ``names`` (aten op names) were dispatched."""
        return sorted(n for n in names if self.primitives.get(n, 0) > 0)

    def to_dict(self) -> dict:
        """JSON-ready form (the ``--json`` report)."""
        d = dataclasses.asdict(self)
        d["peak_shape"] = list(self.peak_shape)
        return d


def report_from_jaxpr(recording: Recording) -> TraceReport:
    """A ``TraceReport`` of an already-recorded call (the reference's name:
    its traced program is a jaxpr, the port's a ``Recording``)."""
    rep = TraceReport(flops=recording.flops, kernel_dispatches=len(recording.routes))
    for r in recording.routes:
        rep.kernel_routes[r] = rep.kernel_routes.get(r, 0) + 1
    for ev in recording.ops:
        rep.eqn_count += 1
        rep.primitives[ev.name] = rep.primitives.get(ev.name, 0) + 1
        if ev.name in HOST_SYNC_OPS:
            rep.host_syncs.append(ev.name)
        rep.host_copies += ev.name == "copy_to_cpu"
        for shape, dtype, nbytes, shared in ev.outputs:
            if shared:
                continue
            elems = 1
            for s in shape:
                elems *= s
            if nbytes > rep.peak_bytes or (nbytes == rep.peak_bytes and elems > rep.peak_elems):
                rep.peak_bytes, rep.peak_elems = nbytes, elems
                rep.peak_shape, rep.peak_dtype = shape, str(dtype).split(".")[-1]
            slot = rep.dtype_census.setdefault(str(dtype).split(".")[-1],
                                               {"buffers": 0, "bytes": 0})
            slot["buffers"] += 1
            slot["bytes"] += nbytes
    return rep


def trace_report(fn, *args, **kwargs) -> TraceReport:
    """Record ``fn(*args, **kwargs)`` once and report on it."""
    return report_from_jaxpr(record(fn, *args, **kwargs))


# --------------------------------------------------------------------------- #
# the reference's compat helpers, on a Recording
# --------------------------------------------------------------------------- #

def count_pallas_calls(recording: Recording) -> int:
    """Kernel dispatches of the recorded call (the reference's one-K-pass-
    per-batch detector, there a static ``pallas_call`` count)."""
    return len(recording.routes)


def max_intermediate_elems(recording: Recording) -> int:
    """Elements of the largest intermediate (by bytes, ties by elements)."""
    return report_from_jaxpr(recording).peak_elems


def peak_intermediate_bytes(recording: Recording) -> int:
    """Bytes of the largest single intermediate."""
    return report_from_jaxpr(recording).peak_bytes


def all_shapes(recording: Recording) -> set:
    """Every distinct tensor shape an op of the recorded call took or made."""
    shapes: set = set()
    for ev in recording.ops:
        shapes.update(ev.input_shapes)
        shapes.update(o[0] for o in ev.outputs)
    return shapes


def verify_donation(outputs, donated) -> bool:
    """True if every donated buffer is the storage of one of ``outputs``
    (tensors, or containers of them): what ``donate=True`` promises
    (``core.apply.accum_grow_batched``).  The reference checks that its
    lowering carries buffer-donation attributes; the port checks the
    buffers themselves, after the call."""
    out_ptrs = {_storage(t) for t in _leaves(outputs) if isinstance(t, torch.Tensor)}
    don = [t for t in _leaves(donated) if isinstance(t, torch.Tensor)]
    return bool(don) and all(_storage(t) in out_ptrs for t in don)
