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
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
from torch.utils._pytree import tree_leaves as _leaves
from torch.utils._python_dispatch import TorchDispatchMode

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


@dataclasses.dataclass
class OpEvent:
    """One dispatched aten op: its name, its outputs (shape, dtype, bytes,
    whether it shares storage with an input) and its tensor inputs'
    shapes."""

    name: str
    outputs: list
    input_shapes: list


@dataclasses.dataclass
class Recording:
    """The port's traced program: the ops, router calls and FLOPs of one
    eager call, and its result."""

    ops: list = dataclasses.field(default_factory=list)
    routes: list = dataclasses.field(default_factory=list)
    flops: float = 0.0
    result: Any = None


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
            [tuple(t.shape) for t in ins]))
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
