"""Roofline terms of one rank's program (the twin of ``repro.launch.analysis``).

The reference re-derives its terms from the compiled HLO text of the SPMD
module (one partition's program), multiplying each loop body by its trip
count, because XLA's cost analysis visits a ``while`` body once.  The port
has no compiled program: the dry run records one rank's op stream
(``analysis.trace.record_rank``: DTensor's local ops, at the shapes this
rank computes), and eager mode runs every trip of every loop, so no
multiplier is needed.  Over that stream (``RankProgram``, the counterpart
of the reference's ``HloModule``):

  * FLOPs: the products torch's ``flop_counter`` knows (mm, bmm, addmm,
    baddbmm, convolutions, attention — the reference's dots and
    convolutions), at the local shapes, and the kernel stand-ins'
    (``landmark_attention``'s two products);
  * HBM bytes: operand plus result bytes of every op that is not a view,
    an allocation (``empty``: it moves no byte) or host arithmetic (the
    program's host values).  Eager ops are unfused, so this is each op's own traffic
    (the reference's post-fusion model charges a fusion's operands and
    result once: the port's count is an upper bound on a fused program);
  * collective bytes: result bytes × the reference's ring factor
    (all-reduce 2×), the torch collectives (``_c10d_functional``, DTensor's
    ``shard_dim_alltoall``) named as the reference's HLO ops;
  * peak memory: the high-water mark of the bytes the rank's live storages
    on the device hold over the call, the arguments included, each storage
    rounded up to the caching allocator's 512-byte granule — the
    counterpart of the reference's temp + argument + output − alias.

Terms (per rank):
  compute    = FLOPs / hw.peak_flops      memory = bytes / hw.hbm_bw
  collective = coll_bytes / hw.nvlink_bw

``hw`` is ``repro_torch.analysis.hardware``'s H100 profile unless another
is passed.  The collective term divides by one card's NVLink rate: on a
mesh that spans 32 or 64 eight-card nodes most of these bytes cross the
nodes' network, which is slower, so this term is a lower bound there.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.hardware import H100_SXM, HardwareModel, get_default_hardware

# the module constants of the reference, from the H100 profile (the
# overridable source of truth is repro_torch.analysis.hardware)
PEAK_FLOPS = H100_SXM.peak_flops     # bf16 FLOP/s per card (dense tensor cores)
HBM_BW = H100_SXM.hbm_bw             # B/s per card
NVLINK_BW = H100_SXM.nvlink_bw       # B/s per card

_COLLECTIVE_FACTOR = {
    "all-gather": 1.0, "all-gather-start": 1.0,
    "all-reduce": 2.0, "all-reduce-start": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0, "collective-permute-start": 1.0,
}

# torch's collective ops → the reference's HLO op names
_TORCH_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "alltoall_base_": "all-to-all",
}
_COLLECTIVE_NAMESPACES = frozenset({"_c10d_functional", "_c10d_functional_autograd",
                                    "_dtensor", "c10d"})
# ops of those namespaces that move nothing
_NOT_COLLECTIVES = frozenset({"wait_tensor", "_wrap_tensor_autograd", "shard_dim_alltoall_"})
# allocations: they compute nothing and move no byte
ALLOCATIONS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided"})


def collective_kind(ev) -> str | None:
    """The reference's name of the collective ``ev`` (an ``OpEvent``), or
    None for an op that is not one.  Raises on a collective it does not
    know, so that no bytes go uncounted."""
    if ev.namespace not in _COLLECTIVE_NAMESPACES or ev.name in _NOT_COLLECTIVES:
        return None
    if ev.name not in _TORCH_COLLECTIVES:
        raise ValueError(f"unknown collective {ev.namespace}.{ev.name}")
    return _TORCH_COLLECTIVES[ev.name]


def compute_op(ev) -> bool:
    """Whether ``ev`` does work on the device: not a view, an allocation or
    host arithmetic."""
    return not (ev.view or ev.host or ev.name in ALLOCATIONS)


class RankProgram:
    """One rank's recorded op stream (``trace.record_rank``), walked as the
    reference's ``HloModule`` walks a compiled partition."""

    def __init__(self, recording):
        self.recording = recording
        self.ops = recording.ops

    def analyze(self) -> tuple[float, float, float, dict]:
        """(FLOPs, HBM bytes, weighted collective bytes, {"bytes": {op:
        bytes}, "count": {op: n}})."""
        flops = hbm = coll = 0.0
        detail: dict = {"bytes": {}, "count": {}}
        for ev in self.ops:
            flops += ev.flops
            if compute_op(ev):
                hbm += ev.nbytes
            kind = collective_kind(ev)
            if kind is not None:
                b = sum(o[2] for o in ev.outputs)
                coll += b * _COLLECTIVE_FACTOR[kind]
                detail["bytes"][kind] = detail["bytes"].get(kind, 0) + b
                detail["count"][kind] = detail["count"].get(kind, 0) + 1
        return flops, hbm, coll, detail


# the reference's name for its program walker
HloModule = RankProgram


@dataclasses.dataclass
class Roofline:
    """One rank's roofline terms and the card model they are scored
    against."""

    flops: float                 # per-rank FLOPs (every loop trip run)
    hbm_bytes: float             # per-rank HBM traffic estimate
    coll_bytes: float            # per-rank weighted collective bytes
    coll_detail: dict
    peak_mem_bytes: float        # per-rank peak of the live storages
    xla_flops: float = 0.0       # the reference's uncorrected cost analysis: none here
    xla_bytes: float = 0.0
    hardware: HardwareModel | None = None   # None → process default

    @property
    def hw(self) -> HardwareModel:
        """The card model this roofline is scored against."""
        if self.hardware is not None:
            return self.hardware
        return get_default_hardware()

    @property
    def t_compute(self) -> float:
        """Seconds of the products at the card's peak FLOP/s."""
        return self.flops / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        """Seconds of the HBM traffic at the card's HBM rate."""
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        """Seconds of the weighted collective bytes at one card's NVLink
        rate (a lower bound where the mesh spans nodes)."""
        return self.coll_bytes / self.hw.nvlink_bw

    @property
    def dominant(self) -> str:
        """The largest term: "compute", "memory" or "collective"."""
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def bound_time(self) -> float:
        """The largest term's seconds."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def compute_fraction(self) -> float:
        """The compute term's share of the bound."""
        return self.t_compute / max(self.bound_time, 1e-30)

    def to_dict(self) -> dict:
        """JSON-ready form (the dry run's record)."""
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "coll_detail": self.coll_detail,
            "peak_mem_bytes": self.peak_mem_bytes,
            "xla_flops": self.xla_flops, "xla_bytes": self.xla_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "roofline_fraction": self.compute_fraction(),
            "hardware": self.hw.name,
        }


def analyze(recording, hardware: HardwareModel | None = None) -> Roofline:
    """The roofline of one rank's recorded program (``trace.record_rank``)."""
    flops, hbm, coll, detail = RankProgram(recording).analyze()
    return Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=coll, coll_detail=detail,
                    peak_mem_bytes=float(recording.peak_bytes), hardware=hardware)


def model_flops(n_params_active: int, n_tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference fwd)."""
    return (6.0 if kind == "train" else 2.0) * n_params_active * n_tokens
