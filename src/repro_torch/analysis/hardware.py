"""One hardware model for the trace-contract analyzer and the roofline
numbers (the twin of ``repro.analysis.hardware``).

The default profile is the card the port runs on, NVIDIA H100 80GB HBM3
(SXM5) at its 700.00 W power limit, with the peaks of NVIDIA's "H100 Tensor
Core GPU" data sheet (H100 SXM column, dense rates): the same 3.35 TB/s,
67 TFLOP/s float32 and 494.7 TFLOP/s TF32 that the port's measurements are
divided by (``chip_smoke.py``, PERF.md §6).  A card set below 700 W runs
slower under load, so a budget stated against these numbers is against
the card at its full limit.  The port has no TPU profile.  Override per
call (``HardwareModel(peak_flops=...)``) or swap the default with
``set_default_hardware``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Per-card peak numbers used for roofline terms and trace budgets.

    ``peak_flops`` is the bfloat16 tensor-core peak (the reference's field
    means its chip's bfloat16 matrix peak); the float32 (FMA pipe) and TF32
    tensor-core peaks, the HBM rate and capacity, the NVLink rate (all 18
    links of one card, both directions) and the L2 size are the port's
    additions.  The reference's per-link ``ici_bw`` and on-chip
    ``vmem_bytes`` have no counterpart."""

    name: str = "NVIDIA H100 80GB HBM3, 700.00 W"
    peak_flops: float = 989.4e12        # bfloat16 FLOP/s, tensor cores, dense
    peak_flops_f32: float = 67e12       # float32 FLOP/s outside the tensor cores
    peak_flops_tf32: float = 494.7e12   # TF32 FLOP/s, tensor cores, dense
    hbm_bw: float = 3.35e12             # B/s
    nvlink_bw: float = 900e9            # B/s per card, 18 links, both directions
    hbm_bytes: float = 80e9             # HBM capacity
    l2_bytes: float = 50e6              # L2 cache


H100_SXM = HardwareModel()

DEFAULT_HARDWARE = H100_SXM


def get_default_hardware() -> HardwareModel:
    """The process-wide default card profile (used when no override is
    passed)."""
    return DEFAULT_HARDWARE


def set_default_hardware(hw: HardwareModel) -> HardwareModel:
    """Swap the process-wide default card profile; returns the previous
    one."""
    global DEFAULT_HARDWARE
    prev = DEFAULT_HARDWARE
    DEFAULT_HARDWARE = hw
    return prev
