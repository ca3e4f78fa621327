"""Resilience layer: fault injection, health reporting and the PSD solve
ladder (no kernel dispatch ladder: a CUDA tensor never degrades)."""
from repro_torch.resilience.degrade import (
    HealthEvent,
    HealthReport,
    global_health,
    solve_psd_ladder,
)
from repro_torch.resilience.faults import (
    SITES,
    DeviceLost,
    FaultInjected,
    active_plan,
    corrupt,
    fault_point,
    mangle_matrix,
    poison,
    reset,
)
