"""Numerical degradation ladders (the PSD solve ladder)."""
from repro_torch.resilience.degrade import solve_psd_ladder
