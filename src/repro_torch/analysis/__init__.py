"""Trace-contract analyzer of the PyTorch port: an eager-call recorder and
an RNG-lineage checker (the twin of ``repro.analysis``).

  * ``repro_torch.analysis.trace`` — record one eager call into a
    ``TraceReport`` (largest intermediate, dtype census, FLOPs, kernel
    dispatches, host syncs, aten op counts; buffer-donation verification);
  * ``repro_torch.analysis.rng`` — RNG-lineage checker (a seed shared by two
    call sites, a generator re-seeded in a loop) and the source-level sweep
    of every generator-making call;
  * ``repro_torch.analysis.streams`` — the registry of named RNG streams;
  * ``repro_torch.analysis.contracts`` — the per-entry-point budget manifest
    (``contracts.toml``) and its evaluator, on the CPU or on a card;
  * ``repro_torch.analysis.hardware`` — the overridable ``HardwareModel``
    (default: the H100 the port runs on);
  * ``repro_torch.analysis.hlo`` — dtype byte widths and the reference's
    type strings (``bf16[16,4096]``), which the dry run's per-op records
    spell (its lowered-text donation check has no twin: donation is checked
    on the buffers themselves).

Gate: ``python -m repro_torch.analysis check [--device cuda|cpu]``
(``--update`` ratchets measured peaks downward).  Only ``streams`` and
``hardware`` are imported eagerly by the modules below (``_util`` takes its
tags from ``streams``), so importing this package pulls in no other module
of the port.
"""
from repro_torch.analysis.hardware import (  # noqa: F401
    DEFAULT_HARDWARE,
    H100_SXM,
    HardwareModel,
    get_default_hardware,
    set_default_hardware,
)
from repro_torch.analysis.rng import (  # noqa: F401
    RngIssue,
    RngReport,
    check_fold_in_sites,
    report_from_events as rng_report_from_jaxpr,
    rng_report,
    sweep_fold_in_sites,
)
from repro_torch.analysis.trace import (  # noqa: F401
    TraceReport,
    all_shapes,
    count_pallas_calls,
    max_intermediate_elems,
    peak_intermediate_bytes,
    report_from_jaxpr,
    trace_report,
    verify_donation,
)

__all__ = [
    "DEFAULT_HARDWARE",
    "H100_SXM",
    "HardwareModel",
    "get_default_hardware",
    "set_default_hardware",
    "RngIssue",
    "RngReport",
    "check_fold_in_sites",
    "rng_report_from_jaxpr",
    "rng_report",
    "sweep_fold_in_sites",
    "TraceReport",
    "all_shapes",
    "count_pallas_calls",
    "max_intermediate_elems",
    "peak_intermediate_bytes",
    "report_from_jaxpr",
    "trace_report",
    "verify_donation",
]
