"""AdamW with float32 master weights, and sketched gradient compression with
error feedback (ported from ``repro.optim``)."""
