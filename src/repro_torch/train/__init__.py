"""The training step and the fault-tolerant loop (ported from
``repro.train``)."""
