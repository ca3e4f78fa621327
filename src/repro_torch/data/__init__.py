"""The deterministic synthetic token stream (ported from ``repro.data``)."""
