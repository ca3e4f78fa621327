"""Accumulation-sketch application kernels: CUDA sources in ``csrc/``, their
build and binding (``kernel``), the plain versions (``ref``) and the
shape-agnostic wrappers (``ops``)."""
