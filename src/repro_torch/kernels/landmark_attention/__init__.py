"""Landmark-attention kernels (the O(S·L) stages of sketched attention):
CUDA sources in ``csrc/``, their build and binding (``kernel``), the plain
versions (``ref``) and the padded entry points (``ops``)."""
