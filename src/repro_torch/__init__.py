"""PyTorch/CUDA port of the accumulation-sketch library (``repro``).

Mirrors ``src/repro/`` module for module.  Plain tensor code is PyTorch; the
TPU's Pallas kernels become CUDA C++ kernels for Hopper (``sm_90a``), built
from ``kernels/*/csrc`` at first use.  Tensors on the CPU take each kernel's
plain PyTorch version; tensors on a CUDA device launch the kernel.
"""
import torch

# The reference holds 1e-5 in float32 (tests/test_matfree.py).  TF32 keeps
# about three decimal digits, so every float32 product stays full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
