"""The NVIDIA H100 SXM5's published peaks (NVIDIA H100 Tensor Core GPU data
sheet, dense rates without sparsity, at the 700 W power limit), frozen here
so that the benchmark's yardstick does not move when the program changes.

Every FLOP count of the benchmark is divided by the TF32 tensor-core rate:
it is the highest rate at which the card takes float32 inputs, so no
formulation of a float32 computation, on tensor cores or split-TF32 or on
the FP32 pipe (67 TFLOP/s), can read above 100% of it.
"""
HBM_BYTES_PER_S = 3.35e12        # HBM3, 80 GB
TF32_FLOPS_PER_S = 494.7e12      # TF32 tensor cores, dense
FP32_FLOPS_PER_S = 66.9e12       # FP32 outside the tensor cores (not a divisor here)
MEMORY_BYTES = 80e9
