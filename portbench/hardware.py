"""Peak rates of one NVIDIA H100 SXM (80 GB HBM3), frozen for the yardstick.

From NVIDIA's H100 Tensor Core GPU datasheet, SXM column, at the full 700 W
power limit: 3.35 TB/s of HBM3 and 34 TFLOP/s of FP64 on the CUDA cores
(outside the tensor cores). A card set below 700 W runs slower under load;
the harness prints the card's power limit beside its numbers.
"""
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 34e12
