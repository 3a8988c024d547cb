"""The chip's peaks that shares of a roofline or of the peak are taken
against. Source: NVIDIA H100 Tensor Core GPU data sheet, H100 SXM, dense
rates (without sparsity), at the card's full 700 W; every run prints the
card's power limit beside its numbers (`nvidia-smi --query-gpu=
name,power.limit`), since a card set below 700 W runs slower under load.

FLOAT32_CUDA_CORES is the float32 rate outside the tensor cores, for
reference. The rate shares are taken against is FLOAT32_3XTF32: the TF32
tensor-core peak (495 TFLOP/s) over three, the rate of the float32-exact
3xTF32 route (three TF32 products per float32 product) that the conv
kernel takes. It is the highest float32-exact rate of the card, so a share
of it cannot pass 100% while the arithmetic stays float32.
"""

FLOAT32_CUDA_CORES = 67e12       # FLOP/s
TF32_TENSOR = 495e12             # FLOP/s
FLOAT32_3XTF32 = TF32_TENSOR / 3  # FLOP/s, 165e12
HBM_BYTES = 3.35e12              # bytes/s, 80 GB HBM3
