"""Peaks of one NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates,
no sparsity), at its full power limit of 700 W.  A share of a peak is
stated against these; the run prints the card's power limit beside it."""

#: dense bf16 / fp16 tensor-core rate, FLOP/s
BF16_FLOPS = 989e12
#: float32 outside the tensor cores, FLOP/s
F32_FLOPS = 67e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES_S = 3.35e12
#: device memory, bytes
HBM_BYTES = 80e9
