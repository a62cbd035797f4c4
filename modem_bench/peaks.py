"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; at its 700 W limit)."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # outside the tensor cores
