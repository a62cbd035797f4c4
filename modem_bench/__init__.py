"""The benchmark of gr_dtl_tpu_torch on an NVIDIA H100 (README.md)."""
