"""gr_dtl_tpu_torch — the adaptive-OFDM modem of ``gr_dtl_tpu`` in PyTorch.

A port of the JAX package for one NVIDIA H100: plain tensor code is
PyTorch, and the JAX package's Pallas kernel is a CUDA C++ kernel for
``sm_90a`` (``csrc/``, built at first use by ``ops/sync_cuda``).  The
layout mirrors ``gr_dtl_tpu`` (``utils/``, ``ops/``, ``models/``) module
for module and function for function.  This package imports neither
``jax`` nor ``gr_dtl_tpu``; the JAX package is the reference the tests
hold it against.

Slice A is ported: the uncoded batch receiver
(``models.receiver.detect_and_extract`` + ``rx_frames``) and the
uncoded transmitter and AWGN channel that feed it.
"""

import torch

# TF32 keeps ~10 mantissa bits.  The size-64 DFT, the LS channel
# estimate and the carrier-offset correlation are float32 matmuls whose
# results feed hard decisions, and the affine CRC is a float32 matmul
# of 0/1 values whose sums must stay exact integers (< 2^24).  All of
# them need full float32, so TF32 is off for matmuls and convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
