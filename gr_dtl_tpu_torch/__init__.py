"""gr_dtl_tpu_torch — the adaptive-OFDM modem of ``gr_dtl_tpu`` in PyTorch.

A port of the JAX package for one NVIDIA H100: plain tensor code is
PyTorch, and the JAX package's Pallas kernel, as well as the per-frame
scans that eager PyTorch would run as thousands of small launches, are CUDA
C++ kernels for ``sm_90a`` (``csrc/``; ``ops/_cuda_build`` compiles each
source with ``nvcc`` at first use, and ``ops/sync_cuda``, ``ops/scans_cuda``
and ``ops/tb_cuda`` hold their wrappers).  The layout mirrors ``gr_dtl_tpu``
(``utils/``, ``ops/``, ``models/``) module for module and function for
function.  This package imports neither ``jax`` nor ``gr_dtl_tpu``; the JAX
package is the reference the tests hold it against.

Ported: slice A, the uncoded batch modem (``models.transmitter``,
``models.receiver.detect_and_extract`` + ``rx_frames``); slice B, the coded
LDPC path (``ops.ldpc``, ``models.fec_chain``); slice C, the always-on
streaming sessions (``models.session``, ``models.streaming``,
``models.adaptive``, ``ops.metrics``); slice D, the channel models
(``ops.channel``), the feedback-burst modem (``ops.burst``), the simplex and
in-graph full-duplex links (``models.simplex``, ``models.full_duplex``) and
the burst sessions (``session.StreamBurstRx``, ``session.StreamSimplex``).
"""

import torch

# TF32 keeps ~10 mantissa bits.  The size-64 DFT, the LS channel
# estimate and the carrier-offset correlation are float32 matmuls whose
# results feed hard decisions, and the affine CRC is a float32 matmul
# of 0/1 values whose sums must stay exact integers (< 2^24).  All of
# them need full float32, so TF32 is off for matmuls and convolutions
# (the burst modem's pulse shaping and correlations are convolutions).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
