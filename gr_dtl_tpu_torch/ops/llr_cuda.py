"""The coded demap's LLRs on the GPU: the CUDA kernel of
``csrc/soft_demap.cu`` (K9) and its wrapper.

``frame_llrs_cuda`` computes in one pass what
``models/receiver.py::_frame_llrs_torch`` computes as a chain of PyTorch
kernels: the closed-form max-log LLRs of each payload symbol
(``ops/constellation.py::soft_llrs``), written into the frame bit stream.
It stands for no TPU kernel (the JAX package leaves both to XLA).  The
library is built at first use (``ops/_cuda_build``); importing this module
needs neither ``nvcc`` nor a GPU.  The wrapper launches on PyTorch's
current stream, never synchronises, reads nothing back, and counts its
launches (one a call with frames) in ``frame_llrs_cuda.LAUNCHES``.
Wire-compat tables (table mode) decide by another algorithm and never
come here.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from gr_dtl_tpu_torch.ops import _cuda_build

__all__ = ["build", "bind_launch", "library_path", "frame_llrs_cuda", "llr_bytes", "SOURCE"]

SOURCE = _cuda_build.PKG / "csrc" / "soft_demap.cu"
NVCC_FLAGS = _cuda_build.NVCC_FLAGS
MAX_SYMBOLS = 1 << 28  # the source's bound on S: a row's 4 S outputs stay 32-bit offsets


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    return _cuda_build.library_path(SOURCE, NVCC_FLAGS)


def bind_launch(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument types of its ``soft_demap_launch``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.soft_demap_launch.argtypes = [p, p, p, p, i, ll, i, i, p, p]
    lib.soft_demap_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return bind_launch(_cuda_build.load(SOURCE, NVCC_FLAGS))


def llr_bytes(B: int, S: int, max_frame_bits: int) -> int:
    """Bytes one call must move: every complex64 symbol read once, a frame's
    constellation id, noise variance and bits a symbol read once (4 bytes
    each), and the float32 row of ``max_frame_bits`` LLRs written once, its
    zero tail included."""
    return B * (8 * S + 12 + 4 * max_frame_bits)




def frame_llrs_cuda(soft: torch.Tensor, cnst: torch.Tensor, noise_var: torch.Tensor,
                    bps_table: torch.Tensor, max_frame_bits: int) -> torch.Tensor:
    """Max-log LLRs of a batch of frames' payload symbols, serialised into
    each frame's bit stream, in one launch.

    Args:
      soft:       [B, S] complex64 CUDA tensor, contiguous.
      cnst:       [B] int32 constellation ids (closed-form forms: 1 BPSK, 2
                  QPSK, 3 8PSK, any other the 16QAM forms).
      noise_var:  [B] float32 noise variances (clamped at 1e-12).
      bps_table:  [n_types] int64 bits a symbol by id (``Tables.bps``).
      max_frame_bits: the row's length, a positive multiple of 4.
    Returns [B, max_frame_bits] float32: symbol s of a frame of k bits a
    symbol holds bits s*k .. s*k+k-1, everything from S*k on is 0, and a
    frame whose k is not 1..4 (or whose id lies outside the table) is all 0.
    """
    if soft.ndim != 2:
        raise ValueError(f"frame_llrs_cuda needs soft as a complex64 tensor [B, S], got {tuple(soft.shape)}")
    B, S = soft.shape
    if not 1 <= S <= MAX_SYMBOLS:
        raise ValueError(f"frame_llrs_cuda takes 1 to {MAX_SYMBOLS} symbols a frame, got {S}")
    if max_frame_bits < 4 or max_frame_bits % 4:
        raise ValueError(f"frame_llrs_cuda needs max_frame_bits a positive multiple of 4 (16-byte rows), "
                         f"got {max_frame_bits}")
    if bps_table.ndim != 1 or bps_table.numel() < 1:
        raise ValueError(f"frame_llrs_cuda needs bps_table as a non-empty [n_types] tensor, got "
                         f"{tuple(bps_table.shape)}")
    args = {"soft": (soft, torch.complex64, (B, S)), "cnst": (cnst, torch.int32, (B,)),
            "noise_var": (noise_var, torch.float32, (B,)),
            "bps_table": (bps_table, torch.int64, tuple(bps_table.shape))}
    for name, (t, dtype, shape) in args.items():
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"frame_llrs_cuda needs {name} as a contiguous {dtype} tensor of shape {shape}, "
                             f"got {t.dtype} {tuple(t.shape)} with strides {t.stride()}")
    dev = soft.device
    for name, (t, _, _) in args.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"frame_llrs_cuda needs CUDA tensors on one device, got {name} on {t.device}")
    llrs = torch.empty((B, max_frame_bits), dtype=torch.float32, device=dev)
    if B == 0:
        return llrs
    with torch.cuda.device(dev):
        rc = build().soft_demap_launch(
            soft.data_ptr(), cnst.data_ptr(), noise_var.data_ptr(), bps_table.data_ptr(), bps_table.numel(),
            B, S, max_frame_bits, llrs.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"soft_demap_launch failed: CUDA error {rc}")
    frame_llrs_cuda.LAUNCHES += 1
    return llrs


frame_llrs_cuda.LAUNCHES = 0
