"""The codeword LLRs of the FEC decode on the GPU: the CUDA kernel of
``csrc/codewords.cu`` (K10) and its wrapper.

``codewords_cuda`` computes in one pass what
``models/fec_chain.py::_extract_torch`` computes as a chain of PyTorch
kernels over int64 index tensors: each group's LLR stream (its W frames'
rows, one after another) cut into the codewords' padded slots, the unsent
ones pinned.  It stands for no TPU kernel (the JAX package leaves the
gather to XLA).  The library is built at first use (``ops/_cuda_build``);
importing this module needs neither ``nvcc`` nor a GPU.  The wrapper
launches on PyTorch's current stream, never synchronises, reads nothing
back, and counts its launches (one a call with groups) in
``codewords_cuda.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from gr_dtl_tpu_torch.ops import _cuda_build

__all__ = ["build", "bind_launch", "library_path", "codewords_cuda", "cw_bytes", "smem_bytes", "SOURCE"]

SOURCE = _cuda_build.PKG / "csrc" / "codewords.cu"
NVCC_FLAGS = _cuda_build.NVCC_FLAGS
SMEM_MAX = 227 * 1024  # what a block may take on an H100


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    return _cuda_build.library_path(SOURCE, NVCC_FLAGS)


def bind_launch(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument types of its ``codewords_launch``."""
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.codewords_launch.argtypes = [p, ll, i, i, p, p, i, p, p, p, p, ll, i, i, i, f, p, p]
    lib.codewords_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return bind_launch(_cuda_build.load(SOURCE, NVCC_FLAGS))


def smem_bytes(W: int, max_frame_bits: int, Cmax: int) -> int:
    """Shared memory a block takes (the source's ``smem_bytes``):
    the group's stream of W rows (one at W = 1), then its schedule."""
    L = W * max_frame_bits
    return -(-4 * L // 16) * 16 + 16 * Cmax


def cw_bytes(G: int, Cmax: int, Nmax: int, llrs_read: int, n_fb: int = 5) -> int:
    """Bytes one call must move: the ``llrs_read`` LLRs the groups' sent
    slots read, once; each group's bps and check bits (8 bytes each), each
    codeword's k', start (8 bytes each) and flag (1 byte), and the frame-bits
    table read once; the [G, Cmax, Nmax] float32 slots written once."""
    return 4 * llrs_read + G * 16 + G * Cmax * 17 + 4 * n_fb + 4 * G * Cmax * Nmax


def codewords_cuda(llrs: torch.Tensor, W: int, bps: torch.Tensor, frame_bits: torch.Tensor, m: torch.Tensor,
                   k_prime: torch.Tensor, cw_start: torch.Tensor, real: torch.Tensor, Mmax: int, Nmax: int,
                   pin: float) -> torch.Tensor:
    """The [G, Cmax, Nmax] codeword LLRs of G = B / W groups of W frames, in
    one launch.

    Args:
      llrs:       [B, max_frame_bits] float32 CUDA tensor, the frames' LLR
                  rows as they lie (any row stride, elements contiguous).
      W:          frames a group (a transport block).
      bps:        [G] int64 bits a symbol of each group (read at W > 1).
      frame_bits: [n] int32 bits of a frame by bps (read at W > 1).
      m:          [G] int64 check bits of each group's code.
      k_prime, cw_start: [G, Cmax] int64: each codeword's systematic bits
                  sent and its first bit in the group's stream.
      real:       [G, Cmax] bool: the codeword is one of the group's.
      Mmax, Nmax: the padded layout [parity: Mmax | systematic: Nmax - Mmax].
      pin:        the LLR of every slot not sent.
    Returns [G, Cmax, Nmax] float32 (``_extract_torch``'s values, bit for bit).
    """
    if llrs.ndim != 2:
        raise ValueError(f"codewords_cuda needs llrs as a float32 tensor [B, max_frame_bits], got {tuple(llrs.shape)}")
    B, max_bits = llrs.shape
    if W < 1 or B % W:
        raise ValueError(f"codewords_cuda needs B a multiple of W >= 1, got B = {B}, W = {W}")
    if llrs.dtype != torch.float32 or max_bits < 1 or (llrs.stride(1) != 1 and max_bits > 1) or llrs.stride(0) < 0:
        raise ValueError(f"codewords_cuda needs llrs as float32 rows with contiguous elements, got {llrs.dtype} "
                         f"{tuple(llrs.shape)} with strides {llrs.stride()}")
    if k_prime.ndim != 2 or k_prime.shape[0] != B // W or k_prime.shape[1] < 1:
        raise ValueError(f"codewords_cuda needs k_prime as [G, Cmax] with G = {B // W}, got {tuple(k_prime.shape)}")
    G, Cmax = k_prime.shape
    if not 0 <= Mmax <= Nmax or Nmax < 1:
        raise ValueError(f"codewords_cuda needs 0 <= Mmax <= Nmax, Nmax >= 1, got Mmax = {Mmax}, Nmax = {Nmax}")
    if smem_bytes(W, max_bits, Cmax) > SMEM_MAX:
        raise ValueError(f"codewords_cuda stages W max_frame_bits = {W * max_bits} floats a group in shared memory: "
                         f"{smem_bytes(W, max_bits, Cmax)} bytes a block, over {SMEM_MAX}")
    if frame_bits.ndim != 1 or frame_bits.numel() < 1:
        raise ValueError(f"codewords_cuda needs frame_bits as a non-empty [n] tensor, got {tuple(frame_bits.shape)}")
    args = {"bps": (bps, torch.int64, (G,)), "frame_bits": (frame_bits, torch.int32, tuple(frame_bits.shape)),
            "m": (m, torch.int64, (G,)), "k_prime": (k_prime, torch.int64, (G, Cmax)),
            "cw_start": (cw_start, torch.int64, (G, Cmax)), "real": (real, torch.bool, (G, Cmax))}
    for name, (t, dtype, shape) in args.items():
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"codewords_cuda needs {name} as a contiguous {dtype} tensor of shape {shape}, "
                             f"got {t.dtype} {tuple(t.shape)} with strides {t.stride()}")
    dev = llrs.device
    for name, t in [("llrs", llrs)] + [(k, v[0]) for k, v in args.items()]:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"codewords_cuda needs CUDA tensors on one device, got {name} on {t.device}")
    out = torch.empty((G, Cmax, Nmax), dtype=torch.float32, device=dev)
    if G == 0:
        return out
    with torch.cuda.device(dev):
        rc = build().codewords_launch(
            llrs.data_ptr(), llrs.stride(0), max_bits, W, bps.data_ptr(), frame_bits.data_ptr(), frame_bits.numel(),
            m.data_ptr(), k_prime.data_ptr(), cw_start.data_ptr(), real.data_ptr(), G, Cmax, Nmax, Mmax, pin,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"codewords_launch failed: CUDA error {rc}")
    codewords_cuda.LAUNCHES += 1
    return out


codewords_cuda.LAUNCHES = 0
