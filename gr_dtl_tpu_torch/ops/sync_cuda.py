"""Schmidl-Cox timing metric on the GPU: the CUDA kernel of
``csrc/sync_metric.cu`` and its wrapper.

The kernel replaces the Pallas TPU kernel
``gr_dtl_tpu/ops/sync_pallas.py::_metric_kernel``; its plain PyTorch
version is ``ops/sync.py::_timing_metric_torch``.  The shared library is
built with ``nvcc`` for ``sm_90a`` at first use, into ``_build/`` beside
the package, keyed by a hash of the source and flags, and loaded with
``ctypes``.  Importing this module needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

__all__ = ["build", "tiling", "timing_metric_cuda"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "sync_metric.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
FFT_LEN = 64    # the kernel is specialized for it
TILE = 2048     # outputs a block emits (kTile of the source)
ALIGN = 16      # a tile's first output sits on a multiple of 16 outputs of M: 64 bytes


def tiles_per_row(out_len: int) -> int:
    """Blocks the launch gives one row: its tile grid starts up to
    ``ALIGN - 1`` outputs before its output 0."""
    return -(-(out_len + ALIGN - 1) // TILE)


class Tiling(NamedTuple):
    """How one launch cuts ``[rows, n]`` into tiles (see :func:`tiling`)."""
    out_len: int
    tiles_per_row: int
    phase: tuple       # per row: outputs by which the tile grid is shifted left
    in_vec: tuple      # per row: the input takes 16-byte loads
    p_vec: tuple       # per row: P takes 16-byte stores

    def tile_outputs(self, row: int, t: int) -> range:
        """The outputs d of ``row`` that tile ``t`` writes."""
        lo = t * TILE - self.phase[row]
        return range(max(lo, 0), max(min(lo + TILE, self.out_len), 0))


def tiling(n: int, rows: int = 1, r_addr: int = 0, p_addr: int = 0, m_addr: int = 0) -> Tiling:
    """The tiling of a ``[rows, n]`` stream whose input, P and M buffers
    start at the given byte addresses, for the CPU tests of coverage and
    alignment.  The launch takes its grid from :func:`tiles_per_row`; the
    kernel works each row's phase and access width out from its pointers.

    Row ``w`` starts at element ``w * n`` of the input and ``w * (n - 64)``
    of P and M, so with an odd ``n`` or ``w`` its 16-byte boundaries fall
    elsewhere than row 0's.  The kernel lays each row's tiles on a grid whose
    origin is a multiple of ``ALIGN`` outputs in M's address space: tile
    ``t`` covers the outputs ``d`` with ``t * TILE <= d + phase < (t + 1) *
    TILE``.  Samples and P then go in 16-byte pairs from the tile's origin
    when that origin is 16-byte aligned in their buffers too.
    """
    out_len = n - FFT_LEN
    if out_len <= 0 or rows <= 0:
        raise ValueError(f"need n > {FFT_LEN} and rows >= 1, got n={n} rows={rows}")
    if r_addr % 8 or p_addr % 8 or m_addr % 4:
        raise ValueError("buffers must be aligned to their element size")
    phase = tuple((m_addr // 4 + w * out_len) % ALIGN for w in range(rows))
    in_vec = tuple((r_addr // 8 + w * n - ph) % 2 == 0 for w, ph in enumerate(phase))
    p_vec = tuple((p_addr // 8 + w * out_len - ph) % 2 == 0 for w, ph in enumerate(phase))
    return Tiling(out_len, tiles_per_row(out_len), phase, in_vec, p_vec)


def metric_bytes(n: int, rows: int = 1) -> int:
    """Bytes the metric must move: every complex64 sample read once, P
    (complex64) and M (float32) written once."""
    return rows * (8 * n + 12 * (n - FFT_LEN))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (not on PATH, nor under $CUDA_HOME/bin): "
                       "the CUDA toolkit is needed to build csrc/sync_metric.cu")


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    text = SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    return BUILD_DIR / f"libsync_metric_{hashlib.sha256(text).hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library.  The
    compiler's report (``-Xptxas=-v``: registers, shared memory, spills) is
    kept beside the library as ``.log``."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.sc_metric_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p]
    lib.sc_metric_launch.restype = ctypes.c_int
    return lib


def _launch_into(r: torch.Tensor, P: torch.Tensor, M: torch.Tensor) -> None:
    """Launch the kernel on ``r`` ([N] or [S, N] complex64) into the
    preallocated ``P`` ([..., N - 64, 2] float32) and ``M`` ([..., N - 64]
    float32) on PyTorch's current stream.  Checks nothing about the
    tensors (:func:`timing_metric_cuda` does); counts the launch."""
    n = r.shape[-1]
    rows = r.numel() // n
    rc = build().sc_metric_launch(r.data_ptr(), P.data_ptr(), M.data_ptr(), n, rows,
                                  tiles_per_row(n - FFT_LEN),
                                  torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sc_metric_launch failed: CUDA error {rc}")
    timing_metric_cuda.LAUNCHES += 1


def timing_metric_cuda(r: torch.Tensor, fft_len: int = FFT_LEN):
    """Schmidl-Cox (P, M) of a [N] or [S, N] complex64 CUDA stream by the
    hand-written kernel; same contract as ``ops/sync.timing_metric``.

    Raises on a tensor the kernel does not take (not on a CUDA device,
    not complex64, not contiguous, N <= 64, more than 65535 rows) and
    on fft_len != 64.  Counts its launches in ``timing_metric_cuda.LAUNCHES``.
    """
    if r.device.type != "cuda":
        raise ValueError(f"timing_metric_cuda needs a CUDA tensor, got {r.device}")
    if r.dtype != torch.complex64:
        raise ValueError(f"timing_metric_cuda needs complex64, got {r.dtype}")
    if not r.is_contiguous():
        raise ValueError("timing_metric_cuda needs a contiguous tensor")
    if fft_len != FFT_LEN:
        raise ValueError(f"the kernel is specialized for fft_len={FFT_LEN}, got {fft_len}")
    if r.ndim not in (1, 2) or r.shape[-1] <= fft_len:
        raise ValueError(f"timing_metric_cuda needs [N] or [S, N] with N > 64, got {tuple(r.shape)}")
    rows = 1 if r.ndim == 1 else r.shape[0]
    if not 1 <= rows <= 65535:
        raise ValueError(f"timing_metric_cuda takes 1..65535 rows, got {rows}")
    out_shape = (*r.shape[:-1], r.shape[-1] - fft_len)
    P = torch.empty((*out_shape, 2), dtype=torch.float32, device=r.device)
    M = torch.empty(out_shape, dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        _launch_into(r, P, M)
    return torch.view_as_complex(P), M


timing_metric_cuda.LAUNCHES = 0
