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

import torch

__all__ = ["build", "timing_metric_cuda"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "sync_metric.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


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
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libsync_metric_{tag}.so"


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library.  The
    compiler's report (``-Xptxas=-v``: registers, shared memory, spills)
    is kept beside the library as ``.log``."""
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
                                     ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.sc_metric_launch.restype = ctypes.c_int
    return lib


def timing_metric_cuda(r: torch.Tensor, fft_len: int = 64):
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
    if fft_len != 64:
        raise ValueError(f"the kernel is specialized for fft_len=64, got {fft_len}")
    if r.ndim not in (1, 2) or r.shape[-1] <= fft_len:
        raise ValueError(f"timing_metric_cuda needs [N] or [S, N] with N > 64, got {tuple(r.shape)}")
    rows = 1 if r.ndim == 1 else r.shape[0]
    if not 1 <= rows <= 65535:
        raise ValueError(f"timing_metric_cuda takes 1..65535 rows, got {rows}")
    n = r.shape[-1]
    lib = build()
    out_shape = (*r.shape[:-1], n - fft_len)
    P = torch.empty((*out_shape, 2), dtype=torch.float32, device=r.device)
    M = torch.empty(out_shape, dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        rc = lib.sc_metric_launch(r.data_ptr(), P.data_ptr(), M.data_ptr(), n, rows,
                                  torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sc_metric_launch failed: CUDA error {rc}")
    timing_metric_cuda.LAUNCHES += 1
    return torch.view_as_complex(P), M


timing_metric_cuda.LAUNCHES = 0
