"""The streaming sessions' per-frame recurrences on the GPU: the two CUDA
kernels of ``csrc/stream_scans.cu`` and their wrappers.

``trigger_lock_scan_cuda`` stands for the ``lax.scan`` of
``gr_dtl_tpu/models/streaming.py::trigger_lock_scan`` and
``frame_accounting_cuda`` for the accounting scans of
``gr_dtl_tpu/models/session.py`` (the block step) and
``gr_dtl_tpu/ops/metrics.py::lost_frames``.  Their plain PyTorch versions
are ``models/streaming.py::_trigger_lock_scan_torch`` and
``ops/metrics.py::_frame_accounting_torch``.  The library is built at
first use (``ops/_cuda_build``); importing this module needs neither
``nvcc`` nor a GPU.  Each wrapper launches on PyTorch's current stream,
never synchronises, and counts its launches in ``<wrapper>.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from gr_dtl_tpu_torch.ops import _cuda_build

__all__ = ["build", "library_path", "trigger_lock_scan_cuda", "frame_accounting_cuda",
           "scan_bytes", "RULES"]

SOURCE = _cuda_build.PKG / "csrc" / "stream_scans.cu"
NVCC_FLAGS = _cuda_build.NVCC_FLAGS
# frame_accounting's two rules: the session step's (an undecoded slot changes
# nothing, the first received frame counts no gap) and metrics.lost_frames'
# (a bad header is one lost frame and advances the expectation)
RULES = {"received": 0, "header": 1}


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    return _cuda_build.library_path(SOURCE, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = _cuda_build.load(SOURCE, NVCC_FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.trigger_lock_scan_launch.argtypes = [p, p, p, i, i, i, p, p, p, p]
    lib.trigger_lock_scan_launch.restype = i
    lib.frame_accounting_launch.argtypes = [p, p, p, i, i, p, p, p, p]
    lib.frame_accounting_launch.restype = i
    return lib


def scan_bytes(T: int) -> dict:
    """Bytes each kernel must move for T items: its inputs read once, its
    outputs and carry written once."""
    return {"trigger_lock_scan": 16 + 5 * T + 16 + 5 * T,
            "frame_accounting": 4 + 5 * T + 4 + 4 * T + 8}


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got one on {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} needs a contiguous {dtype} tensor of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def trigger_lock_scan_cuda(state: torch.Tensor, cand: torch.Tensor, found: torch.Tensor,
                           period: int, tol: int = 4):
    """The lock state machine over T slots in one launch.

    Args:
      state: [4] int32 CUDA tensor: locked (0/1), expected, sync_count, miss_count.
      cand:  [T] int32 candidate trigger positions.
      found: [T] bool, the detector saw a plausible peak in that slot.
    Returns (state' [4] int32, trig [T] int32, valid [T] bool).
    """
    T = cand.shape[0] if cand.ndim == 1 else -1
    _check("trigger_lock_scan_cuda", state, torch.int32, (4,))
    _check("trigger_lock_scan_cuda", cand, torch.int32, (T,))
    _check("trigger_lock_scan_cuda", found, torch.bool, (T,))
    dev = cand.device
    state_out = torch.empty(4, dtype=torch.int32, device=dev)
    trig = torch.empty(T, dtype=torch.int32, device=dev)
    valid = torch.empty(T, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = build().trigger_lock_scan_launch(
            state.data_ptr(), cand.data_ptr(), found.data_ptr(), T, int(period), int(tol),
            state_out.data_ptr(), trig.data_ptr(), valid.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"trigger_lock_scan_launch failed: CUDA error {rc}")
    trigger_lock_scan_cuda.LAUNCHES += 1
    return state_out, trig, valid


def frame_accounting_cuda(expected_no: torch.Tensor, frame_no: torch.Tensor, ok: torch.Tensor,
                          rule: str = "received"):
    """Lost-frame accounting over T frames in one launch.

    Args:
      expected_no: [1] int32 CUDA tensor, the next expected 12-bit frame
                   number (-1: none seen yet, rule "received" only).
      frame_no:    [T] int32 received frame numbers.
      ok:          [T] bool, the frame was decoded.
      rule:        a key of :data:`RULES`.
    Returns (expected_no' [1] int32, lost [T] int32, totals [2] int32 =
    [sum of lost, count of ok]).
    """
    T = frame_no.shape[0] if frame_no.ndim == 1 else -1
    _check("frame_accounting_cuda", expected_no, torch.int32, (1,))
    _check("frame_accounting_cuda", frame_no, torch.int32, (T,))
    _check("frame_accounting_cuda", ok, torch.bool, (T,))
    dev = frame_no.device
    expected_out = torch.empty(1, dtype=torch.int32, device=dev)
    lost = torch.empty(T, dtype=torch.int32, device=dev)
    totals = torch.empty(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = build().frame_accounting_launch(
            expected_no.data_ptr(), frame_no.data_ptr(), ok.data_ptr(), T, RULES[rule],
            expected_out.data_ptr(), lost.data_ptr(), totals.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"frame_accounting_launch failed: CUDA error {rc}")
    frame_accounting_cuda.LAUNCHES += 1
    return expected_out, lost, totals


trigger_lock_scan_cuda.LAUNCHES = 0
frame_accounting_cuda.LAUNCHES = 0
