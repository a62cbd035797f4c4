"""The adaptive MCS decision over a block's frames on the GPU: the CUDA
kernel of ``csrc/feedback_scan.cu`` (K7) and its wrapper.

``feedback_scan_masked_cuda`` stands for the ``lax.scan`` of
``gr_dtl_tpu/models/adaptive.py::feedback_scan`` (:102) and for the masked
scan the reference's sessions and link tools write inline
(``gr_dtl_tpu/models/session.py:673-680``): a thread a batch column walks
the T frames with the decision state in registers, in one launch.  What
binds it is that walk (a launch plus T dependent steps), not its 9 bytes a
frame.  Its plain PyTorch version is
``models/adaptive.py::_feedback_scan_masked_torch``.  The library is built
at first use (``ops/_cuda_build``); importing this module needs neither
``nvcc`` nor a GPU.  The wrapper launches on PyTorch's current stream,
allocates its outputs with ``torch.empty``, never synchronises, and counts
its launches in ``feedback_scan_masked_cuda.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from gr_dtl_tpu_torch.ops import _cuda_build

__all__ = ["build", "library_path", "feedback_scan_masked_cuda", "feedback_bytes"]

SOURCE = _cuda_build.PKG / "csrc" / "feedback_scan.cu"
NVCC_FLAGS = _cuda_build.NVCC_FLAGS
MAX_RUNGS = 1 << 12  # kMaxRungs of the source: the ladder rungs it stages in shared memory


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    return _cuda_build.library_path(SOURCE, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = _cuda_build.load(SOURCE, NVCC_FLAGS)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.feedback_scan_launch.argtypes = [p, p, ll, ll, p, i, ctypes.c_float, i, p, p, p, i, i, p, p,
                                         p]
    lib.feedback_scan_launch.restype = i
    return lib


def feedback_bytes(T: int, B: int = 1, n_mcs: int = 0) -> int:
    """Bytes the kernel must move for T frames of B columns with a mask: the
    SNRs, the mask bytes and the MCS ids once each, the state read and
    written once, the ladder's thresholds read once."""
    return B * (T * (4 + 1 + 4) + 2 * 12) + 4 * n_mcs


def _mask_strides(mask: torch.Tensor, T: int, batch: tuple) -> tuple[int, int]:
    """(frame stride, column stride) of a contiguous bool mask that is
    [T] (every column alike) or [T, *batch]."""
    if mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError(f"the mask must be a contiguous bool tensor, got {mask.dtype}, "
                         f"strides {mask.stride()}")
    if tuple(mask.shape) == (T,):
        return 1, 0
    if tuple(mask.shape) == (T, *batch):
        return max(1, mask[0].numel()), 1
    raise ValueError(f"the mask must be [T] or [T, *batch] = {(T, *batch)}, got {tuple(mask.shape)}")


def feedback_scan_masked_cuda(last: torch.Tensor, cand: torch.Tensor, counter: torch.Tensor,
                              snrs_db: torch.Tensor, mask: torch.Tensor | None, snr_th: torch.Tensor,
                              n_mcs: int, hysteresis: float, decision_th: int):
    """The masked MCS decision over T frames of every batch column in one launch.

    Args:
      last, cand, counter: the decision state, int32 CUDA tensors of the
        batch shape (``()`` for one stream).  Every ``last`` lies in
        ``[0, n_mcs)``, as the plain loop requires of it (its table index
        raises outside the table; the steps keep it there).  The wrapper
        cannot look without reading the state back to the host: the kernel
        checks, and an id outside stops it with a device fault, as the plain
        loop's index does on the card.
      snrs_db: [T, *batch] float32 SNR estimates, contiguous.
      mask: [T] or [T, *batch] bool (the frame was decoded), or None: every
        frame counts.
      snr_th: the float32 threshold table on the same device, at least
        ``n_mcs`` entries (``build_mcs_tables`` makes exactly ``n_mcs``).
      n_mcs, hysteresis, decision_th: the rest of the MCS tables.
    Returns (state [3, *batch] int32 = last, cand, counter; mcs [T, *batch]
    int32).
    """
    batch = tuple(last.shape)
    dev = snrs_db.device
    if dev.type != "cuda":
        raise ValueError(f"feedback_scan_masked_cuda needs CUDA tensors, got one on {dev}")
    if snrs_db.dtype != torch.float32 or not snrs_db.is_contiguous() or snrs_db.ndim < 1 \
            or tuple(snrs_db.shape[1:]) != batch:
        raise ValueError(f"snrs_db must be a contiguous float32 [T, *{batch}] tensor, got "
                         f"{snrs_db.dtype} {tuple(snrs_db.shape)}")
    for name, t in (("last", last), ("cand", cand), ("counter", counter)):
        if t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != batch or not t.is_contiguous():
            raise ValueError(f"state.{name} must be a contiguous int32 tensor of shape {batch} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    n_mcs = int(n_mcs)
    if snr_th.device != dev or snr_th.dtype != torch.float32 or not snr_th.is_contiguous() \
            or not 1 <= n_mcs <= min(snr_th.numel(), MAX_RUNGS):
        raise ValueError(f"snr_th must be a contiguous float32 table of at least n_mcs = {n_mcs} "
                         f"entries (1..{MAX_RUNGS}) on {dev}, got {snr_th.dtype} [{snr_th.numel()}] on "
                         f"{snr_th.device}")
    T = snrs_db.shape[0]
    B = last.numel()
    if T == 0 or B == 0:  # no frame to walk: nothing to launch
        return (torch.stack([last, cand, counter]),
                torch.empty((T, *batch), dtype=torch.int32, device=dev))
    if mask is not None:
        if mask.device != dev:
            raise ValueError(f"the mask lies on {mask.device}, the SNRs on {dev}")
        mt, mb = _mask_strides(mask, T, batch)
    state = torch.empty((3, *batch), dtype=torch.int32, device=dev)
    mcs = torch.empty((T, *batch), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = build().feedback_scan_launch(
            snrs_db.data_ptr(), None if mask is None else mask.data_ptr(),
            0 if mask is None else mt, 0 if mask is None else mb, snr_th.data_ptr(), n_mcs,
            float(hysteresis), int(decision_th), last.data_ptr(), cand.data_ptr(),
            counter.data_ptr(), T, B, mcs.data_ptr(), state.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"feedback_scan_launch failed: CUDA error {rc}")
    feedback_scan_masked_cuda.LAUNCHES += 1
    return state, mcs


feedback_scan_masked_cuda.LAUNCHES = 0
