"""The decision-directed equalizer recurrence on the GPU: the CUDA kernel of
``csrc/equalizer.cu`` and its wrapper.

``equalize_frame_cuda`` stands for the ``lax.scan`` (and the frozen-taps
branch) of ``gr_dtl_tpu/ops/equalizer.py::equalize_frame``; its plain
PyTorch version is ``ops/equalizer.py::_equalize_frame_torch``.  The
library is built at first use (``ops/_cuda_build``); importing this module
needs neither ``nvcc`` nor a GPU.  The wrapper launches on PyTorch's
current stream, never synchronises, reads nothing back, and counts its
launches (one a call) in ``equalize_frame_cuda.LAUNCHES``.

Decisions feed back into the taps, so one decision that falls on the other
side of a boundary changes that carrier for the rest of the frame:
:func:`compare_with_plain` holds the kernel's outputs against the plain
version's row by row and tells a row that parted on a boundary case from a
fault.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from gr_dtl_tpu_torch.ops import _cuda_build
from gr_dtl_tpu_torch.ops import constellation as cn

__all__ = ["build", "library_path", "equalize_frame_cuda", "equalizer_bytes",
           "compare_with_plain", "MAX_FFT_LEN", "FROZEN_ALPHA"]

SOURCE = _cuda_build.PKG / "csrc" / "equalizer.cu"
NVCC_FLAGS = _cuda_build.NVCC_FLAGS
MAX_FFT_LEN = 256  # kMaxFftLen of the source: a thread a carrier, a row in one block
FROZEN_ALPHA = 0.9995  # from here on the reference freezes the taps


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    return _cuda_build.library_path(SOURCE, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = _cuda_build.load(SOURCE, NVCC_FLAGS)
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.equalizer_launch.argtypes = [p, ll, ll, p, p, p, p, p, i, i, i, i, f, f, i, f,
                                     p, p, p, p, p, p]
    lib.equalizer_launch.restype = i
    return lib


def equalizer_bytes(B: int, n_sym: int, fft_len: int) -> int:
    """Bytes one call must move: the spectra and the initial taps read once,
    hard, soft and the final taps written once (complex64), and a row's
    constellation id, SNR and noise variance (4 bytes each)."""
    row = 8 * fft_len
    return B * (3 * n_sym * row + 2 * row + 12)


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"equalize_frame_cuda needs CUDA tensors, got {name} on {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"equalize_frame_cuda needs {name} as a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} with strides "
                         f"{t.stride()}")


def equalize_frame_cuda(spectra: torch.Tensor, init_taps: torch.Tensor, cnst_id: torch.Tensor,
                        eq, sym_offset: int = 0):
    """All symbols of a batch of frames through the equalizer in one launch.

    Args:
      spectra:   [B, n_sym, fft_len] complex64 CUDA tensor, unit stride along
                 the carriers; the frame and symbol strides are free (a slice
                 of the frame's symbols is taken as it is).
      init_taps: [B, fft_len] complex64, contiguous.
      cnst_id:   [B] int32 payload constellation ids.
      eq:        ``ops/equalizer.Equalizer`` with its tensors on the same device.
      sym_offset: absolute data-symbol index of ``spectra[:, 0]``.
    Returns (hard, soft [B, n_sym, fft_len] complex64, taps [B, fft_len]
    complex64, snr_db, noise_var [B] float32); with ``eq.alpha`` >=
    :data:`FROZEN_ALPHA` the taps are ``init_taps`` itself.
    """
    if spectra.ndim != 3 or spectra.dtype != torch.complex64:
        raise ValueError("equalize_frame_cuda needs spectra as a complex64 tensor [B, n_sym, "
                         f"fft_len], got {spectra.dtype} {tuple(spectra.shape)}")
    B, n_sym, fft_len = spectra.shape
    if fft_len % 32 or not 32 <= fft_len <= MAX_FFT_LEN:
        raise ValueError(f"equalize_frame_cuda takes an fft_len that is a multiple of 32 up to "
                         f"{MAX_FFT_LEN} (a thread a carrier, a frame row inside one block of at "
                         f"most {MAX_FFT_LEN} threads), got {fft_len}")
    if B < 1 or n_sym < 1:
        raise ValueError(f"equalize_frame_cuda needs at least one frame and one symbol, got "
                         f"{tuple(spectra.shape)}")
    if spectra.stride(2) != 1:
        raise ValueError("equalize_frame_cuda needs spectra with unit stride along the carriers, "
                         f"got strides {spectra.stride()}")
    if spectra.device.type != "cuda":
        raise ValueError(f"equalize_frame_cuda needs CUDA tensors, got spectra on {spectra.device}")
    if eq.n_pilots < 1:
        raise ValueError("equalize_frame_cuda needs at least one pilot carrier")
    n_rows = eq.pilot_vals.shape[0]
    if not 0 <= sym_offset <= n_rows - n_sym:
        raise ValueError(f"symbols {sym_offset}..{sym_offset + n_sym - 1} lie outside the "
                         f"{n_rows} rows of pilot values")
    _check("init_taps", init_taps, torch.complex64, (B, fft_len))
    _check("cnst_id", cnst_id, torch.int32, (B,))
    _check("eq.occ_mask", eq.occ_mask, torch.bool, (fft_len,))
    _check("eq.pilot_mask", eq.pilot_mask, torch.bool, (fft_len,))
    _check("eq.pilot_vals", eq.pilot_vals, torch.complex64, (n_rows, fft_len))

    dev = spectra.device
    frozen = float(eq.alpha) >= FROZEN_ALPHA
    hard = torch.empty((B, n_sym, fft_len), dtype=torch.complex64, device=dev)
    soft = torch.empty((B, n_sym, fft_len), dtype=torch.complex64, device=dev)
    taps = init_taps if frozen else torch.empty((B, fft_len), dtype=torch.complex64, device=dev)
    snr_db = torch.empty(B, dtype=torch.float32, device=dev)
    noise_var = torch.empty(B, dtype=torch.float32, device=dev)
    # scalars as PyTorch hands them to its kernels: a Python float rounded
    # to float32, 1 - alpha taken in double first, a division by a Python
    # int as a product with the float32 reciprocal
    alpha = float(eq.alpha)
    inv_tot = np.float32(1.0) / np.float32(n_sym * eq.n_pilots)
    n_hdr = min(max(int(eq.header_syms) - sym_offset, 0), n_sym)
    with torch.cuda.device(dev):
        rc = build().equalizer_launch(
            spectra.data_ptr(), spectra.stride(0), spectra.stride(1), init_taps.data_ptr(),
            cnst_id.data_ptr(), eq.occ_mask.data_ptr(), eq.pilot_mask.data_ptr(),
            eq.pilot_vals[sym_offset:].data_ptr(), B, n_sym, fft_len, n_hdr,
            float(np.float32(alpha)), float(np.float32(1.0 - alpha)), int(frozen), float(inv_tot),
            hard.data_ptr(), soft.data_ptr(), taps.data_ptr(), snr_db.data_ptr(),
            noise_var.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"equalizer_launch failed: CUDA error {rc}")
    equalize_frame_cuda.LAUNCHES += 1
    return hard, soft, taps, snr_db, noise_var


equalize_frame_cuda.LAUNCHES = 0


def _abs_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| elementwise (complex: the larger of the two parts'), 0 where
    both hold the same value, infinity or NaN, inf where only one is NaN."""
    if a.is_complex():
        return _abs_diff(torch.view_as_real(a), torch.view_as_real(b)).amax(dim=-1)
    same = (a == b) | (a.isnan() & b.isnan())
    return torch.where(same, 0.0, (a - b).abs().nan_to_num(nan=float("inf")))


def compare_with_plain(got, want, cnst_id: torch.Tensor, eq, sym_offset: int = 0,
                       atol: float = 1e-5, eps: float = 1e-5) -> dict:
    """Hold one ``EqualizerOut`` (``got``, the kernel's) against another
    (``want``, the plain version's) on the same inputs, row by row.

    A row is *clean* when every decision is equal (a NaN equals a NaN: a
    frame slot of idle air has zero taps in both), soft symbols and taps
    agree within ``atol``, the noise variance within rtol 1e-4 and the SNR
    within 1e-3 dB.  Any other row is looked at where it first parts: it is
    a *boundary* row when, at the first symbol with an unequal decision, the
    soft symbols still agree within ``atol`` and every carrier decided
    differently has its plain soft symbol within ``eps`` of a decision
    boundary of that symbol's constellation
    (:func:`constellation.near_decision_boundary`); from there on its taps
    may differ.  Every other row is a *fault*.

    Returns counts ``rows``, ``boundary_rows``, ``fault_rows`` and
    ``max_abs_err`` (soft, hard and taps, over the clean rows), as Python
    numbers: this reads the device.
    """
    B, n_sym, _ = want.soft.shape
    abs_idx = torch.arange(n_sym, device=want.soft.device) + sym_offset
    sym_cnst = torch.where((abs_idx < eq.header_syms)[None, :], int(cn.ConstellationType.BPSK),
                           cnst_id[:, None].int())  # [B, n_sym]
    d_hard_abs, d_soft = _abs_diff(got.hard, want.hard), _abs_diff(got.soft, want.soft)
    d_hard = d_hard_abs != 0  # [B, n_sym, fft]
    err = torch.maximum(torch.maximum(d_soft.amax(dim=(1, 2)), d_hard_abs.amax(dim=(1, 2))),
                        _abs_diff(got.taps, want.taps).amax(dim=1))
    stats_ok = ((_abs_diff(got.noise_var, want.noise_var) <= 1e-4 * want.noise_var.abs().nan_to_num())
                & (_abs_diff(got.snr_db, want.snr_db) <= 1e-3))
    clean = ~d_hard.any(dim=(1, 2)) & (err <= atol) & stats_ok
    # the first symbol at which a decision differs (n_sym: none does)
    sym_differs = d_hard.any(dim=2)
    first = torch.where(sym_differs.any(dim=1), sym_differs.int().argmax(dim=1), n_sym)
    pick = torch.clamp(first, max=n_sym - 1)
    rows = torch.arange(B, device=want.soft.device)
    near = cn.near_decision_boundary(want.soft[rows, pick], sym_cnst[rows, pick][:, None], eps)
    flipped = d_hard[rows, pick]
    before = torch.arange(n_sym, device=want.soft.device)[None, :] <= first[:, None]
    soft_ok = (torch.where(before[:, :, None], d_soft, 0.0).amax(dim=(1, 2)) <= atol)
    boundary = ~clean & (first < n_sym) & soft_ok & (near | ~flipped).all(dim=1)
    fault = ~clean & ~boundary
    max_err = float(torch.where(clean, err, 0.0).max()) if B else 0.0
    return {"rows": B, "boundary_rows": int(boundary.sum()), "fault_rows": int(fault.sum()),
            "max_abs_err": max_err}
