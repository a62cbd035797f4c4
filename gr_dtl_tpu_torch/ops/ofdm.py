"""OFDM modulation core: DFT, carrier allocation, cyclic prefix (port of
gr_dtl_tpu/ops/ofdm.py).

The whole frame batch is one tensor ``[B, n_sym, fft_len]`` and the
size-64 (I)DFT is a complex matmul against a precomputed, centred,
unitary twiddle matrix (``torch.matmul``, full float32).

Conventions: frequency-domain vectors are *centered* (carrier c lives
at index c + fft_len/2); transforms are unitary (norm="ortho").
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

__all__ = [
    "dft_matrix",
    "ofdm_modulate",
    "ofdm_demodulate",
    "Allocator",
    "build_allocator",
    "allocator_from_reference",
    "allocate_carriers",
    "extract_carriers",
    "add_cyclic_prefix",
    "remove_cyclic_prefix",
]


@functools.lru_cache(maxsize=None)
def dft_matrix(n: int, inverse: bool) -> np.ndarray:
    """Unitary (I)DFT matrix with fftshift folded in: ``time = x @
    dft_matrix(n, True)`` takes a centered spectrum to time samples and
    ``freq = y @ dft_matrix(n, False)`` returns a centered spectrum."""
    k = np.arange(n)
    kc = k - n // 2
    if inverse:
        m = np.exp(2j * np.pi * np.outer(kc, k) / n) / np.sqrt(n)
    else:
        m = np.exp(-2j * np.pi * np.outer(k, kc) / n) / np.sqrt(n)
    return m.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _dft_tensor(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(dft_matrix(n, inverse), device=device)


def ofdm_modulate(freq: torch.Tensor) -> torch.Tensor:
    """[..., fft_len] centered spectrum -> [..., fft_len] time samples."""
    return torch.matmul(freq, _dft_tensor(freq.shape[-1], True, freq.device))


def ofdm_demodulate(time: torch.Tensor) -> torch.Tensor:
    """[..., fft_len] time samples -> [..., fft_len] centered spectrum."""
    return torch.matmul(time, _dft_tensor(time.shape[-1], False, time.device))


@dataclasses.dataclass(frozen=True)
class Allocator:
    """Allocation constants (the reference's ``build_allocator`` dict).

    occ_idx   [n_data] int64 — centered FFT index of each data slot.
    pilot_idx [n_pilot] int64.
    pilot_map [n_total_syms, fft_len] complex64 — sync words in rows 0..1,
              then the scrambled pilot sets of header + payload symbols.
    """

    occ_idx: torch.Tensor
    pilot_idx: torch.Tensor
    pilot_map: torch.Tensor
    n_data_syms: int


def _allocator_arrays(cfg):
    fft_len = cfg.fft_len
    half = fft_len // 2
    occ = np.array(cfg.occupied_carriers, dtype=np.int32) + half
    pil = np.array(cfg.pilot_carriers, dtype=np.int32) + half
    n_sym = cfg.frame_ofdm_symbols
    n_data_syms = cfg.header_symbols + cfg.frame_length

    pilot_map = np.zeros((n_sym, fft_len), dtype=np.complex64)
    pilot_map[0] = cfg.sync_word1()
    pilot_map[1] = cfg.sync_word2()
    seq = np.array(cfg.pilot_sym_scramble_seq, dtype=np.float32)
    for s in range(n_data_syms):
        x = seq[s % len(seq)]
        pilot_map[cfg.n_sync_symbols + s, pil] = np.array([x, x, x, -x], dtype=np.complex64)
    return {"occ_idx": occ, "pilot_idx": pil, "pilot_map": pilot_map,
            "n_data_syms": n_data_syms}


def allocator_from_reference(d, device) -> Allocator:
    """An :class:`Allocator` on ``device`` from a reference-layout dict of
    numpy arrays (``occ_idx``, ``pilot_idx``, ``pilot_map``, ``n_data_syms``)."""
    return Allocator(
        occ_idx=torch.as_tensor(np.asarray(d["occ_idx"]), device=device).long(),
        pilot_idx=torch.as_tensor(np.asarray(d["pilot_idx"]), device=device).long(),
        pilot_map=torch.as_tensor(np.asarray(d["pilot_map"], np.complex64), device=device),
        n_data_syms=int(d["n_data_syms"]),
    )


def build_allocator(cfg, device) -> Allocator:
    """Allocation constants for a config, on ``device``."""
    return allocator_from_reference(_allocator_arrays(cfg), device)


def allocate_carriers(data_syms: torch.Tensor, alloc: Allocator) -> torch.Tensor:
    """Place header+payload symbols and pilots/sync into the frame grid.

    Args:
      data_syms: [B, n_data_syms, n_data_carriers] complex symbols.
    Returns [B, n_total_syms, fft_len] centered spectra.
    """
    B = data_syms.shape[0]
    n_sym, fft_len = alloc.pilot_map.shape
    grid = alloc.pilot_map.expand(B, n_sym, fft_len).clone()
    n_sync = n_sym - data_syms.shape[1]
    grid[:, n_sync:, alloc.occ_idx] = data_syms
    return grid


def extract_carriers(spectra: torch.Tensor, alloc: Allocator) -> torch.Tensor:
    """Inverse of :func:`allocate_carriers`: the occupied carriers' values
    of the data symbols, [B, n_data_syms, fft_len] (sync symbols removed)
    -> [B, n_data_syms, n_data_carriers]."""
    return spectra[:, :, alloc.occ_idx]


def remove_cyclic_prefix(samples: torch.Tensor, fft_len: int, cp_len: int) -> torch.Tensor:
    """[..., n_sym, cp+fft] -> [..., n_sym, fft_len]: the prefix dropped."""
    return samples[..., cp_len:]


def add_cyclic_prefix(time_syms: torch.Tensor, cp_len: int) -> torch.Tensor:
    """[..., n_sym, fft_len] -> [..., n_sym, cp+fft] (rolloff 0)."""
    return torch.cat([time_syms[..., -cp_len:], time_syms], dim=-1)
