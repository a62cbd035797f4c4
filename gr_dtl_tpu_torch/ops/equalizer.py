"""Pilot-aided decision-directed equalizer + per-frame SNR estimation
(port of gr_dtl_tpu/ops/equalizer.py).

The decision-directed update is sequential across OFDM symbols and
independent across carriers.  On CUDA tensors :func:`equalize_frame` is
one launch of the hand-written kernel of ``csrc/equalizer.cu``
(``ops/equalizer_cuda``), whatever the number of symbols.  Its plain
version, :func:`_equalize_frame_torch`, is a Python loop over the frame's
symbols with all carriers and the whole frame batch vectorized (masks
select pilot/data/idle carriers, ~90 small launches a symbol on a GPU); it
serves CPU tensors and is what the kernel is held against.

Semantics, as the reference's:
 - taps update ``H = alpha*H + (1-alpha) * Y/ref`` with ``ref`` the known
   pilot value on pilot carriers and the decided symbol on data carriers,
 - hard output = decided symbols (pilots replaced by their known values),
   soft output = pre-decision equalized symbols,
 - SNR from the full complex pilot error E|eqd - pilot|^2.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.ops import equalizer_cuda, ofdm

__all__ = ["Equalizer", "build_equalizer", "equalizer_from_reference",
           "equalize_frame", "EqualizerOut"]


class EqualizerOut(NamedTuple):
    hard: torch.Tensor  # [B, n_sym, fft_len] decided symbols (pilots = known values)
    soft: torch.Tensor  # [B, n_sym, fft_len] pre-decision equalized symbols
    taps: torch.Tensor  # [B, fft_len] final channel state
    snr_db: torch.Tensor  # [B] float32 SNR (dB) from pilots
    noise_var: torch.Tensor  # [B] float32 linear noise variance


@dataclasses.dataclass(frozen=True)
class Equalizer:
    """Pilot layout constants (the reference's ``build_equalizer`` dict).

    pilot_vals[s, k]: known pilot value for data-symbol s (0 = header).
    """

    occ_mask: torch.Tensor  # [fft] bool
    pilot_mask: torch.Tensor  # [fft] bool
    pilot_vals: torch.Tensor  # [n_data_syms, fft] complex64
    alpha: float
    header_syms: int
    n_pilots: int


def equalizer_from_reference(d, device) -> Equalizer:
    """:class:`Equalizer` on ``device`` from a reference-layout dict."""
    return Equalizer(
        occ_mask=torch.as_tensor(np.asarray(d["occ_mask"], bool), device=device),
        pilot_mask=torch.as_tensor(np.asarray(d["pilot_mask"], bool), device=device),
        pilot_vals=torch.as_tensor(np.asarray(d["pilot_vals"], np.complex64), device=device),
        alpha=float(d["alpha"]),
        header_syms=int(d["header_syms"]),
        n_pilots=int(np.sum(d["pilot_mask"])),
    )


def build_equalizer(cfg, device) -> Equalizer:
    """Pilot layout constants; the pilot values come from the allocator's
    pilot map, so TX pilots and the expected pilots cannot diverge."""
    half = cfg.fft_len // 2
    occ = np.zeros(cfg.fft_len, dtype=bool)
    occ[np.array(cfg.occupied_carriers) + half] = True
    pil = np.zeros(cfg.fft_len, dtype=bool)
    pil[np.array(cfg.pilot_carriers) + half] = True
    pilot_map = ofdm.build_allocator(cfg, "cpu").pilot_map.numpy()
    pilot_vals = np.where(pil[None, :], pilot_map[cfg.n_sync_symbols :], 0.0).astype(np.complex64)
    return equalizer_from_reference({
        "occ_mask": occ, "pilot_mask": pil, "pilot_vals": pilot_vals,
        "alpha": getattr(cfg, "eq_alpha", 0.1), "header_syms": cfg.header_symbols,
    }, device)


def equalize_frame(spectra: torch.Tensor, init_taps: torch.Tensor,
                   cnst_id: torch.Tensor, eq: Equalizer, sym_offset: int = 0) -> EqualizerOut:
    """Equalize the data symbols of a batch of frames.

    Args:
      spectra:   [B, n_sym, fft_len] offset-corrected spectra (header
                 symbol(s) first, then payload).
      init_taps: [B, fft_len] from chanest.
      cnst_id:   [B] payload constellation id; header symbols use BPSK.
      eq:        :class:`Equalizer`.
      sym_offset: absolute data-symbol index of spectra[:, 0] (0 = the
                 first header symbol); selects the pilot sets.
    """
    if spectra.device.type != "cuda":
        return _equalize_frame_torch(spectra, init_taps, cnst_id, eq, sym_offset)
    # a CUDA tensor takes the kernel or raises
    return EqualizerOut(*equalizer_cuda.equalize_frame_cuda(spectra, init_taps, cnst_id.int(), eq,
                                                            sym_offset))


def _equalize_frame_torch(spectra: torch.Tensor, init_taps: torch.Tensor,
                          cnst_id: torch.Tensor, eq: Equalizer, sym_offset: int = 0) -> EqualizerOut:
    """:func:`equalize_frame` in plain PyTorch, on any device."""
    B, n_sym, fft_len = spectra.shape
    pil = eq.pilot_mask
    alpha = eq.alpha
    pvs = eq.pilot_vals[sym_offset : sym_offset + n_sym]  # [n_sym, fft]
    abs_idx = torch.arange(n_sym, device=spectra.device) + sym_offset
    sym_cnst = torch.where((abs_idx < eq.header_syms)[None, :],
                           int(cn.ConstellationType.BPSK),
                           cnst_id[:, None].int())  # [B, n_sym]
    tot = n_sym * eq.n_pilots
    # known pilot power per symbol, summed over the frame (batch-independent)
    sig_pw = torch.clamp(
        torch.where(pil[None, :], torch.abs(pvs) ** 2, 0.0).sum(-1).sum() / tot, min=1e-12)

    # The reference freezes the taps from alpha >= 0.9995 on, though the
    # shortcut is exact only at alpha == 1; the port keeps that threshold.
    if float(alpha) >= equalizer_cuda.FROZEN_ALPHA:
        pv = pvs[None]
        eqd = spectra / init_taps[:, None, :]
        _, dec = cn.nearest_point(eqd, sym_cnst[:, :, None])
        hard = torch.where(pil[None, None, :], pv, dec)
        err = torch.where(pil[None, None, :], eqd - pv, 0.0)
        noise_var = torch.clamp((torch.abs(err) ** 2).sum(dim=(1, 2)) / tot, min=1e-12)
        snr_db = 10.0 * torch.log10(sig_pw / noise_var)
        return EqualizerOut(hard=hard, soft=eqd, taps=init_taps,
                            snr_db=snr_db.float(), noise_var=noise_var.float())

    upd = (eq.occ_mask | pil)[None, :]
    H = init_taps
    hard, soft, p_e2 = [], [], []
    for s in range(n_sym):
        Y = spectra[:, s]
        pv = pvs[s][None, :]
        eqd = Y / H
        _, dec = cn.nearest_point(eqd, sym_cnst[:, s, None])
        ref = torch.where(pil[None, :], pv, dec)
        ref_safe = torch.where(torch.abs(ref) > 0, ref, 1.0)
        H = torch.where(upd, alpha * H + (1.0 - alpha) * Y / ref_safe, H)
        hard.append(ref)  # decisions, pilots replaced by their known values
        soft.append(eqd)
        err = torch.where(pil[None, :], eqd - pv, 0.0)
        p_e2.append((torch.abs(err) ** 2).sum(-1))

    noise_var = torch.clamp(torch.stack(p_e2).sum(0) / tot, min=1e-12)
    snr_db = 10.0 * torch.log10(sig_pw / noise_var)
    return EqualizerOut(hard=torch.stack(hard, 1), soft=torch.stack(soft, 1), taps=H,
                        snr_db=snr_db.float(), noise_var=noise_var.float())
