"""Channel estimation from the two Schmidl-Cox sync symbols (port of
gr_dtl_tpu/ops/chanest.py).

1. coarse *integer* carrier-offset search: differential correlation of
   the received sync spectra against the known sync words, all candidate
   shifts at once as one matmul against a precomputed table,
2. spectrum de-shift + per-symbol phase ramp for the whole frame,
3. LS channel taps from both sync words on their active carriers,
   projected onto the time-limited channel subspace.

Sign conventions: a residual time-domain CFO of +n0 subcarriers makes
the received spectrum appear at index c + n0; de-shifting reads
``y[k + n0]``.  Because OFDM symbol s's FFT window starts 80 s samples
into the frame, the same CFO adds a common phase
``exp(+2i pi n0 cp_len s / fft_len)`` to symbol s, removed by the ramp.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "ChanEst",
    "build_chanest",
    "chanest_from_reference",
    "estimate_carrier_offset",
    "apply_carrier_shift",
    "estimate_taps",
    "denoise_taps",
]


def _time_support_projection(active_idx: np.ndarray, fft_len: int,
                             support: int) -> np.ndarray:
    """LS projection onto frequency responses of channels whose impulse
    response lies in [0, support): P [n_active, n_active], denoised =
    P @ h_active."""
    c = active_idx.astype(np.float64) - fft_len // 2
    t = np.arange(support, dtype=np.float64)
    A = np.exp(-2j * np.pi * np.outer(c, t) / fft_len)
    return (A @ np.linalg.pinv(A)).astype(np.complex64)


def _shifted_const(y: np.ndarray, off: int) -> np.ndarray:
    """out[k] = y[k+off], zero outside."""
    n = y.shape[-1]
    out = np.zeros_like(y)
    lo, hi = max(0, -off), min(n, n - off)
    out[..., lo:hi] = y[..., lo + off : hi + off]
    return out


def _offset_table(w: np.ndarray, step: int, max_off: int) -> np.ndarray:
    """conj of the shifted differential references [n_off, fft]: row o is
    dw shifted by -(o - max_off), dw[k] = w[k] conj(w[k+step])."""
    dw = w * np.conj(np.roll(w, -step, axis=-1))
    return np.conj(np.stack([_shifted_const(dw, -o) for o in range(-max_off, max_off + 1)]))


@dataclasses.dataclass(frozen=True)
class ChanEst:
    """Channel-estimation constants (the reference's ``build_chanest``
    dict, plus the two carrier-offset tables it builds per call)."""

    w1: torch.Tensor  # [fft] complex64 sync word 1
    w2: torch.Tensor  # [fft] complex64 sync word 2
    active: torch.Tensor  # [fft] bool
    active_idx: torch.Tensor  # [n_active] int64
    proj: torch.Tensor  # [n_active, n_active] complex64
    W1: torch.Tensor  # [n_off, fft] complex64 offset table of word 1 (lag 2)
    W2: torch.Tensor  # [n_off, fft] complex64 offset table of word 2 (lag 1)
    max_off: int
    fft_len: int
    cp_len: int


def chanest_from_reference(d, device) -> ChanEst:
    """:class:`ChanEst` on ``device`` from a reference-layout dict (numpy
    ``w1``, ``w2``, ``active``, ``active_idx``, ``proj``; ints ``max_off``,
    ``fft_len``, ``cp_len``)."""
    w1 = np.asarray(d["w1"], np.complex64)
    w2 = np.asarray(d["w2"], np.complex64)
    max_off = int(d["max_off"])

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    return ChanEst(
        w1=t(w1), w2=t(w2), active=t(d["active"], bool),
        active_idx=t(d["active_idx"]).long(), proj=t(d["proj"], np.complex64),
        W1=t(_offset_table(w1, 2, max_off)), W2=t(_offset_table(w2, 1, max_off)),
        max_off=max_off, fft_len=int(d["fft_len"]), cp_len=int(d["cp_len"]))


def build_chanest(cfg, device, max_carr_offset: int = 6) -> ChanEst:
    half = cfg.fft_len // 2
    active = np.zeros(cfg.fft_len, dtype=bool)
    for c in list(cfg.occupied_carriers) + list(cfg.pilot_carriers):
        active[c + half] = True
    active_idx = np.nonzero(active)[0].astype(np.int32)
    return chanest_from_reference({
        "w1": cfg.sync_word1(),
        "w2": cfg.sync_word2(),
        "active": active,
        "active_idx": active_idx,
        "proj": _time_support_projection(active_idx, cfg.fft_len, 2 * cfg.cp_len + 1),
        "max_off": max_carr_offset,
        "fft_len": cfg.fft_len,
        "cp_len": cfg.cp_len,
    }, device)


def denoise_taps(taps: torch.Tensor, ce: ChanEst) -> torch.Tensor:
    """Project per-carrier taps [..., fft] onto the time-limited channel
    subspace; active carriers denoised, others untouched."""
    hd = torch.matmul(taps[..., ce.active_idx], ce.proj.T)
    out = taps.clone()
    out[..., ce.active_idx] = hd
    return out


def estimate_carrier_offset(y1: torch.Tensor, y2: torch.Tensor, ce: ChanEst) -> torch.Tensor:
    """Integer carrier offset n0 per frame.

    Differential correlation: carrier-pair products y[k] conj(y[k+s])
    cancel a timing offset's linear phase, leaving a sharp peak at the
    true integer offset.

    Args:
      y1, y2: [B, fft_len] received centered spectra of the sync symbols.
    Returns [B] int32: the spectrum is found at carrier c + n0.
    """
    def dy_of(y, step):
        return y * torch.conj(torch.roll(y, -step, dims=-1))

    scores = (torch.abs(dy_of(y1, 2) @ ce.W1.T)
              + torch.abs(dy_of(y2, 1) @ ce.W2.T))  # [B, n_off]
    # torch.argmax returns the first maximum, as jnp.argmax
    return (torch.argmax(scores, dim=-1) - ce.max_off).int()


def apply_carrier_shift(spectra: torch.Tensor, carr_offset: torch.Tensor,
                        ce: ChanEst, first_sym_index: int = 0) -> torch.Tensor:
    """Undo integer carrier offset on [B, n_sym, fft_len] spectra.

    De-shift by n0 carriers (out[l] = y[l + n0], zero where l + n0 falls
    outside the spectrum) and remove the per-symbol common phase.  The
    reference multiplies by one-hot shift matrices to avoid a TPU
    gather; here it is one index gather, which gives exactly the same
    values.  ``first_sym_index`` is the absolute index within the frame
    of ``spectra[:, 0]``.
    """
    B, n_sym, n = spectra.shape
    src = torch.arange(n, device=spectra.device)[None, :] + carr_offset.long()[:, None]  # [B, n]
    inside = (src >= 0) & (src < n)
    g = torch.gather(spectra, 2, src.clamp(0, n - 1)[:, None, :].expand(B, n_sym, n))
    shifted = torch.where(inside[:, None, :], g, 0)
    s = torch.arange(n_sym, dtype=torch.float32, device=spectra.device) + float(first_sym_index)
    ph = (-2.0 * math.pi * carr_offset[:, None].float()
          * ce.cp_len * s[None, :] / ce.fft_len)
    return shifted * torch.exp(1j * ph)[..., None]


def estimate_taps(y1c: torch.Tensor, y2c: torch.Tensor, ce: ChanEst,
                  denoise: bool = True) -> torch.Tensor:
    """LS channel taps [B, fft_len] complex64 from offset-corrected sync
    spectra; 1.0 on inactive carriers so later divisions stay benign."""
    w1_nz = torch.abs(ce.w1) > 0
    h2 = y2c / torch.where(torch.abs(ce.w2) > 0, ce.w2, 1.0)
    h1 = y1c / torch.where(w1_nz, ce.w1, 1.0)
    taps = torch.where(w1_nz[None, :], 0.5 * (h1 + h2), h2)
    taps = torch.where(ce.active[None, :], taps, 1.0)
    if denoise:
        taps = torch.where(ce.active[None, :], denoise_taps(taps, ce), 1.0)
    return taps.to(torch.complex64)
