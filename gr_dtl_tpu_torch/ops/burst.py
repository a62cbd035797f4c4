"""Narrowband feedback burst modem: BPSK burst TX + data-aided burst RX
(port of gr_dtl_tpu/ops/burst.py).

Protocol:

    burst = [64-bit access code | constellation byte | FEC byte | CRC8]

88 bits, MSB-first per byte, BPSK, 2 samples/symbol, root-raised-cosine
pulse (excess bandwidth 0.35).  Access code = GNU Radio's default
(0xAC DD A4 E2 F2 8C 20 FC); CRC8 poly 0x07 init 0xFF.

The receiver is one-shot and data-aided, fully vectorised over a batch of
captures:

 1. matched filter (RRC) over the capture,
 2. cross-correlation against the known shaped preamble -> peak index
    (timing), complex peak (amplitude + phase), and the phase *slope*
    between the two preamble halves -> CFO,
 3. fractional timing by quadratic interpolation of the correlation
    magnitude around the peak,
 4. de-rotate, sample at symbol strobes, BPSK-decide,
 5. access-code match at the nominal alignment + CRC8 gate.

Convolutions are ``F.conv1d`` with the kernel flipped (``conv1d`` is a
correlation, the reference's ``jnp.convolve`` a true convolution); a
complex one is three real ones combined as the reference's lowering
combines them (:func:`_convolve_full`).  Nothing here waits for the
device: no ``.item()``, no index by a 0-dim tensor.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from gr_dtl_tpu_torch.ops import gf2

__all__ = ["ACCESS_CODE_BITS", "N_BURST_BITS", "rrc_taps", "make_burst_tables", "BurstModem",
           "build_burst_modem", "burst_modem_from_reference", "burst_tx", "burst_rx",
           "BurstRxOut", "burst_wave_len", "build_stream_burst_rx"]

# GNU Radio default access code, 64 bits MSB-first
_ACCESS_BYTES = bytes([0xAC, 0xDD, 0xA4, 0xE2, 0xF2, 0x8C, 0x20, 0xFC])
ACCESS_CODE_BITS = np.array(
    [(b >> (7 - i)) & 1 for b in _ACCESS_BYTES for i in range(8)], dtype=np.int32
)
N_BURST_BITS = 64 + 24  # access + cnst + fec + crc8


def rrc_taps(sps: int, eb: float, ntaps: int, gain: float = 1.0) -> np.ndarray:
    """Root-raised-cosine FIR (same parametrization as
    filter.firdes.root_raised_cosine with nfilts folded out)."""
    t = (np.arange(ntaps) - (ntaps - 1) / 2.0) / sps  # in symbols
    a = eb
    h = np.zeros_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 - a + 4 * a / np.pi
        elif a > 0 and abs(abs(ti) - 1 / (4 * a)) < 1e-9:
            h[i] = (a / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * a))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * a))
            )
        else:
            h[i] = (
                np.sin(np.pi * ti * (1 - a)) + 4 * a * ti * np.cos(np.pi * ti * (1 + a))
            ) / (np.pi * ti * (1 - (4 * a * ti) ** 2))
    h = h / np.sqrt(np.sum(h**2)) * gain
    return h.astype(np.float32)


class BurstRxOut(NamedTuple):
    cnst_id: torch.Tensor  # [B] int32
    fec_id: torch.Tensor  # [B] int32
    ok: torch.Tensor  # [B] bool (access code found + CRC8 good)
    peak_pos: torch.Tensor  # [B] int32 detected burst start (diagnostic)
    cfo: torch.Tensor  # [B] float32 rad/sample (diagnostic)


def make_burst_tables(sps: int = 2, eb: float = 0.35, ntaps_syms: int = 11) -> dict:
    """Pulse shape, shaped preamble waveform and CRC8 tables as numpy: the
    reference's ``build_burst_modem`` dict."""
    ntaps = ntaps_syms * sps + 1
    taps = rrc_taps(sps, eb, ntaps)
    # shaped preamble: BPSK access code upsampled and RRC filtered
    # BPSK map matches ops/constellation: bit 0 -> -1, bit 1 -> +1
    sym = 2.0 * ACCESS_CODE_BITS.astype(np.float32) - 1.0
    up = np.zeros(64 * sps, np.float32)
    up[::sps] = sym
    pre = np.convolve(up, taps)  # [64*sps + ntaps - 1]
    return {
        "sps": sps,
        "taps": taps,
        "ntaps": ntaps,
        "preamble_wave": pre.astype(np.complex64),
        "crc_tables": gf2.make_crc_tables(gf2.CRC8_FEEDBACK, 2),
    }


@dataclasses.dataclass(frozen=True)
class BurstModem:
    """The burst modem's constants on a device."""

    sps: int
    ntaps: int
    taps: torch.Tensor  # [ntaps] float32 RRC pulse
    preamble_wave: torch.Tensor  # [64*sps + ntaps - 1] complex64 shaped access code
    crc_tables: gf2.CrcTables
    access_bits: torch.Tensor  # [64] int32


def burst_modem_from_reference(d, device) -> BurstModem:
    """:class:`BurstModem` on ``device`` from a ``build_burst_modem`` dict
    (the reference's, or :func:`make_burst_tables`'), leaves as numpy."""
    return BurstModem(
        sps=int(d["sps"]), ntaps=int(d["ntaps"]),
        taps=torch.as_tensor(np.asarray(d["taps"], np.float32), device=device),
        preamble_wave=torch.as_tensor(np.asarray(d["preamble_wave"], np.complex64), device=device),
        crc_tables=gf2.crc_tables_from_reference(d["crc_tables"], device),
        access_bits=torch.as_tensor(ACCESS_CODE_BITS, device=device))


def build_burst_modem(device, sps: int = 2, eb: float = 0.35, ntaps_syms: int = 11) -> BurstModem:
    """Precompute pulse shapes and the shaped preamble waveform, on ``device``."""
    return burst_modem_from_reference(make_burst_tables(sps, eb, ntaps_syms), device)


def _conv_real(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Full convolution of real rows [B, N] with real kernels [C, K] ->
    [B, C, N + K - 1]."""
    K = k.shape[-1]
    return F.conv1d(F.pad(x, (K - 1, K - 1))[:, None, :], k.flip(-1)[:, None, :])


def _convolve_full(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``jnp.convolve(x, k, mode="full")`` of every row of ``x`` [B, N]
    with ``k`` [K]: real with real, or complex with complex.  The complex
    product is three real convolutions, combined as the reference's
    lowering combines them: k1 = (xr + xi) * kr, k2 = xr * (ki - kr),
    k3 = xi * (kr + ki); re = k1 - k3, im = k1 + k2."""
    if not x.is_complex():
        return _conv_real(x, k[None, :])[:, 0]
    k = k.to(torch.complex64)
    xr, xi, kr, ki = x.real, x.imag, k.real, k.imag
    k1 = _conv_real(xr + xi, kr[None, :])[:, 0]
    k2 = _conv_real(xr, (ki - kr)[None, :])[:, 0]
    k3 = _conv_real(xi, (kr + ki)[None, :])[:, 0]
    return torch.complex(k1 - k3, k1 + k2)


def _byte_bits(v: torch.Tensor) -> torch.Tensor:
    """[B] -> [B, 8] bits, MSB first."""
    shifts = torch.arange(7, -1, -1, device=v.device)
    return ((v[:, None].int() >> shifts) & 1).int()


def _burst_bits(cnst_id: torch.Tensor, fec_id: torch.Tensor, modem: BurstModem) -> torch.Tensor:
    """[B] -> [B, 88] bits: access | cnst | fec | crc8 (MSB-first)."""
    B = cnst_id.shape[0]
    dev = cnst_id.device
    msg = torch.stack([cnst_id, fec_id], dim=1).to(torch.uint8)  # [B, 2]
    crc = gf2.crc_device(msg, torch.full((B,), 2, dtype=torch.int32, device=dev), modem.crc_tables)
    return torch.cat([modem.access_bits[None].expand(B, 64), _byte_bits(cnst_id),
                      _byte_bits(fec_id), _byte_bits(crc)], dim=1)


def burst_tx(cnst_id: torch.Tensor, fec_id: torch.Tensor, modem: BurstModem,
             pad: int = 32) -> torch.Tensor:
    """Modulate feedback bursts.

    Returns [B, pad + 88*sps + ntaps - 1 + pad] complex64 waveforms.
    """
    sps = modem.sps
    bits = _burst_bits(cnst_id, fec_id, modem)  # [B, 88]
    sym = (2.0 * bits - 1.0).float()
    B = sym.shape[0]
    up = torch.zeros((B, N_BURST_BITS * sps), dtype=torch.float32, device=sym.device)
    up[:, ::sps] = sym
    wave = _convolve_full(up, modem.taps).to(torch.complex64)
    return F.pad(wave, (pad, pad))


def burst_wave_len(modem: BurstModem) -> int:
    """Length of one shaped burst waveform (no padding)."""
    return N_BURST_BITS * modem.sps + modem.ntaps - 1


def build_stream_burst_rx(modem: BurstModem, block: int, max_bursts: int = 4,
                          threshold: float = 0.5):
    """Continuous-capture burst scanner: 0..max_bursts per block.

    The scan is one batch of tensor ops per block:

    1. normalized preamble cross-correlation over [tail | block],
    2. non-max suppression (a start wins if it is the correlation max
       within a burst-length window) + threshold -> candidate starts,
    3. ownership: only starts inside the first ``block`` coordinates
       are emitted now (later ones reappear at the front of the next
       block's extended window, the tail discipline of the OFDM
       StreamRx), so every burst is demodulated exactly once,
    4. the ``max_bursts`` strongest candidates -> windows sliced out and
       demodulated by the one-shot estimator (:func:`burst_rx`) in one
       batch.

    Returns ``(step, tail_len)`` where ``step(ext) -> BurstRxOut`` with
    [max_bursts] leading dims and ``ext = concat(tail, chunk)``,
    ``tail = previous chunk's last tail_len samples``.  Slots beyond the
    number of detected bursts have ``ok=False``; their ``peak_pos`` are
    the lowest positions 0, 1, 2, .. as the reference's ``top_k`` returns
    them among equal scores (a stable descending sort here: ``torch.topk``
    promises no order among ties).
    """
    Lb = burst_wave_len(modem)
    pre = modem.preamble_wave
    Lp = pre.shape[0]
    tail_len = Lb  # any burst starting in the owned region completes
    win = Lb + 8  # demod window per candidate
    pre_conj_rev = torch.conj(pre.flip(0)).resolve_conj()
    e_pre = (pre.abs() ** 2).sum()
    # the reference's "SAME" window of Lb (even: one more on the right)
    pad_lo = (Lb - 1) // 2
    pad_hi = Lb - 1 - pad_lo

    def step(ext: torch.Tensor) -> BurstRxOut:
        T = ext.shape[-1]  # tail_len + block
        dev = ext.device
        corr = _convolve_full(ext[None, :], pre_conj_rev)[0]
        # correlation aligned so index s = burst start in ext coords
        c = corr[Lp - 1: Lp - 1 + T]
        # normalized by local energy under the preamble: moving sum
        p2 = ext.abs() ** 2
        cs = torch.cat([torch.zeros(1, device=dev), torch.cumsum(p2, 0)])
        ar = torch.arange(T, device=dev)
        e_loc = cs[torch.clamp(ar + Lp, max=T)] - cs[:T]
        mag = c.abs()
        norm = mag / torch.sqrt(torch.clamp(e_loc * e_pre, min=1e-12))
        # non-max suppression over a burst-length window
        wmax = F.max_pool1d(F.pad(mag[None, None, :], (pad_lo, pad_hi), value=-torch.inf),
                            Lb, stride=1)[0, 0]
        owned = ar < block  # ownership region (see docstring)
        cand = (norm > threshold) & (mag >= wmax) & owned
        score = torch.where(cand, mag, -1.0)
        top, starts = torch.sort(score, descending=True, stable=True)
        top, starts = top[:max_bursts], starts[:max_bursts]
        found = top > 0
        s = torch.clamp(starts, 0, T - win)
        wins = ext[s[:, None] + torch.arange(win, device=dev)[None, :]]  # [K, win]
        out = burst_rx(wins, modem)
        return BurstRxOut(cnst_id=out.cnst_id, fec_id=out.fec_id, ok=out.ok & found,
                          peak_pos=starts.int(), cfo=out.cfo)

    return step, tail_len


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for [B, M] x and [B] idx."""
    return torch.gather(x, 1, idx.long()[:, None])[:, 0]


def burst_rx(samples: torch.Tensor, modem: BurstModem) -> BurstRxOut:
    """Demodulate feedback bursts from [B, N] captures (one burst each)."""
    sps = modem.sps
    pre = modem.preamble_wave
    B, N = samples.shape
    dev = samples.device
    samples = samples.to(torch.complex64)
    Lp = pre.shape[0]

    # 1. matched filter
    mf = _convolve_full(samples, modem.taps)  # [B, N + ntaps - 1]

    # 2. preamble cross-correlation (on the raw samples: the preamble
    # template is already TX-shaped; correlating raw keeps one RRC)
    corr = _convolve_full(samples, torch.conj(pre.flip(0)).resolve_conj())
    # burst start s corresponds to correlation index s + len(pre) - 1
    mag = corr.abs()
    peak = torch.argmax(mag, dim=1)  # [B]
    pk = _take(corr, peak)
    energy = (pre.abs() ** 2).sum()
    amp = pk.abs() / energy
    phase = torch.angle(pk)

    # CFO from the phase difference of half-preamble correlations
    half = Lp // 2
    c1 = _convolve_full(samples, torch.conj(pre[:half].flip(0)).resolve_conj())
    c2 = _convolve_full(samples, torch.conj(pre[half:].flip(0)).resolve_conj())
    # align: halves peak "half" samples apart; sample both at the full peak
    i1 = torch.clamp(peak - (Lp - half), 0, c1.shape[1] - 1)
    p1 = _take(c1, i1)
    # c2 is shorter than corr: a peak past its end (a burst cut off by the
    # capture's end) reads NaN, as the reference's take_along_axis fills it,
    # and the capture then decodes to nothing
    in_c2 = peak < c2.shape[1]
    p2 = torch.where(in_c2, _take(c2, torch.clamp(peak, max=c2.shape[1] - 1)), torch.nan)
    cfo = torch.angle(p2 * torch.conj(p1)) / half  # rad/sample

    # 3. symbol strobes: the first symbol's centre in mf sits at
    # s + (ntaps - 1), s = burst start in `samples`
    start = peak - (Lp - 1)
    # fractional timing: quadratic fit of |corr| around the peak
    pm1 = _take(mag, torch.clamp(peak - 1, 0, N + Lp - 2))
    pp1 = _take(mag, torch.clamp(peak + 1, 0, N + Lp - 2))
    p0 = pk.abs()
    denom = pm1 - 2 * p0 + pp1
    frac = torch.where(denom.abs() > 1e-9, 0.5 * (pm1 - pp1) / denom, 0.0)
    frac = torch.clamp(frac, -0.5, 0.5)

    ntaps = modem.ntaps
    k = torch.arange(N_BURST_BITS, dtype=torch.int32, device=dev)[None, :]
    strobe_f = (start[:, None] + frac[:, None]) + (ntaps - 1) + (k * sps).float()
    s0 = torch.clamp(torch.floor(strobe_f).int(), 0, mf.shape[1] - 2)
    sf = strobe_f - s0.float()
    n = torch.arange(mf.shape[1], dtype=torch.float32, device=dev)
    ang = phase[:, None] + cfo[:, None] * (n[None, :] - peak[:, None].float())
    derot = mf * torch.polar(torch.ones_like(ang), -ang)
    y0 = torch.gather(derot, 1, s0.long())
    y1 = torch.gather(derot, 1, (s0 + 1).long())
    y = y0 * (1 - sf) + y1 * sf  # [B, 88] linear interp at the strobe
    y = y / torch.clamp(amp[:, None], min=1e-9)

    bits = (y.real > 0).int()

    # 4. access-code check at the nominal alignment + CRC8
    nwrong = (bits[:, :64] != modem.access_bits[None, :]).sum(1)
    ac_ok = nwrong <= 0  # threshold 0, like the reference default

    weights = (1 << torch.arange(7, -1, -1, device=dev)).int()

    def byte_of(b):
        return (b * weights).sum(1)

    cnst = byte_of(bits[:, 64:72])
    fec = byte_of(bits[:, 72:80])
    crc_rx = byte_of(bits[:, 80:88])
    msg = torch.stack([cnst, fec], dim=1).to(torch.uint8)
    crc_want = gf2.crc_device(msg, torch.full((B,), 2, dtype=torch.int32, device=dev),
                              modem.crc_tables)
    ok = ac_ok & (crc_rx == crc_want)
    return BurstRxOut(cnst_id=cnst.int(), fec_id=fec.int(), ok=ok,
                      peak_pos=start.int(), cfo=cfo.float())
