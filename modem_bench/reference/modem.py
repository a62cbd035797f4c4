"""The reference modem end to end: :func:`tx_frames` (bytes -> baseband
frames) and the receiver, :func:`detect` (Schmidl-Cox detection, frame
extraction, fractional CFO) and :func:`rx_frames` (DFT, integer carrier
offset, LS taps, ``eq_passes`` equalizer passes with data-aided
re-estimation between them, then hard demap and CRC32, or soft LLRs and
the LDPC transport block)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from modem_bench.reference import bits as bt
from modem_bench.reference import dsp
from modem_bench.reference import fec as fecmod
from modem_bench.reference.config import Numerology


@dataclasses.dataclass(frozen=True)
class Modem:
    num: Numerology
    lay: dsp.Layout
    crc: bt.CrcTables  # CRC32 of an uncoded frame
    fec: fecmod.Fec | None


def build(num: Numerology, device, H: np.ndarray | None = None) -> Modem:
    """The modem's constants on ``device``; a coded numerology takes its
    code's parity-check matrix."""
    if num.fec and H is None:
        raise ValueError("a coded configuration needs its parity-check matrix")
    return Modem(num, dsp.build_layout(num, device),
                 bt.crc_tables(bt.CRC32_FRAME, num.max_frame_bytes(), torch.device(device)),
                 fecmod.build_fec(num, H, device) if num.fec else None)


def tx_frames(m: Modem, payload, payload_len, cnst, frame_no, pad=None) -> torch.Tensor:
    """[B, frame_samples] complex64 frames of the given user bytes
    (uncoded: payload | CRC32 | ``pad`` bytes; coded: the transport block),
    feedback fields 0."""
    num, dev = m.num, payload.device
    B = payload.shape[0]
    bps = dsp.tables(dev)[1][cnst.long()]
    z = torch.zeros(B, dtype=torch.int32, device=dev)
    if num.fec:
        fbits, tb = fecmod.frame_build(m.fec, payload, payload_len, bps)
        frame = bt.bits_to_bytes(fbits)
        offset = (num.frame_capacity_symbols * bps.int()) & 0xFFF
        hdr = bt.Header(z, frame_no.int(), cnst.int(), z, frame_no.int(), z, offset.int(),
                        torch.ones_like(z), tb.int())
    else:
        frame, l_total = bt.build_frame_bytes(payload, payload_len, pad, num.max_frame_bytes(), m.crc)
        hdr = bt.Header(l_total, frame_no.int(), cnst.int(), z, z, z, z, z, z)
    syms = bt.bytes_to_symbols(frame, bps, num.frame_capacity_symbols)
    grid = dsp.map_symbols(syms, cnst[:, None]).reshape(B, num.frame_length, num.n_data_carriers)
    hbits = bt.format_header(hdr, num.fec)
    hgrid = dsp.map_symbols(hbits, torch.full((B, 1), dsp.BPSK, device=dev)).reshape(
        B, num.header_symbols, num.n_data_carriers)
    spec = dsp.allocate(torch.cat([hgrid, grid], dim=1), m.lay)
    t = torch.matmul(spec, dsp.dft(num.fft_len, True, spec.device))
    t = torch.cat([t[..., -num.cp_len:], t], dim=-1)
    return t.reshape(B, num.frame_samples).to(torch.complex64)


def detect(stream: torch.Tensor, num: Numerology, n_frames: int):
    """(frames [n_frames, frame_samples] CFO-corrected, eps [n_frames])."""
    P, M = dsp.timing_metric(stream, num.fft_len)
    phase = dsp.fold_phase(M, num.frame_samples, num.cp_len)
    trig = dsp.frame_triggers(M, phase, num.frame_samples, n_frames)
    eps = dsp.fine_cfo(P, trig, num.cp_len, num.frame_samples)
    frames = dsp.extract_frames(stream, trig, num.frame_samples)
    return dsp.cfo_correct(frames, eps, num.fft_len), eps


class RxOut(NamedTuple):
    payload: torch.Tensor
    payload_len: torch.Tensor
    crc_ok: torch.Tensor
    header_ok: torch.Tensor
    frame_no: torch.Tensor
    cnst_id: torch.Tensor
    feedback_cnst: torch.Tensor
    snr_db: torch.Tensor
    carr_offset: torch.Tensor
    soft_syms: torch.Tensor
    fec_ok: torch.Tensor
    avg_iters: torch.Tensor
    bp_iters: torch.Tensor  # [B, codewords] BP updates a codeword slot took (coded), else [B, 0]


def rx_frames(m: Modem, frames: torch.Tensor, tf32: bool = False) -> RxOut:
    """Receive a batch of aligned frames.  ``tf32``: every float32 matmul
    with TF32 operands (the benchmark's control)."""
    num, lay = m.num, m.lay
    B, dev = frames.shape[0], frames.device
    wins = frames.reshape(B, num.frame_ofdm_symbols, num.symbol_len)[:, :, :num.fft_len]
    spectra = dsp.mm(wins, dsp.dft(num.fft_len, False, dev), tf32)
    carr = dsp.carrier_offset(spectra[:, 0], spectra[:, 1], lay, tf32)
    spectra = dsp.carrier_shift(spectra, carr, lay, num.cp_len)
    taps = dsp.ls_taps(spectra[:, 0], spectra[:, 1], lay, tf32)

    hs, ns = num.header_symbols, num.n_sync_symbols
    bpsk = torch.full((B,), dsp.BPSK, dtype=torch.int32, device=dev)
    sync_refs = torch.stack([lay.w1, lay.w2])[None].expand(B, ns, num.fft_len)
    alpha = num.eq_alpha
    passes = max(1, int(num.eq_passes))
    for p in range(passes):
        hdr = dsp.equalize(spectra[:, ns:ns + hs], taps, bpsk, lay, alpha, hs, 0)
        hbits = dsp.hard_decision(hdr[1][:, :, lay.occ_idx], bpsk[:, None, None])
        fields, header_ok = bt.parse_header(hbits.reshape(B, hs * num.n_data_carriers), num.fec)
        valid = (fields.cnst_id >= 1) & (fields.cnst_id <= 4)
        cnst = torch.where(header_ok & valid, fields.cnst_id, bpsk)
        pay = dsp.equalize(spectra[:, ns + hs:], hdr[2], cnst, lay, alpha, hs, hs)
        if p + 1 == passes:
            break
        refs = torch.where(lay.active[None, None, :], torch.cat([sync_refs, hdr[0], pay[0]], dim=1), 0.0)
        z = (spectra * torch.conj(refs * taps[:, None, :])).sum(-1)
        d = torch.angle((z[:, 1:] * torch.conj(z[:, :-1])).sum(-1))
        srange = torch.arange(spectra.shape[1], dtype=torch.float32, device=dev)
        spectra = spectra * torch.exp(-1j * d[:, None] * srange[None, :])[:, :, None]
        num_ = (spectra * torch.conj(refs)).sum(1)
        den = (torch.abs(refs) ** 2).sum(1)
        taps = torch.where(den > 1e-9, num_ / torch.clamp(den, min=1e-9), 1.0)
        taps = torch.where(lay.active[None, :], dsp.denoise(taps, lay, tf32), 1.0).to(torch.complex64)
        alpha = num.eq_pass2_alpha

    soft = pay[1][:, :, lay.occ_idx].reshape(B, num.frame_capacity_symbols)
    bps = dsp.tables(dev)[1][cnst.long()]
    common = dict(header_ok=header_ok, frame_no=fields.frame_no, cnst_id=cnst,
                  feedback_cnst=fields.feedback_cnst, snr_db=pay[3], carr_offset=carr, soft_syms=soft)
    if not num.fec:
        fb = bt.symbols_to_bytes(dsp.hard_decision(soft, cnst[:, None]), bps, num.max_frame_bytes())
        payload, plen, ok = bt.verify_frame_bytes(fb, fields.payload_len, m.crc)
        return RxOut(payload, plen, ok & header_ok, fec_ok=torch.ones(B, dtype=torch.bool, device=dev),
                     avg_iters=torch.zeros(B, device=dev), bp_iters=torch.zeros((B, 0), device=dev), **common)
    llr_bits = dsp.soft_llrs(soft, cnst[:, None], pay[4][:, None])
    S, maxF = soft.shape[1], m.fec.max_frame_bits
    llrs = torch.zeros((B, maxF), dtype=torch.float32, device=dev)
    for k in (1, 2, 3, 4):
        flat = llr_bits[:, :, :k].reshape(B, S * k)
        flat = flat[:, :maxF] if S * k >= maxF else F.pad(flat, (0, maxF - S * k))
        llrs = torch.where((bps == k)[:, None], flat, llrs)
    P = torch.where(header_ok, fields.tb_payload, m.fec.tb_bits[bps])
    out = fecmod.frame_decode(m.fec, llrs, bps, P)
    return RxOut(out.payload, out.payload_len, out.crc_ok & header_ok, fec_ok=out.fec_ok,
                 avg_iters=out.avg_iters, bp_iters=out.iters, **common)
