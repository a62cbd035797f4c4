"""OFDM receiver chain: baseband samples -> payload bytes + telemetry (port
of gr_dtl_tpu/models/receiver.py).

- :func:`detect_and_extract`: the Schmidl-Cox timing metric of the whole
  stream (the CUDA kernel on a GPU), fold vote, trigger refinement, fine
  CFO, frame extraction, CFO de-rotation;
- :func:`rx_frames`: DFT, integer carrier offset, LS taps, then
  ``eq_passes`` passes of (BPSK header equalize + CRC16 parse, payload
  equalize) with data-aided re-estimation between passes, then either
  hard demap, repack, CRC32 (uncoded) or, with ``cfg.fec``, soft LLRs
  serialised into the frame bit stream and the LDPC transport-block
  decode of ``models/fec_chain``.

``rx_frames`` runs as three stages, :func:`demodulate`,
:func:`equalize_passes` and :func:`demap_and_verify`, which a profiler
or a timer can call one by one.  Each stage, and :func:`detect_and_extract`,
is a span of ``utils/trace`` (``rx.detect``, ``rx.demodulate``,
``rx.equalize``, ``rx.demap``), with spans inside it at the work it
composes; off by default.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gr_dtl_tpu_torch.models import fec_chain, framing
from gr_dtl_tpu_torch.ops import chanest, constellation as cn
from gr_dtl_tpu_torch.ops import equalizer, gf2, header, ofdm, repack, scramble, sync
from gr_dtl_tpu_torch.utils import config as cfgmod
from gr_dtl_tpu_torch.utils import trace

__all__ = ["RxOut", "RxParams", "build_rx", "rx_params_from_reference",
           "detect_and_extract", "rx_frames", "demodulate", "equalize_passes",
           "frame_llrs", "demap_and_verify"]


class RxOut(NamedTuple):
    payload: torch.Tensor  # [B, max_frame_bytes] uint8 ([B, max_payload_bytes] with
    # FEC), zeroed beyond payload_len
    payload_len: torch.Tensor  # [B] int32
    crc_ok: torch.Tensor  # [B] bool payload CRC32
    header_ok: torch.Tensor  # [B] bool header CRC16
    frame_no: torch.Tensor  # [B] int32
    cnst_id: torch.Tensor  # [B] int32 constellation used for the payload
    feedback_cnst: torch.Tensor  # [B] int32 peer's MCS request (in-band)
    fec_echo: torch.Tensor  # [B] int32 peer's FEC-scheme request (0 without FEC)
    snr_db: torch.Tensor  # [B] float32 payload-equalizer SNR estimate
    noise_var: torch.Tensor  # [B] float32
    carr_offset: torch.Tensor  # [B] int32
    soft_syms: torch.Tensor  # [B, frame_capacity_symbols] equalized payload symbols
    fec_ok: torch.Tensor  # [B] bool (True without FEC)
    avg_iters: torch.Tensor  # [B] float32 mean BP iterations (0 without FEC)


@dataclasses.dataclass(frozen=True)
class RxParams:
    """RX constants (the reference's ``build_rx`` dict)."""

    cfg: cfgmod.RxConfig
    alloc: ofdm.Allocator
    ce: chanest.ChanEst
    eq: equalizer.Equalizer
    eq2: equalizer.Equalizer  # refinement passes: taps start near-true, track slowly
    crc_tables: gf2.CrcTables
    fec: fec_chain.FecParams | None  # the LDPC transport-block path (cfg.fec)

    @property
    def tab(self) -> cn.Tables:
        """The constellation tables the model decides with (its equalizer's)."""
        return self.eq.tab


def build_rx(cfg, device, fec: fec_chain.FecParams | None = None) -> RxParams:
    """All RX constants for a config, on ``device``, with the installed
    constellation tables and sync words.  A config with ``cfg.fec`` needs
    ``fec`` (:func:`fec_chain.build_fec`)."""
    if cfg.fec and fec is None:
        raise ValueError("cfg.fec=True requires a fec table (fec_chain.build_fec)")
    eq = equalizer.build_equalizer(cfg, device)
    return RxParams(
        cfg=cfg, alloc=ofdm.build_allocator(cfg, device),
        ce=chanest.build_chanest(cfg, device), eq=eq,
        eq2=dataclasses.replace(eq, alpha=float(getattr(cfg, "eq_pass2_alpha", 0.95))),
        crc_tables=gf2.crc_tables(gf2.CRC32_FRAME, cfg.max_frame_bytes(), torch.device(device)),
        fec=fec)


def rx_params_from_reference(d, device) -> RxParams:
    """:class:`RxParams` on ``device`` from the reference's ``build_rx``
    dict with its leaves as numpy arrays, and the installed constellation
    tables."""
    return RxParams(
        cfg=cfgmod.config_from_reference(d["cfg"]),
        alloc=ofdm.allocator_from_reference(d["alloc"], device),
        ce=chanest.chanest_from_reference(d["ce"], device),
        eq=equalizer.equalizer_from_reference(d["eq"], device),
        eq2=equalizer.equalizer_from_reference(d["eq2"], device),
        crc_tables=gf2.crc_tables_from_reference(d["crc_tables"], device),
        fec=None if d["fec"] is None else fec_chain.fec_from_reference(d["fec"], device))


@trace.spanned("rx.detect")
def detect_and_extract(stream: torch.Tensor, cfg, n_frames: int):
    """Schmidl-Cox detection over a contiguous [N] stream -> aligned windows.

    Assumes n_frames frames at the common period cfg.frame_samples with
    an unknown stream offset.  Returns (frames [n_frames, frame_samples],
    eps [n_frames] fractional CFO).
    """
    with trace.span("rx.detect.metric"):
        P, M = sync.timing_metric(stream, cfg.fft_len)
    phase = sync.fold_detect(M, cfg.frame_samples, cfg.cp_len)
    trig = sync.frame_triggers(M, phase, cfg.frame_samples, n_frames)
    eps = sync.fine_cfo(P, trig, cfg.cp_len, period=cfg.frame_samples)
    # the trigger sits mid-plateau, so every 64-sample window taken from
    # it stays inside its own symbol
    frames = sync.extract_frames(stream, trig, cfg.frame_samples)
    return sync.cfo_correct(frames, eps, cfg.fft_len), eps


@trace.spanned("rx.demodulate")
def demodulate(rxp: RxParams, frames: torch.Tensor):
    """Stage 1: DFT of every symbol window, integer carrier offset and its
    correction, LS taps from the sync symbols.  Returns (spectra [B, n_sym,
    fft], carr_off [B] int32, taps [B, fft])."""
    cfg = rxp.cfg
    B = frames.shape[0]
    # symbol windows: first 64 of each 80-sample slot (mid-CP alignment)
    wins = frames.reshape(B, cfg.frame_ofdm_symbols, cfg.symbol_len)[:, :, : cfg.fft_len]
    spectra = ofdm.ofdm_demodulate(wins)
    carr_off = chanest.estimate_carrier_offset(spectra[:, 0], spectra[:, 1], rxp.ce)
    spectra = chanest.apply_carrier_shift(spectra, carr_off, rxp.ce, 0)
    taps = chanest.estimate_taps(spectra[:, 0], spectra[:, 1], rxp.ce)
    return spectra, carr_off, taps


@trace.spanned("rx.equalize")
def equalize_passes(rxp: RxParams, spectra: torch.Tensor, taps: torch.Tensor,
                    fallback_cnst: torch.Tensor | None = None):
    """Stage 2: ``eq_passes`` passes of header equalize + parse and payload
    equalize.  Each pass after the first re-estimates the taps by LS over
    every symbol of the frame (sync words + the previous pass's
    decisions), after a data-aided residual-CFO repair, and projects them
    onto the time-limited channel subspace.  Returns (payload
    EqualizerOut, header fields, header_ok [B], cnst [B] int32)."""
    cfg = rxp.cfg
    B = spectra.shape[0]
    hs = cfg.header_symbols
    n_sync = cfg.n_sync_symbols
    dev = spectra.device
    occ = rxp.alloc.occ_idx
    active = rxp.ce.active
    bpsk = torch.full((B,), int(cn.ConstellationType.BPSK), dtype=torch.int32, device=dev)
    if fallback_cnst is None:
        fallback_cnst = bpsk
    hdr_spec = spectra[:, n_sync : n_sync + hs]
    pay_spec = spectra[:, n_sync + hs :]
    sync_refs = torch.stack([rxp.ce.w1, rxp.ce.w2])[None].expand(B, n_sync, cfg.fft_len)
    eq_passes = max(1, int(getattr(cfg, "eq_passes", 1)))
    eq_tab = rxp.eq
    for p in range(eq_passes):
        # --- header pass (BPSK) ---
        with trace.span("rx.equalize.k2"):
            hdr_eq = equalizer.equalize_frame(hdr_spec, taps, bpsk, eq_tab, sym_offset=0)
        with trace.span("rx.equalize.header"):
            hdr_bits = cn.hard_decision(hdr_eq.soft[:, :, occ], bpsk[:, None, None], rxp.tab)
            fields, header_ok = header.parse_header(
                hdr_bits.reshape(B, hs * cfg.n_data_carriers), cfg.fec)
            # constellation gate: update only on CRC ok and a valid id
            valid_id = (fields.cnst_id >= 1) & (fields.cnst_id <= 4)
            cnst = torch.where(header_ok & valid_id, fields.cnst_id, fallback_cnst.int())

        # --- payload pass ---
        with trace.span("rx.equalize.k2"):
            pay_eq = equalizer.equalize_frame(pay_spec, hdr_eq.taps, cnst, eq_tab, sym_offset=hs)
        if p + 1 == eq_passes:
            break
        with trace.span("rx.equalize.reestimate"):
            # data-aided tap re-estimation: per-carrier LS across the whole
            # frame with the decided symbols as references
            refs = torch.cat([sync_refs, hdr_eq.hard, pay_eq.hard], dim=1)
            refs = torch.where(active[None, None, :], refs, 0.0)
            # residual-CFO repair: estimate the per-symbol phase drift d from
            # consecutive matched-filter phases and de-rotate the whole frame
            z = (spectra * torch.conj(refs * taps[:, None, :])).sum(-1)
            d = torch.angle((z[:, 1:] * torch.conj(z[:, :-1])).sum(-1))
            srange = torch.arange(spectra.shape[1], dtype=torch.float32, device=dev)
            spectra = spectra * torch.exp(-1j * d[:, None] * srange[None, :])[:, :, None]
            hdr_spec = spectra[:, n_sync : n_sync + hs]
            pay_spec = spectra[:, n_sync + hs :]
            num = (spectra * torch.conj(refs)).sum(1)
            den = (torch.abs(refs) ** 2).sum(1)
            taps = torch.where(den > 1e-9, num / torch.clamp(den, min=1e-9), 1.0)
            taps = chanest.denoise_taps(taps, rxp.ce)
            taps = torch.where(active[None, :], taps, 1.0).to(torch.complex64)
        eq_tab = rxp.eq2
    return pay_eq, fields, header_ok, cnst


def frame_llrs(rxp: RxParams, soft: torch.Tensor, cnst: torch.Tensor,
               noise_var: torch.Tensor) -> torch.Tensor:
    """FEC stage 3a: max-log LLRs of the [B, S] payload symbols, serialised
    into the frame bit stream [B, max_frame_bits] (symbol s holds bits
    s*bps .. s*bps+bps-1; zeros beyond S*bps).  Four static-k reshapes and
    a per-frame select."""
    B, S = soft.shape
    llr_bits = cn.soft_llrs(soft, cnst[:, None], noise_var[:, None], rxp.tab)  # [B, S, 4]
    bps = rxp.tab.bps[cnst.long()]
    maxF = rxp.fec.max_frame_bits
    llrs = torch.zeros((B, maxF), dtype=torch.float32, device=soft.device)
    for k in (1, 2, 3, 4):
        flat = llr_bits[:, :, :k].reshape(B, S * k)
        flat = flat[:, :maxF] if S * k >= maxF else F.pad(flat, (0, maxF - S * k))
        llrs = torch.where((bps == k)[:, None], flat, llrs)
    return llrs


@trace.spanned("rx.demap")
def demap_and_verify(rxp: RxParams, pay_eq: equalizer.EqualizerOut,
                     fields: header.HeaderFields, header_ok: torch.Tensor,
                     cnst: torch.Tensor, carr_off: torch.Tensor, defer_fec: bool = False):
    """Stage 3: uncoded, hard demap, repack, (descramble,) CRC32 verify;
    with ``cfg.fec``, soft LLRs and the transport-block decode, with the
    TB payload length from the header (gated on its CRC) and, for a code
    bank, the code from its fec_scheme field.  ``defer_fec`` (FEC only)
    skips the decode and returns ``(RxOut, fec_in)``, as :func:`rx_frames`."""
    cfg = rxp.cfg
    B = cnst.shape[0]
    dev = cnst.device
    soft = pay_eq.soft[:, :, rxp.alloc.occ_idx].reshape(B, cfg.frame_capacity_symbols)
    bps = rxp.tab.bps[cnst.long()]
    common = dict(header_ok=header_ok, frame_no=fields.frame_no, cnst_id=cnst,
                  feedback_cnst=fields.feedback_cnst, fec_echo=fields.fec_feedback,
                  snr_db=pay_eq.snr_db, noise_var=pay_eq.noise_var, carr_offset=carr_off,
                  soft_syms=soft)
    if not cfg.fec:
        with trace.span("rx.demap.decide"):
            dec = cn.hard_decision(soft, cnst[:, None], rxp.tab)
        with trace.span("rx.demap.repack"):
            frame_bytes = repack.symbols_to_bytes(dec, bps, cfg.max_frame_bytes())
            if cfg.scramble_bits:
                frame_bytes = scramble.scramble_frames(frame_bytes)
        with trace.span("rx.demap.crc"):
            payload, payload_len, crc_ok = framing.verify_frame_bytes(
                frame_bytes, fields.payload_len, rxp.crc_tables)
        return RxOut(payload=payload, payload_len=payload_len, crc_ok=crc_ok & header_ok,
                     fec_ok=torch.ones(B, dtype=torch.bool, device=dev),
                     avg_iters=torch.zeros(B, dtype=torch.float32, device=dev), **common)

    fec = rxp.fec
    with trace.span("rx.demap.llrs"):
        llrs = frame_llrs(rxp, soft, cnst, pay_eq.noise_var)
    P = torch.where(header_ok, fields.tb_payload, fec.tb_payload_t[1][bps])
    fid = torch.where(header_ok & (fields.fec_scheme >= 1) & (fields.fec_scheme <= fec.n_codes),
                      fields.fec_scheme, 1)
    if defer_fec:
        zeros_b = torch.zeros(B, dtype=torch.int32, device=dev)
        no = torch.zeros(B, dtype=torch.bool, device=dev)
        out = RxOut(payload=torch.zeros((B, fec.max_payload_bytes), dtype=torch.uint8, device=dev),
                    payload_len=zeros_b, crc_ok=no, fec_ok=no,
                    avg_iters=torch.zeros(B, dtype=torch.float32, device=dev), **common)
        return out, {"llrs": llrs, "tb_no": fields.tb_no, "tb_offset": fields.tb_offset,
                     "tb_payload": P, "fec_id": fid}
    fec_out = fec_chain.fec_frame_decode(fec, llrs, cnst, P,
                                         fec_id=fid if fec.n_codes > 1 else None)
    return RxOut(payload=fec_out.payload, payload_len=fec_out.payload_len,
                 crc_ok=fec_out.crc_ok & header_ok, fec_ok=fec_out.fec_ok,
                 avg_iters=fec_out.avg_iters, **common)


def rx_frames(rxp: RxParams, frames: torch.Tensor,
              fallback_cnst: torch.Tensor | None = None, defer_fec: bool = False):
    """Demodulate a batch of frame-aligned sample windows.

    Args:
      rxp:    from :func:`build_rx`.
      frames: [B, frame_samples] complex64, aligned so that sample 0 is
              within the first sync symbol's CP (e.g. from
              :func:`detect_and_extract`).
      fallback_cnst: [B] constellation to assume when the header CRC
              fails; defaults to BPSK.
      defer_fec: FEC configs only: skip the transport-block decode and
              return ``(RxOut, fec_in)``, ``fec_in`` the per-frame decoder
              inputs (``llrs`` [B, max_frame_bits], ``tb_no``,
              ``tb_offset``, ``tb_payload``, ``fec_id`` [B]) for streaming
              reassembly (:func:`fec_chain.tb_reassemble`); the RxOut's
              payload, payload_len, crc_ok, fec_ok and avg_iters are then
              placeholders.
    """
    spectra, carr_off, taps = demodulate(rxp, frames)
    pay_eq, fields, header_ok, cnst = equalize_passes(rxp, spectra, taps, fallback_cnst)
    return demap_and_verify(rxp, pay_eq, fields, header_ok, cnst, carr_off, defer_fec)
