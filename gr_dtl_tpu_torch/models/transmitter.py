"""OFDM transmitter chain: payload bytes -> complex baseband samples (port
of gr_dtl_tpu/models/transmitter.py).

Every per-frame quantity (constellation, payload length, frame number,
feedback echo, code id) is a tensor, and the whole batch flows through
tensor ops: framing + CRC32 (or, with FEC, the LDPC transport block of
``models/fec_chain`` and the long header), repack, constellation map,
header (BPSK), carrier allocation, size-64 IDFT as a matmul, cyclic
prefix.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gr_dtl_tpu_torch.models import fec_chain, framing
from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.ops import gf2, header, ofdm, repack, scramble
from gr_dtl_tpu_torch.utils import config as cfgmod

__all__ = ["TxParams", "build_tx", "tx_params_from_reference", "tx_frames", "TxOut"]


class TxOut(NamedTuple):
    samples: torch.Tensor  # [B, frame_samples] complex64 baseband
    frame_bytes: torch.Tensor  # [B, max_frame_bytes] uint8 framed bytes
    l_total: torch.Tensor  # [B] int32 header payload-length field


@dataclasses.dataclass(frozen=True)
class TxParams:
    """TX constants (the reference's ``build_tx`` dict)."""

    cfg: cfgmod.TxConfig
    alloc: ofdm.Allocator
    crc_tables: gf2.CrcTables
    fec: fec_chain.FecParams | None  # the LDPC transport-block path (cfg.fec)
    tab: cn.Tables  # the constellations symbols are mapped with, read at build time


def build_tx(cfg, device, fec: fec_chain.FecParams | None = None) -> TxParams:
    """All TX constants for a config, on ``device``, with the installed
    constellation tables and sync words.  A config with ``cfg.fec`` needs
    ``fec`` (:func:`fec_chain.build_fec`)."""
    if cfg.fec and fec is None:
        raise ValueError("cfg.fec=True requires a fec table (fec_chain.build_fec)")
    return TxParams(cfg=cfg, alloc=ofdm.build_allocator(cfg, device),
                    crc_tables=gf2.crc_tables(gf2.CRC32_FRAME, cfg.max_frame_bytes(),
                                              torch.device(device)),
                    fec=fec, tab=cn.active(device))


def tx_params_from_reference(d, device) -> TxParams:
    """:class:`TxParams` on ``device`` from the reference's ``build_tx``
    dict with its leaves as numpy arrays, and the installed constellation
    tables."""
    return TxParams(cfg=cfgmod.config_from_reference(d["cfg"]),
                    alloc=ofdm.allocator_from_reference(d["alloc"], device),
                    crc_tables=gf2.crc_tables_from_reference(d["crc_tables"], device),
                    fec=None if d["fec"] is None else fec_chain.fec_from_reference(d["fec"], device),
                    tab=cn.active(device))


def tx_frames(txp: TxParams, payload: torch.Tensor, payload_len: torch.Tensor,
              cnst_id: torch.Tensor, feedback_cnst: torch.Tensor,
              frame_no: torch.Tensor, pad: torch.Tensor | None,
              fec_feedback: torch.Tensor | None = None,
              fec_id: torch.Tensor | None = None) -> TxOut:
    """Modulate a batch of frames.

    Args:
      txp:          from :func:`build_tx`.
      payload:      [B, max_frame_bytes] uint8 ([B, max_payload_bytes]
                    with FEC), zero beyond payload_len.
      payload_len:  [B] payload bytes (excl. CRC32); payload_len + 4 must
                    fit cfg.frame_bytes(bps(cnst_id)) (with FEC, the
                    transport block's user bytes).
      cnst_id:      [B] payload constellation per frame.
      feedback_cnst:[B] echo of the local receiver's MCS request.
      frame_no:     [B] frame numbers (12-bit, wraps).
      pad:          [B, max_frame_bytes] uint8 random padding bytes
                    (unused with FEC: the transport block fills the frame).
      fec_feedback: [B] echo of the requested FEC scheme (FEC long header).
      fec_id:       [B] 1-based LDPC code ids (code bank), announced in the
                    header's fec_scheme field; None = code 1.
    """
    cfg = txp.cfg
    B = payload.shape[0]
    dev = payload.device
    bps = txp.tab.bps[cnst_id.long()]
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)

    if cfg.fec:
        # one transport block fills the frame (W = 1) or a W-frame group;
        # the long header carries the FEC fields
        frame_bits, tb_payload = fec_chain.fec_frame_build(
            txp.fec, payload, payload_len, cnst_id, fec_id=fec_id)
        frame = repack.bits_to_bytes(frame_bits)
        l_total = (payload_len + framing.CRC_LEN).int()
        W = txp.fec.W
        frame_bits_n = cfg.frame_capacity_symbols * bps.int()
        # W == 1: the small-TB-in-frame signal (offset == frame payload
        # bits); W > 1: bit offset of this frame in its TB; both 12-bit
        frame_in_tb = torch.arange(B, dtype=torch.int32, device=dev) % W
        tb_offset = (frame_bits_n if W == 1 else frame_in_tb * frame_bits_n) & 0xFFF
        fields = header.HeaderFields(
            payload_len=zeros, frame_no=frame_no.int(), cnst_id=cnst_id.int(),
            feedback_cnst=feedback_cnst.int(), tb_no=frame_no.int() // W,
            fec_feedback=zeros if fec_feedback is None else fec_feedback.int(),
            tb_offset=tb_offset,
            fec_scheme=torch.ones_like(zeros) if fec_id is None else fec_id.int(),
            tb_payload=tb_payload.int())
    else:
        frame, l_total = framing.build_frame_bytes(
            payload, payload_len, pad, cfg.max_frame_bytes(), txp.crc_tables)
        if cfg.scramble_bits:
            frame = scramble.scramble_frames(frame)
        fields = header.HeaderFields(
            payload_len=l_total, frame_no=frame_no.int(), cnst_id=cnst_id.int(),
            feedback_cnst=feedback_cnst.int(), tb_no=zeros, fec_feedback=zeros,
            tb_offset=zeros, fec_scheme=zeros, tb_payload=zeros)

    sym_idx = repack.bytes_to_symbols(frame, bps, cfg.frame_capacity_symbols)
    payload_pts = cn.map_symbols(sym_idx, cnst_id[:, None], txp.tab)
    payload_grid = payload_pts.reshape(B, cfg.frame_length, cfg.n_data_carriers)
    hbits = header.format_header(fields, cfg.fec)  # [B, 48 * header_symbols]
    bpsk = torch.full((B, 1), int(cn.ConstellationType.BPSK), device=dev)
    hgrid = cn.map_symbols(hbits, bpsk, txp.tab).reshape(B, cfg.header_symbols, cfg.n_data_carriers)

    spectra = ofdm.allocate_carriers(torch.cat([hgrid, payload_grid], dim=1), txp.alloc)
    time_syms = ofdm.ofdm_modulate(spectra)
    with_cp = ofdm.add_cyclic_prefix(time_syms, cfg.cp_len)
    return TxOut(samples=with_cp.reshape(B, cfg.frame_samples).to(torch.complex64),
                 frame_bytes=frame, l_total=l_total)
