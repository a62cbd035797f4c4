"""OFDM transmitter chain: payload bytes -> complex baseband samples (port
of gr_dtl_tpu/models/transmitter.py, uncoded branch).

Every per-frame quantity (constellation, payload length, frame number,
feedback echo) is a tensor, and the whole batch flows through tensor
ops: framing + CRC32, repack, constellation map, header (BPSK),
carrier allocation, size-64 IDFT as a matmul, cyclic prefix.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gr_dtl_tpu_torch.models import framing
from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.ops import gf2, header, ofdm, repack, scramble
from gr_dtl_tpu_torch.utils import config as cfgmod

__all__ = ["TxParams", "build_tx", "tx_params_from_reference", "tx_frames", "TxOut"]

_FEC_TODO = "the coded (LDPC) path is not ported yet: ROADMAP.md, slice B, item B3"


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


def build_tx(cfg, device) -> TxParams:
    """All TX constants for an uncoded config, on ``device``."""
    if cfg.fec:
        raise NotImplementedError(_FEC_TODO)
    return TxParams(cfg=cfg, alloc=ofdm.build_allocator(cfg, device),
                    crc_tables=gf2.crc_tables(gf2.CRC32_FRAME, cfg.max_frame_bytes(),
                                              torch.device(device)))


def tx_params_from_reference(d, device) -> TxParams:
    """:class:`TxParams` on ``device`` from the reference's ``build_tx``
    dict with its leaves as numpy arrays."""
    if d["has_fec"]:
        raise NotImplementedError(_FEC_TODO)
    return TxParams(cfg=cfgmod.config_from_reference(d["cfg"]),
                    alloc=ofdm.allocator_from_reference(d["alloc"], device),
                    crc_tables=gf2.crc_tables_from_reference(d["crc_tables"], device))


def tx_frames(txp: TxParams, payload: torch.Tensor, payload_len: torch.Tensor,
              cnst_id: torch.Tensor, feedback_cnst: torch.Tensor,
              frame_no: torch.Tensor, pad: torch.Tensor) -> TxOut:
    """Modulate a batch of frames.

    Args:
      txp:          from :func:`build_tx`.
      payload:      [B, max_frame_bytes] uint8, zero beyond payload_len.
      payload_len:  [B] payload bytes (excl. CRC32); payload_len + 4 must
                    fit cfg.frame_bytes(bps(cnst_id)).
      cnst_id:      [B] payload constellation per frame.
      feedback_cnst:[B] echo of the local receiver's MCS request.
      frame_no:     [B] frame numbers (12-bit, wraps).
      pad:          [B, max_frame_bytes] uint8 random padding bytes.
    """
    cfg = txp.cfg
    B = payload.shape[0]
    _, bps_table, _ = cn.tables(payload.device)
    bps = bps_table[cnst_id.long()]

    frame, l_total = framing.build_frame_bytes(
        payload, payload_len, pad, cfg.max_frame_bytes(), txp.crc_tables)
    if cfg.scramble_bits:
        frame = scramble.scramble_frames(frame)
    zeros = torch.zeros(B, dtype=torch.int32, device=payload.device)
    fields = header.HeaderFields(
        payload_len=l_total, frame_no=frame_no.int(), cnst_id=cnst_id.int(),
        feedback_cnst=feedback_cnst.int(), tb_no=zeros, fec_feedback=zeros,
        tb_offset=zeros, fec_scheme=zeros, tb_payload=zeros)

    sym_idx = repack.bytes_to_symbols(frame, bps, cfg.frame_capacity_symbols)
    payload_pts = cn.map_symbols(sym_idx, cnst_id[:, None])
    payload_grid = payload_pts.reshape(B, cfg.frame_length, cfg.n_data_carriers)
    hbits = header.format_header(fields, False)  # [B, 48]
    bpsk = torch.full((B, 1), int(cn.ConstellationType.BPSK), device=payload.device)
    hgrid = cn.map_symbols(hbits, bpsk).reshape(B, cfg.header_symbols, cfg.n_data_carriers)

    spectra = ofdm.allocate_carriers(torch.cat([hgrid, payload_grid], dim=1), txp.alloc)
    time_syms = ofdm.ofdm_modulate(spectra)
    with_cp = ofdm.add_cyclic_prefix(time_syms, cfg.cp_len)
    return TxOut(samples=with_cp.reshape(B, cfg.frame_samples).to(torch.complex64),
                 frame_bytes=frame, l_total=l_total)
