"""Frame header formatter/parser, batched (port of gr_dtl_tpu/ops/header.py).

Bit layout of the reference protocol:

short header (48 bits, 1 BPSK OFDM symbol):
  bits  0-11  payload length in bytes (incl. CRC32), LSB-first
  bits 12-23  frame number (mod 4096)
  bits 24-27  constellation id
  bits 28-31  feedback constellation id
  bits 32-47  CRC16 over bits 0-31 (packed MSB-first into 4 bytes;
              poly 0x1021 init 0xFFFF, result reflected), LSB-first

long header with FEC (96 bits, 2 BPSK OFDM symbols) adds at bit 32:
  bits 32-43  TB number         bits 44-47  FEC feedback scheme
  bits 48-59  TB offset         bits 60-63  FEC scheme
  bits 64-79  TB payload length bits 80-95  CRC16 over bits 0-79
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gr_dtl_tpu_torch.ops import gf2

__all__ = ["HeaderFields", "format_header", "parse_header", "header_nbits"]


class HeaderFields(NamedTuple):
    payload_len: torch.Tensor  # [B] int32: bytes incl. CRC32
    frame_no: torch.Tensor  # [B] int32 (12 bit)
    cnst_id: torch.Tensor  # [B] int32 (4 bit)
    feedback_cnst: torch.Tensor  # [B] int32 (4 bit)
    # FEC fields (zeros for the short header)
    tb_no: torch.Tensor
    fec_feedback: torch.Tensor
    tb_offset: torch.Tensor
    fec_scheme: torch.Tensor
    tb_payload: torch.Tensor


def header_nbits(has_fec: bool) -> int:
    return 96 if has_fec else 48


def _field_bits(val: torch.Tensor, nbits: int) -> torch.Tensor:
    """[B] -> [B, nbits] LSB-first bits (int32)."""
    sh = torch.arange(nbits, dtype=torch.int32, device=val.device)
    return (val.int()[:, None] >> sh) & 1


def _bits_to_field(bits: torch.Tensor) -> torch.Tensor:
    """[B, nbits] -> [B] int32, LSB-first."""
    w = torch.ones(bits.shape[-1], dtype=torch.int32, device=bits.device) << torch.arange(
        bits.shape[-1], dtype=torch.int32, device=bits.device)
    return (bits.int() * w).sum(-1).int()


def _crc16_of_bits(bits: torch.Tensor, n_msg_bits: int) -> torch.Tensor:
    """CRC16 over the first n_msg_bits, packed MSB-first into bytes."""
    n_bytes = n_msg_bits // 8
    b = bits[:, :n_msg_bits].reshape(bits.shape[0], n_bytes, 8).int()
    w = torch.ones(8, dtype=torch.int32, device=bits.device) << torch.arange(
        7, -1, -1, dtype=torch.int32, device=bits.device)
    msg = (b * w).sum(-1).to(torch.uint8)
    tables = gf2.crc_tables(gf2.CRC16_HEADER, n_bytes, bits.device)
    lengths = torch.full((bits.shape[0],), n_bytes, dtype=torch.int64, device=bits.device)
    return gf2.crc_device(msg, lengths, tables).int()


def format_header(fields: HeaderFields, has_fec: bool) -> torch.Tensor:
    """Build header bits. Returns [B, header_nbits] int32 bits (0/1)."""
    parts = [
        _field_bits(fields.payload_len & 0xFFF, 12),
        _field_bits(fields.frame_no & 0xFFF, 12),
        _field_bits(fields.cnst_id & 0xF, 4),
        _field_bits(fields.feedback_cnst & 0xF, 4),
    ]
    if has_fec:
        parts += [
            _field_bits(fields.tb_no & 0xFFF, 12),
            _field_bits(fields.fec_feedback & 0xF, 4),
            _field_bits(fields.tb_offset & 0xFFF, 12),
            _field_bits(fields.fec_scheme & 0xF, 4),
            _field_bits(fields.tb_payload & 0xFFFF, 16),
        ]
    msg = torch.cat(parts, dim=-1)
    crc = _crc16_of_bits(msg, msg.shape[-1])
    return torch.cat([msg, _field_bits(crc, 16)], dim=-1)


def parse_header(bits: torch.Tensor, has_fec: bool):
    """Parse header bits -> (fields, crc_ok [B] bool)."""
    bits = bits.int()
    z = torch.zeros(bits.shape[0], dtype=torch.int32, device=bits.device)
    payload_len = _bits_to_field(bits[:, 0:12])
    frame_no = _bits_to_field(bits[:, 12:24])
    cnst_id = _bits_to_field(bits[:, 24:28])
    feedback_cnst = _bits_to_field(bits[:, 28:32])
    if has_fec:
        tb_no = _bits_to_field(bits[:, 32:44])
        fec_feedback = _bits_to_field(bits[:, 44:48])
        tb_offset = _bits_to_field(bits[:, 48:60])
        fec_scheme = _bits_to_field(bits[:, 60:64])
        tb_payload = _bits_to_field(bits[:, 64:80])
        n_msg = 80
    else:
        tb_no = fec_feedback = tb_offset = fec_scheme = tb_payload = z
        n_msg = 32
    crc_got = _bits_to_field(bits[:, n_msg : n_msg + 16])
    crc_want = _crc16_of_bits(bits, n_msg)
    fields = HeaderFields(payload_len, frame_no, cnst_id, feedback_cnst,
                          tb_no, fec_feedback, tb_offset, fec_scheme, tb_payload)
    return fields, crc_got == crc_want
