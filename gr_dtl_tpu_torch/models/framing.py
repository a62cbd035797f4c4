"""Frame payload building/unpacking: CRC32 append/verify + padding (port of
gr_dtl_tpu/models/framing.py).

A frame is payload | CRC32 (little-endian) | pad up to the buffer size.
The header's payload-length field counts payload + CRC bytes.  The pad
bytes are an argument: the caller draws them (``torch.randint`` with a
``torch.Generator``), which lets tests feed both packages the same pad.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gr_dtl_tpu_torch.ops import gf2

__all__ = ["build_frame_bytes", "verify_frame_bytes", "CRC_LEN"]

CRC_LEN = 4  # CRC32


def _crc_at(crc: torch.Tensor, j: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Byte (j - L) of each row's little-endian CRC at column j
    (clipped to 0..3), as uint8."""
    sh = torch.clamp(j - L, 0, CRC_LEN - 1) * 8
    return ((crc[:, None] >> sh) & 0xFF).to(torch.uint8)


def build_frame_bytes(payload: torch.Tensor, payload_len: torch.Tensor,
                      pad: torch.Tensor, max_frame_bytes: int,
                      crc_tables: gf2.CrcTables):
    """Assemble frame byte buffers: payload | CRC32 | pad.

    Args:
      payload:     [B, max_payload] uint8, rows zero beyond payload_len.
      payload_len: [B] integer payload bytes (excl. CRC).
      pad:         [B, max_frame_bytes] uint8 padding bytes; column j of
                   a row is used where j >= payload_len + 4.
      max_frame_bytes: buffer size (capacity at max bps).
      crc_tables:  CRC32_FRAME tables for max_payload bytes.
    Returns (frame [B, max_frame_bytes] uint8, l_total [B] int32 =
    payload_len + 4, the header length field).
    """
    j = torch.arange(max_frame_bytes, device=payload.device)[None, :]
    L = payload_len.long()[:, None]
    pay = F.pad(payload, (0, max(0, max_frame_bytes - payload.shape[1])))[:, :max_frame_bytes]
    pay = torch.where(j < L, pay, 0)  # the affine CRC needs zeros beyond L
    crc = gf2.crc_device(pay, payload_len, crc_tables)
    frame = torch.where(j < L, pay,
                        torch.where(j < L + CRC_LEN, _crc_at(crc, j, L), pad))
    return frame, (payload_len + CRC_LEN).int()


def verify_frame_bytes(frame: torch.Tensor, l_total: torch.Tensor,
                       crc_tables: gf2.CrcTables):
    """Check the frame CRC and return the clean payload.

    Args:
      frame:   [B, max_frame_bytes] uint8 received frame buffers.
      l_total: [B] integer header length field (payload + 4).
    Returns (payload [B, max_frame_bytes] uint8 zero-masked beyond its
    length, payload_len [B] int32, crc_ok [B] bool).
    """
    max_frame_bytes = frame.shape[1]
    payload_len = torch.clamp(l_total - CRC_LEN, 0, max_frame_bytes - CRC_LEN).int()
    j = torch.arange(max_frame_bytes, device=frame.device)[None, :]
    L = payload_len.long()[:, None]
    payload = torch.where(j < L, frame, 0)
    crc = gf2.crc_device(payload, payload_len, crc_tables)
    in_crc = (j >= L) & (j < L + CRC_LEN)
    got_at_j = torch.where(in_crc, frame, 0)
    want_at_j = torch.where(in_crc, _crc_at(crc, j, L), 0)
    crc_ok = (got_at_j == want_at_j).all(dim=1) & (l_total >= CRC_LEN)
    return payload, payload_len, crc_ok
