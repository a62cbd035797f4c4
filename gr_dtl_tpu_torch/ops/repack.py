"""Bit repacking: bytes <-> k-bit symbols, LSB-first, with a per-frame k
(port of gr_dtl_tpu/ops/repack.py).

Symbol ``s`` of a frame takes bits ``s*k .. s*k+k-1`` of the byte
stream, each byte contributing its LSB first.  The per-frame ``k`` is
handled by computing all four static-``k`` repacks (each a reshape and
a shift) and selecting per frame.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["bytes_to_bits", "bits_to_bytes", "bytes_to_symbols", "symbols_to_bytes"]


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """[.., N] uint8 -> [.., N*8] uint8 bits (LSB of each byte first)."""
    sh = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = (data[..., None] >> sh) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """[.., N*8] bits -> [.., N] uint8 (LSB-first within each byte)."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).int()
    w = torch.ones(8, dtype=torch.int32, device=bits.device) << torch.arange(
        8, dtype=torch.int32, device=bits.device)
    return (b * w).sum(-1).to(torch.uint8)


def _fit(x: torch.Tensor, n: int) -> torch.Tensor:
    """Cut or zero-pad the last axis to n."""
    return x[:, :n] if x.shape[1] >= n else F.pad(x, (0, n - x.shape[1]))


def bytes_to_symbols(data: torch.Tensor, bps: torch.Tensor, n_symbols: int) -> torch.Tensor:
    """Repack bytes into k-bit symbols with per-frame k.

    Args:
      data:      [B, max_bytes] uint8.
      bps:       [B] bits per symbol (1..4); symbols beyond the byte
                 buffer are 0.
      n_symbols: symbol count per frame.
    Returns [B, n_symbols] int32 symbol indices.
    """
    bits = bytes_to_bits(data).int()
    B = bits.shape[0]
    out = torch.zeros((B, n_symbols), dtype=torch.int32, device=data.device)
    w = torch.ones(4, dtype=torch.int32, device=data.device) << torch.arange(
        4, dtype=torch.int32, device=data.device)
    for k in (1, 2, 3, 4):
        bk = _fit(bits, n_symbols * k)
        sym_k = (bk.reshape(B, n_symbols, k) * w[:k]).sum(-1).int()
        out = torch.where((bps == k)[:, None], sym_k, out)
    return out


def symbols_to_bytes(symbols: torch.Tensor, bps: torch.Tensor, max_bytes: int) -> torch.Tensor:
    """Inverse of :func:`bytes_to_symbols`.

    Args:
      symbols:   [B, n_symbols] integer symbols.
      bps:       [B] bits per symbol.
      max_bytes: output byte count (bits beyond n_symbols*bps are 0).
    Returns [B, max_bytes] uint8.
    """
    B, S = symbols.shape
    T = max_bytes * 8
    symbols = symbols.int()
    out_bits = torch.zeros((B, T), dtype=torch.int32, device=symbols.device)
    for k in (1, 2, 3, 4):
        sh = torch.arange(k, dtype=torch.int32, device=symbols.device)
        flat = ((symbols[:, :, None] >> sh) & 1).reshape(B, S * k)
        out_bits = torch.where((bps == k)[:, None], _fit(flat, T), out_bits)
    return bits_to_bytes(out_bits)
