"""Affine CRC over GF(2) as a float32 matmul (port of gr_dtl_tpu/ops/gf2.py).

CRC is affine in the message bits, so a whole batch of frames is one
matmul plus a per-frame length correction:

    crc(m, L) = reflect_out( T_{8L} · (D · m)  ⊕  init · x^{8L} mod p ) ⊕ xor_out

- ``D`` [max_bits, width]: column i holds the bits of x^{-(i+1)} mod p,
  so messages stay left-aligned and zero-padded,
- ``T_{8L}`` [width, width]: multiply by x^{8L+width}, one per length,
- ``init · x^{8L} mod p``: a per-length constant.

The tables are built on the host with exact integer polynomial
arithmetic.  On the device the products are float32 matmuls of 0/1
values (sums stay far below 2^24, so exact with TF32 off) followed by
``mod 2``; the final weighted bit sum is int64, because torch's uint32
support is partial.  CRC values are returned as int64 holding the
uint32 value.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

__all__ = [
    "CrcSpec",
    "CRC32_FRAME",
    "CRC16_HEADER",
    "CRC8_FEEDBACK",
    "CrcTables",
    "make_crc_tables",
    "crc_tables",
    "crc_tables_from_reference",
    "crc_device",
]


def _gf2_mulmod(a: int, b: int, poly: int, width: int) -> int:
    """(a*b) mod (x^width + poly) with carry-less multiplication."""
    full_poly = (1 << width) | poly
    res = 0
    while b:
        if b & 1:
            res ^= a
        b >>= 1
        a <<= 1
        if a >> width & 1:
            a ^= full_poly
    for bit in range(res.bit_length() - 1, width - 1, -1):
        if res >> bit & 1:
            res ^= full_poly << (bit - width)
    return res


def _gf2_powmod(base: int, exp: int, poly: int, width: int) -> int:
    res = 1
    base %= 1 << width
    while exp:
        if exp & 1:
            res = _gf2_mulmod(res, base, poly, width)
        base = _gf2_mulmod(base, base, poly, width)
        exp >>= 1
    return res


def _gf2_inv_x(poly: int, width: int) -> int:
    """x^{-1} mod p.  Since p(0)=1:  x^{-1} = (p(x)+1)/x."""
    full_poly = (1 << width) | poly
    if not full_poly & 1:
        raise ValueError("CRC polynomial must have a nonzero constant term")
    return (full_poly ^ 1) >> 1


@dataclasses.dataclass(frozen=True)
class CrcSpec:
    """CRC parameters, in ``gr::digital::crc``'s constructor order."""

    width: int
    poly: int
    init: int
    xor_out: int
    reflect_in: bool
    reflect_out: bool


# frame payload CRC32 (reflect in+out) and header CRC16 of the protocol
CRC32_FRAME = CrcSpec(32, 0x04C11DB7, 0xFFFFFFFF, 0xFFFFFFFF, True, True)
CRC16_HEADER = CrcSpec(16, 0x1021, 0xFFFF, 0x0, False, True)
# feedback-burst CRC8 (poly 0x07, init 0xFF, no reflection)
CRC8_FEEDBACK = CrcSpec(8, 0x07, 0xFF, 0x00, False, False)


def _int_to_bits(v: int, width: int) -> np.ndarray:
    return np.array([(v >> i) & 1 for i in range(width)], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def make_crc_tables(spec: CrcSpec, max_len_bytes: int):
    """Numpy (D, T, init_term) for messages of up to max_len_bytes.

      D         [max_bits, width]   column i = bits of x^{-(i+1)} mod p
      T         [max_len+1, width, width]  multiply by x^{8L+width}
      init_term [max_len+1, width]  bits of init*x^{8L} mod p
    """
    w, p = spec.width, spec.poly
    max_bits = max_len_bytes * 8
    inv_x = _gf2_inv_x(p, w)

    D = np.zeros((max_bits, w), dtype=np.float32)
    cur = 1
    for i in range(max_bits):
        cur = _gf2_mulmod(cur, inv_x, p, w)
        D[i] = _int_to_bits(cur, w)

    T = np.zeros((max_len_bytes + 1, w, w), dtype=np.float32)
    init_term = np.zeros((max_len_bytes + 1, w), dtype=np.float32)
    for L in range(max_len_bytes + 1):
        mult = _gf2_powmod(2, 8 * L + w, p, w)
        for j in range(w):
            T[L, j] = _int_to_bits(_gf2_mulmod(1 << j, mult, p, w), w)
        init_term[L] = _int_to_bits(
            _gf2_mulmod(spec.init, _gf2_powmod(2, 8 * L, p, w), p, w), w)
    return {"D": D, "T": T, "init_term": init_term, "spec": spec}


@dataclasses.dataclass(frozen=True)
class CrcTables:
    """Device copies of :func:`make_crc_tables` (float32) and the spec."""

    D: torch.Tensor
    T: torch.Tensor
    init_term: torch.Tensor
    spec: CrcSpec


def crc_tables_from_reference(d, device) -> CrcTables:
    """:class:`CrcTables` on ``device`` from a dict of numpy ``D``, ``T``,
    ``init_term`` and a ``spec`` with CrcSpec's fields."""
    s = d["spec"]
    spec = CrcSpec(*(getattr(s, f.name) for f in dataclasses.fields(CrcSpec)))
    return CrcTables(
        D=torch.as_tensor(np.asarray(d["D"], np.float32), device=device),
        T=torch.as_tensor(np.asarray(d["T"], np.float32), device=device),
        init_term=torch.as_tensor(np.asarray(d["init_term"], np.float32), device=device),
        spec=spec)


@functools.lru_cache(maxsize=None)
def crc_tables(spec: CrcSpec, max_len_bytes: int, device: torch.device) -> CrcTables:
    """:func:`make_crc_tables` on ``device``, made once per (spec, size, device)."""
    return crc_tables_from_reference(make_crc_tables(spec, max_len_bytes), device)


def _bytes_to_crc_bitstream(msg: torch.Tensor, spec: CrcSpec) -> torch.Tensor:
    """[.., N] uint8 -> [.., N*8] bits in CRC feed order (msb- or lsb-first)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=msg.device)
    if not spec.reflect_in:
        shifts = 7 - shifts
    bits = (msg[..., None] >> shifts) & 1
    return bits.reshape(*msg.shape[:-1], msg.shape[-1] * 8)


def crc_device(msg: torch.Tensor, lengths: torch.Tensor, tables: CrcTables) -> torch.Tensor:
    """Batched CRC.

    Args:
      msg:     [B, max_len] uint8, each row's bytes beyond its length MUST be 0.
      lengths: [B] integer message byte lengths.
      tables:  :class:`CrcTables`.
    Returns [B] int64 CRC values (uint32 range).
    """
    spec = tables.spec
    w = spec.width
    lengths = lengths.long()
    bits = _bytes_to_crc_bitstream(msg, spec).float()  # [B, maxbits]
    v = torch.remainder(bits @ tables.D, 2.0)  # [B, w]
    core = torch.bmm(v[:, None, :], tables.T[lengths])[:, 0]  # [B, w]
    core = torch.remainder(torch.remainder(core, 2.0) + tables.init_term[lengths], 2.0)
    order = torch.arange(w, device=msg.device)
    if spec.reflect_out:
        order = w - 1 - order
    crc = (core.long() << order).sum(-1)
    return crc ^ spec.xor_out
