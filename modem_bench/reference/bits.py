"""Bit-level layers of the reference modem: CRCs (affine over GF(2), as
0/1 float32 matmuls), the frame header, repacking between bytes and k-bit
symbols, and CRC32 framing."""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

CRC_LEN = 4


@dataclasses.dataclass(frozen=True)
class CrcSpec:
    width: int
    poly: int
    init: int
    xor_out: int
    reflect_in: bool
    reflect_out: bool


CRC32_FRAME = CrcSpec(32, 0x04C11DB7, 0xFFFFFFFF, 0xFFFFFFFF, True, True)
CRC16_HEADER = CrcSpec(16, 0x1021, 0xFFFF, 0x0, False, True)


def _mulmod(a: int, b: int, poly: int, width: int) -> int:
    full = (1 << width) | poly
    res = 0
    while b:
        if b & 1:
            res ^= a
        b >>= 1
        a <<= 1
        if a >> width & 1:
            a ^= full
    for bit in range(res.bit_length() - 1, width - 1, -1):
        if res >> bit & 1:
            res ^= full << (bit - width)
    return res


def _powmod(base: int, exp: int, poly: int, width: int) -> int:
    res = 1
    base %= 1 << width
    while exp:
        if exp & 1:
            res = _mulmod(res, base, poly, width)
        base = _mulmod(base, base, poly, width)
        exp >>= 1
    return res


def _bits(v: int, width: int) -> np.ndarray:
    return np.array([(v >> i) & 1 for i in range(width)], np.float32)


@functools.lru_cache(maxsize=None)
def _tables_np(spec: CrcSpec, max_len_bytes: int):
    """(D [bits, w], T [L+1, w, w], init_term [L+1, w]): crc(m, L) =
    T_L (D m) + init x^{8L} mod p, reflected and xored."""
    w, p = spec.width, spec.poly
    inv_x = (((1 << w) | p) ^ 1) >> 1
    D = np.zeros((max_len_bytes * 8, w), np.float32)
    cur = 1
    for i in range(max_len_bytes * 8):
        cur = _mulmod(cur, inv_x, p, w)
        D[i] = _bits(cur, w)
    T = np.zeros((max_len_bytes + 1, w, w), np.float32)
    init = np.zeros((max_len_bytes + 1, w), np.float32)
    for L in range(max_len_bytes + 1):
        mult = _powmod(2, 8 * L + w, p, w)
        for j in range(w):
            T[L, j] = _bits(_mulmod(1 << j, mult, p, w), w)
        init[L] = _bits(_mulmod(spec.init, _powmod(2, 8 * L, p, w), p, w), w)
    return D, T, init


class CrcTables(NamedTuple):
    D: torch.Tensor
    T: torch.Tensor
    init_term: torch.Tensor
    spec: CrcSpec


@functools.lru_cache(maxsize=None)
def crc_tables(spec: CrcSpec, max_len_bytes: int, device: torch.device) -> CrcTables:
    D, T, init = _tables_np(spec, max_len_bytes)
    t = lambda a: torch.as_tensor(a, device=device)
    return CrcTables(t(D), t(T), t(init), spec)


def crc_host(data, spec: CrcSpec) -> int:
    """Bitwise CRC of bytes on the host, the golden model of the tables."""
    reg, top, mask = spec.init, 1 << (spec.width - 1), (1 << spec.width) - 1
    for byte in bytes(data):
        if spec.reflect_in:
            byte = int(f"{byte:08b}"[::-1], 2)
        reg ^= byte << (spec.width - 8)
        for _ in range(8):
            reg = (((reg << 1) ^ spec.poly) if reg & top else (reg << 1)) & mask
    if spec.reflect_out:
        reg = int(f"{reg:0{spec.width}b}"[::-1], 2)
    return reg ^ spec.xor_out


def crc_device(msg: torch.Tensor, lengths: torch.Tensor, tables: CrcTables) -> torch.Tensor:
    """[B, L] uint8 messages (zero past each row's length) -> [B] int64 CRCs."""
    spec = tables.spec
    w = spec.width
    lengths = lengths.long()
    shifts = torch.arange(8, dtype=torch.uint8, device=msg.device)
    if not spec.reflect_in:
        shifts = 7 - shifts
    bits = ((msg[..., None] >> shifts) & 1).reshape(msg.shape[0], -1).float()
    v = torch.remainder(bits @ tables.D, 2.0)
    core = torch.bmm(v[:, None, :], tables.T[lengths])[:, 0]
    core = torch.remainder(torch.remainder(core, 2.0) + tables.init_term[lengths], 2.0)
    order = torch.arange(w, device=msg.device)
    if spec.reflect_out:
        order = w - 1 - order
    return (core.long() << order).sum(-1) ^ spec.xor_out


# ---------------------------------------------------------------- repack

def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """[.., N] uint8 -> [.., 8N] bits, LSB of each byte first."""
    sh = torch.arange(8, dtype=torch.uint8, device=data.device)
    return ((data[..., None] >> sh) & 1).reshape(*data.shape[:-1], data.shape[-1] * 8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).int()
    w = torch.ones(8, dtype=torch.int32, device=bits.device) << torch.arange(8, dtype=torch.int32,
                                                                          device=bits.device)
    return (b * w).sum(-1).to(torch.uint8)


def _fit(x: torch.Tensor, n: int) -> torch.Tensor:
    return x[:, :n] if x.shape[1] >= n else F.pad(x, (0, n - x.shape[1]))


def bytes_to_symbols(data: torch.Tensor, bps: torch.Tensor, n_symbols: int) -> torch.Tensor:
    """[B, bytes] -> [B, n_symbols] int32 k-bit symbols, k = bps per row."""
    bits = bytes_to_bits(data).int()
    B = bits.shape[0]
    out = torch.zeros((B, n_symbols), dtype=torch.int32, device=data.device)
    w = torch.ones(4, dtype=torch.int32, device=data.device) << torch.arange(4, dtype=torch.int32,
                                                                          device=data.device)
    for k in (1, 2, 3, 4):
        sym_k = (_fit(bits, n_symbols * k).reshape(B, n_symbols, k) * w[:k]).sum(-1).int()
        out = torch.where((bps == k)[:, None], sym_k, out)
    return out


def symbols_to_bytes(symbols: torch.Tensor, bps: torch.Tensor, max_bytes: int) -> torch.Tensor:
    B, S = symbols.shape
    symbols = symbols.int()
    out = torch.zeros((B, max_bytes * 8), dtype=torch.int32, device=symbols.device)
    for k in (1, 2, 3, 4):
        sh = torch.arange(k, dtype=torch.int32, device=symbols.device)
        flat = ((symbols[:, :, None] >> sh) & 1).reshape(B, S * k)
        out = torch.where((bps == k)[:, None], _fit(flat, max_bytes * 8), out)
    return bits_to_bytes(out)


# ---------------------------------------------------------------- header

class Header(NamedTuple):
    payload_len: torch.Tensor
    frame_no: torch.Tensor
    cnst_id: torch.Tensor
    feedback_cnst: torch.Tensor
    tb_no: torch.Tensor
    fec_feedback: torch.Tensor
    tb_offset: torch.Tensor
    fec_scheme: torch.Tensor
    tb_payload: torch.Tensor


def _field_bits(val: torch.Tensor, n: int) -> torch.Tensor:
    return (val.int()[:, None] >> torch.arange(n, dtype=torch.int32, device=val.device)) & 1


def _field(bits: torch.Tensor) -> torch.Tensor:
    n = bits.shape[-1]
    w = torch.ones(n, dtype=torch.int32, device=bits.device) << torch.arange(n, dtype=torch.int32,
                                                                          device=bits.device)
    return (bits.int() * w).sum(-1).int()


def _crc16(bits: torch.Tensor, n_msg: int) -> torch.Tensor:
    nb = n_msg // 8
    b = bits[:, :n_msg].reshape(bits.shape[0], nb, 8).int()
    w = torch.ones(8, dtype=torch.int32, device=bits.device) << torch.arange(7, -1, -1, dtype=torch.int32,
                                                                          device=bits.device)
    msg = (b * w).sum(-1).to(torch.uint8)
    lengths = torch.full((bits.shape[0],), nb, dtype=torch.int64, device=bits.device)
    return crc_device(msg, lengths, crc_tables(CRC16_HEADER, nb, bits.device)).int()


def format_header(h: Header, fec: bool) -> torch.Tensor:
    """[B, 48] (short) or [B, 96] (FEC) header bits, CRC16 last."""
    parts = [_field_bits(h.payload_len & 0xFFF, 12), _field_bits(h.frame_no & 0xFFF, 12),
             _field_bits(h.cnst_id & 0xF, 4), _field_bits(h.feedback_cnst & 0xF, 4)]
    if fec:
        parts += [_field_bits(h.tb_no & 0xFFF, 12), _field_bits(h.fec_feedback & 0xF, 4),
                  _field_bits(h.tb_offset & 0xFFF, 12), _field_bits(h.fec_scheme & 0xF, 4),
                  _field_bits(h.tb_payload & 0xFFFF, 16)]
    msg = torch.cat(parts, dim=-1)
    return torch.cat([msg, _field_bits(_crc16(msg, msg.shape[-1]), 16)], dim=-1)


def parse_header(bits: torch.Tensor, fec: bool):
    """(Header, crc_ok [B])."""
    bits = bits.int()
    z = torch.zeros(bits.shape[0], dtype=torch.int32, device=bits.device)
    f = [_field(bits[:, 0:12]), _field(bits[:, 12:24]), _field(bits[:, 24:28]), _field(bits[:, 28:32])]
    if fec:
        f += [_field(bits[:, 32:44]), _field(bits[:, 44:48]), _field(bits[:, 48:60]),
              _field(bits[:, 60:64]), _field(bits[:, 64:80])]
        n_msg = 80
    else:
        f += [z, z, z, z, z]
        n_msg = 32
    return Header(*f), _field(bits[:, n_msg:n_msg + 16]) == _crc16(bits, n_msg)


# ---------------------------------------------------------------- framing

def _crc_at(crc: torch.Tensor, j: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    return ((crc[:, None] >> (torch.clamp(j - L, 0, CRC_LEN - 1) * 8)) & 0xFF).to(torch.uint8)


def build_frame_bytes(payload, payload_len, pad, max_frame_bytes: int, tables: CrcTables):
    """payload | CRC32 (little-endian) | pad -> (frame [B, max_frame_bytes],
    header length field payload_len + 4)."""
    j = torch.arange(max_frame_bytes, device=payload.device)[None, :]
    L = payload_len.long()[:, None]
    pay = F.pad(payload, (0, max(0, max_frame_bytes - payload.shape[1])))[:, :max_frame_bytes]
    pay = torch.where(j < L, pay, 0)
    crc = crc_device(pay, payload_len, tables)
    frame = torch.where(j < L, pay, torch.where(j < L + CRC_LEN, _crc_at(crc, j, L), pad))
    return frame, (payload_len + CRC_LEN).int()


def verify_frame_bytes(frame, l_total, tables: CrcTables):
    """(payload zeroed past its length, payload_len, crc_ok)."""
    n = frame.shape[1]
    payload_len = torch.clamp(l_total - CRC_LEN, 0, n - CRC_LEN).int()
    j = torch.arange(n, device=frame.device)[None, :]
    L = payload_len.long()[:, None]
    payload = torch.where(j < L, frame, 0)
    crc = crc_device(payload, payload_len, tables)
    in_crc = (j >= L) & (j < L + CRC_LEN)
    ok = (torch.where(in_crc, frame, 0) == torch.where(in_crc, _crc_at(crc, j, L), 0)).all(1)
    return payload, payload_len, ok & (l_total >= CRC_LEN)
