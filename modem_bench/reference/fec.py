"""The reference modem's LDPC transport block, one code, a block a frame:
the payload and its CRC32 split over ``ncws`` codewords with balanced
shortening (``k'_i = ceil((P - i) / ncws)``), each sent as ``[m check
bits | k'_i systematic bits]``; unsent bits decode pinned at
+SHORTENED_LLR, unused codeword slots are pinned dummies."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from modem_bench.reference import bits as bt
from modem_bench.reference import dsp
from modem_bench.reference.ldpc import SHORTENED_LLR, Code, build_code, decode, encode

CRC_BITS = 32


@dataclasses.dataclass(frozen=True)
class Fec:
    code: Code
    max_ncws: int
    max_payload_bytes: int
    max_frame_bits: int
    ncws: torch.Tensor  # [5] codewords a frame by bps
    tb_bits: torch.Tensor  # [5] payload + CRC bits of a full block by bps
    user_bytes: np.ndarray  # [5] host copy: user bytes of a full block
    crc: bt.CrcTables


def build_fec(num, H: np.ndarray, device) -> Fec:
    code = build_code(H, device)
    cap = num.frame_capacity_symbols
    ncws = np.zeros(5, np.int32)
    user = np.zeros(5, np.int32)
    ncws[0] = 1
    for b in range(1, 5):
        gb = cap * b
        ncws[b] = 1 + gb // code.N if gb > code.N else 1
        user[b] = (gb - ncws[b] * code.M) // 8 - CRC_BITS // 8
        if user[b] <= 0:
            raise ValueError("frame too small for this code")
    tb = user * 8 + CRC_BITS
    tb[0] = 0  # no frame is sent at 0 bits a symbol
    t = lambda a: torch.as_tensor(a, device=device)
    maxp = int(user.max())
    return Fec(code=code, max_ncws=int(ncws.max()), max_payload_bytes=maxp, max_frame_bits=cap * dsp.MAX_BPS,
               ncws=t(ncws), tb_bits=t(tb), user_bytes=user,
               crc=bt.crc_tables(bt.CRC32_FRAME, maxp + CRC_BITS // 8, torch.device(device)))


class _Sched(NamedTuple):
    k_prime: torch.Tensor
    cw_start: torch.Tensor
    sys_start: torch.Tensor
    real: torch.Tensor
    payload_bits: torch.Tensor


def _schedule(fec: Fec, bps: torch.Tensor) -> _Sched:
    bps = bps.long()
    ncws = fec.ncws[bps].long()
    P = fec.tb_bits[bps].long()
    i = torch.arange(fec.max_ncws, device=bps.device)[None, :]
    real = i < ncws[:, None]
    kp = torch.where(real, (P[:, None] - i + ncws[:, None] - 1) // ncws[:, None], 0)
    cw_len = torch.where(real, kp + fec.code.M, 0)
    return _Sched(kp, torch.cumsum(cw_len, 1) - cw_len, torch.cumsum(kp, 1) - kp, real, P)


def frame_build(fec: Fec, payload, payload_len, bps):
    """User bytes -> (frame bits [B, max_frame_bits] int32, header TB bits)."""
    B, dev = payload.shape[0], payload.device
    s = _schedule(fec, bps)
    C, code = fec.max_ncws, fec.code
    crc = bt.crc_device(F.pad(payload, (0, CRC_BITS // 8)), payload_len, fec.crc)
    pay_bits = bt.bytes_to_bits(payload)
    maxP = fec.max_payload_bytes * 8 + CRC_BITS
    x = torch.arange(maxP, device=dev)[None, :]
    Lb = payload_len.long()[:, None] * 8
    crc_at = (crc[:, None] >> torch.clamp(x - Lb, 0, 31)) & 1
    pay = F.pad(pay_bits, (0, max(0, maxP - pay_bits.shape[1])))[:, :maxP]
    tb = torch.where(x < Lb, pay.long(), torch.where(x < Lb + CRC_BITS, crc_at, 0)).int()
    t = torch.arange(code.K, device=dev)[None, None, :]
    idx = torch.clamp(s.sys_start[:, :, None] + t, 0, maxP - 1)
    msgs = torch.where(t < s.k_prime[:, :, None], torch.gather(tb[:, None, :].expand(B, C, maxP), 2, idx), 0)
    cws = encode(msgs.reshape(-1, code.K), code).reshape(B, C, code.N)
    j = torch.arange(code.N, device=dev)[None, None, :]
    send = (j < code.M + s.k_prime[:, :, None]) & s.real[:, :, None]
    maxF = fec.max_frame_bits
    pos = torch.where(send, s.cw_start[:, :, None] + j, maxF)
    out = torch.zeros((B, maxF + 1), dtype=torch.int32, device=dev)
    out.scatter_(1, pos.reshape(B, -1), cws.reshape(B, -1).int())
    return out[:, :maxF], (payload_len * 8 + CRC_BITS).int()


class FecOut(NamedTuple):
    payload: torch.Tensor
    payload_len: torch.Tensor
    crc_ok: torch.Tensor
    fec_ok: torch.Tensor
    avg_iters: torch.Tensor
    iters: torch.Tensor  # [B, max_ncws] BP updates of each codeword slot (0 for dummies)


def frame_decode(fec: Fec, llrs, bps, tb_payload_len) -> FecOut:
    """Frame LLRs [B, max_frame_bits] -> user bytes, checks and BP counts."""
    B, dev = llrs.shape[0], llrs.device
    s = _schedule(fec, bps)
    code, C = fec.code, fec.max_ncws
    p = torch.arange(code.N, device=dev)[None, None, :]
    is_par = p < code.M
    tsys = p - code.M
    sent = torch.where(is_par, True, tsys < s.k_prime[:, :, None]) & s.real[:, :, None]
    off = s.cw_start[:, :, None] + torch.where(is_par, p, code.M + tsys)
    cw = torch.gather(llrs.float(), 1, torch.clamp(off, 0, llrs.shape[1] - 1).reshape(B, -1)).reshape(B, C, code.N)
    cw = torch.where(sent, cw, SHORTENED_LLR)
    hard, iters, ok = decode(cw.reshape(-1, code.N), code)
    sys_bits = hard.reshape(B, C, code.N)[:, :, code.M:]
    iters, ok = iters.reshape(B, C), ok.reshape(B, C)
    fec_ok = (ok | ~s.real).all(1)
    avg = torch.where(s.real, iters, 0).sum(1) / torch.clamp(s.real.sum(1), min=1)
    maxP = fec.max_payload_bytes * 8 + CRC_BITS
    t = torch.arange(code.K, device=dev)[None, None, :]
    dst = torch.where((t < s.k_prime[:, :, None]) & s.real[:, :, None], s.sys_start[:, :, None] + t, maxP)
    tb = torch.zeros((B, maxP + 1), dtype=torch.int32, device=dev)
    tb.scatter_(1, dst.reshape(B, -1), sys_bits.reshape(B, -1))
    P = tb_payload_len.long()
    ub = (P - CRC_BITS) // 8
    allb = bt.bits_to_bytes(tb[:, :maxP])
    xb = torch.arange(allb.shape[1], device=dev)[None, :]
    payload = torch.where(xb < ub[:, None], allb, 0)
    n_len = fec.crc.T.shape[0]
    crc = bt.crc_device(payload, torch.clamp(torch.where(ub < 0, ub + n_len, ub), 0, n_len - 1), fec.crc)
    in_crc = (xb >= ub[:, None]) & (xb < ub[:, None] + 4)
    want = torch.where(in_crc, (crc[:, None] >> (torch.clamp(xb - ub[:, None], 0, 3) * 8)) & 0xFF, 0)
    crc_ok = (torch.where(in_crc, allb.long(), 0) == want).all(1)
    return FecOut(payload[:, :fec.max_payload_bytes], ub.int(), crc_ok & fec_ok, fec_ok, avg.float(),
                  torch.where(s.real, iters, 0))
