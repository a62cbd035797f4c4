"""FEC transport-block framing: LDPC-coded frames with shortening (port of
gr_dtl_tpu/models/fec_chain.py).

The transport math of the reference's FEC path:

- codewords per TB: ``ncws = 1 + group_bits // n`` when the frame group
  is larger than one codeword,
- the TB payload is split over codewords with balanced shortening,
  ``k'_i = ceil((P - i) / ncws)``,
- each codeword is transmitted as ``[m check bits | k'_i systematic
  bits]``; shortened systematic bits are never sent and are pinned at
  +SHORTENED_LLR on decode,
- the TB payload carries a CRC32.

A transport block fills exactly one group of W = ``tb_frames`` frames,
so a batch of groups is a batch of independent TBs: the codeword tensor
has the static shape ``[G, max_ncws, n]`` (unused trailing codewords of
low-bps frames are dummies pinned at +SHORTENED_LLR, which pass the
first syndrome check), and one batched BP call decodes them all.

Every config, one code or a bank, extracts codewords with the
reference's bank form: one per-frame gather from the frame bit stream
into the padded ``[parity: Mmax | sys: Kmax]`` layout, and reassembles
the payload with one scatter.  A single code is a bank of one, where
that layout is the code's own ``[m | k]``.  (The reference's single-code
path uses ``max_ncws`` static slices per bps and a select instead, a
TPU gather-avoidance giving the same values for constellations 1..4.)
On a GPU the extraction, group streams included, is one CUDA kernel
(``csrc/codewords.cu``, K10) whatever W and the bank; on the CPU the
plain gather.

:func:`tb_reassemble` (streaming reassembly keyed by the header's TB
number and offset) is the reference's ``lax.scan``, exact, for one ring
or a batch of S (a sharded session's streams): on a GPU two CUDA kernels
(``csrc/tb_ring.cu``) whatever S, on the CPU a Python loop over frames
with tensor state, ring by ring.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.ops import cw_cuda, gf2, ldpc, repack, tb_cuda
from gr_dtl_tpu_torch.utils import config as cfgmod
from gr_dtl_tpu_torch.utils import trace

__all__ = ["CRC_LEN_BITS", "BANK_MM_MAX_CODES", "FecFrameOut", "FecParams", "make_fec_tables",
           "build_fec", "fec_from_reference", "fec_frame_build", "fec_frame_decode",
           "codeword_llrs", "TbRing", "init_tb_state", "tb_reassemble", "decode_emitted"]

CRC_LEN_BITS = 32
# banks up to this many codes take the matmul-form bank decoder's
# contract (decode_bank_mm), larger banks the gather form (decode_bank);
# GR_DTL_TPU_BANK_MM_MAX, read at import, overrides it.  Its H100
# crossover is tools/bench_bank_switch's to measure (PERF.md).
BANK_MM_MAX_CODES = int(os.environ.get("GR_DTL_TPU_BANK_MM_MAX", "32"))


class FecFrameOut(NamedTuple):
    payload: torch.Tensor  # [B, max_payload_bytes] uint8 decoded user bytes
    payload_len: torch.Tensor  # [B] int32 user bytes
    crc_ok: torch.Tensor  # [B] bool
    fec_ok: torch.Tensor  # [B] bool: every real codeword converged
    avg_iters: torch.Tensor  # [B] float32 mean BP iterations over real codewords
    tb_payload_len: torch.Tensor  # [B] int32 bits


def make_fec_tables(cfg, H, tb_frames: int = 1) -> dict:
    """FEC-chain constants as numpy: the reference's ``build_fec`` dict.

    Args:
      H: one parity-check matrix, or a list of them (a code bank with
        1-based ids; a single H is the bank's code 1).
      tb_frames: frames per transport block (W); every table but
        ``frame_bits_tab`` is per W-frame group.
    """
    Hs = H if isinstance(H, (list, tuple)) else [H]
    bank = ldpc.build_ldpc_bank([np.asarray(h) for h in Hs])
    C = bank["n_codes"]
    cap_syms = cfg.frame_capacity_symbols
    W = int(tb_frames)
    max_frame_bits = cap_syms * cn.MAX_BPS
    frame_bits_tab = np.array([0] + [cap_syms * b for b in range(1, 5)], np.int32)
    group_bits_tab = W * frame_bits_tab
    ncws_tab2 = np.zeros((C + 1, 5), np.int32)
    tb_payload_tab2 = np.zeros((C + 1, 5), np.int32)
    user_bytes_tab2 = np.zeros((C + 1, 5), np.int32)
    for ci in range(1, C + 1):
        n_c = int(bank["n_tab"][ci])
        m_c = int(bank["m_tab"][ci])
        ncws_tab2[ci, 0] = 1
        for b in range(1, 5):
            gb = int(group_bits_tab[b])
            ncws = 1 + gb // n_c if gb > n_c else 1
            # user bytes: what is left after the check bits, byte-aligned,
            # less the CRC32
            user_bytes = (gb - ncws * m_c) // 8 - CRC_LEN_BITS // 8
            if user_bytes <= 0:
                raise ValueError("frame group too small for this code")
            ncws_tab2[ci, b] = ncws
            user_bytes_tab2[ci, b] = user_bytes
            tb_payload_tab2[ci, b] = user_bytes * 8 + CRC_LEN_BITS
    ncws_tab2[0] = ncws_tab2[1]
    tb_payload_tab2[0] = tb_payload_tab2[1]
    user_bytes_tab2[0] = user_bytes_tab2[1]
    max_payload_bytes = int(user_bytes_tab2.max())
    code = bank["codes"][0]
    return {
        "cfg": cfg, "bank": bank, "n_codes": C, "code": code,
        "n": code["N"], "k": code["K"], "m": code["M"], "W": W,
        "max_ncws": int(ncws_tab2.max()),
        "frame_bits_tab": frame_bits_tab, "group_bits_tab": group_bits_tab,
        "ncws_tab": ncws_tab2[1], "tb_payload_tab": tb_payload_tab2[1],
        "user_bytes_tab": user_bytes_tab2[1],
        "ncws_tab2": ncws_tab2, "tb_payload_tab2": tb_payload_tab2,
        "user_bytes_tab2": user_bytes_tab2,
        "max_payload_bytes": max_payload_bytes,
        "max_frame_bits": max_frame_bits, "max_group_bits": W * max_frame_bits,
        "crc_tables": gf2.make_crc_tables(gf2.CRC32_FRAME,
                                          max_payload_bytes + CRC_LEN_BITS // 8),
    }


@dataclasses.dataclass(frozen=True)
class FecParams:
    """FEC-chain constants on the device, plus host copies (numpy int32)
    of the two tables callers read to size their traffic."""

    cfg: cfgmod.OFDMConfig
    bank: ldpc.LdpcBank
    W: int
    max_ncws: int
    max_payload_bytes: int
    max_frame_bits: int
    max_group_bits: int
    ncws_tab2: np.ndarray  # [C+1, 5] codewords per (code id, bps), per W-frame group
    user_bytes_tab2: np.ndarray  # [C+1, 5] user bytes of a full transport block
    frame_bits_t: torch.Tensor  # [5] bits of one frame per bps
    m_t: torch.Tensor  # [C+1] check bits per code id
    ncws_t: torch.Tensor  # ncws_tab2
    tb_payload_t: torch.Tensor  # [C+1, 5] TB payload bits (user bytes + CRC32)
    crc_tables: gf2.CrcTables

    @property
    def n_codes(self) -> int:
        return self.bank.n_codes

    @property
    def code(self) -> ldpc.LdpcCode:
        return self.bank.codes[0]

    @property
    def n(self) -> int:
        return self.code.N

    @property
    def k(self) -> int:
        return self.code.K

    @property
    def m(self) -> int:
        return self.code.M

    @property
    def user_bytes_tab(self) -> np.ndarray:
        return self.user_bytes_tab2[1]


def fec_from_reference(d, device) -> FecParams:
    """:class:`FecParams` on ``device`` from a ``build_fec`` dict (the
    reference's, or :func:`make_fec_tables`'), leaves as numpy arrays."""
    i32 = lambda a: np.asarray(a, np.int32)
    ncws = i32(d["ncws_tab2"])
    t = lambda a: torch.as_tensor(a, device=device)
    return FecParams(
        cfg=cfgmod.config_from_reference(d["cfg"]),
        bank=ldpc.bank_from_reference(d["bank"], device),
        W=int(d["W"]), max_ncws=int(d["max_ncws"]), max_payload_bytes=int(d["max_payload_bytes"]),
        max_frame_bits=int(d["max_frame_bits"]), max_group_bits=int(d["max_group_bits"]),
        ncws_tab2=ncws, user_bytes_tab2=i32(d["user_bytes_tab2"]),
        frame_bits_t=t(i32(d["frame_bits_tab"])), m_t=t(i32(d["bank"]["m_tab"])),
        ncws_t=t(ncws), tb_payload_t=t(i32(d["tb_payload_tab2"])),
        crc_tables=gf2.crc_tables_from_reference(d["crc_tables"], device))


def build_fec(cfg, H, device, tb_frames: int = 1) -> FecParams:
    """All FEC-chain constants for a config and parity matrix (or a list
    of them: a code bank), on ``device``."""
    return fec_from_reference(make_fec_tables(cfg, H, tb_frames), device)


class _Schedule(NamedTuple):
    k_prime: torch.Tensor  # [G, Cmax]
    cw_start: torch.Tensor  # [G, Cmax] bit offset of each codeword in the group
    sys_start: torch.Tensor  # [G, Cmax] bit offset of its systematic bits in the TB payload
    real: torch.Tensor  # [G, Cmax] bool
    payload_bits: torch.Tensor  # [G]
    m: torch.Tensor  # [G] check bits


def _cw_schedule(fec: FecParams, bps: torch.Tensor, fec_id: torch.Tensor | None = None):
    """Per-group codeword schedule from each group's bps and code id
    (None = code 1)."""
    fid = torch.ones_like(bps) if fec_id is None else fec_id.long()
    bps = bps.long()
    m = fec.m_t[fid].long()
    ncws = fec.ncws_t[fid, bps].long()
    P = fec.tb_payload_t[fid, bps].long()
    i = torch.arange(fec.max_ncws, device=bps.device)[None, :]
    real = i < ncws[:, None]
    k_prime = torch.where(real, (P[:, None] - i + ncws[:, None] - 1) // ncws[:, None], 0)
    cw_len = torch.where(real, k_prime + m[:, None], 0)
    return _Schedule(k_prime=k_prime, cw_start=torch.cumsum(cw_len, 1) - cw_len,
                     sys_start=torch.cumsum(k_prime, 1) - k_prime, real=real,
                     payload_bits=P, m=m)


def _bps(cnst_id: torch.Tensor) -> torch.Tensor:
    return cn.active(cnst_id.device).bps[cnst_id.long()]


def fec_frame_build(fec: FecParams, payload: torch.Tensor, payload_len: torch.Tensor,
                    cnst_id: torch.Tensor, fec_id: torch.Tensor | None = None):
    """TX: user bytes -> frame bit stream (LDPC-coded, shortened).

    Args:
      payload:     [B, max_payload_bytes] uint8, zero beyond payload_len.
                   The codeword schedule always fills the frame (group).
      payload_len: [B] user bytes.
      cnst_id:     [B] constellation.  With W > 1 rows are grouped W at
                   a time: row g*W gives the group's payload, length and
                   constellation.
      fec_id:      optional [B] 1-based code ids; None = code 1.
    Returns (frame_bits [B, max_frame_bits] int32, tb_payload_len [B]
    int32: the payload bits + CRC32 announced in the header).
    """
    W = fec.W
    B = payload.shape[0]
    dev = payload.device
    if B % W:
        raise ValueError(f"batch {B} is not a multiple of tb_frames {W}")
    if W > 1:
        payload, payload_len, cnst_id = payload[::W], payload_len[::W], cnst_id[::W]
        if fec_id is not None:
            fec_id = fec_id[::W]
    G = payload.shape[0]
    bps = _bps(cnst_id)
    s = _cw_schedule(fec, bps, fec_id)
    Cmax = fec.max_ncws

    # TB payload bits: [payload bytes | crc32], LSB first
    crc = gf2.crc_device(F.pad(payload, (0, CRC_LEN_BITS // 8)), payload_len, fec.crc_tables)
    pay_bits = repack.bytes_to_bits(payload)
    maxP = fec.max_payload_bytes * 8 + CRC_LEN_BITS
    x = torch.arange(maxP, device=dev)[None, :]
    Lbits = payload_len.long()[:, None] * 8
    crc_at_x = (crc[:, None] >> torch.clamp(x - Lbits, 0, 31)) & 1
    pay_fit = F.pad(pay_bits, (0, max(0, maxP - pay_bits.shape[1])))[:, :maxP]
    tb_bits = torch.where(x < Lbits, pay_fit.long(),
                          torch.where(x < Lbits + CRC_LEN_BITS, crc_at_x, 0)).int()

    if fec_id is None:
        k_sys = fec.k
    else:
        bank = fec.bank
        k_sys = bank.Kmax
    # per-codeword systematic messages [G, Cmax, k_sys]
    t = torch.arange(k_sys, device=dev)[None, None, :]
    sys_idx = torch.clamp(s.sys_start[:, :, None] + t, 0, maxP - 1)
    msgs = torch.gather(tb_bits[:, None, :].expand(G, Cmax, maxP), 2, sys_idx)
    msgs = torch.where(t < s.k_prime[:, :, None], msgs, 0)
    if fec_id is None:
        tx_cws = ldpc.encode(msgs.reshape(-1, k_sys), fec.code).reshape(G, Cmax, fec.n)
        m_col = fec.m
    else:
        cws = ldpc.encode_bank(msgs.reshape(-1, k_sys), fec_id.repeat_interleave(Cmax), bank)
        cws = cws.reshape(G, Cmax, bank.Nmax)
        # transmitted view [m_b checks | k' systematic]: tx bit j <- padded
        # slot (j if j < m_b else Mmax + j - m_b)
        jj = torch.arange(bank.Nmax, device=dev)[None, None, :]
        m_b = s.m[:, None, None]
        src = torch.where(jj < m_b, jj, torch.clamp(bank.Mmax + jj - m_b, 0, bank.Nmax - 1))
        tx_cws = torch.gather(cws, 2, src.expand(G, Cmax, bank.Nmax))
        m_col = s.m[:, None, None]

    # scatter the sent bits [m | k'] into the group stream; unsent bits all
    # go to the parked column maxG, which is dropped (so the undefined
    # order of duplicate indices there is harmless)
    n_tx = tx_cws.shape[2]
    j = torch.arange(n_tx, device=dev)[None, None, :]
    send = (j < m_col + s.k_prime[:, :, None]) & s.real[:, :, None]
    maxG = fec.max_group_bits
    pos = torch.where(send, s.cw_start[:, :, None] + j, maxG)
    group_bits = torch.zeros((G, maxG + 1), dtype=torch.int32, device=dev)
    group_bits.scatter_(1, pos.reshape(G, -1), tx_cws.reshape(G, -1).int())
    group_bits = group_bits[:, :maxG]
    # the header carries the ACTUAL payload bits (user bytes + CRC32)
    actual_tb = (payload_len * 8 + CRC_LEN_BITS).int()
    if W == 1:
        return group_bits, actual_tb
    # frame f of group g carries group bits [f*fb, (f+1)*fb), fb = cap*bps
    maxF = fec.max_frame_bits
    fb = fec.frame_bits_t[bps].long()
    f = torch.arange(W, device=dev)[None, :, None]
    x = torch.arange(maxF, device=dev)[None, None, :]
    src = torch.clamp(f * fb[:, None, None] + x, 0, maxG - 1)
    frame_bits = torch.gather(group_bits[:, None, :].expand(G, W, maxG), 2, src)
    frame_bits = torch.where(x < fb[:, None, None], frame_bits, 0)
    return frame_bits.reshape(G * W, maxF), actual_tb.repeat_interleave(W)


def _group_llrs(fec: FecParams, llrs: torch.Tensor, bps: torch.Tensor):
    """W > 1: the group LLR streams of W consecutive frames [G, maxG] (bps:
    each group's bits a symbol)."""
    W = fec.W
    G = llrs.shape[0] // W
    maxF = llrs.shape[1]
    fb = fec.frame_bits_t[bps].long()
    y = torch.arange(fec.max_group_bits, device=llrs.device)[None, :]
    f = torch.clamp(y // torch.clamp(fb[:, None], min=1), 0, W - 1)
    x = y - f * fb[:, None]
    src = torch.clamp(f * maxF + x, 0, W * maxF - 1)
    group = torch.gather(llrs.reshape(G, W * maxF), 1, src)
    return torch.where(y < W * fb[:, None], group, 0.0)


def _extract_torch(fec: FecParams, llrs: torch.Tensor, bps: torch.Tensor, s: _Schedule) -> torch.Tensor:
    """The codeword LLRs [G, Cmax, Nmax] of the frames' LLR rows [G W,
    max_frame_bits] in plain PyTorch, on any device: the group streams
    (W > 1), then one gather of every padded slot and the pin."""
    if fec.W > 1:
        llrs = _group_llrs(fec, llrs, bps)
    G = llrs.shape[0]
    # padded slot p maps to frame bit cw_start + p (parity, sent iff
    # p < m_b) or cw_start + m_b + (p - Mmax) (systematic, sent iff
    # p - Mmax < k'); everything unsent, dummy codewords included, is
    # pinned shortened
    bank = fec.bank
    p = torch.arange(bank.Nmax, device=llrs.device)[None, None, :]
    m_b = s.m[:, None, None]
    is_par = p < bank.Mmax
    tsys = p - bank.Mmax
    sent = torch.where(is_par, p < m_b, tsys < s.k_prime[:, :, None]) & s.real[:, :, None]
    off = s.cw_start[:, :, None] + torch.where(is_par, p, m_b + tsys)
    pos = torch.clamp(off, 0, llrs.shape[1] - 1)
    cw = torch.gather(llrs.float(), 1, pos.reshape(G, -1)).reshape(G, fec.max_ncws, bank.Nmax)
    return torch.where(sent, cw, ldpc.SHORTENED_LLR)


def _extract(fec: FecParams, llrs: torch.Tensor, bps: torch.Tensor, s: _Schedule) -> torch.Tensor:
    """:func:`_extract_torch`'s codeword LLRs: on CUDA tensors one launch of
    K10 (``ops/cw_cuda.codewords_cuda``, bit-equal to the plain chain on
    the card), counted in the trace counter ``fec.decode.cw_kernel_groups``;
    CPU tensors take the plain chain."""
    if llrs.device.type == "cuda":
        cw = cw_cuda.codewords_cuda(llrs, fec.W, bps, fec.frame_bits_t, s.m, s.k_prime, s.cw_start, s.real,
                                    fec.bank.Mmax, fec.bank.Nmax, ldpc.SHORTENED_LLR)
        trace.count("fec.decode.cw_kernel_groups", cw.shape[0])
        return cw
    return _extract_torch(fec, llrs, bps, s)


def _codewords(fec: FecParams, llrs, cnst_id, tb_payload_len, fec_id):
    """Group regrouping, schedule and codeword extraction: (cw_llrs [G,
    Cmax, Nmax], schedule, group-level tb_payload_len and fec_id)."""
    W = fec.W
    B = llrs.shape[0]
    if llrs.shape[1] != fec.max_frame_bits:
        raise ValueError(f"llrs must be [B, {fec.max_frame_bits}], got {tuple(llrs.shape)}")
    if B % W:
        raise ValueError(f"batch {B} is not a multiple of tb_frames {W}")
    if W > 1:
        cnst_id = cnst_id[::W]
        if fec_id is not None:
            fec_id = fec_id[::W]
        if tb_payload_len is not None:
            tb_payload_len = tb_payload_len[::W]
    bps = _bps(cnst_id)
    s = _cw_schedule(fec, bps, fec_id)
    return _extract(fec, llrs, bps, s), s, tb_payload_len, fec_id


def codeword_llrs(fec: FecParams, llrs: torch.Tensor, cnst_id: torch.Tensor,
                  fec_id: torch.Tensor | None = None) -> torch.Tensor:
    """The BP decoder's input of :func:`fec_frame_decode`: [G, max_ncws,
    Nmax] codeword LLRs (Nmax = n for a single code)."""
    return _codewords(fec, llrs, cnst_id, None, fec_id)[0]


def _index_like_jax(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Table row of a length read from a header: a negative index counts
    from the end and an out-of-range one clamps, as jnp indexing does."""
    return torch.clamp(torch.where(idx < 0, idx + size, idx), 0, size - 1)


@trace.spanned("fec.decode")
def fec_frame_decode(fec: FecParams, llrs: torch.Tensor, cnst_id: torch.Tensor,
                     tb_payload_len: torch.Tensor | None = None,
                     fec_id: torch.Tensor | None = None) -> FecFrameOut:
    """RX: per-frame LLR stream -> decoded user bytes.

    Args:
      llrs:    [B, max_frame_bits] float32 LLRs in frame bit order (LLR >
               0 <=> bit 0); entries beyond the frame's bit count are ignored.
      cnst_id: [B] constellation of each frame, 1..4 (the receiver never
               passes another; for 0 the reference's single-code path reads
               the bps-4 layout while its schedule is bps 0's, and this
               port follows the schedule).
      tb_payload_len: [B] bits from the header; defaults to the full-frame
               value for the bps.
      fec_id:  optional [B] 1-based code ids; None = code 1.

    Spans (``utils/trace``): ``fec.decode`` with ``fec.decode.codewords``,
    ``fec.decode.bp`` (the BP kernel's call) and ``fec.decode.reassemble``
    inside; counters ``fec.codeword_slots`` (decoded slots),
    ``fec.codewords`` (the real codewords among them),
    ``fec.bp_updates`` (the message updates BP took on the real ones) and,
    on the card, ``fec.decode.cw_kernel_groups`` (the groups whose
    codewords K10 extracted).
    """
    with trace.span("fec.decode.codewords"):
        cw, s, tb_payload_len, fec_id = _codewords(fec, llrs, cnst_id, tb_payload_len, fec_id)
    G, Cmax = cw.shape[:2]
    bank = fec.bank
    with trace.span("fec.decode.bp"):
        if fec_id is None:
            bits, iters, ok = ldpc.decode_mm(cw.reshape(-1, fec.n), fec.code)
        else:
            dec = ldpc.decode_bank_mm if bank.n_codes <= BANK_MM_MAX_CODES else ldpc.decode_bank
            bits, iters, ok = dec(cw.reshape(-1, bank.Nmax), fec_id.repeat_interleave(Cmax), bank)
    iters = iters.reshape(G, Cmax)
    if trace.enabled():
        trace.count("fec.codeword_slots", G * Cmax)
        trace.count("fec.codewords", s.real.sum())
        trace.count("fec.bp_updates", torch.where(s.real, iters, 0).sum())
    with trace.span("fec.decode.reassemble"):
        return _reassemble(fec, llrs.device, llrs.shape[0], bits, iters, ok, s, tb_payload_len)


def _reassemble(fec: FecParams, dev, B: int, bits, iters, ok, s: _Schedule,
                tb_payload_len) -> FecFrameOut:
    """The TB payload of each group from its codewords' hard bits, the
    user bytes, the CRC32 verdict and the BP summary (per frame for W > 1)."""
    W = fec.W
    G, Cmax = iters.shape
    bank = fec.bank
    sys_bits = bits.reshape(G, Cmax, bank.Nmax)[:, :, bank.Mmax:]
    ok = ok.reshape(G, Cmax)
    fec_ok = (ok | ~s.real).all(1)
    avg_iters = torch.where(s.real, iters, 0).sum(1) / torch.clamp(s.real.sum(1), min=1)

    # TB payload bits from the systematic parts; unsent slots all scatter
    # to the dropped column maxP
    maxP = fec.max_payload_bytes * 8 + CRC_LEN_BITS
    t = torch.arange(bank.Kmax, device=dev)[None, None, :]
    take = (t < s.k_prime[:, :, None]) & s.real[:, :, None]
    dst = torch.where(take, s.sys_start[:, :, None] + t, maxP)
    tb = torch.zeros((G, maxP + 1), dtype=torch.int32, device=dev)
    tb.scatter_(1, dst.reshape(G, -1), sys_bits.reshape(G, -1))
    tb_bits = tb[:, :maxP]

    P = (s.payload_bits if tb_payload_len is None else tb_payload_len).long()
    user_bytes = (P - CRC_LEN_BITS) // 8
    all_bytes = repack.bits_to_bytes(tb_bits)  # [G, maxP/8]
    xb = torch.arange(all_bytes.shape[1], device=dev)[None, :]
    ub = user_bytes[:, None]
    payload = torch.where(xb < ub, all_bytes, 0)
    crc = gf2.crc_device(payload, _index_like_jax(user_bytes, fec.crc_tables.T.shape[0]),
                         fec.crc_tables)
    # received CRC: the 4 bytes at user_bytes, compared byte by byte
    in_crc = (xb >= ub) & (xb < ub + 4)
    want = torch.where(in_crc, (crc[:, None] >> (torch.clamp(xb - ub, 0, 3) * 8)) & 0xFF, 0)
    got = torch.where(in_crc, all_bytes.long(), 0)
    crc_ok = (got == want).all(1)

    out = FecFrameOut(payload=payload[:, : fec.max_payload_bytes], payload_len=user_bytes.int(),
                      crc_ok=crc_ok & fec_ok, fec_ok=fec_ok, avg_iters=avg_iters.float(),
                      tb_payload_len=P.int())
    if W == 1:
        return out
    # per-frame rows: the group's payload goes to its first frame; the
    # other W-1 rows carry zero-length payloads and the group's flags
    first = (torch.arange(B, device=dev) % W) == 0
    rep = lambda a: a.repeat_interleave(W, dim=0)
    return FecFrameOut(
        payload=torch.where(first[:, None], rep(out.payload), 0),
        payload_len=torch.where(first, rep(out.payload_len), 0),
        crc_ok=rep(out.crc_ok), fec_ok=rep(out.fec_ok), avg_iters=rep(out.avg_iters),
        tb_payload_len=rep(out.tb_payload_len))


# ---------------------------------------------------------------------------
# streaming TB reassembly
# ---------------------------------------------------------------------------

class TbRing(NamedTuple):
    """The transport block under reassembly, keyed by the header's
    ``tb_no``, slots addressed by the header's ``tb_offset``."""

    tb_no: torch.Tensor  # int32 scalar, -1 = nothing buffered yet
    llrs: torch.Tensor  # [W, max_frame_bits] float32 per-slot LLRs
    present: torch.Tensor  # [W] bool slot-received mask
    cnst: torch.Tensor  # int32 TB constellation
    plen: torch.Tensor  # int32 TB payload bits (header fec_tb_payload)
    fec_id: torch.Tensor  # int32 1-based LDPC code id


def init_tb_state(fec: FecParams, device, batch: tuple = ()) -> TbRing:
    """An empty ring on ``device``; with ``batch`` = (S,), S of them."""
    batch = tuple(batch)
    i32 = lambda v: torch.full(batch, v, dtype=torch.int32, device=device)
    return TbRing(tb_no=i32(-1),
                  llrs=torch.zeros(batch + (fec.W, fec.max_frame_bits), dtype=torch.float32,
                                   device=device),
                  present=torch.zeros(batch + (fec.W,), dtype=torch.bool, device=device),
                  cnst=i32(1), plen=i32(0), fec_id=i32(1))


@trace.spanned("fec.tb_ring")
def tb_reassemble(state: TbRing, llrs: torch.Tensor, tb_no: torch.Tensor,
                  tb_offset: torch.Tensor, cnst_id: torch.Tensor, tb_payload: torch.Tensor,
                  fec_id: torch.Tensor, ok: torch.Tensor, fec: FecParams):
    """Loss-resilient streaming TB reassembly keyed by the header fields.

    Frames in stream order: every header-valid frame writes its LLRs
    into slot ``tb_offset // frame_bits`` of the buffer for its
    ``tb_no``; a frame announcing a NEW tb_no emits the previous buffer
    (slots never received stay at LLR 0 = erasure).  Header-invalid
    frames change nothing.  S rings at once take every argument with a
    leading [S] (the state's scalars [S]).  On a GPU the two CUDA kernels
    of ``csrc/tb_ring.cu`` (``ops/tb_cuda``), two launches whatever F and S;
    on the CPU a plain loop over the frames, ring by ring.  Span
    ``fec.tb_ring``.

    Args:
      state: TbRing from the previous batch.
      llrs:  [F, max_frame_bits] per-frame LLR streams.
      tb_no/tb_offset/cnst_id/tb_payload/fec_id: [F] header fields.
      ok:    [F] bool, header CRC ok (gates everything).
    Returns (state', emitted): ``llrs`` [F, W, maxF], ``cnst``/``plen``/
    ``fec_id``/``tb_no`` [F], ``valid`` [F] (a finished TB was emitted at
    this position).
    """
    if llrs.device.type != "cuda":
        if llrs.ndim == 2:
            return _tb_reassemble_torch(state, llrs, tb_no, tb_offset, cnst_id, tb_payload,
                                        fec_id, ok, fec)
        per = [_tb_reassemble_torch(TbRing(*(a[s] for a in state)), llrs[s], tb_no[s],
                                    tb_offset[s], cnst_id[s], tb_payload[s], fec_id[s], ok[s], fec)
               for s in range(llrs.shape[0])]
        new = TbRing(*(torch.stack(list(col)) for col in zip(*(p[0] for p in per))))
        return new, {k: torch.stack([p[1][k] for p in per]) for k in per[0][1]}
    # a CUDA tensor takes the kernels or raises
    frame_bits_of_cnst = fec.cfg.frame_capacity_symbols * cn.BITS_PER_SYMBOL[:5]
    new, emitted = tb_cuda.tb_reassemble_cuda(
        tuple(state), llrs.contiguous(),
        *(a.int().contiguous() for a in (tb_no, tb_offset, cnst_id, tb_payload, fec_id)),
        ok.contiguous(), frame_bits_of_cnst)
    return TbRing(*new), emitted


def _tb_reassemble_torch(state: TbRing, llrs: torch.Tensor, tb_no: torch.Tensor,
                         tb_offset: torch.Tensor, cnst_id: torch.Tensor, tb_payload: torch.Tensor,
                         fec_id: torch.Tensor, ok: torch.Tensor, fec: FecParams):
    """:func:`tb_reassemble` as a loop over the frames with tensor state:
    the reference's ``lax.scan``, exact."""
    W = fec.W
    dev = llrs.device
    bps_tab = cn.active(dev).bps
    slots = torch.arange(W, device=dev)
    tb_no, tb_offset, cnst_id, tb_payload, fec_id = (
        a.int() for a in (tb_no, tb_offset, cnst_id, tb_payload, fec_id))
    out = []
    st = state
    for i in range(llrs.shape[0]):
        ok_i, tb_i = ok[i], tb_no[i]
        is_new = ok_i & (tb_i != st.tb_no)
        out.append((st.llrs, st.cnst, st.plen, st.fec_id, st.tb_no, is_new & (st.tb_no >= 0)))
        # a new tb_no starts a fresh buffer (stale slots erased)
        tbno = torch.where(is_new, tb_i, st.tb_no)
        # slot from the announced offset; W == 1 has one slot
        fb = fec.frame_bits_t[bps_tab[torch.clamp(cnst_id[i], 0, 4).long()]]
        slot = torch.clamp(torch.div(tb_offset[i], torch.clamp(fb, min=1), rounding_mode="floor"),
                           0, W - 1)
        write = (slots == (0 if W == 1 else slot)) & ok_i & (tb_i == tbno)
        st = TbRing(
            tb_no=tbno,
            llrs=torch.where(write[:, None], llrs[i][None, :],
                             torch.where(is_new, 0.0, st.llrs)),
            present=write | (st.present & ~is_new),
            cnst=torch.where(is_new, cnst_id[i], st.cnst),
            plen=torch.where(is_new, tb_payload[i], st.plen),
            fec_id=torch.where(is_new, fec_id[i], st.fec_id))
    if not out:
        e = lambda a: a[None][:0]
        return st, {"llrs": e(st.llrs), "cnst": e(st.cnst), "plen": e(st.plen),
                    "fec_id": e(st.fec_id), "tb_no": e(st.tb_no),
                    "valid": torch.zeros(0, dtype=torch.bool, device=dev)}
    cols = [torch.stack(c) for c in zip(*out)]
    return st, dict(zip(("llrs", "cnst", "plen", "fec_id", "tb_no", "valid"), cols))


@trace.spanned("fec.tb_decode")
def decode_emitted(fec: FecParams, emitted) -> FecFrameOut:
    """Decode reassembled TB buffers from :func:`tb_reassemble`: one row
    per emitted slot (not per frame).  Rows where ``emitted['valid']`` is
    False are decoded as dummies; their ``crc_ok`` is False.

    Span ``fec.tb_decode`` (``fec.decode`` inside); counters ``fec.tb_rows``
    (the rows decoded) and ``fec.tbs`` (the real TBs among them)."""
    Fn, W, maxF = emitted["llrs"].shape
    if trace.enabled():
        trace.count("fec.tb_rows", Fn)
        trace.count("fec.tbs", emitted["valid"].sum())
    rep = lambda a: torch.clamp(a, min=1).repeat_interleave(W)
    fid = rep(emitted["fec_id"]) if fec.n_codes > 1 else None
    out = fec_frame_decode(
        fec, emitted["llrs"].reshape(Fn * W, maxF), rep(emitted["cnst"]),
        torch.clamp(emitted["plen"], min=CRC_LEN_BITS + 8).repeat_interleave(W), fec_id=fid)
    take = slice(None, None, W)
    return FecFrameOut(payload=out.payload[take], payload_len=out.payload_len[take],
                       crc_ok=out.crc_ok[take] & emitted["valid"], fec_ok=out.fec_ok[take],
                       avg_iters=out.avg_iters[take], tb_payload_len=out.tb_payload_len[take])
