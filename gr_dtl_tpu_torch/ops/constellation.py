"""Constellation tables, mapping, hard decision and max-log soft LLRs
(port of gr_dtl_tpu/ops/constellation.py).

Every constellation lives in one padded ``[n_types, 16]`` table, so a
batch of frames with different per-frame constellations is mapped with
one gather and decided with closed-form Gray slicers, with no control
flow.  Ids match the reference enum: UNKNOWN=0, BPSK=1, QPSK=2, PSK8=3,
QAM16=4.  Scalings: BPSK +-1, QPSK scaled by 0.5 ("normalized"), 8PSK
on the unit circle, 16QAM on the +-1/+-3 grid scaled by 1/sqrt(10).

The wire-compat table mode (foreign label layouts) is not ported yet.
"""

from __future__ import annotations

import enum
import functools
import math

import numpy as np
import torch

__all__ = [
    "ConstellationType",
    "N_TYPES",
    "MAX_POINTS",
    "MAX_BPS",
    "POINTS",
    "BITS_PER_SYMBOL",
    "VALID_MASK",
    "map_symbols",
    "hard_decision",
    "nearest_point",
    "nearest_point_table",
    "soft_llrs",
    "soft_llrs_table",
]


class ConstellationType(enum.IntEnum):
    UNKNOWN = 0
    BPSK = 1
    QPSK = 2
    PSK8 = 3
    QAM16 = 4


N_TYPES = 5
MAX_POINTS = 16
MAX_BPS = 4

_SQ2 = np.sqrt(2.0) / 2.0


def _build_tables():
    pts = np.zeros((N_TYPES, MAX_POINTS), dtype=np.complex64)
    bps = np.zeros((N_TYPES,), dtype=np.int32)

    # BPSK: 0 -> -1, 1 -> +1
    pts[1, 0] = -1.0
    pts[1, 1] = 1.0
    pts[1, 2:] = pts[1, (np.arange(2, MAX_POINTS) % 2)]
    bps[1] = 1

    # QPSK (normalized x0.5): Gray, b0 -> I, b1 -> Q
    for s in range(4):
        i = 1.0 if s & 1 else -1.0
        q = 1.0 if s & 2 else -1.0
        pts[2, s] = 0.5 * (_SQ2 * i + 1j * _SQ2 * q)
    pts[2, 4:] = pts[2, np.arange(4, MAX_POINTS) % 4]
    bps[2] = 2

    # 8PSK: Gray-coded around the circle
    gray3 = [0, 1, 3, 2, 6, 7, 5, 4]
    for pos, sym in enumerate(gray3):
        ang = 2 * np.pi * pos / 8
        pts[3, sym] = np.cos(ang) + 1j * np.sin(ang)
    pts[3, 8:] = pts[3, np.arange(8, MAX_POINTS) % 8]
    bps[3] = 3

    # 16QAM: Gray per axis, level 1/sqrt(10): I from bits (b0,b1), Q from (b2,b3)
    level = 1.0 / np.sqrt(10.0)
    gray2 = {0: -3.0, 1: -1.0, 3: 1.0, 2: 3.0}
    for s in range(16):
        pts[4, s] = level * (gray2[s & 3] + 1j * gray2[(s >> 2) & 3])
    bps[4] = 4

    valid = np.zeros((N_TYPES, MAX_POINTS), dtype=bool)
    for ty in range(1, N_TYPES):
        valid[ty, : 1 << bps[ty]] = True
    return pts, bps, valid


POINTS, BITS_PER_SYMBOL, VALID_MASK = _build_tables()
# bit k of point label p, per type: [N_TYPES, MAX_POINTS, MAX_BPS] (soft demap)
BIT_VALUES = np.broadcast_to(
    ((np.arange(MAX_POINTS)[None, :, None] >> np.arange(MAX_BPS)[None, None, :]) & 1
     ).astype(np.float32), (N_TYPES, MAX_POINTS, MAX_BPS)).copy()


@functools.lru_cache(maxsize=None)
def tables(device: torch.device):
    """(POINTS, BITS_PER_SYMBOL, VALID_MASK) as tensors on ``device``
    (complex64, int64, bool), made once per device."""
    return (torch.as_tensor(POINTS, device=device),
            torch.as_tensor(BITS_PER_SYMBOL, device=device).long(),
            torch.as_tensor(VALID_MASK, device=device))


def _expand_to(x: torch.Tensor, target_shape) -> torch.Tensor:
    """Right-pad x with singleton dims, then broadcast to target_shape."""
    while x.ndim < len(target_shape):
        x = x[..., None]
    return x.expand(target_shape)


def map_symbols(sym_idx: torch.Tensor, cnst_id: torch.Tensor) -> torch.Tensor:
    """Map integer symbols to complex points.

    Args:
      sym_idx: [..., n] integer symbol indices (0 .. 2^bps-1).
      cnst_id: per-frame constellation ids, broadcastable to sym_idx's
               batch dims (constant along the symbol axis).
    Returns complex64 points, same shape as sym_idx.
    """
    pts, _, _ = tables(sym_idx.device)
    cid = _expand_to(cnst_id, sym_idx.shape).long()
    return pts[cid, sym_idx.long()]


def nearest_point(y: torch.Tensor, cnst_id: torch.Tensor):
    """Fused decision: (symbol index int32, decided point complex64).

    Closed form: BPSK/QPSK by sign, 16QAM by per-axis 4-level
    quantization, 8PSK by phase sector; QAM axis labels and 8PSK ring
    labels are Gray codes, so label = ``u ^ (u >> 1)``.  Matches the
    table argmin (:func:`nearest_point_table`) everywhere but on exact
    decision boundaries.
    """
    cid = _expand_to(cnst_id, y.shape)
    re = y.real
    im = y.imag
    pos_re = re > 0
    pos_im = im > 0

    # BPSK: -1 / +1
    b_bit = pos_re.int()
    b_pt = torch.complex(torch.where(pos_re, 1.0, -1.0), torch.zeros_like(re))

    # QPSK (normalized x0.5): +-0.5*sqrt(2)/2 per axis
    q_idx = b_bit + 2 * pos_im.int()
    qs = float(np.float32(0.5 * _SQ2))
    q_pt = torch.complex(torch.where(pos_re, qs, -qs), torch.where(pos_im, qs, -qs))

    # 8PSK: phase sector, ring labels Gray-coded.  `%` on an integer
    # tensor is Python's (floor) modulo, like jnp: -1 % 8 == 7.
    ang = torch.atan2(im, re)  # [-pi, pi]
    pos = torch.round(ang * (4.0 / math.pi)).int() % 8
    p_idx = pos ^ (pos >> 1)
    pang = pos.float() * (math.pi / 4.0)
    p_pt = torch.complex(torch.cos(pang), torch.sin(pang))

    # 16QAM: per-axis levels {-3,-1,1,3}/sqrt(10), Gray per axis; the
    # level is float32 arithmetic, as in the reference
    lvl = np.float32(1.0) / np.sqrt(np.float32(10.0))
    two_l = float(np.float32(2.0) * lvl)
    lvl = float(lvl)
    u = torch.clamp(torch.floor(re / two_l + 2.0), 0, 3).int()
    v = torch.clamp(torch.floor(im / two_l + 2.0), 0, 3).int()
    m_idx = (u ^ (u >> 1)) + 4 * (v ^ (v >> 1))
    m_pt = torch.complex(lvl * (2 * u - 3).float(), lvl * (2 * v - 3).float())

    is_q = cid == int(ConstellationType.QPSK)
    is_p = cid == int(ConstellationType.PSK8)
    is_m = cid == int(ConstellationType.QAM16)
    idx = torch.where(is_q, q_idx, torch.where(is_p, p_idx, torch.where(is_m, m_idx, b_bit)))
    point = torch.where(is_q, q_pt, torch.where(is_p, p_pt, torch.where(is_m, m_pt, b_pt)))
    return idx.int(), point


def hard_decision(y: torch.Tensor, cnst_id: torch.Tensor) -> torch.Tensor:
    """Nearest-point symbol indices (int32), vectorized over a mixed batch.

    Args:
      y:       [..., n] complex received symbols.
      cnst_id: per-frame constellation ids broadcastable to y's batch dims.
    """
    return nearest_point(y, cnst_id)[0]


def nearest_point_table(y: torch.Tensor, cnst_id: torch.Tensor):
    """Table-reduction nearest-point decision: the oracle for
    :func:`nearest_point` (distance to every valid point, first argmin)."""
    pts_t, _, valid_t = tables(y.device)
    cid = _expand_to(cnst_id, y.shape)[..., 0].long()  # per-frame rows
    pts = pts_t[cid]  # [batch..., P]
    ok = valid_t[cid]
    dr = y.real[..., None] - pts.real[..., None, :]
    di = y.imag[..., None] - pts.imag[..., None, :]
    d2 = torch.where(ok[..., None, :], dr * dr + di * di, math.inf)
    idx = torch.argmin(d2, dim=-1)  # first minimum, as jnp.argmin
    point = torch.gather(pts[..., None, :].expand(d2.shape), -1, idx[..., None])[..., 0]
    return idx.int(), point


def _build_psk8_masks():
    """cos/sin of the 8 ring angles and the bit values of the symbol at
    each ring position ([8, 3] bool)."""
    gray3 = [0, 1, 3, 2, 6, 7, 5, 4]  # symbol at ring position p
    ang = 2 * np.pi * np.arange(8) / 8
    bit = np.zeros((8, 3), dtype=bool)
    for p, s in enumerate(gray3):
        for k in range(3):
            bit[p, k] = (s >> k) & 1
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32), bit


_PSK8_COS, _PSK8_SIN, _PSK8_BIT = _build_psk8_masks()
# soft-demap constants, rounded to float32 as the reference's float32 scalars are
_A_Q = float(np.float32(0.5 * _SQ2))  # QPSK axis amplitude (x0.5 normalized)
_L = np.float32(1.0 / np.sqrt(10.0))  # 16QAM level
_4L = float(np.float32(4.0) * _L)
_8LL = float(np.float32(np.float32(8.0) * _L) * _L)
_2L = float(np.float32(2.0) * _L)


@functools.lru_cache(maxsize=None)
def _soft_tables(device: torch.device):
    """(8PSK cos [8], sin [8], bit [8, 3], BIT_VALUES) on ``device``."""
    return (torch.as_tensor(_PSK8_COS, device=device), torch.as_tensor(_PSK8_SIN, device=device),
            torch.as_tensor(_PSK8_BIT, device=device), torch.as_tensor(BIT_VALUES, device=device))


def _psk8_llrs(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """[..., 4] max-log LLRs for the Gray ring (bit 3 zero-padded): on the
    unit circle d^2 = |y|^2 + 1 - 2 proj, so subset-min distances are
    subset-max projections onto the 8 angles."""
    cs, sn, bit, _ = _soft_tables(re.device)
    proj = re[..., None] * cs + im[..., None] * sn  # [..., n, 8]
    p = proj[..., None]  # [..., n, 8, 1]
    m0 = torch.where(bit, -math.inf, p).amax(dim=-2)  # [..., n, 3]
    m1 = torch.where(bit, p, -math.inf).amax(dim=-2)
    llr3 = 2.0 * (m0 - m1)
    return torch.cat([llr3, torch.zeros_like(llr3[..., :1])], dim=-1)


def soft_llrs(y: torch.Tensor, cnst_id: torch.Tensor, noise_var: torch.Tensor) -> torch.Tensor:
    """Max-log LLRs per bit, LSB-first bit order, by closed-form slicers.

    LLR > 0 means bit 0 more likely (log P(b=0) - log P(b=1)), the LDPC
    decoder's input convention.  BPSK/QPSK are linear in the matched
    axis; 16QAM (Gray per axis, levels +-L, +-3L) has the piecewise-linear
    4-PAM forms; 8PSK takes subset-max projections (:func:`_psk8_llrs`).
    :func:`soft_llrs_table` is the oracle.

    Args:
      y:         [..., n] complex received symbols.
      cnst_id:   per-frame constellation id, broadcastable to the batch dims.
      noise_var: per-frame noise variance (sigma^2), broadcastable like cnst_id.
    Returns [..., n, MAX_BPS] float32 LLRs; bits above the frame's bps are 0.
    """
    cid = _expand_to(cnst_id, y.shape)
    nv = torch.clamp(_expand_to(noise_var, y.shape), min=1e-12)
    re = y.real.float()
    im = y.imag.float()
    zeros = torch.zeros_like(re)
    bpsk = torch.stack([-4.0 * re, zeros, zeros, zeros], dim=-1)  # b0: 0 -> -1, 1 -> +1
    qpsk = torch.stack([(-4.0 * _A_Q) * re, (-4.0 * _A_Q) * im, zeros, zeros], dim=-1)

    def pam4(u):
        """Gray 4-PAM (+-L inner, +-3L outer): (inner-bit, sign-bit) LLRs."""
        au = u.abs()
        inner = _4L * au - _8LL
        sign = -(_4L * u + _4L * torch.sign(u) * torch.clamp(au - _2L, min=0.0))
        return inner, sign

    qi0, qi1 = pam4(re)
    qq0, qq1 = pam4(im)
    qam16 = torch.stack([qi0, qi1, qq0, qq1], dim=-1)
    psk8 = _psk8_llrs(re, im)
    c = cid[..., None]
    llr = torch.where(c == 1, bpsk, torch.where(c == 2, qpsk, torch.where(c == 3, psk8, qam16)))
    llr = llr / nv[..., None]
    _, bps, _ = tables(y.device)
    bit_ok = torch.arange(MAX_BPS, device=y.device) < bps[cid.long()][..., None]
    return torch.where(bit_ok, llr, 0.0).float()


def soft_llrs_table(y: torch.Tensor, cnst_id: torch.Tensor, noise_var: torch.Tensor) -> torch.Tensor:
    """Table-reduction max-log LLRs over every valid point: the oracle for
    :func:`soft_llrs`, same contract."""
    pts_t, bps_t, valid_t = tables(y.device)
    bitvals = _soft_tables(y.device)[3]
    cid_b = _expand_to(cnst_id, y.shape)[..., 0].long()  # per-frame rows
    pts = pts_t[cid_b]  # [batch..., P]
    dr = y.real[..., None] - pts.real[..., None, :]
    di = y.imag[..., None] - pts.imag[..., None, :]
    d2 = torch.where(valid_t[cid_b][..., None, :], dr * dr + di * di, math.inf)  # [..., n, P]
    nv = _expand_to(noise_var, y.shape)
    metric = -d2 / torch.clamp(nv, min=1e-12)[..., None]  # log-likelihood per point
    m = metric[..., :, None]  # [..., n, P, 1]
    bvb = bitvals[cid_b][..., None, :, :]  # [batch..., 1, P, MAX_BPS]
    ll0 = torch.where(bvb == 0, m, -math.inf).amax(dim=-2)
    ll1 = torch.where(bvb == 1, m, -math.inf).amax(dim=-2)
    bit_ok = torch.arange(MAX_BPS, device=y.device) < bps_t[cid_b][..., None, None]
    return torch.where(bit_ok, ll0 - ll1, 0.0).float()
