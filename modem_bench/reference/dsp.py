"""Signal layers of the reference modem: constellations (closed-form Gray
slicers and max-log LLRs), OFDM (the size-64 DFT as a matmul), the
channel estimate from the sync symbols, Schmidl-Cox detection, and the
decision-directed equalizer as a loop over symbols.

Every float32 matmul of the receive path goes through :func:`mm`, which
with ``tf32`` rounds both operands to TF32's 10-bit mantissa, as a TF32
tensor-core product reads them: that is the benchmark's control, the
receive path one precision below the float32 the modem states.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

BPSK, QPSK, PSK8, QAM16 = 1, 2, 3, 4
MAX_BPS = 4
FROZEN_ALPHA = 0.9995  # from here on the equalizer's taps are frozen
_SQ2 = np.sqrt(2.0) / 2.0


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 (or complex64) rounded to 10 mantissa bits, nearest, ties away."""
    if x.is_complex():
        return torch.view_as_complex(to_tf32(torch.view_as_real(x).contiguous()))
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    return torch.matmul(to_tf32(a), to_tf32(b)) if tf32 else torch.matmul(a, b)


# ---------------------------------------------------------------- constellations

def _tables():
    pts = np.zeros((5, 16), np.complex64)
    bps = np.array([0, 1, 2, 3, 4], np.int32)
    pts[1, 0], pts[1, 1] = -1.0, 1.0
    pts[1, 2:] = pts[1, np.arange(2, 16) % 2]
    for s in range(4):
        pts[2, s] = 0.5 * (_SQ2 * (1.0 if s & 1 else -1.0) + 1j * _SQ2 * (1.0 if s & 2 else -1.0))
    pts[2, 4:] = pts[2, np.arange(4, 16) % 4]
    for pos, sym in enumerate([0, 1, 3, 2, 6, 7, 5, 4]):
        pts[3, sym] = np.cos(2 * np.pi * pos / 8) + 1j * np.sin(2 * np.pi * pos / 8)
    pts[3, 8:] = pts[3, np.arange(8, 16) % 8]
    g2 = {0: -3.0, 1: -1.0, 3: 1.0, 2: 3.0}
    for s in range(16):
        pts[4, s] = (1.0 / np.sqrt(10.0)) * (g2[s & 3] + 1j * g2[(s >> 2) & 3])
    return pts, bps


POINTS, BITS_PER_SYMBOL = _tables()


@functools.lru_cache(maxsize=None)
def tables(device: torch.device):
    """(points [5, 16] complex64, bps [5] int64) on ``device``."""
    return torch.as_tensor(POINTS, device=device), torch.as_tensor(BITS_PER_SYMBOL, device=device).long()


def _expand(x: torch.Tensor, shape) -> torch.Tensor:
    while x.ndim < len(shape):
        x = x[..., None]
    return x.expand(shape)


def map_symbols(sym: torch.Tensor, cnst: torch.Tensor) -> torch.Tensor:
    return tables(sym.device)[0][_expand(cnst, sym.shape).long(), sym.long()]


def nearest_point(y: torch.Tensor, cnst: torch.Tensor):
    """(label int32, decided point): sign slicers for BPSK / QPSK, the phase
    sector for 8PSK, per-axis 4-level slicers for 16QAM; Gray labels."""
    cid = _expand(cnst, y.shape)
    re, im = y.real, y.imag
    pr, pi_ = re > 0, im > 0
    b_bit = pr.int()
    b_pt = torch.complex(torch.where(pr, 1.0, -1.0), torch.zeros_like(re))
    qs = float(np.float32(0.5 * _SQ2))
    q_idx = b_bit + 2 * pi_.int()
    q_pt = torch.complex(torch.where(pr, qs, -qs), torch.where(pi_, qs, -qs))
    pos = torch.round(torch.atan2(im, re) * (4.0 / math.pi)).int() % 8
    p_idx = pos ^ (pos >> 1)
    pang = pos.float() * (math.pi / 4.0)
    p_pt = torch.complex(torch.cos(pang), torch.sin(pang))
    lvl = np.float32(1.0) / np.sqrt(np.float32(10.0))
    two_l, lvl = float(np.float32(2.0) * lvl), float(lvl)
    u = torch.clamp(torch.floor(re / two_l + 2.0), 0, 3).int()
    v = torch.clamp(torch.floor(im / two_l + 2.0), 0, 3).int()
    m_idx = (u ^ (u >> 1)) + 4 * (v ^ (v >> 1))
    m_pt = torch.complex(lvl * (2 * u - 3).float(), lvl * (2 * v - 3).float())
    is_q, is_p, is_m = cid == QPSK, cid == PSK8, cid == QAM16
    idx = torch.where(is_q, q_idx, torch.where(is_p, p_idx, torch.where(is_m, m_idx, b_bit)))
    pt = torch.where(is_q, q_pt, torch.where(is_p, p_pt, torch.where(is_m, m_pt, b_pt)))
    return idx.int(), pt


def hard_decision(y: torch.Tensor, cnst: torch.Tensor) -> torch.Tensor:
    return nearest_point(y, cnst)[0]


_A_Q = float(np.float32(0.5 * _SQ2))
_L = np.float32(1.0 / np.sqrt(10.0))
_4L, _8LL, _2L = float(np.float32(4.0) * _L), float(np.float32(np.float32(8.0) * _L) * _L), float(np.float32(2.0) * _L)
_GRAY3 = [0, 1, 3, 2, 6, 7, 5, 4]
_PSK8_COS = np.cos(2 * np.pi * np.arange(8) / 8).astype(np.float32)
_PSK8_SIN = np.sin(2 * np.pi * np.arange(8) / 8).astype(np.float32)
_PSK8_BIT = np.array([[(s >> k) & 1 for k in range(3)] for s in _GRAY3], bool)


def soft_llrs(y: torch.Tensor, cnst: torch.Tensor, noise_var: torch.Tensor) -> torch.Tensor:
    """[..., n, 4] max-log LLRs (> 0: bit 0), LSB first, 0 past the frame's bps."""
    cid = _expand(cnst, y.shape)
    nv = torch.clamp(_expand(noise_var, y.shape), min=1e-12)
    re, im = y.real.float(), y.imag.float()
    z = torch.zeros_like(re)
    bpsk = torch.stack([-4.0 * re, z, z, z], dim=-1)
    qpsk = torch.stack([(-4.0 * _A_Q) * re, (-4.0 * _A_Q) * im, z, z], dim=-1)

    def pam4(u):
        au = u.abs()
        return _4L * au - _8LL, -(_4L * u + _4L * torch.sign(u) * torch.clamp(au - _2L, min=0.0))

    qi0, qi1 = pam4(re)
    qq0, qq1 = pam4(im)
    qam16 = torch.stack([qi0, qi1, qq0, qq1], dim=-1)
    cs, sn = torch.as_tensor(_PSK8_COS, device=y.device), torch.as_tensor(_PSK8_SIN, device=y.device)
    bit = torch.as_tensor(_PSK8_BIT, device=y.device)
    p = (re[..., None] * cs + im[..., None] * sn)[..., None]
    llr3 = 2.0 * (torch.where(bit, -math.inf, p).amax(dim=-2) - torch.where(bit, p, -math.inf).amax(dim=-2))
    psk8 = torch.cat([llr3, torch.zeros_like(llr3[..., :1])], dim=-1)
    c = cid[..., None]
    llr = torch.where(c == 1, bpsk, torch.where(c == 2, qpsk, torch.where(c == 3, psk8, qam16))) / nv[..., None]
    ok = torch.arange(MAX_BPS, device=y.device) < tables(y.device)[1][cid.long()][..., None]
    return torch.where(ok, llr, 0.0).float()


# ---------------------------------------------------------------- OFDM

@functools.lru_cache(maxsize=None)
def dft(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """Unitary centred (I)DFT matrix: time = x @ dft(n, True)."""
    k = np.arange(n)
    kc = k - n // 2
    m = (np.exp(2j * np.pi * np.outer(kc, k) / n) if inverse
         else np.exp(-2j * np.pi * np.outer(k, kc) / n)) / np.sqrt(n)
    return torch.as_tensor(m.astype(np.complex64), device=device)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Carrier layout and the known symbols of a frame."""

    occ_idx: torch.Tensor  # [48] centred index of each data carrier
    pilot_map: torch.Tensor  # [n_sym, fft] sync words, then the pilots of each data symbol
    w1: torch.Tensor
    w2: torch.Tensor
    active: torch.Tensor  # [fft] bool
    active_idx: torch.Tensor
    proj: torch.Tensor  # projection onto channels shorter than 2 cp + 1
    W1: torch.Tensor  # carrier-offset tables of the two sync words
    W2: torch.Tensor
    pilot_mask: torch.Tensor
    occ_mask: torch.Tensor
    pilot_vals: torch.Tensor  # [n_data_syms, fft]
    max_off: int = 6


def _shifted(y: np.ndarray, off: int) -> np.ndarray:
    n = y.shape[-1]
    out = np.zeros_like(y)
    lo, hi = max(0, -off), min(n, n - off)
    out[..., lo:hi] = y[..., lo + off:hi + off]
    return out


def _offset_table(w: np.ndarray, step: int, max_off: int) -> np.ndarray:
    dw = w * np.conj(np.roll(w, -step, axis=-1))
    return np.conj(np.stack([_shifted(dw, -o) for o in range(-max_off, max_off + 1)]))


def build_layout(num, device) -> Layout:
    n, half = num.fft_len, num.fft_len // 2
    occ = np.array(num.occupied_carriers) + half
    pil = np.array(num.pilot_carriers) + half
    n_data = num.header_symbols + num.frame_length
    pm = np.zeros((num.frame_ofdm_symbols, n), np.complex64)
    w1, w2 = num.sync_word1(), num.sync_word2()
    pm[0], pm[1] = w1, w2
    seq = np.array(num.pilot_sym_scramble_seq, np.float32)
    for s in range(n_data):
        x = seq[s % len(seq)]
        pm[num.n_sync_symbols + s, pil] = np.array([x, x, x, -x], np.complex64)
    active = np.zeros(n, bool)
    active[occ], active[pil] = True, True
    aidx = np.nonzero(active)[0]
    A = np.exp(-2j * np.pi * np.outer(aidx.astype(np.float64) - half, np.arange(2 * num.cp_len + 1)) / n)
    proj = (A @ np.linalg.pinv(A)).astype(np.complex64)
    pmask = np.zeros(n, bool)
    pmask[pil] = True
    omask = np.zeros(n, bool)
    omask[occ] = True
    pvals = np.where(pmask[None, :], pm[num.n_sync_symbols:], 0.0).astype(np.complex64)
    t = lambda a: torch.as_tensor(a, device=device)
    return Layout(occ_idx=t(occ).long(), pilot_map=t(pm), w1=t(w1), w2=t(w2), active=t(active),
                  active_idx=t(aidx).long(), proj=t(proj), W1=t(_offset_table(w1, 2, 6)),
                  W2=t(_offset_table(w2, 1, 6)), pilot_mask=t(pmask), occ_mask=t(omask), pilot_vals=t(pvals))


def allocate(data_syms: torch.Tensor, lay: Layout) -> torch.Tensor:
    B = data_syms.shape[0]
    grid = lay.pilot_map.expand(B, *lay.pilot_map.shape).clone()
    grid[:, lay.pilot_map.shape[0] - data_syms.shape[1]:, lay.occ_idx] = data_syms
    return grid


# ---------------------------------------------------------------- channel estimate

def carrier_offset(y1, y2, lay: Layout, tf32=False) -> torch.Tensor:
    """[B] int32 integer carrier offset by differential correlation."""
    dy = lambda y, s: y * torch.conj(torch.roll(y, -s, dims=-1))
    scores = torch.abs(mm(dy(y1, 2), lay.W1.T, tf32)) + torch.abs(mm(dy(y2, 1), lay.W2.T, tf32))
    return (torch.argmax(scores, dim=-1) - lay.max_off).int()


def carrier_shift(spectra, carr_off, lay: Layout, cp_len: int) -> torch.Tensor:
    B, n_sym, n = spectra.shape
    src = torch.arange(n, device=spectra.device)[None, :] + carr_off.long()[:, None]
    inside = (src >= 0) & (src < n)
    g = torch.gather(spectra, 2, src.clamp(0, n - 1)[:, None, :].expand(B, n_sym, n))
    s = torch.arange(n_sym, dtype=torch.float32, device=spectra.device)
    ph = -2.0 * math.pi * carr_off[:, None].float() * cp_len * s[None, :] / n
    return torch.where(inside[:, None, :], g, 0) * torch.exp(1j * ph)[..., None]


def denoise(taps, lay: Layout, tf32=False) -> torch.Tensor:
    out = taps.clone()
    out[..., lay.active_idx] = mm(taps[..., lay.active_idx], lay.proj.T, tf32)
    return out


def ls_taps(y1c, y2c, lay: Layout, tf32=False) -> torch.Tensor:
    w1_nz = torch.abs(lay.w1) > 0
    h2 = y2c / torch.where(torch.abs(lay.w2) > 0, lay.w2, 1.0)
    h1 = y1c / torch.where(w1_nz, lay.w1, 1.0)
    taps = torch.where(w1_nz[None, :], 0.5 * (h1 + h2), h2)
    taps = torch.where(lay.active[None, :], taps, 1.0)
    return torch.where(lay.active[None, :], denoise(taps, lay, tf32), 1.0).to(torch.complex64)


# ---------------------------------------------------------------- Schmidl-Cox detection

def _rows(x, starts, length):
    return x[starts[:, None] + torch.arange(length, device=x.device)]


def _median_trunc(x):
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    return torch.div(s[..., (n - 1) // 2] + s[..., n // 2], 2, rounding_mode="trunc")


def _periodic_starts(x_len, base, period, n, length, left_pad):
    xp_len = left_pad + x_len + period + length
    start = torch.clamp(base + left_pad, 0, xp_len - n * period)
    return start[..., None] + torch.arange(n, device=base.device) * period


def _moving_sum(x, w):
    """Windowed sums by two-level block prefixes (a global running sum
    loses the float32 mantissa on long streams)."""
    n = x.shape[-1]
    nb = -(-n // w)
    X = F.pad(x, (0, nb * w - n)).reshape(*x.shape[:-1], nb, w)
    pre = torch.cumsum(X, dim=-1)
    epre = torch.cat([torch.zeros_like(pre[..., :1]), pre[..., :-1]], dim=-1)
    nxt = torch.cat([epre[..., 1:, :], torch.zeros_like(epre[..., :1, :])], dim=-2)
    return ((pre[..., -1:] - epre) + nxt).reshape(*x.shape[:-1], nb * w)[..., :n - w + 1]


def timing_metric(r, fft_len=64):
    """P(d) = sum_{m<32} conj(r[d+m]) r[d+m+32]; M = |P|^2 / (R1 R2)."""
    half = fft_len // 2
    out = r.shape[-1] - fft_len
    P = _moving_sum(torch.conj(r[..., :-half]) * r[..., half:], half)[..., :out]
    E = _moving_sum(torch.abs(r) ** 2, half)
    return P, torch.abs(P) ** 2 / torch.clamp(E[..., :out] * E[..., half:half + out], min=1e-12)


def fold_phase(M, frame_samples, cp_len):
    n_full = M.shape[-1] // frame_samples
    folded = M[: n_full * frame_samples].reshape(n_full, frame_samples).sum(-2)
    k = cp_len + 1
    win = _moving_sum(torch.cat([folded, folded[: k - 1]]), k)
    return ((torch.argmax(win) + k // 2) % frame_samples).int()


def frame_triggers(M, phase, frame_samples, n_frames, search=24):
    L = 2 * search + 1
    base = phase.long() - search
    start = base + torch.arange(n_frames, device=M.device) * frame_samples
    Mp = F.pad(M, (search, frame_samples + L))
    vals = _rows(Mp, _periodic_starts(M.shape[-1], base, frame_samples, n_frames, L, search), L)
    w = torch.where(vals > 0.8 * vals.max(dim=-1, keepdim=True).values, vals, 0.0)
    rel = torch.arange(L, dtype=torch.float32, device=M.device)[None, :]
    return (start + torch.round((w * rel).sum(-1) / torch.clamp(w.sum(-1), min=1e-12)).long()).int()


def _anchor(trig, period):
    k = torch.arange(trig.shape[0], device=trig.device)
    rel = trig.long() - k * period
    base = _median_trunc(rel)
    return k, base, torch.all(torch.abs(rel - base) <= 4)


def fine_cfo(P, trig, cp_len, period):
    L = cp_len + 1
    n = P.shape[-1]
    B = trig.shape[0]
    _, base, uniform = _anchor(trig, period)
    slow = torch.clamp(trig.long() - cp_len // 2, 0, n - L)
    fast = _periodic_starts(n, base - cp_len // 2, period, B, L, cp_len)
    wins = _rows(F.pad(P, (cp_len, period + L)), torch.where(uniform, fast, slow + cp_len), L)
    return (torch.angle(wins.sum(-1)) / math.pi).float()


def extract_frames(stream, trig, period):
    B, N = trig.shape[0], stream.shape[-1]
    if N < B * period:
        return _rows(stream, torch.clamp(trig.long(), 0, N - period), period)
    k, base, uniform = _anchor(trig, period)
    fast = torch.clamp(base, 0, N - B * period) + k * period
    slow = torch.clamp(trig.long(), 0, N - period)
    return _rows(stream, torch.where(uniform, fast, slow), period)


def cfo_correct(frames, eps, fft_len):
    n = torch.arange(frames.shape[-1], dtype=torch.float32, device=frames.device)
    return frames * torch.exp(1j * (-2.0 * math.pi * eps[:, None] * n[None, :] / fft_len))


# ---------------------------------------------------------------- equalizer

def equalize(spectra, taps0, cnst, lay: Layout, alpha: float, header_syms: int, sym_offset: int):
    """Decision-directed equalizer, a step a symbol: (hard, soft, taps,
    snr_db, noise_var); taps track H = alpha H + (1 - alpha) Y / ref, ref
    the known pilot or the decided point; pilots drive the SNR estimate."""
    B, n_sym, _ = spectra.shape
    pil = lay.pilot_mask
    pvs = lay.pilot_vals[sym_offset:sym_offset + n_sym]
    abs_idx = torch.arange(n_sym, device=spectra.device) + sym_offset
    sym_cnst = torch.where((abs_idx < header_syms)[None, :], BPSK, cnst[:, None].int())
    tot = n_sym * int(pil.sum())
    sig_pw = torch.clamp(torch.where(pil[None, :], torch.abs(pvs) ** 2, 0.0).sum(-1).sum() / tot, min=1e-12)
    if float(alpha) >= FROZEN_ALPHA:
        raise ValueError(f"eq_alpha {alpha}: the modem freezes its taps from {FROZEN_ALPHA} on, which no "
                         "configuration of the benchmark states and the reference does not model")
    upd = (lay.occ_mask | pil)[None, :]
    H = taps0
    hard, soft, pe2 = [], [], []
    for s in range(n_sym):
        Y = spectra[:, s]
        pv = pvs[s][None, :]
        eqd = Y / H
        _, dec = nearest_point(eqd, sym_cnst[:, s, None])
        ref = torch.where(pil[None, :], pv, dec)
        H = torch.where(upd, alpha * H + (1.0 - alpha) * Y / torch.where(torch.abs(ref) > 0, ref, 1.0), H)
        hard.append(ref)
        soft.append(eqd)
        pe2.append((torch.abs(torch.where(pil[None, :], eqd - pv, 0.0)) ** 2).sum(-1))
    nv = torch.clamp(torch.stack(pe2).sum(0) / tot, min=1e-12)
    return (torch.stack(hard, 1), torch.stack(soft, 1), H, (10.0 * torch.log10(sig_pw / nv)).float(),
            nv.float())
