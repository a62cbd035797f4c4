"""A numpy float32 model of the equalizer kernel's step (csrc/equalizer.cu),
held against the plain loop ``_equalize_frame_torch`` on the CPU.

The kernel takes the update's division off the step's dependent chain: each
warp tables, before the steps, the divisor constants (c10's ratio, scale and
|re| >= |im| select) of every value the update can divide by (the row's
points, BPSK's two for the header symbols, the pilot values of its pilot
carriers, a point 0 by those of 1), and a step finds them by the index its
slicer yields.  The model is written as the kernel is laid out (entries
0-15 the payload row's points in each slicer's own order, 16-17 BPSK's, the
pilot entries after them, refilled a chunk of symbols at a time, a pilot
carrier reading entry ``(s - s0) P + rank``, P the least power of two at or
above the warp's pilot count), so a fault in that layout
or in an index shows here; the card's rounding is the card tests' to hold.
The bar is ``equalizer_cuda.compare_with_plain``'s: decisions equal, soft
symbols and taps within 1e-5, on every row (no row parts at a boundary on
these inputs)."""

import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.ops import equalizer, equalizer_cuda
from gr_dtl_tpu_torch.tools import bench_equalizer

F32 = np.float32
SRC = equalizer_cuda.SOURCE.read_text()


def _const(name: str):
    m = re.search(rf"constexpr (?:int|float) {name} = ([0-9.e+-]+)f?;", SRC)
    return float(m.group(1)) if "." in m.group(1) else int(m.group(1))


HDR, POINT_ENTRIES, PILOT_ENTRIES = _const("kHdrEntry"), _const("kPointEntries"), _const("kPilotEntries")
QPSK_A, FOUR_OVER_PI, PI_OVER_FOUR = F32(_const("kQpskAmp")), F32(_const("kFourOverPi")), F32(_const("kPiOverFour"))
QAM_L, QAM_2L = F32(_const("kQamLevel")), F32(_const("kQamTwoLevel"))
QAM_INV_2L = F32(1.0) / QAM_2L


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def divisor(y: np.ndarray):
    """c10's constants of a division by y (complex64): (rat, scl, c_larger)."""
    c, d = y.real.astype(F32), y.imag.astype(F32)
    c_larger = np.abs(c) >= np.abs(d)
    p, q = np.where(c_larger, c, d), np.where(c_larger, d, c)
    with np.errstate(divide="ignore", invalid="ignore"):
        rat = (q / p).astype(F32)
        scl = (F32(1.0) / (p + q * rat)).astype(F32)
    return rat, scl, c_larger


def divide(x: np.ndarray, rat, scl, c_larger) -> np.ndarray:
    a, b = x.real.astype(F32), x.imag.astype(F32)
    x1, x2 = np.where(c_larger, b, a), np.where(c_larger, a, b)
    y1, y2 = np.where(c_larger, -a, b), np.where(c_larger, b, -a)
    with np.errstate(invalid="ignore", over="ignore"):
        re_ = ((x2 + x1 * rat) * scl).astype(F32)
        im_ = ((y2 + y1 * rat) * scl).astype(F32)
    return (re_ + 1j * im_).astype(np.complex64)


def cdiv(x, y):
    with np.errstate(divide="ignore", invalid="ignore"):
        out = divide(x, *divisor(y))
        zero = (y.real == 0) & (y.imag == 0)
        over = lambda a: np.where(np.abs(a) > 0, np.copysign(np.inf, a), np.nan).astype(F32)
        return np.where(zero, over(x.real) + 1j * over(x.imag), out).astype(np.complex64)


def ref_safe(v: np.ndarray) -> np.ndarray:
    return np.where((v.real != 0) | (v.imag != 0), v, np.complex64(1.0)).astype(np.complex64)


def table_point(i: int, cid: int) -> complex:
    """The kernel's ``table_point``: entry i's point of the closed-form slicers."""
    if i < HDR:
        if cid == 2:
            return complex(QPSK_A if i & 1 else -QPSK_A, QPSK_A if i & 2 else -QPSK_A)
        if cid == 3:
            pang = F32(i & 7) * PI_OVER_FOUR
            return complex(F32(math.cos(pang)), F32(math.sin(pang)))
        if cid == 4:
            return complex(QAM_L * F32(2 * (i & 3) - 3), QAM_L * F32(2 * ((i >> 2) & 3) - 3))
    return complex(1.0 if i & 1 else -1.0, 0.0)


def slice_closed(y: np.ndarray, cid: np.ndarray) -> np.ndarray:
    """The closed-form slicers' entries: BPSK 16 + sign bit (ids outside
    2..4), QPSK the two sign bits, 8PSK the ring position, 16QAM u + 4v."""
    re_, im_ = y.real.astype(F32), y.imag.astype(F32)
    bpsk = HDR + (re_ > 0)
    qpsk = (re_ > 0) | ((im_ > 0) << 1)
    with np.errstate(invalid="ignore"):
        pos = np.rint(np.arctan2(im_, re_).astype(F32) * FOUR_OVER_PI)
        psk8 = np.where(np.isnan(pos), 0, pos).astype(np.int64) & 7
        lvl = lambda x: np.clip(np.nan_to_num(np.floor(x * QAM_INV_2L + F32(2.0)), nan=0.0), 0, 3).astype(np.int64)
    qam = lvl(re_) + 4 * lvl(im_)
    return np.select([cid == 2, cid == 3, cid == 4], [qpsk, psk8, qam], bpsk)


def slice_table(y: np.ndarray, pts: np.ndarray, base: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Table mode: the first of entries base .. base + n - 1 at the least
    distance (dr*dr + di*di, each rounded; a NaN the least), base for n = 0.
    pts [..., 18] the rows' point entries; base, n broadcast with y."""
    best_d, best = None, np.broadcast_to(base, y.shape).copy()
    for j in range(16):
        e = base + j
        p = np.take_along_axis(pts, np.broadcast_to(np.minimum(e, POINT_ENTRIES - 1), y.shape)[..., None], -1)[..., 0]
        dr, di = (y.real - p.real).astype(F32), (y.imag - p.imag).astype(F32)
        d2 = ((dr * dr).astype(F32) + (di * di).astype(F32)).astype(F32)
        if best_d is None:
            best_d = d2
            continue
        take = (j < n) & ((d2 < best_d) | (np.isnan(d2) & ~np.isnan(best_d)))
        best_d, best = np.where(take, d2, best_d), np.where(take, e, best)
    return best


def abs2(z: np.ndarray) -> np.ndarray:
    zr, zi = z.real.astype(F32), z.imag.astype(F32)
    return np.where(np.isinf(zr) | np.isinf(zi), np.inf, zr * zr + zi * zi).astype(F32)


def point_entries(cid: np.ndarray, tab) -> np.ndarray:
    """[B, 18] the rows' point entries: entries 0-15 the payload row's points
    (closed form: ``table_point``; table mode: the point table's row of the
    id, row 0 outside 1..4), 16-17 BPSK's."""
    if tab.table_mode:
        points = tab.points.numpy()
        typ = np.where((cid >= 1) & (cid < cn.N_TYPES), cid, 0)
        return np.concatenate([points[typ], np.broadcast_to(points[1, :2], (len(cid), 2))], axis=1)
    return np.array([[table_point(i, int(c)) for i in range(POINT_ENTRIES)] for c in cid], np.complex64)


def model(spectra, taps, cnst, eq, sym_offset=0):
    """The kernel's step in numpy float32: an ``EqualizerOut`` of CPU tensors."""
    spectra, H = np.asarray(spectra, np.complex64), np.asarray(taps, np.complex64).copy()
    B, n_sym, F = spectra.shape
    pil, occ = eq.pilot_mask.numpy(), eq.occ_mask.numpy()
    upd = pil | occ
    pv_rows = eq.pilot_vals.numpy()[sym_offset:]
    n_hdr = min(max(eq.header_syms - sym_offset, 0), n_sym)
    alpha = F32(eq.alpha)
    oma = F32(1.0 - eq.alpha)
    frozen = eq.alpha >= equalizer_cuda.FROZEN_ALPHA
    table = eq.tab.table_mode
    n_tab = np.where((cnst >= 1) & (cnst < cn.N_TYPES), 1 << np.clip(cnst, 0, 4), 0) if table else None

    # a warp's entries: the points (per row), then the pilot entries (per warp)
    pts = point_entries(cnst, eq.tab)                                       # [B, 18]
    p_rat, p_scl, p_cl = divisor(ref_safe(pts))
    warps = F // 32
    lanes = pil.reshape(warps, 32)
    n_wp = lanes.sum(1)
    rank = (np.cumsum(lanes, 1) - lanes).reshape(F)                          # a pilot's rank in its warp
    stride = np.array([1 << max(int(n - 1), 0).bit_length() for n in n_wp])  # the least power of two >= n_wp
    chunk = PILOT_ENTRIES // stride
    carriers = [np.nonzero(lanes[w])[0] + 32 * w for w in range(warps)]
    warp_of = np.arange(F) // 32

    hard, soft = np.zeros_like(spectra), np.zeros_like(spectra)
    err2, sig2 = np.zeros((B, F), F32), np.zeros((B, F), F32)
    pil_val = np.zeros((warps, PILOT_ENTRIES), np.complex64)
    s_fill = np.zeros(warps, int)
    s0 = np.zeros(warps, int)
    for s in range(n_sym):
        for w in range(warps):
            if s == s_fill[w]:  # fill(s): entry (s' - s) n_wp + j = symbol s' on pilot j
                s0[w], s_fill[w] = s, s + chunk[w]
                pil_val[w] = 0
                for sj in range(min(chunk[w], n_sym - s)):
                    for j in range(n_wp[w]):
                        pil_val[w, sj * stride[w] + j] = pv_rows[s + sj, carriers[w][j]]
        Y = spectra[:, s]
        eqd = cdiv(Y, H)
        if table:
            hdr = s < n_hdr
            base = np.full((B, 1), HDR if hdr else 0)
            n = np.full((B, 1), 2) if hdr else n_tab[:, None]
            base = np.where(n == 2, HDR, base)  # a BPSK row decides on BPSK's entries
            dec = slice_table(eqd, np.broadcast_to(pts[:, None, :], (B, F, POINT_ENTRIES)), base, n)
        else:
            dec = slice_closed(eqd, np.full((B, 1), 1) if s < n_hdr else cnst[:, None])
        pil_e = (s - s0[warp_of]) * stride[warp_of] + rank                 # [F]
        val = np.where(pil, pil_val[warp_of, np.minimum(pil_e, PILOT_ENTRIES - 1)],
                       np.take_along_axis(pts, dec, 1))
        rat = np.where(pil, divisor(ref_safe(val))[0], np.take_along_axis(p_rat, dec, 1))
        scl = np.where(pil, divisor(ref_safe(val))[1], np.take_along_axis(p_scl, dec, 1))
        cl = np.where(pil, divisor(ref_safe(val))[2], np.take_along_axis(p_cl, dec, 1))
        err2 = np.where(pil, (err2 + abs2(eqd - val)).astype(F32), err2)
        sig2 = np.where(pil, (sig2 + abs2(val)).astype(F32), sig2)
        if not frozen:
            scaled = ((Y.real * oma).astype(F32) + 1j * (Y.imag * oma).astype(F32)).astype(np.complex64)
            d = divide(scaled, rat, scl, cl)
            Hn = (((H.real * alpha).astype(F32) + d.real).astype(F32)
                  + 1j * ((H.imag * alpha).astype(F32) + d.imag).astype(F32)).astype(np.complex64)
            H = np.where(upd, Hn, H)
        hard[:, s], soft[:, s] = val, eqd
    inv_tot = F32(1.0) / F32(n_sym * eq.n_pilots)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        nv = np.maximum(err2.sum(1, dtype=F32) * inv_tot, F32(1e-12)).astype(F32)
        sig = np.maximum(sig2.sum(1, dtype=F32) * inv_tot, F32(1e-12)).astype(F32)
        snr = (F32(10.0) * np.log10(sig / nv)).astype(F32)
    t = torch.as_tensor
    return equalizer.EqualizerOut(hard=t(hard), soft=t(soft), taps=t(np.asarray(taps) if frozen else H),
                                  snr_db=t(snr), noise_var=t(nv))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def custom_eq(fft_len: int, pilots, alpha: float, n_rows: int = 21, tab=None, seed: int = 0):
    """An equalizer of fft_len carriers: the carriers within 3/8 of the band
    occupied but DC, ``pilots`` (carrier offsets) among them, the pilot values
    +-1, +-j and 0.6 - 0.8j (and one 0) drawn from a seed, one header symbol."""
    half = fft_len // 2
    occ = np.zeros(fft_len, bool)
    occ[np.r_[-(3 * fft_len // 8):0, 1:3 * fft_len // 8 + 1] + half] = True
    pil = np.zeros(fft_len, bool)
    pil[np.asarray(pilots) + half] = True
    occ &= ~pil
    rng = np.random.RandomState(seed)
    vals = np.array([1, -1, 1j, -1j, 0.6 - 0.8j], np.complex64)
    pv = np.where(pil[None, :], vals[rng.randint(0, 5, (n_rows, fft_len))], 0).astype(np.complex64)
    pv[3, np.nonzero(pil)[0][0]] = 0  # a pilot of 0 divides as 1
    eq = equalizer.equalizer_from_reference({"occ_mask": occ, "pilot_mask": pil, "pilot_vals": pv,
                                             "alpha": alpha, "header_syms": 1}, "cpu")
    return eq if tab is None else dataclasses.replace(eq, tab=tab)


def frames(eq, B: int, n_sym: int, sym_offset: int, cnst: np.ndarray, seed: int, noise: float = 0.02):
    """Random points of each symbol's constellation (BPSK on header symbols,
    ids outside 1..4 too) on the data carriers, the pilot values on theirs,
    through a smooth channel; the channel with an estimation error as the
    taps (1 on idle carriers)."""
    rng = np.random.RandomState(seed)
    F = eq.pilot_mask.shape[0]
    pil, occ = eq.pilot_mask.numpy(), eq.occ_mask.numpy()
    pv = eq.pilot_vals.numpy()[sym_offset:sym_offset + n_sym]
    points = cn.POINTS
    ids = np.where((cnst >= 1) & (cnst <= 4), cnst, 1)
    sym_cnst = np.where(sym_offset + np.arange(n_sym)[None, :] < eq.header_syms, 1, ids[:, None])
    idx = rng.randint(0, 16, (B, n_sym, F)) % (1 << cn.BITS_PER_SYMBOL[sym_cnst])[:, :, None]
    grid = np.where(pil[None, None, :], pv[None], points[sym_cnst[:, :, None], idx])
    k = np.arange(F) - F // 2
    H = rng.uniform(0.7, 1.3, (B, 1)) * np.exp(1j * (rng.uniform(-3, 3, (B, 1))
                                                     + 2 * np.pi * k[None, :] * rng.uniform(0, 0.2, (B, 1)) / 8))
    w = noise * (rng.randn(B, n_sym, F) + 1j * rng.randn(B, n_sym, F))
    spectra = (grid * H[:, None, :] + w).astype(np.complex64)
    taps0 = np.where(occ | pil, H * (1 + 0.02 * rng.randn(B, F)), 1.0).astype(np.complex64)
    return spectra, taps0


def held_to_plain(eq, spectra, taps0, cnst, sym_offset):
    got = model(spectra, taps0, cnst, eq, sym_offset)
    args = (torch.as_tensor(spectra), torch.as_tensor(taps0), torch.as_tensor(cnst), eq, sym_offset)
    want = equalizer._equalize_frame_torch(*args)
    res = equalizer_cuda.compare_with_plain(got, want, args[2], eq, sym_offset)
    assert res["fault_rows"] == 0 and res["boundary_rows"] == 0, res
    return got, want


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

IDS = np.array([0, 1, 2, 3, 4, 5, 2, 3, 4, 4, 3, 2], np.int32)
PILOTS = {32: [-11, -4, 4, 11], 64: [-21, -7, 7, 21], 128: [-45, -31, -17, -3, 3, 17, 31, 45]}


@pytest.mark.parametrize("table", [False, True], ids=["closed", "foreign_tables"])
@pytest.mark.parametrize("alpha", [0.1, 0.9995])
@pytest.mark.parametrize("fft_len", [32, 64, 128])
def test_model_matches_plain_loop(fft_len, alpha, table):
    """Ids 0-5 (0 and 5 decide as BPSK; in table mode, where the plain
    loop indexes the point table by the id, 0 alone has no valid point), the
    header call, the payload call from its taps, and one call that holds
    both; updating and frozen taps; on the closed-form slicers and on the
    foreign wire tables (table mode)."""
    tab = bench_equalizer.wire_tables("cpu") if table else None
    ids = np.where(IDS < cn.N_TYPES, IDS, 0).astype(np.int32) if table else IDS
    eq = custom_eq(fft_len, PILOTS[fft_len], alpha, tab=tab, seed=fft_len)
    data, taps0 = frames(eq, len(ids), 21, 0, ids, seed=fft_len + int(alpha * 10))
    hdr, _ = held_to_plain(eq, data[:, :1], taps0, np.ones_like(ids), 0)
    held_to_plain(eq, data[:, 1:], hdr.taps.numpy(), ids, 1)
    held_to_plain(eq, data, taps0, ids, 0)


def test_model_refills_the_pilot_entries():
    """Many pilots in one warp (13, laid out 16 a symbol: 2 symbols a chunk of
    46 entries) and one in the other: the pilot entries are refilled every
    other symbol, and a pilot carrier still reads its own symbol's value."""
    pilots = list(range(-32, -6, 2)) + [9]
    eq = custom_eq(64, pilots, 0.1, seed=3)
    n_wp = eq.pilot_mask.numpy().reshape(2, 32).sum(1)
    assert list(n_wp) == [13, 1] and PILOT_ENTRIES // 16 == 2
    cnst = np.array([2, 3, 4, 1], np.int32)
    data, taps0 = frames(eq, 4, 20, 1, cnst, seed=9)
    got, want = held_to_plain(eq, data, taps0, cnst, 1)
    pil = eq.pilot_mask.numpy()
    np.testing.assert_array_equal(got.hard.numpy()[:, :, pil], want.hard.numpy()[:, :, pil])


def test_pilot_of_zero_divides_as_one():
    """The table's constants of a 0 are those of ref_safe's 1: the update
    divides by 1, as the plain loop does."""
    rat, scl, cl = divisor(ref_safe(np.array([0j, 1 + 0j, 0.6 - 0.8j], np.complex64)))
    assert (rat[0], scl[0], cl[0]) == (rat[1], scl[1], cl[1]) == (0.0, 1.0, True)
    x = np.array([0.3 - 0.2j], np.complex64)
    np.testing.assert_array_equal(divide(x, rat[:1], scl[:1], cl[:1]), x)
    np.testing.assert_allclose(divide(x, rat[2:], scl[2:], cl[2:]), x / np.complex64(0.6 - 0.8j), rtol=1e-6)


@pytest.mark.parametrize("cid", [1, 2, 3, 4])
def test_each_entry_is_the_point_its_slicer_decides(cid):
    """For every point of rows 1-4 (and the point a little off it): the
    closed-form slicer's entry holds the point that nearest_point decides,
    and in table mode (on the native and on the foreign tables) the table
    slicer's entry holds nearest_point_table's point."""
    n = 1 << cid
    pts = cn.POINTS[cid, :n]
    rng = np.random.RandomState(cid)
    y = np.concatenate([pts, pts + 0.05 * (rng.randn(n) + 1j * rng.randn(n))]).astype(np.complex64)
    entries = slice_closed(y, np.full(y.shape, cid))
    table = point_entries(np.array([cid]), cn.active("cpu"))[0]
    _, want = cn.nearest_point(torch.as_tensor(y), torch.tensor(cid))
    np.testing.assert_array_equal(table[entries], want.numpy())
    assert sorted(set(entries[:n].tolist())) == sorted(range(HDR, HDR + 2) if cid == 1 else range(n))
    for consts in ("native", "foreign"):
        tab = bench_equalizer.wire_tables("cpu", None if consts == "foreign" else
                                          __import__("gr_dtl_tpu_torch.utils.wire_compat",
                                                     fromlist=["dump_native"]).dump_native())
        tpts = point_entries(np.array([cid]), tab)
        base = HDR if cid == 1 else 0
        got = slice_table(y[None], np.broadcast_to(tpts[:, None, :], (1, y.size, POINT_ENTRIES)),
                          np.full((1, 1), base), np.full((1, 1), n))[0]
        _, want = cn.nearest_point_table(torch.as_tensor(y), torch.tensor(cid), tab)
        np.testing.assert_array_equal(tpts[0][got], want.numpy())


def test_table_mode_without_a_valid_point_decides_entry_zero():
    """An id outside 1..4 in table mode: no valid point, entry 0 (the row-0
    point 0), as the argmin of all-inf distances decides."""
    tab = bench_equalizer.wire_tables("cpu")
    y = np.array([[0.3 + 0.1j, -2 + 1j]], np.complex64)
    pts = point_entries(np.array([0]), tab)
    got = slice_table(y, np.broadcast_to(pts[:, None, :], (1, 2, POINT_ENTRIES)), np.zeros((1, 1), int),
                      np.zeros((1, 1), int))
    assert got.tolist() == [[0, 0]]
    _, want = cn.nearest_point_table(torch.as_tensor(y), torch.tensor([[0]]), tab)
    np.testing.assert_array_equal(pts[0][got[0]], want.numpy()[0])


def test_source_layout_constants():
    """The entries the model lays out are the source's: 16 payload points,
    BPSK's two after them, pilot entries enough for the widest warp (32
    pilot carriers) to hold one symbol and few enough for a fill's two
    rounds of 32 lanes."""
    assert (HDR, POINT_ENTRIES) == (cn.MAX_POINTS, cn.MAX_POINTS + 2)
    assert 32 <= PILOT_ENTRIES <= 64
    assert "constexpr int kEntries = kPointEntries + kPilotEntries;" in SRC
