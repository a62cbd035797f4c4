"""The equalizer kernel (csrc/equalizer.cu) and what stands around it.

On the CPU: the boundary classifier and the row-by-row comparison that the
card tests and chip_smoke.py hold the kernel to, the dispatcher, the
wrapper's refusals, the byte count and the source's constants.

On the card (marked ``cuda``: these skip without an NVIDIA GPU, a CUDA
kernel has no CPU mode): the kernel against ``_equalize_frame_torch`` on
the same CUDA tensors.  Decisions feed back into the taps, and PyTorch's
own CUDA kernels round where their build contracted products and sums, so
bit equality cannot be promised; the bar is: decisions equal, soft symbols
and taps within atol 1e-5, noise variance within rtol 1e-4, SNR within 1e-3
dB (the tolerances of tests/test_torch_equalizer.py) on every row, except
rows that part at a symbol whose equalized value lies within 1e-5 of a
decision boundary, and those stay under 0.1% of the rows.  Table mode
(wire-compat tables: the table argmin, written as PyTorch's chain of
kernels rounds it) is held to more: bit-equal to the plain loop on every
row, boundary inputs included; and the table mode on the native tables
decides the closed form's points (within an ulp: the table holds them
rounded from float64) but at a boundary.  On a machine
with the card but without JAX or pytest-xdist:
``python3 -m pytest -o addopts= --noconftest -q tests/test_torch_equalizer_cuda.py``.
"""

import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.ops import equalizer, equalizer_cuda
from gr_dtl_tpu_torch.tools import bench_equalizer
from gr_dtl_tpu_torch.utils import wire_compat

FRAME_LENGTH = 20
LVL = float(np.float32(1.0) / np.sqrt(np.float32(10.0)))


def eq_tables(device, alpha=0.8, tables=None):
    """The equalizer constants; ``tables``: None (the closed form),
    "foreign" (the relabeled wire tables) or "native" (the native points in
    table mode)."""
    tab = None
    if tables is not None:
        consts = bench_equalizer.foreign_constants() if tables == "foreign" else wire_compat.dump_native()
        tab = bench_equalizer.wire_tables(device, consts)
    return bench_equalizer.eq_tables(device, alpha, tab)


frame_inputs = bench_equalizer.frame_inputs  # synthetic frames, shared with the timing tool


# ---------------------------------------------------------------------------
# CPU: the classifier and the comparison
# ---------------------------------------------------------------------------

EPS = 1e-5
RAY = math.pi / 8  # the first 8PSK boundary


@pytest.mark.parametrize("cid, near, far", [
    (1, [2e-6 + 0.7j, -9e-6 - 3j, 0j], [2e-5 + 0.7j, 1 + 0j, -1 + 1e-7j, 0.3 - 2e-6j]),
    (0, [2e-6 + 0.7j], [1 + 0j]),  # an id outside 2..4 is decided as BPSK
    (2, [2e-6 + 0.7j, 0.35 - 9e-6j, 0j], [0.35 + 0.35j, -2e-5 + 1j, 1 - 2e-5j]),
    (3, [np.exp(1j * (RAY + 5e-6)), 0.5 * np.exp(1j * (3 * RAY - 1.5e-5)), np.exp(-1j * (7 * RAY + 8e-6)),
         1e-6 + 1e-6j],
        [1 + 0j, np.exp(1j * (RAY + 3e-5)), np.exp(2j * RAY), -1 + 1e-7j, -1 - 1e-7j, 3 * np.exp(1j * (RAY + 5e-6))]),
    (4, [2 * LVL + 4e-6 + 0.1j, 0.1 - 1j * (2 * LVL - 8e-6), -2e-6 + 0.9j, -2 * LVL + 0.5j],
        [LVL + LVL * 1j, 3 * LVL - 3j * LVL, 2 * LVL + 3e-5 + 0.1j, 4 * LVL + 0.1j, 0.1 - 4j * LVL]),
])
def test_near_decision_boundary_on_constructed_points(cid, near, far):
    y = torch.as_tensor(np.array([near + far], np.complex64))
    got = cn.near_decision_boundary(y, torch.tensor([cid]), EPS)[0].tolist()
    assert got == [True] * len(near) + [False] * len(far)


def boundary_points(cid, rng, n):
    """n points on the decision boundaries of constellation cid."""
    t = rng.uniform(-1.2, 1.2, n)
    if cid == 3:
        return np.abs(t) * np.exp(1j * (2 * rng.randint(0, 8, n) + 1) * RAY)
    lines = {1: [0.0], 2: [0.0], 4: [-2 * LVL, 0.0, 2 * LVL]}[cid]
    on = rng.choice(lines, n) + 1j * t
    return np.where((rng.rand(n) < 0.5) & (cid != 1), on.imag + 1j * on.real, on)


@pytest.mark.parametrize("cid", [1, 2, 3, 4])
def test_decisions_change_only_near_a_boundary(cid):
    """Two points 2e-6 apart that nearest_point decides differently both lie
    within 1e-5 of a boundary, whatever the constellation; of points spread
    over the plane, under 0.1% do."""
    rng = np.random.RandomState(cid)
    n = 20_000
    step = lambda r: r * np.exp(2j * np.pi * rng.rand(n))
    y = (boundary_points(cid, rng, n) + step(3e-6 * rng.rand(n))).astype(np.complex64)
    y2 = (y + step(2e-6)).astype(np.complex64)
    a, b, c = torch.as_tensor(y)[None], torch.as_tensor(y2)[None], torch.tensor([cid])
    flipped = cn.nearest_point(a, c)[0] != cn.nearest_point(b, c)[0]
    assert flipped.float().mean() > 0.1
    assert bool(cn.near_decision_boundary(a, c, EPS)[flipped].all())
    assert bool(cn.near_decision_boundary(b, c, EPS)[flipped].all())
    spread = (rng.uniform(-1.2, 1.2, 400_000) + 1j * rng.uniform(-1.2, 1.2, 400_000)).astype(np.complex64)
    assert cn.near_decision_boundary(torch.as_tensor(spread)[None], c, EPS).float().mean() < 1e-3


def test_compare_with_plain_tells_boundary_rows_from_faults():
    eq = eq_tables("cpu")
    B, n_sym = 6, 4
    cnst = np.array([1, 2, 3, 4, 4, 2], np.int32)
    spectra, taps0 = frame_inputs(eq, B, n_sym, 1, cnst, seed=3)
    args = (torch.as_tensor(spectra), torch.as_tensor(taps0), torch.as_tensor(cnst), eq, 1)
    want = equalizer._equalize_frame_torch(*args)
    same = equalizer_cuda.compare_with_plain(want, want, args[2], eq, 1)
    assert same == {"rows": B, "boundary_rows": 0, "fault_rows": 0, "max_abs_err": 0.0}

    occ = int(np.nonzero(eq.occ_mask.numpy())[0][3])
    # row 3 (16QAM): carrier `occ` of symbol 1 equalizes to a point just
    # left or just right of the line re = 2l (Y = H x, with H the taps that
    # symbol 0 leaves); everything after that symbol may differ
    taps_1 = equalizer._equalize_frame_torch(args[0][:, :1], *args[1:]).taps[3, occ].numpy()
    runs = []
    for side in (-1, 1):
        moved = spectra.copy()
        moved[3, 1, occ] = taps_1 * np.complex64(2 * LVL + side * 1.5e-6 + 0.2j)
        runs.append(equalizer._equalize_frame_torch(torch.as_tensor(moved), *args[1:]))
    lo, hi = runs
    assert lo.hard[3, 1, occ] != hi.hard[3, 1, occ] and abs(lo.soft[3, 1, occ] - hi.soft[3, 1, occ]) < 1e-5
    got = equalizer_cuda.compare_with_plain(lo, hi, args[2], eq, 1)
    assert (got["boundary_rows"], got["fault_rows"]) == (1, 0)

    # a decision that differs far from any boundary, and a soft symbol off
    # by more than the tolerance with every decision equal, are faults
    bad = want._replace(hard=want.hard.clone())
    bad.hard[0, 2, occ] = -bad.hard[0, 2, occ]
    assert equalizer_cuda.compare_with_plain(bad, want, args[2], eq, 1)["fault_rows"] == 1
    bad = want._replace(soft=want.soft.clone())
    bad.soft[5, 3, occ] += 1e-4
    got = equalizer_cuda.compare_with_plain(bad, want, args[2], eq, 1)
    assert (got["boundary_rows"], got["fault_rows"]) == (0, 1)
    bad = want._replace(snr_db=want.snr_db + 0.01)
    assert equalizer_cuda.compare_with_plain(bad, want, args[2], eq, 1)["fault_rows"] == B

    # a frame slot of idle air (zero taps: NaN and infinite soft symbols, the
    # same in both) is a clean row; a NaN against a number is a fault
    silent = torch.cat([torch.zeros_like(args[0][:, :2]), args[0][:, 2:]], dim=1)
    idle = equalizer._equalize_frame_torch(silent, torch.zeros_like(args[1]), *args[2:])
    assert bool(idle.soft.isnan().any()) and bool(idle.soft.isinf().any()) and bool(idle.snr_db.isnan().any())
    same = equalizer_cuda.compare_with_plain(idle, idle, args[2], eq, 1)
    assert (same["boundary_rows"], same["fault_rows"]) == (0, 0)
    assert equalizer_cuda.compare_with_plain(idle, want, args[2], eq, 1)["fault_rows"] == B


# ---------------------------------------------------------------------------
# CPU: dispatcher, refusals, bytes, constants
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    eq = eq_tables("cpu")
    cnst = np.array([1, 2, 3, 4], np.int32)
    spectra, taps0 = frame_inputs(eq, 4, 3, 1, cnst, seed=1)
    args = (torch.as_tensor(spectra), torch.as_tensor(taps0), torch.as_tensor(cnst), eq, 1)
    before = equalizer_cuda.equalize_frame_cuda.LAUNCHES
    got = equalizer.equalize_frame(*args)
    want = equalizer._equalize_frame_torch(*args)
    assert equalizer_cuda.equalize_frame_cuda.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    eq = eq_tables("cpu")
    cnst = torch.ones(2, dtype=torch.int32)
    spectra, taps0 = (torch.as_tensor(a) for a in frame_inputs(eq, 2, 3, 1, cnst.numpy(), seed=2))
    call = equalizer_cuda.equalize_frame_cuda
    before = call.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(spectra, taps0, cnst, eq, 1)
    with pytest.raises(ValueError, match="complex64"):
        call(spectra.to(torch.complex128), taps0, cnst, eq, 1)
    with pytest.raises(ValueError, match="complex64"):
        call(spectra[0], taps0, cnst, eq, 1)
    with pytest.raises(ValueError, match="unit stride"):
        call(spectra.repeat(1, 1, 2)[:, :, ::2], taps0, cnst, eq, 1)
    with pytest.raises(ValueError, match=f"multiple of 32 up to {equalizer_cuda.MAX_FFT_LEN}"):
        call(spectra[:, :, :48], taps0, cnst, eq, 1)
    with pytest.raises(ValueError, match=f"multiple of 32 up to {equalizer_cuda.MAX_FFT_LEN}"):
        call(spectra.repeat(1, 1, 5), taps0, cnst, eq, 1)
    with pytest.raises(ValueError, match="at least one frame"):
        call(spectra[:0], taps0[:0], cnst[:0], eq, 1)
    assert call.LAUNCHES == before


def test_equalizer_bytes_counts_every_input_and_output_once():
    # a payload call of the uncoded step: 31,756 bytes a row
    assert equalizer_cuda.equalizer_bytes(2048, 20, 64) == 65_036_288
    assert equalizer_cuda.equalizer_bytes(1, 1, 64) == 3 * 512 + 2 * 512 + 12
    assert equalizer_cuda.equalizer_bytes(2048, 1, 64) == 2048 * 2572


def test_library_path_needs_no_compiler():
    assert equalizer_cuda.library_path().name.startswith("libequalizer_")
    assert equalizer_cuda.SOURCE.is_file()


def test_compare_with_plain_takes_decisions_an_ulp_apart_as_one():
    """The closed-form slicers and the native table hold the 8PSK and 16QAM
    points an ulp apart: with decision_atol the two plain loops agree."""
    eq_c, eq_n = eq_tables("cpu"), eq_tables("cpu", tables="native")
    B = 8
    cnst = bench_equalizer.mixed_ids(B)
    args = bench_equalizer.on_device(frame_inputs(eq_c, B, 6, 1, cnst, seed=5), cnst, "cpu")
    got, want = equalizer.equalize_frame(*args, eq_n, 1), equalizer.equalize_frame(*args, eq_c, 1)
    assert not torch.equal(got.hard, want.hard)
    strict = equalizer_cuda.compare_with_plain(got, want, args[2], eq_c, 1)
    loose = equalizer_cuda.compare_with_plain(got, want, args[2], eq_c, 1, decision_atol=1e-6)
    assert strict["fault_rows"] > 0 and loose["fault_rows"] == loose["boundary_rows"] == 0


def test_table_mode_plain_loop_on_foreign_tables():
    """The plain loop in table mode: each decision is the foreign table's
    argmin, and the relabeling moves no point, so the closed form decides
    the same points (within an ulp)."""
    eq_t, eq_c = eq_tables("cpu", tables="foreign"), eq_tables("cpu")
    assert eq_t.tab.table_mode and not eq_c.tab.table_mode
    B = 12
    cnst = bench_equalizer.mixed_ids(B)
    args = bench_equalizer.on_device(frame_inputs(eq_t, B, 4, 1, cnst, seed=6), cnst, "cpu")
    got = equalizer.equalize_frame(*args, eq_t, 1)
    data = eq_t.occ_mask & ~eq_t.pilot_mask
    assert torch.equal(got.hard[:, :, data], cn.nearest_point_table(got.soft[:, :, data], args[2][:, None, None],
                                                                    eq_t.tab)[1])
    want = equalizer.equalize_frame(*args, eq_c, 1)
    res = equalizer_cuda.compare_with_plain(got, want, args[2], eq_c, 1, decision_atol=1e-6)
    assert res["fault_rows"] == res["boundary_rows"] == 0


def test_source_table_mode_matches_the_tables():
    """The table-mode slicer's layout: rows of MAX_POINTS, N_TYPES rows,
    2^id valid points (bits per symbol equal the id)."""
    src = equalizer_cuda.SOURCE.read_text()
    assert int(re.search(r"constexpr int kMaxPoints = (\d+);", src).group(1)) == cn.MAX_POINTS
    assert int(re.search(r"constexpr int kTypes = (\d+);", src).group(1)) == cn.N_TYPES
    np.testing.assert_array_equal(cn.BITS_PER_SYMBOL, np.arange(cn.N_TYPES))
    np.testing.assert_array_equal(cn.VALID_MASK, np.arange(cn.MAX_POINTS)[None, :] < (1 << np.arange(cn.N_TYPES))[:, None] * (np.arange(cn.N_TYPES) > 0)[:, None])
    assert "__fmul_rn(dr, dr)" in src and "__fadd_rn(" in src


def test_source_constants_are_the_slicers_float32_values():
    """The kernel decides with the constants of ops/constellation.py,
    rounded to float32 as PyTorch rounds a Python scalar."""
    src = equalizer_cuda.SOURCE.read_text()
    consts = {k: np.float32(v) for k, v in re.findall(r"constexpr float (k\w+) = ([0-9.e+-]+)f;", src)}
    lvl = np.float32(1.0) / np.sqrt(np.float32(10.0))
    want = {"kQpskAmp": np.float32(0.5 * np.sqrt(2.0) / 2.0), "kFourOverPi": np.float32(4.0 / math.pi),
            "kPiOverFour": np.float32(math.pi / 4.0), "kQamLevel": lvl, "kQamTwoLevel": np.float32(2.0) * lvl}
    assert consts == want
    assert np.float32(0.5 * np.sqrt(2.0) / 2.0) == cn.POINTS[2, 3].real
    assert np.isclose(lvl, cn.POINTS[4, 3].real)
    assert int(re.search(r"constexpr int kMaxFftLen = (\d+);", src).group(1)) == equalizer_cuda.MAX_FFT_LEN
    assert "use_fast_math" not in " ".join(equalizer_cuda.NVCC_FLAGS)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def hold_to_the_bar(got, want, cnst, eq, sym_offset):
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
    res = equalizer_cuda.compare_with_plain(got, want, cnst, eq, sym_offset)
    assert res["fault_rows"] == 0, res
    assert res["boundary_rows"] <= max(1, res["rows"] // 1000), res
    return res


CNST_CASES = {"bpsk": [1], "qpsk": [2], "psk8": [3], "qam16": [4], "mixed": [1, 2, 3, 4, 0]}


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.8, 1.0])
@pytest.mark.parametrize("case", list(CNST_CASES))
@pytest.mark.parametrize("n_sym", [1, 4, 20])
@pytest.mark.parametrize("B", [1, 2, 31, 32, 33, 2048])
def test_equalizer_kernel_matches_plain_loop(gpu, B, n_sym, case, alpha):
    """Both branches (alpha 1.0 freezes the taps), every constellation alone
    and mixed (with an id 0, decided as BPSK), one launch a call."""
    eq = eq_tables(gpu, alpha)
    ids = CNST_CASES[case]
    cnst = np.array([ids[i % len(ids)] for i in range(B)], np.int32)
    sym_offset = 0 if n_sym == 1 else 1
    spectra, taps0 = frame_inputs(eq, B, n_sym, sym_offset, cnst, seed=B + 7 * n_sym)
    args = (torch.as_tensor(spectra, device=gpu), torch.as_tensor(taps0, device=gpu),
            torch.as_tensor(cnst, device=gpu), eq, sym_offset)
    before = equalizer_cuda.equalize_frame_cuda.LAUNCHES
    got = equalizer.equalize_frame(*args)
    assert equalizer_cuda.equalize_frame_cuda.LAUNCHES == before + 1
    want = equalizer._equalize_frame_torch(*args)
    hold_to_the_bar(got, want, args[2], eq, sym_offset)
    if alpha >= equalizer_cuda.FROZEN_ALPHA:
        assert got.taps is args[1]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 2048])
def test_equalizer_kernel_takes_the_receivers_strided_views(gpu, B):
    """Header and payload as slices of the frame's [B, 23, 64] spectra, the
    payload pass from the header pass's taps, int64 ids through the
    dispatcher."""
    eq = eq_tables(gpu)
    cnst = np.arange(B, dtype=np.int32) % 4 + 1
    data, taps0 = frame_inputs(eq, B, 1 + FRAME_LENGTH, 0, cnst, seed=B)
    frame = torch.zeros((B, 2 + 1 + FRAME_LENGTH, 64), dtype=torch.complex64, device=gpu)
    frame[:, 2:] = torch.as_tensor(data, device=gpu)
    taps = torch.as_tensor(taps0, device=gpu)
    ids = torch.as_tensor(cnst, device=gpu).long()
    hdr = equalizer.equalize_frame(frame[:, 2:3], taps, torch.ones_like(ids), eq, 0)
    hold_to_the_bar(hdr, equalizer._equalize_frame_torch(frame[:, 2:3], taps, torch.ones_like(ids), eq, 0),
                    torch.ones_like(ids), eq, 0)
    pay = equalizer.equalize_frame(frame[:, 3:], hdr.taps, ids, eq, 1)
    hold_to_the_bar(pay, equalizer._equalize_frame_torch(frame[:, 3:], hdr.taps, ids, eq, 1), ids, eq, 1)


@pytest.mark.cuda
def test_equalizer_kernel_on_idle_carriers_and_zero_references(gpu):
    """Idle carriers keep their taps and give soft = Y / H; a pilot value of
    0 updates with Y / 1; nothing turns NaN where the plain version gives a
    number."""
    eq = eq_tables(gpu)
    eq = dataclasses.replace(eq, pilot_vals=eq.pilot_vals.clone())
    pil = torch.nonzero(eq.pilot_mask)[:, 0]
    eq.pilot_vals[2, pil[0]] = 0
    cnst = np.array([0, 1, 2, 3, 4, 7, -1, 4], np.int32)
    spectra, taps0 = frame_inputs(eq, 8, 6, 1, cnst, seed=11)
    args = (torch.as_tensor(spectra, device=gpu), torch.as_tensor(taps0, device=gpu),
            torch.as_tensor(cnst, device=gpu), eq, 1)
    got, want = equalizer.equalize_frame(*args), equalizer._equalize_frame_torch(*args)
    hold_to_the_bar(got, want, args[2], eq, 1)
    idle = ~(eq.occ_mask | eq.pilot_mask)
    assert torch.equal(got.taps[:, idle], args[1][:, idle])
    assert bool(torch.isfinite(got.soft.abs()).all()) and bool(torch.isfinite(got.taps.abs()).all())


@pytest.mark.cuda
def test_equalizer_kernel_on_a_silent_frame_slot(gpu):
    """A slot of idle air (zero spectra in its first symbols, zero taps)
    gives the plain loop's infinities and NaNs, and the rows beside it are
    untouched by them."""
    eq = eq_tables(gpu)
    cnst = np.array([2, 4, 3, 1], np.int32)
    spectra, taps0 = frame_inputs(eq, 4, 6, 1, cnst, seed=13)
    spectra[1, :2] = 0
    taps0[1] = 0
    args = (torch.as_tensor(spectra, device=gpu), torch.as_tensor(taps0, device=gpu),
            torch.as_tensor(cnst, device=gpu), eq, 1)
    got, want = equalizer.equalize_frame(*args), equalizer._equalize_frame_torch(*args)
    res = hold_to_the_bar(got, want, args[2], eq, 1)
    assert res["boundary_rows"] == 0
    assert bool(got.soft[1].isnan().any()) and bool(torch.isfinite(got.soft[[0, 2, 3]].abs()).all())


@pytest.mark.cuda
def test_equalizer_wrapper_refuses_on_the_card(gpu):
    eq = eq_tables(gpu)
    cnst = torch.ones(2, dtype=torch.int32, device=gpu)
    spectra, taps0 = (torch.as_tensor(a, device=gpu) for a in frame_inputs(eq, 2, 3, 1, cnst.cpu().numpy(), seed=2))
    call = equalizer_cuda.equalize_frame_cuda
    with pytest.raises(ValueError, match="int32"):
        call(spectra, taps0, cnst.long(), eq, 1)
    with pytest.raises(ValueError, match="init_taps"):
        call(spectra, taps0.repeat(1, 2)[:, ::2], cnst, eq, 1)
    with pytest.raises(ValueError, match="init_taps"):
        call(spectra, taps0.cpu(), cnst, eq, 1)
    with pytest.raises(ValueError, match="rows of pilot values"):
        call(spectra, taps0, cnst, eq, FRAME_LENGTH)
    with pytest.raises(ValueError, match="eq.occ_mask"):
        call(spectra, taps0, cnst, eq_tables("cpu"), 1)


def _table_inputs(gpu, B, n_sym, ids, seed, boundary=False, tables="foreign", alpha=0.8):
    eq = eq_tables(gpu, alpha, tables)
    cnst = np.array([ids[i % len(ids)] for i in range(B)], np.int32)
    sym_offset = 0 if n_sym == 1 else 1
    make = bench_equalizer.boundary_inputs if boundary else frame_inputs
    spectra, taps0 = make(eq, B, n_sym, sym_offset, cnst, seed)
    return eq, (torch.as_tensor(spectra, device=gpu), torch.as_tensor(taps0, device=gpu),
                torch.as_tensor(cnst, device=gpu), eq, sym_offset)


def hold_bit_equal(got, want):
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert bench_equalizer.rows_not_bit_equal(got, want) == 0
    for a, b in zip(got[3:], want[3:]):  # snr_db, noise_var: sums in another order
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("tables", ["foreign", "native"])
@pytest.mark.parametrize("case", list(CNST_CASES))
@pytest.mark.parametrize("n_sym", [1, 20])
@pytest.mark.parametrize("B", [1, 33, 2048])
def test_table_mode_kernel_is_bit_equal_to_plain_loop(gpu, B, n_sym, case, tables):
    """Table mode on the foreign and on the native tables, every
    constellation alone and mixed (with an id 0: no valid point), one
    launch a call: hard, soft and taps bit-equal to the plain loop."""
    eq, args = _table_inputs(gpu, B, n_sym, CNST_CASES[case], seed=B + 7 * n_sym, tables=tables)
    before = equalizer_cuda.equalize_frame_cuda.LAUNCHES
    got = equalizer.equalize_frame(*args)
    assert equalizer_cuda.equalize_frame_cuda.LAUNCHES == before + 1
    hold_bit_equal(got, equalizer._equalize_frame_torch(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.8, 1.0])
def test_table_mode_kernel_at_the_decision_boundaries(gpu, alpha):
    """Symbols placed within 2e-6 of a boundary, where one rounding decides:
    still bit-equal (the distances are rounded as PyTorch rounds them)."""
    eq, args = _table_inputs(gpu, 2048, 20, [1, 2, 3, 4], seed=7, boundary=True, alpha=alpha)
    got = equalizer.equalize_frame(*args)
    hold_bit_equal(got, equalizer._equalize_frame_torch(*args))
    if alpha >= equalizer_cuda.FROZEN_ALPHA:
        assert got.taps is args[1]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [33, 2048])
def test_table_mode_on_native_tables_decides_as_the_closed_form(gpu, B):
    eq_n, args = _table_inputs(gpu, B, 20, [1, 2, 3, 4], seed=B, tables="native")
    eq_c = eq_tables(gpu)
    got = equalizer.equalize_frame(*args[:3], eq_n, 1)
    want = equalizer.equalize_frame(*args[:3], eq_c, 1)
    torch.cuda.synchronize()
    res = equalizer_cuda.compare_with_plain(got, want, args[2], eq_c, 1, decision_atol=1e-6)
    assert res["fault_rows"] == 0 and res["boundary_rows"] <= max(1, B // 1000), res


# ---------------------------------------------------------------------------
# the card: the redesigned step (tables of the update's divisors, a warp's
# pilot entries refilled a chunk at a time, header-only calls dividing in
# the step) at the widths, batches and views the other tests do not reach
# ---------------------------------------------------------------------------

from test_torch_equalizer_plan import IDS, PILOTS, custom_eq, frames  # noqa: E402

PILOTS_WIDE = {**PILOTS, 256: [c for c in range(-93, 94, 12) if c]}  # two or three a warp of 32
MANY_PILOTS = list(range(-32, -6, 2)) + [9]  # 13 in one warp: its entries refilled every other symbol


def _custom_args(gpu, fft_len, B, alpha, table, pilots=None, n_sym=21, off=0, seed=0):
    tab = bench_equalizer.wire_tables(gpu) if table else None
    eq = custom_eq(fft_len, PILOTS_WIDE[fft_len] if pilots is None else pilots, alpha, tab=tab, seed=fft_len)
    eq = dataclasses.replace(eq, occ_mask=eq.occ_mask.to(gpu), pilot_mask=eq.pilot_mask.to(gpu),
                             pilot_vals=eq.pilot_vals.to(gpu))
    ids = np.resize(np.where(IDS < cn.N_TYPES, IDS, 0) if table else IDS, B).astype(np.int32)
    eq_cpu = custom_eq(fft_len, PILOTS_WIDE[fft_len] if pilots is None else pilots, alpha, seed=fft_len)
    data, taps0 = frames(eq_cpu, B, n_sym, off, ids, seed=seed + B)
    return eq, (torch.as_tensor(data, device=gpu), torch.as_tensor(taps0, device=gpu),
                torch.as_tensor(ids, device=gpu))


def _held(eq, args, off, table):
    got = equalizer.equalize_frame(*args, eq, off)
    want = equalizer._equalize_frame_torch(*args, eq, off)
    if table:
        hold_bit_equal(got, want)
    else:
        hold_to_the_bar(got, want, args[2], eq, off)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("table", [False, True], ids=["closed", "table"])
@pytest.mark.parametrize("alpha", [0.1, 1.0])
@pytest.mark.parametrize("fft_len, B", [(32, 5), (32, 2047), (64, 33), (128, 7), (128, 1025), (256, 3)])
def test_kernel_at_other_widths_and_ragged_batches(gpu, fft_len, B, alpha, table):
    """fft_len 32 (four rows a block) to 256 (a row of eight warps), B not a
    multiple of a block's rows, ids 0-5 (0-4 in table mode), updating and
    frozen taps: the header-only call, the payload call from its taps and a
    call that holds both, one launch each; the closed form to the plain
    loop's bar, table mode bit-equal."""
    eq, (data, taps0, ids) = _custom_args(gpu, fft_len, B, alpha, table)
    before = equalizer_cuda.equalize_frame_cuda.LAUNCHES
    hdr = _held(eq, (data[:, :1], taps0, torch.ones_like(ids)), 0, table)
    _held(eq, (data[:, 1:], hdr.taps, ids), 1, table)
    _held(eq, (data, taps0, ids), 0, table)
    assert equalizer_cuda.equalize_frame_cuda.LAUNCHES == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("table", [False, True], ids=["closed", "table"])
@pytest.mark.parametrize("B", [1, 65, 2048])
def test_kernel_refills_a_warps_pilot_entries(gpu, B, table):
    """Thirteen pilots in one warp (two symbols' entries a fill, refilled
    every other symbol of 20) and one in the other: pilot carriers decide
    their own symbol's value and update by it."""
    eq, (data, taps0, ids) = _custom_args(gpu, 64, B, 0.1, table, pilots=MANY_PILOTS, n_sym=20, off=1)
    got = _held(eq, (data, taps0, ids), 1, table)
    pil = eq.pilot_mask
    assert torch.equal(got.hard[:, :, pil], eq.pilot_vals[1:21, pil][None].expand(B, -1, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("table", [False, True], ids=["closed", "table"])
@pytest.mark.parametrize("B", [3, 1025])
def test_kernel_takes_strided_views_at_fft_len_128(gpu, B, table):
    """Header and payload as slices of [B, 23, 128] spectra (row stride
    2944, symbol stride 128), the payload from the header pass's taps."""
    eq, (data, taps0, ids) = _custom_args(gpu, 128, B, 0.1, table)
    frame = torch.zeros((B, 2 + data.shape[1], 128), dtype=torch.complex64, device=gpu)
    frame[:, 2:] = data
    hdr = _held(eq, (frame[:, 2:3], taps0, torch.ones_like(ids)), 0, table)
    assert not frame[:, 3:].is_contiguous()
    _held(eq, (frame[:, 3:], hdr.taps, ids), 1, table)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.8, 1.0])
def test_closed_form_at_the_decision_boundaries(gpu, alpha):
    """Symbols placed within 2e-6 of a boundary, every constellation, B =
    2048: no fault row (a row may part from the plain loop only where its
    equalized value lies within 1e-5 of a boundary)."""
    eq = eq_tables(gpu, alpha)
    cnst = bench_equalizer.mixed_ids(2048)
    args = bench_equalizer.on_device(bench_equalizer.boundary_inputs(eq, 2048, 20, 1, cnst, 7), cnst, gpu)
    got, want = equalizer.equalize_frame(*args, eq, 1), equalizer._equalize_frame_torch(*args, eq, 1)
    torch.cuda.synchronize()
    assert equalizer_cuda.compare_with_plain(got, want, args[2], eq, 1)["fault_rows"] == 0


@pytest.mark.cuda
def test_b2048_fits_one_wave_of_blocks(gpu):
    """Every block of a B = 2048 call is resident at once, in both
    instantiations (the design counts on it)."""
    rows = equalizer_cuda.rows_per_block(64)
    for table in (False, True):
        assert -(-2048 // rows) <= torch.cuda.get_device_properties(gpu).multi_processor_count * \
            equalizer_cuda.resident_blocks(64, table)
