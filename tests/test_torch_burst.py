"""The feedback-burst modem of the port against the JAX package's: host
constants bit-equal, ``burst_tx`` / ``burst_rx`` and the continuous scanner's
block step on the same seeded numpy captures.

Tolerances: ints, bits and bools equal.  Waveforms (values ~0.5) to atol
2e-6 and the CFO estimate (rad/sample, ~1e-3) to atol 1e-6: float32
convolutions summed in another order on the two sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.ops import burst as ref_burst

from gr_dtl_tpu_torch.ops import burst

REF = ref_burst.build_burst_modem()
MODEM = burst.burst_modem_from_reference(REF, "cpu")
LB = ref_burst.burst_wave_len(REF)


def test_burst_tables_equal_the_reference_dict():
    mine = burst.make_burst_tables()
    assert mine.keys() == REF.keys()
    assert (mine["sps"], mine["ntaps"]) == (REF["sps"], REF["ntaps"])
    for k in ("taps", "preamble_wave"):
        a, b = mine[k], np.asarray(REF[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in ("D", "T", "init_term"):
        assert np.array_equal(mine["crc_tables"][k], np.asarray(REF["crc_tables"][k])), k
    assert mine["crc_tables"]["spec"] == burst.gf2.CRC8_FEEDBACK
    assert np.array_equal(burst.ACCESS_CODE_BITS, ref_burst.ACCESS_CODE_BITS)
    assert burst.N_BURST_BITS == ref_burst.N_BURST_BITS
    assert np.array_equal(burst.rrc_taps(4, 0.2, 33, 2.0), ref_burst.rrc_taps(4, 0.2, 33, 2.0))
    built = burst.build_burst_modem("cpu")
    assert torch.equal(built.taps, MODEM.taps) and torch.equal(built.preamble_wave, MODEM.preamble_wave)
    assert burst.burst_wave_len(built) == LB == 198


@pytest.mark.parametrize("pad", [32, 0])
def test_burst_tx_matches_reference(pad):
    cnst = np.array([1, 2, 3, 4, 0, 255, 17], np.int32)
    fec = np.array([0, 1, 2, 0, 7, 255, 3], np.int32)
    want = np.asarray(ref_burst.burst_tx(jnp.asarray(cnst), jnp.asarray(fec), REF, pad=pad))
    got = burst.burst_tx(torch.as_tensor(cnst), torch.as_tensor(fec), MODEM, pad=pad).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (7, LB + 2 * pad)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    # the bits themselves: access code | cnst | fec | crc8
    bits_r = np.asarray(ref_burst._burst_bits(jnp.asarray(cnst), jnp.asarray(fec), REF))
    bits = burst._burst_bits(torch.as_tensor(cnst), torch.as_tensor(fec), MODEM).numpy()
    np.testing.assert_array_equal(bits, bits_r)


def _captures(n, seed, noise=0.1, with_burst=True):
    """n captures of 300 samples: a burst at a random delay, with a CFO, a
    phase, a gain and AWGN; (captures, cnst, fec)."""
    rng = np.random.RandomState(seed)
    cnst = rng.randint(1, 5, n).astype(np.int32)
    fec = rng.randint(0, 3, n).astype(np.int32)
    wave = np.asarray(ref_burst.burst_tx(jnp.asarray(cnst), jnp.asarray(fec), REF, pad=0))
    cap = np.zeros((n, 300), np.complex64)
    for i in range(n):
        d = rng.randint(0, 300 - LB)
        if with_burst:
            cap[i, d: d + LB] = wave[i] * rng.uniform(0.5, 2.0) * np.exp(1j * rng.uniform(0, 6.28))
    k = np.arange(300)
    cap = cap * np.exp(1j * rng.uniform(-0.004, 0.004, (n, 1)) * k)
    cap = cap + noise * (rng.randn(n, 300) + 1j * rng.randn(n, 300)) / np.sqrt(2)
    return cap.astype(np.complex64), cnst, fec


def _assert_rx_equal(got, want, cfo_mask=None):
    for k in ("cnst_id", "fec_id", "ok", "peak_pos"):
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    g, w = got.cfo.numpy(), np.asarray(want.cfo)
    m = slice(None) if cfo_mask is None else cfo_mask
    np.testing.assert_allclose(g[m], w[m], rtol=0, atol=1e-6)


def test_burst_rx_matches_reference_and_decodes():
    cap, cnst, fec = _captures(48, seed=1)
    want = jax.jit(lambda s: ref_burst.burst_rx(s, REF))(jnp.asarray(cap))
    got = burst.burst_rx(torch.as_tensor(cap), MODEM)
    _assert_rx_equal(got, want)
    assert got.ok.all()
    np.testing.assert_array_equal(got.cnst_id.numpy(), cnst)
    np.testing.assert_array_equal(got.fec_id.numpy(), fec)


def test_burst_rx_on_noise_alone_matches_reference_and_decodes_none():
    cap, _, _ = _captures(32, seed=2, noise=0.3, with_burst=False)
    want = jax.jit(lambda s: ref_burst.burst_rx(s, REF))(jnp.asarray(cap))
    got = burst.burst_rx(torch.as_tensor(cap), MODEM)
    _assert_rx_equal(got, want)
    assert not got.ok.any()


def test_burst_rx_on_a_burst_cut_off_by_the_capture_matches_reference():
    """A burst that starts 60 samples before the capture ends: the
    correlation peak lies past the end of the second half-preamble
    correlation, the reference's ``take_along_axis`` fills NaN there, and the
    capture decodes to nothing with a NaN CFO estimate on both sides."""
    wave = np.asarray(ref_burst.burst_tx(jnp.asarray([3], jnp.int32), jnp.asarray([1], jnp.int32),
                                         REF, pad=0))[0]
    cap = np.zeros((2, 300), np.complex64)
    cap[0, 240:] = wave[:60]
    cap[1, 40: 40 + LB] = wave  # a whole burst beside it
    cap += (0.01 * np.random.RandomState(6).randn(2, 300)).astype(np.complex64)
    want = jax.jit(lambda s: ref_burst.burst_rx(s, REF))(jnp.asarray(cap))
    got = burst.burst_rx(torch.as_tensor(cap), MODEM)
    _assert_rx_equal(got, want)
    assert got.ok.tolist() == [False, True] and bool(torch.isnan(got.cfo[0]))
    assert np.isnan(np.asarray(want.cfo)[0])


BLOCK = 1024


def _both_steps(ext, max_bursts=4):
    step_r, tail_r = ref_burst.build_stream_burst_rx(REF, BLOCK, max_bursts)
    step, tail = burst.build_stream_burst_rx(MODEM, BLOCK, max_bursts)
    assert tail == tail_r == LB
    want = jax.jit(step_r)(jnp.asarray(ext))
    got = step(torch.as_tensor(ext))
    return got, want


def _ext(placed, seed, noise=0.02):
    """tail + block samples with bursts (start, cnst, fec, gain) placed in."""
    rng = np.random.RandomState(seed)
    T = LB + BLOCK
    ext = noise * (rng.randn(T) + 1j * rng.randn(T)) / np.sqrt(2)
    for s, c, f, gain in placed:
        w = np.asarray(ref_burst.burst_tx(jnp.asarray([c], jnp.int32), jnp.asarray([f], jnp.int32),
                                          REF, pad=0))[0]
        n = min(LB, T - s)
        ext[s: s + n] += gain * w[:n]
    return ext.astype(np.complex64)


def test_stream_step_matches_reference_and_fills_empty_slots_like_top_k():
    """Two bursts in the owned region and one past it: the two are found,
    strongest first; the unfilled slots come back as positions 0, 1 (the
    reference's ``top_k`` returns the lowest indices among equal scores),
    with ok False."""
    ext = _ext([(700, 3, 1, 1.0), (150, 2, 0, 1.4), (BLOCK + 40, 4, 2, 1.0)], seed=3)
    got, want = _both_steps(ext)
    found = np.array([True, True, False, False])
    _assert_rx_equal(got, want, cfo_mask=found)
    assert got.peak_pos.tolist() == [150, 700, 0, 1]
    assert got.ok.tolist() == [True, True, False, False]
    assert got.cnst_id.tolist()[:2] == [2, 3] and got.fec_id.tolist()[:2] == [0, 1]


def test_stream_step_on_noise_returns_the_first_positions_and_nothing_ok():
    ext = _ext([], seed=4, noise=0.3)
    got, want = _both_steps(ext, max_bursts=6)
    _assert_rx_equal(got, want, cfo_mask=np.zeros(6, bool))
    assert got.peak_pos.tolist() == [0, 1, 2, 3, 4, 5] and not got.ok.any()


@pytest.mark.parametrize("gap,weak_first,weak_found", [
    (99, True, False),   # a stronger start 99 to the right is inside the window
    (100, True, True),   # 100 to the right is not
    (98, False, False),  # a stronger start 98 to the left is inside
    (99, False, True),   # 99 to the left is not
])
def test_stream_step_window_reaches_98_left_and_99_right(gap, weak_first, weak_found):
    """The suppression window of 198 is even: the reference's "SAME"
    padding puts 98 on the left and 99 on the right.  A bare preamble and a
    stronger one ``gap`` samples away: whether the weaker start survives
    tells the reach on that side."""
    pre = np.asarray(REF["preamble_wave"])
    rng = np.random.RandomState(5)
    T = LB + BLOCK
    ext = (0.01 * (rng.randn(T) + 1j * rng.randn(T))).astype(np.complex64)
    weak, strong = (400, 400 + gap) if weak_first else (400 + gap, 400)
    ext[weak: weak + len(pre)] += pre
    ext[strong: strong + len(pre)] += 1.25 * pre  # its skirt one sample off (0.61 of the peak) stays under the weak peak
    got, want = _both_steps(ext)
    np.testing.assert_array_equal(got.peak_pos.numpy(), np.asarray(want.peak_pos))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    pos = got.peak_pos.tolist()
    assert pos[0] == strong
    assert (weak in pos) == weak_found, pos
