"""The streaming plumbing, port against the JAX package: PDU packing, the
trigger lock scan, lost-frame accounting, the constellation metric, the
MCS decision (step, scan, masked scan), the MCS tables and the carried
state converters.  Both sides get the same numpy-drawn inputs; the
reference's scans run under jax.jit on the CPU.

Bytes, ints and bools must be equal.  The one float output, the
constellation metric, is held to rtol 1e-5: a mean of 10 squared float32
differences divided by a constant, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import adaptive as ref_adaptive
from gr_dtl_tpu.models import streaming as ref_streaming
from gr_dtl_tpu.ops import constellation as ref_cn
from gr_dtl_tpu.ops import metrics as ref_metrics
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch.models import adaptive, streaming
from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.ops import metrics, scans_cuda
from gr_dtl_tpu_torch.utils import config


def _pdus(rng, sizes):
    return [rng.randint(0, 256, n).astype(np.uint8).tobytes() for n in sizes]


QUEUES = {
    "whole": [30, 30, 30, 10, 50, 99, 1],
    "jumbo": [20, 20, 250, 20, 20],
    "jumbo_exact": [200, 100, 5],
    "empty": [],
    "single_byte": [1] * 7,
}


@pytest.mark.parametrize("name", list(QUEUES))
@pytest.mark.parametrize("max_frames", [None, 2])
def test_pack_pdus_matches_reference(name, max_frames):
    pdus = _pdus(np.random.RandomState(len(name)), QUEUES[name])
    got = streaming.pack_pdus(list(pdus), 100, max_frames)
    want = ref_streaming.pack_pdus(list(pdus), 100, max_frames)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert got[2] == want[2]


@pytest.mark.parametrize("name", list(QUEUES))
@pytest.mark.parametrize("budget", [1, 3, 16])
def test_pack_pdus_budget_matches_reference(name, budget):
    """Called block after block until the queue runs dry, with the jumbo
    carry handed on: frames, leftover queue and carry equal at every call."""
    pdus = _pdus(np.random.RandomState(len(name) + 1), QUEUES[name])
    q_got, q_want = list(pdus), list(pdus)
    rest_got = rest_want = b""
    for _ in range(12):
        f_got, rest_got = streaming.pack_pdus_budget(q_got, rest_got, 100, budget)
        f_want, rest_want = ref_streaming.pack_pdus_budget(q_want, rest_want, 100, budget)
        assert f_got == f_want and rest_got == rest_want and q_got == q_want
    assert not q_got and not rest_got


def _lock_cases():
    P = 1000
    k = np.arange(12)
    rng = np.random.RandomState(0)
    cases = {
        # three consistent triggers lock; the jitter stays inside tol
        "lock": (k * P + 300 + np.array([0, 1, -1, 2, 0, 0, 1, 4, -4, 0, 1, 0]), np.ones(12, bool)),
        # locked, then candidates missing or far off: synthesized from the period
        "synthesis": (k * P + 300 + np.array([0, 0, 0, 0, 400, 0, 0, -77, 0, 0, 0, 0]),
                      np.array([1, 1, 1, 1, 1, 0, 1, 1, 0, 0, 1, 1], bool)),
        # five misses in a row unlock; a found candidate then re-seeds
        "unlock": (k * P + 300 + np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 50, 50, 50]),
                   np.array([1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1], bool)),
        "never_found": (k * P, np.zeros(12, bool)),
        "random": (np.arange(64) * P + rng.randint(-6, 7, 64), rng.rand(64) > 0.3),
    }
    return P, cases


@pytest.mark.parametrize("name", list(_lock_cases()[1]))
def test_trigger_lock_scan_matches_reference(name):
    """Two successive calls with the state carried and rebased between
    them, as the session does: outputs and every state word equal."""
    P, cases = _lock_cases()
    cand, found = cases[name]
    cand = cand.astype(np.int32)
    half = len(cand) // 2
    ref_scan = jax.jit(lambda s, c, f: ref_streaming.trigger_lock_scan(s, c, f, P))
    ref_state = ref_streaming.TriggerLockState(jnp.asarray(False), jnp.asarray(0),
                                               jnp.asarray(0), jnp.asarray(0))
    state = streaming.initial_lock_state("cpu")
    for sl, shift in ((slice(0, half), 0), (slice(half, None), (half + 3) * P)):
        ref_state, (trig_r, valid_r) = ref_scan(ref_state, jnp.asarray(cand[sl] - shift),
                                                jnp.asarray(found[sl]))
        state, (trig, valid) = streaming.trigger_lock_scan(
            state, torch.as_tensor(cand[sl] - shift), torch.as_tensor(found[sl]), P)
        np.testing.assert_array_equal(trig.numpy(), np.asarray(trig_r))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_r))
        assert trig.dtype == torch.int32 and valid.dtype == torch.bool
        got = streaming.lock_state_to_numpy(state)
        for g, w in zip(got, ref_state):
            assert g == np.asarray(w) and g.dtype == np.asarray(w).dtype
        # rebase the expectation into the next block's coordinates (negative values too)
        ref_state = ref_state._replace(expected=ref_state.expected - (half + 3) * P)
        state = state._replace(expected=state.expected - (half + 3) * P)
    if name == "lock":
        assert got[0] and got[2] >= streaming.LOCK_AFTER
    if name == "never_found":
        assert not got[0] and not valid.any()


def test_trigger_lock_scan_empty_and_constants():
    assert (streaming.LOCK_AFTER, streaming.UNLOCK_AFTER) == (
        ref_streaming.LOCK_AFTER, ref_streaming.UNLOCK_AFTER)
    state = streaming.initial_lock_state("cpu")
    s2, (trig, valid) = streaming.trigger_lock_scan(
        state, torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.bool), 100)
    assert trig.shape == (0,) and valid.shape == (0,)
    assert streaming.lock_state_to_numpy(s2) == streaming.lock_state_to_numpy(state)


def test_lock_state_converters_round_trip():
    ref_state = ref_streaming.TriggerLockState(jnp.asarray(True), jnp.asarray(-1234),
                                               jnp.asarray(7), jnp.asarray(2))
    state = streaming.lock_state_from_reference(tuple(np.asarray(a) for a in ref_state), "cpu")
    assert state.locked.dtype == torch.bool
    assert all(a.dtype == torch.int32 and a.ndim == 0 for a in state[1:])
    back = streaming.lock_state_to_numpy(state)
    for g, w in zip(back, ref_state):
        assert g == np.asarray(w) and g.dtype == np.asarray(w).dtype


LOST_CASES = {
    # frame numbers, header_ok, expected_first
    "in_order": (np.arange(10), np.ones(10, bool), None),
    "gap": (np.array([5, 6, 9, 10, 14]), np.ones(5, bool), None),
    "wrap": (np.array([4093, 4094, 4095, 0, 1, 3]), np.ones(6, bool), None),
    "bad_header": (np.array([7, 8, 999, 10, 11, 0, 13]),
                   np.array([1, 1, 0, 1, 1, 0, 1], bool), None),
    "late_start": (np.array([20, 21, 22]), np.ones(3, bool), 17),
    "first_beyond_12_bits": (np.array([1, 2]), np.ones(2, bool), 4096 + 4095),
    "first_bad": (np.array([100, 3, 4]), np.array([0, 1, 1], bool), 2),
}


@pytest.mark.parametrize("name", list(LOST_CASES))
def test_lost_frames_matches_reference(name):
    nos, ok, first = LOST_CASES[name]
    nos = nos.astype(np.int32)
    want = jax.jit(lambda n, o: ref_metrics.lost_frames(n, o, first))(jnp.asarray(nos),
                                                                     jnp.asarray(ok))
    got = metrics.lost_frames(torch.as_tensor(nos), torch.as_tensor(ok), first)
    assert int(got[0]) == int(want[0]) and int(got[1]) == int(want[1])
    # one float32 division of two small integers: equal
    assert float(got[2]) == float(want[2]) and got[2].dtype == torch.float32


def _ref_session_acct(expected_no, frame_no, ok):
    """The accounting scan of the reference's block step (session.py), which
    the reference defines inline."""

    def acct(exp, x):
        no, okf = x
        gap = jnp.where(exp < 0, 0, (no - exp) % 4096)
        return jnp.where(okf, (no + 1) % 4096, exp), jnp.where(okf, gap, 0)

    return jax.lax.scan(acct, expected_no, (frame_no, ok))


@pytest.mark.parametrize("start", [-1, 0, 4090])
def test_frame_accounting_received_rule_matches_reference(start):
    """The session's rule over three carried blocks: a start at -1, wraps
    past 4095, undecoded slots carrying arbitrary frame numbers."""
    rng = np.random.RandomState(start + 2)
    ref_fn = jax.jit(_ref_session_acct)
    exp_r = jnp.asarray(start, jnp.int32)
    exp = torch.tensor(start, dtype=torch.int32)
    no0 = 4080
    for _ in range(3):
        T = 16
        ok = rng.rand(T) > 0.35
        nos = ((no0 + np.arange(T) + np.cumsum(rng.rand(T) > 0.8)) % 4096).astype(np.int32)
        nos[~ok] = rng.randint(0, 4096, int((~ok).sum()))
        no0 = int(nos[ok][-1]) + 1 if ok.any() else no0
        exp_r, lost_r = ref_fn(exp_r, jnp.asarray(nos), jnp.asarray(ok))
        exp, lost, totals = metrics.frame_accounting(exp, torch.as_tensor(nos), torch.as_tensor(ok))
        np.testing.assert_array_equal(lost.numpy(), np.asarray(lost_r))
        assert int(exp) == int(exp_r) and exp.dtype == torch.int32 and exp.ndim == 0
        assert totals.tolist() == [int(np.asarray(lost_r).sum()), int(ok.sum())]
    with pytest.raises(ValueError):
        metrics.frame_accounting(exp, torch.as_tensor(nos), torch.as_tensor(ok), rule="other")


def test_constellation_metric_matches_reference():
    rng = np.random.RandomState(3)
    B, n_sym, n_car = 8, 10, 48
    cnst = np.tile(np.arange(1, 5, dtype=np.int32), 2)
    cplx = lambda: (rng.randn(B, n_sym, n_car) + 1j * rng.randn(B, n_sym, n_car)).astype(np.complex64)
    hard = cplx()
    soft = hard + 0.05 * cplx()
    want = ref_metrics.constellation_metric(jnp.asarray(hard), jnp.asarray(soft), jnp.asarray(cnst))
    got = metrics.constellation_metric(torch.as_tensor(hard), torch.as_tensor(soft),
                                       torch.as_tensor(cnst))
    assert got.dtype == torch.float32 and got.shape == (B, n_car)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_array_equal(cn.MIN_DIST, ref_cn.MIN_DIST)
    assert cn.MIN_DIST.dtype == ref_cn.MIN_DIST.dtype


def _cfgs(**kw):
    return config.make_rx_config(None, **kw), ref_config.make_rx_config(None, **kw)


def test_build_mcs_tables_bit_equal():
    for kw in ({}, {"fec": True, "fec_codes": (("codeA", "a.alist"), ("codeB", "b.alist")),
                    "mcs": [[0.0, ["bpsk", "codeA"]], [9.5, ["qpsk", "codeB"]],
                            [17.25, ["qam16", "no_fec"]], [30.0, ["psk8", "missing"]]]}):
        cfg, ref_cfg = _cfgs(**kw)
        got, want = adaptive.build_mcs_tables(cfg), ref_adaptive.build_mcs_tables(ref_cfg)
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert got[k] == want[k] and type(got[k]) is type(want[k])
        assert got["snr_th"][0] == -np.inf
        carried = adaptive.tables_from_reference(want)
        np.testing.assert_array_equal(carried["snr_th"], got["snr_th"])
        on_dev = adaptive.tables_to(got, "cpu")
        assert isinstance(on_dev["snr_th"], torch.Tensor) and on_dev["n_mcs"] == got["n_mcs"]


def _snr_walk(rng, shape):
    """SNRs that climb the default ladder (13 / 18 / 23 dB), sit on its
    thresholds and their +1 dB hysteresis edges, and fall back."""
    T = shape[0]
    base = np.concatenate([np.linspace(5, 30, T // 2), np.linspace(30, 2, T - T // 2)])
    snr = base.reshape((T,) + (1,) * (len(shape) - 1)) + 1.5 * rng.randn(*shape)
    snr.reshape(T, -1)[::7, 0] = 14.0  # exactly threshold + hysteresis of the QPSK rung
    snr.reshape(T, -1)[3::11, 0] = 13.0
    return snr.astype(np.float32)


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)])
def test_feedback_scan_and_step_match_reference(batch):
    cfg, ref_cfg = _cfgs()
    tables, ref_tables = adaptive.build_mcs_tables(cfg), ref_adaptive.build_mcs_tables(ref_cfg)
    rng = np.random.RandomState(len(batch))
    snr = _snr_walk(rng, (120,) + batch)
    ref_state0 = ref_adaptive.initial_state(1, batch)
    state0 = adaptive.initial_state(1, batch, "cpu")
    ref_final, ref_mcs = jax.jit(lambda s, x: ref_adaptive.feedback_scan(s, x, ref_tables))(
        ref_state0, jnp.asarray(snr))
    final, mcs = adaptive.feedback_scan(state0, torch.as_tensor(snr), adaptive.tables_to(tables, "cpu"))
    np.testing.assert_array_equal(mcs.numpy(), np.asarray(ref_mcs))
    assert mcs.dtype == torch.int32 and mcs.shape == (120,) + batch
    for g, w in zip(adaptive.feedback_state_to_numpy(final), ref_final):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.dtype == np.asarray(w).dtype
    assert np.asarray(ref_mcs).max() >= 2 and np.asarray(ref_mcs)[-1].max() <= 1  # it climbed and fell
    # one step from a mid-scan state carried over as numpy
    mid_ref, _ = jax.jit(lambda s, x: ref_adaptive.feedback_scan(s, x, ref_tables))(
        ref_state0, jnp.asarray(snr[:40]))
    mid = adaptive.feedback_state_from_reference(tuple(np.asarray(a) for a in mid_ref), "cpu")
    s_ref, m_ref = ref_adaptive.feedback_step(mid_ref, jnp.asarray(snr[40]), ref_tables)
    s, m = adaptive.feedback_step(mid, torch.as_tensor(snr[40]), tables)  # numpy tables too
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    for g, w in zip(s, s_ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _ref_masked_scan(tables):
    """The masked scan the reference's sessions define inline (session.py)."""

    def fb_scan_masked(state, snrs, mask):
        def step(s, x):
            snr, m = x
            ns, mcs = ref_adaptive.feedback_step(s, snr, tables)
            ns = jax.tree.map(lambda a, b: jnp.where(m, a, b), ns, s)
            return ns, jnp.where(m, mcs, s.last)

        return jax.lax.scan(step, state, (snrs, mask))

    return jax.jit(fb_scan_masked)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_feedback_scan_masked_matches_reference(batch):
    cfg, ref_cfg = _cfgs()
    tables, ref_tables = adaptive.build_mcs_tables(cfg), ref_adaptive.build_mcs_tables(ref_cfg)
    rng = np.random.RandomState(5 + len(batch))
    snr = _snr_walk(rng, (96,) + batch)
    mask = rng.rand(*snr.shape) > 0.4
    snr[~mask] = np.nan  # an undecoded frame's SNR estimate must not matter
    ref_final, ref_mcs = _ref_masked_scan(ref_tables)(
        ref_adaptive.initial_state(0, batch), jnp.asarray(snr), jnp.asarray(mask))
    final, mcs = adaptive.feedback_scan_masked(
        adaptive.initial_state(0, batch, "cpu"), torch.as_tensor(snr), torch.as_tensor(mask), tables)
    np.testing.assert_array_equal(mcs.numpy(), np.asarray(ref_mcs))
    for g, w in zip(final, ref_final):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(ref_mcs).max() >= 2


def test_scan_kernel_wrappers_refuse_cpu_tensors():
    """A CPU tensor takes the plain version in the dispatching functions;
    the kernels' own wrappers raise on one, and launch nothing."""
    i32 = lambda n: torch.zeros(n, dtype=torch.int32)
    before = (scans_cuda.trigger_lock_scan_cuda.LAUNCHES, scans_cuda.frame_accounting_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        scans_cuda.trigger_lock_scan_cuda(i32(4), i32(3), torch.zeros(3, dtype=torch.bool), 100)
    with pytest.raises(ValueError, match="CUDA"):
        scans_cuda.frame_accounting_cuda(i32(1), i32(3), torch.zeros(3, dtype=torch.bool))
    assert (scans_cuda.trigger_lock_scan_cuda.LAUNCHES,
            scans_cuda.frame_accounting_cuda.LAUNCHES) == before
    assert scans_cuda.scan_bytes(16) == {"trigger_lock_scan": 192, "frame_accounting": 160}
    src = scans_cuda.SOURCE.read_text()
    assert f"kLockAfter = {streaming.LOCK_AFTER};" in src
    assert f"kUnlockAfter = {streaming.UNLOCK_AFTER};" in src
