"""The stream-batched forms of the sessions' scans on the CPU: the lock
scan and the frame accounting over [S, T] (the scan kernels' batched launch
on the card, csrc/stream_scans.cu) and the TB ring over S rings (the TB
ring kernels', csrc/tb_ring.cu) equal S single-stream calls of their plain
loops exactly; so do the batched trigger refinement and the per-stream
vote of extraction that the sharded receivers use, and fine CFO within
1e-6 (its window sums round in another order on a batch).  The card
cases are in tests/test_torch_scans_cuda.py and tests/test_torch_tb_cuda.py."""

import numpy as np
import pytest
import torch

from gr_dtl_tpu_torch.models import fec_chain, streaming
from gr_dtl_tpu_torch.ops import metrics, sync
from gr_dtl_tpu_torch.utils import alist, config

from test_torch_tb_cuda import EXAMPLES, assert_tb_equal, tb_headers

PERIOD = 1840


def lock_batch(S, T, seed):
    """[S, T] candidates with jitter, negative ones and runs of misses, and
    an [S] carried state with every stream in another phase of the machine."""
    rng = np.random.RandomState(seed)
    cand = (np.arange(T) * PERIOD - 500 + rng.randint(-6, 7, (S, T))).astype(np.int32)
    found = rng.rand(S, T) > 0.25
    state = streaming.TriggerLockState(
        torch.as_tensor(rng.rand(S) > 0.5), torch.as_tensor(rng.randint(-900, 900, S).astype(np.int32)),
        torch.as_tensor(rng.randint(0, 4, S).astype(np.int32)),
        torch.as_tensor(rng.randint(0, 5, S).astype(np.int32)))
    return state, torch.as_tensor(cand), torch.as_tensor(found)


@pytest.mark.parametrize("S,T", [(1, 1), (3, 1), (3, 16), (8, 5)])
def test_batched_lock_scan_equals_stream_by_stream(S, T):
    state, cand, found = lock_batch(S, T, 10 * S + T)
    for _ in range(2):  # the state carried into a second call
        got_state, (trig, valid) = streaming.trigger_lock_scan(state, cand, found, PERIOD)
        assert trig.shape == valid.shape == (S, T) and got_state.expected.shape == (S,)
        for s in range(S):
            one = streaming.TriggerLockState(*(a[s] for a in state))
            st, (t1, v1) = streaming._trigger_lock_scan_torch(one, cand[s], found[s], PERIOD)
            assert torch.equal(trig[s], t1) and torch.equal(valid[s], v1)
            assert [bool(st.locked)] + [int(a) for a in st[1:]] == \
                [bool(got_state.locked[s])] + [int(a[s]) for a in got_state[1:]]
        state = got_state._replace(expected=got_state.expected - T * PERIOD)


@pytest.mark.parametrize("rule", ["received", "header"])
@pytest.mark.parametrize("S,T", [(1, 1), (3, 1), (4, 12)])
def test_batched_frame_accounting_equals_stream_by_stream(rule, S, T):
    """Expectations of -1 and near 4095, frame numbers that wrap (the
    floor-mod of a negative difference)."""
    rng = np.random.RandomState(T + S)
    exp = torch.as_tensor(rng.choice([-1, 0, 4090, 4095], S).astype(np.int32))
    if rule == "header":
        exp = exp % 4096
    nos = torch.as_tensor(((4094 + np.arange(T) + rng.randint(0, 3, (S, T))) % 4096).astype(np.int32))
    ok = torch.as_tensor(rng.rand(S, T) > 0.3)
    got = metrics.frame_accounting(exp, nos, ok, rule)
    assert [tuple(g.shape) for g in got] == [(S,), (S, T), (S, 2)]
    for s in range(S):
        want = metrics._frame_accounting_torch(exp[s], nos[s], ok[s], rule)
        for g, w in zip(got, want):
            assert torch.equal(g[s], w) and g.dtype == w.dtype


@pytest.mark.parametrize("W,F", [(2, 1), (2, 9), (4, 6)])
def test_batched_tb_ring_equals_ring_by_ring(W, F):
    """Three rings, two chained calls (the second from carried-in buffers)."""
    cfg = config.make_tx_config(str(EXAMPLES / "config_fec.json"), frame_length=4)
    fec = fec_chain.build_fec(cfg, alist.load_alist(str(EXAMPLES / "n_0100_k_0027.alist")), "cpu",
                              tb_frames=W)
    fb_tab = fec.cfg.frame_capacity_symbols * np.arange(5)
    S = 3
    state = fec_chain.init_tb_state(fec, "cpu", (S,))
    singles = [fec_chain.init_tb_state(fec, "cpu") for _ in range(S)]
    assert state.llrs.shape == (S, W, fec.max_frame_bits) and state.tb_no.shape == (S,)
    for call in range(2):
        recs = [tb_headers(F, W, fb_tab, fec.max_frame_bits, 7 * s + call, tb0=5 * call) for s in range(S)]
        args = [torch.as_tensor(np.stack(col)) for col in zip(*recs)]
        state, emitted = fec_chain.tb_reassemble(state, *args, fec)
        for s in range(S):
            one = fec_chain._tb_reassemble_torch(singles[s], *(a[s] for a in args), fec)
            assert_tb_equal((fec_chain.TbRing(*(a[s] for a in state)),
                             {k: v[s] for k, v in emitted.items()}), one)
            singles[s] = one[0]


def test_batched_sync_helpers_equal_single_streams():
    """frame_triggers on [S, N'] rows, and extraction / fine CFO with a vote
    a stream, as the single-stream functions give them."""
    g = torch.Generator().manual_seed(4)
    S, P, n = 3, 400, 5
    x = torch.randn(S, P * (n + 1), dtype=torch.complex64, generator=g)
    Pm, M = sync.timing_metric(x, 64)
    phase = torch.tensor([3, 150, 399], dtype=torch.int32)
    trig = sync.frame_triggers(M, phase, P, n)
    trig[1, 2] += 40  # one stream off the affine model: its own vote fails
    frames = sync.extract_frames_batch(x, trig, P, per_stream=True)
    eps = sync.fine_cfo_batch(Pm, trig, 16, P, per_stream=True)
    for s in range(S):
        assert torch.equal(trig[s], sync.frame_triggers(M[s], phase[s], P, n) + (40 if s == 1 else 0)
                           * (torch.arange(n) == 2))
        assert torch.equal(frames[s], sync.extract_frames(x[s], trig[s], P))
        # the same windows; their sums may round in another order on a
        # [S, B, L] than on a [B, L] tensor
        torch.testing.assert_close(eps[s], sync.fine_cfo(Pm[s], trig[s], 16, period=P),
                                   rtol=0, atol=1e-6)
    # one vote for the batch: stream 1's miss sends every stream to its exact windows
    whole = sync.extract_frames_batch(x, trig, P)
    assert torch.equal(whole[0], sync.extract_windows(x[0], trig[0], P))


def test_lock_state_of_a_batch_round_trips_through_numpy():
    state = streaming.initial_lock_state("cpu", (4,))
    state = state._replace(expected=torch.tensor([-5, 0, 7, 2**30], dtype=torch.int32))
    back = streaming.lock_state_from_reference(streaming.lock_state_to_numpy(state), "cpu")
    for a, b in zip(back, state):
        assert torch.equal(a, b) and a.dtype == b.dtype
