"""The two CUDA scan kernels (csrc/stream_scans.cu) against their plain
PyTorch versions, on the card: every output and every state word equal.
Marked ``cuda``: these skip without an NVIDIA GPU (a CUDA kernel has no CPU
mode).  On a machine with the card but without JAX or pytest-xdist:
``python3 -m pytest -o addopts= --noconftest -q tests/test_torch_scans_cuda.py``."""

import numpy as np
import pytest
import torch

from gr_dtl_tpu_torch.models import streaming
from gr_dtl_tpu_torch.ops import metrics, scans_cuda

pytestmark = pytest.mark.cuda

PERIOD = 1840


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def lock_inputs(T, seed):
    """Candidates with a jitter of +-6 around the period and runs of
    misses longer than UNLOCK_AFTER."""
    rng = np.random.RandomState(seed)
    cand = (np.arange(T) * PERIOD + 300 + rng.randint(-6, 7, T)).astype(np.int32)
    found = rng.rand(T) > 0.2
    for start in rng.randint(0, max(T, 1), max(T // 40, 1)):
        found[start: start + 7] = False
    return cand, found


INT_MAX = (1 << 31) - 1


def lock_sequence(kind: str, T: int, seed: int):
    """Candidates and found flags: a stream that locks and stays locked
    ("locked"), jitter and misses that lock and unlock ("random"), nothing
    found ("never"), frames off by more than the tolerance in bursts that
    unlock the stream again and again and defeat a guessed "locked" entry in
    every chunk ("defeat"), and positions that wrap int32 ("wrap").  numpy
    int32 / bool; shared with tests/test_torch_scan_parallel.py."""
    rng = np.random.RandomState(seed)
    base = np.arange(T, dtype=np.int64) * PERIOD + 300
    found = np.ones(T, bool)
    if kind == "random":
        base += rng.randint(-6, 7, T)
        found = rng.rand(T) > 0.25
        for start in rng.randint(0, max(T, 1), max(T // 30, 1)):
            found[start: start + rng.randint(3, 9)] = False
    elif kind == "never":
        found[:] = False
    elif kind == "defeat":
        base += rng.choice([0, 9, -40, 500], T, p=[0.3, 0.3, 0.2, 0.2])
        found = rng.rand(T) > 0.45
    elif kind == "wrap":
        base += INT_MAX - 300 - (T // 2) * PERIOD + rng.randint(-3, 4, T)
    return ((base + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32), found


# entry states (locked, expected, sync_count, miss_count): unlocked, locked,
# mid-miss, and sync counts at and just below the top of int32
LOCK_STATES = {
    "initial": (False, 0, 0, 0),
    "locked": (True, 300 - PERIOD, 9, 0),
    "missing": (True, 77, 3, 4),
    "sync_at_int_max": (False, 300 - PERIOD, INT_MAX, 0),
    "sync_below_int_max": (True, 300 - PERIOD, INT_MAX - 1, 0),
}


def assert_lock_equal(a, b):
    (sa, (ta, va)), (sb, (tb, vb)) = a, b
    assert torch.equal(ta.cpu(), tb.cpu()) and torch.equal(va.cpu(), vb.cpu())
    assert ta.dtype == torch.int32 and va.dtype == torch.bool
    for x, y in zip(sa, sb):  # 0-d leaves, or [S] for a batch
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("T", [0, 1, 5, 16, 256, 1023, 1024, 1025, 4095, 4096, 4097])
def test_trigger_lock_scan_kernel_matches_plain(gpu, T):
    """Three successive calls with the state carried and rebased."""
    state = streaming.initial_lock_state(gpu)
    plain_state = streaming.initial_lock_state(gpu)
    for call in range(3):
        cand, found = lock_inputs(T, 10 * T + call)
        c, f = torch.as_tensor(cand, device=gpu), torch.as_tensor(found, device=gpu)
        before = scans_cuda.trigger_lock_scan_cuda.LAUNCHES
        got = streaming.trigger_lock_scan(state, c, f, PERIOD)
        assert scans_cuda.trigger_lock_scan_cuda.LAUNCHES == before + 1
        want = streaming._trigger_lock_scan_torch(plain_state, c, f, PERIOD)
        torch.cuda.synchronize()
        assert_lock_equal(got, want)
        state = got[0]._replace(expected=got[0].expected - T * PERIOD)
        plain_state = want[0]._replace(expected=want[0].expected - T * PERIOD)


@pytest.mark.parametrize("rule", ["received", "header"])
@pytest.mark.parametrize("T", [0, 1, 5, 16, 31, 32, 33, 256, 1023, 1024, 1025, 4095, 4096, 4097])
def test_frame_accounting_kernel_matches_plain(gpu, rule, T):
    """Three carried calls: wraps past 4095, and for the session's rule a
    start at -1 and undecoded slots with arbitrary numbers."""
    rng = np.random.RandomState(T + len(rule))
    start = -1 if rule == "received" else 4090
    exp = plain_exp = torch.tensor(start, dtype=torch.int32, device=gpu)
    no0 = 4000
    for _ in range(3):
        ok = rng.rand(T) > 0.3
        nos = ((no0 + np.arange(T) + np.cumsum(rng.rand(T) > 0.9)) % 4096).astype(np.int32)
        nos[~ok] = rng.randint(0, 4096, int((~ok).sum()))
        no0 += T + 3
        n, o = torch.as_tensor(nos, device=gpu), torch.as_tensor(ok, device=gpu)
        before = scans_cuda.frame_accounting_cuda.LAUNCHES
        exp, lost, totals = metrics.frame_accounting(exp, n, o, rule)
        assert scans_cuda.frame_accounting_cuda.LAUNCHES == before + 1
        plain_exp, plain_lost, plain_totals = metrics._frame_accounting_torch(plain_exp, n, o, rule)
        torch.cuda.synchronize()
        assert torch.equal(lost, plain_lost) and lost.dtype == torch.int32
        assert torch.equal(totals, plain_totals) and totals.dtype == torch.int32
        assert int(exp) == int(plain_exp) and exp.ndim == 0 and exp.dtype == torch.int32


@pytest.mark.parametrize("kind", ["locked", "random", "never", "defeat", "wrap"])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 1023, 1024, 1025, 4095, 4096, 4097])
def test_trigger_lock_scan_kernel_on_adversarial_sequences(gpu, T, kind):
    """Sequences that lock, unlock, wrap int32 and defeat the kernel's
    speculation in every chunk, from every entry state of LOCK_STATES (sync
    counts at the top of int32 among them): equal to the plain loop (on CPU
    copies, the same loop) in every output and state word."""
    cand, found = lock_sequence(kind, T, 13 * T + len(kind))
    c, f = torch.as_tensor(cand), torch.as_tensor(found)
    for name, st in LOCK_STATES.items():
        state = streaming.lock_state_from_reference(st, "cpu")
        want = streaming._trigger_lock_scan_torch(state, c, f, PERIOD)
        got = streaming.trigger_lock_scan(streaming.lock_state_from_reference(st, gpu), c.to(gpu),
                                          f.to(gpu), PERIOD)
        torch.cuda.synchronize()
        assert_lock_equal(got, want)


def test_lost_frames_on_the_card_equals_cpu(gpu):
    nos = torch.tensor([7, 8, 999, 10, 4095, 0, 13], dtype=torch.int32)
    ok = torch.tensor([1, 1, 0, 1, 1, 0, 1], dtype=torch.bool)
    got = metrics.lost_frames(nos.to(gpu), ok.to(gpu), 5)
    want = metrics.lost_frames(nos, ok, 5)
    assert [float(g) for g in got] == [float(w) for w in want]


def test_scan_kernels_on_a_side_stream(gpu):
    """Launched on PyTorch's current stream, whichever it is."""
    cand, found = lock_inputs(300, 1)
    c, f = torch.as_tensor(cand, device=gpu), torch.as_tensor(found, device=gpu)
    state = streaming.initial_lock_state(gpu)
    exp = torch.tensor(-1, dtype=torch.int32, device=gpu)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(gpu)
    with torch.cuda.stream(side):
        got = streaming.trigger_lock_scan(state, c, f, PERIOD)
        acct = metrics.frame_accounting(exp, got[1][0] % 4096, got[1][1])
    side.synchronize()
    assert_lock_equal(got, streaming._trigger_lock_scan_torch(state, c, f, PERIOD))
    want = metrics._frame_accounting_torch(exp, got[1][0] % 4096, got[1][1])
    assert all(torch.equal(g, w) for g, w in zip(acct, want))


@pytest.mark.parametrize("S,T", [(1, 1024), (64, 32)])
def test_scan_kernels_on_a_side_stream_at_the_paths_shapes(gpu, S, T):
    """The redesigned kernels (block and warp scans through shared memory)
    on a side stream while the default stream is busy, at a stream path's
    T = 1024 and the sharded path's S = 64, T = 32."""
    rng = np.random.RandomState(S + T)
    ins = [lock_sequence("random", T, int(rng.randint(1 << 30))) for _ in range(S)]
    c = torch.as_tensor(np.stack([i[0] for i in ins]), device=gpu)
    f = torch.as_tensor(np.stack([i[1] for i in ins]), device=gpu)
    nos = torch.as_tensor(rng.randint(0, 4096, (S, T)).astype(np.int32), device=gpu)
    ok = torch.as_tensor(rng.rand(S, T) > 0.3, device=gpu)
    state = streaming.initial_lock_state(gpu, (S,))
    exp = torch.full((S,), -1, dtype=torch.int32, device=gpu)
    busy = torch.randn(2048, 2048, device=gpu)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(gpu)
    for _ in range(4):
        busy = busy @ busy / 2048.0  # the default stream's work
    with torch.cuda.stream(side):
        got = streaming.trigger_lock_scan(state, c, f, PERIOD)
        acct = metrics.frame_accounting(exp, nos, ok)
    side.synchronize()
    want = streaming.trigger_lock_scan(streaming.TriggerLockState(*(a.cpu() for a in state)), c.cpu(),
                                       f.cpu(), PERIOD)
    assert_lock_equal(got, want)
    want = metrics.frame_accounting(exp.cpu(), nos.cpu(), ok.cpu())
    assert all(torch.equal(g.cpu(), w) for g, w in zip(acct, want))


def test_scan_kernels_refuse_what_they_do_not_take(gpu):
    z = lambda n, dt: torch.zeros(n, dtype=dt, device=gpu)
    with pytest.raises(ValueError, match="CUDA"):
        scans_cuda.trigger_lock_scan_cuda(torch.zeros(4, dtype=torch.int32),
                                          torch.zeros(3, dtype=torch.int32),
                                          torch.zeros(3, dtype=torch.bool), PERIOD)
    with pytest.raises(ValueError):
        scans_cuda.trigger_lock_scan_cuda(z(4, torch.int32), z(3, torch.int64), z(3, torch.bool), PERIOD)
    with pytest.raises(ValueError):
        scans_cuda.trigger_lock_scan_cuda(z(4, torch.int32), z(3, torch.int32), z(4, torch.bool), PERIOD)
    with pytest.raises(ValueError):
        scans_cuda.frame_accounting_cuda(z(1, torch.int32), z(8, torch.int32)[::2], z(4, torch.bool))
    with pytest.raises(KeyError):
        scans_cuda.frame_accounting_cuda(z(1, torch.int32), z(4, torch.int32), z(4, torch.bool), "other")


@pytest.mark.parametrize("S", [1, 3, 64])
@pytest.mark.parametrize("T", [1, 16, 257])
def test_batched_scan_kernels_match_plain_stream_by_stream(gpu, S, T):
    """S streams in one launch of each kernel ([S, T] items, state [S]),
    three calls with the state carried: every stream's outputs and state
    equal its own plain loop's."""
    rng = np.random.RandomState(S * 1000 + T)
    lock = streaming.initial_lock_state(gpu, (S,))
    plain_locks = [streaming.initial_lock_state(gpu) for _ in range(S)]
    exp = torch.full((S,), -1, dtype=torch.int32, device=gpu)
    plain_exps = [torch.tensor(-1, dtype=torch.int32, device=gpu) for _ in range(S)]
    for call in range(3):
        ins = [lock_inputs(T, rng.randint(1 << 30)) for _ in range(S)]
        c = torch.as_tensor(np.stack([i[0] for i in ins]), device=gpu)
        f = torch.as_tensor(np.stack([i[1] for i in ins]), device=gpu)
        nos = torch.as_tensor(rng.randint(0, 4096, (S, T)).astype(np.int32), device=gpu)
        ok = torch.as_tensor(rng.rand(S, T) > 0.3, device=gpu)
        before = (scans_cuda.trigger_lock_scan_cuda.LAUNCHES, scans_cuda.frame_accounting_cuda.LAUNCHES)
        lock, (trig, valid) = streaming.trigger_lock_scan(lock, c, f, PERIOD)
        exp, lost, totals = metrics.frame_accounting(exp, nos, ok)
        assert (scans_cuda.trigger_lock_scan_cuda.LAUNCHES, scans_cuda.frame_accounting_cuda.LAUNCHES) \
            == (before[0] + 1, before[1] + 1)
        torch.cuda.synchronize()
        for s in range(S):
            plain_locks[s], (t0, v0) = streaming._trigger_lock_scan_torch(plain_locks[s], c[s], f[s], PERIOD)
            assert torch.equal(trig[s], t0) and torch.equal(valid[s], v0)
            assert streaming.lock_state_to_numpy(plain_locks[s]) == tuple(
                a[s] for a in streaming.lock_state_to_numpy(lock))
            plain_exps[s], l0, tot0 = metrics._frame_accounting_torch(plain_exps[s], nos[s], ok[s])
            assert torch.equal(lost[s], l0) and torch.equal(totals[s], tot0)
            assert int(exp[s]) == int(plain_exps[s])
            plain_locks[s] = plain_locks[s]._replace(expected=plain_locks[s].expected - T * PERIOD)
        lock = lock._replace(expected=lock.expected - T * PERIOD)


@pytest.mark.parametrize("S,T", [(1, 32), (8, 32), (64, 32), (256, 32), (8, 1024), (256, 5)])
def test_batched_scan_kernels_at_many_streams(gpu, S, T):
    """S = 1 / 8 / 64 / 256 streams in one launch of each kernel, two calls
    with the state carried, against the plain loops stream by stream (on
    CPU copies: the dispatcher's CPU path), both accounting rules."""
    rng = np.random.RandomState(7 * S + T)
    lock = streaming.initial_lock_state(gpu, (S,))
    plain = streaming.initial_lock_state("cpu", (S,))
    exp = {r: torch.full((S,), -1 if r == "received" else 4090, dtype=torch.int32, device=gpu)
           for r in scans_cuda.RULES}
    exp0 = {r: e.cpu() for r, e in exp.items()}
    for call in range(2):
        kinds = rng.choice(["locked", "random", "defeat"], S)
        ins = [lock_sequence(k, T, int(rng.randint(1 << 30))) for k in kinds]
        c = torch.as_tensor(np.stack([i[0] for i in ins]))
        f = torch.as_tensor(np.stack([i[1] for i in ins]))
        lock, got = streaming.trigger_lock_scan(lock, c.to(gpu), f.to(gpu), PERIOD)
        plain, want = streaming.trigger_lock_scan(plain, c, f, PERIOD)
        torch.cuda.synchronize()
        assert_lock_equal((lock, got), (plain, want))
        nos = torch.as_tensor(rng.randint(0, 4096, (S, T)).astype(np.int32))
        ok = torch.as_tensor(rng.rand(S, T) > 0.3)
        for rule in scans_cuda.RULES:
            exp[rule], lost, totals = metrics.frame_accounting(exp[rule], nos.to(gpu), ok.to(gpu), rule)
            exp0[rule], lost0, totals0 = metrics.frame_accounting(exp0[rule], nos, ok, rule)
            assert torch.equal(lost.cpu(), lost0) and torch.equal(totals.cpu(), totals0)
            assert torch.equal(exp[rule].cpu(), exp0[rule])
        lock = lock._replace(expected=lock.expected - T * PERIOD)
        plain = plain._replace(expected=plain.expected - T * PERIOD)


def test_scan_bytes_scale_with_the_streams():
    one, many = scans_cuda.scan_bytes(64), scans_cuda.scan_bytes(64, S=64)
    assert all(many[k] == 64 * one[k] for k in one)
