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


def assert_lock_equal(a, b):
    (sa, (ta, va)), (sb, (tb, vb)) = a, b
    assert torch.equal(ta.cpu(), tb.cpu()) and torch.equal(va.cpu(), vb.cpu())
    assert ta.dtype == torch.int32 and va.dtype == torch.bool
    assert streaming.lock_state_to_numpy(sa) == streaming.lock_state_to_numpy(sb)


@pytest.mark.parametrize("T", [0, 1, 5, 16, 256, 1023, 1024, 1025, 4096])
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
@pytest.mark.parametrize("T", [0, 1, 5, 16, 256, 1025, 4096])
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
