"""Schmidl-Cox synchronization parity: the port's plain metric against the
Pallas kernel (interpret mode) and the jnp metric, detection and
extraction against the JAX package, both branches of the periodic fast
path, and the median rule for an even frame count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import transmitter as ref_tx
from gr_dtl_tpu.ops import sync as ref_sync
from gr_dtl_tpu.ops import sync_pallas
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch.ops import _cuda_build, sync, sync_cuda

# the reference's own bars for the kernel against the plain metric
# (tests/test_sync_pallas.py): P sums 32 products of unit-variance
# samples (|P| ~ 6), M is a ratio of such sums
P_ATOL, M_ATOL = 2e-4, 2e-3
# fine CFO: angle of a 17-term complex sum, summed in another order
EPS_ATOL = 1e-5


def _cplx(rng, *shape, scale=1.0):
    return (scale * (rng.randn(*shape) + 1j * rng.randn(*shape))).astype(np.complex64)


@pytest.mark.parametrize("N", [9000, 8256])
def test_plain_metric_matches_pallas_and_jnp(N):
    rng = np.random.RandomState(0)
    r = _cplx(rng, N)
    P, M = sync._timing_metric_torch(torch.as_tensor(r), 64)
    assert P.shape == M.shape == (N - 64,) and P.dtype == torch.complex64
    for ref in (sync_pallas.timing_metric_pallas(jnp.asarray(r), 64, interpret=True),
                ref_sync._timing_metric_jnp(jnp.asarray(r), 64)):
        np.testing.assert_allclose(P.numpy(), np.asarray(ref[0]), atol=P_ATOL)
        np.testing.assert_allclose(M.numpy(), np.asarray(ref[1]), atol=M_ATOL)
    # a CPU tensor dispatches to the plain metric
    P2, M2 = sync.timing_metric(torch.as_tensor(r))
    assert torch.equal(P2, P) and torch.equal(M2, M)


def test_plain_metric_row_batch():
    rng = np.random.RandomState(1)
    r = _cplx(rng, 3, 2000)
    P, M = sync._timing_metric_torch(torch.as_tensor(r))
    Pr, Mr = ref_sync._timing_metric_jnp(jnp.asarray(r))
    np.testing.assert_allclose(P.numpy(), np.asarray(Pr), atol=P_ATOL)
    np.testing.assert_allclose(M.numpy(), np.asarray(Mr), atol=M_ATOL)
    for i in range(3):
        Pi, Mi = sync._timing_metric_torch(torch.as_tensor(r[i]))
        np.testing.assert_allclose(P[i].numpy(), Pi.numpy(), atol=1e-5)


def test_moving_sum_long_stream_keeps_precision():
    # a global cumsum would lose the small windows against a ~4e6 running sum
    x = np.ones(4_000_000, np.float32)
    ms = sync._moving_sum(torch.as_tensor(x), 32)
    assert ms.shape == (4_000_000 - 31,) and torch.all(ms == 32.0)


def test_median_rule():
    rng = np.random.RandomState(2)
    cases = [np.array(v, np.int64) for v in ([1, 2], [-3, 0], [-4, -1, 5, 7], [3], [-2, 9, 4])]
    cases += [rng.randint(-40, 40, n) for n in (2, 6, 2048, 2047)]
    for v in cases:
        want = int(jnp.median(jnp.asarray(v, jnp.int32)).astype(jnp.int32))
        assert int(sync._median_trunc(torch.as_tensor(v))) == want, v
    # torch.median would take the lower middle value
    assert int(torch.median(torch.tensor([1, 2]))) == 1
    assert int(sync._median_trunc(torch.tensor([1, 2]))) == 1
    assert int(sync._median_trunc(torch.tensor([1, 4]))) == 2
    assert int(sync._median_trunc(torch.tensor([-4, -1]))) == -2


def _tx_stream(B, frame_length, lead, rng, cfo=0.0):
    cfg = ref_config.make_tx_config(None, frame_length=frame_length)
    txp = ref_tx.build_tx(cfg)
    cnst = rng.randint(1, 5, B).astype(np.int32)
    payload = rng.randint(0, 256, (B, cfg.max_frame_bytes())).astype(np.uint8)
    plen = np.full(B, cfg.frame_bytes(1) - 4, np.int32)
    payload[np.arange(payload.shape[1])[None, :] >= plen[:, None]] = 0
    out = jax.jit(lambda *a: ref_tx.tx_frames(txp, *a))(  # one compile, not one per op
        jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32), jax.random.PRNGKey(0))
    s = np.concatenate([np.zeros(lead, np.complex64), np.asarray(out.samples).reshape(-1),
                        np.zeros(600, np.complex64)])
    s = s * np.exp(2j * np.pi * cfo * np.arange(len(s)) / 64)
    return (s + _cplx(rng, len(s), scale=0.02 / np.sqrt(2))).astype(np.complex64), cfg


@pytest.mark.parametrize("B,lead,cfo", [(8, 531, 0.0), (8, 37, 0.13)])
def test_detection_chain(B, lead, cfo):
    rng = np.random.RandomState(B)
    s, cfg = _tx_stream(B, 6, lead, rng, cfo)
    fs = cfg.frame_samples
    Pr, Mr = ref_sync._timing_metric_jnp(jnp.asarray(s))
    P, M = sync.timing_metric(torch.as_tensor(s))
    phase_r = ref_sync.fold_detect(Mr, fs, cfg.cp_len)
    phase = sync.fold_detect(M, fs, cfg.cp_len)
    assert phase.dtype == torch.int32 and int(phase) == int(phase_r)
    trig_r = ref_sync.frame_triggers(Mr, phase_r, fs, B)
    trig = sync.frame_triggers(M, phase, fs, B)
    assert trig.dtype == torch.int32
    np.testing.assert_array_equal(trig.numpy(), np.asarray(trig_r))
    t = trig.numpy() - lead - np.arange(B) * fs
    assert np.all((t >= 0) & (t <= cfg.cp_len)), t  # on the plateau
    for period in (None, fs):
        eps_r = np.asarray(ref_sync.fine_cfo(Pr, trig_r, cfg.cp_len, period=period))
        eps = sync.fine_cfo(P, trig, cfg.cp_len, period=period)
        np.testing.assert_allclose(eps.numpy(), eps_r, atol=EPS_ATOL)
    np.testing.assert_allclose(eps.numpy(), cfo, atol=0.02)
    frames_r = ref_sync.extract_frames(jnp.asarray(s), trig_r, fs)
    frames = sync.extract_frames(torch.as_tensor(s), trig, fs)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(frames_r))
    np.testing.assert_allclose(sync.cfo_correct(frames, eps, 64).numpy(),
                               np.asarray(ref_sync.cfo_correct(frames_r, jnp.asarray(eps_r), 64)),
                               atol=1e-5)  # |x| ~ 1, float32 phase ramps of up to ~20 rad


PERIOD = 400


def _trigger_sets():
    """Trigger vectors [B=8] that take each branch of the periodic fast path."""
    k = np.arange(8) * PERIOD
    # middle pair 0 and 2: the truncated mean anchors at +1, where the
    # lower middle value (torch.median) would anchor at 0
    jitter = np.array([2, -1, 4, 0, -3, 2, 3, -2])
    return {
        # within tol of the median anchor: fast path
        "fast": 150 + k + jitter,
        # a gap between frames 3 and 4 breaks the affine fit: per-window path
        "slow_gap": 150 + k + np.where(np.arange(8) >= 4, 300, 0),
        # negative anchor: the fast path clips it to 0 (reference quirk) and
        # the plateau windows of fine_cfo read the zero left padding
        "fast_clipped": -6 + k + jitter,
        # one trigger 5 samples off the grid: just past tol, so slow
        "slow_tol": 150 + k + np.array([0, 0, 5, 0, 0, 0, 0, 0]),
    }


@pytest.mark.parametrize("name", list(_trigger_sets()))
def test_extract_frames_and_fine_cfo_branches(name):
    trig = _trigger_sets()[name].astype(np.int32)
    rng = np.random.RandomState(3)
    stream = _cplx(rng, 8 * PERIOD + 500)
    want = np.asarray(ref_sync.extract_frames(jnp.asarray(stream), jnp.asarray(trig), PERIOD))
    got = sync.extract_frames(torch.as_tensor(stream), torch.as_tensor(trig), PERIOD)
    np.testing.assert_array_equal(got.numpy(), want)  # a gather: exact
    Pst = _cplx(rng, 8 * PERIOD + 200)
    for period in (None, PERIOD):
        want = np.asarray(ref_sync.fine_cfo(jnp.asarray(Pst), jnp.asarray(trig), 16, period=period))
        got = sync.fine_cfo(torch.as_tensor(Pst), torch.as_tensor(trig), 16, period=period)
        np.testing.assert_allclose(got.numpy(), want, atol=EPS_ATOL)
    fast = name.startswith("fast")
    rel = trig - np.arange(8) * PERIOD
    assert np.all(np.abs(rel - int(np.median(rel))) <= 4) == fast


def test_extract_windows_and_short_stream():
    rng = np.random.RandomState(4)
    stream = _cplx(rng, 1000)
    trig = np.array([-5, 0, 10, 990, 400], np.int32)
    np.testing.assert_array_equal(
        sync.extract_windows(torch.as_tensor(stream), torch.as_tensor(trig), 64).numpy(),
        np.asarray(ref_sync.extract_windows(jnp.asarray(stream), jnp.asarray(trig), 64)))
    # a stream shorter than B*period always takes the per-window gather
    np.testing.assert_array_equal(
        sync.extract_frames(torch.as_tensor(stream), torch.as_tensor(trig), 300).numpy(),
        np.asarray(ref_sync.extract_frames(jnp.asarray(stream), jnp.asarray(trig), 300)))


def test_cuda_wrapper_refuses_cpu_tensors(monkeypatch):
    r = torch.zeros(1000, dtype=torch.complex64)
    before = sync_cuda.timing_metric_cuda.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        sync_cuda.timing_metric_cuda(r)
    assert sync_cuda.timing_metric_cuda.LAUNCHES == before
    # without nvcc the build says so (and there is no silent fallback)
    monkeypatch.setattr(_cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.nvcc()
