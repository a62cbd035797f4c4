"""The sessions' ``probe=`` telemetry, port against the JAX package: the
scenario of ``tests/test_session.py::test_stream_rx_monitor_probe``
(frame_length 10, F = 4 frames a block, 12 frames of mixed constellations
1..4, AWGN at 30 dB, and a block of idle air after them) through both
packages' ``StreamRx``, ``StreamRxPipelined`` and ``StreamRxMega``, each
with a capture-mode ``MonitorProbe``; and a probed ``StreamDuplex`` whose
two channels hand both packages the same recorded streams.

The captured messages must agree one for one: equal counts, envelope
fields (``system_ts`` pinned in both packages), ``constellation_key``,
``fec_key`` and ``lost_frames_rate`` exact; ``estimated_snr_tag_key`` and
``noise_tag_key`` within rtol 1e-3 (float32 on both sides; sums of a few
hundred squared pilot errors in another order, the bar of
tests/test_torch_session_rx.py).  The port carries the telemetry in the
block's one packed vector ([2 + 6F] with a probe, [2 + 3F] without).
"""

import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import session as ref_session
from gr_dtl_tpu.testbed import monitor as ref_monitor
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch.models import session, transmitter
from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.testbed import monitor
from gr_dtl_tpu_torch.utils import config

FRAME_LENGTH, F, N_FRAMES, K = 10, 4, 12, 2
SNR_DB = 30.0
FLOATS = ("estimated_snr_tag_key", "noise_tag_key")


@pytest.fixture(autouse=True)
def pinned_ts(monkeypatch):
    for mod in (ref_monitor, monitor):
        monkeypatch.setattr(mod, "system_ts", lambda: 1_760_000_000_000)


def make_stream(n_frames, n_blocks, block_samples, seed, offset=0):
    """n_frames frames of mixed constellations filled to capacity from
    sample ``offset`` on, then idle air, AWGN at SNR_DB from one numpy draw."""
    tcfg = config.make_tx_config(None, frame_length=FRAME_LENGTH)
    rng = np.random.RandomState(seed)
    cnst = rng.randint(1, 5, size=n_frames).astype(np.int32)
    maxb = tcfg.max_frame_bytes()
    payload = np.zeros((n_frames, maxb), np.uint8)
    plen = np.array([tcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[c])) - 4 for c in cnst], np.int32)
    for i in range(n_frames):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    out = transmitter.tx_frames(
        transmitter.build_tx(tcfg, "cpu"), torch.as_tensor(payload), torch.as_tensor(plen),
        torch.as_tensor(cnst), torch.zeros(n_frames, dtype=torch.int32),
        torch.arange(n_frames, dtype=torch.int32),
        torch.as_tensor(rng.randint(0, 256, (n_frames, maxb)).astype(np.uint8)))
    samples = out.samples.reshape(-1).numpy()
    n = n_blocks * block_samples
    stream = np.concatenate([np.zeros(offset, np.complex64), samples, np.zeros(n, np.complex64)])[:n]
    std = np.float32(np.sqrt(np.mean(np.abs(samples) ** 2) / 10 ** (SNR_DB / 10)) / np.sqrt(2.0))
    noise = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    return (stream + std * noise).astype(np.complex64)


def assert_same_messages(got_blobs, want_blobs, n_expected, what):
    assert len(got_blobs) == len(want_blobs) == n_expected, (what, len(got_blobs), len(want_blobs))
    for i, (g, w) in enumerate(zip(got_blobs, want_blobs)):
        got, want = monitor.MonitorParser().parse(g), ref_monitor.MonitorParser().parse(w)
        assert got.keys() == want.keys()
        for k in want:
            if k in FLOATS:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=f"{what} message {i} {k}")
            else:
                assert got[k] == want[k], (what, i, k, got[k], want[k])
        assert got["sent_counter"] == i + 1 and got["proto_id"] == monitor.EQ_MSG


@pytest.fixture(scope="module")
def cfgs():
    return (config.make_rx_config(None, frame_length=FRAME_LENGTH),
            ref_config.make_rx_config(None, frame_length=FRAME_LENGTH))


@pytest.fixture(scope="module")
def stream(cfgs):
    P = cfgs[0].frame_samples
    # frames from sample 0 as in the reference's test, one block of idle
    # air after them, and a last block so that K-block calls come out even
    return make_stream(N_FRAMES, N_FRAMES // F + 2, F * P, seed=3)


def _run(rx, chunks):
    for c in chunks:
        rx.process(c)
    if hasattr(rx, "drain"):
        rx.drain()


def _chunks(stream, n):
    return [stream[i * n:(i + 1) * n] for i in range(len(stream) // n)]


@pytest.mark.parametrize("kind", ["StreamRx", "StreamRxPipelined", "StreamRxMega"])
def test_probed_receivers_send_the_references_messages(cfgs, stream, kind):
    cfg, ref_cfg = cfgs
    make = {"StreamRx": (lambda p: session.StreamRx(cfg, "cpu", F, probe=p),
                         lambda p: ref_session.StreamRx(ref_cfg, F, probe=p)),
            "StreamRxPipelined": (lambda p: session.StreamRxPipelined(cfg, "cpu", F, probe=p, depth=2),
                                  lambda p: ref_session.StreamRxPipelined(ref_cfg, F, probe=p, depth=2)),
            "StreamRxMega": (lambda p: session.StreamRxMega(cfg, "cpu", F, blocks_per_dispatch=K, probe=p),
                             lambda p: ref_session.StreamRxMega(ref_cfg, F, blocks_per_dispatch=K, probe=p))}
    probe, ref_probe = monitor.MonitorProbe(address=None), ref_monitor.MonitorProbe(address=None)
    rx, ref_rx = make[kind][0](probe), make[kind][1](ref_probe)
    _run(rx, _chunks(stream, rx.dispatch_samples))
    _run(ref_rx, _chunks(stream, rx.dispatch_samples))
    assert_same_messages(probe.captured, ref_probe.captured, N_FRAMES, kind)
    assert (rx.n_lost, rx.n_frames) == (ref_rx.n_lost, ref_rx.n_frames) == (0, N_FRAMES)
    assert rx.probe_host_ms > 0


def test_telemetry_rides_the_one_packed_vector(cfgs, stream):
    """With a probe the block's vector is [2 + 6F] and holds the frames'
    constellation and the bits of their SNR and noise variance; without
    one it stays [2 + 3F]; the readback copies one vector a block."""
    cfg = cfgs[0]
    plain, probed = session.StreamRx(cfg, "cpu", F), session.StreamRx(cfg, "cpu", F, probe=monitor.MonitorProbe(None))
    chunk = stream[: plain.block_samples]
    d0, d1 = plain._dispatch(chunk), probed._dispatch(chunk)
    assert d0.acct.shape == (2 + 3 * F,) and d1.acct.shape == (2 + 6 * F,)
    assert torch.equal(d1.acct[: 2 + 3 * F], d0.acct)
    assert torch.equal(d1.acct[2 + 3 * F: 2 + 4 * F], d1.out.cnst_id)
    assert torch.equal(d1.acct[2 + 4 * F: 2 + 5 * F], d1.out.snr_db.view(torch.int32))  # NaN in an empty slot
    assert torch.equal(d1.acct[2 + 5 * F:], d1.out.noise_var.view(torch.int32))
    plain._readback(*d0)
    probed._readback(*d1)
    assert len(probed.probe.captured) == int((probed.last_valid & probed.last_header_ok).sum()) > 0


def _recorded(streams):
    """A channel that ignores what its TX sent and hands on the next block
    of a recorded stream: both packages' duplexes then receive the same
    samples whatever pad bytes their transmitters drew."""
    it = iter(streams)
    return lambda samples: next(it)


def test_probed_duplex_sends_the_references_messages(cfgs):
    """StreamDuplex(probe_a=, probe_b=) at F = 8: both directions publish
    the reference's messages for the same received streams."""
    cfg, ref_cfg = cfgs
    Fd, steps = 8, 3
    P = cfg.frame_samples
    txcfg = config.make_tx_config(None, frame_length=FRAME_LENGTH)
    ref_txcfg = ref_config.make_tx_config(None, frame_length=FRAME_LENGTH)
    ab = _chunks(make_stream(2 * Fd, steps, Fd * P, seed=5, offset=123), Fd * P)
    ba = _chunks(make_stream(2 * Fd + 3, steps, Fd * P, seed=6, offset=711), Fd * P)
    probes = [monitor.MonitorProbe(None) for _ in range(2)]
    ref_probes = [ref_monitor.MonitorProbe(None) for _ in range(2)]
    dpx = session.StreamDuplex(txcfg, cfg, txcfg, cfg, _recorded(ab), _recorded(ba), "cpu",
                               frames_per_block=Fd, probe_a=probes[0], probe_b=probes[1])
    ref_dpx = ref_session.StreamDuplex(ref_txcfg, ref_cfg, ref_txcfg, ref_cfg, _recorded(ab), _recorded(ba),
                                       frames_per_block=Fd, probe_a=ref_probes[0], probe_b=ref_probes[1])
    for _ in range(steps):
        got, want = dpx.step(), ref_dpx.step()
        assert got["ctl_a"] == want["ctl_a"] and got["ctl_b"] == want["ctl_b"]
    # B receives the A -> B stream, A the B -> A stream
    assert_same_messages(probes[1].captured, ref_probes[1].captured, 2 * Fd, "duplex, B's receiver")
    assert_same_messages(probes[0].captured, ref_probes[0].captured, 2 * Fd + 3, "duplex, A's receiver")
