"""The streaming receivers, port against the JAX package: the same numpy
stream, block by block, through the reference's ``StreamRx`` (its jitted
block step, on the CPU) and the port's, at frame_length 10 and F = 4
frames a block, with frames that straddle every block boundary, mixed
constellations 1..4, AWGN at 30 dB from one numpy draw and a block of
idle air at the end.

Masks, frame numbers, constellations, payload bytes and lengths, the lock
state, ``expected_no`` and the loss counters must be equal.  ``snr_db`` is
held to 1e-3 relative on the decoded frames (float32 on both sides; sums
of a few hundred squared pilot errors in another order, as in
tests/test_torch_receiver.py).  The pipelined and K-block receivers and
the prefetched ingest are held to the plain ``StreamRx`` bit for bit.

One reference session is built (and its step compiled) once per F for the
whole file; a run starts from its reset state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import session as ref_session
from gr_dtl_tpu.models import streaming as ref_streaming
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch.models import session, streaming, transmitter
from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.utils import config

FRAME_LENGTH, F, K = 10, 4, 3
SNR_DB = 30.0
INT_FIELDS = ("header_ok", "crc_ok", "frame_no", "cnst_id", "payload", "payload_len",
              "feedback_cnst", "carr_offset")


def make_stream(n_frames, offset, n_blocks, block_samples, seed, cnst=None, drop=None):
    """n_frames uncoded frames filled to capacity, starting ``offset``
    samples in, cut or padded to n_blocks blocks, plus AWGN at SNR_DB of
    the measured TX power from one numpy draw.  ``drop = (at, n)`` removes
    n samples at sample ``at`` of the clean frames (a sample slip).
    Returns (stream, payload, payload_len)."""
    tcfg = config.make_tx_config(None, frame_length=FRAME_LENGTH)
    rng = np.random.RandomState(seed)
    cnst = rng.randint(1, 5, size=n_frames).astype(np.int32) if cnst is None else cnst
    maxb = tcfg.max_frame_bytes()
    payload = np.zeros((n_frames, maxb), np.uint8)
    plen = np.zeros(n_frames, np.int32)
    for i in range(n_frames):
        plen[i] = tcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[cnst[i]])) - 4
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    gen = torch.Generator().manual_seed(seed)
    out = transmitter.tx_frames(
        transmitter.build_tx(tcfg, "cpu"), torch.as_tensor(payload), torch.as_tensor(plen),
        torch.as_tensor(cnst), torch.zeros(n_frames, dtype=torch.int32),
        torch.arange(n_frames, dtype=torch.int32),
        torch.randint(0, 256, (n_frames, maxb), generator=gen, dtype=torch.uint8))
    samples = out.samples.reshape(-1).numpy()
    sig = float(np.mean(np.abs(samples) ** 2))
    if drop is not None:
        samples = np.concatenate([samples[: drop[0]], samples[drop[0] + drop[1]:]])
    n = n_blocks * block_samples
    stream = np.concatenate([np.zeros(offset, np.complex64), samples,
                             np.zeros(n, np.complex64)])[:n]
    noise = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    std = np.float32(np.sqrt(sig / 10 ** (SNR_DB / 10)) / np.sqrt(2.0))
    return (stream + std * noise).astype(np.complex64), payload, plen


def reset_reference(rx):
    """Put a reference StreamRx back to its initial carried state, keeping
    its compiled step."""
    rx._tail = None
    rx._lock = ref_streaming.TriggerLockState(jnp.asarray(False), jnp.asarray(0),
                                              jnp.asarray(0), jnp.asarray(0))
    rx._fallback = jnp.full((rx.F,), 1, jnp.int32)
    rx._expected_no = jnp.asarray(-1, jnp.int32)
    rx.n_lost = rx.n_frames = 0


def run_reference(rx, stream, snapshot_after=None):
    """Every block of ``stream`` through the reference session: per block
    its outputs and carried state as numpy (and one state snapshot)."""
    reset_reference(rx)
    S = rx.block_samples
    blocks, snap = [], None
    for b in range(len(stream) // S):
        out, valid = rx.process(stream[b * S:(b + 1) * S])
        blocks.append({
            "out": {k: np.asarray(getattr(out, k)) for k in INT_FIELDS + ("snr_db",)},
            "valid": np.asarray(valid).copy(), "header_ok": valid.header_ok.copy(),
            "crc_ok": valid.crc_ok.copy(),
            "lock": tuple(np.asarray(a) for a in rx._lock),
            "expected_no": int(rx._expected_no), "n_lost": rx.n_lost, "n_frames": rx.n_frames})
        if snapshot_after == b:
            snap = session.snapshot_from_reference(rx)
    return blocks, snap


def assert_block_equal(got, ref, rx, what):
    out, valid = got
    np.testing.assert_array_equal(np.asarray(valid), ref["valid"], err_msg=f"{what} valid")
    np.testing.assert_array_equal(valid.header_ok, ref["header_ok"], err_msg=f"{what} header_ok")
    np.testing.assert_array_equal(valid.crc_ok, ref["crc_ok"], err_msg=f"{what} crc_ok")
    for k in INT_FIELDS:
        g, w = getattr(out, k).numpy(), ref["out"][k]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
    ok = ref["valid"] & ref["header_ok"]
    np.testing.assert_allclose(out.snr_db.numpy()[ok], ref["out"]["snr_db"][ok], rtol=1e-3)
    for g, w in zip(streaming.lock_state_to_numpy(rx._lock), ref["lock"]):
        assert g == w and g.dtype == w.dtype, (what, "lock", g, w)
    assert int(rx._expected_no) == ref["expected_no"], what
    assert (rx.n_lost, rx.n_frames) == (ref["n_lost"], ref["n_frames"]), what


@pytest.fixture(scope="module")
def cfgs():
    return (config.make_rx_config(None, frame_length=FRAME_LENGTH),
            ref_config.make_rx_config(None, frame_length=FRAME_LENGTH))


@pytest.fixture(scope="module")
def ref_rx(cfgs):
    return ref_session.StreamRx(cfgs[1], frames_per_block=F)


@pytest.fixture(scope="module")
def main_run(cfgs, ref_rx):
    """6 blocks: 20 frames from sample 300 on (every boundary cuts a frame)
    and a block of idle air; the reference's run of it, with its carried
    state after block 2."""
    n_blocks = 2 * K
    stream, payload, plen = make_stream((n_blocks - 1) * F, 300, n_blocks,
                                        ref_rx.block_samples, seed=0)
    blocks, snap = run_reference(ref_rx, stream, snapshot_after=2)
    return stream, payload, plen, blocks, snap


def test_stream_rx_matches_reference_block_by_block(cfgs, main_run):
    stream, payload, plen, ref_blocks, _ = main_run
    rx = session.StreamRx(cfgs[0], "cpu", frames_per_block=F)
    assert (rx.block_samples, rx.tail_len, rx.P) == (F * cfgs[1].frame_samples,
                                                    cfgs[1].frame_samples + 64,
                                                    cfgs[1].frame_samples)
    S = rx.block_samples
    decoded = {}
    for b, ref in enumerate(ref_blocks):
        got = rx.process(stream[b * S:(b + 1) * S])
        assert_block_equal(got, ref, rx, f"block {b}")
        np.testing.assert_array_equal(rx.last_valid, ref["valid"])
        np.testing.assert_array_equal(rx.last_crc_ok, ref["crc_ok"])
        out, valid = got
        for i in np.nonzero(valid & valid.crc_ok)[0]:
            no = int(out.frame_no[i])
            assert no not in decoded, f"frame {no} decoded twice"
            decoded[no] = out.payload[i, : int(out.payload_len[i])].numpy().tobytes()
    # the link itself: every frame once, in order, nothing lost, idle air not counted
    assert sorted(decoded) == list(range(len(plen)))
    for i in range(len(plen)):
        assert decoded[i] == payload[i, : plen[i]].tobytes()
    assert rx.n_lost == 0 and rx.n_frames == len(plen) and rx.lost_frame_rate == 0.0


def test_stream_rx_sample_slip_resyncs_like_reference(cfgs, ref_rx):
    """Seven samples dropped mid-stream: the per-block phase vote re-locks,
    frames decode again, the outage shows in the loss counters; block by
    block as the reference."""
    n_blocks, P = 8, cfgs[1].frame_samples
    B = (n_blocks - 1) * F
    stream, payload, plen = make_stream(B, 0, n_blocks, ref_rx.block_samples, seed=1,
                                        cnst=np.full(B, 2, np.int32),
                                        drop=(12 * P + 200, 7))
    ref_blocks, _ = run_reference(ref_rx, stream)
    rx = session.StreamRx(cfgs[0], "cpu", frames_per_block=F)
    S = rx.block_samples
    decoded = set()
    for b, ref in enumerate(ref_blocks):
        out, valid = got = rx.process(stream[b * S:(b + 1) * S])
        assert_block_equal(got, ref, rx, f"block {b}")
        for i in np.nonzero(valid & valid.crc_ok)[0]:
            no = int(out.frame_no[i])
            assert out.payload[i, : plen[no]].numpy().tobytes() == payload[no, : plen[no]].tobytes()
            decoded.add(no)
    assert all(f in decoded for f in range(11))
    assert any(f in decoded for f in range(16, B)), "never re-locked"
    assert rx.n_lost >= 1 and rx.lost_frame_rate > 0


def test_state_hand_over_from_reference(cfgs, main_run):
    """The reference's carried state after block 2, handed to a fresh port
    session: blocks 3.. come out as the reference's; and the port's own
    snapshot restores into another session."""
    stream, _, _, ref_blocks, snap = main_run
    rx = session.StreamRx(cfgs[0], "cpu", frames_per_block=F)
    rx.restore(snap)
    S = rx.block_samples
    assert_block_equal(rx.process(stream[3 * S:4 * S]), ref_blocks[3], rx, "block 3")
    rx2 = session.StreamRx(cfgs[0], "cpu", frames_per_block=F)
    own = rx.snapshot()
    rx2.restore(own)
    again = rx2.snapshot()
    assert own.keys() == again.keys() and own["tb"] is None
    for k in ("tail", "fallback", "expected_no", "n_lost", "n_frames"):
        np.testing.assert_array_equal(own[k], again[k])
    assert own["lock"] == again["lock"]
    for b in (4, 5):
        assert_block_equal(rx2.process(stream[b * S:(b + 1) * S]), ref_blocks[b], rx2, f"block {b}")


def _same_outputs(got, want, what):
    (o_a, v_a), (o_b, v_b) = got, want
    np.testing.assert_array_equal(np.asarray(v_a), np.asarray(v_b), err_msg=what)
    np.testing.assert_array_equal(v_a.header_ok, v_b.header_ok, err_msg=what)
    np.testing.assert_array_equal(v_a.crc_ok, v_b.crc_ok, err_msg=what)
    for k in o_a._fields:
        assert np.array_equal(getattr(o_a, k).numpy(), getattr(o_b, k).numpy(), equal_nan=True), \
            (what, k)


@pytest.fixture(scope="module")
def plain_run(cfgs, main_run):
    stream = main_run[0]
    rx = session.StreamRx(cfgs[0], "cpu", frames_per_block=F)
    S = rx.block_samples
    return rx, [rx.process(stream[b * S:(b + 1) * S]) for b in range(len(stream) // S)]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipelined_equals_stream_rx(cfgs, main_run, plain_run, depth):
    stream = main_run[0]
    rx, plain = plain_run
    prx = session.StreamRxPipelined(cfgs[0], "cpu", frames_per_block=F, depth=depth)
    S = prx.block_samples
    piped = []
    for b in range(len(plain)):
        r = prx.process(stream[b * S:(b + 1) * S])
        assert (r is None) == (b < depth - 1)
        if r is not None:
            piped.append(r)
    piped.extend(prx.drain())
    assert len(piped) == len(plain) and prx.drain() == []
    for b, (g, w) in enumerate(zip(piped, plain)):
        _same_outputs(g, w, f"block {b}")
        # the block-tied masks are this block's, whenever it was read back
        np.testing.assert_array_equal(g[1].crc_ok, g[0].crc_ok.numpy())
    assert (prx.n_lost, prx.n_frames) == (rx.n_lost, rx.n_frames)


def test_mega_equals_k_stream_rx_calls(cfgs, main_run, plain_run):
    stream = main_run[0]
    rx, plain = plain_run
    mega = session.StreamRxMega(cfgs[0], "cpu", frames_per_block=F, blocks_per_dispatch=K)
    D = mega.dispatch_samples
    assert D == K * rx.block_samples
    for d in range(len(plain) // K):
        out, valid = mega.process(stream[d * D:(d + 1) * D])
        want = plain[d * K:(d + 1) * K]
        assert valid.shape == (K * F,) and mega.last_header_ok.shape == (K * F,)
        np.testing.assert_array_equal(np.asarray(valid), np.concatenate([np.asarray(w[1]) for w in want]))
        np.testing.assert_array_equal(valid.header_ok, np.concatenate([w[1].header_ok for w in want]))
        np.testing.assert_array_equal(valid.crc_ok, np.concatenate([w[1].crc_ok for w in want]))
        for k in out._fields:
            cat = np.concatenate([getattr(w[0], k).numpy() for w in want])
            assert np.array_equal(getattr(out, k).numpy(), cat, equal_nan=True), (d, k)
    assert (mega.n_lost, mega.n_frames) == (rx.n_lost, rx.n_frames)
    for g, w in zip(streaming.lock_state_to_numpy(mega._lock), streaming.lock_state_to_numpy(rx._lock)):
        assert g == w
    with pytest.raises(ValueError, match="feed exactly"):
        mega.process(stream[: rx.block_samples])


def test_prefetched_and_tensor_ingest_equal_numpy_ingest(cfgs, main_run, plain_run):
    stream = main_run[0]
    rx, plain = plain_run
    rx_b = session.StreamRx(cfgs[0], "cpu", frames_per_block=F)
    rx_c = session.StreamRx(cfgs[0], "cpu", frames_per_block=F)
    S = rx_b.block_samples
    chunks = [stream[b * S:(b + 1) * S] for b in range(len(plain))]
    handle = rx_b.prefetch(chunks[0])
    assert isinstance(handle, session.Prefetched) and handle.ready is None
    for b in range(len(chunks)):
        nxt = rx_b.prefetch(chunks[b + 1].astype(np.complex128)) if b + 1 < len(chunks) else None
        _same_outputs(rx_b.process(handle), plain[b], f"prefetched block {b}")
        handle = nxt
        _same_outputs(rx_c.process(torch.as_tensor(chunks[b])), plain[b], f"tensor block {b}")
    assert (rx_b.n_lost, rx_b.n_frames) == (rx.n_lost, rx.n_frames)


def test_single_frame_blocks_keep_the_short_tail_like_reference(cfgs):
    """F = 1: a block (P samples) is shorter than the tail (P + 64), so
    after the first block the carried tail is the whole previous chunk, P
    samples, and the step sees 2P samples.  The reference does just that
    (its slice ``chunk[-tail_len:]``); the port follows, block by block."""
    ref = ref_session.StreamRx(cfgs[1], frames_per_block=1)
    n_blocks = 7
    stream, payload, plen = make_stream(5, 300, n_blocks, ref.block_samples, seed=4)
    ref_blocks, _ = run_reference(ref, stream)
    rx = session.StreamRx(cfgs[0], "cpu", frames_per_block=1)
    S = rx.block_samples
    n_ok = 0
    for b, want in enumerate(ref_blocks):
        got = rx.process(stream[b * S:(b + 1) * S])
        assert_block_equal(got, want, rx, f"block {b}")
        assert rx._tail.shape == (S,) and np.asarray(ref._tail).shape == (S,)
        n_ok += int((got[1] & got[1].crc_ok).sum())
    assert n_ok == 5 and rx.n_lost == 0


def test_stream_rx_refuses_a_probe_and_wrong_lengths(cfgs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        session.StreamRx(cfgs[0], "cpu", frames_per_block=F, probe=object())
    rx = session.StreamRx(cfgs[0], "cpu", frames_per_block=F)
    with pytest.raises(ValueError, match="feed exactly"):
        rx.process(np.zeros(rx.block_samples - 1, np.complex64))
    with pytest.raises(ValueError, match="feed exactly"):
        rx.prefetch(np.zeros(rx.block_samples + 1, np.complex64))
    assert rx.flush_tb() is None
