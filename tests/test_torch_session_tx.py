"""The streaming transmitter and the duplex adaptation loop.

``StreamTx`` against the JAX package's, block by block on the same PDU
queue, at frame_length 10 and F = 4: the reference draws its pad bytes
from ``jax.random``, so the port's one drawing method is overridden to
hand it the reference's own frame bytes of that block (whose bytes beyond
the CRC are that pad).  Frame numbers, lengths, constellations and frame
bytes must be equal; samples are held to atol 1e-5 (values ~0.1-0.5 after
a 64-point IDFT, float32 on both sides), the bar of
tests/test_torch_receiver.py.

The empty-frame budget, the pacing (by a patched clock) and the duplex
session (the adaptation assertions of tests/test_session.py, and the
equality of both readback orderings) are tests of the port alone.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import fec_chain as ref_fec
from gr_dtl_tpu.models import session as ref_session
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch.models import fec_chain, session
from gr_dtl_tpu_torch.ops import channel, constellation as cn
from gr_dtl_tpu_torch.utils import alist, config

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
FRAME_LENGTH, F = 10, 4


class InjectedPadTx(session.StreamTx):
    """StreamTx whose pad bytes are handed in, one block's at a time."""

    next_pad = None

    def _draw_pad(self):
        return None if self.next_pad is None else torch.tensor(self.next_pad)


def _queue(rng, cap):
    small = [rng.randint(0, 256, cap // 3).astype(np.uint8).tobytes() for _ in range(4)]
    jumbo = rng.randint(0, 256, 2 * cap + 5).astype(np.uint8).tobytes()
    return small[:2] + [jumbo] + small[2:] + [rng.randint(0, 256, 9).astype(np.uint8).tobytes()]


def _compare_block(got, want, what):
    (s_g, i_g), (s_w, i_w) = got, want
    assert i_g.keys() == i_w.keys()
    for k in i_w:
        g, w = np.asarray(i_g[k]), np.asarray(i_w[k])
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
    assert s_g.shape == s_w.shape and s_g.dtype == np.complex64 == s_w.dtype
    np.testing.assert_allclose(s_g, s_w, atol=1e-5, err_msg=what)


def test_stream_tx_blocks_match_reference():
    """Small PDUs packed together, a jumbo that splits, a feedback switch
    to 8PSK and an echo mid-stream, a dry queue (empty frames), then the
    budget's end: every block equal, and both end at the same call."""
    kw = dict(frame_length=FRAME_LENGTH, max_empty_frames=5)
    ref_tx = ref_session.StreamTx(ref_config.make_tx_config(None, **kw), frames_per_block=F, seed=7)
    tx = InjectedPadTx(config.make_tx_config(None, **kw), "cpu", frames_per_block=F)
    assert tx._capacity() == ref_tx._capacity() and tx.block_samples == ref_tx.block_samples
    for p in _queue(np.random.RandomState(3), tx._capacity()):
        ref_tx.send(p)
        tx.send(p)
    n_blocks = n_empty = 0
    for call in range(8):
        if call == 1:
            for t in (ref_tx, tx):
                t.set_feedback(3)
                t.set_feedback_echo(2)
                t.set_feedback(9)  # not a constellation: ignored
                t.send(b"\x55" * (t._capacity() + 1))
            assert tx.constellation == ref_tx.constellation == 3
            assert tx._capacity() == ref_tx._capacity()
        want = ref_tx.next_block()
        if want is None:
            assert tx.next_block() is None
            break
        tx.next_pad = np.asarray(want[1]["frame_bytes"])
        _compare_block(tx.next_block(), want, f"block {call}")
        n_blocks += 1
        n_empty += not want[1]["payload_len"].any()
    # 5 empty frames round up to two blocks of 4, after the blocks that carry the queue
    assert n_empty == 2 and n_blocks >= 4 and tx.next_block() is None
    assert (want is None) and tx._frame_no == ref_tx._frame_no == n_blocks * F


def test_stream_tx_frame_numbers_wrap_at_12_bits():
    tx = session.StreamTx(config.make_tx_config(None, frame_length=FRAME_LENGTH), "cpu",
                          frames_per_block=F)
    tx._frame_no = 4094
    _, info = tx.next_block()
    np.testing.assert_array_equal(info["frame_no"], [4094, 4095, 0, 1])
    assert tx._frame_no == 2


@pytest.mark.parametrize("max_empty,blocks", [(0, 0), (1, 1), (4, 1), (5, 2), (-1, 6)])
def test_stream_tx_empty_frame_budget(max_empty, blocks):
    """With a dry queue the stream goes on in empty frames up to the
    budget, rounded up to whole blocks; -1 never ends (6 calls here); data
    in between renews the budget."""
    tx = session.StreamTx(config.make_tx_config(None, frame_length=FRAME_LENGTH,
                                                max_empty_frames=max_empty),
                          "cpu", frames_per_block=F)
    n = 0
    for _ in range(6):
        blk = tx.next_block()
        if blk is None:
            break
        assert blk[0].shape == (tx.block_samples,) and not blk[1]["payload_len"].any()
        n += 1
    assert n == blocks
    tx.send(b"abc")
    samples, info = tx.next_block()
    assert info["payload_len"].tolist() == [3, 0, 0, 0] and tx._empty_run == 0
    assert bytes(info["frame_bytes"][0, :3]) == b"abc"
    assert (tx.next_block() is None) == (max_empty == 0)


def test_stream_tx_fec_block_matches_reference():
    """With FEC the capacity comes from the code's tables and no pad is
    drawn: one block of transport blocks, byte for byte."""
    H = alist.load_alist(str(EXAMPLES / "n_0100_k_0027.alist"))
    kw = dict(frame_length=FRAME_LENGTH, fec=True, max_empty_frames=0)
    ref_f = ref_fec.build_fec(ref_config.make_tx_config(None, **kw), H)
    fec = fec_chain.build_fec(config.make_tx_config(None, **kw), H, "cpu")
    ref_tx = ref_session.StreamTx(ref_config.make_tx_config(None, **kw), frames_per_block=F, fec=ref_f)
    tx = session.StreamTx(config.make_tx_config(None, **kw), "cpu", frames_per_block=F, fec=fec)
    assert tx._capacity() == ref_tx._capacity() == int(fec.user_bytes_tab[1])
    assert tx._draw_pad() is None
    rng = np.random.RandomState(8)
    for n in (4, tx._capacity(), 2 * tx._capacity() + 1):
        p = rng.randint(0, 256, n).astype(np.uint8).tobytes()
        ref_tx.send(p)
        tx.send(p)
    _compare_block(tx.next_block(), ref_tx.next_block(), "coded block")
    _compare_block(tx.next_block(), ref_tx.next_block(), "coded block 2")
    assert tx.next_block() is None and ref_tx.next_block() is None


def test_stream_tx_pacing_sleeps_to_the_sample_rate(monkeypatch):
    """pace=True holds next_block to the wall-clock rate of
    cfg.sample_rate: by a patched clock, the first block sets the deadline
    and each later one sleeps for what is left of its block's duration; a
    late caller does not sleep, and pace=False never does."""

    class Clock:
        now, slept = 100.0, []

        def monotonic(self):
            return self.now

        def sleep(self, dt):
            self.slept.append(dt)
            self.now += dt

    clock = Clock()
    monkeypatch.setattr(session, "time", clock)
    cfg = config.make_tx_config({"sample_rate": 200_000}, frame_length=6)
    tx = session.StreamTx(cfg, "cpu", frames_per_block=2, pace=True)
    dt = tx.block_samples / 200_000
    tx.next_block()
    assert clock.slept == [pytest.approx(dt)]
    clock.now += 0.25 * dt  # the caller spent a quarter of a block elsewhere
    tx.next_block()
    assert clock.slept[1] == pytest.approx(0.75 * dt)
    clock.now += 3 * dt  # late: the deadline has passed
    tx.next_block()
    assert len(clock.slept) == 2
    unpaced = session.StreamTx(cfg, "cpu", frames_per_block=2, pace=False)
    unpaced.next_block()
    assert len(clock.slept) == 2


def _make_chan(snr_db, seed):
    gen = torch.Generator().manual_seed(seed)

    def chan(samples):
        sig = float(np.mean(np.abs(samples) ** 2))
        return channel.awgn(torch.as_tensor(samples), float(np.sqrt(sig / 10 ** (snr_db / 10))),
                            generator=gen)

    return chan


def _run_duplex(serialize, steps=6):
    txcfg = config.make_tx_config(None, frame_length=FRAME_LENGTH, max_empty_frames=-1)
    rxcfg = config.make_rx_config(None, frame_length=FRAME_LENGTH)
    dpx = session.StreamDuplex(txcfg, rxcfg, txcfg, rxcfg, _make_chan(30.0, 11), _make_chan(5.0, 12),
                               "cpu", frames_per_block=8, serialize_readback=serialize)
    return dpx, [dpx.step() for _ in range(steps)]


@pytest.fixture(scope="module")
def duplex_runs():
    return _run_duplex(False), _run_duplex(True)


def test_stream_duplex_adaptation(duplex_runs):
    """The 30 dB direction's TX leaves BPSK through the in-band echo; the
    5 dB direction keeps BPSK."""
    dpx, results = duplex_runs[0]
    assert all(r is not None for r in results)
    assert dpx.tx_a.constellation > int(cn.ConstellationType.BPSK)
    assert dpx.tx_b.constellation == int(cn.ConstellationType.BPSK)
    # B decoded A's frames and climbed its own ladder; the echo went out in B's headers
    assert results[-1]["ctl_b"]["n_ok"] == 8 and results[-1]["ctl_b"]["echo_mcs"] >= 1
    assert dpx.tx_b._echo == int(dpx.tables_b["cnst"][results[-1]["ctl_b"]["echo_mcs"]])
    # control acts on the next block only: the first block went out as BPSK both ways
    assert (results[0]["b"].cnst_id == 1).all()


def test_stream_duplex_readback_orderings_equal(duplex_runs):
    (dpx_p, res_p), (dpx_s, res_s) = duplex_runs
    assert dpx_s.serialize_readback and not dpx_p.serialize_readback
    for step, (p, s) in enumerate(zip(res_p, res_s)):
        assert p["ctl_a"] == s["ctl_a"] and p["ctl_b"] == s["ctl_b"], step
        for side in ("a", "b"):
            for k in p[side]._fields:
                assert np.array_equal(getattr(p[side], k).numpy(), getattr(s[side], k).numpy(),
                                      equal_nan=True), (step, side, k)
    assert dpx_p.tx_a.constellation == dpx_s.tx_a.constellation
    assert (dpx_p.rx_a.n_lost, dpx_p.rx_a.n_frames) == (dpx_s.rx_a.n_lost, dpx_s.rx_a.n_frames)


def test_stream_duplex_ends_when_both_budgets_are_spent():
    txcfg = config.make_tx_config(None, frame_length=FRAME_LENGTH, max_empty_frames=0)
    rxcfg = config.make_rx_config(None, frame_length=FRAME_LENGTH)
    dpx = session.StreamDuplex(txcfg, rxcfg, txcfg, rxcfg, _make_chan(30.0, 1), _make_chan(30.0, 2),
                               "cpu", frames_per_block=4)
    dpx.tx_a.send(b"one way only")
    res = dpx.step()
    assert res["a"] is None and res["ctl_a"] is None and res["ctl_b"]["n_ok"] >= 1
    assert dpx.step() is None
