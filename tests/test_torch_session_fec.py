"""The coded streaming receiver with multi-frame transport blocks, port
against the JAX package: the n=100 k=27 code, W = 2 frames a TB, QPSK,
frame_length 10, F = 4 frames a block, one mid-TB frame replaced by
noise, AWGN at 30 dB from one numpy draw.  The same numpy stream goes
block by block through the reference's ``StreamRx`` (jitted, on the CPU)
and the port's: ``rx_frames(defer_fec=True)`` -> ``tb_reassemble`` ->
``decode_emitted``, then ``flush_tb``.

Per block the emission mask, ``tb_no`` and ``crc_ok`` must be equal at
every position, and ``fec_ok``, the payload bytes and their length at the
positions where a TB was emitted (elsewhere the decoder ran on a buffer
still under reassembly, whose hard bits are not a result).  The frame
masks and counters are held as in tests/test_torch_session_rx.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import fec_chain as ref_fec
from gr_dtl_tpu.models import session as ref_session
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch.models import fec_chain, session, transmitter
from gr_dtl_tpu_torch.utils import alist, config

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
FRAME_LENGTH, F, W, K = 10, 4, 2, 2
N_BLOCKS = 4
HIT_FRAME = 3  # the second frame of TB 1
TB_KEYS = ("valid", "tb_no", "crc_ok", "fec_ok", "payload", "payload_len")


@pytest.fixture(scope="module")
def link():
    """The stream, what was sent, both packages' tables, and the
    reference's run of the stream (per block: tb dict, masks, counters;
    its carried state after block 1; its flush)."""
    H = alist.load_alist(str(EXAMPLES / "n_0100_k_0027.alist"))
    tcfg = config.make_tx_config(None, frame_length=FRAME_LENGTH, fec=True)
    rcfg = config.make_rx_config(None, frame_length=FRAME_LENGTH, fec=True)
    fec = fec_chain.build_fec(tcfg, H, "cpu", tb_frames=W)
    ref_f = ref_fec.build_fec(ref_config.make_tx_config(None, frame_length=FRAME_LENGTH, fec=True),
                              H, tb_frames=W)
    ref_rx = ref_session.StreamRx(ref_config.make_rx_config(None, frame_length=FRAME_LENGTH, fec=True),
                                  frames_per_block=F, fec=ref_f)
    S, P = ref_rx.block_samples, rcfg.frame_samples
    G = (N_BLOCKS - 1) * F // W  # TBs; idle air at the end
    B = G * W
    rng = np.random.RandomState(17)
    nb = int(fec.user_bytes_tab[2])
    payload = np.zeros((B, fec.max_payload_bytes), np.uint8)
    plen = np.zeros(B, np.int32)
    for g in range(G):
        plen[g * W] = nb
        payload[g * W, :nb] = rng.randint(0, 256, nb)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    out = transmitter.tx_frames(transmitter.build_tx(tcfg, "cpu", fec), torch.as_tensor(payload),
                                i32(plen), i32(np.full(B, 2)), i32(np.zeros(B)), i32(np.arange(B)),
                                None)
    samples = out.samples.numpy().copy()
    sig = float(np.mean(np.abs(samples) ** 2))
    samples[HIT_FRAME] = (np.sqrt(sig / 2) * (rng.randn(P) + 1j * rng.randn(P))).astype(np.complex64)
    n = N_BLOCKS * S
    stream = np.concatenate([np.zeros(260, np.complex64), samples.reshape(-1),
                             np.zeros(n, np.complex64)])[:n]
    noise = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    stream = (stream + np.float32(np.sqrt(sig / 1e3) / np.sqrt(2.0)) * noise).astype(np.complex64)

    blocks, snap = [], None
    for b in range(N_BLOCKS):
        _o, valid, tb = ref_rx.process(stream[b * S:(b + 1) * S])
        blocks.append({"tb": {k: np.asarray(tb[k]) for k in TB_KEYS},
                       "valid": np.asarray(valid).copy(), "header_ok": valid.header_ok.copy(),
                       "n_lost": ref_rx.n_lost, "n_frames": ref_rx.n_frames,
                       "tb_state_no": int(ref_rx._tb_state.tb_no)})
        if b == 1:
            snap = session.snapshot_from_reference(ref_rx)
    flush = {k: np.asarray(v) for k, v in ref_rx.flush_tb().items()}
    return {"stream": stream, "payload": payload, "nb": nb, "G": G, "rcfg": rcfg, "fec": fec,
            "blocks": blocks, "snap": snap, "flush": flush, "S": S}


def assert_tb_equal(tb, ref_tb, what):
    g = {k: tb[k].numpy() for k in TB_KEYS}
    for k in ("valid", "tb_no", "crc_ok"):
        assert g[k].shape == ref_tb[k].shape and g[k].dtype == ref_tb[k].dtype, (what, k)
        np.testing.assert_array_equal(g[k], ref_tb[k], err_msg=f"{what} {k}")
    v = ref_tb["valid"]
    for k in ("fec_ok", "payload", "payload_len"):
        assert g[k].shape == ref_tb[k].shape and g[k].dtype == ref_tb[k].dtype, (what, k)
        np.testing.assert_array_equal(g[k][v], ref_tb[k][v], err_msg=f"{what} {k}")


def test_coded_stream_rx_matches_reference(link):
    rx = session.StreamRx(link["rcfg"], "cpu", frames_per_block=F, fec=link["fec"])
    S = link["S"]
    got_tbs = {}
    for b, ref in enumerate(link["blocks"]):
        out, valid, tb = rx.process(link["stream"][b * S:(b + 1) * S])
        assert_tb_equal(tb, ref["tb"], f"block {b}")
        np.testing.assert_array_equal(np.asarray(valid), ref["valid"])
        np.testing.assert_array_equal(valid.header_ok, ref["header_ok"])
        assert (rx.n_lost, rx.n_frames) == (ref["n_lost"], ref["n_frames"])
        assert int(rx._tb_state.tb_no) == ref["tb_state_no"]
        for i in np.nonzero(tb["valid"].numpy())[0]:
            got_tbs[int(tb["tb_no"][i])] = (bool(tb["crc_ok"][i]),
                                            tb["payload"][i, : int(tb["payload_len"][i])].numpy())
    fl = rx.flush_tb()
    for k in ("valid", "tb_no", "crc_ok", "fec_ok", "payload", "payload_len"):
        np.testing.assert_array_equal(fl[k].numpy(), link["flush"][k], err_msg=f"flush {k}")
    assert bool(fl["valid"][0])
    got_tbs[int(fl["tb_no"][0])] = (bool(fl["crc_ok"][0]),
                                    fl["payload"][0, : int(fl["payload_len"][0])].numpy())
    # the link itself: every TB comes out once; all but the hit one carry the sent bytes
    assert sorted(got_tbs) == list(range(link["G"]))
    hit = HIT_FRAME // W
    for g, (crc_ok, pay) in got_tbs.items():
        if g == hit:
            assert not crc_ok
        else:
            assert crc_ok
            np.testing.assert_array_equal(pay, link["payload"][g * W, : link["nb"]])
    # a second flush has nothing to emit
    assert not bool(rx.flush_tb()["valid"][0])


def test_coded_state_hand_over_with_tb_ring(link):
    """The reference's carried state after block 1, TB ring included, handed
    to a fresh port session: block 2 emits what the reference's emits."""
    rx = session.StreamRx(link["rcfg"], "cpu", frames_per_block=F, fec=link["fec"])
    assert len(link["snap"]["tb"]) == len(fec_chain.TbRing._fields)
    rx.restore(link["snap"])
    S = link["S"]
    for b in (2, 3):
        _o, _v, tb = rx.process(link["stream"][b * S:(b + 1) * S])
        assert_tb_equal(tb, link["blocks"][b]["tb"], f"block {b}")
    snap = rx.snapshot()
    assert [a.dtype for a in snap["tb"]] == [np.asarray(a).dtype for a in link["snap"]["tb"]]


def test_coded_mega_and_pipelined_equal_stream_rx(link):
    """The TB ring chained through K blocks a call, and through deferred
    readbacks, emits what successive StreamRx calls emit, bit for bit."""
    S = link["S"]
    mk = lambda cls, **kw: cls(link["rcfg"], "cpu", frames_per_block=F, fec=link["fec"], **kw)
    rx = mk(session.StreamRx)
    plain = [rx.process(link["stream"][b * S:(b + 1) * S]) for b in range(N_BLOCKS)]
    prx = mk(session.StreamRxPipelined, depth=2)
    piped = [r for b in range(N_BLOCKS)
             if (r := prx.process(link["stream"][b * S:(b + 1) * S])) is not None] + prx.drain()
    mega = mk(session.StreamRxMega, blocks_per_dispatch=K)
    for d in range(N_BLOCKS // K):
        _o, valid, tb = mega.process(link["stream"][d * K * S:(d + 1) * K * S])
        want = plain[d * K:(d + 1) * K]
        np.testing.assert_array_equal(np.asarray(valid), np.concatenate([np.asarray(w[1]) for w in want]))
        for k in tb:
            np.testing.assert_array_equal(tb[k].numpy(),
                                          np.concatenate([w[2][k].numpy() for w in want]), err_msg=k)
    for b, (g, w) in enumerate(zip(piped, plain)):
        for k in w[2]:
            np.testing.assert_array_equal(g[2][k].numpy(), w[2][k].numpy(), err_msg=f"{b} {k}")
    assert len(piped) == N_BLOCKS
    f_m, f_p, f_r = mega.flush_tb(), prx.flush_tb(), rx.flush_tb()
    for k in f_r:
        np.testing.assert_array_equal(f_m[k].numpy(), f_r[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(f_p[k].numpy(), f_r[k].numpy(), err_msg=k)
    assert (mega.n_lost, mega.n_frames) == (rx.n_lost, rx.n_frames) == (prx.n_lost, prx.n_frames)
