"""The sharded streaming session, port against the JAX package: the same
global numpy chunks, call by call, through the reference's
``ShardedStreamRx`` (its sharded step on the virtual CPU devices of
tests/conftest.py) and the port's, whose ranks run as 2 or 4 gloo worker
processes on the same ``(stream, time)`` grid (``parallel.launch.spawn``;
the workers import the port and torch only).

Uncoded over four chained blocks on (2, 2) and (2, 1) grids, a (1, 2) run
that starts from the reference's carried state after its first block
(``snapshot_from_reference``), coded W = 2 transport blocks with
``flush_tb`` across two processes and the megastep K = 2; the uncoded runs
carry a telemetry probe.
Streams: frame_length 6, mixed constellations 1..4, frames starting at a
different offset in every stream so that block boundaries cut frames, AWGN
at 30 dB from one numpy draw, and a block of idle air at the end.

Masks, frame numbers, constellations, payload bytes and lengths, the lock
state, ``expected_no``, the fallback, the loss counters and the TBs must be
equal.  ``snr_db`` / ``noise_var`` are held to 1e-3 relative on the
decoded frames: float32 on both sides, summed in another order (the
reference documents last-ulp differences from its summed fold vote,
gr_dtl_tpu/parallel/session.py:38-44), as in tests/test_torch_session_rx.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import fec_chain as ref_fec_chain
from gr_dtl_tpu.parallel import mesh as ref_mesh
from gr_dtl_tpu.parallel.session import ShardedStreamRx as RefShardedStreamRx
from gr_dtl_tpu.testbed import monitor as ref_monitor
from gr_dtl_tpu.utils import alist as ref_alist, config as ref_config

from gr_dtl_tpu_torch.models import transmitter
from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.parallel import launch, session
from gr_dtl_tpu_torch.testbed import monitor
from gr_dtl_tpu_torch.utils import config

FRAME_LENGTH, S, F = 6, 4, 4
SNR_DB = 30.0
ALIST = Path(__file__).resolve().parent.parent / "examples" / "n_0100_k_0027.alist"
INT_FIELDS = ("payload", "payload_len", "crc_ok", "header_ok", "frame_no", "cnst_id",
              "feedback_cnst", "carr_offset")
TS = 1_760_000_000_000  # every envelope's system_ts, in both packages
FLOATS = ("estimated_snr_tag_key", "noise_tag_key")


def make_streams(cfg, n_streams, n_frames, n_blocks, block_samples, seed, fec=None):
    """[n_streams, n_blocks * block_samples] samples: n_frames frames a
    stream (uncoded: mixed constellations filled to capacity; coded: one
    QPSK transport block of W frames each) from an offset of its own, then
    idle air, AWGN at SNR_DB from one numpy draw.  Returns (streams, payloads)."""
    tcfg = config.make_tx_config(None, frame_length=FRAME_LENGTH, fec=fec is not None)
    txp = transmitter.build_tx(tcfg, "cpu", fec)
    rng = np.random.RandomState(seed)
    n = n_blocks * block_samples
    streams, payloads = np.zeros((n_streams, n), np.complex64), []
    for s in range(n_streams):
        if fec is None:
            cnst = rng.randint(1, 5, size=n_frames).astype(np.int32)
            maxb = tcfg.max_frame_bytes()
            plen = np.array([tcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[c])) - 4 for c in cnst], np.int32)
            pad = torch.as_tensor(rng.randint(0, 256, (n_frames, maxb)).astype(np.uint8))
        else:
            cnst = np.full(n_frames, 2, np.int32)
            maxb, nb = fec.max_payload_bytes, int(fec.user_bytes_tab[2])
            plen = np.where(np.arange(n_frames) % fec.W == 0, nb, 0).astype(np.int32)
            pad = None
        payload = rng.randint(0, 256, (n_frames, maxb)).astype(np.uint8)
        payload[np.arange(maxb)[None, :] >= plen[:, None]] = 0
        out = transmitter.tx_frames(txp, torch.as_tensor(payload), torch.as_tensor(plen),
                                    torch.as_tensor(cnst), torch.zeros(n_frames, dtype=torch.int32),
                                    torch.arange(n_frames, dtype=torch.int32), pad)
        samples = out.samples.reshape(-1).numpy()
        off = 150 + 97 * s
        streams[s, off: off + samples.size] = samples[: n - off]
        std = np.float32(np.sqrt(np.mean(np.abs(samples) ** 2) / 10 ** (SNR_DB / 10)) / np.sqrt(2.0))
        streams[s] += std * (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
        payloads.append(payload)
    return streams, payloads


def run_reference(srx, chunks):
    """Each chunk through the reference session: the RxOut fields as numpy
    ([S, F, ...], K > 1: [S, K, F, ...]), the masks and the counters."""
    calls = []
    for chunk in chunks:
        res = srx.process(chunk)
        rec = {"out": {k: np.asarray(getattr(res[0], k)) for k in launch.OUT_FIELDS},
               "valid": np.asarray(res[1]).copy(), "header_ok": srx.last_header_ok.copy(),
               "crc_ok": srx.last_crc_ok.copy(), "n_lost": srx.n_lost.copy(),
               "n_frames": srx.n_frames.copy()}
        if len(res) == 3:
            rec["tb"] = {k: np.asarray(v) for k, v in res[2].items()}
        calls.append(rec)
    return calls


def assert_calls_equal(got, want, K=1):
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        for k in ("valid", "header_ok", "crc_ok", "n_lost", "n_frames"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"call {c} {k}")
        for k in INT_FIELDS:
            a, b = g["out"][k], w["out"][k]
            assert a.shape == b.shape and a.dtype == b.dtype, (c, k, a.shape, b.shape, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"call {c} {k}")
        ok = (w["valid"] & w["header_ok"]).reshape(w["out"]["snr_db"].shape)
        for k in ("snr_db", "noise_var"):
            np.testing.assert_allclose(g["out"][k][ok], w["out"][k][ok], rtol=1e-3, err_msg=f"call {c} {k}")
        if "tb" in w:
            v = w["tb"]["valid"]
            for k in ("valid", "tb_no"):
                np.testing.assert_array_equal(g["tb"][k], w["tb"][k], err_msg=f"call {c} tb {k}")
            for k in ("crc_ok", "fec_ok", "payload_len", "payload"):
                np.testing.assert_array_equal(g["tb"][k][v], w["tb"][k][v], err_msg=f"call {c} tb {k}")


def assert_state_equal(snap, ref_srx):
    want = session.snapshot_from_reference(ref_srx)
    np.testing.assert_array_equal(snap["tail"], want["tail"])
    for g, w in zip(snap["lock"], want["lock"]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for k in ("fallback", "expected_no", "n_lost", "n_frames"):
        np.testing.assert_array_equal(snap[k], want[k], err_msg=k)
    if want["tb"] is not None:
        for i, (g, w) in enumerate(zip(snap["tb"], want["tb"])):
            assert g.dtype == w.dtype and g.shape == w.shape, i
            if g.dtype == np.float32:
                np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3, err_msg=f"tb leaf {i}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"tb leaf {i}")


@pytest.fixture(scope="module")
def cfgs():
    return (config.make_rx_config(None, frame_length=FRAME_LENGTH),
            ref_config.make_rx_config(None, frame_length=FRAME_LENGTH))


@pytest.fixture(scope="module")
def chunks(cfgs):
    P = cfgs[0].frame_samples
    streams, _ = make_streams(cfgs[0], S, 3 * F - 2, 4, F * P, seed=5)
    return [streams[:, b * F * P:(b + 1) * F * P] for b in range(4)]


def assert_same_messages(ranks, ref_probe, n_stream):
    """The ranks at time index 0 publish their own streams' messages, each
    call stream by stream, every rank's probe counting its own; taken call
    by call and row by row they are the reference's (its one probe
    publishes every stream's, call by call)."""
    rows = sorted((r for r in ranks if r["index"]["time"] == 0), key=lambda r: r["index"]["stream"])
    assert all(r["captured"] == [] for r in ranks if r["index"]["time"] != 0)
    assert len(rows) == n_stream
    parsed = [[monitor.MonitorParser().parse(b) for b in r["captured"]] for r in rows]
    for msgs in parsed:
        assert [m["sent_counter"] for m in msgs] == list(range(1, len(msgs) + 1))
    got, S_l = [], S // n_stream
    for call in rows[0]["calls"]:
        ok = call["valid"] & call["header_ok"]
        for row, msgs in enumerate(parsed):
            n = int(ok[row * S_l:(row + 1) * S_l].sum())
            got += msgs[:n]
            parsed[row] = msgs[n:]
    assert all(not msgs for msgs in parsed)
    want = [ref_monitor.MonitorParser().parse(b) for b in ref_probe.captured]
    assert len(got) == len(want) == S * (3 * F - 2)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in w:
            if k in FLOATS:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-3, err_msg=f"message {i} {k}")
            elif k != "sent_counter":
                assert g[k] == w[k], (i, k, g[k], w[k])


@pytest.mark.parametrize("grid", [(2, 2), (2, 1)])
def test_sharded_session_matches_reference(cfgs, chunks, grid):
    """Four chained blocks, a capture-mode probe on each side (envelopes
    stamped TS in both packages)."""
    cfg, ref_cfg = cfgs
    ref_probe = ref_monitor.MonitorProbe(address=None)
    saved = ref_monitor.system_ts
    ref_monitor.system_ts = lambda: TS
    try:
        ref = RefShardedStreamRx(ref_cfg, ref_mesh.make_mesh(*grid), n_streams=S, frames_per_block=F,
                                 probe=ref_probe)
        want = run_reference(ref, chunks)
    finally:
        ref_monitor.system_ts = saved
    ranks = launch.spawn(launch.run_session, *grid, device="cpu", cfg=cfg, n_streams=S, frames_per_block=F,
                         chunks=chunks, probe=True, timestamp=TS)
    for r in ranks:  # every rank holds every stream's results
        assert_calls_equal(r["calls"], want)
        assert_state_equal(r["snapshot"], ref)
    got = ranks[0]["calls"]
    assert sum(int((c["valid"] & c["crc_ok"]).sum()) for c in got) == S * (3 * F - 2)
    assert ranks[0]["snapshot"]["n_lost"].tolist() == [0] * S
    assert_same_messages(ranks, ref_probe, grid[0])


def test_sharded_session_restores_the_references_state(cfgs, chunks):
    """(1, 2): the port starts from the reference's carried state after its
    first block and runs the rest."""
    cfg, ref_cfg = cfgs
    ref = RefShardedStreamRx(ref_cfg, ref_mesh.make_mesh(1, 2), n_streams=S, frames_per_block=F)
    run_reference(ref, chunks[:1])
    snap = session.snapshot_from_reference(ref)
    want = run_reference(ref, chunks[1:])
    ranks = launch.spawn(launch.run_session, 1, 2, device="cpu", cfg=cfg, n_streams=S, frames_per_block=F,
                         chunks=chunks[1:], restore=snap)
    for r in ranks:
        assert_calls_equal(r["calls"], want)
        assert_state_equal(r["snapshot"], ref)


def test_sharded_megastep_matches_reference(cfgs, chunks):
    """K = 2 blocks a call on (2, 2): leaves [S, K, F, ...], masks [S, K*F]."""
    cfg, ref_cfg = cfgs
    K = 2
    calls = [np.concatenate(chunks[i:i + K], axis=1) for i in range(0, len(chunks), K)]
    ref = RefShardedStreamRx(ref_cfg, ref_mesh.make_mesh(2, 2), n_streams=S, frames_per_block=F,
                             blocks_per_dispatch=K)
    want = run_reference(ref, calls)
    ranks = launch.spawn(launch.run_session, 2, 2, device="cpu", cfg=cfg, n_streams=S, frames_per_block=F,
                         chunks=calls, blocks_per_dispatch=K)
    assert ranks[0]["calls"][0]["out"]["frame_no"].shape == (S, K, F)
    for r in ranks:
        assert_calls_equal(r["calls"], want)
        assert_state_equal(r["snapshot"], ref)


def test_sharded_coded_session_and_flush_match_reference():
    """W = 2 transport blocks on a (1, 2) grid of two processes: the TBs
    emitted block by block, one mid-TB frame of stream 1 replaced by noise,
    then ``flush_tb`` (gathered through the group, on every rank)."""
    W, Sc, Fc, n_blocks = 2, 2, 4, 3
    tcfg = config.make_tx_config(None, frame_length=FRAME_LENGTH, fec=True)
    cfg = config.make_rx_config(None, frame_length=FRAME_LENGTH, fec=True)
    ref_tcfg = ref_config.make_tx_config(None, frame_length=FRAME_LENGTH, fec=True)
    ref_cfg = ref_config.make_rx_config(None, frame_length=FRAME_LENGTH, fec=True)
    ref_fec = ref_fec_chain.build_fec(ref_tcfg, ref_alist.load_alist(str(ALIST)), tb_frames=W)
    fec = launch._fec((tcfg, ALIST, W), "cpu")
    P = cfg.frame_samples
    streams, _ = make_streams(cfg, Sc, (n_blocks - 1) * Fc + W, n_blocks, Fc * P, seed=9, fec=fec)
    hit = 150 + 97 + 5 * P  # frame 5 of stream 1: the second frame of TB 2
    streams[1, hit: hit + P] = (np.random.RandomState(3).randn(P) * 0.6).astype(np.complex64)
    chunks = [streams[:, b * Fc * P:(b + 1) * Fc * P] for b in range(n_blocks)]
    ref = RefShardedStreamRx(ref_cfg, ref_mesh.make_mesh(1, 2), n_streams=Sc, frames_per_block=Fc,
                             fec=ref_fec)
    want = run_reference(ref, chunks)
    want_snap_tb = session.snapshot_from_reference(ref)["tb"]
    want_flush = {k: np.asarray(v) for k, v in ref.flush_tb().items()}
    ranks = launch.spawn(launch.run_session, 1, 2, device="cpu", cfg=cfg, n_streams=Sc, frames_per_block=Fc,
                         chunks=chunks, fec=(tcfg, ALIST, W), flush=True)
    n_tbs = 0
    for r in ranks:
        assert_calls_equal(r["calls"], want)
        for i, (g, w) in enumerate(zip(r["snapshot"]["tb"], want_snap_tb)):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3, err_msg=f"tb leaf {i}")
        fl = r["flush"]
        for k in ("valid", "tb_no"):
            np.testing.assert_array_equal(fl[k], want_flush[k], err_msg=f"flush {k}")
        v = want_flush["valid"]
        assert v.all()
        for k in ("crc_ok", "fec_ok", "payload_len", "payload"):
            np.testing.assert_array_equal(fl[k][v], want_flush[k][v], err_msg=f"flush {k}")
        n_tbs = sum(int(c["tb"]["valid"].sum()) for c in r["calls"])
    tb_ok = [c["tb"]["crc_ok"][c["tb"]["valid"]] for c in ranks[0]["calls"]]
    assert n_tbs >= 2 * Sc and not np.concatenate(tb_ok).all()  # the hit TB fails, as in the reference
