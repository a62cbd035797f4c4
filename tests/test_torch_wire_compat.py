"""Wire-compat mode, port against the JAX package: the wire-constants file
(``dump_native`` / ``load`` and its schema checks), what ``activate``
installs, and the loopbacks of ``tests/test_wire_compat.py`` under its
foreign constants (QPSK / 8PSK / 16QAM relabeled so that no layout is
Gray, sync words of a random PN), through both packages on the same
numpy streams: uncoded batches of one constellation each (2, 3, 4), a
coded 16QAM batch, a streaming session of mixed constellations and a
two-code bank.

Bytes, bits, ints and bools must be equal between the packages and equal
to what was sent; TX samples atol 1e-5 and soft symbols atol 1e-4, the
bars of tests/test_torch_receiver.py.  ``activate`` is process-wide in
both packages: every test starts and ends with both deactivated.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import fec_chain as ref_fec
from gr_dtl_tpu.models import receiver as ref_rx
from gr_dtl_tpu.models import session as ref_session
from gr_dtl_tpu.models import transmitter as ref_tx
from gr_dtl_tpu.ops import constellation as ref_cn
from gr_dtl_tpu.ops import metrics as ref_metrics
from gr_dtl_tpu.utils import config as ref_config
from gr_dtl_tpu.utils import wire_compat as ref_wc

from gr_dtl_tpu_torch.models import fec_chain, receiver, session, transmitter
from gr_dtl_tpu_torch.ops import channel, constellation as cn, equalizer, metrics
from gr_dtl_tpu_torch.tools import bench_equalizer
from gr_dtl_tpu_torch.utils import alist, config, wire_compat
from test_wire_compat import _foreign_constants

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
INT_FIELDS = ("payload", "payload_len", "crc_ok", "header_ok", "frame_no", "cnst_id",
              "feedback_cnst", "fec_echo", "carr_offset", "fec_ok", "avg_iters")
FRAME_LENGTH = 10


@pytest.fixture(autouse=True)
def clean_wire_state():
    wire_compat.deactivate()
    ref_wc.deactivate()
    yield
    wire_compat.deactivate()
    ref_wc.deactivate()


@pytest.fixture
def foreign_file(tmp_path):
    path = tmp_path / "foreign.json"
    path.write_text(json.dumps(bench_equalizer.foreign_constants()))
    return str(path)


def _activate_both(path):
    """Both packages' configs name the file: making them installs it."""
    cfgs = {}
    for name, mod in (("port", config), ("ref", ref_config)):
        cfgs[name] = (mod.make_tx_config({"wire_compat": path}, frame_length=FRAME_LENGTH),
                      mod.make_rx_config(None, frame_length=FRAME_LENGTH))
    assert cn.TABLE_MODE and ref_cn.TABLE_MODE
    return cfgs


def test_foreign_constants_are_the_reference_tests():
    assert bench_equalizer.foreign_constants() == _foreign_constants()


def test_dump_native_and_load_equal_the_references(tmp_path):
    d = wire_compat.dump_native()
    assert d == ref_wc.dump_native()
    path = tmp_path / "native.json"
    path.write_text(json.dumps(d))
    got, want = wire_compat.load(str(path)), ref_wc.load(str(path))
    assert got.keys() == want.keys() and got["fft_len"] == want["fft_len"] == 64
    assert got["points"].keys() == want["points"].keys() == {1, 2, 3, 4}
    for ty in want["points"]:
        np.testing.assert_array_equal(got["points"][ty], want["points"][ty])
    for k in ("sync_word1", "sync_word2"):
        np.testing.assert_array_equal(got[k], want[k])
    # the native constants, installed: tables and sync words as they were
    wire_compat.activate(str(path))
    np.testing.assert_array_equal(cn.POINTS, cn._DEFAULT_POINTS)
    assert cn.TABLE_MODE and cn.active("cpu").table_mode
    np.testing.assert_array_equal(config.make_sync_word1(), ref_config.make_sync_word1())


@pytest.mark.parametrize("broken, match", [
    (lambda d: d.pop("sync_word2"), "missing key 'sync_word2'"),
    (lambda d: d["constellations"].pop("psk8"), "missing constellation entries"),
    (lambda d: d["constellations"]["qam16"].pop(), "qam16: expected 16 points, got 15"),
    (lambda d: d["sync_word1"].pop(), "sync_word1: expected 64 bins, got 63"),
])
def test_load_refuses_what_the_reference_refuses(tmp_path, broken, match):
    d = wire_compat.dump_native()
    broken(d)
    path = tmp_path / "broken.json"
    path.write_text(json.dumps(d))
    for mod in (wire_compat, ref_wc):
        with pytest.raises(ValueError, match=match):
            mod.load(str(path))


def test_activate_installs_the_references_constants(foreign_file):
    _activate_both(foreign_file)
    np.testing.assert_array_equal(cn.POINTS, ref_cn.POINTS)
    np.testing.assert_array_equal(cn.MIN_DIST, ref_cn.MIN_DIST)
    np.testing.assert_array_equal(cn.min_distances(), ref_cn.min_distances())
    assert not np.array_equal(cn.POINTS[2, :4], cn._DEFAULT_POINTS[2, :4])
    for make, ref_make in ((config.make_sync_word1, ref_config.make_sync_word1),
                           (config.make_sync_word2, ref_config.make_sync_word2)):
        np.testing.assert_array_equal(make(64), ref_make(64))
        with pytest.raises(ValueError, match="does not match this config"):
            make(128)
    tab = cn.active("cpu")
    assert tab.table_mode and np.array_equal(tab.points.numpy(), cn.POINTS)
    np.testing.assert_array_equal(tab.min_dist.numpy(), ref_cn.MIN_DIST)
    wire_compat.deactivate()
    ref_wc.deactivate()
    assert not cn.TABLE_MODE and not cn.active("cpu").table_mode
    np.testing.assert_array_equal(cn.active("cpu").points.numpy(), ref_cn.POINTS)
    np.testing.assert_array_equal(cn.MIN_DIST, ref_cn.MIN_DIST)
    np.testing.assert_array_equal(config.make_sync_word1(), ref_config.make_sync_word1())


def test_missing_constants_file_raises_in_both():
    for mod in (config, ref_config):
        with pytest.raises(FileNotFoundError):
            mod.make_rx_config(None, wire_compat="/nonexistent/wire_constants.json")
    assert not cn.TABLE_MODE


def test_table_decisions_and_llrs_equal_the_references_oracles(foreign_file):
    """In table mode hard_decision / nearest_point are the table argmin and
    soft_llrs the table reduction, as the reference's."""
    _activate_both(foreign_file)
    rng = np.random.RandomState(0)
    y = (rng.randn(4, 32) + 1j * rng.randn(4, 32)).astype(np.complex64)
    cid = np.array([1, 2, 3, 4], np.int32)
    nv = np.full(4, 0.3, np.float32)
    ty, tc, tn = torch.as_tensor(y), torch.as_tensor(cid), torch.as_tensor(nv)
    jy, jc, jn = jnp.asarray(y), jnp.asarray(cid), jnp.asarray(nv)
    np.testing.assert_array_equal(cn.hard_decision(ty, tc).numpy(), np.asarray(ref_cn.hard_decision(jy, jc)))
    np.testing.assert_array_equal(cn.hard_decision(ty, tc).numpy(),
                                  cn.nearest_point_table(ty, tc)[0].numpy())
    idx, pt = cn.nearest_point(ty, tc)
    r_idx, r_pt = ref_cn.nearest_point(jy, jc)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(r_pt))
    got = cn.soft_llrs(ty, tc, tn)
    np.testing.assert_array_equal(got.numpy(), cn.soft_llrs_table(ty, tc, tn).numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_cn.soft_llrs(jy, jc, jn)), atol=1e-5, rtol=1e-5)
    sym = rng.randint(0, 16, (4, 32)) % (1 << cn.BITS_PER_SYMBOL[cid])[:, None]
    np.testing.assert_array_equal(cn.map_symbols(torch.as_tensor(sym), tc[:, None]).numpy(),
                                  np.asarray(ref_cn.map_symbols(jnp.asarray(sym), jc[:, None])))
    # the adaptation metric normalises by the foreign tables' least distances
    hard = rng.randn(4, 3, 48).astype(np.complex64)
    soft = (hard + 0.1 * rng.randn(4, 3, 48)).astype(np.complex64)
    np.testing.assert_allclose(
        metrics.constellation_metric(torch.as_tensor(hard), torch.as_tensor(soft), tc).numpy(),
        np.asarray(ref_metrics.constellation_metric(jnp.asarray(hard), jnp.asarray(soft), jc)), rtol=1e-5)


def test_near_decision_boundary_in_table_mode_finds_the_voronoi_edges(foreign_file):
    """Relabeling moves no point, so the table-mode classifier finds the
    closed form's boundaries (the closed form measures 8PSK's by the arc,
    an upper bound of the distance, so it may find fewer); and it flags
    every point that two decisions 2e-6 apart decide differently."""
    wire_compat.activate(foreign_file)
    tab = cn.active("cpu")
    wire_compat.deactivate()
    rng = np.random.RandomState(1)
    for cid in (1, 2, 3, 4):
        n = 4000
        y = (rng.uniform(-1.3, 1.3, n) + 1j * rng.uniform(-1.3, 1.3, n)).astype(np.complex64)
        t, c = torch.as_tensor(y)[None], torch.tensor([cid])
        for eps in (1e-2, 1e-3):
            by_table, closed = cn.near_decision_boundary(t, c, eps, tab), cn.near_decision_boundary(t, c, eps)
            assert not bool((closed & ~by_table).any()) and int((by_table & ~closed).sum()) <= n // 1000
            assert int(by_table.sum()) > 0
        y2 = (y + 2e-6 * np.exp(2j * np.pi * rng.rand(n))).astype(np.complex64)
        t2 = torch.as_tensor(y2)[None]
        flipped = cn.nearest_point(t, c, tab)[0] != cn.nearest_point(t2, c, tab)[0]
        assert bool(cn.near_decision_boundary(t, c, 1e-5, tab)[flipped].all())


def _sent(tcfg, cnst, rng):
    maxb = tcfg.max_frame_bytes()
    plen = np.array([tcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[c])) - 4 for c in cnst], np.int32)
    payload = np.zeros((len(cnst), maxb), np.uint8)
    for i, n in enumerate(plen):
        payload[i, :n] = rng.randint(0, 256, n)
    return payload, plen


def _tx_both(cfgs, payload, plen, cnst, key, fec=None, fec_id=None):
    """The reference's TX (jitted) and the port's on the same frames, the
    port handed the reference's pad; their samples, held to each other."""
    (tcfg, _), (ref_tcfg, _) = cfgs["port"], cfgs["ref"]
    B = len(cnst)
    ref_txp = ref_tx.build_tx(ref_tcfg, fec and fec[1])
    kw = {} if fec_id is None else {"fec_id": jnp.asarray(fec_id)}
    ref_out = jax.jit(lambda *a: ref_tx.tx_frames(ref_txp, *a, **kw))(
        jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst), jnp.zeros(B, jnp.int32),
        jnp.arange(B, dtype=jnp.int32), jax.random.PRNGKey(key))
    out = transmitter.tx_frames(
        transmitter.build_tx(tcfg, "cpu", fec and fec[0]), torch.as_tensor(payload),
        torch.as_tensor(plen), torch.as_tensor(cnst), torch.zeros(B, dtype=torch.int32),
        torch.arange(B, dtype=torch.int32), None if fec else torch.as_tensor(np.array(ref_out.frame_bytes)),
        fec_id=None if fec_id is None else torch.as_tensor(fec_id))
    np.testing.assert_array_equal(out.frame_bytes.numpy(), np.asarray(ref_out.frame_bytes))
    np.testing.assert_allclose(out.samples.numpy(), np.asarray(ref_out.samples), atol=1e-5)
    return np.asarray(ref_out.samples)


def _noisy(samples, lead, tail, snr_db, rng):
    s = np.concatenate([np.zeros(lead, np.complex64), samples.reshape(-1), np.zeros(tail, np.complex64)])
    std = np.float32(np.sqrt(np.mean(np.abs(samples) ** 2) / 10 ** (snr_db / 10)) / np.sqrt(2.0))
    return (s + std * (rng.randn(len(s)) + 1j * rng.randn(len(s))).astype(np.complex64)).astype(np.complex64)


def _rx_both(cfgs, stream, B, fec=None):
    (_, rcfg), (_, ref_rcfg) = cfgs["port"], cfgs["ref"]
    ref_rxp = ref_rx.build_rx(ref_rcfg, fec and fec[1])
    want = jax.jit(lambda x: ref_rx.rx_frames(ref_rxp, ref_rx.detect_and_extract(x, ref_rcfg, B)[0]))(
        jnp.asarray(stream))
    frames, _ = receiver.detect_and_extract(torch.as_tensor(stream), rcfg, B)
    got = receiver.rx_frames(receiver.build_rx(rcfg, "cpu", fec and fec[0]), frames)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.soft_syms.numpy(), np.asarray(want.soft_syms), atol=1e-4)
    return got


@pytest.mark.parametrize("ctype", [2, 3, 4])
def test_foreign_uncoded_loopback_matches_reference(foreign_file, ctype):
    """tests/test_wire_compat.py::test_foreign_constants_loopback."""
    cfgs = _activate_both(foreign_file)
    rng = np.random.RandomState(7)
    cnst = np.full(4, ctype, np.int32)
    payload, plen = _sent(cfgs["port"][0], cnst, rng)
    samples = _tx_both(cfgs, payload, plen, cnst, key=0)
    got = _rx_both(cfgs, _noisy(samples, 301, 400, 30.0, rng), len(cnst))
    assert got.crc_ok.all() and got.header_ok.all()
    np.testing.assert_array_equal(got.payload.numpy(), payload)


def _coded(cfgs, names):
    tcfg = config.make_tx_config(None, frame_length=FRAME_LENGTH, fec=True)
    ref_tcfg = ref_config.make_tx_config(None, frame_length=FRAME_LENGTH, fec=True)
    Hs = [alist.load_alist(str(EXAMPLES / n)) for n in names]
    cfgs = {"port": (tcfg, config.make_rx_config(None, frame_length=FRAME_LENGTH, fec=True)),
            "ref": (ref_tcfg, ref_config.make_rx_config(None, frame_length=FRAME_LENGTH, fec=True))}
    return cfgs, (fec_chain.build_fec(tcfg, Hs, "cpu"), ref_fec.build_fec(ref_tcfg, Hs))


def test_foreign_coded_loopback_matches_reference(foreign_file):
    """tests/test_wire_compat.py::test_foreign_constants_coded_loopback: 16QAM,
    the soft demap by table, 25 dB."""
    cfgs, fec = _coded(_activate_both(foreign_file), ["n_0100_k_0027.alist"])
    rng = np.random.RandomState(11)
    B, nbytes = 4, int(fec[0].user_bytes_tab[4])
    cnst = np.full(B, 4, np.int32)
    payload = np.zeros((B, fec[0].max_payload_bytes), np.uint8)
    payload[:, :nbytes] = rng.randint(0, 256, (B, nbytes))
    samples = _tx_both(cfgs, payload, np.full(B, nbytes, np.int32), cnst, key=0, fec=fec)
    got = _rx_both(cfgs, _noisy(samples, 211, 400, 25.0, rng), B, fec)
    assert got.crc_ok.all() and got.header_ok.all()
    np.testing.assert_array_equal(got.payload.numpy()[:, :nbytes], payload[:, :nbytes])


def test_foreign_code_bank_matches_reference(foreign_file):
    """tests/test_wire_compat.py::test_foreign_constants_code_bank: two codes,
    per-frame code ids, constellations 2..4, 25 dB."""
    cfgs, fec = _coded(_activate_both(foreign_file), ["n_0100_k_0027.alist", "n_0300_k_0152.alist"])
    rng = np.random.RandomState(31)
    B = 8
    cnst = rng.randint(2, 5, B).astype(np.int32)
    fec_id = rng.randint(1, 3, B).astype(np.int32)
    ub = fec[0].user_bytes_tab2[fec_id, cn.BITS_PER_SYMBOL[cnst]].astype(np.int32)
    payload = np.zeros((B, fec[0].max_payload_bytes), np.uint8)
    for i in range(B):
        payload[i, : ub[i]] = rng.randint(0, 256, ub[i])
    samples = _tx_both(cfgs, payload, ub, cnst, key=1, fec=fec, fec_id=fec_id)
    got = _rx_both(cfgs, _noisy(samples, 223, 400, 25.0, rng), B, fec)
    assert got.crc_ok.all() and got.header_ok.all()
    for i in range(B):
        np.testing.assert_array_equal(got.payload.numpy()[i, : ub[i]], payload[i, : ub[i]])


def test_foreign_streaming_session_matches_reference(foreign_file):
    """tests/test_wire_compat.py::test_foreign_constants_streaming_session:
    StreamRx block by block, mixed constellations, frames across every
    block boundary, both packages on the same stream."""
    cfgs = _activate_both(foreign_file)
    (_, rcfg), (_, ref_rcfg) = cfgs["port"], cfgs["ref"]
    F, n_blocks = 4, 4
    B = (n_blocks - 1) * F
    rng = np.random.RandomState(21)
    cnst = rng.randint(1, 5, B).astype(np.int32)
    payload, plen = _sent(cfgs["port"][0], cnst, rng)
    samples = _tx_both(cfgs, payload, plen, cnst, key=5)
    rx, ref = session.StreamRx(rcfg, "cpu", frames_per_block=F), ref_session.StreamRx(ref_rcfg, frames_per_block=F)
    blk = rx.block_samples
    stream = _noisy(samples, 317, n_blocks * blk, 30.0, rng)[: n_blocks * blk]
    decoded = {}
    for b in range(n_blocks):
        chunk = stream[b * blk:(b + 1) * blk]
        (out, valid), (ref_out, ref_valid) = rx.process(chunk), ref.process(chunk)
        np.testing.assert_array_equal(np.asarray(valid), np.asarray(ref_valid))
        np.testing.assert_array_equal(valid.crc_ok, ref_valid.crc_ok)
        for name in ("payload", "payload_len", "crc_ok", "header_ok", "frame_no", "cnst_id"):
            np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref_out, name)),
                                          err_msg=f"block {b} {name}")
        for i in np.nonzero(out.crc_ok.numpy() & np.asarray(valid))[0]:
            decoded[int(out.frame_no[i])] = out.payload[i, : int(out.payload_len[i])].numpy().tobytes()
    assert sorted(decoded) == list(range(B))
    for i in range(B):
        assert decoded[i] == payload[i, : plen[i]].tobytes()
    assert (rx.n_lost, rx.n_frames) == (ref.n_lost, ref.n_frames)


def test_models_keep_the_tables_they_were_built_with(foreign_file):
    """activate -> build -> deactivate -> build: the first models keep the
    foreign tables and sync words (and still talk to each other), the
    second get the native ones; the installed tables are not stale."""
    wire_compat.activate(foreign_file)
    tcfg = config.make_tx_config(None, frame_length=4)
    rcfg = config.make_rx_config(None, frame_length=4)
    foreign = transmitter.build_tx(tcfg, "cpu"), receiver.build_rx(rcfg, "cpu")
    foreign_session = session.StreamRx(rcfg, "cpu", frames_per_block=2)
    w1 = config.make_sync_word1()
    wire_compat.deactivate()
    native = transmitter.build_tx(tcfg, "cpu"), receiver.build_rx(rcfg, "cpu")
    assert not cn.active("cpu").table_mode
    np.testing.assert_array_equal(cn.active("cpu").points.numpy(), cn._DEFAULT_POINTS)
    for txp, rxp, table_mode in (*foreign, True), (*native, False):
        assert txp.tab.table_mode is rxp.tab.table_mode is rxp.eq2.tab.table_mode is table_mode
    assert foreign_session.rxp.tab.table_mode
    assert not np.array_equal(foreign[1].tab.points.numpy(), native[1].tab.points.numpy())
    np.testing.assert_array_equal(foreign[1].ce.w1.numpy(), w1)
    np.testing.assert_array_equal(native[1].ce.w1.numpy(), config.make_sync_word1())
    assert not np.array_equal(foreign[1].ce.w1.numpy(), native[1].ce.w1.numpy())
    rng = np.random.RandomState(3)
    cnst = np.array([2, 3, 4, 4, 3, 2], np.int32)
    payload, plen = _sent(tcfg, cnst, rng)
    B = len(cnst)
    for (txp, rxp), other in ((foreign, native), (native, foreign)):
        out = transmitter.tx_frames(txp, torch.as_tensor(payload), torch.as_tensor(plen),
                                    torch.as_tensor(cnst), torch.zeros(B, dtype=torch.int32),
                                    torch.arange(B, dtype=torch.int32),
                                    torch.as_tensor(rng.randint(0, 256, (B, tcfg.max_frame_bytes())).astype(np.uint8)))
        stream = torch.as_tensor(_noisy(out.samples.numpy(), 150, 400, 30.0, rng))
        got = receiver.rx_frames(rxp, receiver.detect_and_extract(stream, rcfg, B)[0])
        assert got.crc_ok.all(), txp.tab.table_mode
        np.testing.assert_array_equal(got.payload.numpy(), payload)
        # the other model's receiver, built with the other tables, fails
        # every relabeled frame (its header, BPSK, still decodes)
        mixed = receiver.rx_frames(other[1], receiver.detect_and_extract(stream, rcfg, B)[0])
        assert not mixed.crc_ok.any()


def test_equalizer_plain_loop_decides_by_table(foreign_file):
    """The plain loop (what the kernel is held to) decides by the model's
    tables: on foreign tables it decides the table argmin of each symbol;
    the same frames under the closed form decide the same points (the
    relabeling moves none)."""
    eq_t = bench_equalizer.eq_tables("cpu", tab=bench_equalizer.wire_tables("cpu", json.load(open(foreign_file))))
    eq_c = bench_equalizer.eq_tables("cpu")
    assert eq_t.tab.table_mode and not eq_c.tab.table_mode and not cn.TABLE_MODE
    B = 16
    cnst = bench_equalizer.mixed_ids(B)
    args = bench_equalizer.on_device(bench_equalizer.frame_inputs(eq_t, B, 5, 1, cnst, 4), cnst, "cpu")
    got = equalizer.equalize_frame(*args, eq_t, 1)
    want = equalizer.equalize_frame(*args, eq_c, 1)
    data = (eq_t.occ_mask & ~eq_t.pilot_mask)
    idx, pts = cn.nearest_point_table(got.soft[:, :, data], args[2][:, None, None], eq_t.tab)
    assert torch.equal(got.hard[:, :, data], pts)
    np.testing.assert_allclose(got.hard.numpy(), want.hard.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.taps.numpy(), want.taps.numpy(), atol=1e-5)
