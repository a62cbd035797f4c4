"""The in-graph links (simplex, full duplex with and without FEC) and the
two burst sessions (``StreamBurstRx``, ``StreamSimplex``) of the port
against the JAX package's.

The reference draws a round's payload, pad bytes and noises from
``jax.random`` keys split inside its scan; the tests compute those same
draws (keys split as ``simplex.round_step`` / ``full_duplex.send_one``
split them) and hand them to the port's ``run(draws=...)``.  Integer and
bool telemetry and the final states must be equal; ``snr_db`` (dB, values
5-45) to atol 5e-2, the bar of tests/test_torch_receiver.py.  Small sizes:
frame_length 6-10, 8 rounds, ``decision_th`` lowered to 2 on both sides so
that the constellation moves inside 8 rounds.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import fec_chain as ref_fec
from gr_dtl_tpu.models import full_duplex as ref_duplex
from gr_dtl_tpu.models import session as ref_session
from gr_dtl_tpu.models import simplex as ref_simplex
from gr_dtl_tpu.ops import burst as ref_burst
from gr_dtl_tpu.ops.constellation import ConstellationType as C
from gr_dtl_tpu.utils import alist as ref_alist
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch.models import fec_chain, full_duplex, session, simplex
from gr_dtl_tpu_torch.ops import burst
from gr_dtl_tpu_torch.utils import config

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
ROUNDS = 8
SNR_ATOL = 5e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bytes(key, shape):
    return np.asarray(jax.random.randint(key, shape, 0, 256, dtype=jnp.int32).astype(jnp.uint8))


def _unit_normal(key, shape):
    kr, ki = jax.random.split(key)
    return (np.asarray(jax.random.normal(kr, shape, dtype=jnp.float32))
            + 1j * np.asarray(jax.random.normal(ki, shape, dtype=jnp.float32))).astype(np.complex64)


def _stack(rounds):
    return {k: torch.as_tensor(np.stack([r[k] for r in rounds])) for k in rounds[0]}


def _compare_telemetry(telem, telem_r):
    assert telem.keys() == telem_r.keys()
    for k, want in telem_r.items():
        got, want = telem[k].numpy(), np.asarray(want)
        assert got.shape == want.shape == (ROUNDS,) and got.dtype == want.dtype, k
        if got.dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=0, atol=SNR_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def _tree_equal(got, want):
    got, want = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got)), jax.tree.leaves(_np(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# simplex
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("noise_fwd,noise_rev", [(0.02, 0.1), (0.5, 0.1), (0.05, 1.5)])
def test_simplex_run_matches_reference(noise_fwd, noise_rev):
    """A clean forward link (the TX climbs), a poor one (it stays at BPSK)
    and a reverse channel that loses bursts (the TX moves only on the
    rounds whose burst decoded)."""
    ref_cfg = ref_config.make_tx_config(None, frame_length=6)
    cfg = config.config_from_reference(ref_cfg)
    run_r, tables_r = ref_simplex.build_simplex(ref_cfg, noise_fwd=noise_fwd, noise_rev=noise_rev)
    run, tables = simplex.build_simplex(cfg, "cpu", noise_fwd=noise_fwd, noise_rev=noise_rev)
    tables_r["decision_th"] = tables["decision_th"] = 2
    state_r = ref_simplex.initial_simplex_state(ref_cfg, tables_r)
    state = simplex.simplex_state_from_reference(_np(state_r), "cpu")
    _tree_equal(state, state_r)
    _tree_equal(simplex.initial_simplex_state(cfg, tables, "cpu"), state_r)

    key = jax.random.PRNGKey(0)
    shapes = run.draw_shapes
    rounds = []
    for k in jax.random.split(key, ROUNDS):
        kp, kpad, kn, kb = jax.random.split(k, 4)
        rounds.append({"payload": _bytes(kp, shapes["payload"][0]),
                       "pad": _bytes(kpad, shapes["pad"][0]),
                       "noise_fwd": _unit_normal(kn, shapes["noise_fwd"][0]),
                       "noise_rev": _unit_normal(kb, shapes["noise_rev"][0])})
    state_r, telem_r = run_r(state_r, key, n_rounds=ROUNDS)
    state, telem = run(state, ROUNDS, draws=_stack(rounds))
    _compare_telemetry(telem, telem_r)
    _tree_equal(state, state_r)
    tx = telem["tx_cnst"].numpy()
    if noise_rev > 1:
        assert not telem["burst_ok"].all()  # bursts were lost
        moved = np.nonzero(np.diff(np.concatenate([[1], tx])))[0]
        assert telem["burst_ok"].numpy()[moved].all()
    elif noise_fwd < 0.1:
        assert tx[-1] > int(C.BPSK) and telem["burst_ok"].all() and telem["crc_ok"][-2:].all()
    else:
        assert (tx == int(C.BPSK)).all()


def test_simplex_run_takes_a_generator_or_draws_not_both():
    cfg = config.make_tx_config(None, frame_length=4)
    run, tables = simplex.build_simplex(cfg, "cpu", noise_fwd=0.02, noise_rev=0.05)
    state = simplex.initial_simplex_state(cfg, tables, "cpu")
    gen = torch.Generator().manual_seed(1)
    state2, telem = run(state, 3, generator=gen)
    assert telem["tx_cnst"].shape == (3,) and int(state2.frame_no) == 3
    assert telem["burst_ok"].all() and telem["crc_ok"].all()
    with pytest.raises(ValueError):
        run(state, 3)
    with pytest.raises(ValueError):
        run(state, 3, generator=gen, draws={})
    with pytest.raises(ValueError):  # a draw of the wrong shape
        run(state, 3, draws={k: torch.zeros((2, *s), dtype=d) for k, (s, d) in run.draw_shapes.items()})


# ---------------------------------------------------------------------------
# full duplex
# ---------------------------------------------------------------------------

def _duplex_draws(key, shapes, with_pad):
    rounds = []
    for k in jax.random.split(key, ROUNDS):
        sends = []
        for ks in jax.random.split(k):  # ka: the A->B send, kb: the B->A send
            kp, kpad, kn = jax.random.split(ks, 3)
            d = {"payload": _bytes(kp, shapes["payload"][0][1:]),
                 "noise": _unit_normal(kn, shapes["noise"][0][1:])}
            if with_pad:
                d["pad"] = _bytes(kpad, shapes["pad"][0][1:])
            sends.append(d)
        rounds.append({k2: np.stack([s[k2] for s in sends]) for k2 in sends[0]})
    return _stack(rounds)


def _run_both_duplex(ref_cfg, noise_ab, noise_ba, ref_fec_tables=None, seed=0):
    cfg = config.config_from_reference(ref_cfg)
    fec = None if ref_fec_tables is None else fec_chain.fec_from_reference(ref_fec_tables, "cpu")
    run_r, tables_r = ref_duplex.build_full_duplex(ref_cfg, noise_ab=noise_ab, noise_ba=noise_ba,
                                                   fec=ref_fec_tables)
    run, tables = full_duplex.build_full_duplex(cfg, "cpu", noise_ab=noise_ab, noise_ba=noise_ba,
                                                fec=fec)
    tables_r["decision_th"] = tables["decision_th"] = 2
    state_r = ref_duplex.initial_duplex_state(ref_cfg, tables_r)
    state = full_duplex.duplex_state_from_reference(_np(state_r), "cpu")
    _tree_equal(state, state_r)
    _tree_equal(full_duplex.initial_duplex_state(cfg, tables, "cpu"), state_r)
    key = jax.random.PRNGKey(seed)
    draws = _duplex_draws(key, run.draw_shapes, with_pad=fec is None)
    state_r, telem_r = run_r(state_r, key, n_rounds=ROUNDS)
    state, telem = run(state, ROUNDS, draws=draws)
    _compare_telemetry(telem, telem_r)
    _tree_equal(state, state_r)
    return telem


def test_full_duplex_run_matches_reference():
    """A->B clean, B->A noisy: A's TX climbs through B's echo, B's stays."""
    ref_cfg = ref_config.make_full_duplex_config(None, frame_length=6)
    telem = _run_both_duplex(ref_cfg, noise_ab=0.009, noise_ba=0.6)
    a_tx, b_tx = telem["a_tx_cnst"].numpy(), telem["b_tx_cnst"].numpy()
    assert a_tx[0] == int(C.BPSK) and a_tx[-1] > int(C.BPSK), a_tx
    assert (b_tx == int(C.BPSK)).all(), b_tx
    assert telem["b_crc_ok"][-2:].all()
    assert (telem["a_tx_fec"] == 0).all() and (telem["b_tx_fec"] == 0).all()


def test_fec_full_duplex_run_matches_reference():
    """The LDPC transport-block path with a two-code ladder: the echo
    switches the peer's constellation AND its code; capacity comes from
    ``user_bytes_tab2[tx_fec, bps]``."""
    Hs = [ref_alist.load_alist(str(EXAMPLES / f))
          for f in ("n_0100_k_0027.alist", "n_0300_k_0152.alist")]
    ref_cfg = ref_config.make_full_duplex_config(
        None, frame_length=10, fec=True,
        fec_codes=(("fec_1", "examples/n_0100_k_0027.alist"),
                   ("fec_2", "examples/n_0300_k_0152.alist")),
        mcs=((1e-308, (C.BPSK, "fec_1")), (11.0, (C.QPSK, "fec_2")),
             (16.0, (C.PSK8, "fec_2")), (21.0, (C.QAM16, "fec_2"))))
    telem = _run_both_duplex(ref_cfg, noise_ab=0.02, noise_ba=0.35,
                             ref_fec_tables=ref_fec.build_fec(ref_cfg, Hs), seed=1)
    a_tx, a_fec = telem["a_tx_cnst"].numpy(), telem["a_tx_fec"].numpy()
    assert a_tx[0] == int(C.BPSK) and a_fec[0] == 1
    assert a_tx[-1] > int(C.BPSK) and a_fec[-1] == 2, (a_tx, a_fec)
    assert (telem["b_tx_cnst"] == int(C.BPSK)).all() and (telem["b_tx_fec"] == 1).all()
    assert telem["b_crc_ok"][-2:].all()


# ---------------------------------------------------------------------------
# the burst sessions
# ---------------------------------------------------------------------------

def test_stream_burst_rx_matches_reference_over_blocks():
    """Two bursts inside block 0, one straddling the boundary to block 1, a
    noise-only block 2, a small CFO over the capture: block by block the same
    slots, and every burst found once."""
    N = 2048
    ref_modem = ref_burst.build_burst_modem()
    modem = burst.burst_modem_from_reference(ref_modem, "cpu")
    L = ref_burst.burst_wave_len(ref_modem)
    rng = np.random.RandomState(0)

    def wave(c, f):
        return np.asarray(ref_burst.burst_tx(jnp.asarray([c], jnp.int32), jnp.asarray([f], jnp.int32),
                                             ref_modem, pad=0))[0]

    blocks = np.zeros((3, N), np.complex64)
    blocks[0, 100: 100 + L] += wave(2, 1)
    blocks[0, 1000: 1000 + L] += wave(3, 0)
    straddle, cut = wave(4, 2), 60
    blocks[0, N - cut:] += straddle[:cut]
    blocks[1, : L - cut] += straddle[cut:]
    noisy = blocks + (rng.randn(3, N) + 1j * rng.randn(3, N)).astype(np.complex64) * 0.05
    noisy = (noisy * np.exp(1j * 0.001 * np.arange(3 * N).reshape(3, N))).astype(np.complex64)

    rx_r = ref_session.StreamBurstRx(N, ref_modem)
    rx = session.StreamBurstRx(N, "cpu", modem)
    assert rx.tail_len == rx_r.tail_len and rx.modem is modem
    found = []
    for b in range(3):
        want, got = rx_r.process(noisy[b]), rx.process(noisy[b])
        for k in ("cnst_id", "fec_id", "ok", "peak_pos"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                          err_msg=f"block {b} {k}")
        ok = got.ok.numpy()
        np.testing.assert_allclose(got.cfo.numpy()[ok], np.asarray(want.cfo)[ok], rtol=0, atol=1e-6)
        found += [(int(got.cnst_id[i]), int(got.fec_id[i])) for i in np.nonzero(ok)[0]]
    assert sorted(found) == [(2, 1), (3, 0), (4, 2)]
    with pytest.raises(ValueError):
        rx.process(noisy[0][:-1])


class _InjectedPadTx(session.StreamTx):
    """StreamTx whose pad bytes are handed in, one block's at a time."""

    next_pad = None

    def _draw_pad(self):
        return torch.tensor(self.next_pad)


def _simplex_channels(seed):
    """The forward and reverse channels of tests/test_stream_burst.py: 30 dB
    forward; reverse blocks blacked out half the time, with a CFO and AWGN."""
    rng = np.random.RandomState(seed)
    drops = []

    def chan_fwd(s):
        s = np.asarray(s)
        nv = np.sqrt((float(np.mean(np.abs(s) ** 2)) or 1.0) / 10 ** 3.0)
        return s + (rng.randn(*s.shape) + 1j * rng.randn(*s.shape)) * nv / np.sqrt(2)

    def chan_rev(s):
        drop = rng.rand() < 0.5
        drops.append(drop)
        out = np.zeros_like(s) if drop else np.asarray(s).copy()
        out = out * np.exp(1j * 0.0015 * np.arange(len(out)))
        return out + (rng.randn(*out.shape) + 1j * rng.randn(*out.shape)).astype(np.complex64) * 0.02

    return chan_fwd, chan_rev, drops


def test_stream_simplex_matches_reference_step_by_step():
    """The same channels (numpy, one seed each side) and the same burst
    jitter (numpy, the session's seed): every step both sides want, apply
    and count the same, the TX climbs, and it never moves on a step whose
    burst was lost.  The reference's pad bytes reach the port's StreamTx
    through its frame bytes of that block."""
    kw = dict(frame_length=6)
    F, steps = 4, 12
    ref_tx = ref_config.make_tx_config(None, max_empty_frames=-1, **kw)
    ref_rx = ref_config.make_rx_config(None, **kw)
    fwd_r, rev_r, drops_r = _simplex_channels(7)
    fwd, rev, drops = _simplex_channels(7)
    spx_r = ref_session.StreamSimplex(ref_tx, ref_rx, fwd_r, rev_r, frames_per_block=F,
                                      rev_block=2048, seed=5)
    spx = session.StreamSimplex(config.config_from_reference(ref_tx),
                                config.config_from_reference(ref_rx), fwd, rev, "cpu",
                                frames_per_block=F, rev_block=2048, seed=5)
    spx.tx = _InjectedPadTx(spx.tx.cfg, "cpu", frames_per_block=F)
    blocks = []
    next_block_r = spx_r.tx.next_block
    spx_r.tx.next_block = lambda: blocks.append(next_block_r()) or blocks[-1]
    for s in (spx_r, spx):
        s.tx.send(b"\x55" * 64)
    history = []
    for step in range(steps):
        want = spx_r.step()
        spx.tx.next_pad = np.asarray(blocks[-1][1]["frame_bytes"])
        got = spx.step()
        for k in ("want", "applied", "n_bursts"):
            assert got[k] == want[k], (step, k, got[k], want[k])
        np.testing.assert_array_equal(got["ok"], np.asarray(want["ok"]))
        ok = got["ok"]
        for k in ("frame_no", "cnst_id", "crc_ok", "payload_len"):
            np.testing.assert_array_equal(getattr(got["rx"], k).numpy()[ok],
                                          np.asarray(getattr(want["rx"], k))[ok], err_msg=f"{step} {k}")
        assert spx.tx.constellation == spx_r.tx.constellation
        history.append((got["want"], got["applied"], spx.tx.constellation))
    assert drops == drops_r and any(drops) and not all(drops)
    assert spx.tx.constellation > int(C.BPSK), history
    applied = [h[1] for h in history]
    assert any(a is None for a in applied) and any(a is not None for a in applied)
    cnsts = [int(C.BPSK)] + [h[2] for h in history]
    assert all(h[1] is not None for i, h in enumerate(history) if cnsts[i + 1] != cnsts[i])
