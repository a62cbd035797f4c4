"""The coded slice end to end, port against the JAX package: coded TX ->
CFO + AWGN -> detect_and_extract -> rx_frames (soft LLRs, LLR
serialisation, header-gated TB length, BP, CRC32), at frame_length 10
and B=8 with mixed constellations 1..4, for one code and for the
two-code bank (per-frame code announced in the header), and the
``defer_fec`` output; and 16QAM at frame_length 20 and 25 dB, on draws
where both packages lose the same frames.  Both sides get the same
numpy-drawn payloads and noise; the reference runs under jax.jit on the
CPU.

Bytes, bits, ints, bools and ``avg_iters`` (a ratio of integer BP
iteration counts) must be equal.  Float tolerances are the bars of
tests/test_torch_receiver.py (TX samples atol 1e-5, soft symbols atol
1e-4, noise variance rtol 1e-3, SNR atol 5e-3 dB), and for the deferred
frame LLRs (soft symbols over the noise variance) rtol 2e-3 + atol 2e-2:
the noise variance's rtol 1e-3 plus the soft symbols' 1e-4 scaled by
the LLR slope 4a/sigma^2 (up to ~1e2 at these noise variances).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import fec_chain as ref_fec
from gr_dtl_tpu.models import receiver as ref_rx
from gr_dtl_tpu.models import transmitter as ref_tx
from gr_dtl_tpu.ops import constellation as ref_cn
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch.models import fec_chain, receiver, transmitter
from gr_dtl_tpu_torch.ops import channel
from gr_dtl_tpu_torch.utils import alist, config
from test_torch_host_constants import _assert_same

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
# at 16 dB BP iterates on several frames of these draws and every frame decodes
FRAME_LENGTH, B, CFO, SNR_DB, SEED = 10, 8, 0.05, 16.0, 2
INT_FIELDS = ("payload", "payload_len", "crc_ok", "header_ok", "frame_no", "cnst_id",
              "feedback_cnst", "fec_echo", "carr_offset", "fec_ok", "avg_iters")
CODES = {"single": ["n_0300_k_0152.alist"],
         "bank": ["n_0100_k_0027.alist", "n_0300_k_0152.alist"]}


def _compare_rxout(got, want):
    for name in INT_FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got.soft_syms.numpy(), np.asarray(want.soft_syms), atol=1e-4)
    np.testing.assert_allclose(got.noise_var.numpy(), np.asarray(want.noise_var), rtol=1e-3)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(want.snr_db), atol=5e-3)


@pytest.mark.parametrize("codes", list(CODES))
def test_coded_slice_matches_reference(codes):
    rng = np.random.RandomState(SEED + len(codes))
    Hs = [alist.load_alist(str(EXAMPLES / n)) for n in CODES[codes]]
    H = Hs if len(Hs) > 1 else Hs[0]
    ref_tcfg = ref_config.make_tx_config(None, frame_length=FRAME_LENGTH, fec=True)
    ref_rcfg = ref_config.make_rx_config(None, frame_length=FRAME_LENGTH, fec=True)
    tcfg = config.make_tx_config(None, frame_length=FRAME_LENGTH, fec=True)
    rcfg = config.make_rx_config(None, frame_length=FRAME_LENGTH, fec=True)
    ref_f = ref_fec.build_fec(ref_tcfg, H)
    fec = fec_chain.build_fec(tcfg, H, "cpu")

    cnst = rng.permutation(np.tile(np.arange(1, 5, dtype=np.int32), B // 4))
    fec_id = rng.randint(1, len(Hs) + 1, B).astype(np.int32) if len(Hs) > 1 else None
    ub = ref_f["user_bytes_tab2"][1 if fec_id is None else fec_id,
                                  ref_cn.BITS_PER_SYMBOL[cnst]].astype(np.int32)
    ub[1] = ub[1] // 2  # a partially filled frame: the header carries its length
    payload = np.zeros((B, ref_f["max_payload_bytes"]), np.uint8)
    for i in range(B):
        payload[i, : ub[i]] = rng.randint(0, 256, ub[i])
    feedback = rng.randint(0, 5, B).astype(np.int32)
    fec_fb = rng.randint(0, 3, B).astype(np.int32)
    frame_no = ((np.arange(B) + 4092) % 4096).astype(np.int32)

    # ---- TX ----
    ref_txp = ref_tx.build_tx(ref_tcfg, ref_f)
    ref_out = jax.jit(lambda p, l, c, fb, n, ffb, fid: ref_tx.tx_frames(
        ref_txp, p, l, c, fb, n, jax.random.PRNGKey(0), fec_feedback=ffb, fec_id=fid))(
        jnp.asarray(payload), jnp.asarray(ub), jnp.asarray(cnst), jnp.asarray(feedback),
        jnp.asarray(frame_no), jnp.asarray(fec_fb), None if fec_id is None else jnp.asarray(fec_id))
    out = transmitter.tx_frames(
        transmitter.build_tx(tcfg, "cpu", fec), torch.as_tensor(payload), torch.as_tensor(ub),
        torch.as_tensor(cnst), torch.as_tensor(feedback), torch.as_tensor(frame_no), None,
        fec_feedback=torch.as_tensor(fec_fb),
        fec_id=None if fec_id is None else torch.as_tensor(fec_id))
    np.testing.assert_array_equal(out.frame_bytes.numpy(), np.asarray(ref_out.frame_bytes))
    np.testing.assert_array_equal(out.l_total.numpy(), np.asarray(ref_out.l_total))
    np.testing.assert_allclose(out.samples.numpy(), np.asarray(ref_out.samples), atol=1e-5)

    # ---- channel: unknown offset, CFO, AWGN at SNR_DB from one numpy draw ----
    lead = 300

    def stream_of(samples):
        s = np.concatenate([np.zeros(lead, np.complex64), samples.reshape(-1),
                            np.zeros(2048, np.complex64)])
        return (s * np.exp(2j * np.pi * CFO * np.arange(len(s)) / 64)).astype(np.complex64)

    sig = float(np.mean(np.abs(np.asarray(ref_out.samples)) ** 2))
    noise_v = float(np.sqrt(sig / 10 ** (SNR_DB / 10)))
    n = stream_of(np.asarray(ref_out.samples)).shape[0]
    noise = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    s = channel.awgn(torch.as_tensor(stream_of(out.samples.numpy())), noise_v,
                     noise=torch.as_tensor(noise))
    std = np.float32(noise_v / np.sqrt(2.0))
    ref_s = jnp.asarray(stream_of(np.asarray(ref_out.samples)) + (std * noise).astype(np.complex64))

    # ---- RX ----
    ref_rxp = ref_rx.build_rx(ref_rcfg, ref_f)
    frames_r, _ = jax.jit(lambda x: ref_rx.detect_and_extract(x, ref_rcfg, B))(ref_s)
    rxp = receiver.build_rx(rcfg, "cpu", fec)
    frames, _ = receiver.detect_and_extract(s, rcfg, B)
    want = jax.jit(lambda f: ref_rx.rx_frames(ref_rxp, f))(frames_r)
    got = receiver.rx_frames(rxp, frames)
    _compare_rxout(got, want)
    assert got.payload.shape == (B, fec.max_payload_bytes)
    # the link works, and BP really iterated at this SNR
    assert got.crc_ok.all() and float(got.avg_iters.max()) > 0
    np.testing.assert_array_equal(got.payload.numpy(), payload)
    np.testing.assert_array_equal(got.payload_len.numpy(), ub)
    np.testing.assert_array_equal(got.fec_echo.numpy(), fec_fb)

    # ---- defer_fec: the per-frame decoder inputs ----
    want_d, want_in = jax.jit(lambda f: ref_rx.rx_frames(ref_rxp, f, defer_fec=True))(frames_r)
    got_d, got_in = receiver.rx_frames(rxp, frames, defer_fec=True)
    _compare_rxout(got_d, want_d)
    assert got_in.keys() == want_in.keys()
    for k in ("tb_no", "tb_offset", "tb_payload", "fec_id"):
        np.testing.assert_array_equal(got_in[k].numpy(), np.asarray(want_in[k]), err_msg=k)
    np.testing.assert_allclose(got_in["llrs"].numpy(), np.asarray(want_in["llrs"]),
                               rtol=2e-3, atol=2e-2)
    # and the deferred inputs decode to the same frames
    dec = fec_chain.fec_frame_decode(fec, got_in["llrs"], got_d.cnst_id, got_in["tb_payload"],
                                     fec_id=got_in["fec_id"] if fec.n_codes > 1 else None)
    np.testing.assert_array_equal(dec.payload.numpy(), got.payload.numpy())


@pytest.fixture(scope="module")
def qam16_link():
    """examples/config_fec.json at frame_length 20, n=300 k=152: 8 coded
    16QAM frames filled to capacity from the port's TX, the reference's
    jitted RX and the port's RX, and the noise voltage of 25 dB of the
    measured TX power."""
    cfg_path = str(EXAMPLES / "config_fec.json")
    H = alist.load_alist(str(EXAMPLES / "n_0300_k_0152.alist"))
    ref_rcfg = ref_config.make_rx_config(cfg_path, frame_length=20)
    ref_f = ref_fec.build_fec(ref_config.make_tx_config(cfg_path, frame_length=20), H)
    ref_rxp = ref_rx.build_rx(ref_rcfg, ref_f)
    tcfg = config.make_tx_config(cfg_path, frame_length=20)
    fec = fec_chain.build_fec(tcfg, H, "cpu")
    rxp = receiver.build_rx(config.make_rx_config(cfg_path, frame_length=20), "cpu", fec)
    n = 8
    rng = np.random.RandomState(0)
    ub = np.full(n, fec.user_bytes_tab2[1, 4], np.int32)
    payload = np.zeros((n, fec.max_payload_bytes), np.uint8)
    for i in range(n):
        payload[i, : ub[i]] = rng.randint(0, 256, ub[i])
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    out = transmitter.tx_frames(transmitter.build_tx(tcfg, "cpu", fec), torch.as_tensor(payload),
                                i32(ub), i32(np.full(n, 4)), i32(np.zeros(n)), i32(np.arange(n)),
                                None)
    samples = out.samples.reshape(-1).numpy()
    noise_v = float(np.sqrt(np.mean(np.abs(samples) ** 2) / 10 ** (25.0 / 10)))
    ref_step = jax.jit(lambda x: ref_rx.rx_frames(ref_rxp, ref_rx.detect_and_extract(x, ref_rcfg, n)[0]))
    return (np.concatenate([samples, np.zeros(2048, np.complex64)]), noise_v, payload, n,
            ref_step, rxp)


@pytest.mark.parametrize("seed", [3, 51, 156])
def test_coded_16qam_losses_at_25db_match_reference(qam16_link, seed):
    """At 25 dB of the measured TX power both packages lose the same coded
    16QAM frames: the header passes, BP does not converge.  Over 600 such
    draws of 8 frames the port lost 45 of 4,800 frames (CPU runs); these
    three draws lose one or two each, and the reference loses the same
    ones with the same BP iterations.  Every field but the payload must
    be equal; the payload only on the frames that decode: a lost frame's
    bytes are the hard bits of a codeword that ran 15 updates without
    converging, where float32 rounding may flip a bit."""
    s0, noise_v, payload, n, ref_step, rxp = qam16_link
    rng = np.random.RandomState(seed)
    noise = (rng.randn(s0.size) + 1j * rng.randn(s0.size)).astype(np.complex64)
    x = (s0 + np.float32(noise_v / np.sqrt(2.0)) * noise).astype(np.complex64)
    want = ref_step(jnp.asarray(x))
    got = receiver.rx_frames(rxp, receiver.detect_and_extract(torch.as_tensor(x), rxp.cfg, n)[0])
    lost = ~got.crc_ok.numpy()
    _compare_rxout(got._replace(payload=got.payload[~lost]),
                   want._replace(payload=np.asarray(want.payload)[~lost]))
    assert 1 <= lost.sum() <= 2 and got.header_ok.all() and not got.fec_ok.numpy()[lost].any()
    np.testing.assert_array_equal(got.payload.numpy()[~lost], payload[~lost])


def test_build_rx_tx_params_from_reference_with_fec():
    """The reference's coded build_rx/build_tx dicts carry their fec tables
    across, equal to the port's own builders."""
    H = alist.load_alist(str(EXAMPLES / "n_0100_k_0027.alist"))
    ref_rcfg = ref_config.make_rx_config(None, frame_length=FRAME_LENGTH, fec=True)
    ref_tcfg = ref_config.make_tx_config(None, frame_length=FRAME_LENGTH, fec=True)
    ref_f = ref_fec.build_fec(ref_tcfg, H)
    np_leaves = lambda d: {k: (np.asarray(v) if hasattr(v, "__array__") else v)
                           for k, v in d.items()}
    d = dict(ref_rx.build_rx(ref_rcfg, ref_f))
    for k in ("alloc", "ce", "eq", "eq2"):
        d[k] = np_leaves(d[k])
    fec = fec_chain.build_fec(config.make_tx_config(None, frame_length=FRAME_LENGTH, fec=True),
                              H, "cpu")
    own = receiver.build_rx(config.make_rx_config(None, frame_length=FRAME_LENGTH, fec=True),
                            "cpu", fec)
    _assert_same(receiver.rx_params_from_reference(d, "cpu"), own)
    t = dict(ref_tx.build_tx(ref_tcfg, ref_f))
    t["alloc"] = np_leaves(t["alloc"])
    _assert_same(transmitter.tx_params_from_reference(t, "cpu"),
                 transmitter.build_tx(config.make_tx_config(None, frame_length=FRAME_LENGTH,
                                                            fec=True), "cpu", fec))
