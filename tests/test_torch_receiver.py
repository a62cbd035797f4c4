"""The slice end to end, port against the JAX package: uncoded TX -> CFO +
AWGN -> detect_and_extract -> rx_frames, at small sizes with mixed
constellations 1..4.  Both sides get the same numpy-drawn payloads, pad
and noise (the reference draws its pad from jax.random, so the port is
handed the reference's own frame bytes, whose bytes beyond L+4 are
that pad).

Bytes, ints and bools must be equal.  Float tolerances, all float32 on
both sides with different rounding in XLA and PyTorch (complex divide,
sin/cos/exp, sum order), carried through the whole chain:
 - TX samples atol 1e-5 (values ~0.1-0.5 after a 64-point IDFT);
 - fine CFO atol 1e-5 (angle of a 17-term sum);
 - soft symbols atol 1e-4: the CFO de-rotation (phase ramps up to
   ~100 rad at float32) and two equalizer passes compound the ulps;
 - noise variance rtol 1e-3 and SNR atol 5e-3 dB: sums of a few hundred
   squared pilot errors of order 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import receiver as ref_rx
from gr_dtl_tpu.models import transmitter as ref_tx
from gr_dtl_tpu.ops import constellation as ref_cn
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch.models import receiver, transmitter
from gr_dtl_tpu_torch.ops import channel
from gr_dtl_tpu_torch.utils import config

NOISE_V = 0.02
INT_FIELDS = ("payload", "payload_len", "crc_ok", "header_ok", "frame_no", "cnst_id",
              "feedback_cnst", "fec_echo", "carr_offset", "fec_ok", "avg_iters")


@pytest.mark.parametrize("frame_length,B,cfo", [(4, 8, 0.0), (10, 16, 0.11)])
def test_slice_matches_reference(frame_length, B, cfo):
    rng = np.random.RandomState(frame_length)
    ref_tcfg = ref_config.make_tx_config(None, frame_length=frame_length)
    ref_rcfg = ref_config.make_rx_config(None, frame_length=frame_length)
    tcfg = config.make_tx_config(None, frame_length=frame_length)
    rcfg = config.make_rx_config(None, frame_length=frame_length)

    cnst = rng.permutation(np.tile(np.arange(1, 5, dtype=np.int32), B // 4))
    maxb = tcfg.max_frame_bytes()
    plen = np.array([tcfg.frame_bytes(int(ref_cn.BITS_PER_SYMBOL[c])) - 4 - rng.randint(0, 3)
                     for c in cnst], np.int32)
    payload = rng.randint(0, 256, (B, maxb)).astype(np.uint8)
    payload[np.arange(maxb)[None, :] >= plen[:, None]] = 0
    feedback = rng.randint(0, 5, B).astype(np.int32)
    frame_no = ((np.arange(B) + 4090) % 4096).astype(np.int32)

    # ---- TX ----
    # the reference side runs jitted on the CPU: one compile per stage
    # instead of one per eager op
    ref_txp = ref_tx.build_tx(ref_tcfg)
    ref_out = jax.jit(lambda *a: ref_tx.tx_frames(ref_txp, *a))(
        jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst), jnp.asarray(feedback),
        jnp.asarray(frame_no), jax.random.PRNGKey(frame_length))
    pad = np.array(ref_out.frame_bytes)
    out = transmitter.tx_frames(transmitter.build_tx(tcfg, "cpu"), torch.as_tensor(payload),
                                torch.as_tensor(plen), torch.as_tensor(cnst),
                                torch.as_tensor(feedback), torch.as_tensor(frame_no),
                                torch.as_tensor(pad))
    np.testing.assert_array_equal(out.frame_bytes.numpy(), np.asarray(ref_out.frame_bytes))
    np.testing.assert_array_equal(out.l_total.numpy(), np.asarray(ref_out.l_total))
    np.testing.assert_allclose(out.samples.numpy(), np.asarray(ref_out.samples), atol=1e-5)

    # ---- channel: unknown offset, CFO, AWGN from one numpy draw ----
    lead = 200 + 7 * frame_length

    def stream_of(samples):
        s = np.concatenate([np.zeros(lead, np.complex64), samples.reshape(-1),
                            np.zeros(2048, np.complex64)])
        return (s * np.exp(2j * np.pi * cfo * np.arange(len(s)) / 64)).astype(np.complex64)

    n = stream_of(np.asarray(ref_out.samples)).shape[0]
    noise = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    s = channel.awgn(torch.as_tensor(stream_of(out.samples.numpy())), NOISE_V,
                     noise=torch.as_tensor(noise))
    std = np.float32(NOISE_V / np.sqrt(2.0))
    ref_s = stream_of(np.asarray(ref_out.samples)) + (std * noise).astype(np.complex64)

    # ---- RX ----
    ref_rxp = ref_rx.build_rx(ref_rcfg)
    frames_r, eps_r = jax.jit(lambda x: ref_rx.detect_and_extract(x, ref_rcfg, B))(jnp.asarray(ref_s))
    want = jax.jit(lambda f: ref_rx.rx_frames(ref_rxp, f))(frames_r)
    frames, eps = receiver.detect_and_extract(s, rcfg, B)
    got = receiver.rx_frames(receiver.build_rx(rcfg, "cpu"), frames)

    np.testing.assert_allclose(eps.numpy(), np.asarray(eps_r), atol=1e-5)
    for name in INT_FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got.soft_syms.numpy(), np.asarray(want.soft_syms), atol=1e-4)
    np.testing.assert_allclose(got.noise_var.numpy(), np.asarray(want.noise_var), rtol=1e-3)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(want.snr_db), atol=5e-3)

    # and the link itself works
    assert got.crc_ok.all()
    np.testing.assert_array_equal(got.payload.numpy(), payload)
    np.testing.assert_array_equal(got.cnst_id.numpy(), cnst)
    np.testing.assert_array_equal(got.frame_no.numpy(), frame_no)
