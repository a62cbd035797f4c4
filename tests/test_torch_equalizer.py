"""Equalizer parity: the port's ``equalize_frame`` against the JAX
package's, on both branches (the decision-directed symbol loop and the
frozen-taps shortcut, which the reference takes from alpha >= 0.9995 on).

Decisions must be equal.  Soft symbols and taps agree within atol 1e-5:
both run float32, but complex division and the EMA update round
differently in XLA and PyTorch, a few ulps per symbol on values of order
1, carried through at most 20 symbol steps.  The noise variance agrees
within rtol 1e-4 and the SNR within 1e-3 dB: both are sums of ~100
squared pilot errors of order 1e-3, where those ulps are relative
errors of ~1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.ops import constellation as ref_cn
from gr_dtl_tpu.ops import equalizer as ref_eq
from gr_dtl_tpu.ops import ofdm as ref_ofdm
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.ops import equalizer
from gr_dtl_tpu_torch.utils import config

ATOL = 1e-5
FL = 8  # payload symbols


def _frame_spectra(rng, B, cnst, FL=FL):
    """Received data-symbol spectra [B, 1 + FL, 64] (header + payload)
    through a per-frame smooth channel with a slow per-symbol phase drift,
    plus the channel itself as the initial taps (with an estimation error)."""
    cfg = ref_config.make_rx_config(None, frame_length=FL)
    alloc = ref_ofdm.build_allocator(cfg)
    hbits = rng.randint(0, 2, (B, 1, 48))
    hdr = np.asarray(ref_cn.map_symbols(jnp.asarray(hbits), jnp.ones((B, 1, 1), jnp.int32)))
    sym = rng.randint(0, 16, (B, FL * 48)) % (1 << ref_cn.BITS_PER_SYMBOL[cnst])[:, None]
    pay = np.asarray(ref_cn.map_symbols(jnp.asarray(sym), jnp.asarray(cnst)[:, None])).reshape(B, FL, 48)
    grid = np.asarray(ref_ofdm.allocate_carriers(jnp.asarray(np.concatenate([hdr, pay], 1)), alloc))[:, 2:]
    k = np.arange(64) - 32
    H = (rng.uniform(0.7, 1.3, (B, 1)) * np.exp(1j * (rng.uniform(-3, 3, (B, 1))
                                                     + 2 * np.pi * k[None, :] * rng.uniform(0, 0.2, (B, 1)) / 8)))
    drift = np.exp(1j * 0.01 * np.arange(1 + FL))[None, :, None]
    noise = 0.03 * (rng.randn(*grid.shape) + 1j * rng.randn(*grid.shape))
    spectra = (grid * H[:, None, :] * drift + noise).astype(np.complex64)
    active = np.zeros(64, bool)
    active[np.array(list(cfg.occupied_carriers) + list(cfg.pilot_carriers)) + 32] = True
    taps0 = np.where(active, H * (1 + 0.02 * rng.randn(B, 64)), 1.0).astype(np.complex64)
    return spectra, taps0


@pytest.mark.parametrize("alpha", [0.8, 0.95, 0.9995, 1.0])
def test_equalize_frame_matches_reference(alpha):
    rng = np.random.RandomState(int(alpha * 1e4))
    B = 12
    cnst = np.tile(np.arange(1, 5, dtype=np.int32), B // 4)
    spectra, taps0 = _frame_spectra(rng, B, cnst)
    ref_cfg = ref_config.make_rx_config(None, frame_length=FL, eq_alpha=alpha)
    ref_tab = ref_eq.build_equalizer(ref_cfg)
    tab = equalizer.build_equalizer(config.make_rx_config(None, frame_length=FL, eq_alpha=alpha), "cpu")
    occ = np.nonzero(ref_tab["occ_mask"])[0]
    pil = ref_tab["pilot_mask"]

    # the header pass (one BPSK symbol), then the payload pass from its taps
    for sl, off, cid in ((slice(0, 1), 0, np.ones(B, np.int32)), (slice(1, None), 1, cnst)):
        # jitted: one compile instead of one per eager op of the scan
        want = jax.jit(lambda y, h, c: ref_eq.equalize_frame(y, h, c, ref_tab, sym_offset=off))(
            jnp.asarray(spectra[:, sl]), jnp.asarray(taps0), jnp.asarray(cid))
        got = equalizer.equalize_frame(torch.as_tensor(spectra[:, sl]), torch.as_tensor(taps0),
                                       torch.as_tensor(cid), tab, sym_offset=off)
        w_hard, g_hard = np.asarray(want.hard), got.hard.numpy()
        sym_cid = np.where(off + np.arange(w_hard.shape[1]) < 1, 1, cid[:, None])[:, :, None]
        np.testing.assert_array_equal(
            cn.hard_decision(torch.as_tensor(g_hard[:, :, occ]), torch.as_tensor(sym_cid)).numpy(),
            np.asarray(ref_cn.hard_decision(jnp.asarray(w_hard[:, :, occ]), jnp.asarray(sym_cid))))
        np.testing.assert_array_equal(g_hard[:, :, pil], w_hard[:, :, pil])  # known pilots
        np.testing.assert_allclose(g_hard, w_hard, atol=ATOL)
        np.testing.assert_allclose(got.soft.numpy(), np.asarray(want.soft), atol=ATOL)
        np.testing.assert_allclose(got.taps.numpy(), np.asarray(want.taps), atol=ATOL)
        np.testing.assert_allclose(got.noise_var.numpy(), np.asarray(want.noise_var), rtol=1e-4)
        np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(want.snr_db), atol=1e-3)
        assert got.snr_db.dtype == got.noise_var.dtype == torch.float32
    if alpha >= 0.9995:  # the frozen branch keeps its input taps
        assert torch.equal(got.taps, torch.as_tensor(taps0))


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("alpha", [0.8, 0.95, 0.9995, 1.0])
def test_equalize_frame_at_the_receiver_shapes_matches_reference(alpha, B):
    """The shapes the receive step hands the equalizer: one frame (a link
    round) or a batch, 20 payload symbols, the header and the payload as
    strided slices of the frame's [B, 2 + 1 + 20, 64] spectra (the payload
    at ``sym_offset = header_symbols``, from the header pass's taps), mixed
    constellations 1..4."""
    fl, n_sync = 20, 2
    rng = np.random.RandomState(int(alpha * 1e4) + B)
    cnst = (np.arange(B, dtype=np.int32) + (3 if B == 1 else 0)) % 4 + 1
    data, taps0 = _frame_spectra(rng, B, cnst, FL=fl)
    sync = (rng.randn(B, n_sync, 64) + 1j * rng.randn(B, n_sync, 64)).astype(np.complex64)
    frame = torch.as_tensor(np.concatenate([sync, data], axis=1))  # [B, 23, 64]
    ref_tab = ref_eq.build_equalizer(ref_config.make_rx_config(None, frame_length=fl, eq_alpha=alpha))
    tab = equalizer.build_equalizer(config.make_rx_config(None, frame_length=fl, eq_alpha=alpha), "cpu")
    hs = tab.header_syms
    assert hs == 1 and frame.shape[1] == n_sync + hs + fl

    taps, ref_taps = torch.as_tensor(taps0), jnp.asarray(taps0)
    for sl, off, cid in ((slice(n_sync, n_sync + hs), 0, np.ones(B, np.int32)),
                         (slice(n_sync + hs, None), hs, cnst)):
        view = frame[:, sl]
        assert view.shape[1] in (1, fl) and (B == 1 or not view.is_contiguous())
        want = jax.jit(lambda y, h, c: ref_eq.equalize_frame(y, h, c, ref_tab, sym_offset=off))(
            jnp.asarray(view.numpy()), ref_taps, jnp.asarray(cid))
        got = equalizer.equalize_frame(view, taps, torch.as_tensor(cid), tab, sym_offset=off)
        assert got.hard.shape == got.soft.shape == (B, view.shape[1], 64)
        occ = np.nonzero(ref_tab["occ_mask"])[0]
        sym_cid = np.where(off + np.arange(view.shape[1]) < hs, 1, cid[:, None])[:, :, None]
        np.testing.assert_array_equal(
            cn.hard_decision(got.hard[:, :, occ], torch.as_tensor(sym_cid)).numpy(),
            np.asarray(ref_cn.hard_decision(want.hard[:, :, occ], jnp.asarray(sym_cid))))
        np.testing.assert_allclose(got.hard.numpy(), np.asarray(want.hard), atol=ATOL)
        np.testing.assert_allclose(got.soft.numpy(), np.asarray(want.soft), atol=ATOL)
        np.testing.assert_allclose(got.taps.numpy(), np.asarray(want.taps), atol=ATOL)
        np.testing.assert_allclose(got.noise_var.numpy(), np.asarray(want.noise_var), rtol=1e-4)
        np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(want.snr_db), atol=1e-3)
        # the payload pass starts from the header pass's taps, each side from its own
        taps, ref_taps = got.taps, want.taps
