"""PyTorch port vs the JAX package, module by module: constellation, ofdm,
gf2/header/repack/scramble/framing and chanest.  The same numpy inputs go
through both.  Bytes, ints and bools must be equal; floats agree within
atol 1e-5 (both sides compute in float32, but XLA and PyTorch sum,
divide and take sin/cos/exp in different orders and implementations, a
few ulps on values of order 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import framing as ref_framing
from gr_dtl_tpu.ops import chanest as ref_ce
from gr_dtl_tpu.ops import constellation as ref_cn
from gr_dtl_tpu.ops import gf2 as ref_gf2
from gr_dtl_tpu.ops import header as ref_header
from gr_dtl_tpu.ops import ofdm as ref_ofdm
from gr_dtl_tpu.ops import repack as ref_repack
from gr_dtl_tpu.ops import scramble as ref_scramble
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch.models import framing
from gr_dtl_tpu_torch.ops import chanest, gf2, header, ofdm, repack, scramble
from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.utils import config

ATOL = 1e-5  # float32 on both sides; see the module docstring


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cplx(rng, *shape, scale=1.0):
    return (scale * (rng.randn(*shape) + 1j * rng.randn(*shape))).astype(np.complex64)


# ---------------------------------------------------------------- constellation

def test_map_symbols_mixed_batch():
    rng = np.random.RandomState(0)
    B, n = 12, 96
    cid = rng.randint(1, 5, B).astype(np.int32)
    sym = (rng.randint(0, 1 << 16, (B, n)) % (1 << ref_cn.BITS_PER_SYMBOL[cid])[:, None]).astype(np.int32)
    want = ref_cn.map_symbols(jnp.asarray(sym), jnp.asarray(cid)[:, None])
    got = cn.map_symbols(torch.as_tensor(sym), torch.as_tensor(cid)[:, None])
    np.testing.assert_array_equal(_np(got), np.asarray(want))  # table lookups: exact


@pytest.mark.parametrize("noise", [0.05, 1.0])
def test_nearest_point_closed_form(noise):
    rng = np.random.RandomState(1)
    B, n = 16, 128
    cid = np.tile(np.arange(1, 5, dtype=np.int32), B // 4)
    sym = (rng.randint(0, 16, (B, n)) % (1 << ref_cn.BITS_PER_SYMBOL[cid])[:, None]).astype(np.int32)
    y = np.asarray(ref_cn.map_symbols(jnp.asarray(sym), jnp.asarray(cid)[:, None])) + _cplx(rng, B, n, scale=noise)
    want_idx, want_pt = ref_cn.nearest_point(jnp.asarray(y), jnp.asarray(cid)[:, None])
    got_idx, got_pt = cn.nearest_point(torch.as_tensor(y), torch.as_tensor(cid)[:, None])
    assert got_idx.dtype == torch.int32
    np.testing.assert_array_equal(_np(got_idx), np.asarray(want_idx))
    np.testing.assert_allclose(_np(got_pt), np.asarray(want_pt), atol=ATOL)
    # the closed form agrees with the table argmin of both packages
    t_idx, t_pt = cn.nearest_point_table(torch.as_tensor(y), torch.as_tensor(cid)[:, None])
    r_idx, _ = ref_cn.nearest_point_table(jnp.asarray(y), jnp.asarray(cid)[:, None])
    np.testing.assert_array_equal(_np(t_idx), np.asarray(r_idx))
    np.testing.assert_array_equal(_np(t_idx), _np(got_idx))
    np.testing.assert_allclose(_np(t_pt), _np(got_pt), atol=ATOL)


def test_psk8_negative_sector_wraps_like_python_modulo():
    # angles just below 0 and near -pi round to negative sectors; `% 8`
    # must wrap them to 7 and 4 (Python/jnp semantics, not C's)
    ang = np.array([-0.3, -np.pi / 4, -3.0, -np.pi + 0.01, np.pi - 0.01, 0.2])
    y = np.exp(1j * ang).astype(np.complex64)[None, :]
    cid = np.array([3], np.int32)
    want = ref_cn.hard_decision(jnp.asarray(y), jnp.asarray(cid)[:, None])
    got = cn.hard_decision(torch.as_tensor(y), torch.as_tensor(cid)[:, None])
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    pos = torch.round(torch.as_tensor(ang, dtype=torch.float32) * (4.0 / np.pi)).int() % 8
    assert pos.tolist() == [0, 7, 4, 4, 4, 0]


def test_hard_decision_header_shape():
    rng = np.random.RandomState(2)
    y = _cplx(rng, 6, 1, 48)
    bpsk = np.ones(6, np.int32)
    want = ref_cn.hard_decision(jnp.asarray(y), jnp.asarray(bpsk)[:, None, None])
    got = cn.hard_decision(torch.as_tensor(y), torch.as_tensor(bpsk)[:, None, None])
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------- ofdm

def test_dft_matrix_and_transforms():
    rng = np.random.RandomState(3)
    for inv in (True, False):
        np.testing.assert_array_equal(ofdm.dft_matrix(64, inv), ref_ofdm.dft_matrix(64, inv))
    x = _cplx(rng, 5, 23, 64)
    np.testing.assert_allclose(_np(ofdm.ofdm_modulate(torch.as_tensor(x))),
                               np.asarray(ref_ofdm.ofdm_modulate(jnp.asarray(x))), atol=ATOL)
    np.testing.assert_allclose(_np(ofdm.ofdm_demodulate(torch.as_tensor(x))),
                               np.asarray(ref_ofdm.ofdm_demodulate(jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("frame_length", [4, 20])
def test_allocate_carriers_and_cyclic_prefix(frame_length):
    rng = np.random.RandomState(4)
    cfg = config.make_tx_config(None, frame_length=frame_length)
    ref_alloc = ref_ofdm.build_allocator(ref_config.make_tx_config(None, frame_length=frame_length))
    alloc = ofdm.build_allocator(cfg, "cpu")
    data = _cplx(rng, 3, cfg.header_symbols + frame_length, cfg.n_data_carriers)
    grid = ofdm.allocate_carriers(torch.as_tensor(data), alloc)
    want = ref_ofdm.allocate_carriers(jnp.asarray(data), ref_alloc)
    np.testing.assert_array_equal(_np(grid), np.asarray(want))  # placement only: exact
    np.testing.assert_array_equal(_np(ofdm.add_cyclic_prefix(grid, 16)),
                                  np.asarray(ref_ofdm.add_cyclic_prefix(want, 16)))


@pytest.mark.parametrize("frame_length", [4, 20])
def test_extract_carriers_and_remove_cyclic_prefix(frame_length):
    """The inverses: carriers taken back out of a grid (sync symbols removed)
    and the prefix dropped, as the reference's (exact: placement only)."""
    rng = np.random.RandomState(5)
    cfg = config.make_tx_config(None, frame_length=frame_length)
    ref_alloc = ref_ofdm.build_allocator(ref_config.make_tx_config(None, frame_length=frame_length))
    alloc = ofdm.build_allocator(cfg, "cpu")
    data = _cplx(rng, 3, cfg.header_symbols + frame_length, cfg.n_data_carriers)
    grid = ofdm.allocate_carriers(torch.as_tensor(data), alloc)[:, cfg.n_sync_symbols:]
    got = ofdm.extract_carriers(grid, alloc)
    np.testing.assert_array_equal(_np(got), np.asarray(ref_ofdm.extract_carriers(jnp.asarray(_np(grid)), ref_alloc)))
    np.testing.assert_array_equal(_np(got), data)
    with_cp = _cplx(rng, 2, 5, 80)
    got = ofdm.remove_cyclic_prefix(torch.as_tensor(with_cp), 64, 16)
    np.testing.assert_array_equal(_np(got), np.asarray(ref_ofdm.remove_cyclic_prefix(jnp.asarray(with_cp), 64, 16)))
    time_syms = _cplx(rng, 2, 5, 64)
    np.testing.assert_array_equal(
        _np(ofdm.remove_cyclic_prefix(ofdm.add_cyclic_prefix(torch.as_tensor(time_syms), 16), 64, 16)), time_syms)


# ---------------------------------------------------------------- byte layer

@pytest.mark.parametrize("spec_name,max_len", [("CRC32_FRAME", 480), ("CRC16_HEADER", 10)])
def test_crc_device(spec_name, max_len):
    rng = np.random.RandomState(5)
    B = 24
    lengths = rng.randint(0, max_len + 1, B).astype(np.int32)
    lengths[:2] = (0, max_len)
    msg = rng.randint(0, 256, (B, max_len)).astype(np.uint8)
    msg[np.arange(max_len)[None, :] >= lengths[:, None]] = 0
    want = ref_gf2.crc_device(jnp.asarray(msg), jnp.asarray(lengths),
                              ref_gf2.make_crc_tables(getattr(ref_gf2, spec_name), max_len))
    got = gf2.crc_device(torch.as_tensor(msg), torch.as_tensor(lengths),
                         gf2.crc_tables(getattr(gf2, spec_name), max_len, torch.device("cpu")))
    np.testing.assert_array_equal(_np(got), np.asarray(want).astype(np.int64))
    spec = getattr(gf2, spec_name)
    assert [gf2.crc_host(msg[i, : lengths[i]], spec) for i in range(B)] == _np(got).tolist()


@pytest.mark.parametrize("spec_name", ["CRC32_FRAME", "CRC16_HEADER", "CRC8_FEEDBACK"])
def test_crc_host_matches_reference(spec_name):
    rng = np.random.RandomState(8)
    spec, ref_spec = getattr(gf2, spec_name), getattr(ref_gf2, spec_name)
    for n in (0, 1, 7, 64, 301):
        msg = rng.randint(0, 256, n).astype(np.uint8)
        for data in (msg, msg.tobytes(), bytearray(msg.tobytes())):
            assert gf2.crc_host(data, spec) == ref_gf2.crc_host(data, ref_spec)
    assert gf2.crc_host(b"123456789", gf2.CRC32_FRAME) == 0xCBF43926  # the CRC-32 check value


def test_gf2_matmul_matches_reference():
    rng = np.random.RandomState(9)
    bits = rng.randint(0, 2, (6, 500)).astype(np.float32)
    mat = rng.randint(0, 2, (500, 32)).astype(np.float32)
    got = gf2.gf2_matmul(torch.as_tensor(bits), torch.as_tensor(mat))
    want = np.asarray(ref_gf2.gf2_matmul(jnp.asarray(bits), jnp.asarray(mat)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), (bits.astype(np.int64) @ mat.astype(np.int64)) % 2)


@pytest.mark.parametrize("has_fec", [False, True])
def test_header_format_and_parse(has_fec):
    rng = np.random.RandomState(6)
    B = 16
    vals = [rng.randint(0, 1 << 16, B).astype(np.int32) for _ in range(9)]
    want = np.asarray(ref_header.format_header(
        ref_header.HeaderFields(*map(jnp.asarray, vals)), has_fec))
    got = _np(header.format_header(header.HeaderFields(*map(torch.as_tensor, vals)), has_fec))
    np.testing.assert_array_equal(got, want)
    # flip one bit in half of the headers: the CRC must catch it in both
    bits = want.copy()
    flip = rng.randint(0, bits.shape[1], B // 2)
    bits[np.arange(B // 2), flip] ^= 1
    rf, rok = ref_header.parse_header(jnp.asarray(bits), has_fec)
    pf, pok = header.parse_header(torch.as_tensor(bits), has_fec)
    np.testing.assert_array_equal(_np(pok), np.asarray(rok))
    assert not _np(pok)[: B // 2].any() and _np(pok)[B // 2 :].all()
    for a, b in zip(pf, rf):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_repack_mixed_bps():
    rng = np.random.RandomState(7)
    B, n_sym, maxb = 12, 480, 240
    bps = np.tile(np.arange(1, 5, dtype=np.int32), B // 4)
    data = rng.randint(0, 256, (B, maxb)).astype(np.uint8)
    want = np.asarray(ref_repack.bytes_to_symbols(jnp.asarray(data), jnp.asarray(bps), n_sym))
    got = _np(repack.bytes_to_symbols(torch.as_tensor(data), torch.as_tensor(bps), n_sym))
    np.testing.assert_array_equal(got, want)
    back_ref = np.asarray(ref_repack.symbols_to_bytes(jnp.asarray(want), jnp.asarray(bps), maxb))
    back = _np(repack.symbols_to_bytes(torch.as_tensor(got), torch.as_tensor(bps), maxb))
    np.testing.assert_array_equal(back, back_ref)


def test_scramble_frames():
    rng = np.random.RandomState(8)
    frames = rng.randint(0, 256, (4, 480)).astype(np.uint8)
    for seed in (0x7F, 0):
        np.testing.assert_array_equal(
            _np(scramble.scramble_frames(torch.as_tensor(frames), seed)),
            np.asarray(ref_scramble.scramble_frames(jnp.asarray(frames), seed)))


def test_framing_build_and_verify():
    rng = np.random.RandomState(9)
    B, maxb = 10, 480
    plen = rng.randint(0, maxb - 3, B).astype(np.int32)
    payload = rng.randint(0, 256, (B, maxb)).astype(np.uint8)
    payload[np.arange(maxb)[None, :] >= plen[:, None]] = 0
    ref_tab = ref_gf2.make_crc_tables(ref_gf2.CRC32_FRAME, maxb)
    tab = gf2.crc_tables(gf2.CRC32_FRAME, maxb, torch.device("cpu"))
    want, want_l = ref_framing.build_frame_bytes(
        jnp.asarray(payload), jnp.asarray(plen), jax.random.PRNGKey(3), maxb, ref_tab)
    want = np.array(want)
    # the reference draws its pad from jax.random: hand the port the
    # reference's own frame, whose bytes beyond L+4 are that pad
    got, got_l = framing.build_frame_bytes(torch.as_tensor(payload), torch.as_tensor(plen),
                                           torch.as_tensor(want), maxb, tab)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(got_l), np.asarray(want_l))

    rx = want.copy()
    rx[0, 0] ^= 0x10  # payload byte error
    rx[1, plen[1]] ^= 0x01  # CRC byte error
    l_total = np.asarray(want_l).copy()
    l_total[2] = 2  # length field too short for a CRC
    r = ref_framing.verify_frame_bytes(jnp.asarray(rx), jnp.asarray(l_total), ref_tab)
    p = framing.verify_frame_bytes(torch.as_tensor(rx), torch.as_tensor(l_total), tab)
    for a, b in zip(p, r):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert _np(p[2]).tolist() == [False, False, False] + [True] * (B - 3)


# ---------------------------------------------------------------- chanest

def _sync_spectra(rng, B, offsets):
    """Received sync-symbol spectra [B, n_sym, 64] of reference TX frames
    under an integer carrier offset, a timing offset and noise."""
    cfg = ref_config.make_tx_config(None, frame_length=4)
    alloc = ref_ofdm.build_allocator(cfg)
    data = _cplx(rng, B, cfg.header_symbols + 4, 48) * 0.7
    grid = np.asarray(ref_ofdm.allocate_carriers(jnp.asarray(data), alloc))
    t = np.asarray(ref_ofdm.ofdm_modulate(jnp.asarray(grid)))  # [B, n_sym, 64]
    n = np.arange(cfg.frame_ofdm_symbols)[:, None] * 80 + 16 + np.arange(64)[None, :]
    t = t * np.exp(2j * np.pi * offsets[:, None, None] * n[None] / 64)
    t = np.roll(t, 2, axis=-1)  # timing offset: a linear phase per carrier
    y = np.asarray(ref_ofdm.ofdm_demodulate(jnp.asarray(t.astype(np.complex64))))
    return (y + _cplx(rng, *y.shape, scale=0.02)).astype(np.complex64)


def test_chanest_offset_shift_and_taps():
    rng = np.random.RandomState(10)
    offsets = np.array([0, 1, -1, 3, -4, 6, -6, 2], np.int32)
    y = _sync_spectra(rng, len(offsets), offsets)
    ref_tab = ref_ce.build_chanest(ref_config.make_rx_config(None, frame_length=4))
    ce = chanest.build_chanest(config.make_rx_config(None, frame_length=4), "cpu")
    yt = torch.as_tensor(y)

    want_off = np.asarray(ref_ce.estimate_carrier_offset(jnp.asarray(y[:, 0]), jnp.asarray(y[:, 1]), ref_tab))
    got_off = chanest.estimate_carrier_offset(yt[:, 0], yt[:, 1], ce)
    assert got_off.dtype == torch.int32
    np.testing.assert_array_equal(_np(got_off), want_off)
    np.testing.assert_array_equal(want_off, offsets)

    for first in (0, 2):
        want = np.asarray(ref_ce.apply_carrier_shift(jnp.asarray(y), jnp.asarray(want_off), ref_tab, first))
        got = _np(chanest.apply_carrier_shift(yt, got_off, ce, first))
        np.testing.assert_allclose(got, want, atol=ATOL)
        # the gather moves values exactly; only the phase ramp rounds
        np.testing.assert_array_equal(np.abs(got) == 0, np.abs(want) == 0)

    ys = np.array(ref_ce.apply_carrier_shift(jnp.asarray(y), jnp.asarray(want_off), ref_tab, 0))
    for denoise in (True, False):
        want = np.asarray(ref_ce.estimate_taps(jnp.asarray(ys[:, 0]), jnp.asarray(ys[:, 1]), ref_tab, denoise))
        got = _np(chanest.estimate_taps(torch.as_tensor(ys[:, 0]), torch.as_tensor(ys[:, 1]), ce, denoise))
        np.testing.assert_allclose(got, want, atol=ATOL)
    taps = _cplx(rng, 4, 64)
    np.testing.assert_allclose(_np(chanest.denoise_taps(torch.as_tensor(taps), ce)),
                               np.asarray(ref_ce.denoise_taps(jnp.asarray(taps), ref_tab)), atol=ATOL)
