"""Host constants of the PyTorch port equal the JAX package's build functions, bit
for bit: config fields and derived sizes, sync words, constellation,
allocator, chanest, equalizer, CRC and scrambler tables, and the
converted ``build_rx``/``build_tx`` parameters."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import receiver as ref_rx
from gr_dtl_tpu.models import transmitter as ref_tx
from gr_dtl_tpu.ops import chanest as ref_ce
from gr_dtl_tpu.ops import constellation as ref_cn
from gr_dtl_tpu.ops import gf2 as ref_gf2
from gr_dtl_tpu.ops import scramble as ref_scramble
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch.models import receiver, transmitter
from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.ops import gf2, scramble
from gr_dtl_tpu_torch.utils import config

EXAMPLE = str(Path(__file__).resolve().parent.parent / "examples" / "config.json")


def _assert_same(a, b, path="params"):
    """Dataclasses field by field; tensors equal in dtype, shape and bits."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _assert_config_equal(port, ref):
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "mcs":
            got = [(s, (int(c), fec)) for s, (c, fec) in got]
            want = [(s, (int(c), fec)) for s, (c, fec) in want]
        assert got == want, f.name
    for prop in ("n_data_carriers", "n_pilot_carriers", "header_symbols", "n_sync_symbols",
                 "frame_ofdm_symbols", "symbol_len", "frame_samples",
                 "frame_capacity_symbols", "header_bits"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert [port.frame_bytes(k) for k in (1, 2, 3, 4)] == [ref.frame_bytes(k) for k in (1, 2, 3, 4)]
    assert port.max_frame_bytes() == ref.max_frame_bytes()
    assert [int(c) for c in port.mcs_constellations()] == [int(c) for c in ref.mcs_constellations()]
    assert port.mcs_snr_thresholds() == ref.mcs_snr_thresholds()
    np.testing.assert_array_equal(port.sync_word1(), ref.sync_word1())
    np.testing.assert_array_equal(port.sync_word2(), ref.sync_word2())


@pytest.mark.parametrize("src", [None, EXAMPLE])
@pytest.mark.parametrize("kind", ["rx", "tx"])
def test_config_fields_and_sizes(src, kind):
    make, ref_make = {"rx": (config.make_rx_config, ref_config.make_rx_config),
                      "tx": (config.make_tx_config, ref_config.make_tx_config)}[kind]
    for kw in ({}, {"frame_length": 7, "eq_passes": 1, "scramble_bits": True}):
        port, ref = make(src, **kw), ref_make(src, **kw)
        _assert_config_equal(port, ref)
        _assert_config_equal(config.config_from_reference(ref), ref)


def test_wire_compat_config_raises():
    with pytest.raises(NotImplementedError, match="W1"):
        config.make_rx_config(None, wire_compat="constants.json")


def test_constellation_tables():
    np.testing.assert_array_equal(cn.POINTS, ref_cn.POINTS)
    np.testing.assert_array_equal(cn.BITS_PER_SYMBOL, ref_cn.BITS_PER_SYMBOL)
    np.testing.assert_array_equal(cn.VALID_MASK, ref_cn.VALID_MASK)
    pts, bps, valid = cn.tables(torch.device("cpu"))
    np.testing.assert_array_equal(pts.numpy(), ref_cn.POINTS)
    np.testing.assert_array_equal(bps.numpy(), ref_cn.BITS_PER_SYMBOL)
    np.testing.assert_array_equal(valid.numpy(), ref_cn.VALID_MASK)


@pytest.mark.parametrize("spec_name,max_len", [("CRC32_FRAME", 480), ("CRC32_FRAME", 60),
                                               ("CRC16_HEADER", 4), ("CRC16_HEADER", 10)])
def test_crc_tables(spec_name, max_len):
    got = gf2.make_crc_tables(getattr(gf2, spec_name), max_len)
    want = ref_gf2.make_crc_tables(getattr(ref_gf2, spec_name), max_len)
    for k in ("D", "T", "init_term"):
        np.testing.assert_array_equal(got[k], want[k])
    assert dataclasses.astuple(got["spec"]) == dataclasses.astuple(want["spec"])
    conv = gf2.crc_tables_from_reference(want, "cpu")
    _assert_same(conv, gf2.crc_tables(getattr(gf2, spec_name), max_len, torch.device("cpu")))


def test_scrambler_sequence():
    for seed in (0x7F, 0x5A, 1):
        np.testing.assert_array_equal(scramble.lfsr_bytes(0x8A, seed, 7, 480),
                                      ref_scramble.lfsr_bytes(0x8A, seed, 7, 480))


def _numpy_leaves(d):
    return {k: (np.asarray(v) if hasattr(v, "__array__") else v) for k, v in d.items()}


@pytest.mark.parametrize("frame_length,src", [(4, None), (20, None), (10, EXAMPLE)])
def test_rx_params_match_reference(frame_length, src):
    ref_cfg = ref_config.make_rx_config(src, frame_length=frame_length)
    d = dict(ref_rx.build_rx(ref_cfg))
    for k in ("alloc", "ce", "eq", "eq2"):
        d[k] = _numpy_leaves(d[k])
    conv = receiver.rx_params_from_reference(d, "cpu")
    own = receiver.build_rx(config.make_rx_config(src, frame_length=frame_length), "cpu")
    _assert_same(conv, own)

    # and against the reference's arrays themselves
    np.testing.assert_array_equal(own.alloc.pilot_map.numpy(), d["alloc"]["pilot_map"])
    np.testing.assert_array_equal(own.alloc.occ_idx.numpy(), d["alloc"]["occ_idx"])
    np.testing.assert_array_equal(own.alloc.pilot_idx.numpy(), d["alloc"]["pilot_idx"])
    assert own.alloc.n_data_syms == d["alloc"]["n_data_syms"]
    for k in ("w1", "w2", "active", "active_idx", "proj"):
        np.testing.assert_array_equal(getattr(own.ce, k).numpy(), d["ce"][k])
    assert (own.ce.max_off, own.ce.fft_len, own.ce.cp_len) == (
        d["ce"]["max_off"], d["ce"]["fft_len"], d["ce"]["cp_len"])
    # the carrier-offset tables the reference builds inside
    # estimate_carrier_offset
    for w, step, tab in ((d["ce"]["w1"], 2, own.ce.W1), (d["ce"]["w2"], 1, own.ce.W2)):
        dw = w * np.conj(np.roll(w, -step))
        want = np.conj(np.stack([ref_ce._shifted_const(dw, -o) for o in range(-6, 7)]))
        np.testing.assert_array_equal(tab.numpy(), want)
    for k, eq in (("eq", own.eq), ("eq2", own.eq2)):
        np.testing.assert_array_equal(eq.occ_mask.numpy(), d[k]["occ_mask"])
        np.testing.assert_array_equal(eq.pilot_mask.numpy(), d[k]["pilot_mask"])
        np.testing.assert_array_equal(eq.pilot_vals.numpy(), d[k]["pilot_vals"])
        assert (eq.alpha, eq.header_syms) == (d[k]["alpha"], d[k]["header_syms"])


@pytest.mark.parametrize("frame_length", [4, 20])
def test_tx_params_match_reference(frame_length):
    ref_cfg = ref_config.make_tx_config(None, frame_length=frame_length)
    d = dict(ref_tx.build_tx(ref_cfg))
    d["alloc"] = _numpy_leaves(d["alloc"])
    conv = transmitter.tx_params_from_reference(d, "cpu")
    own = transmitter.build_tx(config.make_tx_config(None, frame_length=frame_length), "cpu")
    _assert_same(conv, own)


def test_fec_configs_raise():
    with pytest.raises(NotImplementedError, match="B3"):
        receiver.build_rx(config.make_rx_config(None, fec=True), "cpu")
    with pytest.raises(NotImplementedError, match="B3"):
        transmitter.build_tx(config.make_tx_config(None, fec=True), "cpu")
