"""The plain reference modem against what its frozen transmitter sent,
and its CRCs against the bitwise golden model."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from modem_bench import generator
from modem_bench.catalog import Catalog
from modem_bench.reference import bits, modem

CPU = torch.device("cpu")
cat = Catalog()


def test_crc_tables_match_the_bitwise_crc():
    rng = np.random.RandomState(3)
    msgs = rng.randint(0, 256, size=(6, 40)).astype(np.uint8)
    lens = np.array([0, 1, 5, 17, 39, 40])
    for spec in (bits.CRC32_FRAME, bits.CRC16_HEADER):
        t = bits.crc_tables(spec, 40, CPU)
        m = np.where(np.arange(40)[None, :] < lens[:, None], msgs, 0)
        got = bits.crc_device(torch.as_tensor(m), torch.as_tensor(lens), t).tolist()
        assert got == [bits.crc_host(m[i, :lens[i]].tobytes(), spec) for i in range(6)]


@pytest.mark.parametrize("cell", ["uncoded.loopback-b32k", "fec.qpsk-11db-b32k"])
@pytest.mark.parametrize("channel", [{"noise_voltage": 0.0}, {"noise_voltage": 0.02}])
def test_reference_receives_what_was_sent(cell, channel):
    c = cat.cell(cell)
    m = cat.system(c.system).modem(c, CPU)
    mix = {"frames_per_step": 24, "constellations": [1, 2, 3, 4], **channel}
    s = cat.kind("uniform_awgn").make(mix, m, 2**31 + 7, CPU)[0]
    frames, eps = modem.detect(s.samples, m.num, 24)
    out = modem.rx_frames(m, frames)
    assert bool(out.crc_ok.all()) and bool(out.header_ok.all())
    assert torch.equal(out.cnst_id, s.cnst) and torch.equal(out.payload_len, s.payload_len)
    assert torch.equal(out.payload[:, :s.payload.shape[1]], s.payload)
    assert torch.equal(out.frame_no, torch.arange(24, dtype=torch.int32))
    # no CFO was applied: what the estimate reads is the noise and, at the plateau's ends, the
    # neighbouring symbols' samples (up to ~7e-4 of a carrier without noise)
    assert float(eps.abs().max()) < 5e-3
    assert int(out.carr_offset.abs().max()) == 0


@pytest.mark.parametrize("cell", ["uncoded.loopback-b32k", "fec.qpsk-11db-b32k"])
def test_same_seed_same_streams_other_seed_other_streams(cell):
    c = cat.cell(cell)
    m = cat.system(c.system).modem(c, CPU)
    mix = {**c.traffic, "frames_per_step": 8}
    a, b, d = (cat.kind(c.traffic["kind"]).make(mix, m, s, CPU) for s in (5, 5, 6))
    assert len(a) == generator.RING
    assert all(torch.equal(x.samples, y.samples) for x, y in zip(a, b))
    assert not torch.equal(a[0].samples, d[0].samples) and not torch.equal(a[0].samples, a[1].samples)
    assert a[0].samples.shape == (8 * m.num.frame_samples + generator.TAIL_SAMPLES,)


def test_snr_calibrated_noise_sits_at_its_snr():
    c = cat.cell("fec.qpsk-11db-b32k")
    m = cat.system(c.system).modem(c, CPU)
    mix = {**c.traffic, "frames_per_step": 32}
    noisy = cat.kind("snr_calibrated").make(mix, m, 11, CPU)[0].samples
    clean = cat.kind("uniform_awgn").make({**mix, "noise_voltage": 0.0}, m, 11, CPU)[0].samples
    n = noisy.shape[0] - generator.TAIL_SAMPLES
    snr = 10 * torch.log10((clean[:n].abs() ** 2).mean() / ((noisy - clean).abs() ** 2).mean())
    assert abs(float(snr) - mix["snr_db"]) < 0.1
