"""The per-layer readers' byte and operation counts, held to the kernel
figures of PERF.md's kernel tables (counted there by the port's own
functions) and to the stage shapes they count."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from modem_bench.catalog import Catalog
from modem_bench.reference import config as refcfg
from modem_bench.reference.ldpc import build_code

cat = Catalog()


def _reader(name):
    return cat.metric(name)


def test_kernel_figures_of_the_tables():
    """K1 75,406,592 B at N = 3,770,368; K2's payload call 65,036,288 B at
    B = 2048; K3 32,015,360 B at 13,312 codewords of n = 300 (PERF.md §6)."""
    from gr_dtl_tpu_torch.ops import equalizer_cuda, ldpc_cuda, sync_cuda

    assert sync_cuda.metric_bytes(3_770_368) == 75_406_592
    assert equalizer_cuda.equalizer_bytes(2048, 20, 64) == 65_036_288
    assert ldpc_cuda.bp_bytes(13_312, 300) == 32_015_360


def test_detect_reads_the_stream_k1_reads():
    """The stage reads the stream once, as K1 does (its 8 B of K1's 20 B a
    sample), and writes the frames and the CFO."""
    num = refcfg.numerology(cat.cell("uncoded.loopback-b32k").config)
    B, tail = 2048, 2048
    n = B * num.frame_samples + tail
    assert n == 3_770_368
    from gr_dtl_tpu_torch.ops import sync_cuda

    k1_read = sync_cuda.metric_bytes(n) - 12 * (n - 64)
    assert _reader("detect_roofline").stage_bytes(num, B, tail) == k1_read + 8 * B * num.frame_samples + 4 * B


def test_equalize_ops_are_k2s_over_every_call():
    from gr_dtl_tpu_torch.tools import bench_equalizer

    for cell in ("uncoded.loopback-b32k", "fec.qpsk-11db-b32k"):
        num = refcfg.numerology(cat.cell(cell).config)
        B = 32768
        calls = [(num.header_symbols, B), (num.frame_length, B)] * num.eq_passes
        k2 = sum(bench_equalizer.OPS_PER_CARRIER * b * s * 64 for s, b in calls)
        assert _reader("equalize_roofline").stage_ops(num, B) == k2
        # K2's payload call reads [B, 20, 64] spectra: the stage reads every symbol of the frame
        assert _reader("equalize_roofline").stage_bytes(num, B) > 8 * 64 * B * (num.frame_length + 1)


def test_demodulate_counts():
    num = refcfg.numerology(cat.cell("uncoded.loopback-b32k").config)
    r = _reader("demodulate_roofline")
    assert r.stage_ops(num, 1) == 5 * 64 * 6 * 23
    assert r.stage_bytes(num, 1) == 2 * 8 * 23 * 64 + 8 * 64 + 4


@pytest.mark.parametrize("seed", [0, 1])
def test_bp_ops_are_k3s(seed):
    """The FEC reader's BP count is ldpc_cuda.bp_ops on the same iteration counts."""
    from gr_dtl_tpu_torch.ops import ldpc, ldpc_cuda

    c = cat.cell("fec.qpsk-11db-b32k")
    H = cat.system(c.system).code(c)
    ours = build_code(H, "cpu")
    graph = ldpc.ldpc_from_reference(ldpc.build_ldpc(H), "cpu").graph
    assert (ours.n_edge, ours.N) == (graph.n_edge, graph.n_var)
    it = torch.as_tensor(np.random.RandomState(seed).randint(0, 16, size=(64, 13)))
    assert _reader("fec_roofline").bp_ops(it, ours) == ldpc_cuda.bp_ops(it.reshape(-1), graph)


def test_rooflines_read_nothing_without_spans():
    class Ctx:
        stage_ms, trace = {}, None

    for name in ("detect_roofline", "demodulate_roofline", "equalize_roofline", "demap_roofline",
                 "device_idle_pct", "launches_per_step"):
        assert _reader(name).read(Ctx) is None
    assert math.isclose(5 * 64 * math.log2(64), 1920)
