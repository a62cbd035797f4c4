"""The receive path's recorder (``utils/trace``) on the CPU: nothing
recorded and bit-equal outputs with it off and on, the span tree of an
uncoded and a coded 16-frame step, the FEC counters against the
decoder's own counts, no CUDA event while a capture is reported, and the
helpers (self time, another clock)."""

import math

import numpy as np
import pytest
import torch

from gr_dtl_tpu_torch.models import fec_chain, receiver, transmitter
from gr_dtl_tpu_torch.ops import channel, ldpc
from gr_dtl_tpu_torch.tools.bench_fec import coded_build, qpsk_frames
from gr_dtl_tpu_torch.utils import config as cfgmod
from gr_dtl_tpu_torch.utils import trace

CPU = torch.device("cpu")
B, FRAME_LENGTH = 16, 20
SNR_DB = {"uncoded": 30.0, "coded": 11.0}  # 11 dB: BP takes updates on most codewords
MODES = tuple(SNR_DB)

TOP = ("rx.detect", "rx.demodulate", "rx.equalize", "rx.demap")
CHILDREN = {
    "rx.detect": {"rx.detect.metric"},
    "rx.demodulate": set(),
    "rx.equalize": {"rx.equalize.k2", "rx.equalize.header", "rx.equalize.reestimate"},
    "rx.demap.uncoded": {"rx.demap.decide", "rx.demap.repack", "rx.demap.crc"},
    "rx.demap.coded": {"rx.demap.llrs", "fec.decode"},
    "fec.decode": {"fec.decode.codewords", "fec.decode.bp", "fec.decode.reassemble"},
}


@pytest.fixture(autouse=True)
def _recorder_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def steps():
    """{mode: step()} of a 16-frame receive step, each over its own stream."""
    out = {}
    for mode, snr in SNR_DB.items():
        if mode == "coded":
            _, rxcfg, _, txp, rxp = coded_build(CPU, FRAME_LENGTH)
        else:
            rxcfg = cfgmod.make_rx_config(None, frame_length=FRAME_LENGTH)
            txp = transmitter.build_tx(cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH), CPU)
            rxp = receiver.build_rx(rxcfg, CPU)
        gen = torch.Generator().manual_seed(7)
        clean = qpsk_frames(txp, B, np.random.RandomState(3), gen).reshape(-1)
        v = math.sqrt(float(clean.abs().pow(2).mean()) / 10 ** (snr / 10))
        stream = channel.awgn(torch.cat([clean, torch.zeros(512, dtype=clean.dtype)]), v, generator=gen)

        def step(stream=stream, rxcfg=rxcfg, rxp=rxp):
            with trace.span("rx.step"):
                frames, _ = receiver.detect_and_extract(stream, rxcfg, B)
                return receiver.rx_frames(rxp, frames)

        out[mode] = step
    return out


def _spans_of(step):
    trace.enable(device_events=True)  # no card here: host times stand in
    out = step()
    trace.disable()
    return out, trace.export()


@pytest.mark.parametrize("mode", MODES)
def test_off_records_nothing_and_on_changes_no_output(steps, mode):
    off = steps[mode]()
    assert trace.export() == {"spans": [], "counters": {}}
    on, rec = _spans_of(steps[mode])
    assert rec["spans"]
    for name, a, b in zip(off._fields, off, on):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert int(off.crc_ok.sum()) >= B - 2  # 11 dB: a frame can fail, as in the coded cell


@pytest.mark.parametrize("mode", MODES)
def test_span_tree(steps, mode):
    _, rec = _spans_of(steps[mode])
    spans = rec["spans"]
    by_id = {s.id: s for s in spans}
    root = spans[0]
    assert root.name == "rx.step" and root.parent is None and root.depth == 0
    assert {s.step for s in spans} == {root.step}
    assert [s.name for s in spans if s.parent == root.id] == list(TOP)
    kids = {}
    for s in spans[1:]:
        up = by_id[s.parent]
        assert s.depth == up.depth + 1
        assert up.host_start_ns <= s.host_start_ns <= s.host_end_ns <= up.host_end_ns, (s, up)
        kids.setdefault(up.name, set()).add(s.name)
    want = {k: v for k, v in CHILDREN.items() if v and not k.startswith("rx.demap.")}
    want.update({"rx.step": set(TOP), "rx.demap": CHILDREN[f"rx.demap.{mode}"]})
    if mode == "uncoded":
        del want["fec.decode"]
    assert kids == want
    names = [s.name for s in spans]
    assert names.count("rx.equalize.k2") == 4 and names.count("rx.equalize.reestimate") == 1
    # every span's time is its host time here, and self time is what its children leave
    summ = trace.summary(spans)
    for s in spans:
        assert s.device_ms is None
        assert trace.span_ms(s) == pytest.approx((s.host_end_ns - s.host_start_ns) * 1e-6)
    for name, o in summ.items():
        mine = [s for s in spans if s.name == name]
        covered = sum(trace.span_ms(k) for s in mine for k in spans if k.parent == s.id)
        assert o["n"] == len(mine)
        assert o["self_ms"] == pytest.approx(o["ms"] - covered, abs=1e-9)
        assert 0 <= o["self_ms"] <= o["ms"]


def test_counters_are_the_decoders_own_sums(steps, monkeypatch):
    seen = {}
    codewords, decode_mm = fec_chain._codewords, ldpc.decode_mm

    def codewords_spy(*args):
        out = seen["cw"] = codewords(*args)
        return out

    def decode_spy(*args, **kwargs):
        out = seen["bp"] = decode_mm(*args, **kwargs)
        return out

    monkeypatch.setattr(fec_chain, "_codewords", codewords_spy)
    monkeypatch.setattr(ldpc, "decode_mm", decode_spy)
    _, rec = _spans_of(steps["coded"])
    cw, s = seen["cw"][:2]
    iters = seen["bp"][1].reshape(s.real.shape)
    want = {"fec.codeword_slots": cw.shape[0] * cw.shape[1], "fec.codewords": int(s.real.sum()),
            "fec.bp_updates": int(iters[s.real].sum())}
    assert rec["counters"] == want
    assert want["fec.codeword_slots"] == 13 * B and want["fec.codewords"] == 7 * B  # QPSK
    assert want["fec.bp_updates"] > 0
    # a second step adds to the counts; reset drops them
    _spans_of(steps["coded"])
    assert trace.export()["counters"] == {k: 2 * v for k, v in want.items()}
    trace.reset()
    assert trace.export() == {"spans": [], "counters": {}}


class _Event:
    """torch.cuda.Event's timing, on the host clock."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1

    def record(self, stream):
        assert stream == {"stream_id": 7, "device_index": 0, "device_type": 1}

    def elapsed_time(self, other):
        return 2.5


@pytest.mark.parametrize("capturing", [False, True])
def test_no_event_while_a_capture_is_reported(monkeypatch, capturing):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentStream", lambda device: (7, device, 1), raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch.cuda, "Stream", lambda **kw: kw)
    monkeypatch.setattr(trace, "_streams", {})
    monkeypatch.setattr(trace, "_pool", [])
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    _Event.made = 0
    trace.enable(device_events=True)
    for _ in range(2):  # the second time round, the events dropped by reset are recorded again
        with trace.span("outer"):
            with trace.span("inner"):
                trace.count("n", 3)
        rec = trace.export()
        trace.reset()
        assert [s.name for s in rec["spans"]] == ["outer", "inner"]
        if capturing:
            assert _Event.made == 0 and rec["counters"] == {}
            assert all(s.device_ms is None for s in rec["spans"])
        else:
            assert _Event.made == 4 and rec["counters"] == {"n": 3}
            assert all(s.device_ms == 2.5 for s in rec["spans"])


def test_off_a_span_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a clock was read")

    monkeypatch.setattr(trace.time, "perf_counter_ns", no_clock)
    assert trace.span("rx.step") is trace._NULL
    with trace.span("rx.step"):
        trace.count("n", 1)
    assert trace.spanned("f")(lambda x: x + 1)(1) == 2
    assert trace.export() == {"spans": [], "counters": {}}


def test_roots_start_steps_and_disable_keeps_what_was_recorded():
    trace.enable()
    for _ in range(2):
        with trace.span("a"):
            with trace.span("b"):
                pass
    trace.disable()
    with trace.span("c"):
        pass
    spans = trace.export()["spans"]
    assert [(s.name, s.depth) for s in spans] == [("a", 0), ("b", 1), ("a", 0), ("b", 1)]
    assert spans[0].step == spans[1].step != spans[2].step == spans[3].step
    assert spans[1].parent == spans[0].id and spans[3].parent == spans[2].id


def test_summary_and_another_clock():
    S = trace.Span
    spans = [S(0, "a", None, 0, 0, 1_000, 11_000, 4.0), S(1, "b", 0, 0, 1, 2_000, 4_000, 1.0),
             S(2, "b", 0, 0, 1, 5_000, 6_000, None), S(3, "a", None, 1, 0, 20_000, 21_000, 0.5)]
    assert trace.summary(spans) == {"a": {"n": 2, "ms": 4.5, "self_ms": pytest.approx(4.5 - 1.0 - 0.001)},
                                    "b": {"n": 2, "ms": pytest.approx(1.001), "self_ms": pytest.approx(1.001)}}
    placed = trace.on_clock(spans, 1_000, 500.0)
    assert [(s.id, a, b) for s, a, b in placed] == [(0, 500.0, 510.0), (1, 501.0, 503.0), (2, 504.0, 505.0),
                                                    (3, 519.0, 520.0)]
