"""The readers of the program's own spans and counters (``spans.py``): a
traced CPU run reports every new metric when the spans' host times stand
in for the device's, nothing from a program without the recorder, the
idle gaps named by the span that covers them, and (on a card) a host
hold of 1 ms named as its gap."""

from __future__ import annotations

import json
import sys
import time

import pytest
import torch

from conftest import CELLS, tiny_catalog
from modem_bench import run, spans, timing

CPU = torch.device("cpu")
SPAN_ROOFLINES = {f"{s}_span_roofline" for s in ("detect", "demodulate", "equalize", "demap")}
CODED = {"fec_span_roofline", "bp_updates_per_codeword", "fec_slot_use_pct"}


@pytest.fixture
def host_as_device(monkeypatch):
    monkeypatch.setattr(spans, "HOST_AS_DEVICE", True)
    monkeypatch.setattr(spans, "PLAIN_MS", 50.0)
    monkeypatch.setattr(spans, "ENQUEUE_STEPS", 4)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_every_span_metric(tmp_path, cell, host_as_device, capsys):
    cat = tiny_catalog(tmp_path)
    res = run.run(cat.cell(f"tiny.{cell}"), 2**31 + 99, 0.2, True, CPU, cat)
    assert res["correct"], res["checks"]
    coded = cell.startswith("fec")
    stages = {"detect", "demodulate", "equalize", "demap"} | ({"fec"} if coded else set())
    want = {f"{s}_roofline" for s in stages} | SPAN_ROOFLINES | {"host_enqueue_ms"} | (CODED if coded else set())
    got = res["metrics"]
    assert set(got) == want
    assert all(v["value"] > 0 for v in got.values())
    line = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("modem_bench: spans ")]
    assert len(line) == 1
    log = json.loads(line[0].split(": ", 2)[2])
    assert {"span_step_gap", "span_ms_per_step", "host_ms_per_step", "counters", "top_spans_ms"} <= set(log)
    assert log["top_spans_ms"] == pytest.approx(log["span_step_ms"], rel=0.02)  # medians over the same steps
    if coded:
        # QPSK: 7 real codewords in a frame's 13 slots; on the CPU the program's BP is the reference's
        assert got["fec_slot_use_pct"]["value"] == pytest.approx(100 * 7 / 13)
        assert got["bp_updates_per_codeword"]["value"] == log["ref_bp_updates_per_codeword"]


def test_nothing_is_read_from_a_program_without_the_recorder(tmp_path, host_as_device, monkeypatch):
    import gr_dtl_tpu_torch.utils as utils

    # an import of the recorder fails, as in a checkout that has none; the program keeps its own binding
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "gr_dtl_tpu_torch.utils.trace", None)
    cat = tiny_catalog(tmp_path)
    res = run.run(cat.cell(f"tiny.{CELLS[1]}"), 4, 0.2, True, CPU, cat)
    assert set(res["metrics"]) == {f"{s}_roofline" for s in ("detect", "demodulate", "equalize", "demap", "fec")}


def _span(i, name, depth, t0, t1):
    from gr_dtl_tpu_torch.utils import trace

    return trace.Span(i, name, None, 0, depth, t0, t1, None)


def test_idle_gaps_are_named_by_the_span_that_covers_them():
    tr = timing.Trace(device_ops=[("a", 10.0, 20.0), ("b", 30.0, 40.0), ("c", 100.0, 110.0)],
                      start_us=10.0, steps=1)
    # host ns 0 reads 0 us: rx.step covers both gaps, its child rx.equalize.k2 most of the first
    placed = [_span(0, "rx.step", 0, 0, 60_000), _span(1, "rx.equalize", 1, 15_000, 45_000),
              _span(2, "rx.equalize.k2", 2, 16_000, 28_000)]
    r = spans.attribute(tr, 0.0, 0, placed)
    assert r["idle_gaps"] == [["outside | b -> c", pytest.approx(60e-6)],
                              ["rx.equalize.k2 | a -> b", pytest.approx(10e-6)]]
    assert r["idle_by_span"] == [["outside", pytest.approx(60e-6)], ["rx.equalize.k2", pytest.approx(10e-6)]]
    assert r["idle_by_step"] == [pytest.approx(10e-6), pytest.approx(60e-6)]
    assert r["idle_by_span_after_first"] == []
    # a second step covering the second gap
    r = spans.attribute(tr, 0.0, 0, placed + [_span(3, "rx.step", 0, 60_000, 130_000)])
    assert r["idle_by_step"] == [pytest.approx(10e-6), pytest.approx(60e-6), 0.0]
    assert r["idle_by_span_after_first"] == [["rx.step", pytest.approx(60e-6)]]
    # the anchor shifts the host clock: 9 us later rx.equalize.k2 covers half of the first gap
    r = spans.attribute(tr, 9.0, 0, placed)
    assert r["idle_gaps"][1][0] == "rx.equalize | a -> b"
    assert spans.covering([], 0.0, 1.0) is None


@pytest.mark.cuda
def test_a_host_hold_names_its_gap(card):
    from gr_dtl_tpu_torch.utils import trace

    x = torch.ones(1 << 16, device=card)

    def step():
        x.mul_(1.0)
        with trace.span("hold"):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 1e-3:
                pass
        x.add_(0.0)

    got = spans.profiled(step, 1, trace)
    assert got is not None
    r = spans.attribute(*got)
    held = [v for name, v in r["idle_gaps"] if name.startswith("hold | ")]
    assert len(held) == 1 and 0.9e-3 <= held[0] <= 1.1e-3, r
    assert all(name.split(" | ")[0] in ("hold", spans.OUTSIDE) for name, _ in r["idle_gaps"])
