"""The harness end to end on the CPU at a tiny B (the port's plain paths
stand in for its kernels), its files found by name, and the comparison's
verdict on runs whose timed path is broken underneath."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import CELLS, tiny_catalog
from modem_bench import generator, run, timing
from modem_bench.catalog import ROOT, Catalog

CPU = torch.device("cpu")
Program = Catalog().system("batch_rx").Program


def test_every_cell_metric_and_config_is_a_file_found_by_name():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    cat = Catalog()
    assert [w["name"] for w in bench["workloads"]] == list(CELLS)
    for w in bench["workloads"]:
        cell = cat.cell(w["name"])
        own = json.loads((ROOT / "workloads" / f"{w['name']}.json").read_text())
        assert {k: own[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert cell.config_dir.name == w["config"] and cell.traffic_name == w["traffic"]
        assert {c["name"] for c in bench["configs"]} >= {w["config"]}
        assert set(cell.limits) >= {"frames_rel_err", "soft_err_median", "soft_diverged", "snr_diverged",
                                    "payload_diff", "steps_crc_diff"}
        assert callable(cat.kind(cell.traffic["kind"]).make)
        assert callable(cat.system(cell.system).Program)
        for m in cell.per_layer:
            assert callable(cat.metric(m["name"]).read)
    for c in bench["configs"]:
        assert (ROOT.parent / c["file"]).is_file()
        assert c["file"] == f"modem_bench/configs/{c['name']}/config.json"


@pytest.mark.parametrize("cell", CELLS)
def test_a_new_cell_file_runs_without_an_edit(tmp_path, cell):
    """A cell written as new files is found and run; on the CPU the port's
    plain paths are the reference's arithmetic, so every number reads 0."""
    cat = tiny_catalog(tmp_path)
    res = run.run(cat.cell(f"tiny.{cell}"), 2**31 + 12345, 0.2, False, CPU, cat)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values()), res["checks"]
    assert res["failed"] == 0 and res["attempted"] == res["_log"]["steps"] * 16
    assert set(res["metrics"]) == {"rx_msamples_per_s", "step_ms.p95", "setup_s"}
    assert list(res)[-2:] == ["checks", "_log"]


QUIET_KIND = '''"""A kind written after the harness: the uniform draw without noise."""
from modem_bench import generator


def make(mix, m, seed, device):
    gen = generator.rng(seed, device)
    out = []
    for _ in range(generator.RING):
        clean, sent = generator.frames(mix, m, gen, device)
        out.append(sent._replace(samples=generator.awgn(clean, 0.0, gen)))
    return out
'''


def test_a_new_traffic_kind_file_runs_without_an_edit(tmp_path):
    """A mix of a kind that no file of the harness names, written as new
    files (the kind, the mix, the cell), is found and run."""
    cat = tiny_catalog(tmp_path)
    (tmp_path / "traffic" / "quiet.py").write_text(QUIET_KIND)
    mix = {"kind": "quiet", "frames_per_step": 16, "constellations": [3, 4]}
    (tmp_path / "traffic" / "quiet-b16.json").write_text(json.dumps(mix))
    w = json.loads((tmp_path / "workloads" / "tiny.uncoded.loopback-b32k.json").read_text())
    (tmp_path / "workloads" / "tiny.uncoded.quiet.json").write_text(json.dumps({**w, "traffic": "quiet-b16"}))
    cell = cat.cell("tiny.uncoded.quiet")
    streams = cat.kind("quiet").make(cell.traffic, cat.system("batch_rx").modem(cell, CPU), 3, CPU)
    assert len(streams) == generator.RING and set(streams[0].cnst.tolist()) <= {3, 4}
    res = run.run(cell, 3, 0.2, False, CPU, cat)
    assert res["correct"], res["checks"]
    assert res["_log"]["ref_crc_ok"] == [16, 16]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_stage_spans(tmp_path, cell):
    cat = tiny_catalog(tmp_path)
    res = run.run(cat.cell(f"tiny.{cell}"), 5, 0.2, True, CPU, cat)
    assert res["correct"]
    stages = {"detect", "demodulate", "equalize", "demap"} | ({"fec"} if cell.startswith("fec") else set())
    assert set(res["metrics"]) == {f"{s}_roofline" for s in stages}  # no trace of a device on the CPU
    assert all(0 < m["value"] for m in res["metrics"].values())


class Stale(Program):
    """Returns the first step's output for every later step."""

    first = None

    def step(self, stream):
        out = super().step(stream)
        self.first = self.first or out
        return self.first


class HalfBatch(Program):
    """Receives the first half of the frames and repeats it for the rest."""

    def step(self, stream):
        frames, eps, out = super().step(stream)
        h = self.B // 2
        half = self.receiver.rx_frames(self.rxp, frames[:h])
        return frames, eps, type(out)(*(torch.cat([a, a]) for a in half))


class Altered(Program):
    """Flips a byte of the first passing frame's payload where the step makes it."""

    def step(self, stream):
        frames, eps, out = super().step(stream)
        p = out.payload.clone()
        p[int(out.crc_ok.nonzero()[0]), 0] ^= 0xFF
        return frames, eps, out._replace(payload=p)


@pytest.mark.parametrize("fault", [Stale, HalfBatch, Altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tmp_path, cell, fault):
    cat = tiny_catalog(tmp_path)
    c = cat.cell(f"tiny.{cell}")
    prog = fault(c, CPU)
    res = run.run(c, 77, 0.2, False, CPU, cat, program=prog)
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0


class QuarterSoft(Program):
    """Scales every fourth frame's equalized symbols by 1.01 where the step makes them."""

    def step(self, stream):
        frames, eps, out = super().step(stream)
        soft = out.soft_syms.clone()
        soft[::4] *= 1.01
        return frames, eps, out._replace(soft_syms=soft)


class QuarterSnr(Program):
    """Adds 0.1 dB to every fourth frame's SNR estimate where the step makes it."""

    def step(self, stream):
        frames, eps, out = super().step(stream)
        snr = out.snr_db.clone()
        snr[::4] += 0.1
        return frames, eps, out._replace(snr_db=snr)


@pytest.mark.parametrize("fault, count", [(QuarterSoft, "soft_diverged"), (QuarterSnr, "snr_diverged")])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_on_a_quarter_of_the_frames_is_not_correct(tmp_path, cell, fault, count):
    """The medians do not see a fault on fewer than half the frames; the
    counts of frames past their threshold do."""
    cat = tiny_catalog(tmp_path, frames=256)
    c = cat.cell(f"tiny.{cell}")
    res = run.run(c, 78, 0.2, False, CPU, cat, program=fault(c, CPU))
    assert not res["correct"]
    bad = {k for k, v in res["checks"].items() if v["value"] > v["limit"]}
    assert bad == {count}, res["checks"]


def test_trace_reduction():
    tr = timing.Trace(device_ops=[("a", 10.0, 20.0), ("b", 15.0, 30.0), ("c", 40.0, 45.0), ("a", 50.0, 60.0)],
                      start_us=10.0, steps=2)
    r = timing.reduce(tr)
    assert r["busy_s"] == pytest.approx(35e-6) and r["window_s"] == pytest.approx(50e-6)
    assert r["launches"] == 4 and r["steps"] == 2
    assert r["device_ops"][0] == ["a", pytest.approx(20e-6)]
    assert r["idle_gaps"] == [["b -> c", pytest.approx(10e-6)], ["c -> a", pytest.approx(5e-6)]]
    assert timing.short("void at::native::(anonymous namespace)::k<float>(int)") == "k<float>(int)"
    assert timing.p95(range(1, 101)) == pytest.approx(95.05)
