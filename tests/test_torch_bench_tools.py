"""The port's measuring tools on the CPU at small sizes: ``bench_fec``,
``bench_twopass``, ``bench_bf16_ab``, ``bench_bank_switch``,
``profile_rx`` and ``bench_stream``, each through ``main(argv)`` with
``--cpu``.

Their JSON keys hold the JAX tools' keys: taken from ``--cpu`` runs of the
JAX tools at the same small arguments (one module fixture, side by side as
subprocesses) where that is cheap, and for the others listed here from
the JAX tools' source.  The random draws are the port's own (noise from a
``torch.Generator``), so of the values only those that do not depend on
them are compared exactly (sizes, code, bucket); the rest are held to what
a clean regime gives: ok rates of 1.0, CRC-clean rows.  Without a card,
``--device cuda`` ends every tool with ``tools/_cli``'s error.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gr_dtl_tpu_torch.tools import (bench_bank_switch, bench_bf16_ab, bench_fec, bench_stream,
                                    bench_twopass, profile_rx)

ROOT = Path(__file__).resolve().parent.parent
FAST = ["--reps", "1", "--iters", "1"]
REF_ARGS = {  # the JAX tools run at these arguments (their --out artifact read back)
    "bench_fec": ["16", "--no-bf16-ab"],
    "bench_twopass": ["--cw", "128", "--reps", "1", "--iters", "1"],
    "bench_bf16_ab": ["--cw", "128", "--reps", "1", "--iters", "1"],
    "bench_bank_switch": ["--codewords", "64", "--sizes", "1,2", "--iters", "1"],
}
# keys of the JAX tools that are not run here, from their source (tools/bench_stream.py)
REF_BF16_AB_KEYS = {"bp_step_ms_bf16", "bp_step_ms_f32", "speedup_bf16", "bp_ok_rate_bf16"}
REF_STREAM = {
    "result": {"platform", "frame_length", "stream_rx", "stream_ingest", "stream_duplex",
               "best_msamples_per_s", "best_frames_per_block", "best_mode", "note"},
    "accumulate": {"mode", "frames_per_block", "block_samples", "timed_blocks", "msamples_per_s",
                   "region_elapsed_s", "crc_ok", "header_ok", "valid_frames", "lost", "dispatch_ms",
                   "buffer_ms_at_700kss"},
    "readback": {"mode", "frames_per_block", "pipeline_depth", "block_samples", "timed_blocks",
                 "msamples_per_s", "sec_per_block_median", "sec_per_block_mean", "sec_per_block_max",
                 "region_elapsed_s", "final_block_crc_ok", "final_block_frames"},
    "mega-host": {"mode", "frames_per_block", "blocks_per_dispatch", "dispatch_samples", "timed_dispatches",
                  "msamples_per_s", "region_elapsed_s", "crc_ok", "valid_frames"},
    "device-stream": {"mode", "frames_per_block", "block_samples", "timed_blocks", "msamples_per_s",
                      "region_elapsed_s", "crc_ok", "header_ok", "valid_frames"},
    "mega-device": {"mode", "frames_per_block", "blocks_per_dispatch", "dispatch_samples",
                    "timed_dispatches", "msamples_per_s", "region_elapsed_s", "crc_ok", "header_ok",
                    "valid_frames"},
    "ingest-cost": {"mode", "block_samples", "block_bytes", "uploads", "h2d_ms_per_block",
                    "h2d_mbytes_per_s"},
    "ingest-ab": {"mode", "frames_per_block", "block_samples", "timed_blocks", "msamples_per_s",
                  "region_elapsed_s", "crc_ok", "valid_frames"},
    "duplex": {"frames_per_block", "steps", "readback", "msamples_per_s", "sec_per_step_median",
               "sec_per_step_max"},
    "best": {"metric", "value", "unit"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's small CPU ops while this module
    runs: the parallel test run's workers otherwise contend for the cores
    (a module of these tests took 20x its lone time so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_tools")
    procs = {name: subprocess.Popen([sys.executable, f"tools/{name}.py", *argv, "--cpu", "--out",
                                     str(d / f"{name}.json")], cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, argv in REF_ARGS.items()}
    out = {}
    for name, p in procs.items():
        _, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, f"reference {name}: {stderr[-3000:]}"
        out[name] = json.loads((d / f"{name}.json").read_text())
    return out


def _port(capsys, tool, argv) -> tuple:
    """The tool's returned result and the JSON of its last stdout line."""
    capsys.readouterr()
    res = tool.main([*argv, "--cpu"])
    return res, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _has_keys(got: dict, want, what: str) -> None:
    missing = set(want) - set(got)
    assert not missing, f"{what}: keys of the JAX tool missing: {sorted(missing)}"


def test_bench_fec(ref, capsys):
    res, line = _port(capsys, bench_fec, ["16", *FAST])
    want = ref["bench_fec"]
    assert line == json.loads(json.dumps(res))
    _has_keys(res, want, "result")
    _has_keys(res["extra"], want["extra"], "extra")
    for got, w in zip(res["coded_snr_sweep"], want["coded_snr_sweep"]):
        _has_keys(got, w, "sweep point")
        assert got["snr_db"] == w["snr_db"]
    _has_keys(res["bf16_ab"], REF_BF16_AB_KEYS, "bf16_ab")
    for k in ("frames_per_step", "codewords_per_step", "code"):
        assert res["extra"][k] == want["extra"][k], k
    assert res["coded_snr_sweep"][0]["crc_rate"] == 1.0 == res["extra"]["coded_crc_rate"]
    assert res["extra"]["bp_ok_rate"] == 1.0 and res["bf16_ab"]["bp_ok_rate_bf16"] == 1.0
    assert res["device"] == "cpu" and res["platform"] == "cpu"
    # the noise scales with the SNR: CRC rate and BP work do not improve toward the cliff
    rates = [p["crc_rate"] for p in res["coded_snr_sweep"]]
    assert rates == sorted(rates, reverse=True) and res["coded_snr_sweep"][-1]["avg_bp_iters"] > 0


@pytest.mark.parametrize("name,tool,variants", [
    ("bench_twopass", bench_twopass, ("mm", "twopass")),
    ("bench_bf16_ab", bench_bf16_ab, ("f32", "bf16"))])
def test_ldpc_ab_benches(ref, capsys, name, tool, variants):
    res, line = _port(capsys, tool, REF_ARGS[name])
    want = ref[name]
    assert line == json.loads(json.dumps(res))
    _has_keys(res, want, "result")
    assert set(res["regimes"]) == set(want["regimes"])
    for k in ("cw", "first", "bucket", "code", "reps", "iters_per_rep"):
        if k in want:
            assert res[k] == want[k], k
    assert "events" not in res["schedule"] and "perf_counter" in res["schedule"]
    for regime, r in res["regimes"].items():
        _has_keys(r, want["regimes"][regime], regime)
        for v in variants:
            _has_keys(r[v], want["regimes"][regime][v], f"{regime} {v}")
        assert (r["llr_amp"], r["noise_sigma"]) == (want["regimes"][regime]["llr_amp"],
                                                    want["regimes"][regime]["noise_sigma"])
        assert r[variants[0]]["ok_rate"] == r[variants[1]]["ok_rate"], regime
    assert res["regimes"]["clean"][variants[0]]["ok_rate"] == 1.0


def test_bench_bank_switch(ref, capsys, tmp_path):
    out = tmp_path / "bank.json"
    res, line = _port(capsys, bench_bank_switch, [*REF_ARGS["bench_bank_switch"], "--reps", "1",
                                                  "--out", str(out)])
    want = ref["bench_bank_switch"]
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert line == {"metric": "bank_decoder_crossover", "crossover": res["measured_crossover_n_codes"]}
    _has_keys(res, want, "result")
    assert [r["n_codes"] for r in res["rows"]] == [r["n_codes"] for r in want["rows"]] == [1, 2]
    for got, w in zip(res["rows"], want["rows"]):
        _has_keys(got, w, "row")
        assert got["mm_ok_rate"] == got["gather_ok_rate"] == 1.0
    for k in ("codewords_per_step", "code", "max_probed_n_codes"):
        assert res[k] == want[k], k


@pytest.mark.parametrize("args", [["--frames", "8"], ["--fec", "--frames", "4", "--steps", "1"]])
def test_profile_rx_writes_a_trace(capsys, tmp_path, args):
    res, line = _port(capsys, profile_rx, [*args, "--out", str(tmp_path)])
    assert line == json.loads(json.dumps(res))
    path = Path(res["trace"])
    assert path.parent == tmp_path and path.name.startswith("rx_coded" if "--fec" in args else "rx_plain")
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    steps = [e for e in spans if e["name"] == "rx.step"]
    assert len(steps) == (1 if "--steps" in args else 3) and res["program_spans"] == len(spans)
    # the program's spans, on the trace's clock: each step holds its stages, and as many of the
    # host ops the profiler saw as every other step (one step's ops are another's)
    ops = [e["ts"] for e in events if e.get("cat") == "cpu_op"]
    held = []
    for st in steps:
        inside = [e for e in spans if e["args"]["step"] == st["args"]["step"] and e is not st]
        assert {e["name"] for e in inside if e["args"]["parent"] == st["args"]["id"]} == \
            {"rx.detect", "rx.demodulate", "rx.equalize", "rx.demap"}
        assert all(st["ts"] <= e["ts"] <= e["ts"] + e["dur"] <= st["ts"] + st["dur"] for e in inside)
        held.append(sum(st["ts"] <= t <= st["ts"] + st["dur"] for t in ops))
    assert min(held) > 0.99 * max(held) > 0
    # on the CPU the trace holds host ops, and no device kernel
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert res["kernels"] == [] and res["kernel_events"] == 0 and res["crc_ok_rate"] == 1.0


def _stream_kind(r: dict) -> str:
    if "readback" in r:
        return "duplex"
    if r["mode"].startswith("ingest-") and r["mode"] != "ingest-cost":
        return "ingest-ab"
    return r["mode"]


@pytest.mark.parametrize("device_stream", [False, True])
def test_bench_stream(capsys, tmp_path, device_stream):
    out = tmp_path / "stream.json"
    argv = ["--sizes", "2,4", "--blocks", "2", "--reps", "2", "--frame-length", "4", "--mega", "2x2",
            "--duplex-steps", "2", "--duplex-frames", "2", "--out", str(out)]
    argv += ["--device-stream"] if device_stream else ["--ingest"]
    res, line = _port(capsys, bench_stream, argv)
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    _has_keys(line, REF_STREAM["best"], "last line")
    _has_keys(res, REF_STREAM["result"], "result")
    rows = res["stream_rx"] + res["stream_ingest"] + res["stream_duplex"]
    kinds = [_stream_kind(r) for r in rows]
    want_kinds = ((["device-stream"] * 2 + ["mega-device"]) if device_stream else
                  (["accumulate", "readback", "readback"] * 2 + ["mega-host", "ingest-cost", "ingest-ab",
                                                                   "ingest-ab"]))
    assert kinds == want_kinds + ["duplex", "duplex"]
    for r, kind in zip(rows, kinds):
        _has_keys(r, REF_STREAM[kind], kind)
        if "crc_ok" in r:
            assert r["crc_ok"] == r["valid_frames"] > 0, r
        if kind == "readback":
            assert r["final_block_crc_ok"] == r["final_block_frames"] == r["frames_per_block"]
    assert [r["frames_per_block"] for r in res["stream_rx"]
            if r["mode"] in ("accumulate", "device-stream")] == [2, 4]
    assert res["best_msamples_per_s"] == line["value"] == max(r["msamples_per_s"] for r in res["stream_rx"])
    assert [r["readback"] for r in res["stream_duplex"]] == ["serialized", "pipelined"]
    assert all(r["frames_header_ok"] == r["frames_sent"] for r in res["stream_duplex"])


@pytest.mark.parametrize("tool", [bench_fec, bench_twopass, bench_bf16_ab, bench_bank_switch,
                                  profile_rx, bench_stream])
def test_card_asked_for_without_one(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tool.main(["--device", "cuda"])
    assert "no CUDA device" in str(e.value.code)
