"""The port's app layer on captures: ``run_modem stream`` (depth 1 and 2,
coded with two-frame transport blocks), ``replay``, ``stream-sharded
--source`` and ``ber`` of gr_dtl_tpu_torch/tools against the JAX package's
tools/ on the same files, on the CPU.

One uncoded and one coded capture are made once, by the port's
``stream-tx`` (frame_length 10, 8 frames a block), then shifted by 300
samples of silence so that block boundaries cut frames, followed by a block
of idle air, with complex noise of std 0.01 drawn by numpy from a seed.
The JAX tools run once per module as subprocesses (``--cpu``), side by side
in one fixture, each start costing seconds; the port's tools run in this
process through their ``main(argv)``.  Frame stores must be byte-equal and
the counts in the JSON equal; replay's float outputs are means of the
per-frame values that tests/test_torch_receiver.py bounds (SNR atol 5e-3
dB, fine CFO atol 1e-5 subcarriers).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gr_dtl_tpu_torch.tools import ber, replay, run_modem
from gr_dtl_tpu_torch.utils import config as cfgmod

ROOT = Path(__file__).resolve().parent.parent
FL, F = 10, 8  # frame_length, frames a block
FEC_CONFIG = str(ROOT / "examples" / "config_fec.json")
STREAM_KEYS = ("blocks", "samples", "frames_header_ok", "frames_crc_ok", "lost_frame_rate",
               "pipeline_depth")
SHARDED_S = 2


def _capture(path: Path, config, pdus: int, blocks: int, seed: int) -> Path:
    """The port's stream-tx output, 300 samples late, a block of idle air
    after it, and complex noise of std 0.01."""
    raw = path.with_suffix(".tx.c64")
    argv = ["stream-tx", "--sink", f"file:{raw}", "--frame-length", str(FL), "--frames-per-block",
            str(F), "--pdus", str(pdus), "--max-blocks", str(blocks), "--seed", str(seed), "--cpu",
            "--json"]
    if config:
        argv += ["--config", config, "--tb-frames", "2"]
    run_modem.main(argv)
    x = np.fromfile(raw, np.complex64)
    block = F * cfgmod.make_rx_config(config, frame_length=FL).frame_samples
    x = np.concatenate([np.zeros(300, np.complex64), x, np.zeros(block, np.complex64)])
    rng = np.random.RandomState(seed + 100)
    x = x + (0.01 * (rng.randn(x.size) + 1j * rng.randn(x.size)) / np.sqrt(2)).astype(np.complex64)
    x.astype(np.complex64).tofile(path)
    return path


def _sharded_file(capture: Path, path: Path) -> Path:
    """[S, D] dispatch chunks, stream-major: stream s is the capture s * 517
    samples late."""
    x = np.fromfile(capture, np.complex64)
    D = F * cfgmod.make_rx_config(None, frame_length=FL).frame_samples
    rows = np.stack([np.concatenate([np.zeros(517 * s, np.complex64), x])[: x.size]
                     for s in range(SHARDED_S)])
    n = rows.shape[1] // D
    with open(path, "wb") as f:
        for c in range(n):
            rows[:, c * D: (c + 1) * D].tofile(f)
    return path


def _json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The captures, and the JAX tools' outputs on them (run side by side)."""
    d = tmp_path_factory.mktemp("cli")
    cap = _capture(d / "cap.c64", None, pdus=40, blocks=6, seed=1)
    ccap = _capture(d / "ccap.c64", FEC_CONFIG, pdus=24, blocks=4, seed=2)
    shard = _sharded_file(cap, d / "shard.c64")
    common = ["--frame-length", str(FL), "--json", "--cpu"]
    stream = ["tools/run_modem.py", "stream", "--frames-per-block", str(F)] + common
    jobs = {
        "stream1": stream + ["--source", f"file:{cap}", "--store-rx", str(d / "ref_s1.dat")],
        "stream2": stream + ["--source", f"file:{cap}", "--pipeline-depth", "2",
                             "--store-rx", str(d / "ref_s2.dat")],
        "coded": stream + ["--source", f"file:{ccap}", "--config", FEC_CONFIG, "--tb-frames", "2",
                           "--store-rx", str(d / "ref_c.dat")],
        "replay": ["tools/replay.py", str(cap), "--store-rx", str(d / "ref_rp.dat")] + common,
        "sharded": ["tools/run_modem.py", "stream-sharded", "--source", f"file:{shard}",
                    "--streams", str(SHARDED_S), "--mesh-stream", "2", "--frames-per-block",
                    str(F)] + common,
    }
    procs = {k: subprocess.Popen([sys.executable, *v], cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k, v in jobs.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, f"reference {k}: {stderr[-3000:]}"
        out[k] = _json(stdout)
    return {"dir": d, "cap": cap, "ccap": ccap, "shard": shard, "ref": out}


def _port(capsys, tool, argv) -> dict:
    capsys.readouterr()
    tool.main(argv)
    return _json(capsys.readouterr().out)


@pytest.mark.parametrize("depth", [1, 2])
def test_stream_matches_reference(runs, capsys, depth):
    d = runs["dir"]
    store = d / f"port_s{depth}.dat"
    got = _port(capsys, run_modem, [
        "stream", "--source", f"file:{runs['cap']}", "--frames-per-block", str(F),
        "--frame-length", str(FL), "--pipeline-depth", str(depth), "--store-rx", str(store),
        "--json", "--cpu"])
    want = runs["ref"][f"stream{depth}"]
    assert set(got) == set(want)
    assert {k: got[k] for k in STREAM_KEYS} == {k: want[k] for k in STREAM_KEYS}
    assert got["frames_crc_ok"] == 48 and got["lost_frame_rate"] == 0.0  # every frame sent
    assert store.read_bytes() == (d / f"ref_s{depth}.dat").read_bytes()


def test_coded_stream_with_transport_blocks_matches_reference(runs, capsys):
    d = runs["dir"]
    got = _port(capsys, run_modem, [
        "stream", "--source", f"file:{runs['ccap']}", "--config", FEC_CONFIG, "--tb-frames", "2",
        "--frames-per-block", str(F), "--frame-length", str(FL), "--store-rx",
        str(d / "port_c.dat"), "--json", "--cpu"])
    want = runs["ref"]["coded"]
    assert set(got) == set(want)
    keys = STREAM_KEYS + ("tb_emitted", "tb_crc_ok")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["tb_emitted"] == 16 and got["tb_crc_ok"] > 0
    assert (d / "port_c.dat").read_bytes() == (d / "ref_c.dat").read_bytes()


def test_replay_matches_reference(runs, capsys):
    d = runs["dir"]
    got = _port(capsys, replay, [str(runs["cap"]), "--frame-length", str(FL), "--store-rx",
                                 str(d / "port_rp.dat"), "--json", "--cpu"])
    want = runs["ref"]["replay"]
    assert set(got) == set(want)
    exact = ("capture_samples", "frames", "carr_offset", "header_ok_rate", "crc_ok_rate",
             "lost_frame_rate")
    assert {k: got[k] for k in exact} == {k: want[k] for k in exact}
    # 48 frames sent; the capture's slots after them hold idle air
    assert round(got["crc_ok_rate"] * got["frames"]) == 48
    assert abs(got["est_snr_db"] - want["est_snr_db"]) <= 5e-3
    assert abs(got["mean_cfo_subcarriers"] - want["mean_cfo_subcarriers"]) <= 1e-5
    assert (d / "port_rp.dat").read_bytes() == (d / "ref_rp.dat").read_bytes()


def test_stream_sharded_file_source_matches_reference(runs, capsys):
    """The reference on a 2 x 1 grid of virtual CPU devices, the port as one
    rank: the same counts."""
    got = _port(capsys, run_modem, [
        "stream-sharded", "--source", f"file:{runs['shard']}", "--streams", str(SHARDED_S),
        "--frames-per-block", str(F), "--frame-length", str(FL), "--json", "--cpu"])
    want = runs["ref"]["sharded"]
    assert set(got) == set(want)
    keys = ("streams", "blocks_per_dispatch", "dispatch_chunks", "frames_header_ok",
            "frames_crc_ok", "lost_frames")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["mesh"] == {"stream": 1, "time": 1} and want["mesh"] == {"stream": 2, "time": 1}
    assert got["frames_crc_ok"] >= SHARDED_S * 47 and got["lost_frames"] == 0


@pytest.mark.parametrize("pair", ["loopback", "loopback_vs_stream", "stream_vs_replay"])
def test_ber_matches_reference(runs, capsys, pair):
    """Both packages' scorers on the same store pair: equal JSON; a pair of
    unrelated stores (mismatched lengths, missing frames) too."""
    from tools.ber import score as ref_score

    d = runs["dir"]
    if not (d / "lb_tx.dat").exists():
        _port(capsys, run_modem, ["loopback", "--frames", "16", "--frame-length", str(FL),
                                  "--snr-db", "25", "--store-tx", str(d / "lb_tx.dat"),
                                  "--store-rx", str(d / "lb_rx.dat"), "--json", "--cpu"])
    tx, rx = {"loopback": ("lb_tx.dat", "lb_rx.dat"),
              "loopback_vs_stream": ("lb_tx.dat", "ref_s1.dat"),
              "stream_vs_replay": ("ref_s1.dat", "ref_rp.dat")}[pair]
    got = _port(capsys, ber, [str(d / tx), str(d / rx), "--json"])
    assert got == ref_score(str(d / tx), str(d / rx))
    if pair == "loopback":
        assert got["frames_sent"] == 16 and got["ber_overall"] == 0.0 and got["fer"] == 0.0
