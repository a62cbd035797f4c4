"""The port's tools beyond the capture parity of test_torch_cli.py, on the
CPU: ``run_modem`` loopback, full-duplex and simplex at 30 dB print the JAX
runner's JSON keys and decode every frame (their random draws are the
port's own, so only the keys and the outcome compare); the sharded
self-test as a 2 x 2 grid of gloo processes; a ``listen:`` / ``tcp:`` pair
of port processes started TX first; the refusal of ``--device cuda``
without a card; ``ModemPipe``; ``ber_curve.run_point`` against the bar of
tests/test_ber_parity.py; the telemetry pipe (``--zmq``, the collector,
``stats``) and the error without pyzmq.

The JAX runner's outputs are made once per module, side by side, as
subprocesses with ``--cpu``.
"""

import json
import os
import socket
import struct
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from gr_dtl_tpu_torch.tools import ber_curve, replay, run_modem, stats, tun_bridge

ROOT = Path(__file__).resolve().parent.parent
FL = 10
LINKS = {
    "loopback": ["loopback", "--frames", "16"],
    "loopback_fec": ["loopback", "--frames", "8", "--config", "examples/config_fec.json"],
    "full-duplex": ["full-duplex", "--rounds", "8"],
    "simplex": ["simplex", "--rounds", "8"],
    "sharded_selftest": ["stream-sharded", "--selftest", "--streams", "4", "--mesh-stream", "2",
                         "--mesh-time", "2", "--frames-per-block", "4"],
}
COMMON = ["--frame-length", str(FL), "--snr-db", "30", "--snr-db-reverse", "30", "--json"]
MAX_LOSS_DB = 0.7  # tests/test_ber_parity.py's bar: 0.5 dB target + finite-sample margin


def _json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref_runs():
    procs = {k: subprocess.Popen([sys.executable, "tools/run_modem.py", *v, *COMMON, "--cpu"],
                                 cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True)
             for k, v in LINKS.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, f"reference {k}: {stderr[-3000:]}"
        out[k] = _json(stdout)
    return out


def _port(capsys, tool, argv) -> dict:
    capsys.readouterr()
    tool.main(argv)
    return _json(capsys.readouterr().out)


@pytest.mark.parametrize("mode", list(LINKS))
def test_modes_print_the_reference_keys_and_decode(ref_runs, capsys, mode):
    got = _port(capsys, run_modem, [*LINKS[mode], *COMMON, "--cpu"])
    want = ref_runs[mode]
    assert set(got) == set(want)
    for k in ("mode", "frames", "rounds", "streams", "mesh", "blocks_per_dispatch",
              "dispatch_chunks", "snr_cfg_db", "cfo"):
        if k in want:
            assert got[k] == want[k], k
    if mode.startswith("loopback"):
        assert got["crc_ok_rate"] == 1.0 and got["header_ok_rate"] == 1.0
        assert got["lost_frame_rate"] == 0.0 and got["carr_offset"] == 0
    elif mode == "full-duplex":
        assert got["a_crc_rate"] == 1.0 and got["b_crc_rate"] == 1.0
        assert got["a_tx_cnst_final"] >= 1 and got["b_tx_cnst_final"] >= 1
    elif mode == "simplex":
        assert got["crc_rate"] == 1.0 and got["burst_ok_rate"] == 1.0
    else:  # 4 streams over a 2 x 2 grid of gloo processes
        assert got["mesh"] == {"stream": 2, "time": 2} and got["selftest_pass"] is True
        assert got["frames_crc_ok"] == 4 * (3 - 1) * 4 and got["lost_frames"] == 0


def test_listen_tcp_pair_of_port_processes(tmp_path):
    """``stream --source listen:`` and ``stream-tx --sink tcp:`` as two
    ``python -m`` processes, the TX started first (its connect retries
    until the RX binds): every payload frame the TX reports reaches the
    RX's frame store with the bytes sent."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    store = tmp_path / "rx.dat"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "gr_dtl_tpu_torch.tools.run_modem"]
    common = ["--frame-length", str(FL), "--frames-per-block", "8", "--json", "--cpu"]
    tx = subprocess.Popen(cmd + ["stream-tx", "--sink", f"tcp:127.0.0.1:{port}", "--pdus", "40",
                                 "--max-blocks", "6", "--seed", "3"] + common,
                          cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True)
    rx = subprocess.Popen(cmd + ["stream", "--source", f"listen:{port}", "--store-rx",
                                 str(store)] + common,
                          cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True)
    tx_out, tx_err = tx.communicate(timeout=120)
    rx_out, rx_err = rx.communicate(timeout=120)
    assert tx.returncode == 0, tx_err[-3000:]
    assert rx.returncode == 0, rx_err[-3000:]
    t, r = _json(tx_out), _json(rx_out)
    assert t["blocks"] == r["blocks"] == 6 and t["samples"] == r["samples"]
    assert t["payload_frames"] == 40 and r["lost_frame_rate"] == 0.0
    from gr_dtl_tpu_torch.testbed.frame_store import read_frames

    rng = np.random.RandomState(3)
    sent = [rng.randint(0, 256, 40).astype(np.uint8).tobytes() for _ in range(40)]
    got = [data for _, data in read_frames(str(store)) if data]
    assert got == sent


TOOLS = {
    "run_modem": (run_modem, ["loopback", "--frames", "2", "--frame-length", "4"]),
    "replay": (replay, ["capture.c64"]),
    "ber_curve": (ber_curve, ["--snrs", "10", "--cnsts", "1"]),
    "tun_bridge": (tun_bridge, ["--self-test"]),
}


@pytest.mark.parametrize("name", list(TOOLS))
def test_cuda_without_a_card_is_an_error(monkeypatch, capsys, name):
    """The default device is cuda; without a card the tool exits with an
    error naming it and builds nothing on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    from gr_dtl_tpu_torch.models import receiver, transmitter

    def refuse(*a, **k):
        raise AssertionError("the tool built a modem after refusing the device")

    monkeypatch.setattr(transmitter, "build_tx", refuse)
    monkeypatch.setattr(receiver, "build_rx", refuse)
    tool, argv = TOOLS[name]
    for extra in ([], ["--device", "cuda"], ["--device", "cuda:0"]):
        with pytest.raises(SystemExit) as e:
            tool.main(argv + extra)
        assert "cuda" in str(e.value) and "no CUDA device" in str(e.value)
        assert capsys.readouterr().out == ""


def test_cuda_default_exits_nonzero_as_a_process():
    proc = subprocess.run([sys.executable, "-m", "gr_dtl_tpu_torch.tools.run_modem", "loopback",
                           "--frames", "2", "--frame-length", "4", "--json"],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT),
                                             CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "device cuda" in proc.stderr


def _ipv4(payload: bytes, ident: int) -> bytes:
    hdr = bytearray(struct.pack("!BBHHHBBH4s4s", 0x45, 0, 20 + len(payload), ident, 0, 64, 17, 0,
                                bytes([10, 99, 0, 1]), bytes([10, 99, 0, 2])))
    s = sum((hdr[i] << 8) | hdr[i + 1] for i in range(0, 20, 2))
    s = (s & 0xFFFF) + (s >> 16)
    s = (s & 0xFFFF) + (s >> 16)
    struct.pack_into("!H", hdr, 10, (~s) & 0xFFFF)
    return bytes(hdr) + payload


def test_modem_pipe_echoes_packets():
    """IPv4 packets (a jumbo among them) -> frames -> AWGN at 25 dB ->
    frames -> the deframer: the same packets; swap_echo swaps them back."""
    rng = np.random.RandomState(0)
    pkts = [_ipv4(rng.bytes(int(n)), i) for i, n in enumerate(rng.randint(8, 100, 15))]
    pkts.append(_ipv4(rng.bytes(300), 99))  # longer than a frame: split, reassembled
    pipe = tun_bridge.ModemPipe(device="cpu")
    assert pipe.process(pkts) == pkts
    assert pipe.process([]) == []
    assert pipe.process(pkts[:3]) == pkts[:3]  # frame numbers go on
    echo = tun_bridge.swap_echo(pkts[0])
    assert echo[12:16] == pkts[0][16:20] and tun_bridge.swap_echo(echo) == pkts[0]


@pytest.mark.parametrize("cnst_id,snr_db,frames", [(1, 6.0, 256), (2, 13.0, 128), (3, 14.0, 192),
                                                   (4, 16.0, 128)])
def test_ber_curve_within_half_db_of_theory(cnst_id, snr_db, frames):
    """tests/test_ber_parity.py's points and bar, through the port."""
    r = ber_curve.run_point(cnst_id, snr_db, frames, seed=int(10 * snr_db) + cnst_id,
                            frame_length=10, device="cpu")
    assert r["ber"] > 0
    assert r["loss_db"] is not None and r["loss_db"] <= MAX_LOSS_DB, r


def test_telemetry_pipe_zmq_collector_stats(tmp_path, capsys):
    """``loopback --zmq`` publishes one MonitorEqMsg a frame, the collector
    writes them as JSONL, ``stats`` summarizes them as the JAX package's
    collect module does."""
    pytest.importorskip("zmq")
    from gr_dtl_tpu.testbed import collect as ref_collect
    from gr_dtl_tpu_torch.tools import monitor_collector

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    jsonl = tmp_path / "telem.jsonl"
    col = threading.Thread(target=monitor_collector.main, args=([
        "--connect", f"tcp://127.0.0.1:{port}", "--jsonl", str(jsonl), "--count", "8",
        "--timeout", "60", "--every", "100"],))
    col.start()
    run_modem.main(["loopback", "--frames", "8", "--frame-length", str(FL), "--zmq",
                    f"tcp://127.0.0.1:{port}", "--json", "--cpu"])
    col.join(timeout=90)
    assert not col.is_alive()
    msgs = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert len(msgs) == 8
    capsys.readouterr()
    assert stats.main([str(jsonl), "--json"]) == 0
    got = _json(capsys.readouterr().out)
    assert got == json.loads(json.dumps({"messages": 8, "fields": ref_collect.summarize(msgs),
                                         "frame_success_rate": ref_collect.frame_success(msgs)}))
    assert got["fields"]["estimated_snr_tag_key"]["n"] == 8


def test_zmq_without_pyzmq_names_it(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "zmq", None)
    with pytest.raises(SystemExit) as e:
        run_modem.main(["loopback", "--frames", "2", "--frame-length", "4", "--zmq",
                        "tcp://127.0.0.1:5999", "--cpu"])
    assert "pyzmq" in str(e.value)
    from gr_dtl_tpu_torch.tools import monitor_collector

    with pytest.raises(SystemExit) as e:
        monitor_collector.main(["--count", "1"])
    assert "pyzmq" in str(e.value)
