"""The live-I/O link tools of gr_dtl_tpu_torch/tools against the JAX
package's tools/, on the CPU: ``sample_link`` (the two-process simplex link
and the full-duplex pair over TCP) and ``soak_link`` (its impairment relay,
and a short soak of the two daemons).

The JAX tools' test modes and the port's run side by side in one module
fixture, as subprocesses, at the settings of tests/test_sample_io.py's slow
tests.  The RX-side AWGN and the burst offsets are the same numpy draws in
both packages; the TX pad bytes are not (``jax.random`` there, a
``torch.Generator`` here), so the sample streams differ in the frames' pad
bytes and with them the SNR estimates, a little.  The counts that do not
depend on those draws must be equal: blocks, samples sent and received,
frames, header_ok, payload frames and their CRC passes, the final
constellation and the last decision.  The decision histories (``want_hist``,
``feedback_applied``, ``applied_hist``) follow the SNR estimates: a pad draw
could move a decision by a block only where an estimate sits within its
pad-dependent spread of a threshold or threshold + hysteresis edge.  At
these settings (30 and 25 dB against edges at 13 / 14, 18 / 19, 23 / 24 dB)
none does, so they are compared too, and printed.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gr_dtl_tpu_torch.tools import soak_link

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

from soak_link import ImpairRelay as RefImpairRelay  # noqa: E402

LOOPBACK = ["--loopback-test", "--pdus", "24", "--frames-per-block", "8", "--frame-length", "10",
            "--snr-db", "30"]
DUPLEX = ["--duplex-test", "--pdus", "24", "--pdu-bytes", "30", "--frames-per-block", "4",
          "--frame-length", "10", "--snr-db", "25", "--seed", "3"]
TX_KEYS = ("blocks", "samples_sent", "pdus", "final_cnst")
RX_KEYS = ("frames", "header_ok", "payload_frames", "payload_crc_ok", "lost_frame_rate",
           "want_final", "samples_received")
DPX_KEYS = ("role", "blocks", "frames", "header_ok", "payload_frames", "payload_crc_ok",
            "lost_frame_rate", "final_tx_cnst", "want_final", "samples_sent", "samples_received")


@pytest.fixture(scope="module")
def links(tmp_path_factory):
    """Both packages' loopback and duplex test modes, the four at once."""
    d = tmp_path_factory.mktemp("links")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_COORDINATOR", None)
    runs = {}
    for name, flags in (("loopback", LOOPBACK), ("duplex", DUPLEX)):
        runs[("jax", name)] = [sys.executable, str(ROOT / "tools" / "sample_link.py"), *flags,
                               "--out", str(d / f"jax_{name}.json")]
        runs[("port", name)] = [sys.executable, "-m", "gr_dtl_tpu_torch.tools.sample_link", *flags,
                                "--cpu", "--out", str(d / f"port_{name}.json")]
    procs = {k: subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for k, cmd in runs.items()}
    out = {}
    try:
        for k, p in procs.items():
            text = p.communicate(timeout=600)[0]
            assert p.returncode == 0, f"{k}: exit {p.returncode}\n{text[-4000:]}"
            out[k] = json.loads((d / f"{k[0]}_{k[1]}.json").read_text())
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_loopback_link_matches_the_reference(links):
    got, want = links[("port", "loopback")], links[("jax", "loopback")]
    print("want_hist port", got["rx"]["want_hist"], "reference", want["rx"]["want_hist"])
    print("feedback_applied port", got["tx"]["feedback_applied"], "reference",
          want["tx"]["feedback_applied"])
    assert got["crc_clean"] is True and got["adaptation_converged"] is True
    assert got["tx"]["final_cnst"] == 4  # climbed to QAM16 at 30 dB
    assert got["rx"]["samples_received"] == got["tx"]["samples_sent"]
    assert got["tx"]["device"] == got["rx"]["device"] == "cpu"
    for side, keys in (("tx", TX_KEYS), ("rx", RX_KEYS)):
        assert {k: got[side][k] for k in keys} == {k: want[side][k] for k in keys}, side
    assert got["rx"]["want_hist"] == want["rx"]["want_hist"]
    assert got["tx"]["feedback_applied"] == want["tx"]["feedback_applied"]
    assert got["rx"]["blocks"] == got["tx"]["blocks"]
    assert got["tx"]["wall_ms_per_block"] > 0 and got["rx"]["work_ms_per_block"] > 0


def test_duplex_link_matches_the_reference(links):
    got, want = links[("port", "duplex")], links[("jax", "duplex")]
    for node in ("a", "b"):
        print(node, "want_hist port", got[node]["want_hist"], "reference", want[node]["want_hist"])
        print(node, "applied_hist port", got[node]["applied_hist"], "reference",
              want[node]["applied_hist"])
    assert got["crc_clean_ab"] and got["crc_clean_ba"]
    assert got["adaptation_converged_ab"] and got["adaptation_converged_ba"]
    for node in ("a", "b"):
        assert got[node]["final_tx_cnst"] >= 3  # both directions climb off BPSK at 25 dB
        hist = got[node]["want_hist"]
        assert hist == sorted(hist)  # the wants climbed monotonically
        assert {k: got[node][k] for k in DPX_KEYS} == {k: want[node][k] for k in DPX_KEYS}, node
        assert got[node]["want_hist"] == want[node]["want_hist"]
        assert got[node]["applied_hist"] == want[node]["applied_hist"]


def _chunks(x: np.ndarray, sizes) -> list:
    out, i, k = [], 0, 0
    while i < len(x):
        n = sizes[k % len(sizes)]
        out.append(x[i: i + n])
        i += n
        k += 1
    return out


@pytest.mark.parametrize("sizes", [[1000], [7333, 1, 0, 65536, 17], [29440], [3, 50000, 2]])
def test_impair_relay_is_byte_equal_to_the_reference(sizes):
    """The numpy relay is the reference's, chunk for chunk: AWGN, the
    wandering CFO and the SFO resampler, with state carried across uneven
    chunks (an empty one included)."""
    rng = np.random.RandomState(4)
    x = (rng.randn(120_000) + 1j * rng.randn(120_000)).astype(np.complex64)
    got = soak_link.ImpairRelay(18.0, 0.35, 5e4, 20.0, seed=7)
    want = RefImpairRelay(18.0, 0.35, 5e4, 20.0, seed=7)
    for c in _chunks(x, sizes):
        a, b = got(c), want(c)
        assert a.dtype == b.dtype == np.complex64 and a.tobytes() == b.tobytes()
    assert got.pos == want.pos and got.phase == want.phase and got.buf.tobytes() == want.buf.tobytes()


def assert_short_soak_healthy(summary: dict, code: int, samples: float) -> None:
    """A soak shorter than the tool's 1e8-sample bar: every other pass
    criterion holds (CRC rate, lost-frame rate, RSS growth of both
    daemons, at the tool's defaults), so the bar is the only one that
    fails and the tool exits 1."""
    assert summary["samples"] >= samples and summary["samples"] < soak_link.MIN_SAMPLES
    assert summary["crc_rate_of_decoded"] >= 0.98 and summary["lost_frame_rate"] <= 0.02
    assert summary["rss_rx_growth_mb"] <= 64.0 and summary["rss_tx_growth_mb"] <= 64.0
    assert summary["pass"] is False and code == 1


def test_short_soak_passes_and_writes_only_where_told(tmp_path):
    """A 2e6-sample soak of the two daemons on the CPU at F = 16 meets every
    criterion of the tool but the 1e8 samples of a real soak (so it exits
    1 with ``pass`` false) and writes its record and summary where the flags
    say, and nothing else: the tracked SOAK_r04 files of the JAX side stay
    as they are."""
    tracked = {p: p.read_bytes() for p in ROOT.glob("SOAK_r04*")}
    jsonl, out = tmp_path / "soak.jsonl", tmp_path / "soak.json"
    with pytest.raises(SystemExit) as ex:
        soak_link.main(["--cpu", "--samples", "2e6", "--frames-per-block", "16",
                        "--stats-every", "8", "--jsonl", str(jsonl), "--out", str(out)])
    summary = json.loads(out.read_text())
    assert_short_soak_healthy(summary, ex.value.code, 2e6)
    assert summary["records"] >= 8 and summary["device"] == "cpu"
    records = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    assert len(records) == summary["records"] and all(r["stat"] == "stream" for r in records)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["soak.json", "soak.jsonl"]
    assert {p: p.read_bytes() for p in ROOT.glob("SOAK_r04*")} == tracked
    with pytest.raises(SystemExit) as ex:  # the output paths are required
        soak_link.main(["--cpu", "--samples", "1e6"])
    assert ex.value.code == 2
