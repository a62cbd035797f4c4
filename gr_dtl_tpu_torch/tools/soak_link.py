"""Long-run soak of the always-on daemons: stream-tx -> impaired link ->
stream, for 1e8+ samples, with a JSONL health record (port of
tools/soak_link.py).

The two deployment entry points (``python -m gr_dtl_tpu_torch.tools.run_modem
stream-tx`` and ``... stream``: OS processes on ``--device``, a TCP sample
stream between them through this process) run for hundreds of millions of
samples through a continuously impaired channel while this tool records,
over time,

  - header / payload-CRC success counters (the RX daemon's
    ``--stats-every`` self-report),
  - the lost-frame rate (12-bit frame_no gap accounting),
  - both daemons' resident set size (a leak in the carried-state host loop
    or the device buffers shows up as RSS growth),

to ``--jsonl``, plus a pass/fail summary to ``--out``.  Both paths are
required: a run writes only where it is told.

The impairment relay (in this process, numpy) applies, per chunk, with
state carried continuously across chunks:

  - AWGN at ``--snr-db``,
  - a slowly wandering CFO (sinusoidal, +-``--cfo-max`` subcarriers over
    ``--cfo-period`` samples: oscillator drift),
  - a constant sample-clock offset (``--sfo-ppm``, linear-interpolation
    resampler): the accumulated timing drift is what keeps the trigger
    lock logic honest over 1e8 samples.

Pass criteria: the RX daemon saw at least 1e8 samples (a real soak),
stayed locked (CRC rate >= --min-crc-rate of the decoded
frames), lost-frame rate <= --max-lost-rate, and neither daemon's RSS grew
by more than --max-rss-growth-mb between the first and last quartile of
the records (read as 0 with fewer than 8 records).  The daemons run on
``--device`` (cuda by default, ``--cpu`` for the CPU); a daemon that
cannot reach its device exits non-zero, and so does this tool.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from gr_dtl_tpu_torch.testbed import sample_io
from gr_dtl_tpu_torch.tools import _cli

__all__ = ["main", "proc_rss_mb", "ImpairRelay"]

PKG_ROOT = Path(__file__).resolve().parents[2]  # the directory that holds gr_dtl_tpu_torch
DAEMON = (sys.executable, "-m", "gr_dtl_tpu_torch.tools.run_modem")
MIN_SAMPLES = 1e8  # samples the RX must have seen for a pass: a real soak


def proc_rss_mb(pid: int) -> float | None:
    try:
        with open(f"/proc/{pid}/statm") as f:
            mb = int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE") / 1e6
        return mb if mb > 1.0 else None  # 0 = zombie/exited
    except (OSError, ValueError):
        return None


class ImpairRelay:
    """TX socket -> (SFO resample + CFO wander + AWGN) -> RX socket."""

    def __init__(self, snr_db, cfo_max_sc, cfo_period, sfo_ppm, fft_len=64, seed=0):
        self.noise_v = float(np.sqrt(0.81 / 10 ** (snr_db / 10)))
        self.cfo_max = cfo_max_sc * 2 * np.pi / fft_len  # rad/sample
        self.cfo_period = float(cfo_period)
        self.step = 1.0 + sfo_ppm * 1e-6
        self.rng = np.random.RandomState(seed)
        self.n_in = 0  # input-clock sample counter (CFO phase source)
        self.phase = 0.0  # accumulated CFO phase, continuous
        self.buf = np.zeros(0, np.complex64)  # resampler holdover
        self.pos = 0.0  # fractional read position into buf

    def __call__(self, chunk: np.ndarray) -> np.ndarray:
        # CFO: integrate the wandering frequency over this chunk
        k = self.n_in + np.arange(len(chunk))
        freq = self.cfo_max * np.sin(2 * np.pi * k / self.cfo_period)
        ph = self.phase + np.cumsum(freq)
        self.phase = float(ph[-1]) if len(ph) else self.phase
        self.n_in += len(chunk)
        x = chunk * np.exp(1j * ph).astype(np.complex64)
        # SFO: linear-interp resample at (1 + ppm) with carried position
        self.buf = np.concatenate([self.buf, x])
        n_out = int((len(self.buf) - 1 - self.pos) / self.step)
        if n_out <= 0:
            return np.zeros(0, np.complex64)
        t = self.pos + self.step * np.arange(n_out)
        i0 = t.astype(np.int64)
        fr = (t - i0).astype(np.float32)
        y = (self.buf[i0] * (1 - fr) + self.buf[i0 + 1] * fr)
        consumed = int(t[-1])  # keep [consumed:] for continuity
        self.pos = t[-1] + self.step - consumed
        self.buf = self.buf[consumed:]
        # AWGN
        y = y + (self.noise_v / np.sqrt(2)) * (
            self.rng.standard_normal(n_out) + 1j * self.rng.standard_normal(n_out))
        return y.astype(np.complex64)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.soak_link",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--samples", type=float, default=1.5e8,
                    help="TX sample budget (>=1e8 for a real soak)")
    ap.add_argument("--frame-length", type=int, default=20)
    ap.add_argument("--frames-per-block", type=int, default=16)
    ap.add_argument("--pdu-bytes", type=int, default=40)
    ap.add_argument("--snr-db", type=float, default=18.0)
    ap.add_argument("--cfo-max", type=float, default=0.35,
                    help="CFO wander amplitude (subcarriers)")
    ap.add_argument("--cfo-period", type=float, default=2e7,
                    help="CFO wander period (samples)")
    ap.add_argument("--sfo-ppm", type=float, default=20.0)
    ap.add_argument("--stats-every", type=int, default=200,
                    help="RX stats interval (blocks)")
    ap.add_argument("--min-crc-rate", type=float, default=0.98)
    ap.add_argument("--max-lost-rate", type=float, default=0.02)
    ap.add_argument("--max-rss-growth-mb", type=float, default=64.0)
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument("--jsonl", required=True, help="where the health records go (JSONL)")
    ap.add_argument("--out", required=True, help="where the summary goes (JSON)")
    _cli.add_device_args(ap)
    return ap


def _popen(cmd: list, env: dict) -> subprocess.Popen:
    """A daemon; its stderr goes to an unnamed temporary file, ``proc.log``."""
    log = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(cmd, env=env, cwd=PKG_ROOT, stdout=subprocess.PIPE, stderr=log,
                            text=True)
    proc.log = log
    return proc


def _failed(proc, what: str) -> None:
    proc.log.seek(0)
    sys.exit(f"error: the {what} daemon exited {proc.returncode}: {proc.log.read()[-3000:]}")


def _alive(proc, what: str) -> None:
    if proc.poll() is not None:
        _failed(proc, what)


def _connect(port: int, proc, timeout: float = 180.0):
    """Connect to the RX daemon's listener once it is up, for as long as it runs."""
    deadline = time.monotonic() + timeout
    while True:
        _alive(proc, "stream")
        try:
            return sample_io.connect("127.0.0.1", port, timeout=2.0)
        except OSError:
            if time.monotonic() > deadline:
                raise


def _accept(srv, proc, timeout: float = 180.0):
    """Accept the TX daemon's connection, for as long as it runs."""
    import socket

    deadline = time.monotonic() + timeout
    while True:
        _alive(proc, "stream-tx")
        try:
            return sample_io.accept_endpoint(srv, timeout=1.0)
        except socket.timeout:
            if time.monotonic() > deadline:
                raise


def _free_ports(n: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    dev = _cli.device_of(args)

    frame_samples = (args.frame_length + 3) * 80  # fft64+cp16, 2 sync + hdr
    block = args.frames_per_block * frame_samples
    n_blocks = int(args.samples / block) + 1
    # enough PDUs that every frame carries payload (BPSK capacity is the
    # smallest; whole-PDU packing => ~2 fit per frame)
    n_pdus = 3 * n_blocks * args.frames_per_block

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(PKG_ROOT), env.get("PYTHONPATH")) if p)
    rx_port, tx_port = _free_ports(2)
    common = ["--frame-length", str(args.frame_length),
              "--frames-per-block", str(args.frames_per_block),
              "--device", str(dev), "--json"]
    rx_cmd = [*DAEMON, "stream", "--source", f"listen:{rx_port}",
              "--pipeline-depth", str(args.pipeline_depth),
              "--stats-every", str(args.stats_every)] + common
    tx_cmd = [*DAEMON, "stream-tx", "--sink", f"tcp:127.0.0.1:{tx_port}",
              "--pdus", str(n_pdus), "--pdu-bytes", str(args.pdu_bytes),
              "--max-blocks", str(n_blocks)] + common
    rxp = _popen(rx_cmd, env)
    txp = None
    records = []
    final = None
    relay_error = []
    try:
        # relay: connect to RX (retries until its listener is up), then
        # listen for TX
        rx_ep = _connect(rx_port, rxp)
        srv, _ = sample_io.listen("127.0.0.1", tx_port)
        txp = _popen(tx_cmd, env)
        try:
            tx_ep = _accept(srv, txp)
        finally:
            srv.close()
        impair = ImpairRelay(args.snr_db, args.cfo_max, args.cfo_period, args.sfo_ppm)

        def relay():
            try:
                while True:
                    chunk = tx_ep.source.read(block)
                    if len(chunk) == 0:
                        break
                    y = impair(chunk)
                    if len(y):
                        rx_ep.sink.write(y)
                    if len(chunk) < block:
                        break
            except Exception as e:  # noqa: BLE001 - reported after the run
                relay_error.append(repr(e))
            finally:
                tx_ep.close()
                rx_ep.close()  # EOF -> the RX daemon drains and reports

        rt = threading.Thread(target=relay, daemon=True)
        rt.start()

        # collect: RX stats lines + periodic RSS of both daemons
        t0 = time.monotonic()
        with open(args.jsonl, "w") as jsonl:
            for line in rxp.stdout:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                rec = json.loads(line)
                if rec.get("stat") == "stream":
                    rec["wall_s"] = round(time.monotonic() - t0, 1)
                    rec["rss_tx_mb"] = proc_rss_mb(txp.pid)
                    records.append(rec)
                    jsonl.write(json.dumps(rec) + "\n")
                    jsonl.flush()
                    print(json.dumps(rec), flush=True)
                elif rec.get("mode") == "stream":
                    final = rec
        wall_s = time.monotonic() - t0
        rt.join(timeout=60)
        txp.wait(timeout=300)
        rxp.wait(timeout=300)
    finally:
        for p in (rxp, txp):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    for name, p in (("stream", rxp), ("stream-tx", txp)):
        if p.returncode != 0:
            _failed(p, name)
    if relay_error:
        sys.exit(f"error: the relay failed: {relay_error[0]}")
    if final is None:
        sys.exit("error: the RX daemon did not report a final summary")

    def growth(key):
        # health: RSS growth between the first and last quartile of records
        vals = [r[key] for r in records if r.get(key) is not None]
        if len(vals) < 8:
            return 0.0
        q = max(1, len(vals) // 4)
        return float(np.mean(vals[-q:]) - np.mean(vals[:q]))

    crc_rate = final["frames_crc_ok"] / max(1, final["frames_header_ok"])
    summary = {
        "samples": final["samples"],
        "blocks": final["blocks"],
        "wall_s": records[-1]["wall_s"] if records else None,
        "run_wall_s": round(wall_s, 3),
        "frames_header_ok": final["frames_header_ok"],
        "frames_crc_ok": final["frames_crc_ok"],
        "crc_rate_of_decoded": crc_rate,
        "lost_frame_rate": final["lost_frame_rate"],
        "rss_rx_growth_mb": round(growth("rss_mb"), 1),
        "rss_tx_growth_mb": round(growth("rss_tx_mb"), 1),
        "impairments": {"snr_db": args.snr_db,
                        "cfo_max_subcarriers": args.cfo_max,
                        "cfo_period_samples": args.cfo_period,
                        "sfo_ppm": args.sfo_ppm},
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": str(dev),
        "pipeline_depth": args.pipeline_depth,
        "records": len(records),
        "jsonl": args.jsonl,
        "pass": bool(
            final["samples"] >= MIN_SAMPLES
            and crc_rate >= args.min_crc_rate
            and final["lost_frame_rate"] <= args.max_lost_rate
            and growth("rss_mb") <= args.max_rss_growth_mb
            and growth("rss_tx_mb") <= args.max_rss_growth_mb),
    }
    print(json.dumps(summary, indent=2), flush=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    sys.exit(0 if summary["pass"] else 1)


if __name__ == "__main__":
    main()
