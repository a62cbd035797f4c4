"""Two-process modem link over a real byte stream (TCP samples); port of
tools/sample_link.py.

The live-I/O counterpart of the reference's Pluto examples: two OS
processes exchange complex64 samples over a duplex TCP connection, forward
OFDM frames one way and the reverse feedback-burst capture the other,
through the ``testbed/sample_io`` source/sink boundary that a real SDR front
end would plug into.

  TX node:  StreamTx --> sink  |  source --> StreamBurstRx --> MCS switch
  RX node:  source --> (AWGN) --> StreamRx --> MCS decision --> burst --> sink

The protocol is strictly alternating per block (TX: write fwd, read rev;
RX: read fwd, write rev), so the link is deadlock-free for any block size.
AWGN is added on the host at the RX (the "RF channel" of this wired setup);
the adaptation loop must climb the MCS ladder from BPSK to whatever the
configured SNR supports, through decoded feedback bursts flowing back over
the socket.  The MCS decision over a block's decoded frames is
``adaptive.feedback_scan_masked``: one launch of the K7 kernel on a card.

Full-duplex mode (--duplex-a / --duplex-b): each node runs a ``StreamTx``
AND a ``StreamRx``; OFDM frames flow both ways over the same socket and
adaptation is in-band through the header echo: each node's RX SNR drives
its MCS decision, which rides its outgoing headers as
``feedback_constellation`` and, decoded by the peer, switches the peer's TX
constellation.

Modes:
  --tx / --rx               one simplex node (connect/listen per --port/--host)
  --duplex-a / --duplex-b   one full-duplex node (a connects, b listens)
  --loopback-test           spawn both simplex nodes as ``python -m
                            gr_dtl_tpu_torch.tools.sample_link`` processes on
                            localhost, collect their JSON reports, check
                            CRC-clean decode, --out
  --duplex-test             the same for the full-duplex pair (both
                            directions CRC-clean, both adaptation loops
                            converged)

Every node runs on ``--device`` (cuda by default; ``--cpu`` for the CPU):
without a card a cuda node exits with an error, and the test modes pass
their own device to both nodes, so two node processes share one card.  The
RX-side AWGN and the burst offsets come from ``np.random.RandomState(seed +
1)`` as in the reference, so both packages add the same noise; the TX pad
bytes come from a ``torch.Generator`` seeded from ``--seed`` (the
reference's come from ``jax.random``), so the sample streams differ in the
frames' pad bytes.  Each node's report adds ``blocks``, its device, and its
median ms a block (``wall_ms_per_block``, socket waits included;
``work_ms_per_block``, the node's own work between reads).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gr_dtl_tpu_torch.models import adaptive, session
from gr_dtl_tpu_torch.ops import burst
from gr_dtl_tpu_torch.testbed import sample_io
from gr_dtl_tpu_torch.tools import _cli
from gr_dtl_tpu_torch.utils import config as cfgmod

__all__ = ["main", "tx_node", "rx_node", "duplex_node", "loopback_test", "duplex_test",
           "NODE_CMD"]

PKG_ROOT = Path(__file__).resolve().parents[2]  # the directory that holds gr_dtl_tpu_torch
NODE_CMD = (sys.executable, "-m", "gr_dtl_tpu_torch.tools.sample_link")


def _noise_voltage(snr_db) -> float:
    # signal power of the modulated stream is ~0.81 (pilot + data mix)
    return 0.0 if snr_db is None else float(np.sqrt(0.81 / 10 ** (snr_db / 10)))


def _awgn(chunk: np.ndarray, noise_v: float, rng: np.random.RandomState) -> np.ndarray:
    """The RX node's host-side channel, drawn as the reference draws it."""
    if noise_v <= 0:
        return chunk
    return chunk + (noise_v / np.sqrt(2)) * (
        rng.standard_normal(len(chunk)) + 1j * rng.standard_normal(len(chunk))
    ).astype(np.complex64)


class _Clock:
    """A node loop's wall time a block and its own work (the wall time less
    the blocking socket reads), each the median over the blocks: the first
    block also pays the device's warm-up."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.waiting = 0.0
        self.walls, self.works = [], []

    def read(self, source, n: int) -> np.ndarray:
        t = time.perf_counter()
        out = source.read(n)
        self.waiting += time.perf_counter() - t
        return out

    def tick(self) -> None:
        """A block ended."""
        now = time.perf_counter()
        self.walls.append(now - self.t0)
        self.works.append(now - self.t0 - self.waiting)
        self.t0, self.waiting = now, 0.0

    def report(self) -> dict:
        med = lambda xs: round(float(np.median(xs)) * 1e3, 3) if xs else None
        return {"wall_ms_per_block": med(self.walls), "work_ms_per_block": med(self.works)}


class _Decider:
    """The RX side's MCS decision over a block's decoded frames."""

    def __init__(self, rxcfg, dev):
        self.tables = adaptive.build_mcs_tables(rxcfg)
        self._tables_dev = adaptive.tables_to(self.tables, dev)
        self.state = adaptive.initial_state(rxcfg.initial_mcs_id, (), dev)
        self.dev = dev

    def __call__(self, snr_db: torch.Tensor, ok: np.ndarray) -> int:
        """The MCS id decided at the last decoded frame of the block."""
        self.state, mcs_seq = adaptive.feedback_scan_masked(
            self.state, snr_db, torch.as_tensor(np.asarray(ok), device=self.dev), self._tables_dev)
        return int(mcs_seq.cpu().numpy()[np.nonzero(ok)[0][-1]])


def _count(out, valid) -> tuple:
    """(frames, header_ok, payload frames, payload CRC ok) of one block, and
    the mask of decoded frames.  The CRC gate only counts frames that carry
    payload (empty keepalive frames have no CRC to pass)."""
    ok = np.asarray(valid.header_ok & valid)
    has_payload = out.payload_len.cpu().numpy() > 0
    return (int(np.asarray(valid).sum()), int(ok.sum()), int((ok & has_payload).sum()),
            int((valid.crc_ok & ok & has_payload).sum())), ok


def tx_node(args) -> None:
    dev = _cli.device_of(args)
    cfg = cfgmod.make_tx_config(args.config, frame_length=args.frame_length,
                                max_empty_frames=2 * args.frames_per_block)
    tx = session.StreamTx(cfg, dev, frames_per_block=args.frames_per_block, seed=args.seed)
    brx = session.StreamBurstRx(args.rev_block, dev)

    rng = np.random.RandomState(args.seed)
    for _ in range(args.pdus):
        tx.send(rng.randint(0, 256, args.pdu_bytes).astype(np.uint8).tobytes())

    ep = sample_io.connect(args.host, args.port, timeout=120.0)
    clock = _Clock()
    blocks = 0
    fb_applied = []
    try:
        while True:
            blk = tx.next_block()
            if blk is None:
                break
            ep.sink.write(blk[0])
            rev = clock.read(ep.source, args.rev_block)
            if len(rev) < args.rev_block:
                break  # peer hung up
            bout = brx.process(rev)
            okb = bout.ok.cpu().numpy()
            if okb.any():
                i = int(np.nonzero(okb)[0][-1])
                cnst = int(bout.cnst_id.cpu().numpy()[i])
                tx.set_feedback(cnst)
                fb_applied.append(cnst)
            blocks += 1
            clock.tick()
    finally:
        ep.close()
    print("TX_RESULT " + json.dumps({
        "blocks": blocks,
        "samples_sent": int(ep.sink.n_written),
        "pdus": args.pdus,
        "feedback_applied": fb_applied,
        "final_cnst": tx.constellation,
        "device": str(dev),
        **clock.report(),
    }), flush=True)


def rx_node(args) -> None:
    dev = _cli.device_of(args)
    rxcfg = cfgmod.make_rx_config(args.config, frame_length=args.frame_length)
    rx = session.StreamRx(rxcfg, dev, frames_per_block=args.frames_per_block)
    decide = _Decider(rxcfg, dev)
    modem = burst.build_burst_modem(dev)
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)

    srv, port = sample_io.listen(args.host, args.port)
    print(f"RX_LISTENING {port}", flush=True)
    ep = sample_io.accept_endpoint(srv, timeout=120.0)
    srv.close()

    rng = np.random.RandomState(args.seed + 1)
    noise_v = _noise_voltage(args.snr_db)
    totals = np.zeros(4, np.int64)  # frames, header_ok, payload frames, payload CRC ok
    want_hist = []
    clock = _Clock()
    blocks = 0
    try:
        while True:
            chunk = clock.read(ep.source, rx.block_samples)
            if len(chunk) < rx.block_samples:
                break  # EOF: TX finished
            out, valid = rx.process(_awgn(chunk, noise_v, rng))
            counts, ok = _count(out, valid)
            totals += counts
            rev = np.zeros(args.rev_block, np.complex64)
            if ok.any():
                mcs = decide(out.snr_db, ok)
                want = int(decide.tables["cnst"][mcs])
                want_hist.append(want)
                wave = burst.burst_tx(i32(want), i32(int(decide.tables["fec"][mcs])), modem,
                                      pad=0)[0].cpu().numpy()
                off = rng.randint(0, args.rev_block - len(wave))
                rev[off: off + len(wave)] = wave
            ep.sink.write(rev)
            blocks += 1
            clock.tick()
    finally:
        ep.close()
    print("RX_RESULT " + json.dumps({
        "frames": int(totals[0]),
        "header_ok": int(totals[1]),
        "payload_frames": int(totals[2]),
        "payload_crc_ok": int(totals[3]),
        "lost_frame_rate": rx.lost_frame_rate,
        "want_final": want_hist[-1] if want_hist else None,
        "want_hist": want_hist[:64],
        "samples_received": int(ep.source.n_read),
        "blocks": blocks,
        "device": str(dev),
        **clock.report(),
    }), flush=True)


def duplex_node(args, initiator: bool) -> None:
    """One full-duplex node: StreamTx + StreamRx over one socket, in-band
    echo adaptation."""
    dev = _cli.device_of(args)
    role = "a" if initiator else "b"
    seed = args.seed + (0 if initiator else 1)
    txcfg = cfgmod.make_tx_config(args.config, frame_length=args.frame_length,
                                  max_empty_frames=4 * args.frames_per_block)
    rxcfg = cfgmod.make_rx_config(args.config, frame_length=args.frame_length)
    tx = session.StreamTx(txcfg, dev, frames_per_block=args.frames_per_block, seed=seed)
    rx = session.StreamRx(rxcfg, dev, frames_per_block=args.frames_per_block)
    decide = _Decider(rxcfg, dev)

    rng = np.random.RandomState(seed)
    for _ in range(args.pdus):
        tx.send(rng.randint(0, 256, args.pdu_bytes).astype(np.uint8).tobytes())

    if initiator:
        ep = sample_io.connect(args.host, args.port, timeout=120.0)
    else:
        srv, port = sample_io.listen(args.host, args.port)
        print(f"RX_LISTENING {port}", flush=True)
        ep = sample_io.accept_endpoint(srv, timeout=120.0)
        srv.close()

    noise_v = _noise_voltage(args.snr_db)
    totals = np.zeros(4, np.int64)
    blocks = 0
    want_hist = []  # local decisions about the incoming link
    applied_hist = []  # peer echoes applied to the outgoing link
    clock = _Clock()
    try:
        while True:
            if initiator:
                blk = tx.next_block()
                if blk is None:
                    break
                ep.sink.write(blk[0])
                chunk = clock.read(ep.source, rx.block_samples)
                if len(chunk) < rx.block_samples:
                    break
            else:
                chunk = clock.read(ep.source, rx.block_samples)
                if len(chunk) < rx.block_samples:
                    break
                blk = tx.next_block()
                if blk is None:
                    break
                ep.sink.write(blk[0])
            blocks += 1
            out, valid = rx.process(_awgn(chunk, noise_v, rng))
            counts, ok = _count(out, valid)
            totals += counts
            if ok.any():
                # local decision -> echo in our headers (the peer switches);
                # the peer's echo in its headers -> our TX MCS
                want = int(decide.tables["cnst"][decide(out.snr_db, ok)])
                want_hist.append(want)
                tx.set_feedback_echo(want)
                echoes = out.feedback_cnst.cpu().numpy()[ok]
                echoes = echoes[echoes > 0]
                if echoes.size:
                    applied = int(echoes[-1])
                    tx.set_feedback(applied)
                    applied_hist.append(applied)
            clock.tick()
    finally:
        ep.close()
    print(f"DPX_{role.upper()}_RESULT " + json.dumps({
        "role": role,
        "blocks": blocks,
        "frames": int(totals[0]),
        "header_ok": int(totals[1]),
        "payload_frames": int(totals[2]),
        "payload_crc_ok": int(totals[3]),
        "lost_frame_rate": rx.lost_frame_rate,
        "final_tx_cnst": tx.constellation,
        "want_final": want_hist[-1] if want_hist else None,
        "want_hist": want_hist[:64],
        "applied_hist": applied_hist[:64],
        "samples_sent": int(ep.sink.n_written),
        "samples_received": int(ep.source.n_read),
        "device": str(dev),
        **clock.report(),
    }), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(args, listener: list, connector: list, tags: tuple, node_cmd) -> tuple:
    """Start the listening node, then (once it listens) the connecting one;
    returns both nodes' result dicts.  A node that fails ends the run."""
    port = _free_port()
    base = [*node_cmd, "--port", str(port),
            "--frames-per-block", str(args.frames_per_block),
            "--frame-length", str(args.frame_length),
            "--pdus", str(args.pdus), "--pdu-bytes", str(args.pdu_bytes),
            "--seed", str(args.seed), "--device", str(_cli.device_of(args))]
    if args.config:
        base += ["--config", args.config]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(PKG_ROOT), env.get("PYTHONPATH")) if p)
    spawn = lambda extra: subprocess.Popen(base + extra, env=env, cwd=PKG_ROOT,
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lp = spawn(listener)
    cp = None
    try:
        head = []
        for line in lp.stdout:
            head.append(line)
            if line.startswith("RX_LISTENING"):
                break
        else:
            lp.wait()
            sys.stderr.write("".join(head))
            raise SystemExit(f"the listening node exited {lp.returncode} before it listened")
        cp = spawn(connector)
        c_out = cp.communicate(timeout=1200)[0]
        l_out = "".join(head) + lp.communicate(timeout=300)[0]
    finally:
        for p in (lp, cp):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    if cp.returncode != 0 or lp.returncode != 0:
        sys.stderr.write(f"--- {tags[1]} ---\n{c_out}\n--- {tags[0]} ---\n{l_out}\n")
        raise SystemExit("node process failed")
    parse = lambda out, tag: json.loads(
        [ln for ln in out.splitlines() if ln.startswith(tag + " ")][-1][len(tag) + 1:])
    return parse(l_out, tags[0]), parse(c_out, tags[1]), port


def duplex_test(args, node_cmd=NODE_CMD) -> dict:
    """Spawn two full-duplex nodes; check that both directions decode
    CRC-clean and both in-band adaptation loops converged.  ``node_cmd``:
    the command that starts a node (it is given the node's flags)."""
    snr = ["--snr-db", str(args.snr_db)] if args.snr_db is not None else []
    b, a, port = _run_pair(args, ["--duplex-b"] + snr, ["--duplex-a"] + snr,
                           ("DPX_B_RESULT", "DPX_A_RESULT"), node_cmd)
    result = {
        "transport": "tcp sample stream (complex64), OFDM both ways, in-band echo adaptation",
        "port": port,
        "a": a,
        "b": b,
        # each node's TX ends on the constellation the PEER decided for that
        # link (peer's want == our final TX MCS)
        "adaptation_converged_ab": b["want_final"] is not None
                                   and a["final_tx_cnst"] == b["want_final"],
        "adaptation_converged_ba": a["want_final"] is not None
                                   and b["final_tx_cnst"] == a["want_final"],
        "crc_clean_ab": b["payload_frames"] > 0 and b["payload_crc_ok"] == b["payload_frames"],
        "crc_clean_ba": a["payload_frames"] > 0 and a["payload_crc_ok"] == a["payload_frames"],
    }
    print(json.dumps(result, indent=2), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    for key, what in (("crc_clean_ab", "A->B payload CRC failures"),
                      ("crc_clean_ba", "B->A payload CRC failures"),
                      ("adaptation_converged_ab", "A->B adaptation diverged"),
                      ("adaptation_converged_ba", "B->A adaptation diverged")):
        if not result[key]:
            raise SystemExit(what)
    return result


def loopback_test(args, node_cmd=NODE_CMD) -> dict:
    """Spawn the RX (listener) and TX (connector) nodes on localhost and
    check the link: CRC-clean payload decode.  ``node_cmd``: the command
    that starts a node (it is given the node's flags)."""
    snr = ["--snr-db", str(args.snr_db)] if args.snr_db is not None else []
    rx, tx, port = _run_pair(args, ["--rx"] + snr, ["--tx"], ("RX_RESULT", "TX_RESULT"), node_cmd)
    result = {
        "transport": "tcp sample stream (complex64), duplex",
        "port": port,
        "tx": tx,
        "rx": rx,
        "adaptation_converged": rx["want_final"] == tx["final_cnst"]
                                and tx["final_cnst"] is not None,
        "crc_clean": rx["payload_frames"] > 0 and rx["payload_crc_ok"] == rx["payload_frames"],
    }
    print(json.dumps(result, indent=2), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    if not result["crc_clean"]:
        raise SystemExit("payload CRC failures over the link")
    if not (tx["blocks"] > 0 and rx["frames"] > 0):
        raise SystemExit("the link moved no frame")
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.sample_link",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tx", action="store_true")
    ap.add_argument("--rx", action="store_true")
    ap.add_argument("--duplex-a", action="store_true")
    ap.add_argument("--duplex-b", action="store_true")
    ap.add_argument("--loopback-test", action="store_true")
    ap.add_argument("--duplex-test", action="store_true")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=5660)
    ap.add_argument("--config", default=None)
    ap.add_argument("--frames-per-block", type=int, default=8)
    ap.add_argument("--frame-length", type=int, default=10)
    ap.add_argument("--rev-block", type=int, default=4096)
    ap.add_argument("--pdus", type=int, default=64)
    ap.add_argument("--pdu-bytes", type=int, default=40)
    ap.add_argument("--snr-db", type=float, default=None,
                    help="inject AWGN at the RX (default: clean wire)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    _cli.add_device_args(ap)
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.tx:
        tx_node(args)
    elif args.rx:
        rx_node(args)
    elif args.duplex_a:
        duplex_node(args, initiator=True)
    elif args.duplex_b:
        duplex_node(args, initiator=False)
    elif args.duplex_test:
        duplex_test(args)
    else:
        loopback_test(args)


if __name__ == "__main__":
    main()
