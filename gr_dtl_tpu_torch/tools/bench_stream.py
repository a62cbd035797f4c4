"""Sustained streaming-session throughput (port of tools/bench_stream.py).

The batch benches time one receive step over a frame batch.  This times
the deployment shape, ``session.StreamRx`` fed block by block from the
host, with what a batch step does not pay for: the per-block upload of
raw samples, the carried tail / trigger-lock / fallback / frame-number
state, and the host loop.  The input is noiseless QPSK frames of the
port's transmitter (payloads from ``numpy.random.RandomState(--seed)``,
pad bytes from a ``torch.Generator`` seeded ``--seed``), 256 frames tiled
over as many blocks as a row needs.  Rows:

``accumulate``: ``StreamRx._dispatch`` block after block with no wait in
  the timed region: each block's CRC / header / validity counts are folded
  on the device, and its lost / received counts are read from the packed
  vector the session copies to pinned memory once that copy has arrived.
  The tiled stream's frame numbers jump back every 256 frames, which the
  12-bit gap count books as losses: ``lost`` counts those jumps.
``readback`` (on the CPU, or with ``--readback``): ``process`` reads every
  block back before the next (depth 1, ``StreamRx``) or one block late
  (depth 2, ``StreamRxPipelined``).
``device-stream`` (``--device-stream``): the stream is made and tiled on
  the device and each block's window is a view of it, handed to the block
  step: no per-block host-to-device copy is timed.
``mega-host`` / ``mega-device`` (``--mega FxK``): ``StreamRxMega``, K
  blocks of F frames a dispatch, fed from the host (or, with
  ``--device-stream``, views of the device stream).
``ingest`` (``--ingest``): the session's upload path alone (pinned ring,
  copy stream) a block, and serial against prefetched ingest
  (``StreamRx.prefetch``).  A failed upload raises.
``duplex``: ``StreamDuplex`` (two TX, an AWGN channel each way, two RX a
  step) with serialized and with pipelined readback.

Each timed region of ``--blocks`` blocks runs ``--reps`` times; a row
reports the median window (``tools/_timing``: CUDA events around the
region on a card, synchronized before and after).  A row whose CRC count
is not its valid-frame count ends the run with an error.

Usage: python -m gr_dtl_tpu_torch.tools.bench_stream [--sizes 16,64,256,1024]
         [--blocks 12] [--reps 3] [--readback] [--device-stream] [--mega FxK,...]
         [--ingest] [--duplex-steps 8] [--out FILE] [--device cuda | --cpu]
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import statistics
import sys
import time

import numpy as np
import torch

from gr_dtl_tpu_torch.models import session, transmitter
from gr_dtl_tpu_torch.ops import channel
from gr_dtl_tpu_torch.tools import _cli, _timing
from gr_dtl_tpu_torch.tools.bench_fec import qpsk_frames
from gr_dtl_tpu_torch.utils import config as cfgmod

__all__ = ["make_stream", "main"]

STREAM_FRAMES = 256
DEVICE_FRAMES = 64
WARMUP, MEGA_WARMUP, DUPLEX_WARMUP = 3, 2, 2  # untimed blocks (dispatches, steps) before a row


def make_stream(txcfg, n_frames: int, seed: int, dev) -> torch.Tensor:
    """n_frames noiseless QPSK frames as one contiguous stream on ``dev``."""
    txp = transmitter.build_tx(txcfg, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return qpsk_frames(txp, n_frames, np.random.RandomState(seed), gen).reshape(-1)


def block_chunks(stream: np.ndarray, block: int) -> list:
    """The distinct blocks of the stream tiled forever: block i is
    ``chunks[i % len(chunks)]``."""
    L = len(stream)
    period = L // math.gcd(block, L)
    return [np.take(stream, np.arange(i * block, (i + 1) * block), mode="wrap") for i in range(period)]


class _Fold:
    """A run's counts: CRC-ok, header-ok and valid frames folded on the
    device a block; lost / received frames from the blocks' packed vectors
    in pinned host memory, each booked once its copy has arrived (polled,
    never waited for, so that the session's pinned buffers are let go as
    they would be in its own readback)."""

    def __init__(self, dev):
        self.acc = torch.zeros(3, dtype=torch.int64, device=dev)
        self.pending, self.lost, self.received = [], 0, 0

    def add(self, inflight) -> None:
        out, valid = inflight.out, inflight.valid
        self.acc += torch.stack([(out.crc_ok & valid).sum(), (out.header_ok & valid).sum(), valid.sum()])
        self.pending.append(inflight)
        while self.pending and (self.pending[0].ready is None or self.pending[0].ready.query()):
            self._book(self.pending.pop(0))

    def _book(self, inflight) -> None:
        a = inflight.acct.numpy().reshape(-1, inflight.acct.shape[-1])
        self.lost += int(a[:, 0].sum())
        self.received += int(a[:, 1].sum())

    def totals(self) -> dict:
        a = self.acc.tolist()  # waits for the device
        for f in self.pending:
            self._book(f)
        self.pending = []
        return {"crc_ok": a[0], "header_ok": a[1], "valid_frames": a[2], "lost": self.lost,
                "received": self.received}


def _region(run_block, n: int, dev) -> float:
    """Seconds of n blocks (``_timing.window_ms``)."""
    return _timing.window_ms(run_block, n, dev) * n / 1e3


def _throughput(row: dict, samples: int, elapsed: list) -> dict:
    """The median window's rate, with every window's."""
    rates = [samples / e / 1e6 for e in elapsed]
    row.update(msamples_per_s=statistics.median(rates), region_elapsed_s=statistics.median(elapsed),
               windows_msamples_per_s=rates)
    return row


def bench_accumulate(rxcfg, stream, F, blocks, reps, dev, warmup=WARMUP) -> dict:
    rx = session.StreamRx(rxcfg, dev, frames_per_block=F)
    B = rx.block_samples
    chunks = block_chunks(stream, B)
    i = itertools.count()
    fold = _Fold(dev)
    step = lambda: fold.add(rx._dispatch(chunks[next(i) % len(chunks)]))
    for _ in range(warmup):
        step()
    _timing.sync(dev)
    fold = _Fold(dev)
    elapsed = [_region(step, blocks, dev) for _ in range(reps)]
    row = {"mode": "accumulate", "frames_per_block": F, "block_samples": B, "timed_blocks": blocks,
           "reps": reps}
    return {**_throughput(row, blocks * B, elapsed), **fold.totals()}


def bench_device_stream(rxcfg, txcfg, F, blocks, reps, seed, dev, warmup=WARMUP) -> dict:
    rx = session.StreamRx(rxcfg, dev, frames_per_block=F)
    S, T = rx.block_samples, rx.tail_len
    total = (warmup + blocks * reps) * S
    s = make_stream(txcfg, DEVICE_FRAMES, seed, dev)
    big = torch.cat([torch.zeros(T, dtype=torch.complex64, device=dev),
                     s.repeat(-(-total // s.shape[0]))[:total]])
    del s
    acc = torch.zeros(3, dtype=torch.int64, device=dev)
    state = {"i": 0, "carry": (rx._lock, rx._fallback, rx._expected_no)}

    def step():
        i = state["i"]
        out, valid, lock, fb, exp, _acct, _, _ = rx._step(big[i * S: i * S + T + S], *state["carry"])
        state["i"], state["carry"] = i + 1, (lock, fb, exp)
        acc.add_(torch.stack([(out.crc_ok & valid).sum(), (out.header_ok & valid).sum(), valid.sum()]))

    for _ in range(warmup):
        step()
    _timing.sync(dev)
    acc.zero_()
    elapsed = [_region(step, blocks, dev) for _ in range(reps)]
    a = acc.tolist()
    row = {"mode": "device-stream", "frames_per_block": F, "block_samples": S, "timed_blocks": blocks,
           "reps": reps, "note": "stream made and tiled on the device; each block is a view of it "
                                 "handed to the block step: no per-block host-to-device copy is timed"}
    # no "lost": the tiled frames repeat their numbers, which the 12-bit gap count books as losses
    return {**_throughput(row, blocks * S, elapsed), "crc_ok": a[0], "header_ok": a[1],
            "valid_frames": a[2]}


def bench_mega(rxcfg, stream, F, K, blocks, reps, dev, device_stream=None, warmup=MEGA_WARMUP) -> dict:
    """K blocks of F frames a dispatch: host-fed from ``stream``, or, with
    ``device_stream`` = (txcfg, seed), views of a stream made and tiled on
    the device."""
    rx = session.StreamRxMega(rxcfg, dev, frames_per_block=F, blocks_per_dispatch=K)
    D = rx.dispatch_samples
    if device_stream is None:
        chunks = block_chunks(stream, D)
        feed = lambda i: chunks[i % len(chunks)]
    else:
        total = (warmup + blocks * reps) * D
        s = make_stream(device_stream[0], DEVICE_FRAMES, device_stream[1], dev)
        big = s.repeat(-(-total // s.shape[0]))[:total]
        del s
        feed = lambda i: big[i * D: (i + 1) * D]
    i = itertools.count()
    fold = _Fold(dev)
    step = lambda: fold.add(rx._dispatch(feed(next(i))))
    for _ in range(warmup):
        step()
    _timing.sync(dev)
    fold = _Fold(dev)
    elapsed = [_region(step, blocks, dev) for _ in range(reps)]
    t = fold.totals()
    row = {"mode": "mega-host" if device_stream is None else "mega-device", "frames_per_block": F,
           "blocks_per_dispatch": K, "dispatch_samples": D, "timed_dispatches": blocks, "reps": reps}
    return {**_throughput(row, blocks * D, elapsed), "crc_ok": t["crc_ok"], "header_ok": t["header_ok"],
            "valid_frames": t["valid_frames"]}


def bench_ingest_cost(rxcfg, F, dev, n=16, reps=3) -> dict:
    """The session's upload of a block (``StreamRx._ingest``: the pinned
    ring and the copy stream on a card), each upload consumed by a small
    reduction on the device so that it must complete."""
    rx = session.StreamRx(rxcfg, dev, frames_per_block=F)
    block = rx.block_samples
    buf = (np.random.RandomState(0).randn(2 * block).astype(np.float32).view(np.complex64))
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    step = lambda: acc.add_(rx._ingest(buf)[:: max(1, block // 64)].abs().sum())
    step()
    _timing.sync(dev)
    ms = [_timing.window_ms(step, n, dev) for _ in range(reps)]
    if not math.isfinite(float(acc)):
        raise RuntimeError("ingest: the uploaded blocks do not hold the host's samples")
    med = statistics.median(ms)
    return {"mode": "ingest-cost", "block_samples": block, "block_bytes": buf.nbytes, "uploads": n,
            "reps": reps, "h2d_ms_per_block": med, "h2d_mbytes_per_s": buf.nbytes / med / 1e3,
            "windows_ms": ms}


def bench_ingest_ab(rxcfg, stream, F, blocks, reps, dev, warmup=WARMUP) -> list:
    """Serial ingest (each block's upload inside its dispatch) against
    prefetched ingest (block k+1's upload started right after block k's
    dispatch, overlapping its compute)."""
    rows = []
    for mode in ("serialized", "prefetch"):
        rx = session.StreamRx(rxcfg, dev, frames_per_block=F)
        B = rx.block_samples
        chunks = block_chunks(stream, B)
        state = {"i": 0, "next": None}
        fold = _Fold(dev)

        def step():
            i = state["i"]
            if mode == "prefetch":
                handle = state["next"] or rx.prefetch(chunks[i % len(chunks)])
                state["next"] = rx.prefetch(chunks[(i + 1) % len(chunks)])
            else:
                handle = chunks[i % len(chunks)]
            fold.add(rx._dispatch(handle))
            state["i"] = i + 1

        for _ in range(warmup):
            step()
        _timing.sync(dev)
        fold = _Fold(dev)
        elapsed = [_region(step, blocks, dev) for _ in range(reps)]
        t = fold.totals()
        row = {"mode": f"ingest-{mode}", "frames_per_block": F, "block_samples": B, "timed_blocks": blocks,
               "reps": reps}
        rows.append({**_throughput(row, blocks * B, elapsed), "crc_ok": t["crc_ok"],
                     "valid_frames": t["valid_frames"]})
    return rows


def bench_readback(rxcfg, stream, F, blocks, reps, dev, warmup=WARMUP, depth=1) -> dict:
    """``process`` every block: depth 1 reads each block back before the
    next; depth 2 one block late.  Depth 1's rate is the median block's,
    depth 2's the median window's (its calls alternate dispatch-only and
    readback, so only a whole region means something)."""
    rx = (session.StreamRxPipelined(rxcfg, dev, frames_per_block=F, depth=depth) if depth > 1
          else session.StreamRx(rxcfg, dev, frames_per_block=F))
    B = rx.block_samples
    chunks = block_chunks(stream, B)
    n = 0
    for _ in range(warmup):
        rx.process(chunks[n % len(chunks)])
        n += 1
    if depth > 1:
        rx.drain()
    times, elapsed, results = [], [], []
    for _ in range(reps):
        t_region = time.perf_counter()
        for _ in range(blocks):
            t0 = time.perf_counter()
            r = rx.process(chunks[n % len(chunks)])
            n += 1
            times.append(time.perf_counter() - t0)
            if r is not None:
                results.append(r)
        if depth > 1:
            results.extend(rx.drain())
        elapsed.append(time.perf_counter() - t_region)
    _, last_valid = results[-1]
    med = statistics.median(times)
    row = {"mode": "readback", "frames_per_block": F, "pipeline_depth": depth, "block_samples": B,
           "timed_blocks": blocks, "reps": reps}
    _throughput(row, blocks * B, elapsed)
    if depth == 1:
        row["msamples_per_s"] = B / med / 1e6
    row.update(sec_per_block_median=med, sec_per_block_mean=float(np.mean(times)),
               sec_per_block_max=float(np.max(times)),
               final_block_crc_ok=int((last_valid.crc_ok & last_valid).sum()),
               final_block_frames=int(last_valid.sum()),
               crc_ok=int(sum(int((v.crc_ok & v).sum()) for _, v in results)),
               valid_frames=int(sum(int(v.sum()) for _, v in results)))
    return row


def bench_duplex(cfg, rxcfg, F, steps, dev, warmup=DUPLEX_WARMUP, serialize_readback=False) -> dict:
    """``StreamDuplex``: a block each way a step through AWGN of noise
    voltage 0.02, wall time a step (each step reads both directions back)."""
    gen = torch.Generator(device=dev).manual_seed(17)
    chan = lambda x: channel.awgn(torch.as_tensor(x, device=dev), 0.02, generator=gen)
    dpx = session.StreamDuplex(cfg, rxcfg, cfg, rxcfg, chan, chan, dev, frames_per_block=F,
                               serialize_readback=serialize_readback)
    rng = np.random.RandomState(3)
    for _ in range(4 * (warmup + steps)):
        dpx.tx_a.send(rng.randint(0, 256, 64).astype(np.uint8).tobytes())
        dpx.tx_b.send(rng.randint(0, 256, 64).astype(np.uint8).tobytes())
    for _ in range(warmup):
        dpx.step()
    times, n_ok = [], 0
    for _ in range(steps):
        t0 = time.perf_counter()
        r = dpx.step()
        times.append(time.perf_counter() - t0)
        if r is None:
            raise RuntimeError("duplex: the sessions stopped before the timed steps ended")
        n_ok += sum((r[k] or {}).get("n_ok", 0) for k in ("ctl_a", "ctl_b"))
    med = statistics.median(times)
    spb = dpx.tx_a.block_samples + dpx.tx_b.block_samples  # one block each way
    return {"frames_per_block": F, "steps": steps,
            "readback": "serialized" if serialize_readback else "pipelined",
            "msamples_per_s": spb / med / 1e6, "sec_per_step_median": med,
            "sec_per_step_max": float(np.max(times)), "frames_header_ok": n_ok,
            "frames_sent": 2 * F * steps}


def _latency_cols(r: dict) -> dict:
    """dispatch_ms: wall ms of one dispatch at the row's rate;
    buffer_ms_at_700kss: stream ms one dispatch's samples span at the
    reference's 700 kS/s TX rate (ofdm_adaptive_config.py:51)."""
    d = r.get("dispatch_samples", r.get("block_samples"))
    if d and r.get("msamples_per_s"):
        r["dispatch_ms"] = d / (r["msamples_per_s"] * 1e6) * 1e3
        r["buffer_ms_at_700kss"] = d / 700e3 * 1e3
    return r


def _crc_clean(r: dict, what: str) -> None:
    if r["crc_ok"] != r["valid_frames"]:
        sys.exit(f"error: CRC failures in the {what}: {r['crc_ok']} of {r['valid_frames']} valid "
                 f"frames passed ({r})")


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.bench_stream")
    p.add_argument("--frame-length", type=int, default=20)
    p.add_argument("--blocks", type=int, default=12, help="timed blocks a window")
    p.add_argument("--reps", type=int, default=3, help="timed windows a row (median)")
    p.add_argument("--sizes", default="16,64,256,1024", help="frames-per-block sweep")
    p.add_argument("--duplex-steps", type=int, default=8)
    p.add_argument("--duplex-frames", type=int, default=16)
    p.add_argument("--readback", action="store_true",
                   help="also run the per-block-readback rows on a card")
    p.add_argument("--device-stream", action="store_true",
                   help="rows fed from a stream made and kept on the device")
    p.add_argument("--mega", default=None,
                   help="megastep rows as FxK pairs (e.g. 16x8,16x64): K blocks of F frames a "
                        "dispatch (StreamRxMega)")
    p.add_argument("--ingest", action="store_true",
                   help="ingest rows: upload cost a block, and serial vs prefetched ingest")
    p.add_argument("--no-duplex-ab", action="store_true", help="skip the serialized-readback duplex row")
    p.add_argument("--stream-cache", default=None,
                   help="npy path: reuse/persist the generated input stream")
    p.add_argument("--seed", type=int, default=0, help="seed of the payloads and pad bytes")
    p.add_argument("--out", default=None)
    _cli.add_device_args(p)
    args = p.parse_args(argv)
    dev = _cli.device_of(args)
    txcfg = cfgmod.make_tx_config(None, frame_length=args.frame_length)
    rxcfg = cfgmod.make_rx_config(None, frame_length=args.frame_length)

    stream = None
    if not args.device_stream:
        if args.stream_cache and os.path.exists(args.stream_cache):
            stream = np.load(args.stream_cache)
        else:
            stream = make_stream(txcfg, STREAM_FRAMES, args.seed, dev).cpu().numpy()
            if args.stream_cache:
                np.save(args.stream_cache, stream)
    emit = lambda metric, r: print(json.dumps({"metric": metric, **r}), flush=True)
    rows = []
    for F in (int(x) for x in args.sizes.split(",")):
        if args.device_stream:
            r = bench_device_stream(rxcfg, txcfg, F, args.blocks, args.reps, args.seed, dev)
        else:
            r = bench_accumulate(rxcfg, stream, F, args.blocks, args.reps, dev)
        _crc_clean(r, "streamed decode")
        rows.append(_latency_cols(r))
        emit("stream_rx_throughput", r)
        if (dev.type == "cpu" or args.readback) and stream is not None:
            for depth in (1, 2):
                r = bench_readback(rxcfg, stream, F, args.blocks, args.reps, dev, depth=depth)
                _crc_clean(r, "streamed decode")
                rows.append(_latency_cols(r))
                emit("stream_rx_throughput", r)

    if args.mega:
        for pair in args.mega.split(","):
            F, K = (int(x) for x in pair.lower().split("x"))
            r = bench_mega(rxcfg, stream, F, K, args.blocks, args.reps, dev,
                           device_stream=(txcfg, args.seed) if args.device_stream else None)
            _crc_clean(r, "megastep decode")
            rows.append(_latency_cols(r))
            emit("stream_rx_throughput", r)

    ingest_rows = []
    if args.ingest:
        F0 = int(args.sizes.split(",")[0])
        ingest_rows.append(bench_ingest_cost(rxcfg, F0, dev, reps=args.reps))
        emit("stream_ingest", ingest_rows[-1])
        if stream is not None:
            for r in bench_ingest_ab(rxcfg, stream, F0, args.blocks, args.reps, dev):
                _crc_clean(r, "ingest A/B decode")
                ingest_rows.append(_latency_cols(r))
                emit("stream_ingest", r)

    dpx_rows = []
    if args.duplex_steps > 0:
        for ser in ([False] if args.no_duplex_ab else [True, False]):
            d = bench_duplex(txcfg, rxcfg, args.duplex_frames, args.duplex_steps, dev,
                             serialize_readback=ser)
            dpx_rows.append(d)
            emit("stream_duplex_throughput", d)

    best = max(rows, key=lambda r: r["msamples_per_s"])
    result = {
        "platform": dev.type,
        "device": _timing.device_label(dev),
        "frame_length": args.frame_length,
        "stream_rx": rows,
        "stream_ingest": ingest_rows,
        "stream_duplex": dpx_rows,
        "best_msamples_per_s": best["msamples_per_s"],
        "best_frames_per_block": best["frames_per_block"],
        "best_mode": best["mode"],
        "note": "host-loop streaming session: per-block upload through the pinned ring, carried "
                "tail/lock state.  accumulate rows fold the accounting on the device and wait once "
                "a window; readback rows read every block back: depth 1 serialized, depth 2 "
                "pipelined (StreamRxPipelined).  duplex rows compare serialized and pipelined "
                "cross-direction readback.  " + _timing.describe(dev, args.blocks, args.reps)
                + " (readback depth 1 and duplex: time.perf_counter a call)",
    }
    print(json.dumps({"metric": "stream_rx_best", "value": best["msamples_per_s"],
                      "unit": "Msamples/s"}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
