"""A profiler trace of the batch receiver (port of tools/profile_rx.py).

Runs ``detect_and_extract`` + ``rx_frames`` over B QPSK frames (through
AWGN of noise voltage 0.02) ``--steps`` times under ``torch.profiler``
(host activity, and the card's kernels and copies on a GPU) and writes a
Chrome trace, which Perfetto (ui.perfetto.dev) or chrome://tracing opens.
The program's own spans (``utils/trace``: ``rx.step`` around each step,
the stages and their parts inside) are written into the trace on a track
of their own ("program spans"), on the trace's clock: a
``record_function`` anchor before each step and after the last maps the
host clock the spans read onto it (the median of the anchors' offsets:
one anchor alone can be off by ~0.1 ms).
The first step, which builds the CUDA kernels, runs before the trace.
The last line is a JSON object naming the trace file and the device
kernels seen in it.

Usage: python -m gr_dtl_tpu_torch.tools.profile_rx [--out DIR] [--frames 256]
         [--frame-length 20] [--fec] [--steps 3] [--device cuda | --cpu]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from gr_dtl_tpu_torch.models import receiver, transmitter
from gr_dtl_tpu_torch.ops import channel
from gr_dtl_tpu_torch.tools import _cli, _timing
from gr_dtl_tpu_torch.tools.bench_fec import coded_build, qpsk_frames
from gr_dtl_tpu_torch.utils import config as cfgmod
from gr_dtl_tpu_torch.utils import trace

__all__ = ["trace_kernels", "add_spans", "main"]

ANCHOR = "program_spans.anchor"
SPAN_TID = 1 << 30  # the spans' track


def trace_kernels(path: str) -> collections.Counter:
    """Device kernel names of a Chrome trace, with their event counts."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter(e["name"] for e in events if e.get("cat") == "kernel")


def add_spans(path: str, spans, anchors_ns: list) -> int:
    """Write ``spans`` (``trace.export()``'s) into the Chrome trace at
    ``path`` on its clock: the ``ANCHOR`` ops, entered at host times
    ``anchors_ns`` in turn, start where the trace says.  Returns the spans
    written."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    marks = sorted((float(e["ts"]), e) for e in events
                   if e.get("name") == ANCHOR and e.get("cat") == "user_annotation")
    if len(marks) != len(anchors_ns):
        raise RuntimeError(f"{path}: {len(marks)} {ANCHOR} ops for {len(anchors_ns)} anchors")
    offset_us = statistics.median(ts - t * 1e-3 for (ts, _), t in zip(marks, anchors_ns))
    pid = marks[0][1]["pid"]
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID,
                   "args": {"name": "program spans"}})
    for s, t0, t1 in trace.on_clock(spans, 0, offset_us):
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": SPAN_TID,
                       "ts": t0, "dur": t1 - t0, "args": {"id": s.id, "parent": s.parent, "step": s.step}})
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(spans)


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.profile_rx")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "dtl_trace"),
                   help="directory the trace file goes to")
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--frame-length", type=int, default=20)
    p.add_argument("--fec", action="store_true", help="profile the coded path")
    p.add_argument("--steps", type=int, default=3, help="traced steps after the first")
    p.add_argument("--seed", type=int, default=0, help="seed of the pad and noise generator")
    _cli.add_device_args(p)
    args = p.parse_args(argv)
    dev = _cli.device_of(args)
    B = args.frames
    if args.fec:
        _, rxcfg, _, txp, rxp = coded_build(dev, args.frame_length)
    else:
        rxcfg = cfgmod.make_rx_config(None, frame_length=args.frame_length)
        txp = transmitter.build_tx(cfgmod.make_tx_config(None, frame_length=args.frame_length), dev)
        rxp = receiver.build_rx(rxcfg, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stream = channel.awgn(qpsk_frames(txp, B, np.random.RandomState(0), gen).reshape(-1), 0.02,
                          generator=gen)

    def rx_full():
        frames, _ = receiver.detect_and_extract(stream, rxcfg, B)
        return receiver.rx_frames(rxp, frames)

    rx_full()  # kernel builds and first-use work outside the trace
    _timing.sync(dev)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    anchors = []

    def anchor():
        anchors.append(time.perf_counter_ns())
        with torch.profiler.record_function(ANCHOR):
            pass

    trace.reset()
    trace.enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.steps):
                anchor()
                with trace.span("rx.step"):
                    out = rx_full()
            _timing.sync(dev)
            anchor()
    finally:
        trace.disable()
    spans = trace.export()["spans"]
    trace.reset()
    os.makedirs(args.out, exist_ok=True)
    mode = "coded" if args.fec else "plain"
    path = os.path.join(args.out, f"rx_{mode}_B{B}.trace.json")
    prof.export_chrome_trace(path)
    n_spans = add_spans(path, spans, anchors)
    kernels = trace_kernels(path)
    res = {"trace": path, "mode": mode, "steps": args.steps, "frames": B,
           "crc_ok_rate": float(out.crc_ok.float().mean()), "device": _timing.device_label(dev),
           "kernel_events": sum(kernels.values()), "kernels": sorted(kernels), "program_spans": n_spans}
    print(f"trace written to {path} ({mode} RX, {args.steps} steps, {B} frames a step); "
          f"open it with https://ui.perfetto.dev or chrome://tracing")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
