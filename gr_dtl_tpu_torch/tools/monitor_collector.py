"""Live telemetry collector: ZMQ SUB -> parse -> aggregate / JSONL (port
of tools/monitor_collector.py).

The external-collector end of the monitoring pipe: the modem publishes
protobuf/JSON telemetry over ZMQ PUB (``testbed.monitor.MonitorProbe``,
mirroring the reference's ``monitor_probe``); this tool subscribes,
decodes every message through the registry parser, and

- appends each message as one JSON line to ``--jsonl`` (the
  Grafana-ingest handoff; feed the file to ``tools/stats.py``), and/or
- prints a rolling aggregate every ``--every`` seconds: message rates
  per proto id, telemetry-channel loss (sent_counter gaps), SNR and
  frame-success summaries.

Needs pyzmq.  Examples:
    python -m gr_dtl_tpu_torch.tools.run_modem stream --zmq tcp://*:5550 ... &
    python -m gr_dtl_tpu_torch.tools.monitor_collector --connect tcp://localhost:5550 \\
        --jsonl telem.jsonl --count 200
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from gr_dtl_tpu_torch.testbed.collect import Collector

__all__ = ["main"]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.monitor_collector",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--connect", default="tcp://localhost:5550",
                    help="ZMQ SUB endpoint to connect to")
    ap.add_argument("--jsonl", default=None,
                    help="append every parsed message as a JSON line")
    ap.add_argument("--every", type=float, default=2.0,
                    help="seconds between aggregate printouts")
    ap.add_argument("--count", type=int, default=0,
                    help="exit after N messages (0 = run forever)")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="exit after this many seconds (0 = no limit)")
    args = ap.parse_args(argv)

    try:
        import zmq
    except ImportError:
        sys.exit("error: the collector needs pyzmq (the zmq module), which is not installed")

    ctx = zmq.Context.instance()
    sock = ctx.socket(zmq.SUB)
    sock.connect(args.connect)
    sock.setsockopt(zmq.SUBSCRIBE, b"")
    sock.setsockopt(zmq.RCVTIMEO, 250)

    col = Collector()
    sink = open(args.jsonl, "a") if args.jsonl else None
    t0 = time.monotonic()
    last_print = t0
    try:
        while True:
            now = time.monotonic()
            if args.timeout and now - t0 > args.timeout:
                break
            if args.count and col.n_received >= args.count:
                break
            try:
                blob = sock.recv()
            except zmq.Again:
                continue
            msg = col.feed(blob)
            if sink:
                json.dump(msg, sink, default=str)
                sink.write("\n")
            if now - last_print >= args.every:
                last_print = now
                s = col.summary()
                line = {"received": s["received"], "lost": s["lost"],
                        "rate_hz": round(col.n_received / (now - t0), 1)}
                if "frame_success_rate" in s:
                    line["frame_success_rate"] = round(s["frame_success_rate"], 4)
                snr = s["fields"].get("estimated_snr_tag_key")
                if snr:
                    line["snr_mean_db"] = round(snr["mean"], 2)
                print(json.dumps(line), file=sys.stderr)
    except KeyboardInterrupt:
        pass
    finally:
        if sink:
            sink.close()
        sock.close(0)
    print(json.dumps(col.summary(), default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
