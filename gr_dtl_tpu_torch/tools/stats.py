"""Offline telemetry statistics, the reference's log.sh + stats.r (port of
tools/stats.py).

Reads a JSONL telemetry capture (from ``monitor_collector --jsonl`` or any
file of one-JSON-dict-per-line messages) and prints, per numeric field,
the reference ``stats.r`` summary columns (min/max/median/mean/sd) plus
the ``log.sh`` frame-success-rate mining.

    python -m gr_dtl_tpu_torch.tools.stats telem.jsonl
    python -m gr_dtl_tpu_torch.tools.stats telem.jsonl --field estimated_snr_tag_key
    cat telem.jsonl | python -m gr_dtl_tpu_torch.tools.stats -
"""

from __future__ import annotations

import argparse
import json
import sys

from gr_dtl_tpu_torch.testbed.collect import frame_success, load_jsonl, summarize

__all__ = ["main"]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.stats",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("jsonl", help="telemetry JSONL file, or - for stdin")
    ap.add_argument("--field", action="append", default=None,
                    help="restrict to these fields (repeatable)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    args = ap.parse_args(argv)

    if args.jsonl == "-":
        msgs = [json.loads(line) for line in sys.stdin if line.strip()]
    else:
        msgs = load_jsonl(args.jsonl)

    fields = summarize(msgs)
    if args.field:
        fields = {k: v for k, v in fields.items() if k in set(args.field)}
    fs = frame_success(msgs)

    if args.json:
        print(json.dumps({"messages": len(msgs), "fields": fields, "frame_success_rate": fs}))
        return 0

    print(f"{len(msgs)} messages")
    if fs is not None:
        print(f"frame success rate: {fs:.4f}")
    if fields:
        w = max(len(k) for k in fields)
        print(f"{'field'.ljust(w)}  {'n':>6} {'min':>10} {'max':>10} "
              f"{'median':>10} {'mean':>10} {'sd':>10}")
        for k, s in sorted(fields.items()):
            print(f"{k.ljust(w)}  {s['n']:>6} {s['min']:>10.4g} "
                  f"{s['max']:>10.4g} {s['median']:>10.4g} "
                  f"{s['mean']:>10.4g} {s['sd']:>10.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
