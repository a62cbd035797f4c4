"""Interleaved A/B of the batch-wide-exit BP (``ldpc.decode_mm``) against
the two-pass straggler schedule (``ldpc.decode_mm_twopass``) (port of
tools/bench_twopass.py).

Both variants decode the same LLR tensor on the device, in turns (mm
window, twopass window, ...) ``--reps`` times; medians decide.  Regimes:
clean (every codeword converges at entry or in an iteration or two), knee
(~96% converge, the stragglers run the whole budget, where a straggler
schedule could win) and waterfall (most never converge, where it cannot).
Codewords of the n=300/k=152 code from ``numpy.random.RandomState(0)``,
noise from a ``torch.Generator`` seeded ``--seed``.

Usage: python -m gr_dtl_tpu_torch.tools.bench_twopass [--reps 5] [--iters 8]
         [--cw 2048] [--first 3] [--bucket N] [--out FILE] [--device cuda | --cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from gr_dtl_tpu_torch.ops import ldpc
from gr_dtl_tpu_torch.tools import _cli, _ldpc_bench, _timing

__all__ = ["REGIMES", "main"]

REGIMES = {"clean": (4.0, 0.5), "knee": (1.6, 1.0), "waterfall": (1.3, 1.0)}


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.bench_twopass")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--iters", type=int, default=8, help="decode steps a timed window")
    p.add_argument("--cw", type=int, default=2048)
    p.add_argument("--first", type=int, default=3, help="pass-1 iteration budget")
    p.add_argument("--bucket", type=int, default=None)
    p.add_argument("--seed", type=int, default=2, help="seed of the noise generator")
    p.add_argument("--out", default=None)
    _cli.add_device_args(p)
    args = p.parse_args(argv)
    dev = _cli.device_of(args)
    code = ldpc.ldpc_from_reference(ldpc.build_ldpc(_ldpc_bench.n300()), dev)
    CW = args.cw
    cws = _ldpc_bench.codewords(code, CW, np.random.RandomState(0))
    result = {"metric": "bp_twopass_ab", "platform": dev.type, "device": _timing.device_label(dev),
              "reps": args.reps, "iters_per_rep": args.iters, "cw": CW, "first": args.first,
              "bucket": args.bucket or max(128, CW // 8), "code": f"n={code.N} k={code.K}",
              "schedule": "interleaved mm/twopass windows; " + _timing.describe(dev, args.iters, args.reps),
              "regimes": {}}
    for name, (amp, sigma) in REGIMES.items():
        llr = _ldpc_bench.regime_llrs(cws, amp, sigma, args.seed)
        fns = {"mm": lambda: ldpc.decode_mm(llr, code, 15),
               "twopass": lambda: ldpc.decode_mm_twopass(llr, code, 15, first=args.first,
                                                         bucket=args.bucket)}
        stats = {k: _ldpc_bench.ok_and_iters(fn()) for k, fn in fns.items()}
        for k, t in _timing.interleaved(fns, dev, args.iters, args.reps, warmup=0).items():
            stats[k].update(t)
        result["regimes"][name] = {
            "llr_amp": amp, "noise_sigma": sigma, **stats,
            "speedup_twopass_median": stats["mm"]["median_ms"] / stats["twopass"]["median_ms"]}
        print(f"[{name}] mm {stats['mm']['ms']} -> {stats['mm']['median_ms']} ms | 2p "
              f"{stats['twopass']['ms']} -> {stats['twopass']['median_ms']} ms | speedup "
              f"{result['regimes'][name]['speedup_twopass_median']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
