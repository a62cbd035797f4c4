"""Interleaved float32-vs-bfloat16 BP A/B: ``ldpc.decode_mm`` with
``bf16=False`` and ``bf16=True`` (the ``GR_DTL_TPU_BP_BF16`` switch) on the
same LLR tensor on the device (port of tools/bench_bf16_ab.py).

The two variants run in turns (f32 window, bf16 window, ...) ``--reps``
times and the medians decide.  The port's BP sums by gathers, not by
matmuls, so the switch only adds its roundings: this measures what they
cost.  Regimes: ``clean`` (LLR amplitude 4, sigma 0.5, bench_fec's raw-BP
point, ~1-2 iterations) and ``hard`` (1.6, 1.0, ~96% converge and the
stragglers run the whole budget).  Codewords of the n=300/k=152 code from
``numpy.random.RandomState(0)``, noise from a ``torch.Generator`` seeded
``--seed``.

Usage: python -m gr_dtl_tpu_torch.tools.bench_bf16_ab [--reps 5] [--iters 8]
         [--cw 2048] [--out FILE] [--device cuda | --cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from gr_dtl_tpu_torch.ops import ldpc
from gr_dtl_tpu_torch.tools import _cli, _ldpc_bench, _timing

__all__ = ["REGIMES", "main"]

REGIMES = {"clean": (4.0, 0.5), "hard": (1.6, 1.0)}


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.bench_bf16_ab")
    p.add_argument("--reps", type=int, default=5, help="interleaved (f32, bf16) window pairs")
    p.add_argument("--iters", type=int, default=8, help="decode steps a timed window")
    p.add_argument("--cw", type=int, default=2048, help="codewords a step")
    p.add_argument("--seed", type=int, default=2, help="seed of the noise generator")
    p.add_argument("--out", default=None)
    _cli.add_device_args(p)
    args = p.parse_args(argv)
    dev = _cli.device_of(args)
    code = ldpc.ldpc_from_reference(ldpc.build_ldpc(_ldpc_bench.n300()), dev)
    CW = args.cw
    cws = _ldpc_bench.codewords(code, CW, np.random.RandomState(0))
    result = {"metric": "bp_bf16_ab", "platform": dev.type, "device": _timing.device_label(dev),
              "reps": args.reps, "iters_per_rep": args.iters, "cw": CW, "code": f"n={code.N} k={code.K}",
              "schedule": "interleaved f32/bf16 windows; " + _timing.describe(dev, args.iters, args.reps),
              "regimes": {}}
    for name, (amp, sigma) in REGIMES.items():
        llr = _ldpc_bench.regime_llrs(cws, amp, sigma, args.seed)
        fns = {"f32": lambda: ldpc.decode_mm(llr, code, 15, bf16=False),
               "bf16": lambda: ldpc.decode_mm(llr, code, 15, bf16=True)}
        stats = {k: _ldpc_bench.ok_and_iters(fn()) for k, fn in fns.items()}
        for k, t in _timing.interleaved(fns, dev, args.iters, args.reps, warmup=0).items():
            stats[k].update(t, min_ms=min(t["ms"]))
        result["regimes"][name] = {
            "llr_amp": amp, "noise_sigma": sigma, **stats,
            "speedup_bf16_median": stats["f32"]["median_ms"] / stats["bf16"]["median_ms"],
            "speedup_bf16_min": stats["f32"]["min_ms"] / stats["bf16"]["min_ms"]}
        print(f"[{name}] f32 {stats['f32']['ms']} -> {stats['f32']['median_ms']} ms | bf16 "
              f"{stats['bf16']['ms']} -> {stats['bf16']['median_ms']} ms | speedup "
              f"{result['regimes'][name]['speedup_bf16_median']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
