"""The crossover of the two LDPC bank decoders on this device (port of
tools/bench_bank_switch.py).

``fec_chain`` routes banks of up to ``BANK_MM_MAX_CODES`` codes
(``GR_DTL_TPU_BANK_MM_MAX``, default 32) to ``ldpc.decode_bank_mm`` (the
reference's whole-batch decode a code; on the card one launch of K3, the
log/sign-domain BP kernel, every row with its own code) and larger banks
to the gather form ``ldpc.decode_bank`` (the reference's per-codeword
tables; on the card one launch of K8, the tanh-product BP kernel in K3's
frame, every row with its own code).  On the CPU both are their plain
PyTorch loops.  This times both at each bank size of ``--sizes``.  A bank
of n codes is n copies of the n=300/k=152 demo code: the reference's
matmul form costs more with the number of codes, not with their
diversity.  Codewords, LLRs (amplitude 4, sigma 0.5) and code
ids from ``numpy.random.RandomState(0)`` and a ``torch.Generator``
seeded ``--seed``.  Prints a JSON line a bank size, then the crossover.

Usage: python -m gr_dtl_tpu_torch.tools.bench_bank_switch [--codewords 1024]
         [--sizes 1,2,4,6,8] [--iters 8] [--reps 3] [--out FILE] [--device cuda | --cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gr_dtl_tpu_torch.ops import ldpc
from gr_dtl_tpu_torch.tools import _cli, _ldpc_bench, _timing

__all__ = ["main"]


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.bench_bank_switch")
    p.add_argument("--codewords", type=int, default=1024)
    p.add_argument("--sizes", default="1,2,4,6,8")
    p.add_argument("--iters", type=int, default=8, help="decode steps a timed window")
    p.add_argument("--reps", type=int, default=3, help="interleaved (mm, gather) window pairs")
    p.add_argument("--seed", type=int, default=2, help="seed of the noise generator")
    p.add_argument("--out", default=None)
    _cli.add_device_args(p)
    args = p.parse_args(argv)
    dev = _cli.device_of(args)
    H = _ldpc_bench.n300()
    code = ldpc.ldpc_from_reference(ldpc.build_ldpc(H), dev)
    CW = args.codewords
    rng = np.random.RandomState(0)
    rows = []
    for n_codes in (int(x) for x in args.sizes.split(",")):
        bank = ldpc.bank_from_reference(ldpc.build_ldpc_bank([H] * n_codes), dev)
        llr = _ldpc_bench.regime_llrs(_ldpc_bench.codewords(code, CW, rng), 4.0, 0.5, args.seed)
        idx = torch.as_tensor(rng.randint(1, n_codes + 1, CW).astype(np.int32), device=dev)
        fns = {"mm": lambda: ldpc.decode_bank_mm(llr, idx, bank, max_iters=15),
               "gather": lambda: ldpc.decode_bank(llr, idx, bank, max_iters=15)}
        ok = {k: _ldpc_bench.ok_and_iters(fn())["ok_rate"] for k, fn in fns.items()}
        t = _timing.interleaved(fns, dev, args.iters, args.reps, warmup=0)
        t_mm, t_g = t["mm"]["median_ms"], t["gather"]["median_ms"]
        rows.append({"n_codes": n_codes, "mm_ms": t_mm, "gather_ms": t_g,
                     "mm_ok_rate": ok["mm"], "gather_ok_rate": ok["gather"], "mm_wins": t_mm < t_g,
                     "mm_ms_windows": t["mm"]["ms"], "gather_ms_windows": t["gather"]["ms"]})
        print(json.dumps(rows[-1]), flush=True)

    crossover = next((r["n_codes"] for r in rows if not r["mm_wins"]), None)
    max_probed = max(r["n_codes"] for r in rows)
    forms = ("decode_bank_mm (K3 on the card, one launch a call) against decode_bank (K8 on the card, one "
             "launch a call; both their plain loops on the CPU)")
    if crossover is not None:
        note = f"{forms}: the gather form first won at {crossover} codes"
    else:
        note = f"{forms}: decode_bank_mm won at every probed bank size (max {max_probed}); no crossover measured"
    res = {"metric": "bank_decoder_crossover", "codewords_per_step": CW,
           "code": "n=300 k=152 (xN copies)", "platform": dev.type, "device": _timing.device_label(dev),
           "rows": rows, "max_probed_n_codes": max_probed, "measured_crossover_n_codes": crossover,
           "note": note, "timing": "interleaved mm/gather windows; "
                                   + _timing.describe(dev, args.iters, args.reps)}
    print(json.dumps({"metric": res["metric"], "crossover": crossover}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
