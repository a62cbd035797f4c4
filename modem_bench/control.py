"""The readings that the limits of a cell's comparison are set from.

    python3 -m modem_bench.control --workload <cell> --seeds 1,2,3 [--out FILE]

For each seed, in one process: the cell's streams, :data:`STEPS` steps
of the program on each stream back to back at the cell's own size (as a
run's window drives it), then the comparison's numbers of

- the program against the plain reference (the lower readings), and
- the control, the reference one precision below the float32 the modem
  states, put in the program's place against the same reference (the
  upper readings): ``reference(..., control=True)`` of the cell's
  system, for ``batch_rx`` the stream's samples read as bfloat16 before
  detection and every float32 matmul of the receive path with TF32
  operands.

Prints a JSON line a seed, then one with the largest program reading and
the smallest control reading of each number.  The benchmark's runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from modem_bench import compare
from modem_bench.catalog import Catalog
from modem_bench.run import REF_BLOCK, cards

STEPS = 2  # steps a stream, as the limits were read


def readings(cell, seeds, dev) -> dict:
    catalog = Catalog()
    system, kind = catalog.system(cell.system), catalog.kind(cell.traffic["kind"])
    m = system.modem(cell, dev)
    B = cell.frames_per_step
    prog = system.Program(cell, dev)
    prog.build()
    out = {"program": [], "control": []}
    for seed in seeds:
        streams = kind.make(cell.traffic, m, seed, dev)
        for s in streams:
            prog.step(s.samples)
        counts, last = [], [None] * len(streams)
        for i in range(STEPS * len(streams)):
            last[i % len(streams)] = prog.step(streams[i % len(streams)].samples)
            counts.append(system.passed(last[i % len(streams)]))
        counts = [int(c) for c in counts]
        p, c = [], []
        for i, s in enumerate(streams):
            r = system.reference(m, s.samples, B, REF_BLOCK)
            p.append(system.readings(last[i], r, s, cell))
            ctl = system.reference(m, s.samples, B, REF_BLOCK, control=True)
            c.append(system.readings(ctl, r, s, cell))
            del r, ctl
        last = None
        pr, cr = compare.merge(p), compare.merge(c)
        pr["steps_crc_diff"] = compare.steps_crc_diff(counts, len(streams))
        cr["steps_crc_diff"] = 0  # one output a stream: nothing to hold it to
        for k, v in (("program", pr), ("control", cr)):
            out[k].append(v)
            print(json.dumps({"seed": seed, "side": k, **v}), flush=True)
    return out


def summary(out: dict) -> dict:
    names = out["program"][0].keys()
    return {"program_max": {k: max(r[k] for r in out["program"]) for k in names},
            "control_min": {k: min(r[k] for r in out["control"]) for k in names}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m modem_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--out", default=None, help="write every reading as JSON")
    args = p.parse_args(argv)
    cell = Catalog().cell(args.workload)
    dev = cards(cell.chips)
    out = readings(cell, [int(s) for s in args.seeds.split(",")], dev)
    s = summary(out)
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(dev), **s}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**out, **s}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
