"""The benchmark of the PyTorch and CUDA port, one cell a run.

    python3 -m modem_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run sets up (the port's CUDA libraries from its build cache, the cell's
streams made on the card from the seed by the reference transmitter, one
step on each stream to warm every shape), receives the streams in turn,
back to back on the card's stream with no host read, for ``--seconds``,
then judges the window's outputs against the plain reference and prints
one JSON line last on standard output.

With ``--trace 0`` the line carries the cell's end-to-end metrics:
``rx_msamples_per_s`` (every sample of every step over the window, CUDA
events before the first step and after the last), ``step_ms.p95`` (the
gaps between the events after consecutive steps) and ``setup_s`` (process
start to the first timed step).  With ``--trace 1`` the steps run stage by
stage with an event at each boundary, a stretch of plain steps and a
profiled stretch follow, and the line carries the per-layer metrics that
``BENCHMARK.json`` lists for the cell, each from its reader in
``metrics/``, with ``device.busy_s`` / ``window_s`` and a ``breakdown``;
its comparison also holds the staged step's median time to the plain
step's (``staged_step_gap``), so that stage spans that no longer time
what the window times fail the run.

Without enough CUDA cards, or with JAX loaded when the window has
closed, a run prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from modem_bench import compare, timing  # noqa: E402
from modem_bench.catalog import Catalog, Cell  # noqa: E402
from modem_bench.reference import config as refcfg  # noqa: E402
from modem_bench.reference import dsp, modem as refmodem  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gr_dtl_tpu")
MAX_STEPS = 1 << 16
PROFILED_STEPS = 6
REF_BLOCK = 4096  # frames the reference receives at a time
PLAIN_MS = 1000.0  # device time of the plain steps a traced run times after its window
STAGED_TOLERANCE = 0.03  # |staged step / plain step - 1| a traced run allows


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads."""

    cell: Cell
    num: refcfg.Numerology
    modem: refmodem.Modem  # the reference modem's constants (code sizes, tables)
    B: int
    steps: int  # steps of the window
    stage_ms: dict  # {stage: device ms summed over the window's steps}
    trace: dict | None  # timing.reduce of the profiled steps
    ref_bp_iters: list  # per stream: [B, codewords] BP updates the reference took (coded), or None
    bps_sum: list  # per stream: bits a symbol summed over its frames (the LLRs a step makes)
    slots: int

    def steps_on(self) -> list:
        """Steps of the window that received each stream."""
        return [len(range(k, self.steps, self.slots)) for k in range(self.slots)]


def cards(n: int) -> torch.device:
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"modem_bench: the cell needs {n} CUDA card(s), found {found}", file=sys.stderr)
        sys.exit(2)
    return torch.device("cuda", 0)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev, catalog: Catalog, program=None) -> dict:
    """One run of ``cell``; returns the result line's object.  ``program``
    stands in for the system under test (tests)."""
    torch.set_num_threads(2)
    system = catalog.system(cell.system)
    num = refcfg.numerology(cell.config)
    m = system.modem(cell, dev)
    streams = catalog.kind(cell.traffic["kind"]).make(cell.traffic, m, seed, dev)
    B, slots = cell.frames_per_step, len(streams)
    prog = program or system.Program(cell, dev)
    prog.build()
    clock = timing.Clock(dev)
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats()

    stages = prog.stages
    marks: list = []

    def staged(stream):
        marks.append(clock.mark())
        return prog.staged(stream, lambda stage: marks.append(clock.mark()))

    step = staged if trace else prog.step
    for s in streams:  # every shape the window uses, and the allocator's growth
        step(s.samples)
        if trace:
            prog.step(s.samples)
    clock.sync()
    marks.clear()
    launches0 = prog.launch_counters() if clock.cuda else {}

    counts = torch.zeros(MAX_STEPS, dtype=torch.int64, device=dev)
    last = [None] * slots
    ends = []
    start = clock.mark()
    setup_s = time.perf_counter() - T0
    t_host = time.perf_counter()
    n = 0
    while n < MAX_STEPS:
        frames, eps, out = step(streams[n % slots].samples)
        counts[n] = system.passed((frames, eps, out))
        ends.append(clock.mark())
        last[n % slots] = (frames, eps, out)
        n += 1
        if time.perf_counter() - t_host >= seconds and n >= slots:
            break
    clock.sync()
    gaps = [clock.ms(a, b) for a, b in zip([start] + ends[:-1], ends)]
    window_ms = clock.ms(start, ends[-1])
    launches = {k: v - launches0[k] for k, v in prog.launch_counters().items()} if clock.cuda else {}
    stage_ms = {}
    if trace:
        per = len(stages) + 1
        for i, st in enumerate(stages):
            stage_ms[st] = sum(clock.ms(marks[k * per + i], marks[k * per + i + 1]) for k in range(n))
    memory_peak = torch.cuda.max_memory_allocated() if clock.cuda else 0
    staged_gap = traced = None
    if trace and clock.cuda:
        # the stage spans stand for the window's step only while the staged step takes its time
        plain = [clock.mark()]
        for k in range(max(4 * slots, int(PLAIN_MS / statistics.median(gaps)))):
            prog.step(streams[k % slots].samples)
            plain.append(clock.mark())
        clock.sync()
        plain_ms = statistics.median(clock.ms(a, b) for a, b in zip(plain, plain[1:]))
        staged_gap = abs(statistics.median(gaps) / plain_ms - 1.0)
        k = iter(range(1 << 30))
        tr = timing.profiled_steps(lambda: prog.step(streams[next(k) % slots].samples), PROFILED_STEPS)
        traced = timing.reduce(tr) if tr is not None else None
    del frames, eps, out

    # the window has closed: judge what it produced
    step_counts = counts[:n].tolist()
    per_stream, ref_counts, ref_iters = [], [], []
    t_ref = time.perf_counter()
    for i, s in enumerate(streams):
        r = system.reference(m, s.samples, B, REF_BLOCK)
        per_stream.append(system.readings(last[i], r, s, cell))
        ref_counts.append(int(system.passed(r)))
        ref_iters.append(getattr(r[2], "bp_iters", None))
        del r
    ref_s = time.perf_counter() - t_ref
    numbers = compare.merge(per_stream)
    numbers["steps_crc_diff"] = compare.steps_crc_diff(step_counts, slots)
    limits = dict(cell.limits)
    if staged_gap is not None:
        numbers["staged_step_gap"] = staged_gap
        limits["staged_step_gap"] = STAGED_TOLERANCE
    correct, checks = compare.verdict(numbers, limits)
    # the last step on each stream is compared frame by frame; an earlier step differs by at least
    # as many frames as its count of passing frames differs from the reference's
    failed = numbers["payload_diff"] + sum(abs(c - ref_counts[i % slots])
                                           for i, c in enumerate(step_counts[:n - slots]))

    if trace:
        bps_sum = [int(dsp.tables(dev)[1][s.cnst.long()].sum()) for s in streams]
        ctx = Context(cell, num, m, B, n, stage_ms, traced, ref_iters, bps_sum, slots)
        metrics = {}
        for spec in cell.per_layer:
            v = catalog.metric(spec["name"]).read(ctx)
            if v is not None:
                metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}
    else:
        metrics = {
            "rx_msamples_per_s": {"value": n * B * num.frame_samples / (window_ms * 1e-3) / 1e6,
                                  "unit": "Msamples/s"},
            "step_ms.p95": {"value": timing.p95(gaps), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    device = {"platform": "gpu" if clock.cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if clock.cuda else "cpu",
              "count": 1, "memory_peak_bytes": memory_peak}
    res = {"correct": correct, "attempted": n * B, "failed": failed, "metrics": metrics, "device": device}
    if traced is not None:
        device.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        res["breakdown"] = {"device_ops": traced["device_ops"], "idle_gaps": traced["idle_gaps"]}
    res["checks"] = checks
    res["_log"] = {"steps": n, "window_ms": window_ms, "step_ms.median": sorted(gaps)[len(gaps) // 2],
                   "launch_counters": launches, "ref_crc_ok": ref_counts,
                   "reference_s": ref_s, "stage_ms_per_step": {k: v / n for k, v in stage_ms.items()}}
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m modem_bench.run")
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json (workloads/<cell>.json)")
    p.add_argument("--seed", type=int, required=True, help="seed of every input the run makes")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: the per-layer metrics")
    args = p.parse_args(argv)
    catalog = Catalog()
    cell = catalog.cell(args.workload)
    dev = cards(cell.chips)
    res = run(cell, args.seed, args.seconds, bool(args.trace), dev, catalog)
    bad = forbidden_modules()
    if bad:
        print(f"modem_bench: loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    log = res.pop("_log")
    print(f"modem_bench: {args.workload} seed {args.seed}: {json.dumps(log)}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
