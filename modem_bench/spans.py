"""The program's own spans and counters (``gr_dtl_tpu_torch.utils.trace``)
in a traced run: three stretches after the run's own, the recorder on in
each, read by the span rooflines, ``host_enqueue_ms``,
``bp_updates_per_codeword`` and ``fec_slot_use_pct``.

- (a) spans: about :data:`PLAIN_MS` of device time of plain steps, each
  under a root span ``rx.step``, a CUDA event at every span boundary
  (after a warm stretch of the same steps, whose events it records
  again); the same steps with the recorder off just before give the
  step's median without it (``span_step_gap``: the recorder's cost when
  on);
- (b) enqueue: :data:`ENQUEUE_STEPS` steps, each started after a
  synchronize, host clock only: the host's own time to enqueue a step
  with no back-pressure from the card;
- (c) attribution: :data:`PROFILED_STEPS` steps under ``torch.profiler``
  as ``timing.profiled_steps`` takes them (the device's activity only),
  host spans only, the host clock put on the trace's by an anchor (the
  host time just before the marker kernel's launch against the marker's
  device start: off by about one launch latency); each idle gap is named
  by the innermost span whose host interval covers most of it, or
  ``outside`` (the harness's loop between steps), the span first.

:func:`of` makes the stretches once a run and prints what they read on
standard error (``modem_bench: spans <cell>: {...}``): every span's device
ms a step (total and self), the host's, the counters, the reference's
mean BP updates beside the program's, ``span_step_gap`` and the idle
gaps by span.  It returns None where the run's program has no recorder
(a checkout older than it), and on the CPU, where only the tests run the
harness, unless :data:`HOST_AS_DEVICE` is set (a span's device time is
then its host time); its readers then report nothing.

``Context`` carries neither the run's program nor its streams, and
``run.py`` changes only in a benchmark PR, so :func:`run_state` reads them
from ``run.run``'s frame on the stack.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import itertools
import json
import os
import statistics
import sys
import time

import torch

from modem_bench import timing
from modem_bench.reference import dsp
from modem_bench.reference import fec as reffec

PLAIN_MS = 1000.0  # device time of stretch (a), and of the plain steps before it
ENQUEUE_STEPS = 20  # stretch (b)
PROFILED_STEPS = 6  # stretch (c), as the run's profiled stretch
HOST_AS_DEVICE = False  # the tests: read the spans' host times on the CPU
ROOT = "rx.step"
OUTSIDE = "outside"
# a stage of the staged rooflines: (its span, the child span that is another stage's)
STAGES = {"detect": ("rx.detect", None), "demodulate": ("rx.demodulate", None),
          "equalize": ("rx.equalize", None), "demap": ("rx.demap", "fec.decode"), "fec": ("fec.decode", None)}


@dataclasses.dataclass
class Readings:
    steps: int  # steps of stretch (a), stream k % slots at step k
    stage_ms: dict  # {stage: device ms over stretch (a)}, as Context.stage_ms
    host_enqueue_ms: float  # median host ms of rx.step in stretch (b)
    counters: dict  # the recorder's counters over stretch (a)


_last = None  # (ctx, Readings or None) of the last run read


def of(ctx) -> Readings | None:
    """The run's readings (the stretches run at the first call of a run)."""
    global _last
    if _last is None or _last[0] is not ctx:
        _last = (ctx, _read(ctx))
    return _last[1]


def roofline(ctx, reader, stage: str):
    """``reader`` (a staged roofline of ``metrics/``) over the span
    stretch's steps and its stage's device ms."""
    r = of(ctx)
    ms = r and r.stage_ms.get(stage)
    if not ms:
        return None
    return reader.read(dataclasses.replace(ctx, steps=r.steps, stage_ms={stage: ms}))


def run_state() -> dict | None:
    """The locals of ``run.run`` on the stack (``prog``, ``streams``,
    ``dev``, ``gaps``), or None outside a run."""
    f = sys._getframe(1)
    while f is not None:
        code = f.f_code
        if code.co_name == "run" and code.co_filename.endswith(os.path.join("modem_bench", "run.py")):
            loc = f.f_locals
            return loc if {"prog", "streams", "dev", "gaps"} <= loc.keys() else None
        f = f.f_back
    return None


def _read(ctx) -> Readings | None:
    try:
        from gr_dtl_tpu_torch.utils import trace
    except ImportError:
        return None
    st = run_state()
    if st is None:
        return None
    dev = torch.device(st["dev"])
    cuda = dev.type == "cuda"
    if not (cuda or HOST_AS_DEVICE):
        return None
    prog, streams = st["prog"], st["streams"]
    slots = len(streams)
    clock = timing.Clock(dev)

    def plain(k):
        prog.step(streams[k % slots].samples)

    def spanned(k):
        with trace.span(ROOT):
            prog.step(streams[k % slots].samples)

    # (a) the spans with device events, after the same steps with the recorder off
    n = max(4 * slots, int(PLAIN_MS / statistics.median(st["gaps"])))
    plain_ms = _median_step(plain, n, clock)
    trace.reset()
    trace.enable(device_events=True)
    try:
        _median_step(spanned, n, clock)
        trace.reset()
        span_step_ms = _median_step(spanned, n, clock)
    finally:
        trace.disable()
    rec = trace.export()
    trace.reset()
    summ = trace.summary(rec["spans"])
    total = lambda name: summ.get(name, {}).get("ms", 0.0)
    stage_ms = {stage: total(name) - (total(less) if less else 0.0)
                for stage, (name, less) in STAGES.items() if name in summ}
    tops = collections.defaultdict(float)  # the top-level spans' sum, by step
    for s in rec["spans"]:
        if s.depth == 1:
            tops[s.step] += trace.span_ms(s)

    # (b) the host's enqueue, the card drained before each step
    trace.enable()
    try:
        for k in range(ENQUEUE_STEPS):
            clock.sync()
            spanned(k)
        clock.sync()
    finally:
        trace.disable()
    host = trace.export()["spans"]
    trace.reset()
    host_enqueue_ms = statistics.median(trace.span_ms(s) for s in host if s.name == ROOT)

    log = {"span_steps": n, "plain_step_ms": plain_ms, "span_step_ms": span_step_ms,
           "span_step_gap": abs(span_step_ms / plain_ms - 1.0), "top_spans_ms": statistics.median(tops.values()),
           "span_ms_per_step": {k: {"ms": v["ms"] / n, "self_ms": v["self_ms"] / n} for k, v in summ.items()},
           "host_enqueue_ms": host_enqueue_ms,
           "host_ms_per_step": {k: v["ms"] / ENQUEUE_STEPS for k, v in trace.summary(host).items()},
           "counters": rec["counters"]}
    c = rec["counters"]
    if c.get("fec.codewords"):
        log["bp_updates_per_codeword"] = c["fec.bp_updates"] / c["fec.codewords"]
        log["ref_bp_updates_per_codeword"] = _ref_updates(ctx, streams, n)

    # (c) the idle gaps by span
    if cuda:
        ks = itertools.count()
        got = profiled(lambda: spanned(next(ks)), PROFILED_STEPS, trace)
        if got is not None:
            log.update(attribute(*got))
    print(f"modem_bench: spans {ctx.cell.name}: {json.dumps(log)}", file=sys.stderr)
    return Readings(n, stage_ms, host_enqueue_ms, c)


def _median_step(step, n: int, clock) -> float:
    marks = [clock.mark()]
    for k in range(n):
        step(k)
        marks.append(clock.mark())
    clock.sync()
    return statistics.median(clock.ms(a, b) for a, b in zip(marks, marks[1:]))


def _ref_updates(ctx, streams, n: int) -> float:
    """The reference's BP updates per real codeword over the steps of a
    stretch of ``n`` (the same streams, in turn)."""
    updates = codewords = 0
    for k, (s, it) in enumerate(zip(streams, ctx.ref_bp_iters)):
        times = len(range(k, n, len(streams)))
        bps = dsp.tables(s.cnst.device)[1][s.cnst.long()]
        updates += times * int(it.sum())
        codewords += times * int(reffec._schedule(ctx.modem.fec, bps).real.sum())
    return updates / codewords


def profiled(step, steps: int, trace):
    """``timing.profiled_steps``'s window with the recorder on for the
    steps, host spans only: ``(timing.Trace, the marker's device start in
    us, the host ns just before its launch, the spans)``, or None if
    three warm-ups in turn saw no marker."""
    from torch.profiler import ProfilerActivity, profile

    for warm_ms in timing.WARM_MS:
        torch.cuda.synchronize()
        trace.reset()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0, n = time.perf_counter(), 0
            while n == 0 or (time.perf_counter() - t0) * 1e3 < warm_ms:
                step()
                torch.cuda.synchronize()
                n += 1
            trace.enable()
            try:
                anchor_ns = time.perf_counter_ns()
                torch.cuda._sleep(1)
                for _ in range(steps):
                    step()
                torch.cuda.synchronize()
            finally:
                trace.disable()
        dev = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
        marks = [(e.time_range.end, e.time_range.start) for e in dev if timing.MARK in e.name]
        if not marks:
            continue
        m_end, m_start = max(marks)
        ops = [(e.name, e.time_range.start, e.time_range.end) for e in dev if e.time_range.start >= m_end]
        if ops:
            spans = trace.export()["spans"]
            trace.reset()
            return timing.Trace(ops, min(s for _, s, _ in ops), steps), m_start, anchor_ns, spans
    trace.reset()
    return None


def attribute(tr: timing.Trace, at_us: float, anchor_ns: int, spans, top: int = 10) -> dict:
    """``idle_gaps`` (the longest, ``"<span> | <before> -> <after>"``),
    ``idle_by_span`` (every gap's seconds summed by span) and
    ``idle_by_span_after_first`` (the same for the gaps inside a root span
    after the first: the first step starts on a drained card), each
    ``[[name, seconds], ...]``, most first, and ``idle_by_step`` (seconds
    by the root span covering the gap, in order, then :data:`OUTSIDE`'s);
    the spans' host intervals put on the trace's clock by the anchor (host
    ``anchor_ns`` is device ``at_us``)."""
    from gr_dtl_tpu_torch.utils import trace

    placed = trace.on_clock(spans, anchor_ns, at_us)
    roots = [p for p in placed if p[0].depth == 0]
    by_step = [0.0] * (len(roots) + 1)
    busy = timing._union([(s, e) for _, s, e in tr.device_ops])
    starts = sorted((s, timing.short(name, 80)) for name, s, _ in tr.device_ops)
    ends = sorted((e, timing.short(name, 80)) for name, _, e in tr.device_ops)
    start_t, end_t = [t for t, _ in starts], [t for t, _ in ends]
    gaps, by_span, later = [], collections.defaultdict(float), collections.defaultdict(float)
    for (_, e), (s, _) in zip(busy, busy[1:]):
        inner = covering(placed, e, s)
        name = inner[0].name if inner else OUTSIDE
        before = ends[bisect.bisect_right(end_t, e) - 1][1]
        after = starts[bisect.bisect_left(start_t, s)][1]
        gaps.append((f"{name} | {before} -> {after}", (s - e) * 1e-6))
        by_span[name] += (s - e) * 1e-6
        root = covering(roots, e, s)
        k = roots.index(root) if root else -1
        by_step[k] += (s - e) * 1e-6
        if k > 0:
            later[name] += (s - e) * 1e-6
    most = lambda d: [[k, v] for k, v in sorted(d, key=lambda x: -x[1])]
    return {"idle_gaps": most(gaps)[:top], "idle_by_span": most(by_span.items()),
            "idle_by_span_after_first": most(later.items()), "idle_by_step": by_step}


def covering(placed, a: float, b: float):
    """The innermost entry of ``placed`` (``trace.on_clock``'s) whose
    interval covers more than half of [a, b], or None."""
    best = None
    for p in placed:
        _, t0, t1 = p
        if min(b, t1) - max(a, t0) > 0.5 * (b - a) and (best is None or p[0].depth > best[0].depth):
            best = p
    return best
