"""The benchmark's clocks and the reduction of a profiler trace.

- :class:`Clock`: CUDA events on the card's stream (the device's own
  timestamps; ``sync`` waits for the stream), host time on the CPU, where
  only the tests run the harness.
- :func:`profiled_steps`: ``steps`` calls of a step under
  ``torch.profiler``, the device's activity only (host activity slows the
  host's enqueue enough to open gaps the untraced steps do not have),
  warmed by time inside the profiler and opened at a marker kernel (the
  profiler misses the launches of its first milliseconds; a window whose
  marker it missed is taken again, warmed longer).
- :func:`reduce`: busy time as the union of the device's kernel and copy
  intervals, the window, the launches, the device operations that took
  most time and the longest idle gaps, each named by the operations on
  either side: the card waited for the host to launch the second.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import statistics
import time

import torch

WARM_MS = (50.0, 200.0, 800.0, 2000.0)
MARK = "spin_kernel"  # what torch.cuda._sleep launches


class Clock:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


def p95(values) -> float:
    """The 95th percentile, linear between order statistics."""
    v = list(values)
    return v[0] if len(v) == 1 else statistics.quantiles(v, n=20, method="inclusive")[18]


@dataclasses.dataclass
class Trace:
    device_ops: list  # [(name, start_us, end_us)] after the marker
    start_us: float  # the first operation's start
    steps: int


def profiled_steps(step, steps: int):
    """Trace of ``steps`` calls of ``step()``, or None if three warm-ups in
    turn saw no marker."""
    from torch.profiler import ProfilerActivity, profile

    for warm_ms in WARM_MS:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0, n = time.perf_counter(), 0
            while n == 0 or (time.perf_counter() - t0) * 1e3 < warm_ms:
                step()
                torch.cuda.synchronize()
                n += 1
            torch.cuda._sleep(1)
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
        marks = [e.time_range.end for e in dev if MARK in e.name]
        if not marks:
            continue
        m = max(marks)
        ops = [(e.name, e.time_range.start, e.time_range.end) for e in dev if e.time_range.start >= m]
        if ops:
            # the window opens at the first operation of the steps: before it the card waits for the
            # harness, which synchronised before the marker
            return Trace(ops, min(s for _, s, _ in ops), steps)
    return None


def short(name: str, width: int = 160) -> str:
    """A kernel's name without its return type and the namespaces that
    every PyTorch kernel shares, cut to ``width`` characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(noise, "")
    return name[:width]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(tr: Trace, top: int = 10) -> dict:
    """``busy_s``, ``window_s``, ``launches``, ``steps``, ``device_ops`` and
    ``idle_gaps`` (each ``[[name, seconds], ...]``, most first)."""
    busy = _union([(s, e) for _, s, e in tr.device_ops])
    by_name = collections.defaultdict(float)
    for name, s, e in tr.device_ops:
        by_name[short(name)] += (e - s) * 1e-6
    starts = sorted((s, short(name, 80)) for name, s, _ in tr.device_ops)
    ends = sorted((e, short(name, 80)) for name, _, e in tr.device_ops)
    start_t, end_t = [t for t, _ in starts], [t for t, _ in ends]
    gaps = []
    for (_, e), (s, _) in zip(busy, busy[1:]):
        before = ends[bisect.bisect_right(end_t, e) - 1][1]
        after = starts[bisect.bisect_left(start_t, s)][1]
        gaps.append((f"{before} -> {after}", (s - e) * 1e-6))
    return {"busy_s": sum(e - s for s, e in busy) * 1e-6, "window_s": (busy[-1][1] - tr.start_us) * 1e-6,
            "launches": len(tr.device_ops), "steps": tr.steps,
            "device_ops": [[n, v] for n, v in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
            "idle_gaps": [[n, v] for n, v in sorted(gaps, key=lambda x: -x[1])[:top]]}
