"""The measuring tools' one timer.

A measurement is ``warmup`` untimed calls (first-use kernel builds, the
allocator's first growth, a profiler's or library's first call), then
``reps`` windows of ``iters`` back-to-back calls.  On a card a window is
timed by two CUDA events on the current stream, with
``torch.cuda.synchronize`` before the first and after the second: the
elapsed time between them covers the device's work and every gap in which
it waited for the host, as a user's loop sees it.  On the CPU a window is
timed by ``time.perf_counter``.  A result is the median of the windows'
ms a call, with every window kept.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

__all__ = ["sync", "window_ms", "measure", "interleaved", "describe", "smi", "device_label", "WARM_MS", "MARK",
           "profiled_windows"]


def sync(dev) -> None:
    """Wait for the device's queued work (nothing on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def window_ms(fn, n: int, dev="cuda") -> float:
    """Mean ms a call over ``n`` back-to-back calls of ``fn()``."""
    if torch.device(dev).type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


# a profiled window is warmed up by time: the profiler misses the launches of its first
# milliseconds, more of them the more profiles the process has taken, and a count of warm calls of
# a short call can end inside them (chip_smoke.py runs have come back with an empty window that
# way); a window that saw none is taken again, warmed for longer
WARM_MS = (50.0, 200.0, 800.0, 2000.0)
MARK = "spin_kernel"  # what torch.cuda._sleep launches: a window counts the launches after it


def profiled_windows(fn, reps: int):
    """Windows of ``reps`` back-to-back calls of ``fn()`` under
    ``torch.profiler``, one for each warm-up of ``WARM_MS`` in turn, until
    the caller stops asking: each yields the device's kernels and copies
    (profiler events) that started after a marker kernel, launched after
    that long of calls of fn inside the profiler, each call synchronised.
    A window whose marker the profiler missed yields nothing."""
    from torch.profiler import ProfilerActivity, profile
    for warm_ms in WARM_MS:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0, n = time.perf_counter(), 0
            while n == 0 or (time.perf_counter() - t0) * 1e3 < warm_ms:
                fn()
                torch.cuda.synchronize()
                n += 1
            torch.cuda._sleep(1)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
        marks = [e.time_range.start for e in dev if MARK in e.name]
        yield [e for e in dev if marks and e.time_range.start > max(marks)]


def measure(fn, dev, iters: int = 8, reps: int = 5, warmup: int = 1) -> dict:
    """``{"median_ms", "ms"}``: the median over ``reps`` windows of
    ``iters`` calls, and each window's ms a call."""
    for _ in range(warmup):
        fn()
    sync(dev)
    ms = [window_ms(fn, iters, dev) for _ in range(reps)]
    return {"median_ms": statistics.median(ms), "ms": ms}


def interleaved(fns: dict, dev, iters: int = 8, reps: int = 5, warmup: int = 1) -> dict:
    """An A/B (or A/B/C...): every variant warmed up, then ``reps`` rounds
    in which each variant's window runs in turn, so that all see the same
    clocks and heat.  ``{label: {"median_ms", "ms"}}``."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    sync(dev)
    ms = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            ms[k].append(window_ms(fn, iters, dev))
    return {k: {"median_ms": statistics.median(v), "ms": v} for k, v in ms.items()}


def describe(dev, iters: int, reps: int) -> str:
    """What a tool's ``timing``/``schedule`` field says was timed."""
    clock = ("CUDA events (synchronized before and after)" if torch.device(dev).type == "cuda"
             else "time.perf_counter")
    return f"{clock} around {iters} back-to-back calls after warm-up, median of {reps} windows"


def smi(query: str, index: int = 0) -> str:
    """``nvidia-smi --query-gpu=<query>`` of card ``index``, e.g.
    ``smi("name,power.limit")`` -> ``"NVIDIA H100 80GB HBM3, 700.00 W"``."""
    out = subprocess.run(["nvidia-smi", "-i", str(index), f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_label(dev) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (a card
    set below its maximum runs slower under load), or ``cpu``."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return "cpu"
    return smi("name,power.limit", torch.cuda.current_device() if dev.index is None else dev.index)
