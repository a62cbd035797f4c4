"""Spans and counters of the receive path, off by default.

A span names a stretch of the program's work (``rx.detect``,
``fec.decode.bp``, ...); a counter adds up a quantity the work produced
(``fec.codewords``).  The recorder is switched by API only:

- :func:`enable` (``device_events=True``: a timing CUDA event on the
  current stream at each span boundary, besides the host clock),
  :func:`disable`, :func:`reset`, :func:`export`;
- :func:`span` (a context manager) and :func:`spanned` (a decorator) at
  the boundaries; :func:`count` for the counters, called under
  ``if trace.enabled():`` where the value costs work to make.

Off, a span checks one module-level flag and returns: no event, no clock
read.  On, a span records its name, its parent (a stack per thread), a
step id shared by every span under one root (a span opened with no
parent starts a step), its host start and end (``time.perf_counter_ns``)
and, with device events, two CUDA events on the stream current at its
start (taken from a pool that :func:`reset` refills).  Spans are kept in
memory and resolved by :func:`export`: one synchronize, then
``elapsed_time`` of each pair.  While the current stream is capturing a
CUDA graph, spans record no event and counters add nothing, so a capture
is never blocked.
Counters add into tensors on the value's device (a Python int stays on
the host): no host read until :func:`export`.

:func:`summary` sums spans by name (total and self time, self less the
children each covers); :func:`on_clock` maps host timestamps onto another
clock (a profiler's device timeline) from one anchor.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch

__all__ = ["Span", "enable", "disable", "enabled", "reset", "span", "spanned", "count", "export",
           "summary", "span_ms", "on_clock"]

_ON = False
_DEVICE = False  # record CUDA events (enable(device_events=True) with a card)
_records: list = []  # (open span, host end ns, end event or None), in the order spans close
_counters: dict = {}
_pool: list = []  # timing events free to record again (those of spans dropped by reset)
_streams: dict = {}  # torch.cuda.Stream by (stream id, device, type)
_ids = itertools.count()
_steps = itertools.count()
_local = threading.local()


class Span(NamedTuple):
    id: int
    name: str
    parent: int | None  # id of the enclosing span, None for a root
    step: int  # the root's step id
    depth: int  # 0 for a root
    host_start_ns: int  # time.perf_counter_ns
    host_end_ns: int
    device_ms: float | None  # between the span's CUDA events; None where none were recorded


def enable(device_events: bool = False) -> None:
    """Start recording; ``device_events``: also time each span on the card
    (ignored without CUDA)."""
    global _ON, _DEVICE
    _DEVICE = bool(device_events) and torch.cuda.is_available()
    _ON = True


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`reset`."""
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def reset() -> None:
    """Drop every recorded span and counter."""
    _pool.extend(e for s, _, e1 in _records if e1 is not None for e in (s.e0, e1))
    _records.clear()
    _counters.clear()


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _stream():
    """The current stream, where the span's events go; None for none.
    ``torch.cuda.current_stream()``'s two calls, without its Python (~9 us
    a call on an H100's host)."""
    if not _DEVICE or torch.cuda.is_current_stream_capturing():
        return None
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    s = _streams.get(key)
    if s is None:
        s = _streams[key] = torch.cuda.Stream(stream_id=key[0], device_index=key[1], device_type=key[2])
    return s


def _event(stream):
    e = _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)
    e.record(stream)
    return e


class _Open:
    __slots__ = ("name", "id", "parent", "step", "depth", "t0", "e0", "stream")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up else None
        self.step = up.step if up else next(_steps)
        self.depth = len(stack)
        stack.append(self)
        self.stream = _stream()
        self.e0 = _event(self.stream) if self.stream is not None else None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        e1 = None
        if self.e0 is not None:
            if torch.cuda.is_current_stream_capturing():
                self.e0 = None  # a capture began inside the span: no device time
            else:
                e1 = _event(self.stream)
        _stack().pop()
        _records.append((self, t1, e1))
        return False


def span(name: str):
    """A context manager around the work named ``name``."""
    if not _ON:
        return _NULL
    return _Open(name)


def spanned(name: str):
    """A decorator: every call of the function is a span named ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with _Open(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, value) -> None:
    """Add ``value`` (a tensor, kept where it is, or an int) into counter ``name``."""
    if not _ON or _capturing():
        return
    _counters[name] = _counters.get(name, 0) + value


def export() -> dict:
    """``{"spans": [Span, ...] in the order they opened, "counters": {name:
    int}}`` of everything recorded since the last :func:`reset`."""
    recs = list(_records)
    if any(e1 is not None for _, _, e1 in recs):
        torch.cuda.synchronize()
    spans = [Span(s.id, s.name, s.parent, s.step, s.depth, s.t0, t1,
                  s.e0.elapsed_time(e1) if e1 is not None else None) for s, t1, e1 in recs]
    spans.sort(key=lambda s: s.id)
    return {"spans": spans, "counters": {k: int(v) for k, v in _counters.items()}}


def span_ms(s: Span) -> float:
    """The span's device ms where its events were recorded, else its host ms."""
    return s.device_ms if s.device_ms is not None else (s.host_end_ns - s.host_start_ns) * 1e-6


def summary(spans) -> dict:
    """``{name: {"n", "ms", "self_ms"}}``: the spans' times (:func:`span_ms`)
    summed by name, and their self times, each span's less the times of
    its children."""
    ms = {s.id: span_ms(s) for s in spans}
    kids = collections.defaultdict(float)
    for s in spans:
        if s.parent is not None:
            kids[s.parent] += ms[s.id]
    out = {}
    for s in spans:
        o = out.setdefault(s.name, {"n": 0, "ms": 0.0, "self_ms": 0.0})
        o["n"] += 1
        o["ms"] += ms[s.id]
        o["self_ms"] += ms[s.id] - kids[s.id]
    return out


def on_clock(spans, host_ns: int, at_us: float) -> list:
    """``[(span, start_us, end_us)]``: host intervals on a clock in us on
    which host time ``host_ns`` reads ``at_us``."""
    return [(s, at_us + (s.host_start_ns - host_ns) * 1e-3, at_us + (s.host_end_ns - host_ns) * 1e-3)
            for s in spans]
