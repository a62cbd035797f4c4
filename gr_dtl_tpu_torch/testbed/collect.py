"""Collector-side telemetry aggregation (port of gr_dtl_tpu/testbed/collect.py).

- :class:`Collector` consumes raw probe blobs (or parsed dicts), keeps the
  message stream, and counts telemetry lost on the monitoring channel from
  gaps in each proto id's envelope ``sent_counter``;
- :func:`summarize`: min / max / median / mean / sd of every numeric field;
- :func:`frame_success`: the frame success rate from the eq / dec message
  stream;
- :func:`load_jsonl`: a collector's JSONL capture back into dicts.

No socket: a subscription loop feeds :meth:`Collector.feed`.
"""

from __future__ import annotations

import json
import math
import typing as t

from gr_dtl_tpu_torch.testbed.monitor import MonitorParser

__all__ = ["Collector", "summarize", "frame_success", "load_jsonl"]


class Collector:
    """Accumulates parsed telemetry messages.

    Feed it raw blobs (:meth:`feed`) or dicts (:meth:`feed_dict`); read
    ``.messages``, :meth:`lost`, :meth:`summary`.
    """

    def __init__(self, keep: int | None = None):
        self._parser = MonitorParser()
        self.messages: list[dict] = []
        self.keep = keep  # ring-buffer bound (None = unbounded)
        self.n_received = 0
        self._last_counter: dict[int, int] = {}  # proto_id -> sent_counter
        self.n_lost = 0

    def feed(self, blob: bytes) -> dict:
        return self.feed_dict(self._parser.parse(blob))

    def feed_dict(self, msg: dict) -> dict:
        self.n_received += 1
        pid = msg.get("proto_id")
        sc = msg.get("sent_counter")
        if pid is not None and sc is not None:
            prev = self._last_counter.get(pid)
            if prev is not None and sc > prev + 1:
                # the publisher sent counters never seen here: channel loss
                self.n_lost += sc - prev - 1
            self._last_counter[pid] = sc
        self.messages.append(msg)
        if self.keep is not None and len(self.messages) > self.keep:
            del self.messages[: len(self.messages) - self.keep]
        return msg

    def lost(self) -> int:
        """Messages lost on the monitoring channel itself."""
        return self.n_lost

    def by_proto(self, proto_id: int) -> list[dict]:
        return [m for m in self.messages if m.get("proto_id") == proto_id]

    def summary(self) -> dict:
        out = {
            "received": self.n_received,
            "lost": self.n_lost,
            "fields": summarize(self.messages),
        }
        fs = frame_success(self.messages)
        if fs is not None:
            out["frame_success_rate"] = fs
        return out


def _stats(values: list[float]) -> dict:
    """min / max / median / mean / sd (n - 1 in the denominator)."""
    n = len(values)
    vs = sorted(values)
    mean = sum(vs) / n
    med = vs[n // 2] if n % 2 else 0.5 * (vs[n // 2 - 1] + vs[n // 2])
    sd = math.sqrt(sum((v - mean) ** 2 for v in vs) / (n - 1)) if n > 1 else 0.0
    return {"n": n, "min": vs[0], "max": vs[-1], "median": med, "mean": mean, "sd": sd}


def summarize(messages: t.Iterable[dict]) -> dict:
    """Per-field numeric summaries over a message stream."""
    cols: dict[str, list[float]] = {}
    for m in messages:
        for k, v in m.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            if k in ("time", "proto_id", "sent_counter"):
                continue
            cols.setdefault(k, []).append(float(v))
    return {k: _stats(v) for k, v in cols.items() if v}


def frame_success(messages: t.Iterable[dict]) -> float | None:
    """Frame success rate from the CRC counters: the latest cumulative
    ``crc_ok_count`` / ``crc_fail_count`` pair (dec messages), else the
    per-message boolean ``crc_ok`` fields (dict telemetry of the uncoded
    chain); None without either."""
    last = None
    oks = fails = 0
    for m in messages:
        if "crc_ok_count" in m and "crc_fail_count" in m:
            last = (m["crc_ok_count"], m["crc_fail_count"])
        elif "crc_ok" in m:
            oks += bool(m["crc_ok"])
            fails += not m["crc_ok"]
    if last is not None:
        total = last[0] + last[1]
        return last[0] / total if total else None
    total = oks + fails
    return oks / total if total else None


def load_jsonl(path: str) -> list[dict]:
    """Read a collector JSONL capture back into message dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
