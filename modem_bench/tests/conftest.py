"""Shared pieces of the benchmark's tests: a catalog of tiny cells beside
the real ones, and the card fixture.

Run on the CPU: ``python -m pytest -n 0 modem_bench/tests``; on a card:
``python3 -m pytest -o addopts= -q modem_bench/tests`` (the tests marked
``cuda`` skip without one).
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from modem_bench.catalog import ROOT, Catalog

CELLS = ("uncoded.loopback-b32k", "fec.qpsk-11db-b32k")


def tiny_catalog(tmp: Path, frames: int = 16) -> Catalog:
    """A catalog whose cells ``tiny.<cell>`` are the real cells at ``frames``
    frames a step, written as new files beside links to the real
    configurations, traffic kinds, systems and readers."""
    (tmp / "workloads").mkdir()
    (tmp / "traffic").mkdir()
    for d in ("configs", "systems", "metrics"):
        (tmp / d).symlink_to(ROOT / d)
    for kind in (ROOT / "traffic").glob("*.py"):
        (tmp / "traffic" / kind.name).symlink_to(kind)
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    for cell in CELLS:
        w = json.loads((ROOT / "workloads" / f"{cell}.json").read_text())
        mix = json.loads((ROOT / "traffic" / f"{w['traffic']}.json").read_text())
        mix["frames_per_step"] = frames
        (tmp / "traffic" / f"tiny-{w['traffic']}.json").write_text(json.dumps(mix))
        w["traffic"] = f"tiny-{w['traffic']}"
        (tmp / "workloads" / f"tiny.{cell}.json").write_text(json.dumps(w))
        for m in bench["per_layer"]:
            if cell in m.get("workloads", []):
                m["workloads"].append(f"tiny.{cell}")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return Catalog(tmp, tmp / "BENCHMARK.json")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
