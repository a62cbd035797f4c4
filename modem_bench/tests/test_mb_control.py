"""On a card: the program reads under every limit of its cell and the
control (the reference with the stream read as bfloat16 before detection
and TF32 matmuls after it) fails one, at 1024 frames a step, three seeds.  The full-size readings the limits were set from are
``python3 -m modem_bench.control`` (PERF.md)."""

from __future__ import annotations

import dataclasses

import pytest

from modem_bench import compare, control
from modem_bench.catalog import Catalog

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["uncoded.loopback-b32k", "fec.qpsk-11db-b32k"])
def test_program_passes_and_control_fails(card, cell):
    c = Catalog().cell(cell)
    c = dataclasses.replace(c, traffic={**c.traffic, "frames_per_step": 1024})
    out = control.readings(c, SEEDS, card)
    for prog, ctl in zip(out["program"], out["control"]):
        assert compare.verdict(prog, c.limits)[0], prog
        assert not compare.verdict(ctl, c.limits)[0], ctl
