"""Where the benchmark finds its parts, by name.

- a cell: ``workloads/<cell>.json`` (its configuration, traffic, system,
  chips, why, and the limits of its comparison);
- a configuration: ``configs/<config>/config.json`` and the files beside it
  (the codes' alists, the source note);
- a traffic mix: ``traffic/<traffic>.json``, parameters that name their
  ``kind``;
- a traffic kind: ``traffic/<kind>.py``, a generator with
  ``make(mix, modem, seed, device)``;
- a system under test: ``systems/<system>.py``, the adapter that drives
  the program and judges what it produced;
- a per-layer metric: ``metrics/<metric>.py``, a reader with ``read(ctx)``;
- which per-layer metrics a cell reports, and their units: the
  ``per_layer`` list of ``BENCHMARK.json`` at the checkout's root.

Adding a cell, a configuration, a mix, a kind, a system or a metric adds
files; no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

from modem_bench.reference.ldpc import parse_alist

ROOT = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    config: dict  # the configuration file as it is run
    config_dir: Path
    traffic_name: str
    traffic: dict
    system: str  # systems/<system>.py
    chips: int
    limits: dict  # {compared number: limit}
    per_layer: tuple  # ({"name", "unit", ...}, ...) this cell reports with --trace 1

    @property
    def coded(self) -> bool:
        return bool(self.config.get("fec", False))

    @property
    def frames_per_step(self) -> int:
        return int(self.traffic["frames_per_step"])

    def codes(self) -> dict:
        """{code name: H} of every code the configuration names (its alist
        copies), in the configuration's order; empty uncoded."""
        return {name: parse_alist((self.config_dir / self.config["alist_copies"][name]).read_text())
                for name, _ in self.config.get("fec_codes", [])} if self.coded else {}


def _json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SystemExit(f"modem_bench: no such file: {path}") from None


def _module(path: Path, name: str):
    if not path.is_file():
        raise SystemExit(f"modem_bench: no such file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Catalog:
    def __init__(self, root: Path = ROOT, benchmark: Path | None = None):
        self.root = Path(root)
        self.benchmark = Path(benchmark) if benchmark else ROOT.parent / "BENCHMARK.json"

    def cell(self, name: str) -> Cell:
        w = _json(self.root / "workloads" / f"{name}.json")
        cdir = self.root / "configs" / w["config"]
        layer = [m for m in _json(self.benchmark)["per_layer"]
                 if name in m.get("workloads", [name])]
        return Cell(name=name, config_name=w["config"], config=_json(cdir / "config.json"), config_dir=cdir,
                    traffic_name=w["traffic"], traffic=_json(self.root / "traffic" / f"{w['traffic']}.json"),
                    system=w["system"], chips=int(w["chips"]), limits=dict(w["limits"]),
                    per_layer=tuple(layer))

    def kind(self, name: str):
        """The generator module of ``traffic/<name>.py``."""
        return _module(self.root / "traffic" / f"{name}.py", f"modem_bench.traffic.{name}")

    def system(self, name: str):
        """The adapter module of ``systems/<name>.py``."""
        return _module(self.root / "systems" / f"{name}.py", f"modem_bench.systems.{name}")

    def metric(self, name: str):
        """The reader module of ``metrics/<name>.py``."""
        return _module(self.root / "metrics" / f"{name}.py", f"modem_bench.metrics.{name}")
