"""What the command-line tools share: the device flags, ``--set`` config
overrides, the telemetry probe and the report."""

from __future__ import annotations

import json
import sys

import torch

__all__ = ["add_device_args", "device_of", "apply_sets", "require_pyzmq", "make_probe", "report"]


def add_device_args(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device the run uses (default cuda; there is no fallback: "
                        "without a card a cuda run exits with an error)")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")


def device_of(args) -> torch.device:
    """The run's device.  A CUDA device that is not there ends the run."""
    dev = torch.device("cpu" if args.cpu else args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"error: device {dev} was asked for, but torch finds no CUDA device "
                 "(torch.cuda.is_available() is false); run with --device cpu to use the CPU")
    if dev.type == "cuda" and (dev.index or 0) >= torch.cuda.device_count():
        sys.exit(f"error: device {dev} was asked for, but torch finds "
                 f"{torch.cuda.device_count()} CUDA device(s)")
    return dev


def apply_sets(config, sets: list[str]):
    """``--set KEY=JSON`` overrides on top of a config file (or None): the
    dict the ``make_*_config`` functions take, or ``config`` unchanged."""
    if not sets:
        return config
    overrides = {}
    for kv in sets:
        key, eq, val = kv.partition("=")
        if not eq:
            sys.exit(f"error: --set needs KEY=JSON, got {kv!r}")
        try:
            overrides[key] = json.loads(val)
        except json.JSONDecodeError:
            overrides[key] = val  # bare string value
    base = {}
    if config:
        with open(config) as f:
            base = json.load(f)
    base.update(overrides)
    return base


def require_pyzmq() -> None:
    try:
        import zmq  # noqa: F401
    except ImportError:
        sys.exit("error: --zmq needs pyzmq (the zmq module), which is not installed")


def make_probe(address: str):
    """A ZMQ PUB ``MonitorProbe`` bound to ``address``; pyzmq is needed."""
    require_pyzmq()
    from gr_dtl_tpu_torch.testbed import monitor

    return monitor.MonitorProbe(address)


def report(as_json: bool, res: dict) -> None:
    if as_json:
        print(json.dumps(res), flush=True)
    else:
        for k, v in res.items():
            print(f"{k}: {v}")
