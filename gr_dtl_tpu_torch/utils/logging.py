"""Per-component logging registry (port of gr_dtl_tpu/utils/logging.py).

Named loggers, one per component, sharing one sink on standard output; a
runtime level switch over the whole registry (:func:`set_log_level`); and
an environment kill switch (``GR_DTL_TPU_LOG=0`` disables every logger,
``GR_DTL_TPU_LOG_LEVEL`` sets the initial level, WARNING by default).
The loggers are named ``gr_dtl_tpu_torch.<component>``.
"""

from __future__ import annotations

import logging
import os
import sys
import typing as t

__all__ = ["get_logger", "set_log_level", "registry"]

_FMT = "%(asctime)s.%(msecs)03d %(process)d %(name)s:%(levelname)s %(message)s"
_DATEFMT = "%m/%d %H:%M:%S"

_registry: dict[str, logging.Logger] = {}
_handler: logging.Handler | None = None


def _sink() -> logging.Handler:
    global _handler
    if _handler is None:
        _handler = logging.StreamHandler(sys.stdout)
        _handler.setFormatter(logging.Formatter(_FMT, _DATEFMT))
    return _handler


def get_logger(component: str) -> logging.Logger:
    """One logger per component, all on the shared sink."""
    if component not in _registry:
        lg = logging.getLogger(f"gr_dtl_tpu_torch.{component}")
        lg.propagate = False
        lg.addHandler(_sink())
        if os.environ.get("GR_DTL_TPU_LOG", "1") == "0":
            lg.setLevel(logging.CRITICAL + 1)
        else:
            lg.setLevel(os.environ.get("GR_DTL_TPU_LOG_LEVEL", "WARNING"))
        _registry[component] = lg
    return _registry[component]


def set_log_level(level: int | str) -> None:
    """Apply a level to every registered logger."""
    for lg in _registry.values():
        lg.setLevel(level)


def registry() -> t.Mapping[str, logging.Logger]:
    return dict(_registry)
