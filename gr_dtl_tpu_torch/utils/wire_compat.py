"""Wire-format compatibility: load foreign air-interface constants from a
JSON file and install them package-wide (port of
gr_dtl_tpu/utils/wire_compat.py).

The native constellations and sync words are self-chosen (Gray label ->
point layouts in ``ops/constellation``, PN sync words from a fixed seed in
``utils/config``).  A wire-constants file carries another modem's exact
label -> point tables and frequency-domain sync words; :func:`activate`
installs them **before a model is built**: models read the tables and sync
words when they are built (``build_tx`` / ``build_rx`` and the sessions
that call them), so a model built earlier keeps its own.

What switches when activated:

- ``ops/constellation`` point tables become the file's label -> point maps,
  and decisions take the table reductions (the closed-form slicers assume
  the native Gray layouts); the equalizer kernel slices by table too;
- ``utils/config`` sync-word makers return the file's vectors.
"""

from __future__ import annotations

import json

import numpy as np

from gr_dtl_tpu_torch.ops import constellation as cn

__all__ = ["load", "activate", "deactivate", "dump_native", "SCHEMA_KEYS"]

# constellation-type name -> id, fixed by the protocol
_TYPE_OF_NAME = {
    "bpsk": int(cn.ConstellationType.BPSK),
    "qpsk": int(cn.ConstellationType.QPSK),
    "psk8": int(cn.ConstellationType.PSK8),
    "qam16": int(cn.ConstellationType.QAM16),
}

SCHEMA_KEYS = ("fft_len", "constellations", "sync_word1", "sync_word2")

_active: dict | None = None


def _c64(pairs) -> np.ndarray:
    a = np.asarray(pairs, np.float32)
    if a.ndim != 2 or a.shape[1] != 2:
        raise ValueError("expected a list of [re, im] pairs")
    return (a[:, 0] + 1j * a[:, 1]).astype(np.complex64)


def load(path) -> dict:
    """Load and validate a wire-constants JSON file (or its contents,
    already read into a dict).

    Schema::

        {"fft_len": 64,
         "constellations": {"bpsk": [[re, im] x 2], "qpsk": [... x 4],
                            "psk8": [... x 8], "qam16": [... x 16]},
         "sync_word1": [[re, im] x fft_len],   # centered frequency domain
         "sync_word2": [[re, im] x fft_len]}

    Returns {"fft_len", "points": {type id: complex64 [2^bps]},
    "sync_word1", "sync_word2"}.
    """
    if isinstance(path, dict):
        raw = path
    else:
        with open(path) as f:
            raw = json.load(f)
    for k in SCHEMA_KEYS:
        if k not in raw:
            raise ValueError(f"wire constants file missing key {k!r}")
    fft_len = int(raw["fft_len"])
    consts = {"fft_len": fft_len, "points": {}}
    missing = [n for n in _TYPE_OF_NAME if n not in raw["constellations"]]
    if missing:
        # a partial table would mix native and foreign labels
        raise ValueError(
            "wire constants file is missing constellation entries "
            f"{missing!r}; all of {sorted(_TYPE_OF_NAME)} are required")
    for name, ty in _TYPE_OF_NAME.items():
        p = _c64(raw["constellations"][name])
        want = 1 << int(cn.BITS_PER_SYMBOL[ty])
        if p.shape != (want,):
            raise ValueError(f"{name}: expected {want} points, got {p.shape[0]}")
        consts["points"][ty] = p
    for k in ("sync_word1", "sync_word2"):
        w = _c64(raw[k])
        if w.shape != (fft_len,):
            raise ValueError(f"{k}: expected {fft_len} bins, got {w.shape[0]}")
        consts[k] = w
    return consts


def activate(consts_or_path) -> None:
    """Install wire constants package-wide (call before building models):
    a file's path, its contents as read by ``json.load``, or what
    :func:`load` returns."""
    global _active
    loaded = isinstance(consts_or_path, dict) and "points" in consts_or_path
    consts = consts_or_path if loaded else load(consts_or_path)
    from gr_dtl_tpu_torch.utils import config as cfgmod

    cn.set_wire_points(consts["points"])
    cfgmod.set_wire_sync_words(consts["sync_word1"], consts["sync_word2"])
    _active = consts


def deactivate() -> None:
    """Restore the native constants (for models built afterwards)."""
    global _active
    from gr_dtl_tpu_torch.utils import config as cfgmod

    cn.reset_points()
    cfgmod.set_wire_sync_words(None, None)
    _active = None


def dump_native(fft_len: int = 64) -> dict:
    """The native constants in the wire-constants schema: activating them
    changes no byte on the air, and they are a template for a hand-edited
    file."""
    from gr_dtl_tpu_torch.utils import config as cfgmod

    def pairs(z):
        return [[float(v.real), float(v.imag)] for v in np.asarray(z)]

    out = {"fft_len": fft_len, "constellations": {}}
    for name, ty in _TYPE_OF_NAME.items():
        n = 1 << int(cn.BITS_PER_SYMBOL[ty])
        out["constellations"][name] = pairs(cn._DEFAULT_POINTS[ty, :n])
    out["sync_word1"] = pairs(cfgmod.make_sync_word1(fft_len))
    out["sync_word2"] = pairs(cfgmod.make_sync_word2(fft_len))
    return out
