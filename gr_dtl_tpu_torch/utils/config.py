"""Configuration dataclasses + JSON override (port of gr_dtl_tpu/utils/config.py).

Numpy only: same OFDM numerology defaults (fft 64, cp 16, 48 data + 4
pilot carriers, 127-long pilot scramble sequence, frame of 20 payload
symbols), same MCS ladder, same layered override scheme (dataclass
defaults <- JSON dict <- kwargs), same self-chosen sync words from a
fixed seed.  The wire-compat override (foreign sync words and
constellation labels) is not ported yet; a config that asks for it
raises.
"""

from __future__ import annotations

import dataclasses as dc
import json
import sys
import typing as t

import numpy as np

from gr_dtl_tpu_torch.ops.constellation import ConstellationType

__all__ = [
    "OFDMConfig",
    "TxConfig",
    "RxConfig",
    "FullDuplexConfig",
    "make_tx_config",
    "make_rx_config",
    "make_full_duplex_config",
    "make_sync_word1",
    "make_sync_word2",
    "config_from_reference",
]

# 127-long pilot scramble sequence (ref ofdm_adaptive_config.py:21-32)
PILOT_SYM_SCRAMBLE_SEQ: t.Tuple[int, ...] = (
    1, 1, 1, 1, -1, -1, -1, 1, -1, -1, -1, -1, 1, 1, -1, 1,
    -1, -1, 1, 1, -1, 1, 1, -1, 1, 1, 1, 1, 1, 1, -1, 1,
    1, 1, -1, 1, 1, -1, -1, 1, 1, 1, -1, 1, -1, -1, -1, 1,
    -1, 1, -1, -1, 1, -1, -1, 1, 1, 1, 1, 1, -1, -1, 1, 1,
    -1, -1, 1, -1, 1, -1, 1, 1, -1, -1, -1, 1, 1, -1, -1, -1,
    -1, 1, -1, -1, 1, -1, 1, 1, 1, 1, -1, 1, -1, 1, -1, 1,
    -1, -1, -1, -1, -1, 1, -1, 1, 1, -1, 1, -1, 1, 1, 1, -1,
    -1, 1, -1, -1, -1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1,
)

# default occupied data carriers (48), centered indexing
DEFAULT_OCCUPIED_CARRIERS: t.Tuple[int, ...] = tuple(
    list(range(-26, -21)) + list(range(-20, -7)) + list(range(-6, 0))
    + list(range(1, 7)) + list(range(8, 21)) + list(range(22, 27))
)
DEFAULT_PILOT_CARRIERS: t.Tuple[int, ...] = (-21, -7, 7, 21)

_SYNC_SEED = 42


def _active_carriers(occupied, pilots):
    return sorted(set(occupied) | set(pilots))


def make_sync_word1(fft_len=64, occupied=DEFAULT_OCCUPIED_CARRIERS,
                    pilots=DEFAULT_PILOT_CARRIERS) -> np.ndarray:
    """Schmidl-Cox sync word 1: PN(+-sqrt(2)) on even active carriers.

    Energy only on even (centered) carriers -> the 64-sample useful part
    repeats with period 32, which the Schmidl-Cox autocorrelator detects.
    Returned as a centered length-fft_len frequency-domain vector.
    """
    rng = np.random.RandomState(_SYNC_SEED)
    w = np.zeros(fft_len, dtype=np.complex64)
    for c in _active_carriers(occupied, pilots):
        v = np.sqrt(2.0) * (1.0 - 2.0 * rng.randint(2))
        if c % 2 == 0 and c != 0:
            w[c + fft_len // 2] = v
    return w


def make_sync_word2(fft_len=64, occupied=DEFAULT_OCCUPIED_CARRIERS,
                    pilots=DEFAULT_PILOT_CARRIERS) -> np.ndarray:
    """Sync word 2: PN(+-1) on all active carriers (channel estimation)."""
    rng = np.random.RandomState(_SYNC_SEED + 1)
    w = np.zeros(fft_len, dtype=np.complex64)
    for c in _active_carriers(occupied, pilots):
        w[c + fft_len // 2] = 1.0 - 2.0 * rng.randint(2)
    return w


@dc.dataclass
class OFDMConfig:
    """Adaptive-OFDM modem configuration (field for field the reference's)."""

    fft_len: int = 64
    cp_len: int = 16
    occupied_carriers: t.Tuple[int, ...] = DEFAULT_OCCUPIED_CARRIERS
    pilot_carriers: t.Tuple[int, ...] = DEFAULT_PILOT_CARRIERS
    pilot_sym_scramble_seq: t.Tuple[int, ...] = PILOT_SYM_SCRAMBLE_SEQ
    rolloff: int = 0
    scramble_bits: bool = False
    wire_compat: str = ""  # not ported: a non-empty value raises
    frame_length: int = 20  # payload OFDM symbols per frame
    frame_store_folder: str = "/tmp"
    fec: bool = False
    fec_codes: t.Tuple[t.Tuple[str, str], ...] = ()
    # MCS ladder: (snr_threshold_dB, (constellation, fec_code_name))
    mcs: t.Tuple[t.Tuple[float, t.Tuple[ConstellationType, str]], ...] = (
        (sys.float_info.min, (ConstellationType.BPSK, "no_fec")),
        (13.0, (ConstellationType.QPSK, "no_fec")),
        (18.0, (ConstellationType.PSK8, "no_fec")),
        (23.0, (ConstellationType.QAM16, "no_fec")),
    )
    initial_mcs_id: int = 0
    # channel-tracking EMA: new taps = eq_alpha*old + (1-eq_alpha)*new
    eq_alpha: float = 0.8
    # equalization passes: 2 adds the data-aided LS re-estimation pass
    eq_passes: int = 2
    # channel-tracking EMA for the refinement pass
    eq_pass2_alpha: float = 0.95
    batch_frames: int = 32

    # ----- derived geometry -----
    @property
    def n_data_carriers(self) -> int:
        return len(self.occupied_carriers)

    @property
    def n_pilot_carriers(self) -> int:
        return len(self.pilot_carriers)

    @property
    def header_symbols(self) -> int:
        """OFDM symbols for the header: 1 short, 2 with FEC."""
        return 2 if self.fec else 1

    @property
    def n_sync_symbols(self) -> int:
        return 2

    @property
    def frame_ofdm_symbols(self) -> int:
        """sync + header + payload symbols per frame."""
        return self.n_sync_symbols + self.header_symbols + self.frame_length

    @property
    def symbol_len(self) -> int:
        return self.fft_len + self.cp_len

    @property
    def frame_samples(self) -> int:
        return self.frame_ofdm_symbols * self.symbol_len

    @property
    def frame_capacity_symbols(self) -> int:
        """Data (payload) complex symbols per frame."""
        return self.frame_length * self.n_data_carriers

    def frame_bytes(self, bps: int) -> int:
        """Total payload bytes per frame incl. CRC32 at a given bps."""
        return self.frame_capacity_symbols * bps // 8

    def max_frame_bytes(self) -> int:
        return self.frame_bytes(4)

    @property
    def header_bits(self) -> int:
        return self.header_symbols * self.n_data_carriers

    def sync_word1(self) -> np.ndarray:
        return make_sync_word1(self.fft_len, self.occupied_carriers, self.pilot_carriers)

    def sync_word2(self) -> np.ndarray:
        return make_sync_word2(self.fft_len, self.occupied_carriers, self.pilot_carriers)

    def mcs_constellations(self) -> t.List[ConstellationType]:
        return [c for _, (c, _) in self.mcs]

    def mcs_snr_thresholds(self) -> t.List[float]:
        return [s for s, _ in self.mcs]


@dc.dataclass
class TxConfig(OFDMConfig):
    max_empty_frames: int = -1
    sample_rate: int = 700000


@dc.dataclass
class RxConfig(OFDMConfig):
    sync_threshold: float = 0.95
    use_sync_correct: bool = True


@dc.dataclass
class FullDuplexConfig(OFDMConfig):
    sync_threshold: float = 0.95
    use_sync_correct: bool = True
    max_empty_frames: int = -1
    sample_rate: int = 700000


_CNST_NAMES = {
    "bpsk": ConstellationType.BPSK,
    "qpsk": ConstellationType.QPSK,
    "psk8": ConstellationType.PSK8,
    "qam16": ConstellationType.QAM16,
}


def _parse_mcs(v):
    """JSON mcs entries [[snr, [name, fec]], ...] -> typed tuples.  Integer
    ids (any IntEnum, such as the reference package's) map by value."""
    return tuple(
        (float(snr),
         (ConstellationType(int(cnst)) if isinstance(cnst, int)
          else _CNST_NAMES[str(cnst).lower()], fec))
        for snr, (cnst, fec) in v
    )


def _make_config(cfg, json_dict: t.Optional[dict], **overrides):
    """Key-matched setattr from a JSON dict then kwargs."""
    parsers = {"mcs": _parse_mcs, "fec_codes": lambda v: tuple(tuple(x) for x in v)}
    for source in (json_dict or {}), overrides:
        for key, val in source.items():
            if hasattr(cfg, key):
                setattr(cfg, key, parsers.get(key, lambda v: v)(val))
    if cfg.wire_compat:
        raise NotImplementedError(
            "wire_compat (foreign sync words and constellation labels) is "
            "not ported yet: ROADMAP.md, queue 1, item W1")
    return cfg


def _load(json_dict_or_path):
    if isinstance(json_dict_or_path, str):
        with open(json_dict_or_path) as f:
            return json.load(f)
    return json_dict_or_path


def make_tx_config(json_dict=None, **overrides) -> TxConfig:
    return _make_config(TxConfig(), _load(json_dict), **overrides)


def make_rx_config(json_dict=None, **overrides) -> RxConfig:
    return _make_config(RxConfig(), _load(json_dict), **overrides)


def make_full_duplex_config(json_dict=None, **overrides) -> FullDuplexConfig:
    return _make_config(FullDuplexConfig(), _load(json_dict), **overrides)


def config_from_reference(ref_cfg) -> OFDMConfig:
    """The port's config equal to a reference ``TxConfig``/``RxConfig``/``FullDuplexConfig``
    object (read field by field; the reference package is not imported)."""
    cls = {"TxConfig": TxConfig, "RxConfig": RxConfig,
           "FullDuplexConfig": FullDuplexConfig}[type(ref_cfg).__name__]
    kw = {f.name: getattr(ref_cfg, f.name) for f in dc.fields(cls)}
    return _make_config(cls(), None, **kw)
