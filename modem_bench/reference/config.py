"""A configuration file's numerology as the reference modem reads it.

The keys are gr-dtl's (``python/dtl/ofdm_adaptive_config.py``, its JSON
files); a key the file leaves out takes that module's default.  The sync
words are the modem's own PN words from a fixed seed.
"""

from __future__ import annotations

import dataclasses as dc

import numpy as np

PILOT_SYM_SCRAMBLE_SEQ = (
    1, 1, 1, 1, -1, -1, -1, 1, -1, -1, -1, -1, 1, 1, -1, 1,
    -1, -1, 1, 1, -1, 1, 1, -1, 1, 1, 1, 1, 1, 1, -1, 1,
    1, 1, -1, 1, 1, -1, -1, 1, 1, 1, -1, 1, -1, -1, -1, 1,
    -1, 1, -1, -1, 1, -1, -1, 1, 1, 1, 1, 1, -1, -1, 1, 1,
    -1, -1, 1, -1, 1, -1, 1, 1, -1, -1, -1, 1, 1, -1, -1, -1,
    -1, 1, -1, -1, 1, -1, 1, 1, 1, 1, -1, 1, -1, 1, -1, 1,
    -1, -1, -1, -1, -1, 1, -1, 1, 1, -1, 1, -1, 1, 1, 1, -1,
    -1, 1, -1, -1, -1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1,
)
OCCUPIED = tuple(list(range(-26, -21)) + list(range(-20, -7)) + list(range(-6, 0))
                 + list(range(1, 7)) + list(range(8, 21)) + list(range(22, 27)))
PILOTS = (-21, -7, 7, 21)
SYNC_SEED = 42


@dc.dataclass(frozen=True)
class Numerology:
    fft_len: int = 64
    cp_len: int = 16
    occupied_carriers: tuple = OCCUPIED
    pilot_carriers: tuple = PILOTS
    pilot_sym_scramble_seq: tuple = PILOT_SYM_SCRAMBLE_SEQ
    frame_length: int = 20
    fec: bool = False
    scramble_bits: bool = False
    eq_alpha: float = 0.8
    eq_passes: int = 2
    eq_pass2_alpha: float = 0.95

    @property
    def n_data_carriers(self) -> int:
        return len(self.occupied_carriers)

    @property
    def header_symbols(self) -> int:
        return 2 if self.fec else 1

    @property
    def n_sync_symbols(self) -> int:
        return 2

    @property
    def frame_ofdm_symbols(self) -> int:
        return self.n_sync_symbols + self.header_symbols + self.frame_length

    @property
    def symbol_len(self) -> int:
        return self.fft_len + self.cp_len

    @property
    def frame_samples(self) -> int:
        return self.frame_ofdm_symbols * self.symbol_len

    @property
    def frame_capacity_symbols(self) -> int:
        return self.frame_length * self.n_data_carriers

    def frame_bytes(self, bps: int) -> int:
        """Payload bytes of a frame, CRC32 included, at ``bps`` bits a symbol."""
        return self.frame_capacity_symbols * bps // 8

    def max_frame_bytes(self) -> int:
        return self.frame_bytes(4)

    def _active(self):
        return sorted(set(self.occupied_carriers) | set(self.pilot_carriers))

    def sync_word1(self) -> np.ndarray:
        """PN(+-sqrt 2) on the even active carriers: the useful part repeats
        with period fft_len / 2 (the Schmidl-Cox symbol)."""
        rng = np.random.RandomState(SYNC_SEED)
        w = np.zeros(self.fft_len, np.complex64)
        for c in self._active():
            v = np.sqrt(2.0) * (1.0 - 2.0 * rng.randint(2))
            if c % 2 == 0 and c != 0:
                w[c + self.fft_len // 2] = v
        return w

    def sync_word2(self) -> np.ndarray:
        """PN(+-1) on every active carrier (the channel estimate's word)."""
        rng = np.random.RandomState(SYNC_SEED + 1)
        w = np.zeros(self.fft_len, np.complex64)
        for c in self._active():
            w[c + self.fft_len // 2] = 1.0 - 2.0 * rng.randint(2)
        return w


def numerology(cfg: dict) -> Numerology:
    """The :class:`Numerology` of a configuration dict; unknown keys are
    left to other readers."""
    kw = {}
    for f in dc.fields(Numerology):
        if f.name in cfg:
            v = cfg[f.name]
            kw[f.name] = tuple(v) if isinstance(v, list) else v
    num = Numerology(**kw)
    if num.scramble_bits:
        raise ValueError("the reference modem has no scrambler: no configuration states one")
    return num
