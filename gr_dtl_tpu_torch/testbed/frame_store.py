"""Binary frame store: a per-frame payload log keyed by frame number (port
of gr_dtl_tpu/testbed/frame_store.py).

The file format is the JAX package's, byte for byte, so an offline BER
scorer reads either side's captures:

    record := [len : int32 LE][long_frame_no : uint64 LE][payload bytes]

The 12-bit on-air frame number is unwrapped to a monotonically increasing
64-bit counter; a record whose short number repeats, or jumps backwards by
more than half the 12-bit range, is skipped.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["FrameStore", "read_frames"]

_HDR = struct.Struct("<iQ")


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


class FrameStore:
    """Append-only frame log with 12-bit -> 64-bit unwrapping."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._last_short = -1
        self._base = 0
        self._started = False

    def store(self, payload: bytes, frame_no: int) -> None:
        frame_no &= 0xFFF
        if not self._started:
            self._started = True
            self._last_short = frame_no
        else:
            delta = (frame_no - self._last_short) & 0xFFF
            if delta == 0:
                return  # duplicate
            if delta > 2048:
                return  # a backwards glitch: skipped
            if frame_no < self._last_short:
                self._base += 1 << 12
            self._last_short = frame_no
        long_no = self._base + frame_no
        self._f.write(_HDR.pack(len(payload), long_no))
        self._f.write(payload)

    def store_batch(self, rx_out, valid=None) -> None:
        """Store every CRC-passing frame of an ``RxOut`` (or ``TxOut``-like)
        batch.  Its tensors may live on the device: the four fields are
        copied to the host once a batch.

        ``valid``: optional [B] bool mask of real frame slots (a streaming
        session's trigger-lock validity): a CRC-passing frame in an invalid
        slot (a tail re-detection duplicate) does not reach the store."""
        payload = _host(rx_out.payload)
        plen = _host(rx_out.payload_len)
        nos = _host(rx_out.frame_no)
        crc_ok = getattr(rx_out, "crc_ok", None)
        ok = np.ones(len(nos), bool) if crc_ok is None else _host(crc_ok).astype(bool)
        if valid is not None:
            ok = ok & _host(valid).astype(bool)
        for i in range(payload.shape[0]):
            if ok[i]:
                self.store(payload[i, : plen[i]].tobytes(), int(nos[i]))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_frames(path: str):
    """Yield (long_frame_no, payload bytes) records."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                return
            length, no = _HDR.unpack(hdr)
            yield no, f.read(length)
