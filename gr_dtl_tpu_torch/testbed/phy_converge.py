"""PHY <-> network convergence layer: ctypes over the C++ of
``native/phy_converge.cpp`` (port of gr_dtl_tpu/testbed/phy_converge.py).

The packet validators (IPv4 checksum, Ethernet destination MAC, modified
Ethernet with an inline length field), the ``from_phy`` deframer that
scans decoded modem bytes for packets and reassembles packets delivered in
parts ("jumbo" packets), and the ``to_phy`` framer, with the reference's
byte semantics.

The library is this package's own build of that source: ``g++`` with the
flags of ``native/Makefile`` into ``_build/`` beside the package, named by
a hash of the source and flags and built at first use, as
``ops/_cuda_build`` builds the CUDA sources.  Nothing is written under
``native/``, and a failed build raises: the tracked binary there is never
loaded.
"""

from __future__ import annotations

import ctypes
import enum
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from gr_dtl_tpu_torch.ops import _cuda_build

__all__ = ["Protocol", "FromPhy", "to_phy_frame", "validate_packet", "build", "library_path",
           "load_lib"]

SOURCE = _cuda_build.PKG.parent / "native" / "phy_converge.cpp"
CXX_FLAGS = ("-O2", "-Wall", "-fPIC", "-std=c++17", "-shared")  # native/Makefile
_lib = None


class Protocol(enum.IntEnum):
    """Transported protocol (ref include/gnuradio/testbed/phy_converge.h:19)."""

    IPV4_ONLY = 0
    ETHER_IPV4 = 1
    MODIFIED_ETHER = 2


def library_path() -> Path:
    """Where the build of the source as it reads now lives."""
    text = SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    return _cuda_build.BUILD_DIR / f"libphy_converge_{hashlib.sha256(text).hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source with ``g++`` (once per hash of source and flags)."""
    out = library_path()
    if not out.exists():
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("g++ not found on the PATH: it builds native/phy_converge.cpp")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def load_lib() -> ctypes.CDLL:
    """Load (building on first use) the library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.dtl_parse_mac.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.dtl_parse_mac.restype = ctypes.c_int
    lib.dtl_ip_valid.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.POINTER(ctypes.c_size_t)]
    lib.dtl_ip_valid.restype = ctypes.c_int
    for name in ("dtl_ether_valid", "dtl_modified_ether_valid"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                       ctypes.POINTER(ctypes.c_size_t)]
        fn.restype = ctypes.c_int
    lib.dtl_from_phy_new.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.dtl_from_phy_new.restype = ctypes.c_void_p
    lib.dtl_from_phy_free.argtypes = [ctypes.c_void_p]
    lib.dtl_from_phy_free.restype = None
    lib.dtl_from_phy_process.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_long), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.dtl_from_phy_process.restype = ctypes.c_long
    lib.dtl_to_phy_frame.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.dtl_to_phy_frame.restype = ctypes.c_long
    _lib = lib
    return lib


def validate_packet(proto: Protocol, buf: bytes,
                    dst_mac: str = "00:00:00:00:00:00") -> tuple[bool, int]:
    """(valid, packet_len): the reference validators' contract."""
    lib = load_lib()
    plen = ctypes.c_size_t(0)
    if proto == Protocol.IPV4_ONLY:
        ok = lib.dtl_ip_valid(buf, len(buf), ctypes.byref(plen))
    else:
        mac = ctypes.create_string_buffer(6)
        if lib.dtl_parse_mac(dst_mac.encode(), mac) != 0:
            raise ValueError(f"bad MAC: {dst_mac}")
        fn = (lib.dtl_ether_valid if proto == Protocol.ETHER_IPV4
              else lib.dtl_modified_ether_valid)
        ok = fn(buf, len(buf), mac.raw[:6], ctypes.byref(plen))
    return bool(ok), int(plen.value)


class FromPhy:
    """Streaming PHY -> network deframer (ref from_phy_impl.cc:78-180)."""

    def __init__(self, proto: Protocol, dst_mac: str = "00:00:00:00:00:00"):
        self._lib = load_lib()
        self._h = self._lib.dtl_from_phy_new(int(proto), dst_mac.encode())
        if not self._h:
            raise ValueError(f"bad MAC: {dst_mac}")

    def process(self, data: bytes) -> list[bytes]:
        """Feed decoded modem bytes; returns the completed packets."""
        # the output must hold packets completing from the pending (jumbo)
        # buffer, which can be far larger than this call's chunk
        out = ctypes.create_string_buffer(len(data) + 65536 + 64)
        tags = (ctypes.c_long * 256)()
        n_tags = ctypes.c_size_t(0)
        produced = self._lib.dtl_from_phy_process(
            self._h, data, len(data), out, len(out), tags, 128, ctypes.byref(n_tags))
        blob = out.raw[:produced]
        return [blob[tags[2 * i]: tags[2 * i] + tags[2 * i + 1]] for i in range(n_tags.value)]

    def close(self) -> None:
        if self._h:
            self._lib.dtl_from_phy_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def to_phy_frame(proto: Protocol, pdu: bytes) -> bytes:
    """Frame one network PDU for the modem (ref to_phy_impl.cc:86-146)."""
    lib = load_lib()
    out = ctypes.create_string_buffer(len(pdu) + 2)
    n = lib.dtl_to_phy_frame(int(proto), pdu, len(pdu), out, len(out))
    if n < 0:
        raise ValueError("PDU too short / buffer too small")
    return out.raw[:n]
