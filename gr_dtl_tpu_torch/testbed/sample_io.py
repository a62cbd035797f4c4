"""Streaming sample I/O: complex64 sources and sinks over byte streams
(TCP sockets, FIFOs, files); port of gr_dtl_tpu/testbed/sample_io.py.

This is the seam between the modem and a radio front end: the stand-in
for the reference's SDR I/O blocks (``iio_pluto_source`` /
``iio_pluto_sink``) that a ``StreamTx`` / ``StreamRx`` daemon attaches to.
The wire format is raw little-endian complex64 (numpy's on-disk layout,
the format ``tools/replay.py`` reads), so either package's daemon reads
the other's samples: blocking reads of exact sample counts, and a clean
EOF.

- The wire carries *samples*, not packets: any byte offset is a valid
  resume point (receivers lock via Schmidl-Cox, not via framing in the
  transport), which is the property a real radio front end has.
- One duplex TCP connection carries forward OFDM samples one way and the
  reverse burst capture the other way.
- ``SampleSource.read`` returns fewer than the requested samples only at
  EOF: the contract a block-based session loop needs to terminate.

Numpy and sockets only: no torch.
"""

from __future__ import annotations

import os
import socket
import time

import numpy as np

__all__ = [
    "SampleSink", "SampleSource", "SampleEndpoint",
    "listen", "accept_endpoint", "connect", "fifo_sink", "fifo_source",
]

_ITEM = 8  # complex64 on the wire: float32 re, float32 im


class SampleSink:
    """Write complex64 samples to a byte stream (socket or fd)."""

    def __init__(self, sock_or_fd):
        self._sock = sock_or_fd if isinstance(sock_or_fd, socket.socket) else None
        self._fd = sock_or_fd if self._sock is None else None
        self.n_written = 0

    def write(self, samples: np.ndarray) -> None:
        buf = np.ascontiguousarray(samples, dtype=np.complex64).tobytes()
        if self._sock is not None:
            self._sock.sendall(buf)
        else:
            view = memoryview(buf)
            while view:
                n = os.write(self._fd, view)
                view = view[n:]
        self.n_written += len(samples)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass
        else:
            os.close(self._fd)


class SampleSource:
    """Read exact complex64 sample counts from a byte stream.

    ``read(n)`` blocks until n samples arrive; a short result means EOF.
    A partial trailing item (torn write / truncated capture) is
    discarded — a real front-end never delivers half a sample.
    """

    def __init__(self, sock_or_fd):
        self._sock = sock_or_fd if isinstance(sock_or_fd, socket.socket) else None
        self._fd = sock_or_fd if self._sock is None else None
        self._rest = b""
        self.n_read = 0
        self.eof = False

    def read(self, n: int) -> np.ndarray:
        want = n * _ITEM
        chunks = [self._rest]
        have = len(self._rest)
        while have < want and not self.eof:
            if self._sock is not None:
                b = self._sock.recv(min(1 << 20, want - have))
            else:
                b = os.read(self._fd, min(1 << 20, want - have))
            if not b:
                self.eof = True
                break
            chunks.append(b)
            have += len(b)
        buf = b"".join(chunks)
        usable = min(want, (len(buf) // _ITEM) * _ITEM)
        self._rest = buf[usable:] if usable == want else b""
        out = np.frombuffer(buf[:usable], dtype=np.complex64)
        self.n_read += len(out)
        return out

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        else:
            os.close(self._fd)


class SampleEndpoint:
    """Duplex sample link over one TCP connection: ``source`` reads the
    peer's samples, ``sink`` writes ours (the two RF directions of the
    Pluto example collapsed onto one socket)."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.source = SampleSource(sock)
        self.sink = SampleSink(sock)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def listen(host: str = "127.0.0.1", port: int = 0):
    """Bind + listen; returns (server_socket, bound_port).  Call
    ``accept_endpoint`` (or ``server.accept()``) to get the link."""
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(1)
    return srv, srv.getsockname()[1]


def accept_endpoint(server: socket.socket, timeout: float | None = None
                    ) -> SampleEndpoint:
    server.settimeout(timeout)
    conn, _ = server.accept()
    return SampleEndpoint(conn)


def connect(host: str, port: int, timeout: float = 30.0) -> SampleEndpoint:
    """Connect to a sample peer, retrying until ``timeout``.

    ``create_connection`` treats its timeout as per-attempt and fails
    immediately with ECONNREFUSED if the peer hasn't bound yet — but the
    standard deployment starts both halves concurrently (the RX daemon
    imports torch and builds its receiver *before* binding its listen
    socket), so the first attempts are expected to be refused.  Retry with backoff until the
    deadline instead."""
    deadline = time.monotonic() + timeout
    delay = 0.05
    while True:
        try:
            sock = socket.create_connection(
                (host, port), timeout=max(0.1, deadline - time.monotonic()))
            break
        except OSError:
            if time.monotonic() + delay > deadline:
                raise
            time.sleep(delay)
            delay = min(delay * 1.6, 1.0)
    sock.settimeout(None)
    return SampleEndpoint(sock)


def _ensure_fifo(path: str) -> None:
    # both ends race to create the pipe (reader and writer start
    # concurrently by design) — EEXIST from the loser is fine
    try:
        os.mkfifo(path)
    except FileExistsError:
        pass


def fifo_sink(path: str) -> SampleSink:
    """Open (creating if needed) a named pipe for writing samples."""
    _ensure_fifo(path)
    return SampleSink(os.open(path, os.O_WRONLY))


def fifo_source(path: str) -> SampleSource:
    _ensure_fifo(path)
    return SampleSource(os.open(path, os.O_RDONLY))
