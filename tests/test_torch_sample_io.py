"""The port's sample I/O (gr_dtl_tpu_torch/testbed/sample_io.py) against
the JAX package's: the same raw complex64 wire, so either side's sink
feeds the other's source byte for byte, over a socket and a FIFO; chunked
reads reassemble at any byte boundary; a short read means EOF, and EOF
stays; ``connect`` retries until the peer binds."""

import socket
import threading
import time

import numpy as np
import pytest

from gr_dtl_tpu.testbed import sample_io as ref_io
from gr_dtl_tpu_torch.testbed import sample_io as io

PAIRS = [("port_to_ref", io, ref_io), ("ref_to_port", ref_io, io)]


def _samples(n: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)


@pytest.mark.parametrize("name,tx_mod,rx_mod", PAIRS, ids=[p[0] for p in PAIRS])
def test_socket_link_between_packages(name, tx_mod, rx_mod):
    """A sink of one package, a source of the other, over TCP, both ways
    on one connection: equal bytes, exact counts, EOF after the close."""
    x = _samples(3001, 1)
    srv, port = rx_mod.listen()
    got = {}

    def server():
        ep = rx_mod.accept_endpoint(srv, timeout=10)
        got["x"] = ep.source.read(len(x))
        got["eof"] = ep.source.read(10)
        ep.sink.write(got["x"][::-1].copy())
        ep.close()

    t = threading.Thread(target=server)
    t.start()
    ep = tx_mod.connect("127.0.0.1", port, timeout=10)
    ep.sink.write(x[:1000])
    ep.sink.write(x[1000:])
    ep.sink.close()  # half-close: the peer sees EOF after the samples
    back = ep.source.read(len(x))
    t.join(timeout=10)
    assert not t.is_alive()
    ep.close()
    srv.close()
    assert got["x"].tobytes() == x.tobytes()
    assert len(got["eof"]) == 0
    assert back.tobytes() == x[::-1].tobytes()
    assert ep.sink.n_written == len(x) and ep.source.n_read == len(x)


@pytest.mark.parametrize("name,tx_mod,rx_mod", PAIRS, ids=[p[0] for p in PAIRS])
def test_fifo_between_packages(tmp_path, name, tx_mod, rx_mod):
    path = str(tmp_path / "samples.fifo")
    x = _samples(777, 2)
    res = {}

    def reader():
        src = rx_mod.fifo_source(path)
        res["y"] = src.read(len(x))
        res["eof"] = src.read(1)
        src.close()

    t = threading.Thread(target=reader)
    t.start()
    sink = tx_mod.fifo_sink(path)
    sink.write(x)
    sink.close()
    t.join(timeout=10)
    assert not t.is_alive()
    assert res["y"].tobytes() == x.tobytes() and len(res["eof"]) == 0


@pytest.mark.parametrize("cuts", [[3, 13, 1, 100, 7, 1024], [1] * 40 + [5000], [8, 8, 4, 12]])
def test_chunked_reads_any_boundary(cuts):
    """Writes cut at any byte (mid-sample included) reassemble exactly in
    both packages' sources, read in the same odd counts."""
    x = np.arange(257, dtype=np.complex64) * (1 - 0.5j)
    raw = x.tobytes()
    outs = []
    for mod in (io, ref_io):
        a, b = socket.socketpair()
        src = mod.SampleSource(a)

        def writer():
            i = 0
            for n in cuts + [len(raw)]:
                b.sendall(raw[i: i + n])
                i += n
                if i >= len(raw):
                    break
            b.close()

        t = threading.Thread(target=writer)
        t.start()
        parts = [src.read(100), src.read(57), src.read(100)]
        t.join(timeout=10)
        assert not t.is_alive()
        assert len(src.read(5)) == 0 and src.eof
        outs.append(np.concatenate(parts))
        a.close()
    assert outs[0].tobytes() == x.tobytes() == outs[1].tobytes()


def test_eof_contract_torn_sample():
    """A capture cut inside a sample: the short read at EOF returns the
    whole samples only, the torn half is dropped, and EOF is sticky; the
    reference does the same."""
    x = _samples(10, 3)
    raw = x.tobytes()[:-3]  # 9 whole samples and 5 bytes of the tenth
    outs = []
    for mod in (io, ref_io):
        a, b = socket.socketpair()
        b.sendall(raw)
        b.close()
        src = mod.SampleSource(a)
        first = src.read(6)
        second = src.read(6)  # short: EOF
        outs.append((first.tobytes(), second.tobytes(), len(src.read(6)), src.eof, src.n_read))
        a.close()
    assert outs[0] == outs[1]
    assert outs[0][0] == x[:6].tobytes() and outs[0][1] == x[6:9].tobytes()
    assert outs[0][2:] == (0, True, 9)


def test_connect_before_listen_binds():
    """The TX may start first: ``connect`` retries until the RX binds."""
    port = io.listen()[0]
    port_no = port.getsockname()[1]
    port.close()  # free the port; nothing listens now
    res = {}

    def late_server():
        time.sleep(0.6)
        srv, _ = io.listen(port=port_no)
        ep = io.accept_endpoint(srv, timeout=10)
        res["y"] = ep.source.read(64)
        ep.close()
        srv.close()

    t = threading.Thread(target=late_server)
    t.start()
    t0 = time.monotonic()
    ep = io.connect("127.0.0.1", port_no, timeout=10)
    waited = time.monotonic() - t0
    x = _samples(64, 4)
    ep.sink.write(x)
    ep.sink.close()
    t.join(timeout=10)
    assert not t.is_alive()
    ep.close()
    assert waited >= 0.5
    assert res["y"].tobytes() == x.tobytes()


def test_connect_gives_up_at_its_deadline():
    srv, port_no = io.listen()
    srv.close()
    t0 = time.monotonic()
    with pytest.raises(OSError):
        io.connect("127.0.0.1", port_no, timeout=0.5)
    assert time.monotonic() - t0 < 5
