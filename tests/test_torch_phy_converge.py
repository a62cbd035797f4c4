"""The port's convergence layer (gr_dtl_tpu_torch/testbed/phy_converge.py,
its own g++ build of native/phy_converge.cpp in gr_dtl_tpu_torch/_build/)
against the JAX package's (the tracked native/libdtl_testbed.so): the same
packets through both packages' validators, deframer and framer give the
same results; the port never loads or writes the tracked library."""

import hashlib
import struct
from pathlib import Path

import numpy as np
import pytest

from gr_dtl_tpu.testbed import phy_converge as ref
from gr_dtl_tpu_torch.testbed import phy_converge as port

ROOT = Path(__file__).resolve().parent.parent
TRACKED = ROOT / "native" / "libdtl_testbed.so"
MAC = "02:50:aa:bb:cc:01"
MAC_B = bytes(int(x, 16) for x in MAC.split(":"))
SRC_B = b"\x02\x50\xaa\xbb\xcc\x02"


def _ipv4(payload: bytes, ident: int = 0x1234) -> bytes:
    total = 20 + len(payload)
    hdr = bytearray(struct.pack("!BBHHHBBH4s4s", 0x45, 0, total, ident, 0, 64, 17, 0,
                                bytes([10, 0, 0, 1]), bytes([10, 0, 0, 2])))
    s = sum((hdr[i] << 8) | hdr[i + 1] for i in range(0, 20, 2))
    s = (s & 0xFFFF) + (s >> 16)
    s = (s & 0xFFFF) + (s >> 16)
    struct.pack_into("!H", hdr, 10, (~s) & 0xFFFF)
    return bytes(hdr) + payload


def _ether(payload: bytes, dst=MAC_B) -> bytes:
    return dst + SRC_B + b"\x08\x00" + payload


def _cases():
    rng = np.random.RandomState(0)
    ip = [_ipv4(rng.bytes(n), i) for i, n in enumerate((0, 11, 30, 200, 1400))]
    bad = bytearray(ip[2])
    bad[12] ^= 0xFF  # checksum fails
    return {
        "ipv4": ip,
        "ipv4_bad_checksum": [bytes(bad)],
        "ipv4_truncated": [ip[3][:30], ip[3][:10]],
        "ether": [_ether(p) for p in ip],
        "ether_other_mac": [_ether(ip[1], b"\xff" * 6)],
        "modified_ether": [MAC_B + SRC_B + rng.bytes(n) for n in (7, 40, 100)],
        "garbage": [b"\x00\x01\x02\x03" * 10, rng.bytes(97), b""],
    }


@pytest.fixture(scope="module")
def tracked_hash():
    """The tracked library's hash before the port builds or loads anything."""
    return hashlib.sha256(TRACKED.read_bytes()).hexdigest()


@pytest.mark.parametrize("proto", list(port.Protocol), ids=lambda p: p.name)
@pytest.mark.parametrize("mac", [MAC, "ff:ff:ff:ff:ff:ff"])
def test_validators_match_reference(tracked_hash, proto, mac):
    for name, bufs in _cases().items():
        for buf in bufs:
            want = ref.validate_packet(ref.Protocol(int(proto)), buf, mac)
            assert port.validate_packet(proto, buf, mac) == want, (name, len(buf))


def test_bad_mac_refused_like_reference():
    for mod in (port, ref):
        with pytest.raises(ValueError):
            mod.validate_packet(mod.Protocol.ETHER_IPV4, b"\x00" * 40, "zz:00")
        with pytest.raises(ValueError):
            mod.FromPhy(mod.Protocol.ETHER_IPV4, "not-a-mac")


@pytest.mark.parametrize("proto", list(port.Protocol), ids=lambda p: p.name)
def test_framer_and_deframer_match_reference(proto):
    """to_phy_frame of every case, the frames concatenated into one decoded
    modem byte stream with garbage between, cut into chunks at odd offsets
    (a jumbo packet split across calls among them): both packages' deframers
    return the same packets at every call."""
    cases = _cases()
    pdus = (cases["ipv4"] if proto == port.Protocol.IPV4_ONLY
            else cases["ether"] if proto == port.Protocol.ETHER_IPV4
            else cases["modified_ether"])
    frames = []
    for p in pdus:
        want = ref.to_phy_frame(ref.Protocol(int(proto)), p)
        assert port.to_phy_frame(proto, p) == want
        frames.append(want)
    stream = b"".join(f + g for f, g in zip(frames, cases["garbage"] * 3))
    cuts = [0, 5, 50, 51, 300, 700, 701, len(stream)]
    fp_port, fp_ref = port.FromPhy(proto, MAC), ref.FromPhy(ref.Protocol(int(proto)), MAC)
    got = []
    for a, b in zip(cuts, cuts[1:]):
        chunk = stream[a:b]
        want = fp_ref.process(chunk)
        assert fp_port.process(chunk) == want, (a, b)
        got += want
    fp_port.close()
    fp_ref.close()
    assert got  # the deframer delivered packets


def test_jumbo_across_calls_matches_reference():
    rng = np.random.RandomState(1)
    pdu = MAC_B + SRC_B + rng.bytes(3000)
    stream = port.to_phy_frame(port.Protocol.MODIFIED_ETHER, pdu)
    outs = []
    for mod in (port, ref):
        fp = mod.FromPhy(mod.Protocol.MODIFIED_ETHER, MAC)
        outs.append([fp.process(stream[a:b]) for a, b in ((0, 50), (50, 1500), (1500, len(stream)))])
        fp.close()
    assert outs[0] == outs[1]
    assert b"".join(sum(outs[0], [])).endswith(pdu[-100:])


def test_port_builds_its_own_library_and_leaves_native_alone(tracked_hash):
    lib = port.load_lib()
    path = Path(lib._name).resolve()
    assert path == port.library_path().resolve()
    assert path.parent == (ROOT / "gr_dtl_tpu_torch" / "_build").resolve()
    assert path != TRACKED.resolve()
    assert port.SOURCE.resolve() == (ROOT / "native" / "phy_converge.cpp").resolve()
    assert hashlib.sha256(TRACKED.read_bytes()).hexdigest() == tracked_hash
    assert sorted(p.name for p in (ROOT / "native").iterdir()
                  if p.name != "__pycache__") == ["Makefile", "libdtl_testbed.so", "phy_converge.cpp"]


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails makes the build raise; the tracked library is
    not taken instead."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(port, "SOURCE", bad)
    monkeypatch.setattr(port._cuda_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        port.build()
