"""Live IP traffic through the modem via a tun interface (port of
tools/tun_bridge.py).

The analog of the reference's tun/tap convergence-layer testbed
(``docs/local_tuntap_test_env.md``, SURVEY.md #34-37): a tun device
feeds real IP packets into the convergence layer (IPv4 validator +
to_phy/from_phy), which rides the full OFDM modem loopback (TX ->
AWGN channel -> RX); reconstructed packets are echoed back through the
tun with src/dst swapped, so ordinary sockets see their own traffic
served across the modem.

    sudo python -m gr_dtl_tpu_torch.tools.tun_bridge --self-test   # UDP echo across the modem

The tun device needs /dev/net/tun and CAP_NET_ADMIN (root); :class:`ModemPipe`
(packets in, packets out) needs neither, and runs on ``device`` (default
cuda).
"""

from __future__ import annotations

import argparse
import fcntl
import os
import select
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import torch

from gr_dtl_tpu_torch.models import receiver, streaming, transmitter
from gr_dtl_tpu_torch.ops import channel, constellation as cn
from gr_dtl_tpu_torch.testbed.phy_converge import FromPhy, Protocol
from gr_dtl_tpu_torch.tools import _cli
from gr_dtl_tpu_torch.utils import config as cfgmod

__all__ = ["open_tun", "swap_echo", "ModemPipe", "self_test", "main"]

TUNSETIFF = 0x400454CA
IFF_TUN = 0x0001
IFF_NO_PI = 0x1000


def open_tun(name: str = "dtl0", addr: str = "10.99.0.1/24"):
    fd = os.open("/dev/net/tun", os.O_RDWR)
    ifr = struct.pack("16sH", name.encode(), IFF_TUN | IFF_NO_PI)
    fcntl.ioctl(fd, TUNSETIFF, ifr)
    subprocess.run(["ip", "addr", "add", addr, "dev", name], check=True)
    subprocess.run(["ip", "link", "set", name, "up"], check=True)
    return fd


def swap_echo(pkt: bytes) -> bytes:
    """Swap IPv4 src/dst (and UDP/TCP ports): checksums are invariant
    under the swap, so no recompute is needed."""
    b = bytearray(pkt)
    ihl = (b[0] & 0xF) * 4
    b[12:16], b[16:20] = b[16:20], b[12:16]
    proto = b[9]
    if proto in (6, 17) and len(b) >= ihl + 4:
        b[ihl : ihl + 2], b[ihl + 2 : ihl + 4] = b[ihl + 2 : ihl + 4], b[ihl : ihl + 2]
    return bytes(b)


class ModemPipe:
    """Packets -> convergence layer -> OFDM loopback -> packets, on
    ``device``: the PDUs are packed into QPSK frames, modulated, sent
    through AWGN at ``snr_db``, demodulated, and the CRC-passing frames'
    bytes go through the IPv4 deframer.  Pad bytes and noise come from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, snr_db: float = 25.0, frame_length: int = 10, device="cuda",
                 seed: int = 0):
        self.device = torch.device(device)
        self.cfg = cfgmod.make_tx_config(None, frame_length=frame_length)
        self.txp = transmitter.build_tx(self.cfg, self.device)
        self.rxp = receiver.build_rx(cfgmod.make_rx_config(None, frame_length=frame_length),
                                     self.device)
        self.cnst = int(cn.ConstellationType.QPSK)
        self.capacity = self.cfg.frame_bytes(2) - 4
        self.noise_v = float(np.sqrt(0.8 / 10 ** (snr_db / 10)))
        self.deframer = FromPhy(Protocol.IPV4_ONLY)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._seq = 0

    def process(self, packets: list[bytes]) -> list[bytes]:
        payload, plen, _ = streaming.pack_pdus(packets, self.capacity)
        B = payload.shape[0]
        if B == 0:
            return []
        dev = self.device
        maxb = self.cfg.max_frame_bytes()
        payload = np.pad(payload, ((0, 0), (0, maxb - payload.shape[1])))
        pad = torch.randint(0, 256, (B, maxb), generator=self._gen, device=dev, dtype=torch.uint8)
        out = transmitter.tx_frames(
            self.txp, torch.as_tensor(payload, device=dev), torch.as_tensor(plen, device=dev),
            torch.full((B,), self.cnst, dtype=torch.int32, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev),
            (torch.arange(B, dtype=torch.int32, device=dev) + self._seq) % 4096, pad)
        self._seq += B
        noisy = channel.awgn(out.samples, self.noise_v, generator=self._gen)
        rx = receiver.rx_frames(self.rxp, noisy)
        ok, pay, lens = (x.cpu().numpy() for x in (rx.crc_ok, rx.payload, rx.payload_len))
        packets_out = []
        for i in range(B):
            if ok[i]:
                packets_out += self.deframer.process(pay[i, : lens[i]].tobytes())
        return packets_out


def self_test(n_packets: int = 8, timeout_s: float = 60.0,
              out_path: str | None = None, device="cuda") -> int:
    tun = open_tun()
    modem = ModemPipe(device=device)
    # warm up the chain (and build the kernels) before real traffic
    import struct as _s
    dummy = bytearray(_s.pack("!BBHHHBBH4s4s", 0x45, 0, 28, 1, 0, 64, 17, 0,
                              socket.inet_aton("10.99.0.1"),
                              socket.inet_aton("10.99.0.2"))) + bytes(8)
    modem.process([bytes(dummy)])

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("10.99.0.1", 0))
    sock.settimeout(0.5)
    sent = {}
    for i in range(n_packets):
        msg = f"dtl-tpu live packet {i}".encode() * 3
        sent[msg] = False
        sock.sendto(msg, ("10.99.0.2", 5005))

    echoed = 0
    deadline = time.time() + timeout_s
    while echoed < n_packets and time.time() < deadline:
        # drain whatever the kernel queued on the tun, batch it through
        # the modem, echo it back
        pkts = []
        while True:
            r, _, _ = select.select([tun], [], [], 0.2)
            if not r:
                break
            pkts.append(os.read(tun, 4096))
        for pkt in modem.process(pkts):
            os.write(tun, swap_echo(pkt))
        try:
            while True:
                data, addr = sock.recvfrom(4096)
                if data in sent and not sent[data] and addr[0] == "10.99.0.2":
                    sent[data] = True
                    echoed += 1
        except socket.timeout:
            pass
    print(f"self-test: {echoed}/{n_packets} UDP packets echoed through the modem")
    if out_path:
        import json

        with open(out_path, "w") as f:
            json.dump({
                "test": "udp echo through tun -> convergence layer -> "
                        "OFDM loopback (AWGN) -> convergence layer -> tun",
                "packets_sent": n_packets,
                "packets_echoed": echoed,
                "ok": echoed == n_packets,
            }, f, indent=2)
    return 0 if echoed == n_packets else 1


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.tun_bridge")
    p.add_argument("--self-test", action="store_true")
    p.add_argument("--packets", type=int, default=8)
    p.add_argument("--out", default=None, help="write a JSON artifact")
    _cli.add_device_args(p)
    args = p.parse_args(argv)
    dev = _cli.device_of(args)
    if args.self_test:
        sys.exit(self_test(args.packets, out_path=args.out, device=dev))
    # bridge mode: echo forever
    tun = open_tun()
    modem = ModemPipe(device=dev)
    print("bridging dtl0 through the modem (ctrl-c to stop)")
    while True:
        r, _, _ = select.select([tun], [], [], 1.0)
        if not r:
            continue
        for pkt in modem.process([os.read(tun, 4096)]):
            os.write(tun, swap_echo(pkt))


if __name__ == "__main__":
    main()
