"""Entry points: the receiver's forward step, and a dry run of the sharded
receivers over a grid of ranks (port of ``__graft_entry__.py``).

``entry(device)``            -> (fn, example_args): the full OFDM receiver
                                chain on a real modulated frame batch.
``dryrun_multichip(n, device)`` -> one sharded loopback step (TX + AWGN +
                                RX with the halo ring and the summed phase
                                vote), uncoded and coded, and three chained
                                ``ShardedStreamRx`` blocks, over an n-rank
                                (stream x time) grid; raises on any frame
                                that does not come back.

Run as ``python -m gr_dtl_tpu_torch.entry [n] [device]`` (default 1, cuda;
``cpu`` runs the grid as gloo processes).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as tdist

from gr_dtl_tpu_torch.models import fec_chain, receiver, transmitter
from gr_dtl_tpu_torch.parallel import _coll, launch, mesh as meshmod, session, stream
from gr_dtl_tpu_torch.utils import alist, config as cfgmod

__all__ = ["entry", "dryrun_multichip"]

ALIST = Path(__file__).resolve().parent.parent / "examples" / "n_0100_k_0027.alist"


def entry(device="cuda"):
    """(forward, (frames,)): ``receiver.rx_frames`` of frame_length 10 on
    ``device``, and an example batch of 8 modulated QPSK frames there."""
    device = torch.device(device)
    cfg = cfgmod.make_rx_config(None, frame_length=10)
    rxp = receiver.build_rx(cfg, device)

    def forward(frames):
        return receiver.rx_frames(rxp, frames)

    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    B, maxb = 8, txcfg.max_frame_bytes()
    rng = np.random.RandomState(0)
    payload = np.zeros((B, maxb), np.uint8)
    plen = np.full(B, txcfg.frame_bytes(2) - 4, np.int32)
    for i in range(B):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    t = lambda a: torch.as_tensor(a, device=device)
    out = transmitter.tx_frames(
        transmitter.build_tx(txcfg, device), t(payload), t(plen), t(np.full(B, 2, np.int32)),
        t(np.zeros(B, np.int32)), t(np.arange(B, dtype=np.int32)),
        t(rng.randint(0, 256, (B, maxb)).astype(np.uint8)))
    return forward, (out.samples,)


def _grid(n: int) -> tuple[int, int]:
    """(n_stream, n_time) as close to square as divides n."""
    n_time = next(t for t in range(int(np.sqrt(n)), 0, -1) if n % t == 0)
    return n // n_time, n_time


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One FULL sharded modem step (uncoded and coded) and three chained
    ``ShardedStreamRx`` blocks over an n-rank (stream x time) grid.

    Inside a process group of ``n_devices`` ranks (every rank calls it) it
    runs on the caller's rank; a single process without a group runs a 1 x
    1 grid in place; otherwise it spawns ``n_devices`` worker processes
    (gloo on the CPU, NCCL with one rank a card on ``cuda``)."""
    n_stream, n_time = _grid(n_devices)
    if tdist.is_available() and tdist.is_initialized():
        if tdist.get_world_size() != n_devices:
            raise ValueError(f"the process group has {tdist.get_world_size()} ranks, not {n_devices}")
        _dryrun(meshmod.make_mesh(n_stream, n_time, device=device))
    elif n_devices == 1:
        _dryrun(meshmod.make_mesh(1, 1, device=device))
    else:
        launch.spawn(_dryrun, n_stream, n_time, device=device)


def _check_frames(out, payload, plen, mesh, what: str) -> None:
    ok = _coll.gather_global(out.crc_ok, mesh, 1).cpu().numpy()
    got = _coll.gather_global(out.payload, mesh, 1).cpu().numpy()
    if not ok.all():
        raise AssertionError(f"{what}: CRC failures at {np.argwhere(~ok).tolist()}")
    for s in range(plen.shape[0]):
        for f in range(plen.shape[1]):
            if not (got[s, f, : plen[s, f]] == payload[s, f, : plen[s, f]]).all():
                raise AssertionError(f"{what}: stream {s} frame {f} payload differs")


def _dryrun(mesh) -> None:
    dev = mesh.device
    n_stream, n_time = mesh.shape["stream"], mesh.shape["time"]
    cfg = cfgmod.make_rx_config(None, frame_length=4)  # tiny shapes
    txcfg = cfgmod.make_tx_config(None, frame_length=4)
    fpb = 1  # frames per time block
    F = fpb * n_time
    maxb = txcfg.max_frame_bytes()
    rng = np.random.RandomState(1)
    plen = np.full((n_stream, F), txcfg.frame_bytes(2) - 4, np.int32)
    payload = np.zeros((n_stream, F, maxb), np.uint8)
    for s in range(n_stream):
        for f in range(F):
            payload[s, f, : plen[s, f]] = rng.randint(0, 256, plen[s, f])
    cnst = np.full((n_stream, F), 2, np.int32)
    frame_no = np.tile(np.arange(F, dtype=np.int32), (n_stream, 1))
    noise = lambda c: (rng.randn(n_stream, F * c.frame_samples)
                       + 1j * rng.randn(n_stream, F * c.frame_samples)).astype(np.complex64)

    step, _ = stream.build_sharded_loopback(txcfg, cfg, mesh, fpb, 0.01, dev)
    pad = rng.randint(0, 256, (n_stream, F, maxb)).astype(np.uint8)
    _check_frames(step(payload, plen, cnst, frame_no, pad, noise(cfg)), payload, plen, mesh,
                  "multichip dryrun")

    # the CODED sharded step: the LDPC transport-block path on the same grid
    ctx = cfgmod.make_tx_config(None, frame_length=4, fec=True)
    crx = cfgmod.make_rx_config(None, frame_length=4, fec=True)
    fec = fec_chain.build_fec(ctx, alist.load_alist(str(ALIST)), dev)
    ub = int(fec.user_bytes_tab[2])
    cplen = np.full((n_stream, F), ub, np.int32)
    cpay = np.zeros((n_stream, F, fec.max_payload_bytes), np.uint8)
    cpay[:, :, :ub] = rng.randint(0, 256, (n_stream, F, ub))
    cstep, _ = stream.build_sharded_loopback(ctx, crx, mesh, fpb, 0.01, dev, fec)
    _check_frames(cstep(cpay, cplen, cnst, frame_no, None, noise(crx)), cpay, cplen, mesh,
                  "multichip coded dryrun")

    # the CONTINUOUS sharded session: 3 chained blocks, the carried state
    # (tail, trigger lock, frame accounting) on the device between calls
    Fs = 2 * n_time  # frames a block: F_local = 2 covers the halo
    srx = session.ShardedStreamRx(cfg, mesh, n_streams=n_stream, frames_per_block=Fs, device=dev)
    blk, n_chain, B = srx.block_samples, 3, 2 * Fs
    chunks = np.zeros((n_stream, n_chain * blk), np.complex64)
    spay = rng.randint(0, 256, (n_stream, B, maxb)).astype(np.uint8)
    splen = np.full((n_stream, B), txcfg.frame_bytes(2) - 4, np.int32)
    spay[np.arange(maxb)[None, None, :] >= splen[:, :, None]] = 0
    txp = transmitter.build_tx(txcfg, "cpu")  # the same vectors on every rank
    for s in range(n_stream):
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))
        out = transmitter.tx_frames(txp, torch.as_tensor(spay[s]), i32(splen[s]), i32(np.full(B, 2)),
                                    i32(np.zeros(B)), i32(np.arange(B)),
                                    torch.as_tensor(rng.randint(0, 256, (B, maxb)).astype(np.uint8)))
        flat = out.samples.reshape(-1).numpy()
        off = 100 + 37 * s  # frames start mid-block
        chunks[s, off: off + flat.size] = flat
    decoded = [dict() for _ in range(n_stream)]
    for b in range(n_chain):
        out, valid = srx.process(chunks[:, b * blk:(b + 1) * blk])
        g = lambda k: _coll.gather_global(getattr(out, k), mesh, 1).cpu().numpy()
        pays, lens, nos = g("payload"), g("payload_len"), g("frame_no")
        for s in range(n_stream):
            for i in np.nonzero(valid[s] & srx.last_crc_ok[s])[0]:
                decoded[s][int(nos[s, i])] = pays[s, i, : lens[s, i]].tobytes()
    for s in range(n_stream):
        if sorted(decoded[s]) != list(range(B)):
            raise AssertionError(f"stream {s}: decoded {sorted(decoded[s])} of {B} frames "
                                 "across the chained sharded steps")
        for f in range(B):
            if decoded[s][f] != spay[s, f, : splen[s, f]].tobytes():
                raise AssertionError(f"stream {s} frame {f}: payload differs")


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    dev = torch.device(sys.argv[2] if len(sys.argv) > 2 else "cuda")
    fn, args = entry(dev)
    print("entry: crc_ok", fn(*args).crc_ok.tolist())
    dryrun_multichip(n, dev)
    print(f"dryrun_multichip({n}, {dev}): OK")
