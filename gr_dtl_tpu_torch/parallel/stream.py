"""Sharded receiver: many streams x time-blocked sample timelines (port of
gr_dtl_tpu/parallel/stream.py).

Each rank of a ``(stream, time)`` grid (parallel/mesh.py) holds S_l =
S / n_stream streams and one contiguous block of their timelines:

- the **stream axis** shards independent adaptive-OFDM channels (pure data
  parallelism; no cross-talk),
- the **time axis** shards one channel's sample timeline into contiguous
  blocks.  The Schmidl-Cox correlator and frame extraction need to look
  past a block's right edge, so each rank fetches a halo of
  ``frame_samples + fft_len`` samples from its right neighbour along the
  time ring (overlap-save), and the frame-phase vote is summed over the
  time axis so every block agrees on trigger positions ("trigger
  ownership": a frame belongs to the block its start sample lies in).

Block length must be a multiple of ``frame_samples`` so the folded trigger
phase is identical in every block.  A rank's whole batch takes one launch
of the metric kernel (``[S_l, block + halo]`` rows) and one receiver call
over its S_l * frames_per_block frames.

The functions take the GLOBAL arrays (numpy or tensors) and each rank
takes only its own part; they return the rank's part of the result, leaves
``[S_l, frames_per_block, ...]`` (``_coll.gather_global`` assembles the
whole).  The reference draws its pad bytes and channel noise from
``jax.random`` keys folded by the shard's (stream, time) index; the
loopback here takes them as arguments, as the port's channels do.
"""

from __future__ import annotations

import numpy as np
import torch

from gr_dtl_tpu_torch.models import receiver, transmitter
from gr_dtl_tpu_torch.ops import channel, sync
from gr_dtl_tpu_torch.parallel import _coll

__all__ = ["local_part", "build_sharded_rx", "build_sharded_loopback"]


def local_part(x, mesh, n_streams: int, dim: int, device) -> torch.Tensor:
    """This rank's part of a global array (numpy or tensor) of ``n_streams``
    rows whose time blocks lie along ``dim``, on ``device``."""
    S_l = n_streams // mesh.shape["stream"]
    n_time = mesh.shape["time"]
    if x.shape[0] != n_streams or x.shape[dim] % n_time:
        raise ValueError(f"a global array of {n_streams} rows with its axis {dim} divisible by "
                         f"{n_time} time blocks, got {tuple(x.shape)}")
    w = x.shape[dim] // n_time
    s0, t0 = mesh.index["stream"] * S_l, mesh.index["time"] * w
    idx = (slice(s0, s0 + S_l),) + (slice(None),) * (dim - 1) + (slice(t0, t0 + w),)
    part = x[idx]
    if isinstance(part, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return part.to(device)


def _make_local_block_rx(cfg, rxp, mesh, frames_per_block: int, block: int):
    """The rank's streams' block + right halo -> frames_per_block results
    each.  The frame-phase vote is local to the block but summed over the
    time axis; extraction and fine CFO vote stream by stream, as the
    reference's per-stream ``vmap`` does."""
    fs = cfg.frame_samples

    def local_block_rx(ext: torch.Tensor) -> receiver.RxOut:
        """ext: [S_l, block + halo] samples."""
        S_l = ext.shape[0]
        Pm, M = sync.timing_metric(ext, cfg.fft_len)
        # local vote over the block only (the halo excluded, so the votes
        # are disjoint), then the consensus across the time blocks
        n_full = block // fs
        folded = M[:, : n_full * fs].reshape(S_l, n_full, fs).sum(-2)
        folded = _coll.all_reduce_sum(folded, mesh.time_group)
        # circular plateau-center vote (a raw argmax can land on the wrap
        # edge and make every block decode its neighbour's frame through
        # the halo)
        phase = sync.phase_from_folded(folded, fs, cfg.cp_len)
        trig = sync.frame_triggers(M, phase, fs, frames_per_block)
        eps = sync.fine_cfo_batch(Pm, trig, cfg.cp_len, fs, per_stream=True)
        frames = sync.extract_frames_batch(ext, trig, fs, per_stream=True)
        frames = sync.cfo_correct(frames.reshape(S_l * frames_per_block, fs), eps.reshape(-1),
                                  cfg.fft_len)
        out = receiver.rx_frames(rxp, frames)
        return receiver.RxOut(*(a.reshape(S_l, frames_per_block, *a.shape[1:]) for a in out))

    return local_block_rx


def build_sharded_rx(cfg, mesh, frames_per_block: int, device):
    """The sharded receiver over a (stream, time) grid.

    Returns ``(fn, rxp)``: ``fn(streams)`` takes the global ``[n_streams,
    n_time * block_samples]`` complex64 samples (each rank reads its own
    block) and returns this rank's RxOut, leaves ``[S_l,
    frames_per_block, ...]``.  The last time block's halo is the first
    block's head (the ring wraps), as in the reference.
    """
    device = torch.device(device)
    rxp = receiver.build_rx(cfg, device)
    fs = cfg.frame_samples
    block = frames_per_block * fs
    halo = fs + cfg.fft_len  # finish boundary frames + the metric window
    local_block_rx = _make_local_block_rx(cfg, rxp, mesh, frames_per_block, block)

    def fn(streams):
        x = local_part(streams, mesh, streams.shape[0], 1, device).to(torch.complex64)
        right = _coll.ring_shift(x[:, :halo], mesh, -1)
        return local_block_rx(torch.cat([x, right], dim=1))

    return fn, rxp


def build_sharded_loopback(txcfg, rxcfg, mesh, frames_per_block: int, noise_v: float, device,
                           fec=None):
    """The full sharded modem step: TX + AWGN + RX on every rank.

    Payloads sharded ``(stream, time)`` are framed and modulated locally (TX
    has no cross-rank dependency), pass through the rank's AWGN, and are
    demodulated by the halo-exchanging sharded receiver.

    Returns ``(fn, (txp, rxp))``: ``fn(payload, plen, cnst, frame_no, pad,
    noise)`` takes global arrays, ``[n_streams, n_time * frames_per_block,
    ...]`` (``pad`` ``[..., max_frame_bytes]`` uint8, None with ``fec``) and
    ``noise`` ``[n_streams, n_time * frames_per_block * frame_samples]``
    complex64 unit draws (``channel.awgn``'s ``noise=``); each rank uses its
    own part.  It returns this rank's RxOut, leaves ``[S_l,
    frames_per_block, ...]``.
    """
    device = torch.device(device)
    txp = transmitter.build_tx(txcfg, device, fec)
    rxp = receiver.build_rx(rxcfg, device, fec)
    fs = rxcfg.frame_samples
    block = frames_per_block * fs
    halo = fs + rxcfg.fft_len
    local_block_rx = _make_local_block_rx(rxcfg, rxp, mesh, frames_per_block, block)

    def fn(payload, plen, cnst, frame_no, pad, noise):
        S = plen.shape[0]
        part = lambda a: local_part(a, mesh, S, 1, device)
        plen_l = part(plen)
        S_l, F_l = plen_l.shape
        flat = lambda a: a.reshape(S_l * F_l, *a.shape[2:])
        i32 = lambda a: flat(part(a)).int()
        out = transmitter.tx_frames(
            txp, flat(part(payload)), flat(plen_l).int(), i32(cnst),
            torch.zeros(S_l * F_l, dtype=torch.int32, device=device), i32(frame_no),
            None if pad is None else flat(part(pad)))
        streams = out.samples.reshape(S_l, F_l * fs)
        streams = channel.awgn(streams, noise_v, noise=part(noise).to(torch.complex64))
        right = _coll.ring_shift(streams[:, :halo], mesh, -1)
        return local_block_rx(torch.cat([streams, right], dim=1))

    return fn, (txp, rxp)
