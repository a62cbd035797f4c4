"""Benchmark: the batch receiver's throughput on one NVIDIA GPU (the port of
the JAX package's top-level ``bench.py``).

Prints ONE JSON line:
  {"metric": "ofdm_demod_throughput", "value": X, "unit": "Msamples/s",
   "vs_baseline": null, "extra": {...}}

The metric counts complex baseband samples fully demodulated per second
through the complete receiver: Schmidl-Cox detection over the raw stream
(the metric kernel, ``csrc/sync_metric.cu``) + frame extraction + CFO
correction + FFT + carrier-offset search + channel estimation + 2-pass
decision-directed equalizer (four launches of ``csrc/equalizer.cu``) +
header parse + adaptive demap + repack + CRC32 verify.  ``value`` is
B x frame_samples over the median step.

The traffic is ``bench.py``'s: B frames (default 2048) of frame_length 20
with constellations 1..4 and payloads drawn from ``np.random.RandomState(0)``
exactly as it draws them, frame numbers 0.. mod 4096, 2048 zero samples
after the last frame, AWGN of noise voltage 0.02.  The pad bytes and the
noise come from a ``torch.Generator`` seeded by ``--seed`` on the bench's
device.  The stream is built once, before anything is timed.

A step rotates the stream by exp(1j * acc * 1e-12), acc the 0-d float32
CRC count of the steps before (a value dependency that chains the steps),
receives it, and adds its CRC passes to acc, on the device.  One untimed
step builds the CUDA sources and warms up; then ``--reps`` windows of
``--iters`` chained steps are timed by ``tools/_timing.measure`` (CUDA
events with a synchronize before and after); acc is read once, at the end,
so ``crc_ok_rate`` covers every step that ran.

Departures from ``bench.py``: ``vs_baseline`` is null (the baseline it
divides by was set for a TPU chip; no H100 baseline exists yet); CUDA
events in place of a wall-clock window closed by a scalar fetch; no
fallback: on a card the kernels launch or the run raises; seeded torch pad
and noise; and a run in which any frame fails its CRC prints its line and
exits non-zero.

Usage: python -m gr_dtl_tpu_torch.bench [B] [--reps 5] [--iters 12]
         [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from gr_dtl_tpu_torch.models import receiver, transmitter
from gr_dtl_tpu_torch.ops import channel, constellation as cn
from gr_dtl_tpu_torch.tools import _cli, _timing
from gr_dtl_tpu_torch.utils import config as cfgmod

__all__ = ["FRAME_LENGTH", "NOISE_V", "STREAM_TAIL", "traffic", "make_stream", "step", "main"]

FRAME_LENGTH = 20
NOISE_V = 0.02
STREAM_TAIL = 2048  # zeros after the last frame, so its window never clips


def traffic(tcfg, B: int):
    """(cnst, plen, payload): B frames of constellations 1..4 filled to
    capacity, drawn from ``np.random.RandomState(0)`` as ``bench.py`` draws
    them."""
    rng = np.random.RandomState(0)
    maxb = tcfg.max_frame_bytes()
    cnst = rng.randint(1, 5, size=B).astype(np.int32)
    payload = np.zeros((B, maxb), np.uint8)
    plen = np.zeros(B, np.int32)
    for i in range(B):
        plen[i] = tcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[cnst[i]])) - 4
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    return cnst, plen, payload


def make_stream(txp, cnst, plen, payload, gen: torch.Generator) -> torch.Tensor:
    """The frames of :func:`traffic` modulated back to back on ``gen``'s
    device (pad bytes from ``gen``, feedback constellation 0), STREAM_TAIL
    zeros after them, then AWGN of voltage NOISE_V from ``gen``."""
    dev = gen.device
    B = len(cnst)
    pad = torch.randint(0, 256, payload.shape, generator=gen, device=dev, dtype=torch.uint8)
    out = transmitter.tx_frames(txp, torch.as_tensor(payload, device=dev), torch.as_tensor(plen, device=dev),
                                torch.as_tensor(cnst, device=dev), torch.zeros(B, dtype=torch.int32, device=dev),
                                torch.arange(B, dtype=torch.int32, device=dev) % 4096, pad)
    s = torch.cat([out.samples.reshape(-1), torch.zeros(STREAM_TAIL, dtype=torch.complex64, device=dev)])
    return channel.awgn(s, NOISE_V, generator=gen)


def step(rxp, B: int, stream: torch.Tensor, acc: torch.Tensor):
    """One timed step -> (acc + the step's CRC passes, its RxOut).  No host
    read: acc stays a 0-d float32 tensor on the stream's device."""
    # a ~identity rotation derived from the carry serializes the steps;
    # complex64 throughout (acc is float32)
    s = stream * torch.exp(1j * acc * 1e-12)
    frames, _ = receiver.detect_and_extract(s, rxp.cfg, B)
    out = receiver.rx_frames(rxp, frames)
    return acc + out.crc_ok.sum().to(torch.float32), out


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.bench")
    p.add_argument("batch", nargs="?", type=int, default=2048, help="frames a step (B)")
    p.add_argument("--reps", type=int, default=5, help="timed windows")
    p.add_argument("--iters", type=int, default=12, help="chained steps a window")
    p.add_argument("--seed", type=int, default=0, help="seed of the pad and noise generator")
    p.add_argument("--device", default="cuda",
                   help="torch device the run uses (default cuda; there is no fallback: "
                        "without a card the run exits with an error)")
    p.set_defaults(cpu=False)  # --device cpu is the one way onto the CPU
    args = p.parse_args(argv)
    if args.batch < 1 or args.reps < 1 or args.iters < 1:
        p.error("B, --reps and --iters must be positive")
    dev = _cli.device_of(args)
    B = args.batch

    cfg = cfgmod.make_rx_config(None, frame_length=FRAME_LENGTH)
    tcfg = cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH)
    txp = transmitter.build_tx(tcfg, dev)
    rxp = receiver.build_rx(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stream = make_stream(txp, *traffic(tcfg, B), gen)

    acc = torch.zeros((), dtype=torch.float32, device=dev)
    steps = 0

    def one_step():
        nonlocal acc, steps
        acc = step(rxp, B, stream, acc)[0]
        steps += 1

    timed = _timing.measure(one_step, dev, iters=args.iters, reps=args.reps, warmup=1)
    n_ok = float(acc)  # the one host read: every step has run
    ok_rate = n_ok / (steps * B)
    res = {"metric": "ofdm_demod_throughput",
           "value": B * cfg.frame_samples / timed["median_ms"] / 1e3,
           "unit": "Msamples/s",
           "vs_baseline": None,
           "extra": {"frames_per_step": B, "crc_ok_rate": ok_rate, "step_ms": timed["median_ms"],
                     "timing": _timing.describe(dev, args.iters, args.reps),
                     "step_ms_windows": timed["ms"], "device": _timing.device_label(dev),
                     "reps": args.reps, "iters": args.iters}}
    print(json.dumps(res), flush=True)
    if ok_rate < 1.0:
        sys.exit(f"error: {steps * B - int(n_ok)} of {steps * B} frames failed their CRC in {steps} steps; "
                 "a throughput over lost frames is not a result")
    return res


if __name__ == "__main__":
    main()
