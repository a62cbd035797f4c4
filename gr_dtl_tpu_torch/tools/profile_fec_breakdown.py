"""Where the coded step's milliseconds go, stage by stage (port of
tools/profile_fec_breakdown.py).

B QPSK frames of examples/config_fec.json (frame_length 20, the
n=300/k=152 code) through AWGN of noise voltage 0.05, timed cumulatively:

  detect           ``receiver.detect_and_extract`` (sync, CFO, windows)
  defer_fec        + ``rx_frames(defer_fec=True)`` (demod, equalize, header,
                   soft LLRs, serialisation)
  full_coded       + ``fec_chain.fec_frame_decode`` (BP, de-shortening,
                   unpack, CRC): the whole coded receive step
  uncoded          the uncoded build's step at the same geometry

Differences of consecutive stages are the stages' costs.  Payloads from
``numpy.random.RandomState(0)``, the uncoded pad bytes and the noise from
a ``torch.Generator`` seeded ``--seed``.  Times: ``tools/_timing``.

Usage: python -m gr_dtl_tpu_torch.tools.profile_fec_breakdown [--frames 1024]
         [--out FILE] [--reps 3] [--iters 8] [--device cuda | --cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gr_dtl_tpu_torch.models import receiver, transmitter
from gr_dtl_tpu_torch.ops import channel
from gr_dtl_tpu_torch.tools import _cli, _timing
from gr_dtl_tpu_torch.tools.bench_fec import coded_build, qpsk_frames
from gr_dtl_tpu_torch.utils import config as cfgmod

__all__ = ["main"]

NOISE_V = 0.05


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.profile_fec_breakdown")
    p.add_argument("--frames", type=int, default=1024)
    p.add_argument("--out", default=None)
    p.add_argument("--reps", type=int, default=3, help="timed windows a stage (median)")
    p.add_argument("--iters", type=int, default=8, help="steps a timed window")
    p.add_argument("--seed", type=int, default=0, help="seed of the pad and noise generator")
    _cli.add_device_args(p)
    args = p.parse_args(argv)
    dev = _cli.device_of(args)
    B = args.frames
    _, rxcfg, _, txp, rxp = coded_build(dev)
    urxcfg = cfgmod.make_rx_config(None, frame_length=20)
    utxp = transmitter.build_tx(cfgmod.make_tx_config(None, frame_length=20), dev)
    urxp = receiver.build_rx(urxcfg, dev)
    rng = np.random.RandomState(0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stream = channel.awgn(qpsk_frames(txp, B, rng).reshape(-1), NOISE_V, generator=gen)
    ustream = channel.awgn(qpsk_frames(utxp, B, rng, gen).reshape(-1), NOISE_V, generator=gen)
    crc = torch.zeros(2, dtype=torch.int64, device=dev)

    def detect():
        return receiver.detect_and_extract(stream, rxcfg, B)[0]

    def defer():
        return receiver.rx_frames(rxp, detect(), defer_fec=True)

    def full():
        crc[0] += receiver.rx_frames(rxp, detect()).crc_ok.sum()

    def uncoded():
        frames, _ = receiver.detect_and_extract(ustream, urxcfg, B)
        crc[1] += receiver.rx_frames(urxp, frames).crc_ok.sum()

    t = {k: _timing.measure(fn, dev, args.iters, args.reps)
         for k, fn in (("detect", detect), ("defer", defer), ("full", full), ("uncoded", uncoded))}
    ms = {k: v["median_ms"] for k, v in t.items()}
    steps = 1 + args.iters * args.reps  # the warm-up step counts too
    ok, uok = crc.tolist()
    res = {
        "metric": "fec_breakdown",
        "frames": B,
        "samples_per_step": B * rxcfg.frame_samples,
        "detect_ms": ms["detect"],
        "defer_fec_ms": ms["defer"],
        "full_coded_ms": ms["full"],
        "uncoded_ms": ms["uncoded"],
        "stage_demod_soft_ms": ms["defer"] - ms["detect"],
        "stage_decode_ms": ms["full"] - ms["defer"],
        "coded_msps": B * rxcfg.frame_samples / ms["full"] / 1e3,
        "uncoded_msps": B * urxcfg.frame_samples / ms["uncoded"] / 1e3,
        "coded_crc_rate": ok / (steps * B),
        "uncoded_crc_rate": uok / (steps * B),
        "device": _timing.device_label(dev),
        "windows_ms": {k: v["ms"] for k, v in t.items()},
        "timing": _timing.describe(dev, args.iters, args.reps),
    }
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
