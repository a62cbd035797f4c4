"""Recorded-IQ replay: run the full RX chain over a complex64 capture
(port of tools/replay.py).

Reads raw interleaved complex64 baseband samples, runs Schmidl-Cox
detection + CFO recovery + the full demod chain, writes a
reference-format frame store and prints stats.  Per-frame trigger
refinement absorbs timing drift across the capture; the
integer+fractional CFO path handles oscillator offset.

Usage: python -m gr_dtl_tpu_torch.tools.replay CAPTURE.c64 [--frames N]
         [--frame-length L] [--config cfg.json] [--store-rx rx.dat] [--json]
         [--device cuda | --cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gr_dtl_tpu_torch.models import fec_chain, receiver
from gr_dtl_tpu_torch.ops import metrics
from gr_dtl_tpu_torch.testbed.frame_store import FrameStore
from gr_dtl_tpu_torch.tools import _cli
from gr_dtl_tpu_torch.utils import alist, config as cfgmod

__all__ = ["main"]


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.replay")
    p.add_argument("capture")
    p.add_argument("--frames", type=int, default=None,
                   help="frame count (default: as many as fit)")
    p.add_argument("--frame-length", type=int, default=20)
    p.add_argument("--config", default=None)
    p.add_argument("--store-rx", default=None)
    p.add_argument("--json", action="store_true")
    _cli.add_device_args(p)
    args = p.parse_args(argv)
    dev = _cli.device_of(args)

    cfg = cfgmod.make_rx_config(args.config, frame_length=args.frame_length)
    fec = None
    if cfg.fec:
        fec = fec_chain.build_fec(cfg, alist.load_alist(cfg.fec_codes[0][1]), dev)
    rxp = receiver.build_rx(cfg, dev, fec)

    raw = np.fromfile(args.capture, dtype=np.complex64)
    n_frames = args.frames or max(1, (len(raw) - cfg.frame_samples) // cfg.frame_samples)
    frames, eps = receiver.detect_and_extract(torch.as_tensor(raw, device=dev), cfg, n_frames)
    rx = receiver.rx_frames(rxp, frames)

    _, _, lost_rate = metrics.lost_frames(rx.frame_no, rx.header_ok)
    host = lambda x: x.cpu().numpy()
    res = {
        "capture_samples": int(len(raw)),
        "frames": int(n_frames),
        "header_ok_rate": float(host(rx.header_ok).mean()),
        "crc_ok_rate": float(host(rx.crc_ok).mean()),
        "est_snr_db": float(host(rx.snr_db).mean()),
        "mean_cfo_subcarriers": float(host(eps).mean()),
        "carr_offset": int(host(rx.carr_offset)[0]),
        "lost_frame_rate": float(lost_rate),
    }
    if args.store_rx:
        with FrameStore(args.store_rx) as s:
            s.store_batch(rx)
    print(json.dumps(res) if args.json else "\n".join(f"{k}: {v}" for k, v in res.items()))


if __name__ == "__main__":
    main()
