"""FEC-path benchmark: the full coded RX and the raw LDPC BP rate (port of
tools/bench_fec.py).

One JSON line:

- ``coded_rx_msps``: complex samples/s through the whole coded receiver
  (sync + demod + soft LLRs + BP decode + TB reassembly + CRC) with the
  n=300/k=152 demo code of examples/config_fec.json, B QPSK frames a step
  of frame_length 20, at 25 dB; ``coded_snr_sweep`` adds 11 dB (the QPSK
  ladder's operating point) and 6 dB (near the cliff), since the
  decoder's early exit makes the step's time depend on the SNR.  The SNR
  labels are taken against the measured power of the clean stream;
- ``ldpc_info_mbps``: decoded systematic Mbit/s of ``ldpc.decode_mm``
  alone on 2048 codewords at 15 iterations (LLR amplitude 4, sigma 0.5);
- ``bf16_ab``: the same BP step with ``decode_mm(..., bf16=True)``.

The payloads and BP messages come from ``numpy.random.RandomState(0)``,
the noise from a ``torch.Generator`` seeded ``--seed`` on the run's
device.  Times: ``tools/_timing`` (CUDA events on a card).

Usage: python -m gr_dtl_tpu_torch.tools.bench_fec [batch] [--out FILE]
         [--no-bf16-ab] [--reps 3] [--iters 8] [--device cuda | --cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from gr_dtl_tpu_torch.models import fec_chain, receiver, transmitter
from gr_dtl_tpu_torch.ops import channel, ldpc
from gr_dtl_tpu_torch.tools import _cli, _timing
from gr_dtl_tpu_torch.utils import alist, config as cfgmod

__all__ = ["ROOT", "FEC_CONFIG", "coded_build", "qpsk_frames", "main"]

ROOT = Path(__file__).resolve().parents[2]
FEC_CONFIG = ROOT / "examples" / "config_fec.json"
SNRS_DB = (25.0, 11.0, 6.0)
BP_CODEWORDS = 2048


def coded_build(dev, frame_length: int = 20):
    """(tx config, rx config, FecParams, TxParams, RxParams) of
    examples/config_fec.json, its codes read relative to the repo."""
    cfg = cfgmod.make_tx_config(str(FEC_CONFIG), frame_length=frame_length)
    rxcfg = cfgmod.make_rx_config(str(FEC_CONFIG), frame_length=frame_length)
    Hs = [alist.load_alist(p if Path(p).is_absolute() else str(ROOT / p)) for _, p in cfg.fec_codes]
    fec = fec_chain.build_fec(cfg, Hs if len(Hs) > 1 else Hs[0], dev)
    return cfg, rxcfg, fec, transmitter.build_tx(cfg, dev, fec), receiver.build_rx(rxcfg, dev, fec)


def qpsk_frames(txp, n: int, rng: np.random.RandomState, gen: torch.Generator | None = None):
    """n QPSK frames filled to capacity with ``rng``'s bytes (frame numbers
    0.. mod 4096) -> [n, frame_samples] complex64 on txp's device.  An
    uncoded build takes its pad bytes from ``gen``."""
    cfg, fec = txp.cfg, txp.fec
    dev = txp.alloc.occ_idx.device
    if fec is not None:
        maxb, plen = fec.max_payload_bytes, int(fec.user_bytes_tab[2])
    else:
        maxb, plen = cfg.max_frame_bytes(), cfg.frame_bytes(2) - 4
    payload = np.zeros((n, maxb), np.uint8)
    for i in range(n):
        payload[i, :plen] = rng.randint(0, 256, plen)
    i32 = lambda v: torch.full((n,), v, dtype=torch.int32, device=dev)
    pad = None if fec is not None else torch.randint(0, 256, (n, maxb), generator=gen, device=dev,
                                                     dtype=torch.uint8)
    out = transmitter.tx_frames(txp, torch.as_tensor(payload, device=dev), i32(plen), i32(2), i32(0),
                                torch.arange(n, dtype=torch.int32, device=dev) % 4096, pad)
    return out.samples


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.bench_fec")
    p.add_argument("batch", nargs="?", type=int, default=1024)
    p.add_argument("--out", default=None, help="write the full result as a JSON artifact")
    p.add_argument("--no-bf16-ab", action="store_true",
                   help="skip the bf16-vs-f32 BP A/B measurement")
    p.add_argument("--reps", type=int, default=3, help="timed windows a measurement (median)")
    p.add_argument("--iters", type=int, default=8, help="steps a timed window")
    p.add_argument("--seed", type=int, default=0, help="seed of the noise generator")
    _cli.add_device_args(p)
    args = p.parse_args(argv)
    dev = _cli.device_of(args)
    B = args.batch
    _, rxcfg, fec, txp, rxp = coded_build(dev)
    rng = np.random.RandomState(0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    clean = qpsk_frames(txp, B, rng).reshape(-1)
    sig_p = float(torch.mean(torch.abs(clean) ** 2))
    unit = torch.complex(torch.randn(clean.shape, generator=gen, device=dev),
                         torch.randn(clean.shape, generator=gen, device=dev))
    n_samples = B * rxcfg.frame_samples

    def coded_point(snr_db):
        """The coded step at one channel SNR: ms a step, CRC rate and mean
        BP iterations over every timed step."""
        noise_v = float(np.sqrt(sig_p / 10 ** (snr_db / 10)))
        stream = channel.awgn(clean, noise_v, noise=unit)
        acc = torch.zeros(2, dtype=torch.float64, device=dev)

        def step():
            frames, _ = receiver.detect_and_extract(stream, rxcfg, B)
            r = receiver.rx_frames(rxp, frames)
            acc.add_(torch.stack([r.crc_ok.sum().double(), r.avg_iters.double().mean()]))

        t = _timing.measure(step, dev, args.iters, args.reps)
        n = 1 + args.iters * args.reps  # the warm-up step counts too
        ok, it = acc.tolist()
        return {"noise_v": noise_v, "snr_db": snr_db, "msps": n_samples / t["median_ms"] / 1e3,
                "step_ms": t["median_ms"], "step_ms_windows": t["ms"],
                "crc_rate": ok / (n * B), "avg_bp_iters": it / n}

    sweep = [coded_point(s) for s in SNRS_DB]
    head = sweep[0]
    del clean, unit

    # ---- raw BP decoder throughput ----
    code = fec.code
    msg = rng.randint(0, 2, size=(BP_CODEWORDS, code.K)).astype(np.float32)
    cws = ldpc.encode(torch.as_tensor(msg, device=dev), code).float()
    llr = (1.0 - 2.0 * cws) * 4.0 + torch.randn(cws.shape, generator=gen, device=dev) * 0.5

    def bp(bf16):
        acc = torch.zeros((), dtype=torch.int64, device=dev)

        def step():
            acc.add_(ldpc.decode_mm(llr, code, 15, bf16=bf16)[2].sum())

        t = _timing.measure(step, dev, args.iters, args.reps)
        return t, int(acc) / ((1 + args.iters * args.reps) * BP_CODEWORDS)

    t_bp, bp_ok = bp(False)
    dt_bp = t_bp["median_ms"]
    bf16 = None
    if not args.no_bf16_ab:
        t16, ok16 = bp(True)
        bf16 = {"bp_step_ms_bf16": t16["median_ms"], "bp_step_ms_f32": dt_bp,
                "speedup_bf16": dt_bp / t16["median_ms"], "bp_ok_rate_bf16": ok16,
                "bp_step_ms_bf16_windows": t16["ms"]}

    result = {
        "metric": "fec_path_throughput",
        "coded_rx_msps": head["msps"],
        "ldpc_info_mbps": BP_CODEWORDS * code.K / dt_bp / 1e3,
        "unit": "Msamples/s | Mbit/s",
        "platform": dev.type,
        "device": _timing.device_label(dev),
        "coded_snr_sweep": sweep,
        "extra": {"frames_per_step": B, "codewords_per_step": BP_CODEWORDS,
                  "code": f"n={code.N} k={code.K}",
                  "coded_avg_bp_iters": head["avg_bp_iters"],
                  "coded_crc_rate": head["crc_rate"],
                  "bp_ok_rate": bp_ok,
                  "coded_step_ms": head["step_ms"],
                  "bp_step_ms": dt_bp, "bp_step_ms_windows": t_bp["ms"],
                  "timing": _timing.describe(dev, args.iters, args.reps)},
    }
    if bf16 is not None:
        result["bf16_ab"] = bf16
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
