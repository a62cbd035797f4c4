"""BER/FER-vs-SNR curves over the AWGN loopback channel (port of
tools/ber_curve.py).

Produces the correctness-baseline evidence for BASELINE.md: per-MCS
BER curves through the *full* chain (TX -> channel -> chanest ->
equalizer -> header parse -> demap), compared against exact textbook
AWGN BER for each constellation (the reference publishes no curves of
its own; its functional bar is byte-exact loopback at high SNR, which
these curves subsume at their top end).

Measurement conventions (matching the reference's offline scorer
``tools/ber.py:82-133``, which counts actual bit mismatches per frame):

- the payload is decoded for EVERY frame — on header-CRC failure the
  receiver falls back to the previous constellation exactly like the
  reference (``ofdm_adaptive_packet_header.cc:269-273``) — and BER
  counts the actual payload bit errors;
- FER counts frames with a failed header or any payload bit error;
- the theory axis uses the *exact* injected noise variance (awgn's
  ``E|n|^2 = noise_voltage^2`` survives the unitary FFT unchanged), so
  ``es_n0_db = -20 log10(noise_voltage)`` is the per-carrier SNR of a
  unit-energy symbol, which is what the textbook formulas take (each
  constellation's actual energy — e.g. QPSK's x0.5 amplitude — is
  already inside its formula);
- ``loss_db`` is the implementation loss: the horizontal shift d such
  that theory(es_n0 - d) equals the measured BER.  The round target is
  loss_db <= 0.5 at every MCS operating point.

Usage: python -m gr_dtl_tpu_torch.tools.ber_curve [--snrs 2,4,...,16] [--frames 64]
         [--json out.json] [--device cuda | --cpu]
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from gr_dtl_tpu_torch.models import fec_chain, receiver, transmitter
from gr_dtl_tpu_torch.ops import channel, constellation as cn
from gr_dtl_tpu_torch.tools import _cli
from gr_dtl_tpu_torch.utils import alist, config as cfgmod

__all__ = ["qfunc", "theory_ber", "implementation_loss_db", "run_point", "main"]


def qfunc(x):
    return 0.5 * math.erfc(x / math.sqrt(2.0))


def theory_ber(cnst_id: int, es_n0_db: float) -> float:
    """Gray-coded AWGN BER vs per-carrier Es/N0 of a UNIT-energy symbol.

    Each formula folds in the constellation's actual energy scaling
    (ids match ops/constellation.py; QPSK carries the reference's x0.5
    amplitude, ref constellation.cc:18-24).
    """
    es = 10 ** (es_n0_db / 10)
    if cnst_id == 1:  # BPSK +-1 (Es == Eb == 1)
        return qfunc(math.sqrt(2 * es))
    if cnst_id == 2:  # QPSK x0.5 amplitude => per-axis a = 0.5*sqrt(2)/2
        return qfunc(math.sqrt(es * 0.25))
    if cnst_id == 3:  # 8PSK unit circle
        return (2.0 / 3.0) * qfunc(math.sqrt(2 * es) * math.sin(math.pi / 8))
    if cnst_id == 4:  # 16QAM levels +-1,+-3 / sqrt(10)
        return 0.75 * qfunc(math.sqrt(es / 5.0))
    raise ValueError(cnst_id)


def implementation_loss_db(cnst_id: int, es_n0_db: float, measured: float) -> float:
    """Horizontal dB shift d with theory(es_n0 - d) = measured (bisection)."""
    if measured <= 0:
        return 0.0
    lo, hi = -3.0, 15.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if theory_ber(cnst_id, es_n0_db - mid) < measured:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def run_point(cnst_id, snr_db, frames, seed, frame_length, fec_alist=None,
              eq_passes=None, eq_alpha=None, target_frame_errors=None,
              max_batches=200, device="cuda"):
    """One (constellation, SNR) point on ``device``.

    With ``target_frame_errors`` set, batches of ``frames`` frames are
    accumulated (each with draws of its own) until that many frame/TB
    errors are observed or ``max_batches`` is hit: waterfall statistics
    instead of a single thin batch.  The pad bytes and the noise of batch
    b come from a ``torch.Generator`` seeded ``seed + 7919 b``.
    """
    dev = torch.device(device)
    use_fec = fec_alist is not None
    kw = {}
    if eq_passes is not None:
        kw["eq_passes"] = eq_passes
    if eq_alpha is not None:
        kw["eq_alpha"] = eq_alpha
    cfg = cfgmod.make_tx_config(None, frame_length=frame_length, fec=use_fec)
    rxcfg = cfgmod.make_rx_config(None, frame_length=frame_length, fec=use_fec, **kw)
    fec = fec_chain.build_fec(cfg, alist.load_alist(fec_alist), dev) if use_fec else None
    txp = transmitter.build_tx(cfg, dev, fec)
    rxp = receiver.build_rx(rxcfg, dev, fec)
    rng = np.random.RandomState(seed)
    B = frames
    cnst = np.full(B, cnst_id, np.int32)
    if use_fec:
        maxb = fec.max_payload_bytes
        plen = np.full(B, int(fec.user_bytes_tab[int(cn.BITS_PER_SYMBOL[cnst_id])]), np.int32)
    else:
        maxb = cfg.max_frame_bytes()
        plen = np.full(B, cfg.frame_bytes(int(cn.BITS_PER_SYMBOL[cnst_id])) - 4, np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)
    plen_d, cnst_d = t(plen), t(cnst)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    frame_no = torch.arange(B, dtype=torch.int32, device=dev) % 4096

    def tx(payload, gen):
        pad = (None if use_fec else
               torch.randint(0, 256, (B, cfg.max_frame_bytes()), generator=gen, device=dev,
                             dtype=torch.uint8))
        return transmitter.tx_frames(txp, t(payload), plen_d, cnst_d, zeros, frame_no, pad)

    # calibrate the noise level once (mean TX sample power at this MCS);
    # theory axis from the EXACT injected noise variance
    cal_payload = np.zeros((B, maxb), np.uint8)
    for i in range(B):
        cal_payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    out = tx(cal_payload, torch.Generator(device=dev).manual_seed(seed))
    sig = float(torch.mean(torch.abs(out.samples) ** 2))
    noise_v = float(np.sqrt(sig / 10 ** (snr_db / 10)))
    es_n0 = -20.0 * np.log10(noise_v)

    def batch(payload, gen):
        noisy = channel.awgn(tx(payload, gen).samples, noise_v, generator=gen)
        rx = receiver.rx_frames(rxp, noisy, fallback_cnst=cnst_d)
        return rx.payload.cpu().numpy(), rx.header_ok.cpu().numpy()

    bit_errors = 0
    bits_total = 0
    frame_errors = 0
    frame_errors_given_hdr = 0
    hdr_ok_total = 0
    n_frames = 0
    n_batches = max_batches if target_frame_errors else 1
    for b in range(n_batches):
        payload = np.zeros((B, maxb), np.uint8)
        for i in range(B):
            payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
        got, hdr_ok = batch(payload, torch.Generator(device=dev).manual_seed(seed + 7919 * b))
        # vectorized bit-error count (plen is constant per point)
        L = int(plen[0])
        e_bits = np.unpackbits(got[:, :L] ^ payload[:, :L], axis=1).sum(1)
        bit_errors += int(e_bits.sum())
        bits_total += B * L * 8
        frame_errors += int(((e_bits > 0) | ~hdr_ok).sum())
        # decoder-only failures: frames whose header SURVIVED but whose
        # payload/TB still failed; the low-SNR coded waterfall is otherwise
        # dominated by header CRC16 loss, conflating two mechanisms (the
        # reference separates them: monitor_dec_msg TBER vs header-level
        # stats, lib/dtl/proto/monitor_ofdm.proto:3-22)
        frame_errors_given_hdr += int(((e_bits > 0) & hdr_ok).sum())
        hdr_ok_total += int(hdr_ok.sum())
        n_frames += B
        if target_frame_errors and frame_errors >= target_frame_errors:
            break
    ber = bit_errors / bits_total
    th = theory_ber(cnst_id, es_n0)
    return {
        "cnst": cnst_id,
        "snr_db": snr_db,
        "es_n0_db": round(float(es_n0), 2),
        "ber": ber,
        "fer": frame_errors / n_frames,
        "frames": n_frames,
        "frame_errors": frame_errors,
        "hdr_ok_rate": hdr_ok_total / n_frames,
        # the split waterfall: header survival is hdr_ok_rate above; this
        # is P(frame fails | header decoded), the decoder's own
        # performance, free of header-CRC16 pollution
        "fer_given_hdr": (frame_errors_given_hdr / hdr_ok_total if hdr_ok_total else None),
        "frame_errors_given_hdr": frame_errors_given_hdr,
        "theory_ber": th,
        "loss_db": (round(implementation_loss_db(cnst_id, es_n0, ber), 3)
                    if bit_errors >= 10 else None),
        "bits": bits_total,
        "fec": bool(use_fec),
    }


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.ber_curve")
    p.add_argument("--snrs", default="4,6,8,10,12,14,16,18,20,24,28")
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--frame-length", type=int, default=10)
    p.add_argument("--cnsts", default="1,2,3,4")
    p.add_argument("--eq-passes", type=int, default=None)
    p.add_argument("--eq-alpha", type=float, default=None,
                   help="tap-EMA alpha (0.1 = reference-exact tracking)")
    p.add_argument("--fec-alist", default=None,
                   help="alist path: run the LDPC transport-block path")
    p.add_argument("--target-frame-errors", type=int, default=None,
                   help="accumulate batches until this many frame/TB "
                        "errors per point (waterfall statistics)")
    p.add_argument("--max-batches", type=int, default=200)
    p.add_argument("--json", default=None)
    _cli.add_device_args(p)
    args = p.parse_args(argv)
    dev = _cli.device_of(args)

    rows = []
    for c in (int(x) for x in args.cnsts.split(",")):
        for s in (float(x) for x in args.snrs.split(",")):
            r = run_point(c, s, args.frames, seed=int(10 * s) + c,
                          frame_length=args.frame_length,
                          fec_alist=args.fec_alist, eq_passes=args.eq_passes,
                          eq_alpha=args.eq_alpha,
                          target_frame_errors=args.target_frame_errors,
                          max_batches=args.max_batches, device=dev)
            rows.append(r)
            loss = f"{r['loss_db']:+.2f} dB" if r["loss_db"] is not None else "  --  "
            fgh = f"{r['fer_given_hdr']:.3f}" if r["fer_given_hdr"] is not None else "--"
            print(f"cnst={r['cnst']} snr={r['snr_db']:5.1f} dB  "
                  f"BER={r['ber']:.2e} (theory {r['theory_ber']:.2e}, "
                  f"loss {loss})  FER={r['fer']:.2f}  "
                  f"hdr={r['hdr_ok_rate']:.3f}  FER|hdr={fgh}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
