"""Offline BER/FER scorer over TX/RX frame stores (port of tools/ber.py).

Same metrics and the same ``[len:4][long_no:8][payload]`` record format,
readable from either package's captures: aligns frames by unwrapped frame
number and reports overall BER (counting missed frames' bits as errors),
BER over detected frames, and FER (ref tools/ber.py:128-133).

Usage: python -m gr_dtl_tpu_torch.tools.ber TX_STORE RX_STORE [--json]
"""

from __future__ import annotations

import json
import sys

import numpy as np

from gr_dtl_tpu_torch.testbed.frame_store import read_frames

__all__ = ["score", "main"]


def score(tx_path: str, rx_path: str) -> dict:
    tx = {no: data for no, data in read_frames(tx_path)}
    bits_sent = sum(len(d) * 8 for d in tx.values())
    frames_sent = len(tx)

    matched = mismatch_lens = missing_tx = 0
    bits_received = errors = frame_errors = crc_ok = 0
    seen = set()
    for no, rx_data in read_frames(rx_path):
        if no not in tx:
            missing_tx += 1
            continue
        tx_data = tx[no]
        if len(tx_data) != len(rx_data):
            mismatch_lens += 1
            continue
        seen.add(no)
        matched += 1
        a = np.frombuffer(tx_data, np.uint8)
        b = np.frombuffer(rx_data, np.uint8)
        e = int(np.unpackbits(a ^ b).sum())
        bits_received += len(rx_data) * 8
        errors += e
        if e:
            frame_errors += 1
        else:
            crc_ok += 1

    missing_frames = frames_sent - len(seen)
    missing_bits = sum(len(d) * 8 for no, d in tx.items() if no not in seen)
    return {
        "frames_sent": frames_sent,
        "bits_sent": bits_sent,
        "frames_matched": matched,
        "frames_missed": missing_frames,
        "mismatch_lengths": mismatch_lens,
        "missing_tx": missing_tx,
        "crc_ok": crc_ok,
        "crc_fail": frame_errors,
        "ber_overall": (errors + missing_bits) / max(bits_sent, 1),
        "ber_detected": errors / max(bits_received, 1),
        "fer": (frame_errors + missing_frames) / max(frames_sent, 1),
    }


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    paths = [a for a in argv if not a.startswith("--")]
    if len(paths) != 2:
        sys.exit("usage: python -m gr_dtl_tpu_torch.tools.ber TX_STORE RX_STORE [--json]")
    res = score(paths[0], paths[1])
    if "--json" in argv:
        print(json.dumps(res))
    else:
        print(f"Sent: frames={res['frames_sent']}, bits={res['bits_sent']}")
        print(f"Matched frames: {res['frames_matched']} "
              f"(missed={res['frames_missed']}, len-mismatch={res['mismatch_lengths']})")
        print(f"Frames: crc_ok={res['crc_ok']}, crc_fail={res['crc_fail']}")
        print(f"BER (overall): {res['ber_overall']}")
        print(f"BER (detected frames): {res['ber_detected']}")
        print(f"FER: {res['fer']}")


if __name__ == "__main__":
    main()
