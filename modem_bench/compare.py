"""The comparison that decides ``correct``: what a system's adapter reads
of the program's outputs against the plain reference's on the same
samples, and against what was sent, merged over the streams and held to
the cell's limits.

The numbers, each of the layer that produces what it reads:

- detect: ``frames_rel_err`` (the CFO-corrected frame windows: the
  triggers and the corrections; largest |difference| over the
  reference's rms), ``eps_abs_err`` (fractional CFO, subcarriers);
- demodulate: ``carr_off_diff`` (frames whose integer carrier offset
  differs);
- equalize: ``header_diff`` (frames whose header CRC verdict, frame
  number, constellation decided or feedback field differs);
  ``soft_err_median`` (the median frame's largest |difference| of its
  equalized payload symbols, over the reference's rms) and
  ``soft_diverged`` (frames whose largest difference is above
  :data:`SOFT_DIVERGED` of that rms); ``snr_db_err_median`` (the median
  frame's |SNR estimate difference|, dB) and ``snr_diverged`` (frames
  whose difference is above :data:`SNR_DIVERGED_DB`);
- demap and CRC: ``payload_diff`` (frames whose CRC verdict or length
  differs, or that both pass with other bytes), ``false_accepts`` (frames
  the program passes whose bytes or length are not what was sent);
- FEC: ``fec_ok_diff``, ``bp_iters_diff`` (frames whose mean BP updates
  a codeword differ);
- every step of the window: ``steps_crc_diff`` (steps whose count of
  passing frames differs from that of the step compared frame by frame on
  the same stream; the program is deterministic, so every step on a stream
  gives the same frames).

Counts are summed over the streams compared, errors take the largest.
The medians read the bulk of the frames, the counts how many frames
leave it: at the coded cell's 11 dB a decision the two sides take
differently on a boundary (inputs 1e-6 apart) steers that frame's
decision-directed taps apart for the rest of the frame (PERF.md),
so a few frames may leave it there, and none at the uncoded cell's 34 dB.
"""

from __future__ import annotations

import torch

ERRORS = ("frames_rel_err", "eps_abs_err", "snr_db_err_median", "soft_err_median")
SOFT_DIVERGED = 1e-3  # of the reference's rms: a frame's equalized symbols left the reference's
SNR_DIVERGED_DB = 1e-2  # a frame's SNR estimate left the reference's


def frame_errors(a: torch.Tensor, b: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """[B] each row's largest |a - b| over b's rms over every row."""
    worst, ss = [], 0.0
    for i in range(0, a.shape[0], block):
        x, y = a[i:i + block], b[i:i + block]
        worst.append((x - y).abs().amax(1))
        ss += float((y.abs() ** 2).sum(dtype=torch.float64))
    return torch.cat(worst) / max((ss / b.numel()) ** 0.5, 1e-30)


def merge(per_stream: list) -> dict:
    out = {}
    for r in per_stream:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v) if k in ERRORS else out.get(k, 0) + v
    return out


def steps_crc_diff(step_counts: list, slots: int) -> int:
    """Steps whose passing-frame count differs from that of the last step
    on the same stream (step i received stream i % slots), the step that
    is compared frame by frame."""
    last = {i % slots: c for i, c in enumerate(step_counts)}
    return sum(int(c != last[i % slots]) for i, c in enumerate(step_counts))


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}); a number with no limit, or
    one that is not a number, fails."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(c["limit"] is not None and c["value"] == c["value"] and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
