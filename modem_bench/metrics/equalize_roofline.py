"""``equalize_roofline``: ``receiver.equalize_passes`` (the equalizer
kernel's two calls a pass, the header parse, the re-estimation between
passes) against the larger of two least times: its bytes (the spectra
and the taps read once; the payload's equalized data carriers, the SNR
and noise estimates, the header fields and verdict and the constellation
written once) at the card's memory rate, and the equalizer's operations
(150 a carrier and symbol: two complex divisions, a slicer, the update)
over every pass's header and payload symbols at its float32 rate; over
the stage's device time summed over the window's steps."""

from modem_bench.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S

OPS_PER_CARRIER = 150
HEADER_FIELDS = 9  # int32 fields of the parsed header


def stage_bytes(num, B: int) -> int:
    read = 8 * B * (num.frame_ofdm_symbols * num.fft_len + num.fft_len)
    written = 8 * B * num.frame_capacity_symbols + B * (4 + 4 + 4 * HEADER_FIELDS + 1 + 4)
    return read + written


def stage_ops(num, B: int) -> float:
    passes = max(1, int(num.eq_passes))
    return float(OPS_PER_CARRIER * passes * (num.header_symbols + num.frame_length) * num.fft_len * B)


def read(ctx):
    ms = ctx.stage_ms.get("equalize")
    if not ms:
        return None
    least_s = ctx.steps * max(stage_bytes(ctx.num, ctx.B) / HBM_BYTES_PER_S,
                              stage_ops(ctx.num, ctx.B) / FP32_OPS_PER_S)
    return 100.0 * least_s / (ms * 1e-3)
