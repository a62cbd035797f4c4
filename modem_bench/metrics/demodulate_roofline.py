"""``demodulate_roofline``: ``receiver.demodulate`` (the symbol windows'
DFT, the integer carrier offset and its correction, the LS taps) against
the larger of two least times: its bytes (the symbol windows read once;
the spectra, taps and offsets written once) at the card's memory rate,
and an FFT's 5 n log2 n operations a symbol at its float32 rate; over the
stage's device time summed over the window's steps."""

import math

from modem_bench.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S


def stage_bytes(num, B: int) -> int:
    spectra = 8 * B * num.frame_ofdm_symbols * num.fft_len
    return 2 * spectra + 8 * B * num.fft_len + 4 * B


def stage_ops(num, B: int) -> float:
    return 5.0 * num.fft_len * math.log2(num.fft_len) * B * num.frame_ofdm_symbols


def read(ctx):
    ms = ctx.stage_ms.get("demodulate")
    if not ms:
        return None
    least_s = ctx.steps * max(stage_bytes(ctx.num, ctx.B) / HBM_BYTES_PER_S,
                              stage_ops(ctx.num, ctx.B) / FP32_OPS_PER_S)
    return 100.0 * least_s / (ms * 1e-3)
