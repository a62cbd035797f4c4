"""``detect_roofline``: ``receiver.detect_and_extract`` (the Schmidl-Cox
metric kernel inside) against the least time its bytes take: the stream
read once, the CFO-corrected frames and the fractional CFO written once,
at the card's memory rate, over the stage's device time (CUDA events at
its boundaries, summed over the window's steps)."""

from modem_bench.generator import TAIL_SAMPLES
from modem_bench.peaks import HBM_BYTES_PER_S


def stage_bytes(num, B: int, tail: int) -> int:
    stream = B * num.frame_samples + tail
    return 8 * stream + 8 * B * num.frame_samples + 4 * B


def read(ctx):
    ms = ctx.stage_ms.get("detect")
    if not ms:
        return None
    least_s = ctx.steps * stage_bytes(ctx.num, ctx.B, TAIL_SAMPLES) / HBM_BYTES_PER_S
    return 100.0 * least_s / (ms * 1e-3)
