"""``demap_span_roofline``: ``receiver.demap_and_verify`` against
``demap_roofline``'s least time, over the device time of the program's
own span ``rx.demap`` less its child ``fec.decode`` (coded) in the span
stretch of ``spans.py`` (CUDA events at the span's boundaries, inside
the program)."""

from modem_bench import spans
from modem_bench.metrics import demap_roofline


def read(ctx):
    return spans.roofline(ctx, demap_roofline, "demap")
