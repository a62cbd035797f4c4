"""``demodulate_span_roofline``: ``receiver.demodulate`` against
``demodulate_roofline``'s least time, over the device time of the
program's own span ``rx.demodulate`` in the span stretch of ``spans.py``
(CUDA events at the span's boundaries, inside the program)."""

from modem_bench import spans
from modem_bench.metrics import demodulate_roofline


def read(ctx):
    return spans.roofline(ctx, demodulate_roofline, "demodulate")
