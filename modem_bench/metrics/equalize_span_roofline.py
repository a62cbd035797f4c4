"""``equalize_span_roofline``: ``receiver.equalize_passes`` against
``equalize_roofline``'s least time, over the device time of the
program's own span ``rx.equalize`` in the span stretch of ``spans.py``
(CUDA events at the span's boundaries, inside the program)."""

from modem_bench import spans
from modem_bench.metrics import equalize_roofline


def read(ctx):
    return spans.roofline(ctx, equalize_roofline, "equalize")
