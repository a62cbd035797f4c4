"""``detect_span_roofline``: ``receiver.detect_and_extract`` against
``detect_roofline``'s least time, over the device time of the program's
own span ``rx.detect`` in the span stretch of ``spans.py`` (CUDA events
at the span's boundaries, inside the program)."""

from modem_bench import spans
from modem_bench.metrics import detect_roofline


def read(ctx):
    return spans.roofline(ctx, detect_roofline, "detect")
