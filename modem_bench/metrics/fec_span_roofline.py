"""``fec_span_roofline``: ``fec_chain.fec_frame_decode`` against
``fec_roofline``'s least time, over the device time of the program's own
span ``fec.decode`` in the span stretch of ``spans.py`` (CUDA events at
the span's boundaries, inside the program)."""

from modem_bench import spans
from modem_bench.metrics import fec_roofline


def read(ctx):
    return spans.roofline(ctx, fec_roofline, "fec")
