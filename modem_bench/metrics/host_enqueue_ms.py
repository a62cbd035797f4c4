"""``host_enqueue_ms``: the median host time of the program's root span
``rx.step`` over steps each started on a drained card (stretch (b) of
``spans.py``): the host's own time to enqueue one step with no
back-pressure from the card."""

from modem_bench import spans


def read(ctx):
    r = spans.of(ctx)
    return r.host_enqueue_ms if r else None
