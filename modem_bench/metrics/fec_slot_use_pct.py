"""``fec_slot_use_pct``: the real codewords among the codeword slots the
program's BP decoded (a frame's slots are the largest rung's count; a
lower rung's spare slots are dummies), from its counters
``fec.codewords`` and ``fec.codeword_slots`` over the span stretch of
``spans.py``."""

from modem_bench import spans


def read(ctx):
    r = spans.of(ctx)
    if not r or not r.counters.get("fec.codeword_slots"):
        return None
    return 100.0 * r.counters["fec.codewords"] / r.counters["fec.codeword_slots"]
