"""``bp_updates_per_codeword``: the message updates the program's BP took
on real codewords over the real codewords it decoded, from its counters
``fec.bp_updates`` and ``fec.codewords`` over the span stretch of
``spans.py`` (the reference's mean on the same streams goes beside it to
standard error)."""

from modem_bench import spans


def read(ctx):
    r = spans.of(ctx)
    if not r or not r.counters.get("fec.codewords"):
        return None
    return r.counters["fec.bp_updates"] / r.counters["fec.codewords"]
