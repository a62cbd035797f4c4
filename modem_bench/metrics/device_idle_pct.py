"""``device_idle_pct``: the share of the profiled steps' window in which
no kernel or copy ran on the card (1 - the union of their intervals over
the window, from the marker kernel's end to the last operation's)."""


def read(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
