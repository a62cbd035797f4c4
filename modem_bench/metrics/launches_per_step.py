"""``launches_per_step``: kernels and copies that ran on the card in the
profiled steps (after the marker kernel), over the steps: the host's
enqueue, launch by launch."""


def read(ctx):
    t = ctx.trace
    if not t or not t["steps"]:
        return None
    return t["launches"] / t["steps"]
