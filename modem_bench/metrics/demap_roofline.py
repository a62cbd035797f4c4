"""``demap_roofline``: ``receiver.demap_and_verify`` against the least
time its bytes take at the card's memory rate, over the stage's device
time summed over the window's steps.  Uncoded: the payload symbols read
once, the frames' constellation and length fields, and the payload bytes,
lengths and CRC verdicts written once.  Coded (the transport-block decode
deferred to the FEC stage): the payload symbols and noise estimates read
once, and the LLRs the frames carry (bits a symbol of each frame) and the
block's length and code fields written once."""

from modem_bench.peaks import HBM_BYTES_PER_S


def stage_bytes(num, B: int, bps_sum: int, coded: bool) -> int:
    soft = 8 * B * num.frame_capacity_symbols
    if coded:
        return soft + B * (4 + 4 + 4) + 4 * num.frame_capacity_symbols * bps_sum + B * (4 + 4)
    return soft + B * (4 + 4 + 1) + B * num.max_frame_bytes() + B * (4 + 1)


def read(ctx):
    ms = ctx.stage_ms.get("demap")
    if not ms:
        return None
    nbytes = sum(k * stage_bytes(ctx.num, ctx.B, b, ctx.cell.coded) for k, b in zip(ctx.steps_on(), ctx.bps_sum))
    return 100.0 * nbytes / HBM_BYTES_PER_S / (ms * 1e-3)
