"""``fec_roofline``: ``fec_chain.fec_frame_decode`` (codeword extraction,
the sum-product BP kernel, reassembly, CRC32) against the larger of two
least times, over the stage's device time summed over the window's steps:

- bytes: the LLRs the frames carry read once, the frames' constellation
  and block length read once, the user bytes, lengths and verdicts
  (CRC, FEC, mean BP updates) written once, at the card's memory rate;
- operations: BP's for the updates these inputs need, as the reference's
  decoder took them on the same streams: every codeword slot takes
  ``updates + 1`` passes of totals and syndrome (2 E + N) and ``updates``
  message updates of 18 operations an edge, at the card's float32 rate.
"""

from modem_bench.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S

UPDATE_OPS_PER_EDGE = 18


def stage_bytes(num, B: int, bps_sum: int, max_payload_bytes: int) -> int:
    return 4 * num.frame_capacity_symbols * bps_sum + B * (4 + 4) + B * (max_payload_bytes + 4 + 1 + 1 + 4)


def bp_ops(iters, code) -> float:
    """``iters``: [B, codeword slots] updates each slot took (0 for a slot
    that converged at once or carries no codeword)."""
    slots, U = iters.numel(), int(iters.sum())
    E, N = code.n_edge, code.N
    return float((slots + U) * (2 * E + N) + U * UPDATE_OPS_PER_EDGE * E)


def read(ctx):
    ms = ctx.stage_ms.get("fec")
    fec = ctx.modem.fec
    if not ms or fec is None:
        return None
    least_s = 0.0
    for k, b, it in zip(ctx.steps_on(), ctx.bps_sum, ctx.ref_bp_iters):
        least_s += k * max(stage_bytes(ctx.num, ctx.B, b, fec.max_payload_bytes) / HBM_BYTES_PER_S,
                           bp_ops(it, fec.code) / FP32_OPS_PER_S)
    return 100.0 * least_s / (ms * 1e-3)
