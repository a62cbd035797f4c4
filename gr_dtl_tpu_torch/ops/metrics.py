"""Diagnostic metrics: constellation error metric and lost-frame tracking
(port of gr_dtl_tpu/ops/metrics.py).

- :func:`constellation_metric`: per-subcarrier mean squared error between
  decided and soft (pre-decision) symbols, normalized by the
  constellation's least point distance.
- :func:`frame_accounting`: the frame-number gap counter as a scan over
  the frames of a block with a carried expectation, under either of the
  reference's two rules; the streaming sessions call it every block, the
  sharded session for all its streams at once.  A CPU tensor takes the
  plain PyTorch loop, stream by stream; a CUDA tensor takes the CUDA
  kernel (``ops/scans_cuda``, one launch for every stream) or raises.
- :func:`lost_frames`: the batch form, gaps of a whole received sequence.
"""

from __future__ import annotations

import torch

from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.ops import scans_cuda

__all__ = ["constellation_metric", "frame_accounting", "lost_frames"]


def constellation_metric(hard: torch.Tensor, soft: torch.Tensor,
                         cnst_id: torch.Tensor, tab: cn.Tables | None = None) -> torch.Tensor:
    """Per-subcarrier normalized error metric.

    Args:
      hard: [B, n_sym, n_carriers] decided symbols.
      soft: same shape, equalized pre-decision symbols.
      cnst_id: [B] constellation ids.
      tab: the model's constellation tables (``RxParams.tab``); None = the
        installed ones (wire-compat tables have their own least distances).
    Returns [B, n_carriers] float32: mean |hard - soft|^2 over symbols,
    divided by the constellation's least distance.
    """
    err = (torch.abs(hard - soft) ** 2).mean(dim=1)
    mind = (cn.active(hard.device) if tab is None else tab).min_dist[cnst_id.long()]
    return (err / torch.clamp(mind[:, None], min=1e-12)).float()


def frame_accounting(expected_no: torch.Tensor, frame_no: torch.Tensor, ok: torch.Tensor,
                     rule: str = "received"):
    """Lost frames from 12-bit frame-number gaps, with a carried expectation.

    Args:
      expected_no: 0-d (or [S]) int32, the next expected frame number;
                   -1 = no frame seen yet (rule "received" only).
      frame_no:    [T] (or [S, T]) int32 frame numbers in arrival order.
      ok:          [T] (or [S, T]) bool, the frame was decoded.
      rule:        "received": gaps between RECEIVED frames only; an
                   undecoded slot (noise, idle air) changes nothing, so a
                   quiet stretch never wraps the 12-bit counter into
                   phantom losses, and the first received frame counts no
                   gap.  "header": a frame with a bad header is itself one
                   lost frame and advances the expectation by one.
    Returns (expected_no' 0-d (or [S]) int32, lost [T] (or [S, T]) int32,
    totals [2] (or [S, 2]) int32 = [sum of lost, count of ok]).  No host
    synchronisation.
    """
    if rule not in scans_cuda.RULES:
        raise ValueError(f"rule must be one of {sorted(scans_cuda.RULES)}, got {rule!r}")
    frame_no = frame_no.int()
    if frame_no.device.type == "cpu":
        if frame_no.ndim == 1:
            return _frame_accounting_torch(expected_no, frame_no, ok, rule)
        per = [_frame_accounting_torch(expected_no[s], frame_no[s], ok[s], rule)
               for s in range(frame_no.shape[0])]
        return tuple(torch.stack(list(col)) for col in zip(*per))
    lead = tuple(frame_no.shape[:-1])
    exp, lost, totals = scans_cuda.frame_accounting_cuda(
        expected_no.int().reshape(-1), frame_no.contiguous(), ok.contiguous(), rule)
    return exp.reshape(lead), lost, totals


def _frame_accounting_torch(expected_no: torch.Tensor, frame_no: torch.Tensor,
                            ok: torch.Tensor, rule: str = "received"):
    """Plain PyTorch :func:`frame_accounting` (any device): a loop over
    the frames with tensor state.  torch's ``%`` floors, as jnp's."""
    exp = expected_no.int().reshape(())
    frame_no = frame_no.int()
    zero = torch.zeros((), dtype=torch.int32, device=frame_no.device)
    losts = []
    for i in range(frame_no.shape[0]):
        no, okf = frame_no[i], ok[i]
        gap = (no - exp) % 4096
        if rule == "received":
            losts.append(torch.where(okf & (exp >= 0), gap, zero))
            exp = torch.where(okf, (no + 1) % 4096, exp)
        else:
            losts.append(torch.where(okf, gap, zero + 1))
            exp = torch.where(okf, (no + 1) % 4096, (exp + 1) % 4096)
    lost = torch.stack(losts) if losts else zero.new_zeros(0)
    totals = torch.stack([lost.sum().int(), ok.sum().int()])
    return exp, lost, totals


def lost_frames(frame_no: torch.Tensor, header_ok: torch.Tensor,
                expected_first: torch.Tensor | int | None = None):
    """Count lost frames from a received frame-number sequence.

    Args:
      frame_no:  [B] received 12-bit frame numbers, in arrival order.
      header_ok: [B] bool; frames with bad headers are themselves counted
                 lost and do not advance the expected counter past them.
      expected_first: expected number of the first frame (defaults to
                 frame_no[0], i.e. the stream starts in sync).
    Returns (n_lost, n_total, rate): 0-d tensors; rate = lost / total.
    """
    if expected_first is None:
        expected_first = frame_no[0]
    first = torch.as_tensor(expected_first, device=frame_no.device).int() % 4096
    _, _, totals = frame_accounting(first, frame_no, header_ok, rule="header")
    n_lost = totals[0]
    n_total = n_lost + totals[1]
    rate = n_lost / torch.clamp(n_total, min=1)
    return n_lost, n_total, rate.float()
