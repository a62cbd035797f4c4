"""Adaptive MCS control: SNR-threshold decision with hysteresis and a
confirmation counter (port of gr_dtl_tpu/models/adaptive.py).

- the LUT maps MCS id -> (snr_threshold_dB, (constellation, fec));
  entry 0's threshold is -inf,
- if snr < threshold(current)            -> candidate = current - 1
- elif snr > threshold(current+1) + hyst -> candidate = current + 1
- else reset the consecutive counter,
- a candidate only becomes active after it has been proposed
  ``decision_th`` times in a row (counter reset on every change),
- defaults: hysteresis 1 dB, decision_th 5.

The decision is sequential across frames: :func:`feedback_scan` walks the
frame sequence with tensor state (no host synchronisation), and the state's
batch shape takes the place of the reference's ``vmap`` over streams.  A CPU
tensor takes the plain PyTorch loop (``_feedback_scan_masked_torch``); a
CUDA tensor takes the CUDA kernel (``ops/feedback_cuda``, K7: one launch a
call) or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gr_dtl_tpu_torch.ops import feedback_cuda

__all__ = ["FeedbackState", "build_mcs_tables", "tables_from_reference", "tables_to",
           "initial_state", "feedback_state_from_reference", "feedback_state_to_numpy",
           "lookup", "feedback_step", "feedback_scan", "feedback_scan_masked"]


class FeedbackState(NamedTuple):
    last: torch.Tensor  # int32 active MCS id
    cand: torch.Tensor  # int32 candidate MCS id
    counter: torch.Tensor  # int32 consecutive confirmations of cand


def build_mcs_tables(cfg) -> dict:
    """LUT arrays (numpy) from the config's mcs ladder."""
    snr = np.array([s for s, _ in cfg.mcs], dtype=np.float32)
    snr[0] = -np.inf
    cnst = np.array([int(c) for _, (c, _) in cfg.mcs], dtype=np.int32)
    fec_names = [f for _, (_, f) in cfg.mcs]
    code_ids = {name: i + 1 for i, (name, _) in enumerate(cfg.fec_codes)}
    code_ids["no_fec"] = 0
    fec = np.array([code_ids.get(f, 0) for f in fec_names], dtype=np.int32)
    return {
        "snr_th": snr,
        "cnst": cnst,
        "fec": fec,
        "n_mcs": len(cfg.mcs),
        "hysteresis": 1.0,
        "decision_th": 5,
    }


def tables_from_reference(tables) -> dict:
    """The reference's ``build_mcs_tables`` dict with its arrays as numpy."""
    return {k: (np.asarray(v) if k in ("snr_th", "cnst", "fec") else v)
            for k, v in tables.items()}


def tables_to(tables: dict, device) -> dict:
    """The tables with ``snr_th`` as a float32 tensor on ``device``, so that
    :func:`feedback_step` uploads nothing (the sessions call this once)."""
    return dict(tables, snr_th=torch.as_tensor(np.asarray(tables["snr_th"], np.float32),
                                               device=device))


def initial_state(mcs_id: int, batch_shape, device) -> FeedbackState:
    z = torch.full(tuple(batch_shape), int(mcs_id), dtype=torch.int32, device=device)
    return FeedbackState(last=z, cand=z.clone(), counter=torch.zeros_like(z))


def feedback_state_from_reference(state, device) -> FeedbackState:
    """The reference's ``FeedbackState`` (leaves as numpy, in field order)
    as the port's, on ``device``."""
    return FeedbackState(*(torch.tensor(np.asarray(a, np.int32), device=device) for a in state))


def feedback_state_to_numpy(state: FeedbackState) -> tuple:
    return tuple(a.cpu().numpy() for a in state)


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an integer tensor ``idx`` of any shape, 0-dim
    included, without a host synchronisation: indexing by a 0-dim tensor
    reads its value back to the host."""
    return table[idx.long().reshape(-1)].reshape(idx.shape)


def feedback_step(state: FeedbackState, snr_db: torch.Tensor, tables):
    """One decision update.  ``snr_db`` and the state's fields share a
    batch shape.  Returns (state', active MCS id)."""
    snr_th = tables["snr_th"]
    if not isinstance(snr_th, torch.Tensor):
        snr_th = torch.as_tensor(snr_th, device=snr_db.device)
    n = tables["n_mcs"]
    hyst = tables["hysteresis"]
    th = tables["decision_th"]

    cur = state.last
    down = snr_db < lookup(snr_th, cur)
    can_up = cur + 1 < n
    up = can_up & (snr_db > lookup(snr_th, torch.clamp(cur + 1, 0, n - 1)) + hyst)

    candidate = torch.where(down, torch.clamp(cur - 1, min=0), torch.where(up, cur + 1, cur))
    propose = down | up

    changed = candidate != state.cand
    new_cand = torch.where(propose & changed, candidate, state.cand)
    zero = torch.zeros_like(state.counter)
    new_counter = torch.where(propose, torch.where(changed, zero, state.counter + 1), zero)
    commit = propose & ~changed & (new_counter >= th)
    new_last = torch.where(commit, new_cand, state.last)
    new_counter = torch.where(commit, zero, new_counter)
    return FeedbackState(last=new_last, cand=new_cand, counter=new_counter), new_last


def feedback_scan(state: FeedbackState, snrs_db: torch.Tensor, tables):
    """Sequential decisions over [T] (or [T, ...batch]) SNR estimates.

    Returns (final_state, mcs_ids [T, ...]).
    """
    return feedback_scan_masked(state, snrs_db, None, tables)


def feedback_scan_masked(state: FeedbackState, snrs_db: torch.Tensor,
                         mask: torch.Tensor | None, tables):
    """:func:`feedback_scan` where a frame with ``mask`` False (not
    decoded) leaves the decision state as it was and reports the active
    MCS id ``state.last``.  ``mask``: [T] (or [T, ...batch]) bool, or None
    for every frame.  The streaming sessions' fixed-length scan.

    On a CUDA tensor this is one launch of K7 (``state`` int32, ``snrs_db``
    float32, ``mask`` bool); on a CPU tensor the plain loop."""
    if not isinstance(tables["snr_th"], torch.Tensor):
        tables = tables_to(tables, snrs_db.device)  # once, not once a frame
    if snrs_db.device.type == "cpu":
        return _feedback_scan_masked_torch(state, snrs_db, mask, tables)
    out, mcs = feedback_cuda.feedback_scan_masked_cuda(
        state.last, state.cand, state.counter, snrs_db.contiguous(),
        None if mask is None else mask.contiguous(), tables["snr_th"], tables["n_mcs"],
        tables["hysteresis"], tables["decision_th"])
    return FeedbackState(out[0], out[1], out[2]), mcs


def _feedback_scan_masked_torch(state: FeedbackState, snrs_db: torch.Tensor,
                                mask: torch.Tensor | None, tables):
    """Plain PyTorch :func:`feedback_scan_masked` (any device): a loop over
    the frames with tensor state, ~35 kernel launches a frame."""
    mcs = []
    for i in range(snrs_db.shape[0]):
        ns, m = feedback_step(state, snrs_db[i], tables)
        if mask is not None:
            ns = FeedbackState(*(torch.where(mask[i], a, b) for a, b in zip(ns, state)))
            m = torch.where(mask[i], m, state.last)
        state = ns
        mcs.append(m)
    if not mcs:
        return state, state.last.new_zeros((0, *state.last.shape))
    return state, torch.stack(mcs)
