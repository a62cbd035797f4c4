"""Streaming-input plumbing: PDU packing and trigger lock tracking (port
of gr_dtl_tpu/models/streaming.py).

- :func:`pack_pdus` / :func:`pack_pdus_budget`: frames consume whole PDUs
  up to the frame's byte capacity; a PDU larger than the capacity
  ("jumbo") is split across consecutive frames; otherwise PDUs never
  straddle a frame boundary.  TX input plumbing on the host, pure Python
  and numpy.

- :func:`trigger_lock_scan`: across successive stream blocks, per-block
  trigger candidates are tracked by a lock state machine: ``LOCK_AFTER``
  consecutive period-consistent triggers to lock, ``UNLOCK_AFTER``
  consecutive misses to unlock, missing triggers synthesized from the
  period while locked.  A CPU tensor takes the plain PyTorch loop; a CUDA
  tensor takes the CUDA kernel (``ops/scans_cuda``) or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gr_dtl_tpu_torch.ops import scans_cuda

__all__ = ["pack_pdus", "pack_pdus_budget", "TriggerLockState", "initial_lock_state",
           "lock_state_from_reference", "lock_state_to_numpy",
           "trigger_lock_scan", "LOCK_AFTER", "UNLOCK_AFTER"]

LOCK_AFTER = 3  # consecutive synced triggers to lock (kLockAfter of csrc/stream_scans.cu)
UNLOCK_AFTER = 5  # consecutive missing triggers to unlock (kUnlockAfter)


def pack_pdus(pdus: list[bytes], frame_capacity: int, max_frames: int | None = None):
    """Pack a PDU queue into frame payloads.

    Args:
      pdus: list of byte strings (network packets, etc.).
      frame_capacity: usable payload bytes per frame (capacity - CRC).
    Returns (payload [B, frame_capacity] uint8, payload_len [B] int32,
    boundaries: list of per-frame lists of (offset, len) PDU extents).
    """
    frames: list[bytearray] = []
    bounds: list[list[tuple[int, int]]] = []
    cur = bytearray()
    cur_bounds: list[tuple[int, int]] = []

    def flush():
        nonlocal cur, cur_bounds
        if cur:
            frames.append(cur)
            bounds.append(cur_bounds)
            cur = bytearray()
            cur_bounds = []

    for pdu in pdus:
        if len(pdu) > frame_capacity:
            # jumbo: split across frames of its own
            flush()
            off = 0
            while off < len(pdu):
                chunk = pdu[off : off + frame_capacity]
                frames.append(bytearray(chunk))
                bounds.append([(0, len(chunk))])
                off += frame_capacity
            continue
        if len(cur) + len(pdu) > frame_capacity:
            flush()
        cur_bounds.append((len(cur), len(pdu)))
        cur += pdu
    flush()

    if max_frames is not None:
        frames = frames[:max_frames]
        bounds = bounds[:max_frames]
    B = len(frames)
    payload = np.zeros((B, frame_capacity), np.uint8)
    plen = np.zeros(B, np.int32)
    for i, f in enumerate(frames):
        payload[i, : len(f)] = np.frombuffer(bytes(f), np.uint8)
        plen[i] = len(f)
    return payload, plen, bounds


def pack_pdus_budget(queue: list[bytes], jumbo_rest: bytes, cap: int,
                     max_frames: int) -> tuple[list[bytes], bytes]:
    """Incremental :func:`pack_pdus` with a hard frame budget.

    Same whole-PDU/jumbo-split semantics, but consumes at most
    ``max_frames`` frames' worth of input: ``queue`` is popped in place
    (leftover PDUs stay queued), and an unfinished jumbo split is
    returned as the new ``jumbo_rest`` carry.  Used by
    :class:`gr_dtl_tpu_torch.models.session.StreamTx`.

    Returns (frames: list of per-frame payload bytes, jumbo_rest).
    """
    frames: list[bytes] = []
    cur = bytearray()
    if jumbo_rest:
        rest = jumbo_rest
        while rest and len(frames) < max_frames:
            frames.append(rest[:cap])
            rest = rest[cap:]
        jumbo_rest = rest
        if jumbo_rest:
            return frames, jumbo_rest
    else:
        jumbo_rest = b""
    while queue and len(frames) < max_frames:
        pdu = queue[0]
        if len(pdu) > cap:
            # jumbo: own frames, split; the tail chunk also gets its own frame
            if cur:
                frames.append(bytes(cur))
                cur = bytearray()
                continue
            queue.pop(0)
            while pdu and len(frames) < max_frames:
                frames.append(pdu[:cap])
                pdu = pdu[cap:]
            jumbo_rest = pdu
            continue
        if len(cur) + len(pdu) > cap:
            frames.append(bytes(cur))
            cur = bytearray()
            continue
        cur += queue.pop(0)
    if cur and len(frames) < max_frames:
        frames.append(bytes(cur))
    return frames, jumbo_rest


class TriggerLockState(NamedTuple):
    locked: torch.Tensor  # 0-d bool
    expected: torch.Tensor  # 0-d int32 expected trigger position (stream units)
    sync_count: torch.Tensor  # 0-d int32 consecutive consistent triggers
    miss_count: torch.Tensor  # 0-d int32 consecutive misses while locked


def initial_lock_state(device) -> TriggerLockState:
    """Unlocked, nothing expected, on ``device``."""
    z = torch.zeros(3, dtype=torch.int32, device=device)
    return TriggerLockState(torch.zeros((), dtype=torch.bool, device=device), z[0], z[1], z[2])


def lock_state_from_reference(state, device) -> TriggerLockState:
    """The reference's ``TriggerLockState`` (its four leaves as numpy
    arrays or scalars, in field order) as the port's, on ``device``."""
    locked, expected, sync_count, miss_count = (np.asarray(a) for a in state)
    i32 = lambda a: torch.tensor(int(a), dtype=torch.int32, device=device)
    return TriggerLockState(torch.tensor(bool(locked), device=device), i32(expected),
                            i32(sync_count), i32(miss_count))


def lock_state_to_numpy(state: TriggerLockState) -> tuple:
    """(locked bool, expected, sync_count, miss_count int32) as numpy scalars."""
    return (np.bool_(bool(state.locked)),) + tuple(np.int32(int(a)) for a in state[1:])


def trigger_lock_scan(state: TriggerLockState, candidates: torch.Tensor,
                      found: torch.Tensor, period: int, tol: int = 4):
    """Track triggers across stream blocks with lock/unlock hysteresis.

    Args:
      state:      carry from the previous call.
      candidates: [T] int32 candidate trigger positions (absolute stream
                  sample index), one per expected frame slot.
      found:      [T] bool whether the detector saw a plausible metric
                  peak for that slot.
      period:     nominal frame period in samples.
      tol:        +- samples considered "consistent".
    Returns (state, (triggers [T] int32, valid [T] bool)): corrected
    trigger positions (synthesized from the period when locked and the
    candidate is missing or off), and whether each should be demodulated.
    No host synchronisation on either device.
    """
    candidates = candidates.int()
    if candidates.device.type == "cpu":
        return _trigger_lock_scan_torch(state, candidates, found, period, tol)
    packed = torch.stack([state.locked.int(), state.expected.int(), state.sync_count.int(),
                          state.miss_count.int()])
    out, trig, valid = scans_cuda.trigger_lock_scan_cuda(
        packed, candidates.contiguous(), found.contiguous(), period, tol)
    return TriggerLockState(out[0] != 0, out[1], out[2], out[3]), (trig, valid)


def _trigger_lock_scan_torch(state: TriggerLockState, candidates: torch.Tensor,
                             found: torch.Tensor, period: int, tol: int = 4):
    """Plain PyTorch :func:`trigger_lock_scan` (any device): a loop over
    the slots with tensor state."""
    candidates = candidates.int()
    dev = candidates.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    one = zero + 1
    true = torch.ones((), dtype=torch.bool, device=dev)
    s = TriggerLockState(state.locked, state.expected.int(), state.sync_count.int(),
                         state.miss_count.int())
    trigs, valids = [], []
    for i in range(candidates.shape[0]):
        cand, ok = candidates[i], found[i]
        consistent = ok & (torch.abs(cand - s.expected) <= tol)
        sync_count = torch.where(consistent, s.sync_count + 1, torch.where(ok, one, zero))
        miss_count = torch.where(s.locked & ~consistent, s.miss_count + 1, zero)
        locked = torch.where(sync_count >= LOCK_AFTER, true, s.locked)
        locked = torch.where(miss_count >= UNLOCK_AFTER, ~true, locked)
        # trust the candidate when consistent or unlocked-but-found;
        # synthesize from the expectation when locked and missing
        take = consistent | (~s.locked & ok)
        trig = torch.where(take, cand, s.expected)
        trigs.append(trig)
        valids.append(take | s.locked)
        s = TriggerLockState(locked, trig + period, sync_count, miss_count)
    if not trigs:
        return s, (candidates, found.bool())
    return s, (torch.stack(trigs), torch.stack(valids))
