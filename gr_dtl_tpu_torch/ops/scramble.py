"""Additive (XOR) LFSR scrambler with per-frame reset (port of
gr_dtl_tpu/ops/scramble.py).

GNU Radio's ``digital.additive_scrambler_bb(0x8a, seed, 7)``: the
per-frame reset makes every frame see the same sequence, so it is made
once on the host and applied as one XOR over the frame byte batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["lfsr_bytes", "scramble_frames"]


@functools.lru_cache(maxsize=None)
def lfsr_bytes(mask: int = 0x8A, seed: int = 0x7F, reg_len: int = 7,
               n_bytes: int = 1024) -> np.ndarray:
    """Byte sequence of the additive scrambler (LSB-first bit packing).

    gr::digital::lfsr semantics: output = LSB of the register; the
    feedback bit (parity of register & mask) shifts into bit position
    *reg_len*.  With (0x8A, 0x7F, 7) the sequence has period 63.
    """
    reg = seed
    out = np.zeros(n_bytes, dtype=np.uint8)
    for i in range(n_bytes):
        b = 0
        for j in range(8):
            bit = reg & 1
            newbit = bin(reg & mask).count("1") & 1
            reg = (reg >> 1) | (newbit << reg_len)
            b |= bit << j
        out[i] = b
    return out


def scramble_frames(frames: torch.Tensor, seed: int = 0x7F) -> torch.Tensor:
    """XOR-scramble (or descramble: an involution) a [B, n_bytes] uint8
    batch.  seed 0 disables scrambling (all-zero sequence)."""
    if seed == 0:
        return frames
    seq = torch.as_tensor(lfsr_bytes(0x8A, seed, 7, frames.shape[-1]), device=frames.device)
    return frames ^ seq[None, :]
