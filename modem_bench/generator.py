"""What every traffic kind shares: a ring of sample streams made on the
device by the reference transmitter, with what each stream carries.

A kind (``traffic/<kind>.py``) has ``make(mix, modem, seed, device)``,
which returns :data:`RING` streams of ``mix["frames_per_step"]`` frames.
The two first kinds draw each frame as :func:`frames` does and differ in
the channel:

- every frame is filled to capacity: uncoded, the frame's bytes less its
  CRC32; coded, the full transport block of its constellation;
- ``constellations``: ids (1 BPSK, 2 QPSK, 3 8PSK, 4 16QAM) drawn
  uniformly for each frame;
- frames sit back to back from sample 0, frame numbers 0.. mod 4096, the
  feedback fields 0, then :data:`TAIL_SAMPLES` zeros, then the noise.

Every draw (constellations, payload and pad bytes, noise) comes from one
``torch.Generator`` on the device, seeded ``seed``, in a fixed order: a
seed gives the same streams on any run.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from modem_bench.reference import dsp
from modem_bench.reference.modem import Modem, tx_frames

RING = 2  # distinct streams, received in turn: no two consecutive steps see the same samples
TAIL_SAMPLES = 2048  # zeros after the last frame, before the noise


class Stream(NamedTuple):
    samples: torch.Tensor  # [B * frame_samples + TAIL_SAMPLES] complex64
    cnst: torch.Tensor  # [B] int32 constellation sent
    payload_len: torch.Tensor  # [B] int32 user bytes sent
    payload: torch.Tensor  # [B, max bytes] uint8 user bytes sent, 0 past the length


def user_bytes(m: Modem, cnst: torch.Tensor) -> torch.Tensor:
    """User bytes of a frame filled to capacity, by constellation."""
    bps = dsp.tables(cnst.device)[1][cnst.long()]
    if m.fec is not None:
        return torch.as_tensor(m.fec.user_bytes, device=cnst.device)[bps].int()
    return (m.num.frame_capacity_symbols * bps // 8 - 4).int()


def rng(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def frames(mix: dict, m: Modem, gen: torch.Generator, device) -> tuple[torch.Tensor, Stream]:
    """(the clean stream [B * frame_samples], what it carries) of B frames,
    constellations drawn uniformly over ``mix["constellations"]``."""
    B = int(mix["frames_per_step"])
    ids = torch.as_tensor(mix["constellations"], dtype=torch.int32, device=device)
    maxb = m.fec.max_payload_bytes if m.fec is not None else m.num.max_frame_bytes()
    cnst = ids[torch.randint(0, len(ids), (B,), generator=gen, device=device)]
    plen = user_bytes(m, cnst)
    raw = torch.randint(0, 256, (B, maxb), generator=gen, device=device, dtype=torch.uint8)
    payload = torch.where(torch.arange(maxb, device=device)[None, :] < plen[:, None], raw, 0)
    pad = torch.randint(0, 256, (B, m.num.max_frame_bytes()), generator=gen, device=device, dtype=torch.uint8)
    frame_no = torch.arange(B, dtype=torch.int32, device=device) % 4096
    clean = tx_frames(m, payload, plen, cnst, frame_no, pad).reshape(-1)
    return clean, Stream(clean, cnst, plen, payload)


def awgn(clean: torch.Tensor, v: float, gen: torch.Generator) -> torch.Tensor:
    """``clean`` and :data:`TAIL_SAMPLES` zeros plus complex AWGN with
    E|n|^2 = v^2."""
    s = torch.cat([clean, torch.zeros(TAIL_SAMPLES, dtype=torch.complex64, device=clean.device)])
    noise = torch.complex(torch.randn(s.shape, generator=gen, device=s.device),
                          torch.randn(s.shape, generator=gen, device=s.device))
    return s + (v / math.sqrt(2.0) * noise).to(torch.complex64)


def snr_voltage(clean: torch.Tensor, snr_db: float) -> float:
    """The noise voltage that puts ``clean``'s measured mean power
    ``snr_db`` above the noise."""
    return math.sqrt(float(torch.mean(torch.abs(clean) ** 2)) / 10 ** (snr_db / 10))
