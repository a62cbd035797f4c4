"""Simplex adaptive modem: OFDM forward link + narrowband burst reverse
(port of gr_dtl_tpu/models/simplex.py).

The TX node sends OFDM frames and listens for feedback bursts on the
reverse channel; the RX node demodulates frames, runs the MCS decision on
its SNR estimate and transmits the decision as a BPSK burst (access code
+ constellation + FEC + CRC8).  On burst reception the TX switches its
constellation: in the simplex topology the burst carries the actual MCS
to use.

The bidirectional session is a Python loop over rounds (a ``lax.scan``
in the reference) whose carried state stays in device tensors: no
``.item()`` and no host ``if`` on a tensor inside a round; the telemetry
is stacked once at the end.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gr_dtl_tpu_torch.models import adaptive, receiver, transmitter
from gr_dtl_tpu_torch.ops import burst, channel as chan, constellation as cn

__all__ = ["SimplexState", "build_simplex", "initial_simplex_state",
           "simplex_state_from_reference", "draw_rounds", "rounds_runner"]


class SimplexState(NamedTuple):
    tx_cnst: torch.Tensor  # TX node's current constellation (burst-controlled)
    rx_fb: adaptive.FeedbackState  # RX node's decision state
    frame_no: torch.Tensor


def initial_simplex_state(cfg, tables, device) -> SimplexState:
    init_cnst = int(np.asarray(tables["cnst"])[cfg.initial_mcs_id])
    return SimplexState(
        tx_cnst=torch.tensor(init_cnst, dtype=torch.int32, device=device),
        rx_fb=adaptive.initial_state(cfg.initial_mcs_id, (), device),
        frame_no=torch.tensor(0, dtype=torch.int32, device=device),
    )


def simplex_state_from_reference(state, device) -> SimplexState:
    """The reference's ``SimplexState`` (leaves as numpy, in field order)
    as the port's, on ``device``."""
    tx_cnst, rx_fb, frame_no = state
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)
    return SimplexState(tx_cnst=i32(tx_cnst),
                        rx_fb=adaptive.feedback_state_from_reference(rx_fb, device),
                        frame_no=i32(frame_no))


def draw_rounds(shapes: dict, n_rounds: int, device, generator: torch.Generator) -> dict:
    """The random draws of ``n_rounds`` rounds: for every name of ``shapes``
    a tensor ``[n_rounds, *shape]``, uint8 bytes for an integer dtype and
    complex unit normal draws (:func:`ops.channel.awgn`'s ``noise``) for a
    complex one."""
    out = {}
    for name, (shape, dtype) in shapes.items():
        full = (n_rounds, *shape)
        if dtype == torch.uint8:
            out[name] = torch.randint(0, 256, full, generator=generator, device=device,
                                      dtype=torch.uint8)
        else:
            re = torch.randn(full, generator=generator, device=device)
            out[name] = torch.complex(re, torch.randn(full, generator=generator, device=device))
    return out


def check_draws(draws: dict, shapes: dict, n_rounds: int) -> None:
    for name, (shape, _) in shapes.items():
        if name not in draws or tuple(draws[name].shape) != (n_rounds, *shape):
            got = tuple(draws[name].shape) if name in draws else None
            raise ValueError(f"draws[{name!r}] must be {(n_rounds, *shape)}, got {got}")


def rounds_runner(round_step, shapes: dict, tables: dict, device):
    """``run(state, n_rounds=32, *, generator=None, draws=None)`` around
    ``round_step(state, round's draws, tables on the device)``: the loop
    over rounds with the state in device tensors and the telemetry stacked
    once at the end.  ``run.draw_shapes`` is ``shapes``."""

    def run(state, n_rounds: int = 32, *, generator=None, draws=None):
        if (generator is None) == (draws is None):
            raise ValueError("run takes exactly one of generator= or draws=")
        if draws is None:
            draws = draw_rounds(shapes, n_rounds, device, generator)
        check_draws(draws, shapes, n_rounds)
        tdev = adaptive.tables_to(tables, device)  # read now: a caller may have set decision_th
        telem = []
        for r in range(n_rounds):
            state, t = round_step(state, {k: draws[k][r] for k in shapes}, tdev)
            telem.append(t)
        if not telem:
            return state, {}
        return state, {k: torch.stack([t[k] for t in telem]) for k in telem[0]}

    run.draw_shapes = shapes
    return run


def build_simplex(cfg, device, *, noise_fwd: float, noise_rev: float):
    """Simplex session: forward OFDM + reverse burst, both lossy.

    Returns ``(run, tables)``; ``run(state, n_rounds=32, *, generator=None,
    draws=None) -> (state, telemetry)`` takes exactly one of a generator on
    ``device`` or a structure of per-round draws, ``run.draw_shapes``: a
    dict of ``[n_rounds, ...]`` tensors, ``payload`` and ``pad`` ([1,
    max_frame_bytes] uint8 a round) and ``noise_fwd`` / ``noise_rev`` ([1,
    frame_samples] / [1, burst samples] complex unit normal draws).  The
    telemetry is a dict of ``[n_rounds]`` tensors.
    """
    device = torch.device(device)
    txp = transmitter.build_tx(cfg, device)
    rxp = receiver.build_rx(cfg, device)
    tables = adaptive.build_mcs_tables(cfg)
    modem = burst.build_burst_modem(device)
    bps_table = cn.tables(device)[1]
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    cnst_of_mcs = i32(tables["cnst"])
    fec_of_mcs = i32(tables["fec"])
    maxb = cfg.max_frame_bytes()
    cap_per_bps = i32([0] + [cfg.frame_bytes(b) - 4 for b in range(1, 5)])
    shapes = {"payload": ((1, maxb), torch.uint8), "pad": ((1, maxb), torch.uint8),
              "noise_fwd": ((1, cfg.frame_samples), torch.complex64),
              "noise_rev": ((1, burst.burst_wave_len(modem) + 64), torch.complex64)}
    look = adaptive.lookup

    def round_step(state: SimplexState, d: dict, tdev: dict):
        # --- forward link: TX node -> RX node ---
        plen = look(cap_per_bps, look(bps_table, state.tx_cnst))
        out = transmitter.tx_frames(
            txp, d["payload"], plen[None], state.tx_cnst[None],
            look(cnst_of_mcs, state.rx_fb.last)[None],  # unused echo in simplex
            state.frame_no[None], d["pad"])
        fwd = chan.awgn(out.samples, noise_fwd, noise=d["noise_fwd"])
        rx = receiver.rx_frames(rxp, fwd, fallback_cnst=state.tx_cnst[None])

        # --- RX node decision + reverse burst ---
        fb, _ = adaptive.feedback_step(state.rx_fb, rx.snr_db[0], tdev)
        fb = adaptive.FeedbackState(*(torch.where(rx.header_ok[0], new, old)
                                      for new, old in zip(fb, state.rx_fb)))
        want_cnst = look(cnst_of_mcs, fb.last)
        want_fec = look(fec_of_mcs, fb.last)
        wave = burst.burst_tx(want_cnst[None], want_fec[None], modem)
        rev = chan.awgn(wave, noise_rev, noise=d["noise_rev"])
        fb_rx = burst.burst_rx(rev, modem)

        # --- TX node applies the burst ---
        got = fb_rx.ok[0] & (fb_rx.cnst_id[0] >= 1) & (fb_rx.cnst_id[0] <= 4)
        new_tx_cnst = torch.where(got, fb_rx.cnst_id[0], state.tx_cnst)

        new_state = SimplexState(tx_cnst=new_tx_cnst, rx_fb=fb,
                                 frame_no=(state.frame_no + 1) & 0xFFF)
        telem = {"tx_cnst": new_tx_cnst, "snr_db": rx.snr_db[0], "crc_ok": rx.crc_ok[0],
                 "burst_ok": fb_rx.ok[0], "requested": want_cnst}
        return new_state, telem

    return rounds_runner(round_step, shapes, tables, device), tables
