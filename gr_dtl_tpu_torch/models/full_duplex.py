"""Full-duplex adaptive modem: two nodes, in-band MCS adaptation (port of
gr_dtl_tpu/models/full_duplex.py).

Each node's RX measures the SNR of its inbound link and runs the feedback
decision; the decision is *echoed* in the 4-bit ``feedback_constellation``
field of the node's outgoing headers; the peer switches its TX
constellation to the echoed value when the header CRC passes.

The whole bidirectional session is a Python loop over rounds (one
``lax.scan`` in the reference); both directions' TX + channel + RX run
inside a round, with the adaptation state (feedback decision state,
current TX constellations and codes, frame counters) carried in device
tensors: no ``.item()`` and no host ``if`` on a tensor inside a round
(with ``fec=`` the BP decoder's one host check an iteration remains), and
the telemetry is stacked once at the end.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gr_dtl_tpu_torch.models import adaptive, receiver, transmitter
from gr_dtl_tpu_torch.models.simplex import rounds_runner
from gr_dtl_tpu_torch.ops import channel as chan
from gr_dtl_tpu_torch.ops import constellation as cn

__all__ = ["NodeState", "DuplexState", "build_full_duplex", "initial_duplex_state",
           "duplex_state_from_reference"]


class NodeState(NamedTuple):
    fb: adaptive.FeedbackState  # decision state for the inbound link
    tx_cnst: torch.Tensor  # current TX constellation (peer-controlled)
    tx_fec: torch.Tensor  # current TX FEC code id (peer-controlled; 0 = none)
    frame_no: torch.Tensor


class DuplexState(NamedTuple):
    a: NodeState
    b: NodeState


def initial_duplex_state(cfg, tables, device) -> DuplexState:
    init_cnst = int(np.asarray(tables["cnst"])[cfg.initial_mcs_id])
    init_fec = int(np.asarray(tables["fec"])[cfg.initial_mcs_id])
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)

    def node():
        return NodeState(fb=adaptive.initial_state(cfg.initial_mcs_id, (), device),
                         tx_cnst=i32(init_cnst), tx_fec=i32(init_fec), frame_no=i32(0))

    return DuplexState(a=node(), b=node())


def duplex_state_from_reference(state, device) -> DuplexState:
    """The reference's ``DuplexState`` (leaves as numpy, in field order) as
    the port's, on ``device``."""
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)

    def node(n):
        fb, tx_cnst, tx_fec, frame_no = n
        return NodeState(fb=adaptive.feedback_state_from_reference(fb, device),
                         tx_cnst=i32(tx_cnst), tx_fec=i32(tx_fec), frame_no=i32(frame_no))

    a, b = state
    return DuplexState(a=node(a), b=node(b))


def build_full_duplex(cfg, device, *, noise_ab: float, noise_ba: float, fec=None):
    """Bidirectional session runner.

    Args:
      cfg: modem config (both nodes share it).
      device: where the session's state and work live.
      noise_ab/noise_ba: AWGN noise voltage on the A->B / B->A links.
      fec: optional ``fec_chain.FecParams``: runs the session on the LDPC
        transport-block path (long headers); the MCS echo then also carries
        the requested FEC scheme in the ``fec_feedback`` field.
    Returns ``(run, tables)``; ``run(state, n_rounds=32, *, generator=None,
    draws=None) -> (state, telemetry dict of [n_rounds] tensors)`` takes
    exactly one of a generator on ``device`` or a structure of per-round
    draws, ``run.draw_shapes``: ``[n_rounds, 2, ...]`` tensors (index 0 the
    A->B send, 1 the B->A send), ``payload`` ([1, max payload bytes]
    uint8), ``pad`` ([1, max_frame_bytes] uint8, uncoded only) and
    ``noise`` ([1, frame_samples] complex unit normal draws).
    """
    device = torch.device(device)
    txp = transmitter.build_tx(cfg, device, fec)
    rxp = receiver.build_rx(cfg, device, fec)
    tables = adaptive.build_mcs_tables(cfg)
    bps_table = cn.active(device).bps
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    cnst_of_mcs = i32(tables["cnst"])
    fec_of_mcs = i32(tables["fec"])
    n_codes = fec.n_codes if fec is not None else 0
    if fec is not None:
        maxb = fec.max_payload_bytes
        # capacity depends on BOTH the code and the constellation
        cap_flat = i32(fec.user_bytes_tab2).reshape(-1)  # [(C+1) * 5]
    else:
        maxb = cfg.max_frame_bytes()
        cap_per_bps = i32([0] + [cfg.frame_bytes(b) - 4 for b in range(1, 5)])
    shapes = {"payload": ((2, 1, maxb), torch.uint8),
              "noise": ((2, 1, cfg.frame_samples), torch.complex64)}
    if fec is None:
        shapes["pad"] = ((2, 1, cfg.max_frame_bytes()), torch.uint8)
    look = adaptive.lookup
    col = torch.arange(maxb, device=device)[None, :]

    def send_one(node: NodeState, noise_v, d: dict, which: int):
        """TX one frame from `node` with its current state."""
        bps = look(bps_table, node.tx_cnst)
        if fec is not None:
            plen = look(cap_flat, node.tx_fec * 5 + bps)
        else:
            plen = look(cap_per_bps, bps)
        # contract: zero beyond payload_len (the framer random-pads the
        # no-FEC tail itself; the FEC transport-block framing expects zeros)
        payload = torch.where(col < plen, d["payload"][which], 0).to(torch.uint8)
        out = transmitter.tx_frames(
            txp, payload, plen[None], node.tx_cnst[None],
            look(cnst_of_mcs, node.fb.last)[None], node.frame_no[None],
            d["pad"][which] if fec is None else None,
            fec_feedback=look(fec_of_mcs, node.fb.last)[None],
            fec_id=node.tx_fec[None] if fec is not None else None)
        return chan.awgn(out.samples, noise_v, noise=d["noise"][which])

    def receive_one(node: NodeState, samples, tdev: dict):
        """RX one frame at `node`; update echo-driven TX state + decision."""
        rx = receiver.rx_frames(rxp, samples, fallback_cnst=node.tx_cnst[None])
        ok = rx.header_ok[0]
        echo = rx.feedback_cnst[0]
        echo_valid = ok & (echo >= 1) & (echo <= 4)
        new_tx_cnst = torch.where(echo_valid, echo, node.tx_cnst)
        # the FEC echo switches the TX code too
        fec_echo = rx.fec_echo[0]
        fec_valid = ok & (fec_echo >= 1) & (fec_echo <= n_codes)
        new_tx_fec = torch.where(fec_valid, fec_echo, node.tx_fec)
        fb, _ = adaptive.feedback_step(node.fb, rx.snr_db[0], tdev)
        # only adapt on frames we actually decoded
        fb = adaptive.FeedbackState(*(torch.where(ok, new, old) for new, old in zip(fb, node.fb)))
        new_node = NodeState(fb=fb, tx_cnst=new_tx_cnst, tx_fec=new_tx_fec,
                             frame_no=(node.frame_no + 1) & 0xFFF)
        return new_node, {"snr_db": rx.snr_db[0], "crc_ok": rx.crc_ok[0]}

    def round_step(state: DuplexState, d: dict, tdev: dict):
        samp_ab = send_one(state.a, noise_ab, d, 0)
        b_new, telem_b = receive_one(state.b, samp_ab, tdev)
        # B replies with its fresh echo
        samp_ba = send_one(b_new, noise_ba, d, 1)
        a_new, telem_a = receive_one(state.a, samp_ba, tdev)
        state = DuplexState(a=a_new, b=b_new)
        telem = {
            "a_tx_cnst": a_new.tx_cnst, "b_tx_cnst": b_new.tx_cnst,
            "a_tx_fec": a_new.tx_fec, "b_tx_fec": b_new.tx_fec,
            "snr_at_b": telem_b["snr_db"], "snr_at_a": telem_a["snr_db"],
            "b_crc_ok": telem_b["crc_ok"], "a_crc_ok": telem_a["crc_ok"],
        }
        return state, telem

    return rounds_runner(round_step, shapes, tables, device), tables
