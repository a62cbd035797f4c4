"""Continuous sharded streaming session: the multi-rank StreamRx (port of
gr_dtl_tpu/parallel/session.py).

The single-device :class:`gr_dtl_tpu_torch.models.session.StreamRx` is an
always-on receiver whose carried state (sample tail, trigger-lock machine,
expected-frame accounting, TB ring) chains across ``process()`` calls.
This is its counterpart over a ``(stream, time)`` grid of ranks
(parallel/mesh.py):

- **stream axis**: ``n_streams`` independent sessions; a rank holds the
  carried state of its S_l = S / n_stream streams as ``[S_l, ...]`` device
  tensors, chained across calls: nothing round-trips through the host
  between blocks.
- **time axis**: each call's block is cut into ``n_time`` contiguous
  sub-blocks.  Sub-block t needs ``tail_len`` samples of left context:
  rank t = 0 takes it from the carried tail, ranks t > 0 receive it from
  their left neighbour along the time ring (overlap-save).  The last
  sub-block's tail becomes the carried tail of every time rank, by a sum
  over the time axis in which only the last rank adds anything.

Sequential control across sub-blocks uses gather-then-replicate: the
Schmidl-Cox fold vote is summed over the time axis; per-slot trigger
candidates (a few int32 per frame) are gathered along time and the lock
scan runs *replicated* on every time rank over the whole block's
candidates, after which each rank demodulates only its own frames.
Lost-frame accounting and TB reassembly run the same way.  On a GPU a
block of a rank costs one launch of the metric kernel (its ``[S_l,
tail_len + B_loc]`` rows), two of the scan kernels (lock scan and
accounting, every stream at once), four of the equalizer kernel (one
receiver call over S_l * F_local frames) and, with multi-frame transport
blocks, two of the TB ring kernels (every stream's ring at once).

Parity with the single-device session is bit-level for all integer
decisions and byte-level for payloads.  Two documented deviations, as in
the reference: float metrics can differ in the last ulp (another summation
order in the summed fold vote), and a *locked* trigger synthesized far
outside a sub-block is clamped to the sub-block instead of extracted
globally (pathological drift only).

The host's per-stream accounting (``n_lost``, ``n_frames``, ``last_*``) is
global on every rank: one gather of the block's packed vector along the
stream axis (the vector is the same on every time rank), then one pinned
readback.  ``process`` returns the rank's part of the frames, leaves
``[S_l, F_local, ...]``: streams ``self.streams`` and slots ``self.frames``
of the global ``[S, F]`` block.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from gr_dtl_tpu_torch.models import fec_chain, receiver, streaming
from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.ops import metrics, sync
from gr_dtl_tpu_torch.parallel import _coll

__all__ = ["ShardedStreamRx", "snapshot_from_reference"]

class ShardedStreamRx:
    """Always-on sharded receiver over a ``(stream, time)`` grid of ranks.

    Every rank constructs it with the same arguments (each with its own
    ``device``) and calls :meth:`process` with the same global chunks.

    Args:
      cfg: RxConfig.
      mesh: parallel.mesh.Mesh (``make_mesh``).
      n_streams: total independent streams (must divide by the stream axis).
      frames_per_block: frames per stream per block (global across the time
        axis; must divide by ``n_time`` with sub-blocks that cover the halo).
      fec: ``fec_chain.FecParams`` for the coded path (W > 1 enables
        streaming TB reassembly, as in StreamRx).
      blocks_per_dispatch: K > 1 chains K blocks a call (the sharded
        megastep): one upload and one packed readback per K blocks, the
        same per-block semantics.
      probe: telemetry (anything with ``.send(bytes)``), on every rank or
        none: one MonitorEqMsg per received frame, published by the ranks
        at time index 0 for their own streams, stream by stream.
      device: this rank's device (the mesh's).
    """

    def __init__(self, cfg, mesh, n_streams: int, frames_per_block: int = 16, fec=None,
                 blocks_per_dispatch: int = 1, probe=None, *, device):
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(device)
        if self.device != mesh.device:
            raise ValueError(f"device {self.device} is not the mesh's ({mesh.device})")
        self.S = int(n_streams)
        self.F = int(frames_per_block)
        self.K = int(blocks_per_dispatch)
        self.n_time = mesh.shape["time"]
        n_stream_ranks = mesh.shape["stream"]
        if self.S % n_stream_ranks:
            raise ValueError(f"n_streams={self.S} must divide by the stream axis "
                             f"({n_stream_ranks} ranks)")
        if self.F % self.n_time:
            raise ValueError(f"frames_per_block={self.F} must divide by the time axis "
                             f"({self.n_time} ranks)")
        self.S_l = self.S // n_stream_ranks
        self.F_local = self.F // self.n_time
        self.P = cfg.frame_samples
        self.block_samples = self.F * self.P  # per stream, global
        self.B_loc = self.F_local * self.P
        self.tail_len = self.P + cfg.fft_len
        if self.B_loc < self.tail_len:
            raise ValueError(
                f"local sub-block ({self.F_local} frames = {self.B_loc} samples) must cover the "
                f"halo ({self.tail_len}); raise frames_per_block or lower the time-axis size")
        self.dispatch_samples = self.K * self.block_samples
        s0, t0 = mesh.index["stream"] * self.S_l, mesh.index["time"] * self.F_local
        self.streams = slice(s0, s0 + self.S_l)  # this rank's streams
        self.frames = slice(t0, t0 + self.F_local)  # and its slots of a block
        self.rxp = receiver.build_rx(cfg, self.device, fec)
        self.fec = fec
        self._use_tb = fec is not None and fec.W > 1
        self.probe = probe
        self.probe_host_ms = 0.0
        if probe is not None:
            if not callable(getattr(probe, "send", None)):
                raise TypeError(f"a probe needs a send(bytes) method, got {type(probe).__name__}")
            from gr_dtl_tpu_torch.testbed import monitor

            self._monitor = monitor
            self._eq_envelope = monitor.MonitorProto(monitor.EQ_MSG)
        # words of a block's packed vector: lost, received, valid[F],
        # header_ok[F], crc_ok[F]; with a probe each frame's constellation
        # and the bits of its float32 SNR and noise variance
        self._acct_words = 2 + (6 if probe is not None else 3) * self.F
        self._reset_state()
        self.n_lost = np.zeros(self.S, np.int64)
        self.n_frames = np.zeros(self.S, np.int64)
        self.last_valid = np.zeros((self.S, self.K * self.F), bool)
        self.last_header_ok = np.zeros((self.S, self.K * self.F), bool)
        self.last_crc_ok = np.zeros((self.S, self.K * self.F), bool)
        self._pinned = None  # ingest buffer on the card, and the event of its last copy
        self._pinned_copied = None

    def _reset_state(self) -> None:
        S_l, dev = self.S_l, self.device
        self._tail = torch.zeros((S_l, self.tail_len), dtype=torch.complex64, device=dev)
        self._lock = streaming.initial_lock_state(dev, (S_l,))
        self._fallback = torch.full((S_l,), int(cn.ConstellationType.BPSK), dtype=torch.int32,
                                    device=dev)
        self._expected_no = torch.full((S_l,), -1, dtype=torch.int32, device=dev)
        self._tb_state = fec_chain.init_tb_state(self.fec, dev, (S_l,)) if self._use_tb else None

    # -- the block step ---------------------------------------------------
    def _block(self, x, tail, lock, fallback, expected_no, tb_state):
        """One block on this rank: x [S_l, B_loc] is its sub-block of its
        streams.  Returns (out [S_l, F_local, ...], valid_l, lock, fallback,
        expected_no, tb_state, tb_out, acct [S_l, words], new tail)."""
        mesh, cfg = self.mesh, self.cfg
        S_l, F, F_l, P, B_loc, tl = self.S_l, self.F, self.F_local, self.P, self.B_loc, self.tail_len
        t = mesh.index["time"]
        n_time, tg = self.n_time, mesh.time_group
        # the ring halo: my sub-block's tail -> my right neighbour's left
        # context; rank 0 takes the carried tail instead
        if n_time == 1:
            left, new_tail = tail, x[:, -tl:]
        else:
            ring = _coll.ring_shift(x[:, -tl:], mesh, 1)
            left = tail if t == 0 else ring
            mine = x[:, -tl:] if t == n_time - 1 else torch.zeros_like(ring)
            new_tail = _coll.all_reduce_sum(mine, tg)
        ext = torch.cat([left, x], dim=1)  # [S_l, tl + B_loc]
        # trigger acquisition: ONE metric launch over the rank's rows
        Pm, M = sync.timing_metric(ext, cfg.fft_len)
        # global fold vote: each rank folds its OWN B_loc metric samples (a
        # disjoint cover of the single-device fold range [0, F*P)); B_loc %
        # P == 0 keeps the phase aligned
        folded = _coll.all_reduce_sum(M[:, :B_loc].reshape(S_l, F_l, P).sum(-2), tg)
        phase = sync.phase_from_folded(folded, P, cfg.cp_len)
        # per-slot candidates in LOCAL coordinates (slot j's search window is
        # the plateau the single-device step sees: the left context covers
        # base - search for every local slot)
        cand_l = sync.frame_triggers(M, phase, P, F_l)
        found_l = M.gather(1, torch.clamp(cand_l.long(), 0, M.shape[-1] - 1)) > 0.5
        # ---- replicated sequential control over the gathered slots ----
        both = _coll.all_gather(torch.stack([cand_l + t * B_loc, found_l.int()], dim=1), tg, dim=2)
        lock, (trig_all, valid_all) = streaming.trigger_lock_scan(lock, both[:, 0], both[:, 1] != 0, P)
        lock = lock._replace(expected=lock.expected - F * P)
        trig_l = trig_all[:, t * F_l:(t + 1) * F_l] - t * B_loc
        valid_l = valid_all[:, t * F_l:(t + 1) * F_l]
        # extraction and CFO: ONE uniformity vote for the rank's batch
        frames = sync.extract_frames_batch(ext, trig_l, P)
        eps = sync.fine_cfo_batch(Pm, trig_l, cfg.cp_len, P)
        frames = sync.cfo_correct(frames.reshape(S_l * F_l, P), eps.reshape(-1), cfg.fft_len)
        # demodulation: one receiver call over the rank's S_l * F_l frames
        fb = fallback[:, None].expand(S_l, F_l).reshape(-1)
        local = lambda a: a.reshape(S_l, F_l, *a.shape[1:])
        tb_out = None
        if self._use_tb:
            out, fec_in = receiver.rx_frames(self.rxp, frames, fallback_cnst=fb, defer_fec=True)
            out = receiver.RxOut(*map(local, out))
            ok_l = out.header_ok & valid_l
            # TB reassembly is a sequential scan in stream order: gather the
            # per-frame decoder inputs along time and run it replicated
            llrs = _coll.all_gather(local(fec_in["llrs"]), tg, dim=1)
            hdr = _coll.all_gather(torch.stack(
                [local(fec_in[k]).int() for k in ("tb_no", "tb_offset")]
                + [out.cnst_id.int(), local(fec_in["tb_payload"]).int(), local(fec_in["fec_id"]).int(),
                   ok_l.int()], dim=1), tg, dim=2)
            tb_state, emitted = fec_chain.tb_reassemble(
                tb_state, llrs, hdr[:, 0], hdr[:, 1], hdr[:, 2], hdr[:, 3], hdr[:, 4], hdr[:, 5] != 0,
                self.fec)
            dec = fec_chain.decode_emitted(self.fec, {k: v.reshape(S_l * F, *v.shape[2:])
                                                      for k, v in emitted.items()})
            tb_out = {"payload": dec.payload, "payload_len": dec.payload_len,
                      "crc_ok": dec.crc_ok, "fec_ok": dec.fec_ok}
            tb_out = {k: v.reshape(S_l, F, *v.shape[1:]) for k, v in tb_out.items()}
            tb_out.update(tb_no=emitted["tb_no"], valid=emitted["valid"])
        else:
            out = receiver.RxOut(*map(local, receiver.rx_frames(self.rxp, frames,
                                                                fallback_cnst=fb)))
            ok_l = out.header_ok & valid_l
        # ---- replicated accounting over the gathered metadata ----
        rows = [out.frame_no.int(), ok_l.int(), out.header_ok.int(), out.crc_ok.int(),
                out.cnst_id.int(), valid_l.int()]
        if self.probe is not None:
            rows += [out.snr_db.float().view(torch.int32), out.noise_var.float().view(torch.int32)]
        meta = _coll.all_gather(torch.stack(rows, dim=1), tg, dim=2)  # [S_l, rows, F]
        new_fallback = meta[:, 4, -1]
        expected_no, _lost, totals = metrics.frame_accounting(expected_no, meta[:, 0], meta[:, 1] != 0)
        parts = [totals, meta[:, 5], meta[:, 2], meta[:, 3]]
        if self.probe is not None:
            parts += [meta[:, 4], meta[:, 6], meta[:, 7]]
        acct = torch.cat(parts, dim=1)  # [S_l, 2 + 3F] (2 + 6F with a probe)
        return out, valid_l, lock, new_fallback, expected_no, tb_state, tb_out, acct, new_tail

    # -- ingest ------------------------------------------------------------
    def _upload(self, chunks) -> torch.Tensor:
        """This rank's [S_l, K, B_loc] part of the global chunks, on the
        device (on the card through a pinned buffer)."""
        if isinstance(chunks, torch.Tensor):
            chunks = chunks.cpu().numpy()
        chunks = np.asarray(chunks)
        if chunks.shape != (self.S, self.dispatch_samples):
            raise ValueError(f"feed [{self.S}, {self.dispatch_samples}] samples per call "
                             f"(K={self.K} blocks), got {chunks.shape}")
        t0 = self.mesh.index["time"] * self.B_loc
        part = chunks.reshape(self.S, self.K, self.block_samples)[self.streams, :, t0:t0 + self.B_loc]
        if self.device.type != "cuda":
            return torch.from_numpy(part.astype(np.complex64))  # a copy
        if self._pinned is None:
            self._pinned = torch.empty(part.shape, dtype=torch.complex64, pin_memory=True)
        elif self._pinned_copied is not None:
            self._pinned_copied.synchronize()  # the buffer's last copy, never the compute
        np.copyto(self._pinned.numpy(), part, casting="same_kind")
        x = self._pinned.to(self.device, non_blocking=True)
        self._pinned_copied = torch.cuda.Event()
        self._pinned_copied.record(torch.cuda.current_stream(self.device))
        return x

    # -- dispatch / readback ------------------------------------------------
    def _dispatch(self, chunks):
        """Enqueue the K block steps and chain the carried state; returns
        the device results and the readback of the global packed vector."""
        x = self._upload(chunks)
        outs, valids, accts, tb_outs = [], [], [], []
        for k in range(self.K):
            (out, valid, self._lock, self._fallback, self._expected_no, self._tb_state, tb_out,
             acct, self._tail) = self._block(x[:, k], self._tail, self._lock, self._fallback,
                                             self._expected_no, self._tb_state)
            outs.append(out)
            valids.append(valid)
            accts.append(acct)
            tb_outs.append(tb_out)
        if self.K == 1:
            out, valid, tb_out = outs[0], valids[0], tb_outs[0]
        else:  # [S_l, K, ...]
            out = receiver.RxOut(*(torch.stack(col, dim=1) for col in zip(*outs)))
            valid = torch.stack(valids, dim=1)
            tb_out = ({k: torch.stack([t[k] for t in tb_outs], dim=1) for k in tb_outs[0]}
                      if self._use_tb else None)
        # every stream's vector: the same on every time rank, so one gather
        # along the stream axis gives the whole [S, K, words]
        acct = _coll.all_gather(torch.stack(accts, dim=1), self.mesh.stream_group, dim=0)
        if acct.device.type != "cuda":
            return out, valid, tb_out, acct, None
        host = torch.empty(acct.shape, dtype=torch.int32, pin_memory=True)
        host.copy_(acct, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return out, valid, tb_out, host, ready

    def process(self, chunks):
        """K = 1: one global block of [S, block_samples] samples -> (this
        rank's RxOut [S_l, F_local, ...], valid [S, F]).  K > 1: [S,
        K * block_samples] samples -> (RxOut [S_l, K, F_local, ...], valid
        [S, K*F]).  W > 1 FEC sessions return a third element, the TBs
        completed within the call: leaves [S_l, F, ...] ([S_l, K, F, ...]),
        the same on every time rank.  ``last_valid`` / ``last_header_ok`` /
        ``last_crc_ok`` are [S, K*F] in frame order, from ONE packed
        readback."""
        out, _valid, tb_out, acct, ready = self._dispatch(chunks)
        if ready is not None:
            ready.synchronize()
        F, K = self.F, self.K
        a = acct.numpy().reshape(self.S, K, self._acct_words)
        self.n_lost += a[:, :, 0].sum(axis=1).astype(np.int64)
        self.n_frames += (a[:, :, 0] + a[:, :, 1]).sum(axis=1).astype(np.int64)
        col = lambda k: np.ascontiguousarray(a[:, :, 2 + k * F: 2 + (k + 1) * F]).reshape(self.S, K * F)
        self.last_valid = col(0).astype(bool)
        self.last_header_ok = col(1).astype(bool)
        self.last_crc_ok = col(2).astype(bool)
        if self.probe is not None and self.mesh.index["time"] == 0:
            self._publish(col)
        if self._use_tb:
            return out, self.last_valid, tb_out
        return out, self.last_valid

    def _publish(self, col) -> None:
        """One MonitorEqMsg per received frame of this rank's streams, built
        on the host from the packed vector's telemetry words."""
        t0 = time.perf_counter()
        ok = self.last_valid & self.last_header_ok
        cnst, snr, noise = col(3), col(4).view(np.float32), col(5).view(np.float32)
        rates = self.lost_frame_rate
        for s in range(self.streams.start, self.streams.stop):
            i = np.nonzero(ok[s])[0]
            view = types.SimpleNamespace(cnst_id=cnst[s, i], snr_db=snr[s, i], noise_var=noise[s, i])
            for msg in self._monitor.eq_messages(view, float(rates[s])):
                self.probe.send(self._eq_envelope.build(msg))
        self.probe_host_ms += (time.perf_counter() - t0) * 1e3

    def flush_tb(self):
        """Decode every stream's in-progress TB (end of stream).  Each rank
        decodes its own streams' rings; the results are gathered along the
        stream axis, so every rank returns every stream's: leaves [S, 1, ...].
        Waits for the device."""
        if not self._use_tb:
            return None
        st = self._tb_state
        has = (st.tb_no >= 0) & st.present.any(dim=-1)
        dec = fec_chain.decode_emitted(self.fec, {
            "llrs": st.llrs, "cnst": st.cnst, "plen": st.plen, "fec_id": st.fec_id,
            "tb_no": st.tb_no, "valid": has})  # one row a stream
        self._tb_state = fec_chain.init_tb_state(self.fec, self.device, (self.S_l,))
        res = {"payload": dec.payload, "payload_len": dec.payload_len, "crc_ok": dec.crc_ok,
               "fec_ok": dec.fec_ok, "tb_no": st.tb_no, "valid": has}
        return {k: _coll.all_gather(v.reshape(self.S_l, 1, *v.shape[1:]), self.mesh.stream_group)
                for k, v in res.items()}

    @property
    def lost_frame_rate(self) -> np.ndarray:
        """Per-stream lost / (lost + received), as StreamRx reports."""
        tot = np.maximum(self.n_frames, 1)
        return np.where(self.n_frames > 0, self.n_lost / tot, 0.0)

    # -- carried state as numpy ---------------------------------------------
    def snapshot(self) -> dict:
        """Every stream's carried state as numpy (waits for the device): the
        ranks' rows gathered along the stream axis.  ``tail`` [S, tail_len],
        ``lock`` (four [S]), ``fallback`` [S], ``expected_no`` [S],
        ``n_lost`` / ``n_frames`` [S] and ``tb`` (the TbRing's six leaves
        with a leading [S], or None)."""
        g = lambda a: _coll.all_gather(a, self.mesh.stream_group).cpu().numpy()
        return {"tail": g(self._tail),
                "lock": (g(self._lock.locked),) + tuple(g(a) for a in self._lock[1:]),
                "fallback": g(self._fallback), "expected_no": g(self._expected_no),
                "n_lost": self.n_lost.copy(), "n_frames": self.n_frames.copy(),
                "tb": None if self._tb_state is None else tuple(g(a) for a in self._tb_state)}

    def restore(self, snap: dict) -> None:
        """Take over the carried state of :meth:`snapshot` or
        :func:`snapshot_from_reference`: each rank its own streams' rows."""
        dev, rows = self.device, self.streams
        mine = lambda a, dt=None: torch.tensor(np.asarray(a, dt)[rows], device=dev)
        self._tail = mine(snap["tail"], np.complex64)
        self._lock = streaming.lock_state_from_reference(
            tuple(np.asarray(a)[rows] for a in snap["lock"]), dev)
        self._fallback = mine(snap["fallback"], np.int32)
        self._expected_no = mine(snap["expected_no"], np.int32)
        self.n_lost = np.asarray(snap["n_lost"], np.int64).copy()
        self.n_frames = np.asarray(snap["n_frames"], np.int64).copy()
        if self._use_tb:
            self._tb_state = fec_chain.TbRing(*(mine(a) for a in snap["tb"]))


def snapshot_from_reference(ref_srx) -> dict:
    """The carried state of a reference ``ShardedStreamRx`` (read attribute
    by attribute in one process; the reference package is not imported) in
    the form :meth:`ShardedStreamRx.restore` takes."""
    copy = np.array  # copies: the reference books its counters in place
    return {"tail": copy(ref_srx._tail),
            "lock": tuple(copy(a) for a in ref_srx._lock),
            "fallback": copy(ref_srx._fallback),
            "expected_no": copy(ref_srx._expected_no),
            "n_lost": copy(ref_srx.n_lost), "n_frames": copy(ref_srx.n_frames),
            "tb": (tuple(copy(a) for a in ref_srx._tb_state)
                   if getattr(ref_srx, "_use_tb", False) else None)}
