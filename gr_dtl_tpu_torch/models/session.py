"""Continuous streaming sessions: block-by-block TX/RX with carried state
(port of gr_dtl_tpu/models/session.py).

:class:`StreamRx` consumes an endless sample stream in fixed-size blocks
(any whole number of frame periods), carrying across blocks, on its
device,

- a held sample *tail* so frames straddling block boundaries complete,
- the trigger lock state machine (models/streaming.trigger_lock_scan),
- the last known constellation as the header-failure fallback,
- a running expected frame number for lost-frame accounting,
- with multi-frame transport blocks, the TB under reassembly.

Between the upload of a block and its packed accounting vector the
uncoded block step never waits for the device: no ``.item()``, no host
``if`` on a device value.  The host learns a block's facts from ONE int32
vector ``[lost, received, valid[F], header_ok[F], crc_ok[F]]``, copied
into pinned memory with an event; :meth:`StreamRx._readback` waits on that
event only.  :class:`StreamRxPipelined` enqueues block k+1 before it waits
for block k's vector; :class:`StreamRxMega` chains K block steps on the
device behind one upload and one readback.

:class:`StreamTx` is the continuous framer/modulator: a host-side PDU
queue feeds the batched modulator, with whole-PDU frame packing and jumbo
split, empty-frame generation when the queue is dry (up to
``max_empty_frames``), optional wall-clock pacing to ``sample_rate``, and
the feedback-driven constellation switch and echo.

:class:`StreamDuplex` wires two ``StreamTx`` and two ``StreamRx`` into an
always-on full-duplex modem with in-band adaptation.

:class:`StreamBurstRx` scans a continuous reverse capture for feedback
bursts, and :class:`StreamSimplex` is the always-on simplex pair: OFDM
frames forward, the MCS decision back as a burst at a jittered position.

Every constructor takes its device explicitly.  The ``probe=`` telemetry
of ``StreamRx`` waits for ``testbed/monitor`` (ROADMAP.md, queue 1, item
T1).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from gr_dtl_tpu_torch.models import adaptive, fec_chain, receiver, streaming, transmitter
from gr_dtl_tpu_torch.ops import burst, metrics, sync
from gr_dtl_tpu_torch.ops import constellation as cn

__all__ = ["BlockMasks", "Prefetched", "StreamRx", "StreamRxPipelined", "StreamRxMega",
           "StreamTx", "StreamBurstRx", "StreamSimplex", "StreamDuplex",
           "snapshot_from_reference"]

_PINNED_RING = 2  # pinned ingest buffers a session keeps


class BlockMasks(np.ndarray):
    """The per-block validity mask, with the block's other per-frame
    masks riding along as attributes (``header_ok``, ``crc_ok``).

    All three come out of ONE packed readback per block; attaching them to
    the returned ``valid`` array keeps them tied to *their* block even when
    readbacks are pipelined or drained: session-level ``last_*`` attributes
    hold only the most recent block's masks.  Behaves like a bool ndarray,
    and the attributes survive numpy operations that derive new arrays.
    """

    header_ok: np.ndarray
    crc_ok: np.ndarray

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.header_ok = getattr(obj, "header_ok", None)
        self.crc_ok = getattr(obj, "crc_ok", None)


class Prefetched(NamedTuple):
    """A block already on its way to the device (:meth:`StreamRx.prefetch`)."""

    samples: torch.Tensor  # [chunk samples] complex64 on the session's device
    ready: "torch.cuda.Event | None"  # the copy's completion; None on the CPU


class _Inflight(NamedTuple):
    """A dispatched block: its device results and its readback in flight."""

    out: receiver.RxOut
    valid: torch.Tensor
    acct: torch.Tensor  # int32 [2 + 3F] or [K, 2 + 3F]: pinned host memory (CPU session: the tensor)
    ready: "torch.cuda.Event | None"  # acct has arrived
    tb_out: dict | None


class StreamRx:
    """Feed me sample chunks; I emit per-frame RxOut batches.

    Args:
      cfg: RxConfig.
      device: where the session's state and work live.
      frames_per_block: frames demodulated per block step; chunks passed to
        :meth:`process` must contain exactly this many frame periods
        (``block_samples``).
      fec: ``fec_chain.FecParams`` for a coded config; with ``fec.W > 1``
        :meth:`process` returns a third element with the decoded TBs.
    """

    def __init__(self, cfg, device, frames_per_block: int = 16, fec=None, probe=None):
        if probe is not None:
            raise NotImplementedError(
                "StreamRx(probe=...) telemetry needs testbed/monitor, which is not ported "
                "yet: ROADMAP.md, queue 1, item T1")
        self.cfg = cfg
        self.device = torch.device(device)
        self.F = frames_per_block
        self.P = cfg.frame_samples
        self.block_samples = self.F * self.P
        # samples one call consumes (K blocks in StreamRxMega)
        self.dispatch_samples = self.block_samples
        # tail: enough history to finish a frame that starts near the end
        # of the previous block, plus the metric's lookahead.  A chunk
        # shorter than this (F = 1) leaves a shorter tail, as in the
        # reference: the whole chunk.
        self.tail_len = self.P + cfg.fft_len
        self.rxp = receiver.build_rx(cfg, self.device, fec)
        self.fec = fec
        self._use_tb = fec is not None and fec.W > 1
        self._tb_state = fec_chain.init_tb_state(fec, self.device) if self._use_tb else None
        self._tail = torch.zeros(self.tail_len, dtype=torch.complex64, device=self.device)
        self._lock = streaming.initial_lock_state(self.device)
        self._fallback = torch.full((self.F,), int(cn.ConstellationType.BPSK),
                                    dtype=torch.int32, device=self.device)
        # 12-bit frame-number gaps, carried across blocks; -1 = no frame seen yet
        self._expected_no = torch.tensor(-1, dtype=torch.int32, device=self.device)
        self.n_lost = 0
        self.n_frames = 0
        # per-frame masks of the most recently read-back block
        self.last_valid = np.zeros(self.F, bool)
        self.last_header_ok = np.zeros(self.F, bool)
        self.last_crc_ok = np.zeros(self.F, bool)
        # ingest on the card: pinned host buffers, each with the event of
        # the last copy out of it, and a side stream for the copies
        self._pinned: list[list] = []
        self._pin_next = 0
        self._copy_stream = None

    # -- the block step -------------------------------------------------
    def _step(self, samples, lock_state, fallback_cnst, expected_no, tb_state=None):
        """samples: [tail + block] complex64; triggers are owned by the
        tail-start coordinate system (frame k starts in the first F
        periods of ``samples``)."""
        cfg, F, P = self.cfg, self.F, self.P
        Pm, M = sync.timing_metric(samples, cfg.fft_len)
        phase = sync.fold_detect(M[: F * P], P, cfg.cp_len)
        cand = sync.frame_triggers(M, phase, P, F)
        # plausibility per candidate: metric level at the trigger
        found = M[torch.clamp(cand.long(), 0, M.shape[-1] - 1)] > 0.5
        lock_state, (trig, valid) = streaming.trigger_lock_scan(lock_state, cand, found, P)
        eps = sync.fine_cfo(Pm, trig, cfg.cp_len, period=P)
        frames = sync.cfo_correct(sync.extract_frames(samples, trig, P), eps, cfg.fft_len)
        tb_out = None
        if self._use_tb:
            fec = self.fec
            out, fec_in = receiver.rx_frames(self.rxp, frames, fallback_cnst=fallback_cnst,
                                             defer_fec=True)
            tb_state, emitted = fec_chain.tb_reassemble(
                tb_state, fec_in["llrs"], fec_in["tb_no"], fec_in["tb_offset"], out.cnst_id,
                fec_in["tb_payload"], fec_in["fec_id"], out.header_ok & valid, fec)
            dec = fec_chain.decode_emitted(fec, emitted)
            tb_out = {"payload": dec.payload, "payload_len": dec.payload_len,
                      "crc_ok": dec.crc_ok, "fec_ok": dec.fec_ok,
                      "tb_no": emitted["tb_no"], "valid": emitted["valid"]}
        else:
            out = receiver.rx_frames(self.rxp, frames, fallback_cnst=fallback_cnst)
        # next fallback: the last frame's accepted constellation
        new_fallback = out.cnst_id[-1:].expand(F)
        # rebase the lock expectation into the next block's coordinates
        lock_state = lock_state._replace(expected=lock_state.expected - F * P)
        # lost-frame accounting across blocks: gaps between RECEIVED frame
        # numbers only; undecoded slots never advance the expectation
        ok = out.header_ok & valid
        expected_no, _lost, totals = metrics.frame_accounting(expected_no, out.frame_no, ok)
        # ONE packed accounting vector per block
        acct_v = torch.cat([totals, valid.int(), out.header_ok.int(), out.crc_ok.int()])
        return out, valid, lock_state, new_fallback, expected_no, acct_v, tb_state, tb_out

    # -- ingest ----------------------------------------------------------
    def _pinned_slot(self) -> list:
        if not self._pinned:
            self._pinned = [[torch.empty(self.dispatch_samples, dtype=torch.complex64,
                                         pin_memory=True), None]
                            for _ in range(_PINNED_RING)]
            self._copy_stream = torch.cuda.Stream(self.device)
        slot = self._pinned[self._pin_next]
        self._pin_next = (self._pin_next + 1) % len(self._pinned)
        return slot

    def _check_len(self, n: int) -> None:
        if n != self.dispatch_samples:
            raise ValueError(f"feed exactly {self.dispatch_samples} samples per call, got {n}")

    def prefetch(self, chunk: np.ndarray) -> Prefetched:
        """Start the host->device transfer of a FUTURE block now.

        Double-buffered ingest: call right after dispatching block k with
        block k+1's samples, then pass the returned handle to the next
        :meth:`process` call in place of the numpy chunk.  On the card the
        chunk goes into a pinned host buffer and from there to the device
        on a side stream, so the transfer overlaps block k's compute; the
        handle carries the event that the compute stream waits on.  A
        pinned buffer is refilled only after its last copy has completed.
        """
        chunk = np.asarray(chunk)
        self._check_len(chunk.shape[-1])
        if self.device.type != "cuda":
            return Prefetched(torch.from_numpy(chunk.astype(np.complex64)), None)  # a copy
        slot = self._pinned_slot()
        buf, last_copy = slot
        if last_copy is not None and not last_copy.query():
            last_copy.synchronize()  # waits for that copy alone, never for the compute stream
        np.copyto(buf.numpy(), chunk, casting="same_kind")
        with torch.cuda.stream(self._copy_stream):
            dev = buf.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        slot[1] = done
        return Prefetched(dev, done)

    def _ingest(self, chunk) -> torch.Tensor:
        """The chunk on the device: numpy samples, a :meth:`prefetch`
        handle, or a complex64 tensor."""
        if isinstance(chunk, torch.Tensor):
            self._check_len(chunk.shape[-1])
            return chunk.to(self.device, torch.complex64)
        if not isinstance(chunk, Prefetched):
            chunk = self.prefetch(chunk)
        self._check_len(chunk.samples.shape[-1])
        if chunk.ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(chunk.ready)
            chunk.samples.record_stream(cur)  # allocated on the copy stream
        return chunk.samples

    # -- dispatch / readback ---------------------------------------------
    def _dispatch(self, chunk) -> _Inflight:
        """Enqueue the block step and update the carried state; returns
        the device-resident results with their readback in flight."""
        x = self._ingest(chunk)
        (out, valid, self._lock, self._fallback, self._expected_no, acct,
         self._tb_state, tb_out) = self._step(
            torch.cat([self._tail, x]), self._lock, self._fallback, self._expected_no,
            self._tb_state)
        self._tail = x[-self.tail_len:]
        return self._start_readback(out, valid, acct, tb_out)

    def _start_readback(self, out, valid, acct, tb_out) -> _Inflight:
        if acct.device.type != "cuda":
            return _Inflight(out, valid, acct, None, tb_out)
        host = torch.empty(acct.shape, dtype=torch.int32, pin_memory=True)
        host.copy_(acct, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return _Inflight(out, valid, host, ready, tb_out)

    def process(self, chunk):
        """One block of ``block_samples`` samples -> (RxOut, valid [F]);
        multi-frame-TB FEC sessions return a third element: a dict of
        [F]-leading tensors for TBs completed within this block (``valid``
        marks real emissions).  The RxOut stays on the device."""
        return self._readback(*self._dispatch(chunk))

    def _readback(self, out, valid, acct, ready, tb_out):
        """Wait for ONE block's packed vector (its event, nothing else)
        and book it: counters, the block's masks."""
        if ready is not None:
            ready.synchronize()
        F = self.F
        a = acct.numpy().reshape(-1, 2 + 3 * F)  # one row a block
        self.n_lost += int(a[:, 0].sum())
        self.n_frames += int(a[:, 0].sum() + a[:, 1].sum())
        valid = a[:, 2: 2 + F].astype(bool).reshape(-1).view(BlockMasks)
        valid.header_ok = a[:, 2 + F: 2 + 2 * F].astype(bool).reshape(-1)
        valid.crc_ok = a[:, 2 + 2 * F: 2 + 3 * F].astype(bool).reshape(-1)
        self.last_valid = valid
        self.last_header_ok = valid.header_ok
        self.last_crc_ok = valid.crc_ok
        if self._use_tb:
            return out, valid, tb_out
        return out, valid

    def flush_tb(self):
        """Emit the in-progress transport block (end of stream).  Waits
        for the device."""
        if not self._use_tb:
            return None
        st = self._tb_state
        has = bool(st.tb_no >= 0) and bool(st.present.any())
        emitted = {"llrs": st.llrs[None], "cnst": st.cnst[None], "plen": st.plen[None],
                   "fec_id": st.fec_id[None], "tb_no": st.tb_no[None],
                   "valid": torch.tensor([has], device=self.device)}
        dec = fec_chain.decode_emitted(self.fec, emitted)
        self._tb_state = fec_chain.init_tb_state(self.fec, self.device)
        return {"payload": dec.payload, "payload_len": dec.payload_len,
                "crc_ok": dec.crc_ok, "fec_ok": dec.fec_ok,
                "tb_no": emitted["tb_no"], "valid": emitted["valid"]}

    @property
    def lost_frame_rate(self) -> float:
        """lost / (lost + received)."""
        return self.n_lost / self.n_frames if self.n_frames else 0.0

    # -- carried state as numpy -------------------------------------------
    def snapshot(self) -> dict:
        """The carried state as numpy (waits for the device): ``tail``,
        ``lock`` (4-tuple), ``fallback``, ``expected_no``, ``n_lost``,
        ``n_frames`` and ``tb`` (the TbRing's six leaves, or None)."""
        return {"tail": self._tail.cpu().numpy(),
                "lock": streaming.lock_state_to_numpy(self._lock),
                "fallback": self._fallback.cpu().numpy().copy(),
                "expected_no": np.int32(int(self._expected_no)),
                "n_lost": self.n_lost, "n_frames": self.n_frames,
                "tb": (None if self._tb_state is None
                       else tuple(a.cpu().numpy() for a in self._tb_state))}

    def restore(self, snap: dict) -> None:
        """Take over the carried state of :meth:`snapshot` or
        :func:`snapshot_from_reference`."""
        dev = self.device
        self._tail = torch.tensor(np.asarray(snap["tail"], np.complex64), device=dev)
        self._lock = streaming.lock_state_from_reference(snap["lock"], dev)
        self._fallback = torch.tensor(np.asarray(snap["fallback"], np.int32), device=dev)
        self._expected_no = torch.tensor(int(snap["expected_no"]), dtype=torch.int32, device=dev)
        self.n_lost, self.n_frames = int(snap["n_lost"]), int(snap["n_frames"])
        if self._use_tb:
            self._tb_state = fec_chain.TbRing(
                *(torch.tensor(np.asarray(a), device=dev) for a in snap["tb"]))


def snapshot_from_reference(ref_rx) -> dict:
    """The carried state of a reference ``StreamRx`` (read attribute by
    attribute; the reference package is not imported) in the form
    :meth:`StreamRx.restore` takes."""
    tail = ref_rx._tail
    return {"tail": (np.zeros(ref_rx.tail_len, np.complex64) if tail is None
                     else np.asarray(tail)),
            "lock": tuple(np.asarray(a) for a in ref_rx._lock),
            "fallback": np.asarray(ref_rx._fallback),
            "expected_no": np.asarray(ref_rx._expected_no),
            "n_lost": ref_rx.n_lost, "n_frames": ref_rx.n_frames,
            "tb": (tuple(np.asarray(a) for a in ref_rx._tb_state)
                   if getattr(ref_rx, "_use_tb", False) else None)}


class StreamRxPipelined(StreamRx):
    """StreamRx with deferred readback: results arrive one (or more)
    blocks late, so the host enqueues block k+1 before it waits for block
    k's packed vector, and the device works on k while the host, which is
    what a block's time is mostly made of, prepares k+1.

    The carried state (tail, trigger lock, fallback constellation,
    frame-number accounting, TB ring) chains block-to-block on the device
    exactly as in :class:`StreamRx`, so the demodulated output is
    bit-identical, shifted by ``depth-1`` blocks.

    ``process`` returns ``None`` for the first ``depth-1`` calls, then
    block ``k-depth+1``'s results; call :meth:`drain` at end of stream.

    Args:
      depth: most dispatched-but-unread blocks (2 = double buffering;
        1 = StreamRx semantics).
    """

    def __init__(self, cfg, device, frames_per_block: int = 16, fec=None, probe=None,
                 depth: int = 2):
        super().__init__(cfg, device, frames_per_block, fec, probe=probe)
        self.depth = max(1, int(depth))
        self._inflight: list[_Inflight] = []

    def process(self, chunk):
        self._inflight.append(self._dispatch(chunk))
        if len(self._inflight) >= self.depth:
            return self._readback(*self._inflight.pop(0))
        return None

    def drain(self):
        """Read back every block still in flight (end of stream)."""
        res = []
        while self._inflight:
            res.append(self._readback(*self._inflight.pop(0)))
        return res


class StreamRxMega(StreamRx):
    """StreamRx with K blocks per call: one upload, K block steps chained
    on the device (tail, trigger lock, fallback, frame accounting, TB
    ring), one ``[K, 2+3F]`` readback.

    The SMALL block's semantics stay: fold vote, trigger-lock update,
    fallback constellation and loss accounting advance every F frames
    exactly as in StreamRx, so adaptation granularity is unchanged; only
    the host's upload/readback granularity (and so its buffering latency)
    grows to K*F frames.  Without a compiler the K steps are a Python loop:
    the launches stay, the K-1 host waits go.  (The loop holds no host
    synchronisation, which is what capturing it in a CUDA graph needs.)

    :meth:`process` consumes ``K * block_samples`` samples and returns
    (RxOut [K*F, ...], valid [K*F]) (+ tb dict for W>1 FEC, leaves
    [K*F, ...]); ``last_valid``/``last_header_ok``/``last_crc_ok`` are
    [K*F].  Results are bit-identical to K successive StreamRx calls.
    """

    def __init__(self, cfg, device, frames_per_block: int = 16, blocks_per_dispatch: int = 8,
                 fec=None, probe=None):
        super().__init__(cfg, device, frames_per_block, fec, probe=probe)
        self.K = int(blocks_per_dispatch)
        self.dispatch_samples = self.K * self.block_samples

    def _dispatch(self, chunk) -> _Inflight:
        x = self._ingest(chunk)
        B, tl = self.block_samples, self.tail_len
        samples = torch.cat([self._tail, x])  # [tl + K*B]
        outs, valids, accts, tb_outs = [], [], [], []
        for k in range(self.K):
            # One metric launch a block, on the contiguous view of its
            # tail + block, not one launch over the dispatch: the kernel's
            # two-level sums group by tile origin, so one long launch would
            # equal the per-block launches bit for bit only when F*P is a
            # multiple of 32.  The view starts k*B samples in: 8-byte
            # aligned always, 16 when k*B is even (the kernel picks its
            # access width per row from the pointer); its outputs are fresh
            # buffers, so its tiles lie as in StreamRx's launch.
            ext = samples[k * B: k * B + tl + B]
            (out, valid, self._lock, self._fallback, self._expected_no, acct,
             self._tb_state, tb_out) = self._step(
                ext, self._lock, self._fallback, self._expected_no, self._tb_state)
            outs.append(out)
            valids.append(valid)
            accts.append(acct)
            tb_outs.append(tb_out)
        self._tail = x[-tl:]
        # [K][F, ...] -> [K*F, ...]: consumers see one frame batch
        out = receiver.RxOut(*(torch.cat(col) for col in zip(*outs)))
        tb_out = ({k: torch.cat([t[k] for t in tb_outs]) for k in tb_outs[0]}
                  if self._use_tb else None)
        return self._start_readback(out, torch.cat(valids), torch.stack(accts), tb_out)


class StreamTx:
    """Continuous framer/modulator: feed me PDUs, I emit sample blocks.

    Whole-PDU packing, empty-frame generation when idle, pacing, and the
    constellation switch driven by decoded peer feedback.

    Args:
      cfg: TxConfig (``max_empty_frames``/``sample_rate`` honored).
      device: where the modulator runs.
      frames_per_block: frames modulated per step.
      pace: when True, :meth:`next_block` sleeps until the block's
        wall-clock deadline at ``cfg.sample_rate``.
      seed: of the generator that draws the uncoded frames' pad bytes.
    """

    def __init__(self, cfg, device, frames_per_block: int = 16, fec=None,
                 pace: bool = False, seed: int = 0):
        self.cfg = cfg
        self.device = torch.device(device)
        self.F = frames_per_block
        self.fec = fec
        self.txp = transmitter.build_tx(cfg, self.device, fec)
        self.block_samples = self.F * cfg.frame_samples
        self.pace = pace
        self._queue: list[bytes] = []
        self._jumbo_rest = b""  # tail of a split jumbo PDU
        self._frame_no = 0
        self._cnst = int(cn.ConstellationType.BPSK)
        self._echo = 0
        self._empty_run = 0  # consecutive all-empty blocks emitted
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._deadline = None  # pacing clock
        self._maxb = fec.max_payload_bytes if fec is not None else cfg.max_frame_bytes()

    # -- control plane ----------------------------------------------------
    def send(self, pdu: bytes):
        """Queue one PDU (network packet) for transmission."""
        self._queue.append(bytes(pdu))

    def set_feedback(self, cnst_id: int):
        """Peer-requested constellation switch: the decoded
        ``feedback_constellation`` echo from the peer's headers."""
        if 1 <= int(cnst_id) <= 4:
            self._cnst = int(cnst_id)

    def set_feedback_echo(self, cnst_id: int):
        """Local RX decision to echo in outgoing headers."""
        self._echo = int(cnst_id)

    @property
    def constellation(self) -> int:
        return self._cnst

    # -- data plane -------------------------------------------------------
    def _capacity(self) -> int:
        bps = int(cn.BITS_PER_SYMBOL[self._cnst])
        if self.fec is not None:
            # FEC transport block: code-1 user bytes for this bps
            return int(self.fec.user_bytes_tab[bps])
        return self.cfg.frame_bytes(bps) - 4  # minus CRC32

    def _draw_pad(self):
        """One block's random pad bytes [F, max_frame_bytes] uint8 on the
        device (None with FEC: the transport block fills the frame)."""
        if self.fec is not None:
            return None
        return torch.randint(0, 256, (self.F, self.cfg.max_frame_bytes()), generator=self._gen,
                             device=self.device, dtype=torch.uint8)

    def next_block(self):
        """Modulate one block -> (samples [block_samples] np.complex64,
        info dict) or ``None`` once the empty-frame budget is spent.

        Frames hold whole queued PDUs (jumbo PDUs split); slots with no
        data become empty frames (payload_len 0) so the stream, and the
        in-band adaptation loop, stays alive, up to
        ``cfg.max_empty_frames`` consecutive empty frames (-1 = forever;
        rounded up to whole blocks since blocks are the emission unit).
        """
        cap = self._capacity()
        F = self.F
        frames, self._jumbo_rest = streaming.pack_pdus_budget(
            self._queue, self._jumbo_rest, cap, F)
        n_data = len(frames)
        if n_data == 0:
            maxe = getattr(self.cfg, "max_empty_frames", -1)
            if maxe >= 0 and self._empty_run >= maxe:
                return None
            self._empty_run += F
        else:
            self._empty_run = 0
        full_payload = np.zeros((F, self._maxb), np.uint8)
        full_plen = np.zeros(F, np.int32)
        for i, f in enumerate(frames):
            full_payload[i, : len(f)] = np.frombuffer(f, np.uint8)
            full_plen[i] = len(f)
        frame_nos = (self._frame_no + np.arange(F)) & 0xFFF
        self._frame_no = int((self._frame_no + F) & 0xFFF)
        dev = self.device
        i32 = lambda v: torch.full((F,), int(v), dtype=torch.int32, device=dev)
        out = transmitter.tx_frames(
            self.txp, torch.as_tensor(full_payload, device=dev),
            torch.as_tensor(full_plen, device=dev), i32(self._cnst), i32(self._echo),
            torch.as_tensor(frame_nos.astype(np.int32), device=dev), self._draw_pad())
        if self.pace:
            rate = getattr(self.cfg, "sample_rate", 0) or 0
            if rate > 0:
                now = time.monotonic()
                if self._deadline is None:
                    self._deadline = now
                self._deadline += self.block_samples / rate
                if self._deadline > now:
                    time.sleep(self._deadline - now)
        info = {
            "frame_no": frame_nos,
            "payload_len": full_plen,
            "cnst_id": np.full(F, self._cnst, np.int32),
            "frame_bytes": out.frame_bytes.cpu().numpy(),
            "l_total": out.l_total.cpu().numpy(),
        }
        return out.samples.reshape(-1).cpu().numpy(), info


class StreamBurstRx:
    """Continuous reverse-channel scanner: feed me sample chunks of the
    reverse capture, I emit every feedback burst found (0..max_bursts
    per block), each exactly once.

    The always-on feedback listener; see ops/burst.build_stream_burst_rx
    for the scan design.  The held tail and the results stay on the
    device.
    """

    def __init__(self, block_samples: int, device, modem=None, max_bursts: int = 4,
                 threshold: float = 0.5):
        self.device = torch.device(device)
        self.modem = modem if modem is not None else burst.build_burst_modem(self.device)
        self._step, self.tail_len = burst.build_stream_burst_rx(
            self.modem, block_samples, max_bursts, threshold)
        self.block_samples = block_samples
        self._tail = torch.zeros(self.tail_len, dtype=torch.complex64, device=self.device)

    def process(self, chunk) -> burst.BurstRxOut:
        """One block of ``block_samples`` samples (numpy, or a tensor) ->
        BurstRxOut with [max_bursts] leading dims, on the device."""
        if chunk.shape[-1] != self.block_samples:
            raise ValueError(f"feed exactly {self.block_samples} samples per call, "
                             f"got {chunk.shape[-1]}")
        x = torch.as_tensor(chunk).to(self.device, torch.complex64)
        out = self._step(torch.cat([self._tail, x]))
        self._tail = x[-self.tail_len:]
        return out


class StreamSimplex:
    """Always-on simplex modem pair over user-supplied channels.

    The streaming counterpart of models/simplex.py's session: node A
    streams OFDM frames forward and scans a continuous reverse capture for
    feedback bursts; node B demodulates frames, runs the MCS decision on
    its SNR estimates and transmits the decision as a burst at a random
    (jittered) position inside its reverse block.  Burst loss, jitter, and
    noise are whatever ``channel_rev`` injects: the adaptation loop must
    survive them (TX simply keeps its MCS until a burst decodes).

    Args:
      channel_fwd/channel_rev: callables, numpy samples -> samples as
        numpy or as a tensor on ``device``.
      device: where both nodes' work runs.
      rev_block: reverse-capture samples per step (one scan block).
      seed: of the numpy generator that draws the burst's position.
    """

    def __init__(self, txcfg, rxcfg, channel_fwd, channel_rev, device,
                 frames_per_block: int = 8, rev_block: int = 4096, seed: int = 0):
        self.device = torch.device(device)
        self.tx = StreamTx(txcfg, device, frames_per_block)
        self.rx = StreamRx(rxcfg, device, frames_per_block)
        self.brx = StreamBurstRx(rev_block, device)
        self.modem = self.brx.modem
        self.chan_fwd = channel_fwd
        self.chan_rev = channel_rev
        self.rev_block = rev_block
        self._rng = np.random.RandomState(seed)
        self.tables = adaptive.build_mcs_tables(rxcfg)
        self._tables_dev = adaptive.tables_to(self.tables, self.device)
        self._fb = adaptive.initial_state(rxcfg.initial_mcs_id, (), self.device)

    def step(self):
        """One forward block + one reverse block; returns telemetry or
        None when the TX queue and empty budget are exhausted."""
        blk = self.tx.next_block()
        if blk is None:
            return None
        samples, _info = blk
        out, valid = self.rx.process(self.chan_fwd(samples))
        ok = np.asarray(valid.header_ok & valid)

        # RX node: decision on decoded frames -> feedback burst
        rev = np.zeros(self.rev_block, np.complex64)
        want = None
        if ok.any():
            self._fb, mcs_seq = adaptive.feedback_scan_masked(
                self._fb, out.snr_db, torch.as_tensor(ok, device=self.device), self._tables_dev)
            mcs = int(mcs_seq.cpu().numpy()[np.nonzero(ok)[0][-1]])
            want = (int(self.tables["cnst"][mcs]), int(self.tables["fec"][mcs]))
            i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=self.device)
            wave = burst.burst_tx(i32(want[0]), i32(want[1]), self.modem, pad=0)[0].cpu().numpy()
            off = self._rng.randint(0, self.rev_block - len(wave))
            rev[off: off + len(wave)] = wave

        # TX node: scan the (lossy) reverse capture, apply the last
        # decodable burst
        bout = self.brx.process(self.chan_rev(rev))
        okb = bout.ok.cpu().numpy()
        applied = None
        if okb.any():
            i = int(np.nonzero(okb)[0][-1])
            applied = int(bout.cnst_id.cpu().numpy()[i])
            self.tx.set_feedback(applied)
        return {"rx": out, "ok": ok, "want": want, "applied": applied,
                "n_bursts": int(okb.sum())}


class StreamDuplex:
    """Always-on full-duplex modem node pair over user-supplied channels.

    Two ``StreamTx``/``StreamRx`` pairs, adaptation in-band via the header
    echo.  The caller supplies the two channel functions (numpy samples ->
    samples as numpy or as a tensor on ``device``), so fading or recorded
    impairments can be injected per direction.

    Each :meth:`step` moves one block in both directions and applies:
      peer echo (header ``feedback_constellation``) -> local TX MCS,
      local RX SNR -> feedback decision -> local echo.
    """

    def __init__(self, cfg_tx_a, cfg_rx_a, cfg_tx_b, cfg_rx_b, channel_ab, channel_ba,
                 device, frames_per_block: int = 8, probe_a=None, probe_b=None,
                 serialize_readback: bool = False):
        self.F = frames_per_block
        self.device = torch.device(device)
        # False (default): both directions' device work is enqueued before
        # either readback, so one direction's wait overlaps the other's
        # compute.  True: readback right after each dispatch, the fully
        # serialized ordering, kept for A/B step-time measurement.  Outputs
        # are bit-identical either way: control (feedback echo, MCS switch)
        # is applied after both halves in both orderings, so it affects the
        # next block only.
        self.serialize_readback = serialize_readback
        self.tx_a = StreamTx(cfg_tx_a, device, frames_per_block)
        self.tx_b = StreamTx(cfg_tx_b, device, frames_per_block)
        self.rx_a = StreamRx(cfg_rx_a, device, frames_per_block, probe=probe_a)
        self.rx_b = StreamRx(cfg_rx_b, device, frames_per_block, probe=probe_b)
        self.chan_ab = channel_ab
        self.chan_ba = channel_ba
        # per-node tables: each node decides with ITS OWN ladder
        self.tables_a = adaptive.build_mcs_tables(cfg_rx_a)
        self.tables_b = adaptive.build_mcs_tables(cfg_rx_b)
        self._tables_dev_a = adaptive.tables_to(self.tables_a, self.device)
        self._tables_dev_b = adaptive.tables_to(self.tables_b, self.device)
        self._fb_a = adaptive.initial_state(cfg_rx_a.initial_mcs_id, (), self.device)
        self._fb_b = adaptive.initial_state(cfg_rx_b.initial_mcs_id, (), self.device)

    def _dispatch_half(self, tx: StreamTx, chan, rx: StreamRx):
        """TX one block through the channel and enqueue the RX step; no
        readback of RX results happens here."""
        blk = tx.next_block()
        if blk is None:
            return None
        samples, _info = blk
        return rx._dispatch(chan(samples))

    def _finish_half(self, disp, rx: StreamRx, fb_state, tables):
        """Read back one direction's results and compute (not apply) its
        adaptation decisions."""
        if disp is None:
            return None, fb_state, None
        out, valid = rx._readback(*disp)[:2]
        ok = np.asarray(valid.header_ok & valid)
        # adaptation: decisions only on decoded frames
        echo_mcs = None
        if ok.any():
            fb_state, mcs_seq = adaptive.feedback_scan_masked(
                fb_state, out.snr_db, torch.as_tensor(ok, device=self.device), tables)
            echo_mcs = int(mcs_seq.cpu().numpy()[np.nonzero(ok)[0][-1]])
        # the last valid decoded echo steers this node's peer
        echoes = out.feedback_cnst.cpu().numpy()[ok]
        peer_req = int(echoes[-1]) if echoes.size else None
        return out, fb_state, {"echo_mcs": echo_mcs, "peer_req": peer_req,
                               "n_ok": int(ok.sum())}

    def step(self):
        """One block each way; returns per-direction RxOut + telemetry
        (None once both TX queues and empty budgets are exhausted)."""
        if self.serialize_readback:
            d_b = self._dispatch_half(self.tx_a, self.chan_ab, self.rx_b)
            out_b, self._fb_b, ctl_b = self._finish_half(
                d_b, self.rx_b, self._fb_b, self._tables_dev_b)
            d_a = self._dispatch_half(self.tx_b, self.chan_ba, self.rx_a)
            out_a, self._fb_a, ctl_a = self._finish_half(
                d_a, self.rx_a, self._fb_a, self._tables_dev_a)
        else:
            d_b = self._dispatch_half(self.tx_a, self.chan_ab, self.rx_b)
            d_a = self._dispatch_half(self.tx_b, self.chan_ba, self.rx_a)
            out_b, self._fb_b, ctl_b = self._finish_half(
                d_b, self.rx_b, self._fb_b, self._tables_dev_b)
            out_a, self._fb_a, ctl_a = self._finish_half(
                d_a, self.rx_a, self._fb_a, self._tables_dev_a)
        if out_a is None and out_b is None:
            return None
        # B's decision about the A->B link is echoed in B's headers and,
        # decoded at A, switches A's TX constellation (and vice versa)
        if ctl_b and ctl_b["echo_mcs"] is not None:
            self.tx_b.set_feedback_echo(int(self.tables_b["cnst"][ctl_b["echo_mcs"]]))
        if ctl_a and ctl_a["echo_mcs"] is not None:
            self.tx_a.set_feedback_echo(int(self.tables_a["cnst"][ctl_a["echo_mcs"]]))
        if ctl_a and ctl_a["peer_req"]:
            self.tx_a.set_feedback(ctl_a["peer_req"])
        if ctl_b and ctl_b["peer_req"]:
            self.tx_b.set_feedback(ctl_b["peer_req"])
        return {"a": out_a, "b": out_b, "ctl_a": ctl_a, "ctl_b": ctl_b}
