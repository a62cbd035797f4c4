"""CLI modem runner, the app layer (port of tools/run_modem.py).

Modes:
  loopback     TX -> AWGN(+CFO) channel -> RX over a frame batch,
               optional LDPC FEC
  full-duplex  two nodes, in-band MCS adaptation session
  simplex      OFDM forward + feedback-burst reverse session
  stream       always-on RX daemon over a c64 sample source
               (file/FIFO/TCP), optional pipelined readback + ZMQ
               telemetry + frame store
  stream-tx    always-on TX daemon: PDUs -> StreamTx -> c64 sink;
               pair with `stream` (RX listens, TX connects) for a
               two-process link:
                 python -m gr_dtl_tpu_torch.tools.run_modem stream --source listen:5661 ... &
                 python -m gr_dtl_tpu_torch.tools.run_modem stream-tx --sink tcp:127.0.0.1:5661 ...
  stream-sharded
               always-on SHARDED RX daemon: N streams over a
               (stream, time) grid of ranks, carried state chained on
               the device (parallel/session.ShardedStreamRx); megastep
               via --blocks-per-dispatch; --selftest self-checks

Examples:
  python -m gr_dtl_tpu_torch.tools.run_modem loopback --config examples/config.json --frames 64 --snr-db 25
  python -m gr_dtl_tpu_torch.tools.run_modem loopback --config examples/config_fec.json --snr-db 8 --mcs-id 0
  python -m gr_dtl_tpu_torch.tools.run_modem full-duplex --rounds 48 --snr-db 30 --snr-db-reverse 22
  python -m gr_dtl_tpu_torch.tools.run_modem simplex --rounds 40 --snr-db 22
  ... [--store-tx tx.dat --store-rx rx.dat] [--zmq tcp://*:5550] [--json] [--device cuda | --cpu]

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
(or ``--cpu``) asks for the CPU; without a card a cuda run exits with an
error.  Random draws (pad bytes, noise) come from a ``torch.Generator``
seeded from ``--seed`` on the run's device, so the modes that synthesize
traffic do not reproduce the JAX runner's samples; a mode fed a capture
(``stream``, ``stream-sharded --source``) gives its frame store and counts.
Writes frame stores scoreable by ``tools/ber.py``, and publishes equalizer
telemetry over ZMQ when ``--zmq`` is given (that needs pyzmq).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from gr_dtl_tpu_torch.models import fec_chain, receiver, session, transmitter
from gr_dtl_tpu_torch.ops import channel, constellation as cn, metrics
from gr_dtl_tpu_torch.testbed import sample_io
from gr_dtl_tpu_torch.testbed.frame_store import FrameStore
from gr_dtl_tpu_torch.tools import _cli
from gr_dtl_tpu_torch.utils import alist, config as cfgmod

__all__ = ["main", "sharded_daemon"]


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def _fec_for(cfg, dev, tb_frames: int = 1):
    """The config's code bank on ``dev``, or None for an uncoded config."""
    if not cfg.fec:
        return None
    return fec_chain.build_fec(cfg, [alist.load_alist(p) for _, p in cfg.fec_codes], dev,
                               tb_frames=tb_frames)


def run_loopback(args):
    dev = _cli.device_of(args)
    cfg = cfgmod.make_tx_config(args.config, frame_length=args.frame_length)
    rxcfg = cfgmod.make_rx_config(args.config, frame_length=args.frame_length)
    fec = _fec_for(cfg, dev)
    txp = transmitter.build_tx(cfg, dev, fec)
    rxp = receiver.build_rx(rxcfg, dev, fec)

    B = args.frames
    rng = np.random.RandomState(args.seed)
    if args.mcs_id is not None and not (0 <= args.mcs_id < len(cfg.mcs)):
        sys.exit(f"error: --mcs-id must be 0..{len(cfg.mcs) - 1} for this config")
    cnst_id = int(cfg.mcs[args.mcs_id][1][0]) if args.mcs_id is not None else 2
    cnst = np.full(B, cnst_id, np.int32)
    fec_ids = None
    if fec is not None:
        # the MCS entry names its code too: transmit with THAT code
        code_ids = {name: i + 1 for i, (name, _) in enumerate(cfg.fec_codes)}
        fec_name = (cfg.mcs[args.mcs_id][1][1] if args.mcs_id is not None
                    else cfg.fec_codes[0][0])
        fid = code_ids.get(fec_name, 1)
        fec_ids = np.full(B, fid, np.int32)
        maxb = fec.max_payload_bytes
        plen = np.full(B, int(fec.user_bytes_tab2[fid, int(cn.BITS_PER_SYMBOL[cnst_id])]), np.int32)
    else:
        maxb = cfg.max_frame_bytes()
        plen = np.full(B, cfg.frame_bytes(int(cn.BITS_PER_SYMBOL[cnst_id])) - 4, np.int32)
    payload = np.zeros((B, maxb), np.uint8)
    for i in range(B):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    pad = (None if fec is not None else
           torch.randint(0, 256, (B, cfg.max_frame_bytes()), generator=gen, device=dev,
                         dtype=torch.uint8))
    out = transmitter.tx_frames(
        txp, t(payload), t(plen), t(cnst), torch.zeros(B, dtype=torch.int32, device=dev),
        torch.arange(B, dtype=torch.int32, device=dev) % 4096, pad,
        fec_id=None if fec_ids is None else t(fec_ids))
    sig = torch.mean(torch.abs(out.samples) ** 2)
    noise_v = float(torch.sqrt(sig / 10 ** (args.snr_db / 10)))
    zeros = lambda n: torch.zeros(n, dtype=torch.complex64, device=dev)
    stream = torch.cat([zeros(517), out.samples.reshape(-1), zeros(400)])
    stream = channel.channel_model(stream, noise_voltage=noise_v, freq_offset=args.cfo,
                                   fft_len=cfg.fft_len, generator=gen)
    frames, _ = receiver.detect_and_extract(stream, rxcfg, B)
    rx = receiver.rx_frames(rxp, frames)

    res = _summarize(rx, B)
    res["mode"] = "loopback"
    res["snr_cfg_db"] = args.snr_db
    res["cfo"] = args.cfo
    _stores_and_telemetry(args, (payload, plen), rx)
    _cli.report(args.json, res)


def _noise_voltage(snr_db: float) -> float:
    """Noise voltage of an SNR against unit-ish signal power (~0.81)."""
    return float(np.sqrt(0.81 / 10 ** (snr_db / 10)))


def run_full_duplex(args):
    from gr_dtl_tpu_torch.models import full_duplex

    dev = _cli.device_of(args)
    cfg = cfgmod.make_full_duplex_config(args.config, frame_length=args.frame_length)
    run, tables = full_duplex.build_full_duplex(
        cfg, dev, noise_ab=_noise_voltage(args.snr_db),
        noise_ba=_noise_voltage(args.snr_db_reverse), fec=_fec_for(cfg, dev))
    state = full_duplex.initial_duplex_state(cfg, tables, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state, telem = run(state, args.rounds, generator=gen)
    t = {k: _host(v) for k, v in telem.items()}
    _cli.report(args.json, {
        "mode": "full-duplex",
        "rounds": args.rounds,
        "a_tx_cnst_final": int(t["a_tx_cnst"][-1]),
        "b_tx_cnst_final": int(t["b_tx_cnst"][-1]),
        "a_crc_rate": float(t["a_crc_ok"].mean()),
        "b_crc_rate": float(t["b_crc_ok"].mean()),
        "snr_at_a_db": float(t["snr_at_a"][-8:].mean()),
        "snr_at_b_db": float(t["snr_at_b"][-8:].mean()),
    })


def run_simplex(args):
    from gr_dtl_tpu_torch.models import simplex

    dev = _cli.device_of(args)
    cfg = cfgmod.make_tx_config(args.config, frame_length=args.frame_length)
    run, tables = simplex.build_simplex(cfg, dev, noise_fwd=_noise_voltage(args.snr_db),
                                        noise_rev=_noise_voltage(args.snr_db_reverse))
    state = simplex.initial_simplex_state(cfg, tables, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state, telem = run(state, args.rounds, generator=gen)
    t = {k: _host(v) for k, v in telem.items()}
    _cli.report(args.json, {
        "mode": "simplex",
        "rounds": args.rounds,
        "tx_cnst_final": int(t["tx_cnst"][-1]),
        "crc_rate": float(t["crc_ok"].mean()),
        "burst_ok_rate": float(t["burst_ok"].mean()),
        "snr_db": float(t["snr_db"][-8:].mean()),
    })


def _rss_mb() -> float:
    # the current resident set (not the getrusage high-water mark): a soak
    # must see growth, not just the peak
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE") / 1e6


def run_stream(args):
    """Always-on receiver daemon: complex64 samples in (file / FIFO /
    TCP), decoded frames + telemetry out: the deployment entry point for
    the streaming session (the reference's ``ofdm_adaptive_rx`` flowgraph
    running forever under grc_run).

    ``--source`` spec:
      file:PATH      replay a capture (``--loop N`` to repeat it)
      fifo:PATH      read a named pipe
      tcp:HOST:PORT  connect to a sample server
      listen:PORT    accept one sample peer (e.g. ``stream-tx --sink tcp:``)

    A block's masks and counters reach the host in the session's one
    packed readback a block; the loop below reads nothing else from the
    device but what the frame store and the transport blocks need.
    """
    dev = _cli.device_of(args)
    rxcfg = cfgmod.make_rx_config(args.config, frame_length=args.frame_length)
    fec = _fec_for(rxcfg, dev, args.tb_frames)
    probe = _cli.make_probe(args.zmq) if args.zmq else None
    if args.pipeline_depth > 1:
        rx = session.StreamRxPipelined(rxcfg, dev, frames_per_block=args.frames_per_block,
                                       fec=fec, probe=probe, depth=args.pipeline_depth)
    else:
        rx = session.StreamRx(rxcfg, dev, frames_per_block=args.frames_per_block, fec=fec,
                              probe=probe)
    S = rx.block_samples

    kind, _, rest = args.source.partition(":")
    endpoint = None
    if kind == "file":
        data = np.fromfile(rest, np.complex64)
        if len(data) == 0:
            sys.exit(f"error: empty capture {rest!r}")
        data = np.tile(data, max(1, args.loop))
        data = np.pad(data, (0, (-len(data)) % S))

        def blocks():
            for b in range(len(data) // S):
                yield data[b * S: (b + 1) * S]

        src_close = lambda: None
    elif kind in ("fifo", "tcp", "listen"):
        if kind == "fifo":
            source = sample_io.fifo_source(rest)
        elif kind == "listen":
            server = sample_io.listen(port=int(rest))[0]
            try:
                endpoint = sample_io.accept_endpoint(server)
            finally:
                server.close()
            source = endpoint.source
        else:
            host, _, port = rest.rpartition(":")
            endpoint = sample_io.connect(host or "127.0.0.1", int(port))
            source = endpoint.source

        def blocks():
            while True:
                chunk = source.read(S)
                if len(chunk) == 0:
                    return
                if len(chunk) < S:  # EOF: pad the final partial block
                    yield np.pad(chunk, (0, S - len(chunk)))
                    return
                yield chunk

        src_close = endpoint.close if endpoint is not None else source.close
    else:
        sys.exit(f"error: unknown --source kind {kind!r} "
                 "(use file:, fifo:, tcp:host:port, or listen:port)")

    store = FrameStore(args.store_rx) if args.store_rx else None
    n_blocks = n_hdr = n_crc = 0
    n_tb = n_tb_ok = 0

    def consume_tb(tb):
        # multi-frame transport blocks completed within a block
        # (loss-resilient reassembly; ref tb_decoder.cc:90-138): one copy
        nonlocal n_tb, n_tb_ok
        if tb is None:
            return
        valid = tb["valid"].reshape(-1)
        flags = _host(torch.stack([valid, tb["crc_ok"].reshape(-1) & valid]))
        n_tb += int(flags[0].sum())
        n_tb_ok += int(flags[1].sum())

    def consume(r):
        # count and store per result as it lands: a daemon must not hold
        # every block's device buffers until shutdown.  The masks ride the
        # valid array (BlockMasks), so they stay tied to THIS block even
        # when pipelined readbacks are drained in bulk
        nonlocal n_hdr, n_crc
        out, valid = r[0], r[1]
        n_hdr += int((valid.header_ok & valid).sum())
        n_crc += int((valid.crc_ok & valid).sum())
        if len(r) > 2:
            consume_tb(r[2])
        if store is not None:
            store.store_batch(out, valid=valid)

    t0 = time.monotonic()
    try:
        for chunk in blocks():
            r = rx.process(chunk)
            n_blocks += 1
            if r is not None:
                consume(r)
            if args.stats_every and n_blocks % args.stats_every == 0:
                # long-run soak telemetry: one JSONL line per interval
                print(json.dumps({
                    "stat": "stream",
                    "t_s": round(time.monotonic() - t0, 3),
                    "blocks": n_blocks,
                    "samples": n_blocks * S,
                    "frames_header_ok": n_hdr,
                    "frames_crc_ok": n_crc,
                    "lost_frame_rate": round(rx.lost_frame_rate, 6),
                    "rss_mb": round(_rss_mb(), 1),
                }), flush=True)
            if args.max_blocks and n_blocks >= args.max_blocks:
                break
        if args.pipeline_depth > 1:
            for r in rx.drain():
                consume(r)
        consume_tb(rx.flush_tb())  # end-of-stream TB tail (ref tb flush)
    finally:
        elapsed = time.monotonic() - t0
        src_close()
        if store is not None:
            store.close()
        if probe is not None:
            probe.close()
    res = {
        "mode": "stream",
        "blocks": n_blocks,
        "samples": n_blocks * S,
        "frames_header_ok": n_hdr,
        "frames_crc_ok": n_crc,
        "lost_frame_rate": rx.lost_frame_rate,
        "msamples_per_s": n_blocks * S / elapsed / 1e6,
        "pipeline_depth": args.pipeline_depth,
    }
    if args.tb_frames > 1:
        res["tb_emitted"] = n_tb
        res["tb_crc_ok"] = n_tb_ok
    _cli.report(args.json, res)


def sharded_daemon(mesh, config, frame_length: int, n_streams: int, frames_per_block: int,
                   blocks_per_dispatch: int, src_path: str, zmq: str | None = None):
    """One rank of ``stream-sharded``: a ``ShardedStreamRx`` on ``mesh``
    over the dispatch chunks of ``src_path`` (``[n_streams,
    dispatch_samples]`` complex64 each, stream-major).  Every rank reads
    every chunk and gathers every stream's frames; rank 0 returns the
    counts and each stream's decoded payloads by frame number, the others
    None.  A function of this module, so that a spawned worker imports
    only this package."""
    from gr_dtl_tpu_torch.parallel import _coll
    from gr_dtl_tpu_torch.parallel.session import ShardedStreamRx

    dev = mesh.device
    rxcfg = cfgmod.make_rx_config(config, frame_length=frame_length)
    probe = _cli.make_probe(zmq) if zmq else None
    srx = ShardedStreamRx(rxcfg, mesh, n_streams, frames_per_block, _fec_for(rxcfg, dev),
                          blocks_per_dispatch, probe, device=dev)
    S, D = n_streams, srx.dispatch_samples
    data = np.fromfile(src_path, np.complex64)
    n_chunks = len(data) // (S * D)
    dim = 1 if blocks_per_dispatch == 1 else 2
    decoded = [dict() for _ in range(S)]
    n_hdr = n_crc = 0
    try:
        for c in range(n_chunks):
            out, valid = srx.process(data[c * S * D: (c + 1) * S * D].reshape(S, D))[:2]
            n_hdr += int(srx.last_header_ok.sum())
            ok = valid & srx.last_crc_ok
            n_crc += int(ok.sum())
            g = lambda k: _host(_coll.gather_global(getattr(out, k), mesh, dim))
            pays = g("payload").reshape(S, -1, out.payload.shape[-1])
            lens, nos = g("payload_len").reshape(S, -1), g("frame_no").reshape(S, -1)
            for s in range(S):
                for i in np.nonzero(ok[s])[0]:
                    decoded[s][int(nos[s][i])] = pays[s][i, : lens[s][i]].tobytes()
    finally:
        if probe is not None:
            probe.close()
    if mesh.rank != 0:
        return None
    return {"dispatch_chunks": n_chunks, "frames_header_ok": n_hdr, "frames_crc_ok": n_crc,
            "lost_frames": int(srx.n_lost.sum()), "decoded": decoded}


def _selftest_input(args, dev, S: int, D: int):
    """The self-test's multi-stream capture, made on ``dev``: per stream
    mixed-constellation frames from sample 150 + 89 s on, AWGN at
    ``--snr-db``; returns (path of the [S, D]-chunked file, payloads)."""
    n_chunks = max(2, args.max_blocks or 3)
    B = (n_chunks * args.blocks_per_dispatch - 1) * args.frames_per_block
    rng = np.random.RandomState(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    txcfg = cfgmod.make_tx_config(args.config, frame_length=args.frame_length)
    txp = transmitter.build_tx(txcfg, dev)
    maxb = txcfg.max_frame_bytes()
    chunks = np.zeros((S, n_chunks * D), np.complex64)
    payloads = []
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    for s in range(S):
        cnst = rng.randint(1, 5, B).astype(np.int32)
        pay = np.zeros((B, maxb), np.uint8)
        plen = np.zeros(B, np.int32)
        for i in range(B):
            plen[i] = txcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[cnst[i]])) - 4
            pay[i, : plen[i]] = rng.randint(0, 256, plen[i])
        pad = torch.randint(0, 256, (B, maxb), generator=gen, device=dev, dtype=torch.uint8)
        out = transmitter.tx_frames(txp, torch.as_tensor(pay, device=dev), i32(plen), i32(cnst),
                                    i32(np.zeros(B)), i32(np.arange(B)), pad)
        flat = out.samples.reshape(-1)
        sig = float(torch.mean(torch.abs(flat) ** 2))
        row = torch.zeros(n_chunks * D, dtype=torch.complex64, device=dev)
        off = 150 + 89 * s
        row[off: off + flat.numel()] = flat
        chunks[s] = _host(channel.awgn(row, float(np.sqrt(sig / 10 ** (args.snr_db / 10))),
                                       generator=gen))
        payloads.append((pay, plen))
    fd, path = tempfile.mkstemp(suffix=".c64")
    with os.fdopen(fd, "wb") as f:
        for c in range(n_chunks):  # stream-major per dispatch chunk
            chunks[:, c * D: (c + 1) * D].tofile(f)
    return path, payloads


def run_stream_sharded(args):
    """Always-on SHARDED receiver daemon: N independent streams over a
    (stream, time) grid of ranks with all carried state chained on the
    device (parallel/session.ShardedStreamRx): the multi-card deployment
    entry point.

    Input layout (``--source file:PATH``): successive dispatch chunks,
    each ``streams * dispatch_samples`` complex64 stored stream-major
    ([S, dispatch_samples] row-major per chunk).  ``--selftest`` makes its
    own multi-stream input on the run's device, consumes it, and checks
    that every frame decodes.

    A grid of one rank runs in this process, in a process group of one
    (NCCL on a card, gloo on the CPU).  A larger grid is spawned as that
    many worker processes on this host: gloo on the CPU, NCCL with one rank
    a card, so on cuda it needs as many cards as ranks.
    """
    import torch.distributed as tdist

    from gr_dtl_tpu_torch.parallel import dist as pdist, launch, mesh as meshmod

    dev = _cli.device_of(args)
    rxcfg = cfgmod.make_rx_config(args.config, frame_length=args.frame_length)
    if rxcfg.fec and args.tb_frames > 1:
        sys.exit("error: stream-sharded consumes in-step-decoded frames; W>1 transport "
                 "blocks (--tb-frames) are not wired into this mode's store loop")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    n_stream = args.mesh_stream or max(1, cards // args.mesh_time)
    n_time = args.mesh_time
    if n_stream < 1 or n_time < 1:
        sys.exit("error: --mesh-stream and --mesh-time must be at least 1")
    if dev.type == "cuda" and n_stream * n_time > cards:
        sys.exit(f"error: a {n_stream} x {n_time} grid needs {n_stream * n_time} ranks, and "
                 f"NCCL takes one rank a card: this machine has {cards} CUDA device(s)")
    if args.zmq and n_stream * n_time > 1:
        sys.exit("error: --zmq publishes from one process; run a grid of one rank with it")
    S = args.streams
    D = args.blocks_per_dispatch * args.frames_per_block * rxcfg.frame_samples

    payloads = None
    if args.selftest:
        src_path, payloads = _selftest_input(args, dev, S, D)
    else:
        if not args.source or not args.source.startswith("file:"):
            sys.exit("error: stream-sharded requires --source file:PATH (or --selftest)")
        src_path = args.source[len("file:"):]
        if os.path.getsize(src_path) < S * D * 8:
            sys.exit(f"error: {src_path!r} holds less than one [{S}, {D}] dispatch chunk")
    kw = dict(config=args.config, frame_length=args.frame_length, n_streams=S,
              frames_per_block=args.frames_per_block,
              blocks_per_dispatch=args.blocks_per_dispatch, src_path=src_path, zmq=args.zmq)
    try:
        if n_stream * n_time == 1:
            own = not tdist.is_initialized()
            if own:
                pdist.init_group(0, 1, f"127.0.0.1:{launch.free_port()}", dev)
            try:
                got = sharded_daemon(meshmod.make_mesh(1, 1, device=dev), **kw)
            finally:
                if own:
                    tdist.destroy_process_group()
        else:
            # the worker by its module's name: under ``python -m`` this
            # module is __main__, which a spawned worker cannot import
            worker = importlib.import_module("gr_dtl_tpu_torch.tools.run_modem").sharded_daemon
            got = launch.spawn(worker, n_stream, n_time, device=dev, **kw)[0]
    finally:
        if args.selftest:
            os.unlink(src_path)
    res = {
        "mode": "stream-sharded",
        "streams": S,
        "mesh": {"stream": n_stream, "time": n_time},
        "blocks_per_dispatch": args.blocks_per_dispatch,
        "dispatch_chunks": got["dispatch_chunks"],
        "frames_header_ok": got["frames_header_ok"],
        "frames_crc_ok": got["frames_crc_ok"],
        "lost_frames": got["lost_frames"],
    }
    if args.selftest:
        decoded = got["decoded"]
        res["selftest_pass"] = all(
            decoded[s].get(i) == pay[i, : plen[i]].tobytes()
            for s, (pay, plen) in enumerate(payloads) for i in range(pay.shape[0]))
        if not res["selftest_pass"]:
            _cli.report(args.json, res)
            sys.exit("stream-sharded selftest FAILED")
    _cli.report(args.json, res)


def run_stream_tx(args):
    """Always-on transmitter daemon: PDUs -> StreamTx -> c64 sample sink
    (file/FIFO/TCP): the TX half of a two-process `stream` link (the
    reference's ofdm_adaptive_tx flowgraph under grc_run).

    PDUs are random (--pdus/--pdu-bytes/--seed): the CLI stand-in for a
    network tap; ``tools/tun_bridge.py`` carries real traffic.  ``--pace``
    holds emission to cfg.sample_rate wall-clock.  Without --max-blocks the
    daemon runs until the config's empty-frame budget is spent (forever at
    the default ``max_empty_frames`` = -1).
    """
    dev = _cli.device_of(args)
    txcfg = cfgmod.make_tx_config(args.config, frame_length=args.frame_length)
    tx = session.StreamTx(txcfg, dev, frames_per_block=args.frames_per_block,
                          fec=_fec_for(txcfg, dev, args.tb_frames), pace=args.pace,
                          seed=args.seed)

    kind, _, rest = args.sink.partition(":")
    if kind == "file":
        sink = sample_io.SampleSink(os.open(rest, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644))
        closer = sink.close
    elif kind == "fifo":
        sink = sample_io.fifo_sink(rest)
        closer = sink.close
    elif kind == "tcp":
        host, _, port = rest.rpartition(":")
        endpoint = sample_io.connect(host or "127.0.0.1", int(port))
        sink = endpoint.sink
        closer = endpoint.close
    else:
        sys.exit(f"error: unknown --sink kind {kind!r} (use file:, fifo:, or tcp:host:port)")

    rng = np.random.RandomState(args.seed)
    nbytes = min(args.pdu_bytes, tx._capacity())
    for _ in range(args.pdus):
        tx.send(rng.randint(0, 256, nbytes).astype(np.uint8).tobytes())

    n_blocks = n_frames = 0
    t0 = time.monotonic()
    try:
        while True:
            blk = tx.next_block()
            if blk is None:
                break
            samples, info = blk
            sink.write(samples)
            n_blocks += 1
            n_frames += int((info["payload_len"] > 0).sum())
            if args.max_blocks and n_blocks >= args.max_blocks:
                break
    finally:
        elapsed = time.monotonic() - t0
        closer()
    _cli.report(args.json, {
        "mode": "stream-tx",
        "blocks": n_blocks,
        "samples": n_blocks * tx.block_samples,
        "payload_frames": n_frames,
        "pdus": args.pdus,
        "msamples_per_s": n_blocks * tx.block_samples / elapsed / 1e6,
    })


def _summarize(rx, B: int) -> dict:
    _, _, lost_rate = metrics.lost_frames(rx.frame_no, rx.header_ok)
    return {
        "frames": B,
        "header_ok_rate": float(_host(rx.header_ok).mean()),
        "crc_ok_rate": float(_host(rx.crc_ok).mean()),
        "est_snr_db": float(_host(rx.snr_db).mean()),
        "lost_frame_rate": float(lost_rate),
        "carr_offset": int(_host(rx.carr_offset)[0]),
    }


class _TxView:
    """What a TX frame store records: the user payload (before coding)."""

    def __init__(self, payload: np.ndarray, plen: np.ndarray):
        self.payload, self.payload_len = payload, plen
        self.frame_no = np.arange(len(plen)) % 4096


def _stores_and_telemetry(args, tx_view, rx) -> None:
    if args.store_tx:
        with FrameStore(args.store_tx) as s:
            s.store_batch(_TxView(*tx_view))
    if args.store_rx:
        with FrameStore(args.store_rx) as s:
            s.store_batch(rx)
    if args.zmq:
        from gr_dtl_tpu_torch.testbed import monitor

        probe = _cli.make_probe(args.zmq)
        # one-shot publisher: give late SUB joiners time to (re)connect
        # before the burst (the reference publisher runs forever, so it
        # never needs this)
        time.sleep(0.5)
        builder = monitor.MonitorProto(monitor.EQ_MSG)
        for msg in monitor.eq_messages(rx):
            probe.send(builder.build(msg))
        time.sleep(0.2)  # let the PUB queue drain before close
        probe.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.run_modem",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["loopback", "full-duplex", "simplex", "stream", "stream-tx",
                                    "stream-sharded"])
    p.add_argument("--sink", default=None,
                   help="stream-tx mode: file:PATH | fifo:PATH | tcp:HOST:PORT sample output")
    p.add_argument("--pdus", type=int, default=64)
    p.add_argument("--pdu-bytes", type=int, default=40)
    p.add_argument("--pace", action="store_true",
                   help="stream-tx: hold emission to cfg.sample_rate")
    p.add_argument("--source", default=None,
                   help="stream mode: file:PATH | fifo:PATH | tcp:HOST:PORT | listen:PORT "
                        "sample input")
    p.add_argument("--loop", type=int, default=1,
                   help="stream mode: replay a file: source N times")
    p.add_argument("--frames-per-block", type=int, default=16)
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help="stream mode: >1 overlaps readback with compute (StreamRxPipelined)")
    p.add_argument("--stats-every", type=int, default=0,
                   help="stream mode: emit a JSONL stats line every N blocks "
                        "(soak telemetry: counters + RSS)")
    p.add_argument("--max-blocks", type=int, default=0,
                   help="stream modes: stop after N blocks (0 = until EOF)")
    p.add_argument("--streams", type=int, default=4,
                   help="stream-sharded: independent streams")
    p.add_argument("--mesh-stream", type=int, default=None,
                   help="stream-sharded: ranks on the stream axis (default: the cards "
                        "there are over --mesh-time; 1 on the CPU)")
    p.add_argument("--mesh-time", type=int, default=1,
                   help="stream-sharded: ranks on the time axis")
    p.add_argument("--blocks-per-dispatch", type=int, default=1,
                   help="stream-sharded: K blocks per dispatch (megastep)")
    p.add_argument("--selftest", action="store_true",
                   help="stream-sharded: generate own input, assert decode")
    p.add_argument("--tb-frames", type=int, default=1,
                   help="stream mode: frames per transport block (FEC configs; "
                        ">1 enables streaming TB reassembly)")
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--rounds", type=int, default=32)
    p.add_argument("--frame-length", type=int, default=20)
    p.add_argument("--snr-db", type=float, default=30.0)
    p.add_argument("--snr-db-reverse", type=float, default=25.0)
    p.add_argument("--cfo", type=float, default=0.0,
                   help="carrier offset in subcarrier units")
    p.add_argument("--mcs-id", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--store-tx", default=None)
    p.add_argument("--store-rx", default=None)
    p.add_argument("--zmq", default=None, help="ZMQ PUB address for telemetry (needs pyzmq)")
    p.add_argument("--json", action="store_true")
    _cli.add_device_args(p)
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                   help="config override, e.g. --set cp_len=32 "
                        "--set 'mcs=[[0,[\"bpsk\",\"no_fec\"]]]' "
                        "(the grc_run jq-override analogue)")
    return p


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    args.config = _cli.apply_sets(args.config, args.set)
    if args.mode == "stream" and not args.source:
        sys.exit("error: stream mode requires --source")
    if args.mode == "stream-sharded" and not args.selftest and not args.source:
        sys.exit("error: stream-sharded requires --source or --selftest")
    if args.mode == "stream-tx" and not args.sink:
        sys.exit("error: stream-tx mode requires --sink")
    if args.zmq:
        _cli.require_pyzmq()
    {"loopback": run_loopback, "full-duplex": run_full_duplex,
     "simplex": run_simplex, "stream": run_stream,
     "stream-tx": run_stream_tx,
     "stream-sharded": run_stream_sharded}[args.mode](args)


if __name__ == "__main__":
    main()
