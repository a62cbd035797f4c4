"""Worker processes for the sharded receivers: spawn a ``(stream, time)``
grid of ranks on one host, run a function of this package on each, and
collect what each returns.

:func:`spawn` starts ``n_stream * n_time`` fresh interpreters
(``torch.multiprocessing``, the spawn start method), each of which joins a
process group on ``localhost`` with the backend of ``device`` (gloo for
``cpu``; NCCL for ``cuda``, rank r on card r: NCCL refuses two ranks on one
card), builds the grid and calls ``fn(mesh, **kwargs)``.  ``fn`` must be a
function of this package, so that a worker imports only this package and
torch.  The ``run_*`` functions below are such functions: they drive the
sharded receivers on given numpy inputs and return numpy results, the
grid's shards gathered so that every rank returns the whole.
"""

from __future__ import annotations

import pickle
import socket
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from gr_dtl_tpu_torch.models import fec_chain
from gr_dtl_tpu_torch.parallel import _coll, dist, mesh as meshmod, session, stream
from gr_dtl_tpu_torch.utils import alist

__all__ = ["free_port", "spawn", "rank_device", "run_sharded_rx", "run_loopback", "run_session",
           "OUT_FIELDS"]

# the RxOut fields the runners return
OUT_FIELDS = ("payload", "payload_len", "crc_ok", "header_ok", "frame_no", "cnst_id",
              "feedback_cnst", "carr_offset", "snr_db", "noise_var")


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, or card ``rank`` (one rank a card)."""
    device = torch.device(device)
    return torch.device("cuda", rank) if device.type == "cuda" else device


def _worker(rank, world, port, device, n_stream, n_time, fn, kwargs, out_dir):
    torch.set_num_threads(1)
    dev = rank_device(device, rank)
    dist.init_group(rank, world, f"127.0.0.1:{port}", dev)
    try:
        res = fn(meshmod.make_mesh(n_stream, n_time, device=dev), **kwargs)
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def spawn(fn, n_stream: int, n_time: int, *, device, **kwargs) -> list:
    """Run ``fn(mesh, **kwargs)`` on an ``n_stream x n_time`` grid of new
    processes on this host, rank r on ``rank_device(device, r)``; returns
    what each rank returned, in rank order.  A rank that raises makes this
    raise."""
    world = n_stream * n_time
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_worker, args=(world, free_port(), str(device), n_stream, n_time, fn, kwargs,
                                out_dir), nprocs=world, join=True)
        results = []
        for r in range(world):
            with open(Path(out_dir) / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return results


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def run_sharded_rx(mesh, cfg, streams: np.ndarray, frames_per_block: int) -> dict:
    """``stream.build_sharded_rx`` on ``streams`` [S, n_time * block]: the
    RxOut fields of every stream and slot, [S, n_time * frames_per_block, ...]."""
    fn, _ = stream.build_sharded_rx(cfg, mesh, frames_per_block, mesh.device)
    out = fn(streams)
    return {k: _host(_coll.gather_global(getattr(out, k), mesh, 1)) for k in OUT_FIELDS}


def _fec(spec, device):
    """``fec_chain.FecParams`` from (tx config, alist path, frames a TB), or None."""
    if spec is None:
        return None
    cfg, path, W = spec
    return fec_chain.build_fec(cfg, alist.load_alist(str(path)), device, tb_frames=W)


def run_loopback(mesh, txcfg, rxcfg, frames_per_block: int, noise_v: float, inputs: dict,
                 fec=None) -> dict:
    """``stream.build_sharded_loopback`` on global numpy ``inputs``
    (payload, plen, cnst, frame_no, pad, noise); ``fec``: (tx config, alist
    path, frames a TB) or None.  The RxOut fields of every stream and slot."""
    fn, _ = stream.build_sharded_loopback(txcfg, rxcfg, mesh, frames_per_block, noise_v,
                                          mesh.device, _fec(fec, mesh.device))
    out = fn(*(inputs[k] for k in ("payload", "plen", "cnst", "frame_no", "pad", "noise")))
    return {k: _host(_coll.gather_global(getattr(out, k), mesh, 1)) for k in OUT_FIELDS}


def run_session(mesh, cfg, n_streams: int, frames_per_block: int, chunks: list, fec=None,
                blocks_per_dispatch: int = 1, probe: bool = False, timestamp: int | None = None,
                restore: dict | None = None, flush: bool = False) -> dict:
    """A ``session.ShardedStreamRx`` over the global numpy ``chunks`` (one
    call each).  ``fec``: (tx config, alist path, frames a TB) or None;
    ``probe``: a capture-mode MonitorProbe, with every envelope stamped
    ``timestamp`` when given; ``restore``: a snapshot to start from;
    ``flush``: call ``flush_tb`` at the end.

    Returns per call the RxOut fields of every stream and slot ([S, F, ...],
    K > 1: [S, K, F, ...]), the masks and counters, the TBs (leaves [S, F,
    ...]); the snapshot after the last call; this rank's captured envelopes;
    the flush.
    """
    probe_obj = None
    if probe:
        from gr_dtl_tpu_torch.testbed import monitor

        if timestamp is not None:
            monitor.system_ts = lambda: timestamp
        probe_obj = monitor.MonitorProbe(address=None)
    srx = session.ShardedStreamRx(cfg, mesh, n_streams, frames_per_block, _fec(fec, mesh.device),
                                  blocks_per_dispatch, probe_obj, device=mesh.device)
    if restore is not None:
        srx.restore(restore)
    dim = 1 if blocks_per_dispatch == 1 else 2
    calls = []
    for chunk in chunks:
        res = srx.process(chunk)
        rec = {"out": {k: _host(_coll.gather_global(getattr(res[0], k), mesh, dim))
                       for k in OUT_FIELDS},
               "valid": srx.last_valid.copy(), "header_ok": srx.last_header_ok.copy(),
               "crc_ok": srx.last_crc_ok.copy(), "n_lost": srx.n_lost.copy(),
               "n_frames": srx.n_frames.copy()}
        if len(res) == 3:
            rec["tb"] = {k: _host(_coll.all_gather(v, mesh.stream_group)) for k, v in res[2].items()}
        calls.append(rec)
    snap = srx.snapshot()
    flushed = srx.flush_tb() if flush else None
    return {"calls": calls, "snapshot": snap,
            "captured": None if probe_obj is None else list(probe_obj.captured),
            "flush": None if flushed is None else {k: _host(v) for k, v in flushed.items()},
            "index": dict(mesh.index)}
