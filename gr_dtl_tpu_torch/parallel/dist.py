"""Multi-process start-up: ``torch.distributed`` and host-aware grids (port
of gr_dtl_tpu/parallel/dist.py).

Design: the **stream axis maps to hosts** (pure data parallelism: no
cross-stream communication in steady state), and the **time axis stays
inside a host** so the overlap-save halo ring of the sharded receiver
(parallel/stream.py, parallel/session.py) rides NVLink only.  That is the
layout :func:`make_host_mesh` builds.

The backend follows the device the caller names, never what happens to be
installed: NCCL for ``cuda``, gloo for ``cpu``.  NCCL takes one rank per
card: two ranks on one device are refused.

Usage (the same program on every process, ``torchrun``-style environment):

    from gr_dtl_tpu_torch.parallel import dist
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dist.init(device=dev)             # MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE
    mesh = dist.make_host_mesh(n_time=2, device=dev)
"""

from __future__ import annotations

import os

import torch
import torch.distributed as tdist

from gr_dtl_tpu_torch.parallel.mesh import Mesh

__all__ = ["backend_for", "init", "init_group", "make_host_mesh"]


def backend_for(device) -> str:
    """The process-group backend of a device: NCCL for CUDA, gloo for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device type {kind!r}")


def init_group(rank: int, world_size: int, address: str, device) -> None:
    """Join the default process group at ``tcp://<address>`` (``host:port``)
    as ``rank`` of ``world_size``, with the backend of ``device``.  Also for
    a world of one (a one-card NCCL group)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(backend_for(dev), init_method=f"tcp://{address}", rank=int(rank),
                             world_size=int(world_size))


def init(coordinator: str | None = None, num_processes: int | None = None,
         process_id: int | None = None, *, device) -> bool:
    """Join the default process group when a multi-process run is asked for.

    Reads ``MASTER_ADDR`` / ``MASTER_PORT`` (or ``coordinator`` as
    ``host:port``), ``WORLD_SIZE`` and ``RANK`` where the arguments are
    omitted.  Returns True when the group was joined, False (doing
    nothing) for a single process, so the same launch script works on one
    card or many.
    """
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    if not coordinator or num_processes <= 1:
        return False
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    init_group(rank, num_processes, coordinator, device)
    return True


def make_host_mesh(n_time: int = 1, *, device) -> Mesh:
    """(stream, time) grid with hosts along the stream axis.

    Ranks are numbered host by host (``torchrun`` gives each node a
    contiguous block of ``LOCAL_WORLD_SIZE`` ranks), and rank
    ``s * n_time + t`` sits at (s, t), so every time ring lives inside one
    host and the stream axis crosses hosts only for data placement.

    Args:
      n_time: ranks per time ring; must divide the per-host rank count
        (``LOCAL_WORLD_SIZE``, the whole world without it) so that a ring
        never straddles two nodes.
    """
    on = tdist.is_available() and tdist.is_initialized()
    world = tdist.get_world_size() if on else 1
    n_local = max(1, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if n_time > n_local or n_local % n_time != 0:
        raise ValueError(f"n_time={n_time} must divide the per-host rank count ({n_local}) so "
                         "halo rings stay inside a host")
    return Mesh(world // n_time, n_time, device)
