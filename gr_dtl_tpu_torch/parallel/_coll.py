"""The collectives of the sharded receivers, in ``torch.distributed``.

Each JAX collective of gr_dtl_tpu/parallel/ maps to one call on a group of
the grid (parallel/mesh.py):

    ppermute ring shift     dist.batch_isend_irecv along the time group
    psum                    dist.all_reduce(SUM)
    tiled all_gather        dist.all_gather_into_tensor, then one reshape

Along an axis of size 1 each is the identity and launches nothing (torch
refuses a send to self, and a one-rank time ring is the one-card layout).
Complex tensors travel as their float pairs and bool tensors as bytes: the
backends' reductions and copies then need no complex or bool support.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["ring_shift", "all_reduce_sum", "all_gather", "gather_global"]


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A view of x in a type every backend moves and sums."""
    if x.is_complex():
        return torch.view_as_real(x)
    if x.dtype == torch.bool:
        return x.view(torch.uint8)
    return x


def ring_shift(x: torch.Tensor, mesh, step: int) -> torch.Tensor:
    """The time ring: this rank gets the x of the rank ``step`` places to its
    left, ``(t - step) mod n_time``, and sends its own ``step`` places right
    (``ppermute`` with the pairs ``(i, (i + step) % n)``).  ``step`` = +1
    passes each block's tail to its right neighbour; -1 each block's head to
    its left neighbour."""
    n = mesh.shape["time"]
    if n == 1:
        return x
    s, t = mesh.index["stream"], mesh.index["time"]
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, _wire(x), mesh.rank_of(s, (t + step) % n), mesh.time_group),
           dist.P2POp(dist.irecv, _wire(out), mesh.rank_of(s, (t - step) % n), mesh.time_group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks of ``group`` (a new tensor)."""
    if _size(group) == 1:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(_wire(out), op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's x of ``group`` concatenated along ``dim`` in rank order
    (``all_gather(..., tiled=True)``)."""
    n = _size(group)
    if n == 1:
        return x
    x = x.contiguous()
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    # the output as the ranks' tensors one after another along axis 0, the
    # form every backend takes
    dist.all_gather_into_tensor(_wire(out.flatten(0, 1)), _wire(x), group=group)
    return out.movedim(0, dim).flatten(dim, dim + 1)


def gather_global(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """A rank's [S_l, ...] piece of a (stream, time)-sharded array, whose
    time blocks lie along ``dim``, as the whole array on every rank."""
    return all_gather(all_gather(x, mesh.time_group, dim), mesh.stream_group, 0)
