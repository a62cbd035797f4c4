"""The ``(stream, time)`` grid of ranks (port of gr_dtl_tpu/parallel/mesh.py).

Scale comes from a grid of the ranks of the default process group with two
axes:

- ``stream``: independent adaptive-OFDM channels (data parallelism: the
  "64 streams over N hosts" deployment),
- ``time``: contiguous blocks of one stream's sample timeline (sequence
  parallelism with an overlap-save halo passed along a ring).

Rank ``s * n_time + t`` sits at stream index s and time index t.  The grid
holds one process group per time ring (the ranks of one stream row) and
one per stream column (the ranks of one time index); a collective along an
axis runs on the caller's group of that axis.  Without an initialised
process group the grid is 1 x 1 and has no groups: every collective along
an axis of size 1 is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh"]


class Mesh:
    """A ``(stream, time)`` grid of the default group's ranks.

    ``shape`` maps each axis to its size and ``index`` to this rank's place
    on it (the counterpart of ``lax.axis_index``); ``time_group`` and
    ``stream_group`` are this rank's groups along each axis (None without
    a process group); ``device`` is where this rank's tensors live.
    """

    def __init__(self, n_stream: int, n_time: int, device):
        self.device = torch.device(device)
        on = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if on else 1
        self.rank = dist.get_rank() if on else 0
        if n_stream < 1 or n_time < 1 or n_stream * n_time != world:
            raise ValueError(f"a {n_stream} x {n_time} grid needs {n_stream * n_time} ranks, "
                             f"the process group has {world}")
        self.shape = {"stream": int(n_stream), "time": int(n_time)}
        self.index = {"stream": self.rank // n_time, "time": self.rank % n_time}
        self.time_group = self.stream_group = None
        if on:
            # every rank creates every group, in the same order: dist.new_group
            # is collective over the whole world, and a rank that made only its
            # own groups would wait for the others forever
            for s in range(n_stream):
                g = dist.new_group([self.rank_of(s, t) for t in range(n_time)])
                if s == self.index["stream"]:
                    self.time_group = g
            for t in range(n_time):
                g = dist.new_group([self.rank_of(s, t) for s in range(n_stream)])
                if t == self.index["time"]:
                    self.stream_group = g

    def rank_of(self, stream: int, time: int) -> int:
        """The global rank at (stream, time)."""
        return stream * self.shape["time"] + time

    def __repr__(self) -> str:
        return (f"Mesh(stream={self.shape['stream']}, time={self.shape['time']}, rank={self.rank} "
                f"at {self.index}, device={self.device})")


def make_mesh(n_stream: int | None = None, n_time: int = 1, *, device) -> Mesh:
    """Build a (stream, time) grid over the default process group's ranks.

    Args:
      n_stream: ranks along the stream (channel) axis; defaults to the
                world size / n_time.
      n_time:   ranks along the time (sequence) axis.
      device:   where this rank's tensors live (``cuda:<local rank>`` under
                NCCL, ``cpu`` under gloo).
    """
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n_stream is None:
        n_stream = world // n_time
    return Mesh(n_stream, n_time, device)
