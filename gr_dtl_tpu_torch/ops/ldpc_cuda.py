"""Sum-product BP on the GPU: the CUDA kernel of ``csrc/ldpc_bp.cu`` (K3)
and its wrapper.

``bp_decode_cuda`` stands for the ``lax.scan`` of
``gr_dtl_tpu/ops/ldpc.py::decode_mm`` (:249-353): one block a codeword
keeps the codeword's messages in shared memory over all its updates and
stops at its own syndrome pass, in one launch with no host check.  Its plain
PyTorch version is ``ops/ldpc.py::_bp``, which ``decode_mm`` and
``decode_bank_mm`` run on CPU tensors.  The library is built at first use
(``ops/_cuda_build``); importing this module needs neither ``nvcc`` nor a
GPU.  The wrapper launches on PyTorch's current stream, allocates its
outputs with ``torch.empty``, never synchronises, reads nothing back, and
counts its launches in ``bp_decode_cuda.LAUNCHES``.  The kernel reads
int16 copies of a graph's index tables (:func:`bp_tables`), made on the
graph's device at its first call and kept.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from gr_dtl_tpu_torch.ops import _cuda_build

__all__ = ["build", "library_path", "BpTables", "bp_tables", "smem_bytes", "bp_bytes", "bp_ops",
           "bp_decode_cuda"]

SOURCE = _cuda_build.PKG / "csrc" / "ldpc_bp.cu"
NVCC_FLAGS = _cuda_build.NVCC_FLAGS
# the source's limits: kMaxIndex (N and E, int16 tables), kMaxDeg (column and
# row degree), kMaxSmem (a block's shared memory on sm_90)
MAX_INDEX = 32767
MAX_DEG = 64
MAX_SMEM = 232448
# operations of the plain version, one an element of each of its ops: a
# message update's per edge (v2c, clamp, halve, tanh, abs, max, log, sign,
# the two check sums, two leave-one-out differences, parity, exp, sign,
# clamp, atanh, double)
UPDATE_OPS_PER_EDGE = 18


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    return _cuda_build.library_path(SOURCE, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = _cuda_build.load(SOURCE, NVCC_FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bp_decode_launch.argtypes = [p, p, p, i, p, p, i, p, p, i, i, i, i, i, i, p, p, p, p, p]
    lib.bp_decode_launch.restype = i
    return lib


@dataclasses.dataclass(frozen=True)
class BpTables:
    """A graph's index tables as the kernel reads them: int16, contiguous,
    on the graph's device, with the graph's pads (E in ``var_edges`` and
    ``chk_edges``, N in ``chk_vars``)."""

    dv: int  # column degree slots
    dc: int  # row degree slots
    var_edges: torch.Tensor  # [N, dv]
    chk_edges: torch.Tensor  # [M, dc]
    chk_vars: torch.Tensor  # [M, dc]
    edge_var: torch.Tensor  # [E]
    edge_chk: torch.Tensor  # [E]


def smem_bytes(N: int, M: int, E: int) -> int:
    """Shared memory a block of the kernel takes (the source's
    ``bp_smem_bytes``): c2v and mag [E + 1], totals and LLRs [N], the check
    sums [M] in 4 bytes each; neg [E + 1] and hard [N + 1] in one."""
    return 4 * (2 * (E + 1) + 2 * N + 2 * M) + (E + 1) + (N + 1)


def _check_limits(graph) -> None:
    N, M, E = graph.n_var, graph.n_chk, graph.n_edge
    dv, dc = graph.var_edges.shape[1], graph.chk_edges.shape[1]
    if max(N, E) > MAX_INDEX or max(dv, dc) > MAX_DEG or smem_bytes(N, M, E) > MAX_SMEM:
        raise ValueError(f"K3 takes N, E <= {MAX_INDEX}, degrees <= {MAX_DEG} and {MAX_SMEM} bytes of "
                         f"shared memory; this graph has N = {N}, M = {M}, E = {E}, column degree {dv}, "
                         f"row degree {dc}, {smem_bytes(N, M, E)} bytes")


def bp_tables(graph) -> BpTables:
    """The int16 tables of a :class:`~gr_dtl_tpu_torch.ops.ldpc.BpGraph`,
    made on its device (no host read); raises above the kernel's limits."""
    _check_limits(graph)
    t = lambda x: x.to(torch.int16).contiguous()
    return BpTables(dv=graph.var_edges.shape[1], dc=graph.chk_edges.shape[1],
                    var_edges=t(graph.var_edges), chk_edges=t(graph.chk_edges),
                    chk_vars=t(graph.chk_vars), edge_var=t(graph.edge_var), edge_chk=t(graph.edge_chk))


_TABLES: dict[int, tuple] = {}  # id(graph) -> (graph, its BpTables); the graph is held so its id stays its own


def _tables(graph) -> BpTables:
    hit = _TABLES.get(id(graph))
    if hit is None or hit[0] is not graph:
        hit = _TABLES[id(graph)] = (graph, bp_tables(graph))
    return hit[1]


def bp_bytes(B: int, N: int) -> int:
    """Bytes a ``decode_mm`` call's launch must move for B codewords of N
    bits: the float32 LLRs read once, the int32 hard bits, int32 iters and
    bool ok written once."""
    return B * (8 * N + 5)


def bp_ops(iters_used, graph) -> int:
    """Operations these inputs need, counted as the plain version's
    element-wise ops: every codeword takes ``iters_used + 1`` passes of
    totals and syndrome (E adds into the totals, N sign tests, E parity
    adds: 2E + N) and ``iters_used`` message updates of
    ``UPDATE_OPS_PER_EDGE`` an edge (a transcendental counts one).
    ``iters_used``: the [B] counts this run returned."""
    it = torch.as_tensor(iters_used)
    U, B = int(it.sum()), it.numel()
    E, N = graph.n_edge, graph.n_var
    return (B + U) * (2 * E + N) + U * UPDATE_OPS_PER_EDGE * E


def bp_decode_cuda(llr: torch.Tensor, graph, max_iters: int = 15, done: torch.Tensor | None = None,
                   bf16: bool = False, total_out: torch.Tensor | None = None):
    """Sum-product BP over one graph in one launch: ``_bp``'s contract.

    Args:
      llr: [B, N] float32 CUDA tensor, contiguous, N = ``graph.n_var``; LLR
        > 0 <=> bit 0.
      graph: a ``BpGraph`` on the same device.
      done: optional [B] bool, contiguous: rows treated as converged from the
        start (their messages stay 0, their iterations 0, their ok True).
      bf16: round to bfloat16 the operands ``_bp(bf16=True)`` rounds.
      total_out: optional [B, N] float32 contiguous tensor that receives the
        final total LLRs (``_bp``'s fourth output).
    Returns (hard [B, N] int32, iters_used [B] int32, ok [B] bool).
    """
    if llr.dtype != torch.float32 or llr.ndim != 2 or llr.shape[1] != graph.n_var:
        raise ValueError(f"llr must be float32 [B, {graph.n_var}], got {llr.dtype} {tuple(llr.shape)}")
    if not llr.is_contiguous():
        raise ValueError(f"llr must be contiguous, got strides {llr.stride()}")
    dev = llr.device
    if dev.type != "cuda":
        raise ValueError(f"bp_decode_cuda needs CUDA tensors, got one on {dev}")
    if graph.var_edges.device != dev:
        raise ValueError(f"the graph lies on {graph.var_edges.device}, the LLRs on {dev}")
    B, N = llr.shape
    if done is not None and (done.dtype != torch.bool or tuple(done.shape) != (B,)
                             or not done.is_contiguous() or done.device != dev):
        raise ValueError(f"done must be a contiguous bool [{B}] tensor on {dev}, got {done.dtype} "
                         f"{tuple(done.shape)} on {done.device}")
    if total_out is not None and (total_out.dtype != torch.float32 or tuple(total_out.shape) != (B, N)
                                  or not total_out.is_contiguous() or total_out.device != dev):
        raise ValueError(f"total_out must be a contiguous float32 [{B}, {N}] tensor on {dev}")
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    tab = _tables(graph)
    hard = torch.empty((B, N), dtype=torch.int32, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:  # no codeword: nothing to launch
        return hard, iters, ok
    with torch.cuda.device(dev):
        rc = build().bp_decode_launch(
            llr.data_ptr(), None if done is None else done.data_ptr(), tab.var_edges.data_ptr(), tab.dv,
            tab.chk_edges.data_ptr(), tab.chk_vars.data_ptr(), tab.dc, tab.edge_var.data_ptr(),
            tab.edge_chk.data_ptr(), B, N, graph.n_chk, graph.n_edge, int(max_iters), int(bool(bf16)),
            hard.data_ptr(), iters.data_ptr(), ok.data_ptr(),
            None if total_out is None else total_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bp_decode_launch failed: CUDA error {rc}")
    bp_decode_cuda.LAUNCHES += 1
    return hard, iters, ok


bp_decode_cuda.LAUNCHES = 0
