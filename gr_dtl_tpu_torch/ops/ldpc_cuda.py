"""Sum-product BP on the GPU: the CUDA kernels of ``csrc/ldpc_bp.cu`` (K3
and K8) and their wrappers.

``bp_decode_cuda`` stands for the ``lax.scan`` of
``gr_dtl_tpu/ops/ldpc.py::decode_mm`` (:249-353) and, given a bank's graphs
and a code id a row, of ``decode_bank_mm`` (:545-572): one block a
codeword (a thread a check, :func:`warps_for`) keeps the codeword's
messages in shared memory over all its updates and stops at its own
syndrome pass, every row with its own code, in one launch with no host
check.  Its plain PyTorch version is ``ops/ldpc.py::_bp``,
which ``decode_mm`` and ``decode_bank_mm`` run on CPU tensors.  The
library is built at first use (``ops/_cuda_build``); importing this module
needs neither ``nvcc`` nor a GPU.  The wrapper launches on PyTorch's
current stream, allocates its outputs with ``torch.empty``, never
synchronises, reads nothing back, and counts its launches in
``bp_decode_cuda.LAUNCHES``.  The kernel reads int16 copies of the codes'
index tables, slot-major, one array for all the codes of a call
(:func:`bank_tables`), made on the graphs' device at their first call and
kept.

``bp_gather_cuda`` (K8) stands for the ``lax.scan`` of ``decode``
(:154-246) and ``decode_bank`` (:574-645), the gather form: a wave of
resident blocks walking codewords from a counter of the stream's
(:func:`_work`) where B fills ``WALK_WAVES`` waves, else a block a
codeword; K3's tables staged in shared memory for a codeword that takes
updates, a tanh-product check update and ``decode_bank``'s code-id rule;
its own C entry point, ``bp_gather_launch``.  Its plain PyTorch version is
``ops/ldpc.py::_bp_gather``.  It launches, allocates and counts
(``bp_gather_cuda.LAUNCHES``) as ``bp_decode_cuda`` does, and shares its
tables' cache.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from gr_dtl_tpu_torch.ops import _cuda_build

__all__ = ["build", "library_path", "BpTables", "bp_tables", "BankTables", "bank_tables", "smem_bytes",
           "warps_for", "resident_codewords", "bp_bytes", "bp_ops", "bp_decode_cuda",
           "bp_gather_cuda"]

SOURCE = _cuda_build.PKG / "csrc" / "ldpc_bp.cu"
NVCC_FLAGS = _cuda_build.NVCC_FLAGS
# the source's limits: kMaxIndex (N and E, int16 tables), kMaxDeg (column and
# row degree), kMaxSmem (a block's shared memory on sm_90), kMaxThreads (a
# block's, so 8 warps); kRegSlots, the row degree up to which a thread's
# slots are unrolled with no guard
MAX_INDEX = 32767
MAX_DEG = 64
MAX_SMEM = 232448
MAX_WARPS = 8
REG_SLOTS = 8
HEADER = 7  # ints a code in the header: M, E, dv, dc and the offsets of var_edges, chk_edges, chk_vars
# operations of the plain version, one an element of each of its ops: a
# message update's per edge (v2c, clamp, halve, tanh, abs, max, log, sign,
# the two check sums, two leave-one-out differences, parity, exp, sign,
# clamp, atanh, double)
UPDATE_OPS_PER_EDGE = 18
# the gather form's (K8): v2c, clamp, halve, tanh, the pad's select, the
# check product, abs, compare, sign, scale, offset, the guard's select,
# divide, clamp, atanh, double
GATHER_UPDATE_OPS_PER_EDGE = 16
GATHER_FORM = 2  # bp_resident_codewords' form for K8 (0 and 1: K3 without and with bf16)
WALK_WAVES = 4  # K8's blocks walk codewords where B fills this many waves of resident blocks (kWalkWaves)


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    return _cuda_build.library_path(SOURCE, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = _cuda_build.load(SOURCE, NVCC_FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bp_decode_launch.argtypes = [p, p, p, i, i, p, p, i, i, i, i, i, i, i, p, p, p, p, p]
    lib.bp_decode_launch.restype = i
    lib.bp_gather_launch.argtypes = [p, p, i, i, p, p, i, i, i, i, i, i, i, i, p, p, p, p, p]
    lib.bp_gather_launch.restype = i
    lib.bp_resident_codewords.argtypes = [i, i, i, i, i, i, i]
    lib.bp_resident_codewords.restype = i
    return lib


@dataclasses.dataclass(frozen=True)
class BpTables:
    """A graph's index tables as the kernel reads them: int16, contiguous,
    slot-major (a row a slot), on the graph's device, with the graph's pads
    (E in ``var_edges`` and ``chk_edges``, N in ``chk_vars``)."""

    dv: int  # column degree slots
    dc: int  # row degree slots
    var_edges: torch.Tensor  # [dv, N]
    chk_edges: torch.Tensor  # [dc, M]
    chk_vars: torch.Tensor  # [dc, M]


@dataclasses.dataclass(frozen=True)
class BankTables:
    """The tables of every code of a call in one array, as the kernel finds
    them: code c's ``var_edges``, ``chk_edges`` and ``chk_vars``
    (:func:`bp_tables`, pads and all, the row tables padded with pad slots
    to the call's largest row degree) lie in ``tab`` from the offsets in
    row c of ``header``."""

    n_var: int  # N, every code's
    max_chk: int  # the largest M
    max_edges: int  # the largest E
    max_dc: int  # the largest row degree: every code's row slots in the tables
    max_chk_slots: int  # the largest max_dc x M: entries of a code's chk_edges, or chk_vars
    max_var_slots: int  # the largest dv x N: entries of a code's var_edges
    header: torch.Tensor  # [C, HEADER] int32: M, E, dv, max_dc, offset of var_edges, chk_edges, chk_vars
    tab: torch.Tensor  # int16, every code's three tables flattened one after another


def smem_bytes(N: int, E: int) -> int:
    """Shared memory a block of K3 takes (the source's ``bp_smem_bytes``)
    for codewords of N bits and codes of at most E edges: the LLRs [N],
    totals [N + 1] and messages [E + 1], 4 bytes each."""
    return 4 * (2 * N + E + 2)


def row_stride(N: int) -> int:
    """Floats K8's row buffer takes (the source's ``row_stride``): N and the
    pad's zero after them, rounded up to 16 bytes."""
    return (N + 4) & ~3


def staged_words(n: int) -> int:
    """int16 entries of room a table of n entries takes staged in K8's
    shared memory (the source's ``staged_words``): n, one before it and
    one past, rounded up to 4 bytes."""
    return (n + 3) & ~1


def gather_smem_bytes(N: int, E: int, cm: int, vn: int) -> int:
    """Shared memory a block of K8 takes (the source's
    ``gather_smem_bytes``): the row buffer (``row_stride``), totals [N + 1],
    messages [E + 1] and the block's next codeword by parity [2], 4 bytes
    each, and the code's staged tables, int16: chk_vars and chk_edges (cm
    entries each, the largest dc x M) and var_edges (vn, the largest dv x
    N)."""
    return 4 * (row_stride(N) + N + E + 4) + 2 * (2 * staged_words(cm) + staged_words(vn))


def _check_limits(graph) -> None:
    N, E = graph.n_var, graph.n_edge
    dv, dc = graph.var_edges.shape[1], graph.chk_edges.shape[1]
    if max(N, E) > MAX_INDEX or max(dv, dc) > MAX_DEG or smem_bytes(N, E) > MAX_SMEM:
        raise ValueError(f"K3 takes N, E <= {MAX_INDEX}, degrees <= {MAX_DEG} and {MAX_SMEM} bytes of "
                         f"shared memory; this graph has N = {N}, E = {E}, column degree {dv}, "
                         f"row degree {dc}, {smem_bytes(N, E)} bytes")


def bp_tables(graph) -> BpTables:
    """The int16 slot-major tables of a
    :class:`~gr_dtl_tpu_torch.ops.ldpc.BpGraph`, made on its device (no
    host read); raises above the kernel's limits."""
    _check_limits(graph)
    t = lambda x: x.T.to(torch.int16).contiguous()
    return BpTables(dv=graph.var_edges.shape[1], dc=graph.chk_edges.shape[1], var_edges=t(graph.var_edges),
                    chk_edges=t(graph.chk_edges), chk_vars=t(graph.chk_vars))


def bank_tables(graphs) -> BankTables:
    """Every graph's :func:`bp_tables` in one int16 array on their device,
    each code's row tables padded to the largest row degree (pads E and N),
    with the header that finds them (built on the host from the graphs'
    sizes, copied once).  The graphs must share N."""
    if not graphs:
        raise ValueError("a bank needs at least one graph")
    N = graphs[0].n_var
    if any(g.n_var != N for g in graphs):
        raise ValueError(f"a bank's graphs must share N; got {[g.n_var for g in graphs]}")
    dc = max(g.chk_edges.shape[1] for g in graphs)
    parts, header, off = [], [], 0
    for g in graphs:
        tab = bp_tables(g)
        pad = lambda t, fill: torch.cat([t, t.new_full((dc - tab.dc, t.shape[1]), fill)])
        row = [g.n_chk, g.n_edge, tab.dv, dc]
        for t in (tab.var_edges, pad(tab.chk_edges, g.n_edge), pad(tab.chk_vars, N)):
            row.append(off)
            parts.append(t.reshape(-1))
            off += t.numel()
        header.append(row)
    dev = graphs[0].var_edges.device
    return BankTables(n_var=N, max_chk=max(g.n_chk for g in graphs), max_edges=max(g.n_edge for g in graphs),
                      max_dc=dc, max_chk_slots=max(dc * r[0] for r in header),
                      max_var_slots=max(r[2] * N for r in header),
                      header=torch.tensor(header, dtype=torch.int32, device=dev), tab=torch.cat(parts))


_TABLES: dict[int, tuple] = {}  # id(graphs) -> (graphs, their BankTables, warps); held so the id stays theirs


def _cached(graphs) -> tuple:
    """(:func:`bank_tables`, :func:`warps_for`) of a graph, or of a tuple of
    graphs (a bank's), made at the first call and kept."""
    hit = _TABLES.get(id(graphs))
    if hit is None or hit[0] is not graphs:
        tab = bank_tables(graphs if isinstance(graphs, tuple) else (graphs,))
        hit = _TABLES[id(graphs)] = (graphs, tab, min(MAX_WARPS, -(-tab.max_chk // 32)))
    return hit[1:]


def warps_for(graphs) -> int:
    """A block's warps for these graphs' calls: a thread a check of the
    largest code, up to ``MAX_WARPS``."""
    return _cached(graphs)[1]


def resident_codewords(graphs, bf16: bool = False, gather: bool = False) -> int:
    """Codewords of these graphs' calls that one SM keeps resident at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; a codeword a block
    of :func:`warps_for` warps), K3's or, with ``gather``, K8's."""
    tab, warps = _cached(graphs)
    form = GATHER_FORM if gather else int(bool(bf16))
    n = build().bp_resident_codewords(tab.n_var, tab.max_edges, tab.max_dc, warps, form, tab.max_chk_slots,
                                      tab.max_var_slots)
    if n < 0:
        raise RuntimeError(f"bp_resident_codewords failed: CUDA error {-n}")
    return n


def bp_bytes(B: int, N: int) -> int:
    """Bytes a ``decode_mm`` call's launch must move for B codewords of N
    bits: the float32 LLRs read once, the int32 hard bits, int32 iters and
    bool ok written once."""
    return B * (8 * N + 5)


def bp_ops(iters_used, graph, per_edge: int = UPDATE_OPS_PER_EDGE) -> int:
    """Operations these inputs need, counted as the plain version's
    element-wise ops: every codeword takes ``iters_used + 1`` passes of
    totals and syndrome (E adds into the totals, N sign tests, E parity
    adds: 2E + N) and ``iters_used`` message updates of ``per_edge`` an
    edge (a transcendental counts one): ``UPDATE_OPS_PER_EDGE`` for K3,
    ``GATHER_UPDATE_OPS_PER_EDGE`` for K8.  ``iters_used``: the [B] counts
    this run returned."""
    it = torch.as_tensor(iters_used)
    U, B = int(it.sum()), it.numel()
    E, N = graph.n_edge, graph.n_var
    return (B + U) * (2 * E + N) + U * per_edge * E


def _checked(fn: str, llr: torch.Tensor, graph, code_idx: torch.Tensor | None, max_iters: int) -> tuple:
    """The checks both wrappers make: (graphs, tables, warps) for a launch
    on ``llr``'s device, or a ValueError."""
    bank = isinstance(graph, tuple)
    if bank != (code_idx is not None):
        raise ValueError("code_idx goes with a bank's graphs (a tuple), and a tuple of graphs with code_idx")
    graphs = graph if bank else (graph,)
    N = graphs[0].n_var
    if llr.dtype != torch.float32 or llr.ndim != 2 or llr.shape[1] != N:
        raise ValueError(f"llr must be float32 [B, {N}], got {llr.dtype} {tuple(llr.shape)}")
    if not llr.is_contiguous():
        raise ValueError(f"llr must be contiguous, got strides {llr.stride()}")
    B = llr.shape[0]
    if code_idx is not None and (code_idx.dtype not in (torch.int32, torch.int64) or tuple(code_idx.shape) != (B,)
                                 or not code_idx.is_contiguous()):
        raise ValueError(f"code_idx must be a contiguous int32 or int64 [{B}] tensor, got {code_idx.dtype} "
                         f"{tuple(code_idx.shape)} with strides {code_idx.stride()}")
    dev = llr.device
    if dev.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got one on {dev}")
    tab, warps = _cached(graph)
    if tab.tab.device != dev:
        raise ValueError(f"the graph lies on {tab.tab.device}, the LLRs on {dev}")
    if code_idx is not None and code_idx.device != dev:
        raise ValueError(f"code_idx lies on {code_idx.device}, the LLRs on {dev}")
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    return graphs, tab, warps


def _launch(fn: str, entry, args: tuple, dev) -> None:
    """Call a C entry point with ``dev`` current; raise on its CUDA error."""
    if dev.index == torch.cuda.current_device():
        rc = entry(*args)
    else:
        with torch.cuda.device(dev):
            rc = entry(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {rc}")


def bp_decode_cuda(llr: torch.Tensor, graph, max_iters: int = 15, done: torch.Tensor | None = None,
                   bf16: bool = False, total_out: torch.Tensor | None = None,
                   code_idx: torch.Tensor | None = None):
    """Sum-product BP in one launch: ``_bp``'s contract, over one graph or a
    bank with a code a row.

    Args:
      llr: [B, N] float32 CUDA tensor, contiguous, N = ``graph.n_var``; LLR
        > 0 <=> bit 0.
      graph: a ``BpGraph`` on the same device; or, with ``code_idx``, a
        bank's graphs (the tuple ``LdpcBank.graphs``, every one of N
        variables), row b decoded with graph ``clamp(code_idx[b], 1, C) - 1``
        (``decode_bank_mm``'s selection).
      done: optional [B] bool, contiguous: rows treated as converged from the
        start (their iterations 0, their ok True, their totals the LLRs).
      bf16: round to bfloat16 the operands ``_bp(bf16=True)`` rounds.
      total_out: optional [B, N] float32 contiguous tensor that receives the
        final total LLRs (``_bp``'s fourth output).
      code_idx: [B] int32 or int64 1-based code ids, contiguous, with a
        bank's graphs.
    Returns (hard [B, N] int32, iters_used [B] int32, ok [B] bool).
    """
    graphs, tab, warps = _checked("bp_decode_cuda", llr, graph, code_idx, max_iters)
    B, N = llr.shape
    dev = llr.device
    if done is not None and (done.dtype != torch.bool or tuple(done.shape) != (B,)
                             or not done.is_contiguous() or done.device != dev):
        raise ValueError(f"done must be a contiguous bool [{B}] tensor on {dev}, got {done.dtype} "
                         f"{tuple(done.shape)} on {done.device}")
    if total_out is not None and (total_out.dtype != torch.float32 or tuple(total_out.shape) != (B, N)
                                  or not total_out.is_contiguous() or total_out.device != dev):
        raise ValueError(f"total_out must be a contiguous float32 [{B}, {N}] tensor on {dev}")
    hard = torch.empty((B, N), dtype=torch.int32, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:  # no codeword: nothing to launch
        return hard, iters, ok
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (llr.data_ptr(), ptr(done), ptr(code_idx), int(code_idx is not None and code_idx.dtype == torch.int64),
            len(graphs), tab.header.data_ptr(), tab.tab.data_ptr(), tab.max_edges, tab.max_dc,
            warps, B, N, int(max_iters), int(bool(bf16)), hard.data_ptr(), iters.data_ptr(),
            ok.data_ptr(), ptr(total_out), torch.cuda.current_stream(dev).cuda_stream)
    _launch("bp_decode_launch", build().bp_decode_launch, args, dev)
    bp_decode_cuda.LAUNCHES += 1
    return hard, iters, ok


bp_decode_cuda.LAUNCHES = 0


def bp_gather_cuda(llr: torch.Tensor, graph, max_iters: int = 15, code_idx: torch.Tensor | None = None):
    """The gather form's sum-product BP in one launch (K8): ``_bp_gather``'s
    contract, over one graph (``decode``) or a bank with a code a row
    (``decode_bank``).

    Args:
      llr: [B, N] float32 CUDA tensor, contiguous, N = ``graph.n_var``; LLR
        > 0 <=> bit 0.
      graph: a ``BpGraph`` on the same device (``LdpcCode.graph``, whose
        edges are the gather tables' slots); or, with ``code_idx``, a bank's
        graphs (``LdpcBank.graphs``), row b decoded with ``decode_bank``'s
        code: table row ``clamp(id + (C + 1 if id < 0 else 0), 0, C)``,
        row 0 being code 1.
      code_idx: [B] int32 or int64 1-based code ids, contiguous, with a
        bank's graphs.
    Returns (hard [B, N] int32, iters_used [B] int32, ok [B] bool).  A walk
    that finds the stream's counters (:func:`_work`) other than 0 traps,
    and the next synchronising call raises.
    """
    graphs, tab, warps = _checked("bp_gather_cuda", llr, graph, code_idx, max_iters)
    B, N = llr.shape
    smem = gather_smem_bytes(N, tab.max_edges, tab.max_chk_slots, tab.max_var_slots)
    if smem > MAX_SMEM:
        raise ValueError(f"K8 takes {MAX_SMEM} bytes of shared memory; these graphs need {smem}")
    dev = llr.device
    hard = torch.empty((B, N), dtype=torch.int32, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:  # no codeword: nothing to launch
        return hard, iters, ok
    stream = torch.cuda.current_stream(dev)
    args = (llr.data_ptr(), None if code_idx is None else code_idx.data_ptr(),
            int(code_idx is not None and code_idx.dtype == torch.int64), len(graphs), tab.header.data_ptr(),
            tab.tab.data_ptr(), tab.max_edges, tab.max_dc, warps, B, N, int(max_iters), tab.max_chk_slots,
            tab.max_var_slots, hard.data_ptr(), iters.data_ptr(), ok.data_ptr(), _work(stream).data_ptr(),
            stream.cuda_stream)
    _launch("bp_gather_launch", build().bp_gather_launch, args, dev)
    bp_gather_cuda.LAUNCHES += 1
    return hard, iters, ok


bp_gather_cuda.LAUNCHES = 0

_WORK: dict[tuple, torch.Tensor] = {}  # (device, stream) -> K8's counters on that stream
WORK_COUNTERS = 3  # codewords taken, blocks left, codewords decoded (the source's work[0..2])


def _work(stream) -> torch.Tensor:
    """K8's uint32 counters for launches on ``stream`` (codewords taken,
    blocks left, codewords decoded): zeroed on the stream at its first
    launch, then left at 0 by every launch, so that a call enqueues the
    kernel alone.  A stream of its own keeps launches on two streams from
    sharing a count.  The first launch on a stream must not be captured into
    a CUDA graph: the zeroing would run only when the graph does, and a
    launch before it would walk from whatever the memory held (the kernel
    traps on counts that did not start at 0)."""
    key = (stream.device.index, stream.cuda_stream)
    if key not in _WORK:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("bp_gather_cuda: the first launch on a stream makes its counters, and cannot be "
                               "captured; call it once on the capturing stream before the capture")
        _WORK[key] = torch.zeros(WORK_COUNTERS, dtype=torch.int32, device=stream.device)  # on the current stream
    return _WORK[key]
