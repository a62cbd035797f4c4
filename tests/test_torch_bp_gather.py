"""K8's plan on the CPU: a numpy model of the gather form's schedule in
``csrc/ldpc_bp.cu`` (``bp_gather_kernel``) held to the port's plain gather
form (``ops/ldpc.py::_bp_gather``) and to the reference's ``decode`` and
``decode_bank``; the map from the gather tables to the kernel's; the
reference's code-id rule; and the host side of ``ldpc_cuda.bp_gather_cuda``.

The model decodes as the kernel does: a codeword at a time, on its code's
slot-major int16 tables found through the header of
``ldpc_cuda.bank_tables`` (K3's tables: the gather form's slot [m, r] is
the edge ``chk_edges[r, m]``), pads reading a zero kept at index E or N.
The first syndrome pass reads the LLRs themselves (llr + 0 differs from
them only at -0.0, where no sign test does), the first totals are the LLRs
plus 0, with no gather, and the first update reads no message.  A check's slots give t = tanh(clamp(v2c, +-20) / 2), 1
at a pad, multiplied left to right from slot 0; each edge's message is
2 atanh(clamp(prod / t_safe, +-0.999999)); the totals add a variable's
slots left to right.  A codeword's loop ends at its own syndrome pass (or
after ``max_iters`` updates), and a bank's rows each take the code the
reference's indexing picks.  It must equal ``_bp_gather`` bit for bit
(hard bits, iterations, ok) and the reference at the bar of
tests/test_torch_ldpc_leftovers.py: ``ok`` and ``iters_used`` on every
row, hard bits on every row that converged, and at most
``DECODE_FAILING_ROWS_PARTED`` rows parted (XLA's float32 tanh differs
from PyTorch's by an ulp on about half of all inputs).

Every product, sum and difference of the model is a float32 numpy
operation, as each of ``_bp_gather``'s is one PyTorch kernel; tanh and
atanh are PyTorch's CPU functions taken at the slot's own place [b, m, r]
of a [B, M, R] array, where ``_bp_gather`` takes them (the CPU's vector
body and scalar tail differ by an ulp; tests/test_torch_bp_plan.py).  On
the card the kernel calls the CUDA functions PyTorch's CUDA kernels call;
the card tests (tests/test_torch_ldpc_cuda.py) hold it to ``_bp_gather``
there.
"""

import functools
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.ops import ldpc as ref_ldpc

from gr_dtl_tpu_torch.ops import ldpc, ldpc_cuda
from test_torch_ldpc import ALISTS, BANK, _H, _bank_vectors, _llrs
from test_torch_ldpc_cuda import gather_tables_of
from test_torch_ldpc_leftovers import DECODE_FAILING_ROWS_PARTED

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("noiseless", "noisy", "shortened", "moderate", "waterfall")
B = 48
f32 = np.float32
BANK_IDS_PARTED = 3  # of 32 rows with ids in [-C-3, C+3], each failing on both sides


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the parallel test run's
    workers otherwise contend for the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def table_row(code_id: int, n_codes: int) -> int:
    """The reference's table row of a code id: jnp indexing of n_codes + 1
    rows (checked against jnp by ``test_id_rule_is_jnp_indexing``)."""
    return min(max(code_id + n_codes + 1 if code_id < 0 else code_id, 0), n_codes)


def gather_model(llr: np.ndarray, graph, max_iters: int = 15, code_idx=None):
    """The kernel's schedule in numpy -> (hard [B, N] int32, iters [B] int32,
    ok [B] bool).  ``graph``: a code's graph, or a bank's graphs (a tuple)
    with ``code_idx`` [B] ids."""
    graphs = graph if isinstance(graph, tuple) else (graph,)
    banked = ldpc_cuda.bank_tables(graphs)
    header, tab = banked.header.numpy(), np.asarray(banked.tab.numpy(), np.int64)
    rows, N = llr.shape
    Mall, R = banked.max_chk, banked.max_dc  # the gather form's [B, M, R] messages
    hard = np.zeros((rows, N), np.int32)
    iters = np.zeros(rows, np.int32)
    ok_out = np.zeros(rows, bool)

    for b in range(rows):
        code = 0 if code_idx is None else max(table_row(int(code_idx[b]), len(graphs)), 1) - 1
        M, E, dv, dc, o_ve, o_ce, o_cv = (int(x) for x in header[code])
        ve = tab[o_ve:o_ve + dv * N].reshape(dv, N)
        ce = tab[o_ce:o_ce + dc * M].reshape(dc, M)
        cv = tab[o_cv:o_cv + dc * M].reshape(dc, M)
        real = ce < E  # [dc, M]: the slots that hold an edge

        def at_slots(fn, x):
            """fn of x [dc, M] at each slot's place [b, m, r] of a [rows, M, R]
            array, as _bp_gather takes it."""
            buf = torch.zeros((rows, Mall, R))
            buf[b, :M, :dc] = torch.as_tensor(x.T)
            return fn(buf)[b, :M, :dc].numpy().T

        c2v = np.zeros(E + 1, f32)  # c2v[E]: the pad's zero
        total = llr[b]  # the first pass reads the LLRs: llr + 0 has their signs
        it = 0
        while True:
            hb = np.append(total < 0, False).astype(np.int64)  # hb[N]: total[N] = 0
            ok = bool((hb[cv].sum(0) % 2 == 0).all())
            if ok or it == max_iters:
                break
            if it == 0:
                total = llr[b] + f32(0.0)  # the first totals: no gather
            old = np.zeros(ce.shape, f32) if it == 0 else c2v[ce]  # the first update reads no message
            v2c = np.where(real, np.append(total, f32(0.0))[cv] - old, f32(0.0))
            t = np.where(real, at_slots(torch.tanh, np.clip(v2c, f32(-20.0), f32(20.0)) * f32(0.5)), f32(1.0))
            prod = t[0]  # the check's product, slots left to right
            for r in range(1, dc):
                prod = prod * t[r]
            safe = np.where(np.abs(t) < f32(1e-12), np.sign(t) * f32(1e-12) + f32(1e-30), t)
            loo = np.clip(prod[None, :] / safe, f32(-0.999999), f32(0.999999))
            c2v[ce[real]] = (f32(2.0) * at_slots(torch.atanh, loo))[real]
            it += 1
            msgs = c2v[ve]  # the totals, slots left to right
            s = msgs[0]
            for d in range(1, dv):
                s = s + msgs[d]
            total = llr[b] + s
        hard[b], iters[b], ok_out[b] = total < 0, it, ok
    return hard, iters, ok_out


def _bit_equal(model, plain):
    for m, p, what in zip(model, plain, ("hard", "iters", "ok")):
        p = p.numpy()
        assert m.dtype == p.dtype, what
        np.testing.assert_array_equal(m, p, err_msg=what)


def _at_reference_bar(got, want, parted_max: int = 0) -> int:
    """tests/test_torch_ldpc_leftovers.py's bar: ok and iterations equal on
    every row, hard bits on every row that converged; returns the rows
    whose hard bits parted."""
    np.testing.assert_array_equal(got[1], want[1], err_msg="iters_used")
    np.testing.assert_array_equal(got[2], want[2], err_msg="ok")
    ok = want[2]
    np.testing.assert_array_equal(got[0][ok], want[0][ok], err_msg="hard of converged rows")
    parted = (got[0] != want[0]).any(1)
    assert parted.sum() <= parted_max, np.nonzero(parted)[0]
    return int(parted.sum())


@functools.lru_cache(maxsize=None)
def _code(name):
    d = ref_ldpc.build_ldpc(_H(name))
    return d, ldpc.ldpc_from_reference(d, "cpu")


@functools.lru_cache(maxsize=None)
def _ref_decode(name):
    d, _ = _code(name)
    return jax.jit(lambda x: ref_ldpc.decode(x, d, 15))


@functools.lru_cache(maxsize=None)
def _bank():
    d = ref_ldpc.build_ldpc_bank([_H(n) for n in BANK])
    return d, ldpc.bank_from_reference(d, "cpu")


@functools.lru_cache(maxsize=None)
def _ref_decode_bank():
    d, _ = _bank()
    return jax.jit(lambda x, c: ref_ldpc.decode_bank(x, c, d, 15))


def _vectors(name, kind):
    """tests/test_torch_ldpc_leftovers.py's decode inputs for this code and kind."""
    d, code = _code(name)
    rng = np.random.RandomState(len(kind) + len(name))
    msgs = rng.randint(0, 2, (B, code.K)).astype(np.float32)
    if kind == "shortened":
        msgs[:, code.K - 9:] = 0
    cw = np.asarray(ref_ldpc.encode(jnp.asarray(msgs), d)).astype(np.float64)
    return _llrs(kind, cw, code.M, rng)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ALISTS)
def test_model_equals_plain_and_reference(name, kind):
    _, code = _code(name)
    llr = _vectors(name, kind)
    got = gather_model(llr, code.graph)
    _bit_equal(got, ldpc.decode(torch.as_tensor(llr), code))
    want = [np.asarray(v) for v in _ref_decode(name)(jnp.asarray(llr))]
    _at_reference_bar(got, want, DECODE_FAILING_ROWS_PARTED.get((name, kind), 0))
    if kind == "noiseless":  # done at entry: no update
        assert got[2].all() and got[1].max() == 0
    if kind == "waterfall":  # the rows stop at many counts
        assert len(np.unique(got[1])) >= 3


@pytest.mark.parametrize("sigma", [0.9, 2.4])
def test_model_bank(sigma):
    """decode_bank's schedule: one pass over the two-code bank, every row
    with its own code's tables; bit-equal to _bp_gather, and to the
    reference's decode_bank exactly (tests/test_torch_ldpc.py's bar)."""
    d, bank = _bank()
    llr, code_idx = _bank_vectors(d, 32, 5, sigma)
    got = gather_model(llr, bank.graphs, code_idx=code_idx)
    _bit_equal(got, ldpc.decode_bank(torch.as_tensor(llr), torch.as_tensor(code_idx), bank))
    want = [np.asarray(v) for v in _ref_decode_bank()(jnp.asarray(llr), jnp.asarray(code_idx))]
    for g, w, what in zip(got, want, ("hard", "iters_used", "ok")):
        np.testing.assert_array_equal(g, w, err_msg=what)
    assert sigma < 2 or got[1].max() == 15  # sigma = 2.4 iterates to the cap


@pytest.mark.parametrize("max_iters", [0, 1])
def test_model_few_iterations(max_iters):
    """max_iters = 0: the syndrome of the channel LLRs alone, no update;
    1: one update, then the syndrome of its totals."""
    name = "n_0100_k_0027.alist"
    d, code = _code(name)
    llr = _vectors(name, "moderate")
    got = gather_model(llr, code.graph, max_iters=max_iters)
    _bit_equal(got, ldpc.decode(torch.as_tensor(llr), code, max_iters))
    want = [np.asarray(v) for v in jax.jit(lambda x: ref_ldpc.decode(x, d, max_iters))(jnp.asarray(llr))]
    for g, w, what in zip(got, want, ("hard", "iters_used", "ok")):
        np.testing.assert_array_equal(g, w, err_msg=what)
    assert got[1].max() == max_iters and not got[2].all()


def test_id_rule_is_jnp_indexing():
    """ldpc._bank_rows, and the model's rule, are jnp's indexing of C + 1
    table rows for ids far past either end: a negative id counts from the
    end once, then clamps."""
    for C in (1, 2, 5):
        ids = np.arange(-2 * C - 4, 2 * C + 5)
        want = np.asarray(jax.jit(lambda i: jnp.arange(C + 1)[i])(jnp.asarray(ids)))
        for dtype in (torch.int32, torch.int64):
            got = ldpc._bank_rows(torch.as_tensor(ids, dtype=dtype), C)
            np.testing.assert_array_equal(got.numpy(), want)
        assert [table_row(int(i), C) for i in ids] == want.tolist()


def test_decode_bank_ids_follow_reference(monkeypatch):
    """decode_bank with ids in [-C-3, C+3] against the reference's jitted
    decode_bank: each row decodes with the code the reference's indexing
    picks (row 0, and any id past the ends, a real code), and the model
    with the same ids equals _bp_gather bit for bit.  Rows that decode with
    the other code's tables never converge, and the hard bits of
    ``BANK_IDS_PARTED`` of them part from the reference's by its float32
    tanh and atanh (the witness below), as ``DECODE_FAILING_ROWS_PARTED``'s
    do by its tanh."""
    d, bank = _bank()
    C = bank.n_codes
    llr, _ = _bank_vectors(d, 32, 5, 0.9)
    ids = np.random.RandomState(3).randint(-C - 3, C + 4, 32).astype(np.int32)
    ids[:2 * C + 7] = np.arange(-C - 3, C + 4)  # every id of the range
    want = [np.asarray(v) for v in _ref_decode_bank()(jnp.asarray(llr), jnp.asarray(ids))]
    for dtype in (torch.int32, torch.int64):
        got = [v.numpy() for v in ldpc.decode_bank(torch.as_tensor(llr), torch.as_tensor(ids, dtype=dtype), bank)]
        _at_reference_bar(got, want, BANK_IDS_PARTED)
    _bit_equal(gather_model(llr, bank.graphs, code_idx=ids),
               ldpc.decode_bank(torch.as_tensor(llr), torch.as_tensor(ids), bank))
    assert 0 < want[2].sum() < 32  # rows decoded with their own code pass, some with the other code fail
    # the parted rows part through float32 tanh and atanh alone: with XLA's, every output of every
    # row is equal (with XLA's tanh alone, one row still parts)
    for fn, xla in (("tanh", jax.jit(jnp.tanh)), ("atanh", jax.jit(jnp.arctanh))):
        monkeypatch.setattr(torch, fn, lambda x, xla=xla: torch.as_tensor(np.array(xla(x.numpy()))))
    got = ldpc.decode_bank(torch.as_tensor(llr), torch.as_tensor(ids), bank)
    for g, w, what in zip(got, want, ("hard", "iters_used", "ok")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)


# ---------------------------------------------------------------------------
# the gather tables are K3's
# ---------------------------------------------------------------------------

def _gather_tables_onto_kernel(chk_adj, var_edges, rev, graph, banked, code: int):
    """Every slot of the gather tables (chk_adj [M, R], var_edges [N, D, 2],
    rev [M, R, 2]) is an edge of the kernel's tables of ``code`` in the
    kernel's order, one to one, and every pad a pad."""
    header, tab = banked.header.numpy(), banked.tab.numpy().astype(np.int64)
    N = banked.n_var
    M, E, dv, dc, o_ve, o_ce, o_cv = (int(x) for x in header[code])
    ve = tab[o_ve:o_ve + dv * N].reshape(dv, N)
    ce = tab[o_ce:o_ce + dc * M].reshape(dc, M)
    cv = tab[o_cv:o_cv + dc * M].reshape(dc, M)
    Mg, R = chk_adj.shape
    assert Mg == M and R == dc and E == graph.n_edge
    # a check's slot r is the kernel's slot r of that check: the same variable, a real edge
    real = chk_adj >= 0
    np.testing.assert_array_equal(ce.T < E, real)
    np.testing.assert_array_equal(np.where(real, cv.T, -1), chk_adj)
    edge = np.where(real, ce.T, -1)  # [M, R]: the kernel's edge of each gather slot
    assert sorted(edge[real].tolist()) == list(range(E))  # one to one onto the edges
    # a variable's slot d is the kernel's slot d: the same edge, in the same order
    D = var_edges.shape[1]
    assert D >= dv
    vreal = var_edges[..., 0] >= 0
    np.testing.assert_array_equal(vreal[:, :dv], ve.T < E)
    assert not vreal[:, dv:].any()  # slots past the kernel's are pads
    m, r = np.where(vreal, var_edges[..., 0], 0), np.where(vreal, var_edges[..., 1], 0)
    np.testing.assert_array_equal(np.where(vreal, edge[m, r], E)[:, :dv], ve.T)
    # rev names each real check slot's (variable, variable slot)
    v, s = rev[..., 0], rev[..., 1]
    np.testing.assert_array_equal(np.where(real, ve[np.where(real, s, 0), np.where(real, v, 0)], -1), edge)
    np.testing.assert_array_equal(np.where(real, cv.T, -1), np.where(real, v, -1))


def test_gather_tables_map_onto_kernel_tables():
    for name in ALISTS:
        _, code = _code(name)
        banked = ldpc_cuda.bank_tables((code.graph,))
        _gather_tables_onto_kernel(*(t.numpy() for t in (code.chk_adj, code.var_edges, code.rev)), code.graph,
                                   banked, 0)
    _, bank = _bank()
    banked = ldpc_cuda.bank_tables(bank.graphs)
    for c in range(bank.n_codes + 1):  # row 0 is code 1's
        g = max(c, 1) - 1
        _gather_tables_onto_kernel(*(t[c].numpy() for t in (bank.chk_adj, bank.var_edges, bank.rev)),
                                   bank.graphs[g], banked, g)


def test_gather_tables_of_rebuilds_a_codes_tables():
    """The card tests' gather_tables_of (gather tables of any graph, for the
    quasi-cyclic codes) rebuilds each shipped code's own tables."""
    for name in ALISTS:
        _, code = _code(name)
        for got, want in zip(gather_tables_of(code.graph), (code.chk_adj, code.var_edges, code.rev)):
            assert torch.equal(got, want), name


# ---------------------------------------------------------------------------
# ops/ldpc_cuda's host side of K8
# ---------------------------------------------------------------------------

def test_bytes_and_ops_by_hand():
    g = _code("n_0300_k_0152.alist")[1].graph
    # two codewords taking 0 and 3 updates: 1 + 4 passes of 2 x 900 + 300, 3 updates of 16 x 900
    it = torch.tensor([0, 3], dtype=torch.int32)
    assert ldpc_cuda.bp_ops(it, g, ldpc_cuda.GATHER_UPDATE_OPS_PER_EDGE) == 5 * 2100 + 3 * 14400 == 53_700
    assert ldpc_cuda.GATHER_UPDATE_OPS_PER_EDGE == 16 < ldpc_cuda.UPDATE_OPS_PER_EDGE


def test_source_matches_the_wrapper():
    """K8 has its own C entry point (``bp_gather_launch``: the wrapper's 19
    arguments, the staged tables' room and the stream's counters among them)
    beside K3's, shares ``bp_resident_codewords`` by its form (the wrapper's
    ``GATHER_FORM``), launches a wave of resident blocks that walk the
    codewords where B fills ``WALK_WAVES`` waves (else B blocks, no
    counter), takes the shared memory the wrapper's ``gather_smem_bytes`` counts (a
    row buffer of ``row_stride`` floats, the totals, messages and next
    codeword, and the code's tables staged in rooms of ``staged_words``), and
    the guard's and clamp's constants are the plain version's scalars."""
    src = ldpc_cuda.SOURCE.read_text()
    sig = re.search(r'extern "C" int bp_decode_launch\(([^)]*)\)', src).group(1)
    assert len(sig.split(",")) == 19 and "int form" in sig
    sig = [a.split()[-1] for a in re.search(r'extern "C" int bp_gather_launch\(([^)]*)\)', src).group(1).split(",")]
    assert len(sig) == 19 and sig[12:14] == ["cm", "vn"] and sig[-2:] == ["work", "stream"]
    sig = re.search(r'extern "C" int bp_resident_codewords\(([^)]*)\)', src).group(1).split(",")
    assert [a.split()[-1] for a in sig] == ["N", "max_e", "dc", "warps", "form", "cm", "vn"]
    assert f"constexpr int kGatherForm = {ldpc_cuda.GATHER_FORM};" in src
    assert "const int grid = B < kWalkWaves * wave ? B : wave;" in src
    assert f"constexpr int kWalkWaves = {ldpc_cuda.WALK_WAVES};" in src
    assert "return gridDim.x + (int)atomicAdd(work, 1u);" in src and "const bool walk = B > (int)gridDim.x;" in src
    assert "int row_stride(int N) { return (N + 4) & ~3; }" in src
    assert "int staged_words(int n) { return (n + 3) & ~1; }" in src
    assert all(ldpc_cuda.row_stride(n) == (n + 4) // 4 * 4 and ldpc_cuda.staged_words(n) == n + 3 - (n + 3) % 2
               for n in range(1, 40))
    assert "4LL * (row_stride(N) + N + E + 4) + 2LL * (2LL * staged_words(cm) + staged_words(vn))" in src
    # n = 300: a row buffer of 304 floats, 301 totals, 901 messages, 2 next codewords; 2 x 1,038 and 902 int16
    assert ldpc_cuda.gather_smem_bytes(300, 900, 7 * 148, 3 * 300) == 4 * (304 + 301 + 901 + 2) + 2 * (2 * 1038 + 902)
    banked = ldpc_cuda.bank_tables((_code("n_0300_k_0152.alist")[1].graph,))
    assert (banked.max_chk_slots, banked.max_var_slots) == (7 * 148, 3 * 300)
    assert "constexpr int kGatherRegs = 56;" in src  # 7 blocks of 5 warps an SM: 65,536 / (7 x 160) = 58.5
    for const, value in (("kTiny", "1e-12"), ("kTinier", "1e-30"), ("kLooMax", "0.999999")):
        assert re.search(rf"constexpr float {const} = \(float\){re.escape(value)};", src), const
    assert "template <int kSlots>\n__global__" in src and "bp_gather_kernel(" in src


class Trapped(Exception):
    """The model's ``__trap()``: the walk's counts at the end were not a
    clean walk's."""


def block_walk(B: int, grid: int, rng: np.random.RandomState, static: bool = False, work=None) -> tuple:
    """A numpy model of K8's walk over codewords: ``min(B, grid)`` blocks,
    block g starting at codeword g, each taking its next one from the
    counter past the grid (``take``: grid + counter, counter + 1; with
    ``static``, the codeword a grid further on) at a codeword's start, or,
    after a codeword that took updates (drawn from ``rng``), at its end; a
    block leaves once its next is past B, adding the codewords it decoded
    to the third counter and then one to the second; the blocks run in an
    order drawn from ``rng``, a step at a time (a codeword's start or its
    end).  A block that leaves after the grid's blocks have, or the last
    block to leave finding other than B taken and B decoded, traps
    (:class:`Trapped`); else the last sets the counters back to 0.
    ``work``: the counters at the launch (0 unless given).  Returns (every
    codeword each block decoded, in order; the counters at the end)."""
    G = min(B, grid)
    work = list(work or [0, 0, 0])

    def take(b):
        if static:
            return b + G
        work[0] += 1
        return G + work[0] - 1

    cur = list(range(G))
    done = [[] for _ in range(G)]
    early = [True] * G  # the block's last codeword took no update
    started = [None] * G  # the next taken at the current codeword's start, or None
    running = list(range(G))
    while running:
        i = rng.randint(len(running))
        g = running[i]
        if started[g] is None and early[g]:  # the codeword's start: take now
            started[g] = take(cur[g])
            continue
        nb = started[g] if early[g] else take(cur[g])  # else at its end
        done[g].append(cur[g])
        early[g], started[g] = bool(rng.randint(2)), None
        if nb >= B:  # the block leaves
            running[i] = running[-1]
            running.pop()
            if static:
                continue
            work[2] += len(done[g])
            left, work[1] = work[1], work[1] + 1
            if left >= G:
                raise Trapped(f"block {g} left as the {left + 1}th of {G}")
            if left == G - 1:
                if work[0] != B or work[2] != B:
                    raise Trapped(f"taken {work[0]}, decoded {work[2]}, of {B}")
                work = [0, 0, 0]
        else:
            cur[g] = nb
    return done, work


@pytest.mark.parametrize("B, grid", [(1, 924), (7, 924), (923, 924), (924, 924), (925, 924), (13312, 924),
                                     (5000, 1), (300, 37)])
def test_block_walk_decodes_every_codeword_once(B, grid):
    """Whatever order the blocks run in, every codeword is decoded exactly
    once, by blocks that walk upward from their own first codeword, and the
    counters end at 0 for the stream's next launch; the same holds for a
    static stride."""
    for seed in range(3):
        for static in (False, True):
            walks, work = block_walk(B, grid, np.random.RandomState(seed), static)
            assert sorted(b for w in walks for b in w) == list(range(B)), (seed, static)
            assert all(w[0] == g and w == sorted(w) for g, w in enumerate(walks))
            assert work == [0, 0, 0]
            if static:
                assert all(w == list(range(g, B, min(B, grid))) for g, w in enumerate(walks))


@pytest.mark.parametrize("work", [[1, 0, 0], [5, 0, 0], [0, 1, 0], [0, 36, 0], [0, 37, 0], [0, 0, 1],
                                  [0, 0, 299]])
def test_block_walk_traps_on_counters_not_at_zero(work):
    """A walk launched on counters left other than 0 (say, zeroed only
    inside a CUDA graph that never ran) skips codewords or finds its last
    block early; whichever counter it is, and whatever order the blocks run
    in, the walk traps instead of returning unwritten outputs.  Counters
    that a walk past the grid's first codewords takes (a count of taken
    codewords) leave the taken and decoded counts equal at B, so it is the
    third count, of codewords decoded, that sees them."""
    for seed in range(4):
        with pytest.raises(Trapped):
            block_walk(300, 37, np.random.RandomState(seed), work=work)


def test_walk_counters_match_the_source():
    """The wrapper's counters are the source's three (taken, blocks left,
    decoded), and the source's last block checks them against B before it
    sets them back to 0."""
    src = ldpc_cuda.SOURCE.read_text()
    assert ldpc_cuda.WORK_COUNTERS == 3
    assert "atomicAdd(work + 2, (unsigned)k);" in src and "if (left >= gridDim.x) __trap();" in src
    assert "if (atomicAdd(work, 0u) != (unsigned)B || atomicAdd(work + 2, 0u) != (unsigned)B) __trap();" in src
    assert "work[0] = 0;\n            work[1] = 0;\n            work[2] = 0;" in src


def test_walk_counters_refuse_a_capture(monkeypatch):
    """A stream's counters are made (and zeroed) by its first launch, which
    may not be captured into a CUDA graph: the wrapper raises rather than
    let the zeroing run only inside the graph; a stream that has its
    counters takes them, captured or not."""
    stream = types.SimpleNamespace(device=torch.device("cpu"), cuda_stream=0x5EED)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        ldpc_cuda._work(stream)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    work = ldpc_cuda._work(stream)
    try:
        assert work.tolist() == [0] * ldpc_cuda.WORK_COUNTERS and work.dtype == torch.int32
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        assert ldpc_cuda._work(stream) is work
    finally:
        del ldpc_cuda._WORK[(None, 0x5EED)]


def stage_table(src: np.ndarray, off: int, n: int, room: int) -> tuple:
    """A numpy model of K8's ``stage_table``: the n int16 entries of a table
    at ``off`` in the int16 array ``src`` into a room of ``room`` entries
    (on 4 bytes), as the kernel copies them: the 4-byte words from the one
    that holds the first entry (the one before it too, where ``off`` is odd)
    to the last whole one, and an odd last entry alone.  Returns (the room,
    where the table starts in it, every index of ``src`` read)."""
    shift = off & 1
    dst = np.full(room, -7, np.int64)
    read = []
    for w in range((n + shift) >> 1):  # a copy4 a word
        dst[2 * w:2 * w + 2] = src[off - shift + 2 * w:off - shift + 2 * w + 2]
        read += [off - shift + 2 * w, off - shift + 2 * w + 1]
    if (n + shift) & 1:  # the odd last entry
        dst[n + shift - 1] = src[off + n - 1]
        read.append(off + n - 1)
    return dst, shift, read


@pytest.mark.parametrize("n", [1, 2, 7, 148 * 7, 300 * 3])
def test_staged_table_copies_every_entry_once(n):
    """Every entry of a table reaches the room once, at either parity of its
    offset, within ``staged_words(n)`` of room; the copy reads nothing past
    the table's last entry and, before its first, only the entry that
    shares its word (never before the array)."""
    room = ldpc_cuda.staged_words(n)
    src = np.arange(2 * n + 9)
    for off in (0, 1, 2, 3, n + 5):
        dst, shift, read = stage_table(src, off, n, room)
        assert n + shift <= room
        np.testing.assert_array_equal(dst[shift:shift + n], src[off:off + n])
        assert sorted(read) == list(range(off - shift, off + n)) and min(read) >= 0


def test_staged_tables_of_the_shipped_codes():
    """The shipped codes' tables, alone and in the two-code bank, staged by
    the model, equal the tables the kernel would read from global memory,
    in rooms of the sizes the wrapper gives the launch (``max_chk_slots``,
    ``max_var_slots``); their offsets take both parities."""
    _, bank = _bank()
    parities = set()
    for graphs in [(_code(name)[1].graph,) for name in ALISTS] + [bank.graphs]:
        banked = ldpc_cuda.bank_tables(graphs)
        parities |= {o & 1 for row in banked.header.tolist() for o in row[4:]}
        tab, N = banked.tab.numpy().astype(np.int64), banked.n_var
        for M, E, dv, dc, o_ve, o_ce, o_cv in banked.header.tolist():
            for off, n, room in ((o_cv, dc * M, banked.max_chk_slots), (o_ce, dc * M, banked.max_chk_slots),
                                 (o_ve, dv * N, banked.max_var_slots)):
                assert n <= room
                dst, shift, _ = stage_table(tab, off, n, ldpc_cuda.staged_words(room))
                np.testing.assert_array_equal(dst[shift:shift + n], tab[off:off + n])
    assert parities == {0, 1}


def test_no_codeword_no_walk():
    """B = 0: the model has no block, and the wrapper launches nothing (held
    on the card by tests/test_torch_ldpc_cuda.py); its checks still run here
    and refuse a CPU tensor before any launch."""
    assert block_walk(0, 924, np.random.RandomState(0)) == ([], [0, 0, 0])
    code = _code("n_0100_k_0027.alist")[1]
    with pytest.raises(ValueError, match="needs CUDA"):
        ldpc_cuda.bp_gather_cuda(torch.zeros((0, code.N)), code.graph)


def test_wrapper_refuses():
    code = _code("n_0100_k_0027.alist")[1]
    _, bank = _bank()
    n0 = ldpc_cuda.bp_gather_cuda.LAUNCHES
    x = torch.zeros((4, code.N))
    with pytest.raises(ValueError, match="float32"):
        ldpc_cuda.bp_gather_cuda(x.double(), code.graph)
    with pytest.raises(ValueError, match="float32"):
        ldpc_cuda.bp_gather_cuda(torch.zeros((4, code.N + 1)), code.graph)
    with pytest.raises(ValueError, match="contiguous"):
        ldpc_cuda.bp_gather_cuda(torch.zeros((code.N, 4)).T, code.graph)
    with pytest.raises(ValueError, match="bp_gather_cuda needs CUDA"):
        ldpc_cuda.bp_gather_cuda(x, code.graph)
    y, idx = torch.zeros((4, bank.Nmax)), torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="code_idx goes with"):
        ldpc_cuda.bp_gather_cuda(y, bank.graphs)
    for bad in (idx.float(), idx.to(torch.int16), torch.ones(5, dtype=torch.int32)):
        with pytest.raises(ValueError, match="code_idx must be"):
            ldpc_cuda.bp_gather_cuda(y, bank.graphs, code_idx=bad)
    with pytest.raises(ValueError, match="CUDA"):
        ldpc_cuda.bp_gather_cuda(y, bank.graphs, code_idx=idx)
    assert ldpc_cuda.bp_gather_cuda.LAUNCHES == n0


def test_cpu_decoders_take_the_plain_version(monkeypatch):
    """On CPU tensors decode and decode_bank run _bp_gather, never K8's
    wrapper, and build nothing."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA wrapper was called on the CPU")

    monkeypatch.setattr(ldpc_cuda, "bp_gather_cuda", refuse)
    name = "n_0300_k_0152.alist"
    _, code = _code(name)
    llr = torch.as_tensor(_vectors(name, "moderate"))
    for a, b in zip(ldpc.decode(llr, code), ldpc._bp_gather(llr, code.chk_adj, code.var_edges, code.rev, 15)):
        assert torch.equal(a, b)
    d, bank = _bank()
    x, idx = _bank_vectors(d, 8, 3)
    ldpc.decode_bank(torch.as_tensor(x), torch.as_tensor(idx), bank)
    assert ldpc_cuda.build.cache_info().currsize == 0


def test_module_imports_without_nvcc():
    """ops/ldpc_cuda imports with no nvcc on the PATH nor under CUDA_HOME,
    and K8's count starts at 0."""
    code = ("from gr_dtl_tpu_torch.ops import ldpc_cuda; "
            "assert ldpc_cuda.bp_gather_cuda.LAUNCHES == 0 and ldpc_cuda.bp_decode_cuda.LAUNCHES == 0; "
            "assert ldpc_cuda.build.cache_info().currsize == 0; print('ok')")
    env = {"PATH": str(Path(sys.executable).parent), "CUDA_HOME": "/nonexistent", "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
