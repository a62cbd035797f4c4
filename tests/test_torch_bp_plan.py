"""K3's plan on the CPU: a numpy model of ``csrc/ldpc_bp.cu``'s own schedule
held to the port's plain BP (``ops/ldpc.py::_bp``) and to the reference's
``decode_mm`` / ``decode_bank_mm``, and the host side of ``ops/ldpc_cuda``.

The model decodes as the kernel does: a codeword at a time, with its own
code's slot-major int16 tables found through the header of
``ldpc_cuda.bank_tables`` (pads read a zero kept at index E, or N).  The
first totals are the LLRs plus 0, with no gather; the first update reads
no message.  The update goes a check at a time: the check's slots' v2c,
tanh and log, its sums added left to right from slot 0, then each edge's
leave-one-out message; the totals add their slots left to right too.  A
codeword's loop ends at its own syndrome pass (or after ``max_iters``
updates; a row marked done takes none), and a bank's rows each take their
own code (``clamp(code_idx, 1, C) - 1``) in one pass.  It must equal
``_bp`` bit for bit (hard bits, iterations, ok and the final totals) and
the reference in hard bits, iterations and ok, on the inputs of
tests/test_torch_ldpc.py: noiseless, noisy, shortened, moderate and
waterfall vectors of all three alists, the two-code bank (one pass with
code ids, and the ``done`` mask), the bfloat16 switch and ``max_iters = 0``;
and to ``_bp`` alone on rows wider than the kernel unrolls: regular
quasi-cyclic codes of row degree 12 and 64, and a bank of row degrees 6
and 12.

Every sum and difference of the model is a float32 numpy operation, as
each of ``_bp``'s is one PyTorch kernel.  tanh, log, exp and atanh are
PyTorch's CPU functions: the CPU's atanh takes another path on the last
elements of an array than on the rest (its vector body and its scalar
tail differ by an ulp), so the model takes each function at the edge's
own place in a [B, E] array, where ``_bp`` takes it.  On the card the
kernel calls the CUDA functions PyTorch's CUDA kernels call; the card
tests (tests/test_torch_ldpc_cuda.py) hold it to ``_bp`` there.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.ops import ldpc as ref_ldpc

from gr_dtl_tpu_torch.ops import ldpc, ldpc_cuda
from gr_dtl_tpu_torch.tools import _ldpc_bench
from test_torch_ldpc import ALISTS, BANK, _H, _bank_vectors, _llrs

KINDS = ("noiseless", "noisy", "shortened", "moderate", "waterfall")
B = 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the parallel test run's
    workers otherwise contend for the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _at(fn, x: np.ndarray, b: int, rows: int) -> np.ndarray:
    """fn of the float32 vector x taken at row b of a [rows, len(x)] array."""
    buf = torch.zeros((rows, x.shape[0]))
    buf[b] = torch.as_tensor(x)
    return fn(buf)[b].numpy()


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.as_tensor(x).to(torch.bfloat16).float().numpy()


def bp_model(llr: np.ndarray, graph, max_iters: int = 15, done=None, bf16: bool = False, code_idx=None):
    """The kernel's schedule in numpy -> (hard [B, N] int32, iters [B] int32,
    ok [B] bool, totals [B, N] float32).  ``graph``: a graph, or a bank's
    graphs (a tuple) with ``code_idx`` [B] 1-based ids."""
    graphs = graph if isinstance(graph, tuple) else (graph,)
    banked = ldpc_cuda.bank_tables(graphs)
    header, tab = banked.header.numpy(), np.asarray(banked.tab.numpy(), np.int64)
    rows, N = llr.shape
    rnd = _bf16 if bf16 else (lambda x: x)
    f32 = np.float32
    hard = np.zeros((rows, N), np.int32)
    iters = np.zeros(rows, np.int32)
    ok_out = np.zeros(rows, bool)
    totals = np.zeros((rows, N), np.float32)

    for b in range(rows):
        code = 0 if code_idx is None else min(max(int(code_idx[b]), 1), len(graphs)) - 1
        M, E, dv, dc, o_ve, o_ce, o_cv = (int(x) for x in header[code])
        ve = tab[o_ve:o_ve + dv * N].reshape(dv, N)
        ce = tab[o_ce:o_ce + dc * M].reshape(dc, M)
        cv = tab[o_cv:o_cv + dc * M].reshape(dc, M)
        real = ce < E  # [dc, M]: the slots that hold an edge

        def at_edges(fn, x):
            """fn of each real slot of x [dc, M] at its edge's place in a
            [rows, E] array, as _bp takes it; pads 0."""
            flat = np.zeros(E, f32)
            flat[ce[real]] = x[real]
            y = np.zeros(x.shape, f32)
            y[real] = _at(fn, flat, b, rows)[ce[real]]
            return y

        c2v = np.zeros(E + 1, f32)  # c2v[E]: the pad's zero
        total = llr[b] + f32(0.0)  # the first totals: no gather
        it, ok = 0, True
        while done is None or not done[b]:
            hb = np.append(total < 0, False).astype(np.int64)  # hb[N]: total[N] = 0
            ok = bool((hb[cv].sum(0) % 2 == 0).all())
            if ok or it == max_iters:
                break
            # a check at a time: its slots' v2c, tanh and log (the first update reads no message)
            old = np.zeros(ce.shape, f32) if it == 0 else c2v[ce]
            v2c = np.where(real, rnd(np.append(total, f32(0.0)))[cv] - old, f32(0.0))
            t = at_edges(torch.tanh, np.clip(v2c, f32(-20.0), f32(20.0)) * f32(0.5))
            mag = at_edges(torch.log, np.maximum(np.abs(t), f32(1e-12)))
            neg = real & (t < 0)
            s = rnd(mag[0])  # the check's sum, slots left to right
            for r in range(1, dc):
                s = s + rnd(mag[r])
            m = at_edges(torch.exp, rnd(s)[None, :] - mag)
            odd = (neg.sum(0)[None, :] - neg) % 2 == 1
            loo = np.clip(np.where(odd, -m, m), f32(-0.999999), f32(0.999999)).astype(f32)
            c2v[ce[real]] = (f32(2.0) * at_edges(torch.atanh, loo))[real]
            it += 1
            msgs = rnd(c2v)[ve]  # the totals, slots left to right
            s = msgs[0]
            for d in range(1, dv):
                s = s + msgs[d]
            total = llr[b] + s
        hard[b], iters[b], ok_out[b], totals[b] = total < 0, it, ok, total
    return hard, iters, ok_out, totals


def _assert_bit_equal(model, plain):
    for m, p, what in zip(model, plain, ("hard", "iters", "ok", "totals")):
        p = p.numpy()
        assert m.dtype == p.dtype, what
        np.testing.assert_array_equal(m, p, err_msg=what)
    assert np.array_equal(model[3].view(np.int32), plain[3].numpy().view(np.int32)), "totals' bits"


@functools.lru_cache(maxsize=None)
def _code(name):
    d = ref_ldpc.build_ldpc(_H(name))
    return d, ldpc.ldpc_from_reference(d, "cpu")


@functools.lru_cache(maxsize=None)
def _ref_decode_mm(name):
    d, _ = _code(name)
    return jax.jit(lambda x: ref_ldpc.decode_mm(x, d, 15))


def _vectors(name, kind):
    """tests/test_torch_ldpc.py's decoder inputs for this code and kind."""
    d, code = _code(name)
    rng = np.random.RandomState(len(kind))
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
    got = bp_model(llr, code.graph)
    _assert_bit_equal(got, ldpc._bp(torch.as_tensor(llr), code.graph, 15))
    want = [np.asarray(v) for v in _ref_decode_mm(name)(jnp.asarray(llr))]
    for g, w, what in zip(got, want, ("hard", "iters_used", "ok")):
        np.testing.assert_array_equal(g, w, err_msg=what)
    if kind == "waterfall":  # the rows stop at many counts, n = 300's some never
        assert len(np.unique(got[1])) >= 3
        assert name != "n_0300_k_0152.alist" or (0 < got[2].mean() < 1 and got[1].max() == 15)


@functools.lru_cache(maxsize=None)
def _bank():
    d = ref_ldpc.build_ldpc_bank([_H(n) for n in BANK])
    return d, ldpc.bank_from_reference(d, "cpu")


@pytest.mark.parametrize("sigma", [0.9, 2.4])
def test_model_bank_with_done_mask(sigma):
    """decode_bank_mm's schedule: one pass over the mixed bank, every row
    with its own code.  Each row equals _bp of its code with the other
    codes' rows marked done (the CPU path), bit for bit, and the whole
    equals the reference's decode_bank_mm.  Ids out of range clamp, as the
    reference's do.  The done mask alone, on each code's graph, equals
    _bp's with the same mask (decode_mm's callers use it)."""
    d, bank = _bank()
    llr, code_idx = _bank_vectors(d, 32, 5, sigma)
    got = bp_model(llr, bank.graphs, code_idx=code_idx)
    want = [np.asarray(v) for v in jax.jit(lambda x, c: ref_ldpc.decode_bank_mm(x, c, d, 15))(
        jnp.asarray(llr), jnp.asarray(code_idx))]
    for g, w, what in zip(got, want, ("hard", "iters_used", "ok")):
        np.testing.assert_array_equal(g, w, err_msg=what)
    assert sigma < 2 or got[1].max() > 0  # the sigma = 2.4 rows take updates
    wild = code_idx.copy()
    wild[:3] = (0, 3, -7)  # clamp to codes 1, 2 and 1
    sel = np.clip(wild, 1, bank.n_codes) - 1
    got = bp_model(llr, bank.graphs, code_idx=wild)
    for ci, g in enumerate(bank.graphs):
        mine = sel == ci
        plain = ldpc._bp(torch.as_tensor(llr), g, 15, done=torch.as_tensor(~mine))
        _assert_bit_equal([v[mine] for v in got], [v[torch.as_tensor(mine)] for v in plain])
        masked = bp_model(llr, g, done=~mine)
        _assert_bit_equal(masked, plain)
        assert (masked[1][~mine] == 0).all() and masked[2][~mine].all()  # marked rows take no update
        np.testing.assert_array_equal(masked[3][~mine], llr[~mine] + np.float32(0.0))  # and keep the LLRs


@pytest.mark.parametrize("kind", ["noiseless", "moderate", "waterfall"])
def test_model_bf16(monkeypatch, kind):
    """With the bfloat16 switch the model equals _bp(bf16=True) bit for bit;
    where the reference's bf16 decode_mm is exact (the clean regimes of
    tests/test_torch_ldpc_leftovers.py) it equals that too."""
    name = "n_0300_k_0152.alist"
    d, code = _code(name)
    llr = _vectors(name, kind)
    got = bp_model(llr, code.graph, bf16=True)
    _assert_bit_equal(got, ldpc._bp(torch.as_tensor(llr), code.graph, 15, bf16=True))
    f32 = bp_model(llr, code.graph)
    if kind == "noiseless":
        monkeypatch.setenv("GR_DTL_TPU_BP_BF16", "1")
        want = [np.asarray(v) for v in jax.jit(lambda x: ref_ldpc.decode_mm(x, d, 15))(jnp.asarray(llr))]
        for g, w, what in zip(got, want, ("hard", "iters_used", "ok")):
            np.testing.assert_array_equal(g, w, err_msg=what)
    else:  # the switch changes the numerics
        assert not np.array_equal(got[3], f32[3])


def test_model_max_iters_zero():
    """max_iters = 0: the syndrome of the channel LLRs alone, no update."""
    _, code = _code("n_0100_k_0027.alist")
    llr = _vectors("n_0100_k_0027.alist", "moderate")
    got = bp_model(llr, code.graph, max_iters=0)
    _assert_bit_equal(got, ldpc._bp(torch.as_tensor(llr), code.graph, 0))
    assert (got[1] == 0).all()


def _qc(dc: int, z: int):
    """A regular quasi-cyclic code of column degree 3 and row degree dc."""
    return ldpc._graph(_ldpc_bench.qc_parity(3, dc, z), "cpu")


@pytest.mark.parametrize("dc, z", [(12, 16), (64, 8)])
def test_model_wide_rows(dc, z):
    """Rows wider than the kernel's unrolled slots (kRegSlots = 8), which
    its guarded instantiation decodes: the model equals _bp bit for bit,
    bf16 too."""
    g = _qc(dc, z)
    assert g.chk_edges.shape[1] == dc > ldpc_cuda.REG_SLOTS
    llr = _ldpc_bench.zero_word_llrs(B, g.n_var, dc)
    for bf16 in (False, True):
        got = bp_model(llr, g, bf16=bf16)
        _assert_bit_equal(got, ldpc._bp(torch.as_tensor(llr), g, 15, bf16=bf16))
        assert 0 < got[1].max()  # rows take updates


def test_model_wide_bank():
    """A bank whose widest rows (12) are past the unrolled slots, beside a
    code of row degree 6 padded to them in the bank's tables: one pass with
    code ids equals _bp of each row's own code bit for bit."""
    graphs = (_qc(6, 32), _qc(12, 16))  # N = 192 each
    banked = ldpc_cuda.bank_tables(graphs)
    assert banked.max_dc == 12 and banked.header[:, 3].tolist() == [12, 12]
    llr = _ldpc_bench.zero_word_llrs(B, 192, 7)
    code_idx = np.random.RandomState(8).randint(0, 4, B)  # 0 and 3 clamp to codes 1 and 2
    got = bp_model(llr, graphs, code_idx=code_idx)
    sel = np.clip(code_idx, 1, 2) - 1
    for ci, g in enumerate(graphs):
        mine = sel == ci
        plain = ldpc._bp(torch.as_tensor(llr), g, 15, done=torch.as_tensor(~mine))
        _assert_bit_equal([v[mine] for v in got], [v[torch.as_tensor(mine)] for v in plain])


# ---------------------------------------------------------------------------
# ops/ldpc_cuda's host side
# ---------------------------------------------------------------------------

def _graphs():
    out = {name: _code(name)[1].graph for name in ALISTS}
    out.update({f"bank code {i + 1}": g for i, g in enumerate(_bank()[1].graphs)})
    return out


def test_tables_equal_the_graphs():
    for name, g in _graphs().items():
        tab = ldpc_cuda.bp_tables(g)
        assert (tab.dv, tab.dc) == (g.var_edges.shape[1], g.chk_edges.shape[1]), name
        for field in ("var_edges", "chk_edges", "chk_vars"):  # slot-major: a row a slot
            t = getattr(tab, field)
            assert t.dtype == torch.int16 and t.is_contiguous(), (name, field)
            assert torch.equal(t.long(), getattr(g, field).T), (name, field)
        # pads: E in the edge tables, N in chk_vars; every real index below them
        E, N = g.n_edge, g.n_var
        assert int(tab.var_edges.max()) <= E and int(tab.chk_vars.max()) <= N
        e = torch.arange(E)[None, :]  # edge e sits in the slots of its variable and of its check
        assert (tab.var_edges.long()[:, g.edge_var] == e).any(0).all(), name
        assert (tab.chk_edges.long()[:, g.edge_chk] == e).any(0).all(), name
        assert int((tab.var_edges < E).sum()) == int((tab.chk_edges < E).sum()) == E
        assert int((tab.chk_vars < N).sum()) == E
        real = tab.chk_edges < E  # a check's slot names its edge's variable
        assert torch.equal(tab.chk_vars[real].long(), g.edge_var[tab.chk_edges[real].long()]), name
    # the three shipped codes: column degree 3, row degree 5, 4 and 7
    dims = {name: (ldpc_cuda.bp_tables(g).dv, ldpc_cuda.bp_tables(g).dc) for name, g in _graphs().items()
            if name in ALISTS}
    assert dims == {"n_0100_k_0027.alist": (3, 5), "n_0100_k_0023.alist": (3, 4),
                    "n_0300_k_0152.alist": (3, 7)}


def test_bank_tables_hold_each_graph():
    """The concatenated tables hold every graph's bp_tables, pads included,
    at the offsets of its header row; a graph alone is a bank of one."""
    for graphs in (_bank()[1].graphs, (_code("n_0300_k_0152.alist")[1].graph,)):
        banked = ldpc_cuda.bank_tables(graphs)
        assert banked.header.dtype == torch.int32 and banked.header.shape == (len(graphs), ldpc_cuda.HEADER)
        assert banked.tab.dtype == torch.int16 and banked.tab.is_contiguous()
        N, off = graphs[0].n_var, 0
        assert banked.n_var == N
        assert banked.max_edges == max(g.n_edge for g in graphs)
        assert banked.max_dc == max(g.chk_edges.shape[1] for g in graphs)
        dc = banked.max_dc
        for row, g in zip(banked.header.tolist(), graphs):
            tab = ldpc_cuda.bp_tables(g)
            assert row[:4] == [g.n_chk, g.n_edge, tab.dv, dc]
            for start, t, rows, fill in zip(row[4:], (tab.var_edges, tab.chk_edges, tab.chk_vars),
                                            (tab.dv, dc, dc), (g.n_edge, g.n_edge, N)):
                assert start == off  # one after another, in the header's order
                got = banked.tab[start:start + rows * t.shape[1]].reshape(rows, t.shape[1])
                assert torch.equal(got[:t.shape[0]], t)  # the graph's own slots
                assert (got[t.shape[0]:] == fill).all()  # then pad slots up to the largest row degree
                off += got.numel()
        assert banked.tab.numel() == off
    # the two-code bank: both codes in the padded layout of N = 300 (code 1's 100 bits
    # among them), 148 checks each; code 1 has 300 edges of row degree 5, code 2 900 of 7,
    # so code 1's row tables take 2 slots of pads: 900 + 2 x 7 x 148 entries a code
    header = ldpc_cuda.bank_tables(_bank()[1].graphs).header.tolist()
    assert header == [[148, 300, 3, 7, 0, 900, 1936], [148, 900, 3, 7, 2972, 3872, 4908]]
    with pytest.raises(ValueError, match="share N"):
        ldpc_cuda.bank_tables((_code("n_0100_k_0027.alist")[1].graph, _code("n_0300_k_0152.alist")[1].graph))


def test_bytes_ops_and_shared_memory_by_hand():
    g = _code("n_0300_k_0152.alist")[1].graph
    assert (g.n_var, g.n_chk, g.n_edge) == (300, 148, 900)
    # the coded step: 13,312 codewords of 300 bits, 300 x 4 in and 300 x 4 out, 4 + 1 more
    assert ldpc_cuda.bp_bytes(13312, 300) == 13312 * 2405 == 32_015_360
    # two codewords taking 0 and 3 updates: 1 + 4 passes of 2 x 900 + 300, 3 updates of 18 x 900
    assert ldpc_cuda.bp_ops(torch.tensor([0, 3], dtype=torch.int32), g) == 5 * 2100 + 3 * 16200 == 59_100
    assert ldpc_cuda.bp_ops(np.zeros(7, np.int32), g) == 7 * 2100
    # LLRs [300], totals [301] and messages [901], 4 bytes each
    assert ldpc_cuda.smem_bytes(300, 900) == 4 * (300 + 301 + 901) == 6_008


def test_bank_shared_memory_by_hand():
    """A bank's block is sized by its largest code: the two-code bank's
    codewords are 300 bits (the padded layout), its codes 300 and 900
    edges, so 4 x (300 + 301 + 901) bytes, as for the n = 300 code alone;
    a 32-code bank of that code takes no more."""
    banked = ldpc_cuda.bank_tables(_bank()[1].graphs)
    assert (banked.n_var, banked.max_chk, banked.max_edges, banked.max_dc) == (300, 148, 900, 7)
    assert ldpc_cuda.smem_bytes(banked.n_var, banked.max_edges) == 4 * (300 + 301 + 901) == 6_008
    g = _code("n_0300_k_0152.alist")[1].graph
    banked = ldpc_cuda.bank_tables((g,) * 32)
    assert ldpc_cuda.smem_bytes(banked.n_var, banked.max_edges) == 6_008
    assert banked.tab.numel() == 32 * (3 * 300 + 2 * 7 * 148) == 95_104


def test_source_constants_match():
    src = ldpc_cuda.SOURCE.read_text()
    for const, value in (("kMaxIndex", ldpc_cuda.MAX_INDEX), ("kMaxDeg", ldpc_cuda.MAX_DEG),
                         ("kMaxSmem", ldpc_cuda.MAX_SMEM), ("kRegSlots", ldpc_cuda.REG_SLOTS),
                         ("kMaxThreads", 32 * ldpc_cuda.MAX_WARPS),
                         ("kHeader", ldpc_cuda.HEADER)):
        assert re.search(rf"constexpr int {const} = {value};", src), const
    assert "return 4LL * (2LL * N + E + 2);" in src  # smem_bytes


def _wide_graph(dv: int, dc: int):
    """A graph whose first variable sits in dv checks and first check
    holds dc variables."""
    M, N = max(dv, 2), max(dc, 2) + 1
    H = np.zeros((M, N), np.uint8)
    H[:dv, 0] = 1
    H[0, :dc] = 1
    return ldpc._graph(H, "cpu")


def test_wrapper_refuses():
    g = _code("n_0100_k_0027.alist")[1].graph
    n0 = ldpc_cuda.bp_decode_cuda.LAUNCHES
    x = torch.zeros((4, g.n_var))
    with pytest.raises(ValueError, match="float32"):
        ldpc_cuda.bp_decode_cuda(x.double(), g)
    with pytest.raises(ValueError, match="float32"):
        ldpc_cuda.bp_decode_cuda(torch.zeros((4, g.n_var + 1)), g)
    with pytest.raises(ValueError, match="contiguous"):
        ldpc_cuda.bp_decode_cuda(torch.zeros((g.n_var, 4)).T, g)
    with pytest.raises(ValueError, match="CUDA"):
        ldpc_cuda.bp_decode_cuda(x, g)
    for dv, dc in ((ldpc_cuda.MAX_DEG + 1, 3), (3, ldpc_cuda.MAX_DEG + 1)):
        with pytest.raises(ValueError, match="degree"):
            ldpc_cuda.bp_tables(_wide_graph(dv, dc))
    ldpc_cuda.bp_tables(_wide_graph(ldpc_cuda.MAX_DEG, ldpc_cuda.MAX_DEG))  # at the limit
    assert ldpc_cuda.bp_decode_cuda.LAUNCHES == n0


def test_wrapper_refuses_a_bank():
    """Code ids go with a bank's graphs and a bank with code ids; ids must be
    int32 or int64, one a row, contiguous; the check comes before the
    device's, so it shows on the CPU (the device's are the card tests')."""
    bank = _bank()[1]
    g = bank.graphs[0]
    n0 = ldpc_cuda.bp_decode_cuda.LAUNCHES
    x = torch.zeros((4, g.n_var))
    idx = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="code_idx goes with"):
        ldpc_cuda.bp_decode_cuda(x, bank.graphs)
    with pytest.raises(ValueError, match="code_idx goes with"):
        ldpc_cuda.bp_decode_cuda(x, g, code_idx=idx)
    for bad in (idx.float(), idx.to(torch.int16), torch.ones(5, dtype=torch.int32),
                torch.ones(8, dtype=torch.int64)[::2]):
        with pytest.raises(ValueError, match="code_idx must be"):
            ldpc_cuda.bp_decode_cuda(x, bank.graphs, code_idx=bad)
    with pytest.raises(ValueError, match="CUDA"):  # right ids, but the CPU
        ldpc_cuda.bp_decode_cuda(x, bank.graphs, code_idx=idx.long())
    assert ldpc_cuda.bp_decode_cuda.LAUNCHES == n0


def test_cpu_decoders_take_the_plain_version(monkeypatch):
    """On CPU tensors decode_mm, decode_mm_twopass and decode_bank_mm never
    reach the kernel's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA wrapper was called on the CPU")

    monkeypatch.setattr(ldpc_cuda, "bp_decode_cuda", refuse)
    _, code = _code("n_0300_k_0152.alist")
    llr = torch.as_tensor(_vectors("n_0300_k_0152.alist", "moderate"))
    for a, b in zip(ldpc.decode_mm(llr, code), ldpc._bp(llr, code.graph, 15)):
        assert torch.equal(a, b)
    ldpc.decode_mm_twopass(llr, code, bucket=16)
    d = ref_ldpc.build_ldpc_bank([_H(n) for n in BANK])
    bank = ldpc.bank_from_reference(d, "cpu")
    x, idx = _bank_vectors(d, 8, 3)
    ldpc.decode_bank_mm(torch.as_tensor(x), torch.as_tensor(idx), bank)
