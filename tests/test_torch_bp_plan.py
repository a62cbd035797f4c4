"""K3's plan on the CPU: a numpy model of ``csrc/ldpc_bp.cu``'s own schedule
held to the port's plain BP (``ops/ldpc.py::_bp``) and to the reference's
``decode_mm``, and the host side of ``ops/ldpc_cuda``.

The model decodes as the kernel does: a codeword at a time, from the
compact int16 tables ``ldpc_cuda.bp_tables`` builds (pads read a zero kept
at index E, or N), each degree sum added left to right from slot 0, and
the codeword's loop ends at its own syndrome pass (or after ``max_iters``
updates; a row marked done takes none).  It must equal ``_bp`` bit for
bit (hard bits, iterations, ok and the final totals) and the reference's
``decode_mm`` in hard bits, iterations and ok, on the inputs of
tests/test_torch_ldpc.py: noiseless, noisy, shortened, moderate and
waterfall vectors of all three alists, the two-code bank with the kernel's
``done`` mask, and the bfloat16 switch.

Every sum and difference of the model is a float32 numpy operation, as
each of ``_bp``'s is one PyTorch kernel.  tanh, log, exp and atanh are
PyTorch's CPU functions: the CPU's atanh takes another path on the last
elements of an array than on the rest (its vector body and its scalar
tail differ by an ulp), so the model takes each function at the
codeword's own place in a [B, E] array, where ``_bp`` takes it.  On the
card the kernel calls the CUDA functions PyTorch's CUDA kernels call; the
card tests (tests/test_torch_ldpc_cuda.py) hold it to ``_bp`` there.
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


def bp_model(llr: np.ndarray, graph, max_iters: int = 15, done=None, bf16: bool = False):
    """The kernel's schedule in numpy -> (hard [B, N] int32, iters [B] int32,
    ok [B] bool, totals [B, N] float32)."""
    tab = ldpc_cuda.bp_tables(graph)
    ve, ce, cv, ev, ec = (np.asarray(t.numpy(), np.int64) for t in (
        tab.var_edges, tab.chk_edges, tab.chk_vars, tab.edge_var, tab.edge_chk))
    rows, N = llr.shape
    E = graph.n_edge
    rnd = _bf16 if bf16 else (lambda x: x)
    f32 = np.float32
    hard = np.zeros((rows, N), np.int32)
    iters = np.zeros(rows, np.int32)
    ok_out = np.zeros(rows, bool)
    totals = np.zeros((rows, N), np.float32)

    def slot_sum(x, idx):  # left to right from slot 0
        s = x[idx[:, 0]]
        for d in range(1, idx.shape[1]):
            s = s + x[idx[:, d]]
        return s

    for b in range(rows):
        c2v = np.zeros(E + 1, f32)  # c2v[E]: the pad's zero
        it, ok = 0, True
        while True:
            total = llr[b] + slot_sum(rnd(c2v), ve)
            hb = np.append(total < 0, False).astype(np.int64)
            if done is not None and done[b]:
                break
            ok = bool((slot_sum(hb, cv) % 2 == 0).all())
            if ok or it == max_iters:
                break
            v2c = rnd(total)[ev] - c2v[:E]
            t = _at(torch.tanh, np.clip(v2c, f32(-20.0), f32(20.0)) * f32(0.5), b, rows)
            mag = _at(torch.log, np.maximum(np.abs(t), f32(1e-12)), b, rows)
            neg = (t < 0).astype(np.int64)
            sum_mag = slot_sum(rnd(np.append(mag, f32(0.0))), ce)
            sum_neg = slot_sum(np.append(neg, 0), ce)
            m = _at(torch.exp, rnd(sum_mag)[ec] - mag, b, rows)
            loo = np.clip(np.where((sum_neg[ec] - neg) % 2 == 1, -m, m), f32(-0.999999), f32(0.999999))
            c2v[:E] = f32(2.0) * _at(torch.atanh, loo.astype(f32), b, rows)
            it += 1
        hard[b], iters[b], ok_out[b], totals[b] = hb[:N], it, ok, total
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


@pytest.mark.parametrize("sigma", [0.9, 2.4])
def test_model_bank_with_done_mask(sigma):
    """decode_bank_mm's schedule: one pass a code with the other codes' rows
    marked done.  Each pass equals _bp's with the same mask; the passes
    merged equal the reference's decode_bank_mm."""
    d = ref_ldpc.build_ldpc_bank([_H(n) for n in BANK])
    bank = ldpc.bank_from_reference(d, "cpu")
    llr, code_idx = _bank_vectors(d, 32, 5, sigma)
    sel = np.clip(code_idx, 1, bank.n_codes) - 1
    hard = np.zeros(llr.shape, np.int32)
    iters = np.zeros(len(llr), np.int32)
    ok = np.zeros(len(llr), bool)
    for ci, g in enumerate(bank.graphs):
        mine = sel == ci
        got = bp_model(llr, g, done=~mine)
        _assert_bit_equal(got, ldpc._bp(torch.as_tensor(llr), g, 15, done=torch.as_tensor(~mine)))
        assert (got[1][~mine] == 0).all() and got[2][~mine].all()  # marked rows take no update
        hard[mine], iters[mine], ok[mine] = got[0][mine], got[1][mine], got[2][mine]
    want = [np.asarray(v) for v in jax.jit(lambda x, c: ref_ldpc.decode_bank_mm(x, c, d, 15))(
        jnp.asarray(llr), jnp.asarray(code_idx))]
    for g, w, what in zip((hard, iters, ok), want, ("hard", "iters_used", "ok")):
        np.testing.assert_array_equal(g, w, err_msg=what)


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


# ---------------------------------------------------------------------------
# ops/ldpc_cuda's host side
# ---------------------------------------------------------------------------

def _graphs():
    out = {name: _code(name)[1].graph for name in ALISTS}
    bank = ldpc.bank_from_reference(ref_ldpc.build_ldpc_bank([_H(n) for n in BANK]), "cpu")
    out.update({f"bank code {i + 1}": g for i, g in enumerate(bank.graphs)})
    return out


def test_tables_equal_the_graphs():
    for name, g in _graphs().items():
        tab = ldpc_cuda.bp_tables(g)
        assert (tab.dv, tab.dc) == (g.var_edges.shape[1], g.chk_edges.shape[1]), name
        for field in ("var_edges", "chk_edges", "chk_vars", "edge_var", "edge_chk"):
            t = getattr(tab, field)
            assert t.dtype == torch.int16 and t.is_contiguous(), (name, field)
            assert torch.equal(t.long(), getattr(g, field)), (name, field)
        # pads: E in the edge tables, N in chk_vars; every real index below them
        E, N = g.n_edge, g.n_var
        assert int(tab.var_edges.max()) <= E and int(tab.chk_vars.max()) <= N
        e = torch.arange(E)[:, None]  # edge e sits in the rows of its variable and of its check
        assert (tab.var_edges.long()[tab.edge_var.long()] == e).any(1).all(), name
        assert (tab.chk_edges.long()[tab.edge_chk.long()] == e).any(1).all(), name
        assert int((tab.var_edges < E).sum()) == int((tab.chk_edges < E).sum()) == E
        assert int((tab.chk_vars < N).sum()) == E
    # the three shipped codes: column degree 3, row degree 5, 4 and 7
    dims = {name: (ldpc_cuda.bp_tables(g).dv, ldpc_cuda.bp_tables(g).dc) for name, g in _graphs().items()
            if name in ALISTS}
    assert dims == {"n_0100_k_0027.alist": (3, 5), "n_0100_k_0023.alist": (3, 4),
                    "n_0300_k_0152.alist": (3, 7)}


def test_bytes_ops_and_shared_memory_by_hand():
    g = _code("n_0300_k_0152.alist")[1].graph
    assert (g.n_var, g.n_chk, g.n_edge) == (300, 148, 900)
    # the coded step: 13,312 codewords of 300 bits, 300 x 4 in and 300 x 4 out, 4 + 1 more
    assert ldpc_cuda.bp_bytes(13312, 300) == 13312 * 2405 == 32_015_360
    # two codewords taking 0 and 3 updates: 1 + 4 passes of 2 x 900 + 300, 3 updates of 18 x 900
    assert ldpc_cuda.bp_ops(torch.tensor([0, 3], dtype=torch.int32), g) == 5 * 2100 + 3 * 16200 == 59_100
    assert ldpc_cuda.bp_ops(np.zeros(7, np.int32), g) == 7 * 2100
    assert ldpc_cuda.smem_bytes(300, 148, 900) == 4 * (2 * 901 + 600 + 296) + 901 + 301 == 11_994


def test_source_constants_match():
    src = ldpc_cuda.SOURCE.read_text()
    for const, value in (("kMaxIndex", ldpc_cuda.MAX_INDEX), ("kMaxDeg", ldpc_cuda.MAX_DEG),
                         ("kMaxSmem", ldpc_cuda.MAX_SMEM)):
        assert re.search(rf"constexpr int {const} = {value};", src), const
    assert "4LL * (2LL * (E + 1) + 2LL * N + 2LL * M) + (E + 1) + (N + 1)" in src  # smem_bytes


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
