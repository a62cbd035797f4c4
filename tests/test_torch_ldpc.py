"""LDPC, port against the JAX package: alist parsing, the host constants of
``build_ldpc``/``build_ldpc_bank`` (bit for bit), encoders (exact) and
the BP decoders ``decode_mm``, ``decode_bank_mm`` and ``decode_bank`` on
noiseless, noisy and shortened vectors built as tests/test_ldpc.py and
tests/test_fec_bank.py build them.

Hard bits, ``iters_used`` and ``ok`` must be equal.  Float tolerance: the
final total LLRs of ``decode_mm`` (the reference's ``llr + c2v @ Vmat.T``,
read from its last incidence matmul).  Both sides are float32, but the
port sums each variable's 3 and each check's up to 7 edge messages by
gathers where the reference multiplies by 0/1 incidence matrices
(another summation order), and tanh/log/exp/atanh round differently in
XLA and PyTorch:
 - channel LLRs of magnitude <= ~6 (the "moderate" and "waterfall"
   vectors): atol 1e-4 + rtol 1e-5, a few ulps of totals up to ~60
   after up to 15 iterations;
 - channel LLRs up to ~30 (the "noisy" and "shortened" vectors of
   tests/test_ldpc.py): atol 1.0.  There tanh saturates and the
   check-node product sits at the 0.999999 clip, where d atanh(x)/dx =
   1/(1-x^2) ~ 5e5: one float32 ulp of the product (6e-8) is ~0.03 in a
   message, and a variable sums three of them per iteration.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.ops import ldpc as ref_ldpc
from gr_dtl_tpu.utils import alist as ref_alist

from gr_dtl_tpu_torch.ops import ldpc
from gr_dtl_tpu_torch.utils import alist

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
ALISTS = ["n_0100_k_0027.alist", "n_0100_k_0023.alist", "n_0300_k_0152.alist"]
BANK = ["n_0100_k_0027.alist", "n_0300_k_0152.alist"]
# (atol, rtol) of the final totals, by the channel LLR magnitude (docstring)
TOTAL_TOL = {"moderate": (1e-4, 1e-5), "waterfall": (1e-4, 1e-5), "noiseless": (1e-4, 1e-5),
             "noisy": (1.0, 0.0), "shortened": (1.0, 0.0)}


def _H(name):
    return alist.load_alist(str(EXAMPLES / name))


def _assert_tree_equal(a, b, path="d"):
    """Nested dicts/lists of numpy arrays and scalars, equal in dtype,
    shape and bits; dataclasses of the two packages (configs, CRC specs)
    equal field value by field value."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert dataclasses.astuple(a) == dataclasses.astuple(b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and a.shape == np.asarray(b).shape, path
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=path)
    else:
        assert a == b, path


def _ref_decode_mm_with_total(llr, code):
    """The reference's ``decode_mm`` under jax.jit, plus its final total
    LLRs: the last ``c2v @ Vmat.T`` product (the only one whose right
    operand is [E, N]), captured while tracing, added to the channel LLRs
    as the reference adds it."""
    E, N = int(code["E"]), int(code["N"])
    orig = jax.lax.dot
    products = []

    def dot(a, b, **kw):
        out = orig(a, b, **kw)
        if b.shape == (E, N):
            products.append(out)
        return out

    def run(x):
        products.clear()
        jax.lax.dot = dot
        try:
            hard, iters, ok = ref_ldpc.decode_mm(x, code, 15)
        finally:
            jax.lax.dot = orig
        return hard, iters, ok, x + products[-1]

    return [np.asarray(v) for v in jax.jit(run)(jnp.asarray(llr))]


@pytest.mark.parametrize("name", ALISTS)
def test_alist_and_build_ldpc_bit_equal(name):
    text = (EXAMPLES / name).read_text()
    H = alist.parse_alist(text)
    np.testing.assert_array_equal(H, ref_alist.parse_alist(text))
    assert H.dtype == np.uint8
    _assert_tree_equal(ldpc.build_ldpc(H), ref_ldpc.build_ldpc(H))
    code = ldpc.ldpc_from_reference(ref_ldpc.build_ldpc(H), "cpu")
    assert (code.M, code.N, code.K, code.graph.n_edge) == (
        H.shape[0], H.shape[1], H.shape[1] - H.shape[0], int(H.sum()))


def test_build_ldpc_bank_bit_equal():
    Hs = [_H(n) for n in BANK]
    _assert_tree_equal(ldpc.build_ldpc_bank(Hs), ref_ldpc.build_ldpc_bank(Hs))
    bank = ldpc.bank_from_reference(ref_ldpc.build_ldpc_bank(Hs), "cpu")
    assert (bank.n_codes, bank.Mmax, bank.Kmax, bank.Nmax) == (2, 148, 152, 300)
    assert [g.n_edge for g in bank.graphs] == [int(H.sum()) for H in Hs]


@pytest.mark.parametrize("name", ALISTS)
def test_encode_exact(name):
    H = _H(name)
    d = ref_ldpc.build_ldpc(H)
    code = ldpc.ldpc_from_reference(d, "cpu")
    msgs = np.random.RandomState(0).randint(0, 2, (16, code.K)).astype(np.float32)
    got = ldpc.encode(torch.as_tensor(msgs), code).numpy()
    want = np.asarray(jax.jit(lambda m: ref_ldpc.encode(m, d))(jnp.asarray(msgs)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert ((d["Ht"].astype(np.int64) @ got.T) % 2 == 0).all()


def test_encode_bank_exact():
    d = ref_ldpc.build_ldpc_bank([_H(n) for n in BANK])
    bank = ldpc.bank_from_reference(d, "cpu")
    rng = np.random.RandomState(1)
    B = 24
    code_idx = rng.randint(0, 3, B).astype(np.int32)  # id 0 reads row 0 = code 1
    msgs = np.zeros((B, bank.Kmax), np.float32)
    for i in range(B):
        k = int(d["k_tab"][code_idx[i]])
        msgs[i, :k] = rng.randint(0, 2, k)
    got = ldpc.encode_bank(torch.as_tensor(msgs), torch.as_tensor(code_idx), bank).numpy()
    want = np.asarray(jax.jit(lambda m, c: ref_ldpc.encode_bank(m, c, d))(
        jnp.asarray(msgs), jnp.asarray(code_idx)))
    np.testing.assert_array_equal(got, want)


def _llrs(kind, cw, M, rng):
    """Decoder inputs as tests/test_ldpc.py builds them."""
    x = 1.0 - 2.0 * cw
    if kind == "noiseless":
        return (x * 8.0).astype(np.float32)
    if kind == "noisy":
        y = x + 0.7 * rng.randn(*cw.shape)
        return (2.0 * y / 0.49).astype(np.float32)
    if kind == "moderate":  # every codeword converges within a few iterations
        return (x * 2.0 + rng.randn(*cw.shape)).astype(np.float32)
    if kind == "waterfall":  # most codewords iterate, some hit the cap
        return (x * 1.6 + rng.randn(*cw.shape)).astype(np.float32)
    # shortened: the tail of the systematic part is never sent
    llr = (x * 2.0 + 0.8 * rng.randn(*cw.shape)).astype(np.float32)
    llr[:, M + (cw.shape[1] - M) - 9:] = ldpc.SHORTENED_LLR
    return llr


@pytest.mark.parametrize("name,kind", [
    ("n_0100_k_0027.alist", "noiseless"), ("n_0100_k_0027.alist", "noisy"),
    ("n_0100_k_0027.alist", "shortened"), ("n_0300_k_0152.alist", "noisy"),
    ("n_0300_k_0152.alist", "moderate"), ("n_0300_k_0152.alist", "waterfall")])
def test_decode_mm_matches_reference(name, kind):
    d = ref_ldpc.build_ldpc(_H(name))
    code = ldpc.ldpc_from_reference(d, "cpu")
    rng = np.random.RandomState(len(kind))
    msgs = rng.randint(0, 2, (48, code.K)).astype(np.float32)
    if kind == "shortened":
        msgs[:, code.K - 9:] = 0
    cw = np.asarray(ref_ldpc.encode(jnp.asarray(msgs), d)).astype(np.float64)
    llr = _llrs(kind, cw, code.M, rng)

    hard_r, iters_r, ok_r, total_r = _ref_decode_mm_with_total(llr, d)
    hard, iters, ok, total = ldpc._bp(torch.as_tensor(llr), code.graph, 15)
    np.testing.assert_array_equal(hard.numpy(), hard_r)
    np.testing.assert_array_equal(iters.numpy(), iters_r)
    np.testing.assert_array_equal(ok.numpy(), ok_r)
    atol, rtol = TOTAL_TOL[kind]
    np.testing.assert_allclose(total.numpy(), total_r, atol=atol, rtol=rtol)
    # the public entry point is the same decode
    for a, b in zip(ldpc.decode_mm(torch.as_tensor(llr), code), (hard, iters, ok)):
        assert torch.equal(a, b)
    if kind == "noiseless":
        assert ok.all() and iters.max() == 0
        np.testing.assert_array_equal(hard.numpy(), cw)
    if kind == "waterfall":
        assert 0 < ok_r.mean() < 1 and iters_r.max() == 15  # the point really iterates


@pytest.mark.parametrize("kind", ["moderate", "waterfall"])
def test_early_exit_changes_nothing(kind):
    """The batch-wide exit only skips work: with it and without it (all
    15 iterations) every output is identical, bit for bit."""
    d = ref_ldpc.build_ldpc(_H("n_0300_k_0152.alist"))
    code = ldpc.ldpc_from_reference(d, "cpu")
    rng = np.random.RandomState(7)
    msgs = rng.randint(0, 2, (32, code.K)).astype(np.float32)
    cw = ldpc.encode(torch.as_tensor(msgs), code).numpy().astype(np.float64)
    llr = torch.as_tensor(_llrs(kind, cw, code.M, rng))
    fast = ldpc._bp(llr, code.graph, 15, early_exit=True)
    full = ldpc._bp(llr, code.graph, 15, early_exit=False)
    for a, b in zip(fast, full):
        assert torch.equal(a, b)
    if kind == "moderate":
        assert fast[1].max() < 15  # the exit was taken


def _bank_vectors(d, B, seed, sigma=0.9):
    """Noisy padded-layout codewords of random codes, unused slots pinned
    (tests/test_fec_bank.py:164-190)."""
    rng = np.random.RandomState(seed)
    code_idx = rng.randint(1, 3, B).astype(np.int32)
    Kmax, Nmax, Mmax = d["Kmax"], d["Nmax"], d["Mmax"]
    msgs = np.zeros((B, Kmax), np.float32)
    for i in range(B):
        k = int(d["k_tab"][code_idx[i]])
        msgs[i, :k] = rng.randint(0, 2, k)
    cws = np.asarray(ref_ldpc.encode_bank(jnp.asarray(msgs), jnp.asarray(code_idx), d))
    llr = (1.0 - 2.0 * cws.astype(np.float32)) * 3.0
    llr += rng.randn(B, Nmax).astype(np.float32) * sigma
    for i in range(B):
        m, k = int(d["m_tab"][code_idx[i]]), int(d["k_tab"][code_idx[i]])
        llr[i, m:Mmax] = ldpc.SHORTENED_LLR
        llr[i, Mmax + k:] = ldpc.SHORTENED_LLR
    return llr, code_idx


@pytest.mark.parametrize("which", ["decode_bank_mm", "decode_bank"])
@pytest.mark.parametrize("sigma", [0.9, 2.4])
def test_bank_decoders_match_reference(which, sigma):
    d = ref_ldpc.build_ldpc_bank([_H(n) for n in BANK])
    bank = ldpc.bank_from_reference(d, "cpu")
    llr, code_idx = _bank_vectors(d, 32, 5, sigma)
    want = [np.asarray(v) for v in jax.jit(
        lambda x, c: getattr(ref_ldpc, which)(x, c, d, 15))(jnp.asarray(llr), jnp.asarray(code_idx))]
    got = getattr(ldpc, which)(torch.as_tensor(llr), torch.as_tensor(code_idx), bank, 15)
    for g, w, name in zip(got, want, ("hard", "iters_used", "ok")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if sigma == 0.9:
        assert want[2].mean() > 0.8  # the point is decodable
    else:
        assert want[1].max() == 15  # and this one iterates to the cap
