"""K3 on the card: ``ops/ldpc_cuda.bp_decode_cuda`` (``csrc/ldpc_bp.cu``)
against the plain BP ``ops/ldpc.py::_bp`` on the same CUDA tensors, and the
decoders' route through it.

Every test is marked ``cuda`` and skips without a card (a CUDA kernel has
no CPU mode); the CPU side of K3 (a numpy model of its schedule, its
tables, bytes and operations, its refusals) is tests/test_torch_bp_plan.py.
This file imports no JAX.  On a machine with the card but without JAX or
pytest-xdist:
``python3 -m pytest -o addopts= --noconftest -q tests/test_torch_ldpc_cuda.py``.

The bar: ``ok`` and ``iters_used`` equal on every row; on every row that
converged, the hard bits and the final totals bit for bit; a row that
never converged may part only by an ulp of a transcendental, and at most
``PARTED_MAX`` of the rows may (the kernel calls the accurate tanhf, logf,
expf and atanhf that PyTorch's CUDA kernels call and adds in _bp's order,
so none is expected: on an NVIDIA H100 none parted).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from gr_dtl_tpu_torch.ops import ldpc, ldpc_cuda
from gr_dtl_tpu_torch.utils import alist

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
ALISTS = ("n_0100_k_0027.alist", "n_0100_k_0023.alist", "n_0300_k_0152.alist")
BANK = ("n_0100_k_0027.alist", "n_0300_k_0152.alist")
REGIMES = {"clean": (4.0, 0.5), "moderate": (2.0, 1.0), "knee": (1.6, 1.0), "waterfall": (1.3, 1.0),
           "saturated": (8.0, 3.0)}  # LLR amplitude, sigma
PARTED_MAX = 0.01  # share of non-converging rows that may part (none expected)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K3 is a CUDA kernel)")
    return torch.device("cuda", 0)


def _code(name, device):
    return ldpc.ldpc_from_reference(ldpc.build_ldpc(alist.load_alist(str(EXAMPLES / name))), device)


def _llr(name, B, regime, dev, seed=0):
    """Codewords of random messages at an LLR amplitude plus Gaussian noise,
    numpy-seeded, on the card."""
    code = _code(name, "cpu")
    rng = np.random.RandomState(seed)
    amp, sigma = REGIMES[regime]
    cw = ldpc.encode(torch.as_tensor(rng.randint(0, 2, (B, code.K)).astype(np.float32)), code).numpy()
    x = (1.0 - 2.0 * cw) * amp + rng.randn(B, code.N) * sigma
    return torch.as_tensor(x.astype(np.float32), device=dev)


def hold_to_plain(llr, g, max_iters=15, done=None, bf16=False) -> int:
    """K3 against _bp on the same tensors, to the bar of the docstring;
    returns the rows that parted."""
    total = torch.empty_like(llr)
    got = ldpc_cuda.bp_decode_cuda(llr, g, max_iters, done=done, bf16=bf16, total_out=total)
    want = ldpc._bp(llr, g, max_iters, done=done, bf16=bf16)
    torch.cuda.synchronize()
    hard, iters, ok = (t.cpu() for t in got)
    hard0, iters0, ok0, total0 = (t.cpu() for t in want)
    assert hard.dtype == torch.int32 and iters.dtype == torch.int32 and ok.dtype == torch.bool
    assert torch.equal(ok, ok0) and torch.equal(iters, iters0)
    parted = (hard != hard0).any(1) | (total.cpu().view(torch.int32) != total0.view(torch.int32)).any(1)
    assert not parted[ok0].any(), f"converged rows parted: {torch.nonzero(parted & ok0).flatten().tolist()}"
    assert int(parted.sum()) <= PARTED_MAX * llr.shape[0], torch.nonzero(parted).flatten().tolist()
    return int(parted.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("name", ALISTS)
def test_kernel_against_plain(dev, name, regime):
    B = 13312 if name.startswith("n_0300") else 2048
    hold_to_plain(_llr(name, B, regime, dev), _code(name, dev).graph)


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["clean", "knee", "waterfall"])
def test_kernel_bf16_and_done_mask(dev, regime):
    code = _code("n_0300_k_0152.alist", dev)
    llr = _llr("n_0300_k_0152.alist", 2048, regime, dev, seed=1)
    hold_to_plain(llr, code.graph, bf16=True)
    done = torch.as_tensor(np.random.RandomState(2).rand(2048) < 0.5, device=dev)
    hold_to_plain(llr, code.graph, done=done)
    hold_to_plain(llr, code.graph, done=done, bf16=True)
    for max_iters in (0, 1, 4):
        hold_to_plain(llr, code.graph, max_iters=max_iters)


@pytest.mark.cuda
def test_edge_sizes(dev):
    code = _code("n_0100_k_0027.alist", dev)
    n0 = ldpc_cuda.bp_decode_cuda.LAUNCHES
    hard, iters, ok = ldpc_cuda.bp_decode_cuda(torch.empty((0, code.N), device=dev), code.graph)
    assert hard.shape == (0, code.N) and iters.shape == ok.shape == (0,)
    assert ldpc_cuda.bp_decode_cuda.LAUNCHES == n0  # nothing to launch
    for B in (1, 2, 129):
        hold_to_plain(_llr("n_0100_k_0027.alist", B, "knee", dev, seed=B), code.graph)
    # NaN and infinite LLRs travel as they do through the plain version
    llr = _llr("n_0100_k_0027.alist", 64, "moderate", dev)
    llr[0, 3], llr[1, 5], llr[2, 7] = float("nan"), float("inf"), -float("inf")
    got = ldpc_cuda.bp_decode_cuda(llr, code.graph)
    want = ldpc._bp(llr, code.graph, 15)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_decoders_launch_k3_and_never_the_plain_loop(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("_bp ran on a CUDA tensor")

    code = _code("n_0300_k_0152.alist", dev)
    llr = _llr("n_0300_k_0152.alist", 2048, "knee", dev)
    want = ldpc._bp(llr, code.graph, 15)[:3]
    d = ldpc.build_ldpc_bank([alist.load_alist(str(EXAMPLES / n)) for n in BANK])
    bank = ldpc.bank_from_reference(d, dev)
    rng = np.random.RandomState(3)
    idx = torch.as_tensor(rng.randint(1, 3, 1024).astype(np.int32), device=dev)
    x = torch.as_tensor((rng.randn(1024, bank.Nmax) * 1.2 + 2.0).astype(np.float32), device=dev)
    want_bank = [torch.zeros(s, dtype=t, device=dev) for s, t in (
        ((1024, bank.Nmax), torch.int32), (1024, torch.int32), (1024, torch.bool))]
    for ci, g in enumerate(bank.graphs):
        mine = idx == ci + 1
        for w, v in zip(want_bank, ldpc._bp(x, g, 15, done=~mine)):
            w[mine] = v[mine]
    monkeypatch.setattr(ldpc, "_bp", refuse)
    n0 = ldpc_cuda.bp_decode_cuda.LAUNCHES
    got = ldpc.decode_mm(llr, code)
    assert ldpc_cuda.bp_decode_cuda.LAUNCHES == n0 + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ldpc.decode_mm(llr, code, bf16=True)
    assert ldpc_cuda.bp_decode_cuda.LAUNCHES == n0 + 2
    # twopass: one launch for pass 1, one a bucket of pass 2; same ok and message bits
    n0 = ldpc_cuda.bp_decode_cuda.LAUNCHES
    hard, _, ok = ldpc.decode_mm_twopass(llr, code, bucket=256)
    assert ldpc_cuda.bp_decode_cuda.LAUNCHES == n0 + 1 + 2048 // 256
    assert torch.equal(ok, want[2]) and torch.equal(hard[ok][:, code.M:], want[0][ok][:, code.M:])
    # the bank: one launch a code
    n0 = ldpc_cuda.bp_decode_cuda.LAUNCHES
    got = ldpc.decode_bank_mm(x, idx, bank)
    assert ldpc_cuda.bp_decode_cuda.LAUNCHES == n0 + bank.n_codes
    for a, b in zip(got, want_bank):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bank_rows_against_plain(dev):
    d = ldpc.build_ldpc_bank([alist.load_alist(str(EXAMPLES / n)) for n in BANK])
    bank = ldpc.bank_from_reference(d, dev)
    rng = np.random.RandomState(4)
    sel = torch.as_tensor(rng.randint(0, 2, 4096), device=dev)
    x = torch.as_tensor((rng.randn(4096, bank.Nmax) * 1.2 + 2.0).astype(np.float32), device=dev)
    for ci, g in enumerate(bank.graphs):
        hold_to_plain(x, g, done=sel != ci)


@pytest.mark.cuda
def test_wrapper_refuses_on_the_card(dev):
    code = _code("n_0100_k_0027.alist", dev)
    x = torch.zeros((8, code.N), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ldpc_cuda.bp_decode_cuda(torch.zeros((code.N, 8), device=dev).T, code.graph)
    with pytest.raises(ValueError, match="float32"):
        ldpc_cuda.bp_decode_cuda(x.half(), code.graph)
    with pytest.raises(ValueError, match="done"):
        ldpc_cuda.bp_decode_cuda(x, code.graph, done=torch.zeros(8, dtype=torch.bool))
    with pytest.raises(ValueError, match="graph"):
        ldpc_cuda.bp_decode_cuda(x, _code("n_0100_k_0027.alist", "cpu").graph)
