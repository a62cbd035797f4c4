"""K3 on the card: ``ops/ldpc_cuda.bp_decode_cuda`` (``csrc/ldpc_bp.cu``)
against the plain BP ``ops/ldpc.py::_bp`` on the same CUDA tensors, and the
decoders' route through it; and K8, ``bp_gather_cuda``, against the plain
gather form ``_bp_gather`` (``decode``, ``decode_bank``).

Every test is marked ``cuda`` and skips without a card (a CUDA kernel has
no CPU mode); the CPU side of K3 (a numpy model of its schedule, its
tables, bytes and operations, its refusals) is tests/test_torch_bp_plan.py,
K8's tests/test_torch_bp_gather.py.
This file imports no JAX.  On a machine with the card but without JAX or
pytest-xdist:
``python3 -m pytest -o addopts= --noconftest -q tests/test_torch_ldpc_cuda.py``.

The bar: ``ok`` and ``iters_used`` equal on every row; on every row that
converged, the hard bits and the final totals bit for bit; a row that
never converged may part only by an ulp of a transcendental, and at most
``PARTED_MAX`` of the rows may (the kernel calls the accurate tanhf, logf,
expf and atanhf that PyTorch's CUDA kernels call and adds in _bp's order,
so none is expected: on an NVIDIA H100 none parted).  K8 is held to
``_bp_gather`` in ``ok``, iterations and hard bits, to the same bar (it
writes no totals).
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gr_dtl_tpu_torch.ops import ldpc, ldpc_cuda
from gr_dtl_tpu_torch.tools import _ldpc_bench
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
    # the bank: one launch, every row with its own code
    n0 = ldpc_cuda.bp_decode_cuda.LAUNCHES
    got = ldpc.decode_bank_mm(x, idx, bank)
    assert ldpc_cuda.bp_decode_cuda.LAUNCHES == n0 + 1
    for a, b in zip(got, want_bank):
        assert torch.equal(a, b)


def _bank_of(n_codes: int, dev):
    """A bank of n_codes codes cycling through the three shipped alists, in
    their padded layout (N = 300, 148 checks; 300, 300 and 900 edges)."""
    Hs = [alist.load_alist(str(EXAMPLES / ALISTS[i % 3])) for i in range(n_codes)]
    return ldpc.bank_from_reference(ldpc.build_ldpc_bank(Hs), dev)


def hold_bank_to_plain(x, idx, bank, bf16=False) -> None:
    """One K3 launch over a bank against _bp of each row's own code (the
    other codes' rows marked done): every row bit-equal, totals included."""
    total = torch.empty_like(x)
    n0 = ldpc_cuda.bp_decode_cuda.LAUNCHES
    hard, iters, ok = ldpc_cuda.bp_decode_cuda(x, bank.graphs, 15, bf16=bf16, total_out=total, code_idx=idx)
    assert ldpc_cuda.bp_decode_cuda.LAUNCHES == n0 + 1
    sel = torch.clamp(idx, 1, bank.n_codes) - 1
    for ci, g in enumerate(bank.graphs):
        mine = sel == ci
        want = ldpc._bp(x, g, 15, done=~mine, bf16=bf16)
        for a, b in zip((hard, iters, ok), want):
            assert torch.equal(a[mine], b[mine]), ci
        assert torch.equal(total[mine].view(torch.int32), want[3][mine].view(torch.int32)), ci


@pytest.mark.cuda
@pytest.mark.parametrize("n_codes", [1, 2, 8, 32])
def test_bank_one_launch(dev, n_codes):
    """decode_bank_mm makes one K3 launch a call whatever the bank's size,
    and every row equals _bp of its own code bit for bit (ids out of range
    clamp as the reference's do; int32 and int64 ids alike)."""
    bank = _bank_of(n_codes, dev)
    rng = np.random.RandomState(n_codes)
    ids = rng.randint(1, n_codes + 1, 1024).astype(np.int64)
    ids[:4] = (0, n_codes + 1, -3, n_codes)
    x = torch.as_tensor((rng.randn(1024, bank.Nmax) * 1.2 + 1.8).astype(np.float32), device=dev)
    for dtype in (torch.int32, torch.int64):
        idx = torch.as_tensor(ids, dtype=dtype, device=dev)
        hold_bank_to_plain(x, idx, bank)
        n0 = ldpc_cuda.bp_decode_cuda.LAUNCHES
        got = ldpc.decode_bank_mm(x, idx, bank)
        assert ldpc_cuda.bp_decode_cuda.LAUNCHES == n0 + 1
        want = ldpc_cuda.bp_decode_cuda(x, bank.graphs, 15, code_idx=idx)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    hold_bank_to_plain(x, idx, bank, bf16=True)


@pytest.mark.cuda
def test_bank_rows_against_plain(dev):
    d = ldpc.build_ldpc_bank([alist.load_alist(str(EXAMPLES / n)) for n in BANK])
    bank = ldpc.bank_from_reference(d, dev)
    rng = np.random.RandomState(4)
    sel = torch.as_tensor(rng.randint(0, 2, 4096), device=dev)
    x = torch.as_tensor((rng.randn(4096, bank.Nmax) * 1.2 + 2.0).astype(np.float32), device=dev)
    for ci, g in enumerate(bank.graphs):
        hold_to_plain(x, g, done=sel != ci)


def _qc(dc: int, z: int, dev):
    """A regular quasi-cyclic code of column degree 3 and row degree dc."""
    return ldpc._graph(_ldpc_bench.qc_parity(3, dc, z), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dc, z", [(12, 16), (64, 8)])
def test_wide_rows_against_plain(dev, dc, z):
    """Rows wider than kRegSlots (8) take the guarded kMaxDeg instantiation:
    bit-equal to _bp on every row, bf16, the done mask and max_iters too."""
    g = _qc(dc, z, dev)
    assert g.chk_edges.shape[1] == dc > ldpc_cuda.REG_SLOTS
    x = torch.as_tensor(_ldpc_bench.zero_word_llrs(2048, g.n_var, dc), device=dev)
    done = torch.as_tensor(np.random.RandomState(dc).rand(2048) < 0.5, device=dev)
    for kw in ({}, {"bf16": True}, {"done": done}, {"max_iters": 3}):
        assert hold_to_plain(x, g, **kw) == 0, kw


@pytest.mark.cuda
def test_wide_bank_against_plain(dev):
    """A bank whose widest rows (12) are past the unrolled slots, with a code
    of row degree 6 padded to them: one launch, every row bit-equal to _bp
    of its own code."""
    graphs = (_qc(6, 32, dev), _qc(12, 16, dev))  # N = 192 each
    bank = types.SimpleNamespace(graphs=graphs, n_codes=2)
    x = torch.as_tensor(_ldpc_bench.zero_word_llrs(2048, 192, 7), device=dev)
    idx = torch.as_tensor(np.random.RandomState(8).randint(0, 4, 2048).astype(np.int32), device=dev)
    hold_bank_to_plain(x, idx, bank)
    hold_bank_to_plain(x, idx, bank, bf16=True)


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
    bank = _bank_of(2, dev)
    y = torch.zeros((8, bank.Nmax), device=dev)
    idx = torch.ones(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="code_idx lies on"):
        ldpc_cuda.bp_decode_cuda(y, bank.graphs, code_idx=idx.cpu())
    with pytest.raises(ValueError, match="code_idx must be"):
        ldpc_cuda.bp_decode_cuda(y, bank.graphs, code_idx=idx.float())
    with pytest.raises(ValueError, match="graph"):
        ldpc_cuda.bp_decode_cuda(y, _bank_of(2, "cpu").graphs, code_idx=idx)


# ---------------------------------------------------------------------------
# K8: the gather form (ldpc_cuda.bp_gather_cuda) against _bp_gather
# ---------------------------------------------------------------------------

def gather_tables_of(graph) -> tuple:
    """The gather form's tables (chk_adj [M, R], var_edges [N, D, 2], rev
    [M, R, 2]) of a graph, as build_ldpc lays them out for its H: a check's
    variables in column order, a variable's (check, slot) pairs in check
    order (tests/test_torch_bp_gather.py holds it to the shipped codes'
    own tables)."""
    E, N = graph.n_edge, graph.n_var
    ce, cv = graph.chk_edges.cpu(), graph.chk_vars.cpu()
    chk_adj = torch.where(ce < E, cv, -1)
    slot_of = torch.full((E + 1, 2), -1, dtype=torch.int64)  # edge -> (check, slot)
    m, r = torch.nonzero(ce < E, as_tuple=True)
    slot_of[ce[m, r]] = torch.stack([m, r], 1)
    var_edges = slot_of[graph.var_edges.cpu()]  # [N, D, 2], pads (-1, -1)
    rev = torch.zeros(ce.shape + (2,), dtype=torch.int64)
    v, d = torch.nonzero(graph.var_edges.cpu() < E, as_tuple=True)
    rev[var_edges[v, d, 0], var_edges[v, d, 1]] = torch.stack([v, d], 1)
    dev = graph.var_edges.device
    return chk_adj.to(dev), var_edges.to(dev), rev.to(dev)


def hold_gather_to_plain(llr, graph, tables, max_iters=15, code_idx=None) -> int:
    """One K8 launch against _bp_gather on the same tensors (``tables``:
    the gather tables, a row's each with code ids): ok and iterations equal
    on every row, hard bits on every row that converged, at most
    ``PARTED_MAX`` of the rows parted; returns the rows that parted."""
    n0 = ldpc_cuda.bp_gather_cuda.LAUNCHES
    hard, iters, ok = ldpc_cuda.bp_gather_cuda(llr, graph, max_iters, code_idx=code_idx)
    assert ldpc_cuda.bp_gather_cuda.LAUNCHES == n0 + 1
    hard0, iters0, ok0 = ldpc._bp_gather(llr, *tables, max_iters)
    torch.cuda.synchronize()
    assert hard.dtype == torch.int32 and iters.dtype == torch.int32 and ok.dtype == torch.bool
    assert torch.equal(ok, ok0) and torch.equal(iters, iters0)
    parted = (hard != hard0).any(1)
    assert not parted[ok0].any(), f"converged rows parted: {torch.nonzero(parted & ok0).flatten().tolist()}"
    assert int(parted.sum()) <= PARTED_MAX * llr.shape[0], torch.nonzero(parted).flatten().tolist()
    return int(parted.sum())


def _code_tables(code):
    return code.chk_adj, code.var_edges, code.rev


@pytest.mark.cuda
@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("name", ALISTS)
def test_gather_against_plain(dev, name, regime):
    code = _code(name, dev)
    x = _llr(name, 2048, regime, dev, seed=5)
    hold_gather_to_plain(x, code.graph, _code_tables(code))
    if regime == "clean":  # the noiseless batch: every row done at entry, no update
        clean = (x > 0).float() * 8.0 - 4.0
        assert hold_gather_to_plain(clean, code.graph, _code_tables(code)) == 0
        _, iters, ok = ldpc_cuda.bp_gather_cuda(clean, code.graph)
        assert bool(ok.all()) and int(iters.max()) == 0


@pytest.mark.cuda
def test_gather_iterations_and_edge_sizes(dev):
    code = _code("n_0300_k_0152.alist", dev)
    x = _llr("n_0300_k_0152.alist", 2048, "knee", dev, seed=6)
    for max_iters in (0, 1, 4):
        hold_gather_to_plain(x, code.graph, _code_tables(code), max_iters=max_iters)
    n0 = ldpc_cuda.bp_gather_cuda.LAUNCHES
    hard, iters, ok = ldpc_cuda.bp_gather_cuda(torch.empty((0, code.N), device=dev), code.graph)
    assert hard.shape == (0, code.N) and iters.shape == ok.shape == (0,)
    assert ldpc_cuda.bp_gather_cuda.LAUNCHES == n0  # nothing to launch
    for B in (1, 2, 129):
        hold_gather_to_plain(x[:B].contiguous(), code.graph, _code_tables(code))
    # NaN and infinite LLRs travel as they do through the plain version
    y = x[:64].clone()
    y[0, 3], y[1, 5], y[2, 7] = float("nan"), float("inf"), -float("inf")
    for a, b in zip(ldpc_cuda.bp_gather_cuda(y, code.graph), ldpc._bp_gather(y, *_code_tables(code), 15)):
        assert torch.equal(a, b)


def _wave(graph) -> int:
    """The blocks of K8 the card keeps resident at once: its grid's most."""
    return ldpc_cuda.resident_codewords(graph, gather=True) * torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.cuda
def test_gather_batches_around_a_wave(dev):
    """B below, at and past one wave of resident blocks and four (where the
    blocks start to walk codewords), and many waves' worth: every codeword
    decoded once, bit-equal to _bp_gather; the stream's counters back at 0
    after every call."""
    code = _code("n_0300_k_0152.alist", dev)
    wave = _wave(code.graph)
    x = _llr("n_0300_k_0152.alist", 13312, "knee", dev, seed=9)
    for B in sorted({1, 7, 923, 925, wave - 1, wave, wave + 1, 4 * wave - 1, 4 * wave, 4 * wave + 1, 13312}):
        hold_gather_to_plain(x[:B].contiguous(), code.graph, _code_tables(code))
        torch.cuda.synchronize()
        assert ldpc_cuda._work(torch.cuda.current_stream(dev)).tolist() == [0] * ldpc_cuda.WORK_COUNTERS, B


@pytest.mark.cuda
def test_gather_rows_off_16_bytes(dev):
    """A batch whose rows do not start on 16 bytes (a view one float into
    its storage) takes the kernel's copy of 4 bytes at a time: bit-equal to
    _bp_gather, and to the same rows on 16 bytes.  The n=100 codes' tables
    start on odd entries too (the staged copy's shifted words)."""
    for name in ("n_0300_k_0152.alist", "n_0100_k_0027.alist"):
        code = _code(name, dev)
        x = _llr(name, 2048, "moderate", dev, seed=10)
        off = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
        off.copy_(x)
        assert off.is_contiguous() and off.data_ptr() % 16 == 4
        hold_gather_to_plain(off, code.graph, _code_tables(code))
        for a, b in zip(ldpc_cuda.bp_gather_cuda(off, code.graph), ldpc_cuda.bp_gather_cuda(x, code.graph)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_gather_bank_alternating_codes(dev):
    """Neighbouring rows of different codes (1, 2, 3, 1, 2, 3, ... of the
    three shipped codes, and a second order): neighbouring blocks stage
    other codes' tables."""
    bank = _bank_of(3, dev)
    rng = np.random.RandomState(11)
    x = torch.as_tensor((rng.randn(3000, bank.Nmax) * 1.2 + 1.8).astype(np.float32), device=dev)
    for ids in (np.arange(3000) % 3 + 1, (np.arange(3000) * 2) % 3 + 1):
        idx = torch.as_tensor(ids.astype(np.int32), device=dev)
        hold_gather_to_plain(x, bank.graphs, ldpc._gather_tables(bank, idx), code_idx=idx)


@pytest.mark.cuda
def test_gather_two_streams(dev):
    """Calls on two streams at once keep their own counters: both
    bit-equal to the one stream's result, both streams' counters at 0."""
    code = _code("n_0300_k_0152.alist", dev)
    x = _llr("n_0300_k_0152.alist", 13312, "waterfall", dev, seed=12)
    want = ldpc_cuda.bp_gather_cuda(x, code.graph)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got_side = ldpc_cuda.bp_gather_cuda(x, code.graph)
    got = ldpc_cuda.bp_gather_cuda(x, code.graph)
    torch.cuda.synchronize()
    for a, b, c in zip(got, got_side, want):
        assert torch.equal(a, c) and torch.equal(b, c)
    for stream in (side, torch.cuda.current_stream(dev)):
        assert ldpc_cuda._work(stream).tolist() == [0] * ldpc_cuda.WORK_COUNTERS


TRAP_SCRIPT = """
import sys
import torch
sys.path.insert(0, {tests!r})
from test_torch_ldpc_cuda import _code, _llr
from gr_dtl_tpu_torch.ops import ldpc_cuda
dev = torch.device("cuda", 0)
code = _code("n_0300_k_0152.alist", dev)
x = _llr("n_0300_k_0152.alist", 13312, "knee", dev, seed=13)
ldpc_cuda.bp_gather_cuda(x, code.graph)
torch.cuda.synchronize()
ldpc_cuda._work(torch.cuda.current_stream(dev))[{which}] = {value}
try:
    ldpc_cuda.bp_gather_cuda(x, code.graph)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(3)
print("no error")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("which, value", [(0, 5), (1, 1), (2, 7)])
def test_gather_traps_on_counters_not_at_zero(dev, which, value):
    """A walk launched on counters left other than 0 traps, and the call's
    next synchronising read raises: in a process of its own, since a trap
    ends the process's CUDA context."""
    import subprocess
    import sys
    tests = str(Path(__file__).resolve().parent)
    proc = subprocess.run([sys.executable, "-c", TRAP_SCRIPT.format(tests=tests, which=which, value=value)],
                          capture_output=True, text=True, timeout=300, cwd=str(Path(tests).parent))
    assert proc.returncode == 3 and "raised:" in proc.stdout, (proc.returncode, proc.stdout, proc.stderr[-2000:])


@pytest.mark.cuda
def test_gather_capture_after_a_launch_on_the_stream(dev):
    """The first launch on a stream may not be captured (it makes the
    stream's counters); after one launch on the capturing stream, a
    captured call replays bit-equal to the call, and the counters stay 0."""
    code = _code("n_0300_k_0152.alist", dev)
    x = _llr("n_0300_k_0152.alist", 13312, "knee", dev, seed=14)
    want = ldpc_cuda.bp_gather_cuda(x, code.graph)
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream(dev)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        with torch.cuda.graph(graph, stream=side):
            ldpc_cuda.bp_gather_cuda(x, code.graph)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        ldpc_cuda.bp_gather_cuda(x, code.graph)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = ldpc_cuda.bp_gather_cuda(x, code.graph)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert ldpc_cuda._work(side).tolist() == [0] * ldpc_cuda.WORK_COUNTERS


@pytest.mark.cuda
@pytest.mark.parametrize("n_codes", [1, 2, 8, 32])
def test_gather_bank_one_launch(dev, n_codes):
    """decode_bank makes one K8 launch a call whatever the bank's size;
    every row equals _bp_gather on its row of the bank's tables, ids in
    [-C-3, C+3] taken as the reference's indexing takes them; int32 and
    int64 ids alike."""
    bank = _bank_of(n_codes, dev)
    rng = np.random.RandomState(n_codes)
    ids = rng.randint(1, n_codes + 1, 1024).astype(np.int64)
    ids[:2 * n_codes + 7] = np.arange(-n_codes - 3, n_codes + 4)
    x = torch.as_tensor((rng.randn(1024, bank.Nmax) * 1.2 + 1.8).astype(np.float32), device=dev)
    for dtype in (torch.int32, torch.int64):
        idx = torch.as_tensor(ids, dtype=dtype, device=dev)
        hold_gather_to_plain(x, bank.graphs, ldpc._gather_tables(bank, idx), code_idx=idx)
        n0 = ldpc_cuda.bp_gather_cuda.LAUNCHES
        got = ldpc.decode_bank(x, idx, bank)
        assert ldpc_cuda.bp_gather_cuda.LAUNCHES == n0 + 1
        want = ldpc_cuda.bp_gather_cuda(x, bank.graphs, 15, code_idx=idx)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dc, z", [(12, 16), (64, 8)])
def test_gather_wide_rows_against_plain(dev, dc, z):
    """Rows wider than kRegSlots (8) take K8's guarded kMaxDeg instantiation."""
    g = _qc(dc, z, dev)
    x = torch.as_tensor(_ldpc_bench.zero_word_llrs(2048, g.n_var, dc), device=dev)
    for max_iters in (15, 3):
        hold_gather_to_plain(x, g, gather_tables_of(g), max_iters=max_iters)


@pytest.mark.cuda
def test_decoders_launch_k8_and_never_the_plain_loop(dev, monkeypatch):
    code = _code("n_0300_k_0152.alist", dev)
    x = _llr("n_0300_k_0152.alist", 2048, "waterfall", dev)
    want = ldpc._bp_gather(x, *_code_tables(code), 15)
    bank = _bank_of(33, dev)
    idx = torch.as_tensor(np.random.RandomState(7).randint(-36, 37, 1024).astype(np.int32), device=dev)
    xb = torch.as_tensor((np.random.RandomState(8).randn(1024, bank.Nmax) + 2.0).astype(np.float32), device=dev)
    want_bank = ldpc._bp_gather(xb, *ldpc._gather_tables(bank, idx), 15)

    def refuse(*a, **k):
        raise AssertionError("_bp_gather ran on a CUDA tensor")

    monkeypatch.setattr(ldpc, "_bp_gather", refuse)
    n0 = ldpc_cuda.bp_gather_cuda.LAUNCHES
    got = ldpc.decode(x, code)
    assert ldpc_cuda.bp_gather_cuda.LAUNCHES == n0 + 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.equal(got[0][want[2]], want[0][want[2]])
    got = ldpc.decode_bank(xb, idx, bank)
    assert ldpc_cuda.bp_gather_cuda.LAUNCHES == n0 + 2
    assert torch.equal(got[1], want_bank[1]) and torch.equal(got[2], want_bank[2])
    assert torch.equal(got[0][want_bank[2]], want_bank[0][want_bank[2]])


@pytest.mark.cuda
def test_gather_wrapper_refuses_on_the_card(dev):
    code = _code("n_0100_k_0027.alist", dev)
    x = torch.zeros((8, code.N), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ldpc_cuda.bp_gather_cuda(torch.zeros((code.N, 8), device=dev).T, code.graph)
    with pytest.raises(ValueError, match="float32"):
        ldpc_cuda.bp_gather_cuda(x.half(), code.graph)
    with pytest.raises(ValueError, match="graph"):
        ldpc_cuda.bp_gather_cuda(x, _code("n_0100_k_0027.alist", "cpu").graph)
    with pytest.raises(ValueError, match="max_iters"):
        ldpc_cuda.bp_gather_cuda(x, code.graph, -1)
    bank = _bank_of(2, dev)
    y = torch.zeros((8, bank.Nmax), device=dev)
    idx = torch.ones(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="code_idx lies on"):
        ldpc_cuda.bp_gather_cuda(y, bank.graphs, code_idx=idx.cpu())
    with pytest.raises(ValueError, match="graph"):
        ldpc_cuda.bp_gather_cuda(y, _bank_of(2, "cpu").graphs, code_idx=idx)
