"""K9, the coded demap's LLR kernel (csrc/soft_demap.cu), and what stands
around it.

On the CPU: the dispatcher in ``models/receiver.frame_llrs`` (CPU tensors
and wire-compat table mode keep the plain chain, launch nothing and count
nothing), the plain chain ``_frame_llrs_torch`` against the serialisation
written out frame by frame, the wrapper's refusals, the byte count the
timing tool uses, and the source's constants against
``ops/constellation.py``'s.

On the card (marked ``cuda``: these skip without an NVIDIA GPU, a CUDA
kernel has no CPU mode): K9 ``torch.equal`` to ``_frame_llrs_torch`` on the
same CUDA tensors, each id 1..4 alone and mixed, the ids outside 1..4 the
table indexes (0 and -1..-4), B in {1, 7, 2048, 32768}, S = 960 and odd S,
symbols at 0 and on every slicer's boundaries, noise variances at and below
the 1e-12 clamp; NaN and infinite symbols NaN where the plain chain's are.
On a machine with the card but without JAX or pytest-xdist:
``python3 -m pytest -o addopts= --noconftest -q tests/test_torch_llr_cuda.py``.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gr_dtl_tpu_torch.models import receiver
from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.ops import llr_cuda
from gr_dtl_tpu_torch.tools import bench_llr
from gr_dtl_tpu_torch.utils import trace

S_CELL = 960
LVL = float(np.float32(1.0) / np.sqrt(np.float32(10.0)))


def params(device, S: int, table_mode: bool = False, max_frame_bits: int | None = None):
    """What ``frame_llrs`` reads of a receiver's params."""
    tab = cn.active(device)._replace(table_mode=table_mode)
    return SimpleNamespace(tab=tab, fec=SimpleNamespace(max_frame_bits=4 * S if max_frame_bits is None
                                                        else max_frame_bits))


def boundary_symbols() -> np.ndarray:
    """0, each axis and slicer boundary (the QPSK and BPSK axes, 16QAM's
    +-2L, the 8PSK rays at odd multiples of pi / 8) with points just off
    them, and the constellations' own points."""
    two_l = 2 * LVL
    axis = [0.0, 1e-7, -1e-7, two_l, -two_l, np.nextafter(np.float32(two_l), np.float32(1)), 0.3, -0.7]
    pts = [complex(a, b) for a in axis for b in axis]
    pts += [np.exp(1j * (np.pi / 8) * (2 * q + 1)) * r for q in range(8) for r in (0.5, 1.0, 1.5)]
    pts += [np.exp(1j * ((np.pi / 8) * (2 * q + 1) + d)) for q in range(8) for d in (1e-6, -1e-6)]
    pts += list(cn.POINTS[1:].reshape(-1))
    return np.array(pts, np.complex64)


def frame_inputs(B: int, S: int, cnst, seed: int, boundaries: bool = False):
    """(soft [B, S] complex64, cnst [B] int32, noise_var [B] float32) as numpy:
    the frames' constellation points with noise, or the boundary symbols
    repeated along each row."""
    rng = np.random.default_rng(seed)
    cnst = np.asarray(cnst, np.int32)
    if boundaries:
        edge = boundary_symbols()
        soft = edge[(np.arange(B)[:, None] * 7 + np.arange(S)[None, :]) % edge.size]
    else:
        bps = cn.BITS_PER_SYMBOL[cnst % cn.N_TYPES]
        labels = rng.integers(0, 16, (B, S)) % (1 << bps)[:, None]
        soft = cn.POINTS[cnst % cn.N_TYPES][np.arange(B)[:, None], labels]
        soft = soft + (rng.normal(size=(B, S)) + 1j * rng.normal(size=(B, S))) * 0.2
    nv = rng.uniform(0.005, 0.2, B).astype(np.float32)
    return soft.astype(np.complex64), cnst, nv


def on(device, arrays):
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def frame_llrs_before(rxp, soft, cnst, noise_var):
    """``receiver.frame_llrs`` as it read before K9, kept as the plain
    chain's reference."""
    B, S = soft.shape
    llr_bits = cn.soft_llrs(soft, cnst[:, None], noise_var[:, None], rxp.tab)
    bps = rxp.tab.bps[cnst.long()]
    maxF = rxp.fec.max_frame_bits
    llrs = torch.zeros((B, maxF), dtype=torch.float32, device=soft.device)
    for k in (1, 2, 3, 4):
        flat = llr_bits[:, :, :k].reshape(B, S * k)
        flat = flat[:, :maxF] if S * k >= maxF else F.pad(flat, (0, maxF - S * k))
        llrs = torch.where((bps == k)[:, None], flat, llrs)
    return llrs


def serialised(rxp, soft, cnst, noise_var) -> np.ndarray:
    """The frame bit stream written out frame by frame with numpy."""
    bits = cn.soft_llrs(soft, cnst[:, None], noise_var[:, None], rxp.tab).numpy()
    B, S = soft.shape
    out = np.zeros((B, rxp.fec.max_frame_bits), np.float32)
    for b in range(B):
        k = int(rxp.tab.bps[int(cnst[b])])
        if 1 <= k <= 4:
            row = bits[b, :, :k].reshape(-1)[: out.shape[1]]
            out[b, : row.size] = row
    return out


# ---------------------------------------------------------------------------
# CPU: the dispatcher, the plain chain, refusals, bytes, constants
# ---------------------------------------------------------------------------

MIXED = [1, 2, 3, 4, 0, -1, -2, -3, -4]


@pytest.mark.parametrize("table_mode", [False, True])
def test_cpu_tensors_take_the_plain_chain_and_count_nothing(table_mode):
    rxp = params("cpu", 24, table_mode)
    args = on("cpu", frame_inputs(len(MIXED), 24, MIXED, seed=1))
    before = llr_cuda.frame_llrs_cuda.LAUNCHES
    trace.reset()
    trace.enable()
    try:
        got = receiver.frame_llrs(rxp, *args)
        counters = trace.export()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert llr_cuda.frame_llrs_cuda.LAUNCHES == before
    assert "rx.demap.llr_kernel_frames" not in counters
    assert torch.equal(got, receiver._frame_llrs_torch(rxp, *args))


@pytest.mark.parametrize("S, max_frame_bits", [(24, None), (7, None), (7, 20), (1, None)])
@pytest.mark.parametrize("case", ["mixed", "boundaries"])
def test_plain_chain_is_the_frame_bit_stream(S, max_frame_bits, case):
    """``_frame_llrs_torch`` gives what ``frame_llrs`` gave before K9, and
    that is each frame's bits laid out symbol after symbol."""
    rxp = params("cpu", S, max_frame_bits=max_frame_bits)
    args = on("cpu", frame_inputs(len(MIXED), S, MIXED, seed=S, boundaries=case == "boundaries"))
    got = receiver._frame_llrs_torch(rxp, *args)
    assert got.shape == (len(MIXED), rxp.fec.max_frame_bits) and got.dtype == torch.float32
    assert torch.equal(got, frame_llrs_before(rxp, *args))
    np.testing.assert_array_equal(got.numpy(), serialised(rxp, *args))
    assert not got[MIXED.index(0)].any()  # id 0 has no bits


def test_wrapper_refuses_what_the_kernel_does_not_take():
    soft, cnst, nv = on("cpu", frame_inputs(4, 10, [1, 2, 3, 4], seed=3))
    bps = cn.active("cpu").bps
    call = llr_cuda.frame_llrs_cuda
    before = call.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(soft, cnst, nv, bps, 40)
    with pytest.raises(ValueError, match="complex64"):
        call(soft.to(torch.complex128), cnst, nv, bps, 40)
    with pytest.raises(ValueError, match=r"\[B, S\]"):
        call(soft[0], cnst, nv, bps, 40)
    with pytest.raises(ValueError, match="contiguous"):
        call(soft.t().contiguous().t(), cnst, nv, bps, 40)
    with pytest.raises(ValueError, match="int32"):
        call(soft, cnst.long(), nv, bps, 40)
    with pytest.raises(ValueError, match="shape"):
        call(soft, cnst[:3], nv, bps, 40)
    with pytest.raises(ValueError, match="float32"):
        call(soft, cnst, nv.double(), bps, 40)
    with pytest.raises(ValueError, match="int64"):
        call(soft, cnst, nv, bps.int(), 40)
    with pytest.raises(ValueError, match="multiple of 4"):
        call(soft, cnst, nv, bps, 38)
    with pytest.raises(ValueError, match="symbols a frame"):
        call(soft[:, :0], cnst, nv, bps, 40)
    assert call.LAUNCHES == before


def test_llr_bytes_counts_every_input_and_output_once():
    # the coded cell's step: 252 MB of symbols and 12 bytes a frame read, 503 MB of rows written
    assert llr_cuda.llr_bytes(32_768, 960, 3840) == 32_768 * (8 * 960 + 12) + 32_768 * 3840 * 4
    assert llr_cuda.llr_bytes(32_768, 960, 3840) == 755_367_936
    assert llr_cuda.llr_bytes(1, 1, 4) == 8 + 12 + 16
    assert bench_llr.floor_ms(32_768) == pytest.approx(755_367_936 / 3.35e12 * 1e3, rel=1e-12)


def test_library_path_needs_no_compiler():
    assert llr_cuda.library_path().name.startswith("libsoft_demap_")
    assert llr_cuda.SOURCE.is_file()


def test_source_constants_are_the_soft_demaps_float32_values():
    """The kernel computes with the constants of ops/constellation.py's
    soft_llrs, rounded to float32 as PyTorch rounds a Python scalar."""
    src = llr_cuda.SOURCE.read_text()
    consts = {k: np.float32(v) for k, v in re.findall(r"constexpr float (k\w+) = ([0-9.e+-]+)f;", src)}
    f32 = np.float32
    assert consts == {"kBpskScale": f32(-4.0), "kQpskScale": f32(-4.0 * cn._A_Q), "kQamFourLevel": f32(cn._4L),
                      "kQamEightLevelSq": f32(cn._8LL), "kQamTwoLevel": f32(cn._2L), "kPsk8Scale": f32(2.0),
                      "kNoiseVarMin": f32(1e-12)}
    ring = lambda name: np.array([np.float32(v.rstrip("f")) for v in
                                  re.search(rf"#define {name} \{{(.*)\}}", src).group(1).split(",")])
    np.testing.assert_array_equal(ring("PSK8_COS"), cn._PSK8_COS)
    np.testing.assert_array_equal(ring("PSK8_SIN"), cn._PSK8_SIN)
    ones = [int(v, 16) for v in re.search(r"#define PSK8_ONES \{(.*)\}", src).group(1).replace("u", "").split(",")]
    assert ones == [int(sum(1 << q for q in range(8) if cn._PSK8_BIT[q, j])) for j in range(3)]
    assert "__fdiv_rn(" in src and "max.NaN.f32" in src
    assert "use_fast_math" not in " ".join(llr_cuda.NVCC_FLAGS)


def test_timing_tool_draws_each_frames_points():
    soft, cnst, nv = bench_llr.inputs(64, "mixed", 5, "cpu", S=12)
    assert soft.shape == (64, 12) and soft.dtype == torch.complex64
    assert cnst.tolist() == [1 + i % 4 for i in range(64)] and bool(((nv >= 0.01) & (nv <= 0.1)).all())
    again = bench_llr.inputs(64, "mixed", 5, "cpu", S=12)
    assert torch.equal(soft, again[0]) and torch.equal(nv, again[2])
    assert bool((bench_llr.ids(8, "qpsk", "cpu") == 2).all())


def test_timing_tools_variants_find_their_text_in_the_source():
    src = llr_cuda.SOURCE.read_text()
    for name, edits in bench_llr.VARIANTS.items():
        assert all(src.count(old) == 1 for old, _ in edits), name


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


CASES = {"bpsk": [1], "qpsk": [2], "psk8": [3], "qam16": [4], "mixed": MIXED}


def held_bit_equal(dev, B: int, S: int, ids, seed: int, boundaries: bool = False, nv=None,
                   max_frame_bits: int | None = None):
    rxp = params(dev, S, max_frame_bits=max_frame_bits)
    soft, cnst, noise = frame_inputs(B, S, [ids[i % len(ids)] for i in range(B)], seed, boundaries)
    if nv is not None:
        noise = np.resize(np.asarray(nv, np.float32), B)
    args = on(dev, (soft, cnst, noise))
    before = llr_cuda.frame_llrs_cuda.LAUNCHES
    got = receiver.frame_llrs(rxp, *args)
    want = receiver._frame_llrs_torch(rxp, *args)
    torch.cuda.synchronize()
    assert llr_cuda.frame_llrs_cuda.LAUNCHES == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("S", [S_CELL, 37])
@pytest.mark.parametrize("B", [1, 7, 2048])
def test_kernel_is_bit_equal_to_the_plain_chain(gpu, B, S, case):
    held_bit_equal(gpu, B, S, CASES[case], seed=B + S)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["qpsk", "mixed"])
def test_kernel_at_the_coded_cells_batch(gpu, case):
    held_bit_equal(gpu, 32_768, S_CELL, CASES[case], seed=11)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("S", [S_CELL, 961])
def test_kernel_on_the_slicers_boundaries(gpu, S, case):
    held_bit_equal(gpu, 64, S, CASES[case], seed=2, boundaries=True)


@pytest.mark.cuda
@pytest.mark.parametrize("S, max_frame_bits", [(2053, None), (2053, 4000), (1, None), (3000, 12)])
def test_kernel_on_long_rows_and_cut_rows(gpu, S, max_frame_bits):
    """Rows past one staged chunk (1024 symbols), and rows shorter than S k."""
    held_bit_equal(gpu, 9, S, MIXED, seed=S, max_frame_bits=max_frame_bits)


@pytest.mark.cuda
def test_kernel_at_and_below_the_noise_clamp(gpu):
    nv = [1e-12, np.nextafter(np.float32(1e-12), np.float32(0)), 1e-13, 0.0, -1.0, 1e-30, 3e-12, 1.0]
    held_bit_equal(gpu, 72, S_CELL, MIXED, seed=4, nv=nv)
    held_bit_equal(gpu, 72, 37, MIXED, seed=5, boundaries=True, nv=nv)


@pytest.mark.cuda
def test_kernel_on_nan_and_infinite_symbols(gpu):
    """An empty frame slot's equalized symbols can be NaN or infinite: the
    kernel's LLRs are NaN where the plain chain's are, equal elsewhere."""
    rxp = params(gpu, 16)
    soft, cnst, nv = frame_inputs(len(MIXED), 16, MIXED, seed=6)
    soft[:, :6] = np.array([np.nan, np.inf, -np.inf, complex(0, np.inf), complex(np.nan, 1),
                            complex(np.inf, -np.inf)], np.complex64)
    nv[-1] = np.nan
    args = on(gpu, (soft, cnst, nv))
    got, want = receiver.frame_llrs(rxp, *args), receiver._frame_llrs_torch(rxp, *args)
    torch.cuda.synchronize()
    assert bool(want.isnan().any())
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_kernel_gives_ids_past_the_table_a_row_of_zeros(gpu):
    soft, _, nv = on(gpu, frame_inputs(5, 40, [1] * 5, seed=7))
    cnst = torch.tensor([5, 99, -6, 2, -2**31], dtype=torch.int32, device=gpu)
    got = llr_cuda.frame_llrs_cuda(soft, cnst, nv, cn.active(gpu).bps, 160)
    torch.cuda.synchronize()
    assert not got[[0, 1, 2, 4]].any() and got[3, :80].ne(0).all() and not got[3, 80:].any()


@pytest.mark.cuda
def test_dispatcher_on_the_card(gpu):
    """Closed-form tables take K9 and count its frames; table mode keeps the
    plain chain and counts nothing."""
    args = on(gpu, frame_inputs(len(MIXED), 30, MIXED, seed=8))
    trace.reset()
    trace.enable()
    try:
        before = llr_cuda.frame_llrs_cuda.LAUNCHES
        receiver.frame_llrs(params(gpu, 30, table_mode=True), *args)
        assert llr_cuda.frame_llrs_cuda.LAUNCHES == before
        assert "rx.demap.llr_kernel_frames" not in trace.export()["counters"]
        receiver.frame_llrs(params(gpu, 30), *args)
        receiver.frame_llrs(params(gpu, 30), *args)
        assert llr_cuda.frame_llrs_cuda.LAUNCHES == before + 2
        assert trace.export()["counters"]["rx.demap.llr_kernel_frames"] == 2 * len(MIXED)
    finally:
        trace.disable()
        trace.reset()


@pytest.mark.cuda
def test_wrapper_refuses_on_the_card(gpu):
    soft, cnst, nv = on(gpu, frame_inputs(4, 10, [1, 2, 3, 4], seed=9))
    bps = cn.active(gpu).bps
    call = llr_cuda.frame_llrs_cuda
    before = call.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors on one device"):
        call(soft, cnst.cpu(), nv, bps, 40)
    with pytest.raises(ValueError, match="contiguous"):
        call(torch.stack([soft, soft], -1)[..., 0], cnst, nv, bps, 40)
    with pytest.raises(ValueError, match="multiple of 4"):
        call(soft, cnst, nv, bps, 42)
    assert call.LAUNCHES == before
    empty = call(soft[:0], cnst[:0], nv[:0], bps, 40)
    assert empty.shape == (0, 40) and call.LAUNCHES == before

