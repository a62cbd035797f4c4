"""K10, the codeword extraction kernel (csrc/codewords.cu), and what stands
around it.

On the CPU: the dispatcher in ``models/fec_chain._extract`` (CPU tensors
keep the plain chain, launch nothing and count nothing), the plain chain
``_extract_torch`` against ``_codewords`` as it read before K10, a numpy
model of the kernel's algorithm (the schedule's sent counts, the stream's
extent, the stage, the slots picked) against the plain chain, the
wrapper's refusals, the byte count the timing tool uses, and the timing
tool's inputs.

On the card (marked ``cuda``: these skip without an NVIDIA GPU, a CUDA
kernel has no CPU mode): K10 bit-equal (``torch.equal``, and the float32
bits) to ``_extract_torch`` on the same CUDA tensors for W in {1, 2, 3, 4},
one code and a bank of 3 codes, ids 0..4 mixed, G in {1, 7, 2048, 32768}
and the stream cell's block; rows as they lie (a wider row stride, rows
off 16 bytes, one row broadcast); a padded layout whose slabs start off 16
bytes; ``fec_frame_decode`` and ``decode_emitted`` equal through the kernel
and through the plain chain; the counter ``fec.decode.cw_kernel_groups``.
On a machine with the card but without JAX or pytest-xdist:
``python3 -m pytest -o addopts= --noconftest -q tests/test_torch_cw_cuda.py``.
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from gr_dtl_tpu_torch.models import fec_chain
from gr_dtl_tpu_torch.ops import cw_cuda, ldpc
from gr_dtl_tpu_torch.tools import bench_cw
from gr_dtl_tpu_torch.utils import alist, config, trace

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
CODES = {"single": ("n_0300_k_0152.alist",),
         "bank3": ("n_0100_k_0023.alist", "n_0100_k_0027.alist", "n_0300_k_0152.alist")}
MIXED = [1, 2, 3, 4, 0]
CPU_FRAME = 10  # payload symbols a frame on the CPU: the smallest every code of CODES fits


@functools.lru_cache(maxsize=None)
def fec_of(code: str, W: int, device: str = "cpu", frame_length: int = 20, padded: bool = False):
    """FEC tables of ``CODES[code]`` at W frames a TB; ``padded``: the bank's
    layout one parity slot wider than its codes (``Nmax`` + 1, ``Mmax`` +
    1), so that Cmax Nmax slabs start off 16 bytes."""
    cfg = config.make_tx_config(str(EXAMPLES / "config_fec.json"), frame_length=frame_length)
    Hs = [alist.load_alist(str(EXAMPLES / n)) for n in CODES[code]]
    fec = fec_chain.build_fec(cfg, Hs if len(Hs) > 1 else Hs[0], torch.device(device), tb_frames=W)
    if padded:
        fec = dataclasses.replace(fec, bank=dataclasses.replace(fec.bank, Nmax=fec.bank.Nmax + 1,
                                                                Mmax=fec.bank.Mmax + 1))
    return fec


def frames(fec, G: int, seed: int, ids=MIXED, with_fec_id: bool = False):
    """(llrs [G W, max_frame_bits] float32, cnst [G W] int32, fec_id [G W]
    int32 or None) as numpy: Gaussian rows, each group's id (and code) on
    its W frames."""
    rng = np.random.default_rng(seed)
    W = fec.W
    llrs = rng.standard_normal((G * W, fec.max_frame_bits)).astype(np.float32)
    cnst = np.repeat(np.resize(np.asarray(ids, np.int32), G), W)
    fid = np.repeat(rng.integers(1, fec.n_codes + 1, G), W).astype(np.int32) if with_fec_id else None
    return llrs, cnst, fid


def on(device, arrays):
    return tuple(None if a is None else torch.as_tensor(a, device=device) for a in arrays)


def plain_of(fec, llrs, cnst, fec_id=None):
    """``_extract_torch`` of the frames, and the schedule."""
    W = fec.W
    bps = fec_chain._bps(cnst[::W])
    s = fec_chain._cw_schedule(fec, bps, None if fec_id is None else fec_id[::W])
    return fec_chain._extract_torch(fec, llrs, bps, s), bps, s


def codewords_before(fec, llrs, cnst_id, fec_id):
    """``_codewords``' codeword LLRs as they read before K10, kept as the
    plain chain's reference."""
    W = fec.W
    if W > 1:
        G = llrs.shape[0] // W
        maxF = llrs.shape[1]
        fb = fec.frame_bits_t[fec_chain._bps(cnst_id[::W])].long()
        y = torch.arange(fec.max_group_bits, device=llrs.device)[None, :]
        f = torch.clamp(y // torch.clamp(fb[:, None], min=1), 0, W - 1)
        x = y - f * fb[:, None]
        src = torch.clamp(f * maxF + x, 0, W * maxF - 1)
        llrs = torch.where(y < W * fb[:, None], torch.gather(llrs.reshape(G, W * maxF), 1, src), 0.0)
        cnst_id = cnst_id[::W]
        fec_id = None if fec_id is None else fec_id[::W]
    G = llrs.shape[0]
    s = fec_chain._cw_schedule(fec, fec_chain._bps(cnst_id), fec_id)
    bank = fec.bank
    p = torch.arange(bank.Nmax, device=llrs.device)[None, None, :]
    m_b = s.m[:, None, None]
    is_par = p < bank.Mmax
    tsys = p - bank.Mmax
    sent = torch.where(is_par, p < m_b, tsys < s.k_prime[:, :, None]) & s.real[:, :, None]
    off = s.cw_start[:, :, None] + torch.where(is_par, p, m_b + tsys)
    pos = torch.clamp(off, 0, llrs.shape[1] - 1)
    cw = torch.gather(llrs.float(), 1, pos.reshape(G, -1)).reshape(G, fec.max_ncws, bank.Nmax)
    return torch.where(sent, cw, ldpc.SHORTENED_LLR)


def k10_model(fec, llrs, bps, s) -> np.ndarray:
    """K10's algorithm in numpy, as the source writes it, a group at a time:
    the sent counts and the extent of the stream the sent slots read, the
    stage (the row at W = 1; the W rows' first fb LLRs one after another,
    zeros up to the extent, at W > 1), every slot picked from the stage
    (its index clamped to [0, L - 1]) or pinned."""
    W, maxF = fec.W, llrs.shape[1]
    L = W * maxF
    Mmax, Nmax = fec.bank.Mmax, fec.bank.Nmax
    llrs, bps = llrs.numpy(), bps.numpy()
    fbt = fec.frame_bits_t.numpy()
    m_of, kp, st, real = (t.numpy() for t in (s.m, s.k_prime, s.cw_start, s.real))
    G, Cmax = kp.shape
    out = np.empty((G, Cmax, Nmax), np.float32)
    p = np.arange(Nmax)[None, :]
    for g in range(G):
        m = int(m_of[g])
        n_par = np.where(real[g], np.clip(m, 0, Mmax), 0)
        n_sys = np.where(real[g], np.maximum(kp[g], 0), 0)
        end = np.where(n_sys > 0, st[g] + m + n_sys, np.where(n_par > 0, st[g] + n_par, 0))
        extent = int(max(1, np.clip(end[real[g]], 1, L).max(initial=1)))
        if W == 1:
            stage = llrs[g, :extent].copy()
        else:
            b = int(bps[g])
            fb = int(fbt[b]) if 0 <= b < fbt.size else 0
            stage = np.zeros(extent, np.float32)
            done = 0
            for f in range(W):
                if fb <= 0 or done >= extent:
                    break
                n = min(fb, extent - done)
                stage[done:done + n] = llrs[g * W + f, :n]
                done += n
        par = p < Mmax
        sent = np.where(par, p < n_par[:, None], p - Mmax < n_sys[:, None])
        off = np.clip(st[g][:, None] + np.where(par, p, m + p - Mmax), 0, L - 1)
        assert (off[sent] < extent).all(), "a sent slot reads past the staged extent"
        out[g] = np.where(sent, stage[np.minimum(off, extent - 1)], np.float32(ldpc.SHORTENED_LLR))
    return out


# ---------------------------------------------------------------------------
# CPU: the dispatcher, the plain chain, the kernel's model, refusals, bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", [1, 2])
def test_cpu_tensors_take_the_plain_chain_and_count_nothing(W):
    fec = fec_of("single", W, frame_length=CPU_FRAME)
    llrs, cnst, _ = on("cpu", frames(fec, 6, seed=W))
    before = cw_cuda.codewords_cuda.LAUNCHES
    trace.reset()
    trace.enable()
    try:
        out = fec_chain.fec_frame_decode(fec, llrs, cnst)
        got = fec_chain._codewords(fec, llrs, cnst, None, None)[0]
        counters = trace.export()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert cw_cuda.codewords_cuda.LAUNCHES == before
    assert "fec.decode.cw_kernel_groups" not in counters and counters["fec.codeword_slots"] == 6 * fec.max_ncws
    assert out.payload.shape[0] == 6 * W
    assert torch.equal(got, plain_of(fec, llrs, cnst)[0])


@pytest.mark.parametrize("with_fec_id", [False, True])
@pytest.mark.parametrize("code", list(CODES))
@pytest.mark.parametrize("W", [1, 2, 3])
def test_plain_chain_is_what_codewords_gave_before(W, code, with_fec_id):
    fec = fec_of(code, W, frame_length=CPU_FRAME)
    llrs, cnst, fid = on("cpu", frames(fec, 10, seed=10 * W + with_fec_id, with_fec_id=with_fec_id))
    got, s, tbp, fid_g = fec_chain._codewords(fec, llrs, cnst, None, fid)
    assert got.dtype == torch.float32 and got.shape == (10, fec.max_ncws, fec.bank.Nmax)
    assert torch.equal(got, codewords_before(fec, llrs, cnst, fid))
    assert tbp is None and (fid_g is None) == (fid is None)
    # every id's codewords are there: real slots hold the rows' LLRs, the rest the pin
    assert bool((got[~s.real] == ldpc.SHORTENED_LLR).all())


@pytest.mark.parametrize("layout", ["single", "bank3", "padded"])
@pytest.mark.parametrize("W", [1, 2, 3])
def test_kernel_model_is_the_plain_chain(W, layout):
    """The kernel's algorithm (extent, stage, pick) gives the plain chain's
    slots for ids 0..4, one code and a bank, and a layout wider than the
    codes."""
    fec = fec_of("single" if layout == "padded" else layout, W, frame_length=CPU_FRAME, padded=layout == "padded")
    llrs, cnst, fid = on("cpu", frames(fec, 10, seed=W, with_fec_id=layout == "bank3"))
    want, bps, s = plain_of(fec, llrs, cnst, fid)
    np.testing.assert_array_equal(k10_model(fec, llrs, bps, s), want.numpy())


def test_kernel_model_takes_rows_as_they_lie():
    """A row stride wider than the row: the plain chain and the model read
    the same values (the kernel gets the stride)."""
    fec = fec_of("single", 2, frame_length=CPU_FRAME)
    llrs, cnst, _ = on("cpu", frames(fec, 7, seed=3))
    wide = torch.zeros((llrs.shape[0], llrs.shape[1] + 3))
    wide[:, 1:-2] = llrs
    rows = wide[:, 1:-2]
    assert rows.stride() == (llrs.shape[1] + 3, 1)
    want, bps, s = plain_of(fec, rows, cnst)
    assert torch.equal(want, plain_of(fec, llrs, cnst)[0])
    np.testing.assert_array_equal(k10_model(fec, rows.contiguous(), bps, s), want.numpy())


def schedule_args(fec, G=4, device="cpu"):
    llrs, cnst, _ = on(device, frames(fec, G, seed=1))
    _, bps, s = plain_of(fec, llrs, cnst)
    return llrs, bps, s


def call(fec, llrs, bps, s, **over):
    a = dict(llrs=llrs, W=fec.W, bps=bps, frame_bits=fec.frame_bits_t, m=s.m, k_prime=s.k_prime,
             cw_start=s.cw_start, real=s.real, Mmax=fec.bank.Mmax, Nmax=fec.bank.Nmax, pin=ldpc.SHORTENED_LLR)
    a.update(over)
    return cw_cuda.codewords_cuda(**a)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    fec = fec_of("single", 2, frame_length=CPU_FRAME)
    llrs, bps, s = schedule_args(fec)
    before = cw_cuda.codewords_cuda.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(fec, llrs, bps, s)
    with pytest.raises(ValueError, match="float32 rows"):
        call(fec, llrs.double(), bps, s)
    with pytest.raises(ValueError, match="float32 rows"):
        call(fec, llrs.t().contiguous().t(), bps, s)
    with pytest.raises(ValueError, match=r"\[B, max_frame_bits\]"):
        call(fec, llrs[0], bps, s)
    with pytest.raises(ValueError, match="multiple of W"):
        call(fec, llrs[:-1], bps, s)
    with pytest.raises(ValueError, match="k_prime as"):
        call(fec, llrs[:4], bps, s)
    with pytest.raises(ValueError, match="int64"):
        call(fec, llrs, bps.int(), s)
    with pytest.raises(ValueError, match="int32"):
        call(fec, llrs, bps, s, frame_bits=fec.frame_bits_t.long())
    with pytest.raises(ValueError, match="shape"):
        call(fec, llrs, bps, s, m=s.m[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        call(fec, llrs, bps, s, cw_start=s.cw_start.t().contiguous().t())
    with pytest.raises(ValueError, match="torch.bool"):
        call(fec, llrs, bps, s, real=s.real.int())
    with pytest.raises(ValueError, match="Mmax <= Nmax"):
        call(fec, llrs, bps, s, Mmax=fec.bank.Nmax + 1)
    with pytest.raises(ValueError, match="shared memory"):  # 16 frames of 3,840 LLRs a group
        call(fec, torch.zeros((16 * 4, 3840)), bps, s, W=16)
    assert cw_cuda.codewords_cuda.LAUNCHES == before


def test_shared_memory_a_block():
    # the stream cell's W = 2: the 7,680-float stage and 26 codewords' schedule
    assert cw_cuda.smem_bytes(2, 3840, 26) == 30_720 + 416
    assert cw_cuda.smem_bytes(1, 3840, 13) == 15_360 + 208
    assert cw_cuda.smem_bytes(1, 5, 3) == 32 + 48  # the stage rounded up to 16 bytes
    assert cw_cuda.smem_bytes(16, 3840, 1) > cw_cuda.SMEM_MAX >= cw_cuda.smem_bytes(15, 3840, 100)


def test_cw_bytes_counts_every_input_and_output_once():
    # the batch cell's step: 1,916 LLRs read a QPSK frame, 13 x 300 slots written
    assert cw_cuda.cw_bytes(32_768, 13, 300, 32_768 * 1916) == (
        4 * 32_768 * 1916 + 32_768 * 16 + 32_768 * 13 * 17 + 20 + 4 * 32_768 * 13 * 300)
    assert cw_cuda.cw_bytes(1, 1, 1, 0, n_fb=1) == 16 + 17 + 4 + 4


@pytest.mark.parametrize("W", [1, 2])
def test_timing_tools_llrs_read_are_the_sent_bits(W):
    """What ``bench_cw`` counts as read: each group's ncws m check bits and
    its TB payload, from the tables, for ids 1..4."""
    fec = fec_of("single", W)
    llrs, cnst = bench_cw.inputs(8, W, "mixed", 5, "cpu")
    bps, s = bench_cw.schedule(fec, cnst)
    want = sum(int(fec.ncws_tab2[1, b]) * fec.m + int(fec.tb_payload_t[1, b]) for b in bps.tolist())
    assert bench_cw.llrs_read(fec, s) == want
    if W == 1:
        assert int(fec.ncws_tab2[1, 2]) * fec.m + int(fec.tb_payload_t[1, 2]) == 1916  # a QPSK frame
    assert bench_cw.nbytes(fec, s) == cw_cuda.cw_bytes(8, fec.max_ncws, fec.n, want)


def test_timing_tool_draws_each_groups_ids():
    llrs, cnst = bench_cw.inputs(32, 2, "ladder", 7, "cpu", frame_length=5)
    assert llrs.shape == (64, bench_cw.fec_params(2, "cpu", 5).max_frame_bits) and llrs.dtype == torch.float32
    assert cnst.tolist() == [bench_cw.LADDER[g // 2] for g in range(32) for _ in range(2)]
    assert torch.equal(llrs, bench_cw.inputs(32, 2, "ladder", 7, "cpu", frame_length=5)[0])
    assert bool((bench_cw.group_ids(8, "qpsk", "cpu") == 2).all())
    assert bench_cw.group_ids(8, "mixed", "cpu").tolist() == [1, 2, 3, 4, 1, 2, 3, 4]


def test_timing_tools_variants_find_their_text_in_the_source():
    src = cw_cuda.SOURCE.read_text()
    for name, edits in bench_cw.VARIANTS.items():
        assert all(src.count(old) == 1 for old, _ in edits), name


def test_library_path_needs_no_compiler():
    assert cw_cuda.library_path().name.startswith("libcodewords_")
    assert cw_cuda.SOURCE.is_file()


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def held_bit_equal(fec, llrs, cnst, fec_id=None):
    """K10 through ``_codewords`` against ``_extract_torch`` on the same card
    tensors: one launch, equal values and equal bits."""
    before = cw_cuda.codewords_cuda.LAUNCHES
    got = fec_chain._codewords(fec, llrs, cnst, None, fec_id)[0]
    want = plain_of(fec, llrs, cnst, fec_id)[0]
    torch.cuda.synchronize()
    assert cw_cuda.codewords_cuda.LAUNCHES == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 7, 2048])
@pytest.mark.parametrize("code", list(CODES))
@pytest.mark.parametrize("W", [1, 2, 3])
def test_kernel_is_bit_equal_to_the_plain_chain(gpu, W, code, G):
    fec = fec_of(code, W, str(gpu))
    held_bit_equal(fec, *on(gpu, frames(fec, G, seed=G + W, with_fec_id=code == "bank3")))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 2])
def test_kernel_at_32k_groups(gpu, W):
    fec = fec_of("single", W, str(gpu))
    held_bit_equal(fec, *on(gpu, frames(fec, 32_768, seed=W)))


@pytest.mark.cuda
def test_kernel_at_the_stream_cells_block(gpu):
    """G = 32,768 groups of 2 frames in the ladder's 16 runs, as the tool draws them."""
    fec = bench_cw.fec_params(2, str(gpu))
    llrs, cnst = bench_cw.inputs(32_768, 2, "ladder", 11, gpu)
    held_bit_equal(fec, llrs, cnst)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [4, 1])
def test_kernel_past_48_kib_of_shared_memory_and_with_a_bank(gpu, W):
    """W = 4 stages 60 KiB a group (the launch raises the block's limit)."""
    fec = fec_of("bank3", W, str(gpu))
    held_bit_equal(fec, *on(gpu, frames(fec, 300, seed=4, with_fec_id=True)))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 2])
def test_kernel_on_a_padded_layout(gpu, W):
    """Slabs of Cmax (Nmax + 1) slots: most groups start off 16 bytes (the
    scalar head and tail)."""
    fec = fec_of("single", W, str(gpu), padded=True)
    assert (fec.max_ncws * fec.bank.Nmax) % 4
    held_bit_equal(fec, *on(gpu, frames(fec, 257, seed=5)))


@pytest.mark.cuda
@pytest.mark.parametrize("lay", ["wide stride", "off 16 bytes", "one row broadcast"])
@pytest.mark.parametrize("W", [1, 2])
def test_kernel_reads_rows_as_they_lie(gpu, W, lay):
    fec = fec_of("single", W, str(gpu))
    llrs, cnst, _ = on(gpu, frames(fec, 33, seed=6))
    B, F = llrs.shape
    if lay == "wide stride":
        wide = torch.zeros((B, F + 8), device=gpu)
        wide[:, 4:-4] = llrs
        rows = wide[:, 4:-4]
    elif lay == "off 16 bytes":
        wide = torch.zeros((B, F + 1), device=gpu)
        wide[:, 1:] = llrs
        rows = wide[:, 1:]
    else:
        rows = llrs[:1].expand(B, F)
    assert not rows.is_contiguous()
    held_bit_equal(fec, rows, cnst)


def decode_fields_equal(got, want):
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["W1 single", "W2 bank3"])
def test_fec_frame_decode_through_the_kernel_and_the_plain_chain(gpu, case, monkeypatch):
    W, code = (1, "single") if case == "W1 single" else (2, "bank3")
    fec = fec_of(code, W, str(gpu))
    llrs, cnst, fid = on(gpu, frames(fec, 512, seed=8, ids=[1, 2, 3, 4], with_fec_id=code == "bank3"))
    llrs = llrs * 4 + 2  # BP converges on some codewords
    before = cw_cuda.codewords_cuda.LAUNCHES
    got = fec_chain.fec_frame_decode(fec, llrs, cnst, fec_id=fid)
    assert cw_cuda.codewords_cuda.LAUNCHES == before + 1
    monkeypatch.setattr(fec_chain, "_extract", fec_chain._extract_torch)
    want = fec_chain.fec_frame_decode(fec, llrs, cnst, fec_id=fid)
    torch.cuda.synchronize()
    assert cw_cuda.codewords_cuda.LAUNCHES == before + 1
    decode_fields_equal(got, want)


@pytest.mark.cuda
def test_decode_emitted_through_the_kernel_and_the_plain_chain(gpu, monkeypatch):
    fec = fec_of("single", 2, str(gpu))
    rng = np.random.default_rng(9)
    Fn = 600
    emitted = {"llrs": torch.as_tensor(rng.standard_normal((Fn, 2, fec.max_frame_bits)).astype(np.float32) * 3 + 1,
                                       device=gpu),
               "cnst": torch.as_tensor(rng.integers(-1, 6, Fn), dtype=torch.int32, device=gpu).clamp(0, 4),
               "plen": torch.as_tensor(rng.integers(0, 9000, Fn), dtype=torch.int32, device=gpu),
               "fec_id": torch.ones(Fn, dtype=torch.int32, device=gpu),
               "tb_no": torch.arange(Fn, dtype=torch.int32, device=gpu),
               "valid": torch.as_tensor(rng.random(Fn) < 0.5, device=gpu)}
    trace.reset()
    trace.enable()
    try:
        got = fec_chain.decode_emitted(fec, emitted)
        counters = trace.export()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert counters["fec.decode.cw_kernel_groups"] == Fn
    monkeypatch.setattr(fec_chain, "_extract", fec_chain._extract_torch)
    want = fec_chain.decode_emitted(fec, emitted)
    torch.cuda.synchronize()
    decode_fields_equal(got, want)


@pytest.mark.cuda
def test_counter_counts_the_groups_the_kernel_extracted(gpu):
    fec = fec_of("single", 2, str(gpu))
    llrs, cnst, _ = on(gpu, frames(fec, 40, seed=10))
    trace.reset()
    trace.enable()
    try:
        fec_chain.fec_frame_decode(fec, llrs, cnst)
        fec_chain.fec_frame_decode(fec, llrs, cnst)
        counters = trace.export()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert counters["fec.decode.cw_kernel_groups"] == 80


@pytest.mark.cuda
def test_wrapper_refuses_on_the_card(gpu):
    fec = fec_of("single", 2, str(gpu))
    llrs, bps, s = schedule_args(fec, device=gpu)
    before = cw_cuda.codewords_cuda.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors on one device"):
        call(fec, llrs, bps, s, m=s.m.cpu())
    with pytest.raises(ValueError, match="float32 rows"):
        call(fec, torch.stack([llrs, llrs], -1)[..., 0], bps, s)
    assert cw_cuda.codewords_cuda.LAUNCHES == before
    empty = call(fec, llrs[:0], bps[:0], fec_chain._Schedule(*(t[:0] for t in s)))
    assert empty.shape == (0, fec.max_ncws, fec.bank.Nmax) and cw_cuda.codewords_cuda.LAUNCHES == before
