"""The TB ring kernels (csrc/tb_ring.cu) against the plain PyTorch loop, on
the card: every emitted tensor and every leaf of the new carry equal (the
copy is exact: error 0 on the LLRs, equality on ints and bools).  Marked
``cuda``: these skip without an NVIDIA GPU (a CUDA kernel has no CPU mode).
On a machine with the card but without JAX or pytest-xdist:
``python3 -m pytest -o addopts= --noconftest -q tests/test_torch_tb_cuda.py``.

:func:`tb_headers` (random header sequences that exercise every branch of
the reassembly) is shared with the CPU parity cases of
tests/test_torch_fec_chain.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from gr_dtl_tpu_torch.models import fec_chain
from gr_dtl_tpu_torch.ops import tb_cuda
from gr_dtl_tpu_torch.utils import alist, config

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def tb_headers(F, W, frame_bits_tab, max_f, seed, tb0=0):
    """F header records and LLR rows: lost frames (ok False, any fields),
    TB numbers that stay, advance, skip and fall back to an earlier one,
    constellation ids outside 1..4, offsets on a slot's edge, past the last
    slot and negative.  numpy: (llrs, tb_no, tb_offset, cnst_id, tb_payload,
    fec_id, ok)."""
    rng = np.random.RandomState(seed)
    ok = rng.rand(F) > 0.25
    tb_no = tb0 + np.cumsum(rng.choice([0, 1, 3], F, p=[1 - 0.9 / W, 0.8 / W, 0.1 / W]))
    back = rng.rand(F) < 0.08
    tb_no[back] -= rng.randint(1, 3, int(back.sum()))  # a repeated, earlier number
    cnst = rng.randint(1, 5, F)
    odd = rng.rand(F) < 0.15
    cnst[odd] = rng.choice([-2, 0, 5, 9], int(odd.sum()))
    fb = np.asarray(frame_bits_tab)[np.clip(cnst, 0, 4)]
    offset = rng.randint(0, W, F) * fb + rng.choice([0, 0, 1, -1], F) * rng.randint(0, 2, F)
    far = rng.rand(F) < 0.1
    offset[far] = rng.randint(W, 3 * W + 1, int(far.sum())) * np.maximum(fb[far], 1)
    neg = rng.rand(F) < 0.05
    offset[neg] = -rng.randint(1, 2000, int(neg.sum()))
    i32 = lambda a: np.asarray(a, np.int32)
    return (rng.randn(F, max_f).astype(np.float32), i32(tb_no), i32(offset), i32(cnst),
            i32(rng.randint(0, 5000, F)), i32(rng.randint(0, 4, F)), ok)


def assert_tb_equal(got, want):
    """(state, emitted) pairs: every leaf equal in dtype, shape and bits."""
    (st, em), (st0, em0) = got, want
    for name, a, b in zip(fec_chain.TbRing._fields, st, st0):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.cpu(), b.cpu()), f"state.{name}"
    assert em.keys() == em0.keys()
    for k in em0:
        assert em[k].dtype == em0[k].dtype and em[k].shape == em0[k].shape, k
        assert torch.equal(em[k].cpu(), em0[k].cpu()), f"emitted {k}"


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _fec(W, device, frame_length=20):
    cfg = config.make_tx_config(str(EXAMPLES / "config_fec.json"), frame_length=frame_length)
    H = alist.load_alist(str(EXAMPLES / "n_0300_k_0152.alist"))
    return fec_chain.build_fec(cfg, H, device, tb_frames=W)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("F", [0, 1, 8, 64, 257, 1024])
def test_tb_ring_kernels_match_plain_loop(gpu, W, F):
    """Three chained calls from the initial state, so the second and third
    start from a carried-in buffer; two launches a call."""
    fec = _fec(W, gpu)
    fb_tab = fec.cfg.frame_capacity_symbols * np.arange(5)
    state = plain = fec_chain.init_tb_state(fec, gpu)
    tb0 = 0
    for call in range(3):
        args = [torch.as_tensor(a, device=gpu)
                for a in tb_headers(F, W, fb_tab, fec.max_frame_bits, 100 * F + 10 * W + call, tb0)]
        before = tb_cuda.tb_reassemble_cuda.LAUNCHES
        got = fec_chain.tb_reassemble(state, *args, fec)
        assert tb_cuda.tb_reassemble_cuda.LAUNCHES == before + 2
        want = fec_chain._tb_reassemble_torch(plain, *args, fec)
        torch.cuda.synchronize()
        assert_tb_equal(got, want)
        state, plain = got[0], want[0]
        tb0 = int(args[1].max()) if F else tb0


@pytest.mark.cuda
def test_tb_ring_carry_works_with_flush_snapshot_and_restore(gpu):
    """The new carry is a TbRing like any other: it can be decoded as
    flush_tb decodes it, read to numpy and put back."""
    fec = _fec(2, gpu, frame_length=10)
    fb_tab = fec.cfg.frame_capacity_symbols * np.arange(5)
    args = [torch.as_tensor(a, device=gpu) for a in tb_headers(16, 2, fb_tab, fec.max_frame_bits, 5)]
    state, _ = fec_chain.tb_reassemble(fec_chain.init_tb_state(fec, gpu), *args, fec)
    back = fec_chain.TbRing(*(torch.tensor(a.cpu().numpy(), device=gpu) for a in state))
    again = fec_chain.tb_reassemble(back, *args, fec)
    assert_tb_equal(again, fec_chain.tb_reassemble(state, *args, fec))
    emitted = {"llrs": state.llrs[None], "cnst": state.cnst[None], "plen": state.plen[None],
               "fec_id": state.fec_id[None], "tb_no": state.tb_no[None],
               "valid": torch.tensor([True], device=gpu)}
    assert fec_chain.decode_emitted(fec, emitted).payload.shape[0] == 1


@pytest.mark.cuda
def test_tb_ring_wrapper_refuses_what_the_kernels_do_not_take(gpu):
    fec = _fec(2, gpu, frame_length=10)
    fb_tab = fec.cfg.frame_capacity_symbols * np.arange(5)
    args = [torch.as_tensor(a, device=gpu) for a in tb_headers(4, 2, fb_tab, fec.max_frame_bits, 1)]
    state = tuple(fec_chain.init_tb_state(fec, gpu))
    with pytest.raises(ValueError):  # a CPU tensor
        tb_cuda.tb_reassemble_cuda(state, args[0].cpu(), *args[1:], fb_tab)
    with pytest.raises(ValueError):  # int64 header fields
        tb_cuda.tb_reassemble_cuda(state, args[0], args[1].long(), *args[2:], fb_tab)
    with pytest.raises(ValueError):  # rows that are not contiguous
        tb_cuda.tb_reassemble_cuda(state, args[0].repeat(1, 2)[:, ::2], *args[1:], fb_tab)
    with pytest.raises(ValueError):  # four table entries
        tb_cuda.tb_reassemble_cuda(state, *args, fb_tab[:4])


def test_tb_bytes_counts_every_input_and_output_once():
    F, W, max_f = 64, 2, 3840
    rows = 4 * max_f * ((F + W) + (F + 1) * W)
    assert tb_cuda.tb_bytes(F, W, max_f) == rows + (21 + 17) * F + 2 * (16 + W)
