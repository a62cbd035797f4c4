"""Soft LLRs and the FEC frame codec, port against the JAX package:
``soft_llrs`` (and the port's own ``soft_llrs_table`` oracle), the
``build_fec`` tables, ``fec_frame_build``/``fec_frame_decode`` for one
code, the two-code bank and W=2 transport blocks, and streaming TB
reassembly (``tb_reassemble``, ``decode_emitted``) on the scenario of
tests/test_tb_resync.py.

Bits, bytes, ints, bools and ``avg_iters`` (a ratio of integer counts)
must be equal.  Float tolerances, float32 on both sides:
 - ``soft_llrs`` against the reference: atol 1e-5 + rtol 1e-5, the same
   closed forms with XLA's and PyTorch's roundings of a few products;
 - ``soft_llrs`` against ``soft_llrs_table``: atol 1e-3 + rtol 1e-4.
   The table form subtracts two squared distances of order |y|^2/sigma^2
   (up to ~2e3 here), so it loses ~1e-4 absolute to cancellation.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import fec_chain as ref_fec
from gr_dtl_tpu.ops import constellation as ref_cn
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch.models import fec_chain
from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.utils import alist, config
from test_torch_host_constants import _assert_same
from test_torch_ldpc import _assert_tree_equal
from test_torch_tb_cuda import assert_tb_equal, tb_headers

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
CASES = {  # name: (alists, tb_frames)
    "single": (["n_0300_k_0152.alist"], 1),
    "bank": (["n_0100_k_0027.alist", "n_0300_k_0152.alist"], 1),
    "w2": (["n_0100_k_0027.alist"], 2),
}


def _H(names):
    Hs = [alist.load_alist(str(EXAMPLES / n)) for n in names]
    return Hs if len(Hs) > 1 else Hs[0]


def _tensors_equal(got, want, names):
    for name in names:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("cid", [1, 2, 3, 4])
def test_soft_llrs_match_reference_and_table(cid):
    rng = np.random.RandomState(cid)
    B, n = 6, 40
    pts = ref_cn.POINTS[cid][rng.randint(0, 1 << int(ref_cn.BITS_PER_SYMBOL[cid]), (B, n))]
    y = (pts + 0.3 * (rng.randn(B, n) + 1j * rng.randn(B, n))).astype(np.complex64)
    y[0, :4] = [0.0, 1e-3, -1e-3j, 0.7 + 0.7j]  # on and near decision boundaries
    cnst = np.full((B, 1), cid, np.int32)
    nv = rng.uniform(0.01, 0.5, (B, 1)).astype(np.float32)
    want = np.asarray(jax.jit(ref_cn.soft_llrs)(jnp.asarray(y), jnp.asarray(cnst), jnp.asarray(nv)))
    args = (torch.as_tensor(y), torch.as_tensor(cnst), torch.as_tensor(nv))
    got = cn.soft_llrs(*args)
    assert got.dtype == torch.float32 and got.shape == (B, n, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), cn.soft_llrs_table(*args).numpy(), atol=1e-3, rtol=1e-4)
    assert (got[..., int(ref_cn.BITS_PER_SYMBOL[cid]):] == 0).all()


def _ref_fec(case, frame_length=10):
    names, W = CASES[case]
    ref_cfg = ref_config.make_tx_config(None, frame_length=frame_length, fec=True)
    return ref_fec.build_fec(ref_cfg, _H(names), tb_frames=W)


@pytest.mark.parametrize("case", list(CASES))
def test_fec_tables_equal(case):
    names, W = CASES[case]
    ref = _ref_fec(case)
    cfg = config.make_tx_config(None, frame_length=10, fec=True)
    own = fec_chain.make_fec_tables(cfg, _H(names), tb_frames=W)
    _assert_tree_equal(own, ref)
    built = fec_chain.build_fec(cfg, _H(names), "cpu", tb_frames=W)
    _assert_same(fec_chain.fec_from_reference(ref, "cpu"), built)
    assert (built.n_codes, built.W, built.n, built.k, built.m) == (
        ref["n_codes"], W, ref["n"], ref["k"], ref["m"])
    np.testing.assert_array_equal(built.user_bytes_tab, ref["user_bytes_tab"])


def _codec_inputs(fec, rng, B):
    """Mixed constellations (uniform within a W-group), per-frame codes for
    a bank, payloads filled to capacity except two partial rows."""
    W, C = fec["W"], fec["n_codes"]
    cnst = np.repeat(rng.randint(1, 5, B // W), W).astype(np.int32)
    cnst[: min(B, 4 * W)] = np.repeat(np.arange(1, 5), W)[: min(B, 4 * W)]  # every bps
    fec_id = rng.randint(1, C + 1, B).astype(np.int32) if C > 1 else None
    bps = ref_cn.BITS_PER_SYMBOL[cnst]
    ub = fec["user_bytes_tab2"][1 if fec_id is None else fec_id, bps].astype(np.int32)
    ub[-W] = ub[-W] // 3  # partially filled transport blocks
    ub[-2 * W] = 0
    payload = np.zeros((B, fec["max_payload_bytes"]), np.uint8)
    for i in range(B):
        payload[i, : ub[i]] = rng.randint(0, 256, ub[i])
    return payload, ub, cnst, fec_id


@pytest.mark.parametrize("case", list(CASES))
def test_frame_build_and_decode_match_reference(case):
    ref = _ref_fec(case)
    fec = fec_chain.fec_from_reference(ref, "cpu")
    rng = np.random.RandomState(len(case))
    B = 8
    payload, ub, cnst, fec_id = _codec_inputs(ref, rng, B)
    jid = None if fec_id is None else jnp.asarray(fec_id)
    tid = None if fec_id is None else torch.as_tensor(fec_id)

    bits_r, tbp_r = jax.jit(lambda p, l, c, f: ref_fec.fec_frame_build(ref, p, l, c, fec_id=f))(
        jnp.asarray(payload), jnp.asarray(ub), jnp.asarray(cnst), jid)
    bits, tbp = fec_chain.fec_frame_build(fec, torch.as_tensor(payload), torch.as_tensor(ub),
                                          torch.as_tensor(cnst), fec_id=tid)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_r))
    np.testing.assert_array_equal(tbp.numpy(), np.asarray(tbp_r))
    assert bits.dtype == torch.int32 and tbp.dtype == torch.int32

    # noisy LLRs: BP iterates; the header-carried TB length, and the
    # schedule's default for it
    llrs = ((1.0 - 2.0 * np.asarray(bits_r, np.float32)) * 3.0
            + rng.randn(*bits.shape).astype(np.float32))
    for P in (None, tbp):
        want = jax.jit(lambda x, c, p, f: ref_fec.fec_frame_decode(ref, x, c, p, fec_id=f))(
            jnp.asarray(llrs), jnp.asarray(cnst), None if P is None else jnp.asarray(P.numpy()),
            jid)
        got = fec_chain.fec_frame_decode(fec, torch.as_tensor(llrs), torch.as_tensor(cnst), P,
                                         fec_id=tid)
        _tensors_equal(got, want, ref_fec.FecFrameOut._fields)
    # the link works with the header-carried length: every frame decodes
    # its payload (group payloads on the first frame of each group)
    assert got.crc_ok.all() and float(got.avg_iters.max()) > 0
    first = np.arange(B) % ref["W"] == 0
    np.testing.assert_array_equal(got.payload.numpy()[first], payload[first])


def test_tb_reassemble_and_decode_emitted_match_reference():
    ref = _ref_fec("w2")
    fec = fec_chain.fec_from_reference(ref, "cpu")
    fb = int(ref["frame_bits_tab"][1])  # BPSK frame bits
    maxF = ref["max_frame_bits"]

    def both(state_r, state, *args):
        out_r = jax.jit(lambda s, *a: ref_fec.tb_reassemble(s, *a, ref))(
            state_r, *[jnp.asarray(a) for a in args])
        out = fec_chain.tb_reassemble(state, *[torch.as_tensor(a) for a in args], fec)
        _tensors_equal(out[0], out_r[0], ref_fec.TbRing._fields)
        for k in out_r[1]:
            np.testing.assert_array_equal(out[1][k].numpy(), np.asarray(out_r[1][k]), err_msg=k)
        return out_r, out

    # tests/test_tb_resync.py: 6 frames = 3 TBs, frame 3 (TB 1 slot 1) lost
    F = 6
    llrs = np.zeros((F, maxF), np.float32)
    for i in range(F):
        llrs[i, :fb] = float(i + 1)
    tb_no = np.array([0, 0, 1, 1, 2, 2], np.int32)
    tb_off = np.array([0, fb, 0, fb, 0, fb], np.int32)
    ok = np.array([1, 1, 1, 0, 1, 1], bool)
    plen = np.full(F, int(ref["tb_payload_tab"][1]), np.int32)
    ones = np.ones(F, np.int32)
    (st_r, em_r), (st, em) = both(ref_fec.init_tb_state(ref), fec_chain.init_tb_state(fec, "cpu"),
                                  llrs, tb_no, tb_off, ones, plen, ones, ok)
    assert list(np.nonzero(em["valid"].numpy())[0]) == [2, 4]
    assert int(st.tb_no) == 2

    # real coded TBs: 4 groups of QPSK, frame 5 (TB 2 slot 1) lost, then
    # a second batch starting a new TB flushes the last one
    rng = np.random.RandomState(3)
    B = 8
    cnst = np.full(B, 2, np.int32)
    ub = np.zeros(B, np.int32)
    ub[::2] = ref["user_bytes_tab"][2]
    payload = np.zeros((B, ref["max_payload_bytes"]), np.uint8)
    for i in range(0, B, 2):
        payload[i, : ub[i]] = rng.randint(0, 256, ub[i])
    bits, tbp = fec_chain.fec_frame_build(fec, torch.as_tensor(payload), torch.as_tensor(ub),
                                          torch.as_tensor(cnst))
    llrs = ((1.0 - 2.0 * bits.numpy().astype(np.float32)) * 3.0
            + rng.randn(*bits.shape).astype(np.float32))
    fbq = int(ref["frame_bits_tab"][2])
    tb_no = (np.arange(B) // 2).astype(np.int32)
    tb_off = ((np.arange(B) % 2) * fbq).astype(np.int32)
    ok = np.ones(B, bool)
    ok[5] = False
    (st_r, em_r), (st, em) = both(st_r, st, llrs, tb_no, tb_off, cnst, tbp.numpy(),
                                  np.ones(B, np.int32), ok)
    want = jax.jit(lambda e: ref_fec.decode_emitted(ref, e))(em_r)
    got = fec_chain.decode_emitted(fec, em)
    _tensors_equal(got, want, ref_fec.FecFrameOut._fields)
    # frame 0 flushes the marker TB 2 left in the carry, TB 0 comes out
    # when TB 1 starts (frame 2), TB 1 at frame 4, TB 2 (one slot erased)
    # at frame 6; the link works for the intact ones
    assert list(np.nonzero(em["valid"].numpy())[0]) == [0, 2, 4, 6]
    assert got.crc_ok[2] and got.crc_ok[4]
    np.testing.assert_array_equal(got.payload.numpy()[2], payload[0])
    np.testing.assert_array_equal(got.payload.numpy()[4], payload[2])

    # the next batch announces a new TB: TB 3 comes out of the carry
    (_, em_r), (_, em) = both(st_r, st, llrs[:1], np.array([9], np.int32), tb_off[:1],
                              cnst[:1], tbp.numpy()[:1], np.ones(1, np.int32), ok[:1])
    want = jax.jit(lambda e: ref_fec.decode_emitted(ref, e))(em_r)
    got = fec_chain.decode_emitted(fec, em)
    _tensors_equal(got, want, ref_fec.FecFrameOut._fields)
    assert got.crc_ok[0] and int(em["tb_no"][0]) == 3
    np.testing.assert_array_equal(got.payload.numpy()[0], payload[6])


@pytest.mark.parametrize("W", [1, 2, 4])
def test_tb_reassemble_matches_reference_on_random_headers(W):
    """The reassembly's every branch (``tb_headers``: lost frames, repeated
    and skipped TB numbers, constellation ids outside 1..4, offsets past
    the last slot and negative ones) over three chained calls, so the later
    ones start from a carried-in buffer: every emitted tensor and every leaf
    of the carry equal the reference's scan.  On the CPU the port runs its
    plain loop, which the CUDA kernels are held against on the card."""
    ref_cfg = ref_config.make_tx_config(None, frame_length=10, fec=True)
    ref = ref_fec.build_fec(ref_cfg, _H(["n_0100_k_0027.alist"]), tb_frames=W)
    fec = fec_chain.fec_from_reference(ref, "cpu")
    scan = jax.jit(lambda s, *a: ref_fec.tb_reassemble(s, *a, ref))
    state_r, state, tb0 = ref_fec.init_tb_state(ref), fec_chain.init_tb_state(fec, "cpu"), 0
    n_valid = 0
    for call in range(3):
        args = tb_headers(12, W, ref["frame_bits_tab"], ref["max_frame_bits"], 10 * W + call, tb0)
        state_r, em_r = scan(state_r, *[jnp.asarray(a) for a in args])
        targs = [torch.as_tensor(a) for a in args]
        state, em = fec_chain.tb_reassemble(state, *targs, fec)
        _tensors_equal(state, state_r, ref_fec.TbRing._fields)
        assert em.keys() == em_r.keys()
        for k in em_r:
            want = np.asarray(em_r[k])
            assert em[k].numpy().dtype == want.dtype, k
            np.testing.assert_array_equal(em[k].numpy(), want, err_msg=f"call {call} {k}")
        tb0 = int(args[1].max())
        n_valid += int(em["valid"].sum())
    assert n_valid >= 3 and bool(state.present.any())
    # the dispatching entry point took the plain loop: same tensors again
    plain = fec_chain._tb_reassemble_torch(fec_chain.init_tb_state(fec, "cpu"), *targs, fec)
    assert_tb_equal(fec_chain.tb_reassemble(fec_chain.init_tb_state(fec, "cpu"), *targs, fec), plain)
