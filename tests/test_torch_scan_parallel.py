"""The parallel formulations of the sessions' per-frame scans, in numpy, held
bit for bit to the reference's ``lax.scan``s and to the port's plain loops.

The CUDA kernels of ``csrc/stream_scans.cu`` and ``csrc/tb_ring.cu`` do not
walk the frames one by one.  They rest on three identities, written here in
numpy in the same shape as the kernels (the same tiles, lanes, chunks and
repair rounds), so that a fault in the algebra shows here on the CPU and a
fault in CUDA shows only on the card (tests/test_torch_scans_cuda.py,
tests/test_torch_tb_cuda.py):

- the frame accounting (``gr_dtl_tpu/models/session.py:214-223``,
  ``gr_dtl_tpu/ops/metrics.py:61-66``): the expectation before frame i is a
  function of the last decoded frame j < i, so the whole scan is one
  exclusive prefix-max of the packed pair (j + 1, value) and elementwise work;
- the TB ring (``gr_dtl_tpu/models/fec_chain.py:211-231``): the carried
  ``tb_no`` before frame i is the ``tb_no`` of the last ok frame before i;
  given it, ``is_new`` is elementwise, and the emitted scalars and every
  slot's source row come from prefix-maxes of the ``is_new`` index and of
  each slot's "mine" index;
- the trigger lock (``gr_dtl_tpu/models/streaming.py:163-178``): each lane
  walks its chunk from a guessed entry state, then rounds of repair re-walk
  a lane from its predecessor's exit beside its old walk until the two
  canonical states ``(locked, expected, miss, min(sync, 3))`` meet; the
  unbounded ``sync_count`` is rebuilt from the tile's last reset.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import fec_chain as ref_fec
from gr_dtl_tpu.models import streaming as ref_streaming
from gr_dtl_tpu.ops import metrics as ref_metrics
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch.models import fec_chain, streaming
from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.ops import metrics
from gr_dtl_tpu_torch.utils import alist

from test_torch_scans_cuda import LOCK_STATES, PERIOD, lock_sequence
from test_torch_tb_cuda import tb_headers

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
LANES = 32  # a warp


def wrap(x: int) -> int:
    """x as a two's-complement int32."""
    return ((int(x) + (1 << 31)) % (1 << 32)) - (1 << 31)


def excl_prefix_max(v: np.ndarray, carry: int, tile: int):
    """Exclusive prefix-max of v, tile by tile with the running max carried
    in (as a block scans a tile and hands its total to the next): element i
    gets max(carry, v[:i]).  Returns (the prefix, the new carry)."""
    out = np.empty(len(v), v.dtype)
    for t0 in range(0, len(v), tile):
        incl = np.maximum(np.maximum.accumulate(v[t0:t0 + tile]), carry)
        out[t0:t0 + tile] = np.concatenate([[carry], incl[:-1]])
        carry = incl[-1]
    return out, carry


# ---------------------------------------------------------------------------
# frame accounting: one prefix-max of (last ok index + 1, value) packed
# ---------------------------------------------------------------------------

def frame_accounting_scan(e0: int, nos: np.ndarray, ok: np.ndarray, rule: str, tile: int):
    """The accounting as the kernel computes it.  Rule "received": the
    expectation before i is (no[j] + 1) & 4095 for the last ok j < i, else
    e0.  Rule "header": (no[j] + 1 + (i - 1 - j)) & 4095 = (no[j] - j + i) &
    4095, else e0 advanced by i.  The packed key's high word is j + 1 (0 =
    none), its low word the value (no[j], or no[j] - j), so one max carries
    both.  Returns (expected', lost, [sum of lost, count of ok])."""
    T = len(nos)
    idx = np.arange(T, dtype=np.int64)
    no64 = nos.astype(np.int64)
    val = no64 if rule == "received" else no64 - idx
    key = np.where(ok, ((idx + 1) << 32) | (val & 0xFFFFFFFF), 0).astype(np.uint64)
    prefix, last = excl_prefix_max(key, np.uint64(0), tile)
    has = (prefix >> np.uint64(32)) > 0
    v = (prefix & np.uint64(0xFFFFFFFF)).astype(np.int64)
    if rule == "received":
        exp = np.where(has, (v + 1) & 4095, e0)
        lost = np.where(ok & (exp >= 0), (no64 - exp) & 4095, 0)
    else:
        exp = np.where(has, (v + idx) & 4095, e0 + idx)  # only (no - exp) & 4095 reads it
        lost = np.where(ok, (no64 - exp) & 4095, 1)
    lv = int(last) & 0xFFFFFFFF
    if int(last) >> 32 == 0:
        e_out = e0 if rule == "received" or T == 0 else (e0 + T) & 4095
    else:
        e_out = (lv + 1) & 4095 if rule == "received" else (lv + T) & 4095
    totals = [wrap(int(lost.sum())), int(ok.sum())]
    return wrap(e_out), lost.astype(np.int32), np.asarray(totals, np.int32)


def _ref_session_acct(expected_no, frame_no, ok):
    """The reference block step's accounting scan (session.py:214-223), which
    the reference defines inline."""

    def acct(exp, x):
        no, okf = x
        gap = jnp.where(exp < 0, 0, (no - exp) % 4096)
        return jnp.where(okf, (no + 1) % 4096, exp), jnp.where(okf, gap, 0)

    return jax.lax.scan(acct, expected_no, (frame_no, ok))


def acct_sequence(T: int, seed: int):
    """Frame numbers that run on, skip, wrap past 4095 and fall back, with
    undecoded slots carrying any number."""
    rng = np.random.RandomState(seed)
    ok = rng.rand(T) > 0.3
    nos = (4000 + np.arange(T) + np.cumsum(rng.choice([0, 0, 0, 1, 7, -3], T))) % 4096
    nos[~ok] = rng.randint(-5000, 9000, int((~ok).sum()))
    return nos.astype(np.int32), ok


ACCT_T = [0, 1, 2, 31, 32, 33, 95, 1023, 1024, 1025, 2100]


@pytest.mark.parametrize("tile", [32, 256, 1024])
@pytest.mark.parametrize("T", ACCT_T)
def test_frame_accounting_prefix_max_equals_reference_and_plain_loop(T, tile):
    """Rule "received" from -1, 0 and 4090 (the session's scan, against the
    reference's inline scan and the port's plain loop); rule "header" from
    several starts, past 12 bits too (against metrics.lost_frames' totals and
    the plain loop's every output)."""
    nos, ok = acct_sequence(T, 7 * T + tile)
    ref = jax.jit(_ref_session_acct)
    for e0 in (-1, 0, 4090):
        e1, lost, totals = frame_accounting_scan(e0, nos, ok, "received", tile)
        exp_r, lost_r = ref(jnp.asarray(e0, jnp.int32), jnp.asarray(nos), jnp.asarray(ok))
        np.testing.assert_array_equal(lost, np.asarray(lost_r))
        assert e1 == int(exp_r)
        plain = metrics._frame_accounting_torch(torch.tensor(e0, dtype=torch.int32),
                                                torch.as_tensor(nos), torch.as_tensor(ok))
        assert e1 == int(plain[0])
        np.testing.assert_array_equal(lost, plain[1].numpy())
        np.testing.assert_array_equal(totals, plain[2].numpy())
    for e0 in (0, 17, 4095, 4096 + 4000):
        e1, lost, totals = frame_accounting_scan(e0, nos, ok, "header", tile)
        plain = metrics._frame_accounting_torch(torch.tensor(e0, dtype=torch.int32),
                                                torch.as_tensor(nos), torch.as_tensor(ok), "header")
        assert e1 == int(plain[0])
        np.testing.assert_array_equal(lost, plain[1].numpy())
        np.testing.assert_array_equal(totals, plain[2].numpy())
        if T:
            n_lost, n_total, _ = jax.jit(ref_metrics.lost_frames)(
                jnp.asarray(nos), jnp.asarray(ok), jnp.asarray(e0, jnp.int32))
            assert (int(totals[0]), int(totals[0]) + int(totals[1])) == (int(n_lost), int(n_total))


# ---------------------------------------------------------------------------
# the TB ring: prefix-maxes of the ok index, the is_new index and each slot's
# "mine" index
# ---------------------------------------------------------------------------

def tb_ring_scan(state, llrs, tb_no, tb_offset, cnst_id, tb_payload, fec_id, ok, W: int,
                 fb_of_cnst, tile: int):
    """The reassembly as the walk kernel computes it: pass 1, the carried
    tb_no before every frame (the last ok frame's); pass 2, ``is_new``, then
    the source row of every slot before every frame (-2 the carried buffer,
    -1 zeros, j frame j) from the last is_new index b and the slot's last
    "mine" index a: a if a >= 0 and a >= b, else -1 if b >= 0, else -2; then
    the copy.  Returns (state', emitted) as numpy, laid out as the
    reference's."""
    tb_in, llrs_in, present_in, cnst_in, plen_in, fec_in = (np.asarray(a) for a in state)
    F = len(ok)
    idx = np.arange(F, dtype=np.int64)
    fb = np.maximum(np.asarray(fb_of_cnst, np.int64)[np.clip(cnst_id, 0, 4)], 1)
    off = tb_offset.astype(np.int64)
    # pass 1: the carried tb_no before each frame
    j, j_last = excl_prefix_max(np.where(ok, idx, -1), -1, tile)
    tbc = np.where(j >= 0, tb_no[np.maximum(j, 0)], tb_in)
    is_new = ok & (tb_no != tbc)
    # pass 2: the last is_new index and each slot's last "mine" index
    b, b_last = excl_prefix_max(np.where(is_new, idx, -1), -1, tile)
    src = np.empty((F + 1, W), np.int64)
    present = np.empty(W, bool)
    for w in range(W):
        # clip(floor(off / bits), 0, W - 1) == w without the division
        mine = ok & ((w == 0) | (off >= w * fb)) & ((w == W - 1) | (off < (w + 1) * fb))
        a, a_last = excl_prefix_max(np.where(mine, idx, -1), -1, tile)
        src[:F, w] = np.where((a >= 0) & (a >= b), a, np.where(b >= 0, -1, -2))
        src[F, w] = a_last if a_last >= 0 and a_last >= b_last else (-1 if b_last >= 0 else -2)
        present[w] = (a_last >= 0 and a_last >= b_last) or (b_last < 0 and present_in[w])
    pick = lambda col, carried, at: np.where(at >= 0, col[np.maximum(at, 0)], carried).astype(np.int32)
    frame_rows = lambda s: llrs[np.clip(s, 0, F - 1)] if F else np.zeros(s.shape + llrs.shape[1:])
    rows = lambda s: np.where((s == -2)[..., None], llrs_in[None] if s.ndim == 2 else llrs_in,
                              np.where((s == -1)[..., None], 0.0, frame_rows(s)))
    emitted = {"llrs": rows(src[:F]).astype(np.float32), "cnst": pick(cnst_id, cnst_in, b),
               "plen": pick(tb_payload, plen_in, b), "fec_id": pick(fec_id, fec_in, b),
               "tb_no": tbc.astype(np.int32), "valid": is_new & (tbc >= 0)}
    new = (np.int32(tb_no[j_last] if j_last >= 0 else tb_in), rows(src[F]).astype(np.float32),
           present, np.int32(cnst_id[b_last] if b_last >= 0 else cnst_in),
           np.int32(tb_payload[b_last] if b_last >= 0 else plen_in),
           np.int32(fec_id[b_last] if b_last >= 0 else fec_in))
    return new, emitted


@functools.lru_cache(maxsize=None)
def _tb_fecs(W: int):
    ref_cfg = ref_config.make_tx_config(None, frame_length=4, fec=True)
    ref = ref_fec.build_fec(ref_cfg, alist.load_alist(str(EXAMPLES / "n_0100_k_0027.alist")),
                            tb_frames=W)
    return ref, fec_chain.fec_from_reference(ref, "cpu")


TB_F = [0, 1, 31, 32, 33, 95, 257]


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("F", TB_F)
def test_tb_ring_prefix_max_equals_reference_and_plain_loop(F, W):
    """tb_headers' every branch (lost frames; TB numbers that stay, advance,
    skip and fall back; constellation ids outside 1..4; offsets on a slot's
    edge, negative and past the last slot) over two chained calls, so the
    second starts from a carried-in buffer, at tiles of 32 and 1024: every
    emitted row, int and bool and every carry leaf equal the reference's scan
    and the port's plain loop exactly."""
    ref, fec = _tb_fecs(W)
    fb5 = fec.cfg.frame_capacity_symbols * cn.BITS_PER_SYMBOL[:5]
    scan = jax.jit(lambda s, *a: ref_fec.tb_reassemble(s, *a, ref))
    state_r, state_p = ref_fec.init_tb_state(ref), fec_chain.init_tb_state(fec, "cpu")
    state_n = {t: tuple(np.asarray(a) for a in state_p) for t in (32, 1024)}
    tb0 = 0
    for call in range(2):
        args = tb_headers(F, W, ref["frame_bits_tab"], ref["max_frame_bits"], 31 * F + W + call, tb0)
        if F:
            state_r, em_r = scan(state_r, *[jnp.asarray(a) for a in args])
            em_r = {k: np.asarray(v) for k, v in em_r.items()}
        state_p, em_p = fec_chain._tb_reassemble_torch(state_p, *[torch.as_tensor(a) for a in args], fec)
        for tile in state_n:
            state_n[tile], em = tb_ring_scan(state_n[tile], *args, W, fb5, tile)
            for k in em:
                np.testing.assert_array_equal(em[k], em_p[k].numpy(), err_msg=f"{k} vs plain")
                assert em[k].dtype == em_p[k].numpy().dtype, k
                if F:
                    np.testing.assert_array_equal(em[k], em_r[k], err_msg=f"{k} vs reference")
            for name, a, p, r in zip(fec_chain.TbRing._fields, state_n[tile], state_p, state_r):
                np.testing.assert_array_equal(a, p.numpy(), err_msg=f"state.{name} vs plain")
                np.testing.assert_array_equal(a, np.asarray(r), err_msg=f"state.{name} vs reference")
        tb0 = int(args[1].max()) if F else tb0


# ---------------------------------------------------------------------------
# the trigger lock: speculative chunks, repaired in rounds
# ---------------------------------------------------------------------------

def lock_step(s, c: int, ok: bool, period: int, tol: int):
    """One step on the canonical state (locked, expected, miss, sync) with
    sync kept at min(sync, 3) (streaming.py:163-178; wrapping int32 as
    jnp's and the kernel's).  Returns (state', trig, valid, consistent)."""
    locked, exp, miss, sync = s
    diff = wrap(c - exp)
    adiff = wrap(-diff) if diff < 0 else diff  # |INT_MIN| is INT_MIN, as jnp.abs
    cons = ok and adiff <= tol
    sync = min(wrap(sync + 1), 3) if cons else int(ok)
    miss = wrap(miss + 1) if locked and not cons else 0
    take = cons or (not locked and ok)
    t = c if take else exp
    valid = take or locked
    locked = True if sync >= 3 else locked
    locked = False if miss >= 5 else locked
    return (locked, wrap(t + period), miss, sync), t, valid, cons


def same(a, b) -> bool:
    """Two states that give the same outputs from here on: locked, expected
    and miss equal, and sync too while unlocked.  While locked, sync decides
    nothing: it can only unlock through an inconsistent frame, which sets
    sync from the frame alone."""
    return a[:3] == b[:3] and (a[0] or a[3] == b[3])


def chunk_size(T: int, cmax: int) -> int:
    """Frames a lane walks: the power of two that lets 32 lanes cover T, up
    to cmax (a tile is 32 chunks)."""
    c = 1
    while c < cmax and LANES * c < T:
        c *= 2
    return c


def trigger_lock_spec(state, cand: np.ndarray, found: np.ndarray, period: int, tol: int = 4,
                      cmax: int = 32, warm: int = 32):
    """The lock scan as the kernel computes it.  Per tile of 32 chunks: lane
    0 walks from the exact carry; lane l > 0 guesses its entry by walking the
    ``warm`` frames before its chunk from "locked, expected = cand[first - 1]
    + period, miss 0, sync 3" (from the exact carry when they reach the
    tile's start); then in rounds every lane whose predecessor's exit (as it
    stood at the round's start) is not ``same`` as its own entry re-walks
    from it, beside its old walk, until the two states meet (then the old
    walk's outputs and exit stand) or the chunk ends; no lane changing ends
    the tile.  The exact sync_count leaves
    the tile as (found at the last reset r) + (frames after r), or the
    entry's plus the tile's length when no frame of it reset the count.
    With the kernel's warm-up of 32, at T <= 32 every lane starts from the
    carry: the kernel then walks the frames in step, as this does there.
    Returns ((locked, expected, sync, miss), trig, valid, rounds)."""
    T = len(cand)
    trig, valid = np.zeros(T, np.int32), np.zeros(T, bool)
    locked, expected, sync, miss = (bool(state[0]), int(state[1]), int(state[2]), int(state[3]))
    canon, sync_exact, rounds = (locked, expected, miss, sync), sync, 0
    C = chunk_size(T, cmax)
    for t0 in range(0, T, LANES * C):
        n = min(LANES * C, T - t0)
        lanes = -(-n // C)

        def walk(entry, lane, old=None):
            """Walk lane's chunk from entry, writing its outputs; beside the
            walk from ``old`` (the lane's previous entry), stop where the two
            meet.  Returns (exit or None if met, last reset, step met)."""
            s, last_reset = entry, -1
            for k in range(min(C, n - lane * C)):
                i = t0 + lane * C + k
                s, trig[i], valid[i], cons = lock_step(s, int(cand[i]), bool(found[i]), period, tol)
                if not cons:
                    last_reset = k
                if old is not None:
                    old = lock_step(old, int(cand[i]), bool(found[i]), period, tol)[0]
                    if same(old, s):
                        return None, last_reset, k
            return s, last_reset, None

        ins, outs, resets = [], [], []
        for lane in range(lanes):
            start = lane * C
            first = start - min(warm, start)
            entry = canon if first == 0 else (True, wrap(int(cand[t0 + first - 1]) + period), 0, 3)
            for i in range(t0 + first, t0 + start):  # the warm-up: outputs not kept
                entry = lock_step(entry, int(cand[i]), bool(found[i]), period, tol)[0]
            ins.append(entry)
            out, r, _ = walk(ins[-1], lane)
            outs.append(out)
            resets.append(r)
        while True:
            pred = [ins[0]] + outs[:-1]
            changed = [lane for lane in range(1, lanes) if not same(pred[lane], ins[lane])]
            if not changed:
                break
            rounds += 1
            for lane in changed:
                out, r, met = walk(pred[lane], lane, ins[lane])
                ins[lane] = pred[lane]
                if met is None:
                    outs[lane], resets[lane] = out, r
                elif resets[lane] <= met:
                    resets[lane] = r
        last = max((lane * C + r for lane, r in enumerate(resets) if r >= 0), default=-1)
        if last >= 0:
            sync_exact = int(found[t0 + last]) + (n - 1 - last)
        else:
            sync_exact = wrap(sync_exact + n)
        canon = outs[lanes - 1]
    return (canon[0], canon[1], sync_exact, canon[2]), trig, valid, rounds


LOCK_T = [0, 1, 2, 31, 32, 33, 63, 65, 200, 1023, 1025, 2049]


@pytest.mark.parametrize("kind", ["locked", "random", "never", "defeat", "wrap"])
@pytest.mark.parametrize("T", LOCK_T)
def test_trigger_lock_speculative_chunks_equal_reference_and_plain_loop(T, kind):
    """At chunk caps of 1, 4 and 32 (the kernel's: a tile of 1024), with no
    warm-up, one of 3 frames and the kernel's 32, from
    entry states that are unlocked, locked, mid-miss, and whose sync_count
    wraps int32: every trig, valid and state word equals the reference's
    lax.scan and the port's plain loop."""
    cand, found = lock_sequence(kind, T, 13 * T + len(kind))
    ref = jax.jit(lambda s, c, f: ref_streaming.trigger_lock_scan(s, c, f, PERIOD))
    for name, st in LOCK_STATES.items():
        want = None
        if T:
            ref_state = ref_streaming.TriggerLockState(jnp.asarray(st[0]), *(jnp.asarray(v, jnp.int32)
                                                                             for v in st[1:]))
            s_r, (t_r, v_r) = ref(ref_state, jnp.asarray(cand), jnp.asarray(found))
            want = (tuple(int(a) for a in s_r), np.asarray(t_r), np.asarray(v_r))
        pstate = streaming.lock_state_from_reference(st, "cpu")
        s_p, (t_p, v_p) = streaming._trigger_lock_scan_torch(pstate, torch.as_tensor(cand),
                                                             torch.as_tensor(found), PERIOD)
        plain = (tuple(int(a) for a in s_p), t_p.numpy(), v_p.numpy())
        for cmax, warm in ((1, 0), (4, 3), (32, 0), (32, 32)):
            s, t, v, _ = trigger_lock_spec(st, cand, found, PERIOD, cmax=cmax, warm=warm)
            for w in (want, plain) if want else (plain,):
                assert tuple(int(a) for a in s) == w[0], (name, cmax, warm)
                np.testing.assert_array_equal(t, w[1], err_msg=f"{name} trig, cmax {cmax}, warm {warm}")
                np.testing.assert_array_equal(v, w[2], err_msg=f"{name} valid, cmax {cmax}, warm {warm}")


def test_speculation_is_repaired_and_costs_rounds_only_when_defeated():
    """A locked stream needs no repair round, nor does a noisy one with the
    warm-up (without it, rounds); a stream built to defeat the guess takes a
    round for most lanes and still equals the plain loop."""
    st = LOCK_STATES["locked"]
    cand, found = lock_sequence("locked", 1024, 1)
    assert trigger_lock_spec(st, cand, found, PERIOD)[3] == 0
    cand, found = lock_sequence("random", 1024, 1)
    assert trigger_lock_spec(st, cand, found, PERIOD, warm=0)[3] > 0
    assert trigger_lock_spec(st, cand, found, PERIOD)[3] <= 2
    cand, found = lock_sequence("never", 1024, 1)
    got = trigger_lock_spec(LOCK_STATES["initial"], cand, found, PERIOD)
    assert got[3] >= LANES // 2
    s_p, (t_p, v_p) = streaming._trigger_lock_scan_torch(
        streaming.lock_state_from_reference(LOCK_STATES["initial"], "cpu"), torch.as_tensor(cand),
        torch.as_tensor(found), PERIOD)
    assert tuple(int(a) for a in got[0]) == tuple(int(a) for a in s_p)
    np.testing.assert_array_equal(got[1], t_p.numpy())


@pytest.mark.parametrize("T,cmax,want", [(0, 32, 1), (1, 32, 1), (32, 32, 1), (33, 32, 2),
                                         (1024, 32, 32), (1025, 32, 32), (200, 4, 4)])
def test_chunk_size_covers_a_tile_of_32_lanes(T, cmax, want):
    assert chunk_size(T, cmax) == want
