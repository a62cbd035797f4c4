"""The map form of the MCS decision over a block's frames (K7's map kernel),
in numpy, held bit for bit to the reference's ``lax.scan`` and to the port's
plain loop.

``csrc/feedback_scan.cu``'s map kernel does not walk the frames one by one.
The decision (``gr_dtl_tpu/models/adaptive.py::feedback_step``) is a
finite-state machine: while the active id is ``last`` a frame proposes only
``max(last - 1, 0)`` or ``last + 1``, so a state is one of n (2 thp + 2)
canonical states (thp = max(decision_th, 1)): the candidate down or up with
any counter under thp, or the candidate equal to ``last`` or neither, with
counter 0.  The kernel walks every chunk of 32 frames from every canonical
state through a transition table, chains the chunks' exits from the carry,
walks a carry outside the canonical states exactly until it is canonical,
and walks each chunk again from its true entry to write the ids.  This file
writes that in numpy in the kernel's shape (its tiles, chunks, padded
frame words, table, chain and re-walk), so that a fault in the algebra
shows here on the CPU and a fault in CUDA only on the card
(``tests/test_torch_feedback_scan.py``'s ``cuda`` cases).

The reference is ``jax.lax.scan`` over ``feedback_step`` with the sessions'
mask rule (``gr_dtl_tpu/models/session.py:673-680``), run once a ladder
over a wide batch (``decision_th`` a column, the frames' states kept) and
read at every T as a prefix.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import adaptive as ref_adaptive
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch.models import adaptive
from gr_dtl_tpu_torch.ops import feedback_cuda

from test_torch_feedback_scan import LADDERS, _cfg_kw, _edge_values

SRC = feedback_cuda.SOURCE.read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


CHUNK, TILE, MAP_RUNGS, MAX_STATES = (_const(k) for k in ("kChunk", "kTile", "kMapRungs", "kMaxStates"))
MASKED = 0xFFFFFFFF
T_CASES = (1, 31, 32, 33, 37, 256, 1024, 1025, 2100)  # 2100: three tiles, the last one part
THS = (0, 1, 5, 100)  # 100: n (2 * 100 + 2) states, more than the map holds: the walk
MASKS = ("none", "random", "all_false", "per_frame")
CARRIES = ("canonical", "odd_counter", "odd_other")
BISTABLE = {"default": np.float32(13.5), "fractional": np.float32(7.8)}  # inside a hysteresis band
I32 = 1 << 32


def wrap(x: int) -> int:
    """x as a two's-complement int32."""
    return ((int(x) + (1 << 31)) % I32) - (1 << 31)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def advance(st: tuple, down: bool, up: bool, m: bool, th: int) -> tuple:
    """The kernel's ``advance``: feedback_step after its compares, masked."""
    last, cand, counter = st
    candidate = max(last - 1, 0) if down else (last + 1 if up else last)
    propose = down or up
    changed = candidate != cand
    new_cand = candidate if propose and changed else cand
    new_counter = (0 if changed else wrap(counter + 1)) if propose else 0
    commit = propose and not changed and new_counter >= th
    if not m:
        return st
    return (new_cand if commit else last, new_cand, 0 if commit else new_counter)


def advance_word(st: tuple, w: int, th: int) -> tuple:
    k = (int(w) >> (2 * st[0])) & 3
    return advance(st, k == 1, k == 2, k != 3, th)


def rungs(snr_th: np.ndarray, n: int, hyst: float):
    """Each id's down threshold and its up threshold, the float32 sum (NaN at
    the top)."""
    lo = np.asarray(snr_th, np.float32)[:n]
    hi = np.full(n, np.nan, np.float32)
    hi[:-1] = lo[1:] + np.float32(hyst)
    return lo, hi


def frame_words(x: np.ndarray, m: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """A frame's word: 2 bits an id, 1 down (first), 2 up, 0 neither; every
    code 3 for a masked frame."""
    with np.errstate(invalid="ignore"):
        down, up = x[:, None] < lo[None], x[:, None] > hi[None]
    code = np.where(down, 1, np.where(up, 2, 0)).astype(np.int64)
    w = (code << (2 * np.arange(len(lo), dtype=np.int64))).sum(1)
    return np.where(m, w, MASKED)


def canonical(st: tuple, n: int, thp: int) -> int:
    last, cand, counter = st
    down = max(last - 1, 0)
    if cand == down or cand == last + 1:
        if not 0 <= counter < thp:
            return -1
        return (counter * 2 + (cand != down)) * n + last
    if counter != 0:
        return -1
    return 2 * n * thp + (0 if cand == last else n) + last


def decode(s: int, n: int, thp: int, other: int) -> tuple:
    du = 2 * n * thp
    if s < du:
        q, l = divmod(s, n)
        return (l, l + 1 if q & 1 else max(l - 1, 0), q >> 1)
    r = s - du
    l = r if r < n else r - n
    return (l, l if r < n else other, 0)


def pack(s: int, n: int, thp: int) -> int:
    """The byte offset of the state's entry in a table row (2 s) above twice
    its id."""
    du = 2 * n * thp
    return (2 * s << 5) | 2 * (s % n if s < du else (s - du) % n)


def enter(st: tuple, n: int, thp: int) -> tuple:
    """The chain's index of a carry and the counter it keeps: a cand neither
    candidate with a counter not 0 walks as the same state with counter 0
    (the first frame not masked zeroes it), the counter kept until then;
    -1 for a down or up candidate with a counter out of range."""
    last, cand, counter = st
    if cand in (max(last - 1, 0), last + 1) or counter == 0:
        return canonical(st, n, thp), 0
    return canonical((last, cand, 0), n, thp), counter


@functools.lru_cache(maxsize=None)
def next_table(n: int, th: int) -> np.ndarray:
    """next[code * H + s], packed, built from each state's representative
    (the other class's cand -1) by the step."""
    thp = max(th, 1)
    H = n * (2 * thp + 2)
    out = np.empty(4 * H, np.int64)
    for e in range(4 * H):
        k, s = divmod(e, H)
        s2 = canonical(advance(decode(s, n, thp, -1), k == 1, k == 2, k != 3, th), n, thp)
        assert s2 >= 0, "a canonical state stepped out of the canonical set"
        out[e] = pack(s2, n, thp)
    return out


def table_step(nxt: np.ndarray, v, w, H: int):
    """The packed states v one frame on, w the frames' words."""
    return nxt[((w >> (v & 31)) & 3) * H + (v >> 6)]


def walk_column(st: tuple, x, m, lo, hi, th: int):
    """The walk kernel: a thread steps the frames one by one."""
    ids = np.empty(len(x), np.int64)
    for t in range(len(x)):
        l = st[0]
        with np.errstate(invalid="ignore"):
            st = advance(st, bool(x[t] < lo[l]), bool(x[t] > hi[l]), bool(m[t]), th)
        ids[t] = st[0]
    return st, ids


def map_column(st: tuple, x, m, lo, hi, n: int, th: int):
    """The map kernel on one column: tiles of TILE frames, each staged as
    words padded with masked frames to whole chunks; the map of every
    (chunk, state); the chain from the carry (exact while it is not
    canonical, the counter of a relaxed carry kept while every frame is
    masked); each chunk walked again from its entry."""
    thp = max(th, 1)
    H = n * (2 * thp + 2)
    assert H <= MAX_STATES and n <= MAP_RUNGS
    nxt = next_table(n, th)
    starts = np.array([pack(h, n, thp) for h in range(H)], np.int64)
    T = len(x)
    ids = np.empty(T, np.int64)
    a, other = st, st[1]
    s, pend = enter(st, n, thp)
    for t0 in range(0, T, TILE):
        L = min(TILE, T - t0)
        nch = -(-L // CHUNK)
        words = np.full(nch * CHUNK, MASKED, np.int64)
        words[:L] = frame_words(x[t0:t0 + L], m[t0:t0 + L], lo, hi)
        words = words.reshape(nch, CHUNK)
        v = np.tile(starts, (nch, 1))  # the map: chunk c's exit of state s as the next chunk's row
        for k in range(CHUNK):
            v = table_step(nxt, v, words[:, k:k + 1], H)
        rows = ((np.arange(nch) + 1) * H)[:, None] + (v >> 6)
        live = (words != MASKED).any(1)
        entries = []  # the chain: odd carries exactly, then a row lookup a chunk
        c = 0
        while c < nch and s < 0:
            entries.append((-1, a))
            for w in words[c]:
                a = advance_word(a, w, th)
            (s, pend), other = enter(a, n, thp), a[1]
            c += 1
        if s >= 0:
            row, c0 = c * H + s, c
            for c in range(c0, nch):
                entries.append((row - c * H, other))
                row = int(rows.reshape(-1)[row])
            s = row - nch * H
            pend = 0 if live[c0:].any() else pend
        enc = [c for c, e in enumerate(entries) if e[0] >= 0]  # the emit
        u = np.array([pack(entries[c][0], n, thp) for c in enc], np.int64)
        out = np.empty((len(enc), CHUNK), np.int64)
        for k in range(CHUNK):
            u = table_step(nxt, u, words[enc, k], H)
            out[:, k] = (u & 31) >> 1
        for i, c in enumerate(enc):
            clen = min(CHUNK, L - c * CHUNK)
            ids[t0 + c * CHUNK:t0 + c * CHUNK + clen] = out[i, :clen]
        for c, e in enumerate(entries):
            if e[0] < 0:
                b = e[1]
                for k in range(min(CHUNK, L - c * CHUNK)):
                    b = advance_word(b, words[c, k], th)
                    ids[t0 + c * CHUNK + k] = b[0]
    if s < 0:
        return a, ids
    fin = decode(s, n, thp, other)
    return (fin[0], fin[1], pend if s >= 2 * n * thp else fin[2]), ids


def kernel_model(state0, snr, mask, snr_th, n: int, hyst: float, th: int):
    """K7 as the wrapper launches it: the kernel :func:`feedback_cuda.design`
    picks, column by column.  state0 [3, B], snr and mask [T, B] (mask None:
    every frame).  Returns (state [3, B], ids [T, B], the design)."""
    T, B = snr.shape
    mask = np.ones((T, B), bool) if mask is None else mask
    lo, hi = rungs(snr_th, n, hyst)
    kind = feedback_cuda.design(T, B, n, th)
    final, ids = np.empty((3, B), np.int64), np.empty((T, B), np.int64)
    for b in range(B):
        st = tuple(int(a[b]) for a in state0)
        if kind == "map":
            f, i = map_column(st, snr[:, b], mask[:, b], lo, hi, n, th)
        else:
            f, i = walk_column(st, snr[:, b], mask[:, b], lo, hi, th)
        final[:, b], ids[:, b] = f, i
    return final, ids, kind


# ---------------------------------------------------------------------------
# inputs and the reference
# ---------------------------------------------------------------------------

def _ladder(ladder: str):
    tables = ref_adaptive.build_mcs_tables(ref_config.make_rx_config(None, **_cfg_kw(ladder)))
    return np.asarray(tables["snr_th"], np.float32), int(tables["n_mcs"]), float(tables["hysteresis"])


T_MAX = max(T_CASES)


def _carry(kind: str, n: int, th: int, rng) -> tuple:
    """A carried-in state: canonical (each class), or outside the canonical
    states (a counter out of range, INT32_MAX among them, so that it wraps)."""
    thp = max(th, 1)
    last = int(rng.randint(n))
    down, up = max(last - 1, 0), last + 1
    if kind == "canonical":
        cls = rng.randint(4)
        if cls < 2:
            return (last, (down, up)[cls], int(rng.randint(thp)))
        return (last, last if cls == 2 else int(rng.choice([-1, n + 2, 7, -(1 << 31)])), 0)
    if kind == "odd_counter":
        return (last, int(rng.choice([down, up])), int(rng.choice([thp, thp + 7, (1 << 31) - 1, -3])))
    others = [n + 3, -2] + ([last] if last > 0 else [])  # at id 0, cand 0 is the down candidate
    return (last, int(rng.choice(others)), int(rng.choice([3, (1 << 31) - 1])))


def _column(ladder: str, rng) -> np.ndarray:
    """T_MAX SNRs: runs of 1-9 equal frames (long enough to cross
    decision_th = 5), each a threshold or threshold + hysteresis or one ulp
    either side, NaN, +-inf, a value inside a hysteresis band, or a point of
    the ladder's range; some runs of 20-300 frames in the band or high."""
    snr_th, n, hyst = _ladder(ladder)
    edges = _edge_values({"snr_th": snr_th, "hysteresis": hyst})
    col = []
    while len(col) < T_MAX:
        r = rng.rand()
        if r < 0.5:
            col += [edges[rng.randint(len(edges))]] * rng.randint(1, 10)
        elif r < 0.85:
            col += [np.float32(rng.uniform(-5, 35))] * rng.randint(1, 10)
        else:  # a steady stretch: inside a band, or well above the ladder
            col += [BISTABLE[ladder] if rng.rand() < 0.6 else np.float32(40.0)] * rng.randint(20, 300)
    return np.array(col[:T_MAX], np.float32)


@functools.lru_cache(maxsize=None)
def columns(ladder: str):
    """Every (th, mask, carry) column of a ladder, plus four set by hand: the
    bistable pair (ids 0 and 1 under an SNR inside their band, both fixed)
    and a steady climb.  Returns (ths [B], state0 [3, B], snr [T_MAX, B],
    mask [T_MAX, B], labels)."""
    rng = np.random.RandomState(11 + len(ladder))
    snr_th, n, hyst = _ladder(ladder)
    per_frame = rng.rand(T_MAX) > 0.3
    ths, states, snrs, masks, labels = [], [], [], [], []
    for th in THS:
        for mk in MASKS:
            for ck in CARRIES:
                ths.append(th)
                states.append(_carry(ck, n, th, rng))
                snrs.append(_column(ladder, rng))
                masks.append({"none": np.ones(T_MAX, bool), "random": rng.rand(T_MAX) > 0.3,
                              "all_false": np.zeros(T_MAX, bool), "per_frame": per_frame}[mk])
                labels.append(f"th{th}-{mk}-{ck}")
        for last in (0, 1):  # the bistable pair: each id a fixed point of the band's SNR
            ths.append(th)
            states.append((last, last, 0))
            snrs.append(np.full(T_MAX, BISTABLE[ladder], np.float32))
            masks.append(np.ones(T_MAX, bool))
            labels.append(f"th{th}-bistable-{last}")
        ths.append(th)
        states.append((0, 0, 0))
        snrs.append(np.full(T_MAX, 40.0, np.float32) + rng.normal(0, 0.5, T_MAX).astype(np.float32))
        masks.append(rng.rand(T_MAX) > 0.05)
        labels.append(f"th{th}-steady")
    return (np.array(ths), np.array(states, np.int64).T, np.stack(snrs, 1), np.stack(masks, 1), labels)


@functools.lru_cache(maxsize=None)
def reference(ladder: str):
    """The reference's masked scan over every column of the ladder, its
    state after every frame: (last, cand, counter), each [T_MAX, B]."""
    ths, state0, snr, mask, _ = columns(ladder)
    snr_th, n, hyst = _ladder(ladder)

    def run(s, x, m, th, table):
        tables = {"snr_th": table, "n_mcs": n, "hysteresis": hyst, "decision_th": th}

        def stepf(c, xm):
            ns, _ = ref_adaptive.feedback_step(c, xm[0], tables)
            ns = jax.tree.map(lambda a, b: jnp.where(xm[1], a, b), ns, c)
            return ns, ns

        return jax.lax.scan(stepf, s, (x, m))[1]

    s = ref_adaptive.FeedbackState(*(jnp.asarray(a.astype(np.int32)) for a in state0))
    ys = jax.jit(run)(s, jnp.asarray(snr), jnp.asarray(mask), jnp.asarray(ths.astype(np.int32)),
                      jnp.asarray(snr_th))
    return tuple(np.asarray(a) for a in ys)


def _group(ladder: str, th: int):
    ths, state0, snr, mask, labels = columns(ladder)
    sel = np.flatnonzero(ths == th)
    return sel, state0[:, sel], snr[:, sel], mask[:, sel], [labels[i] for i in sel]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("th", THS)
@pytest.mark.parametrize("ladder", list(LADDERS))
def test_kernel_model_equals_reference(ladder, th):
    """At every T (a part chunk, whole chunks, one past a chunk, a tile, one
    past a tile, three tiles) the kernel the wrapper picks, modelled, gives
    the reference's ids and final state on every column: every mask kind,
    canonical and odd carries, the bistable pair, a steady climb."""
    snr_th, n, hyst = _ladder(ladder)
    sel, state0, snr, mask, labels = _group(ladder, th)
    ys = reference(ladder)
    kinds = set()
    for T in T_CASES:
        final, ids, kind = kernel_model(state0, snr[:T], mask[:T], snr_th, n, hyst, th)
        kinds.add(kind)
        want_ids = ys[0][:T][:, sel]
        for j, lab in enumerate(labels):
            assert (ids[:, j] == want_ids[:, j]).all(), f"T={T} {lab}: ids differ from frame " \
                f"{int(np.argmax(ids[:, j] != want_ids[:, j]))}"
            got = tuple(final[:, j])
            want = tuple(int(a[T - 1, sel[j]]) for a in ys)
            assert got == want, f"T={T} {lab}: final state {got}, the reference's {want}"
    assert kinds == ({"walk"} if th == 100 else {"walk", "map"})


@pytest.mark.parametrize("ladder", list(LADDERS))
def test_map_with_no_mask_equals_plain_loop(ladder):
    """The map's model without a mask (None) against the port's plain loop
    (``_feedback_scan_masked_torch``, mask None) on the rule's shortest T
    and a multi-tile one."""
    snr_th, n, hyst = _ladder(ladder)
    sel, state0, snr, mask, labels = _group(ladder, 5)
    tables = {"snr_th": torch.as_tensor(snr_th), "n_mcs": n, "hysteresis": hyst, "decision_th": 5}
    for T in (feedback_cuda.MAP_MIN_T, 2100):
        final, ids, kind = kernel_model(state0, snr[:T], None, snr_th, n, hyst, 5)
        assert kind == "map"
        st = adaptive.FeedbackState(*(torch.as_tensor(a.astype(np.int32)) for a in state0))
        want_final, want = adaptive._feedback_scan_masked_torch(st, torch.as_tensor(snr[:T]), None, tables)
        np.testing.assert_array_equal(ids, want.numpy())
        for got, w in zip(final, want_final):
            np.testing.assert_array_equal(got, w.numpy())


@pytest.mark.parametrize("th", (0, 5))
def test_map_equals_plain_loop(th):
    """The map's model against the port's plain loop on the default
    ladder's masked columns at T = 1025 (a tile and one frame)."""
    snr_th, n, hyst = _ladder("default")
    sel, state0, snr, mask, labels = _group("default", th)
    tables = {"snr_th": torch.as_tensor(snr_th), "n_mcs": n, "hysteresis": hyst, "decision_th": th}
    T = 1025
    final, ids, kind = kernel_model(state0, snr[:T], mask[:T], snr_th, n, hyst, th)
    assert kind == "map"
    st = adaptive.FeedbackState(*(torch.as_tensor(a.astype(np.int32)) for a in state0))
    want_final, want = adaptive._feedback_scan_masked_torch(st, torch.as_tensor(snr[:T]),
                                                            torch.as_tensor(mask[:T]), tables)
    np.testing.assert_array_equal(ids, want.numpy())
    for got, w in zip(final, want_final):
        np.testing.assert_array_equal(got, w.numpy())


def test_inputs_reach_what_they_are_for():
    """The columns do what they are for: the bistable pair stays at 0 and at
    1 under one SNR; the odd carries leave the canonical states; the ladder
    climbs and falls."""
    snr_th, n, hyst = _ladder("default")
    ys = reference("default")
    _, state0, _, _, labels = columns("default")
    for last in (0, 1):
        j = labels.index(f"th5-bistable-{last}")
        assert (ys[0][:, j] == last).all()
    odd = [j for j, lab in enumerate(labels) if "odd" in lab]
    assert all(canonical(tuple(int(a[j]) for a in state0), n, 5) < 0 for j in odd if labels[j].startswith("th5"))
    assert any(state0[2, j] == (1 << 31) - 1 for j in odd)
    steps = np.diff(ys[0], axis=0)
    assert (steps > 0).sum() >= 50 and (steps < 0).sum() >= 50


@pytest.mark.parametrize("ladder", list(LADDERS))
def test_canonical_states(ladder):
    """The canonical set: n (2 thp + 2) states, each the index of its own
    decoding, closed under the step (``next_table`` asserts it), and the
    bistable SNR leaves both ids 0 and 1 where they are."""
    snr_th, n, hyst = _ladder(ladder)
    for th in (0, 1, 5):
        thp = max(th, 1)
        H = feedback_cuda.map_states(n, th)
        assert H == n * (2 * thp + 2) == len(next_table(n, th)) // 4
        for s in range(H):  # 2 n thp: "same" at id 0, which is "down" there (never reached)
            assert canonical(decode(s, n, thp, -1), n, thp) == (0 if s == 2 * n * thp else s)
    lo, hi = rungs(snr_th, n, hyst)
    w = int(frame_words(np.array([BISTABLE[ladder]]), np.array([True]), lo, hi)[0])
    assert (w >> 0) & 3 == 0 and (w >> 2) & 3 == 0  # at 0 nothing proposes up, at 1 nothing down


@pytest.mark.parametrize("T, B, n, th, want", [
    (1, 1, 4, 5, "walk"), (8, 1, 4, 5, "walk"), (16, 64, 4, 5, "walk"), (37, 1, 4, 5, "walk"),
    (63, 1, 4, 5, "walk"), (64, 1, 4, 5, "map"), (1024, 1, 4, 5, "map"), (1024, 64, 4, 5, "map"),
    (1024, 256, 4, 5, "map"), (1024, 257, 4, 5, "walk"), (256, 1024, 4, 5, "walk"),
    (1024, 1, 16, 5, "map"), (1024, 1, 17, 0, "walk"), (1024, 1, 4, 63, "map"), (1024, 1, 4, 64, "walk"),
    (1 << 20, 1, 4096, 5, "walk"), (2100, 1, 5, 5, "map"), (2100, 1, 4, 100, "walk")])
def test_launch_rule(T, B, n, th, want):
    """The wrapper's choice, a pure function of T, the columns and the
    ladder: the walk below MAP_MIN_T frames, past MAP_MAX_COLUMNS columns,
    for more than MAP_RUNGS rungs and for more than MAX_MAP_STATES states;
    the map otherwise."""
    assert (feedback_cuda.MAP_MIN_T, feedback_cuda.MAP_MAX_COLUMNS) == (64, 256)
    assert feedback_cuda.design(T, B, n, th) == want


def test_map_limits_are_the_sources():
    """The wrapper's limits are the source's, and the state count is n (2
    max(th, 1) + 2)."""
    assert (feedback_cuda.MAP_RUNGS, feedback_cuda.MAX_MAP_STATES) == (MAP_RUNGS, MAX_STATES)
    assert re.search(r"constexpr int kChunkStride = kChunk \+ 4;", SRC)
    assert re.search(r"constexpr uint32_t kMasked = 0xffffffffu;", SRC)
    assert feedback_cuda.map_states(4, 5) == 48 and feedback_cuda.map_states(4, 0) == 16
    assert feedback_cuda.map_states(4, 63) == 512 and feedback_cuda.map_states(4, 64) == 520
    assert feedback_cuda.map_fits(16, 15) and not feedback_cuda.map_fits(16, 16)
