"""The MCS decision over a block's frames (K7): the port's
``adaptive.feedback_scan_masked`` against the reference.

On the CPU the port takes its plain loop (``_feedback_scan_masked_torch``);
it is held to the reference's jitted ``feedback_scan`` (no mask) and to the
masked scan the reference's sessions and link tools write inline
(``gr_dtl_tpu/models/session.py:673-680``), on seeded numpy SNRs and masks:
T = 1 / 8 / 64 / 1024 frames, batch ``()`` and ``(4,)``, SNRs on the
thresholds, on threshold + hysteresis and one float32 ulp either side, NaN
and +-inf, runs long enough to cross ``decision_th``.  Ids and the final
state must be equal.  The ``cuda``-marked cases hold the CUDA kernel
(``ops/feedback_cuda``) to the plain loop on the same inputs on the card and
skip without one (a CUDA kernel has no CPU mode); on a machine with the card
but without JAX or pytest-xdist:
``python3 -m pytest -o addopts= --noconftest -q -m cuda tests/test_torch_feedback_scan.py``
(the reference's side of the file needs JAX, so it is imported only where
it is used).
"""

import re

import numpy as np
import pytest
import torch

from gr_dtl_tpu_torch.models import adaptive
from gr_dtl_tpu_torch.ops import feedback_cuda
from gr_dtl_tpu_torch.utils import config

T_CASES = (1, 8, 64, 1024)
BATCHES = ((), (4,))
# the default ladder (13 / 18 / 23 dB) and one whose thresholds plus the
# hysteresis cross into the next binade, so the float32 sum rounds
LADDERS = {"default": None,
           "fractional": [[0.0, ["bpsk", "no_fec"]], [7.3, ["qpsk", "no_fec"]],
                          [15.7, ["psk8", "no_fec"]], [31.3, ["qam16", "no_fec"]],
                          [31.9, ["qam16", "no_fec"]]]}
MASKS = ("none", "random", "all_false", "per_frame")


def _cfg_kw(ladder: str) -> dict:
    return {} if LADDERS[ladder] is None else {"mcs": LADDERS[ladder]}


def _tables(ladder: str) -> dict:
    return adaptive.build_mcs_tables(config.make_rx_config(None, **_cfg_kw(ladder)))


def _edge_values(tables) -> np.ndarray:
    """Every threshold and threshold + hysteresis (the float32 sum the
    decision compares against), each with its neighbours one ulp away, and
    NaN, +inf, -inf."""
    th = np.asarray(tables["snr_th"], np.float32)[1:]
    up = th + np.float32(tables["hysteresis"])
    vals = []
    for v in np.concatenate([th, up]):
        vals += [np.nextafter(v, np.float32(-np.inf)), v, np.nextafter(v, np.float32(np.inf))]
    return np.array(vals + [np.nan, np.inf, -np.inf], np.float32)


def _snrs(T: int, batch: tuple, ladder: str, seed: int) -> np.ndarray:
    """Runs of 1-9 equal frames (long enough to cross decision_th = 5), each
    an edge value or a point of a walk up and down the ladder."""
    rng = np.random.RandomState(seed)
    edges = _edge_values(_tables(ladder))
    cols = []
    for _ in range(int(np.prod(batch, dtype=int))):
        col = []
        while len(col) < T:
            v = edges[rng.randint(len(edges))] if rng.rand() < 0.6 else np.float32(rng.uniform(-5, 35))
            col += [v] * rng.randint(1, 10)
        cols.append(col[:T])
    return np.array(cols, np.float32).T.reshape((T,) + batch)


def _mask(kind: str, T: int, batch: tuple, seed: int):
    rng = np.random.RandomState(seed + 1)
    if kind == "none":
        return None
    if kind == "all_false":
        return np.zeros((T,) + batch, bool)
    if kind == "per_frame":  # [T]: one flag a frame for every column
        return rng.rand(T) > 0.3
    return rng.rand(T, *batch) > 0.3


def _state0(batch: tuple, seed: int, n_mcs: int):
    """A carried-in state: random ids, a candidate, a counter under decision_th."""
    rng = np.random.RandomState(seed + 2)
    return tuple(rng.randint(0, hi, batch).astype(np.int32) for hi in (n_mcs, n_mcs, 5))


CASES = [(T, batch, ladder, mask) for T in T_CASES for batch in BATCHES for ladder in LADDERS
         for mask in MASKS if not (mask == "per_frame" and batch == ())]


def _case_id(case) -> str:
    T, batch, ladder, mask = case
    return f"T{T}-b{'x'.join(map(str, batch)) or '0'}-{ladder}-{mask}"


def _port(state0, snr, mask, tables, dev):
    state = adaptive.FeedbackState(*(torch.as_tensor(a, device=dev) for a in state0))
    tab = adaptive.tables_to(tables, dev)
    return adaptive.feedback_scan_masked(state, torch.as_tensor(snr, device=dev),
                                         None if mask is None else torch.as_tensor(mask, device=dev),
                                         tab)


def _reference(state0, snr, mask, ladder: str):
    """The reference's jitted feedback_scan (no mask), or its sessions'
    masked scan written as session.py:673-680 writes it."""
    import jax
    import jax.numpy as jnp

    from gr_dtl_tpu.models import adaptive as ref_adaptive
    from gr_dtl_tpu.utils import config as ref_config

    tables = ref_adaptive.build_mcs_tables(ref_config.make_rx_config(None, **_cfg_kw(ladder)))
    state = ref_adaptive.FeedbackState(*(jnp.asarray(a) for a in state0))
    if mask is None:
        return jax.jit(lambda s, x: ref_adaptive.feedback_scan(s, x, tables))(state, jnp.asarray(snr))

    def stepf(s, x):
        snr_t, m = x
        ns, mcs = ref_adaptive.feedback_step(s, snr_t, tables)
        ns = jax.tree.map(lambda a, b: jnp.where(m, a, b), ns, s)
        return ns, jnp.where(m, mcs, s.last)

    return jax.jit(lambda s, x, m: jax.lax.scan(stepf, s, (x, m)))(state, jnp.asarray(snr),
                                                                     jnp.asarray(mask))


def _inputs(case):
    T, batch, ladder, mask_kind = case
    seed = T + 7 * len(batch) + 13 * MASKS.index(mask_kind) + (100 if ladder == "fractional" else 0)
    tables = _tables(ladder)
    return (_state0(batch, seed, tables["n_mcs"]), _snrs(T, batch, ladder, seed),
            _mask(mask_kind, T, batch, seed), tables)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_scan_equals_reference(case):
    """The port's scan on the CPU (the plain loop) equals the reference's,
    masked and unmasked: ids and final state."""
    state0, snr, mask, tables = _inputs(case)
    n0 = feedback_cuda.feedback_scan_masked_cuda.LAUNCHES
    final, mcs = _port(state0, snr, mask, tables, "cpu")
    ref_final, ref_mcs = _reference(state0, snr, mask, case[2])
    assert feedback_cuda.feedback_scan_masked_cuda.LAUNCHES == n0  # a CPU tensor launches nothing
    assert mcs.dtype == torch.int32 and tuple(mcs.shape) == snr.shape
    np.testing.assert_array_equal(mcs.numpy(), np.asarray(ref_mcs))
    for got, want in zip(final, ref_final):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_edge_cases_move_the_ladder():
    """The synthetic inputs do what they are for: at T = 1024 the ladder
    climbs and falls (commits both ways), an all-False mask keeps the
    carried state, and NaN frames never commit."""
    state0, snr, mask, tables = _inputs((1024, (4,), "fractional", "none"))
    final, mcs = _port(state0, snr, mask, tables, "cpu")
    steps = np.diff(mcs.numpy(), axis=0)
    assert (steps > 0).sum() >= 8 and (steps < 0).sum() >= 8
    state0, snr, mask, tables = _inputs((64, (4,), "default", "all_false"))
    final, mcs = _port(state0, snr, mask, tables, "cpu")
    for got, want in zip(final, state0):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(mcs.numpy(), np.broadcast_to(state0[0], mcs.shape))
    nan = np.full((16, 4), np.nan, np.float32)
    final, mcs = _port(state0, nan, None, tables, "cpu")
    np.testing.assert_array_equal(mcs.numpy(), np.broadcast_to(state0[0], mcs.shape))
    assert (final.counter.numpy() == 0).all()


def test_feedback_scan_is_the_masked_scan_without_a_mask():
    state0, snr, _, tables = _inputs((64, (4,), "default", "none"))
    state = adaptive.FeedbackState(*(torch.as_tensor(a) for a in state0))
    a = adaptive.feedback_scan(state, torch.as_tensor(snr), tables)
    b = adaptive.feedback_scan_masked(state, torch.as_tensor(snr), torch.ones(snr.shape, dtype=torch.bool),
                                      tables)
    for x, y in zip((*a[0], a[1]), (*b[0], b[1])):
        assert torch.equal(x, y)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The kernel's wrapper raises on a CPU tensor and launches nothing; the
    source's rung limit is the wrapper's; the byte count is 9 bytes a frame
    and column."""
    i32 = torch.zeros(4, dtype=torch.int32)
    th = torch.tensor([-np.inf, 1.0, 2.0], dtype=torch.float32)
    n0 = feedback_cuda.feedback_scan_masked_cuda.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        feedback_cuda.feedback_scan_masked_cuda(i32, i32, i32, torch.zeros(8, 4), None, th, 3, 1.0, 5)
    assert feedback_cuda.feedback_scan_masked_cuda.LAUNCHES == n0
    src = feedback_cuda.SOURCE.read_text()
    assert re.search(r"kMaxRungs = 1 << 12;", src) and feedback_cuda.MAX_RUNGS == 1 << 12
    assert feedback_cuda.feedback_bytes(1024, 64) == 64 * (1024 * 9 + 24)
    assert feedback_cuda.feedback_bytes(8, 1, n_mcs=4) == 8 * 9 + 24 + 16


# -- the kernel on the card ---------------------------------------------------


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + [(256, (4,), "default", "random"),
                                          (16, (64,), "fractional", "random"),
                                          (1024, (64,), "default", "per_frame"),
                                          (37, (4,), "fractional", "random")], ids=_case_id)
def test_kernel_equals_plain_loop(gpu, case):
    """K7 on CUDA tensors against the plain loop on the same CUDA tensors:
    ids and state equal, one launch."""
    state0, snr, mask, tables = _inputs(case)
    n0 = feedback_cuda.feedback_scan_masked_cuda.LAUNCHES
    final, mcs = _port(state0, snr, mask, tables, gpu)
    torch.cuda.synchronize()
    assert feedback_cuda.feedback_scan_masked_cuda.LAUNCHES == n0 + 1
    state = adaptive.FeedbackState(*(torch.as_tensor(a, device=gpu) for a in state0))
    want_final, want = adaptive._feedback_scan_masked_torch(
        state, torch.as_tensor(snr, device=gpu),
        None if mask is None else torch.as_tensor(mask, device=gpu), adaptive.tables_to(tables, gpu))
    assert torch.equal(mcs, want)
    for g, w in zip(final, want_final):
        assert torch.equal(g, w)
