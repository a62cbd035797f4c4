"""The CUDA Schmidl-Cox kernel's tiling, on the CPU: the wrapper's pure
``tiling`` function covers every output exactly once with 16-byte-aligned
interiors, its constants are the source's, and the plain metric agrees with
a float64 evaluation of the formula and with the JAX package's jnp metric."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.ops import sync as ref_sync

from gr_dtl_tpu_torch.ops import sync, sync_cuda

P_ATOL, M_ATOL = 2e-4, 2e-3  # the reference's bars (tests/test_sync_pallas.py)
T = sync_cuda.TILE


def _cplx(rng, *shape, scale=1.0):
    return (scale * (rng.randn(*shape) + 1j * rng.randn(*shape))).astype(np.complex64)


def _formula64(r):
    """P and M of the definition, in float64 by direct 32-term sums."""
    r = r.astype(np.complex128)
    out = r.shape[-1] - 64
    win = np.lib.stride_tricks.sliding_window_view
    P = win(np.conj(r[..., :-32]) * r[..., 32:], 32, axis=-1).sum(-1)[..., :out]
    E = win(np.abs(r) ** 2, 32, axis=-1).sum(-1)
    return P, np.abs(P) ** 2 / np.maximum(E[..., :out] * E[..., 32:32 + out], 1e-12)


SHAPES = [(1, 65), (1, 66), (1, T + 64), (1, T + 65), (1, 3 * T + 64 - 15), (3, 9001), (3, 9000),
          (4, T + 49), (2, 2 * T + 79), (5, 131)]


@pytest.mark.parametrize("rows,n", SHAPES)
def test_tiling_covers_every_output_once(rows, n):
    plan = sync_cuda.tiling(n, rows)
    assert plan.out_len == n - 64
    assert plan.tiles_per_row == sync_cuda.tiles_per_row(plan.out_len)  # the launch's grid
    for w in range(rows):
        seen = np.zeros(plan.out_len, np.int32)
        for t in range(plan.tiles_per_row):
            d = plan.tile_outputs(w, t)
            assert len(d) <= T
            seen[d.start:d.stop] += 1
        assert np.all(seen == 1), (w, np.flatnonzero(seen != 1)[:4])


@pytest.mark.parametrize("rows,n", SHAPES)
@pytest.mark.parametrize("r_addr,p_addr,m_addr", [(0, 0, 0), (512, 1024, 256), (8, 0, 0), (0, 8, 4)])
def test_tiling_aligned_interiors(rows, n, r_addr, p_addr, m_addr):
    """A tile's origin is a multiple of 16 outputs of M (64 bytes), and
    wherever the plan says a row's samples or P go as 16-byte pairs, every
    pair from that origin is 16-byte aligned."""
    plan = sync_cuda.tiling(n, rows, r_addr, p_addr, m_addr)
    for w in range(rows):
        for t in range(plan.tiles_per_row):
            d0 = t * T - plan.phase[w]                       # may be negative in tile 0
            assert (m_addr + 4 * (w * plan.out_len + d0)) % 64 == 0
            assert ((r_addr + 8 * (w * n + d0)) % 16 == 0) == plan.in_vec[w]
            assert ((p_addr + 8 * (w * plan.out_len + d0)) % 16 == 0) == plan.p_vec[w]
    if (r_addr, p_addr, m_addr) == (0, 0, 0):
        # buffers from the allocator: every row takes the wide path, odd n or not
        assert all(plan.in_vec) and all(plan.p_vec)
    if (r_addr, p_addr, m_addr) == (8, 0, 0):
        assert not any(plan.in_vec)  # a view one sample into a buffer


@pytest.mark.parametrize("shape", [(65,), (9001,), (3, 2049)])
def test_plain_metric_matches_float64_formula_and_jnp(shape):
    rng = np.random.RandomState(7)
    r = _cplx(rng, *shape)
    P, M = sync._timing_metric_torch(torch.as_tensor(r))
    P64, M64 = _formula64(r)
    np.testing.assert_allclose(P.numpy(), P64, atol=P_ATOL)
    np.testing.assert_allclose(M.numpy(), M64, atol=M_ATOL)
    Pj, Mj = ref_sync._timing_metric_jnp(jnp.asarray(r))
    np.testing.assert_allclose(P.numpy(), np.asarray(Pj), atol=P_ATOL)
    np.testing.assert_allclose(M.numpy(), np.asarray(Mj), atol=M_ATOL)


def test_plain_metric_zero_stream_and_scale():
    """All zeros: M = 0 by the 1e-12 clamp, no NaN.  A stream scaled by 1e3:
    P scales by 1e6 (and its float32 error with it), M does not move."""
    z = torch.zeros(500, dtype=torch.complex64)
    P, M = sync._timing_metric_torch(z)
    assert torch.all(P == 0) and torch.all(M == 0)
    r = _cplx(np.random.RandomState(8), 3000)
    P1, M1 = sync._timing_metric_torch(torch.as_tensor(r))
    Pk, Mk = sync._timing_metric_torch(torch.as_tensor(r * np.float32(1e3)))
    np.testing.assert_allclose(Pk.numpy() / 1e6, P1.numpy(), atol=P_ATOL)
    np.testing.assert_allclose(Mk.numpy(), M1.numpy(), atol=M_ATOL)


def test_metric_bytes_and_wrapper_arguments():
    assert sync_cuda.metric_bytes(3_770_368) == 8 * 3_770_368 + 12 * (3_770_368 - 64) == 75_406_592
    assert sync_cuda.metric_bytes(262_144, 8) == 8 * sync_cuda.metric_bytes(262_144)
    assert [sync_cuda.tiles_per_row(d) for d in (1, T - 15, T - 14, 2 * T)] == [1, 1, 2, 3]
    with pytest.raises(ValueError):
        sync_cuda.tiling(64)
    with pytest.raises(ValueError):
        sync_cuda.tiling(1000, r_addr=4)


def test_wrapper_constants_are_the_sources():
    """The grid the wrapper passes is worked out from TILE and ALIGN: they
    must be the kernel's kTile and kAlign."""
    src = sync_cuda.SOURCE.read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kTile") == sync_cuda.TILE and const("kAlign") == sync_cuda.ALIGN
    assert 2 * const("kHalf") == sync_cuda.FFT_LEN
