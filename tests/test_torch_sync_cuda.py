"""The CUDA Schmidl-Cox kernel against its plain PyTorch version, on the
card.  Marked ``cuda``: these skip without an NVIDIA GPU (the kernel has
no CPU mode).  On a machine with the card but without JAX or pytest-xdist:
``python3 -m pytest -o addopts= --noconftest -q tests/test_torch_sync_cuda.py``."""

import numpy as np
import pytest
import torch

from gr_dtl_tpu_torch.ops import sync, sync_cuda

pytestmark = pytest.mark.cuda

# the reference's bars for a metric kernel against the plain metric
# (tests/test_sync_pallas.py)
P_ATOL, M_ATOL = 2e-4, 2e-3


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


T = sync_cuda.TILE


def _stream(shape, gpu, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return torch.as_tensor((scale * (rng.randn(*shape) + 1j * rng.randn(*shape))).astype(np.complex64),
                           device=gpu)


# one output; a tile and one output more; rows that start off a 16-byte
# boundary (odd N, S = 3); tiles whose last walkers have nothing to emit
@pytest.mark.parametrize("shape", [(9000,), (8256,), (4, 9000), (65,), (66,), (T + 64,), (T + 65,),
                                   (3, 9001), (3, T + 79), (5, 131), (2, 3 * T + 64 + 17),
                                   (8, 262144)])
def test_kernel_matches_plain_metric(gpu, shape):
    r = _stream(shape, gpu)
    before = sync_cuda.timing_metric_cuda.LAUNCHES
    P, M = sync.timing_metric(r)
    torch.cuda.synchronize()
    assert sync_cuda.timing_metric_cuda.LAUNCHES == before + 1
    P0, M0 = sync._timing_metric_torch(r)
    assert P.shape == P0.shape and P.dtype == torch.complex64 and M.dtype == torch.float32
    assert (P - P0).abs().max().item() <= P_ATOL
    assert (M - M0).abs().max().item() <= M_ATOL


def test_kernel_refuses_what_it_does_not_take(gpu):
    r = torch.zeros(1000, dtype=torch.complex64, device=gpu)
    with pytest.raises(ValueError):
        sync_cuda.timing_metric_cuda(r, fft_len=128)
    with pytest.raises(ValueError):
        sync_cuda.timing_metric_cuda(r.to(torch.complex128))
    with pytest.raises(ValueError):
        sync_cuda.timing_metric_cuda(torch.zeros(2, 1000, dtype=torch.complex64, device=gpu)[:, ::2])


def test_kernel_on_views_off_the_16_byte_grid(gpu):
    """A contiguous view one sample into a buffer: its rows take 8-byte loads."""
    buf = _stream((2 * T + 200,), gpu, seed=1)
    for r in (buf[1:], buf[3:2 * T + 100], buf[2:]):
        assert r.is_contiguous()
        P, M = sync_cuda.timing_metric_cuda(r)
        P0, M0 = sync._timing_metric_torch(r)
        assert (P - P0).abs().max().item() <= P_ATOL and (M - M0).abs().max().item() <= M_ATOL


def test_kernel_zero_stream(gpu):
    """M = 0 by the 1e-12 clamp, no NaN."""
    P, M = sync_cuda.timing_metric_cuda(torch.zeros(3, 5000, dtype=torch.complex64, device=gpu))
    assert torch.all(P == 0) and torch.all(M == 0)


def test_kernel_scaled_stream(gpu):
    """A stream scaled by 1e3: P grows by 1e6 and its float32 rounding with
    it, so P is held to 1e6 times the bar; M is a ratio and keeps its bar."""
    r = _stream((3, 9001), gpu, seed=2, scale=1e3)
    P, M = sync_cuda.timing_metric_cuda(r)
    P0, M0 = sync._timing_metric_torch(r)
    assert torch.isfinite(M).all() and torch.isfinite(torch.view_as_real(P)).all()
    assert (P - P0).abs().max().item() <= 1e6 * P_ATOL
    assert (M - M0).abs().max().item() <= M_ATOL


def test_kernel_precision_does_not_depend_on_stream_length(gpu):
    """The last 4096 outputs of a 16 Msample stream against a float64
    evaluation of the formula by direct 32-term sums."""
    n, tail = 1 << 24, 4096
    gen = torch.Generator(device=gpu).manual_seed(3)
    r = torch.randn(n, generator=gen, device=gpu, dtype=torch.complex64)
    P, M = sync_cuda.timing_metric_cuda(r)
    torch.cuda.synchronize()
    seg = r[n - 64 - tail:].cpu().numpy().astype(np.complex128)  # outputs n-64-tail .. n-64
    win = np.lib.stride_tricks.sliding_window_view
    P64 = win(np.conj(seg[:-32]) * seg[32:], 32).sum(-1)[:tail]
    E = win(np.abs(seg) ** 2, 32).sum(-1)
    M64 = np.abs(P64) ** 2 / np.maximum(E[:tail] * E[32:32 + tail], 1e-12)
    np.testing.assert_allclose(P[-tail:].cpu().numpy(), P64, atol=P_ATOL)
    np.testing.assert_allclose(M[-tail:].cpu().numpy(), M64, atol=M_ATOL)
    # and the first outputs, where a running sum would still be small
    seg = r[:tail + 64].cpu().numpy().astype(np.complex128)
    P64 = win(np.conj(seg[:-32]) * seg[32:], 32).sum(-1)[:tail]
    np.testing.assert_allclose(P[:tail].cpu().numpy(), P64, atol=P_ATOL)


def test_launch_into_preallocated_outputs(gpu):
    r = _stream((2, 5000), gpu, seed=4)
    P = torch.full((2, 5000 - 64, 2), float("nan"), device=gpu)
    M = torch.full((2, 5000 - 64), float("nan"), device=gpu)
    before = sync_cuda.timing_metric_cuda.LAUNCHES
    sync_cuda._launch_into(r, P, M)
    torch.cuda.synchronize()
    assert sync_cuda.timing_metric_cuda.LAUNCHES == before + 1
    P0, M0 = sync._timing_metric_torch(r)
    assert (torch.view_as_complex(P) - P0).abs().max().item() <= P_ATOL
    assert (M - M0).abs().max().item() <= M_ATOL
