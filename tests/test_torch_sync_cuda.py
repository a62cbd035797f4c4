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


@pytest.mark.parametrize("shape", [(9000,), (8256,), (4, 9000)])
def test_kernel_matches_plain_metric(gpu, shape):
    rng = np.random.RandomState(0)
    r = torch.as_tensor((rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64), device=gpu)
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
