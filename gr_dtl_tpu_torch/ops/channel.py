"""Channel models for loopback testing (port of gr_dtl_tpu/ops/channel.py).

Only AWGN is ported so far; CFO, multipath and fading wait for slice D.
"""

from __future__ import annotations

import math

import torch

__all__ = ["awgn"]


def awgn(x: torch.Tensor, noise_voltage: float, *,
         generator: torch.Generator | None = None,
         noise: torch.Tensor | None = None) -> torch.Tensor:
    """Add complex white noise with E|n|^2 = noise_voltage^2 (gr
    channel_model semantics: ``noise_voltage`` feeds both I/Q sources,
    each with std ``noise_voltage / sqrt(2)``).

    The unit draws come either from ``generator`` (on x's device) or, as
    given, from ``noise``: a complex64 tensor of x's shape whose real and
    imaginary parts are independent standard normal draws.
    """
    if (generator is None) == (noise is None):
        raise ValueError("awgn takes exactly one of generator= or noise=")
    if noise is None:
        re = torch.randn(x.shape, generator=generator, device=x.device)
        im = torch.randn(x.shape, generator=generator, device=x.device)
        noise = torch.complex(re, im)
    elif noise.shape != x.shape:
        raise ValueError(f"noise shape {tuple(noise.shape)} != signal shape {tuple(x.shape)}")
    std = float(noise_voltage) / math.sqrt(2.0)
    return x + (std * noise).to(torch.complex64)
