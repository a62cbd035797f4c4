"""Channel models for loopback testing (port of gr_dtl_tpu/ops/channel.py):
AWGN, carrier frequency offset, static multipath, sample-clock offset and
time-varying Rayleigh selective fading, as tensor ops on the signal's
device, so a whole simulation sweep runs there.

All of it is float32 / complex64 in the reference's operation order: the
phases ``2 pi f n / fft_len``, ``w t`` and ``n delta`` reach ~1e5 rad (or
samples) far into a stream, where one float32 ulp is ~0.008, so another
order, or float64, would rotate the tail of a long stream differently from
the reference.  Random draws come from an explicit ``torch.Generator`` or
are passed in as tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["awgn", "apply_cfo", "fir_channel", "channel_model",
           "selective_fading", "sample_clock_offset"]

_TWO_PI_F32 = np.float32(2.0 * math.pi)


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


def apply_cfo(x: torch.Tensor, freq_offset: float | torch.Tensor, fft_len: int = 64) -> torch.Tensor:
    """Rotate by a carrier frequency offset given in *subcarrier units*
    (1.0 = one OFDM carrier spacing = fs/fft_len)."""
    n = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    # float32, left to right: (2 pi * f) * n / fft_len
    if isinstance(freq_offset, torch.Tensor):
        scale = float(_TWO_PI_F32) * freq_offset.to(x.device, torch.float32)
    else:
        scale = float(_TWO_PI_F32 * np.float32(freq_offset))
    ph = scale * n / fft_len
    return x * torch.polar(torch.ones_like(ph), ph)


def fir_channel(x: torch.Tensor, taps) -> torch.Tensor:
    """Causal FIR multipath channel, same length output.  The taps are
    added in turn, tap 0 first."""
    t = torch.as_tensor(taps, device=x.device).to(torch.complex64).reshape(-1)
    L, N = t.shape[0], x.shape[-1]
    xp = torch.nn.functional.pad(x, (L - 1, 0))
    acc = torch.zeros_like(x)
    for i in range(L):
        acc = acc + t[i] * xp[..., L - 1 - i: L - 1 - i + N]
    return acc


def channel_model(x: torch.Tensor, *, noise_voltage: float = 0.0, freq_offset=0.0,
                  taps=(1.0,), fft_len: int = 64, generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
    """AWGN + CFO + static multipath, the loopback test channel.  The
    noise draws as for :func:`awgn`."""
    y = fir_channel(x, taps)
    y = apply_cfo(y, freq_offset, fft_len)
    return awgn(y, noise_voltage, generator=generator, noise=noise)


def sample_clock_offset(x: torch.Tensor, ppm: float) -> torch.Tensor:
    """Sample-frequency offset (SFO): resample by ``1 + ppm * 1e-6``.

    Models TX/RX sample-clock mismatch, the impairment the trigger lock
    exists to absorb.  Output sample ``n`` reads the input at position
    ``n * (1 + ppm*1e-6)`` via Catmull-Rom cubic interpolation (accurate
    to ~-45 dB for this 52/64-occupied OFDM signal).  The fractional drift
    ``n * delta`` is computed apart from the integer ramp, so float32 keeps
    sub-sample precision over multi-second captures.
    """
    N = x.shape[-1]
    delta = float(np.float32(float(ppm) * 1e-6))
    n = torch.arange(N, dtype=torch.int32, device=x.device)
    d = n.float() * delta
    di = torch.floor(d).int()
    mu = d - di.float()  # fractional part, [0, 1)
    idx = n + di

    def at(k):
        return x[..., torch.clamp(idx + k, 0, N - 1).long()]

    xm1, x0, x1, x2 = at(-1), at(0), at(1), at(2)
    a = (-xm1 + 3 * x0 - 3 * x1 + x2) * 0.5
    b = xm1 - 2.5 * x0 + 2 * x1 - 0.5 * x2
    c = (x1 - xm1) * 0.5
    return ((a * mu + b) * mu + c) * mu + x0


def selective_fading(x: torch.Tensor, *, delays=(0, 3, 7), powers_db=(0.0, -3.0, -6.0),
                     doppler_norm: float = 1e-4, n_sinusoids: int = 8,
                     generator: torch.Generator | None = None,
                     draws: torch.Tensor | None = None) -> torch.Tensor:
    """Time-varying Rayleigh frequency-selective fading: each discrete
    delay tap fades independently with a Jakes-like sum-of-sinusoids
    process; the taps are then applied as a time-varying FIR.

    Args:
      x:            [N] complex stream.
      delays:       integer tap delays in samples.
      powers_db:    average power per tap (normalized internally).
      doppler_norm: max Doppler as a fraction of the sample rate
                    (f_d / f_s); 1e-4 at 64-sample symbols means the
                    channel decorrelates over ~100 OFDM symbols.
      n_sinusoids:  sinusoids per tap for the Jakes sum (K).
      generator / draws: exactly one.  ``draws`` is a float32 tensor
                    [3, L, K] of angles in [0, 2 pi): the arrival angles
                    ``alpha`` and the two phase sets ``phi`` and ``psi``.

    The ``[L, K, N]`` sum of sinusoids is materialised (float32
    temporaries of 4 L K N bytes each, the complex one twice that).
    """
    if (generator is None) == (draws is None):
        raise ValueError("selective_fading takes exactly one of generator= or draws=")
    n = x.shape[-1]
    dev = x.device
    L, K = len(delays), int(n_sinusoids)
    if draws is None:
        draws = torch.rand((3, L, K), generator=generator, device=dev) * (2 * math.pi)
    elif tuple(draws.shape) != (3, L, K):
        raise ValueError(f"draws must be [3, {L}, {K}], got {tuple(draws.shape)}")
    alpha, phi, psi = draws.to(dev, torch.float32)
    p = 10.0 ** (torch.as_tensor(powers_db, dtype=torch.float32, device=dev) / 10.0)
    p = p / p.sum()
    t = torch.arange(n, dtype=torch.float32, device=dev)

    # h_l(t) = sqrt(p_l / K) sum_k exp(i(2 pi f_d cos(a_k) t + phi_k)),
    # with a quadrature component for proper Rayleigh statistics
    w = (2 * math.pi * doppler_norm) * torch.cos(alpha)  # [L, K]
    ang = w[:, :, None] * t[None, None, :]  # [L, K, N]
    h = torch.complex(torch.cos(ang + phi[:, :, None]), torch.cos(ang + psi[:, :, None]))
    h = h.sum(1) * torch.sqrt(p[:, None] / (2 * K))  # [L, N]

    y = torch.zeros_like(x)
    for i, d in enumerate(delays):
        xd = torch.nn.functional.pad(x[: n - d], (d, 0)) if d else x
        y = y + h[i] * xd
    return y
