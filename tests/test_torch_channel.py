"""The channel models of the port against the JAX package's, on the same
inputs: a seeded numpy stream, and for the random parts the reference's own
draws (``jax.random`` keys split as the reference splits them) handed to the
port as tensors.

Tolerances.  Both sides compute in float32 in the same operation order, so
the phases agree to the bit and what differs is the last bit of cos/sin and
of the complex products: atol 2e-6 on unit-power streams (values ~1).  The
long cases (N = 2^21) compare the stream's last 4096 samples on their own:
there the phase is ~6e4 rad, one float32 ulp of it is 0.004-0.008 rad, and a
port that computed it in another order or in float64 would be off by ~1e-3
(shown by a case below), 500 times the bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.ops import channel as ref_channel

from gr_dtl_tpu_torch.ops import channel

ATOL = 2e-6
N_LONG = 1 << 21
TAIL = 4096


def _stream(n, seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n) + 1j * rng.randn(n)) / np.sqrt(2)).astype(np.complex64)


def _unit_normal(key, shape):
    """The unit draws of the reference's ``awgn`` for this key."""
    kr, ki = jax.random.split(key)
    return (np.asarray(jax.random.normal(kr, shape, dtype=jnp.float32))
            + 1j * np.asarray(jax.random.normal(ki, shape, dtype=jnp.float32))).astype(np.complex64)


def _close(got: torch.Tensor, want, atol=ATOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(got[..., -TAIL:], want[..., -TAIL:], rtol=0, atol=atol)


def test_awgn_matches_reference_with_its_draws():
    x = _stream(5000)
    key = jax.random.PRNGKey(3)
    want = ref_channel.awgn(key, jnp.asarray(x), 0.07)
    got = channel.awgn(torch.as_tensor(x), 0.07, noise=torch.as_tensor(_unit_normal(key, x.shape)))
    _close(got, want)


@pytest.mark.parametrize("freq_offset", [0.3, -0.11])
def test_apply_cfo_matches_reference_to_the_end_of_a_long_stream(freq_offset):
    x = _stream(N_LONG)
    want = jax.jit(lambda s: ref_channel.apply_cfo(s, freq_offset, 64))(jnp.asarray(x))
    got = channel.apply_cfo(torch.as_tensor(x), freq_offset, 64)
    _close(got, want)


def test_apply_cfo_takes_a_tensor_offset_and_a_batch():
    x = _stream(4 * 3000).reshape(4, 3000)
    want = ref_channel.apply_cfo(jnp.asarray(x), jnp.asarray(0.21), 64)
    got = channel.apply_cfo(torch.as_tensor(x), torch.tensor(0.21), 64)
    _close(got, want)


def test_a_float64_phase_would_miss_the_reference_at_the_end():
    """The test above has teeth: the "better" phase, computed in float64,
    rotates the tail of the stream visibly differently."""
    x = _stream(N_LONG)
    want = np.asarray(ref_channel.apply_cfo(jnp.asarray(x), 0.3, 64))
    n = np.arange(N_LONG, dtype=np.float64)
    better = (x * np.exp(1j * 2 * np.pi * 0.3 * n / 64)).astype(np.complex64)
    assert np.abs(better[-TAIL:] - want[-TAIL:]).max() > 100 * ATOL
    assert np.abs(better[:TAIL] - want[:TAIL]).max() < 100 * ATOL


def test_fir_channel_matches_reference_and_its_tap_order():
    x = _stream(6000, seed=1)
    taps = np.array([1.0, 0.4 - 0.3j, -0.2 + 0.1j, 0.05j], np.complex64)
    want = ref_channel.fir_channel(jnp.asarray(x), jnp.asarray(taps))
    got = channel.fir_channel(torch.as_tensor(x), torch.as_tensor(taps))
    _close(got, want)
    # the taps are added in the reference's order, tap 0 first: ~72% of the
    # outputs then equal the reference to the bit (the rest differ by the
    # rounding of its fused complex products); added last tap first, the
    # same sums in another order, only ~27% would
    assert (got.numpy() == np.asarray(want)).mean() > 0.5
    # tap i delays by i samples: the impulse response is the taps, in order
    imp = np.zeros(16, np.complex64)
    imp[0] = 1
    h = channel.fir_channel(torch.as_tensor(imp), taps).numpy()
    np.testing.assert_array_equal(h[:4], taps)
    assert not h[4:].any()
    # taps as a plain tuple; a batch of rows is filtered row by row
    want = ref_channel.fir_channel(jnp.asarray(x), jnp.asarray((0.9, 0.3, 0.1)))
    _close(channel.fir_channel(torch.as_tensor(x), (0.9, 0.3, 0.1)), want)
    xb = torch.as_tensor(x.reshape(3, 2000))
    rows = torch.stack([channel.fir_channel(r, taps) for r in xb])
    assert torch.equal(channel.fir_channel(xb, taps), rows)


def test_channel_model_matches_reference_with_its_draws():
    x = _stream(20000, seed=2)
    key = jax.random.PRNGKey(5)
    kw = dict(noise_voltage=0.02, freq_offset=0.2, taps=(1.0, 0.3 + 0.2j, -0.1j))
    want = jax.jit(lambda s: ref_channel.channel_model(key, s, **kw))(jnp.asarray(x))
    got = channel.channel_model(torch.as_tensor(x), **kw,
                                noise=torch.as_tensor(_unit_normal(key, x.shape)))
    _close(got, want)
    with pytest.raises(ValueError):
        channel.channel_model(torch.as_tensor(x), **kw)


@pytest.mark.parametrize("ppm", [50.0, -50.0, 0.0])
def test_sample_clock_offset_matches_reference_to_the_end_of_a_long_stream(ppm):
    """At 2^21 samples and 50 ppm the read position has drifted by ~105
    samples: ``n * delta`` and its floor must round as the reference's."""
    x = _stream(N_LONG, seed=3)
    want = jax.jit(lambda s: ref_channel.sample_clock_offset(s, ppm))(jnp.asarray(x))
    got = channel.sample_clock_offset(torch.as_tensor(x), ppm)
    _close(got, want, atol=5e-6)  # four taps of weight up to 1.1 each


def test_sample_clock_offset_is_the_identity_at_zero_ppm():
    x = _stream(3000)
    np.testing.assert_allclose(channel.sample_clock_offset(torch.as_tensor(x), 0.0).numpy(), x,
                               atol=1e-6)


def _fading_draws(key, L, K):
    keys = jax.random.split(key, 3)
    return np.stack([np.asarray(jax.random.uniform(k, (L, K), minval=0.0, maxval=2 * jnp.pi))
                     for k in keys])


@pytest.mark.parametrize("n,seed,kw", [
    (N_LONG, 5, dict(delays=(0, 5), powers_db=(0.0, -6.0), doppler_norm=1e-4, n_sinusoids=4)),
    (30000, 3, dict()),  # the defaults: 3 taps, 8 sinusoids
    (30000, 3, dict(delays=(0, 2, 5), powers_db=(0.0, -6.0, -9.0), doppler_norm=2e-5)),
])
def test_selective_fading_matches_reference_with_its_draws(n, seed, kw):
    x = _stream(n, seed=4)
    key = jax.random.PRNGKey(seed)
    L, K = len(kw.get("delays", (0, 3, 7))), kw.get("n_sinusoids", 8)
    draws = _fading_draws(key, L, K)
    if n == N_LONG:
        # w = 2 pi f_d cos(alpha) is multiplied by t up to 2^21, so one ulp of
        # a cos(alpha), where the two libraries' cosines differ (they do for
        # one of the eight under PRNGKey(3)), becomes ~1e-4 rad at the end of
        # the stream.  This key's eight cosines are equal in both, so what
        # the case holds is the order of w t + phi far into the stream.
        assert np.array_equal(np.asarray(jnp.cos(jnp.asarray(draws[0]))),
                              torch.cos(torch.as_tensor(draws[0])).numpy())
    want = jax.jit(lambda s: ref_channel.selective_fading(key, s, **kw))(jnp.asarray(x))
    got = channel.selective_fading(torch.as_tensor(x), **kw, draws=torch.as_tensor(draws))
    # w t reaches ~1.3e3 rad at the end of the long stream (ulp 1.2e-4): the
    # angles agree to the bit, the sums of K cosines to a few 1e-7
    _close(got, want, atol=5e-6)


def test_selective_fading_from_a_generator_is_rayleigh_like():
    x = torch.ones(200000, dtype=torch.complex64)
    g = torch.Generator().manual_seed(0)
    y = channel.selective_fading(x, delays=(0,), powers_db=(0.0,), doppler_norm=1e-3, generator=g)
    p = float((y.abs() ** 2).mean())
    assert 0.5 < p < 2.0  # unit mean power, a finite sum of sinusoids
    assert float(y.abs().min()) < 0.2 < 1.5 < float(y.abs().max())  # it fades
    with pytest.raises(ValueError):
        channel.selective_fading(x, generator=g, draws=torch.zeros(3, 3, 8))
