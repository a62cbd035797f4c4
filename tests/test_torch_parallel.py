"""The sharded batch receiver and the sharded loopback, port against the JAX
package, and the grid, start-up and collectives they stand on.

The reference runs on the virtual CPU devices of tests/conftest.py; the
port's ranks run as gloo worker processes on the same ``(stream, time)``
grid, (1, 2), (2, 2) and (2, 1) (``parallel.launch.spawn``; the workers
import the port and torch only).  The loopback's pad bytes and channel
noise are the reference's own draws (its key folded by the shard's stream
and time index, then split), computed here and handed to the port.  Ints,
bools and bytes must be equal; ``snr_db`` / ``noise_var`` are held to 1e-3
relative on the decoded frames (float32 on both sides, summed in another
order, as in tests/test_torch_receiver.py).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import fec_chain as ref_fec_chain
from gr_dtl_tpu.parallel import mesh as ref_mesh, stream as ref_stream
from gr_dtl_tpu.utils import alist as ref_alist, config as ref_config

from gr_dtl_tpu_torch import entry
from gr_dtl_tpu_torch.models import transmitter
from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.parallel import _coll, dist, launch, mesh as meshmod
from gr_dtl_tpu_torch.utils import config

GRIDS = [(1, 2), (2, 2), (2, 1)]
ALIST = Path(__file__).resolve().parent.parent / "examples" / "n_0100_k_0027.alist"
INT_FIELDS = ("payload", "payload_len", "crc_ok", "header_ok", "frame_no", "cnst_id",
              "feedback_cnst", "carr_offset")


def assert_out_equal(got: dict, want, what: str):
    for k in INT_FIELDS:
        w = np.asarray(getattr(want, k))
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, (what, k)
        np.testing.assert_array_equal(got[k], w, err_msg=f"{what} {k}")
    ok = np.asarray(want.header_ok)
    assert ok.all(), what
    for k in ("snr_db", "noise_var"):
        np.testing.assert_allclose(got[k][ok], np.asarray(getattr(want, k))[ok], rtol=1e-3,
                                   err_msg=f"{what} {k}")


def _bytes(key, shape):
    return np.asarray(jax.random.randint(key, shape, 0, 256, dtype=jnp.int32).astype(jnp.uint8))


def _unit_normal(key, shape):
    kr, ki = jax.random.split(key)
    return (np.asarray(jax.random.normal(kr, shape, dtype=jnp.float32))
            + 1j * np.asarray(jax.random.normal(ki, shape, dtype=jnp.float32))).astype(np.complex64)


def reference_draws(key, grid, S, F, maxb, samples_per_frame):
    """The reference loopback's draws as global arrays: on the shard at
    (s, t) the key folded by s then t, split into the pad key and the
    noise key; pad [S_l * F_l, maxb] bytes and noise [S_l, F_l * P]."""
    n_stream, n_time = grid
    S_l, F_l = S // n_stream, F // n_time
    pad = np.zeros((S, F, maxb), np.uint8)
    noise = np.zeros((S, F * samples_per_frame), np.complex64)
    for s in range(n_stream):
        for t in range(n_time):
            k = jax.random.fold_in(jax.random.fold_in(key, s), t)
            kpad, kn = jax.random.split(k)
            rows, cols = slice(s * S_l, (s + 1) * S_l), slice(t * F_l, (t + 1) * F_l)
            pad[rows, cols] = _bytes(kpad, (S_l * F_l, maxb)).reshape(S_l, F_l, maxb)
            w = F_l * samples_per_frame
            noise[rows, t * w:(t + 1) * w] = _unit_normal(kn, (S_l, w))
    return pad, noise


@pytest.mark.parametrize("grid", GRIDS)
def test_sharded_rx_matches_reference(grid):
    """2 streams of n_time blocks of 2 frames (mixed constellations),
    AWGN at 30 dB from one numpy draw; the last block's halo wraps to the
    first block's head, in both packages."""
    cfg = config.make_rx_config(None, frame_length=8)
    tcfg = config.make_tx_config(None, frame_length=8)
    S, fpb = 2, 2
    F = fpb * grid[1]
    rng = np.random.RandomState(sum(grid))
    cnst = rng.randint(1, 5, (S * F,)).astype(np.int32)
    plen = np.array([tcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[c])) - 4 for c in cnst], np.int32)
    payload = rng.randint(0, 256, (S * F, tcfg.max_frame_bytes())).astype(np.uint8)
    payload[np.arange(payload.shape[1])[None, :] >= plen[:, None]] = 0
    out = transmitter.tx_frames(
        transmitter.build_tx(tcfg, "cpu"), torch.as_tensor(payload), torch.as_tensor(plen),
        torch.as_tensor(cnst), torch.zeros(S * F, dtype=torch.int32),
        torch.arange(S * F, dtype=torch.int32) % F,
        torch.as_tensor(rng.randint(0, 256, payload.shape).astype(np.uint8)))
    streams = out.samples.reshape(S, -1).numpy()
    std = np.float32(np.sqrt(np.mean(np.abs(streams) ** 2) / 1e3) / np.sqrt(2.0))
    streams = (streams + std * (rng.randn(*streams.shape) + 1j * rng.randn(*streams.shape))
               ).astype(np.complex64)

    fn, _ = ref_stream.build_sharded_rx(ref_config.make_rx_config(None, frame_length=8),
                                        ref_mesh.make_mesh(*grid), frames_per_block=fpb)
    want = fn(jnp.asarray(streams))
    ranks = launch.spawn(launch.run_sharded_rx, *grid, device="cpu", cfg=cfg, streams=streams,
                         frames_per_block=fpb)
    for r in ranks:
        assert_out_equal(r, want, f"grid {grid}")
    np.testing.assert_array_equal(ranks[0]["payload"], payload.reshape(S, F, -1))


@pytest.mark.parametrize("grid", GRIDS)
def test_sharded_loopback_matches_reference(grid):
    """TX + AWGN + RX on every rank with the reference's per-shard draws."""
    txcfg = config.make_tx_config(None, frame_length=8)
    rxcfg = config.make_rx_config(None, frame_length=8)
    S, fpb = 2, 2
    F = fpb * grid[1]
    rng = np.random.RandomState(21)
    maxb = txcfg.max_frame_bytes()
    cnst = rng.randint(1, 5, (S, F)).astype(np.int32)
    plen = np.vectorize(lambda c: txcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[c])) - 4)(cnst).astype(np.int32)
    payload = rng.randint(0, 256, (S, F, maxb)).astype(np.uint8)
    payload[np.arange(maxb)[None, None, :] >= plen[:, :, None]] = 0
    frame_no = np.tile(np.arange(F, dtype=np.int32), (S, 1))
    key = jax.random.PRNGKey(5)
    pad, noise = reference_draws(key, grid, S, F, maxb, rxcfg.frame_samples)

    step, _ = ref_stream.build_sharded_loopback(
        ref_config.make_tx_config(None, frame_length=8), ref_config.make_rx_config(None, frame_length=8),
        ref_mesh.make_mesh(*grid), frames_per_block=fpb, noise_v=0.02)
    want = step(jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst), jnp.asarray(frame_no), key)
    inputs = {"payload": payload, "plen": plen, "cnst": cnst, "frame_no": frame_no, "pad": pad,
              "noise": noise}
    ranks = launch.spawn(launch.run_loopback, *grid, device="cpu", txcfg=txcfg, rxcfg=rxcfg,
                         frames_per_block=fpb, noise_v=0.02, inputs=inputs)
    for r in ranks:
        assert_out_equal(r, want, f"grid {grid}")
    np.testing.assert_array_equal(ranks[0]["payload"], payload)


def test_sharded_coded_loopback_matches_reference():
    """The LDPC path (n=100 k=27, one frame a TB) on a (2, 1) grid: the
    noise draws of the reference, every TB recovered."""
    grid, S, fpb = (2, 1), 2, 2
    ref_tx = ref_config.make_tx_config(None, frame_length=4, fec=True)
    ref_rx = ref_config.make_rx_config(None, frame_length=4, fec=True)
    txcfg = config.make_tx_config(None, frame_length=4, fec=True)
    rxcfg = config.make_rx_config(None, frame_length=4, fec=True)
    ref_fec = ref_fec_chain.build_fec(ref_tx, ref_alist.load_alist(str(ALIST)))
    fec = launch._fec((txcfg, ALIST, 1), "cpu")
    rng = np.random.RandomState(5)
    ub = int(fec.user_bytes_tab[2])
    plen = np.full((S, fpb), ub, np.int32)
    payload = np.zeros((S, fpb, fec.max_payload_bytes), np.uint8)
    payload[:, :, :ub] = rng.randint(0, 256, (S, fpb, ub))
    cnst = np.full((S, fpb), 2, np.int32)
    frame_no = np.tile(np.arange(fpb, dtype=np.int32), (S, 1))
    key = jax.random.PRNGKey(3)
    _, noise = reference_draws(key, grid, S, fpb, 1, rxcfg.frame_samples)
    step, _ = ref_stream.build_sharded_loopback(ref_tx, ref_rx, ref_mesh.make_mesh(*grid),
                                                frames_per_block=fpb, noise_v=0.01, fec=ref_fec)
    want = step(jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst), jnp.asarray(frame_no), key)
    inputs = {"payload": payload, "plen": plen, "cnst": cnst, "frame_no": frame_no, "pad": None,
              "noise": noise}
    ranks = launch.spawn(launch.run_loopback, *grid, device="cpu", txcfg=txcfg, rxcfg=rxcfg,
                         frames_per_block=fpb, noise_v=0.01, inputs=inputs, fec=(txcfg, ALIST, 1))
    for r in ranks:
        assert_out_equal(r, want, "coded")
        assert r["crc_ok"].all()
    np.testing.assert_array_equal(ranks[0]["payload"][:, :, :ub], payload[:, :, :ub])


def test_dryrun_multichip_on_four_gloo_ranks():
    """The port's dry run over a 2 x 2 grid of spawned processes: uncoded
    and coded loopbacks and three chained ShardedStreamRx blocks decode
    every frame (it raises otherwise)."""
    entry.dryrun_multichip(4, "cpu")


def test_entry_forward_decodes_its_example():
    fn, (frames,) = entry.entry("cpu")
    out = fn(frames)
    assert out.crc_ok.all() and out.payload.shape[0] == 8


def test_collectives_are_the_identity_on_a_one_rank_grid():
    """Without a process group the grid is 1 x 1: no groups, and every
    collective along an axis of size 1 hands its input back."""
    m = meshmod.make_mesh(device="cpu")
    assert m.shape == {"stream": 1, "time": 1} and m.index == {"stream": 0, "time": 0}
    assert m.time_group is None and m.stream_group is None
    x = torch.arange(6.0).reshape(2, 3).to(torch.complex64)
    for y in (_coll.ring_shift(x, m, 1), _coll.ring_shift(x, m, -1),
              _coll.all_reduce_sum(x, m.time_group), _coll.all_gather(x, m.time_group, 1),
              _coll.gather_global(x, m, 1)):
        assert y is x
    with pytest.raises(ValueError, match="needs 2 ranks"):
        meshmod.make_mesh(2, 1, device="cpu")


def test_dist_start_up_rules(monkeypatch):
    """A single process joins no group; the backend follows the device;
    a time ring may not straddle two hosts."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert dist.init(device="cpu") is False
    assert dist.init("127.0.0.1:1", num_processes=1, device="cpu") is False
    assert (dist.backend_for("cpu"), dist.backend_for("cuda:0")) == ("gloo", "nccl")
    with pytest.raises(ValueError):
        dist.backend_for("meta")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="inside a host"):
        dist.make_host_mesh(n_time=2, device="cpu")
    assert dist.make_host_mesh(n_time=1, device="cpu").shape == {"stream": 1, "time": 1}
