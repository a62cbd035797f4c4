"""The port's bench (``gr_dtl_tpu_torch/bench.py``) against the JAX
package's top-level ``bench.py``, on the CPU.

``bench.py`` keeps its traffic, its stream and its step inside ``main``, so
the reference side here runs those very lines: they are taken from its
source with ``ast`` and executed (every statement of ``main`` up to the
step's definition, B set here in place of ``sys.argv``).  The step's
per-frame outputs are not returned by ``bench.py``'s step, so a restated
step that also returns its ``RxOut`` runs beside it; both must give the same
``acc``.  The Schmidl-Cox metric takes its jnp form on the CPU
(``gr_dtl_tpu/ops/sync.py``'s ``platform_dependent``).

The port's pad bytes and noise come from a ``torch.Generator``, so its own
stream is not the reference's: the chained steps run on the reference's
stream, handed over as numpy.  Ints, bools and ``acc`` must be equal
exactly.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import receiver as ref_rx
from gr_dtl_tpu.ops import constellation as ref_cn
from gr_dtl_tpu.utils import config as ref_config

from gr_dtl_tpu_torch import bench
from gr_dtl_tpu_torch.models import receiver
from gr_dtl_tpu_torch.utils import config

ROOT = Path(__file__).resolve().parent.parent
CHAIN_B, CHAIN_STEPS = 8, 3


def _bench_main() -> list:
    """The statements of ``bench.py``'s ``main``."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main").body


def _assigns(stmt, name: str) -> bool:
    return isinstance(stmt, ast.Assign) and any(isinstance(t, ast.Name) and t.id == name for t in stmt.targets)


def _run(stmts, ns: dict) -> dict:
    exec(compile(ast.Module(body=list(stmts), type_ignores=[]), str(ROOT / "bench.py"), "exec"), ns)
    return ns


def _result_keys() -> tuple:
    """The keys of the JSON line ``bench.py`` prints, and of its ``extra``."""
    call = next(n for n in ast.walk(ast.Module(body=_bench_main(), type_ignores=[]))
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.func.attr == "dumps")
    top = call.args[0]
    extra = next(v for k, v in zip(top.keys, top.values) if k.value == "extra")
    return {k.value for k in top.keys}, {k.value for k in extra.keys}


@pytest.mark.parametrize("B", [2048, 8])
def test_traffic_is_bench_py_draws(B):
    body = _bench_main()
    first = next(i for i, s in enumerate(body) if _assigns(s, "rng"))
    last = next(i for i, s in enumerate(body) if i > first and isinstance(s, ast.For))
    ns = _run(body[first:last + 1], {"np": np, "cn": ref_cn, "B": B,
                                     "txcfg": ref_config.make_tx_config(None, frame_length=20)})
    got = bench.traffic(config.make_tx_config(None, frame_length=bench.FRAME_LENGTH), B)
    for name, g in zip(("cnst", "plen", "payload"), got):
        want = ns[name]
        assert g.dtype == want.dtype and g.shape == want.shape, name
        assert g.tobytes() == want.tobytes(), name


def test_chained_steps_match_bench_py():
    body = _bench_main()
    upto = next(i for i, s in enumerate(body) if isinstance(s, ast.FunctionDef) and s.name == "step")
    # numpy is imported at bench.py's top, the rest inside main
    ns = _run([s for s in body[:upto + 1] if not _assigns(s, "B")], {"np": np, "B": CHAIN_B})
    cfg, rxp_ref = ns["cfg"], ns["rxp"]
    assert cfg.frame_length == bench.FRAME_LENGTH and ns["n_samples"] == CHAIN_B * cfg.frame_samples

    @jax.jit
    def ref_step(s, acc):  # bench.py:97-104, returning the step's RxOut too
        s = s * jnp.exp(1j * acc * 1e-12)
        frames, _ = ref_rx.detect_and_extract(s, cfg, CHAIN_B)
        r = ref_rx.rx_frames(rxp_ref, frames)
        return acc + jnp.sum(r.crc_ok).astype(jnp.float32), r

    stream_ref = ns["stream"]
    stream = torch.as_tensor(np.array(stream_ref))
    assert stream.dtype == torch.complex64 and stream.shape == (CHAIN_B * cfg.frame_samples + bench.STREAM_TAIL,)
    rxp = receiver.build_rx(config.make_rx_config(None, frame_length=bench.FRAME_LENGTH), "cpu")
    acc_bench = acc_ref = jnp.float32(0)
    acc = torch.zeros((), dtype=torch.float32)
    for i in range(CHAIN_STEPS):
        acc_bench = ns["step"](stream_ref, acc_bench)
        acc_ref, want = ref_step(stream_ref, acc_ref)
        acc, got = bench.step(rxp, CHAIN_B, stream, acc)
        assert acc.dtype == torch.float32 and acc.shape == ()
        assert float(acc) == float(acc_ref) == float(acc_bench) == CHAIN_B * (i + 1), i
        for k in ("crc_ok", "payload", "frame_no"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                          err_msg=f"{k}, step {i}")


def test_main_prints_one_line_with_bench_py_keys(capsys):
    res = bench.main(["8", "--device", "cpu", "--reps", "1", "--iters", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(res))
    top, extra = _result_keys()
    assert set(line) == top and extra <= set(line["extra"])
    assert line["metric"] == "ofdm_demod_throughput" and line["unit"] == "Msamples/s"
    assert line["vs_baseline"] is None
    x = line["extra"]
    assert x["crc_ok_rate"] == 1.0 and x["frames_per_step"] == 8 and x["device"] == "cpu"
    assert (x["reps"], x["iters"]) == (1, 2) and len(x["step_ms_windows"]) == 1
    assert line["value"] == pytest.approx(8 * 1840 / x["step_ms"] / 1e3) and line["value"] > 0


def test_without_a_card_the_bench_stops():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "gr_dtl_tpu_torch.bench", "8"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr


def test_lost_frames_exit_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(bench, "NOISE_V", 1.0)
    with pytest.raises(SystemExit) as exc:
        bench.main(["8", "--device", "cpu", "--reps", "1", "--iters", "1"])
    assert exc.value.code not in (None, 0) and "failed their CRC" in str(exc.value.code)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["extra"]["crc_ok_rate"] < 1.0


def test_device_label_names_the_card_and_its_power_limit(monkeypatch):
    """On a card the ``device`` field is nvidia-smi's name and power limit
    of that card (the call is faked here: there is no card)."""
    from gr_dtl_tpu_torch.tools import _timing

    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n", stderr="")

    monkeypatch.setattr(_timing.subprocess, "run", run)
    assert _timing.device_label("cuda:1") == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert calls == [["nvidia-smi", "-i", "1", "--query-gpu=name,power.limit", "--format=csv,noheader"]]
    assert _timing.device_label("cpu") == "cpu" and len(calls) == 1
