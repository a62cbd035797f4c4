"""The port runs on a machine without JAX: every ``gr_dtl_tpu_torch`` module
and ``chip_smoke`` import with ``jax`` and ``gr_dtl_tpu`` blocked, and the
kernel module imports without ``nvcc`` on the PATH; an LDPC bench, the
stream bench and the receiver's bench run that way on the CPU.  The sharded receivers'
worker processes start from the port alone: their module, imported in a
fresh interpreter, brings in neither, and a spawned grid runs with both
blocked in its parent."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "gr_dtl_tpu", "triton"):
    sys.modules[blocked] = None  # any import of these now raises
import gr_dtl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gr_dtl_tpu_torch.__path__, "gr_dtl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import torch
from gr_dtl_tpu_torch.ops import equalizer_cuda, ldpc_cuda, scans_cuda, sync_cuda, tb_cuda
assert sync_cuda.timing_metric_cuda.LAUNCHES == 0 and tb_cuda.tb_reassemble_cuda.LAUNCHES == 0
assert scans_cuda.trigger_lock_scan_cuda.LAUNCHES == 0 and scans_cuda.frame_accounting_cuda.LAUNCHES == 0
from gr_dtl_tpu_torch.models import fec_chain, session
zeros = __import__("numpy").zeros
rx = session.StreamRx(chip_smoke.cfgmod.make_rx_config(None, frame_length=4), "cpu", frames_per_block=2)
rx.process(zeros(rx.block_samples, "complex64"))  # a block on the CPU needs no kernel
# nor does a coded block with two frames a transport block (the TB ring's plain loop)
cfg = chip_smoke.cfgmod.make_rx_config(str(chip_smoke.FEC_CONFIG), frame_length=10)
H = chip_smoke.alist.load_alist(str(chip_smoke.ROOT / "examples" / chip_smoke.BANK_ALISTS[0]))
rx = session.StreamRx(cfg, "cpu", frames_per_block=2, fec=fec_chain.build_fec(cfg, H, "cpu", tb_frames=2))
assert len(rx.process(zeros(rx.block_samples, "complex64"))) == 3
assert tb_cuda.tb_reassemble_cuda.LAUNCHES == 0 and sync_cuda.timing_metric_cuda.LAUNCHES == 0
assert equalizer_cuda.equalize_frame_cuda.LAUNCHES == 0  # nor does the equalizer
assert ldpc_cuda.bp_decode_cuda.LAUNCHES == 0  # nor BP (its plain version, _bp)
assert ldpc_cuda.bp_gather_cuda.LAUNCHES == 0  # nor the gather form's (K8)
# the telemetry (capture mode needs no pyzmq) and the wire-compat tables
from gr_dtl_tpu_torch.testbed import monitor
from gr_dtl_tpu_torch.utils import wire_compat
probe = monitor.MonitorProbe(address=None)
rx = session.StreamRx(chip_smoke.cfgmod.make_rx_config(None, frame_length=4), "cpu", frames_per_block=2,
                      probe=probe)
rx.process(zeros(rx.block_samples, "complex64"))
assert probe.captured == [] and "zmq" not in sys.modules
wire_compat.activate(wire_compat.dump_native())
rx = session.StreamRx(chip_smoke.cfgmod.make_rx_config(None, frame_length=4), "cpu", frames_per_block=2)
wire_compat.deactivate()
assert rx.rxp.tab.table_mode and equalizer_cuda.equalize_frame_cuda.LAUNCHES == 0
assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
# the sharded session on a one-rank grid, without a process group
from gr_dtl_tpu_torch.parallel import mesh as meshmod, session as psession
srx = psession.ShardedStreamRx(chip_smoke.cfgmod.make_rx_config(None, frame_length=4),
                               meshmod.make_mesh(device="cpu"), n_streams=2, frames_per_block=2,
                               device="cpu")
srx.process(zeros((2, srx.block_samples), "complex64"))
assert scans_cuda.trigger_lock_scan_cuda.LAUNCHES == 0 and sync_cuda.timing_metric_cuda.LAUNCHES == 0
# the app layer: a tool's main runs its mode on the CPU with both blocked
import contextlib, io
from gr_dtl_tpu_torch.tools import run_modem
with contextlib.redirect_stdout(io.StringIO()) as out:
    run_modem.main(["loopback", "--frames", "2", "--frame-length", "4", "--json", "--cpu"])
assert '"crc_ok_rate": 1.0' in out.getvalue(), out.getvalue()
# the MCS decision over a block on the CPU takes its plain loop (no K7 launch)
from gr_dtl_tpu_torch.models import adaptive
from gr_dtl_tpu_torch.ops import feedback_cuda
cfg = chip_smoke.cfgmod.make_rx_config(None, frame_length=4)
_, mcs = adaptive.feedback_scan(adaptive.initial_state(0, (2,), "cpu"), torch.full((8, 2), 30.0),
                                adaptive.build_mcs_tables(cfg))
assert mcs.shape == (8, 2) and feedback_cuda.feedback_scan_masked_cuda.LAUNCHES == 0
# the measuring tools: an LDPC bench and the stream bench at a tiny size
from gr_dtl_tpu_torch.tools import bench_stream, bench_twopass
with contextlib.redirect_stdout(io.StringIO()):
    res = bench_twopass.main(["--cw", "16", "--reps", "1", "--iters", "1", "--cpu"])
    st = bench_stream.main(["--sizes", "2", "--blocks", "1", "--reps", "1", "--frame-length", "4",
                            "--duplex-steps", "0", "--cpu"])
assert res["regimes"]["clean"]["twopass"]["ok_rate"] == 1.0
assert all(r["crc_ok"] == r["valid_frames"] > 0 for r in st["stream_rx"])
# the bench, a step of four frames
from gr_dtl_tpu_torch import bench
with contextlib.redirect_stdout(io.StringIO()):
    b = bench.main(["4", "--device", "cpu", "--reps", "1", "--iters", "1"])
assert b["extra"]["crc_ok_rate"] == 1.0 and b["vs_baseline"] is None and b["extra"]["device"] == "cpu"
print("imported", len(names), "modules:", *names)
"""


def test_port_imports_without_jax_or_nvcc():
    env = dict(os.environ, PATH=os.path.dirname(sys.executable), CUDA_HOME="/nonexistent",
               PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[1])
    assert n >= 67, proc.stdout  # every module of slices A-I, the testbed, wire compat
    for name in ("utils.alist", "ops.ldpc", "models.fec_chain", "ops.constellation",
                 "models.receiver", "models.transmitter", "ops.sync_cuda", "ops._cuda_build",
                 "ops.scans_cuda", "ops.metrics", "models.adaptive", "models.streaming",
                 "models.session", "ops.channel", "ops.burst", "ops.tb_cuda", "models.simplex",
                 "models.full_duplex", "ops.equalizer", "ops.equalizer_cuda", "testbed.monitor",
                 "testbed.collect", "testbed.frame_store", "testbed.proto.monitor_pb2",
                 "utils.wire_compat", "utils.logging", "parallel.mesh", "parallel.dist",
                 "parallel._coll", "parallel.stream", "parallel.session", "parallel.launch",
                 "entry", "testbed.sample_io", "testbed.phy_converge", "tools._cli",
                 "tools.run_modem", "tools.replay", "tools.ber", "tools.ber_curve",
                 "tools.tun_bridge", "tools.stats", "tools.monitor_collector",
                 "ops.feedback_cuda", "tools.sample_link", "tools.soak_link", "tools.multihost",
                 "tools._timing", "tools._ldpc_bench", "tools.bench_fec", "tools.bench_twopass",
                 "tools.bench_bf16_ab", "tools.bench_bank_switch", "tools.profile_rx",
                 "tools.bench_stream", "bench", "utils.trace"):
        assert f"gr_dtl_tpu_torch.{name}" in proc.stdout.split(), name


_WORKER_PROBE = r"""
import sys
from gr_dtl_tpu_torch.parallel import launch
from gr_dtl_tpu_torch import entry
assert launch._worker.__module__ == "gr_dtl_tpu_torch.parallel.launch"
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gr_dtl_tpu"))
assert not bad, bad
if len(sys.argv) > 1:  # a spawned 2-rank grid, with JAX blocked here
    for blocked in ("jax", "jaxlib", "gr_dtl_tpu"):
        sys.modules[blocked] = None
    entry.dryrun_multichip(2, "cpu")
print("clean")
"""


def test_worker_processes_import_neither_jax_nor_the_reference():
    """What a spawned worker imports (its module, in a fresh interpreter)
    holds neither JAX nor the JAX package, and a 2-rank gloo grid started
    from a parent that cannot import them runs the dry run."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for args in ([], ["spawn"]):
        proc = subprocess.run([sys.executable, "-c", _WORKER_PROBE, *args], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert proc.stdout.split()[-1] == "clean"


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """Alone in a directory, or without CUDA, chip_smoke.py exits non-zero
    and prints no result line."""
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((tmp_path, lone), (ROOT, ROOT / "chip_smoke.py")):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


# a sitecustomize that makes every import of JAX or the JAX package fail, in
# a process and in every process it starts (they inherit PYTHONPATH)
_BLOCKER = """import sys
for blocked in ("jax", "jaxlib", "gr_dtl_tpu"):
    sys.modules[blocked] = None
"""


def test_link_tools_run_as_processes_without_jax(tmp_path):
    """The three live-I/O tools run their test modes as ``python -m``
    processes, which start node, daemon and rank processes of their own,
    with every import of ``jax`` or ``gr_dtl_tpu`` failing in all of them."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCKER)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), str(ROOT)]))
    env.pop("JAX_COORDINATOR", None)
    runs = {
        "sample_link": ["--loopback-test", "--pdus", "4", "--frames-per-block", "2",
                        "--frame-length", "4", "--cpu"],
        "soak_link": ["--cpu", "--samples", "1e5", "--frames-per-block", "8", "--stats-every", "2",
                      "--jsonl", str(tmp_path / "s.jsonl"), "--out", str(tmp_path / "s.json")],
        "multihost": ["--session", "--procs", "1", "--devices-per-proc", "2", "--streams", "2",
                      "--frames-per-block", "4", "--n-time", "2", "--frame-length", "4", "--cpu"],
    }
    procs = {name: subprocess.Popen([sys.executable, "-m", f"gr_dtl_tpu_torch.tools.{name}", *argv],
                                    cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, argv in runs.items()}
    outs = {name: p.communicate(timeout=300)[0] for name, p in procs.items()}
    for name, p in procs.items():  # the short soak misses only the tool's 1e8-sample bar
        assert p.returncode == (1 if name == "soak_link" else 0), f"{name}:\n{outs[name][-4000:]}"
    assert '"crc_clean": true' in outs["sample_link"]
    soak = json.loads((tmp_path / "s.json").read_text())
    assert soak["pass"] is False and 1e5 <= soak["samples"] < 1e8
    assert soak["crc_rate_of_decoded"] >= 0.98 and soak["lost_frame_rate"] <= 0.02
    assert '"byte_exact_all": true' in outs["multihost"]
