"""The port runs on a machine without JAX: every ``gr_dtl_tpu_torch`` module
and ``chip_smoke`` import with ``jax`` and ``gr_dtl_tpu`` blocked, and the
kernel module imports without ``nvcc`` on the PATH."""

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
from gr_dtl_tpu_torch.ops import equalizer_cuda, scans_cuda, sync_cuda, tb_cuda
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
assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
print("imported", len(names), "modules:", *names)
"""


def test_port_imports_without_jax_or_nvcc():
    env = dict(os.environ, PATH=os.path.dirname(sys.executable), CUDA_HOME="/nonexistent",
               PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[1])
    assert n >= 30, proc.stdout  # every module of slices A, B, C and D
    for name in ("utils.alist", "ops.ldpc", "models.fec_chain", "ops.constellation",
                 "models.receiver", "models.transmitter", "ops.sync_cuda", "ops._cuda_build",
                 "ops.scans_cuda", "ops.metrics", "models.adaptive", "models.streaming",
                 "models.session", "ops.channel", "ops.burst", "ops.tb_cuda", "models.simplex",
                 "models.full_duplex", "ops.equalizer", "ops.equalizer_cuda"):
        assert f"gr_dtl_tpu_torch.{name}" in proc.stdout.split(), name


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
