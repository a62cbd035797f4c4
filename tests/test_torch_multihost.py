"""The port's ``multihost`` tool (gr_dtl_tpu_torch/tools/multihost.py)
beside the JAX package's (tools/multihost.py), on the CPU over gloo.

``--launch --procs 2 --devices-per-proc 2`` and ``--session`` at the
settings of tests/test_dist.py's slow session test (4 streams, 8 frames a
block, a time axis of 2, frame_length 10) with two "hosts" of two ranks.
The JAX tool runs 2 processes of 2 virtual devices each, the port 4 ranks
(a torch rank is a process) as 2 hosts of 2; the global grid must have the
same shape and a step the same frames and samples.  Every frame must decode
in the port's run (``crc_ok_all``, ``byte_exact_all``, 3 chained blocks,
nothing lost).  Both tools run side by side in one module fixture.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
GRID = ["--procs", "2", "--devices-per-proc", "2"]
SESSION = ["--session", *GRID, "--streams", "4", "--frames-per-block", "8", "--n-time", "2",
           "--frame-length", "10"]


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_COORDINATOR", None)
    cmds = {}
    for name, flags in (("launch", ["--launch", *GRID]), ("session", SESSION)):
        cmds[("jax", name)] = [sys.executable, str(ROOT / "tools" / "multihost.py"), *flags]
        cmds[("port", name)] = [sys.executable, "-m", "gr_dtl_tpu_torch.tools.multihost", *flags,
                                "--cpu"]
    out = {}
    for name in ("launch", "session"):  # each tool's two modes, the packages side by side
        procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                 for k, c in cmds.items() if k[1] == name}
        try:
            for k, p in procs.items():
                stdout, stderr = p.communicate(timeout=600)
                assert p.returncode == 0, f"{k}: exit {p.returncode}\n{stdout[-2000:]}\n{stderr[-4000:]}"
                out[k] = json.loads(stdout)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


def test_launch_decodes_every_frame_on_the_reference_grid(runs):
    got, want = runs[("port", "launch")], runs[("jax", "launch")]
    assert got["n_processes"] == want["n_processes"] == 2
    assert got["crc_ok_all"] is True and len(got["workers"]) == 4
    assert {w["rank"] for w in got["workers"]} == {0, 1, 2, 3}
    assert [w["process_id"] for w in got["workers"]] == [0, 0, 1, 1]
    for w in got["workers"]:
        assert w["global_devices"] == 4 and w["local_devices"] == 2 and w["device"] == "cpu"
        assert w["mesh"] == want["workers"][0]["mesh"] == {"stream": 2, "time": 2}
        assert w["frames_per_step"] == want["workers"][0]["frames_per_step"]
        assert w["samples_per_step"] == want["workers"][0]["samples_per_step"]
        assert w["sec_per_step"] > 0 and w["cpu_sec_per_step"] > 0
    assert got["workload"] == want["workload"]
    for key in ("single_process_baseline", "half_workload_baseline"):
        assert got[key]["frames_per_step"] == want[key]["frames_per_step"]
        assert got[key]["devices"] == want[key]["devices"]
    assert got["efficiency_vs_single_process"] > 0 and got["efficiency_weak_scaling"] > 0


def test_session_is_byte_exact_on_the_reference_grid(runs):
    got, want = runs[("port", "session")], runs[("jax", "session")]
    assert got["n_processes"] == want["n_processes"] == 2
    assert got["byte_exact_all"] is True and len(got["workers"]) == 4
    for w in got["workers"]:
        assert w["chained_blocks"] == 3 and w["lost_frames"] == 0 and w["byte_exact"] is True
        assert w["mesh"] == want["workers"][0]["mesh"] == {"stream": 2, "time": 2}
        assert w["streams"] == 4
        assert w["frames_decoded"] == want["workers"][0]["frames_decoded"] == 4 * 2 * 8


@pytest.mark.parametrize("fn", ["launch", "launch_session"])
def test_launchers_run_on_the_card_unless_asked_for_the_cpu(fn):
    """The tool's public launchers, called without a device, take the card,
    as every other entry point of the port does; the CPU is asked for."""
    import inspect

    from gr_dtl_tpu_torch.tools import multihost

    assert inspect.signature(getattr(multihost, fn)).parameters["device"].default == "cuda"
    args = multihost.build_parser().parse_args(["--launch"])
    assert args.device == "cuda" and not args.cpu
