"""No JAX anywhere in what a run imports, and nothing of the program in
the reference (top-level module names compared whole: the port's name
begins with the JAX package's)."""

from __future__ import annotations

import subprocess
import sys

from modem_bench.catalog import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gr_dtl_tpu"}


def _top_levels(code: str) -> set:
    show = "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", code + show], capture_output=True, text=True, check=True,
                         cwd=ROOT.parent, timeout=300)
    return set(out.stdout.split())


def test_a_run_imports_no_jax():
    mods = _top_levels("import modem_bench.run, modem_bench.control\n"
                       "from modem_bench.catalog import Catalog\n"
                       "Catalog().system('batch_rx').Program\n"
                       "import modem_bench.reference.modem\n"
                       "from gr_dtl_tpu_torch.models import receiver, fec_chain")
    assert "gr_dtl_tpu_torch" in mods and "modem_bench" in mods
    assert not mods & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    mods = _top_levels("import modem_bench.reference.modem, modem_bench.generator, modem_bench.compare\n"
                       "from modem_bench.catalog import Catalog\n"
                       "[Catalog().kind(k) for k in ('uniform_awgn', 'snr_calibrated')]")
    assert not mods & (FORBIDDEN | {"gr_dtl_tpu_torch"})
    for f in (ROOT / "reference").glob("*.py"):
        assert "gr_dtl_tpu" not in f.read_text(), f
