"""Build-and-load of the package's CUDA sources: ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``.

A library is built at first use into ``_build/`` beside the package,
named by a hash of its source and flags, with the compiler's report
(``-Xptxas=-v``: registers, shared memory, spills) kept beside it as
``.log``.  Importing this module needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (not on PATH, nor under $CUDA_HOME/bin): "
                       "the CUDA toolkit is needed to build the sources under csrc/")


def library_path(source: Path, flags=NVCC_FLAGS) -> Path:
    """Where the build of ``source`` as it reads now, with ``flags``, lives."""
    text = source.read_bytes() + " ".join(flags).encode()
    return BUILD_DIR / f"lib{source.stem}_{hashlib.sha256(text).hexdigest()[:16]}.so"


def load(source: Path, flags=NVCC_FLAGS) -> ctypes.CDLL:
    """Compile ``source`` (once per hash of source and flags) and load it."""
    out = library_path(source, flags)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source.name}:\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def build_all(*build_fns) -> None:
    """Run the given ``build`` functions at once, one thread each: every
    source gets its own ``nvcc`` process and they compile side by side."""
    with ThreadPoolExecutor(max_workers=max(1, len(build_fns))) as pool:
        for fut in [pool.submit(fn) for fn in build_fns]:
            fut.result()
