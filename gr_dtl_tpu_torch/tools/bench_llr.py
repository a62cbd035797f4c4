"""Checks and times K9, the coded demap's LLR kernel (csrc/soft_demap.cu), on
one NVIDIA GPU, against the plain chain it replaces
(``models/receiver.py::_frame_llrs_torch``), at the shapes the coded
receive step hands it: B = 32,768 frames of S = 960 payload symbols (the
``fec.qpsk-11db-b32k`` cell's step), all QPSK and mixed ids 1..4, and B =
2048 mixed.  Symbols are constellation points with complex Gaussian noise
and noise variances 0.01 to 0.1, drawn on the card from a seed.

For each shape:

* K9 against the plain chain on the same CUDA tensors: the rows that are
  not bit-equal (``torch.equal`` a row; must be 0);
* K9's mean device duration in a ``torch.profiler`` window while the calls
  walk a ring of input sets (over ``RING_BYTES`` of symbols and outputs
  together, so that neither is served from the 50 MB L2), warmed up by
  time (``_timing.profiled_windows``), and its time by CUDA events over the
  same back-to-back calls (which also hold the host's enqueue: a check, an
  allocation and a ctypes launch);
* the plain chain's time by events, in turns plain, kernel, kernel, plain;
* the bytes (``llr_cuda.llr_bytes``: ``8 B S + 12 B`` read, ``4 B
  max_frame_bits`` written), their least time at 3.35 TB/s, and K9's share
  of it.

``--variants`` builds the source with the other block sizes and register
caps of ``VARIANTS`` written in and times each against the source's, in
turns (the source, each variant, each again in the reverse order, the
source), every variant held bit-equal to the source's kernel first.

Run on the card:  python3 -m gr_dtl_tpu_torch.tools.bench_llr [--variants] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import torch

from gr_dtl_tpu_torch.models import receiver
from gr_dtl_tpu_torch.ops import _cuda_build, llr_cuda
from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.tools import _timing
from gr_dtl_tpu_torch.tools._timing import event_ms, kernel_device_ms, smi

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, at the 700 W limit
KERNEL_NAME = "soft_demap_kernel"
S_CELL = 960  # the dtl-fec configuration's payload symbols a frame
SHAPES = {"b32k/qpsk": (32_768, "qpsk"), "b32k/mixed": (32_768, "mixed"), "b2048/mixed": (2048, "mixed")}
RING_BYTES = 300e6
THREADS = "constexpr int kThreads = 256;"
BLOCKS = "constexpr int kMinBlocks = 6;"
VARIANTS = {  # name: the source's text and what the variant writes in its place
    "256 threads, registers uncapped": ((BLOCKS, "constexpr int kMinBlocks = 1;"),),
    "256 threads, 5 blocks an SM": ((BLOCKS, "constexpr int kMinBlocks = 5;"),),
    "256 threads, 8 blocks an SM": ((BLOCKS, "constexpr int kMinBlocks = 8;"),),
    "128 threads, 16 blocks an SM": ((THREADS, "constexpr int kThreads = 128;"),
                                     (BLOCKS, "constexpr int kMinBlocks = 16;")),
    "512 threads, 3 blocks an SM": ((THREADS, "constexpr int kThreads = 512;"),
                                    (BLOCKS, "constexpr int kMinBlocks = 3;")),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"bench_llr FAILED: {what}")


def floor_ms(B: int, S: int = S_CELL, max_frame_bits: int | None = None) -> float:
    """The least time a call could take: its bytes at the card's memory rate
    (rows of ``4 S`` unless ``max_frame_bits`` says otherwise)."""
    return llr_cuda.llr_bytes(B, S, 4 * S if max_frame_bits is None else max_frame_bits) / HBM_BYTES_PER_S * 1e3


def ids(B: int, mix: str, dev) -> torch.Tensor:
    """[B] int32: all QPSK, or 1..4 in turn."""
    if mix == "qpsk":
        return torch.full((B,), int(cn.ConstellationType.QPSK), dtype=torch.int32, device=dev)
    return (torch.arange(B, device=dev, dtype=torch.int32) % 4) + 1


def inputs(B: int, mix: str, seed: int, dev, S: int = S_CELL):
    """(soft [B, S] complex64, cnst [B] int32, noise_var [B] float32): each
    frame's constellation points with noise of its variance."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cnst = ids(B, mix, dev)
    tab = cn.active(dev)
    labels = torch.randint(0, 16, (B, S), generator=gen, device=dev) % (1 << tab.bps[cnst.long()])[:, None]
    points = tab.points[cnst.long()[:, None], labels]
    nv = 0.01 + 0.09 * torch.rand(B, generator=gen, device=dev)
    noise = torch.randn((B, S), generator=gen, device=dev, dtype=torch.complex64) * nv.sqrt()[:, None]
    return (points + noise).to(torch.complex64), cnst, nv.float()


def plain_params(dev, S: int = S_CELL):
    """What ``_frame_llrs_torch`` reads of a receiver's params: the tables and
    the row's length."""
    return SimpleNamespace(tab=cn.active(dev), fec=SimpleNamespace(max_frame_bits=4 * S))


def kernel_call(soft, cnst, nv, rxp=None):
    """K9 on one set, with the tables and row length of ``rxp`` (None: the
    installed tables, rows of ``4 S``)."""
    rxp = rxp or plain_params(soft.device, soft.shape[1])
    return llr_cuda.frame_llrs_cuda(soft, cnst, nv, rxp.tab.bps, rxp.fec.max_frame_bits)


def ring_of(B: int, mix: str, dev) -> list:
    per = llr_cuda.llr_bytes(B, S_CELL, 4 * S_CELL)
    return [inputs(B, mix, 1000 * B + s, dev) for s in range(max(2, -(-int(RING_BYTES) // per)))]


def rows_not_bit_equal(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((~(got == want).all(dim=1)).sum())


def measure(name: str, B: int, mix: str, dev) -> dict:
    """K9 against the plain chain at one of ``SHAPES``, on a ring of drawn inputs."""
    return timed(name, ring_of(B, mix, dev), plain_params(dev), mix)


def timed(name: str, ring: list, rxp, mix: str = "") -> dict:
    """K9 against ``_frame_llrs_torch(rxp, ...)`` on a ring of (soft, cnst
    int32, noise_var) sets on the card: rows not bit-equal on the first set
    (must be 0), K9's device time over the ring, and both by events in
    turns (plain, kernel, kernel, plain)."""
    B, S = ring[0][0].shape
    bits = rxp.fec.max_frame_bits
    want = receiver._frame_llrs_torch(rxp, *ring[0])
    got = kernel_call(*ring[0], rxp)
    torch.cuda.synchronize()
    bad = rows_not_bit_equal(got, want)
    check(bad == 0, f"{name}: {bad} of {B} rows differ from the plain chain")
    del got, want
    kern = lambda i: kernel_call(*ring[i % len(ring)], rxp)
    plain = lambda i: receiver._frame_llrs_torch(rxp, *ring[i % len(ring)])
    reps = max(20, 4 * len(ring))
    k_ev, p_ev = [], []
    for turn in ("plain", "kernel", "kernel", "plain"):
        if turn == "plain":
            p_ev.append(event_ms(plain, 4))
        else:
            k_ev.append(event_ms(kern, reps))
    dev_ms = kernel_device_ms(kern, reps, KERNEL_NAME)
    check(dev_ms is not None, f"the profiler saw no {KERNEL_NAME}")
    nbytes, f_ms = llr_cuda.llr_bytes(B, S, bits), floor_ms(B, S, bits)
    out = {"shape": name, "B": B, "S": S, "ids": mix, "ring_slots": len(ring), "bytes": nbytes,
           "floor_ms": f_ms, "rows_not_bit_equal": bad, "kernel_device_ms": dev_ms, "kernel_events_ms": k_ev,
           "plain_events_ms": p_ev, "share_of_floor": f_ms / dev_ms,
           "clocks_after": smi("name,power.limit,clocks.sm,power.draw,temperature.gpu")}
    print(f"[llr] {name}: K9 device {dev_ms * 1e3:.2f} us ({100 * f_ms / dev_ms:.1f}% of the "
          f"{f_ms * 1e3:.2f} us floor), events {[round(x * 1e3, 2) for x in k_ev]} us; plain chain "
          f"{[round(x, 3) for x in p_ev]} ms; bit-equal rows {B - bad} of {B}", flush=True)
    return out


def variant_library(name: str):
    """The kernel library of the source with ``VARIANTS[name]`` written in
    (built into ``_build/`` beside the others), bound for the wrapper."""
    return _timing.variant_library(llr_cuda, VARIANTS[name], "soft_demap_variant")


def variants(dev) -> dict:
    """Device ms of each variant at each shape, in turns: {shape: {name: [ms, ms]}}."""
    _cuda_build.build_all(llr_cuda.build, *(lambda n=n: variant_library(n) for n in VARIANTS))
    libs = {"as built": llr_cuda.build(), **{n: variant_library(n) for n in VARIANTS}}
    out = {}
    for name, (B, mix) in SHAPES.items():
        ring = ring_of(B, mix, dev)
        want = kernel_call(*ring[0])
        out[name] = {t: [] for t in libs}
        for t in list(libs) + list(libs)[::-1]:
            with _timing.launching(llr_cuda, libs[t]):
                got = kernel_call(*ring[0])
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"{t} at {name}: not bit-equal to the source's kernel")
                ms = kernel_device_ms(lambda i: kernel_call(*ring[i % len(ring)]), max(20, 4 * len(ring)), KERNEL_NAME)
            check(ms is not None, f"the profiler saw no {KERNEL_NAME}")
            out[name][t].append(ms)
        print(f"[variants] {name}: " + "; ".join(f"{t} {[round(x * 1e3, 2) for x in v]} us"
                                                for t, v in out[name].items()), flush=True)
        del ring, want
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gr_dtl_tpu_torch.tools.bench_llr")
    p.add_argument("--variants", action="store_true", help="time other block sizes against the source's")
    p.add_argument("--out", default=None, help="write the result as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_llr: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    llr_cuda.build()
    print("[build] " + " | ".join(ln.strip() for ln in llr_cuda.library_path().with_suffix(".log").read_text()
                                  .splitlines() if ln.strip()), flush=True)
    res = {"device": card}
    if args.variants:
        res["variants"] = variants(dev)
    else:
        res["results"] = [measure(name, B, mix, dev) for name, (B, mix) in SHAPES.items()]
    print(json.dumps(res))
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
