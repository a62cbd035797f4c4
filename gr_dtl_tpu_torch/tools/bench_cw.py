"""Checks and times K10, the codeword extraction kernel (csrc/codewords.cu),
on one NVIDIA GPU, against the plain chain it replaces
(``models/fec_chain.py::_extract_torch``), at the shapes the coded cells
hand it: G = 32,768 groups of W = 2 frames on the stream cell's ladder (16
links in 16 runs of groups, 3 BPSK, 5 QPSK, 5 8PSK, 3 16QAM: the block of
``fecstream.ladder-s16-f2048``), G = 32,768 single QPSK frames (the batch
step of ``fec.qpsk-11db-b32k``), and G = 2048 groups of 2 with ids 1..4 in
turn.  The code is the dtl-fec configuration's (n = 300, k = 152), frames of
960 symbols; the LLR rows are Gaussian draws on the card from a seed.

For each shape:

* K10 against the plain chain on the same CUDA tensors: the groups whose
  slots are not bit-equal (their float32 bits compared; must be 0);
* K10's mean device duration in a ``torch.profiler`` window while the calls
  walk a ring of input sets (over ``RING_BYTES`` together, so that no set is
  served from the 50 MB L2), warmed up by time
  (``_timing.profiled_windows``), and its time by CUDA events over the same
  back-to-back calls (which also hold the host's enqueue);
* the plain chain's time by events, in turns plain, kernel, kernel, plain;
  and ``_codewords`` whole (the schedule and the extraction: what the span
  ``fec.decode.codewords`` covers) with K10 and with the plain chain;
* the bytes (``cw_cuda.cw_bytes``: the sent LLRs and the schedule read, the
  slots written), their least time at 3.35 TB/s, and K10's share of it.

``--variants`` builds the source with the other block sizes and register
caps of ``VARIANTS`` written in and times each against the
source's, in turns (the source, each variant, each again in the reverse
order, the source), every variant held bit-equal to the source's kernel
first.

Run on the card:  python3 -m gr_dtl_tpu_torch.tools.bench_cw [--variants] [--out FILE]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

import torch

from gr_dtl_tpu_torch.models import fec_chain
from gr_dtl_tpu_torch.ops import _cuda_build, cw_cuda
from gr_dtl_tpu_torch.tools import _timing
from gr_dtl_tpu_torch.tools._timing import event_ms, kernel_device_ms, smi
from gr_dtl_tpu_torch.utils import alist, config as cfgmod

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, at the 700 W limit
KERNEL_NAME = "codewords_kernel"
ROOT = Path(__file__).resolve().parents[2]
FEC_CONFIG = ROOT / "examples" / "config_fec.json"
ALIST = ROOT / "examples" / "n_0300_k_0152.alist"
LADDER = (1,) * 3 + (2,) * 5 + (3,) * 5 + (4,) * 3  # the stream cell's 16 links' constellations
SHAPES = {"stream/ladder": (32_768, 2, "ladder"), "batch/qpsk": (32_768, 1, "qpsk"),
          "g2048/mixed": (2048, 2, "mixed")}
RING_BYTES = 300e6
THREADS = "constexpr int kThreads = 128;"
BLOCKS = "constexpr int kMinBlocks = 12;"
VARIANTS = {  # name: the source's text and what the variant writes in its place
    "128 threads, registers uncapped": ((BLOCKS, "constexpr int kMinBlocks = 1;"),),
    "128 threads, 16 blocks an SM": ((BLOCKS, "constexpr int kMinBlocks = 16;"),),
    "64 threads, 24 blocks an SM": ((THREADS, "constexpr int kThreads = 64;"),
                                    (BLOCKS, "constexpr int kMinBlocks = 24;")),
    "256 threads, 6 blocks an SM": ((THREADS, "constexpr int kThreads = 256;"),
                                    (BLOCKS, "constexpr int kMinBlocks = 6;")),
    "256 threads, 7 blocks an SM": ((THREADS, "constexpr int kThreads = 256;"),
                                    (BLOCKS, "constexpr int kMinBlocks = 7;")),
    "512 threads, 3 blocks an SM": ((THREADS, "constexpr int kThreads = 512;"),
                                    (BLOCKS, "constexpr int kMinBlocks = 3;")),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"bench_cw FAILED: {what}")


@functools.lru_cache(maxsize=None)
def fec_params(W: int, dev: str, frame_length: int = 20) -> fec_chain.FecParams:
    """The dtl-fec configuration's FEC tables at W frames a TB on ``dev``."""
    cfg = cfgmod.make_rx_config(str(FEC_CONFIG), frame_length=frame_length)
    return fec_chain.build_fec(cfg, alist.load_alist(str(ALIST)), torch.device(dev), tb_frames=W)


def group_ids(G: int, mix: str, dev) -> torch.Tensor:
    """[G] int32 constellations: all QPSK; the ladder's 16 links in 16 runs of
    groups (a block's rows are stream-major); or 1..4 in turn."""
    g = torch.arange(G, device=dev)
    if mix == "qpsk":
        return torch.full((G,), 2, dtype=torch.int32, device=dev)
    if mix == "ladder":
        return torch.as_tensor(LADDER, dtype=torch.int32, device=dev)[(g * len(LADDER)) // G]
    return (g % 4 + 1).int()


def inputs(G: int, W: int, mix: str, seed: int, dev, frame_length: int = 20):
    """(llrs [G W, max_frame_bits] float32, cnst [G W] int32 a frame): Gaussian
    LLR rows drawn from ``seed``, each group's id on its W frames."""
    fec = fec_params(W, str(dev), frame_length)
    gen = torch.Generator(device=dev).manual_seed(seed)
    llrs = torch.randn((G * W, fec.max_frame_bits), generator=gen, device=dev)
    return llrs, group_ids(G, mix, dev).repeat_interleave(W)


def schedule(fec: fec_chain.FecParams, cnst: torch.Tensor):
    """(bps [G], schedule) of the groups whose frames carry ``cnst``."""
    bps = fec_chain._bps(cnst[:: fec.W])
    return bps, fec_chain._cw_schedule(fec, bps, None)


def llrs_read(fec: fec_chain.FecParams, s) -> int:
    """The LLRs the groups' sent slots read: each group's codewords' bits,
    check and systematic, end to end (ids 1..4: within its W frames)."""
    end = s.cw_start[:, -1] + torch.where(s.real[:, -1], s.k_prime[:, -1] + s.m, 0)
    return int(torch.clamp(end, max=fec.max_group_bits).sum())


def nbytes(fec: fec_chain.FecParams, s) -> int:
    G, Cmax = s.k_prime.shape
    return cw_cuda.cw_bytes(G, Cmax, fec.bank.Nmax, llrs_read(fec, s), int(fec.frame_bits_t.numel()))


def kernel_call(fec, llrs, cnst):
    bps, s = schedule(fec, cnst)
    return fec_chain._extract(fec, llrs, bps, s)


def ring_of(G: int, W: int, mix: str, dev) -> list:
    fec = fec_params(W, str(dev))
    per = 4 * G * W * fec.max_frame_bits + 4 * G * fec.max_ncws * fec.bank.Nmax
    return [inputs(G, W, mix, 1000 * G + 10 * W + k, dev) for k in range(max(2, -(-int(RING_BYTES) // per)))]


def groups_not_bit_equal(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((~(got.view(torch.int32) == want.view(torch.int32)).flatten(1).all(dim=1)).sum())


def measure(name: str, G: int, W: int, mix: str, dev) -> dict:
    """K10 against the plain chain at one of ``SHAPES``, on a ring of drawn inputs."""
    return timed(name, ring_of(G, W, mix, dev), fec_params(W, str(dev)), mix)


def timed(name: str, ring: list, fec, mix: str = "") -> dict:
    """K10 against ``_extract_torch`` on a ring of (llrs, cnst) sets on the
    card: groups not bit-equal on the first set (must be 0), K10's device
    time over the ring, both by events in turns (plain, kernel, kernel,
    plain), and ``_codewords`` whole both ways."""
    llrs0, cnst0 = ring[0]
    bps, s = schedule(fec, cnst0)
    G = s.k_prime.shape[0]
    want = fec_chain._extract_torch(fec, llrs0, bps, s)
    got = fec_chain._extract(fec, llrs0, bps, s)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype, f"{name}: {tuple(got.shape)} against {tuple(want.shape)}")
    bad = groups_not_bit_equal(got, want)
    check(bad == 0, f"{name}: {bad} of {G} groups differ from the plain chain")
    del got, want
    scheds = [schedule(fec, c) for _, c in ring]
    kern = lambda i: fec_chain._extract(fec, ring[i % len(ring)][0], *scheds[i % len(ring)])
    plain = lambda i: fec_chain._extract_torch(fec, ring[i % len(ring)][0], *scheds[i % len(ring)])
    whole = lambda i: fec_chain._codewords(fec, *ring[i % len(ring)], None, None)

    def whole_plain(i):
        llrs, cnst = ring[i % len(ring)]
        return fec_chain._extract_torch(fec, llrs, *schedule(fec, cnst))

    reps = max(20, 4 * len(ring))
    k_ev, p_ev, w_ev, wp_ev = [], [], [], []
    for turn in ("plain", "kernel", "kernel", "plain"):
        if turn == "plain":
            p_ev.append(event_ms(plain, 3))
            wp_ev.append(event_ms(whole_plain, 3))
        else:
            k_ev.append(event_ms(kern, reps))
            w_ev.append(event_ms(whole, reps))
    dev_ms = kernel_device_ms(kern, reps, KERNEL_NAME)
    check(dev_ms is not None, f"the profiler saw no {KERNEL_NAME}")
    nb = nbytes(fec, s)
    f_ms = nb / HBM_BYTES_PER_S * 1e3
    out = {"shape": name, "G": G, "W": fec.W, "Cmax": fec.max_ncws, "Nmax": fec.bank.Nmax, "ids": mix,
           "ring_slots": len(ring), "bytes": nb, "llrs_read": llrs_read(fec, s), "floor_ms": f_ms,
           "groups_not_bit_equal": bad, "kernel_device_ms": dev_ms, "kernel_events_ms": k_ev,
           "plain_events_ms": p_ev, "codewords_events_ms": w_ev, "codewords_plain_events_ms": wp_ev,
           "share_of_floor": f_ms / dev_ms, "clocks_after": smi("name,power.limit,clocks.sm,power.draw,temperature.gpu")}
    print(f"[cw] {name}: K10 device {dev_ms * 1e3:.2f} us ({100 * f_ms / dev_ms:.1f}% of the {f_ms * 1e3:.2f} us "
          f"floor, {nb} B), events {[round(x * 1e3, 2) for x in k_ev]} us; plain chain "
          f"{[round(x, 3) for x in p_ev]} ms; _codewords {[round(x, 3) for x in w_ev]} ms with K10, "
          f"{[round(x, 3) for x in wp_ev]} plain; bit-equal groups {G - bad} of {G}", flush=True)
    return out


def variant_library(name: str):
    """The kernel library of the source with ``VARIANTS[name]`` written in
    (built into ``_build/`` beside the others), bound for the wrapper."""
    return _timing.variant_library(cw_cuda, VARIANTS[name], "codewords_variant")


def variants(dev) -> dict:
    """Device ms of each variant at each shape, in turns: {shape: {name: [ms, ms]}}."""
    _cuda_build.build_all(cw_cuda.build, *(lambda n=n: variant_library(n) for n in VARIANTS))
    libs = {"as built": cw_cuda.build(), **{n: variant_library(n) for n in VARIANTS}}
    out = {}
    for name, (G, W, mix) in SHAPES.items():
        ring = ring_of(G, W, mix, dev)
        fec = fec_params(W, str(dev))
        want = kernel_call(fec, *ring[0])
        out[name] = {t: [] for t in libs}
        for t in list(libs) + list(libs)[::-1]:
            with _timing.launching(cw_cuda, libs[t]):
                got = kernel_call(fec, *ring[0])
                torch.cuda.synchronize()
                check(groups_not_bit_equal(got, want) == 0, f"{t} at {name}: not bit-equal to the source's kernel")
                ms = kernel_device_ms(lambda i: kernel_call(fec, *ring[i % len(ring)]), max(20, 4 * len(ring)),
                                      KERNEL_NAME)
            check(ms is not None, f"the profiler saw no {KERNEL_NAME}")
            out[name][t].append(ms)
        print(f"[variants] {name}: " + "; ".join(f"{t} {[round(x * 1e3, 2) for x in v]} us"
                                                for t, v in out[name].items()), flush=True)
        del ring, want
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gr_dtl_tpu_torch.tools.bench_cw")
    p.add_argument("--variants", action="store_true", help="time other block shapes against the source's")
    p.add_argument("--out", default=None, help="write the result as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_cw: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    cw_cuda.build()
    print("[build] " + " | ".join(ln.strip() for ln in cw_cuda.library_path().with_suffix(".log").read_text()
                                  .splitlines() if ln.strip()), flush=True)
    res = {"device": card}
    if args.variants:
        res["variants"] = variants(dev)
    else:
        res["results"] = [measure(name, G, W, mix, dev) for name, (G, W, mix) in SHAPES.items()]
    print(json.dumps(res))
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
