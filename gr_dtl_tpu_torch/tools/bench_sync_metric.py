"""Times the CUDA Schmidl-Cox metric kernel on one NVIDIA GPU, so that the
number is the card's: device memory and not L2, the kernel and not Python.

For each shape (the uncoded step's 3,770,368-sample stream, the coded
step's 1,968,128, and a streaming block of eight streams [8, 262144]):

* kernel vs the plain PyTorch metric on the same stream (max |dP|, |dM|);
* the kernel's time with a cold L2: launches walk a ring of at least 4
  different streams with their own outputs, over 300 MB together against an
  L2 of 50 MB, >= 50 launches of ``sync_cuda._launch_into`` on preallocated
  outputs between two CUDA events; in turns plain, kernel, kernel, plain;
* the warm time (one stream over and over, inputs served from L2), named so;
* the kernel's mean device duration in a ``torch.profiler`` window over the
  same ring, as a cross-check that the events did not time the host (at
  ~0.015 ms a launch a busy host enqueues more slowly than the card runs):
  where the two differ by over 15% the profiler's is the kernel's time;
* bytes (8 N + 12 (N - 64) a row), the bound at 3.35 TB/s and the share of
  it, from the cold time only.

Run on the card:  python3 -m gr_dtl_tpu_torch.tools.bench_sync_metric
"""

from __future__ import annotations

import json
import sys

import torch

from gr_dtl_tpu_torch.ops import sync, sync_cuda
from gr_dtl_tpu_torch.tools._timing import smi

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, at the 700 W limit
P_ATOL, M_ATOL = 2e-4, 2e-3
SHAPES = {"uncoded_step": (3_770_368,), "coded_step": (1_968_128,), "stream_block": (8, 262_144)}
RING_BYTES = 300e6
KERNEL_NAME = "sc_metric_kernel"


def bound_ms(shape) -> float:
    """The least time the card could take: the metric's bytes at the
    published device-memory rate (2 flops a byte: memory bounds it)."""
    rows = 1 if len(shape) == 1 else shape[0]
    return sync_cuda.metric_bytes(shape[-1], rows) / HBM_BYTES_PER_S * 1e3


def make_ring(first: torch.Tensor, gen: torch.Generator):
    """[(r, P, M), ...]: ``first`` and random streams of its shape, each with
    its own outputs; together over RING_BYTES, and at least 4."""
    rows = 1 if first.ndim == 1 else first.shape[0]
    n = first.shape[-1]
    slots = max(4, -(-int(RING_BYTES) // sync_cuda.metric_bytes(n, rows)))
    out_shape = (*first.shape[:-1], n - sync_cuda.FFT_LEN)
    ring = []
    for i in range(slots):
        r = first if i == 0 else torch.randn(first.shape, generator=gen, device=first.device,
                                             dtype=torch.complex64)
        ring.append((r, torch.empty((*out_shape, 2), dtype=torch.float32, device=first.device),
                     torch.empty(out_shape, dtype=torch.float32, device=first.device)))
    return ring


def event_ms(launch, ring, reps: int) -> float:
    """Mean ms a launch over reps back-to-back launches walking the ring."""
    reps = -(-reps // len(ring)) * len(ring)
    for slot in ring:
        launch(*slot)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(reps):
        launch(*ring[i % len(ring)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiler_ms(ring, reps: int):
    """Mean device duration (ms) of the kernel in a profiler window of reps
    launches over the ring, or None if the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            sync_cuda._launch_into(*ring[i % len(ring)])
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if KERNEL_NAME in e.key and e.self_device_time_total > 0]
    count = sum(e.count for e in found)
    return sum(e.self_device_time_total for e in found) / count / 1e3 if count else None


def plain_launch(r, P, M):
    sync._timing_metric_torch(r)


def measure(name: str, first: torch.Tensor, gen: torch.Generator, reps: int = 52) -> dict:
    """Correctness and times of the kernel on streams of the shape of
    ``first``, which is the ring's first stream."""
    shape = tuple(first.shape)
    ring = make_ring(first, gen)
    _, P, M = ring[0]
    P.zero_(), M.zero_()
    sync_cuda._launch_into(*ring[0])
    P0, M0 = sync._timing_metric_torch(first)
    dp = (torch.view_as_complex(P) - P0).abs().max().item()
    dm = (M - M0).abs().max().item()
    if not (dp <= P_ATOL and dm <= M_ATOL):
        raise SystemExit(f"bench_sync_metric FAILED: kernel vs plain on {name}: dP={dp} dM={dm}")
    del P0, M0
    plain, cold, warm = [], [], []
    for turn in ("plain", "kernel", "kernel", "plain"):
        if turn == "plain":
            plain.append(event_ms(plain_launch, ring, len(ring)))
        else:
            cold.append(event_ms(sync_cuda._launch_into, ring, reps))
            warm.append(event_ms(sync_cuda._launch_into, ring[:1], reps))
    prof = profiler_ms(ring, 24)
    clocks = smi("name,power.limit,clocks.sm,power.draw,temperature.gpu")
    rows = 1 if len(shape) == 1 else shape[0]
    nbytes = sync_cuda.metric_bytes(shape[-1], rows)
    b_ms = bound_ms(shape)
    out = {"shape": name, "dims": list(shape), "bytes": nbytes, "bound_ms": b_ms,
           "ring_slots": len(ring), "launches_between_events": -(-reps // len(ring)) * len(ring),
           "plain_ms": min(plain), "cold_ms": min(cold), "warm_l2_ms": min(warm),
           "cold_runs": cold, "warm_runs": warm, "profiler_kernel_ms": prof,
           "max_abs_dP": dp, "max_abs_dM": dm, "clocks_after": clocks,
           "kernel_ms": min(cold), "kernel_ms_by": "events"}
    note = ""
    if prof is not None and abs(prof - out["cold_ms"]) > 0.15 * prof:
        # the host enqueued more slowly than the card ran: the events timed Python
        note = " (they differ by over 15%: the profiler's device duration is the kernel's time)"
        out["kernel_ms"], out["kernel_ms_by"] = prof, "profiler"
    out["GBps"] = nbytes / out["kernel_ms"] / 1e6
    out["share_of_bound"] = b_ms / out["kernel_ms"]
    print(f"[metric] {name} {list(shape)}: {nbytes / 1e6:.1f} MB, bound {b_ms:.4f} ms; kernel cold L2 "
          f"{out['cold_ms']:.4f} ms by events, profiler {'none' if prof is None else f'{prof:.4f} ms'}{note}; "
          f"by the {out['kernel_ms_by']} reading {out['GBps']:.0f} GB/s = {100 * out['share_of_bound']:.1f}% "
          f"of the bound; warm L2 (one stream, not the card's memory rate) {out['warm_l2_ms']:.4f} ms; "
          f"plain {min(plain):.4f} ms; max|dP| {dp:.3e} max|dM| {dm:.3e}; SM clock after: {clocks}")
    sys.stdout.flush()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_sync_metric: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    sync_cuda.build()
    print("[build] " + " | ".join(
        ln.strip() for ln in sync_cuda.library_path().with_suffix(".log").read_text().splitlines()
        if ln.strip()))
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    for name, shape in SHAPES.items():
        first = torch.randn(shape, generator=gen, device=dev, dtype=torch.complex64)
        results.append(measure(name, first, gen))
        del first
        torch.cuda.empty_cache()
    print(json.dumps({"device": card, "results": results}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
