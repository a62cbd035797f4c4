"""Times K7, the MCS decision over a block's frames (csrc/feedback_scan.cu),
on one NVIDIA GPU: its two kernels in turns on the same inputs, beside the
floors of their chains and the card's bound.

The walk (``feedback_scan_kernel``) binds on its chain:
every frame's step depends on the last through the active id, so a column
costs a launch plus T dependent steps.  The map (``feedback_scan_map_kernel``)
walks every chunk of 32 frames from each canonical state through a table,
chains the chunks' exits in T / 32 lookups and walks each chunk again: a
launch plus about 2 x 32 + T / 32 dependent table steps a tile.  The floors
come from the parts of a step's chain, each timed alone by one thread with
``clock64`` and ``%globaltimer`` around 2^16 steps:

* ``chase``: dependent shared-memory loads (``i = tab[i]``), the latency of
  the load at the head of a step;
* ``selects``: the walk's ``step`` with its rung held fixed in registers, so
  the compares leave the chain: the dependent selects alone;
* ``chain``: the walk's ``step`` with its rung read from shared memory at the
  active id and its frames from registers: a walk step's whole chain;
* ``table``: the map's step, a packed state through the transition table of
  the default ladder, frame words in registers;
* ``launch``: an empty kernel's device duration (profiler).

:func:`walk_floor_ms` is the walk's design floor (a launch plus T chain steps),
:func:`map_floor_ms` the map's (a launch plus, a tile, 2 x 32 + its chunks
table steps), :func:`bound_ms` the card's: the larger of the bytes the call
must move over 3.35 TB/s and its operations over 67 TFLOP/s (the H100
SXM's HBM3 rate and its float32 peak outside the tensor cores).

For T = 1 .. 1024 and batch () and [64] on runs of SNRs across the ladder
(and, at T = 37, 256 and 1024, an SNR inside a hysteresis band, where ids 0
and 1 are both fixed, and a steady link well above the ladder), and at T =
256 and 1024 over 256 and 1024 columns: each kernel held to the plain loop
(``adaptive._feedback_scan_masked_torch``) on the same CUDA tensors (ids
and state equal), then their mean device durations in ``torch.profiler``
windows in turns (walk, map, map, walk), beside the floors, the bound and
the wrapper's choice (``feedback_cuda.design``).

Run on the card:  python3 -m gr_dtl_tpu_torch.tools.bench_feedback_scan [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys
from pathlib import Path

import numpy as np
import torch

from gr_dtl_tpu_torch.models import adaptive
from gr_dtl_tpu_torch.ops import _cuda_build, feedback_cuda
from gr_dtl_tpu_torch.tools import _timing
from gr_dtl_tpu_torch.tools._timing import smi
from gr_dtl_tpu_torch.utils import config

T_CASES = (1, 8, 16, 32, 33, 37, 64, 128, 256, 1024)
BATCHES = ((), (64,))
SETS = {"runs": T_CASES, "bistable": (37, 256, 1024), "steady": (37, 256, 1024)}  # input set: its T
WIDE = tuple((T, (B,)) for B in (256, 1024) for T in (256, 1024))  # many columns, runs
PROBE_STEPS = 1 << 16
REPS = 50
VARIANTS = ("walk", "map")  # the two kernels, each forced, timed in turns
KERNELS = {"walk": "feedback_scan_kernel", "map": "feedback_scan_map_kernel", "launch": "probe_empty"}
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, at the 700 W limit
INT_OPS_PER_S = 67e12      # its float32 rate outside the tensor cores: the H100 SXM's peak for these ops
OPS_PER_FRAME = 15         # integer compares and selects a frame of a column

# appended to csrc/feedback_scan.cu (same translation unit: its step, advance,
# rung_of, the map's table helpers and kChunk)
BENCH_CU = r"""
namespace {

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__global__ void probe_empty() {}

// out: cycles, ns, a sink that keeps the chain alive
__global__ void probe_chase(int n, int len, long long* out) {
    extern __shared__ int tab[];
    for (int i = 0; i < len; ++i) tab[i] = (i * 7 + 1) % len;
    __syncthreads();
    int i = 0;
    const long long c0 = clock64();
    const unsigned long long g0 = global_ns();
    for (int k = 0; k < n; ++k) i = tab[i];
    const long long c1 = clock64();
    const unsigned long long g1 = global_ns();
    out[0] = c1 - c0;
    out[1] = (long long)(g1 - g0);
    out[2] = i;
}

// kFixed: the rung of the carried-in id held in registers; otherwise read
// from shared memory at the active id, as the walk does
template <bool kFixed>
__global__ void probe_step(int n, const float* xs, const float* snr_th, int n_mcs, float hyst, int dth,
                           int last, int cand, int counter, long long* out) {
    extern __shared__ float2 rungs[];
    for (int i = 0; i < n_mcs; ++i) rungs[i] = rung_of(snr_th, n_mcs, hyst, i);
    __syncthreads();
    float x[kChunk];
    bool m[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
        x[k] = xs[k];
        m[k] = true;
    }
    State s{last, cand, counter};
    const float2 fixed = rungs[last];
    int sink = 0;
    const long long c0 = clock64();
    const unsigned long long g0 = global_ns();
    for (int t = 0; t < n; t += kChunk) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) sink ^= step(s, x[k], m[k], kFixed ? fixed : rungs[s.last], dth);
    }
    const long long c1 = clock64();
    const unsigned long long g1 = global_ns();
    out[0] = c1 - c0;
    out[1] = (long long)(g1 - g0);
    out[2] = sink + s.last + s.cand + s.counter;
}

// the map's step: a packed state through the table of the ladder, the
// frames' words in registers
__global__ void probe_table(int n, const float* xs, const float* snr_th, int n_mcs, float hyst, int dth,
                            long long* out) {
    extern __shared__ __align__(16) unsigned char sm[];
    const int thp = dth > 1 ? dth : 1, H = n_mcs * (2 * thp + 2);
    uint16_t* next = (uint16_t*)sm;
    float2* rg = (float2*)(sm + ((size_t)8 * H + 15) / 16 * 16);
    for (int i = 0; i < n_mcs; ++i) rg[i] = rung_of(snr_th, n_mcs, hyst, i);
    for (int e = 0; e < 4 * H; ++e) {  // next[code][s], as the map kernel builds it
        const int k = e / H;
        State r = decode(e - k * H, n_mcs, thp, -1);
        advance(r, k == 1, k == 2, k != 3, dth);
        next[e] = (uint16_t)pack(canonical(r, n_mcs, thp), n_mcs, thp);
    }
    __syncthreads();
    uint32_t w[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
        w[k] = 0;
        for (int l = 0; l < n_mcs; ++l) w[k] |= code_of(xs[k], rg[l]) << (2 * l);
    }
    uint4 w4[kChunk / 4];
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) w4[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    uint32_t v = pack(0, n_mcs, thp);
    const long long c0 = clock64();
    const unsigned long long g0 = global_ns();
    for (int t = 0; t < n; t += kChunk) v = walk_table<false>(v, w4, sm, 2 * H, nullptr);
    const long long c1 = clock64();
    const unsigned long long g1 = global_ns();
    out[0] = c1 - c0;
    out[1] = (long long)(g1 - g0);
    out[2] = v;
}

}  // namespace

// which: 0 chase, 1 selects (fixed rung), 2 chain (rung at the active id), 3 empty, 4 table
extern "C" int probe_launch(int which, int n, const void* xs, const void* snr_th, int n_mcs, float hyst,
                            int dth, int last, int cand, int counter, void* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = (size_t)n_mcs * sizeof(float2);
    if (which == 0)
        probe_chase<<<1, 1, 64 * sizeof(int), s>>>(n, 64, (long long*)out);
    else if (which == 1)
        probe_step<true><<<1, 1, smem, s>>>(n, (const float*)xs, (const float*)snr_th, n_mcs, hyst, dth,
                                            last, cand, counter, (long long*)out);
    else if (which == 2)
        probe_step<false><<<1, 1, smem, s>>>(n, (const float*)xs, (const float*)snr_th, n_mcs, hyst, dth,
                                             last, cand, counter, (long long*)out);
    else if (which == 4)
        probe_table<<<1, 1, 8 * kMaxStates + 16 + kMapRungs * sizeof(float2), s>>>(
            n, (const float*)xs, (const float*)snr_th, n_mcs, hyst, dth, (long long*)out);
    else
        probe_empty<<<1, 1, 0, s>>>();
    return (int)cudaGetLastError();
}
"""


# --timeline: the map kernel with %globaltimer marks at its phases (block 0,
# thread 0, each after its barrier), made from the source by the text
# substitutions below; --variants: the map kernel with one choice changed,
# each against the source's in turns
MARKS_HEAD = r"""
__device__ unsigned long long g_k7_marks[8];
__device__ __forceinline__ void k7_mark(int i) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        unsigned long long t;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        g_k7_marks[i] = t;
    }
}
extern "C" int k7_marks(void* out) { return (int)cudaMemcpyFromSymbol(out, g_k7_marks, sizeof(g_k7_marks)); }
"""
PHASES = {"marks": ("prologue", "stage", "map", "chain", "emit"),  # between marks 0..5 (the ids' write after)
          "prologue_marks": ("table", "thresholds", "carry", "barrier")}  # the prologue's parts


def _mark_before(anchor: str, i: int, indent: str = "        ") -> tuple:
    """A substitution that puts mark i on a line of its own before the anchor."""
    return anchor, f"{indent}k7_mark({i});\n{anchor}"


MARKED = (
    ("#include <stdint.h>\n", "#include <stdint.h>\n" + MARKS_HEAD),
    ("    const int f = threadIdx.x;  // the frame of a tile a thread stages and writes\n",
     "    const int f = threadIdx.x;  // the frame of a tile a thread stages and writes\n    k7_mark(0);\n"),
    ("the last tile's ids are out\n", "the last tile's ids are out\n        k7_mark(1);\n"),
    _mark_before("        // 2. the map: every", 2),
    _mark_before("        if (t0 + kTile < T) load(t0 + kTile);", 3),
    _mark_before("        // 4. emit: each chunk", 4),
    _mark_before("        if (f < len) mcs[", 5))
MARKED_PROLOGUE = (
    MARKED[0], MARKED[1],
    _mark_before("    if (f < n) rungs[f] = make_float2(", 1, "    "),
    _mark_before("    // the chain's carry (thread 0): canonical", 2, "    "),
    _mark_before("    for (int t0 = 0; t0 < T; t0 += kTile) {", 3, "    "),
    ("the last tile's ids are out\n", "the last tile's ids are out\n        if (t0 == 0) k7_mark(4);\n"))
SOURCE_VARIANTS = {
    # at most 32 registers a thread, so that two blocks of 1024 threads share an SM
    "two_blocks_an_sm": (("__global__ void __launch_bounds__(kMapThreads)\n",
                          "__global__ void __launch_bounds__(kMapThreads, 2)\n"),),
}
VARIANT_SETS = ((256, ()), (1024, ()), (1024, (64,)), (256, (1024,)), (1024, (1024,)))
TIMELINE_SETS = ((37, ()), (256, ()), (1024, ()), (1024, (64,)))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"bench_feedback_scan FAILED: {what}")


@functools.lru_cache(maxsize=None)
def build_bench() -> ctypes.CDLL:
    """K7's source with the probes appended, built into ``_build/`` (named
    by a hash of the whole text, as every build is)."""
    src = _cuda_build.BUILD_DIR / "feedback_scan_bench.cu"
    text = feedback_cuda.SOURCE.read_text() + BENCH_CU
    _cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not src.exists() or src.read_text() != text:
        src.write_text(text)
    lib = _cuda_build.load(src)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.probe_launch.argtypes = [i, i, p, p, i, f, i, i, i, i, p, p]
    lib.probe_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def build_source(name: str) -> ctypes.CDLL:
    """K7's source with ``MARKED`` (name "marks"), ``MARKED_PROLOGUE``
    ("prologue_marks") or a ``SOURCE_VARIANTS`` entry substituted, built
    into ``_build/``; each anchor must be found exactly once."""
    text = feedback_cuda.SOURCE.read_text()
    subs = {"marks": MARKED, "prologue_marks": MARKED_PROLOGUE}.get(name) or SOURCE_VARIANTS[name]
    for old, new in subs:
        check(text.count(old) == 1, f"{name}: the anchor {old.strip()!r} is not in the source once")
        text = text.replace(old, new)
    src = _cuda_build.BUILD_DIR / f"feedback_scan_{name}.cu"
    _cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not src.exists() or src.read_text() != text:
        src.write_text(text)
    lib = _cuda_build.load(src)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.feedback_scan_launch.argtypes = [p, p, ll, ll, p, i, ctypes.c_float, i, p, p, p, i, i, p, p, i, p]
    lib.feedback_scan_launch.restype = i
    if name in PHASES:
        lib.k7_marks.argtypes, lib.k7_marks.restype = [p], i
    return lib


def lib_launcher(lib, state, snr, mask, tables):
    """A call of the map kernel of another build of the source, as the
    wrapper launches it."""
    batch, T = tuple(state.last.shape), snr.shape[0]
    B = max(1, state.last.numel())
    mt, mb = (1, 0) if mask.ndim == 1 else (B, 1)

    def call():
        st = torch.empty((3, *batch), dtype=torch.int32, device=snr.device)
        ids = torch.empty(snr.shape, dtype=torch.int32, device=snr.device)
        rc = lib.feedback_scan_launch(snr.data_ptr(), mask.data_ptr(), mt, mb, tables["snr_th"].data_ptr(),
                                      tables["n_mcs"], tables["hysteresis"], tables["decision_th"],
                                      state.last.data_ptr(), state.cand.data_ptr(), state.counter.data_ptr(), T, B,
                                      ids.data_ptr(), st.data_ptr(), feedback_cuda.DESIGNS["map"],
                                      torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"CUDA error {rc}")
        return st, ids
    return call


def timeline(dev, card) -> list:
    """The map kernel's phases and its prologue's parts (us, median of 20
    calls; block 0's thread 0, %globaltimer)."""
    tables, rows = tables_on(dev), []
    for name, phases in PHASES.items():
        lib = build_source(name)
        for T, batch in TIMELINE_SETS:
            state, snr, mask = inputs(T, batch, tables, T + len(batch), dev)
            fn = lib_launcher(lib, state, snr, mask, tables)
            buf, spans = np.zeros(8, np.uint64), []
            for i in range(25):
                fn()
                torch.cuda.synchronize()
                check(lib.k7_marks(buf.ctypes.data) == 0, "reading the marks")
                if i >= 5:
                    spans.append(np.diff(buf[:len(phases) + 1].astype(np.int64)) / 1e3)
            med = np.median(np.array(spans), axis=0)
            rows.append({"marks": name, "T": T, "batch": list(batch), **{p: float(v) for p, v in zip(phases, med)}})
            print(f"[k7-timeline] {name} T={T} batch={list(batch)}: " + ", ".join(
                f"{p} {v:.2f}" for p, v in zip(phases, med)) + f" us (block 0, %globaltimer, median of 20) ({card})",
                flush=True)
    return rows


def variants(dev, card) -> list:
    """Each of ``SOURCE_VARIANTS`` against the source's map kernel in turns
    (source, variant, variant, source), both held to the plain loop."""
    tables, rows = tables_on(dev), []
    for name in SOURCE_VARIANTS:
        lib = build_source(name)
        for T, batch in VARIANT_SETS:
            state, snr, mask = inputs(T, batch, tables, T + len(batch), dev)
            want_state, want = adaptive._feedback_scan_masked_torch(state, snr, mask, tables)
            fns = {"map": launcher("map", state, snr, mask, tables),
                   name: lib_launcher(lib, state, snr, mask, tables)}
            turns = {k: [] for k in fns}
            for k in ("map", name, name, "map"):
                got_state, got = fns[k]()
                torch.cuda.synchronize()
                check(torch.equal(got, want) and all(torch.equal(got_state[i], w) for i, w in enumerate(want_state)),
                      f"{k} T={T} batch={batch}: not equal to the plain loop")
                turns[k].append(profiler_ms(fns[k], KERNELS["map"]))
            rows.append({"variant": name, "T": T, "batch": list(batch), **{f"{k}_ms": v for k, v in turns.items()}})
            print(f"[k7-variant] {name} T={T} batch={list(batch)}: " + "; ".join(
                f"{k} " + " / ".join(f"{v * 1e3:.2f}" for v in vs) for k, vs in turns.items())
                + f" us (profiler, in turns; each equal to the plain loop) ({card})", flush=True)
    return rows


def tables_on(dev) -> dict:
    return adaptive.tables_to(adaptive.build_mcs_tables(config.make_rx_config(None)), dev)


def inputs(T: int, batch: tuple, tables: dict, seed: int, dev, kind: str = "runs"):
    """A carried-in state and T frames a column.  "runs": runs of 1-9 equal
    SNRs across the ladder (long enough to cross decision_th), a random
    mask.  "bistable": 13.5 +- 0.4 dB, inside the band where ids 0 and 1
    both stay, carried ids 0 and 1 in turn, every frame.  "steady": 40 +-
    0.5 dB, well above the ladder, 2% of frames masked."""
    rng = np.random.RandomState(seed)
    B = int(np.prod(batch, dtype=int))
    n = tables["n_mcs"]
    if kind == "runs":
        snr = np.empty((T, B), np.float32)
        for b in range(B):
            col = []
            while len(col) < T:
                col += [np.float32(rng.uniform(5, 30))] * rng.randint(1, 10)
            snr[:, b] = col[:T]
        mask = rng.rand(T, *batch) > 0.2
        state = [rng.randint(0, hi, batch).astype(np.int32) for hi in (n, n, 5)]
    elif kind == "bistable":
        snr = (13.5 + rng.uniform(-0.4, 0.4, (T, B))).astype(np.float32)
        mask = np.ones((T, *batch), bool)
        last = (np.arange(B) % 2).astype(np.int32).reshape(batch)
        state = [last, last.copy(), np.zeros(batch, np.int32)]
    else:
        snr = (40 + rng.normal(0, 0.5, (T, B))).astype(np.float32)
        mask = rng.rand(T, *batch) > 0.02
        state = [rng.randint(0, hi, batch).astype(np.int32) for hi in (n, n, 5)]
    state = adaptive.FeedbackState(*(torch.as_tensor(a, device=dev) for a in state))
    return state, torch.as_tensor(snr.reshape((T,) + batch), device=dev), torch.as_tensor(mask, device=dev)


def launcher(name: str, state, snr, mask, tables):
    """A call of the walk or the map (forced) on these inputs: returns
    (state [3, *batch], mcs [T, *batch])."""
    return lambda: feedback_cuda.feedback_scan_masked_cuda(
        state.last, state.cand, state.counter, snr, mask, tables["snr_th"], tables["n_mcs"],
        tables["hysteresis"], tables["decision_th"], kernel=name)


def profiler_ms(fn, kernel: str, reps: int = REPS) -> float:
    """Mean device duration (ms) of the kernel named so over reps calls,
    after warm calls inside the profiler (``_timing.profiled_windows``)."""
    for events in _timing.profiled_windows(fn, reps):
        found = [e.time_range.elapsed_us() for e in events if kernel in e.name]
        if found:
            return sum(found) / len(found) / 1e3
    check(False, f"the profiler saw no {kernel}")


def step_floor(dev) -> dict:
    """The floors' parts: ns and cycles a step of each probe, the SM clock
    they imply, and the launch's device duration (us)."""
    lib = build_bench()
    tables = tables_on(dev)
    state, snr, _mask = inputs(16, (), tables, 3, dev)
    xs = snr[:16].repeat(2).contiguous()  # kChunk frames
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    res = {}
    stream = torch.cuda.current_stream().cuda_stream
    for which, name in ((0, "chase"), (1, "selects"), (2, "chain"), (4, "table")):
        for _ in range(2):  # the first run warms the instruction cache
            rc = lib.probe_launch(which, PROBE_STEPS, xs.data_ptr(), tables["snr_th"].data_ptr(),
                                  tables["n_mcs"], tables["hysteresis"], tables["decision_th"],
                                  int(state.last), int(state.cand), int(state.counter), out.data_ptr(), stream)
            check(rc == 0, f"probe {name}: CUDA error {rc}")
        cycles, ns, _sink = (int(v) for v in out.cpu())
        res[f"{name}_cycles"] = cycles / PROBE_STEPS
        res[f"{name}_ns"] = ns / PROBE_STEPS
    res["sm_ghz"] = res["chain_cycles"] / res["chain_ns"]
    empty = lambda: lib.probe_launch(3, 0, None, None, 0, 0.0, 0, 0, 0, 0, None, stream)
    empty()
    res["launch_us"] = profiler_ms(empty, KERNELS["launch"]) * 1e3
    return res


def walk_floor_ms(T: int, floor: dict) -> float:
    """The walk's design floor: a launch plus T dependent steps, each at the
    walk's chain."""
    return (floor["launch_us"] * 1e3 + T * floor["chain_ns"]) / 1e6


def map_floor_ms(T: int, floor: dict, chunk: int = 32, tile: int = 1024) -> float:
    """The map's floor: a launch plus, a tile, a chunk's walk from every
    state, the chain's lookup a chunk and the chunk's walk again, each a
    table step."""
    steps = sum(2 * chunk + -(-min(tile, T - t0) // chunk) for t0 in range(0, T, tile))
    return (floor["launch_us"] * 1e3 + steps * floor["table_ns"]) / 1e6


def bound_ms(T: int, B: int, n_mcs: int) -> float:
    """The card's bound for the call: the larger of its bytes over the
    device memory's rate and its operations over the peak."""
    return max(feedback_cuda.feedback_bytes(T, B, n_mcs) / HBM_BYTES_PER_S,
               OPS_PER_FRAME * T * B / INT_OPS_PER_S) * 1e3


def measure(dev, floor: dict, card: str) -> list:
    """The two kernels held to the plain loop and timed in turns at every
    set, T and batch."""
    tables = tables_on(dev)
    cases = [(kind, T, batch) for kind, ts in SETS.items() for batch in BATCHES for T in ts]
    cases += [("runs", T, batch) for T, batch in WIDE]
    rows = []
    for kind, T, batch in cases:
        state, snr, mask = inputs(T, batch, tables, T + len(batch), dev, kind)
        want_state, want = adaptive._feedback_scan_masked_torch(state, snr, mask, tables)
        B = max(1, state.last.numel())
        row = {"set": kind, "T": T, "batch": list(batch),
               "design": feedback_cuda.design(T, B, tables["n_mcs"], tables["decision_th"]),
               "bound_ms": bound_ms(T, B, tables["n_mcs"]), "walk_floor_ms": walk_floor_ms(T, floor),
               "map_floor_ms": map_floor_ms(T, floor)}
        fns = {name: launcher(name, state, snr, mask, tables) for name in VARIANTS}
        for name, fn in fns.items():
            got_state, got = fn()
            torch.cuda.synchronize()
            check(torch.equal(got, want) and all(torch.equal(got_state[i], w) for i, w in enumerate(want_state)),
                  f"{name} {kind} T={T} batch={batch}: not equal to the plain loop")
        turns = {name: [] for name in VARIANTS}
        for name in (*VARIANTS, *reversed(VARIANTS)):
            turns[name].append(profiler_ms(fns[name], KERNELS[name]))
        for name in VARIANTS:
            row[f"{name}_ms"] = turns[name]
        kept = min(row[f"{row['design']}_ms"])
        row["kept_ms"] = kept
        rows.append(row)
        print(f"[k7-bench] {kind} T={T} batch={list(batch)}: walk " + " / ".join(f"{v * 1e3:.2f}" for v in
              row["walk_ms"]) + " us, map " + " / ".join(f"{v * 1e3:.2f}" for v in row["map_ms"])
              + f" us (profiler, in turns walk, map, map, walk; each equal to the plain loop); the rule takes the "
              f"{row['design']}; floors: walk {row['walk_floor_ms'] * 1e3:.2f} us, map "
              f"{row['map_floor_ms'] * 1e3:.2f} us; bound {row['bound_ms'] * 1e6:.2f} ns (bytes), the kept kernel "
              f"at {row['bound_ms'] / kept * 100:.4f}% of it ({card})", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="write the result JSON here as well")
    ap.add_argument("--timeline", action="store_true", help="the map kernel's phases, not the turns")
    ap.add_argument("--variants", action="store_true", help="the map kernel's variants, not the turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("error: bench_feedback_scan needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    extra = [functools.partial(build_source, n) for n in PHASES] if args.timeline else []
    extra += [functools.partial(build_source, n) for n in SOURCE_VARIANTS] if args.variants else []
    _cuda_build.build_all(feedback_cuda.build, build_bench, *extra)
    if args.timeline or args.variants:
        result = {"device": card}
        if args.timeline:
            result["timeline"] = timeline(dev, card)
        if args.variants:
            result["variants"] = variants(dev, card)
    else:
        floor = step_floor(dev)
        print(f"[k7-floor] a walk step's chain: {floor['chain_ns']:.2f} ns ({floor['chain_cycles']:.1f} cycles); "
              f"its parts: the shared-memory load {floor['chase_ns']:.2f} ns ({floor['chase_cycles']:.1f} cycles), "
              f"the selects {floor['selects_ns']:.2f} ns ({floor['selects_cycles']:.1f} cycles); a map table step "
              f"{floor['table_ns']:.2f} ns ({floor['table_cycles']:.1f} cycles); SM clock {floor['sm_ghz']:.3f} "
              f"GHz; launch {floor['launch_us']:.2f} us (empty kernel, profiler) ({card})", flush=True)
        result = {"device": card, "floor": floor, "rows": measure(dev, floor, card)}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
