"""Times K7, the MCS decision over a block's frames (csrc/feedback_scan.cu),
on one NVIDIA GPU beside the floor of its walk and three design alternatives.

K7 binds on its walk: every frame's step depends on the last through the
active id, so a column costs a launch plus T dependent steps.  This tool
works that floor out from the parts of a step's chain, each timed alone by
one thread with ``clock64`` and ``%globaltimer`` around 2^16 steps:

* ``chase``: dependent shared-memory loads (``i = tab[i]``), the latency of
  the load at the head of a step;
* ``selects``: K7's own ``step`` with its rung held fixed in registers, so
  the compares leave the chain: the dependent selects alone;
* ``chain``: K7's ``step`` with its rung read from shared memory at the
  active id and its frames from registers: a step's whole chain with no
  global memory.  That is the floor of a step;
* ``launch``: an empty kernel's device duration (profiler).

The walk's bound for T frames is the launch plus T chain steps.  The probes
and the alternatives are built from K7's source as it reads, with their
kernels appended, so they share its ``step``, its rungs and its chunk:

* ``no_prefetch``: a chunk's frames loaded when its walk starts, not a
  chunk ahead;
* ``reload_on_move``: the rung held in registers and reloaded from shared
  memory under a branch, only where the id moved;
* ``guarded_tail``: one loop of whole chunks, the last one part, its frames
  past T loaded as masked and not stored (guarded loads and stores), in
  place of K7's walk of the last T % 32 frames one at a time.

For T = 1, 8, 16, 37, 256, 1024 and batch () and [64]: K7 and the
alternatives held to the plain loop (``adaptive._feedback_scan_masked_torch``)
on the same CUDA tensors (ids and state equal), and their mean device
durations in a ``torch.profiler`` window, beside the bound.

Run on the card:  python3 -m gr_dtl_tpu_torch.tools.bench_feedback_scan
"""

from __future__ import annotations

import ctypes
import functools
import json
import sys

import numpy as np
import torch

from gr_dtl_tpu_torch.models import adaptive
from gr_dtl_tpu_torch.ops import _cuda_build, feedback_cuda
from gr_dtl_tpu_torch.tools._timing import smi
from gr_dtl_tpu_torch.utils import config

T_CASES = (1, 8, 16, 37, 256, 1024)
BATCHES = ((), (64,))
PROBE_STEPS = 1 << 16
REPS = 50
VARIANTS = {"no_prefetch": 1, "reload_on_move": 2, "guarded_tail": 3}
KERNELS = {"k7": "feedback_scan_kernel", "no_prefetch": "k7_alternative<1>",
           "reload_on_move": "k7_alternative<2>", "guarded_tail": "k7_alternative<3>",
           "launch": "probe_empty"}

# appended to csrc/feedback_scan.cu (same translation unit: its step,
# rung_of, load_chunk and kChunk)
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
// from shared memory at the active id, as K7 does
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

// The walk of K7 with two of its choices open: kPrefetch, chunk k + 1 loaded
// while chunk k is walked (K7) or each chunk loaded when its walk starts;
// kReload, the rung held in registers and reloaded from shared memory under
// a branch where the id moved, or read at the active id every step (K7)
template <bool kPrefetch, bool kReload>
__device__ __forceinline__ void walk_as(State& s, const float* xp, const uint8_t* mp, long long mts, int T,
                                        int B, int* op, const float2* rungs, int dth) {
    float2 r = rungs[s.last];
    auto one = [&](float x, bool m) {
        const int before = s.last;
        const int id = step(s, x, m, kReload ? r : rungs[s.last], dth);
        if (kReload && id != before) r = rungs[id];
        return id;
    };
    int t = 0;
    float x[kChunk];
    bool m[kChunk];
    if (kPrefetch && T >= kChunk) load_chunk(x, m, xp, mp, mts, B);
    for (; t + kChunk <= T; t += kChunk) {
        const bool more = kPrefetch && t + 2 * kChunk <= T;
        float xn[kChunk];
        bool mn[kChunk];
        if (more) load_chunk(xn, mn, xp + (long long)kChunk * B, mp == nullptr ? nullptr : mp + kChunk * mts, mts, B);
        if (!kPrefetch) load_chunk(x, m, xp, mp, mts, B);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) op[(long long)k * B] = one(x[k], m[k]);
        xp += (long long)kChunk * B;
        op += (long long)kChunk * B;
        if (mp != nullptr) mp += kChunk * mts;
        if (more) {
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
                x[k] = xn[k];
                m[k] = mn[k];
            }
        }
    }
    for (; t < T; ++t) {
        *op = one(*xp, mp == nullptr || *mp != 0);
        xp += B;
        op += B;
        if (mp != nullptr) mp += mts;
    }
}

// K7's walk as one loop of whole chunks, the last one part: its frames past
// T loaded as masked (guarded loads) and not stored (guarded stores)
__device__ __forceinline__ void walk_guarded(State& s, const float* xp, const uint8_t* mp, long long mts, int T,
                                             int B, int* op, const float2* rungs, int dth) {
    auto load = [&](float (&x)[kChunk], bool (&m)[kChunk], int t0) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            const bool in = t0 + k < T;
            x[k] = in ? xp[(long long)(t0 + k) * B] : 0.0f;
            m[k] = in && (mp == nullptr || mp[(t0 + k) * mts] != 0);
        }
    };
    float x[kChunk];
    bool m[kChunk];
    load(x, m, 0);
    for (int t = 0; t < T; t += kChunk) {
        float xn[kChunk];
        bool mn[kChunk];
        load(xn, mn, t + kChunk);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            const int id = step(s, x[k], m[k], rungs[s.last], dth);
            if (t + k < T) op[(long long)(t + k) * B] = id;
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            x[k] = xn[k];
            m[k] = mn[k];
        }
    }
}

template <int kWhich>  // 1 no_prefetch, 2 reload_on_move, 3 guarded_tail
__global__ void k7_alternative(const float* __restrict__ snr, const uint8_t* __restrict__ mask, long long mts,
                               long long mbs, const float* __restrict__ snr_th, int n_mcs, float hyst, int dth,
                               const int* __restrict__ l0, const int* __restrict__ c0,
                               const int* __restrict__ k0, int T, int B, int* __restrict__ mcs,
                               int* __restrict__ st) {
    extern __shared__ float2 rungs[];
    for (int i = threadIdx.x; i < n_mcs; i += blockDim.x) rungs[i] = rung_of(snr_th, n_mcs, hyst, i);
    __syncthreads();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    State s{l0[b], c0[b], k0[b]};
    const uint8_t* mp = mask == nullptr ? nullptr : mask + b * mbs;
    if (kWhich == 1) walk_as<false, false>(s, snr + b, mp, mts, T, B, mcs + b, rungs, dth);
    if (kWhich == 2) walk_as<true, true>(s, snr + b, mp, mts, T, B, mcs + b, rungs, dth);
    if (kWhich == 3) walk_guarded(s, snr + b, mp, mts, T, B, mcs + b, rungs, dth);
    st[b] = s.last;
    st[B + b] = s.cand;
    st[2 * B + b] = s.counter;
}

}  // namespace

extern "C" int variant_launch(int which, const void* snr, const void* mask, long long mts, long long mbs,
                              const void* snr_th, int n_mcs, float hyst, int dth, const void* l,
                              const void* c, const void* k, int T, int B, void* mcs, void* st, void* stream) {
    const int threads = B < kMaxThreads ? ((B + 31) / 32) * 32 : kMaxThreads;
    const int blocks = (B + threads - 1) / threads;
    auto f = which == 1 ? k7_alternative<1> : which == 2 ? k7_alternative<2> : k7_alternative<3>;
    f<<<blocks, threads, (size_t)n_mcs * sizeof(float2), (cudaStream_t)stream>>>(
        (const float*)snr, (const uint8_t*)mask, mts, mbs, (const float*)snr_th, n_mcs, hyst, dth,
        (const int*)l, (const int*)c, (const int*)k, T, B, (int*)mcs, (int*)st);
    return (int)cudaGetLastError();
}

// which: 0 chase, 1 selects (fixed rung), 2 chain (rung at the active id), 3 empty
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
    else
        probe_empty<<<1, 1, 0, s>>>();
    return (int)cudaGetLastError();
}
"""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"bench_feedback_scan FAILED: {what}")


@functools.lru_cache(maxsize=None)
def build_bench() -> ctypes.CDLL:
    """K7's source with the probes and the alternatives appended, built into
    ``_build/`` (named by a hash of the whole text, as every build is)."""
    src = _cuda_build.BUILD_DIR / "feedback_scan_bench.cu"
    text = feedback_cuda.SOURCE.read_text() + BENCH_CU
    _cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not src.exists() or src.read_text() != text:
        src.write_text(text)
    lib = _cuda_build.load(src)
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.variant_launch.argtypes = [i, p, p, ll, ll, p, i, f, i, p, p, p, i, i, p, p, p]
    lib.probe_launch.argtypes = [i, i, p, p, i, f, i, i, i, i, p, p]
    lib.variant_launch.restype = lib.probe_launch.restype = i
    return lib


def tables_on(dev) -> dict:
    return adaptive.tables_to(adaptive.build_mcs_tables(config.make_rx_config(None)), dev)


def inputs(T: int, batch: tuple, tables: dict, seed: int, dev):
    """A carried-in state and T frames a column: runs of 1-9 equal SNRs
    across the ladder (long enough to cross decision_th), a random mask."""
    rng = np.random.RandomState(seed)
    B = int(np.prod(batch, dtype=int))
    snr = np.empty((T, B), np.float32)
    for b in range(B):
        col = []
        while len(col) < T:
            col += [np.float32(rng.uniform(5, 30))] * rng.randint(1, 10)
        snr[:, b] = col[:T]
    mask = rng.rand(T, *batch) > 0.2
    n = tables["n_mcs"]
    state = adaptive.FeedbackState(*(torch.as_tensor(rng.randint(0, hi, batch).astype(np.int32), device=dev)
                                     for hi in (n, n, 5)))
    return state, torch.as_tensor(snr.reshape((T,) + batch), device=dev), torch.as_tensor(mask, device=dev)


def launcher(name: str, state, snr, mask, tables):
    """A call of K7 (``k7``) or of an alternative on these inputs: returns
    (state [3, *batch], mcs [T, *batch])."""
    if name == "k7":
        return lambda: feedback_cuda.feedback_scan_masked_cuda(
            state.last, state.cand, state.counter, snr, mask, tables["snr_th"], tables["n_mcs"],
            tables["hysteresis"], tables["decision_th"])
    lib, batch = build_bench(), tuple(state.last.shape)
    T, B = snr.shape[0], max(1, state.last.numel())
    mt, mb = (1, 0) if mask.ndim == 1 else (B, 1)

    def call():
        st = torch.empty((3, *batch), dtype=torch.int32, device=snr.device)
        mcs = torch.empty(snr.shape, dtype=torch.int32, device=snr.device)
        rc = lib.variant_launch(VARIANTS[name], snr.data_ptr(), mask.data_ptr(), mt, mb,
                                tables["snr_th"].data_ptr(), tables["n_mcs"], tables["hysteresis"],
                                tables["decision_th"], state.last.data_ptr(), state.cand.data_ptr(),
                                state.counter.data_ptr(), T, B, mcs.data_ptr(), st.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"{name}: CUDA error {rc}")
        return st, mcs
    return call


def profiler_ms(fn, kernel: str, reps: int = REPS) -> float:
    """Mean device duration (ms) of the kernel named so over reps calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):  # a window that saw no launch is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if kernel in e.key and e.self_device_time_total > 0]
        count = sum(e.count for e in found)
        if count:
            return sum(e.self_device_time_total for e in found) / count / 1e3
    check(False, f"the profiler saw no {kernel}")


def step_floor(dev) -> dict:
    """The floor of K7's walk, from its parts: ns and cycles a step of each
    probe, the SM clock they imply, and the launch's device duration (us)."""
    lib = build_bench()
    tables = tables_on(dev)
    state, snr, _mask = inputs(16, (), tables, 3, dev)
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    res = {}
    stream = torch.cuda.current_stream().cuda_stream
    for which, name in enumerate(("chase", "selects", "chain")):
        for _ in range(2):  # the first run warms the instruction cache
            rc = lib.probe_launch(which, PROBE_STEPS, snr.data_ptr(), tables["snr_th"].data_ptr(),
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


def walk_bound_ms(T: int, floor: dict) -> float:
    """A launch plus T dependent steps, each at the chain's floor."""
    return (floor["launch_us"] * 1e3 + T * floor["chain_ns"]) / 1e6


def measure(dev, floor: dict, card: str) -> list:
    """K7 and the alternatives held to the plain loop and timed at every
    T and batch."""
    tables = tables_on(dev)
    rows = []
    for batch in BATCHES:
        for T in T_CASES:
            state, snr, mask = inputs(T, batch, tables, T + len(batch), dev)
            want_state, want = adaptive._feedback_scan_masked_torch(state, snr, mask, tables)
            row = {"T": T, "batch": list(batch), "bound_ms": walk_bound_ms(T, floor)}
            for name in ("k7", *VARIANTS):
                fn = launcher(name, state, snr, mask, tables)
                got_state, got = fn()
                torch.cuda.synchronize()
                check(torch.equal(got, want) and all(torch.equal(got_state[i], w) for i, w in enumerate(want_state)),
                      f"{name} T={T} batch={batch}: not equal to the plain loop")
                row[f"{name}_ms"] = profiler_ms(fn, KERNELS[name])
            rows.append(row)
            print(f"[k7-bench] T={T} batch={list(batch)}: " + "; ".join(
                f"{n} {row[f'{n}_ms'] * 1e3:.2f} us" for n in ("k7", *VARIANTS))
                + f" (profiler, each equal to the plain loop); walk bound {row['bound_ms'] * 1e3:.2f} us, "
                f"K7 at {row['bound_ms'] / row['k7_ms'] * 100:.1f}% of it ({card})", flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("error: bench_feedback_scan needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    _cuda_build.build_all(feedback_cuda.build, build_bench)
    floor = step_floor(dev)
    print(f"[k7-floor] a step's chain: {floor['chain_ns']:.2f} ns ({floor['chain_cycles']:.1f} cycles); its "
          f"parts: the shared-memory load {floor['chase_ns']:.2f} ns ({floor['chase_cycles']:.1f} cycles), the "
          f"selects {floor['selects_ns']:.2f} ns ({floor['selects_cycles']:.1f} cycles); SM clock "
          f"{floor['sm_ghz']:.3f} GHz; launch {floor['launch_us']:.2f} us (empty kernel, profiler) ({card})",
          flush=True)
    rows = measure(dev, floor, card)
    print(card)
    print(json.dumps({"floor": floor, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
