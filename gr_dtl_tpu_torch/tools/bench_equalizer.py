"""Checks and times the CUDA equalizer kernel (csrc/equalizer.cu) on one
NVIDIA GPU, at the shapes the receive step hands it: the header call
(n_sym = 1) and the payload call (n_sym = 20) of frame_length 20, fft_len
64, at B = 1 (a link round), 32, 1024 (the coded step) and 2048 (the
uncoded step), mixed constellations 1..4, noise 0.02.

For each shape:

* kernel vs ``_equalize_frame_torch`` on the same CUDA tensors, row by row
  (``equalizer_cuda.compare_with_plain``: decisions equal, soft and taps
  within 1e-5; rows that part on a decision boundary counted apart);
* the kernel's mean device duration in a ``torch.profiler`` window while the
  calls walk a ring of different inputs (over 50 MB of them where the shape
  allows, so that the spectra come from device memory and not from L2);
  that is the kernel's time.  Between two CUDA events a call also holds the
  host's enqueue (five allocations and a ctypes launch), named so beside it;
* the plain loop's time by events, in turns plain, kernel, kernel, plain;
* bytes (``equalizer_cuda.equalizer_bytes``), the bound at 3.35 TB/s, the
  share of it.

Then table mode (wire-compat tables, :func:`foreign_constants`): the
payload call at every B decided by table, held to the plain loop bit for
bit, timed beside the closed-form call on the same inputs.

Then the arithmetic experiment: the same source built with ``-fmad=false``
beside the normal build, both held against the plain loop on inputs whose
equalized symbols sit within 2e-6 of decision boundaries (where one
rounding decides) and on the B = 2048 payload inputs, and timed in turns.

Run on the card:  python3 -m gr_dtl_tpu_torch.tools.bench_equalizer
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import sys

import numpy as np
import torch

from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.ops import equalizer, equalizer_cuda
from gr_dtl_tpu_torch.tools.bench_sync_metric import HBM_BYTES_PER_S, smi
from gr_dtl_tpu_torch.utils import config, wire_compat

FRAME_LENGTH = 20
BATCHES = (1, 32, 1024, 2048)
CALLS = {"header": (1, 0), "payload": (FRAME_LENGTH, 1)}  # n_sym, sym_offset
RING_BYTES, MAX_SLOTS = 64e6, 64
KERNEL_NAME = "equalizer_kernel"
FP32_OPS_PER_S = 67e12  # NVIDIA H100 SXM data sheet, outside the tensor cores
OPS_PER_CARRIER = 150   # two complex divisions, a slicer, the update, a carrier and symbol
# table mode: the closed-form slicer's ~10 operations become 6 a point (two
# differences, two squares, a sum, a comparison) over 2^id points: 45 on
# average over the mixed ids 1..4 of these inputs
OPS_PER_CARRIER_TABLE = OPS_PER_CARRIER - 10 + 6 * (2 + 4 + 8 + 16) // 4
LVL = float(np.float32(1.0) / np.sqrt(np.float32(10.0)))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"bench_equalizer FAILED: {what}")


def eq_tables(device, alpha: float = 0.1, tab: cn.Tables | None = None):
    """The equalizer constants of the default config at frame_length 20,
    deciding with ``tab`` (None: the installed tables)."""
    cfg = config.make_rx_config(None, frame_length=FRAME_LENGTH, eq_alpha=alpha)
    eq = equalizer.build_equalizer(cfg, device)
    return eq if tab is None else dataclasses.replace(eq, tab=tab)


def foreign_constants(seed: int = 99) -> dict:
    """Wire constants unlike the native ones, in the wire-constants schema,
    as the JAX package's own tests write them: QPSK, 8PSK and 16QAM
    relabeled (label i gets the native point of label i + 1, so no layout
    is Gray), BPSK as it is, and sync words of a random PN (+-sqrt(2) on the
    even active carriers, +-1 on all of them)."""
    d = wire_compat.dump_native()
    for name in ("qpsk", "psk8", "qam16"):
        pts = d["constellations"][name]
        d["constellations"][name] = pts[1:] + pts[:1]
    rng = np.random.RandomState(seed)
    act = sorted(set(config.DEFAULT_OCCUPIED_CARRIERS) | set(config.DEFAULT_PILOT_CARRIERS))
    w1 = np.zeros(64, np.complex64)
    w2 = np.zeros(64, np.complex64)
    for c in act:
        if c % 2 == 0 and c != 0:
            w1[c + 32] = np.sqrt(2.0) * (1.0 - 2.0 * rng.randint(2))
        w2[c + 32] = 1.0 - 2.0 * rng.randint(2)
    d["sync_word1"] = [[float(v.real), float(v.imag)] for v in w1]
    d["sync_word2"] = [[float(v.real), float(v.imag)] for v in w2]
    return d


def wire_tables(device, consts: dict | None = None) -> cn.Tables:
    """The tables of ``consts`` (default :func:`foreign_constants`) on
    ``device``, in table mode; the native constants are installed again
    afterwards."""
    wire_compat.activate(foreign_constants() if consts is None else consts)
    try:
        return cn.active(device)
    finally:
        wire_compat.deactivate()


def mixed_ids(B: int) -> np.ndarray:
    return (np.arange(B, dtype=np.int32) % 4) + 1


def frame_inputs(eq, B: int, n_sym: int, sym_offset: int, cnst: np.ndarray, seed: int,
                 noise: float = 0.02):
    """numpy (spectra [B, n_sym, 64], taps0 [B, 64]): random points of each
    row's constellation (BPSK on header symbols) on every carrier, the known
    pilots on theirs, through a smooth per-frame channel with a slow phase
    drift, plus noise; the channel with an estimation error as the taps (1
    on idle carriers)."""
    rng = np.random.RandomState(seed)
    pil, occ = eq.pilot_mask.cpu().numpy(), eq.occ_mask.cpu().numpy()
    pv = eq.pilot_vals.cpu().numpy()[sym_offset: sym_offset + n_sym]
    points = eq.tab.points.cpu().numpy()
    sym_cnst = np.where(sym_offset + np.arange(n_sym)[None, :] < eq.header_syms, 1,
                        np.clip(cnst, 1, 4)[:, None])
    idx = rng.randint(0, 16, (B, n_sym, 64)) % (1 << cn.BITS_PER_SYMBOL[sym_cnst])[:, :, None]
    grid = np.where(pil[None, None, :], pv[None], points[sym_cnst[:, :, None], idx])
    k = np.arange(64) - 32
    H = (rng.uniform(0.7, 1.3, (B, 1)) * np.exp(1j * (rng.uniform(-3, 3, (B, 1))
                                                     + 2 * np.pi * k[None, :] * rng.uniform(0, 0.2, (B, 1)) / 8)))
    drift = np.exp(1j * 0.01 * (sym_offset + np.arange(n_sym)))[None, :, None]
    w = noise * (rng.randn(B, n_sym, 64) + 1j * rng.randn(B, n_sym, 64))
    spectra = (grid * H[:, None, :] * drift + w).astype(np.complex64)
    taps0 = np.where(occ | pil, H * (1 + 0.02 * rng.randn(B, 64)), 1.0).astype(np.complex64)
    return spectra, taps0


def boundary_inputs(eq, B: int, n_sym: int, sym_offset: int, cnst: np.ndarray, seed: int):
    """As :func:`frame_inputs`, but symbol 0 of every row is the taps times a
    point within 2e-6 of a decision boundary of the row's constellation, so
    that its equalized value lands on either side by a rounding."""
    spectra, taps0 = frame_inputs(eq, B, n_sym, sym_offset, cnst, seed)
    rng = np.random.RandomState(seed + 1)
    t = rng.uniform(0.2, 1.2, (B, 64)) * rng.choice([-1.0, 1.0], (B, 64))
    line = np.where(cnst[:, None] == 4, rng.choice([-2 * LVL, 0.0, 2 * LVL], (B, 64)), 0.0)
    on = line + 1j * t
    on = np.where((rng.rand(B, 64) < 0.5) & (cnst[:, None] != 1), on.imag + 1j * on.real, on)
    ray = np.abs(t) * np.exp(1j * (2 * rng.randint(0, 8, (B, 64)) + 1) * math.pi / 8)
    on = np.where(cnst[:, None] == 3, ray, on)
    x = on + 2e-6 * rng.rand(B, 64) * np.exp(2j * np.pi * rng.rand(B, 64))
    data = (eq.occ_mask & ~eq.pilot_mask).cpu().numpy()
    spectra[:, 0] = np.where(data[None, :], (taps0 * x).astype(np.complex64), spectra[:, 0])
    return spectra, taps0


def on_device(arrays, cnst, dev):
    spectra, taps0 = arrays
    return (torch.as_tensor(spectra, device=dev), torch.as_tensor(taps0, device=dev),
            torch.as_tensor(cnst, device=dev))


def profiler_ms(fn, reps: int):
    """Mean device duration (ms) of the equalizer kernel over reps calls of
    fn(i), or None if the profiler saw none in three windows.  The first
    launches after the profiler starts may be lost, late in a process with
    many profiler sessions all of a short window: the mean is over those it
    saw, and a window that saw none is taken again."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(i)
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if KERNEL_NAME in e.key and e.self_device_time_total > 0]
        count = sum(e.count for e in found)
        if count:
            return sum(e.self_device_time_total for e in found) / count / 1e3
    return None


def event_ms(fn, reps: int) -> float:
    """Mean ms a call of fn(i) over reps back-to-back calls, by CUDA events."""
    fn(0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rows_not_bit_equal(got, want) -> int:
    """Rows whose hard, soft or taps differ from the other's in any bit (a
    NaN equals a NaN)."""
    same = lambda a, b: ((a == b) | (a.isnan() & b.isnan())).reshape(a.shape[0], -1).all(dim=1)
    return int((~(same(got.hard, want.hard) & same(got.soft, want.soft) & same(got.taps, want.taps))).sum())


def held_to_plain(eq, args, sym_offset: int, what: str) -> dict:
    """The kernel against the plain loop on one set of inputs; fails on a
    fault row, and in table mode on a row that is not bit-equal; returns
    the comparison."""
    got = equalizer.equalize_frame(*args, eq, sym_offset)
    want = equalizer._equalize_frame_torch(*args, eq, sym_offset)
    torch.cuda.synchronize()
    res = equalizer_cuda.compare_with_plain(got, want, args[2], eq, sym_offset)
    res["rows_not_bit_equal"] = rows_not_bit_equal(got, want)
    check(res["fault_rows"] == 0, f"kernel vs plain on {what}: {res}")
    check(not eq.tab.table_mode or res["rows_not_bit_equal"] == 0,
          f"table-mode kernel vs plain on {what}: not bit-equal: {res}")
    return res


def measure(eq, B: int, call: str, dev, card: str, reps: int = 48) -> dict:
    """Correctness and times of the kernel at one shape."""
    n_sym, sym_offset = CALLS[call]
    cnst = mixed_ids(B)
    nbytes = equalizer_cuda.equalizer_bytes(B, n_sym, 64)
    in_bytes = 8 * 64 * B * (n_sym + 1)
    slots = int(min(MAX_SLOTS, max(4, -(-RING_BYTES // in_bytes))))
    ring = [on_device(frame_inputs(eq, B, n_sym, sym_offset, cnst, 100 * B + n_sym + s), cnst, dev)
            for s in range(slots)]
    res = held_to_plain(eq, ring[0], sym_offset, f"B={B} {call}")
    check(res["boundary_rows"] <= max(1, B // 1000), f"B={B} {call}: {res}")
    kern = lambda i: equalizer.equalize_frame(*ring[i % slots], eq, sym_offset)
    plain = lambda i: equalizer._equalize_frame_torch(*ring[i % slots], eq, sym_offset)
    k_ev, p_ev = [], []
    for turn in ("plain", "kernel", "kernel", "plain"):
        if turn == "plain":
            p_ev.append(event_ms(plain, 2))
        else:
            k_ev.append(event_ms(kern, reps))
    prof = profiler_ms(kern, reps)
    check(prof is not None, f"the profiler saw no {KERNEL_NAME}")
    ops = (OPS_PER_CARRIER_TABLE if eq.tab.table_mode else OPS_PER_CARRIER) * B * n_sym * 64
    bound = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    out = {"B": B, "call": call, "n_sym": n_sym, "bytes": nbytes, "bound_ms": bound, "bound_by": "bytes",
           "table_mode": eq.tab.table_mode,
           "ms": prof, "ms_by": "profiler", "enqueue_ms": min(k_ev), "plain_ms": min(p_ev),
           "share_of_bound": bound / prof, "ring_slots": slots, "ring_input_bytes": slots * in_bytes,
           **res}
    print(f"[equalizer] B={B} {call} (n_sym {n_sym}{', table mode' if eq.tab.table_mode else ''}): "
          f"kernel {prof * 1e3:.2f} us device duration "
          f"(profiler, ring of {slots} inputs = {slots * in_bytes / 1e6:.1f} MB"
          f"{'' if slots * in_bytes > 50e6 else ', inside L2'}), {min(k_ev) * 1e3:.2f} us a call "
          f"between events (with the host's enqueue); plain loop {min(p_ev):.3f} ms; {nbytes} bytes, "
          f"bound {bound * 1e3:.3f} us (bytes), share {100 * bound / prof:.1f}%; vs plain: "
          f"{res['boundary_rows']} boundary rows, {res['fault_rows']} faults of {B}, "
          f"{res['rows_not_bit_equal']} rows not bit-equal, max abs err {res['max_abs_err']:.2e}; "
          f"library call: none ({card})", flush=True)
    return out


def table_mode(dev, card: str, reps: int = 48) -> list:
    """The payload call at every B in table mode against the closed-form
    call.  On the foreign tables (:func:`foreign_constants`): the kernel
    bit-equal to the plain loop, its time, the plain loop's, the bound.  The
    same inputs through the closed-form kernel and through the table-mode
    kernel on the native tables (the label layouts differ, the points do
    not, so the two decide the same point everywhere but on a boundary):
    rows that part, and the two kernels' times in turns (closed, table,
    table, closed)."""
    n_sym, sym_offset = CALLS["payload"]
    eq_c = eq_tables(dev)
    eq_t = eq_tables(dev, tab=wire_tables(dev))
    eq_n = eq_tables(dev, tab=wire_tables(dev, wire_compat.dump_native()))
    out = []
    for B in BATCHES:
        r = measure(eq_t, B, "payload", dev, card, reps)
        cnst = mixed_ids(B)
        slots = r["ring_slots"]
        ring = [on_device(frame_inputs(eq_t, B, n_sym, sym_offset, cnst, 100 * B + n_sym + s), cnst, dev)
                for s in range(slots)]
        got_n = equalizer.equalize_frame(*ring[0], eq_n, sym_offset)
        got_c = equalizer.equalize_frame(*ring[0], eq_c, sym_offset)
        torch.cuda.synchronize()
        # the native table holds the 8PSK and 16QAM points an ulp away from
        # the closed form's float32 arithmetic: one decision within 1e-6
        vs_closed = equalizer_cuda.compare_with_plain(got_n, got_c, ring[0][2], eq_c, sym_offset,
                                                      decision_atol=1e-6)
        check(vs_closed["fault_rows"] == 0 and vs_closed["boundary_rows"] <= max(1, B // 1000),
              f"B={B}: table-mode kernel on the native tables vs the closed-form kernel: {vs_closed}")
        ms = {"closed": [], "table": []}
        for turn in ("closed", "table", "table", "closed"):
            eq = eq_c if turn == "closed" else eq_t
            ms[turn].append(profiler_ms(lambda i: equalizer.equalize_frame(*ring[i % slots], eq, sym_offset),
                                        reps))
        check(all(x is not None for v in ms.values() for x in v), f"the profiler saw no {KERNEL_NAME}")
        r.update({"native_table_vs_closed_boundary_rows": vs_closed["boundary_rows"],
                  "table_ms_in_turns": ms["table"], "closed_ms_in_turns": ms["closed"]})
        print(f"[equalizer-table] B={B} payload: table mode {min(ms['table']) * 1e3:.2f} us, closed form "
              f"{min(ms['closed']) * 1e3:.2f} us on the same inputs (profiler, in turns: closed "
              f"{[round(x * 1e3, 2) for x in ms['closed']]}, table {[round(x * 1e3, 2) for x in ms['table']]}); "
              f"bound {r['bound_ms'] * 1e3:.3f} us; the native tables in table mode part from the closed "
              f"form in {vs_closed['boundary_rows']} of {B} rows, at a boundary ({card})", flush=True)
        out.append(r)
    return out


@contextlib.contextmanager
def nvcc_flags(*extra: str):
    """The wrapper on a build of the source with extra nvcc flags."""
    saved = equalizer_cuda.NVCC_FLAGS
    equalizer_cuda.NVCC_FLAGS = saved + extra
    equalizer_cuda.build.cache_clear()
    try:
        yield
    finally:
        equalizer_cuda.NVCC_FLAGS = saved
        equalizer_cuda.build.cache_clear()


def fmad_experiment(dev, card: str) -> dict:
    """The normal build and a ``-fmad=false`` build against the plain loop:
    rows that part from it on inputs at the decision boundaries and on the
    B = 2048 payload inputs, and the kernels' times in turns."""
    B, (n_sym, sym_offset) = 2048, CALLS["payload"]
    cnst = mixed_ids(B)
    out = {}
    for alpha, name in ((0.1, "updating"), (1.0, "frozen")):
        eq = eq_tables(dev, alpha)
        cases = {"at_boundaries": on_device(boundary_inputs(eq, B, n_sym, sym_offset, cnst, 7), cnst, dev),
                 "noise_0.02": on_device(frame_inputs(eq, B, n_sym, sym_offset, cnst, 8), cnst, dev)}
        wants = {k: equalizer._equalize_frame_torch(*a, eq, sym_offset) for k, a in cases.items()}
        for build, flags in (("default", ()), ("fmad_false", ("-fmad=false",)), ("default_again", ())):
            with nvcc_flags(*flags):
                row = {}
                for k, a in cases.items():
                    got = equalizer.equalize_frame(*a, eq, sym_offset)
                    torch.cuda.synchronize()
                    res = equalizer_cuda.compare_with_plain(got, wants[k], a[2], eq, sym_offset)
                    check(res["fault_rows"] == 0, f"{build} build, {name}, {k}: {res}")
                    row[k] = res
                    # bit equality with the plain loop, the strictest reading
                    row[k]["rows_not_bit_equal"] = int(
                        ((got.soft != wants[k].soft).any(dim=(1, 2)) | (got.hard != wants[k].hard).any(dim=(1, 2))
                         | (got.taps != wants[k].taps).any(dim=1)).sum())
                a = cases["noise_0.02"]
                row["ms"] = profiler_ms(lambda i: equalizer.equalize_frame(*a, eq, sym_offset), 48)
                out[f"{name}/{build}"] = row
                print(f"[fmad] {name} taps, {build} build: rows that part from the plain loop at a boundary "
                      f"{row['at_boundaries']['boundary_rows']} of {B} on the inputs at the boundaries, "
                      f"{row['noise_0.02']['boundary_rows']} on the noise-0.02 inputs; rows not bit-equal "
                      f"{row['at_boundaries']['rows_not_bit_equal']} / {row['noise_0.02']['rows_not_bit_equal']}; "
                      f"kernel {row['ms'] * 1e3:.2f} us (profiler, one input set, L2 warm) ({card})", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_equalizer: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    equalizer_cuda.build()
    print("[build] " + " | ".join(
        ln.strip() for ln in equalizer_cuda.library_path().with_suffix(".log").read_text().splitlines()
        if ln.strip() and ("registers" in ln or "spill" in ln)))
    eq = eq_tables(dev)
    results = [measure(eq, B, call, dev, card) for B in BATCHES for call in CALLS]
    table = table_mode(dev, card)
    fmad = fmad_experiment(dev, card)
    print(json.dumps({"device": card, "results": results, "table_mode": table, "fmad": fmad}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
