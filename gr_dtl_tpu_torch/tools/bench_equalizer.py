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
  that is the kernel's time.  The window is warmed up by time inside the
  profiler, as ``chip_smoke.py``'s are (``_timing.WARM_MS``), and counts only the
  launches after a marker kernel.  Between two CUDA events a call also
  holds the host's enqueue (five allocations and a ctypes launch), named so
  beside it;
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

The step's SASS (``--sass``, and in the default run): the built library is
disassembled with ``bench_k3``'s helpers.  A step loop is a loop closed by a
conditional backward branch that writes the outputs (two STG or more) and
holds no other such loop.  Through each, every way a warp can go from the
head to the back-edge is followed (``step_paths``), leaving out the
divisions' slow paths (a branch's fall-through that reaches a CALL before
any other branch); a branch that splits the lanes (a pilot carrier and the
others) is issued on both sides by the warp, so the longest way that passes
through a slicer is its step: 8PSK's multiplies atan2f's angle by 4 / pi
(``FOUR_OVER_PI``), 16QAM's holds FRND.FLOOR, the rest is BPSK's or
QPSK's.  MUFU.RCP on that way counts its divisions: c10's scaled division
issues two, its ratio's and its reciprocal's.  The issue floor of a call is its
warps x n_sym x the step's instructions over 132 SMs x 4 schedulers x the
SM clock (``clocks.max.sm``), the mixed ids 1..4 of these inputs a quarter
each.  Registers and spills are ``ptxas``'s; blocks an SM the occupancy
API's.

``--time`` times the calls alone (both calls at every B in the closed
form, the payload call at every B in table mode; three profiler windows
each).  It calls only ``equalizer.equalize_frame``, ``build_equalizer`` and
the wire-compat tables, so the file run with another checkout's package
first on the path times that checkout's kernel: two checkouts are compared
by running each in turn (a, b, b, a), each its own process.  ``--sass``
likewise counts that checkout's build.

``--same-as SOURCE`` holds this checkout's kernel bit for bit to the one
built from another checkout's csrc/equalizer.cu (:func:`same_as`).
``--variants`` builds the source with each alternative of ``VARIANTS``
written in and times it against the source as it is, in turns, after
holding it bit for bit to the source's kernel (:func:`variants`).

Run on the card:  python3 -m gr_dtl_tpu_torch.tools.bench_equalizer [--time | --sass | --same-as SOURCE | --variants] [--out FILE]
  or, for another checkout at DIR:
  PYTHONPATH=DIR python3 gr_dtl_tpu_torch/tools/bench_equalizer.py --time|--sass [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import sys
from pathlib import Path
from statistics import median

import numpy as np
import torch

from gr_dtl_tpu_torch.ops import constellation as cn
from gr_dtl_tpu_torch.ops import equalizer, equalizer_cuda
from gr_dtl_tpu_torch.tools import bench_k3
from gr_dtl_tpu_torch.tools import _timing
from gr_dtl_tpu_torch.tools._timing import event_ms, kernel_device_ms, smi
from gr_dtl_tpu_torch.tools.bench_sync_metric import HBM_BYTES_PER_S
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


def input_ring(eq, B: int, call: str, dev) -> list:
    """Input sets of one shape for a timed window, the calls walking them in
    turn: over ``RING_BYTES`` of them where the shape allows (at most
    ``MAX_SLOTS``), so that the spectra come from device memory, not L2."""
    n_sym, sym_offset = CALLS[call]
    cnst = mixed_ids(B)
    slots = int(min(MAX_SLOTS, max(4, -(-RING_BYTES // (8 * 64 * B * (n_sym + 1))))))
    return [on_device(frame_inputs(eq, B, n_sym, sym_offset, cnst, 100 * B + n_sym + s), cnst, dev)
            for s in range(slots)]


def on_device(arrays, cnst, dev):
    spectra, taps0 = arrays
    return (torch.as_tensor(spectra, device=dev), torch.as_tensor(taps0, device=dev),
            torch.as_tensor(cnst, device=dev))




def profiler_ms(fn, reps: int):
    """Mean device duration (ms) of the equalizer kernel over reps calls of
    fn(i), i walking on (fn(i) picks its inputs), in a window of
    ``_timing.profiled_windows``.  None if four windows saw none."""
    return kernel_device_ms(fn, reps, KERNEL_NAME)


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
    nbytes = equalizer_cuda.equalizer_bytes(B, n_sym, 64)
    in_bytes = 8 * 64 * B * (n_sym + 1)
    ring = input_ring(eq, B, call, dev)
    slots = len(ring)
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
        ring = input_ring(eq_t, B, "payload", dev)
        slots = len(ring)
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


# ---------------------------------------------------------------------------
# the step's SASS
# ---------------------------------------------------------------------------

SMS, SCHEDULERS = bench_k3.SMS, bench_k3.SCHEDULERS  # an H100 SXM: a warp issues on one scheduler
FOUR_OVER_PI = "1.2732394933700561523"  # kFourOverPi as nvdisasm prints it: 8PSK's slicer
INSTANTIATIONS = {"closed": "ILb0E", "table": "ILb1E"}  # equalizer_kernel<false>, <true>


def step_loops(instrs: list) -> list[tuple[int, int]]:
    """(first, last) instruction of each step loop: a loop closed by a
    conditional backward branch that writes the outputs (two STG or more)
    and holds no other such loop."""
    cand = [(lo, hi) for lo, hi in bench_k3.loops(instrs) if instrs[hi][1].startswith("@")
            and sum(instrs[i][0].startswith("STG") for i in range(lo, hi + 1)) >= 2]
    return [r for r in cand if not any(o != r and r[0] <= o[0] and o[1] <= r[1] for o in cand)]


def _slow_path(instrs: list, lo: int, hi: int) -> bool:
    """Whether [lo, hi) reaches a CALL before any branch: a division's slow path."""
    for op, _, _ in instrs[lo:hi]:
        if op.startswith("CALL"):
            return True
        if op.startswith("BRA"):
            return False
    return False


def step_paths(instrs: list, lo: int, hi: int) -> list[dict]:
    """Every way from the loop's head ``lo`` to its back-edge ``hi``: at a
    conditional forward branch both sides, unless one is a division's slow
    path (:func:`_slow_path`), which is left out; a branch out of the loop,
    or back to an inner loop's head, falls through.  Each way's
    ``instructions``, ``mufu_rcp`` and slicer: 8PSK where it multiplies by
    4 / pi (``FOUR_OVER_PI``), 16QAM where it holds FRND.FLOOR, else
    BPSK/QPSK."""
    at = {lab: i for i, (_, _, labs) in enumerate(instrs) for lab in labs}
    out, stack = [], [(lo, 0, 0, "BPSK/QPSK")]
    while stack:
        i, n, rcp, slicer = stack.pop()
        while True:
            op, ins, _ = instrs[i]
            n, rcp = n + 1, rcp + (op == "MUFU.RCP")
            if FOUR_OVER_PI in ins:
                slicer = "8PSK"
            elif op == "FRND.FLOOR":
                slicer = "16QAM"
            if i == hi:
                out.append({"instructions": n, "mufu_rcp": rcp, "slicer": slicer})
                break
            if op == "EXIT" or op == "RET":
                break
            m = bench_k3._TARGET.search(ins) if op == "BRA" else None
            t = at.get(m.group(1)) if m else None
            if m and not ins.startswith("@"):  # unconditional
                if t is None or not i < t <= hi:
                    break  # out of the loop
                i = t
                continue
            if t is not None and i < t <= hi:
                if _slow_path(instrs, i + 1, t):
                    i = t
                    continue
                stack.append((t, n, rcp, slicer))
            i += 1
    return out


def step_counts(instrs: list) -> dict:
    """What a step issues a warp, over the kernel's step loops: for each
    slicer the longest way through a step that decides with it (its
    ``instructions`` and ``mufu_rcp``), the loops' own sizes and their
    division sites (CALLs of a slow path)."""
    loops = step_loops(instrs)
    best: dict = {}
    for lo, hi in loops:
        for path in step_paths(instrs, lo, hi):
            if path["instructions"] > best.get(path["slicer"], {"instructions": -1})["instructions"]:
                best[path["slicer"]] = {k: path[k] for k in ("instructions", "mufu_rcp")}
    return {"slicers": best, "loops": [[lo, hi, hi - lo + 1] for lo, hi in loops],
            "slow_path_calls": sum(instrs[i][0].startswith("CALL") for lo, hi in loops for i in range(lo, hi + 1)),
            "longest": max(v["instructions"] for v in best.values())}


def mixed_step(counts: dict) -> float:
    """Instructions a step over the mixed ids 1..4, a quarter each (BPSK's
    step counted as QPSK's, the longer of the two)."""
    s = counts["slicers"]
    return (2 * s["BPSK/QPSK"]["instructions"] + s["8PSK"]["instructions"] + s["16QAM"]["instructions"]) / 4


def issue_floor_ms(instr_per_step: float, B: int, n_sym: int, clock_mhz: float, fft_len: int = 64) -> float:
    """Least time the card takes to issue a call's steps: B x fft_len / 32
    warps, n_sym steps each, every scheduler issuing an instruction of one
    warp every cycle."""
    return instr_per_step * B * (fft_len // 32) * n_sym / (SMS * SCHEDULERS * clock_mhz * 1e6) * 1e3


def ptxas_report(lib: Path) -> dict:
    """{instantiation: {"registers", "spill_bytes"}} from the build's ptxas
    log (``-Xptxas=-v``)."""
    out, name = {}, None
    log = Path(lib).with_suffix(".log")
    for ln in log.read_text().splitlines() if log.exists() else []:
        if m := re.search(r"Function properties for (\S+)", ln):
            name = next((k for k, tag in INSTANTIATIONS.items() if tag in m.group(1)), None)
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            out.setdefault(name, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def sass_report() -> dict:
    """The build on the path: its step's SASS counts an instantiation, its
    registers and spills, and the closed form's issue floor at the paths'
    shapes at the SM's top clock (``clocks.max.sm``)."""
    lib = equalizer_cuda.library_path()
    equalizer_cuda.build()
    kernels = bench_k3.disassemble(lib)
    clock = bench_k3.sm_clock_mhz()
    out = {"library": lib.name, "clocks_max_sm_mhz": clock, "ptxas": ptxas_report(lib)}
    # blocks an SM, where the build reports them (an older checkout's may not)
    resident = getattr(equalizer_cuda, "resident_blocks", None)
    if resident is not None:
        out["blocks_per_sm"] = {inst: resident(64, inst == "table") for inst in INSTANTIATIONS}
        out["one_wave_at_2048"] = {inst: -(-2048 // equalizer_cuda.rows_per_block(64)) <= SMS * n
                                   for inst, n in out["blocks_per_sm"].items()}
    for inst, tag in INSTANTIATIONS.items():
        name = next(k for k in kernels if KERNEL_NAME in k and tag in k)
        out[inst] = step_counts(kernels[name])
    step = mixed_step(out["closed"])
    out["closed"]["mixed_ids_step"] = step
    out["issue_floor_ms"] = {f"{B}/{call}": issue_floor_ms(step, B, n_sym, clock)
                             for B in BATCHES for call, (n_sym, _) in CALLS.items()}
    return out


# ---------------------------------------------------------------------------
# --time: the calls alone, by the public functions
# ---------------------------------------------------------------------------

def time_calls(dev, windows: int = 3, reps: int = 48) -> dict:
    """{"<B>/<call>[/table]": {"ms": median, "windows": [...]}}: the device
    time of each call over a ring of inputs, ``windows`` profiler windows
    each; the closed form at every B for both calls, table mode (the
    foreign tables) for the payload call."""
    eq_c, eq_t = eq_tables(dev), eq_tables(dev, tab=wire_tables(dev))
    shapes = [(B, call, eq_c) for B in BATCHES for call in CALLS] + [(B, "payload", eq_t) for B in BATCHES]
    out = {}
    for B, call, eq in shapes:
        sym_offset = CALLS[call][1]
        ring = input_ring(eq, B, call, dev)
        fn = lambda i: equalizer.equalize_frame(*ring[i % len(ring)], eq, sym_offset)
        ms = [profiler_ms(fn, reps) for _ in range(windows)]
        check(all(x is not None for x in ms), f"the profiler saw no {KERNEL_NAME}")
        key = f"{B}/{call}" + ("/table" if eq.tab.table_mode else "")
        out[key] = {"ms": median(ms), "windows": ms}
        print(f"[time] {key}: {median(ms) * 1e3:.2f} us (windows {[round(x * 1e3, 2) for x in ms]})", flush=True)
        del ring
    return out


# ---------------------------------------------------------------------------
# --same-as: bit for bit against another checkout's kernel
# ---------------------------------------------------------------------------

def same_as(dev, other_source: Path) -> dict:
    """The kernel of this checkout against the one built from
    ``other_source`` (another checkout's csrc/equalizer.cu, the same C
    interface), through this checkout's wrapper, on phase 21's inputs at B =
    1024 and 2048 (both calls; the payload call also in table mode on the
    foreign tables) and on the B = 2048 payload inputs at the decision
    boundaries, updating and frozen: {case: rows whose hard, soft, taps,
    SNR or noise variance differ in any bit (a NaN equals a NaN)}."""
    from gr_dtl_tpu_torch.ops import _cuda_build
    other = equalizer_cuda.bind_launch(_cuda_build.load(Path(other_source), equalizer_cuda.NVCC_FLAGS))
    eq_c, eq_t = eq_tables(dev), eq_tables(dev, tab=wire_tables(dev))
    cases = {}
    for B in (1024, 2048):
        cnst = mixed_ids(B)
        for call, (n_sym, off) in CALLS.items():
            cases[f"{B}/{call}"] = (eq_c, off, frame_inputs(eq_c, B, n_sym, off, cnst, 100 * B + n_sym))
        n_sym, off = CALLS["payload"]
        cases[f"{B}/payload/table"] = (eq_t, off, frame_inputs(eq_t, B, n_sym, off, cnst, 100 * B + n_sym))
    n_sym, off = CALLS["payload"]
    for alpha in (0.1, 1.0):
        eq = eq_tables(dev, alpha)
        cases[f"2048/payload/boundaries/alpha={alpha}"] = (
            eq, off, boundary_inputs(eq, 2048, n_sym, off, mixed_ids(2048), 7))

    def rows_differ(a, b) -> int:
        same = lambda x, y: ((x == y) | (x.isnan() & y.isnan())).reshape(x.shape[0], -1).all(dim=1)
        return int((~torch.stack([same(x, y) for x, y in zip(a, b)]).all(dim=0)).sum())

    out = {}
    for name, (eq, off, arrays) in cases.items():
        args = on_device(arrays, mixed_ids(arrays[0].shape[0]), dev)
        mine = equalizer.equalize_frame(*args, eq, off)
        with _timing.launching(equalizer_cuda, other):
            theirs = equalizer.equalize_frame(*args, eq, off)
        torch.cuda.synchronize()
        out[name] = rows_differ(mine, theirs)
        print(f"[same-as] {name}: {out[name]} of {args[0].shape[0]} rows differ from {other_source} in any bit",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# --variants: the design's choices, each against the alternative it beat
# ---------------------------------------------------------------------------

# name: the source's text and what the alternative writes in its place
VARIANTS = {
    "symbols copied 3 ahead": (("constexpr int kAhead = 2;", "constexpr int kAhead = 3;"),),
    "symbols copied 6 ahead, a ring of 8": (("constexpr int kAhead = 2;", "constexpr int kAhead = 6;"),
                                            ("constexpr int kRing = 4;", "constexpr int kRing = 8;")),
    "table mode's groups of four one at a time": (("            Candidate best;\n#pragma unroll\n",
                                                   "            Candidate best;\n#pragma unroll 1\n"),),
    "outputs by 64-bit pointers stepped a symbol": (
        ("            hard_row[out] = ref;\n            soft_row[out] = eqd;\n            out += fft_len;",
         "            *hard_row = ref;\n            *soft_row = eqd;\n            hard_row += fft_len;\n"
         "            soft_row += fft_len;"),),
}
VARIANT_SHAPES = [(1, "payload", False), (1024, "payload", False), (2048, "payload", False),
                  (2048, "header", False), (2048, "payload", True)]


def variant_library(name: str):
    """The kernel library of the source with ``VARIANTS[name]`` written in
    (built into ``_build/`` beside the others), bound for the wrapper."""
    return _timing.variant_library(equalizer_cuda, VARIANTS[name], "equalizer_variant")


def variants(dev, reps: int = 48) -> dict:
    """Each variant of ``VARIANTS`` against the source as it is, at
    ``VARIANT_SHAPES``: rows not bit-equal to the source's kernel (must be
    0), and device times in turns (the source, each variant, each variant
    again in the reverse order, the source): {shape: {name: [ms, ms]}}."""
    libs = {"as built": equalizer_cuda.build(), **{name: variant_library(name) for name in VARIANTS}}
    eq_c, eq_t = eq_tables(dev), eq_tables(dev, tab=wire_tables(dev))
    out = {}
    for B, call, table in VARIANT_SHAPES:
        eq = eq_t if table else eq_c
        off = CALLS[call][1]
        ring = input_ring(eq, B, call, dev)
        want = equalizer.equalize_frame(*ring[0], eq, off)
        key = f"{B}/{call}" + ("/table" if table else "")
        out[key] = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            with _timing.launching(equalizer_cuda, libs[name]):
                got = equalizer.equalize_frame(*ring[0], eq, off)
                torch.cuda.synchronize()
                check(rows_not_bit_equal(got, want) == 0, f"variant {name!r} at {key}: not bit-equal")
                ms = profiler_ms(lambda i: equalizer.equalize_frame(*ring[i % len(ring)], eq, off), reps)
            check(ms is not None, f"the profiler saw no {KERNEL_NAME}")
            out[key][name].append(ms)
        print(f"[variants] {key}: " + "; ".join(f"{n} {[round(x * 1e3, 2) for x in v]} us"
                                                for n, v in out[key].items()), flush=True)
        del ring
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gr_dtl_tpu_torch.tools.bench_equalizer")
    p.add_argument("--time", action="store_true", help="time the calls alone (public functions only)")
    p.add_argument("--sass", action="store_true", help="count the step's SASS of the build only")
    p.add_argument("--same-as", default=None, metavar="SOURCE",
                   help="hold this checkout's kernel bit for bit to the one built from SOURCE "
                        "(another checkout's csrc/equalizer.cu)")
    p.add_argument("--variants", action="store_true",
                   help="time the design's choices against the alternatives of VARIANTS, in turns")
    p.add_argument("--out", default=None, help="write the result as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_equalizer: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    res = {"device": card, "package": str(Path(equalizer.__file__).parents[1])}
    if args.time:
        res["time"] = time_calls(dev)
    elif args.sass:
        res["sass"] = sass_report()
    elif args.same_as:
        res["same_as"] = same_as(dev, Path(args.same_as))
    elif args.variants:
        res["variants"] = variants(dev)
    else:
        res["sass"] = sass_report()
        print("[sass] " + json.dumps(res["sass"]), flush=True)
        eq = eq_tables(dev)
        res["results"] = [measure(eq, B, call, dev, card) for B in BATCHES for call in CALLS]
        res["table_mode"] = table_mode(dev, card)
        res["fmad"] = fmad_experiment(dev, card)
    print(json.dumps(res))
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
