"""K3 and K8, the sum-product BP kernels (csrc/ldpc_bp.cu): their SASS
counts and issue floor as compiled, and the decoders' times on their inputs.

What a message update issues an edge is read from the SASS of the built
library (``cuobjdump -xelf`` then ``nvdisasm``, from the toolkit beside
``nvcc``).  Loops are the regions a backward branch closes.  Every edge of
an update evaluates tanhf and expf once, and each of them issues one
``MUFU.EX2`` (logf and atanhf issue none), so over the innermost loops that
hold a MUFU instruction (the loops that evaluate the transcendentals) an
edge issues ``2 x instructions / MUFU.EX2``; the same ratio gives MUFU,
shared-memory loads and stores an edge.  ``--form gather`` reads K8
(``bp_gather_kernel``), whose edge evaluates tanhf once and no expf (atanhf
and the division issue no ``MUFU.EX2``): there an edge issues
``instructions / MUFU.EX2``.  The compiler unswitches K8's first pass over
a check's slots on the first update (which reads no message): the loop
holds two copies of it, one jumped over by an unconditional branch, and
the count leaves that copy out (:func:`skipped`), as an update that reads
its messages never runs it.  K3's loop holds no such copy.  That leaves out the passes that
only gather (the totals and the syndrome), so the floor below is a lower
bound.  The issue floor of a run is ``instructions an edge x E x the
updates the run took`` over ``132 SMs x 4 schedulers x 32 lanes x the SM
clock`` (``clocks.max.sm``).

``--time`` times ``ldpc.decode_mm`` on the coded step's BP input at 25 and
11 dB (``bench_fec``'s coded build, 1024 QPSK frames) and on 2048 codewords
of the n=300 code clean, at the knee and in the waterfall, and
``ldpc.decode_bank_mm`` on banks of 1, 2, 8 and 32 codes at 1024 codewords
(``bench_bank_switch``'s inputs), by CUDA events and by the profiler's
device time.  It calls only the decoders' public functions, so the file
run with another checkout's package first on the path times that
checkout's decoders: two checkouts are compared by running each in turn
(a, b, b, a), each its own process.  ``--form gather --time`` times K8
(``ldpc.decode`` on a code's sets, ``ldpc.decode_bank`` on a bank's)
against its plain version ``_bp_gather`` on phase 30's sets
(:func:`k8_sets`: the 2048-codeword regimes, the 33-code coded step at 25
and 11 dB, banks of copies and of distinct codes), in turns.

K8's design is read three more ways, each on the card.  ``--dump FILE``
saves K8's outputs on phase 30's sets through the public functions of the
checkout first on the path, and ``--same-as FILE`` counts the rows whose
hard bits, iterations or ok differ in any bit between this checkout's K8
and a dump of another's (:func:`same_as`).  ``--variants`` builds the source with
each alternative of ``VARIANTS`` written in and times them against it in
turns, each held bit for bit to it (:func:`variants`).  ``--timeline``
builds the source (or, with ``--variant``, one of ``VARIANTS``) with a
``%globaltimer`` record a codeword (its start, first barrier and end, its
SM and updates; ``TIMELINES``) and summarises each of four sets: the tail
(the share of the span in which fewer than half the SMs hold a codeword),
the codewords' lives by updates, the time to the first barrier
(:func:`timeline_summary`).

Run on the card:  python3 -m gr_dtl_tpu_torch.tools.bench_k3 [--form k3|gather] [--time] [--out FILE]
  python3 -m gr_dtl_tpu_torch.tools.bench_k3 --form gather [--same-as DUMP | --variants | --timeline [--variant NAME]]
  or, for another checkout at DIR:
  PYTHONPATH=DIR python3 gr_dtl_tpu_torch/tools/bench_k3.py [--form gather] --time [--out FILE]
  PYTHONPATH=DIR python3 gr_dtl_tpu_torch/tools/bench_k3.py --form gather --dump DUMP
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import re
import subprocess
import tempfile
from pathlib import Path
from statistics import median

import torch

from gr_dtl_tpu_torch.ops import _cuda_build, ldpc, ldpc_cuda
from gr_dtl_tpu_torch.tools._timing import smi

SMS, SCHEDULERS, LANES = 132, 4, 32  # an H100 SXM: SMs, warp schedulers an SM, lanes a warp
EX2_PER_EDGE = 2  # K3's: tanhf's and expf's
# each form's kernel (a substring of its mangled name) and MUFU.EX2 an edge
FORMS = {"k3": ("bp_kernel", EX2_PER_EDGE), "gather": ("bp_gather_kernel", 1)}

_INSTR = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"BRA\b.*`\((\.L_x_\d+)\)")
_FUNC = re.compile(r"^//-+ \.text\.(\S+) -+$")


def parse(text: str) -> dict[str, list]:
    """{kernel's mangled name: [(opcode, instruction text, labels before it)]}
    of ``nvdisasm -c`` output."""
    out: dict[str, list] = {}
    name, labels = None, []
    for line in text.splitlines():
        if m := _FUNC.match(line):
            name, labels = m.group(1), []
            out[name] = []
        elif name and (m := _LABEL.match(line)):
            labels.append(m.group(1))
        elif name and (m := _INSTR.match(line)):
            ins = m.group(1)
            out[name].append((re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0], ins, labels))
            labels = []
    return out


def disassemble(lib: Path) -> dict[str, list]:
    """:func:`parse` of every kernel of ``lib``."""
    bin_dir = Path(_cuda_build.nvcc()).parent
    out: dict[str, list] = {}
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([str(bin_dir / "cuobjdump"), "-xelf", "all", str(Path(lib).resolve())], cwd=tmp,
                       check=True, capture_output=True)
        for cubin in sorted(Path(tmp).glob("*.cubin")):
            out.update(parse(subprocess.run([str(bin_dir / "nvdisasm"), "-c", str(cubin)], check=True,
                                            capture_output=True, text=True).stdout))
    return out


def loops(instrs: list) -> list[tuple[int, int]]:
    """(first, last) instruction of every region a backward branch closes."""
    at = {lab: i for i, (_, _, labs) in enumerate(instrs) for lab in labs}
    found = []
    for i, (_, ins, _) in enumerate(instrs):
        if (m := _TARGET.search(ins)) and at.get(m.group(1), i + 1) <= i:
            found.append((at[m.group(1)], i))
    return sorted(found)


def _count(instrs, lo: int, hi: int, skip=frozenset()) -> dict:
    ops = [instrs[i][0] for i in range(lo, hi + 1) if i not in skip]
    base = [op.split(".")[0] for op in ops]
    return {"instructions": len(ops), "mufu": base.count("MUFU"), "ex2": ops.count("MUFU.EX2"),
            "lds": base.count("LDS"), "sts": base.count("STS"), "bar": base.count("BAR"),
            "warpsync": base.count("WARPSYNC"), "vote": base.count("VOTE")}


def skipped(instrs: list, lo: int, hi: int) -> set[int]:
    """The instructions of [lo, hi] that an unconditional forward branch
    inside it jumps over: a copy of the loop's body that the compiler
    unswitched on a condition the loop does not change (K8's first update,
    which reads no message, is such a copy), which an update that reads
    its messages does not run."""
    at = {lab: i for i, (_, _, labs) in enumerate(instrs) for lab in labs}
    out = set()
    for i in range(lo, hi + 1):
        op, ins, _ = instrs[i]
        if op == "BRA" and not ins.startswith("@") and (m := _TARGET.search(ins)) and i < at.get(m.group(1), i) <= hi:
            out.update(range(i + 1, at[m.group(1)]))
    return out


def edge_counts(instrs: list, ex2_per_edge: int = EX2_PER_EDGE) -> dict:
    """What a message update issues an edge over the loops that evaluate the
    transcendentals (the innermost loops holding MUFU; the module's note),
    less the unswitched copies an update that reads its messages skips
    (:func:`skipped`), an edge evaluating ``ex2_per_edge`` MUFU.EX2; and
    the barriers of the loop of updates that holds them (the tightest loop
    around them: K8's walk over codewords holds that loop in turn)."""
    regions = [(lo, hi) for lo, hi in loops(instrs) if _count(instrs, lo, hi)["mufu"]]
    inner = [r for r in regions if not any(o != r and r[0] <= o[0] and o[1] <= r[1] for o in regions)]
    skips = {r: skipped(instrs, *r) for r in inner}
    tot = {k: sum(_count(instrs, lo, hi, skips[(lo, hi)])[k] for lo, hi in inner) for k in _count(instrs, 0, 0)}
    if not tot["ex2"]:
        raise ValueError("no loop evaluates MUFU.EX2: not a BP kernel's SASS")
    per_edge = {k: ex2_per_edge * tot[k] / tot["ex2"] for k in ("instructions", "mufu", "lds", "sts")}
    outer = [r for r in loops(instrs) if r not in inner and any(r[0] <= i[0] and i[1] <= r[1] for i in inner)]
    lo, hi = min(outer, key=lambda r: r[1] - r[0]) if outer else (0, len(instrs) - 1)
    update = _count(instrs, lo, hi)
    return {"per_edge": per_edge, "loops": [[lo_, hi_] for lo_, hi_ in inner],
            "skipped": sum(len(v) for v in skips.values()),
            "update_loop_barriers": {k: update[k] for k in ("bar", "warpsync", "vote")},
            "kernel_instructions": len(instrs)}


def sm_clock_mhz() -> float:
    """The SM's top clock as ``nvidia-smi`` reads it (``clocks.max.sm``)."""
    return float(smi("clocks.max.sm").split()[0])


def issue_floor_ms(instr_per_edge: float, n_edges: int, updates: int, clock_mhz: float) -> float:
    """Least time the card takes to issue ``updates`` message updates of
    ``n_edges`` edges at ``instr_per_edge``: every lane of every scheduler
    issuing an instruction every cycle."""
    return instr_per_edge * n_edges * updates / (SMS * SCHEDULERS * LANES * clock_mhz * 1e6) * 1e3


def form_counts(kernels: dict, form: str = "k3") -> dict:
    """{kernel name: edge_counts} for every kernel of ``form`` (``FORMS``)
    among ``kernels`` (:func:`parse`'s)."""
    tag, ex2 = FORMS[form]
    return {name: edge_counts(ins, ex2) for name, ins in kernels.items() if f"{tag}I" in name}


def kernel_counts(lib: Path, form: str = "k3") -> dict:
    """:func:`form_counts` of the kernels of ``lib``."""
    return form_counts(disassemble(lib), form)


def ptxas_lines(lib: Path) -> list[str]:
    """The compiler's report of registers, barriers and spills, a kernel at a time."""
    log = Path(lib).with_suffix(".log")
    return [ln.strip() for ln in (log.read_text().splitlines() if log.exists() else [])
            if "bp_kernel" in ln or "bp_gather_kernel" in ln or "registers" in ln or "spill" in ln]


REGIMES = {"clean": (4.0, 0.5), "knee": (1.6, 1.0), "waterfall": (1.3, 1.0)}  # LLR amplitude, sigma
BANK_SIZES = (1, 2, 8, 32)


def regime_inputs(dev, n: int = 2048, seed: int = 27) -> tuple:
    """The n=300 code on ``dev`` and n of its codewords' LLRs in each of
    ``REGIMES`` (seeded numpy: random messages, then each regime's noise in
    turn): (code, {regime: [n, 300] float32})."""
    import numpy as np
    from gr_dtl_tpu_torch.tools import _ldpc_bench
    d = ldpc.build_ldpc(_ldpc_bench.n300())
    cpu = ldpc.ldpc_from_reference(d, "cpu")
    rng = np.random.RandomState(seed)
    cw = ldpc.encode(torch.as_tensor(rng.randint(0, 2, (n, d["K"])).astype(np.float32)), cpu).numpy()
    return ldpc.ldpc_from_reference(d, dev), {
        k: torch.as_tensor(((1.0 - 2.0 * cw) * amp + rng.randn(*cw.shape) * sigma).astype(np.float32), device=dev)
        for k, (amp, sigma) in REGIMES.items()}


def bank_inputs(dev, codewords: int = 1024) -> dict:
    """Banks of n copies of the n=300 code with tools/bench_bank_switch's
    inputs (codewords from RandomState(0), clean LLRs of amplitude 4 and
    sigma 0.5 from a generator seeded 2, uniform code ids), n in
    ``BANK_SIZES``: {n: (llr, int32 ids, bank)}."""
    import numpy as np
    from gr_dtl_tpu_torch.tools import _ldpc_bench
    H = _ldpc_bench.n300()
    code = ldpc.ldpc_from_reference(ldpc.build_ldpc(H), dev)
    rng = np.random.RandomState(0)
    out = {}
    for n in BANK_SIZES:
        bank = ldpc.bank_from_reference(ldpc.build_ldpc_bank([H] * n), dev)
        llr = _ldpc_bench.regime_llrs(_ldpc_bench.codewords(code, codewords, rng), 4.0, 0.5, 2).contiguous()
        out[n] = (llr, torch.as_tensor(rng.randint(1, n + 1, codewords).astype(np.int32), device=dev), bank)
    return out


def device_ms(fn, per_call: int = 1, reps: int = 20, kernel: str = "bp_kernel") -> float:
    """Device time a call of fn by ``torch.profiler``: every kernel and copy
    of ``reps`` calls, summed, over the calls the profiler saw, counted as
    ``kernel``'s launches over ``per_call`` (its launches a call).  Events
    time the host's enqueue where a call's kernels take less than it.  The
    window opens after warm calls inside the profiler, at a marker kernel
    (:func:`_timing.profiled_windows`): the profiler misses the launches of
    its first milliseconds.  A window that saw no ``kernel`` is taken again,
    warmed for longer, and four such windows raise."""
    from gr_dtl_tpu_torch.tools import _timing
    for events in _timing.profiled_windows(fn, reps):
        seen = sum(kernel in e.name for e in events)
        if seen:
            return sum(e.time_range.elapsed_us() for e in events) * per_call / seen / 1e3
    raise RuntimeError(f"the profiler saw no {kernel} in {len(_timing.WARM_MS)} windows")


def in_turns(fns: dict, reps: int | dict = 20, device: dict | None = None, rounds: int = 2,
             kernel: str = "bp_kernel") -> dict:
    """ms a call of each fn, after a warm-up call each, the fns in turns (a,
    b, c, c, b, a every round): {name: {"events": [a window's ms a call by
    CUDA events], "device": [a window's by :func:`device_ms`]}}.  A window is
    ``reps`` calls (a number, or one a name).  Device time is taken for the
    names in ``device`` ({name: its launches of ``kernel`` a call}) and for
    no other."""
    from gr_dtl_tpu_torch.tools import _timing
    device = device or {}
    for fn in fns.values():
        fn()
    out = {k: {"events": [], "device": []} for k in fns}
    for _ in range(rounds):
        for k in list(fns) + list(fns)[::-1]:
            n = reps[k] if isinstance(reps, dict) else reps
            out[k]["events"].append(_timing.window_ms(fns[k], n, "cuda"))
            if k in device:
                out[k]["device"].append(device_ms(fns[k], device[k], n, kernel))
    return out


CODED_SNRS_DB = (25.0, 11.0)


def coded_inputs(dev, frames: int = 1024, seed: int = 0) -> tuple:
    """The coded step's BP input at each of ``CODED_SNRS_DB``, drawn as
    ``bench_fec`` draws its coded points (its coded build, ``frames`` QPSK
    frames of bytes from RandomState(0), the noise from a generator seeded
    ``seed`` scaled to the SNR): one receive step a SNR, and the LLRs it
    handed ``ldpc.decode_mm``.  Returns (the code, {"coded 25 dB": [frames
    x codewords a frame, N] float32, ...})."""
    import numpy as np
    from gr_dtl_tpu_torch.models import receiver
    from gr_dtl_tpu_torch.ops import channel
    from gr_dtl_tpu_torch.tools import bench_fec
    _, rxcfg, fec, txp, rxp = bench_fec.coded_build(dev)
    clean = bench_fec.qpsk_frames(txp, frames, np.random.RandomState(0)).reshape(-1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    unit = torch.complex(torch.randn(clean.shape, generator=gen, device=dev),
                         torch.randn(clean.shape, generator=gen, device=dev))
    sig_p = float(torch.mean(torch.abs(clean) ** 2))
    decode_mm, seen = ldpc.decode_mm, []

    def capture(llr, *args, **kw):
        seen.append(llr.float().contiguous().clone())
        return decode_mm(llr, *args, **kw)

    out = {}
    ldpc.decode_mm = capture
    try:
        for snr in CODED_SNRS_DB:
            stream = channel.awgn(clean, float(np.sqrt(sig_p / 10 ** (snr / 10))), noise=unit)
            frames_, _ = receiver.detect_and_extract(stream, rxcfg, frames)
            receiver.rx_frames(rxp, frames_)
            out[f"coded {snr:g} dB"] = seen.pop()
    finally:
        ldpc.decode_mm = decode_mm
    return fec.code, out


def time_decoders(dev) -> dict:
    """``--time``: {input: its times, iterations and launches a call}."""
    code, coded = coded_inputs(dev)
    n300, regimes = regime_inputs(dev)
    calls = {k: (lambda x=x: ldpc.decode_mm(x, code)) for k, x in coded.items()}
    calls.update({f"2048 {k}": (lambda x=x: ldpc.decode_mm(x, n300)) for k, x in regimes.items()})
    calls.update({f"bank of {n} codes, 1024 codewords": (lambda a=a: ldpc.decode_bank_mm(*a))
                  for n, a in bank_inputs(dev).items()})
    launches, rows = {}, {}
    for k, fn in calls.items():
        n0 = ldpc_cuda.bp_decode_cuda.LAUNCHES
        _, it, ok = fn()
        launches[k] = ldpc_cuda.bp_decode_cuda.LAUNCHES - n0
        rows[k] = {"codewords": it.numel(), "mean_iters": it.float().mean().item(),
                   "updates": int(it.sum()), "ok_rate": ok.float().mean().item(), "launches": launches[k]}
    t = in_turns(calls, 20, launches)
    for k, row in rows.items():
        row.update(ms=median(t[k]["events"]), device_ms=median(t[k]["device"]), ms_windows=t[k]["events"],
                   device_ms_windows=t[k]["device"])
        print(f"{k}: {row}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# K8's sets: phase 30's inputs (chip_smoke.py)
# ---------------------------------------------------------------------------

K8_BANK_CODES = 33  # copies of the n=300 code: one more than fec_chain.BANK_MM_MAX_CODES, so decode_bank decodes
K8_IDS = 15  # the step's fec_ids draw from 1..15: the header carries 4 bits of them (ops/header.py)
SHIPPED_ALISTS = ("n_0100_k_0027.alist", "n_0100_k_0023.alist", "n_0300_k_0152.alist")


def bank_step_inputs(dev, frames: int = 1024, seed: int = 0) -> tuple:
    """The coded step's BP input through a bank of ``K8_BANK_CODES`` copies
    of the n=300 code at each of ``CODED_SNRS_DB``, drawn as phase 30 draws
    its step (QPSK frames filled to their transport block from
    RandomState(seed + 30), fec_ids from the same in 1..``K8_IDS``, the
    noise from a generator seeded ``seed`` scaled to the SNR): one receive
    step a SNR, and what it handed ``ldpc.decode_bank``.  Returns (the
    bank, {"33-code step 25 dB": (llr [frames x 13, 300] float32, code ids
    [frames x 13] int32), ...})."""
    import numpy as np
    from gr_dtl_tpu_torch.models import fec_chain, receiver, transmitter
    from gr_dtl_tpu_torch.ops import channel, constellation
    from gr_dtl_tpu_torch.tools import _ldpc_bench, bench_fec
    from gr_dtl_tpu_torch.utils import config as cfgmod
    cfg = cfgmod.make_tx_config(str(bench_fec.FEC_CONFIG), frame_length=20)
    rxcfg = cfgmod.make_rx_config(str(bench_fec.FEC_CONFIG), frame_length=20)
    fec = fec_chain.build_fec(cfg, [_ldpc_bench.n300()] * K8_BANK_CODES, dev)
    txp, rxp = transmitter.build_tx(cfg, dev, fec), receiver.build_rx(rxcfg, dev, fec)
    rng = np.random.RandomState(seed + 30)
    fec_id = rng.randint(1, K8_IDS + 1, frames).astype(np.int32)
    ub = fec.user_bytes_tab2[fec_id, int(constellation.BITS_PER_SYMBOL[2])]
    payload = np.zeros((frames, fec.max_payload_bytes), np.uint8)
    for i in range(frames):
        payload[i, :ub[i]] = rng.randint(0, 256, ub[i])
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    clean = transmitter.tx_frames(txp, torch.as_tensor(payload, device=dev), t(ub), t(np.full(frames, 2)),
                                  t(np.zeros(frames)), torch.arange(frames, device=dev, dtype=torch.int32) % 4096,
                                  None, fec_id=t(fec_id)).samples.reshape(-1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    unit = torch.complex(torch.randn(clean.shape, generator=gen, device=dev),
                         torch.randn(clean.shape, generator=gen, device=dev))
    sig_p = float(torch.mean(torch.abs(clean) ** 2))
    decode_bank, seen = ldpc.decode_bank, []

    def capture(llr, code_idx, *args, **kw):
        seen.append((llr.float().contiguous().clone(), code_idx.to(torch.int32).contiguous().clone()))
        return decode_bank(llr, code_idx, *args, **kw)

    out = {}
    ldpc.decode_bank = capture
    try:
        for snr in CODED_SNRS_DB:
            stream = channel.awgn(clean, float(np.sqrt(sig_p / 10 ** (snr / 10))), noise=unit)
            frames_, _ = receiver.detect_and_extract(stream, rxcfg, frames)
            receiver.rx_frames(rxp, frames_)
            out[f"{K8_BANK_CODES}-code step {snr:g} dB"] = seen.pop()
    finally:
        ldpc.decode_bank = decode_bank
    return fec.bank, out


def distinct_bank(n: int, dev, codewords: int, seed: int) -> tuple:
    """A bank of n codes cycling through the three shipped alists (two rates
    of n=100 and the n=300 code, in the bank's padded layout), so that a row
    decodes only with its own code's tables, and noisy LLRs (seeded numpy,
    mean 1.8, sigma 1.2) that take updates: (llr [codewords, bank.Nmax], bank)."""
    import numpy as np
    from gr_dtl_tpu_torch.tools import bench_fec
    from gr_dtl_tpu_torch.utils import alist
    bank = ldpc.bank_from_reference(ldpc.build_ldpc_bank(
        [alist.load_alist(str(bench_fec.ROOT / "examples" / SHIPPED_ALISTS[i % 3])) for i in range(n)]), dev)
    rng = np.random.RandomState(seed)
    return torch.as_tensor((rng.randn(codewords, bank.Nmax) * 1.2 + 1.8).astype(np.float32), device=dev), bank


def k8_sets(dev, seed: int = 0) -> dict:
    """Phase 30's sets (chip_smoke.py), drawn as it draws them: {name: (llr,
    code or bank, code ids or None, max_iters)}: the n=300 code's 2048
    codewords in each of ``REGIMES``, the knee at max_iters 0 and with no
    noise (done at entry), the 33-code step at 25 and 11 dB, banks of 2 to
    32 copies and of 2, 8 and 32 distinct codes with noise, and ids past
    either end of the 8-code bank's."""
    import numpy as np
    code, regimes = regime_inputs(dev)
    sets = {f"2048 {k}": (x, code, None, 15) for k, x in regimes.items()}
    sets["2048 knee, max_iters 0"] = (regimes["knee"], code, None, 0)
    sets["2048 noiseless"] = (torch.where(regimes["clean"] > 0, 4.0, -4.0).contiguous(), code, None, 15)
    bank, steps = bank_step_inputs(dev, seed=seed)
    sets.update({k: (x, bank, idx, 15) for k, (x, idx) in steps.items()})
    for n, (x, idx, b) in bank_inputs(dev).items():
        if n > 1:
            sets[f"bank of {n} copies, 1024 codewords"] = (x, b, idx, 15)
    for n in (2, 8, 32):
        x, b = distinct_bank(n, dev, 1024, seed + 30 + n)
        idx = torch.as_tensor(np.random.RandomState(n).randint(1, n + 1, 1024).astype(np.int32), device=dev)
        sets[f"bank of {n} distinct codes, noisy, 1024 codewords"] = (x, b, idx, 15)
        if n == 8:
            wild = np.random.RandomState(30).randint(-n - 3, n + 4, 1024).astype(np.int64)
            wild[:2 * n + 7] = np.arange(-n - 3, n + 4)
            sets["bank of 8 distinct codes, ids in [-11, 11]"] = (x, b, torch.as_tensor(wild, device=dev), 15)
    return sets


def gather_calls(sets: dict) -> dict:
    """K8's call and its plain version's on each of ``sets`` (:func:`k8_sets`'s
    layout): ``ldpc.decode`` on a code's, ``ldpc.decode_bank`` on a bank's
    ({set: (K8's call, _bp_gather's call)})."""
    def pair(x, src, idx, max_iters):
        if idx is None:
            return (lambda: ldpc.decode(x, src, max_iters),
                    lambda: ldpc._bp_gather(x, *ldpc._gather_tables(src, None), max_iters))
        return (lambda: ldpc.decode_bank(x, idx, src, max_iters),
                lambda: ldpc._bp_gather(x, *ldpc._gather_tables(src, idx), max_iters))

    return {k: pair(*v) for k, v in sets.items()}


def time_gather(dev) -> dict:
    """``--form gather --time``: {set of :func:`k8_sets`: K8's and
    _bp_gather's times, K8's iterations and launches a call}.  It calls only
    the decoders' public functions (and ``_bp_gather``), so it times the
    checkout first on the path."""
    rows = {}
    for k, (k8, plain) in gather_calls(k8_sets(dev)).items():
        n0 = ldpc_cuda.bp_gather_cuda.LAUNCHES
        _, it, ok = k8()
        launches = ldpc_cuda.bp_gather_cuda.LAUNCHES - n0
        t = in_turns({"plain": plain, "k8": k8}, {"plain": 3, "k8": 20}, {"k8": launches},
                     kernel=FORMS["gather"][0])
        rows[k] = {"codewords": it.numel(), "mean_iters": it.float().mean().item(), "updates": int(it.sum()),
                   "ok_rate": ok.float().mean().item(), "launches": launches,
                   "ms": median(t["k8"]["events"]), "device_ms": median(t["k8"]["device"]),
                   "plain_ms": median(t["plain"]["events"]), "ms_windows": t["k8"]["events"],
                   "device_ms_windows": t["k8"]["device"], "plain_ms_windows": t["plain"]["events"]}
        print(f"{k}: {rows[k]}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# --dump and --same-as: K8 bit for bit against another checkout's
# ---------------------------------------------------------------------------

def bound_like_build(lib):
    """``lib`` (a build of the checkout's source with text written in) with
    the argument types the checkout's own ``ldpc_cuda.build`` gives its
    entry points, so that the checkout's wrappers can launch it."""
    ref = ldpc_cuda.build()
    for name in ("bp_decode_launch", "bp_gather_launch", "bp_resident_codewords"):
        if hasattr(ref, name):
            fn, like = getattr(lib, name), getattr(ref, name)
            fn.argtypes, fn.restype = like.argtypes, like.restype
    return lib


@contextlib.contextmanager
def launching(lib):
    """ldpc_cuda's wrappers launching the kernels of ``lib`` (a build of this
    source or of a variant of it, :func:`bound_like_build`)."""
    saved = ldpc_cuda.build
    ldpc_cuda.build = lambda: lib
    try:
        yield
    finally:
        ldpc_cuda.build = saved


def k8_of(lib, llr, src, code_idx, max_iters: int) -> tuple:
    """(hard, iters, ok) of the K8 of ``lib`` on one set, through the
    public ``ldpc.decode`` (a code's set) or ``ldpc.decode_bank`` (a bank's)."""
    with launching(lib):
        if code_idx is None:
            return ldpc.decode(llr, src, max_iters)
        return ldpc.decode_bank(llr, code_idx, src, max_iters)


def rows_differ(a: tuple, b: tuple) -> int:
    """Rows whose hard bits, iterations or ok differ in any bit."""
    return int(((a[0] != b[0]).any(1) | (a[1] != b[1]) | (a[2] != b[2])).sum())


def digest(*tensors) -> str:
    """A hash of tensors' values (None for an absent one), to tell that two
    processes drew the same inputs."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(b"-" if t is None else t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def gather_outputs(dev) -> dict:
    """K8 of the checkout on the path on :func:`k8_sets`, through its public
    functions: {set: {"inputs": :func:`digest` of the LLRs and ids,
    "hard", "iters", "ok": on the CPU}}."""
    out = {}
    for name, (x, src, idx, max_iters) in k8_sets(dev).items():
        got = ldpc.decode(x, src, max_iters) if idx is None else ldpc.decode_bank(x, idx, src, max_iters)
        out[name] = {"inputs": digest(x, idx), **{k: v.cpu() for k, v in zip(("hard", "iters", "ok"), got)}}
    return out


def compare_outputs(mine: dict, theirs: dict) -> dict:
    """{set: rows that differ in any bit of hard, iters or ok} between two
    :func:`gather_outputs`; a set missing from either, or drawn from other
    inputs, raises."""
    if set(mine) != set(theirs):
        raise ValueError(f"the two runs hold other sets: {sorted(set(mine) ^ set(theirs))}")
    out = {}
    for name, a in mine.items():
        b = theirs[name]
        if a["inputs"] != b["inputs"]:
            raise ValueError(f"{name}: the two runs drew other inputs")
        out[name] = rows_differ(*[tuple(r[k] for k in ("hard", "iters", "ok")) for r in (a, b)])
    return out


def same_as(dev, dump: Path) -> dict:
    """K8 of this checkout against the outputs ``--dump`` saved from another
    (``PYTHONPATH=<checkout> python3 gr_dtl_tpu_torch/tools/bench_k3.py
    --form gather --dump FILE``) on :func:`k8_sets`: {set: rows that differ
    in any bit of hard, iters or ok}."""
    out = compare_outputs(gather_outputs(dev), torch.load(dump))
    for name, n in out.items():
        print(f"[same-as] {name}: {n} rows differ from {dump} in any bit", flush=True)
    return out


def written(subs, tag: str) -> str:
    """This source's text with each (old, new) of ``subs`` written in, in
    order (every ``old`` must be there when its turn comes)."""
    text = ldpc_cuda.SOURCE.read_text()
    for old, new in subs:
        if old not in text:
            raise ValueError(f"{tag}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def variant_source(subs, tag: str) -> Path:
    """:func:`written` saved into ``_build/`` beside the libraries."""
    text = written(subs, tag)
    src = _cuda_build.BUILD_DIR / f"ldpc_bp_{tag}_{hashlib.sha256(text.encode()).hexdigest()[:16]}.cu"
    _cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    return src


def variant_library(subs, tag: str):
    """The kernel library of :func:`variant_source`, built and bound as the
    checkout binds its own."""
    return bound_like_build(_cuda_build.load(variant_source(subs, tag), ldpc_cuda.NVCC_FLAGS))


# ---------------------------------------------------------------------------
# --variants: K8's design choices, each against the alternative it beat
# ---------------------------------------------------------------------------

# The tail (step 1's timeline: codewords that take 15 updates, started late in the walk, run on
# alone): a walk in two passes.  Pass 1 takes every codeword from a counter (the first too, so that no
# codeword waits on a block not yet resident) and makes its first syndrome pass; a codeword that
# fails it is not decoded then but listed by its count of odd checks (16 or more, 8-15, 3-7, 1-2).
# A block that finds pass 1's codewords all taken waits until every one has been checked, then takes
# the listed codewords, the most odd checks first, so that the longest start first and the last to
# start are short.  Its counters and lists are the library's own (device globals, 0 at load).
LPT_HEAD = r"""__device__ __forceinline__ int take(unsigned* work) { return gridDim.x + (int)atomicAdd(work, 1u); }
constexpr int kLptBuckets = 4, kLptMax = 1 << 17, kPass2 = 1 << 30, kLptMask = kPass2 - 1;
// pass-1 taken, pass-1 checked, blocks left; listed by bucket; taken by bucket
__device__ unsigned g_lpt[3 + 2 * kLptBuckets];
__device__ int g_lpt_list[kLptBuckets][kLptMax];
__device__ __forceinline__ int lpt_bucket(int w) { return w >= 16 ? 0 : w >= 8 ? 1 : w >= 3 ? 2 : 3; }
__device__ __forceinline__ int lpt_take1(int B) {
    const unsigned t = atomicAdd(&g_lpt[0], 1u);
    return t < (unsigned)B ? (int)t : -1;
}
// thread 0: the next codeword (a listed one with kPass2 set), or B to leave; once pass 1's codewords
// are all taken, adds the block's checked ones (c1) to the count and waits for every one to be checked
__device__ __noinline__ int lpt_next(int B, unsigned* c1) {
    const int t = lpt_take1(B);
    if (t >= 0) return t;
    if (*c1) {
        __threadfence();  // the block's listings seen before its count
        atomicAdd(&g_lpt[1], *c1);
        *c1 = 0;
    }
    volatile unsigned* w = g_lpt;
    for (unsigned ns = 128; w[1] < (unsigned)B; ns = min(2 * ns, 2048u)) __nanosleep(ns);  // few polls of one line
    unsigned n[kLptBuckets], got[kLptBuckets];  // read at once: one round trip
#pragma unroll
    for (int q = 0; q < kLptBuckets; ++q) {
        n[q] = w[3 + q];
        got[q] = w[3 + kLptBuckets + q];
    }
#pragma unroll
    for (int q = 0; q < kLptBuckets; ++q) {
        if (got[q] >= n[q]) continue;
        const unsigned i = atomicAdd(&g_lpt[3 + kLptBuckets + q], 1u);
        if (i < n[q]) return __ldcg(&g_lpt_list[q][i]) | kPass2;
    }
    return B;
}
template <int kSlots>
__device__ __forceinline__ int syndrome_weight(int M, int dc, const int16_t* chk_vars, const float* v, int tid,
                                               int nt) {
    int odd = 0;
    for (int c = tid; c < M; c += nt) {
        int p = 0;
#pragma unroll
        for (int r = 0; r < kSlots; ++r) {
            if (kSlots > kRegSlots && r >= dc) break;
            p ^= v[chk_vars[r * M + c]] < 0.0f;
        }
        odd += p;
    }
    return __syncthreads_count(odd != 0);
}
"""
LPT = (
    ("__device__ __forceinline__ int take(unsigned* work) { return gridDim.x + (int)atomicAdd(work, 1u); }\n",
     LPT_HEAD),
    ("    for (int b = blockIdx.x; b < B; ++k) {\n"
     "        int taken = B;  // thread 0: the block's next codeword, taken now, so a block holds two at most\n"
     "        if (tid == 0 && walk && early) taken = take(work);\n",
     "    int first = blockIdx.x;\n"
     "    unsigned c1 = 0;  // thread 0: the pass-1 codewords this block checked, not yet counted\n"
     "    if (walk) {\n"
     "        if (tid == 0) next[1] = lpt_next(B, &c1);\n"
     "        __syncthreads();\n"
     "        first = next[1];\n"
     "    }\n"
     "    for (int bx = first; (bx & kLptMask) < B; ++k) {\n"
     "        const int b = bx & kLptMask;\n"
     "        const bool pass2 = (bx & kPass2) != 0;\n"
     "        int taken = -1;\n"
     "        if (tid == 0 && walk && !pass2) taken = lpt_take1(B);\n"),
    ("        bool ok = syndrome_ok<kSlots>(M, dc, tab + h[6], lr, tid, nt);\n"
     "        if (!ok && max_iters > 0) {\n",
     "        const int weight = pass2 ? 1 : syndrome_weight<kSlots>(M, dc, tab + h[6], lr, tid, nt);\n"
     "        bool ok = weight == 0;\n"
     "        const bool defer = walk && !pass2 && !ok && max_iters > 0;\n"
     "        if (defer && tid == 0) {\n"
     "            const int q = lpt_bucket(weight);\n"
     "            g_lpt_list[q][atomicAdd(&g_lpt[3 + q], 1u)] = b;\n"
     "        }\n"
     "        if (!ok && max_iters > 0 && !defer) {\n"),
    ("        const float* out = it == 0 ? lr : total;\n"
     "        int* hard_row = hard + (long long)b * N;\n"
     "        for (int v = tid; v < N; v += nt) hard_row[v] = out[v] < 0.0f;\n"
     "        if (tid == 0) {\n"
     "            iters[b] = it;\n"
     "            ok_out[b] = ok;\n"
     "            if (walk && !early) next[k & 1] = take(work);  // after a codeword with updates: taken at the end\n"
     "        }\n"
     "        early = it == 0;\n"
     "        __syncthreads();  // the next codeword is known, and every thread is done with this one's row and totals\n"
     "        b = next[k & 1];\n",
     "        const float* out = it == 0 ? lr : total;\n"
     "        int* hard_row = hard + (long long)b * N;\n"
     "        if (!defer)\n"
     "            for (int v = tid; v < N; v += nt) hard_row[v] = out[v] < 0.0f;\n"
     "        if (tid == 0) {\n"
     "            if (!defer) {\n"
     "                iters[b] = it;\n"
     "                ok_out[b] = ok;\n"
     "            }\n"
     "            if (walk) {\n"
     "                c1 += !pass2;\n"
     "                if (next[k & 1] < 0) next[k & 1] = lpt_next(B, &c1);\n"
     "            }\n"
     "        }\n"
     "        early = it == 0;\n"
     "        __syncthreads();\n"
     "        bx = next[k & 1];\n"),
    ("    if (tid == 0 && walk) {\n        atomicAdd(work + 2, (unsigned)k);\n",
     "    if (tid == 0 && walk && atomicAdd(&g_lpt[2], 1u) == gridDim.x - 1) {\n"
     "        for (int q = 0; q < 3 + 2 * kLptBuckets; ++q) g_lpt[q] = 0;\n"
     "        __threadfence();\n"
     "    }\n"
     "    if (false) {\n        atomicAdd(work + 2, (unsigned)k);\n"),
    # a walking kernel of its own (kWalk), so that a launch of a block a codeword runs none of the above
    ("template <int kSlots>\n__global__ void __maxnreg__(kSlots <= kRegSlots ? kGatherRegs : 255) bp_gather_kernel(",
     "template <int kSlots, bool kWalk>\n__global__ void __maxnreg__(kSlots <= kRegSlots ? kGatherRegs : 255) "
     "bp_gather_kernel("),
    ("    const bool walk = B > (int)gridDim.x;  // else a block a codeword, and no counter\n",
     "    constexpr bool walk = kWalk;\n"),
    ("GatherKernel pick_gather(int dc) {\n    switch (dc) {\n"
     + "".join(f"        case {d}: return bp_gather_kernel<{d}>;\n" for d in range(1, 9))
     + "        default: return bp_gather_kernel<kMaxDeg>;\n",
     "GatherKernel pick_gather(int dc, bool walk = false) {\n    switch (dc) {\n"
     + "".join(f"        case {d}: return walk ? bp_gather_kernel<{d}, true> : bp_gather_kernel<{d}, false>;\n"
               for d in range(1, 9))
     + "        default: return walk ? bp_gather_kernel<kMaxDeg, true> : bp_gather_kernel<kMaxDeg, false>;\n"),
    ("constexpr int kForms = 3;", "constexpr int kForms = 4;"),
    ("    const GatherKernel kernel = pick_gather(dc);\n"
     "    const int wave = gather_grid(kernel, dc, smem, warps);\n"
     "    if (wave < 0) return -wave;\n"
     "    const int grid = B < kWalkWaves * wave ? B : wave;\n",
     "    const int wave = gather_grid(pick_gather(dc), dc, smem, warps);\n"
     "    if (wave < 0) return -wave;\n"
     "    const int grid = B < kWalkWaves * wave ? B : wave;\n"
     "    const GatherKernel kernel = pick_gather(dc, grid < B);\n"
     "    if (grid < B) {\n"
     "        const cudaError_t e = prepare(kernel, 3, dc, smem);\n"
     "        if (e != cudaSuccess) return (int)e;\n"
     "    }\n"),
)

# name: the source's text and what the alternative writes in its place
VARIANTS = {
    "a block a codeword at every B (the first kernel's)": (("    const int grid = B < kWalkWaves * wave ? B : wave;",
                                                 "    const int grid = B;"),),
    "blocks walking codewords at every B": (("    const int grid = B < kWalkWaves * wave ? B : wave;",
                                             "    const int grid = B < wave ? B : wave;"),),
    "the next codeword taken at every codeword's start": (
        ("        if (tid == 0 && walk && early) taken = take(work);",
         "        if (tid == 0 && walk) taken = take(work);"),
        ("            if (walk && !early) next[k & 1] = take(work);  // after a codeword with updates: taken at the end\n",
         "")),
    "the first pass's table staged first": (
        ("        bool ok = syndrome_ok<kSlots>(M, dc, tab + h[6], lr, tid, nt);\n",
         "        const int16_t* cvs = stage_table(staged, tab + h[6], dc * M, tid, nt);\n"
         "        copy_commit();\n        copy_wait_all();\n        __syncthreads();\n"
         "        bool ok = syndrome_ok<kSlots>(M, dc, cvs, lr, tid, nt);\n"),),
    "the tables read from global memory (the first kernel's)": (
        ("    for (int w = tid; w < words; w += nt) copy4(dst + 2 * w, from + 2 * w);\n"
         "    if (((n + shift) & 1) && tid == nt - 1) dst[n + shift - 1] = src[n - 1];\n"
         "    return dst + shift;\n", "    return src;\n"),),
    "the first pass on totals made first (the first kernel's)": (
        ("        bool ok = syndrome_ok<kSlots>(M, dc, tab + h[6], lr, tid, nt);\n",
         "        for (int v = tid; v < N; v += nt) total[v] = __fadd_rn(lr[v], 0.0f);\n"
         "        if (tid == 0) total[N] = 0.0f;\n"
         "        __syncthreads();\n"
         "        bool ok = syndrome_ok<kSlots>(M, dc, tab + h[6], total, tid, nt);\n"),),
    "the row read by loads into registers (the first kernel's)": (
        ("        for (int q = tid; q < N / 4; q += nt) copy16(row + 4 * q, src + 4 * q);\n",
         "        for (int q = tid; q < N / 4; q += nt)\n"
         "            reinterpret_cast<float4*>(row)[q] = reinterpret_cast<const float4*>(src)[q];\n"),
        ("        for (int v = tid; v < N; v += nt) copy4(row + v, src + v);\n",
         "        for (int v = tid; v < N; v += nt) row[v] = src[v];\n")),
    "the registers the compiler picks (the first kernel's launch bounds)": (
        ("__maxnreg__(kSlots <= kRegSlots ? kGatherRegs : 255) bp_gather_kernel(",
         "__launch_bounds__(kMaxThreads, kSlots <= kRegSlots ? kMinBlocks : 1) bp_gather_kernel("),),
    "the tail: two passes, the codewords that take updates after the first, most odd checks first": LPT,
}
VARIANT_SETS = ("33-code step 25 dB", "33-code step 11 dB", "2048 clean", "2048 knee", "2048 waterfall",
                "bank of 8 copies, 1024 codewords", "bank of 8 distinct codes, noisy, 1024 codewords")


def variants(dev, reps: int = 20) -> dict:
    """Each variant of ``VARIANTS`` against the source as it is on
    ``VARIANT_SETS`` (through ``ldpc._decode_gather``): rows that differ in
    any bit from the source's K8 (must be 0), and device times in turns (the
    source, each variant, each variant again in the reverse order, the
    source): {set: {name: [ms, ms]}}."""
    from concurrent.futures import ThreadPoolExecutor
    sources = [variant_source(subs, "variant") for subs in VARIANTS.values()]
    with ThreadPoolExecutor(max_workers=len(VARIANTS) + 1) as pool:  # an nvcc each, side by side
        built = list(pool.map(lambda src: _cuda_build.load(src, ldpc_cuda.NVCC_FLAGS) if src else ldpc_cuda.build(),
                              [None] + sources))
    libs = {"as built": built[0], **{name: bound_like_build(lib) for name, lib in zip(VARIANTS, built[1:])}}
    sets = k8_sets(dev)
    out = {}
    for key in VARIANT_SETS:
        x, src, idx, max_iters = sets[key]
        want = k8_of(libs["as built"], x, src, idx, max_iters)

        def call(lib):
            with launching(lib):
                return ldpc._decode_gather(x, src, max_iters, idx)

        out[key] = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            got = call(libs[name])
            torch.cuda.synchronize()
            if rows_differ(got, want):
                raise RuntimeError(f"variant {name!r} on {key}: {rows_differ(got, want)} rows differ")
            out[key][name].append(device_ms(lambda: call(libs[name]), 1, reps, FORMS["gather"][0]))
        print(f"[variants] {key}: " + "; ".join(f"{n} {[round(v, 4) for v in t]} ms" for n, t in out[key].items()),
              flush=True)
    return out


# ---------------------------------------------------------------------------
# --timeline: K8 with each codeword's clock marks
# ---------------------------------------------------------------------------

# a record a codeword: its start, its first barrier and its end (%globaltimer, ns), and
# %smid << 32 | the updates it took; set by bp_timeline_set, written by thread 0
TIMELINE_HEAD = r"""#include <stdint.h>
__device__ unsigned long long* g_timeline;
__device__ __forceinline__ unsigned long long timeline_now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
__device__ __forceinline__ void timeline_put(long long b, unsigned long long t0, unsigned long long t1, int it) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    unsigned long long* r = g_timeline + 4 * b;
    r[0] = t0;
    r[1] = t1;
    r[2] = timeline_now();
    r[3] = ((unsigned long long)sm << 32) | (unsigned)it;
}
extern "C" int bp_timeline_set(void* p) { return (int)cudaMemcpyToSymbol(g_timeline, &p, sizeof(p)); }
"""
# where the marks go: in this source's K8 (blocks walking codewords) and in the first K8's (a block a
# codeword, the frame it shared with K3: run the file with that checkout first on the path)
TIMELINES = {
    "walking": (
        ("#include <stdint.h>\n", TIMELINE_HEAD),
        ("    for (int b = blockIdx.x; b < B; ++k) {\n",
         "    for (int b = blockIdx.x; b < B; ++k) {\n        const unsigned long long tl0 = timeline_now();\n"),
        ("        __syncthreads();  // the row is in, and the block's next codeword\n",
         "        __syncthreads();  // the row is in, and the block's next codeword\n"
         "        const unsigned long long tl1 = timeline_now();\n"),
        ("            iters[b] = it;\n            ok_out[b] = ok;\n",
         "            iters[b] = it;\n            ok_out[b] = ok;\n            timeline_put(b, tl0, tl1, it);\n")),
    "two passes (the tail variant)": (
        ("#include <stdint.h>\n", TIMELINE_HEAD),
        ("        const bool pass2 = (bx & kPass2) != 0;\n",
         "        const bool pass2 = (bx & kPass2) != 0;\n        const unsigned long long tl0 = timeline_now();\n"),
        ("        __syncthreads();  // the row is in, and the block's next codeword\n",
         "        __syncthreads();  // the row is in, and the block's next codeword\n"
         "        const unsigned long long tl1 = timeline_now();\n"),
        ("                iters[b] = it;\n                ok_out[b] = ok;\n",
         "                iters[b] = it;\n                ok_out[b] = ok;\n                timeline_put(b, tl0, tl1, it);\n")),
    "a block a codeword": (
        ("#include <stdint.h>\n", TIMELINE_HEAD),
        ("    const long long b = blockIdx.x;\n", "    const long long b = blockIdx.x;\n"
                                                  "    const unsigned long long tl0 = timeline_now();\n"),
        ("        c2v[E] = 0.0f;\n    }\n    __syncthreads();\n",
         "        c2v[E] = 0.0f;\n    }\n    __syncthreads();\n    const unsigned long long tl1 = timeline_now();\n"),
        ("        ok_out[b] = ok;\n    }\n", "        ok_out[b] = ok;\n        if constexpr (kTanh) timeline_put(b, tl0, tl1, it);\n"
                                           "    }\n")),
}


def timeline_library(variant: str | None = None):
    """The K8 of the checkout on the path, or its variant of ``VARIANTS``
    so named, with the clock marks of ``TIMELINES`` written in (the frame
    whose anchors its text holds), bound as that checkout binds its own."""
    subs = tuple(VARIANTS[variant]) if variant else ()
    text = written(subs, "timeline")
    for frame, marks in TIMELINES.items():
        if all(old in text for old, _ in marks):
            return frame, variant_library(subs + tuple(marks), "timeline")
    raise ValueError("the source holds no frame's anchors of TIMELINES")


def timeline_summary(rec, max_iters: int = 15, sms: int = SMS) -> dict:
    """What a run's records ([B, 4] int64: start, first barrier, end ns,
    smid << 32 | updates) say: the kernel's span (first start to last end);
    the tail, the share of the span in which fewer than half of ``sms`` SMs
    hold a codeword (an SM holds one from a start to its end); a codeword's
    mean life (end - start) by its updates (0, 1 to max_iters - 1, and
    max_iters), and their counts; the mean prologue (start to the first
    barrier); the smallest step of the clock seen."""
    import numpy as np
    rec = np.asarray(rec, np.int64)
    t0, t1, t2 = rec[:, 0], rec[:, 1], rec[:, 2]
    sm, it = rec[:, 3] >> 32, rec[:, 3] & 0xFFFFFFFF
    start, end = int(t0.min()), int(t2.max())
    # SMs busy over time: each SM's intervals merged, then +1 / -1 at the edges, swept in order
    edges = []
    for s in np.unique(sm):
        order = np.argsort(t0[sm == s])
        a, z = t0[sm == s][order], t2[sm == s][order]
        lo, hi = int(a[0]), int(z[0])
        for x, y in zip(a[1:], z[1:]):
            if x > hi:
                edges += [(lo, 1), (hi, -1)]
                lo, hi = int(x), int(y)
            else:
                hi = max(hi, int(y))
        edges += [(lo, 1), (hi, -1)]
    edges.sort()
    tail, busy, at = 0, 0, start
    for t, d in edges:
        if busy < sms / 2:
            tail += t - at
        busy, at = busy + d, t
    tail += end - at  # nothing is busy after the last edge
    life = lambda m: float((t2 - t0)[m].mean()) if m.any() else None
    classes = {"0": it == 0, f"1-{max_iters - 1}": (it > 0) & (it < max_iters), str(max_iters): it == max_iters}
    steps = np.diff(np.unique(np.concatenate([t0, t1, t2])))
    return {"codewords": int(rec.shape[0]), "span_ns": end - start, "tail_ns": tail, "tail_share": tail / (end - start),
            "sms_used": int(len(np.unique(sm))), "life_ns": {k: life(m) for k, m in classes.items()},
            "count": {k: int(m.sum()) for k, m in classes.items()}, "prologue_ns": float((t1 - t0).mean()),
            "clock_step_ns": int(steps.min()) if steps.size else 0}


TIMELINE_SETS = ("33-code step 25 dB", "33-code step 11 dB", "2048 knee", "2048 waterfall")


def timeline(dev, variant: str | None = None) -> dict:
    """``--timeline``: K8 (or a variant of ``VARIANTS``) with clock marks
    (:func:`timeline_library`) on ``TIMELINE_SETS``, each after a warm-up
    call: {set: :func:`timeline_summary`}."""
    frame, lib = timeline_library(variant)
    sets = k8_sets(dev)
    out = {"frame": frame, "variant": variant}
    for name in TIMELINE_SETS:
        x, src, idx, max_iters = sets[name]
        rec = torch.zeros((x.shape[0], 4), dtype=torch.int64, device=dev)
        rc = lib.bp_timeline_set(ctypes.c_void_p(rec.data_ptr()))
        if rc:
            raise RuntimeError(f"bp_timeline_set failed: CUDA error {rc}")
        k8_of(lib, x, src, idx, max_iters)
        got = k8_of(lib, x, src, idx, max_iters)
        torch.cuda.synchronize()
        if rows_differ(got, k8_of(ldpc_cuda.build(), x, src, idx, max_iters)):
            raise RuntimeError(f"the timeline's K8 parts from the source's on {name}")
        out[name] = timeline_summary(rec.cpu().numpy(), max_iters)
        print(f"[timeline] {name}: {out[name]}", flush=True)
    return out


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(prog="python3 -m gr_dtl_tpu_torch.tools.bench_k3")
    p.add_argument("--form", choices=sorted(FORMS), default="k3",
                   help="the kernel: K3 (decode_mm, decode_bank_mm) or K8, the gather form (decode, decode_bank)")
    p.add_argument("--time", action="store_true",
                   help="time the decoders instead of counting the kernel's SASS: K3's decoders of the "
                        "gr_dtl_tpu_torch on the path, or K8 against _bp_gather")
    p.add_argument("--dump", default=None, metavar="DUMP",
                   help="K8 only: save K8's outputs on phase 30's sets (run with another checkout first on the path)")
    p.add_argument("--same-as", default=None, metavar="DUMP",
                   help="K8 only: hold this checkout's K8 bit for bit to the outputs --dump saved")
    p.add_argument("--variants", action="store_true",
                   help="K8 only: time the design's choices against the alternatives of VARIANTS, in turns")
    p.add_argument("--timeline", action="store_true",
                   help="K8 only: each codeword's clock marks on four sets, and what they say")
    p.add_argument("--variant", default=None, choices=sorted(VARIANTS),
                   help="with --timeline: the marks in this variant of VARIANTS instead of the source")
    p.add_argument("--out", default=None, help="write the result as JSON")
    args = p.parse_args(argv)
    if (args.dump or args.same_as or args.variants or args.timeline) and args.form != "gather":
        p.error("--dump, --same-as, --variants and --timeline read K8: add --form gather")
    dev = torch.device("cuda")
    res = {"device": smi("name,power.limit"), "package": str(Path(ldpc.__file__).parents[1]), "form": args.form}
    if args.dump:
        torch.save(gather_outputs(dev), args.dump)
        res["dump"] = args.dump
    elif args.same_as:
        res["same_as"] = same_as(dev, Path(args.same_as))
    elif args.variants:
        res["variants"] = variants(dev)
    elif args.timeline:
        res["timeline"] = timeline(dev, args.variant)
    elif args.time:
        res["ms"] = time_gather(dev) if args.form == "gather" else time_decoders(dev)
    else:
        code, _ = regime_inputs(dev, n=1)
        ldpc_cuda.build()
        res.update(clocks_max_sm_mhz=sm_clock_mhz(), ptxas=ptxas_lines(ldpc_cuda.library_path()),
                   sass=kernel_counts(ldpc_cuda.library_path(), args.form),
                   resident_codewords_per_sm=ldpc_cuda.resident_codewords(code.graph, gather=args.form == "gather"),
                   warps=ldpc_cuda.warps_for(code.graph))
    print(json.dumps(res, indent=1))
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
