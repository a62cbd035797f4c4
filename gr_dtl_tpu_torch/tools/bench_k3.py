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
(``ldpc.decode`` on the 2048-codeword regimes, ``ldpc.decode_bank`` on the
banks) against its plain version ``_bp_gather`` on the same inputs, in
turns.

Run on the card:  python3 -m gr_dtl_tpu_torch.tools.bench_k3 [--form k3|gather] [--time] [--out FILE]
  or, for another checkout at DIR:
  PYTHONPATH=DIR python3 gr_dtl_tpu_torch/tools/bench_k3.py --time [--out FILE]
"""

from __future__ import annotations

import argparse
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
    the barriers of the loop of updates that holds them."""
    regions = [(lo, hi) for lo, hi in loops(instrs) if _count(instrs, lo, hi)["mufu"]]
    inner = [r for r in regions if not any(o != r and r[0] <= o[0] and o[1] <= r[1] for o in regions)]
    skips = {r: skipped(instrs, *r) for r in inner}
    tot = {k: sum(_count(instrs, lo, hi, skips[(lo, hi)])[k] for lo, hi in inner) for k in _count(instrs, 0, 0)}
    if not tot["ex2"]:
        raise ValueError("no loop evaluates MUFU.EX2: not a BP kernel's SASS")
    per_edge = {k: ex2_per_edge * tot[k] / tot["ex2"] for k in ("instructions", "mufu", "lds", "sts")}
    outer = [r for r in loops(instrs) if r not in inner and any(r[0] <= i[0] and i[1] <= r[1] for i in inner)]
    lo, hi = max(outer, key=lambda r: r[1] - r[0]) if outer else (0, len(instrs) - 1)
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
    the calls ran, summed, over the calls the profiler saw, counted as
    ``kernel``'s launches over ``per_call`` (its launches a call).  Events
    time the host's enqueue where a call's kernels take less than it; the
    profiler drops some launches, so its sum over ``reps`` reads low, while
    this ratio holds.  A window that saw no ``kernel`` is taken again, twice."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        avgs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        seen = sum(e.count for e in avgs if kernel in e.key)
        if seen:
            return sum(e.self_device_time_total for e in avgs) * per_call / seen / 1e3
    raise RuntimeError(f"the profiler saw no {kernel} in three windows")


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


def gather_calls(dev) -> dict:
    """K8's inputs, each with K8's call and its plain version's: ``ldpc.decode``
    on the 2048-codeword regimes, ``ldpc.decode_bank`` on the banks of
    :func:`bank_inputs` ({input: (K8's call, _bp_gather's call)})."""
    code, regimes = regime_inputs(dev)
    calls = {f"2048 {k}": (lambda x=x: ldpc.decode(x, code),
                           lambda x=x: ldpc._bp_gather(x, *ldpc._gather_tables(code, None), 15))
             for k, x in regimes.items()}
    calls.update({f"bank of {n} codes, 1024 codewords": (
        lambda a=a: ldpc.decode_bank(*a), lambda a=a: ldpc._bp_gather(a[0], *ldpc._gather_tables(a[2], a[1]), 15))
        for n, a in bank_inputs(dev).items()})
    return calls


def time_gather(dev) -> dict:
    """``--form gather --time``: {input: K8's and _bp_gather's times, K8's
    iterations and launches a call}."""
    rows = {}
    for k, (k8, plain) in gather_calls(dev).items():
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


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(prog="python3 -m gr_dtl_tpu_torch.tools.bench_k3")
    p.add_argument("--form", choices=sorted(FORMS), default="k3",
                   help="the kernel: K3 (decode_mm, decode_bank_mm) or K8, the gather form (decode, decode_bank)")
    p.add_argument("--time", action="store_true",
                   help="time the decoders instead of counting the kernel's SASS: K3's decoders of the "
                        "gr_dtl_tpu_torch on the path, or K8 against _bp_gather")
    p.add_argument("--out", default=None, help="write the result as JSON")
    args = p.parse_args(argv)
    dev = torch.device("cuda")
    res = {"device": smi("name,power.limit"), "package": str(Path(ldpc.__file__).parents[1]), "form": args.form}
    if args.time:
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
