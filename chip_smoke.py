"""Smoke run of the PyTorch port (gr_dtl_tpu_torch) on one NVIDIA GPU.

Drives the port's main path, the uncoded batch modem, at the size its
users run it: B=2048 frames of frame_length 20 (1840 samples each, a
3.77 Msample complex64 stream), mixed constellations 1..4, AWGN of
noise voltage 0.02.  Phases:

1. device: the card's name and power limit, torch/CUDA versions, and
   whether nvcc and triton are present;
2. build: compiles csrc/sync_metric.cu for sm_90a from this checkout;
3. kernel vs plain: the CUDA Schmidl-Cox kernel against its plain
   PyTorch version on the card, at the main path's N, at two ragged
   lengths and on a [4, N] batch (atol 2e-4 on P, 2e-3 on M);
4. slice: TX -> AWGN -> detect_and_extract -> rx_frames; every frame's
   CRC must pass with its payload equal to what was sent, the kernel
   must have been launched, and a 16-frame run must agree with the
   port's CPU path;
5. timing with CUDA events: the RX step (median/min/max over 7
   windows), a per-stage split, and the kernel against the plain metric.

Run from the repo root, with one CUDA device:  python3 chip_smoke.py
The last line of standard output is {"ok": true, "device": {...}}; any
failure exits non-zero before it.
"""

import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gr_dtl_tpu_torch.models import receiver, transmitter
from gr_dtl_tpu_torch.ops import channel, constellation as cn, sync, sync_cuda
from gr_dtl_tpu_torch.utils import config as cfgmod

B = 2048
FRAME_LENGTH = 20
NOISE_V = 0.02
SEED = 0
STREAM_TAIL = 2048  # zeros after the last frame, so its window never clips
P_ATOL, M_ATOL = 2e-4, 2e-3  # the reference's bars (tests/test_sync_pallas.py)
WINDOWS, STEPS_PER_WINDOW = 7, 3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of fn over reps back-to-back calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_traffic(tcfg, n: int, dev, gen: torch.Generator):
    """n frames of mixed constellations 1..4 filled to capacity, drawn as
    bench.py draws them, and the padded, noisy stream carrying them."""
    rng = np.random.RandomState(SEED)
    maxb = tcfg.max_frame_bytes()
    cnst = rng.randint(1, 5, size=n).astype(np.int32)
    payload = np.zeros((n, maxb), np.uint8)
    plen = np.zeros(n, np.int32)
    for i in range(n):
        plen[i] = tcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[cnst[i]])) - 4
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    sent = {"payload": torch.as_tensor(payload, device=dev),
            "payload_len": torch.as_tensor(plen, device=dev),
            "cnst_id": torch.as_tensor(cnst, device=dev),
            "frame_no": torch.arange(n, device=dev, dtype=torch.int32) % 4096}
    pad = torch.randint(0, 256, (n, maxb), generator=gen, device=dev, dtype=torch.uint8)
    txp = transmitter.build_tx(tcfg, dev)
    out = transmitter.tx_frames(txp, sent["payload"], sent["payload_len"], sent["cnst_id"],
                                torch.zeros(n, dtype=torch.int32, device=dev),
                                sent["frame_no"], pad)
    s = torch.cat([out.samples.reshape(-1),
                   torch.zeros(STREAM_TAIL, dtype=torch.complex64, device=dev)])
    return channel.awgn(s, NOISE_V, generator=gen), sent


def rx_step(rxp, stream, n):
    frames, _ = receiver.detect_and_extract(stream, rxp.cfg, n)
    return receiver.rx_frames(rxp, frames)


def main() -> int:
    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    nvcc = shutil.which("nvcc") or ("/usr/local/cuda/bin/nvcc"
                                    if Path("/usr/local/cuda/bin/nvcc").is_file() else None)
    print(f"[device] {card}")
    print(f"[device] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc {nvcc or 'absent'}, "
          f"triton {'present' if importlib.util.find_spec('triton') else 'absent'}", flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    sync_cuda.build()
    print(f"[build] csrc/sync_metric.cu -> {sync_cuda.library_path().name} "
          f"in {time.perf_counter() - t0:.2f} s")
    log = sync_cuda.library_path().with_suffix(".log")
    for line in (log.read_text().splitlines() if log.exists() else []):
        if line.strip():
            print(f"[build] {line.strip()}")

    cfg = cfgmod.make_rx_config(None, frame_length=FRAME_LENGTH)
    tcfg = cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH)
    rxp = receiver.build_rx(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stream, sent = make_traffic(tcfg, B, dev, gen)
    n_main = stream.shape[0]
    print(f"[slice] B={B} frame_length={FRAME_LENGTH} frame_samples={cfg.frame_samples} "
          f"stream N={n_main}", flush=True)

    # ---- 3. kernel vs plain on the card ----
    cases = {"main": stream,
             "ragged_9000": torch.randn(9000, generator=gen, device=dev, dtype=torch.complex64),
             "ragged_8256": torch.randn(8256, generator=gen, device=dev, dtype=torch.complex64),
             "batch_4xN": torch.randn((4, n_main), generator=gen, device=dev, dtype=torch.complex64)}
    max_err = 0.0
    for name, r in cases.items():
        P, M = sync_cuda.timing_metric_cuda(r)
        P0, M0 = sync._timing_metric_torch(r)
        torch.cuda.synchronize()
        check(P.shape == P0.shape and M.shape == M0.shape, f"metric shape on {name}")
        dp = (P - P0).abs().max().item()
        dm = (M - M0).abs().max().item()
        print(f"[kernel] {name} {tuple(r.shape)}: max|dP|={dp:.3e} max|dM|={dm:.3e}")
        check(dp <= P_ATOL and dm <= M_ATOL, f"kernel vs plain on {name}: dP={dp} dM={dm}")
        max_err = max(max_err, dp, dm)
    del cases, P, M, P0, M0

    # ---- 4. the slice ----
    sync_cuda.timing_metric_cuda.LAUNCHES = 0
    out = rx_step(rxp, stream, B)
    torch.cuda.synchronize()
    launches = sync_cuda.timing_metric_cuda.LAUNCHES
    print(f"[slice] kernel launches in the slice: {launches}")
    check(launches > 0, "the slice did not launch the Schmidl-Cox kernel")
    n_ok = int(out.crc_ok.sum())
    print(f"[slice] crc_ok {n_ok}/{B}, header_ok {int(out.header_ok.sum())}/{B}, "
          f"snr_db median {out.snr_db.median().item():.2f}")
    check(n_ok == B, f"only {n_ok} of {B} frames passed their CRC")
    for k, v in sent.items():
        check(torch.equal(getattr(out, k), v), f"decoded {k} differs from what was sent")
    check(out.soft_syms.shape == (B, cfg.frame_capacity_symbols)
          and bool(torch.isfinite(out.soft_syms).all()) and bool(torch.isfinite(out.snr_db).all()),
          "soft symbols or SNR not finite or of the wrong shape")

    small, _ = make_traffic(tcfg, 16, dev, gen)
    got = rx_step(rxp, small, 16)
    want = rx_step(receiver.build_rx(cfg, "cpu"), small.cpu(), 16)
    for k in ("payload", "payload_len", "crc_ok", "header_ok", "frame_no", "cnst_id", "carr_offset"):
        check(torch.equal(getattr(got, k).cpu(), getattr(want, k)), f"16-frame {k}: card vs CPU")
    d_soft = (got.soft_syms.cpu() - want.soft_syms).abs().max().item()
    d_snr = (got.snr_db.cpu() - want.snr_db).abs().max().item()
    print(f"[slice] 16 frames, card vs CPU: ints equal, max|d soft|={d_soft:.2e} "
          f"max|d snr_db|={d_snr:.2e}")
    # float32 on both, summed and rounded in other orders: the bars of
    # tests/test_torch_receiver.py, loosened 10x for cuBLAS vs CPU matmuls
    check(d_soft <= 1e-3 and d_snr <= 5e-2, "16-frame soft symbols or SNR: card vs CPU")

    # ---- 5. timing ----
    n_samples = B * cfg.frame_samples
    for _ in range(3):
        rx_step(rxp, stream, B)
    torch.cuda.reset_peak_memory_stats()
    step_ms = sorted(cuda_ms(lambda: rx_step(rxp, stream, B), STEPS_PER_WINDOW)
                     for _ in range(WINDOWS))
    med = step_ms[len(step_ms) // 2]
    print(f"[timing] RX step (detect_and_extract + rx_frames), {WINDOWS} windows of "
          f"{STEPS_PER_WINDOW} steps: median {med:.3f} ms, min {step_ms[0]:.3f}, "
          f"max {step_ms[-1]:.3f}; {n_samples / med / 1e3:.2f} Msamples/s at the median; "
          f"all windows ms {[round(x, 3) for x in step_ms]}")
    print(f"[timing] peak device memory in the step: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    stages = {k: [] for k in ("metric", "detect_and_extract", "demodulate",
                              "equalize_passes", "demap_and_verify")}
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        sync.timing_metric(stream, cfg.fft_len)
        ev[1].record()
        frames, _ = receiver.detect_and_extract(stream, cfg, B)
        ev[2].record()
        spectra, carr_off, taps = receiver.demodulate(rxp, frames)
        ev[3].record()
        pay_eq, fields, header_ok, cnst = receiver.equalize_passes(rxp, spectra, taps)
        ev[4].record()
        receiver.demap_and_verify(rxp, pay_eq, fields, header_ok, cnst, carr_off)
        ev[5].record()
        torch.cuda.synchronize()
        for i, k in enumerate(stages):
            stages[k].append(ev[i].elapsed_time(ev[i + 1]))
    print("[timing] per stage, median of 5 (ms; detect_and_extract includes its metric): "
          + ", ".join(f"{k} {sorted(v)[2]:.3f}" for k, v in stages.items()))

    # kernel against the plain metric at the main path's N, in turns
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = sync._timing_metric_torch if which == "plain" else sync_cuda.timing_metric_cuda
        fn(stream)
        times[which].append(cuda_ms(lambda: fn(stream), 20))
    k_ms, p_ms = min(times["kernel"]), min(times["plain"])
    print(f"[timing] metric at N={n_main}: kernel {k_ms:.4f} ms "
          f"({n_main * 20 / k_ms / 1e6:.1f} GB/s of the 20 B/sample it must move), "
          f"plain PyTorch {p_ms:.4f} ms; runs {times}")
    print(f"[timing] after timing: {smi('clocks.sm,power.draw,temperature.gpu')}")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "schmidl_cox_metric", "route": "cuda",
        "source": "gr_dtl_tpu_torch/csrc/sync_metric.cu",
        "replaces": "gr_dtl_tpu/ops/sync_pallas.py:149",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
