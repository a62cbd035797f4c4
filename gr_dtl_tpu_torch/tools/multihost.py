"""Multi-process ``torch.distributed`` run of the sharded modem (port of
tools/multihost.py).

It launches OS processes that each own one rank of a global ``(stream,
time)`` grid (``parallel/dist.make_host_mesh``), joins them in one process
group on ``localhost``, runs the full TX + channel + RX step
(``parallel/stream.build_sharded_loopback``) over the global arrays, checks
that every frame decodes, and measures the wall time a step and each
process's CPU time (rusage), so that the report separates cross-process
overhead from plain CPU contention on a small host.

A torch rank is a process.  So ``--procs P --devices-per-proc D`` starts
P x D ranks, grouped as P "hosts" of D ranks (``LOCAL_WORLD_SIZE`` = D, the
ranks of a host numbered together), and the global grid has the shape the
reference's P processes of D devices each give: (P x D / n_time, n_time),
every time ring inside one host.  On the CPU the ranks use gloo, one thread
each; on cards (``--device cuda``), NCCL with one rank a card: rank r on
``cuda:r``, so P x D cards.

Modes:
  --launch          spawn the ranks (``--worker``), then TWO single-host
                    reference points of the same per-rank workload:
                      * strong base: one host of all P x D ranks, the full
                        global workload (efficiency = no cross-host
                        overhead),
                      * weak base: one host's D ranks, one host's share of
                        the streams (efficiency = does adding a host add
                        proportional capacity),
                    and print (and with --out write) a JSON report with both
                    efficiencies.
  --session         spawn the continuous sharded session
                    (``parallel/session.ShardedStreamRx``) over the ranks,
                    3 chained blocks, byte-exact decode of every stream
                    checked in every rank.
  --worker, --session-worker, --baseline N [--half]
                    one rank of those runs (spawned by the two above).

A step is timed by the host clock around work that ends in a synchronise
(``torch.cuda.synchronize`` on a card) followed by the readback of the
step's CRC flags; no value chains one step into the next.  Each step's pad
bytes and unit noise come from a ``torch.Generator`` seeded with the step's
number on the rank's device, the same global draws on every rank; the
payloads are the reference's numpy draws.  Workload knobs are the
``GR_DTL_MH_*`` environment variables of the reference (or the flags of the
same names): CI-sized defaults; the artifact scale is 64 streams x 16
frames a block x 20 steps (BASELINE config 5).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as tdist

from gr_dtl_tpu_torch.tools import _cli

__all__ = ["main", "DEFAULTS", "launch", "launch_session"]

PKG_ROOT = Path(__file__).resolve().parents[2]  # the directory that holds gr_dtl_tpu_torch
TOOL = (sys.executable, "-m", "gr_dtl_tpu_torch.tools.multihost")

# CI-fast defaults; the artifact run overrides them.  Ranks inherit the
# launcher's choices through the GR_DTL_MH_* environment variables.
DEFAULTS = {
    "streams": 8,
    "frames_per_block": 2,
    "n_time": 2,
    "steps": 3,
    "frame_length": 4,
    "warmup": 1,
}
NOISE_V = 0.01


def _params() -> dict:
    return {k: int(os.environ.get(f"GR_DTL_MH_{k.upper()}", v)) for k, v in DEFAULTS.items()}


def _workload(txcfg, S, F, seed=0):
    rng = np.random.RandomState(seed)
    maxb = txcfg.max_frame_bytes()
    plen = np.full((S, F), txcfg.frame_bytes(2) - 4, np.int32)
    payload = np.zeros((S, F, maxb), np.uint8)
    for s in range(S):
        for f in range(F):
            payload[s, f, : plen[s, f]] = rng.randint(0, 256, plen[s, f])
    cnst = np.full((S, F), 2, np.int32)
    frame_no = np.tile(np.arange(F, dtype=np.int32), (S, 1))
    return payload, plen, cnst, frame_no


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _join(dev) -> dict:
    """Join the run's process group from the launcher's environment (a
    world of one included); returns this rank's place."""
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    from gr_dtl_tpu_torch.parallel import dist

    dist.init_group(rank, world, f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", dev)
    local = int(env.get("LOCAL_WORLD_SIZE", world))
    return {"rank": rank, "world": world, "local": local, "host": rank // local,
            "hosts": world // local}


def _run_steps(step, dev, inputs: dict, draw_shapes: tuple, steps: int, warmup: int) -> dict:
    """Run loopback steps on the global inputs; returns seconds a step, CPU
    seconds a step and the frames a step.  Every step ends in a synchronise
    and the readback of this rank's CRC flags, which must all be set."""
    pad_shape, noise_shape = draw_shapes

    def one(i: int) -> bool:
        gen = torch.Generator(device=dev).manual_seed(1 + i)
        pad = torch.randint(0, 256, pad_shape, generator=gen, device=dev, dtype=torch.uint8)
        noise = torch.complex(torch.randn(noise_shape, generator=gen, device=dev),
                              torch.randn(noise_shape, generator=gen, device=dev))
        out = step(inputs["payload"], inputs["plen"], inputs["cnst"], inputs["frame_no"], pad, noise)
        _sync(dev)
        return bool(out.crc_ok.all())

    if not one(-1):
        raise SystemExit("the warm-up step did not decode every frame")
    for i in range(warmup):
        if not one(1000 + i):
            raise SystemExit(f"warm-up step {i} did not decode every frame")
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.monotonic()
    for i in range(steps):
        if not one(i):
            raise SystemExit(f"step {i} did not decode every frame")
    wall = time.monotonic() - t0
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    cpu = (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime)
    return {
        "sec_per_step": wall / steps,
        "cpu_sec_per_step": cpu / steps,
        "cpu_utilization": cpu / wall if wall > 0 else 0.0,
        "frames_per_step": int(np.prod(inputs["plen"].shape)),
    }


def _build_and_run(mesh, p: dict, streams: int, dev) -> dict:
    from gr_dtl_tpu_torch.parallel import stream as pstream
    from gr_dtl_tpu_torch.utils import config as cfgmod

    txcfg = cfgmod.make_tx_config(None, frame_length=p["frame_length"])
    rxcfg = cfgmod.make_rx_config(None, frame_length=p["frame_length"])
    step, _ = pstream.build_sharded_loopback(txcfg, rxcfg, mesh, p["frames_per_block"], NOISE_V,
                                             dev)
    F = mesh.shape["time"] * p["frames_per_block"]
    names = ("payload", "plen", "cnst", "frame_no")
    inputs = {k: torch.as_tensor(v, device=dev)
              for k, v in zip(names, _workload(txcfg, streams, F))}
    draws = ((streams, F, txcfg.max_frame_bytes()), (streams, F * rxcfg.frame_samples))
    res = _run_steps(step, dev, inputs, draws, p["steps"], p["warmup"])
    res["samples_per_step"] = res["frames_per_step"] * rxcfg.frame_samples
    return res


def _place(me: dict, mesh, dev) -> dict:
    return {"process_id": me["host"], "rank": me["rank"], "n_processes": me["hosts"],
            "global_devices": me["world"], "local_devices": me["local"],
            "mesh": dict(mesh.shape), "device": str(dev)}


def worker(args) -> None:
    """One rank of ``--launch``."""
    from gr_dtl_tpu_torch.parallel import dist

    dev = _cli.device_of(args)
    me = _join(dev)
    try:
        p = _params()
        mesh = dist.make_host_mesh(n_time=p["n_time"], device=dev)
        res = _build_and_run(mesh, p, p["streams"], dev)
        res.update(_place(me, mesh, dev), crc_ok=True)
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    print("WORKER_RESULT " + json.dumps(res), flush=True)


def baseline(args) -> None:
    """One rank of a single-host reference point: strong (all ranks, the
    full workload) or weak (``--half``: one host's ranks, half the
    streams)."""
    from gr_dtl_tpu_torch.parallel import dist

    dev = _cli.device_of(args)
    me = _join(dev)
    try:
        if me["world"] != args.baseline:
            raise SystemExit(f"--baseline {args.baseline} runs as {args.baseline} ranks, "
                             f"not {me['world']}")
        p = _params()
        mesh = dist.make_host_mesh(n_time=p["n_time"], device=dev)
        res = _build_and_run(mesh, p, p["streams"] // 2 if args.half else p["streams"], dev)
        res.update(devices=me["world"], rank=me["rank"], device=str(dev))
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    tag = "BASELINE_HALF_RESULT" if args.half else "BASELINE_RESULT"
    print(tag + " " + json.dumps(res), flush=True)


def _session_input(txcfg, S: int, B: int, n_samples: int, dev) -> tuple:
    """The global streams every rank builds alike: stream s carries B frames
    of numpy payloads (``RandomState(60 + s)``, mixed constellations) from
    sample 120 + 67 s, then idle air, with AWGN 30 dB under its power."""
    from gr_dtl_tpu_torch.models import transmitter
    from gr_dtl_tpu_torch.ops import channel, constellation as cn

    maxb = txcfg.max_frame_bytes()
    payloads = np.zeros((S, B, maxb), np.uint8)
    plens = np.zeros((S, B), np.int32)
    cnsts = np.zeros((S, B), np.int32)
    for s in range(S):
        rng = np.random.RandomState(60 + s)
        cnsts[s] = rng.randint(1, 5, B)
        for i in range(B):
            plens[s, i] = txcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[cnsts[s, i]])) - 4
            payloads[s, i, : plens[s, i]] = rng.randint(0, 256, plens[s, i])
    gen = torch.Generator(device=dev).manual_seed(0)
    txp = transmitter.build_tx(txcfg, dev)
    flat = lambda a: torch.as_tensor(a.reshape(S * B, *a.shape[2:]), device=dev)
    pad = torch.randint(0, 256, (S * B, maxb), generator=gen, device=dev, dtype=torch.uint8)
    out = transmitter.tx_frames(txp, flat(payloads), flat(plens), flat(cnsts),
                                torch.zeros(S * B, dtype=torch.int32, device=dev),
                                flat(np.tile(np.arange(B, dtype=np.int32), (S, 1))), pad)
    sig = out.samples.reshape(S, -1)
    streams = torch.zeros((S, n_samples), dtype=torch.complex64, device=dev)
    for s in range(S):
        off = 120 + 67 * s
        streams[s, off: off + sig.shape[1]] = sig[s]
        power = float((sig[s].abs() ** 2).mean())
        streams[s] = channel.awgn(streams[s], float(np.sqrt(power / 1e3)), generator=gen)
    return streams.cpu().numpy(), payloads, plens


def session_worker(args) -> None:
    """One rank of the continuous sharded session: ShardedStreamRx over the
    global grid with its carried state chained across process() calls
    through the grid's collectives."""
    from gr_dtl_tpu_torch.parallel import _coll, dist
    from gr_dtl_tpu_torch.parallel.session import ShardedStreamRx
    from gr_dtl_tpu_torch.utils import config as cfgmod

    dev = _cli.device_of(args)
    me = _join(dev)
    try:
        p = _params()
        mesh = dist.make_host_mesh(n_time=p["n_time"], device=dev)
        S, F, n_blocks = p["streams"], p["frames_per_block"], 3
        cfg = cfgmod.make_rx_config(None, frame_length=p["frame_length"])
        txcfg = cfgmod.make_tx_config(None, frame_length=p["frame_length"])
        srx = ShardedStreamRx(cfg, mesh, n_streams=S, frames_per_block=F, device=dev)
        blk = srx.block_samples
        B = (n_blocks - 1) * F  # then a block of idle air
        streams, payloads, plens = _session_input(txcfg, S, B, n_blocks * blk, dev)
        decoded = [dict() for _ in range(S)]
        host = lambda x: _coll.gather_global(x, mesh, 1).cpu().numpy()
        for b in range(n_blocks):
            out, valid = srx.process(streams[:, b * blk: (b + 1) * blk])
            pays, lens, nos = host(out.payload), host(out.payload_len), host(out.frame_no)
            ok = valid & srx.last_crc_ok
            for s in range(S):
                for i in np.nonzero(ok[s])[0]:
                    decoded[s][int(nos[s][i])] = pays[s][i, : lens[s][i]].tobytes()
        exact = all(len(decoded[s]) == B
                    and all(decoded[s][i] == payloads[s][i, : plens[s][i]].tobytes()
                            for i in range(B))
                    for s in range(S))
        res = dict(_place(me, mesh, dev), streams=S, chained_blocks=n_blocks,
                   frames_decoded=int(sum(len(d) for d in decoded)), byte_exact=bool(exact),
                   lost_frames=int(srx.n_lost.sum()))
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    print("SESSION_RESULT " + json.dumps(res), flush=True)
    if not exact:
        raise SystemExit("distributed session decode mismatch")


def _rank_devices(device, world: int) -> list:
    """Rank r's device: the CPU, or card r (NCCL takes one rank a card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * world
    if world > torch.cuda.device_count():
        raise SystemExit(f"error: {world} ranks on cards need {world} cards, torch finds "
                         f"{torch.cuda.device_count()}")
    return [torch.device("cuda", r) for r in range(world)]


def _spawn_ranks(flags: list, world: int, local: int, p: dict, device, tag: str,
                 timeout: float = 3600.0) -> list:
    """Start ``world`` ranks of this tool with ``flags`` as ``world // local``
    hosts of ``local`` ranks; returns each rank's ``tag`` result in rank
    order.  A rank that fails stops the others and ends the run."""
    from gr_dtl_tpu_torch.parallel import launch as plaunch

    port = plaunch.free_port()
    base = dict(os.environ)
    base["PYTHONPATH"] = os.pathsep.join(x for x in (str(PKG_ROOT), base.get("PYTHONPATH")) if x)
    base.update({f"GR_DTL_MH_{k.upper()}": str(v) for k, v in p.items()})
    procs, logs = [], []
    for r, dev in enumerate(_rank_devices(device, world)):
        env = dict(base, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(r % local), LOCAL_WORLD_SIZE=str(local),
                   GROUP_RANK=str(r // local))
        log = tempfile.TemporaryFile("w+")
        logs.append(log)
        procs.append(subprocess.Popen([*TOOL, *flags, "--device", str(dev)], env=env, cwd=PKG_ROOT,
                                      stdout=log, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    try:
        while any(pr.poll() is None for pr in procs):
            failed = [r for r, pr in enumerate(procs) if pr.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    results = []
    for r, (pr, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        if pr.returncode != 0:
            sys.stderr.write(f"--- rank {r} ({' '.join(flags)}) failed ---\n{text}\n")
            raise SystemExit(f"rank {r} exited {pr.returncode}")
        line = [ln for ln in text.splitlines() if ln.startswith(tag + " ")]
        results.append(json.loads(line[-1][len(tag) + 1:]))
    return results


def launch_session(procs: int, devices_per_proc: int, p: dict, device="cuda") -> dict:
    """Spawn the continuous sharded session over P x D ranks."""
    world = procs * devices_per_proc
    workers = _spawn_ranks(["--session-worker"], world, devices_per_proc, p, device, "SESSION_RESULT")
    result = {
        "mode": "distributed-session",
        "n_processes": procs,
        "devices_per_process": devices_per_proc,
        "ranks": world,
        "workers": workers,
        "byte_exact_all": all(w["byte_exact"] for w in workers),
        "note": f"{world} OS processes as {procs} hosts of {devices_per_proc} ranks, "
                f"{'NCCL' if torch.device(device).type == 'cuda' else 'gloo'} collectives: the "
                "continuous sharded session (carried tail, lock and accounting state chained "
                "across process() calls on the global grid), 3 chained blocks, byte-exact decode "
                "of every stream checked in every rank",
    }
    print(json.dumps(result, indent=2), flush=True)
    return result


def launch(procs: int, devices_per_proc: int, out_path: str | None, p: dict, device="cuda") -> dict:
    world = procs * devices_per_proc
    workers = _spawn_ranks(["--worker"], world, devices_per_proc, p, device, "WORKER_RESULT")

    def run_base(flags: list, n: int, tag: str) -> dict:
        ranks = _spawn_ranks(flags, n, n, p, device, tag)
        res = dict(ranks[0])
        res["sec_per_step"] = max(r["sec_per_step"] for r in ranks)
        res["cpu_utilization_ranks"] = [r["cpu_utilization"] for r in ranks]
        return res

    # strong base: one host of all the ranks, the full workload
    base = run_base(["--baseline", str(world)], world, "BASELINE_RESULT")
    # weak base: one host's ranks, half the streams
    base_half = run_base(["--baseline", str(devices_per_proc), "--half"], devices_per_proc,
                         "BASELINE_HALF_RESULT")

    worst = max(w["sec_per_step"] for w in workers)
    eff_strong = base["sec_per_step"] / worst if worst > 0 else 0.0
    # weak scaling: N hosts should do N x the half workload in the half
    # workload's time
    eff_weak = base_half["sec_per_step"] / worst if worst > 0 else 0.0
    backend = "NCCL" if torch.device(device).type == "cuda" else "gloo"
    result = {
        "n_processes": procs,
        "devices_per_process": devices_per_proc,
        "ranks": world,
        "device": str(device),
        "workload": p,
        "workers": workers,
        "single_process_baseline": base,
        "half_workload_baseline": base_half,
        "sec_per_step_distributed": worst,
        "sec_per_step_single": base["sec_per_step"],
        # the same global work on the same ranks: 1.0 = no cross-host overhead
        "efficiency_vs_single_process": round(eff_strong, 4),
        # half the work on one host against the full work on P hosts: 1.0 =
        # each added host added its full capacity
        "efficiency_weak_scaling": round(eff_weak, 4),
        "host_cores": os.cpu_count() or 1,
        "timing": "host clock over the timed steps, each ending in a synchronise and the "
                  "readback of its CRC flags",
        "contention_analysis": {
            "worker_cpu_utilization": [w["cpu_utilization"] for w in workers],
            "baseline_cpu_utilization": base["cpu_utilization"],
            "note": "cpu_utilization = process CPU-sec / wall-sec over the timed steps.  If the "
                    "ranks' summed utilization saturates host_cores, the distributed number is "
                    "CPU-contention-bound, not communication-bound.",
        },
        "crc_ok_all": all(w["crc_ok"] for w in workers),
        "note": f"{world} OS processes as {procs} hosts of {devices_per_proc} ranks, {backend} "
                "collectives, global (stream, time) grid, ring-shifted halos and the summed "
                "phase vote across ranks; every frame's CRC checked in every rank",
    }
    print(json.dumps(result, indent=2), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m gr_dtl_tpu_torch.tools.multihost",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--launch", action="store_true")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--session", action="store_true",
                    help="launch the continuous sharded session across the ranks "
                         "(ShardedStreamRx over the global grid, chained blocks)")
    ap.add_argument("--session-worker", action="store_true")
    ap.add_argument("--baseline", type=int, default=0)
    ap.add_argument("--half", action="store_true",
                    help="with --baseline: weak-scaling base (one host's ranks, half the streams)")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--out", default=None)
    for k in DEFAULTS:
        ap.add_argument(f"--{k.replace('_', '-')}", type=int, default=None)
    _cli.add_device_args(ap)
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.worker:
        worker(args)
    elif args.session_worker:
        session_worker(args)
    elif args.baseline:
        baseline(args)
    else:
        device = _cli.device_of(args)
        p = {k: (getattr(args, k) if getattr(args, k) is not None
                 else int(os.environ.get(f"GR_DTL_MH_{k.upper()}", v)))
             for k, v in DEFAULTS.items()}
        if args.session:
            launch_session(args.procs, args.devices_per_proc, p, device)
        else:
            launch(args.procs, args.devices_per_proc, args.out, p, device)


if __name__ == "__main__":
    main()
