"""Smoke run of the PyTorch port (gr_dtl_tpu_torch) on one NVIDIA GPU.

Drives the port's paths at the size their users run them.  The
uncoded batch modem: B=2048 frames of frame_length 20 (1840 samples
each, a 3.77 Msample complex64 stream), mixed constellations 1..4, AWGN
of noise voltage 0.02.  The coded (LDPC) batch modem of
examples/config_fec.json: B=1024 QPSK frames of frame_length 20 (1920
samples each with the long header), the n=300 k=152 code, 13 codewords
a frame (13,312 a step), AWGN at 25 and 11 dB of the measured TX power,
as tools/bench_fec.py draws them.  Phases:

1. device: the card's name and power limit, torch/CUDA versions, and
   whether nvcc and triton are present;
2. build: compiles csrc/sync_metric.cu, csrc/stream_scans.cu,
   csrc/tb_ring.cu, csrc/equalizer.cu, csrc/feedback_scan.cu,
   csrc/ldpc_bp.cu and csrc/soft_demap.cu for sm_90a from this checkout, one
   nvcc each, side by side; from here on every ``ldpc.decode_mm`` /
   ``decode_bank_mm`` call on the card is held to its K3 launches
   (``BpLedger``: one a call, a bank's too), every ``ldpc.decode`` /
   ``decode_bank`` call to its K8 launch (``GATHER``), and every
   ``receiver.frame_llrs`` call to its K9 launch (``LLR``: one a call with
   the closed-form tables, none in table mode), booked by phase;
3. kernel vs plain: the CUDA Schmidl-Cox kernel against its plain
   PyTorch version on the card, at the uncoded path's N, at two ragged
   lengths, on a [4, N] batch and at the edges of its tiling: one output
   (N = 65), a tile and a tile plus one output, three rows of odd length
   (rows off the 16-byte grid), a streaming block [8, 262144], an all-zero
   stream and a stream scaled by 1e3 (atol 2e-4 on P, 2e-3 on M); phase 6
   holds it to the same bars on the coded path's streams;
4. slice: TX -> AWGN -> detect_and_extract -> rx_frames; every frame's
   CRC must pass with its payload equal to what was sent, the kernel
   must have been launched, and a 16-frame run must agree with the
   port's CPU path;
5. timing with CUDA events: the RX step (median/min/max over 7
   windows), a per-stage split, and the kernel against the plain metric
   as tools/bench_sync_metric.py times it: launches on preallocated
   outputs over a ring of 4 streams (L2 cold), the warm-L2 time named as
   such beside it, a torch.profiler cross-check, bytes, bound and share,
   at the uncoded N, at a streaming block [8, 262144] and (in phase 6) at
   the coded N;
6. coded path: the kernel against the plain metric on the coded
   streams (25 and 11 dB), then TX -> AWGN (25 dB) -> detect_and_extract
   -> rx_frames; every frame's CRC must pass with its payload equal to what was sent,
   the kernel must have been launched (and K3 once), and a 16-frame run must agree
   with the port's CPU path; at 11 dB the CRC rate and BP iterations,
   and a 32-frame run against the CPU path; then B=256 runs with mixed
   constellations and with the two-code bank (30 dB) must decode every
   frame;
7. coded timing with CUDA events at 25 and 11 dB: the RX step
   (median/min/max over 7 windows), a per-stage split with BP inside
   fec_frame_decode, and peak device memory.

And the always-on streaming sessions (models/session.py), on the uncoded
config at frame_length 20 (1840 samples a frame), frames starting at
sample 300 so that every block boundary cuts a frame, mixed
constellations 1..4, noise voltage 0.02, traffic then one block of idle
air, at F = 16, 256 and 1024 frames a block (29,440 / 471,040 / 1,884,160
samples):

8. scan kernels: csrc/stream_scans.cu (trigger lock scan, frame
   accounting under both rules) against their plain PyTorch loops at
   T = 1, 5, 4096 and every T the paths below hand them (8, 16, 64, 256,
   1024) over three carried calls, and in phases 9 and 10 on the block
   step's own tensors: every output and state word equal;
9. uncoded stream: StreamRx at the three F: every sent frame decoded once,
   in order, with the sent payload, nothing lost, idle air not counted,
   one launch of each of the three kernels a block, counted in every
   run; StreamRxPipelined(2) (numpy and prefetched ingest) and, at F = 16,
   StreamRxMega(K=16) equal StreamRx bit for bit; the first 4 blocks at
   F = 16 against the CPU path; the CUDA runtime calls of one dispatch hold
   no synchronising call and no pageable copy, and in a traced pipelined
   run block k+1's launches are all enqueued before the wait for block k;
10. coded stream: the TB ring kernels (csrc/tb_ring.cu) against the plain
   loop on random header sequences (lost frames, repeated and skipped
   tb_no, cnst outside 1..4, offsets past the last slot, a carried-in
   buffer) at F = 1, 8, 64, 256, 1024 and W = 1, 2, 4, every output and the
   new carry equal; then examples/config_fec.json, n=300 k=152, 2 frames a
   transport block, QPSK, F = 64, 25 dB, one mid-TB frame replaced by
   noise: TBs as the port's CPU run reports them, all but the hit one with
   the sent bytes, flush_tb emits the last, two TB ring launches a block
   counted, the kernels against the plain loop on the block step's own
   tensors;
11. StreamTx -> AWGN -> StreamRx (small PDUs, a jumbo, a dry queue, the
   empty-frame budget) and StreamDuplex at 30 / 5 dB, F = 8, 12 steps, in
   both readback orderings;
12. times: wall-clock and CUDA-event ms a block (median over the blocks
   after 2 warm-up blocks, the receivers in turns), Msamples/s, kernels a
   block and the device's idle share from one profiled block; the scan
   kernels (profiler) against their plain loops at T = 1 (the launch
   floor), 16, 32, 256, 1024, and the TB ring kernels at F = 1, 16, 32, 64,
   256, 1024, W = 2, each beside its bound, the earlier design's time
   as PERF.md section 6 records it (printed, not measured here) and
   torch.cummax over the same frames' int32
   indices (the prefix-max at the core of the accounting and of the TB
   walk, not the whole function: library_ms stays None).

And slice D, at frame_length 20 and the default burst modem:

13. channels at N = 3,770,368: channel_model (3 taps, CFO 0.2 carriers,
   noise 0.02), sample_clock_offset (50 ppm) and selective_fading (3 taps,
   8 sinusoids) on the card against the port's CPU run (atol 2e-5, 2e-5,
   2e-3; the last 4096 samples compared on their own), ms, launches and
   peak memory each;
14. the receiver behind them: B=2048 mixed frames behind channel_model
   (every frame decodes, the CFO estimate within 0.05), 16 QPSK frames
   through fading at 28 dB (at least 70% decode), 200 frames at +-50 ppm
   through StreamRx (each decodes once);
15. bursts: 4096 bursts burst_tx -> delay, CFO, AWGN -> burst_rx all
   decode, noise alone decodes none, 64 captures card vs CPU;
   StreamBurstRx over 9 blocks of 4096 with two bursts inside each block
   and one across its end: each found once;
16. links: simplex.run and full_duplex.run (uncoded, and fec= with
   examples/config_fec.json) for 32 rounds: the clean direction climbs to
   16QAM, the poor one stays at (or falls to) BPSK; no synchronising call
   inside the uncoded rounds; ms a round;
17. StreamSimplex at F = 8, 16 steps, half the reverse blocks dropped: the
   TX climbs to 16QAM and never moves on a lost burst; one launch of each
   of the three kernels a step, counted.

And the equalizer kernel (csrc/equalizer.cu), which every receive step of
every phase above launches four times (header and payload call, two
passes; reset and counted at every run):

18. kernel vs plain (before phase 4): ``equalize_frame`` on CUDA tensors
   against ``_equalize_frame_torch`` on synthetic frames at B = 1, 2, 31,
   32, 33, 1024, 2048, header (n_sym 1) and payload (n_sym 20) calls, mixed
   constellation ids and each alone, updating and frozen taps, strided
   views of [B, 23, 64] spectra, and frames placed on the decision
   boundaries: decisions equal, soft symbols and taps within 1e-5, noise
   variance within rtol 1e-4, SNR within 1e-3 dB on every row; a row may
   part from the plain loop only at a symbol whose equalized value lies
   within 1e-5 of a decision boundary, and such rows are counted (under
   0.1% of the rows on every input but the last);
19. on the paths' own tensors: every ``equalize_frame`` call of one uncoded
   B=2048 step, one coded B=1024 step at 25 and at 11 dB, the first three
   blocks of StreamRx at F = 16 and 1024 and two rounds of every link also
   goes through the plain loop, to the same bar; the 11 dB CRC rate beside
   the one the plain loop gives on the same stream;
20. a launch census: device kernels and copies a step by stage, for the
   uncoded and both coded steps, a link round, a stream block;
21. times: the kernel alone at B = 1, 32, 1024, 2048 for both calls
   (profiler, over a ring of inputs) against its bound and the plain loop;
   the step's SASS (instructions a step, divisions, registers, no spill,
   B = 2048 in one wave of blocks) and the payload call's issue floor.

And the testbed's telemetry and the wire-compat mode:

22. telemetry: StreamRx(probe=MonitorProbe(address=None)) on the uncoded
   stream at F = 16 and 1024 over 16 blocks: one MonitorEqMsg per received
   frame, every message parsed, constellation_key the sent constellation,
   sent_counter 1..n; the first blocks against the port's CPU run (keys,
   counters and loss rates equal, SNR and noise variance within 1e-3
   relative); one launch of each kernel a block, counted; a traced probed
   _dispatch holds no synchronising call; ms a block with and without the
   probe in turns and the host ms spent building messages; a probed
   StreamDuplex at F = 8 (a message per decoded frame each way);
23. wire compat: the JAX package's test constants (QPSK / 8PSK / 16QAM
   relabeled, a random sync PN), written by this script and installed
   through a config's wire_compat: uncoded B=2048 mixed at noise 0.02 and
   coded B=1024 QPSK at 25 dB, every frame decoded, the equalizer kernel's
   table mode (4 launches a step, counted) bit-equal to the plain loop on
   every call of both steps; then deactivated, a native batch decodes on
   the closed-form slicers (no table-mode launch) while the receiver built
   under the foreign tables still decodes a foreign stream; the table
   mode's payload call timed at B = 1 / 32 / 1024 / 2048 against its bound,
   beside the closed-form call on the same inputs.

And slice E, the sharded session of parallel/, on a one-rank NCCL group
(world size 1 on cuda:0, a 1 x 1 grid: NCCL takes one rank a card, so the
multi-rank grids are the CPU tests' work over gloo):

24. sharded: ShardedStreamRx at S = 64 streams, F = 32 frames a block of
   frame_length 20 (2048 frames, 3,768,320 samples a block), stream s from
   sample 300 + 37 s mod 1500 so that block boundaries cut frames, 2
   warm-up and 16 timed blocks, then one of idle air: every sent frame
   decoded once, in order, with the sent bytes, n_lost 0; one launch of the
   metric kernel, one of each scan kernel (every stream in one launch) and
   four of the equalizer a block, counted; streams 0, 21, 42, 63 equal
   StreamRx on the same samples; the batched scan kernels against their
   plain loops stream by stream on the block step's own tensors; coded W = 2
   (examples/config_fec.json, 25 dB, S = 8, F = 64): every TB decodes, the
   last by flush_tb, two TB ring launches a block for all 8 rings, counted;
   the megastep K = 4 at S = 64, F = 16 equal to the K = 1 session; a small
   case equal to the port's CPU run; entry.dryrun_multichip(1) on the card;
   the batched K4 and K5 against their plain loops on synthetic inputs
   (S = 1, 8, 64; T and F = 1 .. 1024, error 0); wall ms a block,
   Msamples/s, device-busy ms and idle share, and the batched kernels'
   times (S = 64, T = 32; S = 8, F = 64, W = 2) beside S launches of the
   single-stream form, the earlier design's time as PERF.md records it
   (printed, not measured here) and torch.cummax.

And slice F, the app layer: the tools of gr_dtl_tpu_torch/tools called
through their main(argv) in this process on the card, every launch count
set to 0 just before a tool and read just after (launches a step, block or
round checked), each mode's JSON, wall ms and counts printed:

25. app layer: run_modem loopback at B = 2048 (examples/config.json,
   frame_length 20, 25 dB; every frame passes CRC; 1 metric, 1 accounting
   and 4 equalizer launches) and coded at B = 1024 (examples/config_fec.json,
   every frame decodes), ber on the first's TX / RX stores (0 bit errors);
   stream-tx writing 16 blocks of F = 1024 (1,884,160 samples a block, every
   frame full) to a capture with a block of silence after it, stream reading
   it back at depth 1 and 2 with --store-rx (every frame decoded once, in
   order, with the sent bytes, lost_frame_rate 0, the two stores equal; 1
   metric, 1 + 1 scan and 4 equalizer launches a block); replay of its first
   2048 frames (the stream's first records); coded stream-tx and stream with
   --tb-frames 2 at F = 64 (every transport block passes CRC, 2 TB ring
   launches a block); stream-sharded --selftest at 64 streams, F = 32 and
   --source on a 64-stream capture (a one-rank NCCL group); full-duplex and
   simplex for 32 rounds; tun_bridge.ModemPipe on 64 IPv4 packets (back
   unchanged); and a stream --source listen: / stream-tx --sink tcp: pair of
   python -m processes started from a copy of the package without _build/
   (the RX builds its kernels after it accepted the TX; every payload frame
   the TX reports stored with the bytes sent).  Beside the tools' wall ms,
   the sessions alone on the same blocks (StreamRx, StreamRxPipelined(2),
   ShardedStreamRx) and the loopback's and replay's device work alone.

And slice G, the live-I/O tools, with K7 (csrc/feedback_scan.cu), the MCS
decision over a block's frames as one launch of one of its two kernels
(the walk below 64 frames or past 256 columns, the map otherwise;
``feedback_cuda.design``).
K7 is checked where the paths call it: in phase 11's StreamDuplex and
phase 17's StreamSimplex runs (``FeedbackCheck`` swaps
``adaptive.feedback_scan_masked`` for a function that counts one K7 launch
a call, and which kernel, and, after the run, holds every call to the
plain loop on the same tensors) and in every link node below (each node a
``python -m`` process started through ``checked_node``):

26. live I/O: both K7 kernels against the plain loop on synthetic inputs
   (T = 1, 8, 16, 37, 256, 1024 and three tiles, 2100; batch () and [64];
   random, all-False, per-frame and null masks; SNRs on the thresholds, on
   threshold + hysteresis and one ulp either side, NaN and +-inf, inside a
   hysteresis band where ids 0 and 1 both stay; carries outside the map's
   canonical states; two ladders), ids and state equal; K7's times
   (profiler) at those T beside its bound and the plain loop's time, the
   walk's time at F = 1024 in turns with the map's, the floors of both
   chains (from the probes of tools/bench_feedback_scan),
   and the plain loop's device kernels on one F = 8 and one F = 1024 block;
   sample_link --loopback-test and --duplex-test with both nodes as
   processes on the card, first at the JAX package's slow tests' settings,
   then at F = 1024, frame_length 20, 30 dB (>= 8 blocks): CRC-clean,
   converged, 16QAM (>= 8PSK both ways in the duplex), every sample received,
   wall ms a block for each node; soak_link over 1e8 samples at F = 1024
   through 18 dB AWGN, a wandering CFO and +20 ppm SFO (its own criteria,
   its files under chiprun_out/); multihost --launch and --session, one
   rank on the card, at 64 streams x 16 frames x 20 steps: every frame
   decoded, byte exact, nothing lost, seconds a step and the rusage shares.

And slice H, the measuring tools and the LDPC leftovers (no new kernel):

27. the LDPC leftovers: ``ldpc.decode`` (K8 on the card, phase 30),
   ``decode_mm_twopass`` (default
   bucket and 64) and ``decode_mm(bf16=True)`` on CUDA tensors against the
   same functions on the CPU, 2048 codewords of the n=300 code in three
   regimes (clean: equal; knee and waterfall: ok equal, hard equal where
   both are ok, iteration counts parted on at most 1% of rows), twopass
   against decode_mm on the card (same ok and message bits); then the
   six tools' ``main`` in process on the card at full width, each run
   with every launch count set to 0 just before it and checked after
   (``AppLedger``: one metric launch a receive step, four equalizer, the two
   scans a stream block; none on the BP benches): bench_fec 1024 (CRC
   rate 1.0 at 25 dB, BP and bf16 ok rates 1.0),
   bench_twopass and bench_bf16_ab at 2048 codewords (equal ok rates, 1.0
   clean), bench_bank_switch at 1024 codewords and 1..32 codes (every ok
   rate 1.0; the crossover printed), bench_stream F = 16 / 64 / 256 / 1024
   with readback, --mega 16x16 and --ingest, its duplex rows under
   ``FeedbackCheck`` (K7 held to its plain loop; every frame sent arrives
   with its header), and --device-stream at F = 1024 (every row finds
   frames and is CRC-clean), profile_rx at B = 2048 and coded B = 1024
   (the trace parses and holds ``sc_metric_kernel``,
   ``equalizer_kernel`` and the program's spans).  Their launches join
   the kernels line's counts.

And slice I, the bench (``gr_dtl_tpu_torch/bench.py``, the counterpart of
the JAX package's ``bench.py``; no new kernel):

28. the bench: ``bench.main`` in process on the card at B = 2048 and B =
   32, a warm-up step and 5 windows of 12 chained steps each, every launch
   count set to 0 just before and checked after (one metric and four
   equalizer launches a step; they join the kernels line's counts): its JSON
   line printed behind ``[bench]``, crc_ok_rate 1.0, a finite positive
   value, ``vs_baseline`` null, ``device`` the card's name and power limit;
   its median at B = 2048 printed beside phase 5's (not compared: the host
   swings between states of a process); a B = 16 chain of 3 steps on the
   card against the same stream on the CPU (acc and every int of every step
   equal); one B = 2048 step traced: its CUDA runtime calls hold no
   synchronising call and no pageable copy to the host, and its device
   kernels, copies, busy ms and idle share are printed.

And slice J, K3 (csrc/ldpc_bp.cu), the sum-product BP of ``decode_mm`` and
``decode_bank_mm`` as one launch a call (a bank's too, every row with its
own code), with no host check:

29. K3: how it is compiled (the ``ptxas`` report of each instantiation,
   codewords resident an SM, and what a message update issues an edge in
   its SASS, ``tools/bench_k3.py``); the kernel, called directly, against
   the plain ``ldpc._bp`` on the same CUDA tensors: the 13,312 codewords the
   coded step decoded at 25 and at 11 dB (phase 6), the 2048-codeword clean,
   knee and waterfall sets of phase 27, the two-code bank's codewords at
   30 dB (each code with the other code's rows marked done, and every row
   its own code in one launch), banks of 8 and 32 codes at 1024 codewords
   (tools/bench_bank_switch's inputs) in one launch each, quasi-cyclic codes
   of row degree 12 and 64 and a bank of row degrees 6 and 12 (rows past
   the 8 unrolled slots: the guarded instantiation), bf16 on (11 dB and
   the knee), and ``decode_mm_twopass`` through K3 and through ``_bp``: ok and
   iterations equal on every row, hard bits and final totals bit-equal on
   every converged row, parted rows counted and named (at most 1%); K3 and
   ``_bp`` timed in turns (CUDA events, and K3's device time by the
   profiler) at those five inputs and at banks of 1, 2, 8 and 32 codes,
   beside the bound and the issue floor from this run's iterations; the
   coded step and its stages at 25 and 11 dB with K3 and with
   ``_bp`` in turns; one ``decode_mm`` at 13,312 codewords and one
   ``decode_bank_mm`` of 32 codes traced (one device kernel each, no
   synchronising call, no copy); the K3 launches of every phase (each coded
   phase must have launched it, one a BP call).  The kernels line's eighth
   entry is K3's (its launches: phases 6-28).

And slice K, K8 (``bp_gather_kernel`` of csrc/ldpc_bp.cu, built with K3),
the gather form's BP of ``decode`` and ``decode_bank`` as one launch a call
with no host check:

30. K8: the coded receive step at B=1024 QPSK frames, 25 dB, through a bank
   of 33 copies of the n=300 code (fec_id 1..15, all the header carries),
   which ``fec_frame_decode`` sends to ``decode_bank``: every frame decoded
   with what was sent, the counts set to 0 just before the step and read
   just after (one K8 launch, no K3); the step with K8 and with
   ``_bp_gather`` in turns, each traced once (kernels, busy ms, idle
   share); K8's SASS counts and residency (``tools/bench_k3.py --form
   gather``); K8, called directly, against ``_bp_gather`` on the same CUDA
   tensors: phase 27's 2048 codewords clean, at the knee and in the
   waterfall, the 33-code step's own codewords, banks of 2, 8 and 32 codes
   at 1024 codewords, the 8-code bank with ids in [-11, 11], max_iters = 0
   and a noiseless batch, batches of the knee's codewords below, at and
   past one and four waves of resident blocks (where K8's blocks start to
   walk codewords), rows that do not start on 16 bytes and neighbouring
   rows of other codes (ok and iterations equal on every row, hard bits
   on every converged row, parted rows counted and named, at most 1%), and
   the stream's walk counters back at 0; K8
   and ``_bp_gather`` timed in turns (events, and K8's device time) beside
   the bound and the issue floor; one ``decode_bank`` of 33 codes at 1024
   codewords traced (one device kernel, no synchronising call, copy or
   memset); the K8 launches of phases 27 and 30 (one a call).  The kernels
   line's ninth entry is K8's, with the grid of the 11 dB step's K8 launch
   as the profiler recorded it (held to the launch rule's).

And slice L, K9 (``soft_demap_kernel`` of csrc/soft_demap.cu), the coded
demap's LLRs in one launch:

31. K9: the coded receive step of phase 6 at B=1024 QPSK frames, 25 and
   11 dB, the counts set to 0 just before each step and read just after
   (one K9 launch, ``rx.demap.llr_kernel_frames`` B in the recorder);
   ``frame_llrs``' inputs of each step, as the step handed them, and its
   output held ``torch.equal`` to ``_frame_llrs_torch`` on the same card
   tensors, and K9 called directly too; K9 and the plain chain timed in
   turns (``tools/bench_llr.py``: events, and K9's device time by the
   profiler over a ring of copies of the step's inputs, beside the byte
   floor at 3.35 TB/s), at the step's inputs and at the coded cell's B =
   32,768 QPSK frames of 960 symbols; the K9 launches a phase (one a
   closed-form call, every coded phase on the card).  The kernels line's
   tenth entry is K9's.

And K10 (``codewords_kernel`` of csrc/codewords.cu), the codeword LLRs of
the FEC decode in one launch:

32. K10: the coded receive step of phase 6 at B=1024 QPSK frames, 25 and
   11 dB, and ``decode_emitted`` over the stream cell's block (32,768 rows
   of 2 frames on the ladder of ``tools/bench_cw.py``) and
   ``fec_frame_decode`` over the batch cell's (32,768 QPSK frames), the
   counts set to 0 just before each decode and read just after (one K10
   launch, ``fec.decode.cw_kernel_groups`` G in the recorder); the
   codewords of each call, as K10 wrote them, bit-equal to
   ``_extract_torch`` on the same card tensors; K10 and the plain chain
   timed in turns at both cells' shapes (``tools/bench_cw.py``: events,
   and K10's device time by the profiler over a ring, beside the byte floor
   at 3.35 TB/s); the K10 launches a phase (one a decode call on the card,
   every coded phase).  The kernels line's eleventh entry is K10's.

Run from the repo root, with one CUDA device:  python3 chip_smoke.py
The last line of standard output is {"ok": true, "device": {...}}; any
failure exits non-zero before it.
"""

import contextlib
import importlib.util
import io
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gr_dtl_tpu_torch import bench
from gr_dtl_tpu_torch.models import adaptive, fec_chain, full_duplex, receiver, session, simplex
from gr_dtl_tpu_torch.models import streaming, transmitter
from gr_dtl_tpu_torch.ops import _cuda_build, burst, channel, constellation as cn, ldpc, metrics
from gr_dtl_tpu_torch.ops import equalizer, equalizer_cuda, feedback_cuda, ldpc_cuda, scans_cuda, sync
from gr_dtl_tpu_torch.ops import cw_cuda, llr_cuda, sync_cuda, tb_cuda
from gr_dtl_tpu_torch.testbed import monitor, phy_converge
from gr_dtl_tpu_torch.tools import _ldpc_bench, _timing
from gr_dtl_tpu_torch.tools import bench_equalizer as eq_bench
from gr_dtl_tpu_torch.tools import bench_feedback_scan as k7_bench
from gr_dtl_tpu_torch.tools import bench_cw, bench_k3, bench_llr
from gr_dtl_tpu_torch.tools import bench_sync_metric as metric_bench
from gr_dtl_tpu_torch.utils import alist, config as cfgmod, trace, wire_compat

B = 2048
FRAME_LENGTH = 20
NOISE_V = 0.02
SEED = 0
STREAM_TAIL = 2048  # zeros after the last frame, so its window never clips
P_ATOL, M_ATOL = 2e-4, 2e-3  # the reference's bars (tests/test_sync_pallas.py)
WINDOWS, STEPS_PER_WINDOW = 7, 3
ROOT = Path(__file__).resolve().parent
FEC_CONFIG = ROOT / "examples" / "config_fec.json"
BANK_ALISTS = ("n_0100_k_0027.alist", "n_0300_k_0152.alist")
B_FEC, B_FEC_SMALL = 1024, 256
SNRS_DB = (25.0, 11.0)
# The B=256 runs with constellations 1..4 run at 30 dB.  At 25 dB both
# packages now and then lose a 16QAM frame whose header passes and whose
# BP does not converge (CPU runs: 45 of 4,800 frames over 600 draws of 8
# 16QAM frames; tests/test_torch_fec_receiver.py::
# test_coded_16qam_losses_at_25db_match_reference holds three such draws,
# where the JAX package loses the same frames); at 30 dB none of 1,536
# mixed frames over 24 draws.
SNR_MIXED_DB = 30.0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


smi = _timing.smi


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of fn over reps back-to-back calls, by CUDA events
    (the measuring tools' timer, ``tools/_timing.window_ms``)."""
    return _timing.window_ms(fn, reps, "cuda")


def make_traffic(tcfg, n: int, dev, gen: torch.Generator):
    """n frames of mixed constellations 1..4 filled to capacity, drawn as
    bench.py draws them, and the padded, noisy stream carrying them (the
    port's bench builds its stream so: ``bench.traffic``, ``bench.make_stream``)."""
    cnst, plen, payload = bench.traffic(tcfg, n)
    sent = {"payload": torch.as_tensor(payload, device=dev),
            "payload_len": torch.as_tensor(plen, device=dev),
            "cnst_id": torch.as_tensor(cnst, device=dev),
            "frame_no": torch.arange(n, device=dev, dtype=torch.int32) % 4096}
    return bench.make_stream(transmitter.build_tx(tcfg, dev), cnst, plen, payload, gen), sent


def kernel_vs_plain(cases: dict, p_scale: float = 1.0) -> float:
    """The Schmidl-Cox kernel against its plain PyTorch version on each
    stream of ``cases``; returns the largest |dP| or |dM|.  ``p_scale``:
    the factor by which the streams' power, and so P and its float32
    rounding, exceed a unit stream's; |dP| is taken relative to it."""
    max_err = 0.0
    for name, r in cases.items():
        P, M = sync_cuda.timing_metric_cuda(r)
        P0, M0 = sync._timing_metric_torch(r)
        torch.cuda.synchronize()
        check(P.shape == P0.shape and M.shape == M0.shape, f"metric shape on {name}")
        check(bool(torch.isfinite(M).all()), f"metric not finite on {name}")
        dp = (P - P0).abs().max().item() / p_scale
        dm = (M - M0).abs().max().item()
        print(f"[kernel] {name} {tuple(r.shape)}: max|dP|={dp:.3e} max|dM|={dm:.3e}")
        check(dp <= P_ATOL and dm <= M_ATOL, f"kernel vs plain on {name}: dP={dp} dM={dm}")
        max_err = max(max_err, dp, dm)
    return max_err


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
    # one nvcc each, side by side
    _cuda_build.build_all(sync_cuda.build, scans_cuda.build, tb_cuda.build, equalizer_cuda.build,
                          feedback_cuda.build, ldpc_cuda.build, llr_cuda.build, cw_cuda.build,
                          k7_bench.build_bench, phy_converge.build)
    print(f"[build] csrc/sync_metric.cu -> {sync_cuda.library_path().name}, csrc/stream_scans.cu "
          f"-> {scans_cuda.library_path().name}, csrc/tb_ring.cu -> {tb_cuda.library_path().name}, "
          f"csrc/equalizer.cu -> {equalizer_cuda.library_path().name}, csrc/feedback_scan.cu -> "
          f"{feedback_cuda.library_path().name}, csrc/ldpc_bp.cu -> {ldpc_cuda.library_path().name}, "
          f"csrc/soft_demap.cu -> {llr_cuda.library_path().name}, csrc/codewords.cu -> "
          f"{cw_cuda.library_path().name}, native/phy_converge.cpp (g++) -> "
          f"{phy_converge.library_path().name} in {time.perf_counter() - t0:.2f} s")
    for lib in (sync_cuda.library_path(), scans_cuda.library_path(), tb_cuda.library_path(),
                equalizer_cuda.library_path(), feedback_cuda.library_path(), ldpc_cuda.library_path(),
                llr_cuda.library_path(), cw_cuda.library_path()):
        log = lib.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if line.strip():
                print(f"[build] {line.strip()}")

    BP.install()  # every BP call of every phase from here on is held to its K3 launches
    GATHER.install()  # and every gather-form call to its K8 launch
    LLR.install()  # and every closed-form frame_llrs call on the card to its K9 launch
    CW.install()  # and every codeword extraction on the card to its K10 launch

    cfg = cfgmod.make_rx_config(None, frame_length=FRAME_LENGTH)
    tcfg = cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH)
    rxp = receiver.build_rx(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stream, sent = make_traffic(tcfg, B, dev, gen)
    n_main = stream.shape[0]
    print(f"[slice] B={B} frame_length={FRAME_LENGTH} frame_samples={cfg.frame_samples} "
          f"stream N={n_main}", flush=True)

    # ---- 3. kernel vs plain on the card ----
    # streams of the kernel checks that came later draw from a generator of
    # their own, so the traffic and noise of every phase stay as they were
    gen_k = torch.Generator(device=dev).manual_seed(SEED + 1)
    randn = lambda *shape, g=gen_k: torch.randn(shape, generator=g, device=dev, dtype=torch.complex64)
    tile = sync_cuda.TILE
    max_err = kernel_vs_plain({
        "main": stream, "ragged_9000": randn(9000, g=gen), "ragged_8256": randn(8256, g=gen),
        "batch_4xN": randn(4, n_main, g=gen), "one_output": randn(65), "one_tile": randn(tile + 64),
        "one_tile_and_one": randn(tile + 65), "odd_rows_3x9001": randn(3, 9001),
        "stream_block": randn(*metric_bench.SHAPES["stream_block"]),
        "zeros": torch.zeros(3, 5000, dtype=torch.complex64, device=dev)})
    max_err = max(max_err, kernel_vs_plain({"scaled_1e3": 1e3 * randn(3, 9001)}, p_scale=1e6))

    equalizer_vs_plain(dev)

    # ---- 4. the slice ----
    reset_counts()
    out = rx_step(rxp, stream, B)
    torch.cuda.synchronize()
    launches = sync_cuda.timing_metric_cuda.LAUNCHES
    EQ.counted(1, "uncoded slice")
    print(f"[slice] kernel launches in the uncoded slice: Schmidl-Cox metric {launches}, equalizer "
          f"{equalizer_cuda.equalize_frame_cuda.LAUNCHES}")
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

    with EqualizerCheck(f"uncoded B={B}"):
        rx_step(rxp, stream, B)

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
    census(f"uncoded B={B}", {
        "detect_and_extract": lambda: receiver.detect_and_extract(stream, cfg, B),
        "demodulate": lambda: receiver.demodulate(rxp, frames),
        "equalize_passes (4 of them the equalizer kernel)": lambda: receiver.equalize_passes(rxp, spectra, taps),
        "demap_and_verify": lambda: receiver.demap_and_verify(rxp, pay_eq, fields, header_ok, cnst, carr_off),
    }, med, card)

    # kernel against the plain metric (plain, kernel, kernel, plain) at the
    # main path's N and at a streaming block, L2 cold; the card is `card`
    timed = metric_bench.measure("uncoded_step", stream, gen_k)
    metric_bench.measure("stream_block", randn(*metric_bench.SHAPES["stream_block"]), gen_k)
    print(f"[timing] after timing: {smi('clocks.sm,power.draw,temperature.gpu')} ({card})", flush=True)
    del stream, out, small, got, want, frames, spectra, pay_eq

    # ---- 6-7. the coded path ----
    BP.tag = "6-7 coded batch"
    launches_coded, max_err_coded, bp_paths = coded_phase(dev, gen, card)
    print(f"[timing] after coded timing: {smi('clocks.sm,power.draw,temperature.gpu')}")

    print(f"[timing] schmidl_cox_metric: launches a step 1 uncoded ({launches} counted), 1 coded "
          f"({launches_coded} counted); at N={n_main} cold L2 {timed['cold_ms']:.4f} ms by events (the kernel's time is "
          f"the {timed['kernel_ms_by']} reading), warm L2 "
          f"{timed['warm_l2_ms']:.4f} ms, profiler {timed['profiler_kernel_ms'] or float('nan'):.4f} ms, bound "
          f"{timed['bound_ms']:.4f} ms for {timed['bytes']} bytes, library call: none")
    # ---- 8-12. the streaming sessions ----
    BP.tag = "8-12 streams"
    stream_launches, stream_blocks, max_err_stream, scan_kernels, tb_kernel = stream_phases(dev, card)
    print(f"[timing] after the streaming phases: {smi('clocks.sm,power.draw,temperature.gpu')}")
    # ---- 13-17. channels, bursts, links ----
    BP.tag = "13-17 slice D"
    d_counts, d_steps, d_blocks, max_err_d = slice_d_phases(dev, card)
    stream_launches += d_counts[0]
    max_err_stream = max(max_err_stream, max_err_d)
    scan_blocks = stream_blocks + d_blocks
    for i, entry in enumerate(scan_kernels):
        entry["launches"] += d_counts[i + 1]
        entry["launches_per_step"] = entry["launches"] / scan_blocks
    stream_blocks += d_steps + d_blocks
    print(f"[timing] after the slice D phases: {smi('clocks.sm,power.draw,temperature.gpu')}")
    BP.tag = "22 telemetry"
    telemetry_phase(dev, card)
    BP.tag = "23 wire compat"
    wire_entry = wire_phase(dev, card)
    # ---- 24. slice E: the sharded session ----
    BP.tag = "24 sharded"
    shard = sharded_phase(dev, card)
    tot = shard["totals"]
    launches += tot["k1"]
    stream_blocks += tot["blocks"]
    scan_blocks += tot["blocks"]
    for entry, key in zip(scan_kernels, ("trigger_lock_scan", "frame_accounting")):
        entry["launches"] += tot[key]
        entry["launches_per_step"] = entry["launches"] / scan_blocks
        entry["max_abs_err"] = max(entry["max_abs_err"], shard["max_abs_err"])
        entry["batched"] = dict(shard["times"][key], launches=tot[key],
                                launches_per_block=tot[key] / tot["blocks"])
    tb_kernel["launches"] += tot["tb_reassemble"]
    tb_kernel["max_abs_err"] = max(tb_kernel["max_abs_err"], shard["max_abs_err"])
    tb_kernel["batched"] = dict(shard["times"]["tb_reassemble"], launches=tot["tb_reassemble"],
                                launches_per_block=tot["tb_reassemble"] / tot["tb_blocks"])
    # ---- 25. slice F: the app layer ----
    BP.tag = "25 app"
    app = app_phase(dev, card)
    launches += app["k1"][0]
    stream_blocks += app["k1"][1]
    for entry, key in zip(scan_kernels, ("lock", "acct")):
        entry["launches"] += app[key][0]
        entry["launches_per_step"] = entry["launches"] / (scan_blocks + app[key][1])
    tb_kernel["launches"] += app["tb"][0]
    # ---- 26. slice G: the live-I/O tools and K7 ----
    BP.tag = "26 live I/O"
    k7_entry = live_io_phase(dev, card)
    # ---- 27. slice H: the measuring tools and the LDPC leftovers ----
    BP.tag = "27 slice H"
    h = slice_h_phase(dev, card)
    launches += h["k1"][0]
    stream_blocks += h["k1"][1]
    for entry, key in zip(scan_kernels, ("lock", "acct")):
        entry["launches"] += h[key][0]
        entry["launches_per_step"] = entry["launches"] / (scan_blocks + app[key][1] + h[key][1])
    # ---- 28. slice I: the bench ----
    BP.tag = "28 bench"
    bn = bench_phase(dev, card, med)
    launches += bn["k1"][0]
    stream_blocks += bn["k1"][1]
    # ---- 29. slice J: K3 ----
    BP.tag = "29 K3"
    k3_entry = k3_phase(dev, card, bp_paths)
    # ---- 30. slice K: K8 ----
    k8_entry = k8_phase(dev, card, torch.Generator(device=dev).manual_seed(SEED + 30))
    # ---- 31. slice L: K9 ----
    BP.tag = "31 K9"
    k9_entry = k9_phase(dev, card, bp_paths)
    # ---- 32. K10 ----
    BP.tag = "32 K10"
    k10_entry = k10_phase(dev, card, bp_paths)
    k7_entry.update(launches=K7.launches, launches_per_step=K7.launches / K7.calls, max_abs_err=K7.max_err)
    eq_entry = time_equalizer(dev, card)
    print(card)
    print(json.dumps({"kernels": [{
        "name": "schmidl_cox_metric", "route": "cuda",
        "source": "gr_dtl_tpu_torch/csrc/sync_metric.cu",
        "replaces": "gr_dtl_tpu/ops/sync_pallas.py:149",
        "launches": launches + launches_coded + stream_launches,
        # one uncoded step, one coded step and the streams' blocks (the impaired batch and the
        # burst sessions' among them) were counted
        "launches_per_step": (launches + launches_coded + stream_launches) / (2 + stream_blocks),
        "max_abs_err": max(max_err, max_err_coded, max_err_stream),
        "ms": timed["kernel_ms"], "ms_by": timed["kernel_ms_by"], "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
        "bound_by": "bytes", "library_ms": None}] + scan_kernels + [tb_kernel, eq_entry, wire_entry,
                                                                    k7_entry, k3_entry, k8_entry,
                                                                    k9_entry, k10_entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def coded_params(alists, dev, frame_length=FRAME_LENGTH):
    """(tx config, rx config, TxParams, RxParams) of examples/config_fec.json
    with the given alists (one code, or a bank) on ``dev``."""
    tcfg = cfgmod.make_tx_config(str(FEC_CONFIG), frame_length=frame_length)
    rcfg = cfgmod.make_rx_config(str(FEC_CONFIG), frame_length=frame_length)
    Hs = [alist.load_alist(str(ROOT / "examples" / a)) for a in alists]
    fec = fec_chain.build_fec(tcfg, Hs if len(Hs) > 1 else Hs[0], dev)
    return tcfg, rcfg, transmitter.build_tx(tcfg, dev, fec), receiver.build_rx(rcfg, dev, fec)


def coded_tx(txp, cnst: np.ndarray, fec_id: np.ndarray | None, seed: int = SEED):
    """Frames filled to their transport block's user bytes, drawn as
    tools/bench_fec.py draws them: (flat TX samples, what was sent)."""
    fec = txp.fec
    dev = fec.m_t.device
    n = cnst.shape[0]
    rng = np.random.RandomState(seed)
    ub = fec.user_bytes_tab2[1 if fec_id is None else fec_id, cn.BITS_PER_SYMBOL[cnst]]
    payload = np.zeros((n, fec.max_payload_bytes), np.uint8)
    for i in range(n):
        payload[i, : ub[i]] = rng.randint(0, 256, ub[i])
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    sent = {"payload": torch.as_tensor(payload, device=dev), "payload_len": t(ub),
            "cnst_id": t(cnst), "frame_no": torch.arange(n, device=dev, dtype=torch.int32) % 4096}
    out = transmitter.tx_frames(txp, sent["payload"], sent["payload_len"], sent["cnst_id"],
                                t(np.zeros(n)), sent["frame_no"], None,
                                fec_id=None if fec_id is None else t(fec_id))
    return out.samples.reshape(-1), sent


def noisy(samples: torch.Tensor, snr_db: float, gen: torch.Generator):
    """The stream at snr_db of the MEASURED TX power (QPSK frames run at
    ~0.28, far from mixed traffic's ~0.8), with a zero tail."""
    sig_p = float((samples.abs() ** 2).mean())
    noise_v = float(np.sqrt(sig_p / 10 ** (snr_db / 10)))
    s = torch.cat([samples, torch.zeros(STREAM_TAIL, dtype=torch.complex64, device=samples.device)])
    return channel.awgn(s, noise_v, generator=gen), noise_v


def check_decoded(out, sent, what: str) -> None:
    n = sent["cnst_id"].shape[0]
    n_ok = int(out.crc_ok.sum())
    check(n_ok == n and bool(out.header_ok.all()), f"{what}: only {n_ok} of {n} frames decoded")
    for k, v in sent.items():
        check(torch.equal(getattr(out, k), v), f"{what}: decoded {k} differs from what was sent")


def per_codeword_iters(rxp, stream, n):
    """BP iterations of every real codeword of the first n frames (QPSK)
    of the stream, on the stream's device."""
    frames, _ = receiver.detect_and_extract(stream, rxp.cfg, n)
    out, fec_in = receiver.rx_frames(rxp, frames, defer_fec=True)
    fec = rxp.fec
    cw = fec_chain.codeword_llrs(fec, fec_in["llrs"], out.cnst_id)
    _, iters, _ = ldpc.decode_mm(cw.reshape(-1, fec.n), fec.code)
    return iters.reshape(n, fec.max_ncws)[:, : int(fec.ncws_tab2[1, 2])]


def coded_stages(rxp, rcfg, stream, reps: int = 5) -> tuple:
    """The coded receive step's stages timed with CUDA events, BP inside
    fec_frame_decode and alone: (median ms by stage over ``reps`` steps, the
    last BP call's iterations, its codewords)."""
    fec = rxp.fec
    names = ("detect_and_extract", "demodulate", "equalize_passes",
             "soft LLRs + serialisation", "fec_frame_decode", "BP (decode_mm alone)")
    stages = {k: [] for k in names}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        ev[0].record()
        frames, _ = receiver.detect_and_extract(stream, rcfg, B_FEC)
        ev[1].record()
        spectra, carr_off, taps = receiver.demodulate(rxp, frames)
        ev[2].record()
        pay_eq, fields, header_ok, cnst = receiver.equalize_passes(rxp, spectra, taps)
        ev[3].record()
        out_d, fec_in = receiver.demap_and_verify(rxp, pay_eq, fields, header_ok, cnst,
                                                  carr_off, defer_fec=True)
        ev[4].record()
        fec_chain.fec_frame_decode(fec, fec_in["llrs"], cnst, fec_in["tb_payload"])
        ev[5].record()
        cw = fec_chain.codeword_llrs(fec, fec_in["llrs"], cnst).reshape(-1, fec.n)
        ev[6].record()
        _, iters, _ = ldpc.decode_mm(cw, fec.code)
        ev[7].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names[:5]):
            stages[k].append(ev[i].elapsed_time(ev[i + 1]))
        stages[names[5]].append(ev[6].elapsed_time(ev[7]))
    return {k: sorted(v)[len(v) // 2] for k, v in stages.items()}, iters, cw.shape[0]


def coded_phase(dev, gen, card) -> tuple:
    """Phases 6 and 7; returns the Schmidl-Cox kernel's launches in the
    coded path's run, its largest error against the plain metric on the
    coded streams, and what phase 29 holds K3 to: the arguments of the BP
    calls the steps at 25 and 11 dB and the two-code bank's step made, the
    receiver and streams, and phase 7's step medians."""
    tcfg, rcfg, txp, rxp = coded_params(BANK_ALISTS[1:], dev)
    fec = rxp.fec
    cpu_rxp = coded_params(BANK_ALISTS[1:], "cpu")[3]
    qpsk = np.full(B_FEC, 2, np.int32)  # the QPSK point of the FEC ladder
    samples, sent = coded_tx(txp, qpsk, None)
    streams = {snr: noisy(samples, snr, gen) for snr in SNRS_DB}
    print(f"[coded] B={B_FEC} frame_length={FRAME_LENGTH} frame_samples={rcfg.frame_samples} "
          f"stream N={streams[25.0][0].shape[0]}; code n={fec.n} k={fec.k} m={fec.m}, "
          f"{fec.max_ncws} codewords a frame ({B_FEC * fec.max_ncws} a step), "
          f"{int(fec.user_bytes_tab[2])} user bytes a QPSK frame; noise voltage "
          + ", ".join(f"{v:.4f} at {snr:g} dB" for snr, (_, v) in streams.items()), flush=True)

    # ---- 6. correctness ----
    max_err = kernel_vs_plain({f"coded_{snr:g}dB": s for snr, (s, _) in streams.items()})
    metric_bench.measure("coded_step", streams[25.0][0],
                         torch.Generator(device=dev).manual_seed(SEED + 2))
    stream = streams[25.0][0]
    reset_counts()
    out = rx_step(rxp, stream, B_FEC)
    torch.cuda.synchronize()
    launches = sync_cuda.timing_metric_cuda.LAUNCHES
    EQ.counted(1, "coded slice")
    paths = {"25 dB": BP.last}
    print(f"[coded] kernel launches in the coded slice: Schmidl-Cox metric {launches}, equalizer "
          f"{equalizer_cuda.equalize_frame_cuda.LAUNCHES}, K3 (BP) {ldpc_cuda.bp_decode_cuda.LAUNCHES}")
    check(launches > 0, "the coded slice did not launch the Schmidl-Cox kernel")
    check(ldpc_cuda.bp_decode_cuda.LAUNCHES == 1, "the coded slice did not launch K3 once")
    check(out.payload.shape == (B_FEC, fec.max_payload_bytes), "coded payload shape")
    check(bool(torch.isfinite(out.soft_syms).all()) and bool(torch.isfinite(out.avg_iters).all()),
          "coded soft symbols or BP iterations not finite")
    check_decoded(out, sent, "coded 25 dB")
    print(f"[coded] 25 dB: crc_ok {int(out.crc_ok.sum())}/{B_FEC}, fec_ok "
          f"{int(out.fec_ok.sum())}/{B_FEC}, mean BP iterations {out.avg_iters.mean().item():.4f}, "
          f"snr_db median {out.snr_db.median().item():.2f}")

    small, _ = noisy(coded_tx(txp, qpsk[:16], None, seed=1)[0], 25.0, gen)
    got = rx_step(rxp, small, 16)
    want = rx_step(cpu_rxp, small.cpu(), 16)
    for k in ("payload", "payload_len", "crc_ok", "header_ok", "frame_no", "cnst_id",
              "feedback_cnst", "fec_echo", "carr_offset", "fec_ok", "avg_iters"):
        check(torch.equal(getattr(got, k).cpu(), getattr(want, k)), f"coded 16-frame {k}: card vs CPU")
    print("[coded] 16 frames at 25 dB, card vs CPU: ints, bools and avg_iters equal")

    with EqualizerCheck(f"coded B={B_FEC} at 25 dB"):
        rx_step(rxp, stream, B_FEC)
    reset_counts()
    out = rx_step(rxp, streams[11.0][0], B_FEC)
    EQ.counted(1, "coded slice at 11 dB")
    paths["11 dB"] = BP.last
    check(ldpc_cuda.bp_decode_cuda.LAUNCHES == 1, "the coded slice at 11 dB did not launch K3 once")
    with EqualizerCheck(f"coded B={B_FEC} at 11 dB") as chk:
        rx_step(rxp, streams[11.0][0], B_FEC)
    with plain_equalizer():
        out_plain = rx_step(rxp, streams[11.0][0], B_FEC)
    n_crc, n_crc_plain = int(out.crc_ok.sum()), int(out_plain.crc_ok.sum())
    print(f"[coded] 11 dB: crc rate {out.crc_ok.float().mean().item():.4f} ({n_crc}/{B_FEC}; with the "
          f"equalizer's plain loop on the same stream {n_crc_plain / B_FEC:.4f}, {n_crc_plain}/{B_FEC}), header_ok "
          f"{int(out.header_ok.sum())}/{B_FEC}, fec_ok {int(out.fec_ok.sum())}/{B_FEC}, mean BP "
          f"iterations {out.avg_iters.mean().item():.4f}")
    # a row that parted from the plain loop at a decision boundary may decode otherwise
    check(abs(n_crc - n_crc_plain) <= chk.boundary_rows,
          f"coded 11 dB: {n_crc} frames pass their CRC, {n_crc_plain} on the plain equalizer loop")
    check(bool(torch.isfinite(out.avg_iters).all()), "coded 11 dB BP iterations not finite")
    small, _ = noisy(coded_tx(txp, qpsk[:32], None, seed=2)[0], 11.0, gen)
    got = rx_step(rxp, small, 32)
    want = rx_step(cpu_rxp, small.cpu(), 32)
    for k in ("crc_ok", "header_ok"):
        check(torch.equal(getattr(got, k).cpu(), getattr(want, k)), f"coded 32-frame {k}: card vs CPU")
    it_card = per_codeword_iters(rxp, small, 32).cpu()
    it_cpu = per_codeword_iters(cpu_rxp, small.cpu(), 32)
    share = (it_card == it_cpu).float().mean().item()
    print(f"[coded] 32 frames at 11 dB, card vs CPU: crc_ok and header_ok equal; per-codeword BP "
          f"iterations equal on {share:.4f} of {it_card.numel()} codewords "
          f"(max |d| {(it_card - it_cpu).abs().max().item()})")
    # The LLRs entering BP differ between the card and the CPU by float32
    # rounding (cuBLAS and CPU matmuls in the DFT and LS steps, soft
    # symbols within ~1e-4), and at 11 dB many codewords sit near BP's
    # waterfall, where such a difference can move the iteration at which
    # a syndrome first passes by one.  Codewords far from it (converged at
    # once, or never) agree exactly.  So at least 95% must agree.
    check(share >= 0.95, f"per-codeword BP iterations agree on only {share:.4f}")

    for name, alists, with_ids in (("mixed constellations", BANK_ALISTS[1:], False),
                                   ("two-code bank", BANK_ALISTS, True)):
        _, _, txp_s, rxp_s = coded_params(alists, dev)
        rng = np.random.RandomState(SEED)
        cnst = np.tile(np.arange(1, 5, dtype=np.int32), B_FEC_SMALL // 4)
        fec_id = rng.randint(1, 3, B_FEC_SMALL).astype(np.int32) if with_ids else None
        samples_s, sent_s = coded_tx(txp_s, cnst, fec_id)
        out = rx_step(rxp_s, noisy(samples_s, SNR_MIXED_DB, gen)[0], B_FEC_SMALL)
        check_decoded(out, sent_s, f"coded B={B_FEC_SMALL} {name}")
        if with_ids:
            paths["two-code bank"] = BP.last
        print(f"[coded] B={B_FEC_SMALL} {name} (constellations 1..4"
              f"{', fec_id 1..2' if with_ids else ''}) at {SNR_MIXED_DB:g} dB: all frames decoded, mean BP "
              f"iterations {out.avg_iters.mean().item():.4f}", flush=True)
        del txp_s, rxp_s, out

    # ---- 7. timing ----
    step_med = {}
    n_samples = B_FEC * rcfg.frame_samples
    for snr, (stream, _) in streams.items():
        for _ in range(2):
            rx_step(rxp, stream, B_FEC)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = sorted(cuda_ms(lambda: rx_step(rxp, stream, B_FEC), STEPS_PER_WINDOW)
                         for _ in range(WINDOWS))
        med = step_med[snr] = step_ms[len(step_ms) // 2]
        print(f"[coded-timing] {snr:g} dB: RX step (detect_and_extract + rx_frames), {WINDOWS} "
              f"windows of {STEPS_PER_WINDOW} steps: median {med:.3f} ms, min {step_ms[0]:.3f}, "
              f"max {step_ms[-1]:.3f}; {n_samples / med / 1e3:.2f} Msamples/s at the median; "
              f"all windows ms {[round(x, 3) for x in step_ms]}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

        stages, iters, n_cw = coded_stages(rxp, rcfg, stream)
        print(f"[coded-timing] {snr:g} dB per stage, median of 5 (ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f"; BP message updates run {int(iters.max())} (of 15), on {n_cw} "
              f"codewords, mean iterations per codeword {iters.float().mean().item():.4f}",
              flush=True)
        frames, _ = receiver.detect_and_extract(stream, rcfg, B_FEC)
        spectra, carr_off, taps = receiver.demodulate(rxp, frames)
        pay_eq, fields, header_ok, cnst = receiver.equalize_passes(rxp, spectra, taps)
        out_d, fec_in = receiver.demap_and_verify(rxp, pay_eq, fields, header_ok, cnst, carr_off,
                                                  defer_fec=True)
        census(f"coded B={B_FEC} at {snr:g} dB", {
            "detect_and_extract": lambda: receiver.detect_and_extract(stream, rcfg, B_FEC),
            "demodulate": lambda: receiver.demodulate(rxp, frames),
            "equalize_passes (4 of them the equalizer kernel)": lambda: receiver.equalize_passes(rxp, spectra, taps),
            "soft LLRs + serialisation": lambda: receiver.demap_and_verify(
                rxp, pay_eq, fields, header_ok, cnst, carr_off, defer_fec=True),
            "fec_frame_decode": lambda: fec_chain.fec_frame_decode(fec, fec_in["llrs"], cnst, fec_in["tb_payload"]),
        }, med, card)
    return launches, max_err, {"calls": paths, "rxp": rxp, "rcfg": rcfg, "streams": streams,
                               "step_ms": step_med}


# ---------------------------------------------------------------------------
# phases 8-12: the streaming sessions
# ---------------------------------------------------------------------------

STREAM_F = (16, 256, 1024)
STREAM_OFFSET = 300      # frames start here, so every block boundary cuts one
STREAM_BLOCKS = {16: 64, 256: 15, 1024: 15}  # traffic blocks and one of idle air at the end
MEGA_F, MEGA_K = 16, 16  # the K-block receiver runs at this F
CODED_F, DUPLEX_F = 64, 8  # frames a block of the coded stream; of TX -> RX and the duplex
WARM_BLOCKS = 2
SCAN_T = (16, 256, 1024)
SCAN_TIME_T = (1, 16, 32, 256, 1024)  # T = 1: the launch floor; 32: the sharded path's T
HBM_BYTES_PER_S = metric_bench.HBM_BYTES_PER_S
FP32_OPS_PER_S = 67e12   # NVIDIA H100 SXM data sheet, outside the tensor cores


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else 0.5 * (xs[len(xs) // 2 - 1] + xs[len(xs) // 2])


# warm-up before a profiled or traced window, by time: the profiler misses the launches of its
# first milliseconds, more of them the more profiler sessions the process has had (2 of 18
# launches in a fresh process, 12 of 18 after some sixty sessions), and a count of warm calls of
# a short fn can end inside them (64 calls of a 32-code decode_bank_mm, ~3 ms, left a window
# empty); a window that comes back empty is taken again, warmed for longer.  MARK is the kernel
# torch.cuda._sleep launches: nothing else in the script does
WARM_MS, MARK = _timing.WARM_MS, _timing.MARK


def mark() -> None:
    """A marker on the device's timeline, launched just before a traced
    window: the window's device work is what starts after it, on the
    device's own clock (``window_events``)."""
    torch.cuda._sleep(1)


def window_events(events, span: str) -> list:
    """The device kernels and copies of a traced window: those that start
    after its marker (``mark``) on the device's timeline.  A trace puts the
    host's and the device's clocks on one axis only so nearly: kernels of
    warm calls synchronised before the host span ``span`` opened have been
    seen to start inside it.  Without a marker in the trace (a profiler that
    dropped it), the window opens with the host span, as it used to."""
    dev = [e for e in events if str(e.device_type).endswith("CUDA") and e.name != span]
    marks = [e.time_range.start for e in dev if MARK in e.name]
    if marks:
        return [e for e in dev if e.time_range.start > max(marks) and MARK not in e.name]
    print(f"[trace] no marker kernel in the trace of {span}: its window opens with the host span", flush=True)
    start = host_span(events, span).start
    return [e for e in dev if e.time_range.start >= start]


def launch_grids(prof, kernel: str) -> list:
    """The grid ([x, y, z] blocks) of every launch of the kernel named so
    in a traced window (launched after its marker, ``mark``), as the
    profiler's trace records it: the ``grid`` of a kernel event in the
    trace exported as JSON (None where an event holds none).  A launch's
    place is its CUDA correlation id, which grows with each launch (the
    exported events' times have read 0 on the card)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text()).get("traceEvents", [])
    kernels = [(e.get("args", {}).get("correlation", -1), e) for e in events if e.get("cat") == "kernel"]
    start = max((c for c, e in kernels if MARK in e.get("name", "")), default=None)
    return [e.get("args", {}).get("grid") for c, e in kernels
            if kernel in e.get("name", "") and (start is None or c > start)]


def warm(fn, warm_ms: float, at_least: int = 1) -> None:
    """fn called, each call synchronised, at least ``at_least`` times and
    until ``warm_ms`` have passed."""
    t0, n = time.perf_counter(), 0
    while n < at_least or (time.perf_counter() - t0) * 1e3 < warm_ms:
        fn()
        torch.cuda.synchronize()
        n += 1


def profiled(fn, sacrifice: bool = False):
    """One call of fn under torch.profiler: (wall ms, device busy ms, device
    kernels and copies launched), from the device's timeline.

    ``sacrifice``: fn is first called inside the profiler for ``WARM_MS``
    (at least one call), and only what the device starts after the warm
    calls is counted (``mark``); a window that saw no device work is taken
    again, warmed for longer.  For an fn without side effects.  Without
    it, fn is called once (a block of thousands of launches, of which the
    profiler may miss the first few), and what starts after the host opened
    the call is counted."""
    from torch.profiler import ProfilerActivity, profile, record_function
    for warm_ms in WARM_MS if sacrifice else (None,):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if warm_ms is not None:
                warm(fn, warm_ms)
                mark()
            with record_function("profiled_call"):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        if sacrifice:
            dev_events = window_events(events, "profiled_call")
        else:
            start = host_span(events, "profiled_call").start
            dev_events = [e for e in events if str(e.device_type).endswith("CUDA")
                          and e.name != "profiled_call" and e.time_range.start >= start]
        if dev_events:
            break
    busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    return wall, busy, len(dev_events)


def kernel_profiler_ms(fn, kernel_name: str, reps: int):
    """Mean device duration (ms) of the kernel named so over reps calls of
    fn, after ``WARM_MS`` of calls inside the profiler: only the launches
    that start after the warm calls count (``mark``).  A window that saw
    none is taken again, warmed for longer, and four such windows fail the
    run."""
    from torch.profiler import ProfilerActivity, profile, record_function
    for warm_ms in WARM_MS:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warm(fn, warm_ms)
            mark()
            with record_function("kernel_window"):
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        found = [e.time_range.elapsed_us() for e in window_events(prof.events(), "kernel_window")
                 if kernel_name in e.name]
        if found:
            return sum(found) / len(found) / 1e3
    check(False, f"the profiler saw no {kernel_name} in {len(WARM_MS)} windows of {reps} calls")


def lock_inputs(T: int, seed: int, dev):
    """Candidates with a jitter of +-6 around the period and runs of misses
    longer than UNLOCK_AFTER."""
    rng = np.random.RandomState(seed)
    cand = (np.arange(T) * 1840 + STREAM_OFFSET + rng.randint(-6, 7, T)).astype(np.int32)
    found = rng.rand(T) > 0.2
    for start in rng.randint(0, T, max(T // 40, 1)):
        found[start: start + 7] = False
    return torch.as_tensor(cand, device=dev), torch.as_tensor(found, device=dev)


def acct_inputs(T: int, seed: int, no0: int, dev):
    rng = np.random.RandomState(seed)
    ok = rng.rand(T) > 0.3
    nos = ((no0 + np.arange(T) + np.cumsum(rng.rand(T) > 0.9)) % 4096).astype(np.int32)
    nos[~ok] = rng.randint(0, 4096, int((~ok).sum()))
    return torch.as_tensor(nos, device=dev), torch.as_tensor(ok, device=dev)


def int_err(pairs) -> int:
    """Largest |a - b| over pairs of integer or bool tensors of equal shape."""
    worst = 0
    for a, b in pairs:
        check(a.shape == b.shape and a.dtype == b.dtype, f"shape or type: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        if a.numel():
            worst = max(worst, int((a.long() - b.long()).abs().max()))
    return worst


def lock_pairs(state, plain, trig, trig0, valid, valid0):
    """Every output and every state word of the lock scan, kernel beside plain."""
    return [(trig, trig0), (valid, valid0), (state.locked, plain.locked),
            (state.expected, plain.expected), (state.sync_count, plain.sync_count),
            (state.miss_count, plain.miss_count)]


# the sizes the main paths hand the scans (F of the streams, of the coded
# stream, of TX -> RX and the duplex) and the edges
SCAN_CHECK_T = sorted({1, 5, 4096, DUPLEX_F, CODED_F, *STREAM_F})


def scans_vs_plain(dev) -> int:
    """Phase 8: both scan kernels against their plain loops, state carried
    over three calls; returns the largest |kernel - plain| over every
    output and state word, which must be 0."""
    worst = 0
    for T in SCAN_CHECK_T:
        state = plain = streaming.initial_lock_state(dev)
        for call in range(3):
            c, f = lock_inputs(T, 10 * T + call, dev)
            state, (trig, valid) = streaming.trigger_lock_scan(state, c, f, 1840)
            plain, (trig0, valid0) = streaming._trigger_lock_scan_torch(plain, c, f, 1840)
            err = int_err(lock_pairs(state, plain, trig, trig0, valid, valid0))
            check(err == 0, f"trigger_lock_scan kernel vs plain at T={T}, call {call}: off by {err}")
            worst = max(worst, err)
            state = state._replace(expected=state.expected - T * 1840)
            plain = plain._replace(expected=plain.expected - T * 1840)
        for rule, start in (("received", -1), ("header", 4090)):
            exp = exp0 = torch.tensor(start, dtype=torch.int32, device=dev)
            for call in range(3):
                n, o = acct_inputs(T, T + call, 4000 + call * (T + 3), dev)  # wraps past 4095
                exp, lost, totals = metrics.frame_accounting(exp, n, o, rule)
                exp0, lost0, totals0 = metrics._frame_accounting_torch(exp0, n, o, rule)
                err = int_err([(lost, lost0), (totals, totals0), (exp, exp0)])
                check(err == 0, f"frame_accounting kernel vs plain, rule {rule}, T={T}, call {call}: "
                      f"off by {err}")
                worst = max(worst, err)
    print("[scans] trigger_lock_scan and frame_accounting (both rules) against their plain loops at "
          f"T = {SCAN_CHECK_T} over three carried calls: largest |kernel - plain| over every output "
          f"and state word {worst}", flush=True)
    return worst


def scans_on_path(cfg, F: int, stream: np.ndarray, results, dev, what: str) -> int:
    """Both scan kernels against their plain loops on the tensors the block
    step hands them: ``cand`` / ``found`` recomputed from blocks 1 and 2 of
    ``stream`` as ``StreamRx._step`` computes them (tail + block, the lock
    state carried and rebased), ``frame_no`` / ``ok`` taken from the
    receiver's own ``results`` of blocks 0..2 (the expectation carried from
    -1).  Returns the largest |kernel - plain|, which must be 0."""
    P, B = cfg.frame_samples, F * cfg.frame_samples
    tail = P + cfg.fft_len
    worst = 0
    state = plain = streaming.initial_lock_state(dev)
    for b in (1, 2):
        ext = torch.as_tensor(stream[b * B - tail:(b + 1) * B], device=dev)
        _, M = sync.timing_metric(ext, cfg.fft_len)
        cand = sync.frame_triggers(M, sync.fold_detect(M[:B], P, cfg.cp_len), P, F)
        found = M[torch.clamp(cand.long(), 0, M.shape[-1] - 1)] > 0.5
        state, (trig, valid) = streaming.trigger_lock_scan(state, cand, found, P)
        plain, (trig0, valid0) = streaming._trigger_lock_scan_torch(plain, cand, found, P)
        err = int_err(lock_pairs(state, plain, trig, trig0, valid, valid0))
        check(err == 0, f"{what}: trigger_lock_scan kernel vs plain on block {b}'s candidates: off by {err}")
        worst = max(worst, err)
        state = state._replace(expected=state.expected - B)
        plain = plain._replace(expected=plain.expected - B)
    exp = exp0 = torch.tensor(-1, dtype=torch.int32, device=dev)
    n_ok = 0
    for res in results[:3]:
        out, valid = res[0], res[1]
        ok = out.header_ok[:F] & torch.as_tensor(np.asarray(valid)[:F], device=dev)
        exp, lost, totals = metrics.frame_accounting(exp, out.frame_no[:F], ok)
        exp0, lost0, totals0 = metrics._frame_accounting_torch(exp0, out.frame_no[:F], ok)
        err = int_err([(lost, lost0), (totals, totals0), (exp, exp0)])
        check(err == 0, f"{what}: frame_accounting kernel vs plain on a block's frames: off by {err}")
        worst = max(worst, err)
        n_ok += int(ok.sum())
    check(n_ok > F, f"{what}: only {n_ok} decoded frames in the blocks the accounting was checked on")
    print(f"[scans] {what}: on the block step's own tensors at T={F} (candidates of blocks 1-2, frame "
          f"numbers of blocks 0-2, {n_ok} decoded) both scan kernels equal their plain loops: largest "
          f"|kernel - plain| {worst}", flush=True)
    return worst


# The sequential designs before the prefix-max scans, as PERF.md section 6
# records them (NVIDIA H100 80GB HBM3 at 700 W, profiler device time, us): a
# thread a stream walking its frames, one warp walking the TB records, and
# their batched forms.  Printed beside this run's times, never in its kernels line.
PERF_MD_EARLIER_US = {
    ("trigger_lock_scan", 1, 1): 1.31, ("trigger_lock_scan", 1, 16): 1.90,
    ("trigger_lock_scan", 1, 32): 2.77, ("trigger_lock_scan", 1, 256): 12.89,
    ("trigger_lock_scan", 1, 1024): 48.91, ("trigger_lock_scan", 64, 32): 5.15,
    ("frame_accounting", 1, 1): 1.17, ("frame_accounting", 1, 16): 1.57,
    ("frame_accounting", 1, 32): 2.18, ("frame_accounting", 1, 256): 9.67,
    ("frame_accounting", 1, 1024): 35.48, ("frame_accounting", 64, 32): 4.09,
    ("tb_reassemble", 1, 64): 12.10, ("tb_reassemble", 1, 256): 40.32,
    ("tb_reassemble", 1, 1024): 185.13, ("tb_reassemble", 8, 64): 15.94,
}


def earlier_note(name: str, S: int, n: int) -> str:
    """The earlier design's time at this shape, as PERF.md records it."""
    us = PERF_MD_EARLIER_US.get((name, S, n))
    return "earlier design: none recorded at this shape" if us is None else \
        f"earlier design {us:.2f} us as PERF.md records it, not this run"


def library_ms(fn, reps: int = 50) -> float:
    """Device ms a call of a PyTorch function: every CUDA kernel and copy of
    ``reps`` calls in a profiler window, summed, over the calls.  The window
    opens after warm calls inside the profiler, at a marker kernel
    (``_timing.profiled_windows``); four windows that saw nothing fail the run."""
    for events in _timing.profiled_windows(fn, reps):
        if events:
            return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3
    check(False, f"the profiler saw no device work in {len(WARM_MS)} windows of {reps} calls")


def cummax_ms(S: int, T: int, dev, ok=None) -> float:
    """torch.cummax over [S, T] int32 indices (-1 where ``ok`` is False): the
    library's prefix-max, the core of the accounting and of the TB walk, not
    the whole function of either."""
    idx = torch.arange(T, dtype=torch.int32, device=dev).repeat(S, 1)
    if ok is not None:
        idx = torch.where(ok.reshape(S, T), idx, -1)
    return library_ms(lambda: torch.cummax(idx, dim=-1))


def time_scans(dev, card) -> dict:
    """Phase 12, the scan kernels alone against their plain loops, in turns
    (plain, kernel, kernel, plain).  The kernels' wrappers allocate their
    outputs and launch through ctypes, so between events the host's enqueue
    is timed (named so); the kernel's own time is the profiler's device
    duration.  Beside them: the earlier design's time as PERF.md records
    it, and torch.cummax on the same frames' indices."""
    out = {}
    for T in SCAN_TIME_T:
        c, f = lock_inputs(T, T, dev)
        n, o = acct_inputs(T, T, 4000, dev)
        state = streaming.initial_lock_state(dev)
        packed = torch.stack([state.locked.int(), state.expected, state.sync_count, state.miss_count])
        exp = torch.tensor([-1], dtype=torch.int32, device=dev)
        calls = {
            "trigger_lock_scan": (lambda: scans_cuda.trigger_lock_scan_cuda(packed, c, f, 1840),
                                  lambda: streaming._trigger_lock_scan_torch(state, c, f, 1840),
                                  "trigger_lock_scan_kernel"),
            "frame_accounting": (lambda: scans_cuda.frame_accounting_cuda(exp, n, o),
                                 lambda: metrics._frame_accounting_torch(exp[0], n, o),
                                 "frame_accounting_kernel")}
        for name, (kern, plain, kname) in calls.items():
            kern(), plain()
            torch.cuda.synchronize()
            k_ev, p_ev = [], []
            for turn in ("plain", "kernel", "kernel", "plain"):
                if turn == "plain":
                    p_ev.append(cuda_ms(plain, 1 if T >= 256 else 3))  # one call is T iterations
                else:
                    k_ev.append(cuda_ms(kern, 200))
            k_prof = kernel_profiler_ms(kern, kname, 50)
            check(k_prof is not None, f"the profiler saw no {kname}")
            nbytes = scans_cuda.scan_bytes(T)[name]
            bound = max(nbytes / HBM_BYTES_PER_S, 12 * T / FP32_OPS_PER_S) * 1e3
            cm = cummax_ms(1, T, dev, o if name == "frame_accounting" else f)
            out[(name, T)] = {"ms": k_prof, "enqueue_ms": min(k_ev), "plain_ms": min(p_ev),
                              "bound_ms": bound, "bytes": nbytes, "cummax_ms": cm}
            print(f"[scan-timing] {name} T={T}: kernel {k_prof * 1e3:.2f} us device duration "
                  f"(profiler; {earlier_note(name, 1, T)}), {min(k_ev) * 1e3:.2f} us a call between events (the host's enqueue: "
                  f"3 allocations and a ctypes launch); plain loop {min(p_ev):.3f} ms; {nbytes} "
                  f"bytes, bound {bound * 1e6:.2f} ns (bytes); launch floor (T = 1) "
                  f"{out[(name, 1)]['ms'] * 1e3:.2f} us; torch.cummax on the [1, {T}] int32 indices "
                  f"{cm * 1e3:.2f} us, the prefix-max alone (library call: none computes the function) "
                  f"({card})", flush=True)
    return out


def make_stream(tcfg, n_frames: int, n_blocks: int, block_samples: int, dev, gen):
    """n_frames frames of mixed constellations 1..4 from sample
    STREAM_OFFSET on, padded with idle air to n_blocks blocks, plus AWGN:
    (the stream as host numpy, what was sent)."""
    rng = np.random.RandomState(SEED + n_frames)
    maxb = tcfg.max_frame_bytes()
    cnst = rng.randint(1, 5, size=n_frames).astype(np.int32)
    plen = np.array([tcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[c])) - 4 for c in cnst], np.int32)
    payload = rng.randint(0, 256, (n_frames, maxb)).astype(np.uint8)
    payload[np.arange(maxb)[None, :] >= plen[:, None]] = 0
    sent = {"payload": torch.as_tensor(payload, device=dev),
            "payload_len": torch.as_tensor(plen, device=dev),
            "cnst_id": torch.as_tensor(cnst, device=dev),
            "frame_no": torch.arange(n_frames, device=dev, dtype=torch.int32) % 4096}
    pad = torch.randint(0, 256, (n_frames, maxb), generator=gen, device=dev, dtype=torch.uint8)
    out = transmitter.tx_frames(transmitter.build_tx(tcfg, dev), sent["payload"],
                                sent["payload_len"], sent["cnst_id"],
                                torch.zeros(n_frames, dtype=torch.int32, device=dev),
                                sent["frame_no"], pad)
    n = n_blocks * block_samples
    s = torch.zeros(n, dtype=torch.complex64, device=dev)
    s[STREAM_OFFSET: STREAM_OFFSET + n_frames * tcfg.frame_samples] = out.samples.reshape(-1)
    return channel.awgn(s, NOISE_V, generator=gen).cpu().numpy(), sent


def run_receiver(rx, stream: np.ndarray, prefetch: bool = False):
    """Every dispatch of ``stream`` through ``rx`` (StreamRx, pipelined or
    K-block): per call the wall-clock ms (with the readback wait) and the
    CUDA-event ms of the device work enqueued in it, and the results in
    order.  ``prefetch``: block k+1's transfer is started before block k
    is processed."""
    D = rx.dispatch_samples
    chunks = [stream[i * D:(i + 1) * D] for i in range(len(stream) // D)]
    wall, results, events = [], [], []
    handle = rx.prefetch(chunks[0]) if prefetch else None
    for i, chunk in enumerate(chunks):
        nxt = rx.prefetch(chunks[i + 1]) if prefetch and i + 1 < len(chunks) else None
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        r = rx.process(handle if prefetch else chunk)
        e1.record()
        wall.append((time.perf_counter() - t0) * 1e3)
        events.append((e0, e1))
        handle = nxt
        if r is not None:
            results.append(r)
    if hasattr(rx, "drain"):
        results.extend(rx.drain())
    torch.cuda.synchronize()
    return wall, [a.elapsed_time(b) for a, b in events], results


def decoded(results, dev):
    """(frame_no, payload, payload_len, cnst_id) of the frames that were
    valid with a good CRC, in arrival order, and all the masks."""
    keep = torch.cat([torch.as_tensor(np.asarray(v & v.crc_ok), device=dev) for _, v in results])
    cat = lambda k: torch.cat([getattr(o, k) for o, _ in results])[keep]
    masks = {"valid": np.concatenate([np.asarray(v) for _, v in results]),
             "header_ok": np.concatenate([v.header_ok for _, v in results]),
             "crc_ok": np.concatenate([v.crc_ok for _, v in results])}
    return {k: cat(k) for k in ("frame_no", "payload", "payload_len", "cnst_id")}, masks


def same_as(results, want, what: str) -> None:
    """Bit for bit: the masks, frame numbers and payloads of every slot."""
    for k in ("valid", "header_ok", "crc_ok"):
        a, b = (np.concatenate([np.asarray(v) if k == "valid" else getattr(v, k) for _, v in rs])
                for rs in (results, want))
        check(np.array_equal(a, b), f"{what}: {k} differs from StreamRx's")
    for k in ("frame_no", "payload"):
        a, b = (torch.cat([getattr(o, k) for o, _ in rs]) for rs in (results, want))
        check(torch.equal(a, b), f"{what}: {k} differs from StreamRx's")


def reset_counts() -> None:
    for w in (sync_cuda.timing_metric_cuda, scans_cuda.trigger_lock_scan_cuda,
              scans_cuda.frame_accounting_cuda, tb_cuda.tb_reassemble_cuda,
              equalizer_cuda.equalize_frame_cuda, ldpc_cuda.bp_decode_cuda, ldpc_cuda.bp_gather_cuda,
              llr_cuda.frame_llrs_cuda, cw_cuda.codewords_cuda):
        w.LAUNCHES = 0
    equalizer_cuda.equalize_frame_cuda.TABLE_LAUNCHES = 0


def read_counts() -> tuple:
    return (sync_cuda.timing_metric_cuda.LAUNCHES, scans_cuda.trigger_lock_scan_cuda.LAUNCHES,
            scans_cuda.frame_accounting_cuda.LAUNCHES)


def uncoded_stream(F: int, rcfg, tcfg, dev, gen, card) -> tuple:
    """Phases 9 and 12 at one F; returns the three kernels' launches in
    StreamRx's run, its blocks, the metric kernel's largest error on a
    block and the scan kernels' on the step's own tensors."""
    P = rcfg.frame_samples
    n_blocks = STREAM_BLOCKS[F]
    n_frames = (n_blocks - 1) * F
    stream, sent = make_stream(tcfg, n_frames, n_blocks, F * P, dev, gen)
    mk = {"StreamRx": lambda: session.StreamRx(rcfg, dev, frames_per_block=F),
          "StreamRxPipelined(2)": lambda: session.StreamRxPipelined(rcfg, dev, frames_per_block=F,
                                                                    depth=2)}
    if F == MEGA_F:
        mk[f"StreamRxMega(K={MEGA_K})"] = lambda: session.StreamRxMega(
            rcfg, dev, frames_per_block=F, blocks_per_dispatch=MEGA_K)

    # the main path: StreamRx over the whole stream, the kernels' launches counted
    rx = mk["StreamRx"]()
    reset_counts()
    wall, dev_ms, plain = run_receiver(rx, stream)
    counts = read_counts()
    check(counts == (n_blocks,) * 3, f"F={F}: kernel launches {counts} in {n_blocks} blocks, "
          "expected one of each a block")
    EQ.counted(n_blocks, f"F={F} StreamRx")
    got, masks = decoded(plain, dev)
    check(got["frame_no"].shape[0] == n_frames, f"F={F}: {got['frame_no'].shape[0]} frames "
          f"decoded, {n_frames} sent")
    for k, v in sent.items():
        check(torch.equal(got[k], v), f"F={F}: decoded {k} differs from what was sent, or its order")
    check(rx.n_lost == 0 and rx.n_frames == n_frames,
          f"F={F}: n_lost {rx.n_lost}, n_frames {rx.n_frames} of {n_frames} sent")
    check(not masks["crc_ok"][-F + 1:].any(), f"F={F}: a frame decoded in idle air")
    print(f"[stream] F={F}: {n_blocks} blocks of {F * P} samples ({n_blocks - 1} of traffic, then idle "
          f"air), {n_frames} frames sent: every one decoded once, in order, payloads equal; n_lost "
          f"0, n_frames {rx.n_frames}; kernel launches (metric, lock scan, accounting) {counts}, "
          f"equalizer {EQ_PER_STEP * n_blocks} ({EQ_PER_STEP} a block)", flush=True)

    # the metric kernel against its plain version at the step's length
    ext = torch.as_tensor(stream[: rx.tail_len + F * P], device=dev)
    max_err = kernel_vs_plain({f"stream_block_F{F}": ext})
    scan_err = scans_on_path(rcfg, F, stream, plain, dev, f"uncoded stream F={F}")
    if F in (min(STREAM_F), max(STREAM_F)):
        rx_chk = mk["StreamRx"]()
        with EqualizerCheck(f"StreamRx F={F}, blocks 0-2"):
            for b in range(3):
                rx_chk.process(stream[b * F * P:(b + 1) * F * P])

    # the variants, in turns with StreamRx; their results against StreamRx's
    times = {k: {"wall": [], "dev": []} for k in mk}
    times["StreamRx"]["wall"].append(wall)
    times["StreamRx"]["dev"].append(dev_ms)
    for rnd in range(2):
        for name, make in mk.items():
            if rnd == 0 and name == "StreamRx":
                continue
            r = make()
            reset_counts()
            w, d, res = run_receiver(r, stream, prefetch=(rnd == 1 and name != "StreamRx"))
            check(read_counts() == (n_blocks,) * 3, f"F={F} {name}: kernel launches {read_counts()} "
                  f"in {n_blocks} blocks, expected one of each a block")
            EQ.counted(n_blocks, f"F={F} {name}")
            per = r.dispatch_samples // (F * P)  # blocks a call
            times[name]["wall"].append([x / per for x in w])
            times[name]["dev"].append([x / per for x in d])
            same_as(res, plain, f"F={F} {name}{' with prefetched ingest' if rnd else ''}")
            check((r.n_lost, r.n_frames) == (rx.n_lost, rx.n_frames), f"F={F} {name}: counters")
    print(f"[stream] F={F}: {', '.join(k for k in mk if k != 'StreamRx')} (numpy and prefetched "
          "ingest) equal StreamRx bit for bit: masks, frame_no, payload, n_lost, n_frames; each run "
          f"launched each of the three kernels {n_blocks} times in {n_blocks} blocks and the equalizer "
          f"kernel {EQ_PER_STEP * n_blocks} times")

    # one profiled block of each receiver, after its warm-up
    for name, make in mk.items():
        r = make()
        D = r.dispatch_samples
        per = D // (F * P)
        warm = max(1, WARM_BLOCKS // per)
        for i in range(warm):
            r.process(stream[i * D:(i + 1) * D])
        if hasattr(r, "drain"):
            r.drain()
        torch.cuda.synchronize()
        w_ms, busy, n_k = profiled(lambda: (r.process(stream[warm * D:(warm + 1) * D]),
                                            hasattr(r, "drain") and r.drain()))
        skip = max(1, WARM_BLOCKS // per)
        med_w = [median(run[skip:]) for run in times[name]["wall"]]
        med_d = [median(run[skip:]) for run in times[name]["dev"]]
        best = min(med_w)
        print(f"[stream-timing] F={F} {name}: wall ms a block (with the readback wait), median "
              f"over the blocks after {WARM_BLOCKS} warm-up blocks, per run in turns "
              f"{[round(x, 3) for x in med_w]} -> {best:.3f} ms = {F * P / best / 1e3:.3f} "
              f"Msamples/s; CUDA-event ms a block {[round(x, 3) for x in med_d]}; profiled block: "
              f"wall {w_ms / per:.3f} ms (the profiler stretches it), device busy {busy / per:.3f} ms, "
              f"{n_k / per:.0f} device kernels and copies a block (4,223-4,229 with the equalizer as a Python "
              f"loop); idle share {1 - busy / per / best:.4f} "
              f"against the unprofiled median, {1 - busy / w_ms:.4f} inside the profiled block ({card})",
              flush=True)
    del stream, sent, plain, got
    return counts, n_blocks, max_err, scan_err


def host_span(events, name: str):
    """The host-side time range of the ``record_function`` span named so
    (the profiler also lists the span on the device's timeline)."""
    return next(e.time_range for e in events
                if e.name == name and str(e.device_type).endswith("CPU"))


def no_sync_in_dispatch(rcfg, tcfg, dev, gen) -> None:
    """Between a block's upload and its packed readback the host never
    waits for the device: the CUDA runtime calls of one ``_dispatch``
    (numpy ingest, as a radio feeds it), traced by the profiler, hold no
    synchronising call and no copy through pageable memory.  And in a
    traced ``StreamRxPipelined(depth=2)`` run every launch of block k+1 is
    enqueued before the host waits for block k's packed vector: inside each
    ``process`` the one ``cudaEventSynchronize`` follows the last
    ``cudaLaunchKernel``.  Whether block k's copy to the host was still
    running on the device when block k+1's first launch was enqueued is
    read from the same timeline and printed, not required: on a host-bound
    step the device trails the host's enqueue by microseconds."""
    from torch.profiler import ProfilerActivity, profile, record_function
    F, P = 16, rcfg.frame_samples
    stream, _ = make_stream(tcfg, 7 * F, 8, F * P, dev, gen)
    rx = session.StreamRx(rcfg, dev, frames_per_block=F)
    chunks = [stream[i * F * P:(i + 1) * F * P] for i in range(8)]
    pending = traced_dispatch(rx, chunks, "uncoded")
    n_pending = int(pending)
    for c in chunks[5:]:
        d = rx._dispatch(c)
        n_pending += int(not d.ready.query())
        rx._readback(*d)
    print(f"[stream] no host synchronisation in _dispatch: no *Synchronize call and no pageable copy "
          f"among them; the block's readback was still pending when _dispatch returned in "
          f"{n_pending} of 4 blocks")

    # the pipelined receiver's timeline: 4 blocks after 4 of warm-up
    rxp = session.StreamRxPipelined(rcfg, dev, frames_per_block=F, depth=2)
    for c in chunks[:4]:
        rxp.process(c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, c in enumerate(chunks[4:]):
            with record_function(f"pipelined_process_{i}"):
                rxp.process(c)
        rxp.drain()
    events = prof.events()
    spans = [host_span(events, f"pipelined_process_{i}") for i in range(4)]
    first_launch, lead_us = [], []
    for i, span in enumerate(spans):
        inside = [e for e in events if span.start <= e.time_range.start and e.time_range.end <= span.end]
        launches = [e.time_range for e in inside if e.name.startswith("cudaLaunchKernel")]
        waits = [e.time_range for e in inside if "Synchronize" in e.name]
        check(len(launches) > 100, f"pipelined block {i}: the profiler recorded {len(launches)} launches")
        # process(k+1) = dispatch of k+1, then the wait for k's vector
        check(len(waits) == 1 and waits[0].start >= max(t.end for t in launches),
              f"pipelined block {i}: {len(waits)} synchronising calls in process(), or one before the "
              "block's last launch")
        first_launch.append(min(t.start for t in launches))
        lead_us.append(waits[0].start - first_launch[-1])
    d2h = sorted((e.time_range for e in events if e.name.startswith("Memcpy DtoH")), key=lambda t: t.start)
    check(len(d2h) == 4, f"pipelined run: {len(d2h)} device-to-host copies on the timeline, expected 4")
    still_copying = sum(first_launch[i + 1] < d2h[i].end for i in range(3))
    gaps = [round(first_launch[i + 1] - d2h[i].end, 1) for i in range(3)]
    print(f"[stream] StreamRxPipelined(2) timeline at F={F}: in each of 4 process() calls all of block "
          f"k+1's launches ({[round(x / 1e3, 1) for x in lead_us]} ms from its first launch) are enqueued "
          f"before the host's one wait for block k's vector; on the device, block k's copy to the host "
          f"had not yet ended at block k+1's first launch in {still_copying} of 3 blocks (first launch "
          f"minus copy end, us: {gaps})")


def traced_dispatch(rx, chunks, what: str) -> bool:
    """The CUDA runtime calls of one ``_dispatch`` (chunks[4], after four
    blocks of warm-up: allocator pools, pinned buffers), traced by the
    profiler: no synchronising call and no pageable copy may be among them.
    Returns whether the block's readback was still pending when the
    dispatch returned."""
    from torch.profiler import ProfilerActivity, profile, record_function
    for c in chunks[:4]:
        rx.process(c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("stream_dispatch"):
            d = rx._dispatch(chunks[4])
        pending = not d.ready.query()
    rx._readback(*d)
    events = prof.events()
    span = host_span(events, "stream_dispatch")
    # the profiler itself synchronises the device when it stops: only the
    # calls made inside the dispatch count
    inside = [e.name for e in events
              if span.start <= e.time_range.start and e.time_range.end <= span.end]
    api, copies = {}, {}
    for name in inside:
        if name.startswith("cuda") and not name.startswith(("cudaGet", "cudaDeviceGet", "cudaOccupancy",
                                                            "cudaFuncGet")):
            api[name] = api.get(name, 0) + 1
    for e in events:  # device-side copies, by kind
        if e.name.startswith("Memcpy"):
            copies[e.name] = copies.get(e.name, 0) + 1
    print(f"[stream] CUDA runtime calls inside one {what} _dispatch at F={rx.F}: "
          + ", ".join(f"{k} {n}" for k, n in sorted(api.items(), key=lambda kv: -kv[1]))
          + "; copies on the device's timeline: "
          + ", ".join(f"{k} {n}" for k, n in sorted(copies.items())))
    check(any(k.startswith("cudaLaunchKernel") for k in api), "the profiler recorded no runtime calls")
    waits = [k for k in list(api) + list(copies) if "Synchronize" in k or "Pageable" in k]
    check(not waits, f"{what} _dispatch made synchronising calls or pageable copies: {waits}")
    check(tuple(d.acct.shape) == (rx._acct_words,), f"{what}: a packed vector of {tuple(d.acct.shape)} words")
    return pending


def card_vs_cpu_stream(rcfg, tcfg, dev, gen) -> None:
    """Phase 9, card against CPU on the first 4 blocks at F = 16."""
    F, P = 16, rcfg.frame_samples
    stream, _ = make_stream(tcfg, 3 * F + 5, 4, F * P, dev, gen)
    rx, rx_cpu = (session.StreamRx(rcfg, d, frames_per_block=F) for d in (dev, "cpu"))
    worst = 0.0
    reset_counts()
    for b in range(4):
        chunk = stream[b * F * P:(b + 1) * F * P]
        (o, v), (o0, v0) = rx.process(chunk), rx_cpu.process(chunk)
        for k in ("valid", "header_ok", "crc_ok"):
            a, a0 = (np.asarray(x) if k == "valid" else getattr(x, k) for x in (v, v0))
            check(np.array_equal(a, a0), f"stream block {b} {k}: card vs CPU")
        ok = torch.as_tensor(np.asarray(v0 & v0.header_ok))
        for k in ("frame_no", "payload", "payload_len", "cnst_id"):
            check(torch.equal(getattr(o, k).cpu()[ok], getattr(o0, k)[ok]),
                  f"stream block {b} {k}: card vs CPU")
        rel = ((o.snr_db.cpu()[ok] - o0.snr_db[ok]).abs() / o0.snr_db[ok].abs()).max().item() if ok.any() else 0.0
        worst = max(worst, rel)
    check((rx.n_lost, rx.n_frames) == (rx_cpu.n_lost, rx_cpu.n_frames), "stream counters: card vs CPU")
    check(read_counts() == (4, 4, 4), f"card vs CPU: kernel launches {read_counts()} in 4 blocks on the "
          "card (the CPU session launches none)")
    EQ.counted(4, "card vs CPU stream")
    # float32 on both, summed in other orders (cuBLAS and CPU matmuls)
    check(worst <= 1e-3, f"stream snr_db: card vs CPU differ by {worst} relative")
    print(f"[stream] 4 blocks at F=16, card vs CPU: masks, frame numbers, payload bytes and "
          f"counters equal, snr_db within {worst:.2e} relative")


def coded_stream(dev, gen, card) -> tuple:
    """Phase 10: multi-frame transport blocks through the streaming
    receiver, against the port's CPU run; the TB ring kernels against the
    plain loop on the step's own tensors.  Returns the three kernels'
    launches, the blocks, the scan kernels' largest error on the step's own
    tensors, the TB ring's launches and its largest error there."""
    F, W, n_blocks = CODED_F, 2, 4
    Hm = alist.load_alist(str(ROOT / "examples" / BANK_ALISTS[1]))
    tcfg = cfgmod.make_tx_config(str(FEC_CONFIG), frame_length=FRAME_LENGTH)
    rcfg = cfgmod.make_rx_config(str(FEC_CONFIG), frame_length=FRAME_LENGTH)
    fec = fec_chain.build_fec(tcfg, Hm, dev, tb_frames=W)
    fec_cpu = fec_chain.build_fec(tcfg, Hm, "cpu", tb_frames=W)
    P = rcfg.frame_samples
    G = (n_blocks - 1) * F // W
    B = G * W
    rng = np.random.RandomState(SEED + 5)
    nb = int(fec.user_bytes_tab[2])
    payload = np.zeros((B, fec.max_payload_bytes), np.uint8)
    plen = np.zeros(B, np.int32)
    for g in range(G):
        plen[g * W] = nb
        payload[g * W, :nb] = rng.randint(0, 256, nb)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    out = transmitter.tx_frames(transmitter.build_tx(tcfg, dev, fec),
                                torch.as_tensor(payload, device=dev), t(plen), t(np.full(B, 2)),
                                t(np.zeros(B)), t(np.arange(B)), None)
    samples = out.samples.clone()
    sig_p = float((samples.abs() ** 2).mean())
    hit = F + 1  # the second frame of TB (F + 1) // 2, in the second block
    samples[hit] = channel.awgn(torch.zeros(P, dtype=torch.complex64, device=dev),
                                float(np.sqrt(sig_p)), generator=gen)
    n = n_blocks * F * P
    s = torch.zeros(n, dtype=torch.complex64, device=dev)
    s[STREAM_OFFSET: STREAM_OFFSET + B * P] = samples.reshape(-1)
    stream = channel.awgn(s, float(np.sqrt(sig_p / 10 ** 2.5)), generator=gen).cpu().numpy()

    rx = session.StreamRx(rcfg, dev, frames_per_block=F, fec=fec)
    rx_cpu = session.StreamRx(rcfg, "cpu", frames_per_block=F, fec=fec_cpu)
    tbs, walls, results = {}, [], []
    reset_counts()
    for b in range(n_blocks):
        chunk = stream[b * F * P:(b + 1) * F * P]
        t0 = time.perf_counter()
        _o, v, tb = rx.process(chunk)
        walls.append((time.perf_counter() - t0) * 1e3)
        results.append((_o, v))
        _o0, v0, tb0 = rx_cpu.process(chunk)
        check(np.array_equal(np.asarray(v), np.asarray(v0)) and np.array_equal(v.header_ok, v0.header_ok),
              f"coded stream block {b}: frame masks, card vs CPU")
        for k in ("valid", "tb_no", "crc_ok"):
            check(torch.equal(tb[k].cpu(), tb0[k]), f"coded stream block {b} tb {k}: card vs CPU")
        em = tb0["valid"]
        for k in ("fec_ok", "payload_len"):
            check(torch.equal(tb[k].cpu()[em], tb0[k][em]), f"coded stream block {b} tb {k}: card vs CPU")
        for i in np.nonzero(tb["valid"].cpu().numpy())[0]:
            no = int(tb["tb_no"][i])
            check(no not in tbs, f"TB {no} emitted twice")
            tbs[no] = (bool(tb["crc_ok"][i]), tb["payload"][i, : int(tb["payload_len"][i])].cpu().numpy())
    counts = read_counts()
    tb_launches = tb_cuda.tb_reassemble_cuda.LAUNCHES
    check(counts == (n_blocks,) * 3, f"coded stream: kernel launches {counts} in {n_blocks} blocks")
    EQ.counted(n_blocks, "coded stream")
    check(tb_launches == 2 * n_blocks, f"coded stream: {tb_launches} TB ring kernel launches in "
          f"{n_blocks} blocks, expected the walk and the copy once a block")
    scan_err = scans_on_path(rcfg, F, stream, results, dev, f"coded stream F={F}")
    fl, fl0 = rx.flush_tb(), rx_cpu.flush_tb()
    check(bool(fl["valid"][0]) and bool(fl0["valid"][0]) and int(fl["tb_no"][0]) == G - 1,
          "flush_tb did not emit the last transport block")
    tbs[int(fl["tb_no"][0])] = (bool(fl["crc_ok"][0]),
                                fl["payload"][0, : int(fl["payload_len"][0])].cpu().numpy())
    check(sorted(tbs) == list(range(G)), f"coded stream: TBs emitted {sorted(tbs)[:5]}.. of {G}")
    hit_tb = hit // W
    for g, (crc_ok, pay) in tbs.items():
        if g == hit_tb:
            check(not crc_ok, "the TB with a frame replaced by noise passed its CRC")
        else:
            check(crc_ok and np.array_equal(pay, payload[g * W, :nb]), f"TB {g} did not decode to the sent bytes")
    check((rx.n_lost, rx.n_frames) == (rx_cpu.n_lost, rx_cpu.n_frames), "coded stream counters: card vs CPU")
    print(f"[coded-stream] F={F}, W={W}, QPSK, 25 dB, frame {hit} replaced by noise: {G} TBs, all but "
          f"TB {hit_tb} decode to the sent bytes ({nb} a TB), TB {hit_tb} reported failed as the CPU run "
          f"reports it, flush_tb emitted TB {G - 1}; n_lost {rx.n_lost}, n_frames {rx.n_frames}; kernel "
          f"launches (metric, lock scan, accounting) {counts}; wall ms a block {[round(x, 1) for x in walls]}",
          flush=True)

    # the TB ring kernels against the plain loop on the stream's own decoder
    # inputs: block 0's frames from the initial carry, then block 1's (which
    # hold the frame replaced by noise) from the carry block 0 left
    state = plain = fec_chain.init_tb_state(fec, dev)
    tb_err_path = 0.0
    for b in (0, 1):
        start = STREAM_OFFSET + b * F * P
        frames = torch.as_tensor(stream[start: start + F * P], device=dev).reshape(F, P)
        o, fin = receiver.rx_frames(rx.rxp, frames, defer_fec=True)
        args = (fin["llrs"], fin["tb_no"], fin["tb_offset"], o.cnst_id, fin["tb_payload"],
                fin["fec_id"], o.header_ok, fec)
        got = fec_chain.tb_reassemble(state, *args)
        want = fec_chain._tb_reassemble_torch(plain, *args)
        torch.cuda.synchronize()
        err = tb_err(got, want)
        check(err == 0, f"coded stream: TB ring kernels vs the plain loop on block {b}'s tensors: off by {err}")
        tb_err_path = max(tb_err_path, err)
        n_emitted = int(got[1]["valid"].sum())
        check(n_emitted >= F // W - 1, f"coded stream block {b}: only {n_emitted} TBs emitted on its own tensors")
        state, plain = got[0], want[0]
    print(f"[tb-ring] coded stream F={F}, W={W}: on the block step's own tensors (blocks 0 and 1, the carry "
          f"passed on) the TB ring kernels equal the plain loop: largest |kernel - plain| {tb_err_path:g}; "
          f"launches on the stream: {tb_launches} in {n_blocks} blocks (tb_ring_walk and tb_ring_copy once "
          f"each a block); wall ms a block {[round(x, 1) for x in walls]} (the plain loop's stream took "
          f"104.9-185.2 ms a block)", flush=True)
    return counts, n_blocks, scan_err, tb_launches, tb_err_path


def tx_rx_and_duplex(dev, gen, card) -> tuple:
    """Phase 11: StreamTx -> AWGN -> StreamRx, and the duplex adaptation
    loop.  Returns the three kernels' launches and the blocks received."""
    F = DUPLEX_F
    tcfg = cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH, max_empty_frames=F)
    rcfg = cfgmod.make_rx_config(None, frame_length=FRAME_LENGTH)
    tx = session.StreamTx(tcfg, dev, frames_per_block=F, seed=SEED)
    rx = session.StreamRx(rcfg, dev, frames_per_block=F)
    cap = tx._capacity()
    rng = np.random.RandomState(SEED + 7)
    pdus = ([rng.randint(0, 256, cap // 3).astype(np.uint8).tobytes() for _ in range(7)]
            + [rng.randint(0, 256, 2 * cap + 11).astype(np.uint8).tobytes()]
            + [rng.randint(0, 256, rng.randint(5, cap)).astype(np.uint8).tobytes() for _ in range(9)])
    for p in pdus:
        tx.send(p)
    got, n_tx_blocks, n_empty = [], 0, 0
    reset_counts()

    def receive(samples):
        o, v = rx.process(channel.awgn(torch.as_tensor(samples, device=dev), NOISE_V, generator=gen))
        ok = v & v.crc_ok
        lens, pays = o.payload_len.cpu().numpy(), o.payload.cpu().numpy()
        got.extend(pays[i, : lens[i]].tobytes() for i in np.nonzero(ok)[0] if lens[i])

    while (blk := tx.next_block()) is not None:
        n_tx_blocks += 1
        n_empty += int(not blk[1]["payload_len"].any())
        receive(blk[0])
        check(n_tx_blocks < 50, "StreamTx did not stop at its empty-frame budget")
    receive(np.zeros(rx.block_samples, np.complex64))  # the last frame's tail
    counts = read_counts()
    n_rx_blocks = n_tx_blocks + 1
    check(counts == (n_rx_blocks,) * 3, f"TX -> RX: kernel launches {counts} in {n_rx_blocks} blocks")
    EQ.counted(n_rx_blocks, "StreamTx -> StreamRx")
    check(b"".join(got) == b"".join(pdus), "StreamTx -> StreamRx: the PDUs' bytes did not come back in order")
    check(n_empty == 1 and rx.n_lost == 0, f"StreamTx: {n_empty} all-empty blocks for a budget of "
          f"{F} frames, n_lost {rx.n_lost}")
    print(f"[tx-rx] StreamTx -> AWGN -> StreamRx at F={F}: {len(pdus)} PDUs ({sum(map(len, pdus))} bytes, "
          f"one jumbo of {2 * cap + 11} over a capacity of {cap}) came back in order in {n_tx_blocks} "
          f"blocks, the last {n_empty} of empty frames, then the budget ended the stream; "
          f"n_frames {rx.n_frames}, n_lost 0; kernel launches (metric, lock scan, accounting) {counts} "
          f"in {n_rx_blocks} received blocks", flush=True)

    txcfg = cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH, max_empty_frames=-1)
    make_chan = lambda snr_db, seed: awgn_chan(snr_db, seed, dev)
    runs = {}
    for serialize in (False, True):
        dpx = session.StreamDuplex(txcfg, rcfg, txcfg, rcfg, make_chan(30.0, 11), make_chan(5.0, 12),
                                   dev, frames_per_block=F, serialize_readback=serialize)
        with FeedbackCheck(f"StreamDuplex F={F}, serialize_readback={serialize}") as fc:
            reset_counts()
            t0 = time.perf_counter()
            res = [dpx.step() for _ in range(12)]
            torch.cuda.synchronize()
            runs[serialize] = (dpx, res, (time.perf_counter() - t0) * 1e3 / 12)
        K7.add(fc.what, fc.calls, fc.launches, fc.frames, fc.err, fc.by_kernel)
        check(read_counts() == (24, 24, 24), f"duplex: kernel launches {read_counts()} in 12 steps of "
              "two receivers, expected 2 of each a step")
        EQ.counted(24, "StreamDuplex, two receivers a step")
        counts = tuple(a + b for a, b in zip(counts, read_counts()))
        n_rx_blocks += 24
        check(all(r is not None for r in res), "StreamDuplex stopped")
        check(dpx.tx_a.constellation > int(cn.ConstellationType.BPSK),
              "duplex: the 30 dB direction's TX stayed at BPSK")
        check(dpx.tx_b.constellation == int(cn.ConstellationType.BPSK),
              "duplex: the 5 dB direction's TX left BPSK")
    (d0, r0, ms0), (d1, r1, ms1) = runs[False], runs[True]
    for step, (p, q) in enumerate(zip(r0, r1)):
        check(p["ctl_a"] == q["ctl_a"] and p["ctl_b"] == q["ctl_b"], f"duplex step {step}: control differs")
        for side in ("a", "b"):
            for k in ("header_ok", "crc_ok", "frame_no", "cnst_id", "payload", "feedback_cnst", "snr_db"):
                a, b = getattr(p[side], k), getattr(q[side], k)
                check(torch.equal(a, b) or (a.is_floating_point() and
                                            torch.allclose(a, b, rtol=0, atol=0, equal_nan=True)),
                      f"duplex step {step} side {side} {k}: the readback orderings differ")
    print(f"[duplex] F={F}, 12 steps, A->B at 30 dB, B->A at 5 dB: A's TX climbed to constellation "
          f"{d0.tx_a.constellation}, B's stayed at BPSK; both readback orderings give equal outputs, "
          f"each with 2 launches of each of the three kernels a step (counted: 24 in 12 steps); "
          f"wall ms a step: both dispatched first {ms0:.1f}, serialized {ms1:.1f} ({card})", flush=True)
    return counts, n_rx_blocks


def awgn_chan(snr_db: float, seed: int, dev):
    """A channel for the duplex: AWGN at snr_db of each block's measured
    power, from a generator of its own."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def chan(samples):
        x = torch.as_tensor(samples, device=dev)
        nv = float(np.sqrt(float(np.mean(np.abs(samples) ** 2)) / 10 ** (snr_db / 10)))
        return channel.awgn(x, nv, generator=g)

    return chan


def stream_phases(dev, card) -> tuple:
    """Phases 8-12.  Returns the metric kernel's launches on the streaming
    paths, the blocks they ran, its largest error on the stream's blocks,
    the two scan kernels' entries for the ``kernels`` line and the TB ring's."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rcfg = cfgmod.make_rx_config(None, frame_length=FRAME_LENGTH)
    tcfg = cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH)
    scan_err = scans_vs_plain(dev)
    launches, blocks, max_err = [0, 0, 0], 0, 0.0

    def add(counts, n_blocks):
        nonlocal launches, blocks
        launches = [a + b for a, b in zip(launches, counts)]
        blocks += n_blocks

    for F in STREAM_F:
        counts, n_blocks, err, s_err = uncoded_stream(F, rcfg, tcfg, dev, gen, card)
        add(counts, n_blocks)
        max_err, scan_err = max(max_err, err), max(scan_err, s_err)
        torch.cuda.empty_cache()
    card_vs_cpu_stream(rcfg, tcfg, dev, gen)
    no_sync_in_dispatch(rcfg, tcfg, dev, gen)
    tb_err_all = tb_ring_vs_plain(dev)
    counts, n_blocks, s_err, tb_launches, tb_err_path = coded_stream(dev, gen, card)
    add(counts, n_blocks)
    scan_err = max(scan_err, s_err)
    add(*tx_rx_and_duplex(dev, gen, card))
    scan_times = time_scans(dev, card)
    T = max(SCAN_T)  # the largest block of the main path
    entries = []
    for i, (name, replaces) in enumerate((("trigger_lock_scan", "gr_dtl_tpu/models/streaming.py:180"),
                                          ("frame_accounting", "gr_dtl_tpu/models/session.py:222"))):
        t = scan_times[(name, T)]
        # bound_ms is the larger of bytes over the memory rate and operations
        # over the peak rate, and bytes is the larger; neither is what binds
        # these kernels: launch_floor_ms (the kernel at T = 1) plus the loads
        # of the stream's row and a few block- or warp-wide dependent steps
        entries.append({"name": name, "route": "cuda",
                        "source": "gr_dtl_tpu_torch/csrc/stream_scans.cu", "replaces": replaces,
                        "launches": launches[i + 1],
                        "max_abs_err": scan_err, "ms": t["ms"], "ms_by": "profiler",
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": "bytes",
                        "launch_floor_ms": scan_times[(name, 1)]["ms"],
                        "binds": "the launch, the row's loads and a few block-wide dependent steps",
                        "library_ms": None,
                        "library_note": "no PyTorch call computes the function; torch.cummax, its "
                                        "prefix-max alone, is cummax_ms",
                        "cummax_ms": t["cummax_ms"],
                        "at_T": T, "ms_at_T": {n: scan_times[(name, n)]["ms"] for n in SCAN_TIME_T}})
    tb_times = time_tb_ring(dev, card)
    t = tb_times[CODED_F]  # the main path's shape: the coded stream's block
    # bound_ms is bytes over the memory rate (the larger of the two); what
    # binds at this size is the two launches, the walk's 2 + W block-wide
    # scans, and the copy's bytes
    tb_entry = {"name": "tb_reassemble", "route": "cuda",
                "source": "gr_dtl_tpu_torch/csrc/tb_ring.cu",
                "replaces": "gr_dtl_tpu/models/fec_chain.py:233",
                "launches": tb_launches, "launches_per_step": tb_launches / n_blocks,
                "max_abs_err": max(tb_err_all, tb_err_path), "ms": t["ms"], "ms_by": "profiler",
                "walk_ms": t["walk_ms"], "copy_ms": t["copy_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": "bytes", "bytes": t["bytes"],
                "binds": "two launches, the walk's 2 + W block-wide scans and the copy's bytes",
                "launch_floor_ms": tb_times[1]["ms"], "library_ms": None,
                "library_note": "no PyTorch call computes the function; torch.cummax over the frames' "
                                "indices, the walk's prefix-max alone, is cummax_ms",
                "cummax_ms": t["cummax_ms"],
                "at_F": CODED_F, "at_W": TB_TIME_W,
                "ms_at_F": {n: tb_times[n]["ms"] for n in TB_TIME_F},
                "bound_ms_at_F": {n: tb_times[n]["bound_ms"] for n in TB_TIME_F}}
    return launches[0], blocks, max_err, entries, tb_entry


# ---------------------------------------------------------------------------
# the TB ring kernels (phase 10) and phases 13-17: channels, bursts, links
# ---------------------------------------------------------------------------

TB_F, TB_W = (1, 8, 64, 256, 1024), (1, 2, 4)
TB_TIME_F, TB_TIME_W = (1, 16, 32, 64, 256, 1024), 2
N_CHANNEL = 3_770_368    # the uncoded path's stream: 2048 frames of 1840 samples and 2048 of margin
CHANNEL_TAPS = (1.0, 0.25 - 0.15j, 0.1j)
CHANNEL_CFO = 0.2        # carrier spacings
TAIL_CHECK = 4096        # a stream's last samples, compared on their own
N_BURSTS, BURST_CAPTURE = 4096, 320
BURST_BLOCK, BURST_BLOCKS = 4096, 8
LINK_ROUNDS = 32
NOISE_HIGH_SNR, NOISE_LOW_SNR = 0.009, 0.35  # noise voltages: ~40 dB and ~8 dB on a frame of power ~0.8
BPSK, QAM16 = int(cn.ConstellationType.BPSK), int(cn.ConstellationType.QAM16)


def tb_fec(dev, W: int):
    """The FEC chain of examples/config_fec.json at frame_length 20 with W
    frames a transport block, on ``dev``."""
    tcfg = cfgmod.make_tx_config(str(FEC_CONFIG), frame_length=FRAME_LENGTH)
    Hm = alist.load_alist(str(ROOT / "examples" / BANK_ALISTS[1]))
    return fec_chain.build_fec(tcfg, Hm, dev, tb_frames=W)


def tb_headers(F: int, W: int, fec, seed: int, tb0: int, dev):
    """F header records and LLR rows that take every branch of the
    reassembly: lost frames, TB numbers that stay, advance, skip and fall
    back to an earlier one, constellation ids outside 1..4, offsets on a
    slot's edge, past the last slot and negative.  (llrs, tb_no, tb_offset,
    cnst_id, tb_payload, fec_id, ok) on ``dev``."""
    rng = np.random.RandomState(seed)
    ok = rng.rand(F) > 0.25
    tb_no = tb0 + np.cumsum(rng.choice([0, 1, 3], F, p=[1 - 0.9 / W, 0.8 / W, 0.1 / W]))
    back = rng.rand(F) < 0.08
    tb_no[back] -= rng.randint(1, 3, int(back.sum()))
    cnst = rng.randint(1, 5, F)
    odd = rng.rand(F) < 0.15
    cnst[odd] = rng.choice([-2, 0, 5, 9], int(odd.sum()))
    fb = (fec.cfg.frame_capacity_symbols * np.arange(5))[np.clip(cnst, 0, 4)]
    offset = rng.randint(0, W, F) * fb + rng.choice([0, 0, 1, -1], F) * rng.randint(0, 2, F)
    far = rng.rand(F) < 0.1
    offset[far] = rng.randint(W, 3 * W + 1, int(far.sum())) * np.maximum(fb[far], 1)
    neg = rng.rand(F) < 0.05
    offset[neg] = -rng.randint(1, 2000, int(neg.sum()))
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    llrs = torch.randn((F, fec.max_frame_bits), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(seed))
    return (llrs, i32(tb_no), i32(offset), i32(cnst), i32(rng.randint(0, 5000, F)),
            i32(rng.randint(0, 4, F)), torch.as_tensor(ok, device=dev))


def tb_err(got, want) -> float:
    """Largest |a - b| over every leaf of two (carry, emitted) pairs of
    ``fec_chain.tb_reassemble``: LLRs, ints and bools alike."""
    (st, em), (st0, em0) = got, want
    check(em.keys() == em0.keys(), "the emitted dicts' keys differ")
    worst = 0.0
    for a, b in list(zip(st, st0)) + [(em[k], em0[k]) for k in em0]:
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"shape or type: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
        if a.numel():
            worst = max(worst, float((a.double() - b.double()).abs().max()))
    return worst


def tb_ring_vs_plain(dev) -> float:
    """The TB ring kernels against the plain loop on random header
    sequences at every F and W, two chained calls each (the second starts
    from a carried-in buffer); two launches a call.  Returns the largest
    |kernel - plain| over every output and carry leaf, which must be 0."""
    worst = 0.0
    for W in TB_W:
        fec = tb_fec(dev, W)
        for F in TB_F:
            state = plain = fec_chain.init_tb_state(fec, dev)
            tb0 = 0
            for call in range(2):
                args = tb_headers(F, W, fec, 100 * F + 10 * W + call, tb0, dev)
                tb_cuda.tb_reassemble_cuda.LAUNCHES = 0
                got = fec_chain.tb_reassemble(state, *args, fec)
                n = tb_cuda.tb_reassemble_cuda.LAUNCHES
                check(n == 2, f"tb_reassemble at F={F}, W={W}: {n} kernel launches, expected 2")
                want = fec_chain._tb_reassemble_torch(plain, *args, fec)
                torch.cuda.synchronize()
                err = tb_err(got, want)
                check(err == 0, f"TB ring kernels vs the plain loop at F={F}, W={W}, call {call}: "
                      f"off by {err}")
                worst = max(worst, err)
                state, plain = got[0], want[0]
                tb0 = int(args[1].max())
    print(f"[tb-ring] tb_ring_walk + tb_ring_copy against the plain loop on random header sequences "
          f"(lost frames, repeated and skipped tb_no, cnst outside 1..4, offsets past the last slot, a "
          f"carried-in buffer) at F = {list(TB_F)} x W = {list(TB_W)}, max_frame_bits "
          f"{FRAME_LENGTH * 48 * 4}: largest |kernel - plain| over every output and the new carry "
          f"{worst:g}; 2 launches a call", flush=True)
    return worst


def time_tb_ring(dev, card) -> dict:
    """The TB ring kernels alone against the plain loop at W = 2, in turns
    (plain, kernel, kernel, plain).  The kernels' own times are the
    profiler's device durations; between events a call also holds the
    host's enqueue (10 allocations and two ctypes launches).  The calls
    repeat on the same inputs, so at F = 64 (1 MB in, 2 MB out) they find
    L2 warm, as the block step does right after ``frame_llrs``."""
    out = {}
    W = TB_TIME_W
    fec = tb_fec(dev, W)
    for F in TB_TIME_F:
        args = tb_headers(F, W, fec, F, 0, dev)
        state = fec_chain.init_tb_state(fec, dev)
        kern = lambda: fec_chain.tb_reassemble(state, *args, fec)
        plain = lambda: fec_chain._tb_reassemble_torch(state, *args, fec)
        kern(), plain()
        torch.cuda.synchronize()
        k_ev, p_ev = [], []
        for turn in ("plain", "kernel", "kernel", "plain"):
            if turn == "plain":
                p_ev.append(cuda_ms(plain, 1 if F >= 256 else 3))  # one call is F iterations
            else:
                k_ev.append(cuda_ms(kern, 100))
        walk = kernel_profiler_ms(kern, "tb_ring_walk_kernel", 50)
        copy = kernel_profiler_ms(kern, "tb_ring_copy_kernel", 50)
        check(walk is not None and copy is not None, "the profiler saw no tb_ring kernel")
        _w, plain_busy, plain_n = profiled(plain, sacrifice=True)
        nbytes = tb_cuda.tb_bytes(F, W, fec.max_frame_bits)
        bound = max(nbytes / HBM_BYTES_PER_S, 12 * F / FP32_OPS_PER_S) * 1e3
        cm = cummax_ms(1, F, dev)
        out[F] = {"ms": walk + copy, "walk_ms": walk, "copy_ms": copy, "enqueue_ms": min(k_ev),
                  "plain_ms": min(p_ev), "bound_ms": bound, "bytes": nbytes, "cummax_ms": cm}
        print(f"[tb-ring-timing] F={F}, W={W}: tb_ring_walk {walk * 1e3:.2f} us + tb_ring_copy "
              f"{copy * 1e3:.2f} us = {(walk + copy) * 1e3:.2f} us device duration (profiler; "
              f"{earlier_note('tb_reassemble', 1, F)}), "
              f"{min(k_ev) * 1e3:.2f} us a call between events (with the host's enqueue); plain loop "
              f"{min(p_ev):.3f} ms by events, {plain_n} device kernels, device busy {plain_busy:.3f} ms; "
              f"{nbytes} bytes, bound {bound * 1e3:.3f} us (bytes), {100 * bound / (walk + copy):.1f}% of "
              f"it; launch floor (F = 1) {out[min(out)]['ms'] * 1e3:.2f} us; torch.cummax on the [1, {F}] "
              f"int32 indices {cm * 1e3:.2f} us, the walk's prefix-max alone (library call: none computes "
              f"the function) ({card})", flush=True)
    return out


def tx_batch(tcfg, cnst: np.ndarray, dev, seed: int):
    """One frame per entry of ``cnst``, filled to capacity: (samples [n,
    frame_samples], what was sent)."""
    rng = np.random.RandomState(seed)
    n, maxb = cnst.shape[0], tcfg.max_frame_bytes()
    plen = np.array([tcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[c])) - 4 for c in cnst], np.int32)
    payload = rng.randint(0, 256, (n, maxb)).astype(np.uint8)
    payload[np.arange(maxb)[None, :] >= plen[:, None]] = 0
    sent = {"payload": torch.as_tensor(payload, device=dev),
            "payload_len": torch.as_tensor(plen, device=dev),
            "cnst_id": torch.as_tensor(cnst.astype(np.int32), device=dev),
            "frame_no": torch.arange(n, device=dev, dtype=torch.int32) % 4096}
    pad = torch.as_tensor(rng.randint(0, 256, (n, maxb)).astype(np.uint8), device=dev)
    out = transmitter.tx_frames(transmitter.build_tx(tcfg, dev), sent["payload"],
                                sent["payload_len"], sent["cnst_id"],
                                torch.zeros(n, dtype=torch.int32, device=dev), sent["frame_no"], pad)
    return out.samples, sent


def padded(samples: torch.Tensor, lead: int, total: int) -> torch.Tensor:
    """The frames as one stream of ``total`` samples, ``lead`` zeros first."""
    s = torch.zeros(total, dtype=torch.complex64, device=samples.device)
    s[lead: lead + samples.numel()] = samples.reshape(-1)
    return s


def channels_phase(dev, card) -> tuple:
    """Phase 13 and 14: the channel models at the uncoded path's N against
    the port's CPU run, timed; then the receiver behind each of them.
    Returns the three kernels' launches on the impaired paths, the batch
    steps (the metric kernel alone), the StreamRx blocks (all three), and
    the metric kernel's largest error on an impaired stream."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    N = N_CHANNEL
    x = torch.complex(torch.randn(N, generator=gen, device=dev),
                      torch.randn(N, generator=gen, device=dev)) * float(np.sqrt(0.5))
    noise = torch.complex(torch.randn(N, generator=gen, device=dev),
                          torch.randn(N, generator=gen, device=dev))
    draws = torch.rand((3, 3, 8), generator=gen, device=dev) * (2 * np.pi)
    x_cpu = x.cpu()
    # float32 on both sides in one operation order: what differs is the last
    # bits of cos / sin and of the fused complex products (values ~1-4).
    # selective_fading multiplies w = 2 pi f_d cos(alpha) by t up to 3.77e6:
    # one ulp of a cos(alpha), where the card's and the CPU's differ, is
    # ~1.4e-4 rad at the end of the stream, on each of 8 sinusoids of a tap.
    cases = {
        "channel_model": (lambda s: channel.channel_model(
            s, noise_voltage=NOISE_V, freq_offset=CHANNEL_CFO, taps=CHANNEL_TAPS,
            noise=noise.to(s.device)), 2e-5),
        "sample_clock_offset": (lambda s: channel.sample_clock_offset(s, 50.0), 2e-5),
        "selective_fading": (lambda s: channel.selective_fading(s, draws=draws.to(s.device)), 2e-3),
    }
    for name, (fn, atol) in cases.items():
        got, want = fn(x).cpu(), fn(x_cpu)
        check(got.shape == want.shape == (N,) and got.dtype == torch.complex64
              and bool(torch.isfinite(got.abs()).all()), f"{name}: shape, type or a value not finite")
        err = (got - want).abs().max().item()
        err_tail = (got[-TAIL_CHECK:] - want[-TAIL_CHECK:]).abs().max().item()
        check(err <= atol and err_tail <= atol,
              f"{name} at N={N}: card vs CPU {err} (last {TAIL_CHECK} samples {err_tail}) over {atol}")
        del got, want
        fn(x)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = sorted(cuda_ms(lambda: fn(x), 3) for _ in range(3))
        peak = torch.cuda.max_memory_allocated() - base
        _w, busy, n_k = profiled(lambda: fn(x), sacrifice=True)
        print(f"[channels] {name} at N={N}: card vs CPU max |d| {err:.3e}, on the last {TAIL_CHECK} "
              f"samples {err_tail:.3e} (bar {atol:g}); {ms[1]:.3f} ms a call by events (median of 3 "
              f"windows of 3; min {ms[0]:.3f}, max {ms[-1]:.3f}), device busy {busy:.3f} ms, {n_k} "
              f"device kernels and copies, peak memory above its input {peak / 2**20:.1f} MiB ({card})",
              flush=True)
    del x, x_cpu, noise
    torch.cuda.empty_cache()

    # ---- 14. the receiver behind the channels ----
    rcfg = cfgmod.make_rx_config(None, frame_length=FRAME_LENGTH)
    tcfg = cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH)
    rxp = receiver.build_rx(rcfg, dev)
    counts, steps, blocks = [0, 0, 0], 0, 0
    # B = 2048 mixed frames behind 3 taps, a CFO of 0.2 carriers and noise
    # 0.02, with an unknown offset of 531 samples (tests/test_loopback.py)
    cnst = np.random.RandomState(SEED).randint(1, 5, size=B).astype(np.int32)
    samples, sent = tx_batch(tcfg, cnst, dev, SEED + 14)
    stream = channel.channel_model(padded(samples, 531, N), noise_voltage=NOISE_V,
                                   freq_offset=CHANNEL_CFO, taps=CHANNEL_TAPS, generator=gen)
    max_err = kernel_vs_plain({"impaired_main": stream})
    reset_counts()
    frames, eps = receiver.detect_and_extract(stream, rcfg, B)
    out = receiver.rx_frames(rxp, frames)
    torch.cuda.synchronize()
    check(read_counts()[0] == 1, "the impaired batch did not launch the Schmidl-Cox kernel once")
    EQ.counted(1, "the impaired batch")
    counts[0] += 1
    steps += 1
    d_eps = (eps - CHANNEL_CFO).abs().max().item()
    check(d_eps <= 0.05, f"channel_model: the detector's fractional CFO is off by {d_eps}")
    check_decoded(out, sent, f"B={B} behind channel_model")
    print(f"[channels] B={B} mixed frames behind channel_model (taps {CHANNEL_TAPS}, CFO {CHANNEL_CFO} "
          f"carriers, noise {NOISE_V}, N={N}): every frame decoded with its payload, fractional CFO "
          f"estimates within {d_eps:.4f} of {CHANNEL_CFO}, snr_db median "
          f"{out.snr_db.median().item():.2f}", flush=True)
    del stream, frames, out, samples

    # 16 QPSK frames through slow Rayleigh selective fading + AWGN at 28 dB
    # (tests/test_fading_scramble.py::test_fading_loopback): most decode.  How
    # many depends on the realisation, as Rayleigh fading does (0 to 16 of 16
    # over the numpy seeds 0..9 on the CPU): the angles are drawn on the host,
    # seed 5, a realisation without a deep fade over these 16 frames
    nf = 16
    fade_draws = torch.as_tensor((np.random.RandomState(5).rand(3, 3, 8) * 2 * np.pi).astype(np.float32),
                                 device=dev)
    samples, sent = tx_batch(tcfg, np.full(nf, 2, np.int32), dev, SEED + 15)
    sig = float((samples.abs() ** 2).mean())
    faded = channel.selective_fading(padded(samples, 300, 300 + nf * rcfg.frame_samples + 200),
                                     delays=(0, 2, 5), powers_db=(0.0, -6.0, -9.0),
                                     doppler_norm=2e-5, draws=fade_draws)
    stream = channel.awgn(faded, float(np.sqrt(sig / 10 ** 2.8)), generator=gen)
    reset_counts()
    frames, _ = receiver.detect_and_extract(stream, rcfg, nf)
    out = receiver.rx_frames(rxp, frames)
    check(read_counts()[0] == 1, "the faded batch did not launch the Schmidl-Cox kernel once")
    EQ.counted(1, "the faded batch")
    counts[0] += 1
    steps += 1
    ok = out.crc_ok
    check(ok.float().mean().item() >= 0.7, f"fading: only {int(ok.sum())} of {nf} frames decoded")
    check(torch.equal(out.payload[ok], sent["payload"][ok]), "fading: a decoded payload differs")
    print(f"[channels] {nf} QPSK frames through selective_fading (delays (0, 2, 5), powers (0, -6, -9) "
          f"dB, Doppler 2e-5) + AWGN at 28 dB: {int(ok.sum())} decoded with their payloads (bar: 70%), "
          f"snr_db {out.snr_db.min().item():.1f}..{out.snr_db.max().item():.1f}", flush=True)

    # 200 QPSK frames at +-50 ppm of sample-clock offset + AWGN at 25 dB
    # through StreamRx at F = 8 (tests/test_sfo.py): each decodes once
    F, n_frames = 8, 200
    samples, sent = tx_batch(tcfg, np.full(n_frames, 2, np.int32), dev, SEED + 16)
    sig = float((samples.abs() ** 2).mean())
    flat = samples.reshape(-1)
    for ppm in (50.0, -50.0):
        rx = session.StreamRx(rcfg, dev, frames_per_block=F)
        S = rx.block_samples
        stream = torch.cat([flat, torch.zeros(2 * S, dtype=torch.complex64, device=dev)])
        stream = channel.awgn(channel.sample_clock_offset(stream, ppm),
                              float(np.sqrt(sig / 10 ** 2.5)), generator=gen)
        n_blocks = stream.shape[0] // S
        seen = torch.zeros(n_frames, dtype=torch.int32, device=dev)
        reset_counts()
        for b in range(n_blocks):
            o, valid = rx.process(stream[b * S:(b + 1) * S])
            good = o.crc_ok & torch.as_tensor(np.asarray(valid), device=dev)
            nos = o.frame_no[good].long()
            check(torch.equal(o.payload[good], sent["payload"][nos]), f"SFO {ppm} ppm: a payload differs")
            seen.index_add_(0, nos, torch.ones_like(nos, dtype=torch.int32))
        check(read_counts() == (n_blocks,) * 3, f"SFO: kernel launches {read_counts()} in {n_blocks} blocks")
        EQ.counted(n_blocks, f"StreamRx at {ppm:+g} ppm")
        counts = [a + n_blocks for a in counts]
        blocks += n_blocks
        check(int(seen.max()) <= 1, f"SFO {ppm} ppm: a frame decoded twice")
        n_dec = int(seen.sum())
        check(n_dec >= n_frames - 1 and rx.n_lost <= 1,
              f"SFO {ppm} ppm: {n_dec} of {n_frames} frames decoded, n_lost {rx.n_lost}")
        print(f"[channels] {n_frames} QPSK frames at {ppm:+g} ppm (a drift of "
              f"{abs(ppm) * 1e-6 * n_frames * rcfg.frame_samples:.1f} samples) + AWGN at 25 dB through "
              f"StreamRx F={F}: {n_dec} decoded, each once, with their payloads; n_lost {rx.n_lost}; "
              f"kernel launches (metric, lock scan, accounting) {read_counts()} in {n_blocks} blocks",
              flush=True)
    return counts, steps, blocks, max_err


def bursts_phase(dev, card) -> None:
    """Phase 15: the feedback-burst modem at 4096 bursts a batch, and the
    continuous scanner over 9 blocks of 4096 samples."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    rng = np.random.RandomState(SEED + 17)
    modem = burst.build_burst_modem(dev)
    Lb = burst.burst_wave_len(modem)
    n, cap_len = N_BURSTS, BURST_CAPTURE
    t = lambda a: torch.as_tensor(a, device=dev)
    cnst, fec = t(rng.randint(1, 5, n).astype(np.int32)), t(rng.randint(0, 3, n).astype(np.int32))
    wave = burst.burst_tx(cnst, fec, modem, pad=0)
    check(wave.shape == (n, Lb) and wave.dtype == torch.complex64, "burst_tx shape or type")
    delay = t(rng.randint(0, cap_len - Lb, n))
    rel = torch.arange(cap_len, device=dev)[None, :] - delay[:, None]  # position inside the burst
    inside = (rel >= 0) & (rel < Lb)
    cap = torch.where(inside, torch.gather(wave, 1, torch.clamp(rel, 0, Lb - 1)), 0.0)
    k = torch.arange(cap_len, dtype=torch.float32, device=dev)
    cfo = t(rng.uniform(-0.004, 0.004, n).astype(np.float32))  # rad/sample
    cap = cap * torch.polar(torch.ones((n, cap_len), device=dev), cfo[:, None] * k[None, :])
    cap = channel.awgn(cap, 0.1, generator=gen)
    out = burst.burst_rx(cap, modem)
    torch.cuda.synchronize()
    check(bool(out.ok.all()), f"burst_rx: only {int(out.ok.sum())} of {n} bursts decoded")
    check(torch.equal(out.cnst_id, cnst) and torch.equal(out.fec_id, fec), "burst_rx: decoded fields differ")
    d_pos = (out.peak_pos - delay).abs().max().item()
    d_cfo, d_cfo_med = (out.cfo - cfo).abs().max().item(), (out.cfo - cfo).abs().median().item()
    # one-shot estimate from two half-preamble phases 75 samples apart, at noise 0.1
    check(d_pos <= 1 and d_cfo_med <= 1e-3 and d_cfo <= 4e-3,
          f"burst_rx: start off by {d_pos} samples, CFO by {d_cfo} rad/sample (median {d_cfo_med})")
    got, want = burst.burst_rx(cap[:64], modem), burst.burst_rx(cap[:64].cpu(), burst.build_burst_modem("cpu"))
    for f in ("cnst_id", "fec_id", "ok", "peak_pos"):
        check(torch.equal(getattr(got, f).cpu(), getattr(want, f)), f"burst_rx {f}: card vs CPU")
    ms = sorted(cuda_ms(lambda: burst.burst_rx(cap, modem), 3) for _ in range(3))[1]
    quiet = burst.burst_rx(channel.awgn(torch.zeros_like(cap), 0.3, generator=gen), modem)
    check(not bool(quiet.ok.any()), f"burst_rx decoded {int(quiet.ok.sum())} bursts from noise alone")
    print(f"[bursts] {n} bursts burst_tx -> delay 0..{cap_len - Lb}, CFO +-0.004 rad/sample, AWGN 0.1 -> "
          f"burst_rx: all decoded with their fields, start within {d_pos} samples, CFO within "
          f"{d_cfo:.2e} rad/sample (median {d_cfo_med:.2e}); 64 captures card vs CPU: ints and bools equal; noise alone (0.3) "
          f"decodes none; burst_rx {ms:.3f} ms a batch by events ({card})", flush=True)

    # the scanner: two bursts inside every block and one across its end
    N, nb = BURST_BLOCK, BURST_BLOCKS
    total = torch.zeros((nb + 1) * N, dtype=torch.complex64, device=dev)
    sent = []
    for b in range(nb):
        starts = [b * N + rng.randint(300, 1500), b * N + rng.randint(1800, 3500),
                  (b + 1) * N - rng.randint(20, Lb - 20)]
        for s0 in starts:
            ident = (int(rng.randint(1, 5)), len(sent))  # the FEC byte numbers the burst
            sent.append(ident)
            w = burst.burst_tx(t(np.array([ident[0]], np.int32)), t(np.array([ident[1]], np.int32)),
                               modem, pad=0)[0]
            total[s0: s0 + Lb] += w
    kk = torch.arange(total.shape[0], dtype=torch.float32, device=dev)
    total = channel.awgn(total * torch.polar(torch.ones_like(kk), 0.001 * kk), 0.05, generator=gen)
    brx = session.StreamBurstRx(N, dev, modem)
    found, t0 = [], time.perf_counter()
    for b in range(nb + 1):
        o = brx.process(total[b * N:(b + 1) * N])
        okb = o.ok.cpu().numpy()
        found += [(int(c), int(f)) for c, f in zip(o.cnst_id.cpu().numpy()[okb], o.fec_id.cpu().numpy()[okb])]
    ms = (time.perf_counter() - t0) * 1e3 / (nb + 1)
    check(sorted(found) == sorted(sent), f"StreamBurstRx: found {len(found)} bursts "
          f"({len(set(found))} distinct) of {len(sent)} sent")
    quiet_rx = session.StreamBurstRx(N, dev, modem)
    for _ in range(4):
        o = quiet_rx.process(channel.awgn(torch.zeros(N, dtype=torch.complex64, device=dev), 0.3, generator=gen))
        check(not bool(o.ok.any()), "StreamBurstRx decoded a burst from noise alone")
    print(f"[bursts] StreamBurstRx over {nb + 1} blocks of {N} samples, two bursts inside each of {nb} "
          f"blocks and one across its end, CFO 0.001 rad/sample, AWGN 0.05: {len(found)} of {len(sent)} "
          f"found, each once; 4 blocks of noise alone: none; {ms:.2f} ms a block, wall clock with the "
          f"readback ({card})", flush=True)


def sync_calls(fn) -> list:
    """The synchronising CUDA runtime calls the host makes inside fn()."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("traced_rounds"):
            fn()
    events = prof.events()
    span = host_span(events, "traced_rounds")
    return [e.name for e in events if "Synchronize" in e.name
            and span.start <= e.time_range.start and e.time_range.end <= span.end]


def links_phase(dev, card) -> tuple:
    """Phases 16 and 17: the in-graph links for 32 rounds, and the
    streaming simplex pair.  Returns the three kernels' launches in
    StreamSimplex's run and its blocks."""
    def timed_run(run, state, seed, what, rx_per_round):
        gen = torch.Generator(device=dev).manual_seed(seed)
        with EqualizerCheck(f"{what}, 2 rounds at B=1"):  # and warm-up: allocator pools, cuBLAS handles
            run(state, 2, generator=gen)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, telem = run(state, LINK_ROUNDS, generator=gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / LINK_ROUNDS
        EQ.counted(rx_per_round * LINK_ROUNDS, f"{what}, {rx_per_round} receive steps a round")
        return {k: v.cpu().numpy() for k, v in telem.items()}, ms

    # ---- 16. simplex: forward OFDM, reverse burst ----
    cfg = cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH)
    for name, noise_fwd in (("high", NOISE_HIGH_SNR), ("low", NOISE_LOW_SNR)):
        run, tables = simplex.build_simplex(cfg, dev, noise_fwd=noise_fwd, noise_rev=0.1)
        state = simplex.initial_simplex_state(cfg, tables, dev)
        telem, ms = timed_run(run, state, SEED + 18, f"simplex.run ({name} SNR)", 1)
        tx = telem["tx_cnst"]
        check(telem["burst_ok"].mean() > 0.9, f"simplex {name}: bursts decoded {telem['burst_ok'].mean():.2f}")
        check(np.isfinite(telem["snr_db"]).all(), f"simplex {name}: snr_db not finite")
        if name == "high":
            check(tx[0] == BPSK and tx[-1] == QAM16 and telem["crc_ok"][-8:].all(),
                  f"simplex at noise {noise_fwd}: TX constellations {tx.tolist()}")
            draws = simplex.draw_rounds(run.draw_shapes, 3, dev, torch.Generator(device=dev).manual_seed(1))
            waits = sync_calls(lambda: run(state, 3, draws=draws))
            # the one allowed: the upload of the MCS thresholds when run() starts
            check(len(waits) <= 1, f"simplex.run of 3 rounds made synchronising calls: {waits}")
            # why the links read their tables through adaptive.lookup
            table = torch.arange(5, device=dev)
            by_0dim = sync_calls(lambda: table[state.tx_cnst.long()])
            by_view = sync_calls(lambda: adaptive.lookup(table, state.tx_cnst))
            print(f"[links] a table read by a 0-dim tensor index makes {len(by_0dim)} synchronising "
                  f"calls, through adaptive.lookup {len(by_view)}")
            check(not by_view, f"adaptive.lookup made synchronising calls: {by_view}")
            _w, busy, n_k = profiled(lambda: run(state, 3, draws=draws), sacrifice=True)
            print(f"[links] simplex.run, 3 profiled rounds: {n_k / 3:.0f} device kernels and copies a round "
                  f"({EQ_PER_STEP} of them the equalizer kernel), device busy {busy / 3:.3f} ms a round, idle "
                  f"share {1 - busy / 3 / ms:.4f} of the {ms:.1f} ms round ({card})")
        else:
            check((tx == BPSK).all(), f"simplex at noise {noise_fwd}: TX constellations {tx.tolist()}")
        print(f"[links] simplex.run, {LINK_ROUNDS} rounds, forward noise {noise_fwd} (snr_db median "
              f"{np.median(telem['snr_db']):.1f}), reverse bursts at noise 0.1 "
              f"({int(telem['burst_ok'].sum())} of {LINK_ROUNDS} decoded): TX constellation "
              f"{tx[0]} -> {tx[-1]}; {ms:.1f} ms a round, wall clock ({card})"
              + (f"; synchronising calls in 3 traced rounds: {len(waits)}" if name == "high" else ""),
              flush=True)

    # ---- full duplex, uncoded and on the LDPC path: A->B clean, B->A poor ----
    Hm = alist.load_alist(str(ROOT / "examples" / BANK_ALISTS[1]))
    for name, path in (("uncoded", None), ("fec", str(FEC_CONFIG))):
        cfg = cfgmod.make_full_duplex_config(path, frame_length=FRAME_LENGTH)
        fec = fec_chain.build_fec(cfg, Hm, dev) if path else None
        run, tables = full_duplex.build_full_duplex(cfg, dev, noise_ab=NOISE_HIGH_SNR,
                                                    noise_ba=NOISE_LOW_SNR, fec=fec)
        state = full_duplex.initial_duplex_state(cfg, tables, dev)
        telem, ms = timed_run(run, state, SEED + 19, f"full_duplex.run ({name})", 2)
        a_tx, b_tx = telem["a_tx_cnst"], telem["b_tx_cnst"]
        check(a_tx[-1] == QAM16 and telem["b_crc_ok"][-8:].all(),
              f"full_duplex {name}: the clean direction's TX constellations {a_tx.tolist()}")
        check(b_tx[-1] == BPSK and (b_tx[-8:] == BPSK).all(),
              f"full_duplex {name}: the poor direction's TX constellations {b_tx.tolist()}")
        check(np.isfinite(telem["snr_at_a"]).all() and np.isfinite(telem["snr_at_b"]).all(),
              f"full_duplex {name}: snr not finite")
        extra = ""
        if fec is None:
            draws = simplex.draw_rounds(run.draw_shapes, 3, dev, torch.Generator(device=dev).manual_seed(1))
            waits = sync_calls(lambda: run(state, 3, draws=draws))
            check(len(waits) <= 1, f"full_duplex.run of 3 rounds made synchronising calls: {waits}")
            _w, busy, n_k = profiled(lambda: run(state, 3, draws=draws), sacrifice=True)
            extra = (f"; synchronising calls in 3 traced rounds: {len(waits)}; {n_k / 3:.0f} device kernels and "
                     f"copies a round, device busy {busy / 3:.3f} ms, idle share {1 - busy / 3 / ms:.4f}")
        else:
            check((telem["a_tx_fec"] == 1).all() and (telem["b_tx_fec"] == 1).all(),
                  "full_duplex fec: the one-code ladder left code 1")
        print(f"[links] full_duplex.run ({name}), {LINK_ROUNDS} rounds, noise A->B {NOISE_HIGH_SNR} "
              f"(snr_db median {np.median(telem['snr_at_b']):.1f}), B->A {NOISE_LOW_SNR} "
              f"({np.median(telem['snr_at_a']):.1f}): A's TX {a_tx[0]} -> {a_tx[-1]}, B's "
              f"{b_tx[0]} -> {b_tx[-1]}; {ms:.1f} ms a round, wall clock ({card}){extra}", flush=True)

    # ---- 17. StreamSimplex: 30 dB forward, a lossy reverse channel ----
    F, n_steps = DUPLEX_F, 16
    txcfg = cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH, max_empty_frames=-1)
    rxcfg = cfgmod.make_rx_config(None, frame_length=FRAME_LENGTH)
    rng = np.random.RandomState(7)
    drops = []

    def chan_fwd(s):
        nv = np.sqrt((float(np.mean(np.abs(s) ** 2)) or 1.0) / 10 ** 3.0)
        return s + (rng.randn(*s.shape) + 1j * rng.randn(*s.shape)) * nv / np.sqrt(2)

    def chan_rev(s):  # half the reverse blocks blacked out, a CFO, AWGN
        drops.append(rng.rand() < 0.5)
        out = np.zeros_like(s) if drops[-1] else s.copy()
        out = out * np.exp(1j * 0.0015 * np.arange(len(out)))
        return out + (rng.randn(*out.shape) + 1j * rng.randn(*out.shape)).astype(np.complex64) * 0.02

    spx = session.StreamSimplex(txcfg, rxcfg, chan_fwd, chan_rev, dev, frames_per_block=F, seed=5)
    spx.tx.send(b"\x55" * 64)
    with FeedbackCheck(f"StreamSimplex F={F}") as fc:
        reset_counts()
        t0 = time.perf_counter()
        history = []
        for _ in range(n_steps):
            r = spx.step()
            check(r is not None, "StreamSimplex stopped")
            history.append((r["want"], r["applied"], spx.tx.constellation))
        ms = (time.perf_counter() - t0) * 1e3 / n_steps
    K7.add(fc.what, fc.calls, fc.launches, fc.frames, fc.err, fc.by_kernel)
    counts = read_counts()
    check(counts == (n_steps,) * 3, f"StreamSimplex: kernel launches {counts} in {n_steps} steps")
    EQ.counted(n_steps, "StreamSimplex")
    applied = [h[1] for h in history]
    check(spx.tx.constellation == QAM16, f"StreamSimplex: the TX ended at {spx.tx.constellation}: {history}")
    check(any(drops) and not all(drops) and any(a is None for a in applied)
          and any(a is not None for a in applied), "StreamSimplex: the reverse channel lost no burst, or all")
    cnsts = [BPSK] + [h[2] for h in history]
    check(all(h[1] is not None for i, h in enumerate(history) if cnsts[i + 1] != cnsts[i]),
          "StreamSimplex: the TX moved on a step whose burst was lost")
    print(f"[links] StreamSimplex F={F}, {n_steps} steps, forward 30 dB, reverse blocks dropped "
          f"{sum(drops)} of {len(drops)} + CFO 0.0015 rad/sample + AWGN 0.02: the TX climbed "
          f"{BPSK} -> {spx.tx.constellation}, bursts applied on {sum(a is not None for a in applied)} "
          f"steps, never on a dropped one; kernel launches (metric, lock scan, accounting) {counts}; "
          f"{ms:.1f} ms a step, wall clock ({card})", flush=True)
    return counts, n_steps


def slice_d_phases(dev, card) -> tuple:
    """Phases 13-17.  Returns the three kernels' launches on the new paths,
    the batch steps among them (the metric kernel alone), the session blocks
    (all three kernels), and the metric kernel's largest error there."""
    counts, steps, blocks, max_err = channels_phase(dev, card)
    torch.cuda.empty_cache()
    bursts_phase(dev, card)
    link_counts, link_steps = links_phase(dev, card)
    return tuple(a + b for a, b in zip(counts, link_counts)), steps, blocks + link_steps, max_err

# ---------------------------------------------------------------------------
# phases 18-21: the equalizer kernel (csrc/equalizer.cu)
# ---------------------------------------------------------------------------

EQ_PER_STEP = 4  # header and payload call, two passes (eq_passes = 2)
EQ_CHECK_B = (1, 2, 31, 32, 33, 1024, 2048)


class EqualizerLedger:
    """What the script has seen of the equalizer kernel: its launches over
    the counted runs of the main paths (4 a receive step, checked at every
    run) and its comparisons with the plain loop."""

    def __init__(self):
        self.launches = self.steps = self.rows = self.boundary_rows = 0
        self.max_abs_err = 0.0

    def counted(self, steps: int, what: str, per_step: int = EQ_PER_STEP) -> None:
        """After a run that began with the counts at 0."""
        n = equalizer_cuda.equalize_frame_cuda.LAUNCHES
        check(n == per_step * steps, f"{what}: {n} equalizer kernel launches in {steps} receive "
              f"steps, expected {per_step} a step")
        self.launches += n
        self.steps += steps

    def compared(self, res: dict, what: str) -> None:
        check(res["fault_rows"] == 0, f"equalizer kernel vs plain on {what}: {res}")
        self.rows += res["rows"]
        self.boundary_rows += res["boundary_rows"]
        self.max_abs_err = max(self.max_abs_err, res["max_abs_err"])


EQ = EqualizerLedger()


class EqualizerCheck:
    """While active, every ``equalize_frame`` call a receive step makes also
    goes through the plain loop on the same tensors, and the two are held
    to the bar of ``equalizer_cuda.compare_with_plain`` (decisions equal,
    soft and taps within 1e-5; rows that part on a decision boundary counted
    apart, under 0.1% of the rows).  The step goes on with the kernel's
    outputs.  A call in table mode (wire-compat tables) must be bit-equal
    to the plain loop on every row.  Reads the device at every call: for
    check runs only."""

    def __init__(self, what: str):
        self.what, self.calls, self.rows, self.boundary_rows, self.max_abs_err = what, 0, 0, 0, 0.0
        self.table_rows = 0

    def __enter__(self):
        self._orig = equalizer.equalize_frame

        def both(spectra, init_taps, cnst_id, eq, sym_offset=0):
            got = self._orig(spectra, init_taps, cnst_id, eq, sym_offset)
            want = equalizer._equalize_frame_torch(spectra, init_taps, cnst_id, eq, sym_offset)
            res = equalizer_cuda.compare_with_plain(got, want, cnst_id, eq, sym_offset)
            where = (f"{self.what}, call {self.calls} ({tuple(spectra.shape)}, strides {spectra.stride()}, "
                     f"sym_offset {sym_offset})")
            EQ.compared(res, where)
            if eq.tab.table_mode:
                n = eq_bench.rows_not_bit_equal(got, want)
                check(n == 0, f"table mode: {n} rows not bit-equal to the plain loop on {where}")
                self.table_rows += res["rows"]
            self.calls += 1
            self.rows += res["rows"]
            self.boundary_rows += res["boundary_rows"]
            self.max_abs_err = max(self.max_abs_err, res["max_abs_err"])
            return got

        equalizer.equalize_frame = both
        return self

    def __exit__(self, *exc):
        equalizer.equalize_frame = self._orig
        if exc[0] is None:
            check(self.calls > 0, f"{self.what}: the path made no equalize_frame call")
            check(self.boundary_rows <= max(1, self.rows // 1000),
                  f"{self.what}: {self.boundary_rows} of {self.rows} rows part from the plain loop")
            print(f"[equalizer] on the path's own tensors, {self.what}: {self.calls} equalize_frame calls, "
                  f"{self.rows} rows: kernel vs plain loop 0 fault rows, {self.boundary_rows} rows parted at a "
                  f"decision boundary, max abs err on the others {self.max_abs_err:.2e}"
                  + (f"; {self.table_rows} rows in table mode, every one bit-equal" if self.table_rows else ""),
                  flush=True)


@contextlib.contextmanager
def plain_equalizer():
    """The receive step on the plain loop (what the port ran before the kernel)."""
    orig = equalizer.equalize_frame
    equalizer.equalize_frame = equalizer._equalize_frame_torch
    try:
        yield
    finally:
        equalizer.equalize_frame = orig


def equalizer_vs_plain(dev) -> None:
    """Phase 18: the kernel against the plain loop on synthetic frames at
    the shapes the paths hand it (header call n_sym 1, payload call n_sym
    20), B = 1 .. 2048, mixed constellations (with an id 0) at every B and
    each constellation alone at B = 33 and 2048, updating and frozen taps,
    a strided view of a frame's spectra, and frames whose first symbol sits
    within 2e-6 of the decision boundaries."""
    n_cases = 0
    for alpha in (0.1, 1.0):
        eq = eq_bench.eq_tables(dev, alpha)
        for B in EQ_CHECK_B:
            ids = {"mixed": np.array([(1, 2, 3, 4, 0)[i % 5] for i in range(B)], np.int32)}
            if B in (33, 2048):
                ids.update({f"cnst {c}": np.full(B, c, np.int32) for c in (1, 2, 3, 4)})
            if alpha == 1.0 and B not in (33, 2048):
                continue
            for name, cnst in ids.items():
                for call, (n_sym, off) in eq_bench.CALLS.items():
                    args = eq_bench.on_device(eq_bench.frame_inputs(eq, B, n_sym, off, cnst, B + n_sym), cnst, dev)
                    before = equalizer_cuda.equalize_frame_cuda.LAUNCHES
                    res = eq_bench.held_to_plain(eq, args, off, f"B={B} {call} {name} alpha={alpha}")
                    check(equalizer_cuda.equalize_frame_cuda.LAUNCHES == before + 1,
                          "equalize_frame on CUDA tensors did not launch the kernel once")
                    check(res["boundary_rows"] <= max(1, B // 1000), f"B={B} {call} {name}: {res}")
                    EQ.compared(res, f"B={B} {call} {name}")
                    n_cases += 1
    print(f"[equalizer] kernel vs plain loop on synthetic frames: {n_cases} cases (B = {list(EQ_CHECK_B)}, "
          f"header and payload calls, mixed ids and each alone, alpha 0.1 and 1.0): 0 fault rows, "
          f"{EQ.boundary_rows} of {EQ.rows} rows parted at a decision boundary, max abs err on the others "
          f"{EQ.max_abs_err:.2e} (bar: decisions equal, soft and taps atol 1e-5)", flush=True)

    eq = eq_bench.eq_tables(dev)
    B = 2048
    cnst = eq_bench.mixed_ids(B)
    data, taps0 = eq_bench.frame_inputs(eq, B, 1 + FRAME_LENGTH, 0, cnst, 5)
    frame = torch.zeros((B, 2 + 1 + FRAME_LENGTH, 64), dtype=torch.complex64, device=dev)
    frame[:, 2:] = torch.as_tensor(data, device=dev)
    taps, ids = torch.as_tensor(taps0, device=dev), torch.as_tensor(cnst, device=dev)
    hdr_args = (frame[:, 2:3], taps, torch.ones_like(ids))
    EQ.compared(eq_bench.held_to_plain(eq, hdr_args, 0, "strided header view"), "strided header view")
    hdr = equalizer.equalize_frame(*hdr_args, eq, 0)
    res = eq_bench.held_to_plain(eq, (frame[:, 3:], hdr.taps, ids), 1, "strided payload view")
    EQ.compared(res, "strided payload view")
    print(f"[equalizer] strided views of [B, 23, 64] spectra (strides {frame[:, 3:].stride()}) at B={B}: header "
          f"and payload calls equal the plain loop ({res['boundary_rows']} boundary rows)")

    args = eq_bench.on_device(eq_bench.boundary_inputs(eq, B, FRAME_LENGTH, 1, cnst, 7), cnst, dev)
    res = eq_bench.held_to_plain(eq, args, 1, "frames at the decision boundaries")
    print(f"[equalizer] B={B} frames whose first payload symbol sits within 2e-6 of a decision boundary on "
          f"every data carrier: 0 fault rows, {res['boundary_rows']} rows decided differently from the plain "
          f"loop (each at a carrier within 1e-5 of a boundary)", flush=True)


def census(what: str, stages: dict, step_ms: float, card: str) -> None:
    """Device kernels and copies, and device busy ms, of each stage of one
    receive step, each stage profiled alone after one sacrificed call."""
    total_n, total_busy, parts = 0, 0.0, []
    for name, fn in stages.items():
        for _ in range(3):  # a profiler window now and then comes back empty
            _w, busy, n = profiled(fn, sacrifice=True)
            if n:
                break
        check(n > 0, f"census of {what}: the profiler saw no device work in {name}")
        total_n += n
        total_busy += busy
        parts.append(f"{name} {n} ({busy:.3f} ms busy)")
    print(f"[census] {what}: device kernels and copies a step by stage: " + ", ".join(parts)
          + f"; {total_n} a step, device busy {total_busy:.3f} ms, idle share {1 - total_busy / step_ms:.4f} "
          f"of the {step_ms:.3f} ms step median ({card})", flush=True)


def time_equalizer(dev, card: str) -> dict:
    """Phase 21: the kernel alone at the paths' shapes (tools/bench_equalizer
    times it the same way); returns its entry for the ``kernels`` line, at
    the uncoded step's payload call."""
    eq = eq_bench.eq_tables(dev)
    timed = {(B, call): eq_bench.measure(eq, B, call, dev, card)
             for B in eq_bench.BATCHES for call in eq_bench.CALLS}
    for r in timed.values():
        EQ.compared(r, f"B={r['B']} {r['call']}")
    B = max(eq_bench.BATCHES)  # the uncoded step's batch
    step = sum(timed[(B, call)]["ms"] for call in eq_bench.CALLS) * 2
    bound = sum(timed[(B, call)]["bound_ms"] for call in eq_bench.CALLS) * 2
    print(f"[equalizer] a receive step at B={B}: {EQ_PER_STEP} launches, {step * 1e3:.2f} us of kernel time "
          f"against a bound of {bound * 1e3:.2f} us ({card})")
    # what a step issues (the build's SASS) and the issue floor of the payload call
    sass = eq_bench.sass_report()
    check(all(v["spill_bytes"] == 0 for v in sass["ptxas"].values()), f"the equalizer kernel spills: {sass['ptxas']}")
    check(all(sass["one_wave_at_2048"].values()), f"B=2048 does not fit one wave: {sass['blocks_per_sm']} blocks an SM")
    floor = sass["issue_floor_ms"][f"{B}/payload"]
    print(f"[equalizer] the step's SASS: {sass['closed']['mixed_ids_step']:.2f} instructions a step over the mixed "
          f"ids (BPSK/QPSK, 8PSK, 16QAM: {[v['instructions'] for v in sass['closed']['slicers'].values()]}; "
          f"MUFU.RCP {[v['mufu_rcp'] for v in sass['closed']['slicers'].values()]}), table mode's longest "
          f"{sass['table']['longest']}; {sass['ptxas']}; {sass['blocks_per_sm']} blocks an SM; the payload "
          f"call's issue floor at B={B} {floor * 1e3:.2f} us at {sass['clocks_max_sm_mhz']:.0f} MHz ({card})",
          flush=True)
    t = timed[(B, "payload")]
    return {"name": "equalize_frame", "route": "cuda",
            "source": "gr_dtl_tpu_torch/csrc/equalizer.cu",
            "replaces": "gr_dtl_tpu/ops/equalizer.py:189",
            "launches": EQ.launches, "launches_per_step": EQ.launches / EQ.steps,
            "max_abs_err": EQ.max_abs_err, "boundary_rows": EQ.boundary_rows, "rows_compared": EQ.rows,
            "ms": t["ms"], "ms_by": "profiler", "enqueue_ms": t["enqueue_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes", "bytes": t["bytes"], "library_ms": None,
            "at_B": B, "at_n_sym": t["n_sym"],
            "ms_at_B": {f"{b}/{c}": timed[(b, c)]["ms"] for b, c in timed},
            "instructions_per_step": sass["closed"]["mixed_ids_step"],
            "instructions_per_step_by_slicer": {k: v["instructions"] for k, v in sass["closed"]["slicers"].items()},
            "issue_floor_ms": floor, "blocks_per_sm": sass["blocks_per_sm"]["closed"]}


# ---------------------------------------------------------------------------
# phases 22-23: the sessions' telemetry and the wire-compat mode
# ---------------------------------------------------------------------------

PROBE_F = (16, 1024)  # the stream's narrowest block and its full width
PROBE_BLOCKS = 16     # 15 blocks of traffic, then one of idle air
PROBE_CPU_BLOCKS = {16: 4, 1024: 2}  # blocks held against the port's CPU run
WIRE_NATIVE_B = 256   # the native batch after the wire tables are removed


def parse_all(blobs) -> list:
    parser = monitor.MonitorParser()
    return [parser.parse(b) for b in blobs]


def same_message(got: dict, want: dict, what: str) -> float:
    """Ints and the loss rate equal, the SNR and noise variance within 1e-3
    relative (the bar of card vs CPU on a stream); returns the larger
    relative difference."""
    for k in ("proto_id", "sent_counter", "constellation_key", "fec_key", "lost_frames_rate"):
        check(got[k] == want[k], f"{what}: {k} {got[k]} against {want[k]}")
    rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in ("estimated_snr_tag_key", "noise_tag_key"))
    check(rel <= 1e-3, f"{what}: SNR or noise variance {rel} apart")
    return rel


def probe_stream(F: int, rcfg, tcfg, dev, gen, card) -> None:
    """Phase 22 at one F: the probed StreamRx over a stream whose every frame
    decodes, its messages against what was sent and against the CPU run,
    and its cost a block."""
    P = rcfg.frame_samples
    n_frames = (PROBE_BLOCKS - 1) * F
    stream, sent = make_stream(tcfg, n_frames, PROBE_BLOCKS, F * P, dev, gen)
    probe = monitor.MonitorProbe(address=None)
    rx = session.StreamRx(rcfg, dev, frames_per_block=F, probe=probe)
    reset_counts()
    _wall, _dev, results = run_receiver(rx, stream)
    counts = read_counts()
    check(counts == (PROBE_BLOCKS,) * 3, f"probed F={F}: kernel launches {counts} in {PROBE_BLOCKS} blocks")
    EQ.counted(PROBE_BLOCKS, f"probed StreamRx F={F}")
    msgs = parse_all(probe.captured)
    n_rx = sum(int((v & v.header_ok).sum()) for _, v in results)
    check(len(msgs) == n_rx == n_frames, f"probed F={F}: {len(msgs)} messages, {n_rx} frames received, "
          f"{n_frames} sent")
    check([m["sent_counter"] for m in msgs] == list(range(1, n_frames + 1))
          and all(m["proto_id"] == monitor.EQ_MSG and m["lost_frames_rate"] == 0.0 for m in msgs),
          f"probed F={F}: counters, proto ids or loss rates")
    keys = torch.tensor([m["constellation_key"] for m in msgs], dtype=torch.int32)
    check(torch.equal(keys, sent["cnst_id"].cpu()), f"probed F={F}: constellation_key differs from what was sent")
    snr = np.array([m["estimated_snr_tag_key"] for m in msgs])
    check(bool(np.isfinite(snr).all()) and snr.min() > 10.0, f"probed F={F}: SNR {snr.min()}..{snr.max()}")

    nb = PROBE_CPU_BLOCKS[F]
    cpu_probe = monitor.MonitorProbe(address=None)
    rx_cpu = session.StreamRx(rcfg, "cpu", frames_per_block=F, probe=cpu_probe)
    for b in range(nb):
        rx_cpu.process(stream[b * F * P:(b + 1) * F * P])
    want = parse_all(cpu_probe.captured)
    check(len(want) >= (nb - 1) * F, f"probed F={F}: {len(want)} messages from the CPU run of {nb} blocks")
    worst = max(same_message(g, w, f"probed F={F} message {i}, card vs CPU")
                for i, (g, w) in enumerate(zip(msgs, want)))

    # ms a block with and without the probe, in turns
    wall, host = {"plain": [], "probed": []}, []
    for turn in ("plain", "probed", "probed", "plain"):
        r = session.StreamRx(rcfg, dev, frames_per_block=F,
                             probe=monitor.MonitorProbe(address=None) if turn == "probed" else None)
        w, _, _ = run_receiver(r, stream)
        wall[turn].append(median(w[WARM_BLOCKS:]))
        if turn == "probed":
            host.append(r.probe_host_ms / (PROBE_BLOCKS - 1))  # the blocks that carry frames
    print(f"[telemetry] F={F}: StreamRx(probe=MonitorProbe(address=None)) over {PROBE_BLOCKS} blocks, {n_frames} "
          f"frames: {len(msgs)} MonitorEqMsg, one a received frame, all parsed, constellation_key the sent "
          f"constellation, sent_counter 1..{n_frames}; the first {len(want)} against the CPU run: ints equal, SNR "
          f"and noise variance within {worst:.2e} relative; kernel launches (metric, lock scan, accounting) "
          f"{counts}, equalizer {EQ_PER_STEP * PROBE_BLOCKS}; wall ms a block (median after {WARM_BLOCKS} "
          f"warm-up blocks, in turns plain, probed, probed, plain): plain {[round(x, 3) for x in wall['plain']]}, "
          f"probed {[round(x, 3) for x in wall['probed']]}; host ms building messages a block "
          f"{[round(x, 3) for x in host]} ({F} messages, "
          f"{1e3 * min(host) / F:.2f} us a message) ({card})", flush=True)


def telemetry_phase(dev, card) -> None:
    """Phase 22: the probed receivers, a traced probed dispatch, a probed
    StreamDuplex."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    rcfg = cfgmod.make_rx_config(None, frame_length=FRAME_LENGTH)
    tcfg = cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH)
    for F in PROBE_F:
        probe_stream(F, rcfg, tcfg, dev, gen, card)
        torch.cuda.empty_cache()
    F, P = 16, rcfg.frame_samples
    stream, _ = make_stream(tcfg, 7 * F, 8, F * P, dev, gen)
    probe = monitor.MonitorProbe(address=None)
    rx = session.StreamRx(rcfg, dev, frames_per_block=F, probe=probe)
    traced_dispatch(rx, [stream[i * F * P:(i + 1) * F * P] for i in range(8)], "probed")
    check(len(probe.captured) == rx.n_frames, "probed dispatch: a message for each received frame")
    print(f"[telemetry] a probed _dispatch at F={F}: no synchronising call, no pageable copy; the packed "
          f"vector holds {rx._acct_words} words (2 + 6F)", flush=True)

    Fd = DUPLEX_F
    txcfg = cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH, max_empty_frames=-1)
    probes = [monitor.MonitorProbe(address=None) for _ in range(2)]
    dpx = session.StreamDuplex(txcfg, rcfg, txcfg, rcfg, awgn_chan(30.0, 21, dev), awgn_chan(5.0, 22, dev), dev,
                               frames_per_block=Fd, probe_a=probes[0], probe_b=probes[1])
    reset_counts()
    res = [dpx.step() for _ in range(12)]
    torch.cuda.synchronize()
    check(read_counts() == (24, 24, 24), f"probed duplex: kernel launches {read_counts()} in 12 steps")
    EQ.counted(24, "probed StreamDuplex, two receivers a step")
    for side, p, peer in (("a", probes[0], "b"), ("b", probes[1], "a")):
        n_ok = sum(r[f"ctl_{side}"]["n_ok"] for r in res)
        msgs = parse_all(p.captured)
        check(len(msgs) == n_ok, f"probed duplex, {side}'s receiver: {len(msgs)} messages, {n_ok} frames decoded")
        keys = [m["constellation_key"] for m in msgs]
        sent = np.concatenate([r[side].cnst_id.cpu().numpy()[np.asarray(r[side].header_ok.cpu())] for r in res])
        check(len(sent) >= n_ok and set(keys) <= {1, 2, 3, 4}, f"probed duplex, {side}: keys {set(keys)}")
    keys_b = {m["constellation_key"] for m in parse_all(probes[1].captured)}
    check(max(keys_b) > 1 and dpx.tx_a.constellation > 1, "probed duplex: A's TX did not climb at 30 dB")
    print(f"[telemetry] StreamDuplex(probe_a, probe_b) at F={Fd}, 12 steps, 30 / 5 dB: "
          f"{len(probes[1].captured)} messages at B (constellations {sorted(keys_b)}), "
          f"{len(probes[0].captured)} at A, one a decoded frame; 2 launches of each kernel a step", flush=True)


def wire_phase(dev, card) -> dict:
    """Phase 23; returns the ``kernels`` entry of the equalizer kernel's
    table mode."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    table_launches, chk_rows, chk_err = 0, 0, 0.0
    # a native receiver and stream built first keep the native tables: the
    # two steps are timed in turns below
    native_rxp = receiver.build_rx(cfgmod.make_rx_config(None, frame_length=FRAME_LENGTH), dev)
    native_stream, _ = make_traffic(cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH), B, dev, gen)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "wire_constants.json"
        path.write_text(json.dumps(eq_bench.foreign_constants()))
        tcfg = cfgmod.make_tx_config({"wire_compat": str(path)}, frame_length=FRAME_LENGTH)
    try:
        check(cn.TABLE_MODE, "a config with wire_compat did not install the tables")
        rcfg = cfgmod.make_rx_config(None, frame_length=FRAME_LENGTH)
        rxp = receiver.build_rx(rcfg, dev)
        check(rxp.tab.table_mode, "a receiver built under the wire tables is not in table mode")
        stream, sent = make_traffic(tcfg, B, dev, gen)
        reset_counts()
        out = rx_step(rxp, stream, B)
        torch.cuda.synchronize()
        check(sync_cuda.timing_metric_cuda.LAUNCHES == 1, "wire uncoded: the metric kernel was not launched once")
        EQ.counted(1, "wire uncoded step")
        n = equalizer_cuda.equalize_frame_cuda.TABLE_LAUNCHES
        check(n == EQ_PER_STEP, f"wire uncoded: {n} table-mode launches of the equalizer kernel in a step")
        table_launches += n
        check_decoded(out, sent, f"wire uncoded B={B}")
        with EqualizerCheck(f"wire uncoded B={B}") as chk:
            rx_step(rxp, stream, B)
        chk_rows, chk_err = chk_rows + chk.table_rows, max(chk_err, chk.max_abs_err)

        _, _, txp_c, rxp_c = coded_params(BANK_ALISTS[1:], dev)
        check(txp_c.tab.table_mode and rxp_c.tab.table_mode, "the coded models are not in table mode")
        samples, sent_c = coded_tx(txp_c, np.full(B_FEC, 2, np.int32), None)
        stream_c = noisy(samples, 25.0, gen)[0]
        reset_counts()
        out_c = rx_step(rxp_c, stream_c, B_FEC)
        torch.cuda.synchronize()
        EQ.counted(1, "wire coded step")
        n = equalizer_cuda.equalize_frame_cuda.TABLE_LAUNCHES
        check(n == EQ_PER_STEP, f"wire coded: {n} table-mode launches of the equalizer kernel in a step")
        table_launches += n
        check_decoded(out_c, sent_c, f"wire coded B={B_FEC} at 25 dB")
        with EqualizerCheck(f"wire coded B={B_FEC} at 25 dB") as chk:
            rx_step(rxp_c, stream_c, B_FEC)
        chk_rows, chk_err = chk_rows + chk.table_rows, max(chk_err, chk.max_abs_err)
        step_ms = {"native": [], "wire": []}
        for turn in ("native", "wire", "wire", "native"):
            r, st = (native_rxp, native_stream) if turn == "native" else (rxp, stream)
            rx_step(r, st, B)
            step_ms[turn].append(median([cuda_ms(lambda: rx_step(r, st, B), STEPS_PER_WINDOW) for _ in range(3)]))
        print(f"[wire] uncoded B={B} step (detect_and_extract + rx_frames), median of 3 windows of "
              f"{STEPS_PER_WINDOW} steps, in turns: native tables {[round(x, 3) for x in step_ms['native']]} ms, "
              f"wire tables {[round(x, 3) for x in step_ms['wire']]} ms ({card})", flush=True)
        print(f"[wire] foreign constants (QPSK / 8PSK / 16QAM relabeled, a random sync PN) through a config's "
              f"wire_compat: uncoded B={B} mixed at noise {NOISE_V}: {int(out.crc_ok.sum())}/{B} CRC, payloads "
              f"equal; coded B={B_FEC} QPSK at 25 dB: {int(out_c.crc_ok.sum())}/{B_FEC}; the equalizer kernel "
              f"in table mode {EQ_PER_STEP} launches a step ({table_launches} counted), bit-equal to the plain "
              f"loop on {chk_rows} rows of both steps ({card})", flush=True)
    finally:
        wire_compat.deactivate()

    check(not cn.TABLE_MODE, "deactivate left the tables installed")
    ntcfg = cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH)
    nrxp = receiver.build_rx(cfgmod.make_rx_config(None, frame_length=FRAME_LENGTH), dev)
    stream_n, sent_n = make_traffic(ntcfg, WIRE_NATIVE_B, dev, gen)
    reset_counts()
    out_n = rx_step(nrxp, stream_n, WIRE_NATIVE_B)
    out_w = rx_step(rxp, stream, B)  # built before deactivate: keeps the foreign tables
    torch.cuda.synchronize()
    check(equalizer_cuda.equalize_frame_cuda.TABLE_LAUNCHES == EQ_PER_STEP
          and equalizer_cuda.equalize_frame_cuda.LAUNCHES == 2 * EQ_PER_STEP,
          "after deactivate: the native step launched the table mode, or the foreign receiver did not")
    check_decoded(out_n, sent_n, f"native B={WIRE_NATIVE_B} after deactivate")
    check_decoded(out_w, sent, f"the foreign receiver, B={B}, after deactivate")
    print(f"[wire] deactivated: a native batch of {WIRE_NATIVE_B} decodes on the closed-form slicers "
          f"({int(out_n.crc_ok.sum())}/{WIRE_NATIVE_B}, no table-mode launch), and the receiver built under the "
          f"foreign tables still decodes their stream ({int(out_w.crc_ok.sum())}/{B})", flush=True)
    del stream, out, out_w, stream_c, out_c, rxp, rxp_c, txp_c, native_rxp, native_stream

    timed = eq_bench.table_mode(dev, card)
    t = timed[-1]  # B = 2048, the uncoded step's payload call
    return {"name": "equalize_frame_table", "route": "cuda",
            "source": "gr_dtl_tpu_torch/csrc/equalizer.cu",
            "replaces": "gr_dtl_tpu/ops/equalizer.py:189", "decides_as": "gr_dtl_tpu/ops/constellation.py:410",
            "launches": table_launches, "launches_per_step": table_launches / 2,
            "max_abs_err": chk_err, "rows_compared": chk_rows, "rows_not_bit_equal": 0,
            "ms": t["ms"], "ms_by": "profiler", "enqueue_ms": t["enqueue_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes", "bytes": t["bytes"], "library_ms": None,
            "at_B": t["B"], "at_n_sym": t["n_sym"],
            "closed_form_ms_same_inputs": min(t["closed_ms_in_turns"]),
            "ms_at_B": {r["B"]: r["ms"] for r in timed},
            "closed_form_ms_at_B": {r["B"]: min(r["closed_ms_in_turns"]) for r in timed}}


# ---------------------------------------------------------------------------
# phase 24: the sharded session (parallel/) on a one-rank NCCL group
# ---------------------------------------------------------------------------

SHARD_S, SHARD_F = 64, 32        # streams, frames a block: 2048 frames, 3,768,320 samples a block
SHARD_WARM, SHARD_TIMED = 2, 16  # blocks of traffic: warm-up, then timed; then one of idle air
SHARD_STREAMRX = (0, 21, 42, 63)  # streams held against StreamRx on the same samples
SHARD_CODED = (8, 64, 4)         # coded W = 2 at 25 dB: streams, frames a block, blocks
SHARD_MEGA = (64, 16, 4, 8)      # the megastep: streams, frames a block, K, blocks
SHARD_SMALL = (4, 8, 4)          # the card against the port's CPU run: streams, F, blocks
# synthetic inputs of the batched scans and TB ring against their plain loops
SHARD_SCAN_CASES = [(1, 16), (1, 32), (1, 1024), (8, 16), (8, 32), (8, 1024), (64, 16), (64, 32), (64, 64)]
SHARD_TB_CASES = [(1, 1), (1, 1024), (8, 64), (8, 256), (64, 64)]


def shard_streams(tcfg, S: int, n_frames: int, n_blocks: int, block_samples: int, dev, gen,
                  seed: int, fec=None):
    """S streams of n_frames frames each, stream s from sample 300 + 37 s
    mod 1500 (so that every block boundary cuts a frame), idle air to
    n_blocks blocks: uncoded, mixed constellations 1..4 filled to capacity
    and noise voltage NOISE_V; coded (``fec``), one QPSK transport block of
    W frames each at 25 dB of the measured power.  Returns (samples as host
    numpy [S, n_blocks * block_samples], what was sent: [S, n_frames]
    tensors on ``dev``)."""
    rng = np.random.RandomState(seed)
    P, n = tcfg.frame_samples, S * n_frames
    if fec is None:
        cnst = rng.randint(1, 5, (S, n_frames)).astype(np.int32)
        maxb = tcfg.max_frame_bytes()
        cap = np.array([0] + [tcfg.frame_bytes(b) - 4 for b in (1, 2, 3, 4)], np.int32)
        plen = cap[cn.BITS_PER_SYMBOL[cnst]]
        pad = torch.randint(0, 256, (n, maxb), generator=gen, device=dev, dtype=torch.uint8)
    else:
        cnst = np.full((S, n_frames), 2, np.int32)
        maxb = fec.max_payload_bytes
        plen = np.where(np.arange(n_frames) % fec.W == 0, int(fec.user_bytes_tab[2]), 0)
        plen = np.broadcast_to(plen, (S, n_frames)).astype(np.int32)
        pad = None
    payload = rng.randint(0, 256, (S, n_frames, maxb)).astype(np.uint8)
    payload[np.arange(maxb)[None, None, :] >= plen[:, :, None]] = 0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    sent = {"payload": t(payload), "payload_len": t(plen), "cnst_id": t(cnst),
            "frame_no": (torch.arange(n_frames, device=dev, dtype=torch.int32) % 4096).expand(S, -1)}
    out = transmitter.tx_frames(transmitter.build_tx(tcfg, dev, fec), sent["payload"].reshape(n, maxb),
                                sent["payload_len"].reshape(n), sent["cnst_id"].reshape(n),
                                torch.zeros(n, dtype=torch.int32, device=dev),
                                sent["frame_no"].reshape(n).contiguous(), pad)
    samples = out.samples.reshape(S, n_frames * P)
    x = torch.zeros((S, n_blocks * block_samples), dtype=torch.complex64, device=dev)
    for i in range(S):
        off = 300 + (37 * i) % 1500
        x[i, off: off + n_frames * P] = samples[i]
    nv = NOISE_V if fec is None else float(np.sqrt(float((samples.abs() ** 2).mean()) / 10 ** 2.5))
    return channel.awgn(x, nv, generator=gen).cpu().numpy(), sent


def run_sharded(srx, x: np.ndarray):
    """Every call of ``x`` through the sharded session: wall ms a call and,
    a call, (out, valid, header_ok, crc_ok[, tb])."""
    D = srx.dispatch_samples
    walls, res = [], []
    for i in range(x.shape[1] // D):
        t0 = time.perf_counter()
        r = srx.process(x[:, i * D:(i + 1) * D])
        walls.append((time.perf_counter() - t0) * 1e3)
        res.append((r[0], r[1].copy(), srx.last_header_ok.copy(), srx.last_crc_ok.copy()) + tuple(r[2:]))
    torch.cuda.synchronize()
    return walls, res


def sharded_frames(res) -> tuple:
    """The leaves [S, calls * K * F] (masks numpy, the rest where they lie)
    of a run's calls, in frame order."""
    S = res[0][1].shape[0]
    masks = {k: np.concatenate([r[i] for r in res], axis=1)
             for i, k in ((1, "valid"), (2, "header_ok"), (3, "crc_ok"))}
    out = {}
    for k in ("frame_no", "payload", "payload_len", "cnst_id", "header_ok", "crc_ok"):
        leaves = [getattr(r[0], k) for r in res]
        trail = leaves[0].shape[-1:] if k == "payload" else ()
        out[k] = torch.cat([a.reshape(S, -1, *trail) for a in leaves], 1)
    return out, masks


def check_sharded_decoded(res, sent, srx, what: str) -> int:
    """Every sent frame of every stream decoded once, in order, with the sent
    bytes; nothing lost.  Returns the frames decoded."""
    S, n_frames = sent["cnst_id"].shape
    dev = sent["cnst_id"].device
    out, masks = sharded_frames(res)
    keep = masks["valid"] & masks["crc_ok"]
    per = keep.sum(axis=1)
    check((per == n_frames).all(), f"{what}: frames decoded a stream {per.tolist()}, {n_frames} sent")
    sel = torch.as_tensor(keep, device=dev)
    for k, v in sent.items():
        got = out[k][sel].reshape(v.shape)
        check(torch.equal(got, v), f"{what}: decoded {k} differs from what was sent, or its order")
    check((srx.n_lost == 0).all() and (srx.n_frames == n_frames).all(),
          f"{what}: n_lost {srx.n_lost.max()}, n_frames {sorted(set(srx.n_frames.tolist()))}")
    return int(keep.sum())


def sharded_launches() -> tuple:
    return (sync_cuda.timing_metric_cuda.LAUNCHES, scans_cuda.trigger_lock_scan_cuda.LAUNCHES,
            scans_cuda.frame_accounting_cuda.LAUNCHES, tb_cuda.tb_reassemble_cuda.LAUNCHES,
            equalizer_cuda.equalize_frame_cuda.LAUNCHES)


class BatchedScanCheck:
    """While active, every call of the lock scan, the frame accounting and
    the TB ring (the batched kernels on the card) also runs the plain loop,
    stream by stream, on CPU copies of the same inputs, and every output and
    carried word must be equal.  The path goes on with the kernels'
    outputs.  Reads the device at every call: for check runs only."""

    def __init__(self, what: str, fec_cpu=None):
        self.what, self.fec_cpu, self.calls, self.worst = what, fec_cpu, {}, 0.0

    def _seen(self, name: str, err: float, shape) -> None:
        check(err == 0, f"{self.what}: batched {name} kernel vs plain loop on {tuple(shape)}: off by {err}")
        self.calls[name] = self.calls.get(name, 0) + 1
        self.worst = max(self.worst, err)

    def __enter__(self):
        self._orig = (streaming.trigger_lock_scan, metrics.frame_accounting, fec_chain.tb_reassemble)
        lock0, acct0, tb0 = self._orig
        cpu = lambda xs: [a.cpu() for a in xs]

        def lock(state, cand, found, period, tol=4):
            got = lock0(state, cand, found, period, tol)
            want = lock0(streaming.TriggerLockState(*cpu(state)), cand.cpu(), found.cpu(), period, tol)
            g = streaming.TriggerLockState(*cpu(got[0]))
            self._seen("trigger_lock_scan", int_err(lock_pairs(g, want[0], got[1][0].cpu(), want[1][0],
                                                               got[1][1].cpu(), want[1][1])), cand.shape)
            return got

        def acct(expected_no, frame_no, ok, rule="received"):
            got = acct0(expected_no, frame_no, ok, rule)
            want = acct0(expected_no.cpu(), frame_no.cpu(), ok.cpu(), rule)
            self._seen("frame_accounting", int_err(list(zip(cpu(got), want))), frame_no.shape)
            return got

        def tb(state, llrs, *rest):
            got = tb0(state, llrs, *rest)
            want = tb0(fec_chain.TbRing(*cpu(state)), llrs.cpu(), *cpu(rest[:-1]), self.fec_cpu)
            err = tb_err((fec_chain.TbRing(*cpu(got[0])), {k: v.cpu() for k, v in got[1].items()}), want)
            self._seen("tb_reassemble", err, llrs.shape)
            return got

        streaming.trigger_lock_scan, metrics.frame_accounting, fec_chain.tb_reassemble = lock, acct, tb
        return self

    def __exit__(self, *exc):
        streaming.trigger_lock_scan, metrics.frame_accounting, fec_chain.tb_reassemble = self._orig
        if exc[0] is None:
            check(self.calls, f"{self.what}: no scan call was checked")
            print(f"[sharded-kernels] on the block step's own tensors, {self.what}: batched kernels equal "
                  f"their plain per-stream loops, calls {self.calls}, largest |kernel - plain| {self.worst:g}",
                  flush=True)


def batched_vs_plain(dev) -> float:
    """The batched scan kernels ([S, T], state carried over two calls) and
    the batched TB ring (S rings, W = 2) against the plain loops stream by
    stream on synthetic inputs; returns the largest error, which must be 0."""
    worst = 0.0
    for S, T in SHARD_SCAN_CASES:
        lock = plain = None
        exp = exp0 = torch.full((S,), -1, dtype=torch.int32, device=dev)
        for call in range(2):
            ins = [lock_inputs(T, 7919 * S + 31 * T + 1000 * call + s, dev) for s in range(S)]
            c, f = torch.stack([i[0] for i in ins]), torch.stack([i[1] for i in ins])
            lock = streaming.initial_lock_state(dev, (S,)) if lock is None else lock
            plain = streaming.initial_lock_state("cpu", (S,)) if plain is None else plain
            lock, (trig, valid) = streaming.trigger_lock_scan(lock, c, f, 1840)
            plain, (trig0, valid0) = streaming.trigger_lock_scan(plain, c.cpu(), f.cpu(), 1840)
            g = streaming.TriggerLockState(*(a.cpu() for a in lock))
            err = int_err(lock_pairs(g, plain, trig.cpu(), trig0, valid.cpu(), valid0))
            n, o = acct_inputs(S * T, S + T + call, 4000 + call * (T + 3), dev)
            n, o = n.reshape(S, T), o.reshape(S, T)
            exp, lost, totals = metrics.frame_accounting(exp, n, o)
            exp0, lost0, totals0 = metrics.frame_accounting(exp0.cpu(), n.cpu(), o.cpu())
            err = max(err, int_err([(lost.cpu(), lost0), (totals.cpu(), totals0), (exp.cpu(), exp0)]))
            check(err == 0, f"batched scan kernels vs plain at S={S}, T={T}, call {call}: off by {err}")
            worst = max(worst, err)
            lock = lock._replace(expected=lock.expected - T * 1840)
            plain = plain._replace(expected=plain.expected - T * 1840)
    W = 2
    fec, fec_cpu = tb_fec(dev, W), tb_fec("cpu", W)
    for S, F in SHARD_TB_CASES:
        state, plain = fec_chain.init_tb_state(fec, dev, (S,)), fec_chain.init_tb_state(fec_cpu, "cpu", (S,))
        for call in range(2):
            recs = [tb_headers(F, W, fec, 100 * F + 10 * s + call, 3 * call, dev) for s in range(S)]
            args = [torch.stack(col) for col in zip(*recs)]
            tb_cuda.tb_reassemble_cuda.LAUNCHES = 0
            got = fec_chain.tb_reassemble(state, *args, fec)
            check(tb_cuda.tb_reassemble_cuda.LAUNCHES == 2, f"batched TB ring at S={S}: not 2 launches")
            want = fec_chain.tb_reassemble(plain, *(a.cpu() for a in args), fec_cpu)
            err = tb_err((fec_chain.TbRing(*(a.cpu() for a in got[0])),
                          {k: v.cpu() for k, v in got[1].items()}), want)
            check(err == 0, f"batched TB ring vs plain at S={S}, F={F}, call {call}: off by {err}")
            worst = max(worst, err)
            state, plain = got[0], want[0]
    print(f"[sharded-kernels] batched trigger_lock_scan and frame_accounting against the plain loop stream by "
          f"stream at (S, T) = {SHARD_SCAN_CASES}, and the batched TB ring (W = 2) at (S, F) = "
          f"{SHARD_TB_CASES}, two carried calls each: largest |kernel - plain| {worst:g}", flush=True)
    return worst


def time_batched(dev, card) -> dict:
    """The batched kernels at the sharded path's shapes beside S launches of
    the single-stream form on the same rows: device ms by the profiler (the
    S single launches summed), and the S launches' ms between events."""
    out = {}
    S, T = SHARD_S, SHARD_F
    c, f = (torch.stack(x) for x in zip(*[lock_inputs(T, 50 + s, dev) for s in range(S)]))
    packed = torch.zeros((S, 4), dtype=torch.int32, device=dev)
    n, o = (a.reshape(S, T) for a in acct_inputs(S * T, 77, 4000, dev))
    exp = torch.full((S,), -1, dtype=torch.int32, device=dev)
    calls = {"trigger_lock_scan": (lambda: scans_cuda.trigger_lock_scan_cuda(packed, c, f, 1840),
                                   lambda s: scans_cuda.trigger_lock_scan_cuda(packed[s], c[s], f[s], 1840),
                                   "trigger_lock_scan_kernel"),
             "frame_accounting": (lambda: scans_cuda.frame_accounting_cuda(exp, n, o),
                                  lambda s: scans_cuda.frame_accounting_cuda(exp[s:s + 1], n[s], o[s]),
                                  "frame_accounting_kernel")}
    for name, (batched, one, kname) in calls.items():
        loop = lambda: [one(s) for s in range(S)]
        batched(), loop()
        torch.cuda.synchronize()
        ms = kernel_profiler_ms(batched, kname, 50)
        ms_one = kernel_profiler_ms(loop, kname, 5)
        loop_ev = min(cuda_ms(loop, 5) for _ in range(2))
        nbytes = scans_cuda.scan_bytes(T, S)[name]
        bound = max(nbytes / HBM_BYTES_PER_S, 12 * S * T / FP32_OPS_PER_S) * 1e3
        cm = cummax_ms(S, T, dev, o if name == "frame_accounting" else f)
        out[name] = {"S": S, "T": T, "ms": ms, "ms_by": "profiler", "single_ms_x_S": ms_one * S,
                     "single_x_S_events_ms": loop_ev, "bound_ms": bound, "bytes": nbytes, "cummax_ms": cm}
        print(f"[sharded-timing] {name} [S={S}, T={T}]: one batched launch {ms * 1e3:.2f} us device (profiler; "
              f"{earlier_note(name, S, T)}: a thread a stream); {S} single-stream "
              f"launches {ms_one * S * 1e3:.2f} us device summed, {loop_ev * 1e3:.1f} us between events with the "
              f"host's enqueue; {nbytes} bytes, bound {bound * 1e6:.1f} ns; torch.cummax on the [{S}, {T}] int32 "
              f"indices {cm * 1e3:.2f} us, the prefix-max alone (library call: none computes the function) "
              f"({card})", flush=True)
    Sc, Fc, _ = SHARD_CODED
    W = 2
    fec = tb_fec(dev, W)
    recs = [tb_headers(Fc, W, fec, 900 + s, 0, dev) for s in range(Sc)]
    args = [torch.stack(col) for col in zip(*recs)]
    state = fec_chain.init_tb_state(fec, dev, (Sc,))
    batched = lambda: fec_chain.tb_reassemble(state, *args, fec)
    loop = lambda: [fec_chain.tb_reassemble(fec_chain.TbRing(*(a[s] for a in state)), *(a[s] for a in args), fec)
                    for s in range(Sc)]
    batched(), loop()
    torch.cuda.synchronize()
    walk, copy = (kernel_profiler_ms(batched, k, 50) for k in ("tb_ring_walk_kernel", "tb_ring_copy_kernel"))
    walk1, copy1 = (kernel_profiler_ms(loop, k, 5) for k in ("tb_ring_walk_kernel", "tb_ring_copy_kernel"))
    loop_ev = min(cuda_ms(loop, 5) for _ in range(2))
    nbytes = tb_cuda.tb_bytes(Fc, W, fec.max_frame_bits, Sc)
    bound = max(nbytes / HBM_BYTES_PER_S, 12 * Sc * Fc / FP32_OPS_PER_S) * 1e3
    cm = cummax_ms(Sc, Fc, dev)
    out["tb_reassemble"] = {"S": Sc, "F": Fc, "W": W, "ms": walk + copy, "ms_by": "profiler", "walk_ms": walk,
                            "copy_ms": copy, "single_ms_x_S": (walk1 + copy1) * Sc,
                            "single_x_S_events_ms": loop_ev, "bound_ms": bound, "bytes": nbytes,
                            "cummax_ms": cm}
    print(f"[sharded-timing] tb_reassemble [S={Sc}, F={Fc}, W={W}]: walk {walk * 1e3:.2f} + copy {copy * 1e3:.2f} us "
          f"device (profiler; {earlier_note('tb_reassemble', Sc, Fc)}), {100 * bound / (walk + copy):.1f}% "
          f"of the bound; {Sc} single rings {(walk1 + copy1) * Sc * 1e3:.2f} us device summed, {loop_ev * 1e3:.1f} us "
          f"between events; {nbytes} bytes, bound {bound * 1e3:.2f} us; torch.cummax on the [{Sc}, {Fc}] int32 "
          f"indices {cm * 1e3:.2f} us ({card})", flush=True)
    return out


def sharded_phase(dev, card) -> dict:
    """Phase 24: the sharded session of parallel/ on a one-rank NCCL group
    and a 1 x 1 grid (NCCL refuses two ranks on one card; the CPU tests run
    the multi-rank grids over gloo).  Returns the launches of the counted
    runs, their blocks, the largest errors and the batched kernels' times."""
    import torch.distributed as tdist

    from gr_dtl_tpu_torch import entry
    from gr_dtl_tpu_torch.parallel import dist as pdist, launch, mesh as meshmod
    from gr_dtl_tpu_torch.parallel.session import ShardedStreamRx

    t_phase = time.perf_counter()
    pdist.init_group(0, 1, f"127.0.0.1:{launch.free_port()}", dev)
    try:
        x = torch.arange(8, dtype=torch.float32, device=dev)
        tdist.all_reduce(x)
        g = torch.empty(8, device=dev)
        tdist.all_gather_into_tensor(g, x)
        torch.cuda.synchronize()
        check(torch.equal(g, x) and torch.equal(x, torch.arange(8.0, device=dev)), "NCCL world of one")
        mesh = meshmod.make_mesh(1, 1, device=dev)
        print(f"[sharded] process group: backend {tdist.get_backend()}, world {tdist.get_world_size()}, grid "
              f"{mesh.shape} on {dev} (an all_reduce and an all_gather ran)", flush=True)
        return _sharded_runs(dev, card, mesh, ShardedStreamRx, entry, t_phase)
    finally:
        tdist.destroy_process_group()


def _sharded_runs(dev, card, mesh, ShardedStreamRx, entry, t_phase) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    rcfg = cfgmod.make_rx_config(None, frame_length=FRAME_LENGTH)
    tcfg = cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH)
    S, F, P = SHARD_S, SHARD_F, rcfg.frame_samples
    n_blocks = SHARD_WARM + SHARD_TIMED + 1
    n_frames = (n_blocks - 1) * F - 1
    x, sent = shard_streams(tcfg, S, n_frames, n_blocks, F * P, dev, gen, SEED + 24)
    keys = ("k1", "trigger_lock_scan", "frame_accounting", "tb_reassemble")
    totals = dict.fromkeys(keys + ("blocks", "tb_blocks"), 0)

    def counted(n, k5, what):
        """After a run of n blocks that began with the counts at 0: one metric
        launch, one of each scan kernel, four of the equalizer and k5 of the
        TB ring kernels a block."""
        got = sharded_launches()
        want = (n, n, n, k5 * n)
        check(got[:4] == want, f"{what}: launches (metric, lock scan, accounting, TB ring) {got[:4]} in {n} "
              f"blocks, expected {want}")
        EQ.counted(n, what)
        for k, v in zip(keys, got):
            totals[k] += v
        totals["blocks"] += n
        totals["tb_blocks"] += n if k5 else 0
        return got

    # the main path: S streams of F frames a block, 2 warm-up blocks, 16 timed, one of idle air
    srx = ShardedStreamRx(rcfg, mesh, S, F, device=dev)
    reset_counts()
    walls, res = run_sharded(srx, x)
    got = counted(n_blocks, 0, f"sharded S={S} F={F}")
    n_dec = check_sharded_decoded(res, sent, srx, f"sharded S={S} F={F}")
    timed = walls[SHARD_WARM: SHARD_WARM + SHARD_TIMED]
    med = median(timed)
    n_samp = S * F * P
    print(f"[sharded] S={S} streams, F={F} frames a block ({S * F} frames, {n_samp} samples, "
          f"{n_samp * 8 / 1e6:.1f} MB a block), {n_blocks} chained blocks ({SHARD_WARM} warm-up, {SHARD_TIMED} "
          f"timed, one of idle air), frames from sample 300 + 37 s mod 1500: all {n_dec} sent frames decoded "
          f"once, in order, payloads equal; n_lost 0; launches a block: metric {got[0] // n_blocks}, lock scan "
          f"{got[1] // n_blocks}, accounting {got[2] // n_blocks}, equalizer {got[4] // n_blocks}", flush=True)
    # four of the streams through StreamRx on the same samples
    diff_other = 0
    out_s, masks = sharded_frames(res)
    for s in SHARD_STREAMRX:
        rx = session.StreamRx(rcfg, dev, frames_per_block=F)
        _w, _d, single = run_receiver(rx, x[s])
        out1, m1 = decoded_all(single)
        for k in ("valid", "header_ok", "crc_ok"):
            check(np.array_equal(masks[k][s], m1[k]), f"sharded vs StreamRx, stream {s}: {k} differs")
        dec = torch.as_tensor(masks["valid"][s] & masks["header_ok"][s], device=dev)
        for k in ("frame_no", "payload", "payload_len", "cnst_id", "crc_ok"):
            a, b = out_s[k][s], out1[k]
            check(torch.equal(a[dec], b[dec]), f"sharded vs StreamRx, stream {s}: {k} differs on a decoded slot")
            diff_other += int((a[~dec] != b[~dec]).reshape(int((~dec).sum()), -1).any(-1).sum()) if k == "payload" else 0
        check((rx.n_lost, rx.n_frames) == (int(srx.n_lost[s]), int(srx.n_frames[s])),
              f"sharded vs StreamRx, stream {s}: counters")
    print(f"[sharded] streams {SHARD_STREAMRX} equal StreamRx on the same samples bit for bit: masks on every slot, "
          f"frame numbers, payloads, lengths, constellations and CRC flags on every decoded slot, counters; "
          f"undecoded slots whose payload bytes differ: {diff_other}", flush=True)

    # the step's own tensors through the plain loops (a separate, uncounted run)
    chk = ShardedStreamRx(rcfg, mesh, S, F, device=dev)
    with BatchedScanCheck(f"sharded S={S} F={F}, blocks 0-2"):
        for b in range(3):
            chk.process(x[:, b * F * P:(b + 1) * F * P])
    with EqualizerCheck(f"sharded S={S} F={F}, block 0"):
        ShardedStreamRx(rcfg, mesh, S, F, device=dev).process(x[:, : F * P])

    # one profiled block after two warm-up blocks
    prof = ShardedStreamRx(rcfg, mesh, S, F, device=dev)
    for b in range(SHARD_WARM):
        prof.process(x[:, b * F * P:(b + 1) * F * P])
    w_ms, busy, n_k = profiled(lambda: prof.process(x[:, SHARD_WARM * F * P:(SHARD_WARM + 1) * F * P]))
    print(f"[sharded-timing] S={S} F={F}: wall ms a block, median of the {SHARD_TIMED} timed blocks {med:.3f} "
          f"(min {min(timed):.3f}, max {max(timed):.3f}) = {n_samp / med / 1e3:.1f} Msamples/s; profiled block: wall "
          f"{w_ms:.3f} ms, device busy {busy:.3f} ms, {n_k} device kernels and copies; idle share "
          f"{1 - busy / med:.4f} against the median, {1 - busy / w_ms:.4f} inside the profiled block ({card})",
          flush=True)
    del res, out_s, x, sent

    # coded, W = 2, 25 dB
    Sc, Fc, nbc = SHARD_CODED
    ccfg_t = cfgmod.make_tx_config(str(FEC_CONFIG), frame_length=FRAME_LENGTH)
    ccfg_r = cfgmod.make_rx_config(str(FEC_CONFIG), frame_length=FRAME_LENGTH)
    fec, fec_cpu = tb_fec(dev, 2), tb_fec("cpu", 2)
    Pc = ccfg_r.frame_samples
    nfc = (nbc - 1) * Fc
    xc, sentc = shard_streams(ccfg_t, Sc, nfc, nbc, Fc * Pc, dev, gen, SEED + 25, fec=fec)
    csrx = ShardedStreamRx(ccfg_r, mesh, Sc, Fc, fec, device=dev)
    reset_counts()
    cwalls, cres = run_sharded(csrx, xc)
    counted(nbc, 2, f"sharded coded S={Sc} F={Fc} W=2")
    fl = csrx.flush_tb()
    tbs = [dict() for _ in range(Sc)]
    for r in cres + [(None, None, None, None, fl)]:
        tb = {k: v.cpu().numpy() for k, v in r[4].items()}
        for s in range(Sc):
            for i in np.nonzero(tb["valid"][s])[0]:
                no = int(tb["tb_no"][s, i])
                check(no not in tbs[s], f"sharded coded: stream {s} TB {no} emitted twice")
                tbs[s][no] = bool(tb["crc_ok"][s, i]) and np.array_equal(
                    tb["payload"][s, i, : int(tb["payload_len"][s, i])],
                    sentc["payload"][s, 2 * no, : int(sentc["payload_len"][s, 2 * no])].cpu().numpy())
    G = nfc // 2
    for s in range(Sc):
        check(sorted(tbs[s]) == list(range(G)) and all(tbs[s].values()),
              f"sharded coded: stream {s} TBs {sorted(k for k, v in tbs[s].items() if v)[:8]}.. of {G} decoded")
    check(bool(fl["valid"].all()), "sharded coded: flush_tb did not emit every stream's last TB")
    print(f"[sharded] coded W=2 (examples/config_fec.json, 25 dB) S={Sc} F={Fc}, {nbc} blocks: all {Sc * G} TBs "
          f"decode to the sent bytes, once each, the last of every stream by flush_tb; TB ring launches "
          f"{2} a block (counted), wall ms a block {[round(w, 1) for w in cwalls]}", flush=True)
    # the same chunks as complex64 tensors on the card: _upload slices each where it lies, no host round trip
    Dc = csrx.dispatch_samples
    xc_dev = torch.as_tensor(xc, device=dev).reshape(Sc, nbc, Dc).transpose(0, 1).contiguous()  # a chunk a row
    dsrx = ShardedStreamRx(ccfg_r, mesh, Sc, Fc, fec, device=dev)
    check(dsrx._upload(xc_dev[0]).data_ptr() == xc_dev[0].data_ptr(), "sharded coded: a chunk on the card was copied")
    dwalls, dres = [], []
    for i in range(nbc):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = dsrx.process(xc_dev[i])
        dwalls.append((time.perf_counter() - t0) * 1e3)
        dres.append(r)
    for i, (a, b) in enumerate(zip(cres, dres)):
        check(np.array_equal(a[1], b[1]), f"sharded coded, chunk {i} on the card: valid differs from the numpy path")
        for k in a[4]:
            check(torch.equal(a[4][k], b[2][k]), f"sharded coded, chunk {i} on the card: TB {k} differs")
    print(f"[sharded] coded W=2 S={Sc} F={Fc} from chunks on the card ({Sc * Dc * 8 / 1e6:.1f} MB a block): masks "
          f"and TBs equal the numpy path's; wall ms a block {[round(w, 1) for w in dwalls]} against the numpy "
          f"path's {[round(w, 1) for w in cwalls]} ({card})", flush=True)
    del xc_dev, dres
    with BatchedScanCheck(f"sharded coded S={Sc} F={Fc}, blocks 0-1", fec_cpu):
        chk = ShardedStreamRx(ccfg_r, mesh, Sc, Fc, fec, device=dev)
        for b in range(2):
            chk.process(xc[:, b * Fc * Pc:(b + 1) * Fc * Pc])
    del xc, sentc, cres

    # the megastep K = 4 at S = 64, F = 16, against the K = 1 session
    Sm, Fm, K, nbm = SHARD_MEGA
    xm, sentm = shard_streams(tcfg, Sm, (nbm - 1) * Fm - 1, nbm, Fm * P, dev, gen, SEED + 26)
    mega = ShardedStreamRx(rcfg, mesh, Sm, Fm, blocks_per_dispatch=K, device=dev)
    reset_counts()
    mwalls, mres = run_sharded(mega, xm)
    counted(nbm, 0, f"sharded megastep K={K}")
    check_sharded_decoded(mres, sentm, mega, f"sharded megastep K={K}")
    _w1, one = run_sharded(ShardedStreamRx(rcfg, mesh, Sm, Fm, device=dev), xm)
    (om, mm), (o1, m1) = sharded_frames(mres), sharded_frames(one)
    for k in mm:
        check(np.array_equal(mm[k], m1[k]), f"megastep vs K=1: {k} differs")
    for k in om:
        check(torch.equal(om[k], o1[k]), f"megastep vs K=1: {k} differs")
    print(f"[sharded] megastep K={K} at S={Sm}, F={Fm}: {nbm} blocks in {nbm // K} calls equal the K=1 session "
          f"bit for bit (masks, frame numbers, payloads), every frame decoded; one launch of the metric, two of "
          f"the scans and four of the equalizer a block (counted); wall ms a call {[round(w, 1) for w in mwalls]}",
          flush=True)
    del xm, sentm, mres, one

    # a small case against the port's CPU run
    Ss, Fs, nbs = SHARD_SMALL
    xs, _ = shard_streams(tcfg, Ss, (nbs - 1) * Fs - 1, nbs, Fs * P, dev, gen, SEED + 27)
    _w, rc = run_sharded(ShardedStreamRx(rcfg, mesh, Ss, Fs, device=dev), xs)
    _w, rp = run_sharded(ShardedStreamRx(rcfg, meshmod_cpu(), Ss, Fs, device="cpu"), xs)
    (oc, mc), (op_, mp_) = sharded_frames(rc), sharded_frames(rp)
    for k in mc:
        check(np.array_equal(mc[k], mp_[k]), f"sharded small, card vs CPU: {k} differs")
    dec = torch.as_tensor(mc["valid"] & mc["header_ok"])
    for k in oc:
        check(torch.equal(oc[k].cpu()[dec], op_[k][dec]), f"sharded small, card vs CPU: {k} differs")
    snr_c = torch.cat([r[0].snr_db.reshape(Ss, -1) for r in rc], 1).cpu()[dec]
    snr_p = torch.cat([r[0].snr_db.reshape(Ss, -1) for r in rp], 1)[dec]
    d_snr = float((snr_c - snr_p).abs().max())
    check(d_snr <= 5e-2, f"sharded small, card vs CPU: snr_db off by {d_snr}")
    print(f"[sharded] small case S={Ss} F={Fs}, {nbs} blocks: card equals the port's CPU run (masks on every slot; "
          f"ints and bytes on the {int(dec.sum())} decoded slots; max|d snr_db| {d_snr:.2e})", flush=True)

    entry.dryrun_multichip(1, dev)
    print("[sharded] entry.dryrun_multichip(1) on the card: the uncoded and coded sharded loopbacks and three "
          "chained ShardedStreamRx blocks decode every frame", flush=True)

    err = batched_vs_plain(dev)
    times = time_batched(dev, card)
    print(f"[sharded] phase took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return {"totals": totals, "max_abs_err": err, "times": times, "wall_ms": med,
            "msamples_per_s": n_samp / med / 1e3, "busy_ms": busy}


# ---------------------------------------------------------------------------
# phase 25: the app layer (slice F): the tools' main(argv), in this process
# ---------------------------------------------------------------------------

APP_B, APP_B_FEC = 2048, 1024  # the loopbacks' batches (the bench shapes)
APP_F, APP_BLOCKS = 1024, 16   # the stream modes: frames a block, blocks stream-tx writes
APP_CODED = (64, 8)            # the coded W = 2 stream: frames a block, blocks
APP_SHARD = (64, 32, 4)        # stream-sharded --source: streams, frames a block, blocks
APP_ROUNDS = 32                # the links
APP_PACKETS = 64               # through tun_bridge.ModemPipe
APP_PIPE = (256, 8, 1000)      # the two-process link: frames a block, blocks, PDUs of 40 bytes
APP_KERNELS = ("k1", "lock", "acct", "tb", "eq")


def app_counts() -> dict:
    return {"k1": sync_cuda.timing_metric_cuda.LAUNCHES,
            "lock": scans_cuda.trigger_lock_scan_cuda.LAUNCHES,
            "acct": scans_cuda.frame_accounting_cuda.LAUNCHES,
            "tb": tb_cuda.tb_reassemble_cuda.LAUNCHES,
            "eq": equalizer_cuda.equalize_frame_cuda.LAUNCHES}


def sync_device(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def counted_run(dev, tool, argv: list) -> tuple:
    """A tool's ``main(argv)`` in this process, its standard output kept,
    with every launch count set to 0 just before it: (its result, the dict
    ``main`` returns or else the JSON of its last line; wall ms; counts)."""
    reset_counts()
    buf = io.StringIO()
    sync_device(dev)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = tool.main([str(a) for a in argv])
    sync_device(dev)
    ms = (time.perf_counter() - t0) * 1e3
    res = ret if isinstance(ret, dict) else json.loads(buf.getvalue().strip().splitlines()[-1])
    return res, ms, app_counts()


class AppLedger:
    """Counted runs of the app and tool phases: a tool's ``main(argv)``
    with every launch count set to 0 just before it and read just after,
    held to the launches a receive step (or block, or round) of that mode
    gives each kernel, times the steps the run took.  ``steps`` may be a
    function of the tool's result; the equalizer's launches are booked as
    receive steps of four."""

    def __init__(self, dev, card: str, tag: str):
        self.dev, self.card, self.tag = dev, card, tag
        # launches, launches due (one a step for the metric and the scans)
        self.totals = {k: [0, 0] for k in APP_KERNELS[:4]}

    def run(self, what: str, tool, argv: list, steps, per_step: dict):
        res, ms, counts = counted_run(self.dev, tool, argv)
        steps = steps(res) if callable(steps) else steps
        want = {k: per_step.get(k, 0) * steps for k in APP_KERNELS}
        print(f"[{self.tag}] {what}: {ms:.1f} ms wall ({self.card}), launches {counts} in {steps} steps; "
              f"{json.dumps(res)}", flush=True)
        check(counts == want, f"[{self.tag}] {what}: launches {counts}, expected {want}")
        if want["eq"]:
            EQ.counted(want["eq"] // EQ_PER_STEP, f"[{self.tag}] {what}")
        for k in APP_KERNELS[:4]:
            if want[k]:
                self.totals[k][0] += counts[k]
                self.totals[k][1] += want[k]
        return res, ms


def session_ms(rx, blocks, dev) -> float:
    """Wall ms a block of a StreamRx (or StreamRxPipelined) over in-memory
    numpy blocks, the readback of every block included."""
    sync_device(dev)
    t0 = time.perf_counter()
    for b in blocks:
        rx.process(b)
    if hasattr(rx, "drain"):
        rx.drain()
    sync_device(dev)
    return (time.perf_counter() - t0) * 1e3 / len(blocks)


def app_phase(dev, card) -> dict:
    """Phase 25.  Returns, for the kernels line, each scan and TB ring
    kernel's launches over the phase's counted runs and the steps they
    span."""
    t_phase = time.perf_counter()
    d = Path(tempfile.mkdtemp(prefix="app_layer_"))
    try:
        app = AppLedger(dev, card, "app")
        _app_runs(app, d, dev, card)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"[app] phase took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return app.totals


def _app_runs(app: AppLedger, d: Path, dev, card) -> None:
    from gr_dtl_tpu_torch.testbed.frame_store import read_frames
    from gr_dtl_tpu_torch.tools import ber, replay, run_modem, tun_bridge

    on = ["--device", str(dev), "--json"]
    rcfg = cfgmod.make_rx_config(None, frame_length=FRAME_LENGTH)
    tcfg = cfgmod.make_tx_config(None, frame_length=FRAME_LENGTH)
    P = rcfg.frame_samples
    per_rx = {"k1": 1, "acct": 1, "eq": EQ_PER_STEP}  # a batch receive step and its loss count
    per_block = {"k1": 1, "lock": 1, "acct": 1, "eq": EQ_PER_STEP}  # a StreamRx block

    # -- loopbacks, then ber on the uncoded one's stores --
    res, ms = app.run(f"loopback B={APP_B}", run_modem, [
        "loopback", "--config", "examples/config.json", "--frame-length", FRAME_LENGTH, "--frames",
        APP_B, "--snr-db", 25, "--store-tx", d / "lb_tx.dat", "--store-rx", d / "lb_rx.dat", *on],
        1, per_rx)
    check(res["crc_ok_rate"] == 1.0 and res["header_ok_rate"] == 1.0 and res["lost_frame_rate"] == 0.0,
          f"uncoded loopback: {res}")
    txp, rxp = transmitter.build_tx(tcfg, dev), receiver.build_rx(rcfg, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)

    def loopback_core():
        n, plen = APP_B, tcfg.frame_bytes(2) - 4
        i32 = lambda v: torch.full((n,), v, dtype=torch.int32, device=dev)
        pad = torch.randint(0, 256, (n, tcfg.max_frame_bytes()), generator=gen, device=dev, dtype=torch.uint8)
        pay = torch.where(torch.arange(pad.shape[1], device=dev) < plen, pad, 0).to(torch.uint8)
        out = transmitter.tx_frames(txp, pay, i32(plen), i32(2), i32(0),
                                    torch.arange(n, dtype=torch.int32, device=dev), pad)
        s = channel.channel_model(out.samples.reshape(-1), noise_voltage=0.05, generator=gen)
        rx = rx_step(rxp, torch.cat([torch.zeros(517, dtype=torch.complex64, device=dev), s,
                                     torch.zeros(400, dtype=torch.complex64, device=dev)]), n)
        metrics.lost_frames(rx.frame_no, rx.header_ok)
        sync_device(dev)

    core = []
    for _ in range(4):
        t0 = time.perf_counter()
        loopback_core()
        core.append((time.perf_counter() - t0) * 1e3)
    print(f"[app] loopback B={APP_B}: the tool {ms:.1f} ms wall; TX + channel + detect_and_extract + rx_frames "
          f"+ loss count alone on the same shapes {median(core[1:]):.2f} ms (median of 3 after one warm-up) "
          f"({card})", flush=True)
    res, _ = app.run(f"coded loopback B={APP_B_FEC}", run_modem, [
        "loopback", "--config", FEC_CONFIG, "--frame-length", FRAME_LENGTH, "--frames", APP_B_FEC,
        "--snr-db", 25, *on], 1, per_rx)
    check(res["crc_ok_rate"] == 1.0, f"coded loopback at 25 dB: {res}")
    res, _ = app.run("ber on the loopback's stores", ber, [d / "lb_tx.dat", d / "lb_rx.dat", "--json"], 0, {})
    check(res["frames_sent"] == APP_B and res["frames_matched"] == APP_B and res["ber_overall"] == 0.0
          and res["fer"] == 0.0, f"ber at 25 dB: {res}")

    # -- stream-tx to a capture, then stream at depth 1 and 2 --
    cap = d / "cap.c64"
    pdus = 2 * APP_F * APP_BLOCKS  # two 40-byte PDUs fill a BPSK frame of frame_length 20
    res, tx_ms = app.run(f"stream-tx F={APP_F}", run_modem, [
        "stream-tx", "--sink", f"file:{cap}", "--frame-length", FRAME_LENGTH, "--frames-per-block",
        APP_F, "--pdus", pdus, "--max-blocks", APP_BLOCKS, *on], APP_BLOCKS, {})
    n_frames = APP_F * APP_BLOCKS
    check(res["blocks"] == APP_BLOCKS and res["payload_frames"] == n_frames, f"stream-tx: {res}")
    print(f"[app] stream-tx: {tx_ms / APP_BLOCKS:.2f} ms a block of {APP_F * P} samples, "
          f"{res['msamples_per_s']:.2f} Msamples/s by the tool's clock ({card})", flush=True)
    with open(cap, "ab") as f:  # the air after the last frame: one block of silence
        np.zeros(APP_F * P, np.complex64).tofile(f)
    rng = np.random.RandomState(0)
    sent = b"".join(rng.randint(0, 256, 40).astype(np.uint8).tobytes() for _ in range(pdus))
    blocks = np.fromfile(cap, np.complex64).reshape(-1, APP_F * P)
    stores = []
    for depth in (1, 2):
        store = d / f"stream{depth}.dat"
        res, ms = app.run(f"stream F={APP_F} depth {depth}", run_modem, [
            "stream", "--source", f"file:{cap}", "--frame-length", FRAME_LENGTH, "--frames-per-block", APP_F,
            "--pipeline-depth", depth, "--store-rx", store, *on], APP_BLOCKS + 1, per_block)
        check(res["blocks"] == APP_BLOCKS + 1 and res["frames_header_ok"] == n_frames
              and res["frames_crc_ok"] == n_frames and res["lost_frame_rate"] == 0.0, f"stream depth {depth}: {res}")
        recs = list(read_frames(str(store)))
        check([no for no, _ in recs] == list(range(n_frames)), f"stream depth {depth}: frame numbers in the store")
        check(b"".join(data for _, data in recs) == sent, f"stream depth {depth}: stored bytes differ from the PDUs")
        stores.append(store.read_bytes())
        rx = (session.StreamRx(rcfg, dev, APP_F) if depth == 1 else
              session.StreamRxPipelined(rcfg, dev, APP_F, depth=depth))
        alone = session_ms(rx, blocks, dev)
        print(f"[app] stream depth {depth}: the daemon {ms / (APP_BLOCKS + 1):.2f} ms a block "
              f"({res['msamples_per_s']:.2f} Msamples/s by its clock, file read and frame store included), "
              f"the session alone on the same blocks in memory {alone:.2f} ms a block "
              f"({APP_F * P / alone / 1e3:.2f} Msamples/s) ({card})", flush=True)
    check(stores[0] == stores[1], "stream: the depth-2 frame store differs from depth 1's")
    del blocks

    # -- replay of the capture: its first frames, as the stream stored them --
    res, ms = app.run(f"replay B={APP_B}", replay, [
        cap, "--frame-length", FRAME_LENGTH, "--frames", APP_B, "--store-rx", d / "replay.dat", *on], 1, per_rx)
    check(res["crc_ok_rate"] == 1.0 and res["frames"] == APP_B, f"replay: {res}")
    rp = (d / "replay.dat").read_bytes()
    check(stores[0][: len(rp)] == rp, "replay: its store is not the stream store's first records")
    x = torch.as_tensor(np.fromfile(cap, np.complex64), device=dev)
    core = []
    for _ in range(4):
        sync_device(dev)
        t0 = time.perf_counter()
        rx_step(rxp, x, APP_B)
        sync_device(dev)
        core.append((time.perf_counter() - t0) * 1e3)
    print(f"[app] replay: the tool {ms:.1f} ms wall ({x.numel()} samples read and uploaded); detect_and_extract + "
          f"rx_frames alone on the capture on the device {median(core[1:]):.2f} ms ({card})", flush=True)
    del x

    # -- the coded W = 2 stream --
    Fc, nbc = APP_CODED
    ccap = d / "coded.c64"
    res, _ = app.run(f"coded stream-tx F={Fc}", run_modem, [
        "stream-tx", "--config", FEC_CONFIG, "--tb-frames", 2, "--sink", f"file:{ccap}", "--frame-length",
        FRAME_LENGTH, "--frames-per-block", Fc, "--pdus", 4 * Fc * nbc, "--max-blocks", nbc, *on], nbc, {})
    check(res["payload_frames"] == Fc * nbc, f"coded stream-tx: {res}")
    ccfg = cfgmod.make_rx_config(str(FEC_CONFIG), frame_length=FRAME_LENGTH)
    with open(ccap, "ab") as f:
        np.zeros(Fc * ccfg.frame_samples, np.complex64).tofile(f)
    res, _ = app.run(f"coded stream F={Fc} W=2", run_modem, [
        "stream", "--config", FEC_CONFIG, "--tb-frames", 2, "--source", f"file:{ccap}", "--frame-length",
        FRAME_LENGTH, "--frames-per-block", Fc, *on], nbc + 1, dict(per_block, tb=2))
    check(res["tb_emitted"] == Fc * nbc // 2 and res["tb_crc_ok"] == res["tb_emitted"]
          and res["lost_frame_rate"] == 0.0, f"coded stream: every transport block must pass its CRC: {res}")

    # -- stream-sharded: the self-test at the README's 64 streams, then a capture --
    S, Fs, nbs = APP_SHARD
    res, ms = app.run(f"stream-sharded --selftest S={S} F={Fs}", run_modem, [
        "stream-sharded", "--selftest", "--streams", S, "--frames-per-block", Fs, "--frame-length",
        FRAME_LENGTH, *on], 3, per_block)
    check(res["selftest_pass"] is True and res["mesh"] == {"stream": 1, "time": 1} and res["lost_frames"] == 0
          and res["frames_crc_ok"] == S * 2 * Fs, f"stream-sharded selftest: {res}")
    x, _ = shard_streams(tcfg, S, (nbs - 1) * Fs - 1, nbs, Fs * P, dev, gen, SEED + 25)
    with open(d / "shard.c64", "wb") as f:
        for b in range(nbs):
            x[:, b * Fs * P: (b + 1) * Fs * P].tofile(f)
    res, ms = app.run(f"stream-sharded --source S={S} F={Fs}", run_modem, [
        "stream-sharded", "--source", f"file:{d / 'shard.c64'}", "--streams", S, "--frames-per-block", Fs,
        "--frame-length", FRAME_LENGTH, *on], nbs, per_block)
    check(res["frames_crc_ok"] == S * ((nbs - 1) * Fs - 1) and res["lost_frames"] == 0, f"stream-sharded: {res}")
    from gr_dtl_tpu_torch.parallel import mesh as meshmod
    from gr_dtl_tpu_torch.parallel.session import ShardedStreamRx

    srx = ShardedStreamRx(rcfg, meshmod.make_mesh(1, 1, device=dev), S, Fs, device=dev)
    sync_device(dev)
    t0 = time.perf_counter()
    for b in range(nbs):
        srx.process(x[:, b * Fs * P: (b + 1) * Fs * P])
    sync_device(dev)
    alone = (time.perf_counter() - t0) * 1e3 / nbs
    print(f"[app] stream-sharded: the daemon {ms / nbs:.2f} ms a block of {S} x {Fs * P} samples (file read and "
          f"every stream's frames gathered to the host included), the session alone {alone:.2f} ms a block "
          f"({S * Fs * P / alone / 1e3:.2f} Msamples/s) ({card})", flush=True)
    del x

    # -- the links --
    # a round is two receive steps, A's and B's
    res, ms = app.run(f"full-duplex {APP_ROUNDS} rounds", run_modem, [
        "full-duplex", "--rounds", APP_ROUNDS, "--frame-length", FRAME_LENGTH, *on],
        2 * APP_ROUNDS, {"eq": EQ_PER_STEP})
    check(res["a_crc_rate"] >= 0.9 and res["b_crc_rate"] >= 0.9, f"full-duplex at 30 / 25 dB: {res}")
    print(f"[app] full-duplex: {ms / APP_ROUNDS:.2f} ms a round by the tool ({card})", flush=True)
    res, ms = app.run(f"simplex {APP_ROUNDS} rounds", run_modem, [
        "simplex", "--rounds", APP_ROUNDS, "--frame-length", FRAME_LENGTH, *on], APP_ROUNDS, {"eq": EQ_PER_STEP})
    check(res["crc_rate"] >= 0.9 and res["burst_ok_rate"] >= 0.9, f"simplex at 30 / 25 dB: {res}")
    print(f"[app] simplex: {ms / APP_ROUNDS:.2f} ms a round by the tool ({card})", flush=True)

    # -- the tun pipe, without a tun device --
    rng = np.random.RandomState(SEED + 25)
    packets = [app_ipv4(rng.bytes(int(n)), i) for i, n in enumerate(rng.randint(8, 400, APP_PACKETS))]
    pipe = tun_bridge.ModemPipe(device=dev)
    pipe.process(packets[:2])  # builds the convergence layer's library
    reset_counts()
    sync_device(dev)
    t0 = time.perf_counter()
    echoed = pipe.process(packets)
    ms = (time.perf_counter() - t0) * 1e3
    counts = app_counts()
    print(f"[app] tun_bridge.ModemPipe: {len(echoed)} of {APP_PACKETS} IPv4 packets back in {ms:.1f} ms, "
          f"launches {counts} ({card})", flush=True)
    check(echoed == packets, "ModemPipe: the packets did not come back unchanged")
    check(counts == {"k1": 0, "lock": 0, "acct": 0, "tb": 0, "eq": EQ_PER_STEP}, f"ModemPipe launches {counts}")
    EQ.counted(1, "app layer, ModemPipe")

    app_two_processes(d, dev, card)


def app_ipv4(payload: bytes, ident: int) -> bytes:
    """An IPv4/UDP-shaped packet with a valid header checksum."""
    import struct

    hdr = bytearray(struct.pack("!BBHHHBBH4s4s", 0x45, 0, 20 + len(payload), ident, 0, 64, 17, 0,
                                bytes([10, 99, 0, 1]), bytes([10, 99, 0, 2])))
    s = sum((hdr[i] << 8) | hdr[i + 1] for i in range(0, 20, 2))
    s = (s & 0xFFFF) + (s >> 16)
    s = (s & 0xFFFF) + (s >> 16)
    struct.pack_into("!H", hdr, 10, (~s) & 0xFFFF)
    return bytes(hdr) + payload


def app_two_processes(d: Path, dev, card) -> None:
    """``stream --source listen:`` and ``stream-tx --sink tcp:`` as two
    ``python -m`` processes on the device, from a copy of the package with
    no ``_build/``: the RX builds its kernels at its first block, after it
    accepted the TX.  Every payload frame the TX reports reaches the RX's
    frame store with the bytes sent."""
    import os
    import subprocess

    from gr_dtl_tpu_torch.parallel import launch
    from gr_dtl_tpu_torch.testbed.frame_store import read_frames

    F, nb, pdus = APP_PIPE
    root = d / "cold"
    shutil.copytree(ROOT / "gr_dtl_tpu_torch", root / "gr_dtl_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    port = launch.free_port()
    cmd = [sys.executable, "-m", "gr_dtl_tpu_torch.tools.run_modem"]
    common = ["--frame-length", str(FRAME_LENGTH), "--frames-per-block", str(F), "--device", str(dev), "--json"]
    env = dict(os.environ, PYTHONPATH=str(root))
    t0 = time.perf_counter()
    procs = {"rx": subprocess.Popen(cmd + ["stream", "--source", f"listen:{port}", "--store-rx",
                                           str(d / "pair.dat")] + common,
                                    cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
             "tx": subprocess.Popen(cmd + ["stream-tx", "--sink", f"tcp:127.0.0.1:{port}", "--pdus", str(pdus),
                                           "--max-blocks", str(nb)] + common,
                                    cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    out = {}
    try:
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            check(p.returncode == 0, f"two processes: the {k} process exited {p.returncode}: {stderr[-3000:]}")
            out[k] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    built = sorted(p.name for p in (root / "gr_dtl_tpu_torch" / "_build").glob("*.so"))
    print(f"[app] two processes over TCP from a cold start in {wall:.1f} s: rx {json.dumps(out['rx'])}; "
          f"tx {json.dumps(out['tx'])}; the RX built {built} ({card})", flush=True)
    rng = np.random.RandomState(0)
    sent = b"".join(rng.randint(0, 256, 40).astype(np.uint8).tobytes() for _ in range(pdus))
    got = [data for _, data in read_frames(str(d / "pair.dat")) if data]
    check(out["tx"]["blocks"] == out["rx"]["blocks"] == nb and out["tx"]["payload_frames"] == len(got)
          and b"".join(got) == sent and out["rx"]["lost_frame_rate"] == 0.0,
          "two processes: the RX did not decode every frame the TX reported")
    check(torch.device(dev).type != "cuda" or len(built) == 3,
          f"two processes: the cold RX built {built}, not the metric, scan and equalizer libraries")


# ---------------------------------------------------------------------------
# phase 26: slice G, the live-I/O tools (sample_link, soak_link, multihost)
# and K7, the masked MCS feedback scan as one CUDA launch
# ---------------------------------------------------------------------------

K7_T = (1, 8, 16, 37, 256, 1024)  # frames a call: the links' blocks, a part chunk and a long run
K7_TILES_T = 2100                 # three of the map's tiles, the last one part
K7_BATCH = 64                    # columns of the batched cases
K7_LADDERS = {"default": None,   # the default ladder, and one whose threshold + hysteresis round
              "fractional": [[0.0, ["bpsk", "no_fec"]], [7.3, ["qpsk", "no_fec"]],
                             [15.7, ["psk8", "no_fec"]], [31.3, ["qam16", "no_fec"]],
                             [31.9, ["qam16", "no_fec"]]]}
K7_OPS_PER_FRAME = 15            # integer compares and selects a frame of a column
LINK_SMALL = ["--pdus", "24", "--frames-per-block", "8", "--frame-length", "10", "--snr-db", "30"]
DUPLEX_SMALL = ["--pdus", "24", "--pdu-bytes", "30", "--frames-per-block", "4", "--frame-length", "10",
                "--snr-db", "25", "--seed", "3"]
LINK_F, LINK_PDUS = 1024, 8 * 1024 * 11   # full width: 40-byte PDUs for ~8 blocks of 16QAM frames
SOAK_SAMPLES = 1e8                # the soak's budget: the tool's pass bar (soak_link.MIN_SAMPLES)
SOAK_ARGS = ["--frames-per-block", "1024", "--frame-length", "20", "--pipeline-depth", "2",
             "--stats-every", "4"]
MULTIHOST = {"streams": 64, "frames_per_block": 16, "n_time": 1, "steps": 20, "frame_length": 4,
             "warmup": 1}  # BASELINE config 5's scale (MULTIHOST_r05.json) on one card: a 1 x 1 grid


class FeedbackLedger:
    """K7's launches over the counted runs of the paths (one a call of
    ``adaptive.feedback_scan_masked``, checked at every call) and the
    largest difference of its comparisons with the plain loop, the
    synthetic cases' (``err`` alone) included."""

    def __init__(self):
        self.launches = self.calls = self.frames = self.max_err = 0
        self.by_kernel = dict.fromkeys(feedback_cuda.DESIGNS, 0)
        self.paths = []

    def add(self, what: str, calls: int, launches: int, frames: int, err: int, by_kernel: dict) -> None:
        check(launches == calls == sum(by_kernel.values()),
              f"{what}: {launches} K7 launches ({by_kernel}) in {calls} calls, expected one a call")
        for k, v in by_kernel.items():
            self.by_kernel[k] += v
        self.launches += launches
        self.calls += calls
        self.frames += frames
        self.paths.append(f"{what}: {calls}")
        self.compared(err)

    def compared(self, err: int) -> None:
        self.max_err = max(self.max_err, err)


K7 = FeedbackLedger()


def k7_plain(state, snrs, mask, tables) -> tuple:
    """The plain loop on the inputs, copied to the CPU (on the card it costs
    ~35 launches a frame; its decisions are the same integers there)."""
    cpu = lambda t: None if t is None else t.cpu()
    return adaptive._feedback_scan_masked_torch(adaptive.FeedbackState(*map(cpu, state)), cpu(snrs), cpu(mask),
                                                dict(tables, snr_th=cpu(tables["snr_th"])))


def k7_err(got_state, got, want_state, want) -> int:
    """The largest id or state difference (0 when equal)."""
    return int_err([(got.cpu(), want)] + [(a.cpu(), b) for a, b in zip(got_state, want_state)])


def k7_against_plain(state, snrs, mask, tables, got_state, got) -> int:
    """K7's result against the plain loop on the same inputs."""
    return k7_err(got_state, got, *k7_plain(state, snrs, mask, tables))


class FeedbackCheck:
    """While active, every ``adaptive.feedback_scan_masked`` call of a path
    must launch K7 exactly once; its inputs and outputs are kept (the paths
    never change a tensor in place) and, at exit, held to the plain loop on
    the same inputs: ids and final state equal.  Deferring the plain loop
    keeps the path's own timing.  ``required``: the path must make a call."""

    def __init__(self, what: str, required: bool = True):
        self.what, self.required = what, required
        self.kept, self.launches, self.err = [], 0, 0
        self.by_kernel = dict.fromkeys(feedback_cuda.DESIGNS, 0)

    def __enter__(self):
        self._orig = adaptive.feedback_scan_masked

        def both(state, snrs_db, mask, tables):
            n0 = feedback_cuda.feedback_scan_masked_cuda.LAUNCHES
            k0 = dict(feedback_cuda.feedback_scan_masked_cuda.KERNEL_LAUNCHES)
            got_state, got = self._orig(state, snrs_db, mask, tables)
            n = feedback_cuda.feedback_scan_masked_cuda.LAUNCHES - n0
            check(n == 1, f"{self.what}: a feedback_scan_masked call made {n} K7 launches")
            for k, v in feedback_cuda.feedback_scan_masked_cuda.KERNEL_LAUNCHES.items():
                self.by_kernel[k] += v - k0[k]
            self.launches += n
            self.kept.append((state, snrs_db, mask, tables, got_state, got))
            return got_state, got

        adaptive.feedback_scan_masked = both
        return self

    def __exit__(self, *exc):
        adaptive.feedback_scan_masked = self._orig
        if exc[0] is None:
            check(not self.required or self.kept, f"{self.what}: the path made no feedback_scan_masked call")
            self.err = err = max([k7_against_plain(*k) for k in self.kept], default=0)
            check(err == 0, f"{self.what}: K7 against the plain loop, largest difference {err}")
            self.frames = sum(k[1].shape[0] for k in self.kept)
            print(f"[k7] on the path's own tensors, {self.what}: {len(self.kept)} calls, {self.launches} K7 "
                  f"launches ({self.by_kernel}), {self.frames} frames: ids and state equal to the plain loop",
                  flush=True)

    @property
    def calls(self) -> int:
        return len(self.kept)


def checked_node(argv: list, ledger_dir: str) -> int:
    """A ``sample_link`` node under :class:`FeedbackCheck`: phase 26's link
    test modes start their nodes through this (:func:`k7_node_cmd`), so that
    K7 is held to the plain loop on each node's own tensors.  The node's
    ledger goes to ``<ledger_dir>/node_<pid>.json``."""
    from gr_dtl_tpu_torch.tools import sample_link

    role = next(a for a in argv if a in ("--tx", "--rx", "--duplex-a", "--duplex-b"))
    with FeedbackCheck(f"sample_link node {role}", required=role != "--tx") as fc:
        sample_link.main(argv)
    Path(ledger_dir, f"node_{os.getpid()}.json").write_text(json.dumps(
        {"role": role, "calls": fc.calls, "launches": fc.launches, "frames": fc.frames, "err": fc.err,
         "by_kernel": fc.by_kernel}))
    return 0


def k7_node_cmd(ledger_dir: Path) -> tuple:
    """The command a checked link node starts with (it is given the node's flags)."""
    return (sys.executable, "-c", "import sys, chip_smoke; "
            f"sys.exit(chip_smoke.checked_node(sys.argv[1:], {str(ledger_dir)!r}))")


def k7_tables(ladder: str, dev) -> dict:
    kw = {} if K7_LADDERS[ladder] is None else {"mcs": K7_LADDERS[ladder]}
    return adaptive.tables_to(adaptive.build_mcs_tables(cfgmod.make_rx_config(None, **kw)), dev)


def k7_inputs(T: int, batch: tuple, tables: dict, seed: int, mask_kind: str, dev, carry: str = "random",
              snr_kind: str = "runs") -> tuple:
    """A carried-in state and T frames of each column.  SNRs ("runs"): runs
    of 1-9 equal SNRs (long enough to cross decision_th), each a threshold
    or threshold + hysteresis (their float32 sum) or one ulp either side,
    NaN, +-inf, or a point of the ladder's range; ("bistable") 13.5 dB +-
    0.4, inside the band where ids 0 and 1 of the default ladder both stay.
    A random, all-False, per-frame ([T]) or null mask.  The carry: "random"
    ids, candidates and counters under 5; "odd", outside the map's
    canonical states (a down or up candidate with its counter out of [0, 5),
    INT32_MAX among them, or another candidate with a counter not 0);
    "bistable", ids 0 and 1 in turn."""
    rng = np.random.RandomState(seed)
    th = tables["snr_th"].cpu().numpy()[1:]
    up = th + np.float32(tables["hysteresis"])
    edges = [f(v) for v in np.concatenate([th, up])
             for f in (lambda v: np.nextafter(v, np.float32(-np.inf)), lambda v: v,
                       lambda v: np.nextafter(v, np.float32(np.inf)))]
    edges = np.array(edges + [np.nan, np.inf, -np.inf], np.float32)
    B = int(np.prod(batch, dtype=int))
    cols = []
    for _ in range(B):
        col = []
        while len(col) < T:
            v = edges[rng.randint(len(edges))] if rng.rand() < 0.6 else np.float32(rng.uniform(-5, 35))
            col += [v] * rng.randint(1, 10)
        cols.append(col[:T])
    snr = np.ascontiguousarray(np.array(cols, np.float32).T).reshape((T,) + batch)
    if snr_kind == "bistable":
        snr = (13.5 + rng.uniform(-0.4, 0.4, (T,) + batch)).astype(np.float32)
    mask = {"null": None, "all_false": np.zeros((T,) + batch, bool), "per_frame": rng.rand(T) > 0.3,
            "random": rng.rand(T, *batch) > 0.3}[mask_kind]
    n = tables["n_mcs"]
    state = [rng.randint(0, hi, batch).astype(np.int32) for hi in (n, n, 5)]
    if carry == "bistable":
        last = (np.arange(B) % 2).reshape(batch).astype(np.int32)
        state = [last, last.copy(), np.zeros(batch, np.int32)]
    elif carry == "odd":
        cols = []
        for j in range(B):
            last = int(rng.randint(n))
            if j % 2 == 0:
                cols.append((last, int(rng.choice([max(last - 1, 0), last + 1])),
                             int(rng.choice([5, 12, (1 << 31) - 1, -3]))))
            else:
                cols.append((last, int(rng.choice([n + 3, -2] + ([last] if last else []))),
                             int(rng.choice([3, (1 << 31) - 1]))))
        state = [np.array(c, np.int64).astype(np.int32).reshape(batch) for c in zip(*cols)]
    state = adaptive.FeedbackState(*(torch.as_tensor(a, device=dev) for a in state))
    return (state, torch.as_tensor(snr, device=dev),
            None if mask is None else torch.as_tensor(mask, device=dev))


def k7_cases() -> list:
    """phase 26's synthetic cases: (ladder, T, batch, mask, carry, SNRs)."""
    cases = [(ladder, T, batch, kind, "random", "runs") for ladder in K7_LADDERS for T in K7_T + (K7_TILES_T,)
             for batch in ((), (K7_BATCH,)) for kind in ("random", "all_false", "null")
             + (("per_frame",) if batch else ())]
    cases += [("default", T, batch, kind, "odd", "runs") for T in (37, 1024, K7_TILES_T)
              for batch in ((), (K7_BATCH,)) for kind in ("random", "all_false")]
    cases += [("default", T, batch, "null", "bistable", "bistable") for T in (256, 1024)
              for batch in ((2,), (K7_BATCH,))]
    return cases


def k7_vs_plain(dev) -> None:
    """Both K7 kernels against the plain loop on synthetic inputs: T = 1 ..
    1024 and three tiles, batch () and [64], both ladders, random /
    all-False / per-frame / null masks, carries outside the map's canonical
    states, the bistable band; the wrapper's kernel through
    ``adaptive.feedback_scan_masked`` (one launch a call) and the other one
    forced; ids and state equal."""
    n_cases = 0
    tables = {ladder: k7_tables(ladder, dev) for ladder in K7_LADDERS}
    for ladder, T, batch, kind, carry, snr_kind in k7_cases():
        tab = tables[ladder]
        seed = T + 7 * len(batch) + 13 * len(kind) + (100 if ladder == "fractional" else 0) + 3 * len(carry)
        state, snr, mask = k7_inputs(T, batch, tab, seed, kind, dev, carry, snr_kind)
        n0 = feedback_cuda.feedback_scan_masked_cuda.LAUNCHES
        got_state, got = adaptive.feedback_scan_masked(state, snr, mask, tab)
        torch.cuda.synchronize()
        check(feedback_cuda.feedback_scan_masked_cuda.LAUNCHES == n0 + 1, f"K7 T={T} batch={batch}: not one launch")
        chosen = feedback_cuda.design(T, max(1, state.last.numel()), tab["n_mcs"], tab["decision_th"])
        other = "walk" if chosen == "map" else "map"
        o_state, o = feedback_cuda.feedback_scan_masked_cuda(
            state.last, state.cand, state.counter, snr, mask, tab["snr_th"], tab["n_mcs"], tab["hysteresis"],
            tab["decision_th"], kernel=other)
        want = k7_plain(state, snr, mask, tab)
        for what, gs, g in ((chosen, got_state, got), (other, o_state, o)):
            e = k7_err(gs, g, *want)
            K7.compared(e)
            check(e == 0, f"K7's {what} against the plain loop, {ladder} T={T} batch={batch} mask {kind} carry "
                  f"{carry} SNRs {snr_kind}: largest difference {e}")
        n_cases += 1
    print(f"[k7] both kernels vs the plain loop on {n_cases} synthetic cases (T = {K7_T + (K7_TILES_T,)}, batch "
          f"() and [{K7_BATCH}], both ladders, random / all-False / per-frame / null masks, SNRs on the "
          f"thresholds and threshold + hysteresis and one ulp either side, NaN, +-inf, inside a hysteresis "
          f"band; carries outside the map's canonical states): ids and state equal, one launch a call",
          flush=True)


def time_k7(dev, card) -> dict:
    """K7's device time (profiler) at T = 1 .. 1024, batch () and [64], by
    the wrapper's kernel, beside its bytes bound, the plain loop's time
    (events) and its device kernels and copies a call at F = 8 and 1024
    (profiler); at F = 1024 the walk and the map in turns (walk, map, map,
    walk); the floors of both chains."""
    tables = k7_tables("default", dev)
    times = {}
    for batch in ((), (K7_BATCH,)):
        for T in K7_T:
            state, snr, mask = k7_inputs(T, batch, tables, 5, "random", dev)
            fn = lambda: feedback_cuda.feedback_scan_masked_cuda(
                state.last, state.cand, state.counter, snr, mask, tables["snr_th"], tables["n_mcs"],
                tables["hysteresis"], tables["decision_th"])
            fn()
            ms = kernel_profiler_ms(fn, "feedback_scan", 50)
            B = int(np.prod(batch, dtype=int))
            nbytes = feedback_cuda.feedback_bytes(T, B, tables["n_mcs"])
            bound = max(nbytes / HBM_BYTES_PER_S, K7_OPS_PER_FRAME * T * B / FP32_OPS_PER_S) * 1e3
            plain = lambda: adaptive._feedback_scan_masked_torch(state, snr, mask, tables)
            plain()
            plain_ms = cuda_ms(plain, 1 if T * max(B, 1) >= 1024 else 5)
            kernel = feedback_cuda.design(T, B, tables["n_mcs"], tables["decision_th"])
            times[(T, B)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bytes": nbytes, "kernel": kernel}
            print(f"[k7-timing] T={T} batch={list(batch)}: the {kernel} {ms * 1e3:.2f} us (profiler), plain loop "
                  f"{plain_ms:.3f} ms (events), bound {bound * 1e6:.2f} ns for {nbytes} bytes (bytes) ({card})",
                  flush=True)
    state, snr, mask = k7_inputs(LINK_F, (), tables, 5, "random", dev)
    turns = {"walk": [], "map": []}
    for kernel in ("walk", "map", "map", "walk"):
        fn = lambda: feedback_cuda.feedback_scan_masked_cuda(
            state.last, state.cand, state.counter, snr, mask, tables["snr_th"], tables["n_mcs"],
            tables["hysteresis"], tables["decision_th"], kernel=kernel)
        fn()
        turns[kernel].append(kernel_profiler_ms(fn, k7_bench.KERNELS[kernel], 50))
    times["turns"] = turns
    floor = times["floor"] = k7_bench.step_floor(dev)
    print(f"[k7-timing] F={LINK_F}, batch (): the walk " + " / ".join(
        f"{v * 1e3:.2f}" for v in turns["walk"]) + " us, the map " + " / ".join(f"{v * 1e3:.2f}" for v in turns["map"])
          + f" us (profiler, in turns walk, map, map, walk); floors: the walk {k7_bench.walk_floor_ms(LINK_F, floor) * 1e3:.2f}"
          f" us (a launch {floor['launch_us']:.2f} us and {LINK_F} steps of {floor['chain_ns']:.2f} ns: the rung's "
          f"shared-memory load {floor['chase_ns']:.2f} ns, selects {floor['selects_ns']:.2f} ns), the map "
          f"{k7_bench.map_floor_ms(LINK_F, floor) * 1e3:.2f} us (table steps of {floor['table_ns']:.2f} ns); SM clock "
          f"{floor['sm_ghz']:.3f} GHz ({card})", flush=True)
    for T in (8, 1024):  # the plain loop's launches on one block, beside K7's one
        state, snr, mask = k7_inputs(T, (), tables, 6, "random", dev)
        _w, busy, n = profiled(lambda: adaptive._feedback_scan_masked_torch(state, snr, mask, tables),
                               sacrifice=T <= 8)
        times[("plain_launches", T)] = n
        print(f"[k7] the plain loop on one F = {T} block: {n} device kernels and copies ({n / T:.1f} a "
              f"frame), device busy {busy:.3f} ms; K7: 1 launch", flush=True)
    return times


def link_run(kind: str, flags: list, dev, d: Path) -> tuple:
    """A ``sample_link`` test mode, its nodes started through
    :func:`k7_node_cmd` with their ledgers in ``d``: (report, wall s, the
    nodes' K7 ledgers)."""
    from gr_dtl_tpu_torch.tools import sample_link

    d.mkdir()
    args = sample_link.build_parser().parse_args([*flags, "--device", str(dev)])
    fn = sample_link.loopback_test if kind == "loopback" else sample_link.duplex_test
    t0 = time.perf_counter()
    res = fn(args, node_cmd=k7_node_cmd(d))
    wall = time.perf_counter() - t0
    return res, wall, [json.loads(f.read_text()) for f in sorted(d.glob("node_*.json"))]


def link_phase(dev, card) -> None:
    """sample_link --loopback-test and --duplex-test on the card, at the
    JAX package's slow tests' settings (the two at once: their nodes' start
    is most of their time) and then at full width (F = 1024, frame_length
    20, one at a time); K7 checked in every node."""
    from concurrent.futures import ThreadPoolExecutor

    d = Path(tempfile.mkdtemp(prefix="k7_nodes_"))
    full = ["--frames-per-block", str(LINK_F), "--frame-length", str(FRAME_LENGTH), "--pdus", str(LINK_PDUS)]
    runs = [("loopback", ["--loopback-test", *LINK_SMALL]), ("duplex", ["--duplex-test", *DUPLEX_SMALL]),
            ("loopback", ["--loopback-test", *full, "--snr-db", "30"]),
            # 30 dB: at 25 dB both packages lose 1-2% of 16QAM frames of frame_length
            # 20 (the slow test's 25 dB is at frame_length 10)
            ("duplex", ["--duplex-test", *full, "--snr-db", "30"])]
    try:
        # the test modes print their reports: one redirect around the threads (a redirect is
        # process-wide, so two threads' own would restore each other's buffer)
        with contextlib.redirect_stdout(io.StringIO()):
            with ThreadPoolExecutor(2) as pool:
                small = [pool.submit(link_run, kind, flags, dev, d / str(i))
                         for i, (kind, flags) in enumerate(runs[:2])]
                done = [f.result() for f in small]
            done += [link_run(kind, flags, dev, d / str(i + 2)) for i, (kind, flags) in enumerate(runs[2:])]
        for (kind, flags), (res, wall, nodes) in zip(runs, done):
            F = int(flags[flags.index("--frames-per-block") + 1])
            if kind == "loopback":
                tx, rx = res["tx"], res["rx"]
                check(res["crc_clean"] and res["adaptation_converged"] and tx["final_cnst"] == QAM16
                      and rx["samples_received"] == tx["samples_sent"],
                      f"sample_link loopback F={F}: {json.dumps(res)}")
                check(F < LINK_F or tx["blocks"] >= 8, f"sample_link loopback F={F}: {tx['blocks']} blocks")
                per_node = {"tx": tx, "rx": rx}
            else:
                check(res["crc_clean_ab"] and res["crc_clean_ba"] and res["adaptation_converged_ab"]
                      and res["adaptation_converged_ba"]
                      and all(res[n]["final_tx_cnst"] >= 3 and res[n]["want_hist"] == sorted(res[n]["want_hist"])
                              for n in "ab"), f"sample_link duplex F={F}: {json.dumps(res)}")
                per_node = {"a": res["a"], "b": res["b"]}
            check(all(torch.device(n["device"]).type == dev.type for n in per_node.values()),
                  f"sample_link {kind} F={F}: a node did not run on {dev}")
            calls = sum(n["calls"] for n in nodes)
            K7.add(f"sample_link {kind} F={F}", calls, sum(n["launches"] for n in nodes),
                   sum(n["frames"] for n in nodes), max(n["err"] for n in nodes),
                   {k: sum(n["by_kernel"][k] for n in nodes) for k in feedback_cuda.DESIGNS})
            check(len(nodes) == 2 and calls > 0, f"sample_link {kind} F={F}: node ledgers {nodes}")
            print(f"[link] sample_link --{kind}-test F={F}: " + "; ".join(
                f"{k} {v['blocks']} blocks, {v['wall_ms_per_block']} ms a block wall, {v['work_ms_per_block']} "
                f"of its own work" for k, v in per_node.items())
                + f"; {wall:.1f} s in all; K7 {calls} calls ({[n['calls'] for n in nodes]} by node), one launch "
                f"each, equal to the plain loop; {json.dumps({k: v for k, v in res.items() if k not in per_node})} "
                f"({card})", flush=True)
            if kind == "loopback":
                print(f"[link]   tx {json.dumps(res['tx'])}; rx {json.dumps(res['rx'])}", flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def soak_phase(dev, card) -> dict:
    """soak_link on the card: 1e8 samples through the impairment relay at
    F = 1024, its own criteria; files under chiprun_out/."""
    from gr_dtl_tpu_torch.tools import soak_link

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    jsonl, out = out_dir / "soak_slice_g.jsonl", out_dir / "soak_slice_g.json"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            soak_link.main(["--device", str(dev), "--samples", str(SOAK_SAMPLES), *SOAK_ARGS,
                            "--jsonl", str(jsonl), "--out", str(out)])
            code = 0
        except SystemExit as e:
            code = e.code
    wall = time.perf_counter() - t0
    check(code == 0 and out.exists(), f"soak_link exited {code}")
    summary = json.loads(out.read_text())
    check(summary["pass"] and summary["records"] >= 8 and summary["samples"] >= soak_link.MIN_SAMPLES,
          f"soak_link: {json.dumps(summary)}")
    print(f"[soak] soak_link {SOAK_SAMPLES:g} samples, {' '.join(SOAK_ARGS)}, the tool's impairments (18 dB, "
          f"CFO 0.35 subcarriers over 2e7 samples, +20 ppm): {wall:.1f} s in all ({card}); {json.dumps(summary)}",
          flush=True)
    return summary


def multihost_phase(dev, card) -> None:
    """multihost --launch and --session, one rank on the one card (a 1 x 1
    grid), at BASELINE config 5's scale through the GR_DTL_MH_* knobs."""
    from gr_dtl_tpu_torch.tools import multihost

    saved = {k: os.environ.get(f"GR_DTL_MH_{k.upper()}") for k in MULTIHOST}
    os.environ.update({f"GR_DTL_MH_{k.upper()}": str(v) for k, v in MULTIHOST.items()})
    try:
        runs = {}
        for mode in ("--launch", "--session"):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                multihost.main([mode, "--procs", "1", "--devices-per-proc", "1", "--device", str(dev)])
            runs[mode] = (json.loads(buf.getvalue()), time.perf_counter() - t0)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(f"GR_DTL_MH_{k.upper()}", None)
            else:
                os.environ[f"GR_DTL_MH_{k.upper()}"] = v
    (res, wall), (ses, wall_s) = runs["--launch"], runs["--session"]
    w = res["workers"][0]
    S, F = MULTIHOST["streams"], MULTIHOST["frames_per_block"]
    check(res["crc_ok_all"] and w["frames_per_step"] == S * F and torch.device(w["device"]).type == dev.type,
          f"multihost --launch: {json.dumps(res)}")
    sw = ses["workers"][0]
    check(ses["byte_exact_all"] and sw["chained_blocks"] == 3 and sw["lost_frames"] == 0
          and sw["frames_decoded"] == S * 2 * F, f"multihost --session: {json.dumps(ses)}")
    base, half = res["single_process_baseline"], res["half_workload_baseline"]
    print(f"[multihost] --launch --procs 1 on {w['device']} (a 1 x 1 grid, S={S}, F={F}, "
          f"frame_length {MULTIHOST['frame_length']}, {MULTIHOST['steps']} steps): every frame passed CRC; "
          f"{w['sec_per_step'] * 1e3:.3f} ms a step ({w['frames_per_step']} frames, {w['samples_per_step']} "
          f"samples), CPU {w['cpu_sec_per_step'] * 1e3:.3f} ms a step, utilization {w['cpu_utilization']:.3f}; "
          f"strong base {base['sec_per_step'] * 1e3:.3f} ms (utilization {base['cpu_utilization']:.3f}), "
          f"half-workload base {half['sec_per_step'] * 1e3:.3f} ms; efficiencies "
          f"{res['efficiency_vs_single_process']} / {res['efficiency_weak_scaling']}; {wall:.1f} s in all "
          f"({card})", flush=True)
    print(f"[multihost] --session --procs 1: {sw['frames_decoded']} frames of {S} streams over 3 chained "
          f"blocks, byte exact, lost {sw['lost_frames']}; {wall_s:.1f} s in all ({card})", flush=True)


def live_io_phase(dev, card) -> dict:
    """Phase 26.  Returns K7's entry of the kernels line."""
    t_phase = time.perf_counter()
    k7_vs_plain(dev)
    times = time_k7(dev, card)
    link_phase(dev, card)
    soak_phase(dev, card)
    multihost_phase(dev, card)
    check(K7.launches > 0, "no path launched K7")
    print(f"[k7] counted on the paths: {K7.launches} launches ({K7.by_kernel}) in {K7.calls} calls, {K7.frames} frames "
          f"({'; '.join(K7.paths)})", flush=True)
    print(f"[live-io] phase took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    main_t, floor = times[(LINK_F, 1)], times["floor"]
    check(all(K7.by_kernel.values()), f"the paths did not launch both K7 kernels: {K7.by_kernel}")
    return {"name": "feedback_scan_masked", "route": "cuda", "source": "gr_dtl_tpu_torch/csrc/feedback_scan.cu",
            "replaces": "gr_dtl_tpu/models/adaptive.py:102 (lax.scan of feedback_step), "
                        "gr_dtl_tpu/models/session.py:673 (the masked scan)",
            "launches": K7.launches, "launches_per_step": K7.launches / max(1, K7.calls),
            "launches_by_kernel": K7.by_kernel, "max_abs_err": K7.max_err,
            "ms": main_t["ms"], "ms_by": "profiler", "plain_ms": main_t["plain_ms"],
            "bound_ms": main_t["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "design": main_t["kernel"], "at": {"T": LINK_F, "batch": []},
            "binds": "the dependence: the map, a launch and ~2 x 32 + T / 32 dependent table steps a tile "
                     f"beside its staging and barriers; the walk (T < {feedback_cuda.MAP_MIN_T}), a launch and T "
                     "dependent steps",
            "map_floor_ms": k7_bench.map_floor_ms(LINK_F, floor), "walk_floor_ms": k7_bench.walk_floor_ms(LINK_F, floor),
            "launch_floor_ms": floor["launch_us"] / 1e3, "walk_step_floor_ns": floor["chain_ns"],
            "table_step_ns": floor["table_ns"], "turns_ms": times["turns"],
            "times_us": {f"T={T},B={B}": round(v["ms"] * 1e3, 3) for (T, B), v in
                         ((k, v) for k, v in times.items() if isinstance(k[0], int))},
            "plain_launches": {str(T): times[("plain_launches", T)] for T in (8, 1024)}}


# ---------------------------------------------------------------------------
# phase 27: slice H, the measuring tools and the LDPC leftovers
# ---------------------------------------------------------------------------

H_CW = 2048  # codewords of the n=300 code in the LDPC leftovers' checks
H_REGIMES = {"clean": (4.0, 0.5), "knee": (1.6, 1.0), "waterfall": (1.3, 1.0)}  # LLR amplitude, sigma
H_ITERS_PARTED = 0.01  # share of rows whose iteration counts may part, card against CPU, off the clean regime
H_BANK_SIZES = "1,2,4,8,16,32"
H_B, H_B_FEC, H_BANK_CW = 2048, 1024, 1024  # the tools' batches: uncoded, coded, bank codewords
H_STREAM = ("16,64,256,1024", 1024, "16x16", 12)  # bench_stream: sizes, --device-stream size, --mega, --blocks


def h_llrs(dev) -> tuple:
    """The n=300 code's build dict, the code on the CPU and on ``dev``, and
    the LLRs of the leftovers' 2048 codewords in each of ``H_REGIMES``
    (seeded numpy: random messages, then each regime's noise in turn)."""
    d = ldpc.build_ldpc(alist.load_alist(str(ROOT / "examples" / "n_0300_k_0152.alist")))
    codes = {"cpu": ldpc.ldpc_from_reference(d, "cpu"), "card": ldpc.ldpc_from_reference(d, dev)}
    rng = np.random.RandomState(SEED + 27)
    cw = ldpc.encode(torch.as_tensor(rng.randint(0, 2, (H_CW, d["K"])).astype(np.float32)),
                     codes["cpu"]).numpy().astype(np.float32)
    return d, codes, {regime: ((1.0 - 2.0 * cw) * amp + rng.randn(*cw.shape) * sigma).astype(np.float32)
                      for regime, (amp, sigma) in H_REGIMES.items()}


def ldpc_leftovers(dev) -> None:
    """``decode``, ``decode_mm_twopass`` (default bucket and 64) and
    ``decode_mm`` with bf16 on CUDA tensors against the same functions on
    the CPU, at 2048 codewords of the n=300 code in three regimes of seeded
    numpy LLRs.  Clean: every output equal.  Knee and waterfall: ``ok``
    equal on every row, ``hard`` on every row both sides mark ok, and the
    iteration counts parted on at most 1% of the rows (tanh, log, exp and
    atanh on the card differ from the CPU's by ulps).  Then twopass against
    decode_mm on the card: the same ``ok`` and message bits wherever ok."""
    d, codes, llrs = h_llrs(dev)
    variants = {"decode": lambda x, c: ldpc.decode(x, c),
                "decode_mm_twopass": lambda x, c: ldpc.decode_mm_twopass(x, c),
                "decode_mm_twopass bucket=64": lambda x, c: ldpc.decode_mm_twopass(x, c, bucket=64),
                "decode_mm bf16": lambda x, c: ldpc.decode_mm(x, c, 15, bf16=True)}
    for regime, (amp, sigma) in H_REGIMES.items():
        x = {"cpu": torch.as_tensor(llrs[regime]), "card": torch.as_tensor(llrs[regime], device=dev)}
        for name, fn in variants.items():
            t0 = time.perf_counter()
            hard, iters, ok = (t.cpu().numpy() for t in fn(x["card"], codes["card"]))
            ms = (time.perf_counter() - t0) * 1e3
            hard0, iters0, ok0 = (t.numpy() for t in fn(x["cpu"], codes["cpu"]))
            both = ok & ok0
            n_hard = int((hard != hard0).any(1).sum())
            n_iters = int((iters != iters0).sum())
            print(f"[slice-h] {name}, {regime} ({amp}, {sigma}), {H_CW} codewords: card vs CPU: ok rate "
                  f"{ok.mean():.4f} (CPU {ok0.mean():.4f}), ok parted on {int((ok != ok0).sum())} rows, hard on "
                  f"{n_hard} rows ({int((hard != hard0).any(1)[both].sum())} of them ok on both), iterations on "
                  f"{n_iters}; card call {ms:.1f} ms wall", flush=True)
            what = f"{name} at the {regime} regime, card vs CPU"
            if regime == "clean":
                check(n_hard == n_iters == 0 and (ok == ok0).all() and ok.all(), f"{what}: not equal")
                continue
            check((ok == ok0).all(), f"{what}: ok parted")
            check((hard[both] == hard0[both]).all(), f"{what}: hard bits of rows ok on both parted")
            check(n_iters <= H_ITERS_PARTED * H_CW, f"{what}: iteration counts parted on {n_iters} rows")
        hard_mm, _, ok_mm = ldpc.decode_mm(x["card"], codes["card"])
        for bucket in (None, 64):
            hard_tp, _, ok_tp = ldpc.decode_mm_twopass(x["card"], codes["card"], bucket=bucket)
            check(torch.equal(ok_mm, ok_tp) and torch.equal(hard_mm[ok_mm][:, d["M"]:], hard_tp[ok_tp][:, d["M"]:]),
                  f"twopass (bucket {bucket}) against decode_mm on the card at the {regime} regime")


def stream_block_steps(res: dict) -> int:
    """Block steps a bench_stream run took, its warm-ups included."""
    from gr_dtl_tpu_torch.tools import bench_stream as bs
    n = 0
    for r in res["stream_rx"] + res["stream_ingest"]:
        if r["mode"] == "ingest-cost":
            continue
        warm = bs.MEGA_WARMUP if r["mode"].startswith("mega") else bs.WARMUP
        n += (warm + r["reps"] * r.get("timed_blocks", r.get("timed_dispatches"))) * r.get("blocks_per_dispatch", 1)
    return n + sum(2 * (bs.DUPLEX_WARMUP + r["steps"]) for r in res["stream_duplex"])


def slice_h_phase(dev, card) -> dict:
    """Phase 27.  Returns, for the kernels line, the metric's and the scans'
    launches over the phase's counted runs and the steps they span."""
    from gr_dtl_tpu_torch.tools import (bench_bank_switch, bench_bf16_ab, bench_fec, bench_stream,
                                        bench_twopass, profile_rx)

    t_phase = time.perf_counter()
    ldpc_leftovers(dev)
    print(f"[slice-h] LDPC leftovers card vs CPU: {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    runs = AppLedger(dev, card, "slice-h")
    on = ["--device", str(dev)]
    per_rx = {"k1": 1, "eq": EQ_PER_STEP}  # a receive step
    per_block = {"k1": 1, "lock": 1, "acct": 1, "eq": EQ_PER_STEP}  # a stream block

    steps = 1 + 3 * 8  # a measurement: a warm-up step and three windows of eight
    res, _ = runs.run(f"bench_fec {H_B_FEC}", bench_fec, [H_B_FEC, "--reps", 3, "--iters", 8, *on],
                      len(bench_fec.SNRS_DB) * steps, per_rx)
    check(res["coded_snr_sweep"][0]["crc_rate"] == 1.0 and res["extra"]["bp_ok_rate"] == 1.0
          and res["bf16_ab"]["bp_ok_rate_bf16"] == 1.0, f"bench_fec: {res}")
    sweep = ", ".join(f"{p['snr_db']:g} dB {p['step_ms']:.2f} ms (CRC {p['crc_rate']:.4f}, BP iterations "
                      f"{p['avg_bp_iters']:.2f})" for p in res["coded_snr_sweep"])
    print(f"[slice-h] bench_fec: coded step B={H_B_FEC} at {sweep}; raw BP 2048 codewords {res['extra']['bp_step_ms']:.3f} ms "
          f"= {res['ldpc_info_mbps']:.1f} Mbit/s, bf16 {res['bf16_ab']['bp_step_ms_bf16']:.3f} ms ({card})", flush=True)

    for name, tool, variants in (("bench_twopass", bench_twopass, ("mm", "twopass")),
                                 ("bench_bf16_ab", bench_bf16_ab, ("f32", "bf16"))):
        res, _ = runs.run(f"{name} --cw {H_CW} --reps 5", tool, ["--cw", H_CW, "--reps", 5, *on], 0, {})
        for regime, r in res["regimes"].items():
            a, b = (r[v] for v in variants)
            print(f"[slice-h] {name} {regime}: {variants[0]} {a['median_ms']:.3f} ms (ok {a['ok_rate']:.4f}, "
                  f"iterations {a['avg_iters']:.2f}), {variants[1]} {b['median_ms']:.3f} ms (ok {b['ok_rate']:.4f}, "
                  f"iterations {b['avg_iters']:.2f}); windows {a['ms']} / {b['ms']} ({card})", flush=True)
            check(a["ok_rate"] == b["ok_rate"], f"{name} {regime}: ok rates {a['ok_rate']} and {b['ok_rate']}")
        check(res["regimes"]["clean"][variants[0]]["ok_rate"] == 1.0, f"{name}: clean regime not all ok")

    res, _ = runs.run(f"bench_bank_switch --codewords {H_BANK_CW} --sizes {H_BANK_SIZES}", bench_bank_switch,
                      ["--codewords", H_BANK_CW, "--sizes", H_BANK_SIZES, *on], 0, {})
    for r in res["rows"]:
        check(r["mm_ok_rate"] == r["gather_ok_rate"] == 1.0, f"bench_bank_switch: {r}")
    print(f"[slice-h] bank decoders at {H_BANK_CW} codewords: " + ", ".join(
        f"{r['n_codes']} codes mm {r['mm_ms']:.2f} / gather {r['gather_ms']:.2f} ms" for r in res["rows"])
          + f"; crossover {res['measured_crossover_n_codes']} codes (fec_chain.BANK_MM_MAX_CODES = "
          f"{fec_chain.BANK_MM_MAX_CODES}) ({card})", flush=True)

    sizes, f_dev, mega, blocks = H_STREAM
    with FeedbackCheck("bench_stream duplex") as fc:
        res, _ = runs.run(f"bench_stream --sizes {sizes} --blocks {blocks} --readback --mega {mega} --ingest",
                          bench_stream, ["--sizes", sizes, "--blocks", blocks, "--readback", "--mega", mega,
                                         "--ingest", *on], stream_block_steps, per_block)
    K7.add("bench_stream duplex", fc.calls, fc.launches, fc.frames, fc.err, fc.by_kernel)
    stream_rows, duplex_rows = res["stream_rx"] + res["stream_ingest"], res["stream_duplex"]
    res, _ = runs.run(f"bench_stream --device-stream --sizes {f_dev}", bench_stream,
                      ["--device-stream", "--sizes", f_dev, "--blocks", blocks, "--duplex-steps", 0, *on],
                      stream_block_steps, per_block)
    check(len(duplex_rows) == 2 and all(r["frames_header_ok"] == r["frames_sent"] > 0 for r in duplex_rows),
          f"bench_stream duplex: every frame sent must arrive with its header intact: {duplex_rows}")
    for r in stream_rows + res["stream_rx"]:
        if r["mode"] != "ingest-cost":
            check(r["crc_ok"] == r["valid_frames"] > 0, f"bench_stream row not CRC-clean, or no frame found: {r}")
        if "msamples_per_s" in r:
            print(f"[slice-h] bench_stream {r['mode']} F={r.get('frames_per_block')}"
                  f"{' depth ' + str(r['pipeline_depth']) if 'pipeline_depth' in r else ''}: "
                  f"{r['msamples_per_s']:.3f} Msamples/s, {r.get('dispatch_ms', float('nan')):.2f} ms a dispatch "
                  f"({card})", flush=True)

    tdir = tempfile.mkdtemp(prefix="profile_rx_")
    try:
        for args in (["--frames", H_B], ["--fec", "--frames", H_B_FEC]):
            res, _ = runs.run(f"profile_rx {' '.join(map(str, args))}", profile_rx, [*args, "--out", tdir, *on],
                              4, per_rx)
            names = profile_rx.trace_kernels(res["trace"])  # parses the trace file
            for k in ("sc_metric_kernel", "equalizer_kernel"):
                check(any(k in n for n in names), f"profile_rx {args}: no {k} in the trace ({sorted(names)[:20]})")
            check(res["crc_ok_rate"] == 1.0, f"profile_rx {args}: {res['crc_ok_rate']}")
            check(res["program_spans"] > 3 * 4, f"profile_rx {args}: {res['program_spans']} program spans")
            print(f"[slice-h] profile_rx {args}: {res['kernel_events']} kernel events of {len(names)} kernels in "
                  f"{os.path.getsize(res['trace']) / 1e6:.1f} MB of trace", flush=True)
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    print(f"[slice-h] phase took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return runs.totals


# ---------------------------------------------------------------------------
# phase 28: slice I, the bench (gr_dtl_tpu_torch/bench.py)
# ---------------------------------------------------------------------------

BENCH_B = (2048, 32)          # the main path's batch and a small one
BENCH_RUN = (5, 12)           # the bench's windows and chained steps a window
BENCH_CHAIN = (16, 3)         # card against CPU: frames a step, chained steps
BENCH_INTS = ("payload", "payload_len", "crc_ok", "header_ok", "frame_no", "cnst_id", "carr_offset")


def traced_step(fn, name: str, sacrifice: int = 1, on_trace=None) -> tuple:
    """One fn() traced by the profiler, after ``sacrifice`` sacrificed calls
    and more until ``WARM_MS`` have passed (``warm``): the CUDA runtime
    calls the host makes inside it and the device's kernels and copies that
    start after the warm calls' (``mark``), by name, and their busy ms.  A
    trace whose window holds no device work is taken again, warmed for
    longer.  ``on_trace``, if given, is called with the profiler of the
    window returned."""
    from torch.profiler import ProfilerActivity, profile, record_function
    for warm_ms in WARM_MS:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warm(fn, warm_ms, sacrifice)
            mark()
            with record_function(name):
                fn()
            torch.cuda.synchronize()  # outside the span: the step's own calls only
        events = prof.events()
        span = host_span(events, name)
        api, device, busy = {}, {}, 0.0
        for e in window_events(events, name):
            device[e.name] = device.get(e.name, 0) + 1
            busy += e.time_range.elapsed_us() / 1e3
        for e in events:
            if (not str(e.device_type).endswith("CUDA") and e.name.startswith("cuda")
                    and span.start <= e.time_range.start and e.time_range.end <= span.end
                    and not e.name.startswith(("cudaGet", "cudaDeviceGet", "cudaOccupancy", "cudaFuncGet"))):
                api[e.name] = api.get(e.name, 0) + 1
        if device:
            if on_trace is not None:
                on_trace(prof)
            break
        print(f"[trace] {name} traced after {warm_ms:g} ms of warm calls: the profiler saw no device work in "
              f"the span (runtime calls {api}); taken again", flush=True)
    return api, device, busy


def bench_phase(dev, card, phase5_ms: float) -> dict:
    """Phase 28.  Returns, for the kernels line, the metric's launches over
    the bench's counted runs and the steps they span."""
    t_phase = time.perf_counter()
    runs = AppLedger(dev, card, "bench")
    reps, iters = BENCH_RUN
    median_ms = {}
    for b in BENCH_B:
        # a warm-up step, then reps windows of iters: one metric and four equalizer launches a step
        res, _ = runs.run(f"python -m gr_dtl_tpu_torch.bench {b}", bench,
                          [b, "--reps", reps, "--iters", iters, "--device", str(dev)],
                          1 + reps * iters, {"k1": 1, "eq": EQ_PER_STEP})
        x = res["extra"]
        median_ms[b] = x["step_ms"]
        check(x["crc_ok_rate"] == 1.0, f"bench {b}: crc_ok_rate {x['crc_ok_rate']}")
        check(np.isfinite(res["value"]) and res["value"] > 0, f"bench {b}: value {res['value']}")
        check(res["vs_baseline"] is None and x["device"] == card and len(x["step_ms_windows"]) == reps,
              f"bench {b}: {res}")
        beside = (f"; phase 5's median at this B {phase5_ms:.3f} ms (7 windows of 3 steps, another "
                  "process state: printed, not compared)" if b == B else "")
        print(f"[bench] B={b}: {res['value']:.3f} Msamples/s, step median {x['step_ms']:.3f} ms, windows "
              f"{x['step_ms_windows']}{beside} ({card})", flush=True)

    # the chain on the card against the same stream on the CPU
    n, n_steps = BENCH_CHAIN
    cfg = cfgmod.make_rx_config(None, frame_length=bench.FRAME_LENGTH)
    tcfg = cfgmod.make_tx_config(None, frame_length=bench.FRAME_LENGTH)
    stream = bench.make_stream(transmitter.build_tx(tcfg, dev), *bench.traffic(tcfg, n),
                               torch.Generator(device=dev).manual_seed(SEED))
    rxp, rxp_cpu = receiver.build_rx(cfg, dev), receiver.build_rx(cfg, "cpu")
    acc, acc_cpu = torch.zeros((), device=dev), torch.zeros(())
    for i in range(n_steps):
        acc, got = bench.step(rxp, n, stream, acc)
        acc_cpu, want = bench.step(rxp_cpu, n, stream.cpu(), acc_cpu)
        check(float(acc) == float(acc_cpu) == n * (i + 1), f"bench chain step {i}: acc {float(acc)} on the "
              f"card, {float(acc_cpu)} on the CPU")
        for k in BENCH_INTS:
            check(torch.equal(getattr(got, k).cpu(), getattr(want, k)), f"bench chain step {i}: {k}, card vs CPU")
    print(f"[bench] B={n}, {n_steps} chained steps: acc {float(acc):g} on the card and on the CPU, "
          f"{', '.join(BENCH_INTS)} equal at every step", flush=True)

    # one step traced: no host read inside it
    stream = bench.make_stream(transmitter.build_tx(tcfg, dev), *bench.traffic(tcfg, B),
                               torch.Generator(device=dev).manual_seed(SEED))
    rxp = receiver.build_rx(cfg, dev)
    acc = torch.zeros((), device=dev)
    api, device, busy = traced_step(lambda: bench.step(rxp, B, stream, acc), "bench_step")
    n_dev = sum(device.values())
    print(f"[bench] one traced step at B={B}: CUDA runtime calls "
          + ", ".join(f"{k} {v}" for k, v in sorted(api.items(), key=lambda kv: -kv[1]))
          + "; copies on the device's timeline: "
          + (", ".join(f"{k} {v}" for k, v in sorted(device.items()) if k.startswith("Memcpy")) or "none")
          + f"; {n_dev} device kernels and copies, busy {busy:.3f} ms, idle share "
          f"{1 - busy / median_ms[B]:.4f} of the bench's {median_ms[B]:.3f} ms median ({card})", flush=True)
    check(any(k.startswith("cudaLaunchKernel") for k in api), "bench step: the profiler recorded no launch")
    waits = [k for k in list(api) + list(device)
             if "Synchronize" in k or ("DtoH" in k and "Pageable" in k)]
    check(not waits, f"bench step: synchronising calls or pageable device-to-host copies: {waits}")
    print(f"[bench] phase took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return runs.totals


# ---------------------------------------------------------------------------
# phase 29: slice J, K3 (csrc/ldpc_bp.cu)
# ---------------------------------------------------------------------------

BP_PARTED_MAX = 0.01  # share of an input's rows that may part from the plain version, never a converged one
# the phases whose paths decode LDPC codewords on the card: each must have launched K3
K3_CODED_TAGS = ("6-7 coded batch", "8-12 streams", "13-17 slice D", "23 wire compat", "24 sharded",
                 "25 app", "27 slice H")


class BpLedger:
    """A BP kernel's launches on the paths: K3's (``BP``: ``ldpc.decode_mm``
    and ``ldpc.decode_bank_mm``) or K8's (``GATHER``: ``ldpc.decode`` and
    ``ldpc.decode_bank``).  Once installed, every call of those decoders on
    a CUDA tensor (the receivers', the tools', ``decode_mm_twopass``'s inner
    calls) must launch the kernel once, a bank's call too, counted from its
    wrapper's count (``ldpc_cuda.<wrapper>.LAUNCHES``) just before and just
    after the call; each is booked under the phase named in ``tag``, one tag
    for every ledger.  The last call's arguments are kept in ``last``, so
    that the kernel's phase can hold it to its plain version on the tensors
    a path decoded.  Under ``plain_bp`` / ``plain_gather`` a call must
    launch nothing."""

    _tag = "setup"  # the phase running

    def __init__(self, kernel: str, wrapper: str, decoders: tuple, own_tag: str):
        self.kernel, self.wrapper, self.decoders, self.own_tag = kernel, wrapper, decoders, own_tag
        self.plain, self.last = False, None
        self.by_tag = {}  # tag -> [calls, launches]

    @property
    def tag(self) -> str:
        return BpLedger._tag

    @tag.setter
    def tag(self, value: str) -> None:
        BpLedger._tag = value

    def launches(self) -> int:
        return getattr(ldpc_cuda, self.wrapper).LAUNCHES

    def install(self) -> None:
        def counted(fn):
            def call(llr, *args, **kw):
                n0 = self.launches()
                out = fn(llr, *args, **kw)
                if self.on_card(llr):
                    want = 0 if self.plain else 1
                    got = self.launches() - n0
                    check(got == want, f"[{self.tag}] {fn.__name__}: {got} {self.kernel} launches, expected {want}")
                    if not self.plain:
                        row = self.by_tag.setdefault(self.tag, [0, 0])
                        row[0] += 1
                        row[1] += got
                        self.last = (fn.__name__, llr, args, kw)
                return out
            return call

        for name in self.decoders:
            setattr(ldpc, name, counted(getattr(ldpc, name)))

    @staticmethod
    def on_card(llr) -> bool:
        return llr.is_cuda

    def totals(self) -> tuple:
        """(calls, launches) over the paths' phases (all but the kernel's own phase)."""
        rows = [v for k, v in self.by_tag.items() if k != self.own_tag]
        return sum(r[0] for r in rows), sum(r[1] for r in rows)


BP = BpLedger("K3", "bp_decode_cuda", ("decode_mm", "decode_bank_mm"), "29 K3")
GATHER = BpLedger("K8", "bp_gather_cuda", ("decode", "decode_bank"), "30 K8")
# each BP kernel's wrapper, plain version, device kernel, and rounds of its timing in turns
BP_KERNELS = {"K3": {"wrapper": "bp_decode_cuda", "plain": "_bp", "kernel": "bp_kernel", "rounds": 2},
              "K8": {"wrapper": "bp_gather_cuda", "plain": "_bp_gather", "kernel": "bp_gather_kernel", "rounds": 1}}


@contextlib.contextmanager
def plain_bp():
    """``decode_mm`` on its plain version on CUDA tensors too (what the port
    ran before K3): for comparisons only."""
    orig = ldpc._decode
    ldpc._decode = lambda llr, g, max_iters, done, bf16: ldpc._bp(llr, g, max_iters, done=done, bf16=bf16)[:3]
    BP.plain = True
    try:
        yield
    finally:
        ldpc._decode = orig
        BP.plain = False


def against_plain(kernel: str, what: str, launch, plain) -> dict:
    """A BP kernel (``kernel``: "K3" or "K8"), called directly by
    ``launch()`` (no path's launch), against its plain version (``plain()``:
    ``_bp`` or ``_bp_gather``) on the same CUDA tensors: ok and iterations
    equal on every row, hard bits (and final totals, where ``launch`` and
    ``plain`` return them as a fourth output) bit-equal on every row that
    converged; a row that never converged may part (an ulp of a
    transcendental), and such rows are counted and named, at most
    ``BP_PARTED_MAX`` of them.  ``max_abs_err``: over the totals where they
    are compared, else over the hard bits."""
    counter = getattr(ldpc_cuda, BP_KERNELS[kernel]["wrapper"])
    name = BP_KERNELS[kernel]["plain"]
    n0 = counter.LAUNCHES
    got = launch()
    check(counter.LAUNCHES == n0 + 1, f"{kernel} on {what}: not one launch")
    want = plain()
    torch.cuda.synchronize()
    (hard, iters, ok), (hard0, iters0, ok0) = got[:3], want[:3]
    n = ok.shape[0]
    check(torch.equal(ok, ok0), f"{kernel} vs {name} on {what}: ok parted on {int((ok != ok0).sum())} rows")
    check(torch.equal(iters, iters0),
          f"{kernel} vs {name} on {what}: iterations parted on {int((iters != iters0).sum())} rows")
    parted = (hard != hard0).any(1)
    if len(got) > 3:
        parted |= (got[3].view(torch.int32) != want[3].view(torch.int32)).any(1)
        err = float((got[3] - want[3]).abs().max()) if n else 0.0
    else:
        err = float((hard - hard0).abs().max()) if n else 0.0
    ids = torch.nonzero(parted).flatten().tolist()
    check(not bool((parted & ok0).any()), f"{kernel} vs {name} on {what}: converged rows parted: {ids[:20]}")
    check(len(ids) <= BP_PARTED_MAX * n, f"{kernel} vs {name} on {what}: {len(ids)} rows parted: {ids[:20]}")
    print(f"[{kernel.lower()}] {what}: {n} codewords, ok rate {ok.float().mean().item():.4f}, iterations mean "
          f"{iters.float().mean().item():.4f} max {int(iters.max()) if n else 0}: {kernel} (one launch) against "
          f"{name}: ok and iterations equal on every row, hard bits{' and totals' if len(got) > 3 else ''} "
          f"bit-equal on {n - len(ids)} rows, parted rows {len(ids)} {ids[:10]}, max |d| {err:.3e}", flush=True)
    return {"rows": n, "parted": len(ids), "max_abs_err": err, "iters": iters}


def k3_against_plain(what: str, llr, g, done=None, bf16: bool = False, code_idx=None) -> dict:
    """K3 against ``_bp`` (:func:`against_plain`), final totals included.
    With a bank's graphs and ``code_idx``: one launch, each row against
    ``_bp`` of its own code (the other codes' rows marked done)."""
    total = torch.empty_like(llr)

    def launch():
        return (*ldpc_cuda.bp_decode_cuda(llr, g, 15, done=done, bf16=bf16, total_out=total, code_idx=code_idx),
                total)

    def plain():
        if code_idx is None:
            return ldpc._bp(llr, g, 15, done=done, bf16=bf16)
        return plain_bank(llr, code_idx, g, bf16, totals=True)

    return against_plain("K3", what, launch, plain)


def time_against_plain(kernel: str, what: str, fns: dict, nbytes: int, ops: int, edge_updates: int,
                       per_edge: float, clock: float, card: str, iters=None) -> dict:
    """A BP kernel's call (``fns["kernel"]``, one launch of ``kernel``) and
    its plain version's (``fns["plain"]``) in turns: plain, kernel, kernel,
    plain.  Both by CUDA events, the kernel by its device time too (the plain
    loop's is not taken: it is tens of launches a call, host-bound); beside
    the bound (``nbytes`` over the memory rate or ``ops`` over the float32
    rate, the larger) and the issue floor (``edge_updates`` at ``per_edge``
    instructions at ``clock`` MHz).  Returns the row of ``ms_at``."""
    k = BP_KERNELS[kernel]
    t = bench_k3.in_turns(fns, {"plain": 3, "kernel": 20}, {"kernel": 1}, rounds=k["rounds"], kernel=k["kernel"])
    ms, dev_ms = median(t["kernel"]["events"]), median(t["kernel"]["device"])
    plain_ms = median(t["plain"]["events"])
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    floor = bench_k3.issue_floor_ms(per_edge, 1, edge_updates, clock)
    row = {"ms": ms, "device_ms": dev_ms, "ms_windows": t["kernel"]["events"],
           "device_ms_windows": t["kernel"]["device"], "plain_ms": plain_ms,
           "plain_ms_windows": t["plain"]["events"], "bound_ms": max(by_bytes, by_ops),
           "bound_by": "bytes" if by_bytes >= by_ops else "operations", "issue_floor_ms": floor,
           "edge_updates": edge_updates}
    if iters is not None:
        row["mean_iters"] = iters.float().mean().item()
    print(f"[{kernel.lower()}-timing] {what}: {kernel} {ms:.4f} ms by events "
          f"({[round(v, 4) for v in t['kernel']['events']]}), {dev_ms:.4f} ms on the device (profiler, "
          f"{[round(v, 4) for v in t['kernel']['device']]}); {k['plain']} {plain_ms:.3f} ms "
          f"({[round(v, 3) for v in t['plain']['events']]}); bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
          f"({by_bytes:.4f} ms for {nbytes} bytes, {by_ops:.4f} ms for {ops} operations), "
          f"{row['bound_ms'] / dev_ms:.1%} of the device time; issue floor {floor:.4f} ms ({edge_updates} edge "
          f"updates at {per_edge:.1f} instructions), {floor / dev_ms:.1%} of it; "
          + (f"mean iterations {row['mean_iters']:.4f}; " if iters is not None else "")
          + f"library call: none computes it ({card})", flush=True)
    return row


def plain_bank(llr, code_idx, graphs, bf16: bool = False, totals: bool = False):
    """``decode_bank_mm``'s plain version on the card: ``_bp`` a code over
    every row, the other codes' rows marked done, merged a code at a time."""
    sel = torch.clamp(code_idx, 1, len(graphs)) - 1
    out = None
    for ci, g in enumerate(graphs):
        mine = sel == ci
        got = ldpc._bp(llr, g, 15, done=~mine, bf16=bf16)[:4 if totals else 3]
        out = got if out is None else [torch.where(mine.reshape(-1, *[1] * (a.ndim - 1)), a, o)
                                       for a, o in zip(got, out)]
    return out


def sass_of(counts: dict, bf16: bool, slots: int) -> tuple:
    """(name, counts) of the instantiation bp_kernel<bf16, slots> of a build."""
    tag = f"bp_kernelILb{int(bf16)}ELi{slots}EE"
    name = next(k for k in counts if tag in k)
    return name, counts[name]


K3_BANK_CW = 1024  # codewords of the banks phase 29 times (tools/bench_bank_switch's)


def k3_phase(dev, card, paths: dict) -> dict:
    """Phase 29.  Returns K3's entry for the ``kernels`` line."""
    t_phase = time.perf_counter()
    code = paths["rxp"].fec.code
    _, codes, h = h_llrs(dev)
    inputs = {}  # name -> (llr, graph)
    for snr in ("25 dB", "11 dB"):
        name, llr, _, _ = paths["calls"][snr]
        check(name == "decode_mm" and llr.shape == (B_FEC * paths["rxp"].fec.max_ncws, code.N),
              f"the coded step's BP call at {snr}: {name} {tuple(llr.shape)}")
        inputs[f"coded {snr}"] = (llr.float().contiguous(), code.graph)
    for regime, x in h.items():
        inputs[f"{H_CW} {regime}"] = (torch.as_tensor(x, device=dev), codes["card"].graph)
    banks = bench_k3.bank_inputs(dev, K3_BANK_CW)

    # ---- how K3 is compiled: registers, residency, what an update issues an edge ----
    clock = bench_k3.sm_clock_mhz()
    # the main path's instantiation: bp_kernel<bf16, the code's row degree>, warps_for's warps
    lib, slots, warps = ldpc_cuda.library_path(), code.graph.chk_edges.shape[1], ldpc_cuda.warps_for(code.graph)
    resident = {bf: ldpc_cuda.resident_codewords(code.graph, bf) for bf in (False, True)}
    for line in bench_k3.ptxas_lines(lib):
        print(f"[k3-build] {line}")
    counts = bench_k3.kernel_counts(lib)
    for bf in (False, True):
        name, c = sass_of(counts, bf, slots)
        e = c["per_edge"]
        print(f"[k3-sass] bf16={int(bf)} ({name}): {c['kernel_instructions']} instructions; a message update "
              f"issues {e['instructions']:.1f} an edge in the loops that evaluate the transcendentals "
              f"({e['mufu']:.1f} MUFU, {e['lds']:.1f} shared loads, {e['sts']:.1f} shared stores an edge; loops "
              f"{c['loops']}), barriers in its loop of updates {c['update_loop_barriers']}; resident codewords an "
              f"SM {resident[bf]} ({resident[bf] * bench_k3.SMS} on {bench_k3.SMS} SMs, {warps} warps a codeword) "
              f"({card})", flush=True)
    per_edge = sass_of(counts, False, slots)[1]["per_edge"]["instructions"]
    print(f"[k3-sass] issue floor: instructions an edge x E x updates over {bench_k3.SMS} SMs x "
          f"{bench_k3.SCHEDULERS} schedulers x {bench_k3.LANES} lanes x {clock:.0f} MHz (clocks.max.sm)", flush=True)

    # ---- K3 against _bp on the paths' own tensors ----
    cmp = {what: k3_against_plain(what, x, g) for what, (x, g) in inputs.items()}
    for what in ("coded 11 dB", f"{H_CW} knee"):
        cmp[f"{what}, bf16"] = k3_against_plain(f"{what}, bf16", *inputs[what], bf16=True)
    name, llr, args, kw = paths["calls"]["two-code bank"]
    check(name == "decode_bank_mm", f"the two-code bank's BP call: {name}")
    code_idx, bank = args[0], args[1]
    sel = torch.clamp(code_idx, 1, bank.n_codes) - 1
    x = llr.float().contiguous()
    for ci, g in enumerate(bank.graphs):
        what = f"two-code bank at {SNR_MIXED_DB:g} dB, code {ci + 1} (other rows marked done)"
        cmp[what] = k3_against_plain(what, x, g, done=sel != ci)
    what = f"two-code bank at {SNR_MIXED_DB:g} dB, every row its own code"
    cmp[what] = k3_against_plain(what, x, bank.graphs, code_idx=code_idx.contiguous())
    for n, (x, idx, bank) in banks.items():
        if n in (8, 32):
            what = f"bank of {n} codes, {K3_BANK_CW} codewords"
            cmp[what] = k3_against_plain(what, x, bank.graphs, code_idx=idx)
    # rows wider than the unrolled slots (8): the guarded instantiation, alone and in a bank
    qc = lambda dc, z: ldpc._graph(_ldpc_bench.qc_parity(3, dc, z), dev)
    for dc, z in ((12, 16), (64, 8)):
        g = qc(dc, z)
        what = f"a quasi-cyclic code of row degree {dc}, {H_CW} codewords"
        x = torch.as_tensor(_ldpc_bench.zero_word_llrs(H_CW, g.n_var, dc), device=dev)
        cmp[what] = k3_against_plain(what, x, g)
    what = f"a bank of quasi-cyclic codes of row degrees 6 and 12, {H_CW} codewords, every row its own code"
    cmp[what] = k3_against_plain(
        what, torch.as_tensor(_ldpc_bench.zero_word_llrs(H_CW, 192, 7), device=dev), (qc(6, 32), qc(12, 16)),
        code_idx=torch.as_tensor(np.random.RandomState(8).randint(0, 4, H_CW).astype(np.int32), device=dev))
    for what, c in (("coded 11 dB", code), (f"{H_CW} waterfall", codes["card"])):
        x = inputs[what][0]
        got = ldpc.decode_mm_twopass(x, c)
        with plain_bp():
            want = ldpc.decode_mm_twopass(x, c)
        check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
              and torch.equal(got[0][want[2]], want[0][want[2]]),
              f"decode_mm_twopass on {what}: K3 against _bp")
        print(f"[k3] decode_mm_twopass on {what}: through K3 and through _bp, ok and iterations equal on every "
              f"row, hard bits on every converged row ({int(want[2].sum())} of {x.shape[0]})", flush=True)
    rows = sum(c["rows"] for c in cmp.values())
    parted = sum(c["parted"] for c in cmp.values())
    max_err = max(c["max_abs_err"] for c in cmp.values())

    # ---- times: _bp, K3, K3, _bp ----
    times = {}
    for what, (x, g) in inputs.items():
        it = cmp[what]["iters"]
        times[what] = time_against_plain(
            "K3", what, {"plain": lambda: ldpc._bp(x, g, 15), "kernel": lambda: ldpc_cuda.bp_decode_cuda(x, g, 15)},
            ldpc_cuda.bp_bytes(*x.shape), ldpc_cuda.bp_ops(it, g), int(it.sum()) * g.n_edge, per_edge, clock, card,
            it)
    for n, (x, idx, bank) in banks.items():
        _, it, _ = ldpc.decode_bank_mm(x, idx, bank)
        sel = idx.long() - 1
        ops = sum(ldpc_cuda.bp_ops(it[sel == ci], g) for ci, g in enumerate(bank.graphs))
        updates = sum(int(it[sel == ci].sum()) * g.n_edge for ci, g in enumerate(bank.graphs))
        what = f"bank of {n} codes, {K3_BANK_CW} codewords"
        times[what] = time_against_plain(
            "K3", what,
            {"plain": lambda: plain_bank(x, idx, bank.graphs), "kernel": lambda: ldpc.decode_bank_mm(x, idx, bank)},
            ldpc_cuda.bp_bytes(*x.shape) + idx.element_size() * idx.numel(), ops, updates, per_edge, clock, card)

    # ---- the coded step with K3 and with _bp, in turns ----
    rxp, rcfg = paths["rxp"], paths["rcfg"]
    for snr, (stream, _) in paths["streams"].items():
        def step_plain(stream=stream):
            with plain_bp():
                return rx_step(rxp, stream, B_FEC)
        t = {k: (median(v["events"]), v["events"]) for k, v in bench_k3.in_turns(
            {"plain": step_plain, "k3": lambda: rx_step(rxp, stream, B_FEC)}, STEPS_PER_WINDOW).items()}
        stages_k3, iters, _ = coded_stages(rxp, rcfg, stream)
        with plain_bp():
            stages_plain, _, _ = coded_stages(rxp, rcfg, stream)
        print(f"[k3-step] {snr:g} dB coded step B={B_FEC}: with K3 {t['k3'][0]:.3f} ms (windows "
              f"{[round(v, 3) for v in t['k3'][1]]}), with _bp {t['plain'][0]:.3f} ms "
              f"({[round(v, 3) for v in t['plain'][1]]}); phase 7's median {paths['step_ms'][snr]:.3f} ms ({card})")
        print(f"[k3-step] {snr:g} dB stages (ms, median of 5), with K3: "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages_k3.items()) + "; with _bp: "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages_plain.items())
              + f"; mean BP iterations {iters.float().mean().item():.4f}", flush=True)

    # ---- one decode_mm and one decode_bank_mm traced: one kernel each, no host read ----
    x = inputs["coded 11 dB"][0]
    xb, idxb, bankb = banks[32]
    for what, fn in ((f"decode_mm at {x.shape[0]} codewords", lambda: ldpc.decode_mm(x, code)),
                     (f"decode_bank_mm of {bankb.n_codes} codes at {xb.shape[0]} codewords",
                      lambda: ldpc.decode_bank_mm(xb, idxb, bankb))):
        api, device, busy = traced_step(fn, "k3_traced", sacrifice=64)
        print(f"[k3] one {what} traced: CUDA runtime calls "
              + (", ".join(f"{k} {v}" for k, v in sorted(api.items())) or "none seen")
              + "; on the device's timeline " + ", ".join(f"{k} {v}" for k, v in sorted(device.items()))
              + f", busy {busy:.4f} ms ({card})", flush=True)
        check(sum(device.values()) == 1 and "bp_kernel" in next(iter(device)),
              f"a traced {what}: device work {device}, expected the one K3 kernel")
        waits = [k for k in list(api) + list(device) if "Synchronize" in k or "DtoH" in k or "Memcpy" in k]
        check(not waits, f"a traced {what}: synchronising calls or copies {waits}")

    # ---- launches on the paths ----
    print("[k3] launches a phase (BP calls / K3 launches): "
          + ", ".join(f"{k} {c} / {n}" for k, (c, n) in BP.by_tag.items()), flush=True)
    for tag in K3_CODED_TAGS:
        check(BP.by_tag.get(tag, [0, 0])[1] > 0, f"phase {tag} launched no K3")
    calls, launches = BP.totals()
    check(launches == calls, f"the paths made {calls} BP calls and {launches} K3 launches, not one a call")
    print(f"[k3] phase took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    main = times["coded 11 dB"]
    return {"name": "ldpc_bp", "route": "cuda", "source": "gr_dtl_tpu_torch/csrc/ldpc_bp.cu",
            "replaces": "gr_dtl_tpu/ops/ldpc.py:249-353", "launches": launches,
            # a step: a BP call of a path (a coded receive step makes one)
            "launches_per_step": launches / calls, "max_abs_err": max_err, "rows_compared": rows,
            "parted_rows": parted, "ms": main["ms"], "ms_by": "events", "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
            "device_ms": main["device_ms"], "issue_floor_ms": main["issue_floor_ms"], "instructions_per_edge": per_edge,
            "resident_codewords_per_sm": resident[False],
            "at": f"the coded 11 dB step's {x.shape[0]} codewords of n={code.N}",
            "ms_at": times}


# ---------------------------------------------------------------------------
# phase 30: slice K, K8 (the gather form, csrc/ldpc_bp.cu's bp_gather_kernel)
# ---------------------------------------------------------------------------

K8_BANK_CODES, K8_IDS = bench_k3.K8_BANK_CODES, bench_k3.K8_IDS  # 33 copies of n=300, fec_ids 1..15


@contextlib.contextmanager
def plain_gather():
    """``decode`` and ``decode_bank`` on their plain version on CUDA tensors
    too (what the port ran before K8): for comparisons only."""
    orig = ldpc._decode_gather
    ldpc._decode_gather = lambda llr, src, max_iters, code_idx=None: ldpc._bp_gather(
        llr, *ldpc._gather_tables(src, code_idx), max_iters)
    GATHER.plain = True
    try:
        yield
    finally:
        ldpc._decode_gather = orig
        GATHER.plain = False


def k8_against_plain(what: str, llr, src, code_idx=None, max_iters: int = 15) -> dict:
    """K8 against ``_bp_gather`` (:func:`against_plain`) on the code ``src``
    or, with ``code_idx``, the bank ``src``, each row its own code."""
    graph = src.graph if code_idx is None else src.graphs
    return against_plain("K8", what, lambda: ldpc_cuda.bp_gather_cuda(llr, graph, max_iters, code_idx=code_idx),
                         lambda: ldpc._bp_gather(llr, *ldpc._gather_tables(src, code_idx), max_iters))


def k8_path(dev, gen, card) -> dict:
    """The coded receive step at B_FEC frames through a bank of
    ``K8_BANK_CODES`` codes, which ``fec_frame_decode`` sends to
    ``decode_bank``, at 25 and 11 dB: the counts set to 0 just before each
    step and read just after (one K8 launch, no K3, the metric and four
    equalizer launches); every frame decoded with what was sent at 25 dB,
    and at 11 dB (where BP takes updates) the frames that pass their CRC the
    same as through ``_bp_gather``; each step timed with K8 and with
    ``_bp_gather`` in turns, and traced."""
    alists = (BANK_ALISTS[1],) * K8_BANK_CODES
    _, rcfg, txp, rxp = coded_params(alists, dev)
    fec = rxp.fec
    check(fec.bank.n_codes > fec_chain.BANK_MM_MAX_CODES,
          f"a bank of {fec.bank.n_codes} codes would not reach decode_bank")
    rng = np.random.RandomState(SEED + 30)
    fec_id = rng.randint(1, K8_IDS + 1, B_FEC).astype(np.int32)
    samples, sent = coded_tx(txp, np.full(B_FEC, 2, np.int32), fec_id)
    path = {"bank": fec.bank, "counts": {}, "llr": {}, "code_idx": {}, "step_ms": {}, "grid": {}}
    # the launch's grid by its rule (bp_gather_launch): a wave of the blocks the card keeps resident for
    # this bank, where the step's codewords fill WALK_WAVES waves, else a block a codeword
    wave = (ldpc_cuda.resident_codewords(fec.bank.graphs, gather=True)
            * torch.cuda.get_device_properties(dev).multi_processor_count)
    for snr in SNRS_DB:
        stream, _ = noisy(samples, snr, gen)
        what = f"coded B={B_FEC} QPSK at {snr:g} dB through a {K8_BANK_CODES}-code bank"
        BP.tag = "30 K8 path"
        reset_counts()
        out = rx_step(rxp, stream, B_FEC)
        torch.cuda.synchronize()
        counts = path["counts"][snr] = {
            "K1": sync_cuda.timing_metric_cuda.LAUNCHES, "K2": equalizer_cuda.equalize_frame_cuda.LAUNCHES,
            "K3": ldpc_cuda.bp_decode_cuda.LAUNCHES, "K8": ldpc_cuda.bp_gather_cuda.LAUNCHES}
        EQ.counted(1, what)
        print(f"[k8-path] {what} (fec_id 1..{K8_IDS}, {B_FEC * fec.max_ncws} codeword slots): launches in the step "
              f"{counts}", flush=True)
        check(counts["K8"] == 1 and counts["K3"] == 0 and counts["K1"] > 0,
              f"{what}: launches {counts}, expected one K8 and no K3")
        name, llr, args, _ = GATHER.last
        check(name == "decode_bank" and args[1] is fec.bank, f"{what}: the BP call was {name}")
        path["llr"][snr], path["code_idx"][snr] = llr.float().contiguous(), args[0].contiguous()
        BP.tag = "30 K8"
        if snr == 25.0:
            check_decoded(out, sent, what)
            print(f"[k8-path] every frame decoded with what was sent: crc_ok {int(out.crc_ok.sum())}/{B_FEC}, "
                  f"mean BP iterations {out.avg_iters.mean().item():.4f}", flush=True)
        else:
            with plain_gather():
                out_plain = rx_step(rxp, stream, B_FEC)
            check(torch.equal(out.crc_ok, out_plain.crc_ok) and torch.equal(out.avg_iters, out_plain.avg_iters),
                  f"{what}: crc_ok or BP iterations parted from the step through _bp_gather")
            print(f"[k8-path] crc rate {out.crc_ok.float().mean().item():.4f} ({int(out.crc_ok.sum())}/{B_FEC}), "
                  f"mean BP iterations {out.avg_iters.mean().item():.4f}: crc_ok and iterations the same through "
                  f"_bp_gather", flush=True)

        def step_plain(stream=stream):
            with plain_gather():
                return rx_step(rxp, stream, B_FEC)
        t = bench_k3.in_turns({"plain": step_plain, "k8": lambda: rx_step(rxp, stream, B_FEC)}, STEPS_PER_WINDOW)
        ms = path["step_ms"][snr] = {k: median(v["events"]) for k, v in t.items()}
        traced = []
        api, device, busy = traced_step(lambda: rx_step(rxp, stream, B_FEC), "k8_step", on_trace=traced.append)
        _, device_plain, busy_plain = traced_step(step_plain, "k8_step_plain")
        n_k8 = sum(v for k, v in device.items() if "bp_gather_kernel" in k)
        grids = launch_grids(traced[0], "bp_gather_kernel")
        rows = path["llr"][snr].shape[0]
        want = wave if rows >= ldpc_cuda.WALK_WAVES * wave else rows
        print(f"[k8-path] {snr:g} dB: the traced K8 launch's grid {grids} (the profiler's record) for {rows} "
              f"codewords; the launch rule's {want} (a wave {wave})", flush=True)
        check(len(grids) == 1 and grids[0] == [want, 1, 1],
              f"the traced step at {snr:g} dB: K8's grids {grids}, expected one of [{want}, 1, 1]")
        path["grid"][snr] = grids[0][0]
        print(f"[k8-path] {snr:g} dB: the step with K8 {ms['k8']:.3f} ms (windows "
              f"{[round(v, 3) for v in t['k8']['events']]}), with _bp_gather {ms['plain']:.3f} ms "
              f"({[round(v, 3) for v in t['plain']['events']]}); traced: {sum(device.values())} device kernels and "
              f"copies, busy {busy:.3f} ms, idle share {1 - busy / ms['k8']:.4f} (with _bp_gather "
              f"{sum(device_plain.values())}, busy {busy_plain:.3f} ms, idle {1 - busy_plain / ms['plain']:.4f}); "
              f"K8 in the trace {n_k8} ({card})", flush=True)
        check(n_k8 == 1, f"the traced step at {snr:g} dB ran {n_k8} K8 kernels, expected one")
    return path


def k8_phase(dev, card, gen) -> dict:
    """Phase 30.  Returns K8's entry for the ``kernels`` line."""
    t_phase = time.perf_counter()
    path = k8_path(dev, gen, card)
    _, codes, h = h_llrs(dev)
    code = codes["card"]
    banks = bench_k3.bank_inputs(dev, K3_BANK_CW)

    # ---- how K8 is compiled ----
    lib = ldpc_cuda.library_path()
    clock = bench_k3.sm_clock_mhz()
    kernels = bench_k3.disassemble(lib)
    counts = bench_k3.form_counts(kernels, "gather")
    slots = code.graph.chk_edges.shape[1]
    name = next(k for k in counts if f"bp_gather_kernelILi{slots}EE" in k)
    c = counts[name]
    resident = ldpc_cuda.resident_codewords(code.graph, gather=True)
    per_edge = c["per_edge"]["instructions"]
    print(f"[k8-sass] {name}: {c['kernel_instructions']} instructions; a message update issues {per_edge:.1f} an "
          f"edge in the loops that evaluate the transcendentals ({c['per_edge']['mufu']:.1f} MUFU, "
          f"{c['per_edge']['lds']:.1f} shared loads, {c['per_edge']['sts']:.1f} shared stores an edge; loops "
          f"{c['loops']}), barriers in its loop of updates {c['update_loop_barriers']}; resident codewords an SM "
          f"{resident} ({resident * bench_k3.SMS} on {bench_k3.SMS} SMs, {ldpc_cuda.warps_for(code.graph)} warps a "
          f"codeword); K3's at the same slots: {sass_of(bench_k3.form_counts(kernels), False, slots)[1]['per_edge']} "
          f"({card})", flush=True)

    # ---- K8 against _bp_gather ----
    cmp, inputs = {}, {}  # inputs: name -> (llr, src, code_idx)
    for regime, x in h.items():
        inputs[f"{H_CW} {regime}"] = (torch.as_tensor(x, device=dev), code, None)
    for snr in SNRS_DB:
        inputs[f"the {K8_BANK_CODES}-code step's {path['llr'][snr].shape[0]} codewords at {snr:g} dB"] = (
            path["llr"][snr], path["bank"], path["code_idx"][snr])
    for n, (x, idx, bank) in banks.items():
        if n > 1:
            inputs[f"bank of {n} copies, {K3_BANK_CW} codewords"] = (x, bank, idx)
    distinct = {n: bench_k3.distinct_bank(n, dev, K3_BANK_CW, SEED + 30 + n) for n in (2, 8, 32)}
    for n, (x, bank) in distinct.items():
        idx = torch.as_tensor(np.random.RandomState(n).randint(1, n + 1, x.shape[0]).astype(np.int32), device=dev)
        inputs[f"bank of {n} distinct codes, noisy, {K3_BANK_CW} codewords"] = (x, bank, idx)
    for what, (x, src, idx) in inputs.items():
        cmp[what] = k8_against_plain(what, x, src, idx)
    # decode_bank's id rule: ids past the bank and negative ones, on distinct codes with updates
    x8, bank8 = distinct[8]
    C = bank8.n_codes
    wild = torch.as_tensor(np.random.RandomState(30).randint(-C - 3, C + 4, x8.shape[0]).astype(np.int64),
                           device=dev)
    wild[:2 * C + 7] = torch.arange(-C - 3, C + 4, device=dev)  # every id of [-C-3, C+3]
    what = f"bank of {C} distinct codes, noisy, ids in [{-C - 3}, {C + 3}]"
    cmp[what] = k8_against_plain(what, x8, bank8, wild)
    # the check tells the rules apart: decode_bank_mm's clamp to [1, C] decodes other rows otherwise
    mm_rule = ldpc._bp_gather(x8, *ldpc._gather_tables(bank8, torch.clamp(wild, 1, C)), 15)
    k8 = ldpc_cuda.bp_gather_cuda(x8, bank8.graphs, 15, code_idx=wild)
    differ = (k8[0] != mm_rule[0]).any(1) | (k8[1] != mm_rule[1]) | (k8[2] != mm_rule[2])
    check(bool(differ.any()), f"{what}: decode_bank_mm's id rule gives the same rows, so the check tells nothing")
    print(f"[k8] {what}: decode_bank_mm's clamp to [1, {C}] would part on {int(differ.sum())} rows", flush=True)
    what = f"{H_CW} knee, max_iters 0"
    cmp[what] = k8_against_plain(what, inputs[f"{H_CW} knee"][0], code, max_iters=0)
    # batches below, at and past the grid (a wave of resident blocks), rows that do not start on 16 bytes
    # (the row's 4-byte copies), and neighbouring rows of other codes; the stream's counters back at 0 after
    wave = resident * torch.cuda.get_device_properties(dev).multi_processor_count
    knee = torch.cat([inputs[f"{H_CW} knee"][0]] * 2)  # 4096 codewords: past four waves
    for B in sorted({1, 7, 923, 925, wave - 1, wave, wave + 1, 4 * wave - 1, 4 * wave, 4 * wave + 1} - {0}):
        cmp[f"{H_CW} knee, the first {B}"] = k8_against_plain(f"{H_CW} knee, the first {B} (a wave {wave})",
                                                              knee[:B].contiguous(), code)
    for what, x, src, idx in ((f"{H_CW} knee", knee, code, None),
                              ("bank of 8 distinct codes", x8, bank8,
                               torch.as_tensor(np.arange(x8.shape[0]) % 8 + 1, dtype=torch.int32, device=dev))):
        off = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
        off.copy_(x)
        check(off.is_contiguous() and off.data_ptr() % 16 == 4, "a view one float into its storage")
        what = f"{what}, rows 4 bytes past 16" + ("" if idx is None else ", neighbouring rows of other codes")
        cmp[what] = k8_against_plain(what, off, src, idx)
    torch.cuda.synchronize()
    work = ldpc_cuda._work(torch.cuda.current_stream(dev)).tolist()
    check(work == [0] * ldpc_cuda.WORK_COUNTERS, f"K8's counters after the calls: {work}, expected all 0")
    cw = torch.as_tensor(h["clean"] > 0, device=dev)  # the clean regime's codewords, with no noise
    noiseless = torch.where(cw, 4.0, -4.0).float().contiguous()
    got = cmp["noiseless"] = k8_against_plain(f"{H_CW} noiseless (done at entry)", noiseless, code)
    check(int(got["iters"].max()) == 0, "the noiseless batch took updates")
    rows = sum(v["rows"] for v in cmp.values())
    parted = sum(v["parted"] for v in cmp.values())

    # ---- times: _bp_gather, K8, K8, _bp_gather ----
    times = {}
    for what, (x, src, idx) in inputs.items():
        graphs = (src.graph,) if idx is None else src.graphs
        it = cmp[what]["iters"]
        if idx is None:
            sel = torch.zeros_like(it, dtype=torch.long)
        else:
            sel = torch.clamp(ldpc._bank_rows(idx, src.n_codes), min=1) - 1
        ops = sum(ldpc_cuda.bp_ops(it[sel == ci], g, ldpc_cuda.GATHER_UPDATE_OPS_PER_EDGE)
                  for ci, g in enumerate(graphs))
        updates = sum(int(it[sel == ci].sum()) * g.n_edge for ci, g in enumerate(graphs))
        nbytes = ldpc_cuda.bp_bytes(*x.shape) + (0 if idx is None else idx.element_size() * idx.numel())
        times[what] = time_against_plain(
            "K8", what, {"plain": lambda: ldpc._bp_gather(x, *ldpc._gather_tables(src, idx), 15),
                         "kernel": lambda: ldpc._decode_gather(x, src, 15, idx)},
            nbytes, ops, updates, per_edge, clock, card, it)

    # ---- one decode_bank of the path's bank traced: one kernel, no host read ----
    x, idx = path["llr"][11.0][:K3_BANK_CW].contiguous(), path["code_idx"][11.0][:K3_BANK_CW].contiguous()
    bank = path["bank"]
    what = f"decode_bank of {bank.n_codes} codes at {x.shape[0]} codewords (11 dB)"
    api, device, busy = traced_step(lambda: ldpc.decode_bank(x, idx, bank), "k8_traced", sacrifice=64)
    print(f"[k8] one {what} traced: CUDA runtime calls "
          + (", ".join(f"{k} {v}" for k, v in sorted(api.items())) or "none seen")
          + "; on the device's timeline " + ", ".join(f"{k} {v}" for k, v in sorted(device.items()))
          + f", busy {busy:.4f} ms ({card})", flush=True)
    check(sum(device.values()) == 1 and "bp_gather_kernel" in next(iter(device)),
          f"a traced {what}: device work {device}, expected the one K8 kernel")
    waits = [k for k in list(api) + list(device) if any(w in k for w in ("Synchronize", "DtoH", "Memcpy", "Memset"))]
    check(not waits, f"a traced {what}: synchronising calls or copies {waits}")

    # ---- launches on the paths ----
    print("[k8] launches a phase (gather-form calls / K8 launches): "
          + ", ".join(f"{k} {c} / {n}" for k, (c, n) in GATHER.by_tag.items()), flush=True)
    for tag in ("27 slice H", "30 K8 path"):
        check(GATHER.by_tag.get(tag, [0, 0])[1] > 0, f"phase {tag} launched no K8")
    calls, launches = GATHER.totals()
    check(launches == calls, f"the paths made {calls} gather-form calls and {launches} K8 launches, not one a call")
    print(f"[k8] phase took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    # the main path: the coded steps through the large bank, each run with the counts set to 0 just before
    path_launches = sum(c["K8"] for c in path["counts"].values())
    main = times[f"the {K8_BANK_CODES}-code step's {path['llr'][11.0].shape[0]} codewords at 11 dB"]
    return {"name": "ldpc_bp_gather", "route": "cuda", "source": "gr_dtl_tpu_torch/csrc/ldpc_bp.cu",
            "replaces": "gr_dtl_tpu/ops/ldpc.py:154-246", "launches": path_launches,
            # a step: a coded receive step through the large bank (it makes one decode_bank call)
            "launches_per_step": path_launches / len(path["counts"]),
            "max_abs_err": max(v["max_abs_err"] for v in cmp.values()), "rows_compared": rows,
            "parted_rows": parted, "ms": main["ms"], "ms_by": "events", "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
            "device_ms": main["device_ms"], "issue_floor_ms": main["issue_floor_ms"],
            "instructions_per_edge": per_edge, "resident_codewords_per_sm": resident,
            # the 11 dB step's K8 launch, as the profiler recorded it: a wave of resident blocks walking its codewords
            "grid_blocks": path["grid"][11.0],
            "also_replaces": "gr_dtl_tpu/ops/ldpc.py:574-645",
            # every path's gather-form calls on the card (phases 27 and 30), booked by the ledger
            "ledger_calls": calls, "ledger_launches": launches,
            "at": f"the {K8_BANK_CODES}-code coded step's {path['llr'][11.0].shape[0]} codewords of n={code.N} "
                  f"at 11 dB", "step_ms": path["step_ms"], "ms_at": times}


class LlrLedger:
    """K9's launches on the paths.  Once installed, every
    ``receiver.frame_llrs`` call on a CUDA tensor must launch K9 once with
    the closed-form tables and not at all in wire-compat table mode (the
    plain chain), counted from ``llr_cuda.frame_llrs_cuda.LAUNCHES`` just
    before and just after the call, and is booked under the phase running
    (``BP.tag``): [closed-form calls, K9 launches, frames, table-mode calls].
    While ``keep`` is set, the last closed-form call's arguments and output
    are kept in ``last``."""

    def __init__(self):
        self.by_tag, self.keep, self.last = {}, False, None

    def install(self) -> None:
        fn = receiver.frame_llrs

        def call(rxp, soft, cnst, noise_var):
            n0 = llr_cuda.frame_llrs_cuda.LAUNCHES
            out = fn(rxp, soft, cnst, noise_var)
            if soft.is_cuda:
                table = bool(rxp.tab.table_mode)
                got = llr_cuda.frame_llrs_cuda.LAUNCHES - n0
                want = 0 if table else 1
                check(got == want, f"[{BP.tag}] frame_llrs: {got} K9 launches, expected {want}")
                row = self.by_tag.setdefault(BP.tag, [0, 0, 0, 0])
                if table:
                    row[3] += 1
                else:
                    row[0], row[1], row[2] = row[0] + 1, row[1] + got, row[2] + soft.shape[0]
                    if self.keep:
                        self.last = (rxp, soft, cnst, noise_var, out)
            return out

        receiver.frame_llrs = call


LLR = LlrLedger()


def llr_ring(args: tuple) -> list:
    """Copies of one call's (soft, cnst int32, noise_var) at their own
    addresses, over ``bench_llr.RING_BYTES`` of inputs and outputs, so that
    a timed walk over them is not served from the L2."""
    rxp, soft, cnst, nv = args[:4]
    per = llr_cuda.llr_bytes(*soft.shape, rxp.fec.max_frame_bits)
    n = max(2, -(-int(bench_llr.RING_BYTES) // per))
    return [(soft.clone(), cnst.int().clone(), nv.clone()) for _ in range(n)]


def k9_phase(dev, card, coded: dict) -> dict:
    """Phase 31.  Returns K9's entry for the ``kernels`` line."""
    t_phase = time.perf_counter()
    rxp, rcfg = coded["rxp"], coded["rcfg"]
    check(not rxp.tab.table_mode, "the coded receiver of phase 6 has the closed-form tables")
    steps, times = {}, {}
    for snr, (stream, _) in coded["streams"].items():
        # the main path: one coded step, the counts set to 0 just before it and read just after
        LLR.keep, LLR.last = True, None
        trace.reset()
        trace.enable()
        reset_counts()
        try:
            out = rx_step(rxp, stream, B_FEC)
            torch.cuda.synchronize()
        finally:
            trace.disable()
            LLR.keep = False
        n_k9 = llr_cuda.frame_llrs_cuda.LAUNCHES
        frames = trace.export()["counters"].get("rx.demap.llr_kernel_frames")
        trace.reset()
        check(n_k9 == 1, f"the coded step at {snr:g} dB launched K9 {n_k9} times, not once")
        check(frames == B_FEC, f"the coded step at {snr:g} dB counted {frames} K9 frames, not {B_FEC}")
        check(LLR.last is not None and LLR.last[0] is rxp, f"the coded step at {snr:g} dB made no frame_llrs call")
        _, soft, cnst, nv, used = LLR.last
        LLR.last = None
        plain = receiver._frame_llrs_torch(rxp, soft, cnst, nv)
        direct = llr_cuda.frame_llrs_cuda(soft, cnst.int(), nv, rxp.tab.bps, rxp.fec.max_frame_bits)
        check(torch.equal(used, plain), f"the coded step at {snr:g} dB: K9's LLRs differ from the plain chain's")
        check(torch.equal(direct, plain), f"K9 called on the step's inputs at {snr:g} dB differs from the plain chain")
        ids = {int(k): int(v) for k, v in zip(*torch.unique(cnst.cpu(), return_counts=True))}
        steps[snr] = {"launches": n_k9, "frames_counted": frames, "frames": soft.shape[0], "symbols": soft.shape[1],
                      "max_frame_bits": rxp.fec.max_frame_bits, "ids": ids, "crc_ok": int(out.crc_ok.sum())}
        print(f"[k9] coded step at {snr:g} dB, B={B_FEC}: K9 launches {n_k9}, rx.demap.llr_kernel_frames {frames}; "
              f"frame_llrs' inputs as the step handed them: soft {tuple(soft.shape)} {soft.dtype}, cnst {cnst.dtype} "
              f"(frames by id {ids}), noise_var {nv.dtype}; the step's LLRs [{used.shape[0]}, {used.shape[1]}] and "
              f"K9 called directly torch.equal to _frame_llrs_torch on the same card tensors ({card})", flush=True)
        times[snr] = bench_llr.timed(f"the coded step's inputs at {snr:g} dB", llr_ring((rxp, soft, cnst, nv)),
                                     rxp, "the step's")
        del soft, cnst, nv, used, plain, direct, out
    cell = bench_llr.measure("the coded cell's shape, b32k/qpsk", *bench_llr.SHAPES["b32k/qpsk"], dev)

    print("[k9] K9 a phase (closed-form calls / K9 launches / frames / table-mode calls): "
          + ", ".join(f"{k} {c} / {n} / {f} / {t}" for k, (c, n, f, t) in LLR.by_tag.items()), flush=True)
    for tag in ("6-7 coded batch", "31 K9"):
        check(LLR.by_tag.get(tag, [0, 0, 0, 0])[1] > 0, f"phase {tag} launched no K9")
    calls = sum(r[0] for r in LLR.by_tag.values())
    launches = sum(r[1] for r in LLR.by_tag.values())
    check(launches == calls, f"the paths made {calls} closed-form frame_llrs calls and {launches} K9 launches")
    print(f"[k9] phase took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    main = times[11.0]
    return {"name": "soft_demap", "route": "cuda", "source": "gr_dtl_tpu_torch/csrc/soft_demap.cu",
            # no TPU kernel: the JAX package leaves the LLRs and their serialisation to XLA
            "replaces": "gr_dtl_tpu_torch/models/receiver.py::_frame_llrs_torch",
            "launches": sum(v["launches"] for v in steps.values()),
            # a step: a coded receive step at B=1024 (its one frame_llrs call)
            "launches_per_step": sum(v["launches"] for v in steps.values()) / len(steps),
            "max_abs_err": 0.0, "rows_compared": sum(v["frames"] for v in steps.values()),
            "ms": median(main["kernel_events_ms"]), "ms_by": "events", "device_ms": main["kernel_device_ms"],
            "plain_ms": median(main["plain_events_ms"]), "bound_ms": main["floor_ms"], "bound_by": "bytes",
            "library_ms": None, "at": f"the coded step's {B_FEC} QPSK frames at 11 dB",
            "ledger_calls": calls, "ledger_launches": launches, "steps": steps, "ms_at": times, "cell_shape": cell}


class CwLedger:
    """K10's launches on the paths.  Once installed, every codeword
    extraction (``fec_chain._extract``) on a CUDA tensor must launch K10
    once, counted from ``cw_cuda.codewords_cuda.LAUNCHES`` just before and
    just after the call, and is booked under the phase running
    (``BP.tag``): [calls, K10 launches, groups].  While ``keep`` is set,
    each call's arguments and output are kept in ``kept``."""

    def __init__(self):
        self.by_tag, self.keep, self.kept = {}, False, []

    def install(self) -> None:
        fn = fec_chain._extract

        def call(fec, llrs, bps, s):
            n0 = cw_cuda.codewords_cuda.LAUNCHES
            out = fn(fec, llrs, bps, s)
            if llrs.is_cuda:
                got = cw_cuda.codewords_cuda.LAUNCHES - n0
                check(got == 1, f"[{BP.tag}] codeword extraction: {got} K10 launches, expected 1")
                row = self.by_tag.setdefault(BP.tag, [0, 0, 0])
                row[0], row[1], row[2] = row[0] + 1, row[1] + got, row[2] + out.shape[0]
                if self.keep:
                    self.kept.append((fec, llrs, bps, s, out))
            return out

        fec_chain._extract = call


CW = CwLedger()


def k10_held(what: str, decode, G: int, card: str) -> dict:
    """One decode call (``decode()``) with the counts set to 0 just before
    it and read just after: one K10 launch, ``fec.decode.cw_kernel_groups``
    G, and the codewords K10 wrote bit-equal to ``_extract_torch`` on the
    same card tensors.  Returns what was seen."""
    CW.keep, CW.kept = True, []
    trace.reset()
    trace.enable()
    reset_counts()
    try:
        out = decode()
        torch.cuda.synchronize()
    finally:
        trace.disable()
        CW.keep = False
    n = cw_cuda.codewords_cuda.LAUNCHES
    groups = trace.export()["counters"].get("fec.decode.cw_kernel_groups")
    trace.reset()
    check(n == 1 and len(CW.kept) == 1, f"{what}: {n} K10 launches in {len(CW.kept)} extractions, not one")
    check(groups == G, f"{what}: fec.decode.cw_kernel_groups {groups}, not {G}")
    fec, llrs, bps, s, used = CW.kept.pop()
    plain = fec_chain._extract_torch(fec, llrs, bps, s)
    torch.cuda.synchronize()
    check(used.shape == plain.shape and torch.equal(used.view(torch.int32), plain.view(torch.int32)),
          f"{what}: K10's codewords differ from the plain chain's")
    ids = {int(k): int(v) for k, v in zip(*torch.unique(bps.cpu(), return_counts=True))}
    print(f"[k10] {what}: K10 launches {n}, fec.decode.cw_kernel_groups {groups}; the codewords "
          f"{tuple(used.shape)} from rows {tuple(llrs.shape)} (W = {fec.W}, groups by bits a symbol {ids}) "
          f"bit-equal to _extract_torch on the same card tensors ({card})", flush=True)
    return {"launches": n, "groups_counted": groups, "groups": G, "W": fec.W, "rows": llrs.shape[0],
            "bps": ids, "crc_ok": int(out.crc_ok.sum())}


def k10_phase(dev, card, coded: dict) -> dict:
    """Phase 32.  Returns K10's entry for the ``kernels`` line."""
    t_phase = time.perf_counter()
    rxp = coded["rxp"]
    steps = {}
    for snr, (stream, _) in coded["streams"].items():
        steps[f"coded step at {snr:g} dB"] = k10_held(f"the coded step at {snr:g} dB, B={B_FEC}",
                                                      lambda: rx_step(rxp, stream, B_FEC), B_FEC, card)
    # the stream cell's block: decode_emitted over 32,768 rows of 2 frames on the ladder
    G = bench_cw.SHAPES["stream/ladder"][0]
    fec2 = bench_cw.fec_params(2, str(dev))
    llrs, cnst = bench_cw.inputs(G, 2, "ladder", SEED + 32, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    c = cnst[::2]
    emitted = {"llrs": llrs.reshape(G, 2, -1), "cnst": c, "plen": fec2.tb_payload_t[1, cn.active(dev).bps[c.long()]],
               "fec_id": torch.ones_like(c), "tb_no": torch.arange(G, dtype=torch.int32, device=dev),
               "valid": torch.rand(G, generator=gen, device=dev) < 0.5}
    steps["stream block"] = k10_held(f"decode_emitted over the stream cell's block, {G} rows",
                                     lambda: fec_chain.decode_emitted(fec2, emitted), G, card)
    del emitted, llrs, cnst
    # the batch cell's step: fec_frame_decode over 32,768 QPSK frames
    fec1 = bench_cw.fec_params(1, str(dev))
    llrs, cnst = bench_cw.inputs(G, 1, "qpsk", SEED + 33, dev)
    steps["batch step"] = k10_held(f"fec_frame_decode over the batch cell's {G} QPSK frames",
                                   lambda: fec_chain.fec_frame_decode(fec1, llrs, cnst), G, card)
    del llrs, cnst
    times = {name: bench_cw.measure(f"the {name} shape", *bench_cw.SHAPES[name], dev)
             for name in ("stream/ladder", "batch/qpsk")}

    print("[k10] K10 a phase (extractions / K10 launches / groups): "
          + ", ".join(f"{k} {c} / {n} / {g}" for k, (c, n, g) in CW.by_tag.items()), flush=True)
    for tag in ("6-7 coded batch", "32 K10"):
        check(CW.by_tag.get(tag, [0, 0, 0])[1] > 0, f"phase {tag} launched no K10")
    calls = sum(r[0] for r in CW.by_tag.values())
    launches = sum(r[1] for r in CW.by_tag.values())
    check(launches == calls, f"the paths made {calls} codeword extractions on the card and {launches} K10 launches")
    print(f"[k10] phase took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    main = times["stream/ladder"]
    return {"name": "codewords", "route": "cuda", "source": "gr_dtl_tpu_torch/csrc/codewords.cu",
            # no TPU kernel: the JAX package leaves the codeword gather to XLA
            "replaces": "gr_dtl_tpu_torch/models/fec_chain.py::_extract_torch",
            "launches": sum(v["launches"] for v in steps.values()),
            # a step: one decode call (its one extraction)
            "launches_per_step": sum(v["launches"] for v in steps.values()) / len(steps),
            "max_abs_err": 0.0, "groups_compared": sum(v["groups"] for v in steps.values()),
            "ms": median(main["kernel_events_ms"]), "ms_by": "events", "device_ms": main["kernel_device_ms"],
            "plain_ms": median(main["plain_events_ms"]), "bound_ms": main["floor_ms"], "bound_by": "bytes",
            "library_ms": None, "at": f"the stream cell's block, {G} groups of 2 frames on the ladder",
            "ledger_calls": calls, "ledger_launches": launches, "steps": steps, "ms_at": times}


def meshmod_cpu():
    """A 1 x 1 grid on the CPU (collectives of size 1 launch nothing)."""
    from gr_dtl_tpu_torch.parallel import mesh as meshmod
    return meshmod.make_mesh(1, 1, device="cpu")


def decoded_all(results) -> tuple:
    """A StreamRx run's leaves and masks over every slot, in frame order."""
    cat = lambda k: torch.cat([getattr(o, k) for o, _ in results])
    masks = {"valid": np.concatenate([np.asarray(v) for _, v in results]),
             "header_ok": np.concatenate([v.header_ok for _, v in results]),
             "crc_ok": np.concatenate([v.crc_ok for _, v in results])}
    return {k: cat(k) for k in ("frame_no", "payload", "payload_len", "cnst_id", "header_ok", "crc_ok")}, masks


if __name__ == "__main__":
    sys.exit(main())
