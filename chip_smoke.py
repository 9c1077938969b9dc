#!/usr/bin/env python3
"""Run the PyTorch + CUDA port's main paths on one NVIDIA GPU, end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --only wis       # phases 1, 2 (K1, K2) and 2e alone
    python3 chip_smoke.py --only service   # phases 1 and 6 alone
    python3 chip_smoke.py --only train     # phases 1 and 7 alone
    python3 chip_smoke.py --only serve     # phases 1, 2c, 2d, 4 and 5 alone
    python3 chip_smoke.py --only models    # phases 1, 2d and 8 alone
    python3 chip_smoke.py --only xattn     # phases 1, 2d and 9 alone
    python3 chip_smoke.py --only mesh      # phases 1, 2 (K1, K2), 3 and 10 alone
    python3 chip_smoke.py --only shard     # phases 1, 2d and 11 alone
    python3 chip_smoke.py --only examples  # phases 1 and 12, the full study

Phases (any failure exits non-zero and prints no result):

1. the card's name and power limit, and the build of every hand-written
   kernel (``src/repro_torch/kernels/csrc/*.cu``, one nvcc per source, in
   parallel) with its ptxas report;
2. each kernel against its plain torch version on the card, on seeded
   inputs at the main path's shapes: the Eq. 4 score + FMP safety kernel
   (K1) at M = 32768, T = 32, and at M in {256, 1000} x T in {1, 7, 33,
   64}, where the block's rows x grid points do not divide evenly; the
   batched WIS settle kernel (K2) at W = 64 windows, L = 2048 lanes, the
   re-clear shape (8, 2048), L = 1000 with an all-masked row, a row set
   with zero-length intervals (taken lanes whose pred lies past them: the
   bounded-walk backtrack), one L whose row needs more than 48 KB of
   shared memory and one past the shared-memory limit (global scratch),
   fused with and without a transform; in each case the kernel reports,
   per row, whether it backtracked by pointer doubling or by the walk,
   and those rows must be the ones the reference predicts.  Scores and
   totals must be bit-equal, eligibility and selections exactly equal.
   Each kernel is timed with CUDA events beside its plain version and its
   bound, raw launches back to back; K1 and K2, whose kernels take about
   what the host needs to launch one from Python, are also timed as
   launches replayed in one CUDA graph, printed beside.  K1 must take at
   most 0.011 ms at M = 32768, T = 32 and K2 at most 0.06 ms at (64, 2048)
   fused, launched one by one;
2c. the linear-scan kernel (K5) against its plain version at the mamba
   prefill's shapes, (1, T, 131072) float32 for T in {1, 37, 512, 1024},
   with and without h0, the RG-LRU width (1, 512, 4096) and one bfloat16
   case (2, 256, 8192).  Outputs and final states must be bit-equal;
2d. the flash-attention kernel (K4) against its plain version within
   2e-5 (float32) / 2e-2 (bfloat16), atol and rtol: recurrentgemma's local
   attention (1, 16, S, 256) on one kv head, window 2048, bfloat16, at
   S = 1024, 2500 and 4096; qwen3-14b's GQA widths (1, 40, 4096, 128) on 8
   kv heads; Sq = 128 against Sk = 384 (q_offset 256) and one non-causal
   case, each in float32 and in bfloat16; olmoe-1b-7b's 2048-token prefill
   (1, 16, 2048, 128) MHA, granite-moe-3b-a800m's (1, 24, 2048, 64) on
   8 kv heads, qwen1.5-4b's (1, 20, 2048, 128) MHA, starcoder2-15b's
   (1, 48, 2048, 128) on 4 and llama3-405b's (1, 128, 2048, 128) on 8, and
   phase 8's served shapes, whose keys run to max_seq past the prompt
   (starcoder2 Sk 2064, granite Sk 2112, qwen3-14b 4096 on Sk 4224), causal,
   bfloat16; and phase 9's shapes, bfloat16: whisper-small's encoder
   (4, 12, 1500, 64) MHA non-causal, its cross attention (4, 12, 224, 64)
   on Sk 1500 non-causal and its decoder's self attention (4, 12, 224, 64)
   on the 448-row cache, causal; llama-3.2-vision's cross attention
   (2, 64, 2048, 128) on 8 kv heads against 1600 patches, non-causal, and
   its self attention on the 2112-row cache, causal (the last key tile is
   partial in every non-causal case).  Each case prints the kernel it
   ran (``flash_attention_path``: the tensor cores for bfloat16 at D >= 64,
   else the CUDA cores), and the tensor-core cases are also held against
   ``mha_tiled_reference`` within 1e-2.  Each is timed beside its plain
   version, the CUDA-core kernel on the same bfloat16 input, one
   ``scaled_dot_product_attention`` call (a yardstick the port never calls)
   and its bound; the tensor-core kernel must take at most 0.6 ms at
   (1, 16, 4096, 256), 1.2 ms at (1, 40, 4096, 128), beat SDPA at S = 2500
   and 4096, and be 4x faster than the CUDA-core kernel on every bfloat16
   case;
2e. the single-window WIS kernel (K3) against its plain version at M in
   {1, 2, 3, 5, 7, 2048, 16384, 65536, 300000, 450000}: one block with
   dp in its shared memory up to ~55k lanes, a thread-block cluster at
   65536 (2 blocks) and 300000 (6), dp in global scratch at 450000
   (``wis_dp_plan`` names the branch; each must run), one window of
   zero-length intervals and -0, negative, ±inf and NaN weights, and
   M = 16384 forced onto each branch through the C entry
   ``wis_dp_launch_on``: dp bit-equal, take equal.  K3 is timed at
   M = 2048, 16384 and 65536 and on each forced branch, with CUDA events
   over raw launches and a CUDA-graph replay beside, and logged beside its
   chain floor (derived: M x 4 cycles at the SM clock nvidia-smi reports,
   not in the kernels line); at M = 2048 it must take at most 1.25x K2's
   re-clear (8, 2048) of the same run.  Then ``wis_clear`` on the card
   (its K3 launches counted) must return ``core.wis.wis_select``'s
   selection and total;
3. the auction path: ``simulate`` of a 16-GPU H100 cluster cut into 64 MIG
   slices (3g.40gb + 2g.20gb + 1g.10gb + 1g.10gb per GPU) against a
   backlog of 500 jobs, through the CUDA kernels pipelined and serial, and
   over its first four rounds (to t = 3, M bucket 32768 among them)
   through the plain torch versions on the card and the kernels again.  Launch counters are reset just before
   the pipelined run and read just after; commit logs and summaries must
   be identical between the runs of one horizon, no backend may be marked
   failed, and a small seeded run on the card must match the same run on
   the host;
4. the serving path: falcon-mamba-7b at full width (64 layers, d_model
   4096, bfloat16, vocab 65,024), initialised on the card from a seed,
   serves 8 seeded greedy requests of 128-1024 prompt tokens and 32 new
   tokens through ``ServingEngine`` (4 slots, max_seq 2048; its decode
   step a CUDA graph, as on every engine on the card), once through
   K5 and once through the plain scan on the card.  Every request must
   finish, the tokens of the two runs must be identical, so must each
   prefill's last logits and the cache states it hands to its slot (bit
   for bit), and K5's counter (reset just before the kernel run) must read
   64 layers x 8 prefills.  The same traffic is then served once more
   under torch.profiler, its device time split into prefill and decode
   and grouped by kernel name.  The reduced config's logits on the card
   must match the host's;
5. recurrentgemma-9b at full width (38 layers: 12 local attention, 26
   RG-LRU; bfloat16), initialised on the card from a seed, serves 8 greedy
   requests (prompts of 4096, 3072, 2500 and 2048 tokens and 4 seeded in
   128-2047; 16 new tokens; 4 slots, max_seq 4224) once with its prefill
   attention through K4 (``attn_impl="pallas"``) and once through
   ``"auto"``.  K4 must launch 12 x 8 times on 8 shapes and K5 26 x 8 times
   in each run; where the auto run's top-1 margin exceeds twice the largest
   gap between the two runs' prefill logits, the first token must agree.
   The K4 traffic is served once more under torch.profiler, as in phase 4;
   the 4096-token prefill through K4 must beat auto's in the serving runs
   and again as medians of three prefills of each, timed in turns; K4 must
   take under 5% of prefill device time.  Then ``python -m
   repro_torch.launch.serve --arch recurrentgemma_9b --attn-impl pallas``
   serves its 8 default requests on the card.
   The reduced config (float32) on the card through K4 and K5 must match
   the host within 1e-4 over a prefill and 8 decode steps;
6. the streaming auction service (``repro_torch.service.JasdaService``)
   through K1 and K2 (``score_impl = wis_impl = "cuda"``): 6a soaks phase
   3's 64-slice cluster under Poisson arrivals (rate 8, work 8-40, 30%
   QoS jobs with deadline slack 2-6, AcceptAll) to t = 200, cuda pipelined
   (launch counters reset just before, read just after; K1's M buckets
   and K2's (W, L) shapes printed), cuda serial and host float64 numpy:
   award logs and ``ServiceStats`` must be identical; 6b runs the same
   soak with a ``CheckpointStore`` (a snapshot every 50 rounds) to
   t = 100, restores the service from the store and runs it on to 200:
   it must equal 6a; 6c repartitions a 64-chip pod of eight 8-chip 80 GB
   slices (``FragmentationAware``, the migration ladder) under the same
   arrivals to t = 120, cuda pipelined against the plain torch versions on
   the host, serial: identical, with at least one split; host float64
   numpy must agree with them up to t = 98, where two bids' float32
   scores tie and their float64 scores do not (the reference's own f32
   and f64 backends part there too); 6d replays phase 3's simulation
   through a scheduler crash at t = 10.5, restored from the store: its
   commit log and summary must equal phase 3's; 6e runs ``repro_torch.launch.serve_auction
   --json --t-end 60`` on cuda and on cpu: both exit 0 with the same
   line.  No soak may mark a backend failed;
7. training falcon-mamba-7b under the JASDA executor: 7a holds K5's
   backward (``linear_scan_bwd_kernel``) bit-equal to its plain reverse
   loop (da, db, dh0) at the training shape (4, 512, 131072) float32 with
   and without h0 (and a cotangent on h_T), (1, 37, 131072), the RG-LRU
   width (1, 512, 4096) and bfloat16 (2, 256, 8192), timed beside its
   plain version and its bound; 7b takes one train step of full-width
   falcon-mamba-7b cut to 32 of its 64 layers (bfloat16, batch 4 x 512,
   AdamW, remat, clip 1.0) through K5 and, from the same params and
   batch, the same loss and gradient norm through the plain scan: within
   1e-3 relative, with 2 x 32 forward and 32 backward K5 launches; 7c
   trains 8 steps of it under ``JasdaExecutor`` through
   ``repro_torch.launch.train.train`` (every step once, in order, in
   contiguous chunks, finite losses, the last below the first; step
   times, tokens/s and the peak memory printed) and profiles one more
   step by kernel name; 7d runs ``python -m repro_torch.launch.train
   --arch falcon_mamba_7b --reduced --steps 20`` on cuda and on cpu in
   subprocesses: both exit 0 and their losses agree within 1e-4;
8. the MoE family and the dense configs, each initialised on the card from
   a seed in bfloat16 and served through ``ServingEngine`` (4 slots) once
   with prefill attention through K4 and once through ``"auto"``: every
   request must finish, K4 must launch once a layer and prefill (never
   through auto), and where auto's top-1 margin exceeds twice the largest
   gap between the two runs' prefill logits the first token must agree.
   8a olmoe-1b-7b and 8b granite-moe-3b-a800m at full width and depth
   serve 8 greedy requests (prompts of 2048, 1536, 1024, 512 tokens and 4
   seeded in 64-512; 16 new tokens; max_seq 2112); the (token, choice)
   pairs dropped by capacity in the 2048-token prefill are counted in
   both runs and printed, not gated (bf16 attention outputs part on
   router near-ties, so the runs route many choices apart); the K4
   traffic is served once more (olmoe's under torch.profiler) and must
   drop exactly as many as its first run; 8c qwen3-14b at full width and
   depth (prompts of
   4096, 3072, 2048, 1024 and 4 seeded in 128-2047; max_seq 4224), its
   4096-token prefill timed again through K4 and auto as medians of three
   in turns (printed, not gated); 8d qwen1.5-4b and starcoder2-15b at full
   width and depth and llama3-405b at full width with 8 of its 126 layers
   (59 GB in bfloat16) run one 2048-token prefill and 8 decode steps; 8e
   the six configs reduced (float32) on the card through K4 must match the
   host within 1e-4 over a prefill and 8 decode steps, the MoE configs
   with the card's routing replayed on the host (the combine rounds the
   gates to bfloat16, so a last-bit difference can move one by a bfloat16
   step), and the card's routing held to the host's own choices on the
   same inputs: slots equal to a plain count, other experts only on
   near-ties, gates within 1e-6 (the gap under the host's own routing is
   printed, not gated); 8f ``python -m
   repro_torch.launch.serve --arch olmoe_1b_7b --attn-impl pallas`` serves
   its 8 default requests on the card.  Each model is freed before the
   next is drawn, and the peak memory printed;
9. the cross-attention families, each initialised on the card from a seed
   in bfloat16, with the leaves the reference draws as zeros (LayerNorm
   scales and biases, qkv and MLP biases, the VLM's tanh gates) drawn
   from the seed too: with zeros whisper's logits are identically zero
   and the VLM's cross attention reaches nothing.  Each runs
   ``Model.prefill(memory=)`` over a seeded N(0, 1) float32 memory, then
   greedy ``decode_step(cross_stack=)``, once with prefill attention
   through K4 (``impl="pallas"``) and once through ``"auto"``.  9a
   whisper-small at full width and depth (12 + 12 layers), a batch of 4
   each with its own 1500-frame memory: 4-token prompts and 64 new tokens,
   then 224-token prompts and 16 new tokens, max_seq 448; 9b
   llama-3.2-vision-90b at full width with 20 of its 100 layers (16 self,
   4 cross; 38.5 GB in bfloat16), a batch of 2 each with its own
   1600-patch memory, 2048-token prompts, 16 new tokens, max_seq 2112.
   Gated: every row yields its tokens, all below the vocab, and the logits
   are finite; K4 launches once an attention layer in a prefill (36 for
   whisper: 12 encoder, 12 self, 12 cross; 20 for the VLM), never in a
   decode step or through auto; ``cross_kv`` runs once a prefill and its
   stack is (L_cross, B, T, Hkv, hd); where auto's top-1 margin exceeds
   twice the largest gap between the two runs' prefill logits, the first
   token agrees.  Printed: prefill ms through K4 and auto, the median
   decode ms, the peak memory, the reference's ``param_count`` beside the
   leaf count, and K4's share of a profiled prefill's device time.  9c the
   two configs reduced (float32) on the card through K4 must match the
   host within 1e-4 over a prefill and 8 decode steps; 9d ``python -m
   repro_torch.launch.train --arch whisper_small --reduced --steps 20``
   on cuda and on cpu: both exit 0, losses within 1e-4;
10. the auction mesh (``repro_torch.launch.mesh``): the round's device
   work split into row shards launched from this one process, held to
   phase 3.  10a ``make_auction_mesh()`` on the one card is degenerate
   (one device): phase 3's simulation under it gives phase 3's commit log,
   summary and launches at phase 3's shapes; a hand-built 3-shard mesh
   divides no pow2 bucket and falls back to the unsharded launches on a
   700-bid round.  10b four virtual shards of the card (``devices=[card]
   * 4``) run phase 3's simulation cuda pipelined and serial: commit logs
   and summaries equal phase 3's, K1 launches 4x phase 3's at M / 4 rows
   and K2 4x at W / 4 windows, a dispatch whose rows 4 does not divide
   counted apart as one unsharded launch (the totals must match that
   account shape for shape); both walls are printed beside phase 3's,
   not gated.  10c K1 at M = 2^20, T = 32 and K2 fused at (64, 2048),
   with and without a transform, and batched at (8, 2048): the 4-shard
   dispatch bit-equal to one launch and to the plain version, each timed
   beside one launch (CUDA events).  10d a 2^17-bid round over 24 windows
   and a second of 2^17 - 4097 bids in the same bucket, ``clear_round``
   through K1 and K2 on 4 shards and on one launch: identical selections,
   no build between them; phase 3's small run through the torch backend
   on 4 shards equals its cuda run.  10e every kernel source was built
   once in the process (also checked after phase 3's 21 drifting rounds
   and at the end).  10f pickling a meshed scheduler, or saving it in a
   ``CheckpointStore``, raises ``ValueError``;
11. the model half of sharding and the dry-run tools.  11a builds
   ``ShardingRules`` with the dry run's ``build_rules`` on a (data=2,
   model=2) mesh of four virtual shards of the card, and runs full-width
   qwen1.5-4b (headdim: the Ulysses branch) and olmoe-1b-7b (heads, the
   expert-sharded MoE) through one 2048-token prefill through K4 and 4
   decode steps, with the rules and without: logits and caches bit-equal,
   K4 launched once a layer in each prefill at shapes 2d holds, and every
   model-sharded param dim divides the model axis (16).  11b runs ``python
   -m repro_torch.launch.dryrun`` for every arch and shape on the
   single-pod mesh (one process an arch, all started together, under a
   wall limit) and ``python -m repro_torch.launch.report`` over the rows,
   printing its tables: no cell errs, long_500k is skipped where the
   reference skips it, flops_per_device x chips equals ``analytic_cost``
   and the meta run's FLOP count falls in ``flop_counter_band``.  11c
   prints the MFU (model FLOPs over the time at 989 TFLOP/s) and the share
   of the analytic bound (``launch/roofline.py``'s H100 constants) of
   phase 8c's qwen3-14b 4096-token K4 prefill and phase 7c's falcon-mamba-7b
   train step: each share at most 1.05 (skipped under ``--only shard``);
12. the examples, through their own entry points (``examples/*_torch.py``).
   12a the cluster study's four sections (JASDA against the baselines,
   steady and with slice failures; the four policy presets; the mixed
   bidder population) cut to t_end 300 (failures 450), JASDA through K1
   and K2 on the card and through the plain torch versions on the host in
   the same process: every table equal, K1 and K2 launched in every JASDA
   simulation (counts set to 0 before each section), none in a baseline,
   K1's pools at least 256 rows and K2's settles at least 8 windows, no
   backend marked failed; 12b batched serving (10 requests, 4 slots, the
   float32 serve-demo decoder) through K4 and through auto, in turns,
   twice: the same tokens (a pick may part only at a near-tie, where
   auto's top-1 margin is at most twice the runs' logit gap), K4 4 times
   a prefill and 40 a run, never in decode or through auto, and K4 within
   7.2e-7 of its plain version on the served prefills' inputs; 12c the
   100M-parameter LM at full width, 40 steps under the executor into a
   new directory (a non-blocking save at every chunk boundary, each timed),
   then a second run on it to step 56: it resumes from step 40, the store
   gives back the first run's final state bit for bit, and the loss falls
   in both runs; ms a step, tokens/s, the peak memory and each save's time
   printed, then three more steps timed one by one and one profiled.  Under
   ``--only examples`` the study then runs at its own length through K1
   and K2, its tables printed.

Every phase prints its wall time.

The line before the last is a JSON object with every kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA card; runs
nothing on the host in its place.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth,
# float32 outside the tensor cores, bfloat16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

GB = 1 << 30
MIG_PROFILES = (("3g.40gb", 40, 3), ("2g.20gb", 20, 2),
                ("1g.10gb-a", 10, 1), ("1g.10gb-b", 10, 1))


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


@contextlib.contextmanager
def collector_off():
    """Collect, then keep Python's cyclic collector off while two paths are
    timed against each other, as ``timeit`` does.  A generation-2 pass walks
    the whole heap the earlier phases keep (phase 3's run among it), so it
    stalls whichever path happens to be running: neither path's cost.  The
    entry collect's time is printed: it is what such a pass costs."""
    t0 = time.perf_counter()
    n = gc.collect()
    log(f"  collector off for the timed runs; the collect before them freed "
        f"{n} objects in {1e3 * (time.perf_counter() - t0):.1f} ms")
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


def release_profiler() -> None:
    """Free a finished ``torch.profiler`` run now.  The ``profile`` object
    sits in a reference cycle, so what it recorded waits for a generation-2
    collection, which takes seconds, and the first model call after that
    freeing runs slow: left to chance, both land on some later timing.
    Call it once the caller holds no reference to the profiler; the
    freeing's time is printed, and the next model call pays the rest."""
    t0 = time.perf_counter()
    n = gc.collect()
    log(f"  profiler results freed: {n} objects in "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> tuple:
    """(current, maximum) SM clock in MHz as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    cur, top = out.stdout.strip().splitlines()[0].split(",")
    return int(cur), int(top)


def time_ms(torch, fn, *, reps: int, inner: int) -> float:
    """Median per-call device time (ms) of ``fn`` from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def time_graph_ms(torch, launch, *, reps: int, inner: int) -> float:
    """Median per-launch device time (ms) of ``inner`` launches replayed as
    one CUDA graph: ``launch(stream)`` enqueues one kernel on the stream it
    is given.  Back-to-back launches from Python take the host several
    microseconds each, which floors :func:`time_ms` for a kernel that short;
    a graph replays them with no gap between kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        launch(side.cuda_stream)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(inner):
            launch(stream)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def ptxas_report(log_text: str):
    """(kernel, registers and spills) for each entry function in a ptxas -v
    log; the kernel is its name and template arguments, read from the
    mangled name (``flash_attention_tc_kernel<Li256>``)."""
    import re

    out, fn, spill = [], None, ""
    for line in log_text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            m = re.search(r"([a-z_]+_kernel)I(.+?)EE", entry.group(1))
            fn = f"{m.group(1)}<{m.group(2)}>" if m else entry.group(1)[-60:]
        elif "spill" in line:
            spill = line.split(":")[-1].strip() if ":" in line else line.strip()
        elif "registers" in line and fn is not None:
            out.append((fn, f"{line.split(':', 1)[1].strip()}; {spill}"))
            fn, spill = None, ""
    return out


def ulp_gap(torch, a, b) -> int:
    """Largest distance in float32 units in the last place between a and b."""
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    # map the sign-magnitude bit patterns onto one ordered integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max().item()) if a.numel() else 0


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def score_inputs(np, torch, dev, m: int, t: int, n_pad: int = 256,
                 seed: int = SEED):
    """Round-path operands: ĥ column (Fj = 1, α = [1]), Fs = 4, T grid points,
    heterogeneous caps/θ, ~10% σ = 0 points, and a final block of n_pad
    pad rows."""
    rng = np.random.default_rng(seed)
    fj = rng.uniform(0, 1, (m, 1)).astype(np.float32)
    fs = rng.uniform(0, 1, (m, 4)).astype(np.float32)
    al = np.array([1.0], np.float32)
    be = np.array([0.4, 0.2, 0.1, 0.2], np.float32)
    cap = rng.uniform(15.0, 25.0, m).astype(np.float32)
    # per-row risk: most rows sit well under their cap, some brush it (the
    # σ = 0 points of those are deterministic violations)
    risk = rng.uniform(0.6, 1.03, (m, 1))
    mu = (cap[:, None] * risk * rng.uniform(0.7, 1.0, (m, t))).astype(np.float32)
    sg = (cap[:, None] * rng.uniform(0.0, 0.06, (m, t))).astype(np.float32)
    sg[rng.uniform(size=(m, t)) < 0.1] = 0.0
    lam = rng.uniform(0.2, 0.8, m).astype(np.float32)
    theta = rng.uniform(0.01, 0.3, m).astype(np.float32)
    pad = slice(m - n_pad, m)  # bucket padding as ops.score_variants writes it
    fj[pad] = 0.0
    fs[pad] = 0.0
    mu[pad] = 1.0
    sg[pad] = 0.0
    lam[pad] = cap[pad] = theta[pad] = 0.0
    arrays = (fj, fs, al, be, mu, sg, lam, cap, theta)
    return [torch.from_numpy(a).to(dev) for a in arrays]


#: (M, T) beside the round path's: rows x grid points that do not fill
#: K1's blocks of 128 rows, and T past its 32-point staging pass
SCORE_EXTRA = tuple((m, t) for m in (256, 1000) for t in (1, 7, 33, 64))
K1_LIMIT_MS = 0.011
K2_LIMIT_MS = 0.06


def compare_scores(torch, k1, ref, args, name: str):
    """K1 against its plain version on one input: (score, elig, ulps, err)."""
    score, elig = k1.score_variants_cuda(*args)
    p_score, p_elig, _ = ref.score_variants_reference(
        *args[:6], lam=args[6], capacity=args[7], theta=args[8])
    torch.cuda.synchronize()
    if not torch.equal(elig, p_elig):
        raise AssertionError(
            f"{name}: eligibility differs on {int((elig != p_elig).sum())} rows")
    gap = ulp_gap(torch, score, p_score)
    err = float((score - p_score).abs().max().item())
    if gap != 0:
        raise AssertionError(f"{name}: scores differ by {gap} ulps (max abs {err})")
    return score, elig, gap, err


def check_score_kernel(np, torch, dev, k1, ref):
    for n, (m_x, t_x) in enumerate(SCORE_EXTRA):
        args = score_inputs(np, torch, dev, m_x, t_x, n_pad=16, seed=SEED + 50 + n)
        _, elig, _, _ = compare_scores(torch, k1, ref, args,
                                       f"K1 M={m_x} T={t_x}")
        log(f"K1 jasda_score M={m_x} T={t_x}: scores bit-equal, eligibility "
            f"equal ({int(elig.sum())} eligible)")
    m, t = 32768, 32
    args = score_inputs(np, torch, dev, m, t)
    score, elig, gap, err = compare_scores(torch, k1, ref, args, "K1")
    if elig[m - 256:].any() or score[m - 256:].any():
        raise AssertionError("K1 pad rows are not self-masking")
    n_elig = int(elig.sum().item())
    if not (0 < n_elig < m - 256):
        raise AssertionError(f"K1 safety check did no work ({n_elig} eligible)")
    if not torch.isfinite(score).all():
        raise AssertionError("K1 produced non-finite scores")

    lib = k1._lib()
    out_s = torch.empty_like(score)
    out_e = torch.empty_like(elig)
    ptrs = [a.data_ptr() for a in args]
    stream = torch.cuda.current_stream().cuda_stream

    def raw(on=stream):  # the kernel alone: no validation or allocation per call
        lib.jasda_score_launch(*ptrs, m, 1, 4, t, out_s.data_ptr(),
                               out_e.data_ptr(), on)

    ms = time_ms(torch, raw, reps=21, inner=50)
    graph_ms = time_graph_ms(torch, raw, reps=21, inner=50)
    plain_ms = time_ms(torch, lambda: ref.score_variants_reference(
        *args[:6], lam=args[6], capacity=args[7], theta=args[8]),
        reps=5, inner=3)
    n_bytes = (m * (1 + 4 + 2 * t + 3) * 4 + (1 + 4) * 4) + m * 4 + m
    # one operation per elementwise op or transcendental call: the dots and
    # score (2 (Fj + Fs) + 4), per grid point z, its branch and log Φ (~8),
    # and the final expm1 + compare
    n_ops = m * (2 * (1 + 4) + 4 + 8 * t + 2)
    bound_s = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
    log(f"K1 jasda_score M={m} T={t}: eligible {n_elig}/{m - 256}, scores "
        f"bit-equal (0 ulps), kernel {ms:.4f} ms launched one by one "
        f"({graph_ms:.4f} ms a launch replayed in a CUDA graph), plain "
        f"{plain_ms:.3f} ms, bound "
        f"{bound_s * 1e3:.4f} ms ({n_bytes} bytes)")
    if ms > K1_LIMIT_MS:
        raise AssertionError(f"K1 takes {ms:.4f} ms at M={m} T={t}, over "
                             f"{K1_LIMIT_MS} ms")
    return score, {
        "max_abs_err": err, "ulps": gap, "ms": ms, "graph_ms": graph_ms,
        "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / F32_OPS_PER_S
        else "operations",
        "shape": {"M": m, "Fj": 1, "Fs": 4, "T": t},
    }


def settle_inputs(np, torch, dev, n_rows: int, lanes: int, m_pad: int, seed: int,
                  *, zero_rows: int = 0, masked_row=None):
    """(W, L) sorted lanes over a pool of m_pad rows: idx (−1 on ~20% pads),
    predecessors from the host's float64 stable sort, a transform.  The
    first ``zero_rows`` rows get ~30% zero-length intervals (pred past the
    lane); ``masked_row`` has every lane masked."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m_pad, (n_rows, lanes)).astype(np.int32)
    idx[rng.random((n_rows, lanes)) < 0.2] = -1
    if masked_row is not None:
        idx[masked_row] = -1
    starts = rng.integers(0, 4 * lanes, (n_rows, lanes)) / 2.0
    ends = starts + rng.integers(1, 64, (n_rows, lanes)) / 2.0
    if zero_rows:
        zero = rng.random((n_rows, lanes)) < 0.3
        zero[zero_rows:] = False
        ends = np.where(zero, starts, ends)
    order = np.argsort(ends, axis=1, kind="stable")
    e_s = np.take_along_axis(ends, order, axis=1)
    s_s = np.take_along_axis(starts, order, axis=1)
    pred = np.stack([np.searchsorted(e_s[k], s_s[k], side="right")
                     for k in range(n_rows)]).astype(np.int32)
    transform = (1.0 + rng.random(m_pad) * 0.5).astype(np.float32)
    t = {"idx": idx, "mask": idx >= 0, "pred": pred, "transform": transform}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in t.items()}


#: (W, L, form, options): the round path's first pass and a re-clear,
#: L = 1000 with an all-masked row, zero-length intervals in half the rows,
#: a row past 48 KB of shared memory and one past the limit
SETTLE_CASES = (
    (64, 2048, "fused", {}), (64, 2048, "fused+transform", {}),
    (64, 2048, "batched", {}), (8, 2048, "batched", {}),
    (64, 1000, "fused", {"masked_row": 5}),
    (64, 2048, "fused+transform", {"zero_rows": 32}),
    (64, 16384, "fused+transform", {}), (64, 32768, "fused", {}),
)


def backtrack_paths(torch, dev, k2, n_rows, lanes, sel, tot, *, w=None,
                    scores=None, t=None, transform=None):
    """The backtrack K2 took on each row, read from the kernel: one more
    launch on the same operands through ``wis_batch_launch_paths``, whose
    selections and totals must equal ``sel`` and ``tot`` (the wrapper's).
    (W,) bool, True where the row took the bounded walk."""
    def ptr(x):
        return None if x is None else x.data_ptr()

    fused = w is None
    sel2 = torch.empty_like(sel)
    tot2 = torch.empty_like(tot)
    paths = torch.full((n_rows,), 2, dtype=torch.uint8, device=dev)
    scratch = None
    if not k2.uses_shared_memory(lanes, dev):
        scratch = torch.empty((n_rows * k2.row_bytes(lanes),),
                              dtype=torch.uint8, device=dev)
    err = k2._lib().wis_batch_launch_paths(
        ptr(w), ptr(scores) if fused else None, ptr(transform) if fused else None,
        t["idx"].data_ptr() if fused else None,
        t["mask"].data_ptr() if fused else None, t["pred"].data_ptr(), n_rows,
        lanes, int(scores.shape[0]) if fused else 0, sel2.data_ptr(),
        tot2.data_ptr(), ptr(scratch), paths.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"wis_batch_launch_paths failed with CUDA error {err}")
    torch.cuda.synchronize()
    if not torch.equal(sel2, sel) or ulp_gap(torch, tot2, tot) != 0:
        raise AssertionError("K2 with its paths output differs from the wrapper")
    if int(paths.max().item()) > 1:
        raise AssertionError("K2 left a row's backtrack path unwritten")
    return paths.bool()


def check_settle_kernel(np, torch, dev, k2, ref, scores):
    m_pad = int(scores.shape[0])
    branches = set()
    paths = {"doubling": 0, "walk": 0}
    timed = {}
    for n, (n_rows, lanes, form, opts) in enumerate(SETTLE_CASES):
        t = settle_inputs(np, torch, dev, n_rows, lanes, m_pad, SEED + 1 + n,
                          **opts)
        tr = t["transform"] if form == "fused+transform" else None
        w = ref.fused_weights(scores, t["idx"], t["mask"], tr)
        if form == "batched":
            sel, tot = k2.wis_batch_cuda(t["pred"], weights=w)
        else:
            sel, tot = k2.wis_batch_cuda(t["pred"], scores=scores, idx=t["idx"],
                                         mask=t["mask"], transform=tr)
        p_sel, p_tot = ref.wis_batch_reference(w, t["pred"])
        _, p_take = ref.wis_forward_reference(w, t["pred"])
        expected = ref.climbing_rows(p_take, t["pred"])
        torch.cuda.synchronize()
        name = f"K2 W={n_rows} L={lanes} {form}" + (f" {opts}" if opts else "")
        if not torch.equal(sel, p_sel):
            raise AssertionError(f"{name}: selections differ")
        if ulp_gap(torch, tot, p_tot) != 0:
            raise AssertionError(f"{name}: totals not bit-equal")
        if not int(sel.sum().item()) or not torch.isfinite(tot).all():
            raise AssertionError(f"{name}: empty or non-finite")
        if "masked_row" in opts and (sel[opts["masked_row"]].any()
                                     or tot[opts["masked_row"]] != 0):
            raise AssertionError(f"{name}: the all-masked row selected a lane")
        walked = backtrack_paths(
            torch, dev, k2, n_rows, lanes, sel, tot, t=t, transform=tr,
            w=w if form == "batched" else None,
            scores=None if form == "batched" else scores)
        if not torch.equal(walked, expected):
            raise AssertionError(
                f"{name}: the kernel walked rows "
                f"{torch.nonzero(walked)[:, 0].tolist()}, the reference's "
                f"climbing rows are {torch.nonzero(expected)[:, 0].tolist()}")
        n_walk = int(walked.sum().item())
        if "zero_rows" in opts and not 0 < n_walk <= opts["zero_rows"]:
            raise AssertionError(f"{name}: {n_walk} rows walked, expected "
                                 f"1..{opts['zero_rows']}")
        paths["walk"] += n_walk
        paths["doubling"] += n_rows - n_walk
        row = k2.row_bytes(lanes)
        branch = ("global scratch" if not k2.uses_shared_memory(lanes, dev)
                  else "shared > 48 KB" if row > 48 * 1024 else "shared")
        branches.add(branch)
        log(f"{name}: selections and totals equal, row {row} bytes in "
            f"{branch}; backtrack read from the kernel: {n_rows - n_walk} rows "
            f"doubling, {n_walk} bounded walk (the rows the reference predicts)")
        if (n_rows, lanes, form) in ((64, 2048, "fused"), (8, 2048, "batched")) \
                and not opts:
            timed[form] = (t, w, n_rows, lanes)
    if branches != {"shared", "shared > 48 KB", "global scratch"}:
        raise AssertionError(f"K2 branches exercised: {sorted(branches)}")
    if not all(paths.values()):
        raise AssertionError(f"K2 backtrack paths exercised: {paths}")

    lib = k2._lib()
    stream = torch.cuda.current_stream().cuda_stream
    times, graphs = {}, {}
    for form, (t, w, n_rows, lanes) in timed.items():
        sel = torch.empty((n_rows, lanes), dtype=torch.bool, device=dev)
        tot = torch.empty((n_rows,), dtype=torch.float32, device=dev)
        fused = form == "fused"

        def raw(on=stream):
            lib.wis_batch_launch(None if fused else w.data_ptr(),
                                 scores.data_ptr() if fused else None, None,
                                 t["idx"].data_ptr() if fused else None,
                                 t["mask"].data_ptr() if fused else None,
                                 t["pred"].data_ptr(), n_rows, lanes,
                                 m_pad if fused else 0, sel.data_ptr(),
                                 tot.data_ptr(), None, on)

        times[form] = time_ms(torch, raw, reps=11, inner=10)
        graphs[form] = time_graph_ms(torch, raw, reps=11, inner=20)
        log(f"K2 wis_batch W={n_rows} L={lanes} {form}: kernel "
            f"{times[form]:.4f} ms launched one by one ({graphs[form]:.4f} ms "
            "a launch replayed in a CUDA graph)")

    t, _, n_rows, lanes = timed["fused"]
    ms = times["fused"]
    plain_ms = time_ms(torch, lambda: ref.wis_batch_reference(
        ref.fused_weights(scores, t["idx"], t["mask"]), t["pred"]),
        reps=3, inner=1)
    lanes_total = n_rows * lanes
    # idx + mask + pred read once, the score vector read once, sel + totals
    n_bytes = lanes_total * (4 + 1 + 4) + m_pad * 4 + lanes_total + n_rows * 4
    n_ops = lanes_total * 3  # gather-mask select, add, compare per lane
    bound_s = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
    log(f"K2 wis_batch W={n_rows} L={lanes} fused: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.2f} ms, bound {bound_s * 1e3:.5f} ms ({n_bytes} bytes)")
    if ms > K2_LIMIT_MS:
        raise AssertionError(f"K2 takes {ms:.4f} ms at W={n_rows} L={lanes} "
                             f"fused, over {K2_LIMIT_MS} ms")
    return {
        "max_abs_err": 0.0, "ulps": 0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / F32_OPS_PER_S
        else "operations",
        "shape": {"W": n_rows, "L": lanes, "M_pad": m_pad},
        "graph_ms": graphs["fused"], "reclear_ms": times["batched"],
        "reclear_graph_ms": graphs["batched"],
        "reclear_shape": {"W": 8, "L": 2048},
        "backtrack_rows": paths,
    }


def scan_inputs(torch, dev, b: int, t: int, d: int, dtype, seed: int):
    """Decays in (0.8, 1), inputs ~ N(0, 0.01), h0 ~ N(0, 1), drawn on the card."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    a = torch.rand((b, t, d), generator=g, device=dev) * 0.199 + 0.8
    x = torch.randn((b, t, d), generator=g, device=dev) * 0.1
    h0 = torch.randn((b, d), generator=g, device=dev)
    return a.to(dtype), x.to(dtype), h0.to(dtype)


def check_scan_kernel(torch, dev, k5, ref):
    """K5 bit-equal to its plain version on every shape; times and bounds."""
    d_full = 8192 * 16  # falcon-mamba d_inner * ssm_state
    cases = [(1, t, d_full, torch.float32, h0)
             for t in (1, 37, 512, 1024) for h0 in (True, False)]
    cases += [(1, 512, 4096, torch.float32, False),
              (2, 256, 8192, torch.bfloat16, False)]
    lib = k5._lib()
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for n, (b, t, d, dtype, with_h0) in enumerate(cases):
        a, x, h0 = scan_inputs(torch, dev, b, t, d, dtype, SEED + 10 + n)
        h0 = h0 if with_h0 else None
        out, h_t = k5.linear_scan_cuda(a, x, h0)
        p_out, p_h = ref.linear_scan_reference(a, x, h0)
        torch.cuda.synchronize()
        name = f"K5 linear_scan ({b}, {t}, {d}) {str(dtype)[6:]} h0={with_h0}"
        if not (torch.equal(out, p_out) and torch.equal(h_t, p_h)):
            err = float((out.float() - p_out.float()).abs().max().item())
            raise AssertionError(f"{name}: not bit-equal (max abs {err})")
        if not (torch.isfinite(out).all() and torch.isfinite(h_t).all()):
            raise AssertionError(f"{name}: non-finite output")
        h0f = None if h0 is None else h0.float().contiguous()
        o_raw, h_raw = torch.empty_like(out), torch.empty_like(h_t)
        code = k5._DTYPES[dtype]

        def raw():  # the kernel alone: no validation or allocation per call
            lib.linear_scan_launch(a.data_ptr(), x.data_ptr(),
                                   None if h0f is None else h0f.data_ptr(),
                                   b, t, d, code, o_raw.data_ptr(),
                                   h_raw.data_ptr(), stream)

        ms = time_ms(torch, raw, reps=11, inner=10)
        plain_ms = time_ms(torch, lambda: ref.linear_scan_reference(a, x, h0),
                           reps=3, inner=1)
        size = a.element_size()
        # a and b read once, h written once, h_T written once, h0 (f32) read
        n_bytes = 3 * b * t * d * size + b * d * size + (b * d * 4 if with_h0 else 0)
        n_ops = 2 * b * t * d  # one multiply and one add an element
        bound_s = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
        log(f"{name}: bit-equal, kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound_s * 1e3:.5f} ms ({n_bytes} bytes)")
        rows.append({
            "shape": [b, t, d], "dtype": str(dtype)[6:], "h0": with_h0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / F32_OPS_PER_S
            else "operations",
        })
        del a, x, h0, out, h_t, p_out, p_h, o_raw, h_raw
    torch.cuda.empty_cache()
    main = next(r for r in rows if r["shape"] == [1, 1024, d_full] and not r["h0"])
    return {"max_abs_err": 0.0, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "shape": {"B": 1, "T": 1024, "D": d_full, "dtype": "float32"},
            "cases": rows}


# ---------------------------------------------------------------------------
# Phase 2d: flash attention (K4); phase 2e: single-window WIS (K3)
# ---------------------------------------------------------------------------

#: (B, Hq, Hkv, Sq, Sk, D, dtype, causal, window, q_offset): recurrentgemma's
#: local attention at three prompt lengths (2500 does not tile), qwen3-14b's
#: GQA widths, a cache longer than the queries, a non-causal case; the
#: 2048-token prefills of olmoe-1b-7b (MHA), granite-moe-3b-a800m (D = 64
#: on 8 kv heads), qwen1.5-4b (MHA), starcoder2-15b (group 12) and
#: llama3-405b (group 16); phase 8's served shapes, whose keys run to
#: max_seq past the prompt (starcoder2, granite and qwen3's longest); and
#: phase 9's: whisper-small's encoder, cross and decoder self attention
#: (224-token and 4-token prompts), llama-3.2-vision's cross and self
#: attention; phase 11a's prefills of qwen1.5-4b and olmoe-1b-7b, whose
#: keys run 4 decode steps past the prompt
ATTN_CASES = (
    (1, 16, 1, 1024, 1024, 256, "bfloat16", True, 2048, 0),
    (1, 16, 1, 2500, 2500, 256, "bfloat16", True, 2048, 0),
    (1, 16, 1, 4096, 4096, 256, "bfloat16", True, 2048, 0),
    (1, 40, 8, 4096, 4096, 128, "bfloat16", True, None, 0),
    (2, 4, 2, 128, 384, 64, "float32", True, None, 256),
    (1, 8, 2, 1000, 1000, 128, "float32", False, None, 0),
    (2, 4, 2, 128, 384, 64, "bfloat16", True, None, 256),
    (1, 8, 2, 1000, 1000, 128, "bfloat16", False, None, 0),
    (1, 16, 16, 2048, 2048, 128, "bfloat16", True, None, 0),
    (1, 24, 8, 2048, 2048, 64, "bfloat16", True, None, 0),
    (1, 20, 20, 2048, 2048, 128, "bfloat16", True, None, 0),
    (1, 48, 4, 2048, 2048, 128, "bfloat16", True, None, 0),
    (1, 128, 8, 2048, 2048, 128, "bfloat16", True, None, 0),
    (1, 48, 4, 2048, 2064, 128, "bfloat16", True, None, 0),
    (1, 24, 8, 2048, 2112, 64, "bfloat16", True, None, 0),
    (1, 40, 8, 4096, 4224, 128, "bfloat16", True, None, 0),
    (4, 12, 12, 1500, 1500, 64, "bfloat16", False, None, 0),
    (4, 12, 12, 224, 1500, 64, "bfloat16", False, None, 0),
    (4, 12, 12, 224, 448, 64, "bfloat16", True, None, 0),
    (2, 64, 8, 2048, 1600, 128, "bfloat16", False, None, 0),
    (2, 64, 8, 2048, 2112, 128, "bfloat16", True, None, 0),
    (4, 12, 12, 4, 448, 64, "bfloat16", True, None, 0),
    (4, 12, 12, 4, 1500, 64, "bfloat16", False, None, 0),
    (1, 20, 20, 2048, 2052, 128, "bfloat16", True, None, 0),
    (1, 16, 16, 2048, 2052, 128, "bfloat16", True, None, 0),
)
ATTN_MAIN = ATTN_CASES[2]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py
#: head dims whose bfloat16 calls run on the tensor-core kernel
ATTN_TC_HEAD_DIMS = (64, 128, 256)
#: the tensor-core kernel against ref.mha_tiled_reference, which models its
#: tiles and roundings: one bfloat16 rounding of the output apart
ATTN_TILED_TOL = 1e-2
#: time limits (ms) of the tensor-core kernel: recurrentgemma's 4096-token
#: prefill shape and the GQA widths
ATTN_LIMIT_MS = {ATTN_CASES[2]: 0.6, ATTN_CASES[3]: 1.2}
#: non-causal (B, Hq, Hkv, Sq, Sk, D) whose last key tile is partial
#: (TcTile::kKeys in flash_attention.cu, ATTN_TILE_KEYS here): whisper's
#: 4-token cross attention and its encoder (1500 = 23 x 64 + 28 keys),
#: the VLM's cross attention (1600 = 12 x 128 + 64)
ATTN_PAD_CASES = ((4, 12, 12, 4, 1500, 64), (4, 12, 12, 1500, 1500, 64),
                  (2, 64, 8, 2048, 1600, 128))
ATTN_TILE_KEYS = {64: 64, 128: 128, 256: 64}
#: the tensor-core kernel must beat one SDPA call at these shapes
ATTN_BEATS_SDPA = (ATTN_CASES[1], ATTN_CASES[2])
#: ... and be this many times faster than the CUDA-core kernel on bf16 input
#: where a head has at least one 64 x 64 tile of (row, key) pairs to compute;
#: below that (whisper's 4-token decoder self attention sees 10 pairs a
#: head) both kernels take about a launch
ATTN_SPEEDUP = 4.0
ATTN_SPEEDUP_MIN_PAIRS = 64 * 64


def keys_seen(np, sq: int, sk: int, causal: bool, window, q_offset: int) -> int:
    """Sum over query rows of the keys each row sees (the unmasked pairs)."""
    qp = np.arange(sq, dtype=np.int64) + q_offset
    lo = np.maximum(0, qp - window + 1) if window is not None else np.zeros_like(qp)
    hi = np.minimum(sk, qp + 1) if causal else np.full_like(qp, sk)
    return int(np.maximum(hi - lo, 0).sum())


def sdpa_ms(torch, q, k, v, *, causal, window, q_offset, scale):
    """One PyTorch call computing the same attention, timed as a yardstick
    (never called by the port); None where PyTorch refuses the shape."""
    import torch.nn.functional as F

    sq, sk = q.shape[2], k.shape[2]
    kw = dict(scale=scale, enable_gqa=True)
    if causal and window is None and q_offset == 0 and sq == sk:
        kw["is_causal"] = True
    elif causal or window is not None:
        qp = torch.arange(sq, device=q.device)[:, None] + q_offset
        kp = torch.arange(sk, device=q.device)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kp <= qp
        if window is not None:
            mask &= kp > qp - window
        kw["attn_mask"] = mask
    try:
        return time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, **kw),
                       reps=5, inner=3)
    except RuntimeError as exc:
        log(f"  SDPA refused this shape: {exc}")
        return None


def check_attention_kernel(np, torch, dev, k4, ref):
    """K4 against its plain version within the kernel tests' tolerances, and
    the tensor-core kernel against its tiled model; times beside the plain
    version, the CUDA-core kernel (bfloat16 cases), SDPA and the bound."""
    lib = k4._lib()
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for n, case in enumerate(ATTN_CASES):
        b, hq, hkv, sq, sk, d, dt, causal, window, off = case
        dtype = getattr(torch, dt)
        code = k4._DTYPES[dtype]
        path = lib.flash_attention_path(code, d)
        if path != int(dt == "bfloat16" and d in ATTN_TC_HEAD_DIMS):
            raise AssertionError(f"flash_attention_path({dt}, {d}) = {path}: "
                                 "bf16 at D = 64, 128, 256 takes the tensor "
                                 "cores (1), the rest the CUDA cores (0)")
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 30 + n)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
        scale = 1.0 / d ** 0.5
        out = k4.mha_cuda(q, k, v, causal=causal, window=window, q_offset=off)
        want = ref.mha_reference(q, k, v, causal=causal, window=window,
                                 q_offset=off)
        torch.cuda.synchronize()
        kind = "tensor cores" if path else "CUDA cores"
        name = (f"K4 flash_attention ({b}, {hq}, {sq}, {d}) kv {hkv} Sk {sk} "
                f"{dt} causal={causal} window={window} q_offset={off} [{kind}]")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name}: non-finite output")
        err = (out.float() - want.float()).abs()
        tol = ATTN_TOL[dt]
        n_bad = int((err > tol + tol * want.float().abs()).sum().item())
        max_err = float(err.max().item())
        if n_bad:
            raise AssertionError(f"{name}: {n_bad} entries outside atol = rtol "
                                 f"= {tol} (max abs {max_err})")
        tiled_err = None
        if path:
            tiled = ref.mha_tiled_reference(q, k, v, causal=causal,
                                            window=window, q_offset=off).float()
            terr = (out.float() - tiled).abs()
            tiled_err = float(terr.max().item())
            n_bad = int((terr > ATTN_TILED_TOL * (1 + tiled.abs())).sum().item())
            if n_bad:
                raise AssertionError(
                    f"{name}: {n_bad} entries outside atol = rtol = "
                    f"{ATTN_TILED_TOL} of the tiled model (max abs {tiled_err})")
            del tiled, terr
        o_raw = torch.empty_like(q)

        def raw(on=path):  # the kernel alone: no validation or allocation per call
            lib.flash_attention_launch_on(
                on, q.data_ptr(), k.data_ptr(), v.data_ptr(), o_raw.data_ptr(), b,
                hq, hkv, sq, sk, d, code, int(causal),
                0 if window is None else window, off, scale, stream)

        ms = time_ms(torch, raw, reps=5, inner=3)
        cc_ms = time_ms(torch, lambda: raw(0), reps=3, inner=1) if path else None
        plain_ms = time_ms(torch, lambda: ref.mha_reference(
            q, k, v, causal=causal, window=window, q_offset=off), reps=3, inner=1)
        lib_ms = sdpa_ms(torch, q, k, v, causal=causal, window=window,
                         q_offset=off, scale=scale)
        seen = keys_seen(np, sq, sk, causal, window, off)
        n_ops = 4 * b * hq * d * seen
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        peak = BF16_OPS_PER_S if dt == "bfloat16" else F32_OPS_PER_S
        bound_s = max(n_bytes / HBM_BYTES_PER_S, n_ops / peak)
        lib_txt = "refused" if lib_ms is None else f"{lib_ms:.4f} ms"
        cc_txt = "" if cc_ms is None else f", CUDA-core kernel {cc_ms:.4f} ms"
        tiled_txt = ("" if tiled_err is None else f", tiled model within "
                     f"{ATTN_TILED_TOL} (max abs {tiled_err:.3g})")
        log(f"{name}: within {tol} (max abs {max_err:.3g}){tiled_txt}, kernel "
            f"{ms:.4f} ms{cc_txt}, plain {plain_ms:.3f} ms, SDPA {lib_txt}, bound "
            f"{bound_s * 1e3:.5f} ms ({100 * bound_s * 1e3 / ms:.1f}% of it; "
            f"{n_ops} flops over {seen} (row, key) pairs per head, {n_bytes} bytes)")
        rows.append({
            "shape": [b, hq, hkv, sq, sk, d], "dtype": dt, "causal": causal,
            "window": window, "q_offset": off,
            "path": "tensor_cores" if path else "cuda_cores",
            "pairs_per_head": seen,
            "max_abs_err": max_err, "max_abs_err_tiled": tiled_err,
            "ms": ms, "cuda_core_ms": cc_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / peak
            else "operations",
        })
        del q, k, v, out, want, err, o_raw
        torch.cuda.empty_cache()
    attention_gates(rows)
    padding = check_attention_padding(torch, dev, k4, ref)
    main = rows[ATTN_CASES.index(ATTN_MAIN)]
    return {k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                                 "bound_ms", "bound_by")} | {
        "shape": {"B": 1, "Hq": 16, "Hkv": 1, "S": 4096, "D": 256,
                  "dtype": "bfloat16", "window": 2048},
        "cases": rows, "padding": padding}


def check_attention_padding(torch, dev, k4, ref) -> list:
    """The tensor-core kernel's mask of a partial last key tile when not
    causal, on inputs where keys left unmasked would take the softmax:
    q ~ N(2, 1) and k ~ N(-2, 1) put every real logit near -4 sqrt(D),
    the zeros TMA fills past Sk give logit 0, and v ~ N(8, 1).  The fault
    (the plain version over K and V zero-padded to whole tiles) must miss
    the tolerance on every entry, and the kernel meet it on every entry."""
    tol = ATTN_TOL["bfloat16"]
    rows = []
    for n, (b, hq, hkv, sq, sk, d) in enumerate(ATTN_PAD_CASES):
        pad = -sk % ATTN_TILE_KEYS[d]
        name = (f"K4 flash_attention ({b}, {hq}, {sq}, {d}) kv {hkv} Sk {sk} "
                f"bfloat16 causal=False, last key tile {sk % ATTN_TILE_KEYS[d]}"
                f" of {ATTN_TILE_KEYS[d]}")
        if not pad:
            raise AssertionError(f"{name}: the last key tile is whole")
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 70 + n)
        q, k, v = ((torch.randn(shape, generator=g, device=dev) + mean)
                   .to(torch.bfloat16) for shape, mean in (
                       ((b, hq, sq, d), 2.0), ((b, hkv, sk, d), -2.0),
                       ((b, hkv, sk, d), 8.0)))
        out = k4.mha_cuda(q, k, v, causal=False).float()
        want = ref.mha_reference(q, k, v, causal=False).float()
        zeros = torch.zeros((b, hkv, pad, d), dtype=q.dtype, device=dev)
        fault = ref.mha_reference(q, torch.cat([k, zeros], 2),
                                  torch.cat([v, zeros], 2), causal=False).float()
        limit = tol + tol * want.abs()
        err, fault_err = (out - want).abs(), (fault - want).abs()
        n_bad = int((err > limit).sum().item())
        n_seen = int((fault_err > limit).sum().item())
        max_err, fault_min = float(err.max().item()), float(fault_err.min().item())
        if n_seen < want.numel():
            raise AssertionError(f"{name}: unmasked padding would pass on "
                                 f"{want.numel() - n_seen} entries; the check "
                                 "cannot see the fault")
        if n_bad:
            raise AssertionError(f"{name}: {n_bad} entries outside atol = rtol "
                                 f"= {tol} (max abs {max_err})")
        log(f"{name}: within {tol} (max abs {max_err:.3g}); unmasked padding "
            f"would miss it on every entry (least abs error {fault_min:.3g})")
        rows.append({"shape": [b, hq, hkv, sq, sk, d], "keys_in_last_tile":
                     sk % ATTN_TILE_KEYS[d], "max_abs_err": max_err,
                     "fault_min_abs_err": fault_min})
        del q, k, v, out, want, fault, zeros, err, fault_err, limit
        torch.cuda.empty_cache()
    return rows


def attention_gates(rows) -> None:
    """The tensor-core kernel's time limits: absolute at two shapes, ahead
    of SDPA at two, and ATTN_SPEEDUP x the CUDA-core kernel on bf16 with
    at least ATTN_SPEEDUP_MIN_PAIRS pairs a head."""
    by_case = dict(zip(ATTN_CASES, rows))
    missed = []
    for case, limit in ATTN_LIMIT_MS.items():
        if not by_case[case]["ms"] <= limit:
            missed.append(f"{case}: {by_case[case]['ms']:.4f} ms > {limit} ms")
    for case in ATTN_BEATS_SDPA:
        r = by_case[case]
        if r["library_ms"] is not None and not r["ms"] < r["library_ms"]:
            missed.append(f"{case}: {r['ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms")
    for case, r in by_case.items():
        if r["cuda_core_ms"] is not None and (
                r["pairs_per_head"] >= ATTN_SPEEDUP_MIN_PAIRS) and not (
                r["ms"] * ATTN_SPEEDUP <= r["cuda_core_ms"]):
            missed.append(f"{case}: {r['ms']:.4f} ms, not {ATTN_SPEEDUP}x under "
                          f"the CUDA-core kernel's {r['cuda_core_ms']:.4f} ms")
    if missed:
        raise AssertionError("K4 time limits missed: " + "; ".join(missed))
    limits = ", ".join(f"{c[3]}x{c[5]} <= {v} ms" for c, v in ATTN_LIMIT_MS.items())
    log(f"K4 time limits hold: {limits}, ahead of SDPA at S = "
        f"{[c[3] for c in ATTN_BEATS_SDPA]}, every bf16 case of >= "
        f"{ATTN_SPEEDUP_MIN_PAIRS} (row, key) pairs a head >= {ATTN_SPEEDUP}x "
        "faster than the CUDA-core kernel")


#: K3 windows held bit-equal: around its pipeline depth, the reference's
#: range (2048; 16384 past 48 KB of shared memory; 65536 in a cluster of
#: 2), a cluster of 6 (preds reaching back two blocks) and one past what a
#: cluster of 8 holds (global scratch)
DP_SIZES = (1, 2, 3, 5, 7, 2048, 16384, 65536, 300_000, 450_000)
#: K3 timed at these sizes, and each branch forced at DP_FORCED_M
DP_TIMED = (2048, 16384, 65536)
DP_FORCED_M = 16384
#: K3 at M = 2048 against K2's re-clear (8, 2048) of the same run: the same
#: forward, without the gather and the backtrack
DP_K2_RATIO = 1.25
#: cycles of the chain's loop-carried float add or max (its dependent-issue
#: latency on the SM's float32 pipe), for the chain floor
CHAIN_OP_CYCLES = 4


def dp_window(np, m: int, seed: int, *, specials: bool = False):
    """One end-sorted window: weights in [0, 1), predecessors from the
    host's searchsorted over sorted ends.  ``specials`` makes ~10% of the
    intervals zero-length (pred past the lane) and puts -0, negative, ±inf
    and NaN weights among the rest."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 1, m).astype(np.float32)
    ends = np.sort(rng.uniform(0, 100, m))
    starts = ends - rng.uniform(0.5, 20, m)
    if specials:
        starts = np.where(rng.random(m) < 0.1, ends, starts)
        pick = rng.random(m)
        for lo, v in ((0.0, -0.0), (0.02, -0.5), (0.06, np.inf),
                      (0.062, -np.inf), (0.065, np.nan)):
            w = np.where((pick >= lo) & (pick < lo + 0.02), np.float32(v), w)
        w = w.astype(np.float32)
    pred = np.searchsorted(ends, starts, side="right").astype(np.int32)
    return w, pred


def check_dp_kernel(np, torch, dev, k3, ref, k2_row):
    """K3 bit-equal to its plain version on every branch (one block, a
    cluster, global scratch), timed at DP_TIMED and on each branch forced at
    DP_FORCED_M, against K2's re-clear time; then the ``wis_clear`` entry
    point on the card against the host's float64 ``wis_select``, its
    launches counted."""
    from repro_torch.core.wis import wis_select
    from repro_torch.kernels import wis_clear
    from repro_torch.kernels.common import check_launch

    lib = k3._lib()
    stream = torch.cuda.current_stream().cuda_stream

    def forced(m, w, p, path):
        """A raw launch of K3 through its C entry ``wis_dp_launch_on`` on
        branch ``path`` (-1 as the wrapper chooses), not counted, with its
        plan and output buffers."""
        plan = k3.wis_dp_plan(m, path)
        dp = torch.empty((m,), dtype=torch.float32, device=dev)
        take = torch.empty((m,), dtype=torch.int32, device=dev)
        scratch = None if plan[0] != 2 else torch.empty(
            (m + 1,), dtype=torch.float32, device=dev)

        def raw(on=stream):
            return lib.wis_dp_launch_on(
                path, w.data_ptr(), p.data_ptr(), m, dp.data_ptr(),
                take.data_ptr(), None if scratch is None else scratch.data_ptr(),
                on)

        return plan, raw, dp, take

    def held(m, w, p, dp, take, name=""):
        # the plain version on the host: the same float32 loop, faster
        # there than one small launch a step on the card
        p_dp, p_take = ref.wis_dp_reference(w.cpu(), p.cpu())
        torch.cuda.synchronize()
        if ulp_gap(torch, dp.cpu(), p_dp) != 0 or \
                not torch.equal(take.cpu().bool(), p_take):
            raise AssertionError(f"K3 M={m}{name}: dp not bit-equal or take differs")

    paths = {}
    inputs = {}
    for n, m in enumerate(DP_SIZES):
        w_np, p_np = dp_window(np, m, SEED + 40 + n)
        w = torch.from_numpy(w_np).to(dev)
        p = torch.from_numpy(p_np).to(dev)
        dp, take = k3.wis_dp_cuda(w, p)
        held(m, w, p, dp, take)
        if not int(take.sum().item()) or not torch.isfinite(dp).all():
            raise AssertionError(f"K3 M={m}: nothing taken or non-finite dp")
        plan = k3.wis_dp_plan(m)
        paths.setdefault(k3.DP_PATHS[plan[0]], []).append(m)
        log(f"K3 wis_dp M={m}: dp bit-equal, take equal ({int(take.sum())} "
            f"taken) on the {k3.DP_PATHS[plan[0]]} branch ({plan[1]} block(s) "
            f"of {plan[2]} lanes, {plan[3]} bytes of shared memory each)")
        inputs[m] = (w, p)
    if sorted(paths) != sorted(k3.DP_PATHS):
        raise AssertionError(f"K3 branches exercised: {paths}")
    w_np, p_np = dp_window(np, 2048, SEED + 49, specials=True)
    w, p = torch.from_numpy(w_np).to(dev), torch.from_numpy(p_np).to(dev)
    held(2048, w, p, *k3.wis_dp_cuda(w, p),
         name=" (zero-length intervals, -0, ±inf, NaN)")
    log("K3 wis_dp M=2048 with zero-length intervals and -0, negative, ±inf, "
        "NaN weights: dp bit-equal, take equal")
    w, p = inputs[2048]
    held(2047, w[1:], p[1:], *k3.wis_dp_cuda(w[1:], p[1:]),
         name=" (views 4 bytes past 16-byte alignment)")
    log("K3 wis_dp M=2047 on views 4 bytes off 16-byte alignment (the "
        "wrapper copies them for the bulk copies): dp bit-equal, take equal")
    w, p = inputs[DP_FORCED_M]
    for path in range(len(k3.DP_PATHS)):
        _, raw, dp, take = forced(DP_FORCED_M, w, p, path)
        check_launch(raw(), "wis_dp_launch_on")
        held(DP_FORCED_M, w, p, dp, take, name=f" forced {k3.DP_PATHS[path]}")
    log(f"K3 wis_dp M={DP_FORCED_M} forced onto each branch: dp bit-equal, "
        "take equal")

    clock_mhz = sm_clock_mhz()
    log(f"SM clock (current, max) MHz: {clock_mhz}")

    def timed(m, path):
        w, p = inputs[m]
        plan, raw, _, _ = forced(m, w, p, path)
        ms = time_ms(torch, raw, reps=11, inner=10)
        graph_ms = time_graph_ms(torch, raw, reps=11, inner=20)
        # derived, not measured: kept in the log, out of the kernels line
        floor_ms = m * CHAIN_OP_CYCLES / (clock_mhz[1] * 1e3)
        log(f"K3 wis_dp M={m} {k3.DP_PATHS[plan[0]]} ({plan[1]} block(s)): "
            f"kernel {ms:.4f} ms launched one by one ({graph_ms:.4f} ms a "
            f"launch replayed in a CUDA graph), {ms / m * 1e6:.2f} ns a lane; "
            f"chain floor {floor_ms:.4f} ms")
        return {"ms": ms, "graph_ms": graph_ms, "branch": k3.DP_PATHS[plan[0]],
                "blocks": plan[1]}

    times = {str(m): timed(m, -1) for m in DP_TIMED}
    forced = {k3.DP_PATHS[path]: timed(DP_FORCED_M, path)
              for path in range(len(k3.DP_PATHS))}

    m = 2048
    w, p = inputs[m]
    ms = times[str(m)]["ms"]
    plain_ms = time_ms(torch, lambda: ref.wis_dp_reference(w, p), reps=3, inner=1)
    n_bytes = 4 * m * 4  # w and pred read, dp and take written
    n_ops = 2 * m  # one add and one compare a lane
    bound_s = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
    log(f"K3 wis_dp M={m}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
        f"{bound_s * 1e3:.6f} ms ({n_bytes} bytes), chain floor (derived) "
        f"{m * CHAIN_OP_CYCLES / (clock_mhz[1] * 1e3):.4f} ms "
        f"({CHAIN_OP_CYCLES} cycles a lane at {clock_mhz[1]} MHz)")
    limit = DP_K2_RATIO * k2_row["reclear_ms"]
    if ms > limit:
        raise AssertionError(f"K3 takes {ms:.4f} ms at M={m}, over {DP_K2_RATIO} "
                             f"x K2's re-clear {k2_row['reclear_ms']:.4f} ms")
    log(f"K3 at M={m} within {DP_K2_RATIO} x K2's re-clear (8, 2048): {ms:.4f} "
        f"<= {limit:.4f} ms")

    # the entry point: one window's clear as a user calls it, DP on the card
    k3.LAUNCHES["wis_dp"] = 0
    rng = np.random.default_rng(SEED + 45)
    sizes = (1, 12, 300, 2048)
    for m_pool in sizes:
        starts = rng.uniform(0, 100, m_pool)
        ends = starts + rng.uniform(0.5, 30, m_pool)
        weights = rng.uniform(0.0, 1.0, m_pool)
        sel, total = wis_clear(starts, ends, weights, impl="cuda", device=dev)
        sel_h, total_h = wis_select(starts, ends, weights)
        sel_t, total_t = wis_clear(starts, ends, weights, impl="torch",
                                   device="cpu")
        if sel.tolist() != sel_t.tolist() or total != total_t:
            raise AssertionError(f"wis_clear M={m_pool}: card and host float32 "
                                 "DP disagree")
        if set(sel.tolist()) != set(sel_h.tolist()) or \
                abs(total - total_h) > 1e-5 * max(1.0, abs(total_h)):
            raise AssertionError(f"wis_clear M={m_pool}: selection or total "
                                 f"differs from wis_select ({total} vs {total_h})")
        log(f"wis_clear M={m_pool} on the card: {len(sel)} selected, total "
            f"{total} (host float64 {total_h}), selection equal")
    launches = k3.LAUNCHES["wis_dp"]
    if launches != len(sizes):
        raise AssertionError(f"wis_clear launched K3 {launches} times, "
                             f"expected {len(sizes)}")
    return {"launches": launches, "max_abs_err": 0.0, "ulps": 0, "ms": ms,
            "graph_ms": times[str(m)]["graph_ms"], "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / F32_OPS_PER_S
            else "operations",
            "branch": times[str(m)]["branch"], "shape": {"M": m},
            "times": times, "forced": {"M": DP_FORCED_M, **forced},
            "paths": paths}


# ---------------------------------------------------------------------------
# Phase 3: the auction path
# ---------------------------------------------------------------------------


def cluster(SliceSpec):
    return [SliceSpec(f"gpu{g:02d}-{name}", cap * GB, n_chips=units)
            for g in range(16) for name, cap, units in MIG_PROFILES]


def run_sim(core, impl, *, pipeline, device, workload, sim, mesh=None,
            **sim_kw):
    """One ``simulate`` run, its device work split over ``mesh`` if given;
    ``sim_kw`` (faults, checkpoint, ...) passes through.  Its commit log is
    read from the scheduler that finished the run: the one a
    ``scheduler_crash`` restored from the store."""
    from repro_torch.core.scheduler import SchedulerConfig

    cfg = SchedulerConfig.from_policy(
        core.Policy(per_agent_theta=True), score_impl=impl, wis_impl=impl,
        device=device, mesh=mesh)
    t0 = time.perf_counter()
    res = core.simulate(
        core.JasdaScheduler(workload["slices"](core.SliceSpec), cfg),
        core.make_workload(**workload["jobs"]),
        core.SimConfig(pipeline=pipeline, **sim), **sim_kw)
    wall = time.perf_counter() - t0
    sched = res.scheduler
    commits = [(c.variant_id, c.slice_id, c.t_start, c.score)
               for c in sched.commit_log]
    rounds = [r for r in sched.log if r.n_windows]
    failed = sched.backend_health.failed_backends()
    if failed:
        raise AssertionError(f"{impl} run marked backends failed: {failed}")
    return {"commits": commits, "summary": res.summary(), "wall_s": wall,
            "rounds": len(rounds),
            "max_bids": max((r.n_bids for r in rounds), default=0),
            "max_windows": max((r.n_windows for r in rounds), default=0)}


#: phase 3's workload: 500 jobs on the 64-slice cluster, 21 rounds
SIM_WORKLOAD = {"slices": cluster,
                "jobs": dict(n_jobs=500, seed=0, arrival_rate=100.0,
                             mem_range_gb=(2.0, 36.0))}
SIM_CONFIG = dict(t_end=20.0, seed=1)
#: the plain torch versions on the card take ~8x the kernels' wall, most
#: of it in the early rounds, whose pools are the largest: they replay the
#: first four rounds (to M bucket 32768), against the kernels there
TORCH_SIM_CONFIG = dict(SIM_CONFIG, t_end=3.0)


def main_path(torch, dev, k1, k2):
    import repro_torch.core as core
    from repro_torch.kernels.jasda_score.ops import bucket_m

    workload, sim = SIM_WORKLOAD, SIM_CONFIG
    k1.LAUNCHES["jasda_score"] = 0
    k2.LAUNCHES["wis_batch"] = 0
    k1.SHAPES.clear()
    k2.SHAPES.clear()
    cuda_pipe = run_sim(core, "cuda", pipeline=True, device=dev,
                        workload=workload, sim=sim)
    launches = {"jasda_score": k1.LAUNCHES["jasda_score"],
                "wis_batch": k2.LAUNCHES["wis_batch"]}
    shapes = {"jasda_score": dict(k1.SHAPES), "wis_batch": dict(k2.SHAPES)}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never ran: {launches}")
    log(f"main path cuda pipelined: {cuda_pipe['rounds']} rounds, max "
        f"{cuda_pipe['max_bids']} bids/round (M bucket "
        f"{bucket_m(cuda_pipe['max_bids'])}), max {cuda_pipe['max_windows']} "
        f"windows, launches {launches}, {cuda_pipe['wall_s']:.2f} s wall")
    log(f"  K1 shapes (M, Fj, Fs, T): {shapes['jasda_score']}")
    log(f"  K2 shapes (W, L, fused, transformed): {shapes['wis_batch']}")
    log(f"  {cuda_pipe['summary']}")

    k1.LAUNCHES["jasda_score"] = 0
    k2.LAUNCHES["wis_batch"] = 0
    k1.SHAPES.clear()
    k2.SHAPES.clear()
    cuda_serial = run_sim(core, "cuda", pipeline=False, device=dev,
                          workload=workload, sim=sim)
    serial_launches = {"jasda_score": k1.LAUNCHES["jasda_score"],
                       "wis_batch": k2.LAUNCHES["wis_batch"]}
    cuda_pipe["shapes"] = shapes
    cuda_pipe["serial"] = {
        "launches": serial_launches, "wall_s": cuda_serial["wall_s"],
        "shapes": {"jasda_score": dict(k1.SHAPES), "wis_batch": dict(k2.SHAPES)}}
    if not all(serial_launches.values()):
        raise AssertionError(f"serial run skipped a kernel: {serial_launches}")
    log(f"main path cuda serial: launches {serial_launches}, "
        f"{cuda_serial['wall_s']:.2f} s wall")

    k1.LAUNCHES["jasda_score"] = 0
    k2.LAUNCHES["wis_batch"] = 0
    torch_run = run_sim(core, "torch", pipeline=True, device=dev,
                        workload=workload, sim=TORCH_SIM_CONFIG)
    if k1.LAUNCHES["jasda_score"] or k2.LAUNCHES["wis_batch"]:
        raise AssertionError("the plain torch run launched a CUDA kernel")
    cuda_half = run_sim(core, "cuda", pipeline=True, device=dev,
                        workload=workload, sim=TORCH_SIM_CONFIG)
    log(f"main path to t = {TORCH_SIM_CONFIG['t_end']}: torch on the card "
        f"{torch_run['rounds']} rounds (at most {torch_run['max_bids']} bids "
        f"a round), {torch_run['wall_s']:.2f} s wall; "
        f"cuda pipelined {cuda_half['wall_s']:.2f} s wall")

    for name, run, other in (("cuda serial", cuda_pipe, cuda_serial),
                             ("torch", cuda_half, torch_run)):
        if other["commits"] != run["commits"]:
            raise AssertionError(f"{name} commit log differs from cuda pipelined")
        if other["summary"] != run["summary"]:
            raise AssertionError(f"{name} summary differs: {other['summary']}")
        if not run["commits"]:
            raise AssertionError(f"the main path committed nothing ({name})")
    log(f"commit logs ({len(cuda_pipe['commits'])} rows; "
        f"{len(cuda_half['commits'])} to t = {TORCH_SIM_CONFIG['t_end']}) and "
        f"summaries identical: cuda pipelined and serial; to t = "
        f"{TORCH_SIM_CONFIG['t_end']}, cuda pipelined and torch on the card")

    host = run_sim(core, "numpy", pipeline=False, device="cpu",
                   workload=workload, sim=sim)
    log(f"host float64 reference summary {'matches' if host['summary'] == cuda_pipe['summary'] else 'differs'}"
        f": {host['summary']} ({host['wall_s']:.2f} s wall)")

    # a small seeded run: the kernels on the card against the plain
    # versions on the host, commit for commit
    small = {"slices": lambda S: [S("s20", 20 * GB, n_chips=4),
                                  S("s10", 10 * GB, n_chips=2),
                                  S("s5", 5 * GB, n_chips=1)],
             "jobs": dict(n_jobs=40, seed=3, arrival_rate=0.3)}
    small_sim = dict(t_end=900.0, seed=2)
    on_card = run_sim(core, "cuda", pipeline=True, device=dev,
                      workload=small, sim=small_sim)
    on_host = run_sim(core, "torch", pipeline=True, device="cpu",
                      workload=small, sim=small_sim)
    if ([c[:3] for c in on_card["commits"]] != [c[:3] for c in on_host["commits"]]
            or on_card["summary"] != on_host["summary"]):
        raise AssertionError("small run: card and host disagree")
    worst = max((abs(a[3] - b[3]) for a, b in zip(on_card["commits"],
                                                    on_host["commits"])),
                default=0.0)
    if worst > 3e-5:
        raise AssertionError(f"small run: scores differ by {worst}")
    log(f"small run: {len(on_card['commits'])} commits identical on card and "
        f"host (max score gap {worst})")
    cuda_pipe["small"] = on_card
    device_share(torch, core, dev, workload, sim)
    return launches, cuda_pipe


# ---------------------------------------------------------------------------
# Phase 4: the serving path
# ---------------------------------------------------------------------------


PHASES = ("prefill", "decode")


def serve_requests(torch, dev, model, params, prompts, *, max_new: int,
                   max_seq: int = 2048, attn_impl: str = "auto",
                   cache_leaves: bool = True):
    """Serve ``prompts`` through ``ServingEngine`` (4 slots); returns the
    requests, host-clock timings of each prefill and each decode step, and
    what each prefill returned (its last logits and, with ``cache_leaves``,
    its cache leaves).  Each prefill and each step's decode of the slots
    (its CUDA graph's capture or replay) runs inside a profiler range named
    after its phase that starts and ends with a device synchronise, so
    every kernel it launched also ran inside the range."""
    from torch.profiler import record_function

    from repro_torch.serving import Request, ServeConfig, ServingEngine

    eng = ServingEngine(model, params, ServeConfig(batch_slots=4, max_seq=max_seq),
                        device=dev, attn_impl=attn_impl)
    times = {"prefill": [], "decode": []}
    prefills = []

    def timed(kind, fn):
        def call(*args):
            with record_function(kind):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                times[kind].append(time.perf_counter() - t0)
            if not torch.isfinite(out[0]).all():
                raise AssertionError(f"{kind} produced non-finite logits")
            if kind == "prefill":
                prefills.append([out[0], *(_leaves(out[1]) if cache_leaves
                                           else ())])
            return out
        return call

    eng._prefill = timed("prefill", eng._prefill)
    eng._decode_slots = timed("decode", eng._decode_slots)
    reqs = [Request(f"r{i}", p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_done()
    torch.cuda.synchronize()
    times["wall_s"] = time.perf_counter() - t0
    return reqs, times, prefills


def serving_path(np, torch, dev, k5, card: str):
    from repro_torch.configs import get, reduced
    from repro_torch.models import Model

    cfg = get("falcon_mamba_7b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Model(cfg).init(SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"falcon-mamba-7b full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {str(cfg.dtype)[6:]}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}), {n_params} params initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    lens = [1024] + [int(n) for n in rng.integers(128, 1025, 7)]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    max_new = 32

    # one short prefill first, so cuBLAS and the kernels are loaded before
    # anything is timed (not counted: the counters are reset just below)
    Model(cfg).prefill(params, torch.from_numpy(prompts[0][:16]).to(dev)[None])
    torch.cuda.synchronize()

    k5.LAUNCHES["linear_scan"] = 0
    k5.SHAPES.clear()
    kern_reqs, kern_t, kern_pre = serve_requests(
        torch, dev, Model(cfg), params, prompts, max_new=max_new)
    launches = k5.LAUNCHES["linear_scan"]
    shapes = dict(k5.SHAPES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    k5.LAUNCHES["linear_scan"] = 0
    plain_reqs, plain_t, plain_pre = serve_requests(
        torch, dev, Model(cfg, scan_impl="torch"), params, prompts,
        max_new=max_new)
    if k5.LAUNCHES["linear_scan"]:
        raise AssertionError("the plain-scan run launched K5")

    for name, reqs in (("K5", kern_reqs), ("plain", plain_reqs)):
        bad = [r.request_id for r in reqs
               if not r.done or len(r.output) != max_new]
        if bad:
            raise AssertionError(f"{name} run left requests unfinished: {bad}")
        if any(not 0 <= t < cfg.padded_vocab for r in reqs for t in r.output):
            raise AssertionError(f"{name} run emitted a token outside the vocab")
    for a, b in zip(kern_reqs, plain_reqs):
        if a.output != b.output:
            raise AssertionError(f"{a.request_id}: tokens differ between K5 "
                                 f"and the plain scan: {a.output} vs {b.output}")
    # K5 is bit-equal to the plain loop, so each prefill's logits and the
    # ssm/conv states it hands to its slot must be too
    if len(kern_pre) != len(prompts) or len(plain_pre) != len(prompts):
        raise AssertionError(f"expected {len(prompts)} prefills, got "
                             f"{len(kern_pre)} and {len(plain_pre)}")
    for i, (a, b) in enumerate(zip(kern_pre, plain_pre)):
        if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"r{i}: prefill logits or cache states differ "
                                 f"between K5 and the plain scan")
    n_pre_leaves = len(kern_pre[0])
    del kern_pre, plain_pre
    want = cfg.n_layers * len(prompts)
    if launches != want:
        raise AssertionError(f"K5 launched {launches} times, expected {want}")
    n_tok = sum(len(r.output) for r in kern_reqs)
    for name, t in (("K5", kern_t), ("plain scan", plain_t)):
        pre = [x * 1e3 for x in t["prefill"]]
        dec = [x * 1e3 for x in t["decode"]]
        log(f"serving through {name} [{card}]: {len(prompts)} requests, "
            f"{n_tok} tokens in {t['wall_s']:.3f} s = {n_tok / t['wall_s']:.2f} "
            f"tokens/s; prefill ms per request {[round(x, 2) for x in pre]} "
            f"(prompt lengths {lens}); decode {len(dec)} steps, median "
            f"{statistics.median(dec):.3f} ms, mean {statistics.mean(dec):.3f} ms")
    log(f"serving: all {len(prompts)} requests finished, tokens identical through "
        f"K5 and the plain scan, each prefill's last logits and {n_pre_leaves - 1} "
        f"cache leaves bit-equal, K5 launches {launches} = {cfg.n_layers} layers x "
        f"{len(prompts)} prefills, shapes {shapes}; peak memory "
        f"{peak_gb:.3f} GB [{card}]")
    busy = serving_profile(torch, dev, Model(cfg), params, prompts, max_new,
                           kern_t, card)
    del params
    torch.cuda.empty_cache()

    # a small input held against the host: the reduced config on the card
    # (through K5) and on the CPU (plain versions), same params
    worst = card_vs_host(np, torch, dev, reduced("falcon_mamba_7b"), SEED + 1,
                         "auto")["gap"]
    log(f"reduced falcon-mamba: card (K5) and host logits agree, prefill + 8 "
        f"decode steps, max abs gap {worst:.3g} (tolerance 1e-4)")
    return {"launches": launches, "peak_gb": peak_gb, "kernel": kern_t,
            "plain": plain_t, "prompt_lengths": lens, "tokens": n_tok,
            "device_busy": busy}


# ---------------------------------------------------------------------------
# Phase 5: recurrentgemma-9b serving through K4 and K5
# ---------------------------------------------------------------------------


class RouteRecorder:
    """While entered, records every MoE routing (``moe.route``, a call a
    layer) of ``tokens`` tokens in all, or of any size when None: the
    chosen experts, gates, slots, kept choices and capacity, as the tensors
    of the call's device, and with ``probs`` the router probabilities
    (G, g, E) in float32.  With ``replay`` (another recorder's ``calls``)
    each call's experts, gates, slots and kept choices are replaced by
    that recorder's call of the same index."""

    FIELDS = ("expert", "gate", "slot", "keep")

    def __init__(self, tokens=None, *, probs: bool = False, replay=None):
        self.tokens, self.probs, self.replay = tokens, probs, replay
        self.calls = []

    def __enter__(self):
        import torch
        from repro_torch.models import moe

        self.route, self.moe = moe.route, moe

        def spy(xt, router, **kw):
            r = self.route(xt, router, **kw)
            if self.tokens is not None and xt.shape[0] * xt.shape[1] != self.tokens:
                return r
            call = {k: getattr(r, k) for k in self.FIELDS}
            call["capacity"] = r.capacity
            if self.probs:
                call["probs"] = torch.softmax(xt.float() @ router.float(), dim=-1)
            if self.replay is not None:
                c = self.replay[len(self.calls)]
                r = r._replace(**{k: c[k].to(xt.device) for k in self.FIELDS})
            self.calls.append(call)
            return r

        moe.route = spy
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def host_calls(self) -> list:
        return [{k: v.cpu() if hasattr(v, "cpu") else v for k, v in c.items()}
                for c in self.calls]

    def total(self) -> int:
        """(token, choice) pairs dropped by capacity, over the calls."""
        return int(sum(int((~c["keep"]).sum()) for c in self.calls))

    def apart(self, other: "RouteRecorder") -> int:
        """(token, choice) pairs routed to another expert in ``other``."""
        return int(sum(int((a["expert"] != b["expert"]).sum())
                       for a, b in zip(self.calls, other.calls)))


def serve_k4_and_auto(np, torch, dev, k4, cfg, params, lens, prompts, *,
                      max_new: int, max_seq: int, card: str,
                      drops_at: int = 0, k5=None) -> dict:
    """The traffic served once with prefill attention through K4 and once
    through "auto": every request finishes, K4 launches once an attention
    layer and prefill on one shape a prompt (never through auto), K5 (when
    given) once a recurrent layer and prefill in both runs, and the
    first-token gate holds.  For MoE, the (token, choice) pairs dropped by
    capacity in the ``drops_at``-token prefill are counted in both runs and
    printed, not gated: bf16 attention outputs that part between K4 and
    auto move router near-ties, so the two runs route many choices apart
    (``moe_serving`` gates the K4 run's drops against a second K4 run)."""
    from repro_torch.models import Model

    kinds = cfg.superblock * cfg.n_super + cfg.superblock[:cfg.n_tail]
    n_attn = sum(kind in ("attn", "moe") for kind in kinds)
    runs = {}
    with collector_off():
        for impl in ("pallas", "auto"):
            k4.LAUNCHES["flash_attention"] = 0
            k4.SHAPES.clear()
            if k5 is not None:
                k5.LAUNCHES["linear_scan"] = 0
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with RouteRecorder(drops_at) as drops:
                reqs, t, pre = serve_requests(
                    torch, dev, Model(cfg), params, prompts, max_new=max_new,
                    max_seq=max_seq, attn_impl=impl, cache_leaves=False)
            runs[impl] = {"reqs": reqs, "t": t,
                          "logits": [x[0][0].float() for x in pre],
                          "k4": k4.LAUNCHES["flash_attention"],
                          "k4_shapes": dict(k4.SHAPES),
                          "k5": None if k5 is None else k5.LAUNCHES["linear_scan"],
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "drops": drops}
            del pre
    pal, auto = runs["pallas"], runs["auto"]
    n_tok = sum(len(r.output) for r in pal["reqs"])
    for impl, run in runs.items():
        t = run["t"]
        pre = [x * 1e3 for x in t["prefill"]]
        dec = [x * 1e3 for x in t["decode"]]
        log(f"{cfg.name} serving, attention {impl} [{card}]: {len(prompts)} "
            f"requests, {n_tok} tokens in {t['wall_s']:.3f} s = "
            f"{n_tok / t['wall_s']:.2f} tokens/s; prefill ms per request "
            f"{[round(x, 2) for x in pre]} (prompt lengths {lens}); decode "
            f"{len(dec)} steps, median {statistics.median(dec):.3f} ms, mean "
            f"{statistics.mean(dec):.3f} ms; peak memory {run['peak_gb']:.3f} "
            f"GB; K4 launches {run['k4']}"
            + ("" if k5 is None else f", K5 launches {run['k5']}"))
    log(f"  K4 shapes (B, Hq, Hkv, Sq, Sk, D, dtype, causal, window, q_offset): "
        f"{pal['k4_shapes']}")
    for impl, run in runs.items():
        bad = [r.request_id for r in run["reqs"]
               if not r.done or len(r.output) != max_new]
        if bad:
            raise AssertionError(f"{cfg.name} {impl} run left requests "
                                 f"unfinished: {bad}")
        if any(not 0 <= tok < cfg.padded_vocab for r in run["reqs"]
               for tok in r.output):
            raise AssertionError(f"{cfg.name} {impl} run emitted a token "
                                 "outside the vocab")
        if len(run["logits"]) != len(prompts):
            raise AssertionError(f"{cfg.name} {impl} run made "
                                 f"{len(run['logits'])} prefills")
        if k5 is not None and run["k5"] != (len(kinds) - n_attn) * len(prompts):
            raise AssertionError(f"{cfg.name} {impl} run launched K5 "
                                 f"{run['k5']} times, expected "
                                 f"{len(kinds) - n_attn} x {len(prompts)}")
    if auto["k4"]:
        raise AssertionError(f"{cfg.name}: the auto-attention run launched K4")
    if pal["k4"] != n_attn * len(prompts) or \
            len(pal["k4_shapes"]) != len(set(lens)):
        raise AssertionError(f"{cfg.name}: K4 launched {pal['k4']} times on "
                             f"{len(pal['k4_shapes'])} shapes, expected "
                             f"{n_attn} x {len(prompts)} on {len(set(lens))}")
    worst, gated, later_same, later = first_token_gate(pal, auto, lens)
    drops = None
    if drops_at:
        drops = {impl: run["drops"].total() for impl, run in runs.items()}
        apart = pal["drops"].apart(auto["drops"])
        n_choices = drops_at * cfg.top_k * cfg.n_layers
        log(f"{cfg.name}: (token, choice) pairs dropped by capacity in the "
            f"{drops_at}-token prefill, summed over {cfg.n_layers} layers: "
            f"{drops['pallas']} through K4, {drops['auto']} through auto, of "
            f"{n_choices}; {apart} choices routed to other experts in the two "
            "runs (bf16 attention outputs part on router near-ties); not gated")
    out = {"prompt_lengths": lens, "tokens": n_tok, "k4_launches": pal["k4"],
           "k5_launches": pal["k5"], "max_logit_gap": worst,
           "first_token_gated": gated, "later_tokens_equal": [later_same, later],
           "drops": drops}
    for impl, run in runs.items():
        t = run["t"]
        dec = [x * 1e3 for x in t["decode"]]
        out[impl] = {"wall_s": t["wall_s"],
                     "prefill_ms": [x * 1e3 for x in t["prefill"]],
                     "decode_ms_median": statistics.median(dec),
                     "decode_ms_mean": statistics.mean(dec),
                     "peak_gb": run["peak_gb"]}
    out["timed"] = pal["t"]
    return out


def hybrid_serving_path(np, torch, dev, k4, k5, card: str):
    """recurrentgemma-9b at full width, bf16, random from SEED: 8 greedy
    requests (prompts on both sides of the 2048 window) through K4 and
    through the "auto" attention; then the reduced config on the card
    against the host."""
    from repro_torch.configs import get, reduced
    from repro_torch.models import Model

    cfg = get("recurrentgemma_9b")
    n_attn = cfg.n_super * cfg.superblock.count("attn")
    n_rglru = cfg.n_layers - n_attn
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = Model(cfg).init(SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"recurrentgemma-9b full width: {cfg.n_layers} layers ({n_attn} local "
        f"attention, window {cfg.window}, {cfg.n_heads} q heads on "
        f"{cfg.n_kv_heads} kv head, head dim {cfg.hd}; {n_rglru} RG-LRU), "
        f"d_model {cfg.d_model}, {str(cfg.dtype)[6:]}, vocab {cfg.vocab_size}, "
        f"{n_params} params initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED + 50)
    lens = [4096, 3072, 2500, 2048] + sorted(
        (int(n) for n in rng.choice(np.arange(128, 2048), 4, replace=False)),
        reverse=True)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    max_new, max_seq = 16, 4224

    warm = torch.from_numpy(prompts[0][:64]).to(dev)[None]
    for impl in ("pallas", "auto"):  # load cuBLAS and the kernels, untimed
        Model(cfg).prefill(params, warm, impl=impl)
    torch.cuda.synchronize()

    out = serve_k4_and_auto(np, torch, dev, k4, cfg, params, lens, prompts,
                            max_new=max_new, max_seq=max_seq, card=card, k5=k5)
    out["device_busy"] = serving_profile(
        torch, dev, Model(cfg), params, prompts, max_new, out.pop("timed"),
        card, max_seq=max_seq, attn_impl="pallas")
    out["longest_prefill_ms"] = longest_prefill_ms(
        torch, dev, Model(cfg), params, prompts[lens.index(max(lens))], max_seq)
    k4_prefill_gates(out, lens)
    del params
    torch.cuda.empty_cache()

    # the launcher a user runs, on the card at full width (its own params
    # and short synthetic prompts): every request must finish
    from repro_torch.launch import serve

    k4.LAUNCHES["flash_attention"] = 0
    if serve.main(["--arch", "recurrentgemma_9b", "--attn-impl", "pallas",
                   "--json"]) != 0:
        raise AssertionError("launch.serve --attn-impl pallas failed on the card")
    if k4.LAUNCHES["flash_attention"] != n_attn * 8:
        raise AssertionError(f"launch.serve launched K4 "
                             f"{k4.LAUNCHES['flash_attention']} times, "
                             f"expected {n_attn} x 8 requests")
    log(f"launch.serve --arch recurrentgemma_9b --attn-impl pallas on the card: "
        f"8 requests finished, K4 launches {k4.LAUNCHES['flash_attention']}")
    torch.cuda.empty_cache()

    # a small input held against the host: the reduced config (window 16)
    # on the card through K4 and K5, on the CPU through the plain versions
    small = reduced("recurrentgemma_9b")
    k4.LAUNCHES["flash_attention"] = 0
    worst = card_vs_host(np, torch, dev, small, SEED + 2, "pallas")["gap"]
    small_attn = small.n_super * small.superblock.count("attn")
    if k4.LAUNCHES["flash_attention"] != small_attn:
        raise AssertionError(f"reduced prefill on the card launched K4 "
                             f"{k4.LAUNCHES['flash_attention']} times, expected "
                             f"{small_attn}")
    log(f"reduced recurrentgemma: card (K4, K5) and host (plain versions) "
        f"logits agree, prompt 32 past window {small.window}, prefill + 8 "
        f"decode steps, max abs gap {worst:.3g} (tolerance 1e-4)")
    out["reduced_gap"] = worst
    return out


def first_token_gate(pal: dict, auto: dict, lens) -> tuple:
    """Where the auto run's top-1 margin exceeds twice the largest gap
    between the two runs' prefill logits, the first token through K4 must
    be auto's.  Returns the largest gap, the requests gated, the later
    tokens equal and the later tokens, which are printed, not gated."""
    gated = later = later_same = 0
    worst = 0.0
    for i, (a, b) in enumerate(zip(pal["logits"], auto["logits"])):
        gap = float((a - b).abs().max().item())
        worst = max(worst, gap)
        top2 = b.topk(2).values
        margin = float((top2[0] - top2[1]).item())
        ra, rb = pal["reqs"][i], auto["reqs"][i]
        if margin > 2 * gap:
            gated += 1
            if ra.output[0] != rb.output[0]:
                raise AssertionError(
                    f"r{i}: first token {ra.output[0]} through K4, {rb.output[0]} "
                    f"through auto, though the auto margin {margin} exceeds "
                    f"twice the logit gap {gap}")
        same = sum(x == y for x, y in zip(ra.output[1:], rb.output[1:]))
        later += len(ra.output) - 1
        later_same += same
        log(f"  r{i} prompt {lens[i]}: prefill logit gap {gap:.4g}, auto "
            f"top-1 margin {margin:.4g}, first token {ra.output[0]} / "
            f"{rb.output[0]}, later tokens equal {same}/{len(ra.output) - 1}")
    log(f"K4 vs auto: largest prefill logit gap {worst:.4g}; first token "
        f"gated on {gated}/{len(lens)} requests (margin > 2 x gap), all "
        f"equal; later tokens equal {later_same}/{later} (not gated)")
    return worst, gated, later_same, later


#: largest gap between a reduced float32 config's logits on the card and on
#: the host, over a prefill and 8 decode steps
REDUCED_TOL = 1e-4


def card_vs_host(np, torch, dev, cfg, seed: int, impl: str) -> dict:
    """A reduced float32 config on the card and on the host, the same params
    drawn on the host from SEED: a 32-token prefill of two rows (attention
    ``impl``) and 8 decode steps.  Returns the largest logit gap ("gap")
    and, in the ``moe`` family, the routings (a call a layer) of the card
    and of the host's replaying run, with the router probabilities.  The
    ``vlm`` and ``encdec`` families prefill over a seeded memory, with
    ``live_params``' leaves, and decode against the prefill's cross stack.

    In the ``moe`` family the host runs twice: with its own routing, whose
    gap is returned as "own_gap" (printed, not gated), and with the card's
    routing replayed call by call (experts, slots, kept choices, gates),
    whose gap is "gap".  The combine rounds the gates to bfloat16 as the
    reference does, so a last-bit float32 difference between cuBLAS and
    the host can move a gate by a bfloat16 step, and a near-tie can move a
    choice (ROADMAP.md §3); given the same routing, the rest of the model
    must agree.  "gap" must be within REDUCED_TOL."""
    from repro_torch.models import Model

    host_params = Model(cfg).init(SEED, device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    memory = None
    if cfg.family in ("vlm", "encdec"):
        live_params(torch, cfg, host_params, seed)
        memory = rng.standard_normal(
            (2, cfg.encoder_seq or cfg.vision_seq, cfg.d_model)).astype(np.float32)

    def run(params, d, replay=None):
        with RouteRecorder(probs=True, replay=replay) as rec:
            m = Model(cfg)
            tk = torch.from_numpy(toks).to(d)
            mem = None if memory is None else torch.from_numpy(memory).to(d)
            logits, cache, cross = m.prefill(params, tk[:, :32], memory=mem,
                                             impl=impl, max_seq=64)
            seq = [logits.float().cpu()]
            for t in range(32, 40):
                logits, cache = m.decode_step(params, tk[:, t], t, cache,
                                              cross_stack=cross)
                seq.append(logits.float().cpu())
        return torch.stack(seq), rec.host_calls()

    cpu = torch.device("cpu")
    card, card_calls = run(_to(host_params, dev), dev)
    host, host_calls = run(host_params, cpu)
    own_gap = gap = float((card - host).abs().max().item())
    if card_calls:
        # the host's own choices in this run, on inputs that track the
        # card's, are what routing_gate holds the card's to
        replayed, host_calls = run(host_params, cpu, replay=card_calls)
        gap = float((card - replayed).abs().max().item())
    if not gap <= REDUCED_TOL:
        raise AssertionError(f"reduced {cfg.name}: card and host logits differ "
                             f"by {gap}")
    return {"gap": gap, "own_gap": own_gap,
            "routes": {"card": card_calls, "host": host_calls}}


#: K4's largest share of the K4 run's prefill device time
K4_PREFILL_SHARE = 0.05


def longest_prefill_ms(torch, dev, model, params, prompt, max_seq: int,
                       turns: int = 3) -> dict:
    """Host-clock ms of one prefill of ``prompt`` through K4 ("pallas") and
    through "auto", each timed ``turns`` times in turns (pallas, auto, auto,
    pallas, ...) between device synchronises, as the engine calls it; the
    median of each, and the samples.  Beside the serving runs' one prefill
    a path, these are later calls of the same shape: their gap to the
    serving run's is what the first call in the run costs.  One untimed
    call through K4 goes first (``first_ms``): it pays for what the serving
    profile before it freed (``release_profiler``)."""
    toks = torch.from_numpy(prompt).to(dev)[None]
    samples = {"pallas": [], "auto": []}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, toks, impl="pallas", max_seq=max_seq)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    with collector_off():
        for n in range(turns):
            for impl in (("pallas", "auto") if n % 2 == 0 else ("auto", "pallas")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.prefill(params, toks, impl=impl, max_seq=max_seq)
                torch.cuda.synchronize()
                samples[impl].append((time.perf_counter() - t0) * 1e3)
    return {"median": {k: statistics.median(v) for k, v in samples.items()},
            "samples": samples, "first_ms": first_ms}


def k4_prefill_gates(out: dict, lens) -> None:
    """The longest prompt's prefill through K4 must beat "auto"'s, in the
    serving runs and in the medians of ``longest_prefill_ms``; K4 must take
    under K4_PREFILL_SHARE of prefill device time where the profiler
    measured it."""
    i = lens.index(max(lens))
    pal_ms, auto_ms = out["pallas"]["prefill_ms"][i], out["auto"]["prefill_ms"][i]
    med = out["longest_prefill_ms"]["median"]
    share = None
    busy = out["device_busy"]
    if busy is not None and busy["busy_s"]["prefill"] > 0:
        share = busy["groups"]["prefill"].get("K4", 0.0) / busy["busy_s"]["prefill"]
    out["k4_prefill_share"] = share
    share_txt = "not measured" if share is None else f"{100 * share:.2f}%"
    log(f"{lens[i]}-token prefill: {pal_ms:.2f} ms through K4, {auto_ms:.2f} ms "
        f"through auto; K4 share of prefill device time {share_txt}")
    log(f"{lens[i]}-token prefill again, median of "
        f"{len(out['longest_prefill_ms']['samples']['pallas'])} in turns: "
        f"{med['pallas']:.2f} ms through K4, {med['auto']:.2f} ms through auto "
        f"(samples {out['longest_prefill_ms']['samples']}; an untimed one "
        f"through K4 before them {out['longest_prefill_ms']['first_ms']:.2f} "
        f"ms); the serving run's first prefill exceeds it by "
        f"{pal_ms - med['pallas']:.2f} / {auto_ms - med['auto']:.2f} ms")
    for what, p_ms, a_ms in (("", pal_ms, auto_ms),
                             (" (medians)", med["pallas"], med["auto"])):
        if not p_ms < a_ms:
            raise AssertionError(f"the {lens[i]}-token prefill through K4 "
                                 f"({p_ms:.2f} ms) is not faster than auto "
                                 f"({a_ms:.2f} ms){what}")
    if share is not None and not share < K4_PREFILL_SHARE:
        raise AssertionError(f"K4 takes {100 * share:.2f}% of prefill device "
                             f"time, limit {100 * K4_PREFILL_SHARE}%")


def kernel_group(name: str) -> str:
    """The kind of work a device activity does, read from its name."""
    n = name.lower()
    if "linear_scan_bwd_kernel" in n:
        return "K5 backward"
    if "linear_scan_kernel" in n:
        return "K5"
    if "flash_attention_kernel" in n or "flash_attention_tc_kernel" in n:
        return "K4"
    if any(w in n for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "gemm"
    for group, words in (("index", ("index",)),
                         ("sort, scan", ("sort", "scan")),
                         ("exp", ("exp_kernel",)),
                         ("mul", ("mulfunctor",)),
                         ("add", ("addfunctor", "functor_add",
                                  "functoronself_add", "functoronother_add")),
                         ("copy", ("copy", "memcpy", "memset"))):
        if any(w in n for w in words):
            return group
    return "other"


def kernel_label(name: str) -> str:
    """A short name for a device kernel: its functor or kernel function."""
    import re

    generic = {"vectorized_elementwise_kernel", "unrolled_elementwise_kernel",
               "elementwise_kernel", "BinaryFunctor", "AUnaryFunctor",
               "BUnaryFunctor"}
    for word in re.findall(r"[A-Za-z_]\w*", name):
        if word not in generic and (word.endswith(("Functor", "_kernel_cuda",
                                                   "_kernel", "Kernel",
                                                   "Copy"))
                                    or word.startswith(("nvjet", "sm90",
                                                        "CUDAFunctor"))):
            return word
    return name[:60]


def serving_profile(torch, dev, model, params, prompts, max_new: int,
                    timed: dict, card: str, *, top: int = 8, **serve_kw):
    """Where serving's time goes: the same requests once more through the
    kernels under torch.profiler (``serve_kw`` as ``serve_requests`` takes
    them).  Each device activity is put in the ``prefill`` or ``decode``
    range it ran in (the ranges start and end with a synchronise), or
    between them (the engine's cache placement and host copies), and
    grouped by kernel name.  A phase's device seconds are set against the
    same phase's host-clock seconds in the unprofiled run ``timed`` and in
    this profiled one."""
    import bisect

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reqs, t, _ = serve_requests(torch, dev, model, params, prompts,
                                    max_new=max_new, **serve_kw)
    events = profiled_events(torch, prof)
    del prof
    release_profiler()
    ranges = sorted((t0, t1, name) for name, on_card, t0, t1 in events
                    if not on_card and name in PHASES)
    want = len(t["prefill"]) + len(t["decode"])
    if len(ranges) != want:
        log(f"serving device share: not measured (the profiler kept "
            f"{len(ranges)} of {want} phase ranges)")
        return None
    starts = [r[0] for r in ranges]
    seconds = {ph: {} for ph in PHASES + ("between",)}
    names = {ph: {} for ph in PHASES + ("between",)}
    for name, on_card, t0, t1 in events:
        if not on_card or name in PHASES:
            continue
        i = bisect.bisect_right(starts, (t0 + t1) / 2) - 1
        ph = ranges[i][2] if i >= 0 and (t0 + t1) / 2 <= ranges[i][1] else "between"
        s = (t1 - t0) / 1e9
        g = kernel_group(name)
        seconds[ph][g] = seconds[ph].get(g, 0.0) + s
        label = kernel_label(name)
        names[ph][label] = names[ph].get(label, 0.0) + s
    busy = {ph: sum(v.values()) for ph, v in seconds.items()}
    if sum(busy.values()) == 0.0:
        log("serving device share: not measured (the profiler saw no device time)")
        return None
    out = {"profiled_wall_s": t["wall_s"], "busy_s": busy, "groups": seconds}
    log(f"{model.cfg.name} serving under torch.profiler [{card}]: {len(reqs)} requests x "
        f"{max_new} new tokens, {t['wall_s']:.3f} s wall (unprofiled "
        f"{timed['wall_s']:.3f} s); device busy {sum(busy.values()):.4f} s, "
        f"{busy['between']:.4f} s of it between the model calls")
    for ph in PHASES:
        host, prof_host = sum(timed[ph]), sum(t[ph])
        n = len(t[ph])
        top_names = sorted(names[ph].items(), key=lambda kv: -kv[1])[:top]
        log(f"  {ph}: {n} calls, host clock {host:.4f} s unprofiled "
            f"({1e3 * host / n:.3f} ms a call), {prof_host:.4f} s profiled; "
            f"device busy {busy[ph]:.4f} s ({1e3 * busy[ph] / n:.3f} ms a call, "
            f"{100 * busy[ph] / host:.2f}% of the unprofiled host time, "
            f"{100 * busy[ph] / prof_host:.2f}% of the profiled); by group: "
            + ", ".join(f"{g} {v:.4f} s" for g, v in sorted(
                seconds[ph].items(), key=lambda kv: -kv[1]))
            + "; top kernels: "
            + ", ".join(f"{k} {v:.4f} s" for k, v in top_names))
        out[ph] = {"host_s": host, "profiled_host_s": prof_host, "calls": n}
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def profiled_events(torch, prof) -> list:
    """(name, on the card, start ns, end ns) of every activity ``prof`` kept,
    read from its raw results (``prof.events()`` builds a Python tree over
    them first, which took most of a minute for one served model's
    traffic); the device's copies of record_function ranges left out."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        on_card = e.device_type() == cuda
        if on_card and e.is_user_annotation():
            continue
        out.append((e.name(), on_card, e.start_ns(), e.end_ns()))
    return out


def device_seconds(torch, prof, names, group_of) -> dict:
    """Device seconds by group (``group_of(kernel name)``; each of ``names``
    is listed, at 0 where nothing ran) from device activities only: a CPU
    op's self device time repeats the time of the kernels and copies it
    launched."""
    groups = dict.fromkeys(names, 0.0)
    for name, on_card, t0, t1 in profiled_events(torch, prof):
        if on_card:
            g = group_of(name)
            groups[g] = groups.get(g, 0.0) + (t1 - t0) / 1e9
    return groups


def device_share(torch, core, dev, workload, sim) -> None:
    """Where the main path's time goes: the cuda serial run once more under
    torch.profiler, its device time by kind over its (profiled) wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = run_sim(core, "cuda", pipeline=False, device=dev,
                      workload=workload, sim=sim)
        torch.cuda.synchronize()
    names = ("score_kernel", "wis_batch_kernel", "memcpy", "other")
    groups = device_seconds(torch, prof, names, lambda key: next(
        (g for g in names if g in key or (g == "memcpy" and "Memcpy" in key)),
        "other"))
    del prof
    release_profiler()
    busy = sum(groups.values())
    if busy == 0.0:
        log("device share: not measured (the profiler saw no device time)")
        return
    log(f"device share, cuda serial under torch.profiler: {run['wall_s']:.3f} s "
        f"wall, device busy {busy:.4f} s ({100 * busy / run['wall_s']:.3f}%), "
        + ", ".join(f"{k} {v:.4f} s" for k, v in groups.items()))


# ---------------------------------------------------------------------------
# Phase 6: the streaming auction service
# ---------------------------------------------------------------------------

#: the open-loop arrivals of every phase-6 soak (rate 8 on the 64-slice
#: cluster: pools of a few hundred to a few thousand bids a round)
SERVICE_ARRIVALS = dict(rate=8.0, seed=0, work_range=(8.0, 40.0),
                        qos_fraction=0.3, deadline_slack=(2.0, 6.0))
SERVICE_T_END = 200.0
SERVICE_CRASH_T = 100.0
SERVICE_CHECKPOINT_EVERY = 50
POD_T_END = 120.0
#: the first 6c round whose float32 scores tie where host float64 ones do
#: not (two bids 5.3e-9 apart in float64, equal in float32): the f32
#: backends and host numpy pick different winners from here on
POD_F64_TIE_T = 98.0
SIM_CRASH_T = 10.5
LAUNCHER_ARGV = ["--json", "--t-end", "60"]


def pod(SliceSpec):
    """A 64-chip pod of eight 8-chip 80 GB slices (repartitioned in 6c)."""
    return [SliceSpec(f"s{i}", 80 * GB, n_chips=8) for i in range(8)]


def run_service(impl, *, device, pipeline, slices=cluster, t_end=None,
                checkpoint=None, **svc_cfg):
    """One soak of ``SERVICE_ARRIVALS`` with AcceptAll, configured to
    ``SERVICE_T_END`` and run to ``t_end`` (the same when None); the service
    object, its stats and its wall."""
    from repro_torch import core, service
    from repro_torch.core.scheduler import SchedulerConfig

    sched = core.JasdaScheduler(slices(core.SliceSpec), SchedulerConfig(
        score_impl=impl, wis_impl=impl, device=device))
    arr = dict(SERVICE_ARRIVALS)
    svc = service.JasdaService(
        sched, service.PoissonArrivals(arr.pop("rate"), **arr),
        config=service.ServiceConfig(t_end=SERVICE_T_END, seed=0,
                                     max_bucket_m=32768, pipeline=pipeline,
                                     **svc_cfg),
        admission=service.AcceptAll())
    t0 = time.perf_counter()
    stats = svc.run(t_end, checkpoint=checkpoint,
                    checkpoint_every=SERVICE_CHECKPOINT_EVERY)
    return svc, stats, time.perf_counter() - t0


def soak_digest(svc, stats, wall: float) -> dict:
    """What two soaks must agree on (award log, stats as JSON so NaN
    compares), and what the phase reports."""
    import dataclasses

    failed = svc.scheduler.backend_health.failed_backends()
    if failed:
        raise AssertionError(f"a service soak marked backends failed: {failed}")
    rounds = [r for r in svc.scheduler.log if r.n_windows]
    return {"awards": [(r.round, r.t, r.variant_id, r.job_id, r.slice_id)
                       for r in svc.award_log],
            "stats": json.dumps(dataclasses.asdict(stats)),
            "p50": stats.announce_award_p50, "p99": stats.announce_award_p99,
            "rounds": stats.n_rounds, "wall_s": wall,
            "big_rounds": sum(r.n_bids >= 256 for r in rounds),
            "max_bids": max((r.n_bids for r in rounds), default=0),
            "windows": (min((r.n_windows for r in rounds), default=0),
                        max((r.n_windows for r in rounds), default=0))}


def same_soak(name: str, a: dict, b: dict) -> None:
    if a["awards"] != b["awards"]:
        i = next((i for i, (x, y) in enumerate(zip(a["awards"], b["awards"]))
                  if x != y), min(len(a["awards"]), len(b["awards"])))
        raise AssertionError(
            f"{name}: award logs differ from row {i} of "
            f"{len(a['awards'])} / {len(b['awards'])}: "
            f"{a['awards'][i:i + 3]} / {b['awards'][i:i + 3]}")
    if a["stats"] != b["stats"]:
        raise AssertionError(f"{name}: stats differ: {a['stats']} / {b['stats']}")


def counted(k1, k2, fn):
    """Run ``fn`` with K1's and K2's counts set to 0 just before; return its
    result and the launches and shapes counted in it."""
    k1.LAUNCHES["jasda_score"] = 0
    k2.LAUNCHES["wis_batch"] = 0
    k1.SHAPES.clear()
    k2.SHAPES.clear()
    out = fn()
    return out, {"jasda_score": k1.LAUNCHES["jasda_score"],
                 "wis_batch": k2.LAUNCHES["wis_batch"]}, {
        "jasda_score": dict(k1.SHAPES), "wis_batch": dict(k2.SHAPES)}


def service_path(dev, k1, k2, sim_run=None) -> dict:
    """Phase 6: the streaming service through K1 and K2 (6a soak, 6b crash
    and resume, 6c repartitioning and migration, 6d the simulator's crash
    replay, 6e the launcher).  ``sim_run`` is phase 3's cuda pipelined run,
    run here when phase 3 was not."""
    import contextlib
    import io
    import tempfile

    import repro_torch.core as core
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.launch import serve_auction
    from repro_torch.service import JasdaService

    t_phase = time.perf_counter()
    out = {}
    # 6a: the soak, cuda pipelined (counted), cuda serial, host numpy
    (svc, stats, wall), launches, shapes = counted(k1, k2, lambda: run_service(
        "cuda", device=dev, pipeline=True))
    if not all(launches.values()):
        raise AssertionError(f"6a: a kernel of the service path never ran: "
                             f"{launches}")
    pipe = soak_digest(svc, stats, wall)
    del svc
    (serial_run, serial_launches, _) = counted(k1, k2, lambda: run_service(
        "cuda", device=dev, pipeline=False))
    serial = soak_digest(*serial_run)
    host = soak_digest(*run_service("numpy", device="cpu", pipeline=True))
    same_soak("6a cuda serial", serial, pipe)
    same_soak("6a host numpy", host, pipe)
    if not pipe["awards"]:
        raise AssertionError("6a: the soak awarded nothing")
    log(f"6a service soak, 64 slices, Poisson rate {SERVICE_ARRIVALS['rate']}, "
        f"t_end {SERVICE_T_END}: {pipe['rounds']} rounds, "
        f"{pipe['big_rounds']} at >= 256 bids, max {pipe['max_bids']} bids, "
        f"{len(pipe['awards'])} awards; announce->award p50 {pipe['p50']} "
        f"p99 {pipe['p99']}")
    log(f"  walls: cuda pipelined {pipe['wall_s']:.2f} s, cuda serial "
        f"{serial['wall_s']:.2f} s, host numpy {host['wall_s']:.2f} s; "
        f"launches pipelined {launches}, serial {serial_launches}")
    log(f"  K1 shapes (M, Fj, Fs, T): {shapes['jasda_score']}")
    log(f"  K2 shapes (W, L, fused, transformed): {shapes['wis_batch']}")
    log("  award logs and stats identical across cuda pipelined, cuda serial "
        "and host numpy")
    out["6a"] = {"launches": launches, "serial_launches": serial_launches,
                 **{k: pipe[k] for k in ("rounds", "big_rounds", "max_bids",
                                         "p50", "p99")},
                 "wall_s": {"cuda_pipelined": pipe["wall_s"],
                            "cuda_serial": serial["wall_s"],
                            "host_numpy": host["wall_s"]}}

    # 6b: crash at t = SERVICE_CRASH_T, restore from the store, run on
    with tempfile.TemporaryDirectory() as tmp:
        store = CheckpointStore(tmp, keep=3)

        def crash_and_resume():
            t0 = time.perf_counter()
            run_service("cuda", device=dev, pipeline=True,
                        t_end=SERVICE_CRASH_T, checkpoint=store)
            resumed = JasdaService.restore(store)
            step = resumed.round_count
            stats = resumed.run()
            return resumed, stats, time.perf_counter() - t0, step

        (resumed, stats, wall, step), b_launches, _ = counted(
            k1, k2, crash_and_resume)
    resumed_digest = soak_digest(resumed, stats, wall)
    same_soak("6b resumed soak", resumed_digest, pipe)
    log(f"6b crash at t = {SERVICE_CRASH_T}, restored at round {step} "
        f"(checkpoint every {SERVICE_CHECKPOINT_EVERY}), run on to "
        f"{SERVICE_T_END}: award log and stats equal 6a's; {wall:.2f} s "
        f"wall, launches {b_launches}")
    out["6b"] = {"restored_round": step, "wall_s": wall, "launches": b_launches}

    # 6c: repartitioning and migration on the 64-chip pod.  The f32
    # backends' twin on the host is the plain torch versions (bit-equal to
    # K1 and K2); host float64 numpy parts from them at the first round
    # whose f32 scores tie where the f64 ones do not (ROADMAP.md §3)
    def pod_run(impl, device, pipeline=True):
        svc, stats, wall = run_service(
            impl, device=device, pipeline=pipeline, slices=pod,
            t_end=POD_T_END, repartition=core.FragmentationAware(),
            migration=True)
        return soak_digest(svc, stats, wall), svc.repartition.stats()

    (pod_card, coord), c_launches, c_shapes = counted(
        k1, k2, lambda: pod_run("cuda", dev))
    pod_torch, torch_coord = pod_run("torch", "cpu", pipeline=False)
    same_soak("6c host torch serial", pod_torch, pod_card)
    if coord != torch_coord:
        raise AssertionError(f"6c: coordinators differ: {coord} / {torch_coord}")
    if not coord["n_splits"] > 0:
        raise AssertionError(f"6c made no split: {coord}")
    pod_host, _ = pod_run("numpy", "cpu")
    parted = next((i for i, (a, b) in enumerate(zip(pod_host["awards"],
                                                    pod_card["awards"]))
                   if a != b), None)
    if parted is not None and pod_card["awards"][parted][1] < POD_F64_TIE_T:
        raise AssertionError(
            f"6c: host numpy parts from the card at award row {parted}, "
            f"before the f32 tie at t = {POD_F64_TIE_T}: "
            f"{pod_host['awards'][parted]} / {pod_card['awards'][parted]}")
    parted_txt = ("never" if parted is None else
                  f"at award row {parted} (t = {pod_card['awards'][parted][1]}"
                  f": {pod_host['awards'][parted][2]} on the host, "
                  f"{pod_card['awards'][parted][2]} on the card)")
    log(f"6c repartitioning pod (8 x 8-chip 80 GB, FragmentationAware, "
        f"migration), t_end {POD_T_END}: {coord['n_splits']} splits, "
        f"{coord['n_merges']} merges, {coord['n_forced']} forced drains, "
        f"windows a round {pod_card['windows'][0]}-{pod_card['windows'][1]}, "
        f"max {pod_card['max_bids']} bids; cuda pipelined identical to the "
        f"plain versions on the host (serial); host float64 numpy parts "
        f"{parted_txt}; walls cuda {pod_card['wall_s']:.2f} s, host torch "
        f"{pod_torch['wall_s']:.2f} s, host numpy {pod_host['wall_s']:.2f} s; "
        f"launches {c_launches}")
    log(f"  K1 shapes: {c_shapes['jasda_score']}")
    log(f"  K2 shapes: {c_shapes['wis_batch']}")
    out["6c"] = {"coordinator": coord, "windows": pod_card["windows"],
                 "max_bids": pod_card["max_bids"], "launches": c_launches,
                 "numpy_parts_at_row": parted,
                 "wall_s": {"cuda_pipelined": pod_card["wall_s"],
                            "host_torch_serial": pod_torch["wall_s"],
                            "host_numpy": pod_host["wall_s"]}}

    # 6d: phase 3's simulation with a scheduler crash mid-run
    if sim_run is None:
        sim_run = run_sim(core, "cuda", pipeline=True, device=dev,
                          workload=SIM_WORKLOAD, sim=SIM_CONFIG)
    plan = core.FaultPlan(seed=0, events=(
        core.FaultEvent(t=SIM_CRASH_T, kind="scheduler_crash"),))
    with tempfile.TemporaryDirectory() as tmp:
        crashed, d_launches, _ = counted(k1, k2, lambda: run_sim(
            core, "cuda", pipeline=True, device=dev, workload=SIM_WORKLOAD,
            sim=SIM_CONFIG, faults=plan, checkpoint=CheckpointStore(tmp),
            checkpoint_every=5))
    if (crashed["commits"] != sim_run["commits"]
            or crashed["summary"] != sim_run["summary"]):
        raise AssertionError("6d: the crash replay differs from phase 3's run")
    log(f"6d simulate with a scheduler crash at t = {SIM_CRASH_T}: "
        f"{len(crashed['commits'])} commits and the summary equal phase 3's; "
        f"{crashed['wall_s']:.2f} s wall, launches {d_launches}")
    out["6d"] = {"wall_s": crashed["wall_s"], "launches": d_launches}

    # 6e: the launcher, on the card and on the host
    lines = {}
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve_auction.main(LAUNCHER_ARGV + ["--device", device])
        if rc != 0:
            raise AssertionError(f"6e: serve_auction --device {device} "
                                 f"exited {rc}")
        lines[device] = (buf.getvalue().strip(), time.perf_counter() - t0)
    if lines["cuda"][0] != lines["cpu"][0]:
        raise AssertionError(f"6e: the launcher's lines differ: {lines}")
    log(f"6e serve_auction {' '.join(LAUNCHER_ARGV)}: the same line on "
        f"--device cuda ({lines['cuda'][1]:.2f} s) and cpu "
        f"({lines['cpu'][1]:.2f} s): {lines['cuda'][0]}")
    out["6e"] = {"wall_s": {d: w for d, (_, w) in lines.items()}}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 6 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 7: training falcon-mamba-7b under the JASDA executor
# ---------------------------------------------------------------------------

#: the full-width training run: falcon-mamba-7b cut from 64 to 32 layers.
#: AdamW's 12 bytes a param at 64 layers, 87 GB, exceed the card's 80 GB;
#: 32 layers peak at 56.1 GB.  40 layers ran too, but their loss did not
#: fall over the 8 steps under the launcher's (untuned) schedule (PERF.md)
TRAIN_LAYERS = 32
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 8
#: the TPU kernel whose backward the K5 backward is; the reference has no
#: backward kernel (it differentiates its scan through XLA)
K5_BWD_REPLACES = ("src/repro/kernels/linear_scan/kernel.py:51 (backward; "
                   "the reference has no backward kernel)")
#: the launcher's reduced run, on the card and on the host
TRAIN_LAUNCHER_ARGV = ["--arch", "falcon_mamba_7b", "--reduced", "--steps", "20"]


def check_scan_bwd_kernel(torch, dev, k5, ref):
    """K5's backward bit-equal to its plain reverse loop: da, db and dh0;
    times and bounds.  The training path's case (no h0, no cotangent on
    h_T) is the row's main case."""
    d_full = 8192 * 16
    cases = [(4, 512, d_full, torch.float32, True),
             (4, 512, d_full, torch.float32, False),
             (1, 37, d_full, torch.float32, True),
             (1, 512, 4096, torch.float32, False),
             (2, 256, 8192, torch.bfloat16, False)]
    lib = k5._lib()
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for n, (b, t, d, dtype, with_h0) in enumerate(cases):
        a, x, h0 = scan_inputs(torch, dev, b, t, d, dtype, SEED + 40 + n)
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 60 + n)
        gh = torch.randn((b, t, d), generator=g, device=dev).to(dtype)
        ghT = torch.randn((b, d), generator=g, device=dev) if with_h0 else None
        h0 = h0 if with_h0 else None
        h, _ = k5.linear_scan_cuda(a, x, h0)
        del x
        got = k5.linear_scan_bwd_cuda(a, h, h0, gh, ghT)
        want = ref.linear_scan_bwd_reference(a, h, h0, gh, ghT)
        torch.cuda.synchronize()
        name = (f"K5 backward ({b}, {t}, {d}) {str(dtype)[6:]} "
                f"h0={with_h0} ghT={with_h0}")
        for part, u, v in zip(("da", "db", "dh0"), got, want):
            if (u is None) != (v is None) or (
                    u is not None and not torch.equal(u, v)):
                err = (float((u.float() - v.float()).abs().max().item())
                       if u is not None and v is not None else None)
                raise AssertionError(f"{name}: {part} not bit-equal "
                                     f"(max abs {err})")
            if u is not None and not torch.isfinite(u).all():
                raise AssertionError(f"{name}: non-finite {part}")
        del got, want
        h0f = None if h0 is None else h0.float().contiguous()
        da, db = torch.empty_like(a), torch.empty_like(a)
        dh0 = None if h0 is None else torch.empty_like(h0f)
        code = k5._DTYPES[dtype]

        def raw():  # the kernel alone: no validation or allocation per call
            lib.linear_scan_bwd_launch(
                a.data_ptr(), h.data_ptr(), None if h0f is None else h0f.data_ptr(),
                gh.data_ptr(), None if ghT is None else ghT.data_ptr(),
                b, t, d, code, da.data_ptr(), db.data_ptr(),
                None if dh0 is None else dh0.data_ptr(), stream)

        ms = time_ms(torch, raw, reps=11, inner=10)
        plain_ms = time_ms(torch, lambda: ref.linear_scan_bwd_reference(
            a, h, h0, gh, ghT), reps=3, inner=1)
        fwd_ms = None
        if (b, t, d) == (4, 512, d_full) and not with_h0:
            # the forward at the training shape, for the record (the
            # cotangent stands in for the input; h is overwritten)
            fwd_ms = time_ms(torch, lambda: lib.linear_scan_launch(
                a.data_ptr(), gh.data_ptr(), None, b, t, d, code,
                h.data_ptr(), da.data_ptr(), stream), reps=11, inner=10)
        size = a.element_size()
        # a, h and gh read once, da and db written once; with h0, h0 and
        # ghT read and dh0 written (float32)
        n_bytes = 5 * b * t * d * size + (3 * b * d * 4 if with_h0 else 0)
        n_ops = 3 * b * t * d  # one add and two multiplies an element
        bound_s = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
        log(f"{name}: bit-equal, kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound_s * 1e3:.5f} ms ({n_bytes} bytes)"
            + ("" if fwd_ms is None else
               f"; the forward (K5) at this shape {fwd_ms:.4f} ms, bound "
               f"{3 * b * t * d * size / HBM_BYTES_PER_S * 1e3:.5f} ms"))
        rows.append({
            "shape": [b, t, d], "dtype": str(dtype)[6:], "h0": with_h0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / F32_OPS_PER_S
            else "operations", "fwd_ms": fwd_ms,
        })
        del a, h, h0, gh, ghT, da, db, dh0, h0f
    torch.cuda.empty_cache()
    main = next(r for r in rows if r["shape"] == [4, 512, d_full] and not r["h0"])
    return {"max_abs_err": 0.0, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "shape": {"B": 4, "T": 512, "D": d_full, "dtype": "float32"},
            "cases": rows}


def _train_batch(torch, dev, cfg, step: int):
    from repro_torch.data import DataConfig, SyntheticTokens

    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    return {k: torch.from_numpy(v).to(dev) for k, v in data.batch(step).items()}


def train_step_check(torch, dev, k5, card: str) -> dict:
    """7b: one train step at full width through K5 against the same step's
    loss and gradient norm through the plain scan, from the same params
    and batch, both on the card."""
    from repro_torch.configs import get
    from repro_torch.models import Model
    from repro_torch.training import (adamw, global_norm, make_accum_steps,
                                      make_train_step, warmup_cosine)

    cfg = get("falcon_mamba_7b").replace(n_layers=TRAIN_LAYERS)
    params = Model(cfg).init(SEED, device=dev)
    batch = _train_batch(torch, dev, cfg, 0)
    opt = adamw(warmup_cosine(3e-4, min(50, TRAIN_STEPS // 4 + 1), TRAIN_STEPS))

    # the plain scan's loss and gradient norm (no update: params unchanged)
    k5.LAUNCHES.update(linear_scan=0, linear_scan_bwd=0)
    micro_step, _ = make_accum_steps(Model(cfg, scan_impl="torch"), opt,
                                     accum_dtype=cfg.dtype)
    t0 = time.perf_counter()
    acc, plain_loss = micro_step(params, _zeros_like(torch, params), batch)
    plain_norm = float(global_norm(acc))
    plain_loss = float(plain_loss)
    plain_s = time.perf_counter() - t0
    if any(k5.LAUNCHES.values()):
        raise AssertionError(f"the plain-scan step launched K5: {k5.LAUNCHES}")
    del acc
    torch.cuda.empty_cache()

    # the same step through K5, as the trainer runs it (update included)
    opt_state = opt.init(params)
    step = make_train_step(Model(cfg), opt)
    k5.LAUNCHES.update(linear_scan=0, linear_scan_bwd=0)
    t0 = time.perf_counter()
    params, opt_state, m = step(params, opt_state, batch, 0)
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    k5_s = time.perf_counter() - t0
    fwd, bwd = k5.LAUNCHES["linear_scan"], k5.LAUNCHES["linear_scan_bwd"]
    del params, opt_state, step, m
    torch.cuda.empty_cache()

    loss_gap = abs(loss - plain_loss) / abs(plain_loss)
    norm_gap = abs(norm - plain_norm) / abs(plain_norm)
    log(f"7b one train step, falcon-mamba-7b {cfg.n_layers} layers, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} [{card}]: K5 loss {loss!r} grad norm "
        f"{norm!r} ({k5_s:.2f} s, first step); plain scan loss {plain_loss!r} "
        f"grad norm {plain_norm!r} ({plain_s:.2f} s, no update); relative gaps "
        f"{loss_gap:.3g} and {norm_gap:.3g} (tolerance 1e-3); K5 launches "
        f"{fwd} forward, {bwd} backward")
    if not (math.isfinite(loss) and math.isfinite(norm)):
        raise AssertionError("7b: non-finite loss or gradient norm")
    if loss_gap > 1e-3 or norm_gap > 1e-3:
        raise AssertionError(f"7b: K5 and plain-scan steps differ: loss gap "
                             f"{loss_gap}, grad norm gap {norm_gap}")
    want_fwd, want_bwd = 2 * cfg.n_layers, cfg.n_layers  # remat recomputes
    if (fwd, bwd) != (want_fwd, want_bwd):
        raise AssertionError(f"7b: K5 launched {fwd} forward and {bwd} "
                             f"backward, expected {want_fwd} and {want_bwd}")
    return {"loss": loss, "grad_norm": norm, "plain_loss": plain_loss,
            "plain_grad_norm": plain_norm, "loss_gap": loss_gap,
            "grad_norm_gap": norm_gap, "launches": {"fwd": fwd, "bwd": bwd},
            "k5_step_s": k5_s, "plain_grads_s": plain_s}


def _zeros_like(torch, tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(torch, v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def train_profile(torch, step_once, what: str, card: str) -> dict:
    """``step_once()``, one more train step, under torch.profiler: its
    device time by kernel group and name, and its device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = profiled_events(torch, prof)
    del prof
    release_profiler()
    groups, names = {}, {}
    n_events = 0
    for name, on_card, t0, t1 in events:
        if not on_card:
            continue
        n_events += 1
        sec = (t1 - t0) / 1e9
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + sec
        label = kernel_label(name)
        names[label] = names.get(label, 0.0) + sec
    busy = sum(groups.values())
    if busy == 0.0:
        log(f"{what}: device time not measured (the profiler saw no device "
            "time)")
        return {}
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    log(f"{what} under torch.profiler [{card}]: "
        f"{wall:.3f} s wall, device busy {busy:.4f} s ({100 * busy / wall:.1f}% "
        f"of the wall) in {n_events} device events; by group: " + ", ".join(
            f"{g} {v:.4f} s" for g, v in sorted(groups.items(), key=lambda kv: -kv[1]))
        + "; top kernels: " + ", ".join(f"{k} {v:.4f} s" for k, v in top))
    return {"wall_s": wall, "busy_s": busy, "groups": groups,
            "device_events": n_events}


def train_split(torch, dev, run, step: int, card: str) -> dict:
    """One more step of ``run`` as the trainer's two halves, each timed on
    the host clock between synchronises: the loss and its gradients
    (``make_accum_steps``' micro step) and clip + the run's optimizer +
    apply (its apply step)."""
    from repro_torch.training import make_accum_steps

    micro, apply_step = make_accum_steps(run.model, run.opt,
                                         accum_dtype=run.model.cfg.dtype)
    params, opt_state = run.state["params"], run.state["opt"]
    batch = _train_batch(torch, dev, run.model.cfg, step)
    acc = _zeros_like(torch, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, loss = micro(params, acc, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params, opt_state, m = apply_step(params, opt_state, acc, step)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del acc
    torch.cuda.empty_cache()
    out = {"grad_s": t1 - t0, "update_s": t2 - t1, "loss": float(loss)}
    log(f"7c one step (step {step}) in two halves [{card}]: loss and "
        f"gradients {out['grad_s']:.4f} s, clip + AdamW + apply "
        f"{out['update_s']:.4f} s (host clock, synchronised)")
    return out


def launcher_on_card_and_host(tag: str, argv) -> dict:
    """``python -m repro_torch.launch.train *argv`` in subprocesses on cuda
    and on cpu: both exit 0 and their losses agree within 1e-4 (relative)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    losses = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *argv,
             "--device", device],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{tag}: launch.train --device {device} "
                                 f"exited {proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
        line = next(x for x in proc.stdout.splitlines()
                    if x.startswith("losses: "))
        losses[device] = json.loads(line[len("losses: "):])
        log(f"{tag} launch.train {' '.join(argv)} --device {device}: exit 0 "
            f"in {time.perf_counter() - t0:.2f} s; "
            + proc.stdout.strip().splitlines()[-1])
    a, b = losses["cuda"], losses["cpu"]
    gap = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    if len(a) != len(b) or not gap <= 1e-4:
        raise AssertionError(f"{tag}: cuda and cpu losses differ (largest "
                             f"relative gap {gap}): {a} vs {b}")
    log(f"{tag}: the {len(a)} losses agree on cuda and cpu, largest relative "
        f"gap {gap:.3g} (tolerance 1e-4)")
    return {"gap": gap, "losses": losses}


def training_path(torch, dev, k5, k5_ref, card: str) -> dict:
    """Phase 7: K5's backward (7a), one train step against the plain scan
    (7b), 8 steps under the executor through the launcher's ``train``
    (7c), the launcher itself on the card and on the host (7d)."""
    from repro_torch.configs import get, info
    from repro_torch.launch.train import train

    t_phase = time.perf_counter()
    gc.collect()  # what phases 4-6 left behind, before 7 allocates
    torch.cuda.empty_cache()
    log(f"phase 7 starts with {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        f"allocated on the card")
    out = {"7a": check_scan_bwd_kernel(torch, dev, k5, k5_ref)}
    out["7b"] = train_step_check(torch, dev, k5, card)

    # 7c: the launcher's function, 8 steps under JasdaExecutor
    cfg = get("falcon_mamba_7b").replace(n_layers=TRAIN_LAYERS)
    boundaries = []
    lane = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.empty_cache()
    if torch.cuda.memory_allocated() > 1e9:
        raise AssertionError(f"7c: 7b left {torch.cuda.memory_allocated()} "
                             f"bytes allocated on the card")
    torch.cuda.reset_peak_memory_stats()
    k5.LAUNCHES.update(linear_scan=0, linear_scan_bwd=0)
    t0 = time.perf_counter()
    run = train(cfg, optimizer=info("falcon_mamba_7b").optimizer,
                steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                device=dev, init_device=dev,
                checkpoint_fn=lambda s, _state: boundaries.append(s),
                lane_bytes=lane, max_wall=600.0)
    wall = time.perf_counter() - t0
    launches = dict(k5.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ran = [i for s0, n in run.chunks for i in range(s0, s0 + n)]
    ends = [s0 + n for s0, n in run.chunks]
    if ran != list(range(TRAIN_STEPS)) or boundaries != ends:
        raise AssertionError(f"7c: chunks {run.chunks} and checkpoints "
                             f"{boundaries} do not run every step once, in order")
    if not all(math.isfinite(x) for x in run.losses + run.grad_norms):
        raise AssertionError(f"7c: non-finite losses {run.losses}")
    if not run.losses[-1] < run.losses[0]:
        raise AssertionError(f"7c: the loss did not fall: {run.losses}")
    want = {"linear_scan": 2 * cfg.n_layers * TRAIN_STEPS,
            "linear_scan_bwd": cfg.n_layers * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"7c: K5 launches {launches}, expected {want}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    free_gb = lane / 1e9 - peak_gb
    log(f"7c falcon-mamba-7b ({cfg.n_layers} of 64 layers, {run.n_params} "
        f"params, AdamW, remat, clip 1.0) under JasdaExecutor [{card}]: "
        f"{TRAIN_STEPS} steps in chunks {run.chunks}, checkpoints at "
        f"{boundaries}, {wall:.2f} s wall; losses {run.losses}; grad norms "
        f"{run.grad_norms}; step s {[round(x, 4) for x in run.step_s]}; "
        f"tokens/s a step {[round(tokens / x, 1) for x in run.step_s]}; "
        f"K5 launches {launches}; peak memory {peak_gb:.3f} GB "
        f"({free_gb:.3f} GB of the card's {lane / 1e9:.3f} GB free)")
    prof = train_profile(torch, lambda: run.run_steps(TRAIN_STEPS, 1),
                         f"7c one train step (step {TRAIN_STEPS})", card)
    split = train_split(torch, dev, run, TRAIN_STEPS + 1, card)
    out["7c"] = {"losses": run.losses, "grad_norms": run.grad_norms,
                 "step_s": run.step_s, "chunks": run.chunks, "wall_s": wall,
                 "peak_gb": peak_gb, "launches": launches,
                 "n_params": run.n_params, "profile": prof, "split": split}
    del run
    torch.cuda.empty_cache()

    out["7d"] = launcher_on_card_and_host("7d", TRAIN_LAUNCHER_ARGV)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 7 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the MoE family and the dense configs, served through K4
# ---------------------------------------------------------------------------

#: the configs phase 8 adds, each also held reduced on the card to the host
NEW_ARCHS = ("olmoe_1b_7b", "granite_moe_3b_a800m", "qwen3_14b", "qwen1_5_4b",
             "starcoder2_15b", "llama3_405b")
#: llama3-405b's layers served at full width: 8 of its 126 fit one card
#: (3.19 B params a layer and 4.2 B of embeddings, 59 GB in bf16)
LLAMA_LAYERS = 8


def prompt_traffic(np, vocab: int, fixed, lo: int, hi: int, seed: int):
    """``fixed`` prompt lengths and 4 seeded ones in [lo, hi], longest first
    among the seeded; random token ids below ``vocab``."""
    rng = np.random.default_rng(seed)
    lens = list(fixed) + sorted(
        (int(n) for n in rng.choice(np.arange(lo, hi + 1), 4, replace=False)),
        reverse=True)
    return lens, [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def free_card(torch, what: str) -> None:
    """Collect what was dropped, return the cached blocks and print the
    peak memory since the last reset."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{what} freed: {torch.cuda.memory_allocated() / 1e9:.3f} GB still "
        f"allocated; peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    torch.cuda.reset_peak_memory_stats()


def init_model(torch, dev, cfg, what: str):
    from repro_torch.models import Model

    t0 = time.perf_counter()
    params = Model(cfg).init(SEED, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in _leaves(params))
    active = (f" ({cfg.active_param_count()} active a token)"
              if cfg.family == "moe" else "")
    log(f"{what}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"q heads on {cfg.n_kv_heads} kv heads, head dim {cfg.hd}, "
        f"{str(cfg.dtype)[6:]}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}); {n} params{active} (param_count "
        f"{cfg.param_count()}) initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return params


def moe_serving(np, torch, dev, k4, arch: str, seed: int, card: str, *,
                profile: bool) -> dict:
    """8a / 8b: a full-width MoE config through K4 and auto, its K4 traffic
    served once more (under torch.profiler with ``profile``) to the same
    drops."""
    from repro_torch.configs import get
    from repro_torch.models import Model

    t0 = time.perf_counter()
    cfg = get(arch)
    params = init_model(torch, dev, cfg, f"{cfg.name} full width and depth")
    lens, prompts = prompt_traffic(np, cfg.vocab_size, (2048, 1536, 1024, 512),
                                   64, 512, seed)
    max_new, max_seq = 16, 2112
    warm = torch.from_numpy(prompts[0][:64]).to(dev)[None]
    for impl in ("pallas", "auto"):  # load cuBLAS and the kernels, untimed
        Model(cfg).prefill(params, warm, impl=impl)
    torch.cuda.synchronize()
    out = serve_k4_and_auto(np, torch, dev, k4, cfg, params, lens, prompts,
                            max_new=max_new, max_seq=max_seq, card=card,
                            drops_at=2048)
    t1 = time.perf_counter()
    timed = out.pop("timed")
    with RouteRecorder(2048) as again:  # the same K4 traffic once more
        if profile:
            out["device_busy"] = serving_profile(
                torch, dev, Model(cfg), params, prompts, max_new, timed,
                card, max_seq=max_seq, attn_impl="pallas", top=14)
        else:
            serve_requests(torch, dev, Model(cfg), params, prompts,
                           max_new=max_new, max_seq=max_seq,
                           attn_impl="pallas", cache_leaves=False)
    log(f"{cfg.name}: served {'under torch.profiler' if profile else 'again'}"
        f" in {time.perf_counter() - t1:.1f} s wall, its processing included")
    if again.total() != out["drops"]["pallas"]:
        raise AssertionError(f"{cfg.name}: the K4 traffic served again dropped "
                             f"{again.total()} choices, the first time "
                             f"{out['drops']['pallas']}")
    log(f"{cfg.name}: the K4 traffic served again drops the same "
        f"{again.total()} choices")
    del params
    free_card(torch, cfg.name)
    out["wall_s"] = time.perf_counter() - t0
    return out


def qwen3_serving(np, torch, dev, k4, card: str) -> dict:
    """8c: qwen3-14b at full width and depth through K4 and auto; its
    4096-token prefill timed again in turns (printed, not gated: K4 loses
    to SDPA at these GQA widths)."""
    from repro_torch.configs import get
    from repro_torch.models import Model

    t0 = time.perf_counter()
    cfg = get("qwen3_14b")
    params = init_model(torch, dev, cfg, "qwen3-14b full width and depth")
    lens, prompts = prompt_traffic(np, cfg.vocab_size, (4096, 3072, 2048, 1024),
                                   128, 2047, SEED + 82)
    max_new, max_seq = 16, 4224
    warm = torch.from_numpy(prompts[0][:64]).to(dev)[None]
    for impl in ("pallas", "auto"):
        Model(cfg).prefill(params, warm, impl=impl)
    torch.cuda.synchronize()
    out = serve_k4_and_auto(np, torch, dev, k4, cfg, params, lens, prompts,
                            max_new=max_new, max_seq=max_seq, card=card)
    out.pop("timed")
    out["longest_prefill_ms"] = longest_prefill_ms(
        torch, dev, Model(cfg), params, prompts[0], max_seq)
    med = out["longest_prefill_ms"]["median"]
    log(f"qwen3-14b 4096-token prefill [{card}]: serving run "
        f"{out['pallas']['prefill_ms'][0]:.2f} ms through K4, "
        f"{out['auto']['prefill_ms'][0]:.2f} ms through auto; medians of 3 "
        f"in turns {med['pallas']:.2f} / {med['auto']:.2f} ms (samples "
        f"{out['longest_prefill_ms']['samples']}); not gated")
    del params
    free_card(torch, cfg.name)
    out["wall_s"] = time.perf_counter() - t0
    return out


def dense_serving(np, torch, dev, k4, card: str) -> dict:
    """8d: qwen1.5-4b and starcoder2-15b at full width and depth, and
    llama3-405b at full width with LLAMA_LAYERS layers: one 2048-token
    prefill and 8 decode steps each, through K4 and through auto."""
    from repro_torch.configs import get
    from repro_torch.models import Model

    out = {}
    for arch in ("qwen1_5_4b", "starcoder2_15b", "llama3_405b"):
        t0 = time.perf_counter()
        cfg = get(arch)
        what = f"{cfg.name} full width and depth"
        if arch == "llama3_405b":
            what = (f"{cfg.name} full width, {LLAMA_LAYERS} of its "
                    f"{cfg.n_layers} layers")
            cfg = cfg.replace(n_layers=LLAMA_LAYERS)
        params = init_model(torch, dev, cfg, what)
        lens, prompts = [2048], [np.random.default_rng(SEED + 83).integers(
            0, cfg.vocab_size, 2048).astype(np.int32)]
        warm = torch.from_numpy(prompts[0][:64]).to(dev)[None]
        for impl in ("pallas", "auto"):
            Model(cfg).prefill(params, warm, impl=impl)
        torch.cuda.synchronize()
        res = serve_k4_and_auto(np, torch, dev, k4, cfg, params, lens, prompts,
                                max_new=9, max_seq=2064, card=card)
        res.pop("timed")
        del params
        free_card(torch, cfg.name)
        res["wall_s"] = time.perf_counter() - t0
        out[arch] = res
    return out


#: a card choice that differs from the host's must be a near-tie: the
#: host's router probabilities of the two experts within this much
#: (the card's and the host's inputs to the router differ by ~1e-6)
ROUTE_TIE_TOL = 1e-6
#: the card's gates against the host's where both chose the same experts
ROUTE_GATE_TOL = 1e-6


def plain_slots(np, expert, capacity: int):
    """Each (group, token, choice)'s slot in its expert's queue, counted
    one by one in the reference's priority (choice-major, then token
    order), and whether it is below ``capacity``."""
    n_groups, g, k = expert.shape
    slot = np.empty_like(expert)
    for grp in range(n_groups):
        taken = {}
        for j in range(k):
            for i in range(g):
                e = int(expert[grp, i, j])
                slot[grp, i, j] = taken.get(e, 0)
                taken[e] = slot[grp, i, j] + 1
    return slot, slot < capacity


def routing_gate(np, torch, name: str, routes: dict) -> dict:
    """The card's routing against the host's, call by call.  Gated: each
    card slot and kept choice equals a one-by-one count over the card's
    experts; where a token's experts differ, every rank's two experts lie
    within ROUTE_TIE_TOL in the host's router probabilities; where they
    agree, the gates lie within ROUTE_GATE_TOL.  Printed: the tokens moved
    and their smallest gap, the gates that round to another bfloat16 and
    their largest float32 gap, and the largest card/host probability gap."""
    moved = flips = 0
    tie_gap = flip_gap = None
    prob_gap = gate_gap = 0.0
    for n, (c, h) in enumerate(zip(routes["card"], routes["host"])):
        where = f"{name}, routing call {n}"
        slot, keep = plain_slots(np, c["expert"].numpy(), c["capacity"])
        if c["capacity"] != h["capacity"] or not (
                np.array_equal(c["slot"].numpy(), slot)
                and np.array_equal(c["keep"].numpy(), keep)):
            raise AssertionError(f"{where}: the card's slots or kept choices "
                                 "are not its experts' queue positions")
        prob_gap = max(prob_gap, float((c["probs"] - h["probs"]).abs().max()))
        apart = (c["expert"] != h["expert"]).any(dim=-1)
        moved += int(apart.sum())
        if apart.any():
            pc = h["probs"].gather(-1, c["expert"])[apart]
            ph = h["probs"].gather(-1, h["expert"])[apart]
            g = float((pc - ph).abs().max())
            if not g <= ROUTE_TIE_TOL:
                raise AssertionError(
                    f"{where}: {int(apart.sum())} tokens routed to other "
                    f"experts on the card, host probabilities {g} apart "
                    f"(near-tie limit {ROUTE_TIE_TOL})")
            tie_gap = g if tie_gap is None else max(tie_gap, g)
        same = ~apart[..., None].expand_as(c["gate"])
        gate_gap = max(gate_gap, float(
            torch.where(same, (c["gate"] - h["gate"]).abs(), 0.0).max()))
        bf16 = torch.bfloat16
        flip = same & (c["gate"].to(bf16) != h["gate"].to(bf16))
        flips += int(flip.sum())
        if flip.any():
            g = float((c["gate"] - h["gate"]).abs()[flip].max())
            flip_gap = g if flip_gap is None else max(flip_gap, g)
    if not gate_gap <= ROUTE_GATE_TOL:
        raise AssertionError(f"{name}: the card's gates part from the host's "
                             f"by {gate_gap} (limit {ROUTE_GATE_TOL})")
    return {"tokens_moved": moved, "largest_tie_gap": tie_gap,
            "bf16_gate_flips": flips, "largest_flip_gap": flip_gap,
            "largest_gate_gap": gate_gap, "largest_prob_gap": prob_gap}


def reduced_on_card(np, torch, dev, k4) -> dict:
    """8e: the six configs reduced (float32) on the card through K4 against
    the host, a prefill and 8 decode steps within REDUCED_TOL (for MoE with
    the card's routing replayed on the host, ``card_vs_host``), and for MoE
    the card's routing held to the host's by ``routing_gate`` (cuBLAS and
    the host's float32 products may part in their last bits, which moves a
    choice only on a near-tie)."""
    from repro_torch.configs import reduced

    out = {}
    for n, arch in enumerate(NEW_ARCHS):
        cfg = reduced(arch)
        k4.LAUNCHES["flash_attention"] = 0
        res = card_vs_host(np, torch, dev, cfg, SEED + 90 + n, "pallas")
        if k4.LAUNCHES["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"reduced {arch}: K4 launched "
                                 f"{k4.LAUNCHES['flash_attention']} times, "
                                 f"expected {cfg.n_layers}")
        row = {"gap": res["gap"]}
        txt = ""
        if cfg.family == "moe":
            row.update(routing_gate(np, torch, cfg.name, res["routes"]),
                       own_gap=res["own_gap"])
            txt = (f" with the card's routing replayed on the host; with the "
                   f"host's own {res['own_gap']:.3g}; of "
                   f"{len(res['routes']['host'])} routing calls, slots and "
                   f"kept choices equal to a plain count on every call, "
                   f"{row['tokens_moved']} tokens routed to other experts on "
                   f"the card (largest host-probability gap among them "
                   f"{row['largest_tie_gap']}, limit {ROUTE_TIE_TOL}), gates "
                   f"within {row['largest_gate_gap']:.3g} of the host's (limit "
                   f"{ROUTE_GATE_TOL}), {row['bf16_gate_flips']} of them "
                   f"rounded to another bfloat16 (largest float32 gap "
                   f"{row['largest_flip_gap']}); router probabilities within "
                   f"{row['largest_prob_gap']:.3g} of the host's")
        log(f"reduced {cfg.name}: card (K4) and host logits agree, prefill + 8 "
            f"decode steps, max abs gap {res['gap']:.3g} (tolerance "
            f"{REDUCED_TOL}){txt}")
        out[arch] = row
    return out


def models_path(np, torch, dev, k4, card: str) -> dict:
    """Phase 8: the MoE family and the dense configs through K4."""
    from repro_torch.configs import get
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"8a": moe_serving(np, torch, dev, k4, "olmoe_1b_7b", SEED + 80,
                             card, profile=True),
           "8b": moe_serving(np, torch, dev, k4, "granite_moe_3b_a800m",
                             SEED + 81, card, profile=False),
           "8c": qwen3_serving(np, torch, dev, k4, card),
           "8d": dense_serving(np, torch, dev, k4, card)}
    t0 = time.perf_counter()
    out["8e"] = reduced_on_card(np, torch, dev, k4)
    out["8e"]["wall_s"] = time.perf_counter() - t0

    # 8f: the launcher a user runs, on the card at full width (its own
    # params and 8 short synthetic prompts): every request must finish
    t0 = time.perf_counter()
    k4.LAUNCHES["flash_attention"] = 0
    if serve.main(["--arch", "olmoe_1b_7b", "--attn-impl", "pallas",
                   "--json"]) != 0:
        raise AssertionError("launch.serve --arch olmoe_1b_7b --attn-impl "
                             "pallas failed on the card")
    n_layers = get("olmoe_1b_7b").n_layers
    if k4.LAUNCHES["flash_attention"] != n_layers * 8:
        raise AssertionError(f"launch.serve launched K4 "
                             f"{k4.LAUNCHES['flash_attention']} times, "
                             f"expected {n_layers} layers x 8 requests")
    free_card(torch, "launch.serve olmoe-1b-7b")
    out["8f"] = {"k4_launches": k4.LAUNCHES["flash_attention"],
                 "wall_s": time.perf_counter() - t0}
    log(f"launch.serve --arch olmoe_1b_7b --attn-impl pallas on the card: 8 "
        f"requests finished, K4 launches {out['8f']['k4_launches']}")
    out["k4_launches"] = {
        "olmoe_1b_7b": out["8a"]["k4_launches"],
        "granite_moe_3b_a800m": out["8b"]["k4_launches"],
        "qwen3_14b": out["8c"]["k4_launches"],
        **{a: r["k4_launches"] for a, r in out["8d"].items()}}
    out["wall_s"] = time.perf_counter() - t_phase
    log("phase 8 walls (s): " + ", ".join(
        f"{k} {v['wall_s']:.1f}" for k, v in out.items()
        if isinstance(v, dict) and "wall_s" in v)
        + ", " + ", ".join(f"8d {a} {r['wall_s']:.1f}"
                           for a, r in out["8d"].items()))
    log(f"phase 8 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 9: the cross-attention families (whisper-small, llama-3.2-vision)
# ---------------------------------------------------------------------------

#: (batch, prompt tokens, new tokens) of whisper-small's two prefills over
#: one 1500-frame memory a row: the start-of-transcript prefix, and a
#: previous-text prompt of half the 448-token context
WHISPER_RUNS = ((4, 4, 64), (4, 224, 16))
WHISPER_MAX_SEQ = 448
#: llama-3.2-vision-90b's layers run at full width: 20 of its 100 (4
#: superblocks of 4 self + 1 cross; 19.2 B params, 38.5 GB in bf16)
VLM_LAYERS = 20
VLM_RUN = (2, 2048, 16)
VLM_MAX_SEQ = 2112
XATTN_ARCHS = ("whisper_small", "llama3_2_vision_90b")
XATTN_LAUNCHER_ARGV = ["--arch", "whisper_small", "--reduced", "--steps", "20"]


def live_params(torch, cfg, params, seed: int) -> None:
    """Draw the leaves the reference draws as zeros from ``seed``, in place:
    LayerNorm scales (``encdec``) 1 + 0.3 N(0, 1), every other zeros leaf
    (biases, the VLM's tanh gates, RMSNorm scales, which add 1) 0.3 N(0, 1).
    With the reference's zeros whisper's logits are identically zero and
    the VLM's cross attention reaches nothing."""
    from repro_torch.models.params import P, build_template

    gen = None

    def walk(tpl, p, name):
        nonlocal gen
        if not isinstance(tpl, P):
            for k in tpl:
                walk(tpl[k], p[k], k)
            return
        if tpl.init != "zeros":
            return
        if gen is None:
            gen = torch.Generator(device=p.device)
            gen.manual_seed(seed)
        scale = name.endswith("_scale") or name == "final_norm"
        base = 1.0 if cfg.family == "encdec" and scale else 0.0
        noise = torch.randn(p.shape, generator=gen, device=p.device)
        p.copy_(base + 0.3 * noise)

    walk(build_template(cfg), params, "")


def xattn_prefill_profile(torch, model, params, toks, memory, max_seq: int):
    """One more prefill through K4 under torch.profiler: device seconds by
    kernel group, and K4's share of them (None where the profiler saw no
    device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.prefill(params, toks, memory=memory, impl="pallas",
                      max_seq=max_seq)
        torch.cuda.synchronize()
    groups = device_seconds(torch, prof, (), kernel_group)
    del prof
    release_profiler()
    busy = sum(groups.values())
    return {"busy_s": busy, "groups": groups,
            "k4_share": groups.get("K4", 0.0) / busy if busy else None}


def xattn_k4_and_auto(np, torch, dev, k4, cfg, params, memory, toks, *,
                      new: int, max_seq: int, card: str, what: str) -> dict:
    """One batch of prompts over ``memory`` through ``Model.prefill`` with
    attention through K4 and through "auto", then ``new`` greedy tokens a
    row by ``decode_step`` against the prefill's cross stack.  Gated: K4
    launches once an attention layer in the K4 prefill, never in decode or
    through auto; ``cross_kv`` once a prefill, its stack (L_cross, B, T,
    Hkv, hd); finite logits; tokens below the vocab; the first-token gate."""
    from types import SimpleNamespace

    from repro_torch.models import Model

    model = Model(cfg)
    n_cross = cfg.n_layers if cfg.family == "encdec" else cfg.n_super
    n_attn = cfg.n_layers + (cfg.n_encoder_layers + cfg.n_layers
                             if cfg.family == "encdec" else 0)
    b, s = toks.shape
    t_mem = memory.shape[1]
    want_cross = (n_cross, b, t_mem, cfg.n_kv_heads, cfg.hd)
    calls = [0]
    real_cross_kv = model.cross_kv

    def cross_kv(*args, **kw):
        calls[0] += 1
        return real_cross_kv(*args, **kw)

    model.cross_kv = cross_kv
    vocab = cfg.vocab_size
    runs = {}
    for impl in ("pallas", "auto"):
        k4.LAUNCHES["flash_attention"] = 0
        k4.SHAPES.clear()
        calls[0] = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, cross = model.prefill(params, toks, memory=memory,
                                             impl=impl, max_seq=max_seq)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        k4_prefill, shapes = k4.LAUNCHES["flash_attention"], dict(k4.SHAPES)
        got = [tuple(cross[k].shape) for k in ("k", "v")]
        if got != [want_cross] * 2:
            raise AssertionError(f"{what} {impl}: cross stack {got}, expected "
                                 f"{want_cross}")
        first = logits[:, :vocab].float()
        tok = first.argmax(-1)
        rows = [[] for _ in range(b)]
        dec_ms = []
        for i in range(new):
            if not torch.isfinite(logits).all():
                raise AssertionError(f"{what} {impl}: non-finite logits at "
                                     f"token {i}")
            for r, x in zip(rows, tok.tolist()):
                r.append(x)
            if i == new - 1:
                break
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, tok, s + i, cache,
                                              cross_stack=cross)
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            tok = logits[:, :vocab].argmax(-1)
        runs[impl] = {
            "logits": list(first), "prefill_ms": prefill_ms, "dec_ms": dec_ms,
            "reqs": [SimpleNamespace(output=r) for r in rows],
            "k4_prefill": k4_prefill, "k4_decode":
            k4.LAUNCHES["flash_attention"] - k4_prefill, "k4_shapes": shapes,
            "cross_kv_calls": calls[0],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del logits, cache, cross
        bad = [r for r in rows if len(r) != new or not all(0 <= x < vocab for x in r)]
        if bad:
            raise AssertionError(f"{what} {impl}: rows without {new} tokens "
                                 f"below the vocab: {bad}")
        if calls[0] != 1:
            raise AssertionError(f"{what} {impl}: cross_kv ran {calls[0]} times "
                                 "in a prefill and its decode steps")
    pal, auto = runs["pallas"], runs["auto"]
    if pal["k4_prefill"] != n_attn or pal["k4_decode"] or \
            auto["k4_prefill"] or auto["k4_decode"]:
        raise AssertionError(
            f"{what}: K4 launched {pal['k4_prefill']} times in the K4 prefill "
            f"(expected {n_attn}), {pal['k4_decode']} in its decode steps, "
            f"{auto['k4_prefill'] + auto['k4_decode']} through auto (expected 0)")
    unchecked = set(pal["k4_shapes"]) - set(ATTN_CASES)
    if unchecked:
        raise AssertionError(f"{what}: K4 ran at shapes phase 2d does not hold "
                             f"to the plain version: {sorted(unchecked, key=str)}")
    for impl, run in runs.items():
        log(f"{what}, prefill attention {impl} [{card}]: prefill "
            f"{run['prefill_ms']:.2f} ms; {len(run['dec_ms'])} decode steps, "
            f"median {statistics.median(run['dec_ms']):.3f} ms, mean "
            f"{statistics.mean(run['dec_ms']):.3f} ms; peak memory "
            f"{run['peak_gb']:.3f} GB; K4 launches {run['k4_prefill']} in the "
            f"prefill, {run['k4_decode']} in decode; cross_kv once")
    log(f"  K4 shapes (B, Hq, Hkv, Sq, Sk, D, dtype, causal, window, q_offset): "
        f"{pal['k4_shapes']}")
    worst, gated, later_same, later = first_token_gate(pal, auto, [s] * b)
    out = {"prompt": s, "batch": b, "new": new, "k4_launches": pal["k4_prefill"],
           "k4_shapes": {str(k): v for k, v in pal["k4_shapes"].items()},
           "max_logit_gap": worst, "first_token_gated": gated,
           "later_tokens_equal": [later_same, later]}
    for impl, run in runs.items():
        out[impl] = {"prefill_ms": run["prefill_ms"],
                     "decode_ms_median": statistics.median(run["dec_ms"]),
                     "decode_ms_mean": statistics.mean(run["dec_ms"]),
                     "peak_gb": run["peak_gb"]}
    return out


def xattn_model(np, torch, dev, k4, arch: str, card: str) -> dict:
    """9a / 9b: one full-width cross-attention config drawn on the card,
    its memory seeded, its prompt batches through K4 and auto, one
    prefill profiled."""
    from repro_torch.configs import get
    from repro_torch.models import Model

    t0 = time.perf_counter()
    cfg = get(arch)
    if arch == "llama3_2_vision_90b":
        what = (f"{cfg.name} full width, {VLM_LAYERS} of its {cfg.n_layers} "
                f"layers")
        cfg = cfg.replace(n_layers=VLM_LAYERS)
        runs, max_seq = (VLM_RUN,), VLM_MAX_SEQ
    else:
        what = f"{cfg.name} full width and depth"
        runs, max_seq = WHISPER_RUNS, WHISPER_MAX_SEQ
    params = init_model(torch, dev, cfg, what)
    live_params(torch, cfg, params, SEED + 95)
    n_leaves = sum(p.numel() for p in _leaves(params))
    log(f"{cfg.name}: the reference's param_count {cfg.param_count()} beside "
        f"{n_leaves} params in the template's leaves (the count leaves out "
        + ("the decoder's cross stack, the biases and both position tables)"
           if cfg.family == "encdec" else "the gates)"))
    b = runs[0][0]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 96)
    t_mem = cfg.encoder_seq or cfg.vision_seq
    memory = torch.randn((b, t_mem, cfg.d_model), generator=g, device=dev)
    rng = np.random.default_rng(SEED + 97)
    model = Model(cfg)
    warm = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 4))).to(dev)
    for impl in ("pallas", "auto"):  # load cuBLAS and the kernels, untimed
        model.prefill(params, warm, memory=memory, impl=impl)
    torch.cuda.synchronize()
    out = {"param_count": cfg.param_count(), "leaves": n_leaves, "runs": []}
    toks = None
    for bb, s, new in runs:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (bb, s))).to(dev)
        out["runs"].append(xattn_k4_and_auto(
            np, torch, dev, k4, cfg, params, memory, toks, new=new,
            max_seq=max_seq, card=card, what=f"{cfg.name} {s}-token prompts"))
    prof = xattn_prefill_profile(torch, model, params, toks, memory, max_seq)
    share = prof["k4_share"]
    out["prefill_profile"] = prof
    log(f"{cfg.name} {toks.shape[1]}-token prefill through K4 under "
        f"torch.profiler [{card}]: device busy {prof['busy_s']:.4f} s, K4 "
        + ("not measured" if share is None else f"{100 * share:.2f}%")
        + " of it; by group: " + ", ".join(
            f"{k} {v:.4f} s" for k, v in sorted(prof["groups"].items(),
                                                key=lambda kv: -kv[1])))
    del params, memory
    free_card(torch, cfg.name)
    out["k4_launches"] = sum(r["k4_launches"] for r in out["runs"])
    out["wall_s"] = time.perf_counter() - t0
    return out


def xattn_path(np, torch, dev, k4, card: str) -> dict:
    """Phase 9: the cross-attention families through K4."""
    from repro_torch.configs import reduced

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"9a": xattn_model(np, torch, dev, k4, "whisper_small", card),
           "9b": xattn_model(np, torch, dev, k4, "llama3_2_vision_90b", card)}
    t0 = time.perf_counter()
    out["9c"] = {}
    for n, arch in enumerate(XATTN_ARCHS):
        cfg = reduced(arch)
        k4.LAUNCHES["flash_attention"] = 0
        res = card_vs_host(np, torch, dev, cfg, SEED + 98 + n, "pallas")
        want = cfg.n_layers + (cfg.n_encoder_layers + cfg.n_layers
                               if cfg.family == "encdec" else 0)
        if k4.LAUNCHES["flash_attention"] != want:
            raise AssertionError(f"reduced {arch}: K4 launched "
                                 f"{k4.LAUNCHES['flash_attention']} times, "
                                 f"expected {want}")
        log(f"reduced {cfg.name}: card (K4, {want} launches) and host logits "
            f"agree, prefill + 8 decode steps, max abs gap {res['gap']:.3g} "
            f"(tolerance {REDUCED_TOL})")
        out["9c"][arch] = {"gap": res["gap"]}
    out["9c"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["9d"] = launcher_on_card_and_host("9d", XATTN_LAUNCHER_ARGV)
    out["9d"]["wall_s"] = time.perf_counter() - t0
    out["k4_launches"] = {"whisper_small": out["9a"]["k4_launches"],
                          "llama3_2_vision_90b": out["9b"]["k4_launches"]}
    out["wall_s"] = time.perf_counter() - t_phase
    log("phase 9 walls (s): " + ", ".join(
        f"{k} {v['wall_s']:.1f}" for k, v in out.items()
        if isinstance(v, dict) and "wall_s" in v))
    log(f"phase 9 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the auction mesh
# ---------------------------------------------------------------------------

#: virtual row shards of the card in 10b-10f
MESH_SHARDS = 4
#: 10c's K1 rows (T = 32) and 10d's round (bids over 24 windows; the
#: second round of the same bucket drops 4097 of them)
MESH_K1_M = 1 << 20
MESH_ROUND_M = 1 << 17


def check_builds(common, reports: dict, when: str) -> dict:
    """Each kernel source phase 1 built was built exactly once in this
    process (the kernels take every shape, bucket and row slice at run
    time), and nothing else was built."""
    counts = common.build_counts()
    want = {name: 1 for name in reports}
    if counts != want:
        raise AssertionError(f"{when}: builds {counts}, expected {want}")
    log(f"builds after {when}: {counts} (each source once)")
    return counts


def mesh_round(np, m: int, n_windows: int, *, rng, n_jobs: int = 23):
    """``tests/test_sharded_auction.py``'s ``_mk_round``: a random round on
    float32-exact grids (12-bit utilities, half-step intervals)."""
    from repro_torch.core.trp import fmp_standard
    from repro_torch.core.types import Variant, Window

    windows = [Window(f"s{k}", (6 + 2 * (k % 5)) * GB, 0.0, 100.0)
               for k in range(n_windows)]
    fmp = fmp_standard(1 * GB, 2 * GB, 0.1 * GB)
    pool = []
    for i in range(m):
        w = windows[int(rng.integers(0, n_windows))]
        t0 = float(rng.integers(0, 180)) / 2
        dur = float(rng.integers(2, 40)) / 2
        if t0 + dur > 100.0:
            dur = 100.0 - t0
        if dur <= 0:
            continue
        pool.append(Variant(
            job_id=f"J{i % n_jobs}", slice_id=w.slice_id, t_start=t0,
            duration=dur, fmp=fmp,
            local_utility=float(rng.integers(1, 1 << 12)) / (1 << 12),
            declared_features={}, payload={"work": dur}, variant_id=f"v{i}"))
    return windows, pool


def round_sig(rr):
    """Byte-level round signature: selections, scores, feedback, totals."""
    return ([tuple(v.variant_id for v in r.selected) for r in rr.results],
            tuple(rr.scores), rr.selected_idx, rr.total_score, rr.n_conflicts)


def sharded_shapes(shapes: dict, n: int):
    """The launches ``shapes`` (row count first in each key -> launches)
    become under an ``n``-shard mesh: a launch whose rows n divides becomes
    n launches of rows / n; any other stays as it was.  Returns (expected
    shapes, sharded dispatches, unsharded dispatches)."""
    out, split, whole = {}, 0, 0
    for key, count in shapes.items():
        rows = key[0]
        if rows % n == 0:
            new, split = (rows // n,) + tuple(key[1:]), split + count
            out[new] = out.get(new, 0) + n * count
        else:
            out[key] = out.get(key, 0) + count
            whole += count
    return out, split, whole


def same_run(name: str, run: dict, base: dict) -> None:
    if run["commits"] != base["commits"]:
        raise AssertionError(f"{name}: commit log differs from phase 3's")
    if run["summary"] != base["summary"]:
        raise AssertionError(f"{name}: summary differs: {run['summary']}")


def mesh_account(name: str, launches: dict, shapes: dict, base_shapes: dict,
                 n: int) -> dict:
    """Hold a sharded run's launches to phase 3's, split ``n`` ways."""
    out = {}
    for kernel in ("jasda_score", "wis_batch"):
        want, split, whole = sharded_shapes(base_shapes[kernel], n)
        if shapes[kernel] != want:
            raise AssertionError(
                f"{name}: {kernel} launched at {shapes[kernel]}, expected {want}")
        if launches[kernel] != n * split + whole:
            raise AssertionError(
                f"{name}: {kernel} {launches[kernel]} launches, expected "
                f"{n} x {split} sharded + {whole} unsharded dispatches")
        out[kernel] = {"launches": launches[kernel], "sharded_dispatches": split,
                       "unsharded_dispatches": whole}
    return out


def mesh_kernels(np, torch, dev, k1, k2, k1_ref, k2_ref, mesh) -> dict:
    """10c: K1 and K2 split over ``mesh``'s row shards against one launch,
    bit for bit, and timed beside it two ways: the dispatch as the round
    makes it (wrappers, row views, the gather; host launch overhead
    included) and the raw launches alone, each shard writing its rows of
    one output (the kernel time the split costs)."""
    from repro_torch.distributed.sharding import row_slices
    from repro_torch.kernels.jasda_score import ops as score_ops
    from repro_torch.kernels.wis_dp import ops as wis_ops

    n = len(mesh.devices)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    m, t = MESH_K1_M, 32
    args = score_inputs(np, torch, dev, m, t)
    host = [a.cpu().numpy() for a in args]
    kw = dict(lam=host[6], capacity=host[7], theta=host[8], impl="cuda",
              trim=False)
    whole = score_ops.score_variants(*host[:6], device=dev, **kw)
    split = score_ops.score_variants(*host[:6], mesh=mesh, **kw)
    p_score, p_elig, _ = k1_ref.score_variants_reference(
        *args[:6], lam=args[6], capacity=args[7], theta=args[8])
    torch.cuda.synchronize()
    for name, (a, b) in (("sharded", (split, whole)),
                         ("plain", ((p_score, p_elig), whole))):
        if ulp_gap(torch, a[0], b[0]) != 0 or not torch.equal(a[1], b[1]):
            raise AssertionError(f"10c K1 M={m} T={t}: {name} differs from one launch")
    rows = [r for _, r in row_slices(mesh, n, m)]

    def k1_split():
        parts = [k1.score_variants_cuda(*[a if i in (2, 3) else a[r]
                                          for i, a in enumerate(args)])
                 for r in rows]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    lib1 = k1._lib()
    out_s, out_e = torch.empty_like(whole[0]), torch.empty_like(whole[1])

    def k1_raw(cuts):
        for r in cuts:
            ops = [a if i in (2, 3) else a[r] for i, a in enumerate(args)]
            lib1.jasda_score_launch(*[o.data_ptr() for o in ops],
                                    r.stop - r.start, 1, 4, t,
                                    out_s[r].data_ptr(), out_e[r].data_ptr(),
                                    stream)

    k1_row = {"shape": {"M": m, "T": t}, "shards": n,
              "ms": time_ms(torch, lambda: k1.score_variants_cuda(*args),
                            reps=11, inner=10),
              "sharded_ms": time_ms(torch, k1_split, reps=11, inner=10),
              "raw_ms": time_ms(torch, lambda: k1_raw([slice(0, m)]), reps=11,
                                inner=10),
              "raw_sharded_ms": time_ms(torch, lambda: k1_raw(rows), reps=11,
                                        inner=10)}
    torch.cuda.synchronize()
    if ulp_gap(torch, out_s, whole[0]) != 0 or not torch.equal(out_e, whole[1]):
        raise AssertionError("10c K1: the raw row-shard launches differ")
    out["K1"] = k1_row
    log(f"10c K1 M={m} T={t}: {n} row shards concatenated bit-equal to one "
        f"launch and to the plain version; dispatch: one launch "
        f"{k1_row['ms']:.4f} ms, {n} shards + gather "
        f"{k1_row['sharded_ms']:.4f} ms; raw launches: one "
        f"{k1_row['raw_ms']:.4f} ms, {n} shards {k1_row['raw_sharded_ms']:.4f} ms")

    scores = whole[0]
    lib2 = k2._lib()
    for n_rows, lanes, form in ((64, 2048, "fused"), (64, 2048, "fused+transform"),
                                (8, 2048, "batched")):
        ins = settle_inputs(np, torch, dev, n_rows, lanes, m, SEED + 70 + n_rows)
        tr = ins["transform"] if form == "fused+transform" else None
        w = None
        if form == "batched":
            w = k2_ref.fused_weights(scores, ins["idx"], ins["mask"])

            def call(mesh_):
                return wis_ops.wis_settle_batch(w, ins["pred"], impl="cuda",
                                                device=dev, mesh=mesh_)
        else:
            def call(mesh_):
                return wis_ops.wis_settle_fused(
                    scores, ins["idx"], ins["mask"], ins["pred"], impl="cuda",
                    mesh=mesh_, transform=tr)
        one, four = call(None), call(mesh)
        w_plain = k2_ref.fused_weights(scores, ins["idx"], ins["mask"], tr)
        p_sel, p_tot = k2_ref.wis_batch_reference(w_plain, ins["pred"])
        torch.cuda.synchronize()
        name = f"10c K2 W={n_rows} L={lanes} {form}"
        for what, a in (("sharded", four), ("plain", (p_sel, p_tot))):
            if not torch.equal(a[0], one[0]) or ulp_gap(torch, a[1], one[1]) != 0:
                raise AssertionError(f"{name}: {what} differs")
        if not int(one[0].sum().item()):
            raise AssertionError(f"{name}: empty")
        sel, tot = torch.empty_like(one[0]), torch.empty_like(one[1])
        cuts = [r for _, r in row_slices(mesh, n, n_rows)]

        def raw(parts):
            for r in parts:
                def ptr(x):
                    return None if x is None else x[r].data_ptr()
                lib2.wis_batch_launch(
                    ptr(w), None if w is not None else scores.data_ptr(),
                    None if tr is None else tr.data_ptr(),
                    None if w is not None else ptr(ins["idx"]),
                    None if w is not None else ptr(ins["mask"]),
                    ptr(ins["pred"]), r.stop - r.start, lanes,
                    0 if w is not None else m, sel[r].data_ptr(),
                    tot[r].data_ptr(), None, stream)

        row = {"ms": time_ms(torch, lambda: call(None), reps=11, inner=10),
               "sharded_ms": time_ms(torch, lambda: call(mesh), reps=11,
                                     inner=10),
               "raw_ms": time_ms(torch, lambda: raw([slice(0, n_rows)]),
                                 reps=11, inner=10),
               "raw_sharded_ms": time_ms(torch, lambda: raw(cuts), reps=11,
                                         inner=10)}
        torch.cuda.synchronize()
        if not torch.equal(sel, one[0]) or ulp_gap(torch, tot, one[1]) != 0:
            raise AssertionError(f"{name}: the raw row-shard launches differ")
        out[f"K2 {n_rows}x{lanes} {form}"] = row
        log(f"{name}: {n} row shards (W={n_rows // n}) bit-equal to one launch "
            f"and to the plain version; dispatch: one launch {row['ms']:.4f} ms, "
            f"{n} shards + gather {row['sharded_ms']:.4f} ms; raw launches: one "
            f"{row['raw_ms']:.4f} ms, {n} shards {row['raw_sharded_ms']:.4f} ms")
    return out


def mesh_path(np, torch, dev, k1, k2, k1_ref, k2_ref, common, reports,
              base: dict) -> dict:
    """Phase 10: the round sharded over an auction mesh on the card, held
    to phase 3's run (``base``)."""
    import pickle
    import tempfile

    import repro_torch.core as core
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core.clearing import clear_round
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.core.scoring import ScoringPolicy
    from repro_torch.launch.mesh import (AUCTION_AXIS, Mesh, make_auction_mesh,
                                         mesh_chips)

    out = {}
    sim = dict(workload=SIM_WORKLOAD, sim=SIM_CONFIG)
    walls = {"phase 3 pipelined": base["wall_s"],
             "phase 3 serial": base["serial"]["wall_s"]}

    # 10a: the mesh of every visible card is degenerate on one H100
    one = make_auction_mesh()
    if mesh_chips(one) != 1 or one.devices != (dev,):
        raise AssertionError(f"10a: make_auction_mesh() gave {one}")
    run, launches, shapes = counted(k1, k2, lambda: run_sim(
        core, "cuda", pipeline=True, device=dev, mesh=one, **sim))
    same_run("10a degenerate mesh", run, base)
    if shapes != base["shapes"]:
        raise AssertionError(f"10a: launches {shapes} differ from phase 3's")
    walls["10a degenerate pipelined"] = run["wall_s"]
    log(f"10a degenerate mesh {one.shape}: commit log and summary equal "
        f"phase 3's, launches {launches} at phase 3's shapes, "
        f"{run['wall_s']:.2f} s wall")
    odd = Mesh((dev,) * 3, (AUCTION_AXIS,), (3,))
    windows, pool = mesh_round(np, 700, 5, rng=np.random.default_rng(4))
    sigs, counts = [], []
    for mesh in (None, odd):
        k1.SHAPES.clear()
        k2.SHAPES.clear()
        rr = clear_round(windows, pool, ScoringPolicy(), score_impl="cuda",
                         wis_impl="cuda", device=dev, mesh=mesh)
        sigs.append(round_sig(rr))
        counts.append((dict(k1.SHAPES), dict(k2.SHAPES)))
    if sigs[0] != sigs[1] or counts[0] != counts[1]:
        raise AssertionError("10a: the 3-shard mesh did not fall back identically")
    log(f"10a hand-built 3-shard mesh: a 700-bid round falls back to the "
        f"unsharded launches {counts[0]}, selections identical")
    out["10a"] = {"launches": launches, "wall_s": run["wall_s"]}

    # 10b: four virtual shards on the card, phase 3's workload
    n = MESH_SHARDS
    mesh = make_auction_mesh(n, devices=[dev] * n)
    if mesh_chips(mesh) != n:
        raise AssertionError(f"10b: {mesh}")
    runs = {}
    for pipeline, base_shapes in ((True, base["shapes"]),
                                  (False, base["serial"]["shapes"])):
        name = f"10b {n} shards {'pipelined' if pipeline else 'serial'}"
        run, launches, shapes = counted(k1, k2, lambda: run_sim(
            core, "cuda", pipeline=pipeline, device=dev, mesh=mesh, **sim))
        same_run(name, run, base)
        account = mesh_account(name, launches, shapes, base_shapes, n)
        walls[name] = run["wall_s"]
        runs["pipelined" if pipeline else "serial"] = {
            "wall_s": run["wall_s"], "account": account,
            "k1_shapes": {str(k): v for k, v in shapes["jasda_score"].items()}}
        log(f"{name}: commit log ({len(run['commits'])} rows) and summary "
            f"equal phase 3's; launches {account}; {run['wall_s']:.2f} s wall")
    out["10b"] = runs
    log("10b walls (s): " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()))

    # 10c: kernel level
    out["10c"] = mesh_kernels(np, torch, dev, k1, k2, k1_ref, k2_ref, mesh)

    # 10d: a large sharded round, twice in one bucket; the torch backend
    # sharded on the card
    rng = np.random.default_rng(100)
    policy = ScoringPolicy()
    before = common.build_counts()
    for m in (MESH_ROUND_M, MESH_ROUND_M - 4097):
        windows, pool = mesh_round(np, m, 24, rng=rng, n_jobs=101)
        t0 = time.perf_counter()
        whole = round_sig(clear_round(windows, pool, policy, wis_impl="cuda",
                                      device=dev))
        t1 = time.perf_counter()
        split = round_sig(clear_round(windows, pool, policy, wis_impl="cuda",
                                      mesh=mesh))
        t2 = time.perf_counter()
        if whole != split:
            raise AssertionError(f"10d: the sharded {len(pool)}-bid round differs")
        log(f"10d {len(pool)} bids over 24 windows: sharded round identical "
            f"({sum(map(len, whole[0]))} selected); unsharded {t1 - t0:.2f} s, "
            f"{n} shards {t2 - t1:.2f} s of host clock")
        out[f"10d M={len(pool)}"] = {"s": t1 - t0, "sharded_s": t2 - t1}
    if common.build_counts() != before:
        raise AssertionError(f"10d rebuilt: {before} -> {common.build_counts()}")
    small = {"slices": lambda S: [S("s20", 20 * GB, n_chips=4),
                                  S("s10", 10 * GB, n_chips=2),
                                  S("s5", 5 * GB, n_chips=1)],
             "jobs": dict(n_jobs=40, seed=3, arrival_rate=0.3)}
    torch_split = run_sim(core, "torch", pipeline=True, device=dev, mesh=mesh,
                          workload=small, sim=dict(t_end=900.0, seed=2))
    if (torch_split["commits"] != base["small"]["commits"]
            or torch_split["summary"] != base["small"]["summary"]):
        raise AssertionError("10d: the sharded torch run differs from phase 3's "
                             "small cuda run")
    log(f"10d small run, torch backend on {n} shards of the card: "
        f"{len(torch_split['commits'])} commits identical to phase 3's cuda run")

    # 10e: builds
    out["builds"] = check_builds(common, reports, "phase 10")

    # 10f: a meshed scheduler refuses to pickle
    cfg = SchedulerConfig.from_policy(core.Policy(per_agent_theta=True),
                                      score_impl="cuda", wis_impl="cuda",
                                      device=dev, mesh=mesh)
    sched = core.JasdaScheduler(SIM_WORKLOAD["slices"](core.SliceSpec), cfg)
    with tempfile.TemporaryDirectory() as tmp:
        store = CheckpointStore(tmp)
        for what, act in (("pickle", lambda: pickle.dumps(sched)),
                          ("checkpoint", lambda: store.save_state(1, sched))):
            try:
                act()
            except ValueError as exc:
                if "mesh" not in str(exc):
                    raise
            else:
                raise AssertionError(f"10f: {what} took a meshed scheduler")
        if store.latest_step() is not None:
            raise AssertionError("10f: the store kept a meshed scheduler")
    log("10f: pickle and the checkpoint store refuse a meshed scheduler")
    return out

# ---------------------------------------------------------------------------
# Phase 11: the model half of sharding, the dry run and the roofline
# ---------------------------------------------------------------------------

#: 11a: (arch, the attention sharding it exercises), one 2048-token prefill
#: through K4 and SHARD_DECODE decode steps each, with rules and without
SHARD_ARCHS = (("qwen1_5_4b", "headdim: the Ulysses branch"),
               ("olmoe_1b_7b", "heads, expert-sharded MoE (gecd / gecf)"))
SHARD_PROMPT, SHARD_DECODE = 2048, 4
#: 11b: the whole dry run's wall limit (s); its cells run in one process
#: per arch, all started together
DRYRUN_LIMIT_S = 300
#: 11c: a share of the bound above this means the count or the constants
#: are wrong
SHARE_LIMIT = 1.05


def _flat_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_leaves(tree[k])
    else:
        yield tree


def sharded_run(torch, dev, k4, model, params, toks, rules) -> dict:
    """One K4 prefill of ``toks`` and SHARD_DECODE greedy decode steps under
    ``rules`` (None: unconstrained): logits, the final cache, K4's launches
    and shapes, and the prefill's host-clock ms."""
    k4.LAUNCHES["flash_attention"] = 0
    k4.SHAPES.clear()
    s = toks.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, _ = model.prefill(params, toks, rules=rules, impl="pallas",
                                     max_seq=s + SHARD_DECODE)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    k4_prefill, shapes = k4.LAUNCHES["flash_attention"], dict(k4.SHAPES)
    steps = [logits]
    tok = logits.argmax(-1)
    for i in range(SHARD_DECODE):
        logits, cache = model.decode_step(params, tok, s + i, cache,
                                          rules=rules)
        steps.append(logits)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    return {"logits": steps, "cache": list(_flat_leaves(cache)),
            "k4_prefill": k4_prefill,
            "k4_decode": k4.LAUNCHES["flash_attention"] - k4_prefill,
            "k4_shapes": shapes, "prefill_ms": prefill_ms}


def rules_on_card(np, torch, dev, k4, card: str) -> dict:
    """11a: full-width prefills through K4 and decode steps with the dry
    run's sharding rules on a (data=2, model=2) mesh of four virtual
    shards of the card, against the same calls without rules."""
    from repro_torch.configs import Shape, get, info
    from repro_torch.distributed.sharding import resolve_param_specs
    from repro_torch.launch.dryrun import build_rules
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import Model

    mesh = Mesh((dev,) * 4, ("data", "model"), (2, 2))
    shape = Shape("prefill_2k", "prefill", SHARD_PROMPT, 1)
    out = {}
    for arch, what in SHARD_ARCHS:
        t0 = time.perf_counter()
        cfg = get(arch)
        rules = build_rules(cfg, info(arch), shape, mesh, multi_pod=False)
        model = Model(cfg)
        resolved = resolve_param_specs(model.specs(), rules)
        params = init_model(torch, dev, cfg, f"11a {cfg.name} full width")

        def split_dims(spec, leaf, path=()):
            if isinstance(spec, dict):
                return sum(split_dims(spec[k], leaf[k], path + (k,))
                           for k in spec)
            n = 0
            for dim, entry in zip(leaf.shape, spec):
                if entry is not None and "model" in entry:
                    if dim % cfg.model_axis_size:
                        raise AssertionError(
                            f"11a {cfg.name} {'/'.join(path)}: dim {dim} does "
                            f"not divide the model axis {cfg.model_axis_size}")
                    n += 1
            return n

        n_split = split_dims(resolved, params)
        toks = torch.from_numpy(np.random.default_rng(SEED + 110).integers(
            0, cfg.vocab_size, (1, SHARD_PROMPT)).astype(np.int64)).to(dev)
        # untimed warm-up at the prefill's shape, then the runs in turns
        model.prefill(params, toks, impl="pallas",
                      max_seq=SHARD_PROMPT + SHARD_DECODE)
        runs = [sharded_run(torch, dev, k4, model, params, toks, r)
                for r in (None, rules, rules, None)]
        plain, ruled = runs[0], runs[1]
        same_logits = all(torch.equal(a, b) for run in runs[1:]
                          for a, b in zip(plain["logits"], run["logits"]))
        same_cache = all(len(plain["cache"]) == len(run["cache"]) and all(
            torch.equal(a, b) for a, b in zip(plain["cache"], run["cache"]))
            for run in runs[1:])
        ms = {"plain": [runs[0]["prefill_ms"], runs[3]["prefill_ms"]],
              "rules": [runs[1]["prefill_ms"], runs[2]["prefill_ms"]]}
        n_attn = cfg.n_layers
        log(f"11a {cfg.name} ({what}) [{card}]: rules batch {rules.batch_axes} "
            f"fsdp {rules.fsdp_axes} model {rules.model_axes} attn_shard "
            f"{rules.attn_shard}; {n_split} param dims split on model, each "
            f"dividing {cfg.model_axis_size}; prefill {SHARD_PROMPT} tokens "
            f"through K4 in turns (without, with, with, without rules) "
            f"{ms['plain'][0]:.2f}, {ms['rules'][0]:.2f}, {ms['rules'][1]:.2f}, "
            f"{ms['plain'][1]:.2f} ms; K4 launches "
            f"{[run['k4_prefill'] for run in runs]}; logits of the "
            f"prefill and {SHARD_DECODE} decode steps "
            f"{'bit-equal' if same_logits else 'DIFFER'}, the "
            f"{len(plain['cache'])} cache leaves "
            f"{'bit-equal' if same_cache else 'DIFFER'}")
        if not (same_logits and same_cache):
            raise AssertionError(f"11a {cfg.name}: the runs with rules and "
                                 "without differ")
        for run in runs:
            if run["k4_prefill"] != n_attn or run["k4_decode"]:
                raise AssertionError(
                    f"11a {cfg.name}: K4 launched {run['k4_prefill']} times in "
                    f"a prefill (expected {n_attn}) and {run['k4_decode']} in "
                    "decode (expected 0)")
        unchecked = set(ruled["k4_shapes"]) - set(ATTN_CASES)
        if unchecked:
            raise AssertionError(f"11a {cfg.name}: K4 ran at shapes phase 2d "
                                 f"does not hold: {sorted(unchecked, key=str)}")
        if not all(torch.isfinite(x).all() for x in plain["logits"]):
            raise AssertionError(f"11a {cfg.name}: non-finite logits")
        out[arch] = {"k4_launches": ruled["k4_prefill"], "prefill_ms": ms,
                     "model_split_dims": n_split,
                     "wall_s": time.perf_counter() - t0}
        del params, plain, ruled, runs
        free_card(torch, cfg.name)
    return out


def dry_run_on_host(card: str) -> dict:
    """11b: ``python -m repro_torch.launch.dryrun`` for every arch and shape
    on the single-pod mesh, one process an arch, then the report over the
    rows.  Every cell must run (long_500k skipped where the reference skips
    it), its flops_per_device x chips must equal ``analytic_cost``, and the
    meta run's FLOP count must fall in ``flop_counter_band``."""
    import tempfile

    from repro_torch.configs import ARCH_NAMES, SHAPES, get, info
    from repro_torch.launch.costmodel import analytic_cost
    from repro_torch.launch.dryrun import flop_counter_band

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {arch: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", "all", "--mesh", "single", "--out",
             f"{tmp}/{arch}.jsonl"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for arch in ARCH_NAMES}
        logs = {}
        try:
            for arch, proc in procs.items():
                left = DRYRUN_LIMIT_S - (time.perf_counter() - t0)
                logs[arch] = proc.communicate(timeout=max(left, 1.0))[0]
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - t0
        bad = [a for a, p in procs.items() if p.returncode != 0]
        if bad:
            raise AssertionError(f"11b: the dry run failed for {bad}:\n"
                                 + "\n".join(logs[a][-2000:] for a in bad))
        merged = Path(tmp) / "dryrun.jsonl"
        merged.write_text("".join((Path(tmp) / f"{a}.jsonl").read_text()
                                  for a in ARCH_NAMES))
        rows = [json.loads(x) for x in merged.read_text().splitlines()]
        rep = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.report", str(merged)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        if rep.returncode != 0:
            raise AssertionError(f"11b: the report failed:\n{rep.stderr}")
    for line in rep.stdout.rstrip().splitlines():
        log(f"11b {line}")
    n_ok = n_skip = 0
    ratios = {}
    for r in rows:
        arch, name = r["arch"], r["shape"]
        cfg, inf, shape = get(arch), info(arch), SHAPES[name]
        if "error" in r:
            raise AssertionError(f"11b {arch} x {name}: {r['error']}")
        if "skipped" in r:
            if inf.long_context or name != "long_500k":
                raise AssertionError(f"11b {arch} x {name}: skipped")
            n_skip += 1
            continue
        ac = analytic_cost(cfg, inf, shape, attn_impl=(
            "chunked" if shape.seq > 8192 else "full"))
        if r["flops_per_device"] * r["chips"] != ac.flops_global:
            raise AssertionError(f"11b {arch} x {name}: flops_per_device x "
                                 f"chips {r['flops_per_device'] * r['chips']} "
                                 f"!= analytic {ac.flops_global}")
        lo, hi, why = flop_counter_band(cfg, shape)
        ratio = r["flop_counter"]["flops_global"] / ac.flops_global
        ratios[f"{arch} x {name}"] = ratio
        if not lo <= ratio <= hi:
            raise AssertionError(f"11b {arch} x {name}: flop counter / analytic "
                                 f"{ratio} outside [{lo}, {hi}] ({why})")
        n_ok += 1
    want = sum(1 for a in ARCH_NAMES for s in SHAPES
               if s != "long_500k" or info(a).long_context)
    if n_ok != want or n_skip != len(ARCH_NAMES) * len(SHAPES) - want:
        raise AssertionError(f"11b: {n_ok} cells ran and {n_skip} skipped, "
                             f"expected {want} and "
                             f"{len(ARCH_NAMES) * len(SHAPES) - want}")
    lowers = {f"{r['arch']} x {r['shape']}": r["t_lower_s"] for r in rows
              if "t_lower_s" in r}
    log(f"11b dry run on the card's host [{card}]: {n_ok} cells ok, {n_skip} "
        f"skipped (long_500k, quadratic attention), {wall:.1f} s wall in "
        f"{len(ARCH_NAMES)} processes (limit {DRYRUN_LIMIT_S} s); "
        f"flops_per_device x chips equal analytic_cost in every cell; flop "
        f"counter / analytic: " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in ratios.items()))
    log(f"11b lower seconds a cell: {lowers}")
    return {"cells_ok": n_ok, "skipped": n_skip, "wall_s": wall,
            "flop_counter_ratio": ratios}


def roofline_share(what: str, cfg, inf, shape, seconds: float, attn_impl: str,
                   card: str) -> dict:
    """MFU (model FLOPs over the time at the card's bf16 peak) and the
    share of the analytic bound (the larger of compute and memory) that a
    step of ``seconds`` reaches on one card."""
    from repro_torch.launch.costmodel import analytic_cost
    from repro_torch.launch.roofline import (HBM_BW, PEAK_FLOPS,
                                             model_flops)

    ac = analytic_cost(cfg, inf, shape, attn_impl=attn_impl)
    t_compute = ac.flops_global / PEAK_FLOPS
    t_memory = ac.bytes_per_device(1, params_replicated=False) / HBM_BW
    mf = model_flops(cfg, shape)
    out = {"seconds": seconds, "model_flops": mf, "flops": ac.flops_global,
           "t_compute_s": t_compute, "t_memory_s": t_memory,
           "mfu": mf / (seconds * PEAK_FLOPS),
           "bound_share": max(t_compute, t_memory) / seconds,
           "bound_by": "compute" if t_compute >= t_memory else "memory"}
    log(f"11c {what} [{card}]: {seconds * 1e3:.2f} ms measured; model FLOPs "
        f"{mf:.4e}, MFU {out['mfu']:.4f} (at {PEAK_FLOPS:.4g} FLOP/s); "
        f"analytic {ac.flops_global:.4e} FLOPs ({attn_impl} attention) and "
        f"{ac.bytes_per_device(1, params_replicated=False):.4e} bytes: "
        f"t_compute {t_compute * 1e3:.2f} ms, t_memory {t_memory * 1e3:.2f} "
        f"ms, {out['bound_by']}-bound, share of the bound "
        f"{out['bound_share']:.4f} (limit {SHARE_LIMIT})")
    if not (out["mfu"] <= SHARE_LIMIT and out["bound_share"] <= SHARE_LIMIT):
        raise AssertionError(f"11c {what}: a share above {SHARE_LIMIT}: the "
                             "count or the constants are wrong")
    return out


def shard_path(np, torch, dev, k4, card: str, models=None,
               training=None) -> dict:
    """Phase 11: 11a rules on the card, 11b the dry run on its host, 11c the
    roofline of phases 8 and 7's measured steps (skipped without them)."""
    from repro_torch.configs import Shape, get, info

    t_phase = time.perf_counter()
    out = {"11a": rules_on_card(np, torch, dev, k4, card),
           "11b": dry_run_on_host(card)}
    if models is None or training is None:
        log("11c skipped: phases 7 and 8, whose steps it reads, did not run")
    else:
        prefill_s = models["8c"]["longest_prefill_ms"]["median"]["pallas"] / 1e3
        step_s = statistics.median(training["7c"]["step_s"])
        out["11c"] = {
            "qwen3_14b_prefill_4096": roofline_share(
                "qwen3-14b 4096-token prefill through K4 (phase 8c, median of "
                "3)", get("qwen3_14b"), info("qwen3_14b"),
                Shape("prefill_4k", "prefill", 4096, 1), prefill_s,
                "triangle", card),
            "falcon_mamba_7b_train_step": roofline_share(
                f"falcon-mamba-7b train step, {TRAIN_LAYERS} layers, batch "
                f"{TRAIN_BATCH} x {TRAIN_SEQ} (phase 7c, median of "
                f"{len(training['7c']['step_s'])})",
                get("falcon_mamba_7b").replace(n_layers=TRAIN_LAYERS),
                info("falcon_mamba_7b"),
                Shape("train_7c", "train", TRAIN_SEQ, TRAIN_BATCH), step_s,
                "full", card)}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 11 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the examples
# ---------------------------------------------------------------------------

EXAMPLES = ROOT / "examples"
#: 12a's horizon: the cluster study's sections run to 6000 (failures 9000)
STUDY_T_END = 300.0
#: 12b: f32 K4 against its plain version on the served prefills' inputs
SERVE_K4_TOL = 7.2e-7
#: 12c: steps of the first run, then the resumed run's total; the tokens
#: of a step at the example's default batch x sequence
TRAIN_FIRST, TRAIN_TOTAL = 40, 56
TRAIN_100M_TOKENS = 8 * 256


def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"{name}_example",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn, *args, **kw):
    """``fn``'s result and what it printed to standard output."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def study_sections(t_end: float):
    """The four sections of ``cluster_study_torch.main``, to ``t_end``."""
    return [("steady", "run", dict(
                title="steady state (heterogeneous MIG pool)", t_end=t_end)),
            ("failures", "run", dict(
                title="with slice failures (MTBF ~5.5 min, repair 50 s)",
                t_end=1.5 * t_end, failure_rate=0.003)),
            ("presets", "run_presets", dict(t_end=t_end)),
            ("strategies", "run_strategies", dict(t_end=t_end))]


def run_study(k1, k2, study, sections, device: str, impl) -> dict:
    """Each section of the study through backend ``impl`` on ``device``:
    its printed table, wall, and the K1 and K2 launches counted in it, each
    simulation's apart (a JASDA one must launch both on the card; the
    baselines launch nothing)."""
    simulate = study.simulate
    sims = []

    def recorded(sched, agents, cfg):
        before = (k1.LAUNCHES["jasda_score"], k2.LAUNCHES["wis_batch"])
        t0 = time.perf_counter()
        res = simulate(sched, agents, cfg)
        row = {"system": type(sched).__name__,
               "wall_s": time.perf_counter() - t0,
               "jasda_score": k1.LAUNCHES["jasda_score"] - before[0],
               "wis_batch": k2.LAUNCHES["wis_batch"] - before[1]}
        health = getattr(sched, "backend_health", None)
        if health is not None:
            row["rounds"] = sum(1 for r in sched.log if r.n_windows)
            row["policy"] = sched.policy.name
            if health.failed_backends():
                raise AssertionError(f"{impl} study marked backends failed: "
                                     f"{health.failed_backends()}")
        sims.append(row)
        return res

    out = {}
    study.simulate = recorded
    try:
        for name, fn, kw in sections:
            sims.clear()
            t0 = time.perf_counter()
            (_, text), launches, shapes = counted(
                k1, k2, lambda: printed(getattr(study, fn), device=device,
                                        impl=impl, **kw))
            out[name] = {"text": text, "wall_s": time.perf_counter() - t0,
                         "launches": launches, "shapes": shapes,
                         "sims": list(sims)}
    finally:
        study.simulate = simulate
    return out


def study_gates(cuda: dict, host: dict, card: str) -> dict:
    """12a's gates: every table equal, K1 and K2 launched in every JASDA
    simulation on the card and never on the host, K1's pools padded to at
    least 256 rows and K2's settles to at least 8 windows."""
    out = {}
    for name, run in cuda.items():
        other = host[name]
        if run["text"] != other["text"]:
            raise AssertionError(f"12a {name}: the card's table differs from "
                                 f"the host's:\n{run['text']}\n---\n"
                                 f"{other['text']}")
        if any(other["launches"].values()):
            raise AssertionError(f"12a {name}: the host run launched "
                                 f"{other['launches']}")
        jasda = [s for s in run["sims"] if "rounds" in s]
        if not jasda or any(not (s["jasda_score"] and s["wis_batch"])
                            for s in jasda):
            raise AssertionError(f"12a {name}: a JASDA simulation skipped a "
                                 f"kernel: {jasda}")
        if any(s["jasda_score"] or s["wis_batch"] for s in run["sims"]
               if "rounds" not in s):
            raise AssertionError(f"12a {name}: a baseline launched a kernel")
        m_min = min(key[0] for key in run["shapes"]["jasda_score"])
        w_min = min(key[0] for key in run["shapes"]["wis_batch"])
        if m_min < 256 or w_min < 8:
            raise AssertionError(f"12a {name}: pools below the buckets: M "
                                 f"{m_min}, W {w_min}")
        log(f"12a {name} [{card}]: tables equal; cuda {run['wall_s']:.2f} s, "
            f"host torch {other['wall_s']:.2f} s wall; launches "
            f"{run['launches']}")
        host_jasda = [s for s in other["sims"] if "rounds" in s]
        for s, h in zip(jasda, host_jasda):
            log(f"  {s['policy']}: {s['rounds']} rounds, K1 "
                f"{s['jasda_score']}, K2 {s['wis_batch']}, "
                f"{s['wall_s']:.2f} s (host torch {h['wall_s']:.2f} s)")
        log(f"  K1 shapes (M, Fj, Fs, T): {run['shapes']['jasda_score']}")
        log(f"  K2 shapes (W, L, fused, transformed): "
            f"{run['shapes']['wis_batch']}")
        out[name] = {"cuda_wall_s": run["wall_s"],
                     "host_wall_s": other["wall_s"],
                     "launches": run["launches"],
                     "sims": run["sims"], "host_sims": other["sims"]}
    print("".join(run["text"] for run in cuda.values()), flush=True)
    return out


def recording_engine(k4, Engine, record: dict):
    """``ServingEngine`` that records every token pick's logits and K4's
    launches in each prefill and decode call."""

    class Recording(Engine):
        def _prefill(self, tokens):
            before = k4.LAUNCHES["flash_attention"]
            out = super()._prefill(tokens)
            record["prefill_k4"].append(k4.LAUNCHES["flash_attention"] - before)
            return out

        def _decode(self, tok, idx):
            before = k4.LAUNCHES["flash_attention"]
            out = super()._decode(tok, idx)
            record["decode_k4"].append(k4.LAUNCHES["flash_attention"] - before)
            return out

        def _pick(self, logits):
            record["picks"].append(logits.copy())
            return super()._pick(logits)

    return Recording


def served_once(torch, k4, serve, impl: str, card: str) -> dict:
    """``serve_batch_torch.main`` on the card through attention ``impl``,
    K4's count set to 0 just before it and read just after."""
    record = {"prefill_k4": [], "decode_k4": [], "picks": []}
    Engine = serve.ServingEngine
    serve.ServingEngine = recording_engine(k4, Engine, record)
    try:
        gc.collect()
        torch.cuda.synchronize()
        k4.LAUNCHES["flash_attention"] = 0
        k4.SHAPES.clear()
        (reqs, steps, wall), text = printed(
            serve.main, ["--device", "cuda", "--attn-impl", impl])
        launches = k4.LAUNCHES["flash_attention"]
    finally:
        serve.ServingEngine = Engine
    n_tok = sum(len(r.output) for r in reqs)
    log(f"12b {impl} [{card}]: {n_tok} tokens in {steps} engine steps, "
        f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s; K4 launches {launches} "
        f"({sum(record['decode_k4'])} in decode)")
    return {"reqs": reqs, "steps": steps, "wall_s": wall,
            "tok_per_s": n_tok / wall, "k4": launches, "text": text,
            "k4_shapes": dict(k4.SHAPES), **record}


def k4_on_served_inputs(k4_ops, k4_ref, serve) -> float:
    """The K4 traffic served once more, each launch held against the plain
    version on the same q, k and v; returns the largest gap."""
    worst = [0.0]
    launch = k4_ops.mha_cuda

    def checked(q, k, v, **kw):
        out = launch(q, k, v, **kw)
        plain = k4_ref.mha_reference(q, k, v, **kw)
        worst[0] = max(worst[0], float((out - plain).abs().max().item()))
        return out

    k4_ops.mha_cuda = checked
    try:
        printed(serve.main, ["--device", "cuda", "--attn-impl", "pallas"])
    finally:
        k4_ops.mha_cuda = launch
    return worst[0]


def serve_example(np, torch, k4, k4_ref, card: str) -> dict:
    """12b: the batched-serving example through K4 and through auto, in
    turns: the same tokens (a pick may part only where auto's top-1 margin
    is at most twice the two runs' logit gap, and nothing after it is
    gated), 4 K4 launches a prefill and 40 a run through K4, none in
    decode or through auto, and K4 within SERVE_K4_TOL of its plain
    version on the served inputs."""
    from repro_torch.kernels.flash_attention import ops as k4_ops

    serve = load_example("serve_batch_torch")
    n_attn = serve.build_model().n_layers
    runs = {"pallas": [], "auto": []}
    with collector_off():
        for _ in range(2):
            for impl in ("pallas", "auto"):
                runs[impl].append(served_once(torch, k4, serve, impl, card))
    for pal, auto in zip(runs["pallas"], runs["auto"]):
        for impl, run in (("pallas", pal), ("auto", auto)):
            want = n_attn * len(run["prefill_k4"]) if impl == "pallas" else 0
            if run["k4"] != want or any(run["decode_k4"]) or (
                    impl == "pallas" and set(run["prefill_k4"]) != {n_attn}):
                raise AssertionError(
                    f"12b {impl}: K4 launched {run['k4']} times (prefills "
                    f"{run['prefill_k4']}, decode {sum(run['decode_k4'])})")
            if not all(r.done for r in run["reqs"]):
                raise AssertionError(f"12b {impl}: requests left unfinished")
        if pal["k4"] != 40:
            raise AssertionError(f"12b: {pal['k4']} K4 launches, expected 40")
        parted = None
        for i, (a, b) in enumerate(zip(pal["picks"], auto["picks"])):
            if int(np.argmax(a)) != int(np.argmax(b)):
                gap = float(np.abs(a - b).max())
                top2 = np.sort(b)[-2:]
                margin = float(top2[1] - top2[0])
                if margin > 2 * gap:
                    raise AssertionError(
                        f"12b: pick {i} parts though auto's margin {margin} "
                        f"exceeds twice the logit gap {gap}")
                parted = (i, margin, gap)
                break
        same = [r.output for r in pal["reqs"]] == [r.output for r in auto["reqs"]]
        gap = max(float(np.abs(a - b).max())
                  for a, b in zip(pal["picks"], auto["picks"]))
        log(f"12b K4 against auto: tokens {'equal' if same else 'parted'}; "
            f"largest logit gap over {len(pal['picks'])} picks {gap:.4g}"
            + ("" if parted is None else
               f"; first parted pick {parted[0]} at a near-tie (margin "
               f"{parted[1]:.4g}, gap {parted[2]:.4g})"))
    log(f"  K4 shapes (B, Hq, Hkv, Sq, Sk, D, dtype, causal, window, "
        f"q_offset): {runs['pallas'][0]['k4_shapes']}")
    worst = k4_on_served_inputs(k4_ops, k4_ref, serve)
    if not worst <= SERVE_K4_TOL:
        raise AssertionError(f"12b: K4 {worst} from its plain version on the "
                             f"served inputs (tolerance {SERVE_K4_TOL})")
    log(f"12b: K4 within {worst:.3g} of its plain version on the served "
        f"prefills' inputs (tolerance {SERVE_K4_TOL})")
    print(runs["pallas"][0]["text"], end="", flush=True)
    return {"k4_launches": runs["pallas"][0]["k4"], "k4_max_abs_err": worst,
            "tokens_equal": [[r.output for r in p["reqs"]] ==
                             [r.output for r in a["reqs"]]
                             for p, a in zip(runs["pallas"], runs["auto"])],
            **{impl: [{"wall_s": r["wall_s"], "tok_per_s": r["tok_per_s"],
                       "steps": r["steps"]} for r in rs]
               for impl, rs in runs.items()}}


def bits(torch, t):
    """A tensor's bits, for a bit-for-bit comparison."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16, torch.float64: torch.int64}
    return t.view(view[t.dtype]) if t.dtype in view else t


def train_example_steps(torch, rec: dict, card: str, n: int = 3) -> dict:
    """``n`` more steps of a finished 12c run, each timed on the host clock
    between synchronises, then one under torch.profiler."""
    from repro_torch.checkpoint.store import tree_flatten

    state, data, step_fn = rec["state"], rec["data"], rec["step_fn"]
    first = rec["start"] + len(rec["losses"])
    dev = tree_flatten(state["params"])[0][0].device

    def step(i):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(i).items()}
        state["params"], state["opt"], m = step_fn(
            state["params"], state["opt"], batch, i)
        return float(m["loss"])

    times = []
    for i in range(first, first + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"12c steady steps [{card}]: {[round(1e3 * t, 2) for t in times]} ms "
        "(host clock, synchronised)")
    return {"step_ms": [1e3 * t for t in times],
            "profile": train_profile(torch, lambda: step(first + n),
                                     f"12c one more step (step {first + n})",
                                     card)}


def train_example(torch, card: str) -> dict:
    """12c: the 100M-parameter example at full width on the card for
    TRAIN_FIRST steps into a new directory, then a second ``main`` on it to
    TRAIN_TOTAL: it resumes from step TRAIN_FIRST, the store gives back the
    first run's final state bit for bit, and the loss falls in both runs.
    Each ``save`` (the wait for the previous write and the copy to the
    host) is timed; the directory is removed at the end."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.store import tree_flatten

    train = load_example("train_100m_torch")
    Store = train.CheckpointStore
    saves = []

    class TimedStore(Store):
        def save(self, step, tree, *, blocking=False):
            t0 = time.perf_counter()
            self.wait()
            t1 = time.perf_counter()
            super().save(step, tree, blocking=blocking)
            saves.append((t1 - t0, time.perf_counter() - t1))

    tmp = tempfile.mkdtemp(prefix="train_100m_")
    train.CheckpointStore = TimedStore
    out = {}
    try:
        for tag, steps in (("first", TRAIN_FIRST), ("resumed", TRAIN_TOTAL)):
            saves.clear()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rec, text = printed(train.main, ["--steps", str(steps),
                                             "--ckpt-dir", tmp])
            wall = time.perf_counter() - t0
            job = rec["job"]
            run_s = sum(m["wall"] for m in job.metrics_log)
            n = job.steps_done
            row = {"steps": n, "start": rec["start"],
                   "chunks": len(job.metrics_log), "wall_s": wall,
                   "ms_per_step": 1e3 * run_s / n,
                   "tokens_per_s": TRAIN_100M_TOKENS * n / run_s,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "save_wait_s": [w for w, _ in saves],
                   "save_copy_s": [c for _, c in saves],
                   "loss_first": rec["losses"][0],
                   "loss_last": rec["losses"][-1],
                   "n_params": rec["n_params"]}
            log(f"12c {tag} [{card}]: {n} steps from {rec['start']} in "
                f"{row['chunks']} chunks, {row['ms_per_step']:.2f} ms a step "
                f"(chunk walls), {row['tokens_per_s']:.1f} tokens/s, peak "
                f"{row['peak_gb']:.3f} GB, loss {row['loss_first']:.4f} → "
                f"{row['loss_last']:.4f}; save: wait "
                f"{[round(x, 3) for x in row['save_wait_s']]} s, copy "
                f"{[round(x, 3) for x in row['save_copy_s']]} s; {wall:.1f} s")
            print(text, end="", flush=True)
            if tag == "first":
                if n != TRAIN_FIRST or rec["start"] != 0:
                    raise AssertionError(f"12c: first run did {n} steps from "
                                         f"{rec['start']}")
                template = {"params": rec["state"]["params"],
                            "opt": rec["state"]["opt"]}
                restored, step = rec["store"].restore(template)
                saved = tree_flatten(template)[0]
                back = tree_flatten(restored)[0]
                if step != TRAIN_FIRST or len(saved) != len(back) or not all(
                        a.device == b.device and torch.equal(bits(torch, a),
                                                             bits(torch, b))
                        for a, b in zip(saved, back)):
                    raise AssertionError("12c: the restored tree is not the "
                                         "saved one bit for bit")
                row["leaves_bit_equal"] = len(back)
                del restored, back, saved, template
            else:
                if (f"resumed from checkpoint step {TRAIN_FIRST}" not in text
                        or rec["start"] != TRAIN_FIRST
                        or n != TRAIN_TOTAL - TRAIN_FIRST):
                    raise AssertionError(f"12c: the second run did not resume "
                                         f"from step {TRAIN_FIRST}")
                row["after"] = train_example_steps(torch, rec, card)
            if not all(math.isfinite(x) for x in rec["losses"]) or not \
                    rec["losses"][-1] < rec["losses"][0]:
                raise AssertionError(f"12c {tag}: loss did not fall: "
                                     f"{rec['losses']}")
            out[tag] = row
            del rec, job
    finally:
        train.CheckpointStore = Store
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"12c: restored tree bit-equal ({out['first']['leaves_bit_equal']} "
        f"leaves); {tmp} removed")
    free_card(torch, "12c")
    return out


def examples_path(np, torch, dev, k1, k2, k4, k4_ref, card: str, *,
                  full_study: bool = False) -> dict:
    """Phase 12: the three examples through the port's entry points.  12a
    the cluster study's four sections to STUDY_T_END through K1 and K2 on
    the card against the plain torch versions on the host, 12b batched
    serving through K4 and auto, 12c the 100M-parameter run and its resume;
    with ``full_study`` (``--only examples``) the study at its own length
    through K1 and K2 last."""
    t_phase = time.perf_counter()
    study = load_example("cluster_study_torch")
    sections = study_sections(STUDY_T_END)
    with collector_off():
        cuda = run_study(k1, k2, study, sections, "cuda", "cuda")
        host = run_study(k1, k2, study, sections, "cpu", "torch")
    out = {"12a": study_gates(cuda, host, card)}
    out["12b"] = serve_example(np, torch, k4, k4_ref, card)
    out["12c"] = train_example(torch, card)
    out["launches"] = {
        k: sum(s["launches"][k] for s in out["12a"].values())
        for k in ("jasda_score", "wis_batch")}
    out["launches"]["flash_attention"] = out["12b"]["k4_launches"]
    if full_study:
        t0 = time.perf_counter()
        runs = run_study(k1, k2, study, study_sections(6000.0), "cuda", "cuda")
        for name, run in runs.items():
            log(f"full study {name} [{card}]: {run['wall_s']:.1f} s, launches "
                f"{run['launches']}")
        print("".join(run["text"] for run in runs.values()), flush=True)
        out["full_study"] = {name: {"wall_s": run["wall_s"],
                                    "launches": run["launches"],
                                    "text": run["text"]}
                             for name, run in runs.items()}
        log(f"full study: {time.perf_counter() - t0:.1f} s")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 12 took {out['wall_s']:.1f} s")
    return out


def phase(name: str, fn, *args, **kw):
    """Run one phase of the script and print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s wall")
    return out


def main(argv) -> int:
    only = None
    if argv:
        if argv[:1] != ["--only"] or argv[1:] not in (
                ["wis"], ["service"], ["train"], ["serve"], ["models"],
                ["xattn"], ["mesh"], ["shard"], ["examples"]):
            return fail(f"usage: chip_smoke.py [--only wis|service|train|"
                        f"serve|models|xattn|mesh|shard|examples], not {argv}")
        only = argv[1]
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        return fail(f"the port's package is missing under {src}")
    sys.path.insert(0, str(src))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch sees no CUDA device")
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.kernels.flash_attention import ref as k4_ref
    from repro_torch.kernels.jasda_score import kernel as k1
    from repro_torch.kernels.jasda_score import ref as k1_ref
    from repro_torch.kernels.linear_scan import kernel as k5
    from repro_torch.kernels.linear_scan import ref as k5_ref
    from repro_torch.kernels.wis_dp import kernel as k2
    from repro_torch.kernels.wis_dp import ref as k2_ref

    # float32 matmuls in full float32 on the card, as on the host
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = common.build_all()
    log(f"built {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for fn, regs in ptxas_report(report):
            log(f"  ptxas {name} {fn}: {regs}")

    if only == "train":  # the build, then training alone
        training = training_path(torch, dev, k5, k5_ref, card)
        print(card, flush=True)
        print(json.dumps({"kernels": [dict(
            name="linear_scan_bwd", route="cuda",
            source="src/repro_torch/kernels/csrc/linear_scan.cu",
            replaces=K5_BWD_REPLACES,
            launches=training["7c"]["launches"]["linear_scan_bwd"],
            library_ms=None, **training["7a"])], "training": training}),
            flush=True)
        return 0
    if only == "serve":  # the build, K5 and K4 alone, then the served models
        phase("2c", check_scan_kernel, torch, dev, k5, k5_ref)
        phase("2d", check_attention_kernel, np, torch, dev, k4, k4_ref)
        served = phase("4", serving_path, np, torch, dev, k5, card)
        hybrid = phase("5", hybrid_serving_path, np, torch, dev, k4, k5, card)
        print(card, flush=True)
        print(json.dumps({"serving": served, "hybrid": hybrid}, default=str),
              flush=True)
        return 0
    if only == "models":  # the build, K4 alone, then the new configs
        k4_row = phase("2d", check_attention_kernel, np, torch, dev, k4, k4_ref)
        models = phase("8", models_path, np, torch, dev, k4, card)
        print(card, flush=True)
        print(json.dumps({"kernels": [dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:108",
            launches=sum(models["k4_launches"].values()),
            model_launches=models["k4_launches"], **k4_row)],
            "models": models}, default=str), flush=True)
        return 0
    if only == "xattn":  # the build, K4 alone, then the cross-attention families
        k4_row = phase("2d", check_attention_kernel, np, torch, dev, k4, k4_ref)
        xattn = phase("9", xattn_path, np, torch, dev, k4, card)
        print(card, flush=True)
        print(json.dumps({"kernels": [dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:108",
            launches=sum(xattn["k4_launches"].values()),
            model_launches=xattn["k4_launches"], **k4_row)],
            "xattn": xattn}, default=str), flush=True)
        return 0
    if only == "shard":  # the build, K4 alone, then the sharding rules and tools
        k4_row = phase("2d", check_attention_kernel, np, torch, dev, k4, k4_ref)
        shard = phase("11", shard_path, np, torch, dev, k4, card)
        print(card, flush=True)
        print(json.dumps({"kernels": [dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:108",
            launches=sum(r["k4_launches"] for r in shard["11a"].values()),
            **k4_row)], "shard": shard}, default=str), flush=True)
        return 0
    if only == "examples":  # the build, the examples, the full-length study
        examples = phase("12", examples_path, np, torch, dev, k1, k2, k4,
                         k4_ref, card, full_study=True)
        print(card, flush=True)
        print(json.dumps({"examples": examples}, default=str), flush=True)
        return 0
    if only == "service":  # the build, then the streaming service alone
        service = service_path(dev, k1, k2)
        print(card, flush=True)
        print(json.dumps({"service": service}), flush=True)
        return 0
    scores, k1_row = phase("2 (K1)", check_score_kernel, np, torch, dev, k1,
                           k1_ref)
    k2_row = phase("2 (K2)", check_settle_kernel, np, torch, dev, k2, k2_ref,
                   scores)
    if only == "wis":  # the WIS kernels alone: K1 feeds K2, then K3
        k3_row = check_dp_kernel(np, torch, dev, k2, k2_ref, k2_row)
        print(card, flush=True)
        print(json.dumps({"kernels": [dict(name="wis_batch", **k2_row),
                                      dict(name="wis_dp", **k3_row)]}),
              flush=True)
        return 0
    if only == "mesh":  # K1 and K2, the round, then the round sharded
        del scores
        launches, run = phase("3", main_path, torch, dev, k1, k2)
        check_builds(common, reports, "phase 3")
        mesh = phase("10", mesh_path, np, torch, dev, k1, k2, k1_ref, k2_ref,
                     common, reports, run)
        print(card, flush=True)
        print(json.dumps({"kernels": [
            dict(name="jasda_score", launches=launches["jasda_score"],
                 mesh4_launches=mesh["10b"]["pipelined"]["account"]["jasda_score"],
                 **k1_row),
            dict(name="wis_batch", launches=launches["wis_batch"],
                 mesh4_launches=mesh["10b"]["pipelined"]["account"]["wis_batch"],
                 **k2_row)], "mesh": mesh}, default=str), flush=True)
        return 0
    k5_row = phase("2c", check_scan_kernel, torch, dev, k5, k5_ref)
    k4_row = phase("2d", check_attention_kernel, np, torch, dev, k4, k4_ref)
    k3_row = phase("2e", check_dp_kernel, np, torch, dev, k2, k2_ref, k2_row)
    del scores
    launches, run = phase("3", main_path, torch, dev, k1, k2)
    check_builds(common, reports, "phase 3")
    served = phase("4", serving_path, np, torch, dev, k5, card)
    hybrid = phase("5", hybrid_serving_path, np, torch, dev, k4, k5, card)
    service = phase("6", service_path, dev, k1, k2, sim_run=run)
    training = phase("7", training_path, torch, dev, k5, k5_ref, card)
    models = phase("8", models_path, np, torch, dev, k4, card)
    xattn = phase("9", xattn_path, np, torch, dev, k4, card)
    mesh = phase("10", mesh_path, np, torch, dev, k1, k2, k1_ref, k2_ref,
                 common, reports, run)
    phase("11", shard_path, np, torch, dev, k4, card, models=models,
          training=training)
    examples = phase("12", examples_path, np, torch, dev, k1, k2, k4, k4_ref,
                     card)

    kernels = [
        dict(name="jasda_score", route="cuda",
             source="src/repro_torch/kernels/csrc/jasda_score.cu",
             replaces="src/repro/kernels/jasda_score/kernel.py:87",
             launches=launches["jasda_score"], library_ms=None, **k1_row),
        dict(name="wis_batch", route="cuda",
             source="src/repro_torch/kernels/csrc/wis_batch.cu",
             replaces="src/repro/kernels/wis_dp/kernel.py:111",
             launches=launches["wis_batch"], library_ms=None, **k2_row),
    ]
    for k in kernels:
        k["launches_per_round"] = k["launches"] / max(run["rounds"], 1)
        k["service_launches"] = service["6a"]["launches"][k["name"]]
        k["mesh4_launches"] = mesh["10b"]["pipelined"]["account"][k["name"]]
        k["examples_launches"] = examples["launches"][k["name"]]
    kernels.append(dict(
        name="linear_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/linear_scan.cu",
        replaces="src/repro/kernels/linear_scan/kernel.py:51",
        launches=served["launches"], library_ms=None,
        train_launches=training["7c"]["launches"]["linear_scan"], **k5_row))
    kernels.append(dict(
        name="linear_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/linear_scan.cu",
        replaces=K5_BWD_REPLACES,
        launches=training["7c"]["launches"]["linear_scan_bwd"],
        library_ms=None, **training["7a"]))
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:108",
        launches=hybrid["k4_launches"],
        model_launches=models["k4_launches"] | xattn["k4_launches"],
        examples_launches=examples["launches"]["flash_attention"], **k4_row))
    kernels.append(dict(
        name="wis_dp", route="cuda",
        source="src/repro_torch/kernels/csrc/wis_batch.cu",
        replaces="src/repro/kernels/wis_dp/kernel.py:46",
        library_ms=None, **k3_row))
    check_builds(common, reports, "every phase")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception as exc:  # report the failing phase, print no result
        import traceback

        traceback.print_exc()
        sys.exit(fail(f"{type(exc).__name__}: {exc}"))
