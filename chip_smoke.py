#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card):

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and the exit code is
nonzero:

1. ``env``: the card (``nvidia-smi``), torch and CUDA versions.
2. ``build``: nvcc builds the seven kernel libraries from ``src/``
   (segment reduce, RMSNorm and its backward, flash attention and its
   backward, grouped matmul, RG-LRU scan), one nvcc each, all started
   together, with each kernel's registers and spills.
3. ``kernel``: the segment kernels against their plain PyTorch versions
   on the card, at edge-case sizes (two leave the last warp part-filled)
   and at the sim path's shapes (mphx-4p-86x9 uniform: the incidence's
   edge and flow columns), twice for bitwise repeatability; the sum also
   bit for bit against its ordered twin at the plan's lanes, and at the
   sim's shapes that twin against the twin at 32 lanes (the first
   kernel's order).  Each line carries the plan's lanes a segment, the
   kernel's time, the time of the plain version and of the one PyTorch
   call that computes the same function, and their bound.
4. ``main_path``: ``--suite sim`` on mphx-4p-86x9 (uniform and
   neighbor_shift, loads 0.5 and 0.9) through the hand-written kernels,
   with the launch counts read around that run alone; then again with
   the plain versions on the card; every row must agree at 1e-9
   relative, integers exactly.
5. ``golden``: the mphx-2p-8x8 array cells (``uniform`` and
   ``neighbor_shift`` in minimal routing, ``hotspot_valiant`` in
   valiant), the graph engine's ``dragonfly-small/uniform`` cell and the
   staggered trace of ``tests/golden/fairshare_golden.json`` on the
   card: exact incidence sizes, rates, link loads and FCT columns at the
   golden's tolerances, the trace's exact epoch count.
6. ``sweep``: ``--suite sweep`` over mphx-2p-16x16 (the five synthetic
   scenarios and the three collective chunk schedules) and mphx-4p-86x9
   (the same; ``transpose`` a skip record on its non-square grid) in
   minimal, valiant and adaptive routing, loads
   0.5 and 1.0, measured FCTs on the minimal rows, through the kernels
   (launch counts read around that run alone), then again with the
   plain versions: every row at 1e-9 relative, integers exact.  Then
   each (topology, scenario, mode)'s route alone at full injection with
   its wall, adaptive bit for bit equal to the plain path (the sum
   kernel's ordered twin) and, for every mphx-2p-16x16 scenario and
   mphx-4p-86x9 uniform, to the CPU's; mphx-4p-86x9 uniform adaptive
   twice, bit for bit; the sum kernel at that route's load-update shape; the route
   under the profiler (device idle share, ten longest device ops).
7. ``valiant_sim``: the valiant incidence of mphx-4p-86x9 hotspot (its
   wall, size and peak memory; the sum kernel at its coalescing shape,
   both kernels at its water-filling shapes), then
   ``load_sweep(mode="valiant", simulate=True)`` at loads 0.5 and 0.9
   through the kernels (launch counts read around that run alone) and
   on the plain path: rows at 1e-9 relative, integers exact.
8. ``graph``: the Table-2 baselines on the graph engine.  ``--suite
   sim``'s defaults (mphx-2p-8x8, dragonfly-small, with their measured
   collectives), then ``--suite sim
   --topos mpft-8p-65536`` (uniform, 16,711,680 incidence entries, and
   neighbor_shift, loads 0.5 and 0.9, uncut); ``--suite sweep`` over
   the four ``*-small`` presets (every scenario, three modes, loads 0.5
   and 1.0, measured FCTs) and the four ``*-65536`` presets (uniform and
   neighbor_shift, three modes, loads 0.5 and 1.0): each through the
   kernels (launch counts read around that run alone), then on the plain
   path (at 65K uniform alone: reduced), every row at 1e-9 relative,
   integers exact; the small presets' rows also against the CPU's.  Each
   65K preset's uniform route alone in each mode with its wall, adaptive
   twice and on the plain path, bit for bit; the dragonfly-65536 uniform
   adaptive route under the profiler; the segment kernels at the graph's
   shapes (ft3-65536's pull, ECMP denominators and bottleneck max, one
   lane a segment) and at mpft-8p-65536's water-filling shapes.
9. ``table2_trace``: ``--suite table2`` through the CLI under
   ``--trace`` (its rows equal to the same process's host rows, every
   cost the paper's, the trace's untraced note); the neighbor-shift
   throughput of Table 2's four MPHX rows in the three routing modes
   through the kernels and on the plain path (each route's wall,
   adaptive bit for bit); ``pattern_throughput`` at mphx-4p-86x9 uniform
   with the simulator's loads within 1e-6 of the router's.  Then the
   fabric flight recorder: ``--suite sim --trace`` at its defaults
   through the kernels, on the plain path and on the CPU (valid traces,
   the same events, journals at 1e-9, each ``sim.json`` with its
   ``telemetry`` block); the golden staggered trace journaled on the
   card (127 rows) against the CPU's; the many-epoch cell
   (``results/BENCH_sim_scale.json``'s mphx-4p-86x9 workload, 1,547
   epochs in the reference) with and without the recorder, in turns,
   kernels and plain, one run a turn: its walls, the extra sum launches (one for the
   link selection, one a journaled epoch), outputs bit for bit unmoved,
   and, through the kernels, the walls of a journal that buffers the
   epochs' rates and sums them at once (``buffered_journal``); the profiler's device-to-host copies and the
   synchronizing calls (torch's sync debug mode) with and without the
   recorder at the golden trace's 127 epochs and the cell's 1,547,
   counted in a fresh process (``chip_smoke.py --count-copies``); the
   reference's bounded series at mphx-8p-256 (64 rows, 32 flow spans,
   the rest counted).
10. ``spray``: multi-plane spraying.  The many-epoch cell's workload
   (774 flows) sprayed over mphx-4p-86x9's 4 planes, uncut, in three
   variants: (a) whole chunks, every plane healthy; (b) chunks with
   plane skew ``[1, 1.5, 1, inf]`` (plane 3 dead, its bytes re-sprayed);
   (c) 64 KiB flowlets hashed with seed 0, plane 3 dead.  Each through
   the kernels (launch counts read around that run alone), on the plain
   path on the card and on the CPU: per-plane bytes, stalls, the
   ``spray.*`` counters and (c)'s flowlet split bit for bit, completions
   and makespans within 1e-9 relative; each run's wall, epochs a plane,
   launches and segment plans built (once a run, whatever the plane
   count).  Then ``--suite sim`` through the CLI at its defaults and
   ``--topos mphx-2p-16x16 --scenarios uniform`` (the largest fabric
   whose collectives the suite measures: an all-to-all of 65,280 flows
   on 2 planes), kernels, plain and CPU, every row but the walls equal,
   each collective's wall, flows a step and measured-over-analytic
   ratio.
11. ``failures``: failure injection and fast-reroute protection.
   ``--suite failures`` through the CLI at its defaults (mphx-2p-8x8 and
   dragonfly-small, ``link:0.01`` and ``link:0.05``, uniform, the three
   reroute modes) through the kernels (launch counts read around that
   run alone), on the plain path and on the CPU, rows equal but the
   walls.  Then ``--suite failures`` at mphx-4p-86x9 (66,564 NICs,
   uncut) and mphx-2p-16x16 under ``link:0.01,plane:1`` and
   ``switch:0.02,seed:3``, uniform, three reroute modes, 4 protection
   layers: through the kernels, at 16 x 16 twice (rows equal but the
   walls), one run at each size checking that each local reroute put no
   load on a failed edge and conserved its Gbps within 1e-9 (at 86 x 9
   the only kernel run, its walls with these checks in them: its repeat
   cut for time), on the plain path
   (at 86 x 9 the first spec alone: reduced) and on the CPU (16 x 16
   under the switch failure alone: reduced), every row at 1e-9
   relative, integers exact, each side's
   ``conservation_residual`` below 1e-9; each run's wall, peak device
   memory, launches and the ``protection.*`` / ``failures.*`` timers
   (the layer BFS and the backup table: provisioning), and a spec's
   phase walls and ``time_to_90_s`` a reroute mode (and whether the
   local reroute reaches 90 % before the global recompute).  Then the
   segment
   kernels at the protection's shapes at 86 x 9: a local-reroute pull's
   ECMP denominators and the backup table's first-downhill min.
12. ``cosim_serving``: training-step co-simulation and multi-tenant
   serving, each line stamped with ``phase_s``.  (a) ``--suite cosim``
   and ``--suite serving --tenants chat burst train web`` through the
   CLI at their defaults, through the kernels (launch counts read
   around that run alone), on the plain path and on the CPU, and
   ``--suite cosim --cosim-method batches`` through the kernels and on
   the CPU: rows equal but the walls; ``--suite cosim --trace``: the
   phase spans add up to the rows' ``comm_ms``.  (b) ``--suite cosim
   --topos mphx-4p-86x9 --ranks 16384`` (kimi-k2-1t-a32b dp 1,024 x tp
   16 x ep 8 and mixtral-8x22b dp 2,048 x tp 8 x ep 8; array engine
   linear and mapped, graph engine linear) through the kernels and on
   the plain path (1e-9; its kernel repeat cut for time), then
   ``--topos mphx-2p-16x16 --ranks 4096`` through the kernels and on
   the CPU (1e-9); each run's wall, peak device memory and launches,
   each row's wall, phase flows and steps and ``comm_over_analytic``.
   (c) ``--suite serving --topos mphx-2p-8x8 --serving-rate-scale 4``
   with the four tenants, seed 0, twice through the kernels
   (``serving.json`` byte for byte) and once on the plain path (rows
   equal): the mixed run's flows and epochs, the wall and epochs a
   second.
13. ``train``: training through the port's entry points (``Trainer``,
   ``launch.train``), each line stamped with ``phase_s``.  yi-9b at full
   width and 8 of its 48 layers (1.91 B parameters, random bf16 weights
   from seed 0; the whole model's ~106 GB of state does not fit one
   card: reduced), the ``RunConfig`` defaults with lr 3e-3 and a warmup
   of one step, the reference's lcg stream at 4,096 tokens, global batch
   2: four steps through the kernels (each step's loss and wall,
   tokens/s, peak memory, and the launch counts of that run alone: 17
   RMSNorm forwards and backwards and 8 attention forwards (``tc``, each
   saving its rows' LSE) and backwards (``tc``, on the tensor cores, with
   that LSE) a step), again with the same bits, and on the plain path
   (remat full): losses within 2e-2 relative, step-1 gradients within
   5e-2 of each leaf's max |g|, and each parameter leaf after the steps
   within 0.25 of the plain path's own update (L2) from the init.
   ``remat`` full and dots and ``microbatches=2`` through the kernels at
   the same tolerances of remat none; 2 layers in float32 (the
   CUDA-core forward, the float32 backward) at 2e-5; a checkpoint round
   trip at the smoke config (step 3 from the restored state with the
   uninterrupted run's bits); ``python -m repro_torch.launch.train
   --arch yi-9b --smoke --steps 20`` and its ``--resume``.  Then the two
   backward kernels against their plain versions (RMSNorm's: narrow,
   unaligned, wide and the cell's (8,192, 4,096); attention's: causal, a
   binding window, G 1, 4 and 8, Dh 64, 128 and 256, and the cell's q
   (2, 4096, 4, 8, 128), each with the forward's saved LSE and without
   it), float32 (CUDA cores) at 2e-5 and bf16 (tensor cores) at 2e-2 of
   each gradient's max, twice for bitwise repeatability, the cell timed
   (events, the profiler's device ms of each pass) beside
   ``F.rms_norm``'s and SDPA's backward; and the forward's LSE (``tc``
   and ``simt`` routes, the cell among them) against its plain version
   at 1e-5, the outputs bit for bit those of a call without it.
14. ``model_kernel``: RMSNorm and flash attention against their plain
   versions (edge cases: ragged sizes, decode, GQA and MQA, a window, a
   ring cache with empty and wrapped slots, float32 and bfloat16), at
   the serve path's shapes (float32 at 2e-5; bfloat16, and for
   attention each output row within 2e-2 of its max), twice for bitwise
   repeatability, with the same times and bounds as phase 3.  RMSNorm's
   bf16 rows at the serve paths' shapes carry the plan the timed calls
   took (``ops.call_plan``; ``register``: one pass, the row in
   registers, at every model width) and that route's kernel's and
   ``F.rms_norm``'s device ms from the profiler and from 20 calls in one
   CUDA graph.  Attention
   has three routes: every decode call (Sq = 1, either dtype) takes the
   split-KV decode kernel (``decode``), bf16 with Sq > 1 the tensor-core
   one (``tc``), float32 with Sq > 1 the CUDA-core one (``simt``); the
   bf16 routes are also held to ``mask_probe``'s exact answer (within
   2^-8 of each value, empty ring slots holding NaN) at every shape of
   the three serve paths, and their device times are read from the
   profiler and from 20 calls in one CUDA graph, beside SDPA's.  Then the
   grouped matmul at mixtral-8x22b's expert shapes (prefill's 1,280-row
   capacity buffers, decode's 2 rows, the window wave's 1,300), float32
   at 2e-5 and bfloat16 per output row within 2e-2 of its max.  It has
   three routes too: bf16 with more than 64 rows a tile takes the
   TMA-fed ``wgmma`` kernel, bf16 with at most 64 (decode) the
   ``mma.sync`` one, float32 the CUDA-core one (``f32``); the ``mma``
   route splits K where its grid leaves the card's slots under-filled
   (``ops.splits_for``: decode down takes 2 on the H100, every other
   shape 1), and each line carries its ``splits``; its device
   times come from the profiler and from CUDA graphs as attention's,
   beside ``torch.bmm``'s, with the SM clock around each timing.
15. ``serve``: yi-9b at full width and depth (random bf16 weights drawn
   on the card from a seed) serves 8 requests of 1,024 prompt tokens and
   32 new tokens each in waves of 4 through the kernels, with the launch
   counts read around that run alone (97 RMSNorm and 48 attention
   launches per forward pass, the 96 of the two prefill passes on the
   tensor-core kernel, the 3,072 of the 64 decode steps on the decode
   kernel); then the same requests on the plain path.
   Prefill and teacher-forced decode logits of the two paths must agree,
   and a float32 2-layer yi-9b must agree at 2e-5; a decode wave is
   profiled for the device's idle share.
16. ``moe_serve``: mixtral-8x22b at full width and 12 of its 56 layers
   (60.9 GB of random bf16 weights drawn on the card after yi-9b's are
   freed) serves the same traffic through the kernels, with the launch
   counts read around that run alone (25 RMSNorm, 12 attention and 36
   grouped-matmul launches per forward pass; 24 tensor-core attention
   launches in the two prefills, 768 decode ones; the 72 grouped-matmul
   launches of the two prefills on the ``wgmma`` route, the 2,304 of
   decode on ``mma``, of which the 768 down products split K on the
   H100), then on the plain path.
   The ragged grouped matmul is held to its plain version on the routed
   rows of the first layer of a prefill wave, as routed and with groups
   padded to 128 rows (the ``wgmma`` route; timed as the grouped one,
   beside ``torch._grouped_mm``).  Teacher-forced logits must agree
   within 5e-2 of max |logit| with the plain path's expert choice
   replayed on the kernel path (the router is discontinuous: a near-tie
   flipped by bf16 rounding moves a token's FFN output by O(1)); the
   free-routing gap and the count of routings that differ are printed
   beside it.  A 4,160-token request
   runs through mixtral's 4,096-token window, a decode wave is profiled,
   and a float32 2-layer mixtral must agree at 2e-5 with no routing
   flipped.
17. ``hybrid_serve``: the RG-LRU scan bit for bit equal to its plain
   version, with each shape's plan, at ``tests/test_kernels.py``'s edge
   shapes, ragged widths and lengths, recurrentgemma-2b prefill's (4,
   1024, 2560) (timed: event, device and CUDA-graph ms, GB/s and the
   share of the bound by device ms) and its window wave's (1, 2304, 2560)
   (a check row), RMSNorm at d_model 2,560 and
   attention at head dim 256 at the path's shapes (as phase 11); then
   recurrentgemma-2b uncut (26 layers, 6.26 GB of random bf16 weights,
   the gates and conv taps float32) serves the same traffic through the
   kernels, with the launch counts read around that run alone (53
   RMSNorm and 8 attention launches per forward pass, 16 of them on the
   tensor-core kernel in the two prefills and 512 on the decode kernel,
   18 scans per prefill and none in decode), then on the plain path.
   Teacher-forced logits must agree within 5e-2 of max |logit|, also for
   a 2,304-token request through the 2,048-token local window; a decode
   wave is
   profiled, and a float32 model at full width and 5 of its 26 layers
   must agree at 2e-5.
18. ``ssm_serve``, each line stamped with ``phase_s``: RMSNorm against
   its plain version at xlstm-125m's shapes, (4,096, 768) and (4, 768) on
   the ``narrow`` route, (4,096, 1,536) and (4, 1,536) (the mLSTM's
   ``out_norm``) on ``register``, as in phase 14; one mLSTM block in
   float32 at full width, the chunkwise form against the sequential one
   over 1,024 tokens (outputs and final C, n, m within 1e-4 of their
   max).  Then xlstm-125m uncut (12 layers, random bf16 weights from
   seed 0, the gates and the sLSTM float32) serves the same traffic
   through the kernels, with the launch counts read around that run
   alone (25 RMSNorm launches a forward pass, 1,650 in all, no other
   kernel), then on the plain path; the share of a prefill wave's wall in
   the sLSTM time loop; teacher-forced logits within 5e-2 of max |logit|,
   also for a 1,000-token request (the chunkwise form pads its last
   chunk); a decode wave profiled; the float32 model uncut at 2e-5; and
   ``python -m repro_torch.launch.serve --arch xlstm-125m`` at its
   defaults.
19. ``audio_serve``, each line stamped with ``phase_s``: attention at
   whisper-small's shapes (a wave of 4, 12 heads of 64, G = 1) against
   its plain version and ``mask_probe``'s answer, as in phase 14, timed
   beside SDPA with 20-call CUDA graphs: non-causal, the encoder's
   self-attention over 1,500 frames, the prompt's cross-attention (4
   queries over the frames) and a decode step's (the decode route);
   causal, the prompt's self-attention and the last decode step's over
   its ring.  Then whisper-small uncut (12 encoder and 12 decoder layers,
   random bf16 weights from seed 0) serves 8 requests of 1,500 frames
   (0.1 x N(0, 1)), a 4-token prompt and 64 new greedy tokens each, in
   waves of 4, through ``EncDecLM.prefill`` and ``decode_step`` (neither
   serve CLI takes audio): through the kernels, with the launch counts
   read around that run alone (36 ``tc`` launches a prefill, 24
   ``decode`` ones a decode step, no other kernel), then on the plain
   path; the encoder pass's wall, teacher-forced bf16 logits within 5e-2
   of max |logit|, a decode wave profiled, the float32 model uncut at
   2e-5 with its greedy tokens all equal.
20. A ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and as
   the last line ``{"ok": true, "device": {...}}``.

Exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "repro_torch" / "chip_smoke"
GOLDEN = ROOT / "tests" / "golden" / "fairshare_golden.json"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float64 and float32
# outside the tensor cores, bf16 on the tensor cores (dense).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP64_PER_S = 34e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12

MAIN_TOPO = "mphx-4p-86x9"
MAIN_SCENARIOS = ["uniform", "neighbor_shift"]
MAIN_LOADS = (0.5, 0.9)
# wall clocks, and the size of round-off (each row's agrees_1e-6 flag
# holds that one to its bound)
UNCOMPARED_KEYS = ("sim_wall_s", "sweep_wall_s", "max_abs_util_diff")
# the sweep phase: every synthetic scenario (transpose a skip record on
# the non-square Table-2 row) in the three routing modes, measured FCTs
# on the minimal rows
SWEEP_TOPOS = ["mphx-2p-16x16", MAIN_TOPO]
SWEEP_SCENARIOS = ["uniform", "neighbor_shift", "bit_complement",
                   "transpose", "hotspot", "allreduce_ring",
                   "allgather_ring", "alltoall"]
SWEEP_LOADS = (0.5, 1.0)
# the valiant sim phase: water-filling over the valiant incidence
VALIANT_SCENARIO = "hotspot"
VALIANT_LOADS = (0.5, 0.9)

# the graph phase: the Table-2 baselines on the graph engine
GRAPH_SMALL = ["ft3-small", "mpft-2p-small", "dragonfly-small",
               "dfplus-small"]
GRAPH_BIG = ["ft3-65536", "mpft-8p-65536", "dragonfly-65536",
             "dfplus-65536"]
GRAPH_SIM_TOPO = "mpft-8p-65536"
GRAPH_BIG_SCENARIOS = ["uniform", "neighbor_shift"]
# reduced: the plain pass of the 65K sweep runs uniform alone
GRAPH_PLAIN_BIG_SCENARIOS = ["uniform"]
GRAPH_PROFILED = "dragonfly-65536"
# the row-scatter kernel lines: the largest pull
GRAPH_KERNEL_TOPO = "ft3-65536"

# the table2_trace phase: results/BENCH_sim_scale.json's workload
# (neighbor_shift at 0.9, default_rng(7), sizes up to 16 MiB, starts
# within 200 us) at mphx-4p-86x9, the many-epoch cell, where the
# reference's numpy loop took 1,547 epochs; and the reference's bounded
# series (tests/test_telemetry.py) at mphx-8p-256
SIM_SCALE_SEED, SIM_SCALE_LOAD = 7, 0.9
SIM_SCALE_SIZE_MAX, SIM_SCALE_WINDOW_S = float(1 << 24), 200e-6
SIM_SCALE_EPOCHS = 1547
BOUNDED_TOPO = "mphx-8p-256"
# the spray phase: that workload sprayed over mphx-4p-86x9's 4 planes in
# three variants; then the sim suite's measured collectives at its
# defaults and on the largest fabric it measures them on (4,096 NICs)
SPRAY_VARIANTS = {
    "a chunk": dict(granularity="chunk"),
    "b chunk skewed": dict(granularity="chunk",
                           plane_skew=[1.0, 1.5, 1.0, math.inf]),
    "c flowlet dead": dict(granularity="flowlet", flowlet_bytes=1 << 16,
                           flowlet_seed=0,
                           plane_skew=[1.0, 1.0, 1.0, math.inf]),
}
SPRAY_RUNS = (("cuda", "cuda", "cuda"), ("torch", "cuda", "torch"),
              ("cpu", "cpu", "torch"))
COLLECTIVE_TOPO = "mphx-2p-16x16"
# the failures phase: --suite failures through the CLI at its defaults,
# then the paper's Table-2 MPHX and mphx-2p-16x16 under a link and plane
# failure and a switch failure, uniform, three reroute modes, 4 layers.
# Reduced: the plain pass at mphx-4p-86x9 runs the first spec alone, and
# the CPU pass runs mphx-2p-16x16 under the second alone (the CPU's
# minimal incidence of 65,280 pairs takes ~18 s a reroute mode on the
# card's host)
FAILURE_TOPOS = [MAIN_TOPO, COLLECTIVE_TOPO]
FAILURE_SPECS = ["link:0.01,plane:1", "switch:0.02,seed:3"]
FAILURE_LAYERS = 4
# not compared as values: the walls, time_to_90_s (a wall: only whether
# it is None) and conservation_residual (raw round-off: below 1e-9 on
# each side)
FAILURE_UNCOMPARED_KEYS = ("phase_wall_s", "t_offset_s", "sim_wall_s",
                           "time_to_90_s", "conservation_residual")
# the cosim_serving phase: --suite serving with the four tenant presets;
# one training step of kimi-k2 and mixtral on 16,384 ranks of the paper's
# Table-2 MPHX (through the kernels and on the plain path; its kernel
# repeat cut for time) and on
# 4,096 ranks of mphx-2p-16x16 (kernels and the CPU); the serving mix at
# 4 x its rates on mphx-2p-8x8 (the many-epoch host-bound cell)
SERVING_TENANTS = ["chat", "burst", "train", "web"]
COSIM_CELLS = [
    (MAIN_TOPO, 16_384, (("cuda", "cuda", "cuda"),
                         ("torch", "cuda", "torch"))),
    (COLLECTIVE_TOPO, 4096, (("cuda", "cuda", "cuda"),
                             ("cpu", "cpu", "torch"))),
]
SERVING_TOPO, SERVING_RATE_SCALE = "mphx-2p-8x8", 4.0

KERNELS = {
    "segment_sum": "src/repro/kernels/segment_fairshare/kernel.py:97",
    "segment_min": "src/repro/kernels/segment_fairshare/kernel.py:107",
}
SOURCE = "src/repro_torch/kernels/segment_fairshare/csrc/segment_reduce.cu"
MODEL_KERNELS = {
    "rmsnorm": ("src/repro/kernels/rmsnorm/kernel.py:25",
                "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"),
    "flash_attention": (
        "src/repro/kernels/flash_attention/kernel.py:97",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"),
    "grouped_matmul": (
        "src/repro/kernels/grouped_matmul/kernel.py:42",
        "src/repro_torch/kernels/grouped_matmul/csrc/grouped_matmul.cu"),
    "ragged_grouped_matmul": (
        "src/repro/kernels/grouped_matmul/kernel.py:94",
        "src/repro_torch/kernels/grouped_matmul/csrc/grouped_matmul.cu"),
    "lru_scan": ("src/repro/kernels/rg_lru/kernel.py:40",
                 "src/repro_torch/kernels/rg_lru/csrc/lru_scan.cu"),
    # the gradients: no Pallas kernel has one; the reference trains
    # through jax.grad of its plain layers
    "rmsnorm_backward": (
        "src/repro/models/layers.py:65",
        "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_backward.cu"),
    "flash_attention_backward": (
        "src/repro/models/layers.py:227",
        "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention_backward.cu"),
}
# what the backward rows replace: JAX's autodiff of the plain layer
AUTODIFF_OF = {"rmsnorm_backward": "jax.grad of repro.models.layers.rmsnorm",
               "flash_attention_backward":
               "jax.grad of repro.models.layers.attention"}
# the serve path: yi-9b, 8 requests of 1,024 tokens, 32 new, waves of 4
SERVE_ARCH = "yi-9b"
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_BATCH = 8, 1024, 32, 4
SERVE_SEED = 0
SERVE_MAX_LEN = SERVE_PROMPT + SERVE_NEW + 1
# logits of the kernel path vs the plain path, as max |diff| / max |logit|:
# bf16 at tests/test_kernels.py's 5e-2, float32 at its 2e-5
SERVE_TOL = {"bfloat16": 5e-2, "float32": 2e-5}
# bf16 attention at the serve path's shapes, per output row (one query
# head's Dh values): max |kernel - plain| within this share of the row's
# max |plain|.  The kernel keeps the softmax weights in fp32 where the
# plain version rounds them to bf16 before the PV product; the two then
# differ by one bf16 ulp of the row's max (2^-7 of it on an NVIDIA H100
# 80GB HBM3 at 700 W), and 2e-2 leaves 2.5 times that.
ATTN_ROW_TOL_BF16 = 2e-2
# the MoE serve path: mixtral-8x22b at full width, 12 of its 56 layers
# (60.9 GB of bf16 weights; 14 would leave too little of the card's 80 GB
# for the plain path's float32 copy of one expert matrix, 3.2 GB, and the
# prefill buffers), the same traffic as yi-9b
MOE_ARCH, MOE_LAYERS = "mixtral-8x22b", 12
# one request past mixtral's 4,096-token window, decoded 8 steps
WINDOW_PROMPT, WINDOW_NEW = 4160, 8
# the grouped matmul in bf16, per output row: both versions sum exact bf16
# products in fp32 (in another order) and round once, so a row differs by
# at most one bf16 ulp of its max (2^-8 of it); 2e-2 as attention's rule
GMM_ROW_TOL_BF16 = 2e-2
# the hybrid serve path: recurrentgemma-2b uncut (6.26 GB of weights), the
# traffic of yi-9b; its float32 check at full width runs one unit of
# (rec, rec, attn) and the 2 tail rec blocks
HYBRID_ARCH, HYBRID_F32_LAYERS = "recurrentgemma-2b", 5
# one request past the 2,048-token local window, decoded WINDOW_NEW steps
HYBRID_WINDOW_PROMPT = 2304
# the RG-LRU scan against its plain version: tests/test_kernels.py's 1e-5
LRU_TOL = 1e-5
# the ssm serve path: xlstm-125m uncut (134.3 M parameters), the traffic
# of yi-9b; its float32 check runs it uncut too.  One request of a length
# that is no multiple of the 256-token chunk (its last chunk padded), and
# the chunkwise mLSTM against its sequential oracle in float32, each
# output within this share of its max |value|
SSM_ARCH, SSM_PADDED_PROMPT = "xlstm-125m", 1000
MLSTM_FORM_TOL = 1e-4
# the audio serve path: whisper-small uncut (238.2 M parameters, 0.48 GB in
# bf16; its float32 check runs it uncut too).  8 requests in waves of 4,
# each of 1,500 encoder frames (whisper's 30-s window after the conv
# stack's 2x downsampling; the frontend is a stub that takes frames) drawn
# as 0.1 x N(0, 1), a 4-token decoder prompt and 64 new greedy tokens
AUDIO_ARCH = "whisper-small"
AUDIO_REQUESTS, AUDIO_BATCH, AUDIO_FRAMES = 8, 4, 1500
AUDIO_PROMPT, AUDIO_NEW = 4, 64
AUDIO_MAX_LEN = AUDIO_PROMPT + AUDIO_NEW + 1
# mask_probe through the bf16 attention routes: exact weights summed in
# fp32 and acc / l rounded once to bf16, so within 2^-8 of each value
PROBE_REL_TOL = 2.0 ** -8
# the train phase's cell: yi-9b at full width and 8 of its 48 layers (1.91
# B parameters: bf16 params and grads and float32 AdamW moments are 22.9
# GB; the whole model's ~106 GB of state does not fit one card), the
# RunConfig defaults with lr 3e-3 and a warmup of one step (step 1's lr
# scale is 0, steps 2-4 take the full lr: the defaults' 100 would scale
# them by at most 0.03, too little to move bf16 weights), the lcg stream at
# train_4k's 4,096 tokens, global batch 2 (8,192 tokens a step), four steps
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_F32_LAYERS = "yi-9b", 8, 2
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 4
TRAIN_LR, TRAIN_WARMUP, TRAIN_SEED = 3e-3, 1, 0
# a path against another: each loss within this share of the other's, and
# each step-1 gradient leaf within the grad tolerance of its max |g| (the
# serve gate's bf16 tolerance; float32 at 2e-5)
TRAIN_LOSS_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
TRAIN_GRAD_TOL = {"bfloat16": 5e-2, "float32": 2e-5}
# the kernel path's parameters after the four steps against the plain
# path's: each leaf's L2 distance within this share of the plain path's
# own L2 update from the init.  Twice what a sound run reads on the H100;
# tools/train_update_gap.py reads it under faults of the attention
# backward that start at step 2
TRAIN_UPDATE_TOL = 0.25
TRAIN_CKPT_DIR = ROOT / "build" / "repro_torch" / "train_ck"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> int:
    """The card's SM clock now, from ``nvidia-smi`` (MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return int(out.stdout.split()[0])


def time_ms(fn, reps: int = 20, samples: int = 7) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events (after a warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(samples):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        per_call.append(t0.elapsed_time(t1) / reps)
    return statistics.median(per_call)


def device_time(fn, kernel_name: str, reps: int = 20) -> dict:
    """Device time per call of the kernels whose name contains
    ``kernel_name`` (all kernels for ""), from ``torch.profiler``, and how
    many runs of them it recorded.  Late in a long process the profiler
    can drop some of a session's kernel records, so the time is reckoned
    per kernel name: its mean over the runs recorded, times the runs it
    makes a call (ceil(recorded / reps), at least 1), summed over the
    names.  A kernel that runs once a call is timed right whatever was
    dropped, and with nothing dropped every kernel is.  ``ms`` is None
    when the profiler records no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [(c, t) for name, c, t in device_events(prof)
            if kernel_name in name]
    ms = sum(t / c * max(1, -(-c // reps)) for c, t in hits) / 1e3
    return {"ms": ms if ms > 0 else None,
            "recorded": sum(c for c, _ in hits)}


def graph_ms(fn, calls: int = 20, samples: int = 5) -> float:
    """Mean time per call of ``calls`` calls captured in one CUDA graph,
    each replay timed by CUDA events (median of ``samples``): the host's
    launch work is left out, the gaps between the graph's kernels are
    not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(samples):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        per_call.append(t0.elapsed_time(t1) / calls)
    del graph
    return statistics.median(per_call)


def device_events(prof) -> "list[tuple[str, int, float]]":
    """(name, count, total microseconds) of the work the profiler saw on
    the device (kernels, copies, fills), longest first, summed from its
    raw event list.  ``key_averages()`` costs time that grows with the
    events (tens of seconds for a graph route's ~10^5 launches), and late
    in this script it kept fewer kernel records than the raw list (24
    rows without device ms against 7 in one H100 run each)."""
    cuda = torch.autograd.DeviceType.CUDA
    acc = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and e.duration_ns() > 0:
            count, us = acc.get(e.name(), (0, 0.0))
            acc[e.name()] = (count + 1, us + e.duration_ns() / 1e3)
    return sorted(((n, c, t) for n, (c, t) in acc.items()),
                  key=lambda k: -k[2])


def bound(nnz: int, n_seg: int, permuted: bool, id_bytes: int) -> dict:
    """Least time for one segment reduction: each value (8 B) read once,
    each output (8 B) written once and the index read once in the
    smaller of its two forms, or one float64 operation per entry.  The
    index is the function's own ids (``id_bytes`` each) or the kernel's
    plan (a 4-byte permutation entry per value where permuted, and a
    4-byte CSR offset per segment), whichever is fewer bytes: a sparse
    sum into many segments needs no offset per segment.  Both forms'
    bytes are reported beside the bound, and with a permutation also the
    plan's bytes at the card's 32-byte sectors when each gathered value
    takes a sector of its own, and their time (not in the bound)."""
    ids = id_bytes * nnz
    plan = (4 * nnz if permuted else 0) + 4 * (n_seg + 1)
    n_bytes = 8 * nnz + min(ids, plan) + 8 * n_seg
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = nnz / PEAK_FP64_PER_S
    out = {"bytes": n_bytes, "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_index": "ids" if ids < plan else "plan",
           "ids_bytes": ids, "plan_bytes": plan}
    if permuted:
        sectors = 8 * nnz + plan + 8 * n_seg + 24 * nnz
        out.update(sector_bytes=sectors,
                   sector_ms=sectors / PEAK_BYTES_PER_S * 1e3)
    return out


def check_kernel(name: str, vals, ids, n_seg: int, plan=None,
                 main_shape: bool = False) -> "tuple[float, int]":
    """Kernel vs plain version on the card; returns the max abs error and
    the plan's lanes.  Sum: bit for bit its ordered twin at the plan's
    lanes (the plan the wrapper builds when none is given), and within
    1e-12 * max|v| * NNZ of ``index_add_`` (which adds in no fixed
    order); at a main-path shape the twin at the plan's lanes must also
    equal the twin at 32, the one-warp-a-segment order of the first
    kernel.  Min: exact.  Two runs: same bits."""
    from repro_torch.kernels import segment_fairshare as sf

    kern = getattr(sf, name)
    ref = getattr(sf, f"{name}_ref")
    if plan is None:
        plan = sf.make_plan(ids, n_seg)
    got = kern(vals, ids, n_seg, plan=plan)
    again = kern(vals, ids, n_seg, plan=plan)
    want = ref(vals, ids, n_seg)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two runs differ (nnz={vals.numel()})")
    if got.shape != (n_seg,):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {n_seg}")
    both_inf = torch.isinf(got) & torch.isinf(want) & (got == want)
    diff = torch.where(both_inf, 0.0, (got - want).abs())
    err = float(diff.max()) if n_seg else 0.0
    if name == "segment_min":
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: differs from plain version "
                                 f"(max abs err {err})")
        return err, plan.lanes
    vmax = float(vals.abs().max()) if vals.numel() else 0.0
    tol = 1e-12 * vmax * vals.numel()
    if err > tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    twin = sf.segment_sum_ordered_ref(vals, plan)
    if not torch.equal(got.view(torch.int64), twin.view(torch.int64)):
        raise AssertionError(f"{name}: differs from its ordered twin at "
                             f"{plan.lanes} lanes (nnz={vals.numel()}, "
                             f"segments={n_seg})")
    if main_shape and not torch.equal(
            twin, sf.segment_sum_ordered_ref(vals, plan, 32)):
        raise AssertionError(f"{name}: the twin at {plan.lanes} lanes "
                             "differs from the twin at 32")
    return err, plan.lanes


def phase_kernels() -> dict:
    from repro_torch.core.netsim import make_router
    from repro_torch.core.routing_vec import uniform_demands
    from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES
    from repro_torch.kernels.segment_fairshare import make_plan
    from repro_torch.sim.fairshare import SolveProblem, flow_incidence

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # edge cases: (nnz, segments, id range low, id range high); 101 and
    # 333 segments at 4 and 16 lanes leave the last warp part-filled
    cases = [(0, 5, 0, 5), (1, 1, 0, 1), (1, 3, 0, 3), (1000, 37, 0, 37),
             (1025, 2000, 0, 2000), (3000, 1, 0, 1), (4097, 64, 0, 67),
             (10, 0, 0, 1), (300, 101, 0, 101), (3000, 333, 0, 333)]
    for nnz, n_seg, lo, hi in cases:
        vals = torch.randn(nnz, dtype=torch.float64, device=dev,
                           generator=gen)
        ids = torch.randint(lo, hi, (nnz,), device=dev, generator=gen)
        for name in KERNELS:
            err, lanes = check_kernel(name, vals, ids, n_seg)
            srt = torch.sort(ids).values
            check_kernel(name, vals, srt, n_seg,
                         plan=make_plan(srt, n_seg, presorted=True))
            emit("kernel", kernel=name, case="edge", nnz=nnz, segments=n_seg,
                 lanes=lanes, max_abs_err=err, ok=True)

    # the main path's shapes: mphx-4p-86x9 uniform incidence
    topo = SWEEP_TOPOLOGIES[MAIN_TOPO]
    router = make_router(topo, device=dev)
    inc = flow_incidence(router, uniform_demands(topo, topo.nic_bw_gbps,
                                                 device=dev))
    prob = SolveProblem.build(inc, "cuda")
    nnz, E, F = inc.nnz, prob.n_edges, inc.n_flows
    rand = torch.rand(nnz, dtype=torch.float64, device=dev, generator=gen)
    bneck_vals = inc.capacity[inc.edge] / inc.frac
    edge = (prob.edge, E, prob.edge_plan, True)
    flow = (inc.flow, F, prob.flow_plan, False)
    # (kernel, call site, values, (ids, segments, plan, permuted)); the
    # first shape of each kernel is the one its summary line reports
    shapes = [
        # per-edge live weight of a water-filling round, and the epoch's
        # edge bytes: edge-major, through the permutation
        ("segment_sum", "edge", inc.frac, edge),
        # per-flow saturated share of a round, and switch hops: flow-major
        ("segment_sum", "flow", inc.frac, flow),
        # per-flow bottleneck (FlowIncidence.bottleneck_gbps): flow-major
        ("segment_min", "flow", bneck_vals, flow),
        ("segment_min", "edge", bneck_vals, edge),
    ]
    results = {}
    for name, site, vals, (ids, n_seg, plan, permuted) in shapes:
        check_kernel(name, rand, ids, n_seg, plan, main_shape=True)
        row = kernel_row(name, f"{MAIN_TOPO} uniform", site, vals, ids,
                         n_seg, plan, permuted, main_shape=True)
        results.setdefault(name, row)
    return results


def kernel_row(name: str, case: str, site: str, vals, ids, n_seg: int,
               plan, permuted: bool, main_shape: bool = False) -> dict:
    """One main-path shape of a segment kernel: held to its plain
    version (:func:`check_kernel`), then timed beside the plain version
    and the one PyTorch call that computes the same function, with its
    bound; emits a ``kernel`` line and returns its numbers."""
    from repro_torch.kernels.segment_fairshare import (segment_min_ref,
                                                       segment_sum_ref)
    from repro_torch.kernels.segment_fairshare import ops

    err, lanes = check_kernel(name, vals, ids, n_seg, plan,
                              main_shape=main_shape)
    kern = getattr(ops, name)
    ref = {"segment_sum": segment_sum_ref,
           "segment_min": segment_min_ref}[name]
    out = torch.empty(n_seg, dtype=torch.float64, device=vals.device)
    if name == "segment_sum":
        library = "index_add_"

        def lib_call():
            out.zero_().index_add_(0, ids, vals)
    else:
        library = "scatter_reduce_(amin)"

        def lib_call():
            out.fill_(math.inf).scatter_reduce_(0, ids, vals, "amin")

    def call():
        kern(vals, ids, n_seg, plan=plan)

    ms = time_ms(call)
    plain_ms = time_ms(lambda: ref(vals, ids, n_seg))
    lib_ms = time_ms(lib_call)
    nnz = vals.numel()
    b = bound(nnz, n_seg, permuted, ids.element_size())
    emit("kernel", kernel=name, case=case, site=site, nnz=nnz,
         segments=n_seg, permuted=permuted, lanes=lanes, max_abs_err=err,
         ms=ms, plain_ms=plain_ms, library=library, library_ms=lib_ms,
         # one template, segment_reduce_kernel<Op, G>: the name matches
         # the instance of every Op and lanes count, and the call
         # launches one of them
         kernel_device_ms=device_time(call, "segment_reduce_kernel")["ms"],
         library_device_ms=device_time(lib_call, "")["ms"], **b,
         achieved_GBps=b["bytes"] / (ms * 1e-3) / 1e9, ok=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "lanes": lanes, **b}


def compare_rows(a, b, where: str, uncompared: tuple = UNCOMPARED_KEYS,
                 exact: bool = False) -> None:
    """Rows, lists of rows and the dicts and lists inside them (a cosim
    row's ``phases`` and ``mesh``): the same keys, every value but the
    ``uncompared`` keys' equal, ints and strings exactly, floats at 1e-9
    relative (exactly with ``exact``)."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            raise AssertionError(f"{where}: keys {sorted(a)} != "
                                 f"{sorted(b) if isinstance(b, dict) else b}")
        for k, v in a.items():
            if k not in uncompared:
                compare_rows(v, b[k], f"{where}: {k}", uncompared, exact)
    elif isinstance(a, list):
        if not isinstance(b, list) or len(a) != len(b):
            raise AssertionError(f"{where}: {a} != {b}")
        for i, (x, y) in enumerate(zip(a, b)):
            compare_rows(x, y, f"{where}[{i}]", uncompared, exact)
    elif isinstance(a, float) and isinstance(b, float) and not exact:
        if abs(a - b) > 1e-9 * max(abs(a), abs(b)):
            raise AssertionError(f"{where}: {a} != {b}")
    elif a != b:
        raise AssertionError(f"{where}: {a!r} != {b!r}")


def run_suite(backend: str, topo: str, out: str) -> "tuple[dict, float]":
    from repro_torch.experiments.simsuite import run_sim_suite

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = run_sim_suite(str(OUT_DIR / out), topo_names=[topo],
                            scenario_names=MAIN_SCENARIOS,
                            load_fractions=MAIN_LOADS, sim_backend=backend,
                            device="cuda")
    torch.cuda.synchronize()
    return payload, time.perf_counter() - t0


def phase_main_path() -> dict:
    from repro_torch.kernels.segment_fairshare import (LAUNCHES,
                                                       reset_launch_counts)

    # a small run first, so that neither timed run pays the first use of
    # torch's own kernels
    run_suite("cuda", "mphx-2p-8x8", "warmup")
    reset_launch_counts()
    runs = {"cuda": run_suite("cuda", MAIN_TOPO, "cuda")}
    launches = dict(LAUNCHES)
    runs["torch"] = run_suite("torch", MAIN_TOPO, "torch")
    for backend, (payload, wall) in runs.items():
        for r in payload["rows"]:
            if r.get("kind") != "fct":
                continue
            emit("main_path", backend=backend, scenario=r["scenario"],
                 offered_fraction=r["offered_fraction"],
                 flows=r["sim_flows"], nnz=r["sim_nnz"],
                 epochs=r["sim_epochs"],
                 waterfill_rounds=r["sim_waterfill_rounds"],
                 fct_p50_us=r["fct_p50_us"], fct_p99_us=r["fct_p99_us"],
                 slowdown_p99=r["slowdown_p99"],
                 sim_wall_s=r["sim_wall_s"])
        emit("main_path", backend=backend, suite_wall_s=wall,
             device_name=payload["params"]["device_name"])
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel")
    if not runs["cuda"][0]["params"]["all_steady_checks_agree_1e-6"]:
        raise AssertionError("steady-state loads diverge from the analytic "
                             "engine")
    rows = {b: [r for r in p["rows"] if r.get("kind") in ("fct",
                                                         "steady_check")]
            for b, (p, _) in runs.items()}
    if len(rows["cuda"]) != len(MAIN_SCENARIOS) * (1 + len(MAIN_LOADS)):
        raise AssertionError(f"unexpected row count {len(rows['cuda'])}")
    for a, b in zip(rows["cuda"], rows["torch"]):
        compare_rows(a, b, f"{a['scenario']}/{a['kind']}")
        for k, v in a.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{a['scenario']}: {k} = {v}")
    emit("main_path", launches=launches, rows_agree=True, ok=True)

    # where the time goes: the same run once more under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = run_suite("cuda", MAIN_TOPO, "profiled")
    kernels = device_events(prof)
    busy_ms = sum(k[2] for k in kernels) / 1e3
    emit("main_path", profiled_wall_s=wall, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / (wall * 1e3),
         top_device_ops=[{"name": n[:80], "count": c, "ms": t / 1e3}
                         for n, c, t in kernels[:10]])
    return launches


def check_golden_cell(router, dem, mode: str, want: dict, flow_time_s,
                      cell: str, load_key: str) -> None:
    """One load of a golden cell on the card: exact incidence sizes,
    rates and link loads within 1e-9 of the scale, FCT columns within
    1e-9 relative, integers exact."""
    from repro_torch.sim.events import simulate_demands
    from repro_torch.sim.fairshare import flow_incidence, max_min_rates

    inc = flow_incidence(router, dem, mode)
    assert (inc.n_flows, inc.n_edges, inc.nnz) == (
        want["n_flows"], want["n_edges"], want["nnz"])
    caps = dem.gbps
    scale = max(float(caps.max()), 1.0)
    rates = max_min_rates(inc, caps, backend="cuda",
                          device="cuda").cpu().numpy()
    err = float(np.abs(rates - np.asarray(want["rates_gbps"])).max())
    if err > 1e-9 * scale:
        raise AssertionError(f"{cell}@{load_key}: rates err {err}")
    loads = inc.loads(rates, "cuda").cpu().numpy()
    golden = np.zeros(inc.n_edges)
    for e, v in want["link_loads_gbps_nonzero"].items():
        golden[int(e)] = v
    lerr = float(np.abs(loads - golden).max())
    if lerr > 1e-9 * scale:
        raise AssertionError(f"{cell}@{load_key}: loads err {lerr}")
    row = simulate_demands(router, dem, flow_time_s, mode=mode,
                           backend="cuda", inc=inc)
    for k, v in want["fct"].items():
        got = row[k]
        if isinstance(v, float) and v != 0:
            if abs(got - v) > 1e-9 * abs(v) + 1e-12:
                raise AssertionError(f"{cell}@{load_key}: {k} {got} != {v}")
        elif got != v:
            raise AssertionError(f"{cell}@{load_key}: {k} {got} != {v}")
    emit("golden", cell=cell, mode=mode, load=load_key, n_flows=inc.n_flows,
         nnz=inc.nnz, rates_max_abs_err=err, loads_max_abs_err=lerr,
         epochs=row["sim_epochs"], ok=True)


def phase_golden() -> None:
    from repro_torch.core.netsim import make_router
    from repro_torch.core.routing_graph import graph_uniform_demands
    from repro_torch.core.routing_vec import (hotspot_demands,
                                              neighbor_shift_demands,
                                              uniform_demands)
    from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES
    from repro_torch.sim.events import simulate_incidence
    from repro_torch.sim.fairshare import flow_incidence

    fixture = json.loads(GOLDEN.read_text())
    topo = SWEEP_TOPOLOGIES["mphx-2p-8x8"]
    router = make_router(topo, device="cuda")
    builders = {"uniform": (uniform_demands, "minimal"),
                "neighbor_shift": (neighbor_shift_demands, "minimal"),
                "hotspot_valiant": (hotspot_demands, "valiant")}
    for scen, (build, mode) in builders.items():
        cell = fixture["cells"][f"array/mphx-2p-8x8/{scen}"]
        if cell["mode"] != mode:
            raise AssertionError(f"{scen}: golden mode {cell['mode']}")
        for load_key, want in cell["loads"].items():
            dem = build(topo, float(load_key) * topo.nic_bw_gbps,
                        device="cuda")
            check_golden_cell(router, dem, mode, want, fixture["flow_time_s"],
                              f"mphx-2p-8x8/{scen}", load_key)
    # the graph engine's cell: dragonfly-small, uniform, minimal
    topo = SWEEP_TOPOLOGIES["dragonfly-small"]
    router = make_router(topo, device="cuda")
    cell = fixture["cells"]["graph/dragonfly-small/uniform"]
    for load_key, want in cell["loads"].items():
        dem = graph_uniform_demands(topo, float(load_key) * topo.nic_bw_gbps,
                                    graph=router.graph, device="cuda")
        check_golden_cell(router, dem, cell["mode"], want,
                          fixture["flow_time_s"], "dragonfly-small/uniform",
                          load_key)
    topo = SWEEP_TOPOLOGIES["mphx-2p-8x8"]
    router = make_router(topo, device="cuda")
    rec = fixture["staggered"]
    inc = flow_incidence(router, neighbor_shift_demands(topo, 800.0,
                                                        device="cuda"))
    res = simulate_incidence(inc, rec["size_bytes"], rec["rate_caps_gbps"],
                             start_s=rec["start_s"], backend="cuda",
                             device="cuda")
    makespan = rec["makespan_s"]
    if res.n_epochs != rec["n_epochs"]:
        raise AssertionError(f"staggered: {res.n_epochs} epochs != "
                             f"{rec['n_epochs']}")
    ferr = float(np.abs(res.finish_s.cpu().numpy()
                        - np.asarray(rec["finish_s"])).max())
    cerr = float(np.abs(res.fct_s.cpu().numpy()
                        - np.asarray(rec["fct_s"])).max())
    if max(ferr, cerr, abs(res.makespan_s - makespan)) > 1e-9 * makespan:
        raise AssertionError(f"staggered: finish err {ferr}, fct err {cerr}")
    golden_bytes = np.zeros(inc.n_edges)
    for e, v in rec["edge_bytes_nonzero"].items():
        golden_bytes[int(e)] = v
    size_sum = float(np.sum(rec["size_bytes"]))
    berr = np.abs(res.edge_bytes.cpu().numpy() - golden_bytes)
    if np.any(berr > 1e-9 * np.abs(golden_bytes) + 1e-9 * size_sum):
        raise AssertionError(f"staggered: edge bytes err {berr.max()}")
    emit("golden", cell="staggered mphx-2p-8x8/neighbor_shift",
         epochs=res.n_epochs, finish_max_abs_err=ferr, ok=True)


def timed(fn):
    """``(fn(), wall seconds)``, the device synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def launched(by_path: dict, path: str, kernels=tuple(KERNELS),
             counts=None) -> None:
    """Keep ``path``'s launch counts in ``by_path`` (default: the counts
    now); each of ``kernels`` must have launched."""
    from repro_torch.kernels.segment_fairshare import LAUNCHES

    by_path[path] = dict(LAUNCHES if counts is None else counts)
    missing = [k for k in kernels if by_path[path][k] == 0]
    if missing:
        raise AssertionError(f"{path} launched no {missing} kernel")


def run_cli(args: list, out: Path, dev: str, backend: str) -> tuple:
    """``python -m repro_torch.experiments.run`` with ``args`` on ``dev``
    and ``backend`` into ``out``, from an emptied cache and zeroed launch
    counts: (the suite's payload, wall, peak bytes on the card (None on
    the CPU), launch counts)."""
    from repro_torch.experiments.run import main as cli
    from repro_torch.kernels.segment_fairshare import (LAUNCHES,
                                                       reset_launch_counts)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    rc, wall = timed(lambda: cli(args + ["--device", dev, "--sim-backend",
                                         backend, "--out", str(out)]))
    if rc != 0:
        raise AssertionError(f"{args} on {dev} ({backend}): exit {rc}")
    suite = args[args.index("--suite") + 1]
    payload = json.loads((out / f"{suite}.json").read_text())
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
    return payload, wall, peak, dict(LAUNCHES)


def capture_sums(fn):
    """``(fn(), calls)``: ``calls`` holds the ``(values, ids, n)`` of
    each fixed-order sum of the router (``routing_vec.ordered_sum``) that
    ``fn`` made, the shapes the sum kernel takes on that path."""
    from repro_torch.core import routing_vec

    calls = []
    ordered_sum = routing_vec.ordered_sum

    def spy(values, ids, n, backend, plan=None):
        calls.append((values, ids, n))
        return ordered_sum(values, ids, n, backend, plan=plan)

    routing_vec.ordered_sum = spy
    try:
        out = fn()
    finally:
        routing_vec.ordered_sum = ordered_sum
    return out, calls


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int64), b.view(torch.int64))


def run_sweep(backend: str, out: str) -> "tuple[dict, float]":
    from repro_torch.experiments.sweep import run_sweep_suite

    return timed(lambda: run_sweep_suite(
        str(OUT_DIR / out), topo_names=SWEEP_TOPOS,
        scenario_names=SWEEP_SCENARIOS, load_fractions=SWEEP_LOADS,
        simulate=True, sim_backend=backend, device="cuda"))


def phase_sweep() -> dict:
    from repro_torch.core.netsim import make_router
    from repro_torch.core.routing_vec import uniform_demands
    from repro_torch.experiments.scenarios import get_scenario
    from repro_torch.experiments.sweep import (ROUTING_MODES,
                                               SWEEP_TOPOLOGIES,
                                               run_sweep_suite)
    from repro_torch.kernels.segment_fairshare import (LAUNCHES, make_plan,
                                                       reset_launch_counts)

    # a small run first, so that neither timed run pays the first use of
    # torch's own kernels
    run_sweep_suite(str(OUT_DIR / "sweep_warmup"),
                    topo_names=["mphx-2p-8x8"], load_fractions=(1.0,),
                    scenario_names=["hotspot"], simulate=True,
                    device="cuda")
    reset_launch_counts()
    runs = {"cuda": run_sweep("cuda", "sweep_cuda")}
    launches = dict(LAUNCHES)
    runs["torch"] = run_sweep("torch", "sweep_torch")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"sweep launched no {missing} kernel")
    rows = {b: p["rows"] for b, (p, _) in runs.items()}
    if len(rows["cuda"]) != len(rows["torch"]):
        raise AssertionError("the sweep's two runs have other rows")
    skipped = [(r["topology"], r["scenario"]) for r in rows["cuda"]
               if r.get("skipped")]
    if skipped != [(SWEEP_TOPOLOGIES[MAIN_TOPO].name, "transpose")]:
        raise AssertionError(f"unexpected skip records {skipped}")
    routed = [r for r in rows["cuda"] if not r.get("skipped")]
    want = (2 * len(SWEEP_SCENARIOS) - 1) * len(ROUTING_MODES) \
        * len(SWEEP_LOADS)
    if len(routed) != want:
        raise AssertionError(f"{len(routed)} routed rows, not {want}")
    for a, b in zip(rows["cuda"], rows["torch"]):
        compare_rows(a, b, f"{a['topology']}/{a['scenario']}/"
                           f"{a.get('mode')}")
        for k, v in a.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{a['scenario']}: {k} = {v}")
    for backend, (payload, wall) in runs.items():
        cells = {}
        for r in payload["rows"]:
            if not r.get("skipped"):
                cells.setdefault((r["topology"], r["scenario"], r["mode"]),
                                 []).append(r)
        for (topo, scen, mode), rs in cells.items():
            emit("sweep", backend=backend, topology=topo, scenario=scen,
                 mode=mode, max_util=[r["max_util"] for r in rs],
                 fct_p99_us=[r.get("fct_p99_us") for r in rs],
                 sweep_wall_s=rs[0]["sweep_wall_s"])
        emit("sweep", backend=backend, suite_wall_s=wall,
             device_name=payload["params"]["device_name"])
    emit("sweep", launches=launches, rows_agree=True, routed_rows=want,
         ok=True)

    # each (topology, scenario, mode)'s route alone at full injection;
    # adaptive also on the plain path, bit for bit, and on the CPU (every
    # mphx-2p-16x16 scenario and the Table-2 row's uniform), bit for bit
    for tn in SWEEP_TOPOS:
        topo = SWEEP_TOPOLOGIES[tn]
        router = make_router(topo, device="cuda")
        for scen in SWEEP_SCENARIOS:
            sc = get_scenario(scen)
            if not sc.applicable(topo):
                continue
            dem = sc.build(topo, topo.nic_bw_gbps, device="cuda")
            for mode in ROUTING_MODES:
                ll, wall = timed(lambda: router.route(dem, mode))
                line = {"route_wall_s": wall}
                if mode == "adaptive":
                    plain, pwall = timed(lambda: router.route(
                        dem, mode, backend="torch"))
                    if not same_bits(ll.loads, plain.loads):
                        raise AssertionError(f"{tn}/{scen}: adaptive loads "
                                             "differ from the plain path")
                    line.update(plain_route_wall_s=pwall,
                                bits_equal_plain=True)
                if mode == "adaptive" and (tn != MAIN_TOPO
                                           or scen == "uniform"):
                    t0 = time.perf_counter()
                    cpu = make_router(topo, device="cpu").route(
                        sc.build(topo, topo.nic_bw_gbps, device="cpu"),
                        mode)
                    cwall = time.perf_counter() - t0
                    if not same_bits(ll.loads.cpu(), cpu.loads):
                        diff = (ll.loads.cpu() - cpu.loads).abs()
                        raise AssertionError(
                            f"{tn}/{scen}: adaptive loads differ from the "
                            f"CPU's in {int((diff > 0).sum())} slots, "
                            f"max {float(diff.max())}")
                    line.update(cpu_route_wall_s=cwall, bits_equal_cpu=True)
                emit("sweep", topology=tn, scenario=scen, mode=mode,
                     demands=dem.n, max_util=ll.max_utilization(), **line)

    # the Table-2 row, uniform, adaptive: repeatable, its load update's
    # shape held and timed, and the route profiled
    topo = SWEEP_TOPOLOGIES[MAIN_TOPO]
    router = make_router(topo, device="cuda")
    dem = uniform_demands(topo, topo.nic_bw_gbps, device="cuda")
    first, calls = capture_sums(lambda: router.route(dem, "adaptive"))
    again = router.route(dem, "adaptive")
    if not same_bits(first.loads, again.loads):
        raise AssertionError("adaptive: two kernel runs differ")
    # the second round's first sub-batch (the loads no longer 0)
    vals, ids, n = calls[len(calls) // 8]
    kernel_row("segment_sum", f"{MAIN_TOPO} uniform", "adaptive update",
               vals, ids, n, make_plan(ids, n), True)
    emit("sweep", repeat=f"{MAIN_TOPO} uniform adaptive", bits_equal=True,
         sums=len(calls), sum_nnz=[c[0].numel() for c in calls[:8]],
         sum_segments=n)
    del calls, vals, ids
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: router.route(dem, "adaptive"))
    kernels = device_events(prof)
    busy_ms = sum(k[2] for k in kernels) / 1e3
    emit("sweep", profiled=f"{MAIN_TOPO} uniform adaptive route",
         profiled_wall_s=wall, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / (wall * 1e3),
         top_device_ops=[{"name": n[:80], "count": c, "ms": t / 1e3}
                         for n, c, t in kernels[:10]])
    del first, again, dem, router, runs, rows, routed
    torch.cuda.empty_cache()
    return launches


def phase_valiant_sim() -> dict:
    from repro_torch.core.netsim import load_sweep, make_router
    from repro_torch.experiments.scenarios import get_scenario
    from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES
    from repro_torch.kernels.segment_fairshare import (LAUNCHES, make_plan,
                                                       reset_launch_counts)
    from repro_torch.sim.fairshare import SolveProblem, flow_incidence

    topo = SWEEP_TOPOLOGIES[MAIN_TOPO]
    sc = get_scenario(VALIANT_SCENARIO)

    def build(t, offered):
        return sc.build(t, offered, device="cuda")

    case = f"{MAIN_TOPO} {VALIANT_SCENARIO} valiant"
    # the incidence alone: its wall, size and peak memory, and the
    # shapes the kernels take on it
    router = make_router(topo, device="cuda")
    dem = build(topo, VALIANT_LOADS[0] * topo.nic_bw_gbps)
    torch.cuda.reset_peak_memory_stats()
    (inc, calls), wall = timed(lambda: capture_sums(
        lambda: flow_incidence(router, dem, "valiant")))
    emit("valiant_sim", incidence_wall_s=wall, flows=inc.n_flows,
         raw_entries=calls[0][0].numel(), nnz=inc.nnz,
         incidence_peak_bytes=torch.cuda.max_memory_allocated())
    vals, ids, n = calls[0]
    kernel_row("segment_sum", case, "coalescing", vals, ids, n,
               make_plan(ids, n), True)
    del calls, vals, ids
    prob = SolveProblem.build(inc, "cuda")
    kernel_row("segment_sum", case, "edge", inc.frac, prob.edge,
               prob.n_edges, prob.edge_plan, True)
    kernel_row("segment_sum", case, "flow", inc.frac, inc.flow,
               inc.n_flows, prob.flow_plan, False)
    kernel_row("segment_min", case, "flow", inc.capacity[inc.edge]
               / inc.frac, inc.flow, inc.n_flows, prob.flow_plan, False)
    del prob, inc, dem, router
    torch.cuda.empty_cache()

    runs = {}
    for backend in ("cuda", "torch"):
        router = make_router(topo, device="cuda")
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        rows, wall = timed(lambda: load_sweep(
            topo, build, mode="valiant", load_fractions=VALIANT_LOADS,
            router=router, simulate=True, flow_time_s=200e-6,
            sim_backend=backend))
        if backend == "cuda":
            launches = dict(LAUNCHES)
        runs[backend] = rows
        for r in rows:
            emit("valiant_sim", backend=backend,
                 offered_fraction=r["offered_fraction"],
                 max_util=r["max_util"], flows=r["sim_flows"],
                 sim_nnz=r["sim_nnz"], epochs=r["sim_epochs"],
                 waterfill_rounds=r["sim_waterfill_rounds"],
                 fct_p50_us=r["fct_p50_us"], fct_p99_us=r["fct_p99_us"],
                 slowdown_p99=r["slowdown_p99"],
                 delivered=r["sim_delivered_fraction"])
        emit("valiant_sim", backend=backend, wall_s=wall,
             peak_bytes=torch.cuda.max_memory_allocated())
        del router
        torch.cuda.empty_cache()
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"valiant sim launched no {missing} kernel")
    for a, b in zip(runs["cuda"], runs["torch"]):
        compare_rows(a, b, f"valiant/{a['offered_fraction']}")
        for k, v in a.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"valiant: {k} = {v}")
    if len(runs["cuda"]) != len(VALIANT_LOADS):
        raise AssertionError("valiant sim: missing rows")
    emit("valiant_sim", launches=launches, rows_agree=True, ok=True)
    return launches


def graph_suite(kind: str, backend: str, out: str, **kw):
    """``(payload, wall s)`` of one graph-phase suite run on the card."""
    from repro_torch.experiments.simsuite import run_sim_suite
    from repro_torch.experiments.sweep import run_sweep_suite

    run = run_sim_suite if kind == "sim" else run_sweep_suite
    return timed(lambda: run(str(OUT_DIR / out), sim_backend=backend,
                             device="cuda", **kw))


def row_name(r: dict) -> str:
    """A suite row's scenario, or (a measured collective) its collective."""
    return r.get("scenario", r.get("collective"))


def check_rows(got: "list[dict]", want: "list[dict]", where: str) -> int:
    """Row for row (:func:`compare_rows`), every float finite where it is
    not a skip record; returns the count of routed rows."""
    if len(got) != len(want):
        raise AssertionError(f"{where}: {len(got)} rows, not {len(want)}")
    routed = 0
    for a, b in zip(got, want):
        compare_rows(a, b, f"{where} {a['topology']}/{row_name(a)}/"
                           f"{a.get('mode')}")
        if a.get("skipped"):
            continue
        routed += 1
        for k, v in a.items():
            if isinstance(v, float) and not math.isfinite(v) \
                    and k != "latency_us":
                raise AssertionError(f"{where}: {row_name(a)}: {k} = {v}")
    return routed


def phase_graph() -> dict:
    """The graph engine on the card: the sim and sweep suites over the
    Table-2 baselines through the kernels and on the plain path, each
    65K preset's uniform route alone, the small presets against the
    CPU, a profiled route and the kernel lines at the graph's shapes.
    Returns each path's launch counts."""
    from repro_torch.core.netsim import make_router
    from repro_torch.experiments.scenarios import get_scenario
    from repro_torch.experiments.sweep import (ROUTING_MODES,
                                               SWEEP_TOPOLOGIES,
                                               run_sweep_suite)
    from repro_torch.kernels.segment_fairshare import (LAUNCHES,
                                                       reset_launch_counts)
    from repro_torch.sim.fairshare import SolveProblem, flow_incidence

    t_phase = time.perf_counter()

    def emit_graph(**fields):
        emit("graph", phase_s=time.perf_counter() - t_phase, **fields)

    # a small run first, so that no timed run pays the first use of the
    # graph engine's torch kernels
    graph_suite("sim", "cuda", "graph_warmup", topo_names=["dragonfly-small"])
    by_path = {}

    def kernel_then_plain(path, kind, out, plain_kw=None, **kw):
        reset_launch_counts()
        got, wall = graph_suite(kind, "cuda", f"{out}_cuda", **kw)
        by_path[path] = dict(LAUNCHES)
        missing = [k for k, n in by_path[path].items() if n == 0]
        if missing:
            raise AssertionError(f"{path} launched no {missing} kernel")
        plain, pwall = graph_suite(kind, "torch", f"{out}_torch",
                                   **{**kw, **(plain_kw or {})})
        emit_graph(path=path, suite_wall_s=wall, plain_suite_wall_s=pwall,
             launches=by_path[path],
             device_name=got["params"]["device_name"])
        return got, plain

    # --suite sim: its defaults (mphx-2p-8x8, dragonfly-small), then the
    # multi-plane Fat-Tree row at 65,536 NICs, uncut
    for path, topo_names in (("graph sim default", None),
                             (f"graph sim {GRAPH_SIM_TOPO}",
                              [GRAPH_SIM_TOPO])):
        torch.cuda.reset_peak_memory_stats()
        got, plain = kernel_then_plain(path, "sim", path.replace(" ", "_"),
                                       topo_names=topo_names,
                                       scenario_names=MAIN_SCENARIOS,
                                       load_fractions=MAIN_LOADS)
        check_rows(got["rows"], plain["rows"], path)
        if not got["params"]["all_steady_checks_agree_1e-6"]:
            raise AssertionError(f"{path}: steady-state loads diverge")
        for r in got["rows"]:
            if r.get("kind") == "fct":
                emit_graph(path=path, topology=r["topology"],
                     engine=r["engine"], scenario=r["scenario"],
                     offered_fraction=r["offered_fraction"],
                     max_util=r["max_util"], flows=r["sim_flows"],
                     nnz=r["sim_nnz"], epochs=r["sim_epochs"],
                     waterfill_rounds=r["sim_waterfill_rounds"],
                     fct_p50_us=r["fct_p50_us"], fct_p99_us=r["fct_p99_us"],
                     delivered=r["sim_delivered_fraction"],
                     sim_wall_s=r["sim_wall_s"])
        emit_graph(path=path, peak_bytes=torch.cuda.max_memory_allocated())

    # --suite sweep over the small presets: every scenario, three modes,
    # measured FCTs on the minimal rows; then against the CPU's rows
    path = "graph sweep small"
    sweep_kw = dict(topo_names=GRAPH_SMALL, load_fractions=SWEEP_LOADS,
                    simulate=True)
    got, plain = kernel_then_plain(path, "sweep", "graph_sweep_small",
                                   **sweep_kw)
    routed = check_rows(got["rows"], plain["rows"], path)
    cpu, cwall = timed(lambda: run_sweep_suite(
        str(OUT_DIR / "graph_sweep_small_cpu"), sim_backend="torch",
        device="cpu", **sweep_kw))
    check_rows(got["rows"], cpu["rows"], f"{path} vs cpu")
    emit_graph(path=path, routed_rows=routed, rows_agree=True,
         rows_agree_cpu=True, cpu_suite_wall_s=cwall)

    # --suite sweep at 65,536 NICs: uniform and neighbor_shift, three
    # modes, loads 0.5 / 1.0; the plain pass runs uniform alone (reduced)
    path = "graph sweep 65536"
    got, plain = kernel_then_plain(
        path, "sweep", "graph_sweep_65536",
        plain_kw={"scenario_names": GRAPH_PLAIN_BIG_SCENARIOS},
        topo_names=GRAPH_BIG, scenario_names=GRAPH_BIG_SCENARIOS,
        load_fractions=SWEEP_LOADS)
    same = [r for r in got["rows"]
            if r["scenario"] in GRAPH_PLAIN_BIG_SCENARIOS]
    check_rows(same, plain["rows"], path)
    routed = check_rows(got["rows"], got["rows"], path)
    want = len(GRAPH_BIG) * len(GRAPH_BIG_SCENARIOS) * len(ROUTING_MODES) \
        * len(SWEEP_LOADS)
    if routed != want:
        raise AssertionError(f"{path}: {routed} routed rows, not {want}")
    cells = {}
    for r in got["rows"]:
        cells.setdefault((r["topology"], r["scenario"], r["mode"]),
                         []).append(r)
    for (topo, scen, mode), rs in cells.items():
        emit_graph(path=path, topology=topo, scenario=scen, mode=mode,
             max_util=[r["max_util"] for r in rs],
             latency_us=[r["latency_us"] for r in rs],
             sweep_wall_s=rs[0]["sweep_wall_s"])
    emit_graph(path=path, routed_rows=routed, rows_agree=True)

    # each 65K preset's uniform route alone in each mode; adaptive twice
    # (bit for bit) and on the plain path (bit for bit)
    for tn in GRAPH_BIG:
        topo = SWEEP_TOPOLOGIES[tn]
        router, build_s = timed(lambda: make_router(topo, device="cuda"))
        _, hops_s = timed(lambda: router.hops)
        dem = get_scenario("uniform").build(topo, topo.nic_bw_gbps,
                                            graph=router.graph, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        line = {"switches": router.csr.n_switches,
                "edges": router.csr.n_edges, "demands": dem.n,
                "dst_chunk": router.dst_chunk, "router_s": build_s,
                "hops_s": hops_s}
        for mode in ROUTING_MODES:
            reset_launch_counts()
            ll, wall = timed(lambda: router.route(dem, mode))
            line[f"{mode}_wall_s"] = wall
            line[f"{mode}_launches"] = dict(LAUNCHES)
            line[f"{mode}_max_util"] = ll.max_utilization()
        again, wall2 = timed(lambda: router.route(dem, "adaptive"))
        plain, pwall = timed(lambda: router.route(dem, "adaptive",
                                                  backend="torch"))
        if not (same_bits(ll.loads, again.loads)
                and same_bits(ll.loads, plain.loads)):
            raise AssertionError(f"{tn}: adaptive loads differ between "
                                 "runs or from the plain path")
        emit_graph(route=tn, scenario="uniform", adaptive_again_s=wall2,
             adaptive_plain_s=pwall, bits_equal=True, bits_equal_plain=True,
             peak_bytes=torch.cuda.max_memory_allocated(), **line)
        del router, dem, ll, again, plain
        torch.cuda.empty_cache()

    # the dragonfly-65536 uniform adaptive route under the profiler
    topo = SWEEP_TOPOLOGIES[GRAPH_PROFILED]
    router = make_router(topo, device="cuda")
    dem = get_scenario("uniform").build(topo, topo.nic_bw_gbps,
                                        graph=router.graph, device="cuda")
    router.route(dem, "minimal")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: router.route(dem, "adaptive"))
    kernels = device_events(prof)
    busy_ms = sum(k[2] for k in kernels) / 1e3
    emit_graph(profiled=f"{GRAPH_PROFILED} uniform adaptive route",
         profiled_wall_s=wall, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / (wall * 1e3),
         top_device_ops=[{"name": n[:80], "count": c, "ms": t / 1e3}
                         for n, c, t in kernels[:10]])
    del router, dem, prof
    torch.cuda.empty_cache()

    # #1 and #2 at the graph's shapes: the pull's row scatter, the ECMP
    # denominators and the bottleneck max of ft3-65536's first chunk
    topo = SWEEP_TOPOLOGIES[GRAPH_KERNEL_TOPO]
    router = make_router(topo, device="cuda")
    S, E, C = router.csr.n_switches, router.csr.n_edges, router.dst_chunk
    dests = torch.nonzero(router.csr.nic_counts).squeeze(1)[:C]
    ll = router.route(get_scenario("uniform").build(
        topo, topo.nic_bw_gbps, graph=router.graph, device="cuda"),
        "minimal")
    inject = torch.zeros((S, C), dtype=torch.float64, device="cuda")
    inject[torch.nonzero(router.csr.nic_counts).squeeze(1)] = 1.0
    contribs = []

    def keep(contrib):
        contribs.append(contrib)
        return contrib

    _, calls = capture_sums(lambda: [keep(c) for c in router._pull(
        dests, inject, "cuda", router._levels(dests.tolist()))])
    case = f"{GRAPH_KERNEL_TOPO} uniform, {C} destinations"
    dst_ids, dst_plan = router._block("dst", C)
    src_ids, src_plan = router._block("src", C)
    pull = next(c for c in calls if c[1] is dst_ids)
    denom = next(c for c in calls if c[1] is src_ids)
    results = {"pull": kernel_row("segment_sum", case, "pull (dst rows)",
                                  pull[0], dst_ids, S * C, dst_plan, True),
               "denom": kernel_row("segment_sum", case, "ECMP denominators",
                                   denom[0], src_ids, S * C, src_plan,
                                   True)}
    dist_to, frac = router._downhill(dests, "cuda")
    util = ll.utilization_array()
    cand = torch.where(frac > 0, util[:, None].expand(E, C), -torch.inf)
    results["bottleneck"] = kernel_row(
        "segment_min", case, "bottleneck max (as -min(-x))",
        (-cand).reshape(-1), src_ids, S * C, src_plan, True)
    del router, ll, inject, contribs, calls, pull, denom, dist_to, frac, cand
    torch.cuda.empty_cache()

    # mpft-8p-65536's water-filling shapes: the uniform incidence
    topo = SWEEP_TOPOLOGIES[GRAPH_SIM_TOPO]
    router = make_router(topo, device="cuda")
    dem = get_scenario("uniform").build(topo, topo.nic_bw_gbps,
                                        graph=router.graph, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    inc, wall = timed(lambda: flow_incidence(router, dem))
    emit_graph(incidence=f"{GRAPH_SIM_TOPO} uniform", wall_s=wall,
         flows=inc.n_flows, nnz=inc.nnz,
         peak_bytes=torch.cuda.max_memory_allocated())
    prob = SolveProblem.build(inc, "cuda")
    case = f"{GRAPH_SIM_TOPO} uniform"
    kernel_row("segment_sum", case, "edge", inc.frac, prob.edge,
               prob.n_edges, prob.edge_plan, True)
    kernel_row("segment_sum", case, "flow", inc.frac, inc.flow, inc.n_flows,
               prob.flow_plan, False)
    kernel_row("segment_min", case, "flow", inc.capacity[inc.edge]
               / inc.frac, inc.flow, inc.n_flows, prob.flow_plan, False)
    del prob, inc, dem, router
    torch.cuda.empty_cache()
    emit_graph(launches=by_path, ok=True)
    return by_path


def compare_traces(a: dict, b: dict, where: str) -> dict:
    """Two exported traces of one run (kernels against plain, or against
    the CPU): the same ``(ph, name)`` events in the same order; counter
    samples with the same series (edge ids, active-flow labels), active
    counts exact and utilizations within 1e-9; clocks within 1e-9 of the
    longest simulated time."""
    ea, eb = a["traceEvents"], b["traceEvents"]
    if [(e["ph"], e["name"]) for e in ea] != \
            [(e["ph"], e["name"]) for e in eb]:
        raise AssertionError(f"{where}: the event sequences differ")
    scale = max([e["ts"] + e.get("dur", 0.0) for e in ea if "ts" in e]
                + [1e-30])
    t_err = util_err = 0.0
    for x, y in zip(ea, eb):
        if x["ph"] == "M":
            if x != y:
                raise AssertionError(f"{where}: track {x} != {y}")
            continue
        for key in ("ts", "dur"):
            if key in x:
                t_err = max(t_err, abs(x[key] - y[key]))
        if x["ph"] != "C":
            continue
        if list(x["args"]) != list(y["args"]):
            raise AssertionError(f"{where}: {x['name']} series differ")
        for k, v in x["args"].items():
            if x["name"] == "active_flows":
                if v != y["args"][k]:
                    raise AssertionError(f"{where}: active {v} != "
                                         f"{y['args'][k]}")
            else:
                util_err = max(util_err, abs(v - y["args"][k]))
    if t_err > 1e-9 * scale or util_err > 1e-9:
        raise AssertionError(f"{where}: clock err {t_err} (scale {scale}), "
                             f"util err {util_err}")
    return {"events": len(ea), "clock_max_abs_err_us": t_err,
            "util_max_abs_err": util_err}


def compare_journals(a: dict, b: dict, makespan: float,
                     where: str) -> dict:
    """Two journals of one simulation at the CPU tests' tolerances."""
    for key in ("edge_ids", "active_flows", "dropped_epochs"):
        if a[key] != b[key]:
            raise AssertionError(f"{where}: journal {key} differ")
    t_err = max([abs(x - y) for k in ("t_s", "dt_s")
                 for x, y in zip(a[k], b[k])] + [0.0])
    u = np.abs(np.asarray(a["util"]) - np.asarray(b["util"]))
    u_err = float(u.max()) if u.size else 0.0
    if len(a["t_s"]) != len(b["t_s"]) or t_err > 1e-9 * makespan \
            or u_err > 1e-9:
        raise AssertionError(f"{where}: journal t/dt err {t_err}, util err "
                             f"{u_err}")
    return {"rows": len(a["t_s"]), "t_max_abs_err": t_err,
            "util_max_abs_err": u_err}


def d2h_copies(prof) -> int:
    """Device-to-host copies the profiler saw on the device."""
    return sum(c for name, c, _ in device_events(prof) if "DtoH" in name)


def sim_scale_case(topo_name: str, device):
    """``results/BENCH_sim_scale.json``'s workload on one preset:
    neighbor_shift at 0.9 of NIC bandwidth, minimal routing, sizes
    ``U(0.2, 1) * 16 MiB`` and starts ``U(0, 200 us)`` from
    ``default_rng(7)``: ``(incidence, sizes, caps, starts)``."""
    from repro_torch.core.netsim import make_router
    from repro_torch.core.routing_vec import neighbor_shift_demands
    from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES
    from repro_torch.sim.fairshare import flow_incidence

    topo = SWEEP_TOPOLOGIES[topo_name]
    dem = neighbor_shift_demands(topo, SIM_SCALE_LOAD * topo.nic_bw_gbps,
                                 device=device)
    inc = flow_incidence(make_router(topo, device=device), dem)
    rng = np.random.default_rng(SIM_SCALE_SEED)
    size = rng.uniform(0.2, 1.0, inc.n_flows) * SIM_SCALE_SIZE_MAX
    start = rng.uniform(0.0, SIM_SCALE_WINDOW_S, inc.n_flows)
    return inc, size, dem.gbps, start


def sim_scale_runner(inc, size, caps, start):
    """``sim(backend, rec=None, buffered=False)``: one timed simulation
    of a ``sim_scale_case`` on the card, under ``rec`` where one is
    given, with the buffered journal where ``buffered``."""
    from repro_torch.sim import events
    from repro_torch.sim.events import simulate_incidence
    from repro_torch.telemetry import recording

    journal, buffered_cls = events._Journal, buffered_journal()

    def run(backend):
        return simulate_incidence(inc, size, caps, start_s=start,
                                  backend=backend, device="cuda")

    def sim(backend, rec=None, buffered=False):
        if rec is None:
            return timed(lambda: run(backend))
        events._Journal = buffered_cls if buffered else journal
        try:
            with recording(rec):
                return timed(lambda: run(backend))
        finally:
            events._Journal = journal
    return sim


def buffered_journal():
    """The epoch journal that buffers the selected entries' rates of up
    to 64 MiB of epochs (an ``index_select`` an epoch) and sums a full
    buffer, and the rest at the end, in one segment sum over (epoch,
    edge) segments: the design timed against the journal's sum an epoch,
    in the many-epoch cell's turns."""
    from repro_torch.kernels.segment_fairshare import make_plan
    from repro_torch.sim import events
    from repro_torch.sim.fairshare import _seg_sum

    class BufferedJournal(events._Journal):
        def __init__(self, inc, sel, max_epochs, backend):
            super().__init__(inc, sel, max_epochs, backend)
            nnz = int(self.flow.shape[0])
            chunk = min(self.clock.shape[0],
                        max(1, (64 << 20) // (8 * max(nnz, 1))))
            self.rates = torch.empty((chunk, nnz), dtype=torch.float64,
                                     device=self.clock.device)
            self.summed = 0

        def write(self, t, dt, act, rates):
            n = self.n_epochs
            self.n_epochs += 1
            if n >= self.clock.shape[0]:
                return
            row = self.clock[n]
            torch.stack((t, dt), out=row[:2])
            torch.sum(act, 0, dtype=torch.float64, out=row[2])
            if self.K:
                torch.index_select(rates, 0, self.flow,
                                   out=self.rates[n - self.summed])
                if n + 1 - self.summed == self.rates.shape[0]:
                    self.flush()

        def flush(self):
            m = min(self.n_epochs, self.clock.shape[0]) - self.summed
            if m <= 0 or not self.K:
                return
            values = (self.rates[:m] * self.frac).reshape(-1)
            ids = (torch.arange(m, device=values.device)[:, None] * self.K
                   + self.ids).reshape(-1)
            plan = make_plan(ids, m * self.K) \
                if self.backend == "cuda" else None
            loads = _seg_sum(values, ids, m * self.K, self.backend, plan)
            torch.div(loads.view(m, self.K), self.cap,
                      out=self.util[self.summed:self.summed + m])
            self.summed += m

        def record(self, recorder):
            self.flush()
            super().record(recorder)

    return BufferedJournal


def host_syncs(fn) -> int:
    """Synchronizing CUDA calls in ``fn()`` (device-to-host reads, copies
    from pageable host memory, ``nonzero``), counted by torch's sync
    debug mode, which warns at each one and drops none."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


def count_copies() -> dict:
    """Device-to-host copies by the profiler, without and with the
    recorder (turns off, on, on, off at the golden staggered trace; off,
    on at the many-epoch cell), through the kernels, and each run's
    synchronizing calls (``host_syncs``, one run a side): ``{cell:
    {"epochs": n, "off": [...], "on": [...], "syncs_off": s,
    "syncs_on": s}}``.  Run in a process of its own (``chip_smoke.py
    --count-copies``)."""
    from repro_torch.core.netsim import make_router
    from repro_torch.core.routing_vec import neighbor_shift_demands
    from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES
    from repro_torch.sim.fairshare import flow_incidence
    from repro_torch.telemetry import TraceRecorder

    golden = json.loads(GOLDEN.read_text())["staggered"]
    t = SWEEP_TOPOLOGIES["mphx-2p-8x8"]
    cases = {"golden": (flow_incidence(
        make_router(t, device="cuda"),
        neighbor_shift_demands(t, 800.0, device="cuda")),
        golden["size_bytes"], golden["rate_caps_gbps"], golden["start_s"]),
        "many_epoch": sim_scale_case(MAIN_TOPO, "cuda")}
    out = {}
    for cell, case in cases.items():
        sim = sim_scale_runner(*case)
        sim("cuda")
        res, _ = sim("cuda", TraceRecorder())
        out[cell] = {"epochs": res.n_epochs, "off": [], "on": []}
        # a profiled run of the many-epoch cell takes ~9 s: one a side
        for turn in ("off", "on", "on", "off")[:4 if cell == "golden"
                                               else 2]:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                sim("cuda", TraceRecorder() if turn == "on" else None)
            out[cell][turn].append(d2h_copies(prof))
        for turn in ("off", "on"):
            out[cell][f"syncs_{turn}"] = host_syncs(lambda: sim(
                "cuda", TraceRecorder() if turn == "on" else None))
    return out


def phase_table2_trace() -> dict:
    """``--suite table2`` and the routed Table-2 closed forms on the card,
    then the fabric flight recorder: ``--suite sim --trace``, the golden
    staggered journal, the many-epoch cell with and without the recorder
    and the bounded series.  Returns each path's launch counts."""
    from repro_torch.core.hyperx import table2_mphx_rows
    from repro_torch.core.netsim import (adversarial_throughput_fraction,
                                         make_router, pattern_throughput)
    from repro_torch.core.routing_vec import (neighbor_shift_demands,
                                              uniform_demands)
    from repro_torch.experiments import run_table2_suite
    from repro_torch.experiments.run import main as cli
    from repro_torch.experiments.sweep import (ROUTING_MODES,
                                               SWEEP_TOPOLOGIES)
    from repro_torch.sim.fairshare import flow_incidence
    from repro_torch.kernels.segment_fairshare import (LAUNCHES,
                                                       reset_launch_counts)
    from repro_torch.sim.events import simulate_incidence
    from repro_torch.telemetry import (LinkSeriesPolicy, TraceRecorder,
                                       recording, validate_trace)

    t_phase = time.perf_counter()
    by_path = {}

    def emit_t2(**fields):
        emit("table2_trace", phase_s=time.perf_counter() - t_phase, **fields)

    # --suite table2 through the CLI, traced: the host's rows, every
    # cost the paper's, and the untraced note
    out = OUT_DIR / "table2"
    trace_path = OUT_DIR / "table2_trace.json"
    rc, wall = timed(lambda: cli(["--suite", "table2", "--out", str(out),
                                  "--trace", str(trace_path)]))
    if rc != 0:
        raise AssertionError(f"--suite table2 exited {rc}")
    disk = json.loads((out / "table2.json").read_text())
    host = run_table2_suite(str(OUT_DIR / "table2_host"))
    if disk["rows"] != json.loads(json.dumps(host["rows"])):
        raise AssertionError("table2: the CLI's rows differ from the host's")
    if not all(r.get("cost_matches_paper") for r in disk["rows"]):
        raise AssertionError("table2: a cost differs from the paper's")
    trace = json.loads(trace_path.read_text())
    if validate_trace(trace) != [] or [n["name"] for n in
                                       trace["otherData"]["skipped"]] \
            != ["table2"]:
        raise AssertionError("table2: no untraced note in its trace")
    for r in disk["rows"]:
        emit_t2(suite="table2", topology=r["topology"], N=r["N"],
                N_s=r["N_s"], N_o=r["N_o"],
                cost_per_nic_usd=r["cost_per_nic_usd"],
                paper_cost_per_nic_usd=r["paper_cost_per_nic_usd"],
                diameter=r["diameter"],
                zero_load_latency_us=r["zero_load_latency_us"],
                uniform_throughput=r["uniform_throughput"],
                allreduce_256MB_ms=r["allreduce_256MB_ms"],
                allreduce_algo=r["allreduce_algo"])
    emit_t2(suite="table2", wall_s=wall, rows=len(disk["rows"]),
            rows_equal_host=True, untraced_note=True)

    # the adversarial (neighbor-shift) throughput of Table 2's MPHX rows,
    # routed through the kernels, then on the plain path; a small fabric
    # first, so that no timed route pays the first use of torch's kernels
    for mode in ROUTING_MODES:
        for backend in ("cuda", "torch"):
            adversarial_throughput_fraction(
                SWEEP_TOPOLOGIES["mphx-2p-8x8"], mode, backend=backend,
                device="cuda")
    reset_launch_counts()
    results = {}
    for topo in table2_mphx_rows():
        for mode in ROUTING_MODES:
            results[topo.name, mode] = timed(
                lambda: adversarial_throughput_fraction(
                    topo, mode, backend="cuda", device="cuda"))
    launched(by_path, "table2 adversarial", ("segment_sum",))
    for topo in table2_mphx_rows():
        for mode in ROUTING_MODES:
            got, wall = results[topo.name, mode]
            want, pwall = timed(lambda: adversarial_throughput_fraction(
                topo, mode, backend="torch", device="cuda"))
            ok = got == want if mode == "adaptive" \
                else abs(got - want) <= 1e-12 * abs(want)
            if not ok:
                raise AssertionError(f"adversarial {topo.name}/{mode}: "
                                     f"{got} != {want}")
            emit_t2(adversarial=topo.name, mode=mode, throughput=got,
                    plain_throughput=want, route_wall_s=wall,
                    plain_route_wall_s=pwall, bits_equal=got == want)

    # pattern_throughput with the simulator's load cross-check, at the
    # Table-2 row mphx-4p-86x9 under uniform traffic
    topo = SWEEP_TOPOLOGIES[MAIN_TOPO]
    dem = uniform_demands(topo, topo.nic_bw_gbps, device="cuda")
    reset_launch_counts()
    got, wall = timed(lambda: pattern_throughput(
        topo, dem, "minimal", simulate=True, backend="cuda", device="cuda"))
    launched(by_path, "table2 pattern_throughput", ("segment_sum",))
    want, pwall = timed(lambda: pattern_throughput(
        topo, dem, "minimal", simulate=True, backend="torch",
        device="cuda"))
    if got["sim_max_abs_util_diff"] > 1e-6:
        raise AssertionError(f"pattern_throughput: util diff "
                             f"{got['sim_max_abs_util_diff']}")
    compare_rows(got, want, "pattern_throughput",
                 UNCOMPARED_KEYS + ("sim_max_abs_util_diff",))
    emit_t2(pattern_throughput=f"{MAIN_TOPO} uniform minimal", **got,
            wall_s=wall, plain_wall_s=pwall, plain_rows_agree=True)
    del dem
    torch.cuda.empty_cache()

    # --suite sim --trace at its defaults: kernels, plain, and the CPU
    traces = {}
    for name, dev, backend in (("cuda", "cuda", "cuda"),
                               ("torch", "cuda", "torch"),
                               ("cpu", "cpu", "torch")):
        path = OUT_DIR / f"sim_trace_{name}.json"
        reset_launch_counts()
        rc, wall = timed(lambda: cli(["--suite", "sim", "--device", dev,
                                      "--sim-backend", backend, "--out",
                                      str(OUT_DIR / f"sim_trace_{name}"),
                                      "--trace", str(path)]))
        if name == "cuda":
            launched(by_path, "sim default --trace")
        traces[name] = json.loads(path.read_text())
        art = json.loads((OUT_DIR / f"sim_trace_{name}" / "sim.json")
                         .read_text())
        if rc != 0 or validate_trace(traces[name]) != [] \
                or "telemetry" not in art or traces[name]["otherData"][
                    "skipped"]:
            raise AssertionError(f"sim --trace ({name}): rc {rc}, or an "
                                 "invalid trace, or no telemetry block")
        emit_t2(suite="sim --trace", run=name, wall_s=wall,
                events=len(traces[name]["traceEvents"]),
                telemetry_counters=art["telemetry"]["counters"])
    for other in ("torch", "cpu"):
        emit_t2(suite="sim --trace", compared=f"cuda vs {other}",
                **compare_traces(traces["cuda"], traces[other],
                                 f"sim --trace cuda vs {other}"), ok=True)

    # the golden staggered trace journaled on the card against the CPU
    golden = json.loads(GOLDEN.read_text())["staggered"]
    journals = {}
    for dev in ("cuda", "cpu"):
        t = SWEEP_TOPOLOGIES["mphx-2p-8x8"]
        inc = flow_incidence(make_router(t, device=dev),
                             neighbor_shift_demands(t, 800.0, device=dev))
        rec = TraceRecorder()
        with recording(rec):
            res = simulate_incidence(
                inc, golden["size_bytes"], golden["rate_caps_gbps"],
                start_s=golden["start_s"], backend="cuda", device=dev)
        journals[dev] = rec.journals[0]
        if res.n_epochs != golden["n_epochs"] or \
                len(journals[dev]["t_s"]) != golden["n_epochs"]:
            raise AssertionError(f"golden journal ({dev}): "
                                 f"{len(journals[dev]['t_s'])} rows")
    emit_t2(golden_journal="staggered mphx-2p-8x8/neighbor_shift",
            **compare_journals(journals["cuda"], journals["cpu"],
                               golden["makespan_s"], "golden journal"),
            ok=True)

    # the many-epoch cell: BENCH_sim_scale.json's mphx-4p-86x9 workload,
    # its wall without the recorder ("off"), with it ("on") and, through
    # the kernels, with the buffered journal ("buffered"), one run each
    # (cut from turns forth and back for time); the overheads from them
    inc, size, caps, start = sim_scale_case(MAIN_TOPO, "cuda")
    cell = {"topology": MAIN_TOPO, "flows": inc.n_flows, "nnz": inc.nnz}
    sim = sim_scale_runner(inc, size, caps, start)
    sim("cuda")
    sim("torch")
    sim("cuda", TraceRecorder(), buffered=True)
    for backend in ("cuda", "torch"):
        turns = ("off", "on", "buffered") if backend == "cuda" \
            else ("off", "on")
        walls = {turn: [] for turn in turns}
        for turn in turns:
            rec = TraceRecorder() if turn != "off" else None
            reset_launch_counts()
            res, wall = sim(backend, rec, buffered=turn == "buffered")
            walls[turn].append(wall)
            if len(walls[turn]) == 1:
                first = (res, dict(LAUNCHES), rec and rec.journals[0])
                if turn == "off":
                    plain_res, launches_off, _ = first
                elif turn == "on":
                    rec_res, launches_on, journal = first
                else:
                    buf_res, launches_buf, buf_journal = first
        if backend == "cuda":
            # the event loop alone: water-filling and the journal sum
            launched(by_path, f"many-epoch sim {MAIN_TOPO} traced",
                     ("segment_sum",), counts=launches_on)
            kernel_journal, kernel_makespan = journal, rec_res.makespan_s
            compare_journals(journal, buf_journal, kernel_makespan,
                             "many-epoch journal, a sum an epoch vs "
                             "buffered")
            for name in ("finish_s", "edge_bytes", "fct_s"):
                if not same_bits(getattr(buf_res, name),
                                 getattr(plain_res, name)):
                    raise AssertionError(f"many-epoch: the buffered "
                                         f"journal moved {name}")
        else:
            compare_journals(kernel_journal, journal, kernel_makespan,
                             "many-epoch journal, kernels vs plain")
        for name in ("finish_s", "edge_bytes", "fct_s"):
            if not same_bits(getattr(rec_res, name),
                             getattr(plain_res, name)):
                raise AssertionError(f"many-epoch ({backend}): recording "
                                     f"moved {name}")
        if rec_res.n_epochs != SIM_SCALE_EPOCHS:
            raise AssertionError(f"many-epoch: {rec_res.n_epochs} epochs, "
                                 f"the reference's {SIM_SCALE_EPOCHS}")
        # the kernel path: the selection's sum and one a journaled epoch
        extra = launches_on["segment_sum"] - launches_off["segment_sum"]
        rows = len(journal["t_s"])
        if extra != (1 + rows if backend == "cuda" else 0):
            raise AssertionError(f"many-epoch ({backend}): {extra} extra "
                                 f"sum launches for {rows} rows")
        med = {turn: statistics.median(w) for turn, w in walls.items()}
        arms = {}
        if backend == "cuda":
            # the buffer's gain: how much above the buffered journal's
            # median wall the sum an epoch's is
            arms = {"wall_buffered_s": walls["buffered"],
                    "buffered_overhead": med["buffered"] / med["off"] - 1,
                    "buffered_extra_sum_launches":
                        launches_buf["segment_sum"]
                        - launches_off["segment_sum"],
                    "buffer_gain": med["on"] / med["buffered"] - 1}
        emit_t2(many_epoch=backend, **cell, epochs=rec_res.n_epochs,
                reference_epochs=SIM_SCALE_EPOCHS,
                waterfill_rounds=rec_res.waterfill_rounds,
                journal_rows=rows, edge_ids=journal["edge_ids"],
                wall_off_s=walls["off"], wall_on_s=walls["on"],
                journal_overhead=med["on"] / med["off"] - 1,
                off_spread=(max(walls["off"]) - min(walls["off"]))
                / med["off"], **arms,
                launches_off=launches_off, launches_on=launches_on,
                extra_sum_launches=extra, outputs_bits_equal=True)
    del inc, sim
    torch.cuda.empty_cache()

    # the device->host copies with and without the recorder, by the
    # profiler in a fresh process (late in a long one it drops records)
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--count-copies"], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"--count-copies exited {proc.returncode}:\n"
                             f"{proc.stdout}{proc.stderr}")
    copies = json.loads(proc.stdout.strip().splitlines()[-1])
    # the recorder's copies at most (the largest session with it less the
    # smallest without) and its synchronizing calls at the golden trace's
    # 127 epochs and the cell's 1,547: one an epoch would add 1,420 more
    # at the cell
    added = {cell: max(c["on"]) - min(c["off"]) for cell, c in copies.items()}
    syncs = {cell: c["syncs_on"] - c["syncs_off"]
             for cell, c in copies.items()}
    growth = added["many_epoch"] - added["golden"]
    sync_growth = syncs["many_epoch"] - syncs["golden"]
    more_epochs = copies["many_epoch"]["epochs"] - copies["golden"]["epochs"]
    if max(growth, sync_growth) >= more_epochs // 10:
        raise AssertionError(f"the recorder adds {added} copies and "
                             f"{syncs} synchronizing calls: they grow with "
                             "the epochs")
    emit_t2(d2h_copies=copies, added_at_most=added, growth=growth,
            added_syncs=syncs, sync_growth=sync_growth)

    # the reference's bounded series at mphx-8p-256: 64 rows, 32 spans
    inc, size, caps, start = sim_scale_case(BOUNDED_TOPO, "cuda")
    rec = TraceRecorder(LinkSeriesPolicy(top_k=8, reservoir=4,
                                         max_epochs=64), max_flow_events=32)
    reset_launch_counts()
    with recording(rec):
        res, wall = timed(lambda: simulate_incidence(
            inc, size, caps, start_s=start, backend="cuda", device="cuda"))
    launched(by_path, f"bounded series {BOUNDED_TOPO}", ("segment_sum",))
    j = rec.journals[0]
    if not (res.n_epochs > 64 and len(j["t_s"]) == 64
            and j["dropped_epochs"] == res.n_epochs - 64
            and rec.metrics.value("trace.dropped_epochs") == res.n_epochs - 64
            and rec.metrics.value("trace.dropped_flow_events")
            == inc.n_flows - 32 and len(j["edge_ids"]) <= 12
            and validate_trace(rec.to_json()) == []):
        raise AssertionError(f"bounded series: {res.n_epochs} epochs, "
                             f"{len(j['t_s'])} rows, "
                             f"{j['dropped_epochs']} dropped")
    emit_t2(bounded=BOUNDED_TOPO, flows=inc.n_flows, epochs=res.n_epochs,
            rows=64, dropped_epochs=j["dropped_epochs"],
            dropped_flow_events=rec.metrics.value(
                "trace.dropped_flow_events"), wall_s=wall)
    del inc
    torch.cuda.empty_cache()
    emit_t2(launches=by_path, ok=True)
    return by_path


def spray_flows(topo_name: str) -> list:
    """``sim_scale_case``'s workload as flows: the neighbor_shift pairs
    with its sizes and starts (the same ``default_rng(7)`` draws)."""
    from repro_torch.core.routing_vec import neighbor_shift_demands
    from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES
    from repro_torch.sim.events import FlowSpec

    topo = SWEEP_TOPOLOGIES[topo_name]
    dem = neighbor_shift_demands(topo, SIM_SCALE_LOAD * topo.nic_bw_gbps,
                                 device="cpu")
    rng = np.random.default_rng(SIM_SCALE_SEED)
    size = rng.uniform(0.2, 1.0, dem.n) * SIM_SCALE_SIZE_MAX
    start = rng.uniform(0.0, SIM_SCALE_WINDOW_S, dem.n)
    return [FlowSpec(s, d, float(b), float(t)) for s, d, b, t in
            zip(dem.src.tolist(), dem.dst.tolist(), size, start)]


def count_plans(fn):
    """``(fn(), plans)``: ``plans`` holds the ``(entries, segments)`` of
    each segment plan built while ``fn`` ran (``make_plan``, wherever the
    port imported it)."""
    from repro_torch.kernels.segment_fairshare import ops

    make_plan, plans = ops.make_plan, []

    def spy(ids, n, **kw):
        plans.append((ids.numel(), n))
        return make_plan(ids, n, **kw)

    owners = [m for m in list(sys.modules.values())
              if getattr(m, "make_plan", None) is make_plan]
    for m in owners:
        m.make_plan = spy
    try:
        out = fn()
    finally:
        for m in owners:
            m.make_plan = make_plan
    return out, plans


def same_spray(a, b, where: str) -> dict:
    """Two sprayed results of one run: per-plane bytes and stalls bit for
    bit, completions within 1e-9 relative (inf where the other is),
    makespans within 1e-9 relative."""
    if not (same_bits(a.per_plane_bytes.cpu(), b.per_plane_bytes.cpu())
            and torch.equal(a.stalled.cpu(), b.stalled.cpu())):
        raise AssertionError(f"{where}: per-plane bytes or stalls differ")
    x, y = a.completion_s.cpu().numpy(), b.completion_s.cpu().numpy()
    fin = np.isfinite(y)
    if not (np.array_equal(np.isfinite(x), fin)
            and np.array_equal(x[~fin], y[~fin])):
        raise AssertionError(f"{where}: stalled completions differ")
    err = float((np.abs(x[fin] - y[fin]) / np.abs(y[fin])).max()) \
        if fin.any() else 0.0
    span = abs(a.makespan_s - b.makespan_s)
    if err > 1e-9 or span > 1e-9 * b.makespan_s:
        raise AssertionError(f"{where}: completion rel err {err}, "
                             f"makespan err {span}")
    return {"completion_max_rel_err": err, "makespan_abs_err": span}


def phase_spray() -> dict:
    """Multi-plane spraying on the card: the many-epoch cell's workload
    sprayed over mphx-4p-86x9's 4 planes in three variants, then
    ``--suite sim``'s measured collectives at its defaults and at
    mphx-2p-16x16, each through the kernels, on the plain path and on
    the CPU.  Returns each path's launch counts."""
    from repro_torch.core.planes import SprayConfig
    from repro_torch.experiments.run import main as cli
    from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES
    from repro_torch.kernels.segment_fairshare import (LAUNCHES,
                                                       reset_launch_counts)
    from repro_torch.sim.events import FlowSpec
    from repro_torch.sim.spray import flowlet_split, simulate_sprayed
    from repro_torch.telemetry import collecting

    t_phase = time.perf_counter()
    by_path = {}

    def emit_spray(**fields):
        emit("spray", phase_s=time.perf_counter() - t_phase, **fields)

    # the sprayed many-epoch cell: a small run first, so that no timed
    # run pays the first use of torch's kernels
    topo = SWEEP_TOPOLOGIES[MAIN_TOPO]
    flows = spray_flows(MAIN_TOPO)
    cfg = SprayConfig(n_planes=topo.n_planes)
    small = [FlowSpec(s, (s + 9) % 64, 1e6 * (s + 1)) for s in range(16)]
    for backend in ("cuda", "torch"):
        simulate_sprayed(SWEEP_TOPOLOGIES["mphx-2p-8x8"], small, cfg=cfg,
                         backend=backend, device="cuda",
                         **SPRAY_VARIANTS["c flowlet dead"])
    for variant, kw in SPRAY_VARIANTS.items():
        results = {}
        for run, dev, backend in SPRAY_RUNS:
            reset_launch_counts()
            with collecting() as mx:
                (res, wall), plans = count_plans(lambda: timed(
                    lambda: simulate_sprayed(topo, flows, cfg=cfg,
                                             backend=backend, device=dev,
                                             **kw)))
            path = f"spray {MAIN_TOPO} {variant}"
            if run == "cuda":
                # a sprayed run needs no bottleneck: sums alone
                launched(by_path, path, ("segment_sum",))
            counters = mx.snapshot()["counters"]
            flowlet = kw["granularity"] == "flowlet"
            # plans once a run, whatever the planes: the incidence's edge
            # column, its flow column for the kernels, and on the card its
            # coalescing and the flowlet bins
            on_card = dev == "cuda"
            want_plans = 1 + (backend == "cuda") + on_card \
                + (flowlet and on_card)
            if len(plans) != want_plans:
                raise AssertionError(f"{path} ({run}): {len(plans)} plans "
                                     f"{plans}, not {want_plans}")
            results[run] = res, counters
            n_sims = counters["spray.plane_sims"]
            emit_spray(variant=variant, run=run, topology=MAIN_TOPO,
                       flows=len(flows), planes=cfg.n_planes,
                       plane_sims=n_sims, wall_s=wall,
                       epochs=counters["sim.epochs"],
                       epochs_per_plane=counters["sim.epochs"] / n_sims,
                       launches=dict(LAUNCHES) if dev == "cuda" else None,
                       make_plan_calls=len(plans), plans=plans,
                       makespan_s=res.makespan_s,
                       spray_counters={k: v for k, v in counters.items()
                                       if k.startswith("spray.")},
                       device_name=torch.cuda.get_device_name(0)
                       if dev == "cuda" else "cpu")
        res, counters = results["cuda"]
        line = {}
        for other in ("torch", "cpu"):
            line[other] = same_spray(res, results[other][0],
                                     f"spray {variant}: cuda vs {other}")
            if results[other][1] != counters:
                raise AssertionError(f"spray {variant}: counters differ "
                                     f"from {other}'s")
        if kw["granularity"] == "flowlet":
            # the flowlet split alone: counts and bytes bit for bit
            sizes = torch.tensor([f.size_bytes for f in flows],
                                 dtype=torch.float64)
            alive = [not math.isinf(s) for s in kw["plane_skew"]]
            split = {run: flowlet_split(
                sizes.to(dev), cfg.n_planes, kw["flowlet_bytes"],
                seed=kw["flowlet_seed"], alive=alive, backend=backend)
                for run, dev, backend in SPRAY_RUNS}
            for other in ("torch", "cpu"):
                if not (same_bits(split["cuda"][0].cpu(),
                                  split[other][0].cpu())
                        and torch.equal(split["cuda"][1].cpu(),
                                        split[other][1].cpu())):
                    raise AssertionError(f"flowlet split: cuda vs {other}")
            line["flowlets"] = int(split["cuda"][1].sum())
        emit_spray(variant=variant, compared=line, counters_equal=True,
                   ok=True)
        del results, res
    torch.cuda.empty_cache()

    # --suite sim through the CLI: its defaults, then the largest fabric
    # it measures collectives on; kernels, plain on the card, the CPU
    for path, args in (("sim default collectives", []),
                       (f"sim {COLLECTIVE_TOPO} collectives",
                        ["--topos", COLLECTIVE_TOPO, "--scenarios",
                         "uniform"])):
        runs = {}
        for run, dev, backend in SPRAY_RUNS:
            out = OUT_DIR / f"{path.replace(' ', '_')}_{run}"
            reset_launch_counts()
            rc, wall = timed(lambda: cli(["--suite", "sim", *args,
                                          "--device", dev, "--sim-backend",
                                          backend, "--out", str(out)]))
            if rc != 0:
                raise AssertionError(f"{path} ({run}): exit {rc}")
            if run == "cuda":
                launched(by_path, path)
            runs[run] = json.loads((out / "sim.json").read_text())
            emit_spray(path=path, run=run, suite_wall_s=wall,
                       device_name=runs[run]["params"]["device_name"])
        rows = runs["cuda"]["rows"]
        colls = [r for r in rows if r.get("kind") == "collective"]
        want = 3 * len(runs["cuda"]["params"]["topologies"])
        if len(colls) != want or any(r.get("skipped") for r in rows):
            raise AssertionError(f"{path}: {len(colls)} collective rows, "
                                 f"not {want}, or a skip record")
        for other in ("torch", "cpu"):
            check_rows(rows, runs[other]["rows"], f"{path} cuda vs {other}")
        for r in colls:
            emit_spray(path=path, topology=r["topology"],
                       collective=r["collective"],
                       sim_flows_per_step=r["sim_flows_per_step"],
                       steps=r["steps"], measured_us=r["measured_us"],
                       analytic_us=r["analytic_us"],
                       measured_over_analytic=r["measured_over_analytic"],
                       sim_wall_s=r["sim_wall_s"],
                       plain_sim_wall_s=next(
                           p["sim_wall_s"] for p in runs["torch"]["rows"]
                           if p.get("collective") == r["collective"]
                           and p["topology"] == r["topology"]),
                       cpu_sim_wall_s=next(
                           p["sim_wall_s"] for p in runs["cpu"]["rows"]
                           if p.get("collective") == r["collective"]
                           and p["topology"] == r["topology"]))
        emit_spray(path=path, launches=by_path[path], rows=len(rows),
                   rows_agree_plain=True, rows_agree_cpu=True, ok=True)
    return by_path


def spy_reroutes(fn):
    """``(fn(), checks)``: each ``local_reroute_loads`` that ``fn`` ran,
    with the largest load it put on a failed edge (surviving
    multiplicity 0), its conservation residual, diverted Gbps and
    pulls.  The check runs inside the local phase's wall: use it on a
    run whose walls are not reported."""
    from repro_torch.routing.protection import ProtectedRouter

    reroute = ProtectedRouter.local_reroute_loads
    checks = []

    def spy(self, demands, dg, max_redirects=None):
        lr = reroute(self, demands, dg, max_redirects)
        dead = self._degraded_state(dg)[0] <= 0
        checks.append({
            "failed_edges": int(dead.sum()),
            "max_load_on_failed": float(lr.loads[dead].abs().max())
            if bool(dead.any()) else 0.0,
            "conservation_residual": lr.conservation_residual,
            "diverted_gbps": lr.diverted_gbps, "pulls": lr.n_pulls})
        return lr

    ProtectedRouter.local_reroute_loads = spy
    try:
        out = fn()
    finally:
        ProtectedRouter.local_reroute_loads = reroute
    return out, checks


def phase_failures() -> dict:
    """Failure injection and fast-reroute protection on the card:
    ``--suite failures`` through the CLI at its defaults, then at
    mphx-4p-86x9 and mphx-2p-16x16 (``FAILURE_SPECS``, uniform, three
    reroute modes) through the kernels (16 x 16 twice), on the plain
    path and on the CPU, then the segment kernels at the protection's
    shapes.
    Returns each path's launch counts."""
    from repro_torch.experiments.simsuite import run_failures_suite
    from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES
    from repro_torch.kernels.segment_fairshare import (LAUNCHES,
                                                       reset_launch_counts)
    from repro_torch.routing.protection import ProtectedRouter
    from repro_torch.sim.failures import degrade_graph, parse_failure_spec
    from repro_torch.telemetry import collecting

    t_phase = time.perf_counter()
    by_path = {}
    card = torch.cuda.get_device_name(0)

    def emit_failures(**fields):
        emit("failures", phase_s=time.perf_counter() - t_phase, **fields)

    def compare_failure_rows(got, want, where, exact=False):
        """``compare_rows`` on each pair of ``--suite failures`` rows; of
        ``time_to_90_s`` whether it is None, and each side's
        ``conservation_residual`` below 1e-9.  Returns the count of
        routed rows."""
        if len(got) != len(want):
            raise AssertionError(f"{where}: {len(got)} rows, not "
                                 f"{len(want)}")
        for a, b in zip(got, want):
            name = f"{where} {a.get('topology')}/{a.get('failures')}/" \
                   f"{a.get('reroute')}/{a.get('phase', a.get('kind'))}"
            compare_rows(a, b, name, FAILURE_UNCOMPARED_KEYS, exact)
            if (a.get("time_to_90_s") is None) \
                    != (b.get("time_to_90_s") is None) \
                    or not all(r.get("conservation_residual", 0.0) < 1e-9
                               for r in (a, b)):
                raise AssertionError(f"{name}: {a} vs {b}")
        return sum(1 for r in got if not r.get("skipped"))

    # (a) --suite failures through the CLI at its defaults: kernels, plain
    # on the card, the CPU
    payloads = {}
    for run, dev, backend in SPRAY_RUNS:
        payloads[run], wall, _, launches = run_cli(
            ["--suite", "failures"], OUT_DIR / f"failures_default_{run}",
            dev, backend)
        if run == "cuda":
            launched(by_path, "failures default", counts=launches)
        emit_failures(path="failures default", run=run, suite_wall_s=wall,
                      rows=len(payloads[run]["rows"]),
                      device_name=payloads[run]["params"]["device_name"])
    rows = payloads["cuda"]["rows"]
    for other in ("torch", "cpu"):
        routed = compare_failure_rows(rows, payloads[other]["rows"],
                                      f"failures default cuda vs {other}",
                                      exact=True)
    emit_failures(path="failures default", routed_rows=routed,
                  launches=by_path["failures default"],
                  rows_agree_plain=True, rows_agree_cpu=True, ok=True)

    # (b), (c) the Table-2 MPHX and 16 x 16 through the kernels, the
    # plain path (86 x 9: the first spec alone) and the CPU (16 x 16).
    # 16 x 16 runs twice through the kernels (walls from the first, the
    # local reroutes' checks in the second); 86 x 9 once (reduced for
    # time: its repeat took ~60 s), with the checks, so its walls include
    # them
    for topo_name in FAILURE_TOPOS:
        plan = [("cuda", "cuda", "cuda", FAILURE_SPECS)]
        if topo_name == MAIN_TOPO:
            plan.append(("torch", "cuda", "torch", FAILURE_SPECS[:1]))
            spied = "cuda"
        else:
            plan += [("cuda again", "cuda", "cuda", FAILURE_SPECS),
                     ("torch", "cuda", "torch", FAILURE_SPECS),
                     ("cpu", "cpu", "torch", FAILURE_SPECS[1:])]
            spied = "cuda again"
        runs, checks = {}, []
        path = f"failures {topo_name}"
        for run, dev, backend, specs in plan:
            out = OUT_DIR / f"failures_{topo_name}_{run.replace(' ', '_')}"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()

            def suite():
                return run_failures_suite(
                    str(out), topo_names=[topo_name],
                    failure_specs=specs, protection_layers=FAILURE_LAYERS,
                    sim_backend=backend, device=dev)

            with collecting() as mx:
                if run == spied:
                    (payload, wall), checks = spy_reroutes(
                        lambda: timed(suite))
                else:
                    payload, wall = timed(suite)
            if run == "cuda":
                launched(by_path, path)
            runs[run] = payload["rows"]
            snap = mx.snapshot()
            emit_failures(
                path=path, run=run, specs=specs,
                reduced=specs != FAILURE_SPECS,
                suite_wall_s=wall,
                walls_include_reroute_checks=run == spied,
                peak_bytes=torch.cuda.max_memory_allocated()
                if dev == "cuda" else None,
                launches=dict(LAUNCHES) if dev == "cuda" else None,
                timers={k: v for k, v in snap["timers"].items()
                        if k.startswith(("protection.", "failures."))},
                counters={k: v for k, v in snap["counters"].items()
                          if k.startswith(("protection.", "failures."))},
                device_name=payload["params"]["device_name"])
        if "cuda again" in runs:
            compare_failure_rows(runs["cuda"], runs["cuda again"],
                                 f"{path} repeat", exact=True)
        for run, *_, specs in plan:
            if run in ("cuda", "cuda again"):
                continue
            labels = {parse_failure_spec(s).label() for s in specs}
            compare_failure_rows(
                [r for r in runs["cuda"] if r.get("failures") in labels],
                runs[run], f"{path} cuda vs {run}")
        for c in checks:
            if c["max_load_on_failed"] != 0.0 \
                    or c["conservation_residual"] >= 1e-9:
                raise AssertionError(f"{path}: local reroute {c}")
        emit_failures(path=path, local_reroutes=checks,
                      rows_repeat="cuda again" in runs,
                      rows_agree_plain=True,
                      rows_agree_cpu="cpu" in runs, ok=True)
        # the summary a spec: every mode's phase walls and time to 90 %
        for spec in FAILURE_SPECS:
            label = parse_failure_spec(spec).label()
            mine = [r for r in runs["cuda"] if r.get("failures") == label]
            t90 = {r["reroute"]: r["time_to_90_s"] for r in mine
                   if r.get("kind") == "recovery_summary"}
            emit_failures(
                path=path, failures=label,
                throughput={k: v for r in mine
                            if r.get("kind") == "throughput"
                            for k, v in r.items()},
                phases=[{k: r.get(k) for k in (
                    "reroute", "phase", "delivered_fraction",
                    "stalled_share", "max_util", "phase_wall_s",
                    "t_offset_s", "conservation_residual")}
                    for r in mine if r.get("kind") == "recovery"],
                time_to_90_s=t90,
                # does the local reroute reach 90 % before the global
                # recompute does (None: neither reaches it)
                local_first=None if t90.get("local") is None
                else t90.get("none") is None or t90["local"] < t90["none"],
                protection_coverage=next(
                    (r["protection_coverage"] for r in mine
                     if "protection_coverage" in r), None),
                device_name=card)

    # (d) #1 and #2 at the protection's shapes at mphx-4p-86x9: a local
    # reroute pull's ECMP denominators (surviving downhill multiplicity
    # by source, one lane a segment) under the first spec, and the
    # backup table's first-downhill min in protection layer 1
    topo = SWEEP_TOPOLOGIES[MAIN_TOPO]
    pr = ProtectedRouter(topo, n_layers=FAILURE_LAYERS, device="cuda")
    csr = pr.csr
    S = csr.n_switches
    C = min(pr.dst_chunk, S)
    dests = torch.arange(C, device="cuda")
    dg = degrade_graph(pr.graph, parse_failure_spec(FAILURE_SPECS[0]))
    surv_mult = pr._degraded_state(dg)[0]
    ids, plan = pr.router._block("src", C)
    case = f"{MAIN_TOPO} uniform, {C} destinations"
    dist = pr.layer_hops(0)[:, dests]
    d_src = dist[csr.src]
    down = (dist[csr.dst] == d_src - 1) & (d_src > 0)
    w = surv_mult[:, None] * (down & (surv_mult > 0)[:, None])
    kernel_row("segment_sum", case, "protection pull: ECMP denominators",
               w.reshape(-1), ids, S * C, plan, True)
    dist = pr.layer_hops(1)[:, dests]
    d_src = dist[csr.src]
    down = pr.layer_mask[1][:, None] & (dist[csr.dst] == d_src - 1) \
        & (d_src > 0)
    first = torch.where(down, csr.dst.to(torch.float64)[:, None],
                        torch.inf)
    kernel_row("segment_min", case,
               "backup table: first-downhill min, layer 1",
               first.reshape(-1), ids, S * C, plan, True)
    del pr, dg, surv_mult, dist, d_src, down, w, first
    torch.cuda.empty_cache()
    emit_failures(launches=by_path, ok=True)
    return by_path


def spy_tenant_sims(fn):
    """``(fn(), sims)``: the flows and epochs of each simulation the
    tenant mixes of ``fn`` ran (a fabric's mixed run first, then its
    isolated ones)."""
    from repro_torch.workload import tenants

    simulate, sims = tenants._simulate, []

    def spy(router, flows, *args):
        res = simulate(router, flows, *args)
        sims.append({"flows": len(flows), "epochs": res.n_epochs})
        return res

    tenants._simulate = spy
    try:
        out = fn()
    finally:
        tenants._simulate = simulate
    return out, sims


def phase_cosim_serving() -> dict:
    """Training-step co-simulation and multi-tenant serving on the card:
    (a) ``--suite cosim`` and ``--suite serving`` (four tenants) through
    the CLI at their defaults on the kernels, the plain path and the CPU,
    ``--cosim-method batches`` on the kernels and the CPU, ``--suite
    cosim --trace``; (b) the 16,384-rank step on mphx-4p-86x9 through
    the kernels and on the plain path, and 4,096 ranks on
    mphx-2p-16x16 on the kernels and the CPU; (c) the serving mix at
    4 x its rates on mphx-2p-8x8 twice through the kernels (byte-equal
    ``serving.json``) and once on the plain path.  Returns each path's
    launch counts."""
    t_phase = time.perf_counter()
    by_path = {}
    card = torch.cuda.get_device_name(0)

    def emit_cs(**fields):
        emit("cosim_serving", phase_s=time.perf_counter() - t_phase,
             **fields)

    def out_dir(name, run):
        return OUT_DIR / f"{name}_{run.replace(' ', '_')}"

    def cosim_rows(payload):
        return [{"arch": r["arch"], "topology": r["topology"],
                 "engine": r["engine"], "placement": r["placement"],
                 "sim_wall_s": r["sim_wall_s"],
                 "comm_over_analytic": r["comm_over_analytic"],
                 "tokens_per_s": r["tokens_per_s"],
                 "phases": [(p["phase"], p["sim_flows_per_step"],
                             p["steps"]) for p in r["phases"]]}
                for r in payload["rows"] if not r.get("skipped")]

    # (a) the CLI at its defaults: kernels, plain on the card, the CPU
    serve_args = ["--suite", "serving", "--tenants", *SERVING_TENANTS]
    for name, args in (("cosim defaults", ["--suite", "cosim"]),
                       ("serving defaults", serve_args),
                       ("cosim batches", ["--suite", "cosim",
                                          "--cosim-method", "batches"])):
        runs = {}
        plan = SPRAY_RUNS if name != "cosim batches" \
            else (SPRAY_RUNS[0], SPRAY_RUNS[2])
        for run, dev, backend in plan:
            payload, wall, peak, launches = run_cli(
                args, out_dir(name.replace(" ", "_"), run), dev, backend)
            if run == "cuda":
                launched(by_path, name, ("segment_sum",), launches)
            runs[run] = payload["rows"]
            emit_cs(path=name, run=run, suite_wall_s=wall, peak_bytes=peak,
                    rows=len(payload["rows"]),
                    launches=launches if dev == "cuda" else None,
                    device_name=payload["params"]["device_name"])
        for other in runs:
            if other != "cuda":
                compare_rows(runs["cuda"], runs[other],
                             f"{name} cuda vs {other}", exact=True)
        emit_cs(path=name, rows_agree=sorted(runs), ok=True)
    # --suite cosim --trace: the phase spans add up to the rows' comm
    trace_path = OUT_DIR / "cosim_trace.json"
    payload, wall, _, _ = run_cli(
        ["--suite", "cosim", "--trace", str(trace_path)],
        OUT_DIR / "cosim_trace_cuda", "cuda", "cuda")
    trace = json.loads(trace_path.read_text())
    spans = [e for e in trace["traceEvents"] if e.get("cat") == "phase"]
    rows = [r for r in payload["rows"] if not r.get("skipped")]
    span_ms = sum(e["dur"] for e in spans) / 1e3
    comm_ms = sum(r["comm_ms"] for r in rows)
    if len(spans) != sum(len(r["phases"]) for r in rows) \
            or abs(span_ms - comm_ms) > 1e-4 * len(rows):
        raise AssertionError(f"cosim trace: {len(spans)} phase spans, "
                             f"{span_ms} ms against {comm_ms} ms")
    emit_cs(path="cosim trace", suite_wall_s=wall, phase_spans=len(spans),
            span_ms=span_ms, comm_ms=comm_ms,
            cosim_phases=payload["telemetry"]["counters"]["cosim.phases"],
            ok=True)

    # (b) one training step of 16,384 ranks on the paper's Table-2 MPHX
    # through the kernels and on the plain path; then 4,096 ranks
    # on mphx-2p-16x16 through the kernels and on the CPU
    for topo_name, ranks, plan in COSIM_CELLS:
        path = f"cosim {topo_name}"
        args = ["--suite", "cosim", "--topos", topo_name, "--ranks",
                str(ranks)]
        runs = {}
        for run, dev, backend in plan:
            payload, wall, peak, launches = run_cli(
                args, out_dir(f"cosim_{topo_name}", run), dev, backend)
            if run == "cuda":
                launched(by_path, path, ("segment_sum",), launches)
            runs[run] = payload["rows"]
            emit_cs(path=path, run=run, ranks=ranks, suite_wall_s=wall,
                    peak_bytes=peak,
                    launches=launches if dev == "cuda" else None,
                    meshes=payload["params"]["meshes"],
                    rows=cosim_rows(payload),
                    device_name=payload["params"]["device_name"])
        for other in runs:
            if other != "cuda":
                compare_rows(runs["cuda"], runs[other],
                             f"{path} cuda vs {other}")
        emit_cs(path=path, ranks=ranks, rows_agree=sorted(runs),
                device_name=card, ok=True)

    # (c) the serving mix at 4 x its rates on mphx-2p-8x8: the many-epoch
    # host-bound cell; twice through the kernels (serving.json byte for
    # byte), once on the plain path
    path = f"serving {SERVING_TOPO} x{SERVING_RATE_SCALE:g}"
    args = ["--suite", "serving", "--topos", SERVING_TOPO, "--tenants",
            *SERVING_TENANTS, "--serving-rate-scale",
            str(SERVING_RATE_SCALE), "--seed", "0"]
    runs, files = {}, {}
    for run, dev, backend in (("cuda", "cuda", "cuda"),
                              ("cuda again", "cuda", "cuda"),
                              ("torch", "cuda", "torch")):
        out = out_dir("serving_x4", run)
        (payload, wall, peak, launches), sims = spy_tenant_sims(
            lambda: run_cli(args, out, dev, backend))
        if run == "cuda":
            # the event loop's water-filling sums; no bottleneck (min) is
            # computed on this path
            launched(by_path, path, ("segment_sum",), launches)
        runs[run] = payload["rows"]
        files[run] = (out / "serving.json").read_bytes()
        mixed = sims[0]
        emit_cs(path=path, run=run, suite_wall_s=wall, peak_bytes=peak,
                launches=launches, mixed_flows=mixed["flows"],
                mixed_epochs=mixed["epochs"], sims=sims,
                epochs=sum(s["epochs"] for s in sims),
                epochs_per_s=sum(s["epochs"] for s in sims) / wall,
                device_name=payload["params"]["device_name"])
    if files["cuda"] != files["cuda again"]:
        raise AssertionError(f"{path}: serving.json differs run to run")
    compare_rows(runs["cuda"], runs["torch"], f"{path} cuda vs torch",
                 exact=True)
    emit_cs(path=path, serving_json_bytes=len(files["cuda"]),
            byte_identical=True, rows_agree_plain=True, device_name=card,
            ok=True)
    emit_cs(launches=by_path, ok=True)
    return by_path


def phase_build() -> None:
    """nvcc for the seven libraries at once (one process each)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.flash_attention.ops import (
        BACKWARD_LIBRARY as attn_bwd_lib)
    from repro_torch.kernels.flash_attention.ops import LIBRARY as attn_lib
    from repro_torch.kernels.grouped_matmul.ops import LIBRARY as gmm_lib
    from repro_torch.kernels.rg_lru.ops import LIBRARY as lru_lib
    from repro_torch.kernels.rmsnorm.ops import (
        BACKWARD_LIBRARY as norm_bwd_lib)
    from repro_torch.kernels.rmsnorm.ops import LIBRARY as norm_lib
    from repro_torch.kernels.segment_fairshare.ops import LIBRARY as seg_lib

    def build(lib):
        t0 = time.perf_counter()
        path, log = lib.build()
        return lib, path, log, time.perf_counter() - t0

    t0 = time.perf_counter()
    libs = (seg_lib, norm_lib, attn_lib, gmm_lib, lru_lib, norm_bwd_lib,
            attn_bwd_lib)
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        built = list(pool.map(build, libs))
    wall = time.perf_counter() - t0
    for lib, path, log, seconds in built:
        lib.load()
        emit("build", library=os.path.relpath(path, ROOT), seconds=seconds,
             ptxas=[l.strip() for l in log.splitlines()
                    if "Compiling entry" in l or "registers" in l
                    or "spill" in l])
    emit("build", parallel_wall_s=wall, ok=True)


def check_close(name: str, got, again, want, tol: float,
                where: str) -> float:
    """Kernel vs plain version: within ``tol`` absolute and relative (the
    dtype's tolerance), the same shape and dtype, two kernel runs the same
    bits.  Returns the max abs error."""
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name} {where}: two runs differ")
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} {where}: {tuple(got.shape)} "
                             f"{got.dtype} != {tuple(want.shape)} "
                             f"{want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name} {where}: non-finite output")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not bool(((g - w).abs() <= tol + tol * w.abs()).all()):
        raise AssertionError(f"{name} {where}: max abs err {err} beyond "
                             f"{tol} abs + {tol} rel")
    return err


def row_rel_err(got, want) -> float:
    """max over the last axis's rows of max |got - want| / max |want|."""
    g, w = got.float(), want.float()
    gap = (g - w).abs().amax(dim=-1)
    top = w.abs().amax(dim=-1)
    if bool((gap > 0).logical_and(top == 0).any()):
        return math.inf
    return float((gap / top.clamp_min(torch.finfo(torch.float32).tiny))
                 .max())


def ring_kv_pos(cap: int, written: int, device) -> torch.Tensor:
    """kv_pos of a ring cache after positions 0..written-1: -1 = empty."""
    kv_pos = torch.full((cap,), -1, dtype=torch.int32)
    for p in range(written):
        kv_pos[p % cap] = p
    return kv_pos.to(device)


def attention_inputs(gen, B, Sq, K, G, Skv, Dh, dtype):
    """q (B,Sq,K,G,Dh), k and v (B,Skv,K,Dh), standard normal."""
    dev = torch.device("cuda")
    q = torch.randn(B, Sq, K, G, Dh, device=dev, generator=gen).to(dtype)
    kv = [torch.randn(B, Skv, K, Dh, device=dev, generator=gen).to(dtype)
          for _ in range(2)]
    return q, kv[0], kv[1]


def attention_cost(q, k, q_pos, kv_pos, causal, window) -> dict:
    """Least time for one attention call: q, o and the attended keys'
    k and v moved once, or 4*Dh operations per attended (query head,
    key) pair on the bf16 tensor cores (float32 outside them)."""
    from repro_torch.kernels.flash_attention import attention_mask

    B, Sq, K, G, Dh = q.shape
    mask = attention_mask(q_pos, kv_pos, causal, window)
    pairs = int(mask.sum())
    keys = int(mask.any(dim=0).sum())
    elt = q.element_size()
    n_bytes = 2 * q.numel() * elt + 2 * B * keys * K * Dh * elt \
        + 4 * (q_pos.numel() + kv_pos.numel())
    ops = 4 * Dh * B * K * G * pairs
    peak = PEAK_BF16_PER_S if q.dtype == torch.bfloat16 else PEAK_FP32_PER_S
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / peak
    return {"bytes": n_bytes, "flops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rmsnorm_cost(x, scale) -> dict:
    """Least time for one RMSNorm: x read and written once, the scale
    read once, or 4 float32 operations per element outside the tensor
    cores."""
    n_bytes = 2 * x.numel() * x.element_size() \
        + scale.numel() * scale.element_size()
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = 4 * x.numel() / PEAK_FP32_PER_S
    return {"bytes": n_bytes, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def gmm_cost(n_ops: int, n_bytes: int, dtype) -> dict:
    """Least time for a grouped matmul: ``n_bytes`` moved once, or
    ``n_ops`` operations on the bf16 tensor cores (float32 outside
    them)."""
    peak = PEAK_BF16_PER_S if dtype == torch.bfloat16 else PEAK_FP32_PER_S
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / peak
    return {"bytes": n_bytes, "flops": n_ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def expert_inputs(gen, E, M, K, N, dtype):
    """x (E, M, K) standard normal, w (E, K, N) scaled by 1/sqrt(K) as the
    model's init."""
    dev = torch.device("cuda")
    x = torch.randn(E, M, K, device=dev, generator=gen).to(dtype)
    w = torch.randn(E, K, N, device=dev, generator=gen)
    return x, w.mul_(1.0 / math.sqrt(K)).to(dtype)


def device_time_kept(fn, kernel_name: str, reps: int,
                     sessions: int = 3) -> dict:
    """``device_time``, profiled again (up to ``sessions`` sessions) while
    the profiler keeps no record of the kernel: late in this process a
    short session can lose all of them (``moe_serve``'s ragged rows kept
    0 of 3 on an NVIDIA H100 80GB HBM3 at 700 W)."""
    for _ in range(sessions):
        got = device_time(fn, kernel_name, reps=reps)
        if got["recorded"]:
            break
    return got


def gmm_times(call, lib_call, heavy: bool, reps: int = 0) -> dict:
    """A grouped matmul's device times beside its library call's: the
    profiler's (``device_time_kept`` over ``reps`` calls, 3 when heavy
    and 20 else by default; every route's kernel name starts with
    ``gmm_``) and 20 (5 when heavy) calls in one CUDA graph
    (``graph_ms``), with the SM clock before and after the kernel's.
    ``lib_call`` None: no library times."""
    reps, calls = (reps or 3, 5) if heavy else (reps or 20, 20)
    clock0 = sm_clock_mhz()
    kern = device_time_kept(call, "gmm_", reps)
    kern_graph = graph_ms(call, calls)
    clock1 = sm_clock_mhz()
    lib = device_time_kept(lib_call, "", reps) if lib_call else {"ms": None}
    return {"kernel_device_ms": kern["ms"],
            "kernel_device_runs_recorded": kern["recorded"],
            "kernel_device_runs_expected": reps,
            "kernel_graph_ms": kern_graph,
            "library_device_ms": lib["ms"],
            "library_graph_ms": graph_ms(lib_call, calls) if lib_call
            else None,
            "sm_clock_mhz_before_after": [clock0, clock1]}


def check_grouped_matmul() -> dict:
    """The grouped matmul at mixtral-8x22b's expert shapes: float32 at
    2e-5, then bf16 (timed) per output row, on its route (``wgmma`` for
    more than 64 rows, ``mma`` for decode's 2)."""
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul.ops import _route, call_route

    gen = torch.Generator(device="cuda").manual_seed(2)
    E, d, f = 8, 6144, 16384
    # (case, rows per expert, K, N): the prefill wave's capacity C = 1,280,
    # a decode step's C = 2, the window wave's C = 1,300
    shapes = [("prefill gate/up", 1280, d, f), ("prefill down", 1280, f, d),
              ("decode gate/up", 2, d, f), ("decode down", 2, f, d),
              ("window gate/up", 1300, d, f)]
    results, splits_by_case = {}, {}
    for case, M, K, N in shapes:
        x, w = expert_inputs(gen, E, M, K, N, torch.float32)
        err32 = check_close("grouped_matmul", gm.grouped_matmul(x, w),
                            gm.grouped_matmul(x, w),
                            gm.grouped_matmul_ref(x, w), 2e-5,
                            f"{case} float32")
        del x, w
        x, w = expert_inputs(gen, E, M, K, N, torch.bfloat16)
        got, want = gm.grouped_matmul(x, w), gm.grouped_matmul_ref(x, w)
        err = check_close("grouped_matmul", got, gm.grouped_matmul(x, w),
                          want, 5e-2, case)
        row_err = row_rel_err(got, want)
        if row_err > GMM_ROW_TOL_BF16:
            raise AssertionError(f"grouped_matmul {case}: a row differs by "
                                 f"{row_err} of its max > "
                                 f"{GMM_ROW_TOL_BF16}")
        del got, want

        def call():
            gm.grouped_matmul(x, w)

        def lib_call():
            torch.bmm(x, w)

        heavy = M > 2
        n_bytes = 2 * (x.numel() + w.numel() + E * M * N)
        splits = gm.ops.call_splits(x, w)
        splits_by_case[case] = splits
        clock0 = sm_clock_mhz()
        kern_ms = time_ms(call, reps=3 if heavy else 20)
        clock1 = sm_clock_mhz()
        row = {"max_abs_err": err, "ms": kern_ms,
               "plain_ms": time_ms(lambda: gm.grouped_matmul_ref(x, w),
                                   reps=2 if heavy else 5, samples=3),
               "library_ms": time_ms(lib_call, reps=3 if heavy else 20),
               **gmm_cost(2 * E * M * K * N, n_bytes, x.dtype),
               "kernel_route": call_route(x), "splits": splits}
        results.setdefault("grouped_matmul", row)
        times = gmm_times(call, lib_call, heavy)
        emit("model_kernel", kernel="grouped_matmul", case=case,
             x=list(x.shape), w=list(w.shape), dtype="bfloat16", **row,
             max_row_rel_err=row_err, row_tolerance=GMM_ROW_TOL_BF16,
             float32_route=_route(torch.float32, M),
             float32_max_abs_err=err32, float32_tolerance=2e-5,
             library="torch.bmm (bf16)", **times,
             sm_clock_mhz_around_ms=[clock0, clock1],
             achieved_TFLOPs=row["flops"] / (row["ms"] * 1e-3) / 1e12,
             achieved_device_TFLOPs=(
                 row["flops"] / (times["kernel_device_ms"] * 1e-3) / 1e12
                 if times["kernel_device_ms"] else None),
             achieved_GBps=n_bytes / (row["ms"] * 1e-3) / 1e9, ok=True)
        del x, w
        torch.cuda.empty_cache()
    results["grouped_matmul"]["splits_by_case"] = splits_by_case
    return results


def check_rmsnorm_path(phase: str, entries, gen,
                       t_phase: "float | None" = None) -> dict:
    """RMSNorm at a serve path's shapes, ``entries`` of (arch, width,
    rows): float32 at its tolerance, then bf16 (timed), held per row.
    Each line is stamped with ``phase_s`` when the phase's start
    ``t_phase`` is given.  Returns the first entry's row of the kernels
    line."""
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    dev = torch.device("cuda")
    tol = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
    results = {}
    for arch, d, rows in entries:
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(rows, d, device=dev, generator=gen).to(dt)
            s = torch.randn(d, device=dev, generator=gen).to(dt)
            got, want = rn.rmsnorm(x, s, 1e-6), rn.rmsnorm_ref(x, s, 1e-6)
            errs[dt] = check_close("rmsnorm", got, rn.rmsnorm(x, s, 1e-6),
                                   want, tol[dt],
                                   f"{arch} path ({rows}, {d}) {dt}")
        # x and s are now the bf16 inputs: held per row, then timed
        row_err = row_rel_err(got, want)
        if row_err > ATTN_ROW_TOL_BF16:
            raise AssertionError(f"rmsnorm {arch} path ({rows}, {d}): a row "
                                 f"differs by {row_err} of its max > "
                                 f"{ATTN_ROW_TOL_BF16}")
        del got, want

        def call():
            rn.rmsnorm(x, s, 1e-6)

        def lib_call():
            F.rms_norm(x, (d,), weight=s, eps=1e-6)

        row = {"max_abs_err": errs[torch.bfloat16], "ms": time_ms(call),
               "plain_ms": time_ms(lambda: rn.rmsnorm_ref(x, s, 1e-6)),
               "library_ms": time_ms(lib_call), **rmsnorm_cost(x, s)}
        results.setdefault("rmsnorm", row)
        # the plan the timed calls took, and its kernel's name alone in
        # the device time
        route = rn.ops.call_plan(x, s)
        kernel_name = ("rmsnorm_row_kernel" if route.route == "register"
                       else "rmsnorm_kernel")
        stamp = {} if t_phase is None else \
            {"phase_s": time.perf_counter() - t_phase}
        emit(phase, kernel="rmsnorm", arch=arch, **stamp,
             case="prefill" if rows > SERVE_BATCH else "decode",
             shape=[rows, d], dtype="bfloat16",
             kernel_route=route._asdict(), **row,
             max_row_rel_err=row_err, row_tolerance=ATTN_ROW_TOL_BF16,
             float32_max_abs_err=errs[torch.float32],
             float32_tolerance=tol[torch.float32],
             library="torch.nn.functional.rms_norm",
             kernel_device_ms=device_time(call, kernel_name)["ms"],
             library_device_ms=device_time(lib_call, "")["ms"],
             kernel_graph_ms=graph_ms(call),
             library_graph_ms=graph_ms(lib_call),
             achieved_GBps=row["bytes"] / (row["ms"] * 1e-3) / 1e9, ok=True)
    return results


def positions_range(n: int) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device="cuda")


def position_at(p: int) -> torch.Tensor:
    return torch.tensor([p], dtype=torch.int32, device="cuda")


def check_mask_probe(q_pos, kv_pos, B, K, G, Dh, window, where,
                     causal: bool = True) -> float:
    """``mask_probe``'s exact answer through the bf16 route of ``q_pos``'s
    length (the tensor-core kernel for Sq > 1, the decode kernel for
    Sq = 1), with NaN in the empty ring slots' k and v: every value within
    PROBE_REL_TOL of its own size (0 exactly where the answer is 0), one
    launch counted on that route.  Returns the largest relative gap."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import _route

    counter = f"flash_attention_{_route(torch.bfloat16, q_pos.numel())}"
    q, k, v, want = fa.mask_probe(B, K, G, Dh, q_pos, kv_pos, causal=causal,
                                  window=window)
    empty = kv_pos < 0
    k[:, empty] = float("nan")
    v[:, empty] = float("nan")
    before = fa.LAUNCHES[counter]
    got = fa.flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                             window=window).double()
    torch.cuda.synchronize()
    if fa.LAUNCHES[counter] != before + 1:
        raise AssertionError(f"mask probe {where}: not on {counter}")
    want = want[None, :, None, None, :]
    gap = (got - want).abs()
    if not bool((gap <= PROBE_REL_TOL * want).all()):
        raise AssertionError(f"mask probe {where}: max gap {float(gap.max())}"
                             f" beyond {PROBE_REL_TOL} of the value")
    return float((gap / want.clamp_min(1e-300)).max())


def check_attention_path(phase: str, path, gen, causal: bool = True,
                         t_phase: "float | None" = None,
                         graph_calls: "int | None" = None,
                         rows: "dict | None" = None) -> dict:
    """Attention at a serve path's shapes, ``path`` of (arch, case, B, K,
    G, Sq, q_pos, kv_pos, window, Dh), causal or not as ``causal`` says:
    float32 at 2e-5 first (the decode kernel for Sq = 1, the CUDA-core
    kernel otherwise: no bf16 rounding hides a dropped tile, a lost split
    or a wrong mask there), then bf16 (timed), held per row and to the
    mask probe's exact answer, on its own route (``tc`` for Sq > 1,
    ``decode`` for Sq = 1), beside SDPA as the yardstick.  Device times
    come from the profiler and from ``graph_calls`` calls (default 5 for
    Sq > 1, 20 for decode) in one CUDA graph timed by CUDA events, for the
    kernel and for SDPA alike.  Each line is stamped with ``phase_s`` when
    the phase's start ``t_phase`` is given, and each case's row with its
    device times is kept in ``rows`` when given.  Returns the first
    entry's row of the kernels line."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import _route

    tol = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
    results = {}
    for arch, name, B, K, G, Sq, q_pos, kv_pos, window, Dh in path:
        Skv = kv_pos.numel()
        kw = dict(causal=causal, window=window)
        route = _route(torch.bfloat16, Sq)
        probe = check_mask_probe(q_pos, kv_pos, B, K, G, Dh, window,
                                 f"{arch} path {name}", causal=causal)
        q, k, v = attention_inputs(gen, B, Sq, K, G, Skv, Dh, torch.float32)
        args = (q, k, v, q_pos, kv_pos)
        err32 = check_close("flash_attention", fa.flash_attention(*args, **kw),
                            fa.flash_attention(*args, **kw),
                            fa.attention_ref(*args, **kw), tol[q.dtype],
                            f"{arch} path {name} float32")
        q, k, v = attention_inputs(gen, B, Sq, K, G, Skv, Dh,
                                   torch.bfloat16)
        args = (q, k, v, q_pos, kv_pos)
        got, want = fa.flash_attention(*args, **kw), \
            fa.attention_ref(*args, **kw)
        err = check_close("flash_attention", got,
                          fa.flash_attention(*args, **kw), want, tol[q.dtype],
                          f"{arch} path {name}")
        row_err = row_rel_err(got, want)
        if row_err > ATTN_ROW_TOL_BF16:
            raise AssertionError(f"flash_attention {arch} path {name}: a row "
                                 f"differs by {row_err} of its max |o| > "
                                 f"{ATTN_ROW_TOL_BF16}")
        del got, want
        # the yardstick: SDPA on (B, H, S, Dh) copies made beforehand
        qs = q.reshape(B, Sq, K * G, Dh).transpose(1, 2).contiguous()
        ks, vs = (t.transpose(1, 2).contiguous() for t in (k, v))
        causal_only = causal and name == "prefill" and window is None
        # non-causal over keys all filled: every key attended, no mask
        unmasked = not causal and window is None and bool((kv_pos >= 0)
                                                          .all())
        sdpa_kw = dict(is_causal=True) if causal_only else {} if unmasked \
            else dict(attn_mask=fa.attention_mask(q_pos, kv_pos, causal,
                                                  window))

        def call():
            fa.flash_attention(*args, **kw)

        def lib_call():
            return F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True,
                                                  **sdpa_kw)

        lib_err = float((lib_call().transpose(1, 2).reshape(q.shape).float()
                         - fa.attention_ref(*args, **kw).float()).abs().max())
        heavy = Sq > 1
        row = {"max_abs_err": err,
               "ms": time_ms(call, reps=5 if heavy else 20),
               "plain_ms": time_ms(lambda: fa.attention_ref(*args, **kw),
                                   reps=3 if heavy else 20, samples=3),
               "library_ms": time_ms(lib_call, reps=5 if heavy else 20),
               **attention_cost(q, k, q_pos, kv_pos, causal, window),
               "kernel_route": route}
        results.setdefault("flash_attention", row)
        kern_dev = device_time(call, "flash_attention_kernel")
        lib_dev = device_time(lib_call, "")
        calls = graph_calls or (5 if heavy else 20)
        times = {"kernel_device_ms": kern_dev["ms"],
                 "kernel_device_runs_recorded": kern_dev["recorded"],
                 # the decode route is two kernels a call (split, combine)
                 "kernel_device_runs_expected": 20 * (1 if heavy else 2),
                 "library_device_ms": lib_dev["ms"],
                 "library_device_runs_recorded": lib_dev["recorded"],
                 "kernel_graph_ms": graph_ms(call, calls),
                 "library_graph_ms": graph_ms(lib_call, calls),
                 "graph_calls": calls}
        if not heavy:
            # the decode kernel's device time against its bound and SDPA's
            for how in ("device", "graph"):
                ms, lib = times[f"kernel_{how}_ms"], times[f"library_{how}_ms"]
                times[f"kernel_{how}_ms_over_bound"] = \
                    ms / row["bound_ms"] if ms else None
                times[f"kernel_{how}_ms_over_library"] = \
                    ms / lib if ms and lib else None
        if rows is not None:
            rows[name] = {**row, **times}
        stamp = {} if t_phase is None else \
            {"phase_s": time.perf_counter() - t_phase}
        emit(phase, kernel="flash_attention", arch=arch, case=name, **stamp,
             q=list(q.shape), kv=list(k.shape), window=window,
             causal=causal, dtype="bfloat16", **row,
             max_row_rel_err=row_err, row_tolerance=ATTN_ROW_TOL_BF16,
             mask_probe_max_rel_gap=probe, mask_probe_tolerance=PROBE_REL_TOL,
             float32_route=_route(torch.float32, Sq),
             float32_max_abs_err=err32,
             float32_tolerance=tol[torch.float32],
             library="scaled_dot_product_attention(enable_gqa=True"
                     + (", is_causal=True)" if causal_only else ")"
                        if unmasked else ", attn_mask)"),
             library_max_abs_err_vs_plain=lib_err, **times,
             achieved_TFLOPs=row["flops"] / (row["ms"] * 1e-3) / 1e12,
             achieved_GBps=row["bytes"] / (row["ms"] * 1e-3) / 1e9,
             ok=True)
        del q, k, v, args, qs, ks, vs
        torch.cuda.empty_cache()
    return results


def phase_model_kernels() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    tol = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
    torch.backends.cuda.matmul.allow_tf32 = False
    dtypes = (torch.float32, torch.bfloat16)

    # RMSNorm edge cases: (N, D), ragged and misaligned rows
    for n, d in [(1, 16), (7, 64), (5, 13), (33, 1000), (9, 8192)]:
        for dt in dtypes:
            x = torch.randn(n, d, device=dev, generator=gen).to(dt)
            s = torch.randn(d, device=dev, generator=gen).to(dt)
            err = check_close("rmsnorm", rn.rmsnorm(x, s, 1e-6),
                              rn.rmsnorm(x, s, 1e-6),
                              rn.rmsnorm_ref(x, s, 1e-6), tol[dt],
                              f"({n}, {d}) {dt}")
            emit("model_kernel", kernel="rmsnorm", case="edge",
                 shape=[n, d], dtype=str(dt), max_abs_err=err, ok=True)

    # rows of a wider buffer (the prefill's last position), with and
    # without 16-byte vector loads
    for pad in (8, 3):
        x = torch.randn(4, 4096 + pad, device=dev, generator=gen).to(
            torch.bfloat16)[:, :4096]
        s = torch.randn(4096, device=dev, generator=gen).to(torch.bfloat16)
        err = check_close("rmsnorm", rn.rmsnorm(x, s, 1e-6),
                          rn.rmsnorm(x, s, 1e-6), rn.rmsnorm_ref(x, s, 1e-6),
                          tol[x.dtype], f"strided rows, pad {pad}")
        emit("model_kernel", kernel="rmsnorm", case=f"strided rows +{pad}",
             shape=[4, 4096], dtype="bfloat16", max_abs_err=err, ok=True)

    # attention edge cases: (name, B, Sq, K, G, Skv, Dh, positions, window)
    # positions: None = right-aligned contiguous, else (q_pos, cap, written)
    edge = [("prefill-gqa-ragged", 2, 100, 2, 4, 100, 64, None, None),
            ("prefill-mha-1024-rows", 1, 1030, 2, 1, 1030, 128, None, None),
            ("mqa-window", 2, 80, 1, 8, 80, 16, None, 8),
            ("cross-ragged-dh32", 1, 33, 2, 2, 77, 32, None, None),
            ("decode-ring-empty", 4, 1, 4, 8, 70, 128, ([40], 70, 41), None),
            ("decode-ring-wrapped", 2, 1, 2, 4, 64, 64, ([150], 64, 151),
             16)]
    for name, B, Sq, K, G, Skv, Dh, pos, window in edge:
        for dt in dtypes:
            q, k, v = attention_inputs(gen, B, Sq, K, G, Skv, Dh, dt)
            if pos is None:
                q_pos, kv_pos = fa.right_aligned_positions(Sq, Skv, dev)
            else:
                q_pos = torch.tensor(pos[0], dtype=torch.int32, device=dev)
                kv_pos = ring_kv_pos(pos[1], pos[2], dev)
            args = (q, k, v, q_pos, kv_pos)
            kw = dict(causal=True, window=window)
            err = check_close("flash_attention", fa.flash_attention(*args,
                                                                    **kw),
                              fa.flash_attention(*args, **kw),
                              fa.attention_ref(*args, **kw), tol[dt],
                              f"{name} {dt}")
            emit("model_kernel", kernel="flash_attention", case=name,
                 dtype=str(dt), q=list(q.shape), kv=list(k.shape),
                 window=window, max_abs_err=err, ok=True)

    from repro_torch.models.registry import get_config

    moe = get_config(MOE_ARCH)
    # the serve paths' RMSNorm shapes, yi-9b's and mixtral-8x22b's width:
    # prefill rows B*S, decode rows B
    results = check_rmsnorm_path("model_kernel", [
        (SERVE_ARCH, 4096, SERVE_BATCH * SERVE_PROMPT),
        (SERVE_ARCH, 4096, SERVE_BATCH),
        (MOE_ARCH, moe.d_model, SERVE_BATCH * SERVE_PROMPT),
        (MOE_ARCH, moe.d_model, SERVE_BATCH)], gen)

    # the serve paths' attention.  yi-9b (4 KV heads of 8 queries):
    # prefill over the prompt's own keys (as the reference's prefill), the
    # same queries over a 1,057-slot cache holding the prompt, and a decode
    # step over 1,040 filled slots.  mixtral-8x22b (8 KV heads of 6, so a
    # 64-row tile straddles query positions; its window on every call):
    # prefill, decode over the 1,057-slot ring, the window wave's 4,160-token
    # prefill with the window binding, and its last decode step over the
    # wrapped ring of `window` slots.
    arange, at = positions_range, position_at
    S, cap, win = SERVE_PROMPT, SERVE_MAX_LEN, moe.sliding_window
    last = WINDOW_PROMPT + WINDOW_NEW - 1
    mk, mg = moe.n_kv_heads, moe.n_heads // moe.n_kv_heads
    path = [  # (arch, case, B, K, G, Sq, q_pos, kv_pos, window, Dh)
        (SERVE_ARCH, "prefill", SERVE_BATCH, 4, 8, S, arange(S), arange(S),
         None, 128),
        (SERVE_ARCH, "prefill-over-cache", SERVE_BATCH, 4, 8, S, arange(S),
         ring_kv_pos(cap, S, dev), None, 128),
        (SERVE_ARCH, "decode", SERVE_BATCH, 4, 8, 1, at(1039),
         ring_kv_pos(cap, 1040, dev), None, 128),
        (MOE_ARCH, "prefill", SERVE_BATCH, mk, mg, S, arange(S), arange(S),
         win, 128),
        (MOE_ARCH, "decode", SERVE_BATCH, mk, mg, 1, at(1039),
         ring_kv_pos(cap, 1040, dev), win, 128),
        (MOE_ARCH, "window prefill", 1, mk, mg, WINDOW_PROMPT,
         arange(WINDOW_PROMPT), arange(WINDOW_PROMPT), win, 128),
        (MOE_ARCH, "window decode", 1, mk, mg, 1, at(last),
         ring_kv_pos(win, last + 1, dev), win, 128)]
    results.update(check_attention_path("model_kernel", path, gen))
    results.update(check_grouped_matmul())
    return results


def logits_gap(got, want) -> "tuple[float, float]":
    """max |got - want| and max |want| over finite logits."""
    if not bool(torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("non-finite logits")
    return float((got - want).abs().max()), float(want.abs().max())


def teacher_forced(kern, plain, params, prompts, steps: int, tol: float,
                   where: str, max_len: int = SERVE_MAX_LEN,
                   frames=None) -> dict:
    """Prefill and ``steps`` decode steps on both paths, each fed the
    plain path's greedy token, so one near-tie cannot decide the
    comparison.  Every logit within ``tol * max |logit|``.  ``frames``:
    an encoder-decoder's encoder input, given to both prefills."""
    inputs = (prompts,) if frames is None else (prompts, frames)
    lk, ck = kern.prefill(params, *inputs, max_len=max_len)
    lp, cp = plain.prefill(params, *inputs, max_len=max_len)
    if lk.shape != (prompts.shape[0], kern.cfg.vocab_size) \
            or lk.dtype != torch.float32:
        raise AssertionError(f"{where}: logits {tuple(lk.shape)} {lk.dtype}")
    gap, top = logits_gap(lk, lp)
    worst = {"prefill_max_abs_diff": gap, "prefill_max_abs_logit": top}
    rel = [gap / top]
    for _ in range(steps):
        tok = torch.argmax(lp, dim=-1)[:, None]
        lk, ck = kern.decode_step(params, tok, ck)
        lp, cp = plain.decode_step(params, tok, cp)
        gap, top = logits_gap(lk, lp)
        rel.append(gap / top)
    worst.update(decode_steps=steps, max_rel_diff=max(rel),
                 prefill_rel_diff=rel[0], decode_max_rel_diff=max(rel[1:]),
                 tolerance=tol)
    if max(rel) > tol:
        raise AssertionError(f"{where}: logits differ by {max(rel)} of "
                             f"max |logit| > {tol}")
    return worst


def serve_run(cfg, model, params, requests: int = SERVE_REQUESTS,
              prompt: int = SERVE_PROMPT, new: int = SERVE_NEW):
    """``requests`` random prompts (numpy, from SERVE_SEED) through
    ``ServeEngine`` in waves of SERVE_BATCH, greedy.  Returns (stats,
    requests, wall s, peak device bytes)."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import ServeEngine

    reqs = make_requests(cfg, requests, prompt, new, SERVE_SEED)
    eng = ServeEngine(model, params, max_batch=SERVE_BATCH,
                      max_len=prompt + new + 1, seed=SERVE_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    return eng.stats, reqs, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()


def emit_serve_runs(phase: str, card: str, runs: dict, **stamp) -> None:
    """One line per path of the timed serve runs (each with ``stamp``'s
    fields); every request must have its SERVE_NEW tokens."""
    for backend, (stats, reqs, wall, peak) in runs.items():
        if stats.tokens_out != SERVE_REQUESTS * SERVE_NEW or any(
                len(r.output) != SERVE_NEW or not r.done for r in reqs):
            raise AssertionError(f"{backend}: {stats.tokens_out} tokens out")
        emit(phase, card=card, kernel_backend=backend, **stamp,
             requests=SERVE_REQUESTS, prompt_tokens=SERVE_PROMPT,
             new_tokens=SERVE_NEW, max_batch=SERVE_BATCH, waves=stats.waves,
             wall_s=wall, prefill_s=stats.prefill_s,
             decode_s=stats.decode_s,
             decode_tok_per_s=stats.decode_tok_per_s,
             prefill_tok_per_s=SERVE_REQUESTS * SERVE_PROMPT
             / stats.prefill_s, peak_memory_GB=peak / 1e9)


def tokens_equal(runs: dict) -> int:
    """Greedy tokens of the kernel path equal to the plain path's."""
    return sum(a == b for r, p in zip(runs["cuda"][1], runs["torch"][1])
               for a, b in zip(r.output, p.output))


def profile_decode_wave(model, params, prompts, max_len: int,
                        steps: int = SERVE_NEW, frames=None) -> dict:
    """Where the time goes in one decode wave of ``steps`` steps (sampling
    and the host read of the tokens included, as in the engine);
    ``frames``: an encoder-decoder's encoder input."""
    inputs = (prompts,) if frames is None else (prompts, frames)
    _, caches = model.prefill(params, *inputs, max_len=max_len)
    tok = prompts[:, -1:]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, caches = model.decode_step(params, tok, caches)
            tok = torch.argmax(logits, dim=-1)[:, None]
            tok.cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    busy_ms = sum(e[2] for e in events) / 1e3
    attn = [(c, t) for n, c, t in events if "flash_attention_kernel" in n]
    return {"profiled": "decode wave", "steps": steps, "wall_s": wall,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
            "attention_device_ms": sum(t for _, t in attn) / 1e3,
            "attention_kernel_runs": sum(c for c, _ in attn),
            "top_device_ops": [{"name": n[:80], "count": c, "ms": t / 1e3}
                               for n, c, t in events[:10]]}


def phase_serve(card: str) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models.registry import get_config, get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(SERVE_ARCH)
    kern = get_model(cfg, kernel_backend="cuda")
    plain = get_model(cfg, kernel_backend="torch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = kern.init(SERVE_SEED)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    n_params = kern.param_count()
    emit("serve", card=card, arch=SERVE_ARCH, params=n_params,
         param_dtype=cfg.param_dtype, layers=cfg.n_layers,
         weight_fill_s=fill_s,
         weights_GB=torch.cuda.memory_allocated() / 1e9)

    # a short run of each path first: neither timed run pays first use
    serve_run(cfg, kern, params, 1, 64, 2)
    serve_run(cfg, plain, params, 1, 64, 2)
    rn.reset_launch_counts()
    fa.reset_launch_counts()
    runs = {"cuda": serve_run(cfg, kern, params)}
    launches = {**rn.LAUNCHES, **fa.LAUNCHES}
    runs["torch"] = serve_run(cfg, plain, params)
    emit_serve_runs("serve", card, runs)
    # each wave: one prefill, then one decode step per new token (the
    # last step's logits are not sampled, as in the reference's engine);
    # the prefills' attention runs on the tensor-core kernel, the decode
    # steps' on the split-KV decode kernel
    waves = runs["cuda"][0].waves
    passes = waves * (1 + SERVE_NEW)
    want = {"rmsnorm": passes * (2 * cfg.n_layers + 1),
            "flash_attention": passes * cfg.n_layers,
            "flash_attention_tc": waves * cfg.n_layers,
            "flash_attention_decode": (passes - waves) * cfg.n_layers,
            "rmsnorm_backward": 0, "flash_attention_backward": 0,
            "flash_attention_backward_tc": 0}
    if launches != want:
        raise AssertionError(f"serve launches {launches} != {want} "
                             f"({passes} forward passes)")
    emit("serve", launches=launches, forward_passes=passes,
         launches_per_pass={k: v / passes for k, v in launches.items()},
         tokens_equal_to_plain_path=tokens_equal(runs),
         tokens_total=SERVE_REQUESTS * SERVE_NEW)

    prompts = torch.as_tensor(np.stack(
        [r.prompt for r in runs["cuda"][1][:SERVE_BATCH]]), device="cuda")
    bf16 = teacher_forced(kern, plain, params, prompts, SERVE_NEW,
                          SERVE_TOL["bfloat16"], "yi-9b bf16")
    emit("serve", check="teacher-forced logits, kernels vs plain",
         dtype="bfloat16", **bf16, ok=True)

    emit("serve", card=card,
         **profile_decode_wave(kern, params, prompts, SERVE_MAX_LEN))
    del params
    torch.cuda.empty_cache()

    # float32, 2 layers at full width: the kernels without bf16 rounding
    cfg32 = cfg.replace(n_layers=2, param_dtype="float32",
                        activation_dtype="float32")
    kern32 = get_model(cfg32, kernel_backend="cuda")
    params32 = kern32.init(SERVE_SEED)
    f32 = teacher_forced(kern32, get_model(cfg32, kernel_backend="torch"),
                         params32, prompts, 8, SERVE_TOL["float32"],
                         "yi-9b 2-layer float32")
    emit("serve", check="teacher-forced logits, kernels vs plain",
         dtype="float32", layers=2, **f32, ok=True)
    del params32
    torch.cuda.empty_cache()
    return launches


class RouteLog:
    """Wraps ``repro_torch.models.moe._route`` for one path's run of a
    comparison, and restores it afterwards.  Every call's own top-k
    experts are recorded; with ``replay`` (the other path's records, call
    by call) the layer takes the replayed experts instead, with weights
    renormalised from this path's own router probabilities, and the
    routings that differ from this path's own choice are counted.  With
    ``keep_first``, the first call's input rows are kept."""

    def __init__(self, replay=None, keep_first: bool = False):
        self.replay = replay
        self.keep_first = keep_first
        self.top_i = []
        self.first_input = None
        self.flips = 0

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._route = moe, moe._route
        moe._route = self.route
        return self

    def __exit__(self, *exc):
        self._moe._route = self._route

    def route(self, router_w, x_flat, cfg):
        top_w, top_i, aux = self._route(router_w, x_flat, cfg)
        if self.keep_first and self.first_input is None:
            self.first_input = x_flat.clone()
        if self.replay is not None:
            want = self.replay[len(self.top_i)]
            self.flips += differing_routings(top_i, want)
            probs = torch.softmax(x_flat.float() @ router_w, dim=-1)
            top_w = probs.gather(1, want)
            top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
            self.top_i.append(top_i)
            return top_w, want, aux
        self.top_i.append(top_i)
        return top_w, top_i, aux


def differing_routings(a, b) -> int:
    """Tokens whose sets of chosen experts differ."""
    return int((a.sort(dim=1).values != b.sort(dim=1).values)
               .any(dim=1).sum())


def moe_teacher_forced(kern, plain, params, prompts, steps: int,
                       max_len: int, tol: "float | None", replay: bool,
                       where: str, keep_first: bool = False) -> dict:
    """Prefill and ``steps`` decode steps of the plain path, each fed its
    own greedy token, then of the kernel path fed the same tokens; with
    ``replay`` the kernel path takes the plain path's experts.  Logits
    within ``tol * max |logit|`` of each pass (no gate when ``tol`` is
    None).  Also counts the (token, layer) routings that differ."""
    with RouteLog() as plain_log:
        lp, cp = plain.prefill(params, prompts, max_len=max_len)
        want, feed = [lp], []
        for _ in range(steps):
            feed.append(torch.argmax(lp, dim=-1)[:, None])
            lp, cp = plain.decode_step(params, feed[-1], cp)
            want.append(lp)
    del cp
    with RouteLog(plain_log.top_i if replay else None,
                  keep_first=keep_first) as kern_log:
        lk, ck = kern.prefill(params, prompts, max_len=max_len)
        if lk.shape != (prompts.shape[0], kern.cfg.vocab_size) \
                or lk.dtype != torch.float32:
            raise AssertionError(f"{where}: logits {tuple(lk.shape)} "
                                 f"{lk.dtype}")
        got = [lk]
        for tok in feed:
            lk, ck = kern.decode_step(params, tok, ck)
            got.append(lk)
    del ck
    rel = []
    for g, w in zip(got, want):
        gap, top = logits_gap(g, w)
        rel.append(gap / top)
    flips = kern_log.flips if replay else sum(
        differing_routings(a, b)
        for a, b in zip(kern_log.top_i, plain_log.top_i))
    out = {"decode_steps": steps, "max_rel_diff": max(rel),
           "prefill_rel_diff": rel[0],
           "decode_max_rel_diff": max(rel[1:]) if steps else None,
           "routing_replayed": replay, "differing_routings": flips,
           "routings": sum(t.shape[0] for t in plain_log.top_i),
           "tolerance": tol}
    if tol is not None and max(rel) > tol:
        raise AssertionError(f"{where}: logits differ by {max(rel)} of "
                             f"max |logit| > {tol}")
    return out, kern_log


def check_ragged(params, x_flat, top_i) -> dict:
    """The ragged grouped matmul on one MoE layer's routed rows: the
    (token, slot) records sorted by expert (stable), the layer's w_gate,
    ownership blocks of 128 rows; as routed, then with every group padded
    to a multiple of 128 rows.  Every row is compared: the masked rows
    must be 0, the others within the bf16 row rule."""
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul.ops import call_route

    w = params["layers"][0]["moe"]["experts"]["w_gate"]
    E, K, N = w.shape
    k = top_i.shape[1]
    eid = top_i.reshape(-1)
    order = torch.sort(eid, stable=True).indices
    x = x_flat[order // k].contiguous()
    sizes = torch.bincount(eid, minlength=E)
    padded = (sizes + 127) // 128 * 128
    x_pad = torch.zeros((int(padded.sum()), K), dtype=x.dtype,
                        device=x.device)
    dst = torch.cat([torch.arange(int(s), device=x.device) + int(o)
                     for s, o in zip(sizes.tolist(),
                                     (torch.cumsum(padded, 0) - padded)
                                     .tolist())])
    x_pad[dst] = x
    row = {}
    for case, xs, gs in (("routed", x, sizes), ("padded to 128", x_pad,
                                                 padded)):
        got = gm.ragged_grouped_matmul(xs, w, gs)
        want = gm.ragged_grouped_matmul_masked_ref(xs, w, gs)
        check_close("ragged_grouped_matmul", got,
                    gm.ragged_grouped_matmul(xs, w, gs), want, 5e-2, case)
        owner, inside = gm.block_owners(gs, xs.shape[0], 128)
        if bool((got[~inside] != 0).any()):
            raise AssertionError(f"ragged_grouped_matmul {case}: a masked "
                                 "row is not 0")
        row_err = row_rel_err(got[inside], want[inside])
        if row_err > GMM_ROW_TOL_BF16:
            raise AssertionError(f"ragged_grouped_matmul {case}: a row "
                                 f"differs by {row_err} of its max")
        exact_rows = None
        if case != "routed":
            exact = gm.ragged_grouped_matmul_ref(xs, w, gs)
            if not bool(inside.all()) or row_rel_err(got, exact) \
                    > GMM_ROW_TOL_BF16:
                raise AssertionError("ragged_grouped_matmul: padded groups "
                                     "differ from the exact oracle")
            exact_rows = xs.shape[0]
            del exact
        err = float((got.float() - want.float()).abs().max())
        del got, want
        offs = torch.cumsum(gs, 0).to(torch.int32)

        def call():
            gm.ragged_grouped_matmul(xs, w, gs)

        def lib_call():
            torch._grouped_mm(xs, w, offs=offs)

        kept = int(inside.sum())
        owners = int(torch.unique(owner[inside]).numel())
        n_bytes = 2 * (xs.numel() + owners * K * N + xs.shape[0] * N)
        timed = {"max_abs_err": err, "ms": time_ms(call, reps=3),
                 "plain_ms": time_ms(
                     lambda: gm.ragged_grouped_matmul_masked_ref(xs, w, gs),
                     reps=2, samples=3),
                 **gmm_cost(2 * kept * K * N, n_bytes, xs.dtype),
                 "kernel_route": call_route(xs, 128),
                 "splits": gm.ops.call_splits(xs, w, 128)}
        # the yardstick last: the kernel's own numbers do not wait on it
        try:
            timed["library_ms"] = time_ms(lib_call, reps=3)
            lib_note = "torch._grouped_mm(offs=cumsum(group_sizes))"
            lib = lib_call
        except (AttributeError, RuntimeError) as e:
            timed["library_ms"] = None
            lib_note = f"torch._grouped_mm unavailable: {e}"
            lib = None
        # late in the process: a longer profiler session than the
        # model_kernel phase's
        times = gmm_times(call, lib, True, reps=10)
        row.setdefault("ragged_grouped_matmul", timed)
        emit("moe_serve", kernel="ragged_grouped_matmul", case=case,
             x=list(xs.shape), w=list(w.shape), block_m=128,
             group_sizes=gs.tolist(), rows_kept=kept,
             rows_masked=xs.shape[0] - kept,
             rows_equal_to_exact_oracle=exact_rows, dtype="bfloat16",
             **timed, max_row_rel_err=row_err,
             row_tolerance=GMM_ROW_TOL_BF16, library=lib_note, **times,
             achieved_TFLOPs=timed["flops"] / (timed["ms"] * 1e-3) / 1e12,
             achieved_device_TFLOPs=(
                 timed["flops"] / (times["kernel_device_ms"] * 1e-3) / 1e12
                 if times["kernel_device_ms"] else None),
             ok=True)
    return row


def phase_moe_serve(card: str) -> "tuple[dict, dict]":
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.moe import _capacity
    from repro_torch.models.registry import get_config, get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    kern = get_model(cfg, kernel_backend="cuda")
    plain = get_model(cfg, kernel_backend="torch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = kern.init(SERVE_SEED)
    torch.cuda.synchronize()
    emit("moe_serve", card=card, arch=MOE_ARCH, layers=cfg.n_layers,
         layers_of_the_config=get_config(MOE_ARCH).n_layers,
         params=kern.param_count(), active_params=kern.active_param_count(),
         param_dtype=cfg.param_dtype, weight_fill_s=time.perf_counter() - t0,
         weights_GB=torch.cuda.memory_allocated() / 1e9)

    # a short run of each path first: neither timed run pays first use
    serve_run(cfg, kern, params, 1, 64, 2)
    serve_run(cfg, plain, params, 1, 64, 2)
    rn.reset_launch_counts()
    fa.reset_launch_counts()
    gm.reset_launch_counts()
    runs = {"cuda": serve_run(cfg, kern, params)}
    launches = {**rn.LAUNCHES, **fa.LAUNCHES, **gm.LAUNCHES}
    runs["torch"] = serve_run(cfg, plain, params)
    emit_serve_runs("moe_serve", card, runs)
    waves = runs["cuda"][0].waves
    passes = waves * (1 + SERVE_NEW)
    L = cfg.n_layers
    # the K splits of a decode step's expert products, (E, C, K) buffers
    # of the decode capacity C against the layers' weights
    experts = params["layers"][0]["moe"]["experts"]
    cap = _capacity(SERVE_BATCH, cfg)
    decode_splits = {
        name: gm.ops.call_splits(
            w.new_empty((w.shape[0], cap, w.shape[1])), w)
        for name, w in (("gate/up", experts["w_gate"]),
                        ("down", experts["w_down"]))}
    # on the H100's 132 SMs (264 slots of 2 blocks) the plan splits decode
    # down's 384 blocks in 2 and leaves gate/up's 1,024 whole: pinned here,
    # so a plan that stopped splitting would not lower the count it is
    # held to below
    if (torch.cuda.get_device_properties(0).multi_processor_count == 132
            and decode_splits != {"gate/up": 1, "down": 2}):
        raise AssertionError(f"moe_serve decode splits {decode_splits} on "
                             "132 SMs, not gate/up 1 and down 2")
    split_per_pass = L * (2 * (decode_splits["gate/up"] > 1)
                          + (decode_splits["down"] > 1))
    want = {"rmsnorm": passes * (2 * L + 1), "flash_attention": passes * L,
            "flash_attention_tc": waves * L,
            "flash_attention_decode": (passes - waves) * L,
            "rmsnorm_backward": 0, "flash_attention_backward": 0,
            "flash_attention_backward_tc": 0,
            "grouped_matmul": passes * 3 * L, "ragged_grouped_matmul": 0,
            "grouped_matmul_wgmma": waves * 3 * L,
            "grouped_matmul_splitk": (passes - waves) * split_per_pass}
    if launches != want:
        raise AssertionError(f"moe_serve launches {launches} != {want} "
                             f"({passes} forward passes)")
    emit("moe_serve", launches=launches, forward_passes=passes,
         decode_capacity=cap, decode_splits=decode_splits,
         launches_per_pass={k: v / passes for k, v in launches.items()},
         tokens_equal_to_plain_path=tokens_equal(runs),
         tokens_total=SERVE_REQUESTS * SERVE_NEW)

    prompts = torch.as_tensor(np.stack(
        [r.prompt for r in runs["cuda"][1][:SERVE_BATCH]]), device="cuda")
    max_len = SERVE_PROMPT + SERVE_NEW + 1
    gate, log = moe_teacher_forced(kern, plain, params, prompts, SERVE_NEW,
                                   max_len, SERVE_TOL["bfloat16"], True,
                                   "mixtral bf16 (routing replayed)",
                                   keep_first=True)
    emit("moe_serve", check="teacher-forced logits, kernels vs plain, the "
         "plain path's experts replayed", dtype="bfloat16", **gate, ok=True)
    # kernel #5 on the first layer's routed rows of this prefill wave
    ragged = check_ragged(params, log.first_input, log.replay[0])
    del log
    free, _ = moe_teacher_forced(kern, plain, params, prompts, SERVE_NEW,
                                 max_len, None, False,
                                 "mixtral bf16 (free routing)")
    emit("moe_serve", check="teacher-forced logits, kernels vs plain, "
         "free routing (not gated)", dtype="bfloat16", **free)

    # one request through the 4,096-token window: the ring holds the last
    # 4,096 prompt positions and wraps in decode; capacity 1,300 rows
    window = torch.as_tensor(make_requests(cfg, 1, WINDOW_PROMPT, WINDOW_NEW,
                                           SERVE_SEED + 1)[0].prompt,
                             device="cuda")[None]
    torch.cuda.reset_peak_memory_stats()
    win, _ = moe_teacher_forced(kern, plain, params, window, WINDOW_NEW,
                                WINDOW_PROMPT + WINDOW_NEW + 1,
                                SERVE_TOL["bfloat16"], True,
                                "mixtral window wave (routing replayed)")
    emit("moe_serve", check="window wave: teacher-forced logits, the plain "
         "path's experts replayed", prompt_tokens=WINDOW_PROMPT,
         window=cfg.sliding_window,
         cache_capacity=kern.cache_capacity(WINDOW_PROMPT + WINDOW_NEW + 1),
         dtype="bfloat16", **win,
         peak_memory_GB=torch.cuda.max_memory_allocated() / 1e9, ok=True)

    emit("moe_serve", card=card,
         **profile_decode_wave(kern, params, prompts, max_len))
    del params
    torch.cuda.empty_cache()

    # float32, 2 layers at full width, free routing: the kernels without
    # bf16 rounding must not flip a single routing
    cfg32 = cfg.replace(n_layers=2, param_dtype="float32",
                        activation_dtype="float32")
    kern32 = get_model(cfg32, kernel_backend="cuda")
    params32 = kern32.init(SERVE_SEED)
    torch.cuda.reset_peak_memory_stats()
    f32, _ = moe_teacher_forced(kern32, get_model(cfg32,
                                                  kernel_backend="torch"),
                                params32, prompts, 8, max_len,
                                SERVE_TOL["float32"], False,
                                "mixtral 2-layer float32")
    if f32["differing_routings"]:
        raise AssertionError(f"mixtral 2-layer float32: "
                             f"{f32['differing_routings']} routings differ")
    emit("moe_serve", check="teacher-forced logits, kernels vs plain, free "
         "routing", dtype="float32", layers=2, **f32,
         peak_memory_GB=torch.cuda.max_memory_allocated() / 1e9, ok=True)
    del params32
    torch.cuda.empty_cache()
    return launches, ragged


def lru_scan_cost(a) -> dict:
    """Least time for one scan: a and b read once, y written once, h0
    read and h_last written once (float32), or one multiply and one add
    per element at the float32 rate outside the tensor cores."""
    B, S, W = a.shape
    n_bytes = 4 * (3 * B * S * W + 2 * B * W)
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = 2 * B * S * W / PEAK_FP32_PER_S
    return {"bytes": n_bytes, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_lru_scan(gen) -> dict:
    """The RG-LRU scan against its plain version: y and h_last bit for
    bit equal to it (and so within LRU_TOL), two kernel runs the same
    bits, with each shape's plan: at tests/test_kernels.py's edge shapes,
    ragged widths and lengths, then (timed) recurrentgemma-2b prefill's
    (4, 1024, 2560) and (a check row) its window wave's (1, 2304, 2560),
    all with a random h0."""
    from repro_torch.kernels import rg_lru

    dev = torch.device("cuda")
    shapes = [("edge", 1, 16, 32), ("edge", 2, 75, 96), ("edge", 3, 128, 64),
              ("edge", 1, 200, 48), ("ragged", 3, 40, 1),
              ("ragged", 2, 70, 33), ("ragged", 2, 90, 2576),
              ("ragged", 2, 1, 96), ("ragged", 2, 31, 96),
              ("ragged", 2, 33, 96), ("ragged", 2, 1025, 160),
              ("prefill", SERVE_BATCH, SERVE_PROMPT, 2560),
              ("window", 1, HYBRID_WINDOW_PROMPT, 2560)]
    results = {}
    for case, B, S, W in shapes:
        a = torch.empty(B, S, W, device=dev).uniform_(0.4, 0.999,
                                                      generator=gen)
        b = torch.randn(B, S, W, device=dev, generator=gen)
        h0 = torch.randn(B, W, device=dev, generator=gen)
        y, h = rg_lru.lru_scan(a, b, h0)
        y2, h2 = rg_lru.lru_scan(a, b, h0)
        wy, wh = rg_lru.lru_scan_ref(a, b, h0)
        err = max(check_close("lru_scan", y, y2, wy, LRU_TOL,
                              f"y {(B, S, W)}"),
                  check_close("lru_scan", h, h2, wh, LRU_TOL,
                              f"h_last {(B, S, W)}"))
        if not (torch.equal(y, wy) and torch.equal(h, wh)):
            raise AssertionError(f"lru_scan {(B, S, W)}: not bit for bit "
                                 "equal to lru_scan_ref")
        if not torch.equal(h, y[:, -1]):
            raise AssertionError(f"lru_scan {(B, S, W)}: h_last != y[:, -1]")
        ops = rg_lru.ops
        line = {"kernel": "lru_scan", "case": case, "shape": [B, S, W],
                "plan": {"threads": ops.THREADS, "stages": ops.STAGES,
                         "steps": ops.STEPS, "vec": ops.call_plan(a, b)},
                "blocks": math.prod(ops.grid(B, W)),
                "shared_bytes": ops.SHARED_BYTES, "tolerance": LRU_TOL,
                "bitwise_equal_to_plain": True}
        if case in ("edge", "ragged"):
            emit("hybrid_serve", **line, max_abs_err=err, ok=True)
            continue

        def call():
            rg_lru.lru_scan(a, b, h0)

        cost = lru_scan_cost(a)
        dev_ms = device_time(call, "lru_scan_kernel")["ms"]
        timed = {"kernel_device_ms": dev_ms, "kernel_graph_ms": graph_ms(call),
                 "device_GBps": (cost["bytes"] / (dev_ms * 1e-3) / 1e9
                                 if dev_ms else None),
                 "bound_share_by_device_ms": (cost["bound_ms"] / dev_ms
                                              if dev_ms else None)}
        if case == "window":
            emit("hybrid_serve", **line, max_abs_err=err, **timed,
                 ms=time_ms(call), **cost, note="a check shape, not timed "
                 "on the main path", ok=True)
            continue
        row = {"max_abs_err": err, "ms": time_ms(call),
               "plain_ms": time_ms(lambda: rg_lru.lru_scan_ref(a, b, h0),
                                   reps=2, samples=3),
               "library_ms": None, **cost}
        results["lru_scan"] = row
        emit("hybrid_serve", **line, **row, **timed,
             library="none: no PyTorch call computes a linear recurrence",
             achieved_GBps=row["bytes"] / (row["ms"] * 1e-3) / 1e9, ok=True)
    return results


def phase_hybrid_serve(card: str) -> "tuple[dict, dict]":
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rg_lru
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.registry import get_config, get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg = get_config(HYBRID_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(3)

    # the kernels at the path's shapes: the scan, then RMSNorm at
    # d_model 2,560 and attention at head dim 256 (one KV head of 10
    # queries, the 2,048-token local window on every call): prefill,
    # decode over the 1,057-slot ring, the window wave's 2,304-token
    # prefill with the window binding, and its last decode step over the
    # wrapped ring of 2,048 slots
    results = check_lru_scan(gen)
    rows = SERVE_BATCH * SERVE_PROMPT
    results.update(check_rmsnorm_path("hybrid_serve", [
        (HYBRID_ARCH, cfg.d_model, rows),
        (HYBRID_ARCH, cfg.d_model, SERVE_BATCH)], gen))
    arange, at = positions_range, position_at
    S, win = SERVE_PROMPT, cfg.local_window
    K, G, Dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.resolved_head_dim
    last = HYBRID_WINDOW_PROMPT + WINDOW_NEW - 1
    results.update(check_attention_path("hybrid_serve", [
        (HYBRID_ARCH, "prefill", SERVE_BATCH, K, G, S, arange(S), arange(S),
         win, Dh),
        (HYBRID_ARCH, "decode", SERVE_BATCH, K, G, 1, at(1039),
         ring_kv_pos(min(SERVE_MAX_LEN, win), 1040, "cuda"), win, Dh),
        (HYBRID_ARCH, "window prefill", 1, K, G, HYBRID_WINDOW_PROMPT,
         arange(HYBRID_WINDOW_PROMPT), arange(HYBRID_WINDOW_PROMPT), win,
         Dh),
        (HYBRID_ARCH, "window decode", 1, K, G, 1, at(last),
         ring_kv_pos(win, last + 1, "cuda"), win, Dh)], gen))

    kern = get_model(cfg, kernel_backend="cuda")
    plain = get_model(cfg, kernel_backend="torch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = kern.init(SERVE_SEED)
    torch.cuda.synchronize()
    emit("hybrid_serve", card=card, arch=HYBRID_ARCH, layers=cfg.n_layers,
         blocks=kern.n_blocks, params=kern.param_count(),
         param_dtype=cfg.param_dtype, weight_fill_s=time.perf_counter() - t0,
         weights_GB=torch.cuda.memory_allocated() / 1e9)

    # a short run of each path first: neither timed run pays first use
    serve_run(cfg, kern, params, 1, 64, 2)
    serve_run(cfg, plain, params, 1, 64, 2)
    for mod in (rn, fa, rg_lru):
        mod.reset_launch_counts()
    runs = {"cuda": serve_run(cfg, kern, params)}
    launches = {**rn.LAUNCHES, **fa.LAUNCHES,
                "lru_scan": rg_lru.LAUNCHES["lru_scan"]}
    runs["torch"] = serve_run(cfg, plain, params)
    emit_serve_runs("hybrid_serve", card, runs)
    # each wave: one prefill, then one decode step per new token; every
    # block has 2 RMSNorms, every attention block 1 attention (on the
    # tensor-core kernel in prefill, the decode kernel in decode), and
    # every rec block 1 scan in prefill and none in decode (one
    # rg_lru_step)
    waves = runs["cuda"][0].waves
    passes = waves * (1 + SERVE_NEW)
    want = {"rmsnorm": passes * (2 * cfg.n_layers + 1),
            "flash_attention": passes * kern.n_blocks["attn"],
            "flash_attention_tc": waves * kern.n_blocks["attn"],
            "flash_attention_decode":
                (passes - waves) * kern.n_blocks["attn"],
            "rmsnorm_backward": 0, "flash_attention_backward": 0,
            "flash_attention_backward_tc": 0,
            "lru_scan": waves * kern.n_blocks["rec"]}
    if launches != want:
        raise AssertionError(f"hybrid_serve launches {launches} != {want} "
                             f"({passes} forward passes, {waves} prefills)")
    emit("hybrid_serve", launches=launches, forward_passes=passes,
         prefill_passes=waves,
         launches_per_pass={k: v / passes for k, v in launches.items()},
         lru_scan_per_prefill=launches["lru_scan"] / waves,
         tokens_equal_to_plain_path=tokens_equal(runs),
         tokens_total=SERVE_REQUESTS * SERVE_NEW)

    prompts = torch.as_tensor(np.stack(
        [r.prompt for r in runs["cuda"][1][:SERVE_BATCH]]), device="cuda")
    bf16 = teacher_forced(kern, plain, params, prompts, SERVE_NEW,
                          SERVE_TOL["bfloat16"], f"{HYBRID_ARCH} bf16")
    emit("hybrid_serve", check="teacher-forced logits, kernels vs plain",
         dtype="bfloat16", **bf16, ok=True)

    # one request through the 2,048-token window: prefill attention with
    # the window binding, the ring holding the last 2,048 positions and
    # wrapping in decode
    window = torch.as_tensor(make_requests(cfg, 1, HYBRID_WINDOW_PROMPT,
                                           WINDOW_NEW, SERVE_SEED + 1)[0]
                             .prompt, device="cuda")[None]
    max_len = HYBRID_WINDOW_PROMPT + WINDOW_NEW + 1
    torch.cuda.reset_peak_memory_stats()
    win_gate = teacher_forced(kern, plain, params, window, WINDOW_NEW,
                              SERVE_TOL["bfloat16"],
                              f"{HYBRID_ARCH} window wave", max_len=max_len)
    emit("hybrid_serve", check="window wave: teacher-forced logits, "
         "kernels vs plain", prompt_tokens=HYBRID_WINDOW_PROMPT,
         window=cfg.local_window, cache_capacity=kern.cache_capacity(max_len),
         dtype="bfloat16", **win_gate,
         peak_memory_GB=torch.cuda.max_memory_allocated() / 1e9, ok=True)

    emit("hybrid_serve", card=card,
         **profile_decode_wave(kern, params, prompts, SERVE_MAX_LEN))
    del params
    torch.cuda.empty_cache()

    # float32 at full width, reduced to 5 of the 26 layers: the kernels
    # without bf16 rounding
    cfg32 = cfg.replace(n_layers=HYBRID_F32_LAYERS, param_dtype="float32",
                        activation_dtype="float32")
    kern32 = get_model(cfg32, kernel_backend="cuda")
    params32 = kern32.init(SERVE_SEED)
    f32 = teacher_forced(kern32, get_model(cfg32, kernel_backend="torch"),
                         params32, prompts, 8, SERVE_TOL["float32"],
                         f"{HYBRID_ARCH} {HYBRID_F32_LAYERS}-layer float32")
    emit("hybrid_serve", check="teacher-forced logits, kernels vs plain",
         dtype="float32", layers=HYBRID_F32_LAYERS,
         reduced=f"depth: {HYBRID_F32_LAYERS} of {cfg.n_layers} layers "
                 "(1 unit of (rec, rec, attn) and the 2 tail rec blocks)",
         blocks=kern32.n_blocks, **f32, ok=True)
    del params32
    torch.cuda.empty_cache()
    return launches, results


# ---------------------------------------------------------------- ssm


def check_mlstm_forms(model, gen, emit_ss) -> None:
    """One mLSTM block in float32 at the model's full width: the
    chunkwise form (the prefill's) against the sequential oracle (one
    recurrent step a token, the decode's) over SERVE_PROMPT tokens of
    SERVE_BATCH rows, outputs and final (C, n, m) each within
    MLSTM_FORM_TOL of its max |value|."""
    from repro_torch.models import xlstm

    chunk = model.cfg.hybrid.chunk_size
    p = xlstm.mlstm_init(gen, model.d_in, model.H, torch.float32, "cuda")
    x = torch.randn(SERVE_BATCH, SERVE_PROMPT, model.d_in, device="cuda",
                    generator=gen)
    (hc, sc), chunkwise_s = timed(lambda: xlstm.mlstm_chunkwise(
        p, x, model.H, chunk=chunk))
    (hs, ss), sequential_s = timed(lambda: xlstm.mlstm_sequential(
        p, x, model.H))
    rel = {}
    for name, got, want in (("h", hc, hs), *((k, sc[k], ss[k])
                                             for k in ("C", "n", "m"))):
        gap, top = logits_gap(got, want)
        rel[name] = gap / top
    if max(rel.values()) > MLSTM_FORM_TOL:
        raise AssertionError(f"mLSTM chunkwise vs sequential: {rel} of max "
                             f"|value| > {MLSTM_FORM_TOL}")
    emit_ss(check="mLSTM chunkwise vs sequential, float32",
            shape=[SERVE_BATCH, SERVE_PROMPT, model.d_in], heads=model.H,
            head_dim=model.d_in // model.H, chunk=chunk, rel_diff=rel,
            tolerance=MLSTM_FORM_TOL, chunkwise_s=chunkwise_s,
            sequential_s=sequential_s, ok=True)


def slstm_loop_share(model, params, prompts) -> dict:
    """One prefill wave with each ``slstm_sequential`` call (its input
    product and its time loop) timed between device synchronizes: the
    share of the prefill's wall it takes, and the device kernels one
    sLSTM step launches (profiled over 64 steps at the wave's batch)."""
    from repro_torch.models import xlstm

    real = xlstm.slstm_sequential
    walls = []

    def timed_slstm(*args, **kw):
        out, wall = timed(lambda: real(*args, **kw))
        walls.append(wall)
        return out

    xlstm.slstm_sequential = timed_slstm
    try:
        _, wall = timed(lambda: model.prefill(params, prompts,
                                              max_len=SERVE_MAX_LEN))
    finally:
        xlstm.slstm_sequential = real
    B, S = prompts.shape
    p = next(up[name]["slstm"] for up in params["units"] for name in up
             if name.startswith("slstm"))
    x = torch.zeros(B, 64, model.cfg.d_model, device="cuda",
                    dtype=model.adtype)
    real(p, x, model.H)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        real(p, x, model.H)
        torch.cuda.synchronize()
    kernels = sum(c for _, c, _ in device_events(prof))
    return {"prefill_wall_s": wall, "slstm_blocks": len(walls),
            "slstm_steps": len(walls) * S, "slstm_s": sum(walls),
            "slstm_share_of_prefill": sum(walls) / wall,
            "slstm_us_per_step": sum(walls) / (len(walls) * S) * 1e6,
            "device_kernels_per_step_64": kernels / 64}


def check_serve_cli(emit_ss) -> None:
    """``python -m repro_torch.launch.serve --arch xlstm-125m`` at its
    defaults on the card: exit 0 and every requested token out."""
    import re

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--arch", SSM_ARCH], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=600)
    found = re.search(r"\| (\d+) tokens \|", proc.stdout)
    tokens = int(found.group(1)) if found else None
    ok = proc.returncode == 0 and tokens == 8 * 16
    emit_ss(check="launch.serve CLI --arch " + SSM_ARCH,
            returncode=proc.returncode, tokens_out=tokens,
            stdout=proc.stdout.strip().splitlines()[-2:],
            wall_s=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError(f"serve CLI: rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")


def phase_ssm_serve(card: str) -> dict:
    """xlstm-125m uncut serves yi-9b's traffic through the RMSNorm kernel
    (the only kernel on its path), then on the plain path."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import rg_lru
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import segment_fairshare as sf
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.registry import get_config, get_model

    t_phase = time.perf_counter()

    def emit_ss(**fields):
        emit("ssm_serve", phase_s=time.perf_counter() - t_phase, **fields)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg = get_config(SSM_ARCH)
    kern = get_model(cfg, kernel_backend="cuda")
    plain = get_model(cfg, kernel_backend="torch")
    gen = torch.Generator(device="cuda").manual_seed(4)

    # RMSNorm at the path's shapes: d_model 768 (narrow) and the mLSTM's
    # out_norm width 1,536 (register), prefill rows and decode rows
    rows = SERVE_BATCH * SERVE_PROMPT
    check_rmsnorm_path("ssm_serve", [
        (SSM_ARCH, cfg.d_model, rows), (SSM_ARCH, kern.d_in, rows),
        (SSM_ARCH, cfg.d_model, SERVE_BATCH),
        (SSM_ARCH, kern.d_in, SERVE_BATCH)], gen, t_phase)
    check_mlstm_forms(kern, gen, emit_ss)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = kern.init(SERVE_SEED)
    torch.cuda.synchronize()
    emit_ss(card=card, arch=SSM_ARCH, layers=cfg.n_layers,
            unit=list(kern.unit), units=kern.n_units, tail=list(kern.tail),
            d_model=cfg.d_model, d_in=kern.d_in, heads=kern.H,
            chunk=cfg.hybrid.chunk_size, params=kern.param_count(),
            param_dtype=cfg.param_dtype,
            weight_fill_s=time.perf_counter() - t0,
            weights_GB=torch.cuda.memory_allocated() / 1e9,
            reduced="none: full width and all 12 layers")

    # a short run of each path first: neither timed run pays first use
    serve_run(cfg, kern, params, 1, 64, 2)
    serve_run(cfg, plain, params, 1, 64, 2)
    mods = (rn, fa, gm, rg_lru, sf)
    for mod in mods:
        mod.reset_launch_counts()
    runs = {"cuda": serve_run(cfg, kern, params)}
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    runs["torch"] = serve_run(cfg, plain, params)
    emit_serve_runs("ssm_serve", card, runs,
                    phase_s=time.perf_counter() - t_phase)
    # each wave: one prefill, then one decode step per new token; every
    # block has 2 RMSNorms, and the final norm 1; no other kernel
    waves = runs["cuda"][0].waves
    passes = waves * (1 + SERVE_NEW)
    want = dict.fromkeys(launches, 0)
    want["rmsnorm"] = passes * (2 * cfg.n_layers + 1)
    if launches != want:
        raise AssertionError(f"ssm_serve launches {launches} != {want} "
                             f"({passes} forward passes, {waves} prefills)")
    emit_ss(launches=launches, forward_passes=passes, prefill_passes=waves,
            rmsnorm_per_pass=launches["rmsnorm"] / passes,
            tokens_equal_to_plain_path=tokens_equal(runs),
            tokens_total=SERVE_REQUESTS * SERVE_NEW)

    prompts = torch.as_tensor(np.stack(
        [r.prompt for r in runs["cuda"][1][:SERVE_BATCH]]), device="cuda")
    emit_ss(check="sLSTM time loop in a prefill wave",
            **slstm_loop_share(kern, params, prompts))
    bf16 = teacher_forced(kern, plain, params, prompts, SERVE_NEW,
                          SERVE_TOL["bfloat16"], f"{SSM_ARCH} bf16")
    emit_ss(check="teacher-forced logits, kernels vs plain",
            dtype="bfloat16", **bf16, ok=True)

    # a prompt that is no multiple of the 256-token chunk: each mLSTM
    # block's chunkwise form pads its last chunk
    padded = torch.as_tensor(make_requests(cfg, 1, SSM_PADDED_PROMPT,
                                           WINDOW_NEW, SERVE_SEED + 1)[0]
                             .prompt, device="cuda")[None]
    pad_gate = teacher_forced(kern, plain, params, padded, WINDOW_NEW,
                              SERVE_TOL["bfloat16"],
                              f"{SSM_ARCH} padded chunk",
                              max_len=SSM_PADDED_PROMPT + WINDOW_NEW + 1)
    emit_ss(check="padded last chunk: teacher-forced logits, kernels vs "
            "plain", prompt_tokens=SSM_PADDED_PROMPT,
            chunk=cfg.hybrid.chunk_size,
            padded_steps=-SSM_PADDED_PROMPT % cfg.hybrid.chunk_size,
            dtype="bfloat16", **pad_gate, ok=True)

    emit_ss(card=card,
            **profile_decode_wave(kern, params, prompts, SERVE_MAX_LEN))
    del params
    torch.cuda.empty_cache()

    # float32 at full width and depth: the kernel without bf16 rounding
    cfg32 = cfg.replace(param_dtype="float32", activation_dtype="float32")
    kern32 = get_model(cfg32, kernel_backend="cuda")
    params32 = kern32.init(SERVE_SEED)
    f32 = teacher_forced(kern32, get_model(cfg32, kernel_backend="torch"),
                         params32, prompts, 8, SERVE_TOL["float32"],
                         f"{SSM_ARCH} float32")
    emit_ss(check="teacher-forced logits, kernels vs plain",
            dtype="float32", layers=cfg32.n_layers, reduced="none",
            **f32, ok=True)
    del params32
    torch.cuda.empty_cache()
    check_serve_cli(emit_ss)
    return launches


# ---------------------------------------------------------------- audio


def audio_inputs(cfg, gen) -> "tuple[torch.Tensor, torch.Tensor]":
    """AUDIO_REQUESTS prompts of AUDIO_PROMPT random tokens (numpy, from
    SERVE_SEED) on the card, and their frames (AUDIO_REQUESTS,
    AUDIO_FRAMES, d_model), 0.1 x N(0, 1) in float32 drawn on the card
    from ``gen`` (the encoder casts them to its activation dtype)."""
    from repro_torch.launch.serve import make_requests

    reqs = make_requests(cfg, AUDIO_REQUESTS, AUDIO_PROMPT, AUDIO_NEW,
                         SERVE_SEED)
    prompts = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                              dtype=torch.int64, device="cuda")
    frames = torch.randn(AUDIO_REQUESTS, AUDIO_FRAMES, cfg.d_model,
                         device="cuda", generator=gen).mul_(0.1)
    return prompts, frames


def audio_serve_run(model, params, prompts, frames, new: int = AUDIO_NEW):
    """The requests in waves of AUDIO_BATCH, each as ``ServeEngine`` runs
    a wave: a prefill (the encoder and the decoder prompt), then ``new``
    decode steps, each step's greedy tokens read by the host.  Returns
    (tokens (requests, new) numpy, prefill s, decode s, waves, peak
    device bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, prefill_s, decode_s = [], 0.0, 0.0
    for i in range(0, prompts.shape[0], AUDIO_BATCH):
        wave, wave_frames = prompts[i:i + AUDIO_BATCH], \
            frames[i:i + AUDIO_BATCH]
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, wave, wave_frames,
                                       max_len=wave.shape[1] + new + 1)
        torch.cuda.synchronize()
        prefill_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        toks = []
        for _ in range(new):
            tok = torch.argmax(logits, dim=-1)[:, None]
            toks.append(tok[:, 0].cpu().numpy())
            logits, caches = model.decode_step(params, tok, caches)
        torch.cuda.synchronize()
        decode_s += time.perf_counter() - t0
        out.append(np.stack(toks, axis=1))
    return np.concatenate(out), prefill_s, decode_s, len(out), \
        torch.cuda.max_memory_allocated()


def phase_audio_serve(card: str) -> "tuple[dict, dict]":
    """whisper-small uncut serves 8 requests of 1,500 frames through the
    attention kernel (the only kernel on its path), then on the plain
    path.  Returns the launch counts of the kernel run and attention's
    rows at the path's shapes."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import rg_lru
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import segment_fairshare as sf
    from repro_torch.models.registry import get_config, get_model

    t_phase = time.perf_counter()

    def emit_as(**fields):
        emit("audio_serve", phase_s=time.perf_counter() - t_phase, **fields)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg = get_config(AUDIO_ARCH)
    kern = get_model(cfg, kernel_backend="cuda")
    plain = get_model(cfg, kernel_backend="torch")
    gen = torch.Generator(device="cuda").manual_seed(5)
    n_enc, n_dec = cfg.encdec.n_encoder_layers, cfg.n_layers

    # attention at the path's shapes, a wave of 4, 12 heads of 64 (G = 1):
    # non-causal, timed, the encoder's self-attention over 1,500 frames,
    # the prompt's cross-attention and the last decode step's; causal, the
    # prompt's self-attention and the last decode step's over its ring
    # (one slot still empty)
    arange, at = positions_range, position_at
    B, S, T = AUDIO_BATCH, AUDIO_PROMPT, AUDIO_FRAMES
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    last = S + AUDIO_NEW - 1
    rows = {}
    check_attention_path("audio_serve", [
        (AUDIO_ARCH, "encoder", B, H, 1, T, arange(T), arange(T), None, Dh),
        (AUDIO_ARCH, "cross prefill", B, H, 1, S, arange(S), arange(T), None,
         Dh),
        (AUDIO_ARCH, "decode cross", B, H, 1, 1, at(last), arange(T), None,
         Dh)], gen, causal=False, t_phase=t_phase, graph_calls=20, rows=rows)
    check_attention_path("audio_serve", [
        (AUDIO_ARCH, "decoder self prefill", B, H, 1, S, arange(S), arange(S),
         None, Dh),
        (AUDIO_ARCH, "decode self", B, H, 1, 1, at(last),
         ring_kv_pos(AUDIO_MAX_LEN, last + 1, "cuda"), None, Dh)], gen,
        t_phase=t_phase, graph_calls=20)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = kern.init(SERVE_SEED)
    torch.cuda.synchronize()
    emit_as(card=card, arch=AUDIO_ARCH, encoder_layers=n_enc,
            decoder_layers=n_dec, d_model=cfg.d_model, heads=H,
            head_dim=Dh, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
            params=kern.param_count(), param_dtype=cfg.param_dtype,
            weight_fill_s=time.perf_counter() - t0,
            weights_GB=torch.cuda.memory_allocated() / 1e9,
            reduced="none: full width, all 12 encoder and 12 decoder layers")
    prompts, frames = audio_inputs(cfg, gen)
    wave, wave_frames = prompts[:B], frames[:B]

    # a short run of each path first: neither timed run pays first use
    audio_serve_run(kern, params, wave, wave_frames, 2)
    audio_serve_run(plain, params, wave, wave_frames, 2)
    encoder_s = {backend: sorted(timed(lambda m=m: m.encode(
        params, wave_frames))[1] for _ in range(5))
        for backend, m in (("cuda", kern), ("torch", plain))}
    mods = (rn, fa, gm, rg_lru, sf)
    for mod in mods:
        mod.reset_launch_counts()
    runs = {"cuda": audio_serve_run(kern, params, prompts, frames)}
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    runs["torch"] = audio_serve_run(plain, params, prompts, frames)
    for backend, (_, prefill_s, decode_s, waves, peak) in runs.items():
        emit_as(card=card, kernel_backend=backend, requests=AUDIO_REQUESTS,
                frames=T, prompt_tokens=S, new_tokens=AUDIO_NEW,
                max_batch=B, waves=waves, prefill_s=prefill_s,
                decode_s=decode_s,
                decode_tok_per_s=AUDIO_REQUESTS * AUDIO_NEW / decode_s,
                prefill_tok_per_s=AUDIO_REQUESTS * S / prefill_s,
                prefill_frames_per_s=AUDIO_REQUESTS * T / prefill_s,
                encoder_pass_s=encoder_s[backend][2],
                encoder_pass_s_min_max=[encoder_s[backend][0],
                                        encoder_s[backend][-1]],
                peak_memory_GB=peak / 1e9)
    # each wave: one prefill (the encoder's 12 self-attentions, the
    # decoder's 12 self- and 12 cross-attentions, all on the tensor cores),
    # then AUDIO_NEW decode steps of 24 on the decode route; no other kernel
    waves = runs["cuda"][3]
    want = dict.fromkeys(launches, 0)
    want["flash_attention_tc"] = waves * (n_enc + 2 * n_dec)
    want["flash_attention_decode"] = waves * AUDIO_NEW * 2 * n_dec
    want["flash_attention"] = want["flash_attention_tc"] + \
        want["flash_attention_decode"]
    if launches != want:
        raise AssertionError(f"audio_serve launches {launches} != {want} "
                             f"({waves} waves)")
    tokens_equal = int((runs["cuda"][0] == runs["torch"][0]).sum())
    emit_as(launches=launches, prefill_passes=waves,
            decode_passes=waves * AUDIO_NEW,
            tc_per_prefill=want["flash_attention_tc"] / waves,
            decode_per_step=2 * n_dec, dtype="bfloat16",
            tokens_equal_to_plain_path=tokens_equal,
            tokens_total=AUDIO_REQUESTS * AUDIO_NEW)

    bf16 = teacher_forced(kern, plain, params, wave, AUDIO_NEW,
                          SERVE_TOL["bfloat16"], f"{AUDIO_ARCH} bf16",
                          max_len=AUDIO_MAX_LEN, frames=wave_frames)
    emit_as(check="teacher-forced logits, kernels vs plain",
            dtype="bfloat16", **bf16, ok=True)
    emit_as(card=card, **profile_decode_wave(kern, params, wave,
                                             AUDIO_MAX_LEN, steps=AUDIO_NEW,
                                             frames=wave_frames))
    del params
    torch.cuda.empty_cache()

    # float32 uncut: the kernel without bf16 rounding, teacher-forced and
    # then free greedy (one wave each path: every token equal)
    cfg32 = cfg.replace(param_dtype="float32", activation_dtype="float32")
    kern32 = get_model(cfg32, kernel_backend="cuda")
    plain32 = get_model(cfg32, kernel_backend="torch")
    params32 = kern32.init(SERVE_SEED)
    f32 = teacher_forced(kern32, plain32, params32, wave, 8,
                         SERVE_TOL["float32"], f"{AUDIO_ARCH} float32",
                         max_len=AUDIO_MAX_LEN, frames=wave_frames)
    greedy = [audio_serve_run(m, params32, wave, wave_frames)[0]
              for m in (kern32, plain32)]
    equal32 = int((greedy[0] == greedy[1]).sum())
    if equal32 != greedy[1].size:
        raise AssertionError(f"{AUDIO_ARCH} float32: {equal32} of "
                             f"{greedy[1].size} greedy tokens equal")
    emit_as(check="teacher-forced logits, kernels vs plain",
            dtype="float32", weights_GB=kern32.param_count() * 4 / 1e9,
            reduced="none", **f32, greedy_tokens_equal=equal32,
            greedy_tokens_total=greedy[1].size, ok=True)
    del params32
    torch.cuda.empty_cache()
    return launches, rows


# ---------------------------------------------------------------- train


def train_batches(cfg, steps: int) -> list:
    """The cell's ``steps`` host batches: the reference's lcg stream
    (numpy, seed TRAIN_SEED), made once."""
    from repro_torch.data.pipeline import DataConfig, SyntheticDataset

    ds = SyntheticDataset(DataConfig(kind="lcg", vocab_size=cfg.vocab_size,
                                     seq_len=TRAIN_SEQ,
                                     global_batch=TRAIN_BATCH,
                                     seed=TRAIN_SEED))
    return [ds.batch(i) for i in range(steps)]


def train_launches() -> dict:
    """The launch counts of the kernels a train step runs."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    return {**rn.LAUNCHES, **fa.LAUNCHES}


def reset_train_launches() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    rn.reset_launch_counts()
    fa.reset_launch_counts()


def host_leaves(tree) -> list:
    from repro_torch.models.layers import tree_leaves

    return [t.detach().cpu() for t in tree_leaves(tree)]


def leaf_gap(host: list, tree) -> float:
    """max over leaves of max |host - tree| / max |tree|, leaf by leaf on
    the device (``host`` the leaves of another run, on the host)."""
    from repro_torch.models.layers import tree_leaves

    worst = 0.0
    for h, t in zip(host, tree_leaves(tree), strict=True):
        w = t.float()
        gap = float((h.to(t.device).float() - w).abs().max())
        top = float(w.abs().max())
        worst = max(worst, gap / top if top > 0 else
                    (0.0 if gap == 0 else math.inf))
    return worst


def same_leaves(host: list, tree) -> bool:
    from repro_torch.models.layers import tree_leaves

    return all(torch.equal(h.to(t.device), t)
               for h, t in zip(host, tree_leaves(tree), strict=True))


def update_gap(host: list, tree, init) -> float:
    """max over leaves of ||host - tree|| / ||tree - init|| (L2 norms):
    how far another run's parameters after the steps (``host``, on the
    host) lie from ``tree``'s, in units of ``tree``'s own update from
    ``init``, leaf by leaf on the device."""
    from repro_torch.models.layers import tree_leaves

    worst = 0.0
    for h, t, t0 in zip(host, tree_leaves(tree), tree_leaves(init),
                        strict=True):
        w = t.float()
        gap = float(torch.linalg.vector_norm(h.to(t.device).float() - w))
        moved = float(torch.linalg.vector_norm(w - t0.float()))
        worst = max(worst, gap / moved if moved > 0 else
                    (0.0 if gap == 0 else math.inf))
    return worst


def train_run(trainer, batches: list) -> dict:
    """TRAIN_STEPS steps from ``init_state(TRAIN_SEED)``: each step's loss
    and wall (ending in a device synchronize), the peak device memory and
    the launch counts of that run alone; the final state under
    ``state``."""
    state = trainer.init_state(TRAIN_SEED)
    step_fn = trainer.make_train_step()
    dev = [trainer.device_batch(b) for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_launches()
    losses, walls = [], []
    for b in dev:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite train losses {losses}")
    step_wall = statistics.median(walls[1:])
    return {"state": state, "losses": losses, "step_walls_s": walls,
            "step_wall_s": step_wall,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_wall,
            "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9,
            "launches": train_launches()}


def profile_train_step(trainer, state, batch) -> dict:
    """Where the time goes in one more train step of ``state``: its wall,
    the device's busy ms and idle share, the kernels' device ms and the
    ten longest device ops."""
    step_fn = trainer.make_train_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    busy_ms = sum(t for _, _, t in events) / 1e3

    def ms(key):
        return sum(t for n, _, t in events if key in n) / 1e3

    return {"profiled": "one train step", "wall_s": wall,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
            "attention_backward_device_ms": ms("attn_bwd"),
            "attention_backward_pass_device_ms": {
                n[:60]: t / 1e3 for n, _, t in events if "attn_bwd" in n},
            "attention_forward_device_ms": ms("flash_attention_kernel"),
            "rmsnorm_backward_device_ms": ms("rmsnorm_backward"),
            "rmsnorm_forward_device_ms": ms("rmsnorm_row_kernel"),
            "top_device_ops": [{"name": n[:80], "count": c, "ms": t / 1e3}
                               for n, c, t in events[:10]]}


def grads_of(trainer, params, batch) -> "tuple[float, list]":
    """The step-1 loss and gradients (host copies) of ``trainer``'s path."""
    loss, _, grads = trainer._grads(params, batch)
    out = float(loss), host_leaves(grads)
    del grads
    return out


def check_gradients(where: str, trainer, params, batch, want_loss: float,
                    want: list, dtype: str, **fields) -> None:
    """``trainer``'s step-1 loss and gradients against another path's:
    the loss within TRAIN_LOSS_TOL relative, each leaf within
    TRAIN_GRAD_TOL of its max |g|."""
    loss, _, grads = trainer._grads(params, batch)
    gap = leaf_gap(want, grads)
    del grads
    loss_gap = abs(float(loss) - want_loss) / abs(want_loss)
    ok = loss_gap <= TRAIN_LOSS_TOL[dtype] and gap <= TRAIN_GRAD_TOL[dtype]
    emit("train", check=where, dtype=dtype, loss=float(loss),
         reference_loss=want_loss, loss_rel_gap=loss_gap,
         loss_tolerance=TRAIN_LOSS_TOL[dtype], grad_leaf_max_rel_gap=gap,
         grad_tolerance=TRAIN_GRAD_TOL[dtype], **fields, ok=ok)
    if not ok:
        raise AssertionError(f"train {where}: loss gap {loss_gap}, gradient "
                             f"gap {gap} beyond the {dtype} tolerances")


def check_backward(name: str, got, again, want, tol: float,
                   where: str) -> float:
    """A backward kernel's gradients against the plain version's: each
    within ``tol`` of its max |plain|, finite, two runs the same bits.
    Returns the largest max abs error."""
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name} {where}: two runs differ")
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name} {where}: {tuple(g.shape)} {g.dtype}"
                                 f" != {tuple(w.shape)} {w.dtype}")
        gf, wf = g.float(), w.float()
        if not bool(torch.isfinite(gf).all()):
            raise AssertionError(f"{name} {where}: non-finite gradient")
        err = float((gf - wf).abs().max())
        top = float(wf.abs().max())
        if err > tol * top:
            raise AssertionError(f"{name} {where}: max abs err {err} beyond "
                                 f"{tol} of max |plain| {top}")
        worst = max(worst, err)
    return worst


def rmsnorm_backward_cost(x) -> dict:
    """Least time for one RMSNorm backward: x and dy read once, dx written
    once (scale and dscale besides), or ~10 float32 operations an element
    outside the tensor cores."""
    n, d = x.shape
    elt = x.element_size()
    n_bytes = 3 * n * d * elt + 2 * d * elt
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, 10 * n * d / PEAK_FP32_PER_S
    return {"bytes": n_bytes, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def attention_backward_cost(q, k, q_pos, kv_pos, causal, window) -> dict:
    """Least time for one attention backward: q, o, dO, dq read or written
    once and the attended keys' k, v, dk, dv, or the five products of
    2*Dh operations per attended (query head, key) pair (S and dP
    recomputed, dV, dK, dQ) on the bf16 tensor cores (float32 outside
    them)."""
    from repro_torch.kernels.flash_attention import attention_mask

    B, Sq, K, G, Dh = q.shape
    mask = attention_mask(q_pos, kv_pos, causal, window)
    pairs = int(mask.sum())
    keys = int(mask.any(dim=0).sum())
    elt = q.element_size()
    n_bytes = 4 * q.numel() * elt + 4 * B * keys * K * Dh * elt
    ops = 5 * 2 * Dh * B * K * G * pairs
    peak = PEAK_BF16_PER_S if q.dtype == torch.bfloat16 else PEAK_FP32_PER_S
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / peak
    return {"bytes": n_bytes, "flops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_rmsnorm_backward(t_phase: float) -> dict:
    """RMSNorm's backward kernel against its plain version: edge shapes
    (narrow, unaligned, wider than shared memory holds) at 2e-5 / 2e-2,
    then the cell's (8,192, 4,096) in float32 and bfloat16 (timed beside
    ``F.rms_norm``'s backward)."""
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    n_cell, d_cell = TRAIN_BATCH * TRAIN_SEQ, 4096
    for n, d in [(37, 128), (5, 13), (4097, 2560), (3, 16384),
                 (n_cell, d_cell)]:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(n, d, device=dev, generator=gen).to(dt)
            s = torch.randn(d, device=dev, generator=gen).to(dt)
            dy = torch.randn(n, d, device=dev, generator=gen).to(dt)
            err = check_backward(
                "rmsnorm_backward", rn.rmsnorm_backward(x, s, dy),
                rn.rmsnorm_backward(x, s, dy),
                rn.rmsnorm_backward_ref(x, s, dy), tol[dt], f"({n}, {d}) {dt}")
            emit("train", kernel="rmsnorm_backward", shape=[n, d],
                 dtype=str(dt), max_abs_err=err, tolerance=tol[dt], ok=True)
    # x, s, dy: the cell's bf16 inputs

    def call():
        rn.rmsnorm_backward(x, s, dy)

    xl, sl = (t.detach().requires_grad_(True) for t in (x, s))
    y = F.rms_norm(xl, (d_cell,), weight=sl, eps=1e-6)

    def lib_call():
        torch.autograd.grad(y, (xl, sl), dy, retain_graph=True)

    row = {"max_abs_err": err, "ms": time_ms(call),
           "plain_ms": time_ms(lambda: rn.rmsnorm_backward_ref(x, s, dy)),
           "library_ms": time_ms(lib_call), **rmsnorm_backward_cost(x)}
    emit("train", kernel="rmsnorm_backward", case="cell",
         shape=[n_cell, d_cell], dtype="bfloat16", **row,
         library="torch.nn.functional.rms_norm backward",
         kernel_device_ms=device_time(call, "rmsnorm_backward")["ms"],
         library_device_ms=device_time(lib_call, "")["ms"],
         achieved_GBps=row["bytes"] / (row["ms"] * 1e-3) / 1e9,
         phase_s=time.perf_counter() - t_phase, ok=True)
    del x, s, dy, xl, sl, y
    return row


def pass_device_ms(fn, key: str, reps: int) -> dict:
    """Each kernel name containing ``key`` that ``fn`` runs: its device ms
    a run, the mean over the runs the profiler recorded (``reps`` calls),
    and the runs recorded."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {n[:80]: {"ms": t / c / 1e3, "runs": c}
            for n, c, t in device_events(prof) if key in n}


def check_forward_lse(t_phase: float) -> None:
    """The LSE the forward saves for the backward: the ``tc`` route at the
    train cell and at head dim 256 with a window, the ``simt`` route in
    float32, against ``attention_lse_ref`` within 1e-5 (relative, or
    absolute below 1); the output bit for bit that of a call without it;
    the decode route writes none."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(13)
    cases = [  # name, B, Sq, Skv, K, G, Dh, window, dtype
        ("cell", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 4, 8, 128, None,
         torch.bfloat16),
        ("window-g1-dh256", 1, 300, 300, 2, 1, 256, 64, torch.bfloat16),
        ("causal-g4-dh64", 1, 256, 256, 2, 4, 64, None, torch.float32),
        ("decode", 2, 1, 300, 4, 8, 128, None, torch.bfloat16)]
    for name, B, S, Skv, K, G, Dh, window, dt in cases:
        q, k, v = attention_inputs(gen, B, S, K, G, Skv, Dh, dt)
        kv_pos = positions_range(Skv)
        q_pos = kv_pos[Skv - S:]
        kw = dict(causal=True, window=window)
        out = fa.flash_attention(q, k, v, q_pos, kv_pos, **kw)
        got, lse = fa.flash_attention_with_lse(q, k, v, q_pos, kv_pos, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, got):
            raise AssertionError(f"forward lse {name}: the output moved")
        route = fa.ops._route(dt, S)
        gap = None
        if route == "decode":
            if lse is not None:
                raise AssertionError("forward lse: the decode route wrote one")
        else:
            want = fa.attention_lse_ref(q, k, q_pos, kv_pos, **kw)
            rel = (lse - want).abs() / want.abs().clamp_min(1.0)
            gap = float(rel.max())
            del want, rel
            if not gap <= 1e-5:
                raise AssertionError(f"forward lse {name}: {gap} of the "
                                     "plain LSE away")
        emit("train", check="forward lse", case=name, q=list(q.shape),
             dtype=str(dt), kernel_route=route, lse_max_rel_gap=gap,
             tolerance=1e-5, output_bits_equal=True,
             phase_s=time.perf_counter() - t_phase, ok=True)
        del q, k, v, out, got, lse
    torch.cuda.empty_cache()


def check_attention_backward(t_phase: float) -> dict:
    """Attention's backward kernels against their plain version: causal, a
    binding window, G 1 and 8, Dh 64, 128 and 256, float32 (CUDA cores)
    at 2e-5 and bfloat16 (tensor cores) at 2e-2 of each gradient's max,
    each with the forward's saved LSE and without it; then the cell's
    q (2, 4,096, 4, 8, 128) causal bf16, the train path's call (with the
    LSE) timed beside SDPA's backward, with each pass's device ms, and
    without the LSE."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    cases = [  # name, B, S, K, G, Dh, window
        ("causal-g8-dh128", 1, 512, 4, 8, 128, None),
        ("window-g8-dh128", 1, 1024, 2, 8, 128, 256),
        ("causal-g1-dh64", 2, 384, 8, 1, 64, None),
        ("window-g1-dh256", 1, 300, 2, 1, 256, 64),
        ("causal-g4-dh256", 1, 256, 2, 4, 256, None),
        ("cell", TRAIN_BATCH, TRAIN_SEQ, 4, 8, 128, None)]
    for name, B, S, K, G, Dh, window in cases:
        for dt in ((torch.bfloat16,) if name == "cell"
                   else (torch.float32, torch.bfloat16)):
            q, k, v = attention_inputs(gen, B, S, K, G, S, Dh, dt)
            do = torch.randn(q.shape, device=dev, generator=gen).to(dt)
            pos = positions_range(S)
            kw = dict(causal=True, window=window)
            with torch.no_grad():
                o, lse = fa.flash_attention_with_lse(q, k, v, pos, pos, **kw)
            args = (q, k, v, o, do, pos, pos)
            want = fa.attention_backward_ref(*args, **kw)
            for saved in (None, lse):
                fa.reset_launch_counts()
                err = check_backward(
                    "flash_attention_backward",
                    fa.flash_attention_backward(*args, **kw, lse=saved),
                    fa.flash_attention_backward(*args, **kw, lse=saved),
                    want, tol[dt],
                    f"{name} {dt} {'with' if saved is not None else 'no'} "
                    "lse")
                route = fa.ops._backward_route(dt)
                if fa.LAUNCHES["flash_attention_backward_tc"] != \
                        (2 if route == "tc" else 0):
                    raise AssertionError(f"attention backward {name}: "
                                         f"launches {fa.LAUNCHES}")
                emit("train", kernel="flash_attention_backward", case=name,
                     q=list(q.shape), window=window, dtype=str(dt),
                     kernel_route=route, with_lse=saved is not None,
                     max_abs_err=err, tolerance=tol[dt], ok=True)
            del want
            torch.cuda.empty_cache()
    # q, k, v, o, lse, do: the cell's bf16 inputs; err: with the LSE

    def call():
        fa.flash_attention_backward(*args, causal=True, lse=lse)

    def call_without_lse():
        fa.flash_attention_backward(*args, causal=True)

    qs = q.reshape(B, S, K * G, Dh).transpose(1, 2).detach()
    ks, vs = (t.transpose(1, 2).detach() for t in (k, v))
    leaves = [t.requires_grad_(True) for t in (qs, ks, vs)]
    y = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                       enable_gqa=True)
    dy = do.reshape(B, S, K * G, Dh).transpose(1, 2)

    def lib_call():
        torch.autograd.grad(y, leaves, dy, retain_graph=True)

    row = {"max_abs_err": err, "ms": time_ms(call, reps=5, samples=5),
           "plain_ms": time_ms(lambda: fa.attention_backward_ref(
               *args, causal=True), reps=1, samples=3),
           "library_ms": time_ms(lib_call, reps=5, samples=3),
           **attention_backward_cost(q, k, pos, pos, True, None)}
    kern_dev = device_time(call, "attn_bwd", reps=5)
    emit("train", kernel="flash_attention_backward", case="cell",
         q=list(q.shape), kv=list(k.shape), dtype="bfloat16",
         kernel_route=fa.ops._backward_route(q.dtype), with_lse=True, **row,
         library="scaled_dot_product_attention(is_causal=True, "
                 "enable_gqa=True) backward",
         kernel_device_ms=kern_dev["ms"],
         kernel_device_runs_recorded=kern_dev["recorded"],
         pass_device_ms=pass_device_ms(call, "attn_bwd", reps=5),
         ms_without_lse=time_ms(call_without_lse, reps=5, samples=3),
         pass_device_ms_without_lse=pass_device_ms(call_without_lse, "",
                                                   reps=5),
         library_device_ms=device_time(lib_call, "", reps=5)["ms"],
         achieved_TFLOPs=row["flops"] / (row["ms"] * 1e-3) / 1e12,
         bound_TFLOPs=row["flops"] / (row["bound_ms"] * 1e-3) / 1e12,
         ms_over_bound=row["ms"] / row["bound_ms"],
         phase_s=time.perf_counter() - t_phase, ok=True)
    del q, k, v, o, lse, do, args, qs, ks, vs, leaves, y, dy
    torch.cuda.empty_cache()
    return row


def check_checkpoint_round_trip(t_phase: float) -> None:
    """yi-9b's smoke config on the card: two steps, an async save, a
    restore into a fresh template, and step 3 from it with the same bits
    as the uninterrupted run's."""
    import shutil

    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticDataset
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.train import Checkpointer, Trainer

    cfg = get_config(TRAIN_ARCH, smoke=True)
    run = RunConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    tr = Trainer(get_model(cfg, run, kernel_backend="cuda"), run)
    ds = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                     global_batch=8))
    batches = [tr.device_batch(ds.batch(i)) for i in range(3)]
    step_fn = tr.make_train_step()
    state = tr.init_state(TRAIN_SEED)
    for b in batches[:2]:
        state, _ = step_fn(state, b)
    where = TRAIN_CKPT_DIR / "round_trip"
    shutil.rmtree(where, ignore_errors=True)
    ck = Checkpointer(str(where))
    ck.save(2, state, blocking=False)
    ck.wait()
    cont, m_direct = step_fn(state, batches[2])
    restored, step = ck.restore(tr.init_state(TRAIN_SEED + 1))
    again, m_replay = step_fn(restored, batches[2])
    same = float(m_direct["loss"]) == float(m_replay["loss"]) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(cont.params),
                                          tree_leaves(again.params)))
    emit("train", check="checkpoint round trip, smoke config", step=step,
         loss_direct=float(m_direct["loss"]),
         loss_restored=float(m_replay["loss"]), bit_identical=same,
         phase_s=time.perf_counter() - t_phase, ok=same)
    if not same or step != 2:
        raise AssertionError("train: the restored run's step 3 differs")


def check_train_cli(t_phase: float) -> None:
    """``python -m repro_torch.launch.train --arch yi-9b --smoke --steps
    20 --ckpt-dir build/repro_torch/train_ck`` on the card through the
    kernels, then the same with ``--resume``: both exit 0, the first
    logs its [train] lines, the second resumes from step 20."""
    import shutil

    where = TRAIN_CKPT_DIR / "cli"
    shutil.rmtree(where, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            TRAIN_ARCH, "--smoke", "--steps", "20", "--ckpt-dir", str(where)]
    for extra in ([], ["--resume"]):
        t0 = time.perf_counter()
        proc = subprocess.run(base + extra, capture_output=True, text=True,
                              env=env, cwd=ROOT, timeout=600)
        lines = [json.loads(l[len("[train] "):])
                 for l in proc.stdout.splitlines()
                 if l.startswith("[train] {")]
        resumed = "[train] resumed from step 20" in proc.stdout
        ok = proc.returncode == 0 and (resumed if extra else
                                       len(lines) == 2 and all(
                                           math.isfinite(m["loss"])
                                           for m in lines))
        emit("train", check="launch.train CLI " + " ".join(extra),
             returncode=proc.returncode, logged=lines, resumed=resumed,
             wall_s=time.perf_counter() - t0,
             phase_s=time.perf_counter() - t_phase, ok=ok)
        if not ok:
            raise AssertionError(f"train CLI {extra}: rc {proc.returncode}\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")


def phase_train(card: str) -> "tuple[dict, dict]":
    """Training through the port's entry points (``Trainer``,
    ``launch.train``): the yi-9b cell at full width and TRAIN_LAYERS of its
    48 layers, its kernel path against itself and the plain path, the
    float32 check, remat, accumulation, a checkpoint round trip, the CLI,
    and the two backward kernels' rows.  Returns (the timed run's launch
    counts, the backward kernels' rows)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.train import Trainer

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS)
    batches = train_batches(cfg, TRAIN_STEPS)
    data_s = time.perf_counter() - t_phase
    run = RunConfig(lr=TRAIN_LR)
    kern = Trainer(get_model(cfg, run, kernel_backend="cuda"), run)
    emit("train", card=card, arch=TRAIN_ARCH, layers=TRAIN_LAYERS,
         of_layers=get_config(TRAIN_ARCH).n_layers,
         params=kern.model.param_count(), seq_len=TRAIN_SEQ,
         global_batch=TRAIN_BATCH, tokens_per_step=TRAIN_BATCH * TRAIN_SEQ,
         steps=TRAIN_STEPS, lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
         adam_dtype=run.adam_dtype,
         data="lcg", data_s=data_s)

    # step-1 gradients through the kernels, then remat and accumulation
    # against them (kernel path, bf16 tolerances)
    params = kern.model.init(TRAIN_SEED)
    batch0 = kern.device_batch(batches[0])
    loss1, grads1 = grads_of(kern, params, batch0)
    for where, kw in (("remat full", {"remat": "full"}),
                      ("remat dots", {"remat": "dots"}),
                      ("microbatches 2", {"microbatches": 2})):
        r = RunConfig(lr=TRAIN_LR, **kw)
        check_gradients(f"{where} vs remat none, kernels",
                        Trainer(get_model(cfg, r, kernel_backend="cuda"), r),
                        params, batch0, loss1, grads1, "bfloat16",
                        phase_s=time.perf_counter() - t_phase)
    del params
    torch.cuda.empty_cache()

    # the timed run through the kernels, again (the same bits), then the
    # plain path (remat full: its S x S scores live a layer at a time)
    first = kern_launches = None
    for label, backend, remat in (("cuda", "cuda", "none"),
                                  ("cuda again", "cuda", "none"),
                                  ("torch", "torch", "full")):
        r = RunConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, remat=remat)
        tr = Trainer(get_model(cfg, r, kernel_backend=backend), r)
        if backend == "torch":
            params = tr.model.init(TRAIN_SEED)
            check_gradients("step-1 gradients, kernels vs plain", tr, params,
                            batch0, loss1, grads1, "bfloat16",
                            phase_s=time.perf_counter() - t_phase)
            del params
        out = train_run(tr, batches)
        state = out.pop("state")
        fields = {}
        if label == "cuda":
            first = out["losses"], host_leaves(state.params)
            kern_launches = out["launches"]
            L = cfg.n_layers
            want = {"rmsnorm": TRAIN_STEPS * (2 * L + 1),
                    "rmsnorm_backward": TRAIN_STEPS * (2 * L + 1),
                    "flash_attention": TRAIN_STEPS * L,
                    "flash_attention_tc": TRAIN_STEPS * L,
                    "flash_attention_decode": 0,
                    "flash_attention_backward": TRAIN_STEPS * L,
                    "flash_attention_backward_tc": TRAIN_STEPS * L}
            if kern_launches != want:
                raise AssertionError(f"train launches {kern_launches} != "
                                     f"{want}")
            fields["launches_per_step"] = {
                k: v / TRAIN_STEPS for k, v in kern_launches.items()}
        elif label == "cuda again":
            fields["bit_identical"] = out["losses"] == first[0] and \
                same_leaves(first[1], state.params)
            if not fields["bit_identical"]:
                raise AssertionError("train: two kernel runs differ")
            fields["profile"] = profile_train_step(tr, state, batch0)
        else:
            gaps = [abs(a - b) / abs(b) for a, b in zip(first[0],
                                                         out["losses"])]
            init = tr.model.init(TRAIN_SEED)
            moved = update_gap(first[1], state.params, init)
            del init
            fields.update(loss_rel_gaps_kernels_vs_plain=gaps,
                          loss_tolerance=TRAIN_LOSS_TOL["bfloat16"],
                          param_update_gap_kernels_vs_plain=moved,
                          param_update_tolerance=TRAIN_UPDATE_TOL)
            if max(gaps) > TRAIN_LOSS_TOL["bfloat16"]:
                raise AssertionError(f"train: kernel losses {first[0]} vs "
                                     f"plain {out['losses']}")
            if moved > TRAIN_UPDATE_TOL:
                raise AssertionError(f"train: kernel params after the steps "
                                     f"{moved} of the plain update away")
        emit("train", run=label, kernel_backend=backend, remat=remat,
             card=card, **out, **fields,
             phase_s=time.perf_counter() - t_phase, ok=True)
        del state, tr
        torch.cuda.empty_cache()
    del first, grads1

    # float32, 2 layers at full width: the CUDA-core forward and the
    # float32 backward against the plain path
    cfg32 = cfg.replace(n_layers=TRAIN_F32_LAYERS, param_dtype="float32",
                        activation_dtype="float32")
    k32 = Trainer(get_model(cfg32, run, kernel_backend="cuda"), run)
    params = k32.model.init(TRAIN_SEED)
    reset_train_launches()
    loss32, grads32 = grads_of(k32, params, batch0)
    launches32 = train_launches()
    if launches32["flash_attention_backward"] != TRAIN_F32_LAYERS or \
            launches32["flash_attention_tc"] != 0 or \
            launches32["flash_attention_backward_tc"] != 0:
        raise AssertionError(f"train float32 launches {launches32}")
    check_gradients("step-1 gradients, kernels vs plain", Trainer(
        get_model(cfg32, run, kernel_backend="torch"), run), params, batch0,
        loss32, grads32, "float32", layers=TRAIN_F32_LAYERS,
        kernel_launches=launches32, phase_s=time.perf_counter() - t_phase)
    del params, grads32
    torch.cuda.empty_cache()

    check_checkpoint_round_trip(t_phase)
    check_train_cli(t_phase)
    check_forward_lse(t_phase)
    rows = {"rmsnorm_backward": check_rmsnorm_backward(t_phase),
            "flash_attention_backward": check_attention_backward(t_phase)}
    emit("train", phase_s=time.perf_counter() - t_phase, ok=True)
    return kern_launches, rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.is_file():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(src/repro_torch and tests/golden are missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:] == ["--count-copies"]:
        print(json.dumps(count_copies()), flush=True)
        return 0
    card = nvidia_smi_line()
    emit("env", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device_name=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())
    t0 = time.perf_counter()
    phase_build()
    kernel_results = phase_kernels()
    # each path's launch counts, read around that path's own run
    by_path = {"sim mphx-4p-86x9": phase_main_path()}
    phase_golden()
    by_path["sweep mphx-2p-16x16, mphx-4p-86x9"] = phase_sweep()
    by_path[f"valiant sim {MAIN_TOPO} {VALIANT_SCENARIO}"] = \
        phase_valiant_sim()
    by_path.update(phase_graph())
    by_path.update(phase_table2_trace())
    by_path.update(phase_spray())
    by_path.update(phase_failures())
    by_path.update(phase_cosim_serving())
    by_path[f"{TRAIN_ARCH} train"], train_rows = phase_train(card)
    kernel_results.update(train_rows)
    kernel_results.update(phase_model_kernels())
    by_path[f"{SERVE_ARCH} serve"] = phase_serve(card)
    by_path[f"{MOE_ARCH} serve"], ragged = phase_moe_serve(card)
    kernel_results.update(ragged)
    by_path[f"{HYBRID_ARCH} serve"], hybrid = phase_hybrid_serve(card)
    kernel_results["lru_scan"] = hybrid["lru_scan"]
    by_path[f"{SSM_ARCH} serve"] = phase_ssm_serve(card)
    by_path[f"{AUDIO_ARCH} serve"], audio_rows = phase_audio_serve(card)
    emit("done", script_s=time.perf_counter() - t0)

    sources = {name: (replaces, SOURCE) for name, replaces in KERNELS.items()}
    sources.update(MODEL_KERNELS)
    launches = {name: {path: counts[name] for path, counts in by_path.items()
                       if counts.get(name)} for name in sources}
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(launches[name].values()),
                "launches_by_path": launches[name],
                "max_abs_err": kernel_results[name]["max_abs_err"],
                "ms": kernel_results[name]["ms"],
                "plain_ms": kernel_results[name]["plain_ms"],
                "bound_ms": kernel_results[name]["bound_ms"],
                "bound_by": kernel_results[name]["bound_by"],
                "library_ms": kernel_results[name]["library_ms"],
                "ok": True}
               for name, (replaces, source) in sources.items()]
    # the backward rows replace JAX's autodiff of a plain layer, and time
    # the train cell's shape
    for name, what in AUTODIFF_OF.items():
        next(k for k in kernels if k["name"] == name)["replaces_what"] = what
    # the segment kernels' rows time their first main-path shape, at the
    # lanes of its plan
    for name in KERNELS:
        row = next(k for k in kernels if k["name"] == name)
        row["lanes"] = kernel_results[name]["lanes"]
    # attention's row times the tensor-core kernel (yi-9b prefill); its
    # launches count every route, the tensor-core and decode ones beside
    attn = next(k for k in kernels if k["name"] == "flash_attention")
    attn["kernel_route"] = kernel_results["flash_attention"]["kernel_route"]
    # and whisper-small's shapes (non-causal, head dim 64, G = 1) beside
    attn["rows_whisper_small_serve"] = {
        case: {key: row[key] for key in (
            "kernel_route", "ms", "kernel_device_ms", "kernel_graph_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms", "library_graph_ms", "max_abs_err")}
        for case, row in audio_rows.items()}
    for route in ("tc", "decode"):
        attn[f"launches_{route}_by_path"] = {
            path: counts[f"flash_attention_{route}"]
            for path, counts in by_path.items()
            if counts.get(f"flash_attention_{route}")}
    # the attention backward's row times its tensor-core route (bf16, the
    # train path's); its launches count both routes, the tc ones beside
    attn_bwd = next(k for k in kernels
                    if k["name"] == "flash_attention_backward")
    attn_bwd["kernel_route"] = "tc"
    attn_bwd["launches_tc_by_path"] = {
        path: counts["flash_attention_backward_tc"]
        for path, counts in by_path.items()
        if counts.get("flash_attention_backward_tc")}
    # the grouped matmuls' rows time the wgmma route (mixtral prefill
    # gate/up, the routed rows) with its K splits (1); their launches
    # count every route, the wgmma ones (both variants) and the split-K
    # ones (mma, S > 1) beside, and the grouped row every shape's splits
    for name in ("grouped_matmul", "ragged_grouped_matmul"):
        row = next(k for k in kernels if k["name"] == name)
        row["kernel_route"] = kernel_results[name]["kernel_route"]
        row["splits"] = kernel_results[name]["splits"]
    gmm = next(k for k in kernels if k["name"] == "grouped_matmul")
    gmm["splits_by_case"] = kernel_results["grouped_matmul"][
        "splits_by_case"]
    for route in ("wgmma", "splitk"):
        gmm[f"launches_{route}_by_path"] = {
            path: counts[f"grouped_matmul_{route}"]
            for path, counts in by_path.items()
            if counts.get(f"grouped_matmul_{route}")}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
