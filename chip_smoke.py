#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases build,kernels

Phases (each prints its results, one line each):
  build    card name and power limit, torch version, nvcc build of the
           five kernels from src/repro_torch/csrc (with ptxas's
           registers and spills of the flash, decode, prefill int8,
           queue_scan and cluster_scan kernels; a spill in any but int8
           fails the run)
  kernels  every kernel against its plain PyTorch version on the card at
           the serving path's full-width shapes (fp32 and bf16; flash
           and decode also at the heads of yi_9b, gemma2_9b,
           qwen3_moe_235b (64/4/128, rep 16) and recurrentgemma-2b as
           it runs them (16/1/256), decode checked at unpadded
           recurrentgemma_2b's too; flash and decode also at
           recurrentgemma-2b's model shapes: prefill at T = 2040 and
           2560 with window 2048, its 2048-slot ring wrapped; and at
           the dense models' (deepseek-coder-33b's 64/8/128 heads
           everywhere the other heads go; gemma2-9b's local layers at T = 4200, window 4096, softcap
           50, its ring wrapped, its global layers at S = 8192; yi-9b,
           deepseek-coder-33b, chameleon-34b and musicgen-large as
           their runs give them); int8 at the decode M and the serve
           and model phases' prefill M, for stablelm's, recurrentgemma's
           and the dense int8 candidates' projections, up to K = 22016),
           the bit-exact pins (flash and decode at each heads and
           dtype: valid_from = 0 gives the bits of None, two calls give
           the same bits; decode: the linear skip gives those of the full
           scan; int8: two calls), and each kernel's time beside its
           bound (attention: counted on the rows it attends), the plain
           version's time and one PyTorch library call's time; decode
           (with its split plan) and the decode int8 shapes also with
           their K/V or weights cold in L2; queue_scan (the scan
           engine's open-loop queue recurrence) against its plain
           version bit for bit at 50000 requests on 1, 2, 8 and 40
           servers and at 2000 on 1600 (free times in the device
           buffer), with and without ties, and timed at 10 million
           requests on 2 servers beside its bound (its dependent chain
           at the fp64 add latency the card measures); cluster_scan (the
           scan cluster engine's request-axis scan) against its plain
           version bit for bit, every column and carry, at 2000 requests
           for R x K in 3 x 3, 1 x 1, 8 x 5 and 260 x 5 (its state past
           shared memory), with and without a budget and ties, and timed
           at 200000 requests on 3 x 3 beside its bound (its dependent
           chain through the free times)
  scan     simulate(engine="scan") on the card (no model): on
           benchmarks/engine_scale.py's workload (ArrayFleet(1000),
           reactive controller, greedy_nw, t_sla 350, seed 11) and on
           the open-loop case (lte_outage_fleet, reactive, cnnselect,
           500 Hz, 2 servers; queue_scan must launch), 50000 requests
           each, exact against the python engine (selections, modes,
           hedges, fallbacks, cold starts and switch events equal,
           latencies within 1e-9 relative); at ArrayFleet(100000) x 1
           million requests for pctl:90 (top layout), pctl:50 (sbuf) and
           the reactive controller, and with no fleet at 2000 requests
           for pctl:90 (the rolling layout), bit for bit against the
           same run on the CPU (scan_device("cpu")); requests/s at
           100000 x 1 million (median of 3 after a warm run), the column
           program's CUDA-event span, its kernel time and launches
           (torch.profiler), and the python engine's rate at 100000 x
           50000
  cluster  Cluster(engine="scan") on the card (no model), on
           benchmarks/cluster_scale.py's workload (3 replicas of
           mobilenetv1_025, mobilenetv1_10 and inceptionv3, 12 Hz, seed
           7): bit for bit against the python Cluster (events, metrics
           rows, n_active, replica zoo / queue / RNG state, controller
           events) at its check row (1000 devices, 2000 requests, a
           250e6-byte budget: evictions; cluster_scan must launch), the
           python capture replayed through both engines, and on each
           tenant mix at 2000 requests, 40 Hz (hedges); the card
           against the CPU bit for bit at 1000 x 20000; requests/s at
           SWEEP_RUN's points (scan 1000 x 20000 and 100000 x 200000,
           median of 3 after a warm run, collect_rows=False, split into
           host precompute, column program, kernel and assembly; python
           at 20000 and 50000 requests)
  model    full-width stablelm-1.6b (fp32 and int8) through prefill and
           teacher-forced decode on the "cuda" path against the "naive"
           path (for int8: on the dequantized weights, so no int8
           kernel), a prefill_row backfill against a from-scratch
           prefill, and the engine's CUDA graphs against models.model
           run eagerly on a fresh cache, bit for bit (both candidates,
           40 decode steps, a backfill mid-group, a second prefill at
           a shorter T)
  serve    the main path: CNNSelectServer over the two full-width
           engines (profiling, then requests under cnnselect), then a
           ServingLoop run with staggered arrivals that backfills freed
           slots; every kernel's launch counter (graph replays
           included), and that of the int8 kernel's prefill path, must
           be > 0 here; each engine's captures, replays and capture
           seconds. A TraceRecorder captures the server's and the
           loop's requests
  sim      the simulation plane on the serve phase's server (no new
           model): each serve capture holds one record a request
           served, is valid and carries exec_ms on each; then for
           cnnselect and greedy_nw, 200 requests (prompts of 64
           tokens, 8 new tokens, uploads from the wifi -> lte step
           trace scaled to the fp32 candidate's mean) served under a
           TraceRecorder, the capture saved as JSONL and npz and loaded
           back bit for bit, and replayed through simulate (profiles
           fitted from the capture, its uploads exactly, its exec_ms
           injected): |sim - served attainment| <= 0.02. After the
           dense phase, attainment_improvement (CNNSelect against
           greedy, 16 SLA points, 10000 requests each, a CPU
           computation) on every candidate profile the serve phases
           measured
  sharded  the tensor-parallel serve path on torch.distributed: (a) a
           one-rank NCCL group, mesh (1, 1): full-width stablelm-1.6b
           fp32 and int8 through InferenceEngine(parallel=) with its
           graphs (all_reduce makes its NCCL call over an axis of size
           1, and the graphs capture it; the calls are counted), every
           step within 1e-4 of max|logit| of the unsharded engine and
           bit for bit its own eager run, every kernel launched
           (launches_sharded); then all_reduce and the NCCL calls behind
           all_gather and reduce_scatter captured in one CUDA graph on
           the group and replayed on new inputs; (b) two gloo ranks on
           the one card (NCCL refuses two ranks on one device), mesh (1,
           2): full-width stablelm-1.6b fp32 forward, prefill and decode
           eagerly against the unsharded run, and flash_decode_sharded
           at yi-9b's heads (32/4/128) on a 4096-slot ring past its
           wrap, split over the two ranks, with valid_from and a row
           that attends no slot, against the plain decode attention over
           the whole cache; then, on mesh (2, 1) over the same ranks,
           moe_ffn_sharded (qwen3-moe reduced in ep and ep2d, grok-1
           reduced in tp and tp2d, capacity n_experts) against
           moe_ffn_dense on the whole batch
  recurrent
           recurrentgemma-2b (fp32, int8) and mamba2-2.7b (fp32) at their
           published size, batch 4, max_seq 4096: the engine's graphs
           against models.model run eagerly on a fresh cache, bit for
           bit at every step (recurrentgemma: a group at T = 2040 and
           24 decode steps across position 2048, where the local
           layers' ring wraps, then T = 2560 and 8 steps; mamba2: T =
           512 and 300, 8 steps each); recurrentgemma's cuda path
           against its naive path (int8: on the dequantized weights);
           mamba2's steps against one forward over the sequence; each
           candidate's shards (views of its tree) through
           InferenceEngine(parallel=) with graphs on a one-rank NCCL
           mesh (1, 1), fed the unsharded engine's tokens, bit for bit
           its logits (launches_sharded_recurrent); then the recurrent
           path: CNNSelectServer over the three candidates, whose
           graph replays must launch every kernel
  dense    the five attention-only architectures at published width and
           depth, batch 4, one model at a time (each one's peak memory
           printed, at most 75 GB): gemma2-9b fp32 and int8 through the
           engine at max_seq 8192 (a group at T = 4200, past its 4096
           window, and 24 steps, then T = 1024 and 8 steps; the engine
           refuses backfill there), yi-9b fp32 and deepseek-coder-33b
           int8 on the model phase's schedule at max_seq 1024: graphs
           against models.model eagerly on a fresh cache, bit for bit
           at every step; the cuda path against the naive path (gemma2
           at B = 1, int8 on the dequantized weights; deepseek on the
           same int8 tree); musicgen-large fp32 and chameleon-34b int8
           model-level with embeddings in: a prefill at T = 512 and 16
           teacher-forced steps against one forward and cuda against
           naive. The 34 B int8 trees are built one scan group at a time
           (tree_by_group). gemma2-9b fp32's T = 4200 prefill (B = 1)
           also runs under attn_impl "auto", which takes the chunked
           attention there, against the flash path. Then the dense path:
           CNNSelectServer over gemma2-9b int8 and yi-9b int8, whose graph
           replays must launch every kernel
  moe      qwen3-moe-235b-a22b in fp32 at published width (d 4096, 64
           q heads on 4 kv heads, 128 experts top 8, f 1536, vocab
           151936), its depth cut from 94 to the most layers that keep
           the phase's peak under 75 GB (6; the cut is logged), batch
           4, max_seq 1024: the model phase's schedule through the
           engine, graphs against models.model eagerly on a fresh cache
           bit for bit, the cuda path against the naive path (a ragged
           prefill at T = 512 and 16 teacher-forced steps); the step
           times (prefill at T = 64 and 512, decode; graph and eager)
           and the MoE FFN's share of a graph decode step; then 6
           requests through CNNSelectServer with this engine as its one
           candidate, whose graph replays must launch flash_attention
           and decode_attention (the experts compute in float only, so
           no int8 kernel); then the sharded MoE (moe_ffn_sharded) on
           the same tree through InferenceEngine(parallel=) with graphs
           on a one-rank NCCL mesh (1, 1), in moe_mode ep2d, on
           the sharded phase's schedule (B = 4, T = 64 ragged, 16
           steps, a backfill): at capacity_factor = n_experts within
           1e-4 of max|logit| of the unsharded engine, at the config's
           1.25 (pairs drop, logged a step) graphs bit for bit eager
           (launches_sharded_moe)
  train    the training path (src/repro_torch/launch/train.py) at
           full width and depth: stablelm-1.6b fp32 under
           mixed_precision(adamw(cosine)), as the launcher builds it, 20
           steps at its default B = 8, T = 64 with lr 1e-3 on the Markov
           task (loss finite and falling; ms/step by CUDA events,
           tokens/s, peak memory), a checkpoint after step 10 restored
           into a fresh state whose step 11 must give the uninterrupted
           one's; one step at B = 1, T = 4608 under remat="block" with
           "auto" (chunked) attention and again with naive attention
           (loss, ms, peak memory of each); at 2 layers of full width,
           fp32 loss and grads against float64 and remat="block"
           against "none"; the launcher's CLI for 2 steps. No kernel
           launches here (the kernels have no backward)
  profile  (only when asked for) where the time of a full-width decode
           step and of a full-width prefill (T = 64 and 512) goes,
           through the engine's graphs and through models.model called
           eagerly, in one call: host wall time and the card's timeline
           (CUDA events) over 64 decode steps, 3 times, then device
           kernel time from torch.profiler, decode_attention's,
           int8_matmul's and flash_attention's shares, and the kernels
           that take it (ms a step)
  profile_recurrent
           (only when asked for) the same for each recurrent candidate
           (B = 4, prompt 2040), with the device time of the
           plain-torch RG-LRU and SSD functions (profiler ranges)
  profile_dense
           (only when asked for) the same for each dense engine
           candidate (gemma2-9b fp32 and int8, yi-9b fp32,
           deepseek-coder-33b int8; B = 4, prompt 512, max_seq 1024)
  profile_train
           (only when asked for) where a full-width train step's time
           goes (the train phase's model and batch): the whole step and
           its loss and grads alone, wall and device time, launches, the
           kernels that take the most
  scan_full
           (only when asked for) simulate(engine="scan") at 1 million
           devices x 10 million requests (reactive), once; and the
           no-fleet reactive run's wall (D = 1: 2000 rows of launches)
           through scan on the card, scan on the CPU and python
  profile_cluster
           (only when asked for) cluster_scan's cycles a request at
           200000 requests on input variants that each drop or add one
           part of the step (the cnnselect choice, the hedge leg, the
           replicas of the placement, eviction)
  tune     (only when asked for) the prefill int8 path's variants side
           by side: the source as it is, each tile's ring 2 <-> 3 stages
           deep, each tile forced, built from csrc/int8_matmul.cu with
           -D values of its macros and timed at stablelm's projections
           and the dense models' w_down, weights hot and cold in L2, each
           with its error against a float64 product

The last two lines are a {"kernels": [...]} JSON object and the result
{"ok": true, "device": {...}}. Any failure raises and exits non-zero
before them. Without a CUDA device, or outside a checkout of the
repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "scan", "cluster", "model", "serve", "sim",
          "sharded", "recurrent", "dense", "moe", "train")
EXTRA_PHASES = ("profile", "profile_recurrent", "profile_dense",
                "profile_train", "tune", "scan_full", "profile_cluster")

# NVIDIA H100 SXM data-sheet peaks (dense): HBM bandwidth; fp32 on the
# CUDA cores, where decode attention and the decode int8 path compute;
# bf16 on the tensor cores, where the prefill int8 path computes (two
# bf16 passes for fp32 x).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# Flash attention's operations bound, on the tensor cores: fp32 inputs
# at three TF32 passes (3xTF32, the least that holds fp32 accuracy) of
# 495 TFLOP/s; bf16 inputs at one bf16 pass of 989 TFLOP/s (the kernel
# runs P V twice, on p's hi and lo bf16 parts, so it cannot reach it).
FLASH_PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
# Copies of a weight to rotate through for an L2-cold time: well over
# the H100's 50 MB L2, as a decode step streams 1.2 GB of weights.
COLD_BYTES = 256 << 20
# Most operand copies of an L2-cold decode time: its 2 x COLD_COPIES
# calls (about 0.1 ms of host time each) queue behind one sleeping
# kernel. Binds only where a head group's attended rows are small
# (recurrentgemma-2b's one kv head at context 70 in bf16: 722 copies
# would fill the L2 4 times over, 400 fill it 2.3 times).
COLD_COPIES = 400

# Full-width serving shapes of stablelm-1.6b (configs/stablelm_1_6b.py).
B, H, HD, D, F = 4, 32, 64, 2048, 5632
T_PREFILL, S_CACHE = 512, 1024
T_SERVE = 64            # prompt length of the serve phase
# int8 rows: decode (M = B), the serve phase's prefill, the model phase's.
INT8_M = (B, B * T_SERVE, B * T_PREFILL)
PROJ_KN = ((D, D), (D, F), (F, D))   # (K, N): q/k/v/o, gate/up, down
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Attention heads of the flash checks and times (Hq, KV, hd): stablelm-
# 1.6b's, and the reference configs' at head dims 128 and 256, from
# src/repro/configs/yi_9b.py and gemma2_9b.py.
# recurrentgemma-2b's local attention as its model runs it
# (src/repro/configs/recurrentgemma_2b.py): the 10 q heads padded to
# tp_pad_heads = 16 (q_heads_padded), on 1 kv head, hd 256, window 2048,
# no softcap; "recurrentgemma_2b" below is the unpadded 10/1/256.
RG = "recurrentgemma_2b_q16"
RG_HEADS, RG_WINDOW = (16, 1, 256), 2048
# deepseek-coder-33b's heads as its model runs them (56 q heads padded to
# tp_pad_heads = 64, on 8 kv heads); chameleon-34b's are the same.
# qwen3-moe-235b's (src/repro/configs/qwen3_moe_235b.py): 64 q heads on
# 4 kv heads (rep 16, the most of the reference configs), hd 128.
FLASH_HEADS = {"stablelm_1_6b": (H, H, HD), "yi_9b": (32, 4, 128),
               "gemma2_9b": (16, 8, 256), RG: RG_HEADS,
               "deepseek_coder_33b": (64, 8, 128),
               "qwen3_moe_235b": (64, 4, 128)}
# Heads of the decode checks: the flash heads, checked and timed, and
# recurrentgemma_2b.py's unpadded rep 10 at hd 256, checked only.
DECODE_HEADS = dict(FLASH_HEADS, recurrentgemma_2b=(10, 1, 256))
# The recurrent phases: batch, the engines' max_seq (the local layers
# keep a ring of RG_WINDOW slots), recurrentgemma's prompt lengths (a
# group at 2040 whose decode steps cross position 2048, where the ring
# wraps; a prefill at 2560 > the window), its int8 projections (K, N):
# w_up / w_gate, w_down, wq, wk / wv, wo (d_model 2560, d_ff 7680).
RG_B, RG_MAX_SEQ = 4, 4096
RG_T = (2040, 2560)
RG_PROJ_KN = ((2560, 7680), (7680, 2560), (2560, 4096), (2560, 256),
              (4096, 2560))
# int8 shapes checked and timed: stablelm's, then recurrentgemma's at
# the decode M and the prefill M of a group at RG_T[0].
INT8_SHAPES = ([(M, K, N) for M in INT8_M for K, N in PROJ_KN]
               + [(M, K, N) for M in (RG_B, RG_B * RG_T[0])
                  for K, N in RG_PROJ_KN])
# The dense phase: the five attention-only architectures at published
# size (src/repro/configs/{gemma2_9b,yi_9b,deepseek_coder_33b,
# musicgen_large,chameleon_34b}.py), batch B. gemma2-9b's engine runs at
# max_seq G2_MAX_SEQ with its local layers on a G2_WINDOW-slot ring:
# a group at G2_GROUPS[0][0] > the window (flash masks by window, the
# ring wraps), then a shorter one. yi-9b and deepseek-coder-33b run
# stablelm's schedule at max_seq S_CACHE; musicgen-large and chameleon-34b
# (embeddings in) a prefill at EMBED_T and EMBED_STEPS teacher-forced
# steps, model-level.
G2_MAX_SEQ, G2_WINDOW, G2_CAP = 8192, 4096, 50.0
G2_GROUPS = ((4200, 24), (1024, 8))
# The row start of the fp32 prefill under attn_impl "auto" (chunked):
# past the first 512-key chunk, which is skipped.
G2_AUTO_VF = 600
EMBED_T, EMBED_STEPS = 512, 16
# The card's memory the dense and moe phases may take at their peak, per
# model.
PEAK_LIMIT_BYTES = 75e9
# The moe phase: qwen3-moe-235b-a22b (src/repro/configs/qwen3_moe_235b.py)
# in fp32 at published width, its depth cut to the layers that fit
# PEAK_LIMIT_BYTES beside its embedding and head and MOE_ACT_BYTES of
# activations (the experts run one at a time: a prefill of B x T_PREFILL
# tokens keeps (T, f) per expert, not (T, E, f)), caches and graph pools;
# MOE_REQUESTS requests through the server; MOE_TIMED calls a step time.
MOE_ARCH, MOE_ACT_BYTES = "qwen3_moe_235b", 4e9
MOE_REQUESTS, MOE_TIMED = 6, 3
# The sharded MoE's layout on the card's one-rank mesh, where every mode
# computes alike (each axis of size 1); phase sharded (b) runs all four
# on two ranks.
MOE_SHARD_MODES = ("ep2d",)
# The decode main shape: the ragged prefill's rows (valid_from = T_PREFILL
# - lengths) 16 tokens on, and the profile's decode step's context.
DECODE_CPOS, DECODE_VF = T_PREFILL + 16, [0, 212, 383, 475]
DECODE_CTX = 70
L2_BYTES = 50 << 20
INT8_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# The prefill path (M > 8) with fp32 x against a float64 product, of
# max|product|: fresh sums a 16 rows of K measured at most 2.9e-6 at every
# K up to 22016, one mma chain over K 5.3e-5 there (PERF.md).
INT8_PREFILL_F64_TOL = 1e-5
LOGIT_TOL = 1e-4
# The train phase: TRAIN_STEPS launcher steps at its defaults (B=8,
# T=64) but lr TRAIN_LR on the Markov task, a checkpoint after
# TRAIN_CKPT_STEP; one step at B=1, T=LONG_T (4608² > 4096²: "auto" takes
# chunked attention) under remat="block". The launcher's default lr,
# 3e-3, barely moves the full-width loss in 20 steps (12.06 to a last-5
# mean of 11.97); 1e-3 brings it to 11.72 (PERF.md).
TRAIN_STEPS, TRAIN_CKPT_STEP, TRAIN_LR, LONG_T = 20, 10, 1e-3, 4608
# fp32 against float64 (2 layers at full width): the loss within
# LOSS64_RTOL relative, each grad leaf within GRAD64_TOL of its
# max|float64 grad| (the CPU tests' limit against the reference). The
# long step's chunked and naive losses within LOSS64_RTOL too.
LOSS64_RTOL, GRAD64_TOL = 1e-5, 1e-4
# remat="block" against "none": the loss bit for bit (the forward is
# the same), each grad leaf within REMAT_TOL of its max|grad|.
REMAT_TOL = 1e-6
# The resumed step against the uninterrupted one (the restored state is
# the saved one bit for bit): the loss within RESUME_LOSS_RTOL, each
# param within RESUME_TOL. Adam moves an element by up to about lr
# whatever its gradient's size, so a gradient summed in another order
# (the embedding backward's) can move it by a fraction of lr (the CPU
# tests measure 0.0146 lr between the port and the reference).
RESUME_LOSS_RTOL, RESUME_TOL = 1e-6, 0.05 * TRAIN_LR

KERNEL_META = {
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:98"),
    "decode_attention": dict(
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:87"),
    "int8_matmul": dict(
        source="src/repro_torch/csrc/int8_matmul.cu",
        replaces="src/repro/kernels/int8_matmul.py:40"),
    # No Pallas kernel: the reference's open-loop queue lax.scan.
    "queue_scan": dict(
        source="src/repro_torch/csrc/queue_scan.cu",
        replaces="src/repro/serving/scan_engine.py:727"),
    # No Pallas kernel: the reference's cluster lax.scan.
    "cluster_scan": dict(
        source="src/repro_torch/csrc/cluster_scan.cu",
        replaces="src/repro/serving/cluster_engine.py:527"),
}

# The scan phase: benchmarks/engine_scale.py's workload (an ArrayFleet of
# the paper's device tiers, the "reactive" controller, greedy_nw, t_sla
# 350 ms, seed 11) and tests/test_engine.py's open-loop case
# (lte_outage_fleet, reactive, cnnselect, 500 Hz, 2 servers).
SCAN_T_SLA, SCAN_SEED = 350.0, 11
SCAN_EQ_DEVICES, SCAN_EQ_N = 1_000, 50_000
SCAN_DEVICES, SCAN_N = 100_000, 1_000_000
SCAN_PY_N = 50_000          # the python engine's run at SCAN_DEVICES
SCAN_ROLL_N = 2_000         # no fleet: one column of N rows (> 64)
SCAN_REPS = 3
SCAN_FULL_DEVICES, SCAN_FULL_N = 1_000_000, 10_000_000
# queue_scan: checked at QUEUE_N for each server count, and at
# QUEUE_BIG_N on QUEUE_BIG_SERVERS (more free times than its shared memory
# holds: they live in the device buffer), timed at QUEUE_TIME_N requests
# on QUEUE_TIME_SERVERS servers.
QUEUE_N, QUEUE_SERVERS = 50_000, (1, 2, 8, 40)
QUEUE_BIG_N, QUEUE_BIG_SERVERS = 2_000, 1_600
QUEUE_TIME_N, QUEUE_TIME_SERVERS = 10_000_000, 2
# Bytes a request of the queue recurrence moves: arrival and execution
# time and three gate bytes in, the wait out.
QUEUE_BYTES = 8 + 8 + 3 + 8

# The cluster phase: benchmarks/cluster_scale.py's workload (3 replicas of
# CLUSTER_MODELS behind a Cluster over scale_tenant_mix's fleets, 12 Hz,
# seed 7): its check row (1000 devices, 2000 requests, a 250e6-byte
# budget, so eviction runs) and SWEEP_RUN's points (devices, python
# requests, scan requests; no budget, collect_rows=False); and
# tests/test_cluster_engine.py's tenant mixes at 2000 requests, 40 Hz,
# 250e6 bytes (hedges run).
CLUSTER_MODELS = ("mobilenetv1_025", "mobilenetv1_10", "inceptionv3")
CLUSTER_REPLICAS, CLUSTER_RATE, CLUSTER_SEED = 3, 12.0, 7
CLUSTER_BUDGET = int(250e6)
CLUSTER_CHECK_DEVICES, CLUSTER_CHECK_N = 1_000, 2_000
CLUSTER_MIX_N, CLUSTER_MIX_RATE = 2_000, 40.0
CLUSTER_CPU_DEVICES, CLUSTER_CPU_N = 1_000, 20_000   # card against the CPU
CLUSTER_SWEEP = ((1_000, 20_000, 20_000), (100_000, 50_000, 200_000))
CLUSTER_REPS = 3
# cluster_scan: checked bit for bit at CLUSTER_KERNEL_N requests for each
# (R, K) (the last past its shared-memory state: more than 256 replicas
# and 1024 entries), timed at CLUSTER_TIME_N on the main path's 3 x 3.
CLUSTER_KERNEL_SHAPES = ((3, 3), (1, 1), (8, 5), (260, 5))
CLUSTER_KERNEL_N = 2_000
CLUSTER_TIME_N = 200_000


def log(*parts):
    print(*parts, flush=True)


class Failed(AssertionError):
    pass


def require(cond, what):
    if not cond:
        raise Failed(what)


def bench_ms(fn, iters=20, warmup=3, queued=True):
    """Device time of one call: CUDA events around `iters` calls. With
    `queued`, the calls are enqueued behind a sleeping kernel, so the
    card runs them back to back and the host's enqueue rate (a Python
    wrapper takes tens of microseconds a call) does not show; without
    it, the pace at which the host issues the calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for cycles in (1 << 22, 1 << 24, 1 << 26, 1 << 28):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(cycles)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        if not (queued and t0.query()):  # the calls all queued in time
            torch.cuda.synchronize()
            return t0.elapsed_time(t1) / iters
        torch.cuda.synchronize()
    raise Failed("bench_ms: the calls did not queue behind the sleep")


def bench_cold_ms(fn, operands):
    """Device time of one call with its weight cold in L2: call i reads
    operands[i % len(operands)], copies that together exceed the L2."""
    n = len(operands)
    i = itertools.count()
    return bench_ms(lambda: fn(operands[next(i) % n]), iters=2 * n, warmup=n)


def copies(t):
    """Enough copies of t to fill COLD_BYTES."""
    return [t.clone() for _ in range(-(-COLD_BYTES // t.nbytes))]


def bound(nbytes, flops, dtype, peaks=PEAK_FLOPS):
    """Least time (ms) for the work: bytes over HBM rate or operations
    over the peak of the input type, whichever is larger."""
    tb = nbytes / PEAK_BYTES_S * 1e3
    tf = flops / peaks[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


# --------------------------------------------------------------------------
# Phase: build
# --------------------------------------------------------------------------

def phase_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build(verbose=True)
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.nvcc_path()}, {' '.join(_build.NVCC_FLAGS)})")
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    ops, ffma = sass_hot_loop(_build._lib_path("int8_matmul"),
                              "int8_matmul_small_mIfLi4ELb1E")
    # At M = 4 every weight byte takes four FMAs.
    log(f"sass int8_matmul_small_m<float, 4, true> hot loop: {ops} "
        f"instructions, {ffma} FFMA: {4 * ops / max(ffma, 1):.2f} "
        f"instructions per weight byte; SM clock max {clock}; "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    for lib, function in (("int8_matmul", "int8_matmul_prefill"),
                          ("flash_attention", "flash_attention_kernel"),
                          ("decode_attention", "decode_attention_kernel"),
                          ("queue_scan", "queue_scan_kernel"),
                          ("cluster_scan", "cluster_scan_kernel")):
        if lib not in _build.LOGS:
            log(f"ptxas {function}: registers and spills not reported, as "
                f"{_build._lib_path(lib)} was built by an earlier process "
                f"(delete it to see them)")
            continue
        usage = ptxas_usage(_build.LOGS[lib], function)
        require(usage, f"no {function} kernel in ptxas's output")
        for name, regs, spills in usage:
            log(f"ptxas {name}: {regs} registers, {spills}")
            if lib != "int8_matmul":
                require(spills == "0 bytes spill stores, 0 bytes spill "
                                  "loads", f"ptxas {name}: {spills}")
    return smi[0]


def ptxas_usage(nvcc_log, function):
    """(kernel, registers, spill line) of each kernel whose mangled name
    holds `function`, from nvcc's -Xptxas -v output."""
    out = []
    for part in nvcc_log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        if function not in name:
            continue
        dtype = "float" if f"{function}If" in name else "bf16"
        m = re.search(r"PfTileILi(\d+)ELi(\d+)E.*?Lb([01])E", name)
        f = re.search(rf"{function}I(?:f|13__nv_bfloat16)Li(\d+)ELb([01])E",
                      name)
        if function in ("queue_scan_kernel", "cluster_scan_kernel"):
            name = function
        elif m:
            name = (f"{function}<{dtype}, {m[1]}x{m[2]}, "
                    f"{'16-byte copies' if m[3] == '1' else 'element loads'}>")
        elif f:
            name = (f"{function}<{dtype}, hd {f[1]}, "
                    f"{'16-byte copies' if f[2] == '1' else 'element loads'}>")
        regs = re.search(r"Used (\d+) registers", part)
        spills = re.search(r"\d+ bytes spill stores, \d+ bytes spill loads",
                           part)
        out.append((name, regs[1] if regs else "?",
                    spills[0] if spills else "spills not reported"))
    return out


def sass_hot_loop(lib, function):
    """(instructions, FFMAs) of the innermost loop with the most FFMAs in
    the kernel whose mangled name holds `function`, from cuobjdump's
    SASS of the built library: the span from a backward branch's target
    to the branch."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    best = (0, 0)
    for fn in sass.split("Function : ")[1:]:
        if function not in fn.split("\n", 1)[0]:
            continue
        ins = [(int(a, 16), t) for a, t in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
        where = {a: i for i, (a, _) in enumerate(ins)}
        for i, (a, t) in enumerate(ins):
            m = re.search(r"\bBRA\b.*0x([0-9a-f]+)", t)
            if m and int(m.group(1), 16) < a and int(m.group(1), 16) in where:
                body = ins[where[int(m.group(1), 16)]:i + 1]
                ffma = sum(bool(re.search(r"\bFFMA\b", x)) for _, x in body)
                if (ffma, -len(body)) > (best[1], -best[0]):
                    best = (len(body), ffma)
    return best


# --------------------------------------------------------------------------
# Phase: kernels
# --------------------------------------------------------------------------

def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(out, ref, tol):
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= tol + tol * ref.float().abs()).all())
    return float(err.max()), ok


def _flash_cases():
    """(heads, case name, shape and masks) of the flash checks: the
    stablelm heads through every mask, the yi_9b, gemma2_9b,
    deepseek_coder_33b and qwen3_moe_235b heads with softcap on, a ragged
    valid_from and a window, and the gemma2_9b heads at a long context
    (S = 4096, where the fp32 error's margin to its tolerance is thinnest
    at S = 512)."""
    T = T_PREFILL
    yield "stablelm_1_6b", "plain", dict(T=T, KV=H, vf=None)
    yield "stablelm_1_6b", "vf mid/edge/full", dict(T=T, KV=H,
                                                    vf=[0, 37, 64, T])
    yield "stablelm_1_6b", "window", dict(T=T, KV=H, vf=[0, 37, 64, T],
                                          window=128)
    yield "stablelm_1_6b", "softcap", dict(T=T, KV=H, vf=[0, 37, 64, T],
                                           cap=30.0)
    yield "stablelm_1_6b", "T not a block multiple", dict(
        T=T - 3, KV=H, vf=[0, 5, 100, 1])
    yield "stablelm_1_6b", "GQA rep=4", dict(T=T, KV=8, vf=[0, 37, 64, 300])
    for heads in ("yi_9b", "gemma2_9b", "deepseek_coder_33b",
                  "qwen3_moe_235b"):
        yield heads, "vf + softcap", dict(vf=[0, 37, 64, T], cap=50.0, T=T)
        yield heads, "window + softcap, T not a block multiple", dict(
            vf=[0, 5, 100, 1], cap=50.0, window=128, T=T - 3)
    yield "gemma2_9b", "long S, vf + softcap", dict(B=2, T=4096,
                                                    vf=[0, 1500], cap=50.0)
    # recurrentgemma-2b's local layers as its prefill runs them.
    for T in RG_T:
        yield RG, f"model prefill T={T}", dict(B=RG_B, T=T, vf=None,
                                                window=RG_WINDOW)


def _flash_inputs(gen, dtype, Hq, KV, hd, T=T_PREFILL, Bn=B):
    """q (Bn, T, Hq, hd), k and v (Bn, T, KV, hd): the model layout."""
    return (_randn(gen, (Bn, T, Hq, hd), dtype),
            _randn(gen, (Bn, T, KV, hd), dtype),
            _randn(gen, (Bn, T, KV, hd), dtype))


def _decode_pos(kind, cpos, S=S_CACHE):
    """Stored positions of a cache of S slots at cache_pos cpos: linear
    (slot == position), a ring (slot != position), or a ring as the
    model writes it (`wrap`: slot s holds the latest position p <= cpos
    with p % S == s); -1 past cpos."""
    s = torch.arange(S, device="cuda")
    if kind == "linear":
        pos = s
    elif kind == "wrap":
        pos = cpos - (cpos - s) % S
        return torch.where(pos >= 0, pos, -1).to(torch.int32)
    else:   # ring: slot != position
        pos = (s + 17) % (S - 3)
    return torch.where(pos <= cpos, pos, -1).to(torch.int32)


def _decode_cases():
    """(heads, case name, shape and masks) of the decode checks: at the
    stablelm heads those of earlier runs (cache_pos 700, linear and ring,
    a window, softcap, GQA rep 4); at every heads the main shape, the
    profile step's context (a row with nothing valid), a ring with a
    window and softcap, cache_pos and valid_from on the edges of the
    launch's chunks (`edge`), and a ring whose whole chunks hold only
    unwritten slots; the gemma2_9b heads also at S = 4096."""
    cpos = 700
    for kind in ("linear", "ring"):
        yield "stablelm_1_6b", kind, dict(kind=kind, cpos=cpos, vf=None)
        yield "stablelm_1_6b", f"{kind} vf", dict(
            kind=kind, cpos=cpos, vf=[0, 37, 512, cpos + 1])
    yield "stablelm_1_6b", "ring window", dict(
        kind="ring", cpos=cpos, vf=[0, 37, 512, 600], window=256)
    yield "stablelm_1_6b", "linear softcap", dict(
        kind="linear", cpos=cpos, vf=[0, 37, 512, 600], cap=30.0)
    yield "stablelm_1_6b", "linear GQA rep=4", dict(
        kind="linear", cpos=cpos, KV=8, vf=[0, 37, 512, 600])
    for heads in DECODE_HEADS:
        yield heads, "main", dict(kind="linear", cpos=DECODE_CPOS,
                                  vf=DECODE_VF)
        yield heads, f"context {DECODE_CTX}", dict(
            kind="linear", cpos=DECODE_CTX, vf=[0, 5, 33, DECODE_CTX + 1])
        yield heads, "ring window softcap", dict(
            kind="ring", cpos=DECODE_CPOS, vf=[0, 37, 300, 500], window=256,
            cap=50.0)
        yield heads, "cache_pos ends a chunk", dict(kind="linear", edge=1)
        yield heads, "cache_pos starts a chunk", dict(kind="linear", edge=2)
        yield heads, "ring, chunks of unwritten slots", dict(
            kind="ring", cpos=DECODE_CPOS, vf=[0, 37, 300, 500], holes=True)
    yield "gemma2_9b", "long S", dict(kind="linear", B=2, S=4096, cpos=4000,
                                      vf=[0, 1500])
    # recurrentgemma-2b's local layers' ring as its decode reads it:
    # full, just wrapped, 16 on, and after a prefill past the window.
    for cpos in (RG_WINDOW - 1, RG_WINDOW, RG_WINDOW + 15, RG_T[1] + 7):
        yield RG, f"model ring, cache_pos {cpos}", dict(
            kind="wrap", B=RG_B, S=RG_WINDOW, cpos=cpos, vf=None,
            window=RG_WINDOW)


def _dense_flash_cases():
    """(label, heads, case) of the dense models' prefill attention as
    their phase runs it: gemma2-9b's local layers (window, softcap) and
    global layers at its first group, and its second group; yi-9b and
    deepseek-coder-33b at the first group of stablelm's schedule (its
    ragged valid_from); chameleon-34b and musicgen-large at EMBED_T."""
    g2, vf_g2 = FLASH_HEADS["gemma2_9b"], [0] * B
    vf_sched = [T_SERVE - n for n in LENS_FIRST]
    T1, T2 = G2_GROUPS[0][0], G2_GROUPS[1][0]
    yield "gemma2_9b local", g2, dict(T=T1, vf=vf_g2, window=G2_WINDOW,
                                      cap=G2_CAP)
    yield "gemma2_9b global", g2, dict(T=T1, vf=vf_g2, cap=G2_CAP)
    yield "gemma2_9b second group", g2, dict(T=T2, vf=vf_g2,
                                             window=G2_WINDOW, cap=G2_CAP)
    for arch in ("yi_9b", "deepseek_coder_33b"):
        yield arch, FLASH_HEADS[arch], dict(T=T_SERVE, vf=vf_sched)
    yield "chameleon_34b", FLASH_HEADS["deepseek_coder_33b"], dict(
        T=EMBED_T, vf=None)
    yield "musicgen_large", FLASH_HEADS["stablelm_1_6b"], dict(T=EMBED_T,
                                                               vf=None)


def _dense_decode_cases():
    """(label, heads, case) of the dense models' decode attention as their
    phase runs it: gemma2-9b's local ring (linear=False) wrapped 10 steps
    after the first group, its global layers' linear G2_MAX_SEQ cache
    there, its local ring in the second group (not wrapped); yi-9b and
    deepseek-coder-33b 36 steps into the first group of stablelm's
    schedule; chameleon-34b and musicgen-large 8 steps after EMBED_T."""
    g2, vf_g2 = FLASH_HEADS["gemma2_9b"], [0] * B
    vf_sched = [T_SERVE - n for n in LENS_FIRST]
    c1, c2 = G2_GROUPS[0][0] + 10, G2_GROUPS[1][0] + 4
    ring = dict(S=G2_WINDOW, linear=False, window=G2_WINDOW, cap=G2_CAP,
                vf=vf_g2)
    yield "gemma2_9b local ring", g2, dict(ring, kind="wrap", cpos=c1)
    yield "gemma2_9b global", g2, dict(S=G2_MAX_SEQ, kind="linear", cpos=c1,
                                       linear=True, cap=G2_CAP, vf=vf_g2)
    yield "gemma2_9b local ring, second group", g2, dict(
        ring, kind="linear", cpos=c2)
    for arch in ("yi_9b", "deepseek_coder_33b"):
        yield arch, FLASH_HEADS[arch], dict(S=S_CACHE, kind="linear",
                                            cpos=T_SERVE + 36, linear=True,
                                            vf=vf_sched)
    for arch, heads in (("chameleon_34b", "deepseek_coder_33b"),
                        ("musicgen_large", "stablelm_1_6b")):
        yield arch, FLASH_HEADS[heads], dict(S=S_CACHE, kind="linear",
                                             cpos=EMBED_T + 8, linear=True,
                                             vf=None)


def _flash_work(Bn, T, vf, window, Hq, KV, hd, es):
    """(bytes, operations) of a prefill attention call: the rows of q, k
    and v from each row's valid_from on read once, the output written
    once, valid_from; two products of 2 FLOPs a multiply-add over the
    (query, key) pairs attended (causal, in the window, from
    valid_from)."""
    i = np.arange(T)
    pairs = rows = 0
    for b in range(Bn):
        v0 = 0 if vf is None else vf[b]
        lo = np.maximum(v0, i - window + 1) if window else np.full(T, v0)
        pairs += int(np.clip(i - lo + 1, 0, None)[i >= v0].sum())
        rows += max(0, T - v0)
    nbytes = (rows * (Hq + 2 * KV) + Bn * T * Hq) * hd * es \
        + (0 if vf is None else Bn * 4)
    return nbytes, 4 * hd * Hq * pairs


def _flash_mask(T, window, vf):
    """(B or 1, 1, T, T) bool: the (query, key) pairs a prefill attends
    (causal, in the window, from each row's valid_from), as SDPA's
    attn_mask."""
    pq = torch.arange(T, device="cuda")
    m = pq[None, :] <= pq[:, None]
    if window:
        m = m & (pq[None, :] > pq[:, None] - window)
    m = m[None]
    if vf is not None:
        m = m & (pq[None, None, :] >= vf[:, None, None])
    return m[:, None]


def _decode_work(pos, cpos, vf, window, Bn, Hq, KV, hd, es):
    """(bytes, operations, (B, S) attended slots) of a decode call: the K
    and V rows each batch row attends (stored position in [valid_from,
    cache_pos], in the window) read once, q and the output once, the
    stored positions of the slots any row attends, valid_from; two
    products of 2 FLOPs a multiply-add per attended row and q head."""
    ok = (pos >= 0) & (pos <= cpos)
    if window:
        ok &= pos > cpos - window
    att = ok[None].expand(Bn, -1) if vf is None else \
        ok[None] & (pos[None] >= vf[:, None])
    n = int(att.sum())
    nbytes = (n * KV * hd * 2 + 2 * Bn * Hq * hd) * es \
        + int(att.any(0).sum()) * 4 + (0 if vf is None else Bn * 4)
    return nbytes, 4 * hd * Hq * n, att


def _dense_attention_rows(gen, vft):
    """Check and time flash and decode at the dense models' shapes
    (_dense_flash_cases, _dense_decode_cases), fp32 and bf16: each
    against its plain version (TOL), then the kernel's time (with the
    softcap the model runs, and without it where it runs one: the
    library call has none), the plain version's, SDPA's (no softcap)
    and the bound; decode also L2-cold and its split plan. Returns
    (flash rows, decode rows, largest fp32 flash error, largest fp32
    decode error)."""
    from repro_torch.kernels import ops, ref as R
    from repro_torch.kernels.decode_attention import decode_plan
    sdpa = torch.nn.functional.scaled_dot_product_attention
    frows, drows, fworst, dworst = [], [], 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for label, (Hq, KV, hd), c in _dense_flash_cases():
            T, vf, es = c["T"], vft(c["vf"]), dtype.itemsize
            win, cap = c.get("window", 0), c.get("cap", 0.0)
            q, k, v = _flash_inputs(gen, dtype, Hq, KV, hd, T, B)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), \
                v.transpose(1, 2)
            run = lambda cap_=cap: ops.flash_attention_btHd(
                q, k, v, vf, window=win, softcap=cap_)
            plain = lambda: R.flash_attention_ref(qt, kt, vt, window=win,
                                                  cap=cap, valid_from=vf)
            err, ok = _close(run(), plain().transpose(1, 2), TOL[dtype])
            shape = (f"{label}: B={B} T=S={T} Hq={Hq} KV={KV} hd={hd} {dt} "
                     f"window={win} softcap={cap} valid_from={c['vf']}")
            log(f"flash dense {shape}: max_abs_err={err:.3e} "
                f"tol={TOL[dtype]} {'ok' if ok else 'FAIL'}")
            require(ok, f"flash dense {shape}")
            if dtype == torch.float32:
                fworst = max(fworst, err)
            nbytes, flops = _flash_work(B, T, c["vf"], win, Hq, KV, hd, es)
            tb, by = bound(nbytes, flops, dtype, FLASH_PEAK_FLOPS)
            mask = _flash_mask(T, win, vf)
            r = dict(heads=label, dtype=dt, hd=hd, max_abs_err=err,
                     tol=TOL[dtype], ms=bench_ms(run),
                     plain_ms=bench_ms(plain), bound_ms=tb, bound_by=by,
                     bound_fp32_cores_ms=bound(nbytes, flops,
                                               torch.float32)[0],
                     library_ms=bench_ms(lambda: sdpa(
                         qt, kt, vt, attn_mask=mask, enable_gqa=Hq != KV)),
                     shape=shape)
            if cap:
                r["ms_no_softcap"] = bench_ms(lambda: run(0.0))
            del q, k, v, qt, kt, vt, mask
            torch.cuda.empty_cache()
            frows.append(r)
            log(f"time flash_attention dense {shape}: {json.dumps(r)}")
        for label, (Hq, KV, hd), c in _dense_decode_cases():
            S, cpos, vfl = c["S"], c["cpos"], c["vf"]
            win, cap, linear = c.get("window", 0), c.get("cap", 0.0), \
                c["linear"]
            vf, es = vft(vfl), dtype.itemsize
            q, k, v = _decode_inputs(gen, dtype, Hq, KV, hd, S, B)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            pos = _decode_pos(c["kind"], cpos, S)
            cpt = torch.tensor(cpos, dtype=torch.int32, device="cuda")
            run = lambda k_=k, v_=v, cap_=cap: ops.decode_attention(
                q, k_, v_, pos, cpt, vf, window=win, softcap=cap_,
                linear=linear)
            plain = lambda: R.decode_attention_ref(
                q[:, 0], kt, vt, pos, cpt, cap=cap, window=win,
                valid_from=vf)
            err, ok = _close(run()[:, 0], plain(), TOL[dtype])
            shape = (f"{label}: B={B} S={S} cache_pos={cpos} Hq={Hq} KV={KV} "
                     f"hd={hd} {dt} {'linear' if linear else 'ring'} "
                     f"window={win} softcap={cap} valid_from={vfl}")
            log(f"decode dense {shape}: max_abs_err={err:.3e} "
                f"tol={TOL[dtype]} {'ok' if ok else 'FAIL'}")
            require(ok, f"decode dense {shape}")
            if dtype == torch.float32:
                dworst = max(dworst, err)
            nbytes, flops, att = _decode_work(pos, cpos, vf, win, B, Hq, KV,
                                              hd, es)
            tb, by = bound(nbytes, flops, dtype)
            # Copies of K and V whose attended rows fill the L2 4 times
            # over, as the timed rows above take them.
            attended = int(att.sum()) * KV * hd * 2 * es
            n = max(2, min(-(-4 * L2_BYTES // attended),
                           (4 << 30) // (k.nbytes + v.nbytes), COLD_COPIES))
            kv = [(k.clone(), v.clone()) for _ in range(n)]
            r = dict(heads=label, dtype=dt, cache_pos=cpos, max_abs_err=err,
                     tol=TOL[dtype], ms=bench_ms(run),
                     cold_ms=bench_cold_ms(lambda kv_: run(*kv_), kv),
                     plain_ms=bench_ms(plain), bound_ms=tb, bound_by=by,
                     library_ms=bench_ms(lambda: sdpa(
                         q.transpose(1, 2), kt, vt,
                         attn_mask=att[:, None, None, :],
                         enable_gqa=Hq != KV)),
                     plan=decode_plan(q[:, 0], kt, vt), shape=shape)
            if cap:
                r["ms_no_softcap"] = bench_ms(lambda: run(cap_=0.0))
            del q, k, v, kt, vt, kv, att
            torch.cuda.empty_cache()
            drows.append(r)
            log(f"time decode_attention dense {shape}: {json.dumps(r)}")
    return frows, drows, fworst, dworst


def _dense_int8_shapes():
    """{(M, K, N): the archs that run it} of the dense int8 candidates'
    projections (wq, wk / wv, wo, w_up / w_gate, w_down) at the decode M
    and at the prefill M of their runs: gemma2-9b's first group,
    yi-9b's and deepseek-coder-33b's serve prompts, chameleon-34b's
    EMBED_T."""
    from repro_torch.configs import get_config
    out = {}
    for arch, M in (("gemma2_9b", B * G2_GROUPS[0][0]),
                    ("yi_9b", B * T_SERVE),
                    ("deepseek_coder_33b", B * T_SERVE),
                    ("chameleon_34b", B * EMBED_T)):
        c = get_config(arch)
        d, f = c.d_model, c.d_ff
        hq, kv = c.q_heads_padded * c.head_dim, c.n_kv_heads * c.head_dim
        for m in (B, M):
            for K, N in ((d, hq), (d, kv), (hq, d), (d, f), (f, d)):
                archs = out.setdefault((m, K, N), [])
                if arch not in archs:
                    archs.append(arch)
    return out


def _edge_masks(chunk, edge):
    """cache_pos and valid_from on chunk edges: with edge = 1 cache_pos is
    a chunk's last slot, with edge = 2 the next chunk's first; valid_from
    starts rows at chunk starts, at cache_pos (one valid slot) and past
    it (nothing valid). The cache holds more than three chunks."""
    e = 2 * chunk   # the third chunk's first slot
    if edge == 1:
        return e - 1, [0, e - chunk, e - 1, e]
    return e, [e - chunk, e, e + 1, 0]


def _decode_inputs(gen, dtype, Hq, KV, hd, S=S_CACHE, Bn=B):
    """q (Bn, 1, Hq, hd), k and v (Bn, S, KV, hd): the model layout."""
    return (_randn(gen, (Bn, 1, Hq, hd), dtype),
            _randn(gen, (Bn, S, KV, hd), dtype),
            _randn(gen, (Bn, S, KV, hd), dtype))


def phase_kernels(results):
    from repro_torch.kernels import ops, ref as R
    from repro_torch.kernels.int8_matmul import prefill_plan, small_m_plan
    gen = torch.Generator(device="cuda").manual_seed(0)
    vft = lambda v: None if v is None else torch.tensor(
        v, dtype=torch.int32, device="cuda")

    # -- flash attention ---------------------------------------------------
    worst = 0.0
    errs = {}   # the largest error at each heads and dtype
    for dtype in (torch.float32, torch.bfloat16):
        for heads, name, c in _flash_cases():
            Hq, KV, hd = FLASH_HEADS[heads]
            T, KV, Bn = c["T"], c.get("KV", KV), c.get("B", B)
            q, k, v = _flash_inputs(gen, dtype, Hq, KV, hd, T, Bn)
            vf = vft(c["vf"])
            kw = dict(window=c.get("window", 0), softcap=c.get("cap", 0.0))
            out = ops.flash_attention_btHd(q, k, v, vf, **kw)
            ref = R.flash_attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                window=kw["window"], cap=kw["softcap"],
                valid_from=vf).transpose(1, 2)
            err, ok = _close(out, ref, TOL[dtype])
            if dtype == torch.float32:
                worst = max(worst, err)
            errs[heads, dtype] = max(errs.get((heads, dtype), 0.0), err)
            # bf16: both sides round an fp32 result once, so elements
            # differ only where the two fp32 results straddle a rounding
            # boundary; the share shows how close they were.
            neq = "" if dtype == torch.float32 else (
                f" unequal_to_plain={float((out != ref).float().mean()):.5f}")
            log(f"flash {str(dtype)[6:]} {heads} heads, {name}: B={Bn} "
                f"T={T} Hq={Hq} KV={KV} hd={hd} window={kw['window']} "
                f"softcap={kw['softcap']} vf={c['vf']} max_abs_err={err:.3e} "
                f"tol={TOL[dtype]}{neq} {'ok' if ok else 'FAIL'}")
            require(ok, f"flash {heads} {name} {dtype}")
            if c["vf"] is not None and c["vf"][-1] >= T:
                require(not out[-1].any(), "flash fully masked row != 0")
            del q, k, v, out, ref
    # Pins at each heads and dtype: valid_from = 0 gives the bits of
    # None, and two calls (another shape's call between) the same bits.
    fpins = {}
    vf = vft([0, 37, 64, 300])
    for dtype in (torch.float32, torch.bfloat16):
        for heads, (Hq, KV, hd) in FLASH_HEADS.items():
            q, k, v = _flash_inputs(gen, dtype, Hq, KV, hd)
            zero = torch.equal(
                ops.flash_attention_btHd(q, k, v, softcap=50.0),
                ops.flash_attention_btHd(q, k, v, vft([0] * B), softcap=50.0))
            first = ops.flash_attention_btHd(q, k, v, vf, softcap=50.0)
            ops.flash_attention_btHd(q[:, :100], k[:, :100], v[:, :100])
            same = torch.equal(ops.flash_attention_btHd(q, k, v, vf,
                                                        softcap=50.0), first)
            fpins[heads, dtype] = {"valid_from_zero_bit_identical": zero,
                                   "two_calls_bit_identical": same}
            log(f"flash pins {heads} heads hd={hd} {str(dtype)[6:]}: "
                f"valid_from=0 bit-identical to None: {zero}; two calls "
                f"bit-identical: {same}")
            require(zero and same, f"flash pins {heads} {dtype}")

    # -- decode attention --------------------------------------------------
    from repro_torch.kernels.decode_attention import decode_plan
    dworst = 0.0
    derrs = {}   # the largest error at each heads and dtype
    for dtype in (torch.float32, torch.bfloat16):
        for heads, name, c in _decode_cases():
            Hq, KV, hd = DECODE_HEADS[heads]
            KV, Bn, S = c.get("KV", KV), c.get("B", B), c.get("S", S_CACHE)
            q, k, v = _decode_inputs(gen, dtype, Hq, KV, hd, S, Bn)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            linear = c["kind"] == "linear"
            cpos, vfl = c.get("cpos", DECODE_CPOS), c.get("vf")
            plan = decode_plan(q[:, 0], kt, vt)
            if "edge" in c:
                cpos, vfl = _edge_masks(plan["chunk"], c["edge"])
            pos = _decode_pos(c["kind"], cpos, S)
            if c.get("holes"):   # chunks 1 and 2 hold only unwritten slots
                pos[plan["chunk"]:3 * plan["chunk"]] = -1
            vf = vft(vfl)
            kw = dict(window=c.get("window", 0), softcap=c.get("cap", 0.0))
            out = ops.decode_attention(q, k, v, pos, cpos, vf, linear=linear,
                                       **kw)
            ref = R.decode_attention_ref(q[:, 0], kt, vt, pos, cpos,
                                         cap=kw["softcap"],
                                         window=kw["window"], valid_from=vf)
            err, ok = _close(out[:, 0], ref, TOL[dtype])
            if dtype == torch.float32:
                dworst = max(dworst, err)
            derrs[heads, dtype] = max(derrs.get((heads, dtype), 0.0), err)
            log(f"decode {str(dtype)[6:]} {heads} heads, {name}: B={Bn} "
                f"S={S} Hq={Hq} KV={KV} hd={hd} cache_pos={cpos} vf={vfl} "
                f"window={kw['window']} softcap={kw['softcap']} "
                f"max_abs_err={err:.3e} tol={TOL[dtype]} plan={plan} "
                f"{'ok' if ok else 'FAIL'}")
            require(ok, f"decode {heads} {name} {dtype}")
            for row in range(Bn):   # nothing valid: exact zeros
                if vfl is not None and not bool(ref[row].any()):
                    require(not out[row].any(),
                            f"decode {heads} {name}: row {row} with nothing "
                            f"valid != 0")
            del q, k, v, kt, vt, out, ref
    # Pins at each heads and dtype: valid_from = 0 gives the bits of None,
    # the linear skip those of the full scan, and two calls (another
    # shape's call between) the same bits.
    dpins = {}
    pos = _decode_pos("linear", DECODE_CPOS)
    vf = vft(DECODE_VF)
    for dtype in (torch.float32, torch.bfloat16):
        for heads, (Hq, KV, hd) in DECODE_HEADS.items():
            q, k, v = _decode_inputs(gen, dtype, Hq, KV, hd)
            call = lambda vf_, linear: ops.decode_attention(
                q, k, v, pos, DECODE_CPOS, vf_, linear=linear, softcap=50.0)
            zero = torch.equal(call(None, True), call(vft([0] * B), True))
            first = call(vf, True)
            skip = torch.equal(first, call(vf, False))
            ops.decode_attention(q[:2], k[:2, :100], v[:2, :100], pos[:100],
                                 70)
            same = torch.equal(call(vf, True), first)
            dpins[heads, dtype] = {
                "valid_from_zero_bit_identical": zero,
                "linear_skip_bit_identical_to_full_scan": skip,
                "two_calls_bit_identical": same}
            log(f"decode pins {heads} heads {str(dtype)[6:]}: valid_from=0 "
                f"bit-identical to None: {zero}; linear skip bit-identical "
                f"to full scan: {skip}; two calls bit-identical: {same}")
            require(zero and skip and same, f"decode pins {heads} {dtype}")
            del q, k, v

    # -- int8 matmul -------------------------------------------------------
    iworst = 0.0
    ipins = {}
    dense_int8 = _dense_int8_shapes()
    int8_shapes = INT8_SHAPES + [s for s in dense_int8 if s not in INT8_SHAPES]
    for dtype in (torch.float32, torch.bfloat16):
        for M, K, N in int8_shapes:
            x = _randn(gen, (M, K), dtype)
            wq = torch.randint(-127, 128, (K, N), generator=gen,
                               device="cuda", dtype=torch.int8)
            sc = torch.rand((N,), generator=gen, device="cuda") * 1e-3
            out = ops.int8_matmul(x, wq, sc)
            ref = R.int8_matmul_ref(x, wq, sc)
            err = float((out.float() - ref.float()).abs().max())
            scale_ = max(1.0, float(ref.float().abs().max()))
            ok = err <= INT8_TOL[dtype] * scale_
            if dtype == torch.float32:
                iworst = max(iworst, err / scale_)
            log(f"int8 {str(dtype)[6:]} M={M} K={K} N={N}: "
                f"max_abs_err={err:.3e} max|ref|={scale_:.3e} "
                f"rel={err / scale_:.3e} tol={INT8_TOL[dtype]}*max|ref| "
                f"{'ok' if ok else 'FAIL'}")
            require(ok, f"int8 M={M} K={K} N={N} {dtype}")
            if M > 8 and dtype == torch.float32:
                exact = x.double() @ (wq.double() * sc.double())
                rel = float((out.double() - exact).abs().max()
                            / exact.abs().max())
                ok = rel <= INT8_PREFILL_F64_TOL
                log(f"int8 prefill fp32 M={M} K={K} N={N} vs float64: "
                    f"rel={rel:.3e} tol={INT8_PREFILL_F64_TOL} "
                    f"{'ok' if ok else 'FAIL'}")
                require(ok, f"int8 prefill M={M} K={K} N={N} vs float64")
                del exact
            if M <= B * T_SERVE:   # the decode path and a prefill M
                same = torch.equal(ops.int8_matmul(x, wq, sc), out)
                ipins[f"M={M} K={K} N={N} {str(dtype)[6:]}"] = same
                log(f"int8 pin M={M} K={K} N={N} {str(dtype)[6:]}: two "
                    f"calls bit-identical: {same}")
                require(same, f"int8 determinism M={M} K={K} N={N} "
                              f"{dtype}")
            del x, wq, sc, out, ref

    # -- times at the main path's shapes (fp32, as the model runs) ---------
    f32 = torch.float32
    # A ragged left-padded prefill.
    vfl = [T_PREFILL - n for n in (T_PREFILL, 300, 129, 37)]
    vf = vft(vfl)
    bool_mask = _flash_mask(T_PREFILL, 0, vf)
    frows = []
    for dtype in (f32, torch.bfloat16):
        for heads, (Hq, KV, hd) in FLASH_HEADS.items():
            q, k, v = _flash_inputs(gen, dtype, Hq, KV, hd)
            nbytes, flops = _flash_work(B, T_PREFILL, vfl, 0, Hq, KV, hd,
                                        q.element_size())
            tb, by = bound(nbytes, flops, dtype, FLASH_PEAK_FLOPS)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), \
                v.transpose(1, 2)
            r = dict(
                heads=heads, dtype=str(dtype)[6:], hd=hd,
                max_abs_err=errs[heads, dtype], tol=TOL[dtype],
                pins=fpins[heads, dtype],
                ms=bench_ms(lambda: ops.flash_attention_btHd(q, k, v, vf)),
                plain_ms=bench_ms(lambda: R.flash_attention_ref(
                    qt, kt, vt, valid_from=vf)),
                bound_ms=tb, bound_by=by,
                # The same work on the CUDA cores in fp32.
                bound_fp32_cores_ms=bound(nbytes, flops, f32)[0],
                # SDPA reads K and V unexpanded (GQA through enable_gqa).
                library_ms=bench_ms(lambda: torch.nn.functional
                                    .scaled_dot_product_attention(
                                        qt, kt, vt, attn_mask=bool_mask,
                                        enable_gqa=Hq != KV)),
                shape=f"{heads} heads: B={B} T=S={T_PREFILL} Hq={Hq} "
                      f"KV={KV} hd={hd} {str(dtype)[6:]} "
                      f"valid_from={vfl}")
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
            frows.append(r)
            log(f"time flash_attention {r['shape']}: {json.dumps(r)}")
    # recurrentgemma-2b's local layers at its prefill's shapes: no
    # valid_from, window 2048, so a query row attends min(i + 1, 2048)
    # keys; every row of q, k and v is read.
    Hq, KV, hd = RG_HEADS
    for dtype in (f32, torch.bfloat16):
        for T in RG_T:
            q, k, v = _flash_inputs(gen, dtype, Hq, KV, hd, T, RG_B)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), \
                v.transpose(1, 2)
            nbytes, flops = _flash_work(RG_B, T, None, RG_WINDOW, Hq, KV, hd,
                                        q.element_size())
            tb, by = bound(nbytes, flops, dtype, FLASH_PEAK_FLOPS)
            wmask = _flash_mask(T, RG_WINDOW, None)
            r = dict(
                heads="recurrentgemma_2b model", dtype=str(dtype)[6:], hd=hd,
                max_abs_err=errs[RG, dtype], tol=TOL[dtype],
                ms=bench_ms(lambda: ops.flash_attention_btHd(
                    q, k, v, window=RG_WINDOW)),
                plain_ms=bench_ms(lambda: R.flash_attention_ref(
                    qt, kt, vt, window=RG_WINDOW)),
                bound_ms=tb, bound_by=by,
                bound_fp32_cores_ms=bound(nbytes, flops, f32)[0],
                library_ms=bench_ms(lambda: torch.nn.functional
                                    .scaled_dot_product_attention(
                                        qt, kt, vt, attn_mask=wmask,
                                        enable_gqa=True)),
                shape=f"recurrentgemma_2b local layer: B={RG_B} T=S={T} "
                      f"Hq={Hq} KV={KV} hd={hd} {str(dtype)[6:]} window="
                      f"{RG_WINDOW} valid_from=None")
            del q, k, v, qt, kt, vt, wmask
            torch.cuda.empty_cache()
            frows.append(r)
            log(f"time flash_attention {r['shape']}: {json.dumps(r)}")
    # The dense models' attention, checked and timed (decode rows join
    # the decode timings below).
    dense_f, dense_d, fw, dw = _dense_attention_rows(gen, vft)
    frows += dense_f
    worst = max(worst, fw)
    main = frows[0]   # stablelm heads, fp32: the main path's shape
    results["flash_attention"] = dict(
        main, max_abs_err=worst, rows=frows,
        pins={p: all(r["pins"][p] for r in frows if "pins" in r)
              for p in main["pins"]},
        shape=main["shape"] + "; max_abs_err: the largest over every fp32 "
              "check; bound_ms: bytes (q, k and v from valid_from on) or "
              "operations at three TF32 passes (fp32) or one bf16 pass on "
              "the tensor cores; rows: each heads and dtype (timed without "
              "softcap, so SDPA computes the same function; the dense "
              "models' rows with the softcap they run, and ms_no_softcap "
              "beside SDPA)")

    drows = []
    for dtype in (f32, torch.bfloat16):
        for heads, cpos, Bn, S in (
                [(h, c, B, S_CACHE) for h in FLASH_HEADS
                 for c in (DECODE_CPOS, DECODE_CTX)]
                + [("gemma2_9b", 4000, 2, 4096)]):
            Hq, KV, hd = FLASH_HEADS[heads]
            vfl = (DECODE_VF if cpos == DECODE_CPOS else
                   [0, 1500] if S == 4096 else [0] * Bn)
            q, k, v = _decode_inputs(gen, dtype, Hq, KV, hd, S, Bn)
            pos = _decode_pos("linear", cpos, S)
            vf = vft(vfl)
            # cache_pos as the decode step passes it: one int32 on the card.
            cpt = torch.tensor(cpos, dtype=torch.int32, device="cuda")
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            es = q.element_size()
            nbytes, flops, dmask = _decode_work(pos, cpos, vf, 0, Bn, Hq, KV,
                                                hd, es)
            tb, by = bound(nbytes, flops, dtype)
            # Copies of K and V whose attended rows fill the L2 4 times
            # over (at most 4 GB of copies, and at most COLD_COPIES: the
            # 2 x copies calls must all queue behind one sleep).
            attended = int(dmask.sum()) * KV * hd * 2 * es
            n = max(2, min(-(-4 * L2_BYTES // attended),
                           (4 << 30) // (k.nbytes + v.nbytes), COLD_COPIES))
            kv = [(k.clone(), v.clone()) for _ in range(n)]
            r = dict(
                heads=heads, dtype=str(dtype)[6:], cache_pos=cpos,
                max_abs_err=derrs[heads, dtype], tol=TOL[dtype],
                pins=dpins[heads, dtype],
                ms=bench_ms(lambda: ops.decode_attention(
                    q, k, v, pos, cpt, vf, linear=True)),
                cold_ms=bench_cold_ms(lambda c: ops.decode_attention(
                    q, c[0], c[1], pos, cpt, vf, linear=True), kv),
                plain_ms=bench_ms(lambda: R.decode_attention_ref(
                    q[:, 0], kt, vt, pos, cpt, valid_from=vf)),
                bound_ms=tb, bound_by=by,
                # SDPA reads K and V unexpanded (GQA through enable_gqa).
                library_ms=bench_ms(lambda: torch.nn.functional
                                    .scaled_dot_product_attention(
                                        q.transpose(1, 2), kt, vt,
                                        attn_mask=dmask[:, None, None, :],
                                        enable_gqa=Hq != KV)),
                plan=decode_plan(q[:, 0], kt, vt),
                shape=f"{heads} heads: B={Bn} S={S} cache_pos={cpos} "
                      f"Hq={Hq} KV={KV} hd={hd} {str(dtype)[6:]} linear "
                      f"valid_from={vfl}")
            del q, k, v, kt, vt, kv
            torch.cuda.empty_cache()
            drows.append(r)
            log(f"time decode_attention {r['shape']}: {json.dumps(r)}")
    # recurrentgemma-2b's local layers at its decode's shape: a ring of
    # RG_WINDOW slots that has wrapped (linear=False), every slot in the
    # window, no valid_from.
    Hq, KV, hd = RG_HEADS
    cpos, S = RG_WINDOW + 15, RG_WINDOW
    for dtype in (f32, torch.bfloat16):
        q, k, v = _decode_inputs(gen, dtype, Hq, KV, hd, S, RG_B)
        pos = _decode_pos("wrap", cpos, S)
        cpt = torch.tensor(cpos, dtype=torch.int32, device="cuda")
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        nbytes, flops, dmask = _decode_work(pos, cpos, None, RG_WINDOW, RG_B,
                                            Hq, KV, hd, q.element_size())
        tb, by = bound(nbytes, flops, dtype)
        n = max(2, -(-4 * L2_BYTES // (k.nbytes + v.nbytes)))
        kv = [(k.clone(), v.clone()) for _ in range(n)]
        r = dict(
            heads="recurrentgemma_2b model", dtype=str(dtype)[6:],
            cache_pos=cpos, max_abs_err=derrs[RG, dtype], tol=TOL[dtype],
            ms=bench_ms(lambda: ops.decode_attention(
                q, k, v, pos, cpt, window=RG_WINDOW)),
            cold_ms=bench_cold_ms(lambda c: ops.decode_attention(
                q, c[0], c[1], pos, cpt, window=RG_WINDOW), kv),
            plain_ms=bench_ms(lambda: R.decode_attention_ref(
                q[:, 0], kt, vt, pos, cpt, window=RG_WINDOW)),
            bound_ms=tb, bound_by=by,
            library_ms=bench_ms(lambda: torch.nn.functional
                                .scaled_dot_product_attention(
                                    q.transpose(1, 2), kt, vt,
                                    attn_mask=dmask[:, None, None, :],
                                    enable_gqa=True)),
            plan=decode_plan(q[:, 0], kt, vt),
            shape=f"recurrentgemma_2b local layer: B={RG_B} S={S} ring "
                  f"(linear=False), wrapped, cache_pos={cpos} Hq={Hq} "
                  f"KV={KV} hd={hd} {str(dtype)[6:]} window={RG_WINDOW} "
                  f"valid_from=None")
        del q, k, v, kt, vt, kv
        torch.cuda.empty_cache()
        drows.append(r)
        log(f"time decode_attention {r['shape']}: {json.dumps(r)}")
    drows += dense_d
    dworst = max(dworst, dw)
    main = drows[0]   # stablelm heads, fp32, cache_pos 528
    results["decode_attention"] = dict(
        main, max_abs_err=dworst, rows=drows,
        pins={p: all(v[p] for v in dpins.values()) for p in main["pins"]},
        shape=main["shape"] + "; max_abs_err: the largest over every fp32 "
              "check; bound_ms: bytes of the attended K and V rows; "
              "cold_ms: K and V cold in L2; rows: each heads, dtype and "
              "cache_pos (S = 4096 for gemma2_9b's last), then the dense "
              "models' as they run them; plan: the "
              "launch's split (splits blocks a group, one cluster; block "
              "c takes chunks c, c + splits, ... of the cache axis)")

    rows = {}
    for M, K, N in int8_shapes:
        x = _randn(gen, (M, K), f32)
        wq = torch.randint(-127, 128, (K, N), generator=gen,
                           device="cuda", dtype=torch.int8)
        sc = torch.rand((N,), generator=gen, device="cuda") * 1e-3
        wd = wq.float() * sc
        nbytes = M * K * 4 + K * N + N * 4 + M * N * 4
        if M > B:
            # The prefill path: two bf16 mma passes (hi and lo parts
            # of fp32 x) on the tensor cores; beside it the bound of
            # the same product on the CUDA cores in fp32.
            tb, by = bound(nbytes, 2 * 2 * M * K * N, torch.bfloat16)
        else:
            tb, by = bound(nbytes, 2 * M * K * N, f32)
        r = dict(ms=bench_ms(lambda: ops.int8_matmul(x, wq, sc)),
                 plain_ms=bench_ms(lambda: R.int8_matmul_ref(x, wq, sc)),
                 bound_ms=tb, bound_by=by,
                 library_ms=bench_ms(lambda: torch.matmul(x, wd)))
        if M > B:
            r["bound_fp32_cores_ms"] = bound(nbytes, 2 * M * K * N,
                                             f32)[0]
            r["plan"] = prefill_plan(x, wq)
        else:
            r["cold_ms"] = bench_cold_ms(
                lambda w: ops.int8_matmul(x, w, sc), copies(wq))
            r["library_cold_ms"] = bench_cold_ms(
                lambda w: torch.matmul(x, w), copies(wd))
            torch.cuda.empty_cache()
            # What does not scale with K: the same call on 32 rows
            # of K, and an empty kernel's launch; and the host's pace.
            x32, w32 = x[:, :32].contiguous(), wq[:32]
            r["k32_ms"] = bench_ms(lambda: ops.int8_matmul(x32, w32, sc))
            r["empty_launch_ms"] = bench_ms(lambda: torch.cuda._sleep(0))
            r["enqueue_ms"] = bench_ms(lambda: ops.int8_matmul(x, wq, sc),
                                       queued=False)
            # The grid the launcher chose, and how many of its
            # clusters the card runs at once.
            r["grid"] = small_m_plan(N, K)
        rows[(M, K, N)] = r
        log(f"time int8_matmul M={M} K={K} N={N} fp32: "
            f"{json.dumps(r)}")
    results["int8_matmul"] = dict(
        rows[(B, D, F)], max_abs_err=iworst, pins=ipins,
        small_m=[dict(K=K, N=N, **rows[(B, K, N)]) for K, N in PROJ_KN],
        prefill=[dict(M=M, K=K, N=N, **rows[(M, K, N)])
                 for M in INT8_M[1:] for K, N in PROJ_KN],
        recurrentgemma=[dict(M=M, K=K, N=N, **rows[(M, K, N)])
                        for M, K, N in INT8_SHAPES[len(INT8_M) *
                                                   len(PROJ_KN):]],
        dense=[dict(archs=dense_int8[M, K, N], M=M, K=K, N=N,
                    **rows[(M, K, N)]) for M, K, N in dense_int8],
        shape=f"M={B} K={D} N={F} fp32 (decode w_up); max_abs_err is "
              f"relative to max|ref|; cold_ms: weights cold in L2; "
              f"small_m: the three decode shapes; prefill: the M > 8 path "
              f"at the serve and model phases' prefill M, its bound_ms "
              f"at the bf16 tensor-core rate for two passes; "
              f"recurrentgemma: recurrentgemma-2b's projections at the "
              f"decode M and a T={RG_T[0]} group's prefill M; dense: the "
              f"dense int8 candidates' projections at the decode M and "
              f"their prefill M")
    for name in ("flash_attention", "decode_attention"):
        log(f"time {name}: {json.dumps(results[name])}")
    _queue_scan_checks(results)
    _cluster_scan_checks(results)


def _queue_inputs(gen, n, ties):
    """Open-loop queue inputs on the card: arrivals plus uploads (mean
    gap 2 ms), lognormal execution times and the p95, outage and active
    gates; with `ties`, bursts of 4 at one instant and equal execution
    times, so the servers' free times tie."""
    f64 = dict(dtype=torch.float64, device="cuda")
    a = torch.cumsum(torch.empty(n, **f64).exponential_(0.5, generator=gen),
                     0)
    e = torch.empty(n, **f64).log_normal_(2.0, 0.5, generator=gen)
    if ties:
        a = torch.repeat_interleave(a[:(n + 3) // 4], 4)[:n]
        e = torch.full((n,), 8.0, **f64)
    gates = [torch.rand(n, generator=gen, device="cuda") < p
             for p in (0.5, 0.1, 0.9)]
    return [a, e, *gates]


def _sm_clock_mhz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0])


def _queue_scan_checks(results):
    """queue_scan against its plain version (the host loop) bit for bit
    at QUEUE_N requests for each server count and at QUEUE_BIG_N on
    QUEUE_BIG_SERVERS, with and without ties, then timed at QUEUE_TIME_N
    beside its bound: the larger of its bytes over the HBM rate and its
    dependent chain, ceil(log2 S) + 2 links a
    request (the min over S free times, the max, the add) at the fp64
    add latency the card measures, at its highest SM clock."""
    from repro_torch.kernels import queue_scan as QS, ref as R
    gen = torch.Generator(device="cuda").manual_seed(1)
    thr = 0.05 * SCAN_T_SLA
    worst = 0.0
    for n, S in ([(QUEUE_N, S) for S in QUEUE_SERVERS]
                 + [(QUEUE_BIG_N, QUEUE_BIG_SERVERS)]):
        for ties in (False, True):
            cols = _queue_inputs(gen, n, ties)
            q, h = QS.queue_scan(*cols, S, thr)
            wq, wh = R.queue_scan_ref(*(c.cpu() for c in cols), S, thr)
            torch.cuda.synchronize()
            err = float((q.cpu() - wq).abs().max())
            worst = max(worst, err)
            same = torch.equal(q.cpu(), wq) and int(h) == int(wh)
            log(f"queue_scan N={n} S={S} ties={ties}: hedges "
                f"{int(h)} (plain {int(wh)}), waiting {int((wq > 0).sum())}"
                f", max_abs_err={err:.3e} "
                f"{'bit for bit' if same else 'FAIL'}")
            require(same, f"queue_scan S={S} ties={ties} bit for bit")
    N, S = QUEUE_TIME_N, QUEUE_TIME_SERVERS
    cols = _queue_inputs(gen, N, False)
    QS.queue_scan(*cols, S, thr)
    e0, e1 = _events()
    torch.cuda.synchronize()
    e0.record()
    for _ in range(3):
        q, h = QS.queue_scan(*cols, S, thr)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / 3
    host = [c.cpu() for c in cols]
    t0 = time.perf_counter()
    wq, wh = R.queue_scan_ref(*host, S, thr)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((q.cpu() - wq).abs().max())
    require(torch.equal(q.cpu(), wq) and int(h) == int(wh),
            f"queue_scan N={N} bit for bit")
    cycles = QS.fp64_add_cycles()
    clock = _sm_clock_mhz()
    links = math.ceil(math.log2(S)) + 2
    chain_ms = N * links * cycles / (clock * 1e6) * 1e3
    bytes_ms = N * QUEUE_BYTES / PEAK_BYTES_S * 1e3
    bound_ms, by = ((chain_ms, "operations") if chain_ms >= bytes_ms
                    else (bytes_ms, "bytes"))
    results["queue_scan"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
        library_ms=None, max_abs_err=max(worst, err),
        pins={"bit_for_bit_plain": True},
        bound_bytes_ms=bytes_ms, bound_chain_ms=chain_ms,
        fp64_add_cycles=cycles, chain_links=links, sm_clock_mhz=clock,
        cycles_per_request=ms * 1e-3 * clock * 1e6 / N,
        shape=f"N={N} S={S} fp64 (ms: CUDA events, 3 calls); plain_ms: "
              f"the host loop (kernels.ref.queue_scan_ref), one call; "
              f"library_ms: no PyTorch call computes the recurrence; "
              f"bound_ms: the dependent chain ({links} fp64 links a "
              f"request at {cycles:.2f} cycles, {clock:.0f} MHz) over "
              f"bytes ({QUEUE_BYTES} B a request at 3.35 TB/s); checked "
              f"bit for bit at N={QUEUE_N} for S in {QUEUE_SERVERS} and "
              f"at N={QUEUE_BIG_N} for S={QUEUE_BIG_SERVERS}, "
              f"with and without ties")
    log(f"time queue_scan: {json.dumps(results['queue_scan'])}")


# --------------------------------------------------------------------------
# cluster_scan (the scan cluster engine's request-axis scan)
# --------------------------------------------------------------------------

def cluster_inputs(seed, R, K, n, *, has_budget, kinds="mixed", ties=False,
                   tight=True, degr_p=0.5):
    """xs, init and const of the cluster scan as numpy arrays of the
    reference program's dtypes (src/repro/serving/cluster_engine.py:626-
    642), drawn from `seed`: arrivals in bursts at one instant, two
    upload times, equal free times, capacities and last uses where
    `ties`; a budget of a fifth of all models' bytes where `tight`
    (several victims for one request), of 60% otherwise; a share
    `degr_p` of degraded requests (which hedge). `kinds`: "mixed"
    (cnnselect, random and precomputed replicas in turn), "cnn" (every
    replica cnnselect, as the cluster's SimReplicaStacks) or "det"
    (precomputed only: no CDF, one u and ri column)."""
    rng = np.random.default_rng(seed)
    E = R * K
    gap = rng.exponential(12.0, n)
    if ties:
        gap = np.where(rng.random(n) < 0.5, 0.0, np.round(gap))
    arr = np.cumsum(gap)
    ti = (rng.choice([20.0, 35.0], n) if ties
          else rng.lognormal(np.log(30.0), 0.5, n))
    slac = rng.choice([150.0, 300.0, 600.0], n)
    has = rng.random(n) < 0.8
    kind = {"mixed": np.array([(1, 2, 0)[r % 3] for r in range(R)]),
            "cnn": np.ones(R), "det": np.zeros(R)}[kinds].astype(np.int32)
    cnn, rnd = bool((kind == 1).any()), bool((kind == 2).any())
    p = rng.random((n, R, K)) + 1e-3
    cdf = np.cumsum(p, axis=-1)
    cdf /= cdf[..., -1:]
    mu = rng.uniform(5.0, 120.0, E)
    if ties:
        mu = np.round(mu)
    sizes = rng.integers(10_000_000, 120_000_000, E).astype(np.int64)
    hot0 = rng.random(E) < 0.5
    xs = dict(
        arr=arr, ti=ti, slac=slac, slar=np.where(has, slac, 1e9), has=has,
        prio=rng.choice([0.0, 1.0, 2.0], n),
        od=np.where(rng.random(n) < 0.7, rng.uniform(50.0, 400.0, n), 0.0),
        degr=rng.random(n) < degr_p,
        al=rng.choice([-1, 0, 0, 0, 0, 1], n).astype(np.int8),
        sel=rng.integers(0, K, (n, R)).astype(np.int32),
        cdf=cdf if cnn else np.zeros((n, R, 0)))
    const = dict(
        mu=mu, sgp=rng.uniform(0.5, 10.0, E) + 1e-9, p1mu=0.1 * mu,
        xmu=np.where(rng.random(E) < 0.7, rng.uniform(10.0, 300.0, E),
                     0.0),
        xsgp=rng.uniform(0.0, 20.0, E) + 1e-9, sizes=sizes,
        cap=(rng.choice([1.0, 2.0], R) if ties
             else rng.uniform(0.5, 3.0, R)),
        speed=rng.choice([1.0, 1.5, 2.0], R), kind=kind,
        u=rng.random((R, n if cnn else 1)),
        ri=rng.integers(0, K, (R, n if rnd else 1)).astype(np.int32),
        z=rng.standard_normal((R, 2 * n)),
        budget=np.int64(int(sizes.sum() * (0.2 if tight else 0.6))
                        if has_budget else 0),
        min_active=np.int32(1), hedge=np.bool_(True),
        shed_factor=np.float64(rng.choice([0.5, 1.0, 1e9])),
        headroom=np.float64(0.25))
    last0 = (np.where(hot0, -5.0, 0.0) if ties
             else np.where(hot0, -rng.uniform(0.0, 50.0, E), 0.0))
    init = (np.full(R, 10.0) if ties else rng.uniform(0.0, 50.0, R),
            hot0, last0, np.int64(sizes[hot0].sum()),
            np.int32(rng.integers(1, R + 1)), np.zeros(R, np.int32),
            np.zeros(R, np.int32))
    return xs, init, const


def cluster_tensors(xs, init, const, device):
    """cluster_inputs' arrays as tensors of the same dtypes on device."""
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    return ({k: t(v) for k, v in xs.items()}, tuple(t(v) for v in init),
            {k: t(v) for k, v in const.items()})


def cluster_scan_diff(got, want):
    """(names of the outputs that differ in any bit, largest absolute
    difference of the float ones) between two cluster_scan results
    ((carry, ys) pairs, any devices)."""
    (gc, gy), (wc, wy) = got, want
    pairs = ([(k, gy.get(k), wy[k]) for k in wy]
             + list(zip(("free", "hot", "last", "hb", "n_act", "up", "zp"),
                        gc, wc)))
    bad, err = [], 0.0
    for name, g, w in pairs:
        if g is None:
            bad.append(name)
            continue
        g, w = g.cpu(), w.cpu()
        if w.dtype == torch.float64:
            same = g.dtype == w.dtype and torch.equal(
                g.view(torch.int64), w.view(torch.int64))
            err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
        else:
            same = g.dtype == w.dtype and torch.equal(g, w)
        if not same:
            bad.append(name)
    return bad + sorted(set(gy) - set(wy)), err


def _cluster_scan_checks(results):
    """cluster_scan against its plain version (the host loop) bit for bit
    at CLUSTER_KERNEL_N requests for each (R, K) of CLUSTER_KERNEL_SHAPES,
    with and without a budget, with and without ties, then timed at
    CLUSTER_TIME_N requests on the main path's 3 replicas x 3 models
    (every replica cnnselect, no budget) beside its bound: the larger of
    its bytes (every input read once, every output written once) over
    the HBM rate and its dependent fp64 chain through the free times,
    ceil(log2 R) + 5 links a request (a delay's subtract and max, the
    min over the active replicas, the compare that picks the replica,
    the max with the arrival, the add of the execution time), at the
    fp64 add latency the card measures, at its highest SM clock."""
    from repro_torch.kernels import cluster_scan as CS, queue_scan as QS
    from repro_torch.kernels import ref as R
    worst = 0.0
    for (Rn, K), has_budget, ties in itertools.product(
            CLUSTER_KERNEL_SHAPES, (True, False), (False, True)):
        xs, init, const = cluster_inputs(
            Rn * 100 + K * 10 + ties, Rn, K, CLUSTER_KERNEL_N,
            has_budget=has_budget, ties=ties)
        dev = cluster_tensors(xs, init, const, "cuda")
        got = CS.cluster_scan(*dev, has_budget)
        want = R.cluster_scan_ref(*cluster_tensors(xs, init, const, "cpu"),
                                  has_budget)
        torch.cuda.synchronize()
        bad, err = cluster_scan_diff(got, want)
        worst = max(worst, err)
        ys = want[1]
        log(f"cluster_scan R={Rn} K={K} N={CLUSTER_KERNEL_N} budget="
            f"{has_budget} ties={ties}: hedged {int(ys['hedged'].sum())}, "
            f"shed {int(ys['shed'].sum())}, victims "
            f"{int((ys['vict1'] >= 0).sum()) if has_budget else 0}, "
            f"max_abs_err={err:.3e} "
            f"{'bit for bit' if not bad else 'FAIL ' + ','.join(bad)}")
        require(not bad, f"cluster_scan R={Rn} K={K} budget={has_budget} "
                         f"ties={ties} bit for bit: {bad}")
    N = CLUSTER_TIME_N
    xs, init, const = cluster_inputs(N, 3, 3, N, has_budget=False,
                                     kinds="cnn", tight=False)
    dev = cluster_tensors(xs, init, const, "cuda")
    CS.cluster_scan(*dev, False)
    e0, e1 = _events()
    torch.cuda.synchronize()
    e0.record()
    for _ in range(3):
        got = CS.cluster_scan(*dev, False)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / 3
    host = cluster_tensors(xs, init, const, "cpu")
    t0 = time.perf_counter()
    want = R.cluster_scan_ref(*host, False)
    plain_ms = (time.perf_counter() - t0) * 1e3
    bad, err = cluster_scan_diff(got, want)
    require(not bad, f"cluster_scan N={N} bit for bit: {bad}")
    nbytes = (sum(t.nbytes for t in host[0].values())
              + sum(t.nbytes for t in host[1])
              + sum(t.nbytes for t in host[2].values())
              + sum(t.nbytes for t in want[0])
              + sum(t.nbytes for t in want[1].values()))
    cycles = QS.fp64_add_cycles()
    clock = _sm_clock_mhz()
    links = math.ceil(math.log2(3)) + 5
    chain_ms = N * links * cycles / (clock * 1e6) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    bound_ms, by = ((chain_ms, "operations") if chain_ms >= bytes_ms
                    else (bytes_ms, "bytes"))
    results["cluster_scan"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
        library_ms=None, max_abs_err=max(worst, err),
        pins={"bit_for_bit_plain": True},
        bound_bytes_ms=bytes_ms, bound_chain_ms=chain_ms,
        fp64_add_cycles=cycles, chain_links=links, sm_clock_mhz=clock,
        cycles_per_request=ms * 1e-3 * clock * 1e6 / N,
        shape=f"N={N} R=3 K=3, every replica cnnselect, no budget (ms: "
              f"CUDA events, 3 calls); plain_ms: the host loop "
              f"(kernels.ref.cluster_scan_ref), one call; library_ms: no "
              f"PyTorch call computes the scan; bound_ms: the dependent "
              f"chain through the free times ({links} fp64 links a "
              f"request at {cycles:.2f} cycles, {clock:.0f} MHz) over "
              f"bytes ({nbytes} B in and out at 3.35 TB/s); checked bit "
              f"for bit at N={CLUSTER_KERNEL_N} for (R, K) in "
              f"{CLUSTER_KERNEL_SHAPES}, with and without a budget and "
              f"ties")
    log(f"time cluster_scan: {json.dumps(results['cluster_scan'])}")


# --------------------------------------------------------------------------
# Phase: model
# --------------------------------------------------------------------------

def _full_width(attn_impl):
    from repro_torch.configs import get_config
    return get_config("stablelm_1_6b", attn_impl=attn_impl)


def _build_params():
    from repro_torch.models import init_params
    from repro_torch.quant.int8 import quantize_exec_tree, \
        tree_bytes_quantized
    t0 = time.perf_counter()
    p32 = init_params(_full_width("cuda"), seed=0, device="cuda")
    p8 = quantize_exec_tree(p32)
    torch.cuda.synchronize()
    log(f"params: fp32 {tree_bytes_quantized(p32) / 1e9:.3f} GB, int8 "
        f"{tree_bytes_quantized(p8) / 1e9:.3f} GB (embeddings and norms "
        f"shared) in {time.perf_counter() - t0:.1f} s")
    return p32, p8


def _dequantized(tree):
    """The int8 execution tree with each {"q", "scale"} leaf replaced by
    q.float() * scale: the plain version's arithmetic (dequantize, then
    an fp32 torch.matmul), with no int8 kernel on the way."""
    if isinstance(tree, dict):
        if set(tree) == {"q", "scale"}:
            return tree["q"].float() * tree["scale"]
        return {k: _dequantized(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_dequantized(v) for v in tree)
    return tree


def tree_by_group(cfg, seed, device="cuda", quantize=True):
    """Random weights of cfg from `seed`, built one scan group at a time:
    each group's slice of a projection leaf is drawn in fp32 on `device`
    and, with `quantize`, turned into int8 by the package's own
    per-output-channel rule (`quant.int8._quantize_matmul`) and written
    into preallocated int8 `q` / fp32 `scale` stacks, so no whole fp32
    stack ever exists (a 34 B model's fp32 tree does not fit the card).
    A stacked leaf's amax already excludes the group axis, so this
    equals `quantize_exec_tree` of the fp32 tree that quantize=False
    stacks from the same draws, bit for bit (tests/test_torch_dense.py).
    Every other leaf is drawn whole, as `init_params` draws it."""
    from repro_torch.models import params as pmod
    from repro_torch.quant.int8 import PROJ_OUT_AXES, _quantize_matmul
    if cfg.tail_kinds:
        raise ValueError(f"{cfg.name}: tail layers are not built by group")
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = torch.float32

    def draw(shape, init, stacked=False):
        return pmod._draw(gen, shape, init, f32, device, stacked=stacked)

    def fill(d):
        out = {}
        for key, leaf in d.items():
            if isinstance(leaf, dict):
                out[key] = fill(leaf)
                continue
            shape, init, n = leaf
            if key not in PROJ_OUT_AXES:
                out[key] = draw((n,) + shape, init, stacked=True)
            elif not quantize:
                out[key] = torch.stack([draw(shape, init) for _ in range(n)])
            else:
                q = torch.empty((n,) + shape, dtype=torch.int8, device=device)
                scale = None
                for g in range(n):
                    part = _quantize_matmul(draw(shape, init),
                                            PROJ_OUT_AXES[key], stacked=False)
                    if scale is None:
                        scale = torch.empty((n,) + part["scale"].shape,
                                            dtype=f32, device=device)
                    q[g], scale[g] = part["q"], part["scale"]
                    del part
                out[key] = {"q": q, "scale": scale}
        return out
    # Stacked leaves come back from model_tree as (shape, init, groups)
    # and are drawn by `fill`, in the tree's order.
    tree = pmod.model_tree(cfg, lambda shape, axes, init: draw(shape, init),
                           lambda shape, axes, init, n: (shape, init, n))
    tree["blocks"] = tuple(fill(b) for b in tree["blocks"])
    return tree


def _cuda_vs_naive(label, cfg, params, naive_params, toks, vf, forced,
                   max_seq):
    """A prefill of toks (valid_from vf) and a teacher-forced decode step
    for each of `forced`, through `models.model` on the "cuda" path with
    params and on the "naive" path with naive_params: the same tree, or
    the dequantized one of an int8 tree (whose naive run must then
    launch no int8 kernel). The naive run launches no attention kernel.
    Returns the (steps, B, V) logits of each."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import decode_step, prefill
    runs = {}
    T = toks.shape[1]
    for impl, p in (("cuda", params), ("naive", naive_params)):
        c = dataclasses.replace(cfg, attn_impl=impl)
        before = ops.launch_counts()
        with torch.no_grad():
            lg, cache = prefill(p, toks, c, max_seq, logits_last_only=True,
                                valid_from=vf)
            steps = [lg[:, 0]]
            for s, tok in enumerate(forced):
                lg, cache = decode_step(p, tok, cache, T + s, c,
                                        valid_from=vf)
                steps.append(lg[:, 0])
        runs[impl] = torch.stack(steps)
        del cache
        if impl == "naive":
            after = ops.launch_counts()
            quiet = ["flash_attention", "decode_attention"] + (
                ["int8_matmul"] if naive_params is not params else [])
            for name in quiet:
                require(after[name] == before[name],
                        f"{label}: the naive run launched {name}")
    require(bool(torch.isfinite(runs["cuda"]).all()),
            f"{label}: non-finite logits")
    return runs["cuda"], runs["naive"]


def _worst_rel(label, a, b, tol=LOGIT_TOL):
    """The largest |a - b| / max|b| over the steps (the leading axis);
    each step must stay within tol."""
    rels = [float((a[s] - b[s]).abs().max() / b[s].abs().max())
            for s in range(a.shape[0])]
    require(max(rels) <= tol, f"{label}: max |dlogit|/max|logit| by step "
                              f"{[f'{r:.2e}' for r in rels]} (tol {tol})")
    return max(rels)


def phase_model(p32, p8):
    from repro_torch.serving.engine import InferenceEngine
    rng = np.random.default_rng(0)
    V = _full_width("cuda").vocab
    lens = np.array([T_PREFILL, 300, 129, 37])
    toks = torch.as_tensor(rng.integers(0, V, (B, T_PREFILL)),
                           dtype=torch.int32, device="cuda")
    vf = torch.as_tensor(T_PREFILL - lens, dtype=torch.int32, device="cuda")
    forced = [torch.as_tensor(f, dtype=torch.int32, device="cuda")
              for f in rng.integers(0, V, (16, B, 1))]
    # The naive run of int8 takes the dequantized tree, so the int8
    # kernel's prefill and decode paths are held against plain fp32
    # arithmetic at full width.
    for label, params in (("fp32", p32), ("int8", p8)):
        naive_p = _dequantized(p8) if label == "int8" else params
        a, b = _cuda_vs_naive(label, _full_width("cuda"), params, naive_p,
                              toks, vf, forced, S_CACHE)
        del naive_p
        torch.cuda.empty_cache()
        worst = _worst_rel(label, a, b)
        log(f"model {label}: stablelm-1.6b full width, prefill B={B} "
            f"T={T_PREFILL} lengths={lens.tolist()} + 16 decode steps, cuda "
            f"vs naive{' (dequantized weights)' if label == 'int8' else ''}: "
            f"max |dlogit|/max|logit| = {worst:.3e} over 17 steps "
            f"(tol {LOGIT_TOL}); max|logit|={float(b.abs().max()):.2f}")

    # prefill_row backfill against a from-scratch prefill (fp32, cuda).
    cfg = _full_width("cuda")
    P = 256
    eng = InferenceEngine(cfg, p32, batch_size=B, max_seq=S_CACHE)
    ref = InferenceEngine(cfg, p32, batch_size=B, max_seq=S_CACHE)
    prompts = rng.integers(0, V, (B, P)).astype(np.int32)
    p_new = rng.integers(0, V, 100).astype(np.int32)
    with torch.no_grad():
        logits = eng.run_prefill(prompts)
        hist = prompts.copy()
        for _ in range(2):
            nxt = logits.argmax(-1).astype(np.int32)
            hist = np.concatenate([hist, nxt[:, None]], axis=1)
            logits = eng.run_decode(nxt[:, None])
        joined = np.zeros(P, np.int32)
        joined[P - len(p_new):] = p_new
        lj = eng.prefill_row(joined, 0, length=len(p_new))
        row0 = np.zeros(P + 2, np.int32)
        row0[P + 2 - len(p_new):] = p_new
        full = np.concatenate([row0[None], hist[1:]], axis=0)
        lr = ref.run_prefill(full, lengths=[len(p_new)] + [P + 2] * (B - 1))
        nxt = np.concatenate([[lj.argmax(-1)], logits[1:].argmax(-1)])
        nxt = nxt.astype(np.int32)[:, None]
        d1, d2 = eng.run_decode(nxt), ref.run_decode(nxt)
    rel = max(np.abs(lj - lr[0]).max() / np.abs(lr[0]).max(),
              np.abs(logits[1:] - lr[1:]).max() / np.abs(lr[1:]).max(),
              np.abs(d1 - d2).max() / np.abs(d2).max())
    log(f"model backfill: prefill_row (100 real tokens into slot 0 at "
        f"cache_pos {P + 2}) vs from-scratch prefill, then one decode: "
        f"max rel dlogit = {rel:.3e} (tol {LOGIT_TOL})")
    require(rel <= LOGIT_TOL and eng.stats.backfill_calls == 1,
            "backfill vs from-scratch prefill")
    del eng, ref
    torch.cuda.empty_cache()

    # The engine's CUDA graphs against models.model run eagerly.
    for label, params in (("fp32", p32), ("int8", p8)):
        _graphs_vs_eager(label, params, rng)


# A group at T_SERVE (ragged), GRAPH_STEPS decode steps with a backfill
# into slot 1 (BACKFILL_LEN real tokens) before step BACKFILL_AT, then a
# group at the shorter T_SECOND and 4 decode steps.
GRAPH_STEPS, BACKFILL_AT, BACKFILL_LEN, T_SECOND = 40, 12, 30, 32
LENS_FIRST, LENS_SECOND = [T_SERVE, 17, 50, 1], [T_SECOND, 9, T_SECOND, 20]


def _engine_steps(eng, fed):
    """The plan above through the engine (graphs on the card): its
    logits at every step, in order. fed: the prompts (first group,
    backfill row, second group)."""
    out = [eng.run_prefill(fed[0], lengths=LENS_FIRST)]
    for i in range(GRAPH_STEPS):
        nxt = out[-1].argmax(-1).astype(np.int32)[:, None]
        if i == BACKFILL_AT:
            out.append(eng.prefill_row(fed[1], 1, length=BACKFILL_LEN))
            nxt[1, 0] = out[-1].argmax(-1)
        out.append(eng.run_decode(nxt))
    out.append(eng.run_prefill(fed[2], lengths=LENS_SECOND))
    for _ in range(4):
        out.append(eng.run_decode(out[-1].argmax(-1).astype(np.int32)
                                  [:, None]))
    return out


def _model_steps(cfg, params, fed):
    """The same plan through `models.model`, eagerly, on a fresh cache a
    group; the backfill's row through `forward` on a fresh row cache,
    merged as the engine merges it."""
    from repro_torch.models.model import (decode_step, forward, init_cache,
                                          prefill)
    from repro_torch.serving.engine import InferenceEngine
    i32 = dict(dtype=torch.int32, device="cuda")
    out = []

    def group(toks, lengths):
        T = toks.shape[1]
        vf = torch.tensor([T - n for n in lengths], **i32)
        lg, cache = prefill(params, torch.tensor(toks, device="cuda"), cfg,
                            S_CACHE, logits_last_only=True, valid_from=vf)
        out.append(lg[:, 0].cpu().numpy())
        return cache, vf

    def decode(cache, pos, vf, nxt):
        lg, _ = decode_step(params, torch.tensor(nxt, device="cuda"), cache,
                            pos, cfg, valid_from=vf)
        out.append(lg[:, 0].cpu().numpy())
    cache, vf = group(fed[0], LENS_FIRST)
    for i in range(GRAPH_STEPS):
        nxt = out[-1].argmax(-1).astype(np.int32)[:, None]
        if i == BACKFILL_AT:
            pos = T_SERVE + i
            rc = init_cache(cfg, 1, S_CACHE, device="cuda")
            lg, _ = forward(params, torch.tensor(fed[1][None], device="cuda"),
                            cfg, cache=rc,
                            positions=pos - T_SERVE + torch.arange(T_SERVE,
                                                                   **i32),
                            logits_last_only=True,
                            valid_from=torch.tensor([pos - BACKFILL_LEN],
                                                    **i32))
            out.append(lg[0, 0].cpu().numpy())
            InferenceEngine._merge(cache, rc, 1, pos - T_SERVE, T_SERVE)
            vf[1] = pos - BACKFILL_LEN
            del rc
            nxt[1, 0] = out[-1].argmax(-1)
        decode(cache, T_SERVE + i, vf, nxt)
    del cache
    cache, vf = group(fed[2], LENS_SECOND)
    for i in range(4):
        decode(cache, T_SECOND + i, vf,
               out[-1].argmax(-1).astype(np.int32)[:, None])
    return out


def _graphs_vs_eager(label, params, rng, cfg=None):
    """Full width: the engine (decode as one captured CUDA graph, prefill
    as one a prompt length, over one persistent cache) against
    `models.model` run eagerly on a fresh cache, bit for bit at every
    step (cfg: stablelm-1.6b's by default)."""
    from repro_torch.serving.engine import InferenceEngine
    cfg = cfg or _full_width("cuda")
    V = cfg.vocab
    row = np.zeros(T_SERVE, np.int32)
    row[T_SERVE - BACKFILL_LEN:] = rng.integers(0, V, BACKFILL_LEN)
    fed = [rng.integers(0, V, (B, T_SERVE)).astype(np.int32), row,
           rng.integers(0, V, (B, T_SECOND)).astype(np.int32)]
    eng = InferenceEngine(cfg, params, batch_size=B, max_seq=S_CACHE)
    with torch.no_grad():
        got = _engine_steps(eng, fed)
        want = _model_steps(cfg, params, fed)
    require(len(got) == len(want) == GRAPH_STEPS + 7, "graph plan length")
    unequal = [i for i, (g, w) in enumerate(zip(got, want))
               if not np.array_equal(g, w)]
    rel = max(float(np.abs(g - w).max() / np.abs(w).max())
              for g, w in zip(got, want))
    st = eng.stats
    log(f"model {label} graphs vs eager: {cfg.name} full width, "
        f"prefill T={T_SERVE} lengths={LENS_FIRST}, {GRAPH_STEPS} decode "
        f"steps, a backfill into slot 1 before step {BACKFILL_AT}, prefill "
        f"T={T_SECOND} + 4 steps: {len(got)} steps, bit-identical at "
        f"{len(got) - len(unequal)} (unequal: {unequal}), max |dlogit|/"
        f"max|logit| = {rel:.3e}; captures={st.graph_captures} replays="
        f"{st.graph_replays} compile_time_s={st.compile_time_s:.3f}")
    require(not unequal, f"{label}: graph logits != eager logits")
    require(bool(all(np.isfinite(g).all() for g in got)),
            f"{label}: non-finite graph logits")
    del eng
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Phase: serve (the main path)
# --------------------------------------------------------------------------

def phase_serve(p32, p8):
    from repro_torch.kernels import ops
    from repro_torch.serving.batching import Request
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.loop import ServingLoop
    from repro_torch.serving.server import CNNSelectServer, ServedModel
    from repro_torch.serving.trace import TraceRecorder

    cfg = _full_width("cuda")
    engines = {"stablelm_fp32": InferenceEngine(cfg, p32, batch_size=B,
                                                max_seq=S_CACHE),
               "stablelm_int8": InferenceEngine(cfg, p8, batch_size=B,
                                                max_seq=S_CACHE)}
    # Offline task scores of the two candidates (set here, as the
    # launcher sets its tiers): int8 pays a small accuracy penalty.
    acc = {"stablelm_fp32": 0.74, "stablelm_int8": 0.73}
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    with torch.no_grad():
        srv = CNNSelectServer(
            [ServedModel(name=n, engine=e, accuracy=acc[n],
                         size_bytes=e.resident_bytes)
             for n, e in engines.items()],
            t_threshold=30.0, policy="cnnselect", n_tokens=8)
        srv.profile_models(prompt_len=T_SERVE, reps=3)
        profs = srv.current_profiles()
        for p in profs:
            log(f"profile {p.name}: mu={p.mu:.2f} ms sigma={p.sigma:.2f} "
                f"acc={p.accuracy} size={p.size_bytes}")
        mus = sorted(p.mu for p in profs)
        rng = np.random.default_rng(1)
        # Trace capture on the served path (the sim phase checks it).
        srv_rec = TraceRecorder(name="serve-server").attach(srv)
        for i in range(8):
            # Alternate a budget between the two candidates' means and a
            # generous one, so the selection has a real choice to make.
            sla = (mus[0] + mus[1]) / 2 + 40.0 if i % 2 else mus[1] * 3
            req = Request(arrival=0.0, rid=i,
                          prompt=rng.integers(0, cfg.vocab, T_SERVE)
                          .astype(np.int32),
                          t_input_ms=float(rng.uniform(5.0, 15.0)))
            rec = srv.handle(req, t_sla=sla)
            require(len(rec["tokens"]) == 8 and rec["e2e_ms"] > 0,
                    f"server request {i}")
            log(f"server req {i}: sla={sla:.1f} {json.dumps(rec)}")
        log(f"server summary: {json.dumps(srv.metrics.summary())}")
        srv_rec.detach()

        loop = ServingLoop(engines, profiles=profs, t_threshold=30.0,
                           policy="cnnselect")
        loop_rec = TraceRecorder(name="serve-loop").attach(loop)
        for e in engines.values():   # the loop's prompt length
            e.warmup(S_CACHE // 4)
        reqs = []
        for i in range(10):
            n = int(rng.integers(16, 200))
            reqs.append(Request(
                arrival=0.0 if i < B else float(i), rid=100 + i,
                prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                max_new_tokens=int(2 + i % 5), sla_ms=1e5,
                t_input_ms=float(rng.uniform(5.0, 15.0))))
        m = loop.run(reqs)
        loop_rec.detach()
    torch.cuda.synchronize()
    for r in m.records:
        log(f"loop record: {json.dumps(r, default=str)}")
    s = m.summary()
    log(f"loop summary: {json.dumps(s)}")
    backfills = {n: e.stats.backfill_calls for n, e in engines.items()}
    log(f"loop backfills: {backfills}")
    for n, e in engines.items():
        st = e.stats
        log(f"serve engine {n}: graph captures {st.graph_captures}, "
            f"replays {st.graph_replays}, compile_time_s "
            f"{st.compile_time_s:.3f} (warm-up and captures), prefill "
            f"{st.prefill_calls} calls {st.prefill_time_s:.3f} s, decode "
            f"{st.decode_calls} calls {st.decode_time_s:.3f} s, backfill "
            f"{st.backfill_calls} calls {st.backfill_time_s:.3f} s")
        require(st.graph_replays == st.prefill_calls + st.decode_calls,
                f"{n}: every prefill and decode a graph replay")
    require(s["served"] == len(reqs), "loop served every request")
    for b in loop.batchers.values():
        require(all(len(r.tokens) == r.max_new_tokens for r in b.done),
                "loop tokens per request")
    require(sum(backfills.values()) > 0, "loop backfilled a freed slot")
    # int8_matmul counts every launch; int8_matmul_prefill those of its
    # M > 8 path (prefill and prefill_row of the int8 candidate). Both
    # hold the launches of graph replays.
    counts = dict(ops.launch_counts(),
                  int8_matmul_prefill=ops.int8_prefill_launches())
    # The window also holds the eager warm-ups before each capture: the
    # replayed part shows that the served steps' graphs ran each kernel.
    replayed = ops.replayed_counts()
    log(f"serve launches: {json.dumps(counts)} (of them graph replays: "
        f"{json.dumps(replayed)}) in "
        f"{time.perf_counter() - t_start:.1f} s")
    for name, n in counts.items():
        require(n > 0, f"{name} launched on the main path")
        require(replayed[name] > 0,
                f"{name} launched by a graph replay on the main path")
    served = dict(srv=srv, profiles=profs, ref="stablelm_fp32",
                  captures={"server": (srv_rec, srv.metrics.summary()),
                            "loop": (loop_rec, s)})
    return counts, served


# --------------------------------------------------------------------------
# Phase: sim (captures of the served path, replayed through simulate)
# --------------------------------------------------------------------------

# The reference's sim-to-real smoke (benchmarks/trace_replay.py): its CI
# request count, seed, policies and attainment tolerance (--tol).
SIM_N = 200
SIM_SEED = 11
SIM_POLICIES = ("cnnselect", "greedy_nw")
SIM_TOL = 0.02
# The paper's headline (simulator.attainment_improvement): SLA points
# and requests a point, under the stationary campus network.
HEADLINE_POINTS = 16
HEADLINE_N = 10000
TRACE_COLUMNS = ("t_arrival", "device_id", "t_input_ms", "regime_id",
                 "model", "sla_ok")


def check_capture(trace, n_served, label):
    """A served capture: one record per request served, valid, and a
    measured exec_ms in its meta for every record."""
    require(len(trace) == n_served,
            f"{label}: {len(trace)} records for {n_served} served")
    trace.validate()
    ex = np.asarray(trace.meta.get("exec_ms", []), np.float64)
    require(len(ex) == n_served and np.isfinite(ex).all()
            and (ex > 0).all(), f"{label}: exec_ms for every record")


def roundtrip_capture(trace, tmpdir):
    """Save the capture as JSONL and as npz, load both, and require
    every column (dtype and bytes) and the header equal to the
    capture's. Returns the capture loaded from JSONL."""
    from repro_torch.serving.trace import Trace
    back = {}
    for ext in ("jsonl", "npz"):
        path = Path(tmpdir) / f"{trace.name.replace(':', '_')}.{ext}"
        trace.save(path)
        got = back[ext] = Trace.load(path)
        for col in TRACE_COLUMNS:
            a, b = getattr(trace, col), getattr(got, col)
            require(a.dtype == b.dtype and a.tobytes() == b.tobytes(),
                    f"{trace.name}: column {col} through {ext}")
        require(got.header() == trace.header(),
                f"{trace.name}: header through {ext}")
    return back["jsonl"]


def capture_profiles(trace, fallback):
    """Profiles fitted from the capture's measured exec_ms (mean, and
    the std floored at 0.5 ms), the live profile for a model the
    capture ran fewer than twice (benchmarks/trace_replay.py:123)."""
    out = []
    exec_ms = np.asarray(trace.meta["exec_ms"], np.float64)
    for p in fallback:
        mask = trace.model == p.name
        if mask.sum() >= 2:
            out.append(dataclasses.replace(
                p, mu=float(exec_ms[mask].mean()),
                sigma=max(float(exec_ms[mask].std()), 0.5)))
        else:
            out.append(p)
    return out


def exec_override(trace, order):
    """(N, K): the captured selection's measured exec_ms, NaN (sampled
    from the profile) for every other model."""
    out = np.full((len(trace), len(order)), np.nan)
    exec_ms = np.asarray(trace.meta["exec_ms"], np.float64)
    index = {name: k for k, name in enumerate(order)}
    for i, m in enumerate(trace.model):
        if str(m) in index:
            out[i, index[str(m)]] = exec_ms[i]
    return out


def capture_and_replay(srv, spec, n, t_sla, tin_proc, tmpdir, vocab,
                       prompt_len):
    """Serve n requests through `srv` under policy `spec` while a
    TraceRecorder captures them; round-trip the capture through disk,
    then replay it through `simulate`: profiles fitted from the capture,
    its T_input sequence exactly, its measured exec_ms injected
    (benchmarks/trace_replay.py:141-176). Returns (capture, SimResult,
    server seconds for the n requests)."""
    from repro_torch.core.selection import make_policy
    from repro_torch.serving.batching import Request
    from repro_torch.serving.simulator import SimConfig, simulate
    from repro_torch.serving.trace import CapturedTraceProcess, TraceRecorder
    srv.metrics = type(srv.metrics)()
    srv.router.policy = make_policy(spec, t_threshold=30.0, seed=SIM_SEED)
    live = srv.current_profiles()
    t_inputs = tin_proc.sample_t_input(np.random.default_rng(SIM_SEED), n)
    rng = np.random.default_rng(SIM_SEED + 1)
    t0 = time.perf_counter()
    with torch.no_grad(), TraceRecorder(name=f"sim-{spec}").attach(
            srv) as rec:
        for i in range(n):
            srv.handle(Request(arrival=float(i), rid=i,
                               prompt=rng.integers(0, vocab, prompt_len)
                               .astype(np.int32),
                               t_input_ms=float(t_inputs[i])), t_sla=t_sla)
    served_s = time.perf_counter() - t0
    trace = rec.to_trace(name=f"sim-{spec}", source="server",
                         meta={"policy": spec, "t_sla": t_sla,
                               "models": [p.name for p in live]})
    check_capture(trace, srv.metrics.summary()["served"], trace.name)
    trace = roundtrip_capture(trace, tmpdir)
    profs = capture_profiles(trace, live)
    sim = simulate(profs, SimConfig(
        t_sla=t_sla, n_requests=len(trace),
        network=CapturedTraceProcess(trace, mode="exact"),
        policy=make_policy(spec, t_threshold=30.0, seed=SIM_SEED),
        seed=SIM_SEED),
        exec_override=exec_override(trace, [p.name for p in profs]))
    return trace, sim, served_s


def replay_policies(srv, ref, n, tmpdir, vocab, prompt_len):
    """The sim-to-real loop for each of SIM_POLICIES at n requests, the
    SLA by the reference's rule (trace_replay.py:187). Returns
    {policy: row}."""
    from repro_torch.configs.paper_zoo import synthetic_trace
    from repro_torch.serving.network import TraceReplayProcess
    mu = {p.name: p.mu for p in srv.current_profiles()}[ref]
    # Uploads: the wifi -> lte step trace, jittered, scaled so that its
    # mean is the `ref` candidate's measured mean (the reference's 0.2
    # was set for host-sized engines).
    step = synthetic_trace("wifi_lte_step", n)
    tin_proc = TraceReplayProcess(mu / step.mean() * step, jitter_cv=0.15,
                                  name="wifi_lte_step*mu")
    t_sla = float(2.2 * tin_proc.mean + 1.25 * mu)
    rows = {}
    for spec in SIM_POLICIES:
        trace, sim, served_s = capture_and_replay(
            srv, spec, n, t_sla, tin_proc, tmpdir, vocab, prompt_len)
        share = {name: float((trace.model == name).mean())
                 for name in trace.meta["models"]}
        # Where the replay picked the served model, its latency is the
        # served one and so is its outcome; elsewhere (a policy's draws
        # differ: the server's scalar cnnselect draws with numpy,
        # simulate's batched one with a torch.Generator) it samples.
        agreed = np.asarray(sim.model_names)[sim.selections] == trace.model
        served_ok = trace.sla_ok == 1
        rows[spec] = dict(n=len(trace), t_sla_ms=t_sla,
                          served_attainment=trace.attainment,
                          sim_attainment=sim.attainment,
                          gap=sim.attainment - trace.attainment,
                          share=share, served_s=served_s,
                          other_model=int((~agreed).sum()),
                          flips_where_agreed=int(
                              (agreed & (sim.violations == served_ok))
                              .sum()))
    return rows


def phase_sim(served):
    """The serve phase's captures checked, then capture -> disk ->
    replay at full width for each of SIM_POLICIES, through the serve
    phase's CNNSelectServer (no new model)."""
    import tempfile
    t0 = time.perf_counter()
    for label, (rec, summary) in served["captures"].items():
        trace = rec.to_trace(name=f"serve-{label}")
        check_capture(trace, summary["served"], f"serve {label} capture")
        log(f"sim capture of the serve phase's {label}: {len(trace)} "
            f"records, valid, exec_ms on each, attainment "
            f"{trace.attainment}")
    srv = served["srv"]
    with tempfile.TemporaryDirectory() as tmpdir:
        rows = replay_policies(srv, served["ref"], SIM_N, tmpdir,
                               srv.models[served["ref"]].engine.cfg.vocab,
                               T_SERVE)
    for spec, r in rows.items():
        log(f"sim replay {spec} (full width, N={r['n']}, JSONL and npz "
            f"round trips bit-exact): {json.dumps(r)}")
    for spec, r in rows.items():
        require(abs(r["gap"]) <= SIM_TOL,
                f"sim {spec}: |sim - served attainment| {abs(r['gap'])} "
                f"> {SIM_TOL}")
        require(r["flips_where_agreed"] == 0,
                f"sim {spec}: an outcome changed where the replay ran the "
                f"served model")
    log(f"sim phase (captures, serving and replay) "
        f"{time.perf_counter() - t0:.1f} s")
    return rows


def phase_sim_headline(profiles):
    """attainment_improvement (paper: CNNSelect against greedy) on the
    profiles the serve phases measured on the card. A CPU computation
    on measured inputs: a reading, whose curves must only be finite and
    in [0, 1]."""
    from repro_torch.serving.simulator import (SimConfig,
                                               attainment_improvement,
                                               simulate)
    t0 = time.perf_counter()
    mus = [p.mu for p in profiles]
    slas = np.linspace(min(mus) + 10.0, 3.0 * max(mus), HEADLINE_POINTS)
    # Host ms of one simulate call at HEADLINE_N (the grid's middle SLA).
    for policy in ("cnnselect", "greedy"):
        cfg = SimConfig(t_sla=float(slas[HEADLINE_POINTS // 2]),
                        n_requests=HEADLINE_N, network="campus_wifi",
                        policy=policy)
        ms = []
        for _ in range(5):
            t1 = time.perf_counter()
            simulate(profiles, cfg)
            ms.append((time.perf_counter() - t1) * 1e3)
        log(f"sim simulate {policy} N={HEADLINE_N} host ms (5 calls): "
            f"median {float(np.median(ms))} min {min(ms)} max {max(ms)}")
    out = attainment_improvement(profiles, slas, network="campus_wifi",
                                 n_requests=HEADLINE_N)
    for key in ("ours_attainment", "base_attainment", "ours_accuracy",
                "base_accuracy"):
        v = np.asarray(out[key])
        require(np.isfinite(v).all() and (v >= 0).all() and (v <= 1).all(),
                f"headline {key} finite and in [0, 1]")
    log(f"sim headline (CPU simulate on the card's measured profiles of "
        f"{[p.name for p in profiles]}; campus_wifi, "
        f"{HEADLINE_N} requests a point): {json.dumps(out)} in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------
# Phase: scan (simulate(engine="scan") on the card)
# --------------------------------------------------------------------------

def _simulate(engine, n, fleet=None, device=None, **kw):
    """(SimResult, host wall s) of one simulate() call on benchmarks/
    engine_scale.py's settings (greedy_nw unless kw names a policy); the
    scan engine under scan_device(device) when one is given, else on
    the card."""
    from repro_torch.configs.paper_zoo import paper_profiles
    from repro_torch.serving import scan_engine as se
    from repro_torch.serving.simulator import SimConfig, simulate
    kw.setdefault("policy", "greedy_nw")
    cfg = SimConfig(t_sla=SCAN_T_SLA, n_requests=n, seed=SCAN_SEED,
                    fleet=fleet, engine=engine, **kw)
    ctx = se.scan_device(device) if device else contextlib.nullcontext()
    with ctx:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simulate(paper_profiles(), cfg)
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _same_decisions(a, b, label):
    """tests/test_engine.py's equivalence: selections, modes, hedges,
    fallbacks, cold starts and switch events equal; latencies within
    1e-9 relative, each event's ref and level within 1e-6. Returns the
    largest relative latency difference."""
    require(list(a.selections) == list(b.selections), f"{label} selections")
    rel = np.abs(a.latencies - b.latencies) / np.abs(b.latencies)
    require(bool((rel <= 1e-9).all()), f"{label} latencies within 1e-9")
    for k in ("hedges", "fallbacks", "cold_starts"):
        require(getattr(a, k) == getattr(b, k), f"{label} {k}")
    require(list(a.modes if a.modes is not None else []) ==
            list(b.modes if b.modes is not None else []), f"{label} modes")
    ea, eb = a.switch_events or [], b.switch_events or []
    require(len(ea) == len(eb), f"{label} switch events")
    for x, y in zip(ea, eb):
        require(all(x[k] == y[k] for k in ("request", "device", "from", "to",
                                           "alarm")), f"{label} event {x}")
        require(all(abs(x[k] - y[k]) <= 1e-6 * abs(y[k])
                    for k in ("ref", "level")), f"{label} event {x}")
    return float(rel.max())


def _bit_identical(a, b, label):
    """Every output of two scan runs bit for bit."""
    require(np.array_equal(a.selections, b.selections),
            f"{label} selections")
    require(np.array_equal(a.latencies, b.latencies), f"{label} latencies")
    require((a.modes is None) == (b.modes is None) and (
        a.modes is None or np.array_equal(a.modes, b.modes)),
        f"{label} modes")
    require((a.switch_events or []) == (b.switch_events or []),
            f"{label} switch events")
    for k in ("hedges", "fallbacks", "cold_starts", "attainment",
              "accuracy"):
        require(getattr(a, k) == getattr(b, k), f"{label} {k}")


@contextlib.contextmanager
def _scan_probe():
    """Records, while it is open, the percentile layout of each pctl
    bank the column program builds and the CUDA-event span (ms) of each
    program call on the card."""
    from repro_torch.serving import scan_engine as se
    init, prog = se._core_init, se._program
    seen = {"layouts": [], "program_ms": []}

    def core_init(desc, D, dev, n_rows=None):
        st = init(desc, D, dev, n_rows)
        if desc.kind == "pctl":
            seen["layouts"].append((desc.param, n_rows, se._layout(st)))
        return st

    def program(*args):
        if args[2].device.type != "cuda":
            return prog(*args)
        e0, e1 = _events()
        e0.record()
        out = prog(*args)
        e1.record()
        e1.synchronize()
        seen["program_ms"].append(e0.elapsed_time(e1))
        return out

    se._core_init, se._program = core_init, program
    try:
        yield seen
    finally:
        se._core_init, se._program = init, prog


def phase_scan():
    """simulate(engine="scan") on the card: exact against the python
    engine at SCAN_EQ_N requests (the engine_scale workload, and the
    open-loop case through queue_scan), bit for bit against the CPU at
    SCAN_DEVICES x SCAN_N in each percentile layout and under the
    controller, then its requests/s. Returns the phase's launch counts
    (the open-loop run's)."""
    from repro_torch.kernels.queue_scan import queue_scan
    from repro_torch.serving.fleet import ArrayFleet
    t_phase = time.perf_counter()
    # -- against the python engine ----------------------------------------
    fleet = lambda: ArrayFleet(SCAN_EQ_DEVICES, seed=SCAN_SEED)
    py, t_py = _simulate("python", SCAN_EQ_N, fleet(), controller="reactive")
    sc, t_sc = _simulate("scan", SCAN_EQ_N, fleet(), controller="reactive")
    rel = _same_decisions(py, sc, "scan engine_scale")
    log(f"scan engine_scale D={SCAN_EQ_DEVICES} N={SCAN_EQ_N}: scan on the "
        f"card equals python (max rel latency diff {rel:.3e}; "
        f"{len(sc.switch_events or [])} switch events, "
        f"{sc.fallbacks} fallbacks, {sc.cold_starts} cold starts); python "
        f"{t_py:.3f} s, scan {t_sc:.3f} s")
    open_kw = dict(controller="reactive", policy="cnnselect",
                   arrival_rate_hz=500.0, n_servers=2)
    py, t_py = _simulate("python", SCAN_EQ_N, "lte_outage_fleet", **open_kw)
    queue_scan.launches = 0
    sc, t_sc = _simulate("scan", SCAN_EQ_N, "lte_outage_fleet", **open_kw)
    counts = {"queue_scan": queue_scan.launches}
    require(counts["queue_scan"] > 0, "the open-loop scan run launched "
                                      "queue_scan")
    rel = _same_decisions(py, sc, "scan open loop")
    require(sc.hedges > 0, "the open-loop run hedges")
    log(f"scan open loop (lte_outage_fleet, cnnselect, 500 Hz, 2 servers) "
        f"N={SCAN_EQ_N}: scan on the card equals python (max rel latency "
        f"diff {rel:.3e}; {sc.hedges} hedges, "
        f"{len(sc.switch_events or [])} switch events); queue_scan "
        f"launches {counts['queue_scan']}; python {t_py:.3f} s, scan "
        f"{t_sc:.3f} s")
    # -- the card against the CPU, bit for bit ----------------------------
    big = lambda: ArrayFleet(SCAN_DEVICES, seed=SCAN_SEED)
    cases = (("pctl:90", dict(t_estimator="pctl:90"), big, SCAN_N, "top"),
             ("pctl:50", dict(t_estimator="pctl:50"), big, SCAN_N, "sbuf"),
             ("reactive", dict(controller="reactive"), big, SCAN_N, "top"),
             ("pctl:90 no fleet", dict(t_estimator="pctl:90"), lambda: None,
              SCAN_ROLL_N, "buf"))
    walls = {}
    for label, kw, make, n, layout in cases:
        with _scan_probe() as seen:
            card, t_card = _simulate("scan", n, make(), **kw)
        cpu, t_cpu = _simulate("scan", n, make(), device="cpu", **kw)
        _bit_identical(card, cpu, f"scan {label}")
        layouts = sorted({lay for _, _, lay in seen["layouts"]})
        require(layouts == [layout], f"scan {label} layout {layouts}")
        L = seen["layouts"][0][1]
        walls[label] = (t_card, t_cpu)
        log(f"scan {label} D={SCAN_DEVICES if n == SCAN_N else 1} N={n}: card "
            f"equals CPU bit for bit (selections, latencies, modes, "
            f"{len(card.switch_events or [])} switch events); L={L}, "
            f"layout {layout}; card {t_card:.3f} s (program "
            f"{sum(seen['program_ms']):.3f} ms), CPU {t_cpu:.3f} s")
    # -- requests/s at SCAN_DEVICES x SCAN_N (reactive, after the warm run
    # above) ----------------------------------------------------------------
    runs = []
    for _ in range(SCAN_REPS):
        with _scan_probe() as seen:
            _, t = _simulate("scan", SCAN_N, big(), controller="reactive")
        runs.append((t, sum(seen["program_ms"])))
    t_med, p_med = sorted(runs)[len(runs) // 2]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _simulate("scan", SCAN_N, big(), controller="reactive")
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern = [e for e in ev if not e.key.startswith("Memcpy")]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    launches = sum(e.count for e in kern)
    _, t_pyd = _simulate("python", SCAN_PY_N, big(), controller="reactive")
    out = dict(
        scan_reqs_per_s=SCAN_N / t_med, walls_s=[t for t, _ in runs],
        program_ms=p_med, host_share=1.0 - p_med / (t_med * 1e3),
        program_kernel_ms=dev_ms, program_launches=launches,
        python_reqs_per_s=SCAN_PY_N / t_pyd)
    log(f"scan times D={SCAN_DEVICES} N={SCAN_N} reactive (median of "
        f"{SCAN_REPS} after a warm run; program_ms: CUDA-event span of the "
        f"column program; program_kernel_ms and launches: torch.profiler, "
        f"one more run; python at N={SCAN_PY_N}): {json.dumps(out)}")
    log(f"scan phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_scan_full():
    """simulate(engine="scan") at SCAN_FULL_DEVICES x SCAN_FULL_N
    (reactive), once, on the card; then the walls of the launch-bound
    no-fleet case (one column of SCAN_ROLL_N rows, reactive) through scan
    on the card, scan on the CPU and the python engine."""
    from repro_torch.serving.fleet import ArrayFleet
    torch.cuda.reset_peak_memory_stats()
    with _scan_probe() as seen:
        res, t = _simulate("scan", SCAN_FULL_N,
                           ArrayFleet(SCAN_FULL_DEVICES, seed=SCAN_SEED),
                           controller="reactive")
    require(np.isfinite(res.latencies).all()
            and len(res.latencies) == SCAN_FULL_N, "scan_full latencies")
    log(f"scan_full D={SCAN_FULL_DEVICES} N={SCAN_FULL_N} reactive, one "
        f"run: {t:.3f} s, {SCAN_FULL_N / t:.1f} requests/s; program "
        f"{sum(seen['program_ms']):.3f} ms (L={seen['layouts'][0][1]}); "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
        f"attainment {res.attainment:.6f}, "
        f"{len(res.switch_events or [])} switch events")
    walls = {}
    for label, engine, kw in (("card", "scan", {}),
                              ("cpu", "scan", dict(device="cpu")),
                              ("python", "python", {})):
        _, walls[f"d1_{label}_wall_s"] = _simulate(
            engine, SCAN_ROLL_N, None, controller="reactive", **kw)
    log(f"scan no fleet D=1 N={SCAN_ROLL_N} reactive, one run each: "
        f"{json.dumps(walls)}")


# --------------------------------------------------------------------------
# Phase: cluster (Cluster(engine="scan") on the card)
# --------------------------------------------------------------------------

def make_cluster(mix, engine, budget=None):
    """benchmarks/cluster_scale.py's cluster: CLUSTER_REPLICAS
    SimReplicaStacks of CLUSTER_MODELS (seeds 100, 101, ...) serving
    `mix` with the full control plane."""
    from repro_torch.configs.paper_zoo import paper_profiles
    from repro_torch.serving.cluster import Cluster
    from repro_torch.serving.stack import SimReplicaStack
    reps = [SimReplicaStack(paper_profiles(list(CLUSTER_MODELS)),
                            seed=100 + i, name=f"r{i}")
            for i in range(CLUSTER_REPLICAS)]
    return Cluster(reps, mix, memory_budget_bytes=budget, engine=engine)


def cluster_state(cl):
    """Everything a later run could observe of a cluster's replicas:
    queue clocks, zoo placement state, cold-start counts and the exact
    RNG streams."""
    out = []
    for r in cl.replicas:
        pol_rng = getattr(r.router.policy, "rng", None)
        out.append(dict(
            free=r._server_free,
            zoo={n: (e.hot, e.last_used, e.loads, e.evictions)
                 for n, e in r.router.zoo.entries.items()},
            colds=r.router.zoo.total_cold_starts,
            rng=r.rng.gen.bit_generator.state["state"],
            block=(r.rng._i, r.rng._z.tolist()),
            pol_rng=(None if pol_rng is None
                     else pol_rng.bit_generator.state["state"])))
    return out


def _same_cluster(a, b, label):
    """tests/test_cluster_engine.py's equality: events, metrics rows,
    n_active, replica state and the controller's events, bit for bit."""
    require(a.events == b.events, f"{label} events")
    require(a.metrics.records == b.metrics.records, f"{label} metrics rows")
    require(a.n_active == b.n_active, f"{label} n_active")
    require(cluster_state(a) == cluster_state(b), f"{label} replica state")
    require(a.controller is None
            or a.controller.events == b.controller.events,
            f"{label} controller events")


def _event_kinds(cl):
    kinds = {}
    for e in cl.events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    return kinds


@contextlib.contextmanager
def _cluster_probe():
    """Records, while it is open, the parts of each scan_cluster_run on
    the card: the column program's CUDA-event span and host seconds, the
    cluster_scan call's CUDA-event span and its host-clock interval."""
    from repro_torch.serving import cluster_engine as ce
    prog, scan = ce._run_program, ce.cluster_scan
    seen = {"program_ms": 0.0, "program_s": 0.0, "kernel_ms": 0.0,
            "scan_call": None}

    def program(*args):
        e0, e1 = _events()
        t0 = time.perf_counter()
        e0.record()
        out = prog(*args)
        e1.record()
        e1.synchronize()
        seen["program_ms"] += e0.elapsed_time(e1)
        seen["program_s"] += time.perf_counter() - t0
        return out

    def kernel(*args):
        e0, e1 = _events()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        out = scan(*args)
        e1.record()
        e1.synchronize()
        seen["kernel_ms"] += e0.elapsed_time(e1)
        seen["scan_call"] = (t0, time.perf_counter())
        return out

    ce._run_program, ce.cluster_scan = program, kernel
    try:
        yield seen
    finally:
        ce._run_program, ce.cluster_scan = prog, scan


def phase_cluster():
    """Cluster(engine="scan") on the card: bit for bit against the
    python Cluster at cluster_scale's check row (evictions; the python
    capture replayed through both engines) and on each tenant mix
    (hedges), bit for bit against the same run on the CPU at
    CLUSTER_CPU_DEVICES x CLUSTER_CPU_N, then requests/s at SWEEP_RUN's
    points beside the python engine's, split into host precompute, the
    column program, the kernel and the assembly after it. Returns the
    check row's launch counts."""
    from repro_torch.configs.paper_zoo import TENANT_MIXES, scale_tenant_mix
    from repro_torch.kernels.cluster_scan import cluster_scan
    from repro_torch.serving import cluster_engine as ce
    from repro_torch.serving.cluster import (capture_run,
                                             make_tenant_columns,
                                             make_tenant_workload,
                                             replay_events)
    from repro_torch.serving.scan_engine import scan_device
    t_phase = time.perf_counter()
    # -- the check row: the card against python, and the replay ----------
    mix = scale_tenant_mix(CLUSTER_CHECK_DEVICES)
    wl = make_tenant_workload(mix, n_requests=CLUSTER_CHECK_N,
                              rate_hz=CLUSTER_RATE, seed=CLUSTER_SEED)
    py = make_cluster(mix, "python", CLUSTER_BUDGET)
    trace = capture_run(py, wl)
    sc = make_cluster(mix, "scan", CLUSTER_BUDGET)
    cluster_scan.launches = 0
    sc.run(wl)
    counts = {"cluster_scan": cluster_scan.launches}
    require(counts["cluster_scan"] > 0, "the cluster check run launched "
                                        "cluster_scan")
    _same_cluster(py, sc, "cluster check")
    kinds = _event_kinds(py)
    require(kinds.get("evict", 0) > 0, "the cluster check row evicts")
    replay = {e: replay_events(trace, lambda e=e: make_cluster(
        mix, e, CLUSTER_BUDGET)) for e in ("python", "scan")}
    require(all(replay.values()), f"cluster replay {replay}")
    log(f"cluster check D={CLUSTER_CHECK_DEVICES} N={CLUSTER_CHECK_N} "
        f"budget {CLUSTER_BUDGET}: scan on the card equals python bit for "
        f"bit (events {json.dumps(kinds)}, metrics rows, n_active "
        f"{sc.n_active}, replica state, controller events); the python "
        f"capture replays through python and the card; cluster_scan "
        f"launches {counts['cluster_scan']}; attainment "
        f"{py.metrics.summary()['attainment']}")
    # -- the tenant mixes: hedges ------------------------------------------
    for name in sorted(TENANT_MIXES):
        wl = make_tenant_workload(name, n_requests=CLUSTER_MIX_N,
                                  rate_hz=CLUSTER_MIX_RATE, seed=CLUSTER_SEED)
        py = make_cluster(name, "python", CLUSTER_BUDGET)
        py.run(wl)
        sc = make_cluster(name, "scan", CLUSTER_BUDGET)
        sc.run(wl)
        _same_cluster(py, sc, f"cluster {name}")
        hedged = sum(r["hedged"] for r in py.metrics.records)
        require(hedged > 0, f"cluster {name} hedges")
        log(f"cluster {name} N={CLUSTER_MIX_N} {CLUSTER_MIX_RATE} Hz budget "
            f"{CLUSTER_BUDGET}: scan on the card equals python bit for bit "
            f"({hedged} hedged, events {json.dumps(_event_kinds(py))})")
    # -- the card against the CPU ------------------------------------------
    mix = scale_tenant_mix(CLUSTER_CPU_DEVICES)
    wl = make_tenant_columns(mix, n_requests=CLUSTER_CPU_N,
                             rate_hz=CLUSTER_RATE, seed=CLUSTER_SEED)
    walls = {}
    runs = {}
    for label, ctx in (("card", contextlib.nullcontext()),
                       ("cpu", scan_device("cpu"))):
        runs[label] = make_cluster(mix, "scan", CLUSTER_BUDGET)
        t0 = time.perf_counter()
        with ctx:
            runs[label].run(wl)
        walls[label] = time.perf_counter() - t0
    _same_cluster(runs["card"], runs["cpu"], "cluster card vs CPU")
    log(f"cluster D={CLUSTER_CPU_DEVICES} N={CLUSTER_CPU_N} budget "
        f"{CLUSTER_BUDGET}: card equals CPU bit for bit (events "
        f"{json.dumps(_event_kinds(runs['card']))}, metrics rows, replica "
        f"state); card {walls['card']:.3f} s, CPU (the plain loop) "
        f"{walls['cpu']:.3f} s")
    # -- requests/s at SWEEP_RUN's points ------------------------------------
    for devices, n_py, n_scan in CLUSTER_SWEEP:
        mix = scale_tenant_mix(devices)
        wl = make_tenant_columns(mix, n_requests=n_scan,
                                 rate_hz=CLUSTER_RATE, seed=CLUSTER_SEED)
        ce.scan_cluster_run(make_cluster(mix, "scan"), wl,
                            collect_rows=False)
        timed = []
        for _ in range(CLUSTER_REPS):
            cl = make_cluster(mix, "scan")
            with _cluster_probe() as seen:
                t0 = time.perf_counter()
                res = ce.scan_cluster_run(cl, wl, collect_rows=False)
                t1 = time.perf_counter()
            a, b = seen["scan_call"]
            timed.append(dict(
                wall_s=t1 - t0, precompute_s=a - t0 - seen["program_s"],
                program_ms=seen["program_ms"], kernel_ms=seen["kernel_ms"],
                kernel_call_s=b - a, assembly_s=t1 - b))
        med = sorted(timed, key=lambda r: r["wall_s"])[len(timed) // 2]
        wl_py = make_tenant_columns(mix, n_requests=n_py,
                                    rate_hz=CLUSTER_RATE, seed=CLUSTER_SEED)
        py = make_cluster(mix, "python")
        t0 = time.perf_counter()
        py.run(wl_py)
        t_py = time.perf_counter() - t0
        out = dict(
            devices=devices, scan_requests=n_scan,
            scan_reqs_per_s=n_scan / med["wall_s"],
            walls_s=[r["wall_s"] for r in timed], **med,
            kernel_cycles_per_request=(med["kernel_ms"] * 1e-3
                                       * _sm_clock_mhz() * 1e6 / n_scan),
            attainment=float(res.ok.mean()), sheds=int(res.shed.sum()),
            hedges=int(res.hedged.sum()), events=len(cl.events),
            python_requests=n_py, python_reqs_per_s=n_py / t_py,
            python_attainment=py.metrics.summary()["attainment"])
        log(f"cluster times D={devices} (scan median of {CLUSTER_REPS} after "
            f"a warm run, collect_rows=False; precompute_s: host time "
            f"before the kernel call outside the column program; "
            f"program_ms: its CUDA-event span; kernel_ms: cluster_scan's "
            f"CUDA-event span; assembly_s: events and writeback after "
            f"it; python at its own N): {json.dumps(out)}")
    log(f"cluster phase {time.perf_counter() - t_phase:.1f} s")
    return counts


# The profile_cluster phase's input variants: (label, R, K, kinds, budget,
# degraded share), each at CLUSTER_TIME_N requests.
CLUSTER_PROFILE_CASES = (
    ("main", 3, 3, "cnn", False, 0.5),
    ("precomputed choice", 3, 3, "det", False, 0.5),
    ("no hedge", 3, 3, "cnn", False, 0.0),
    ("precomputed, no hedge", 3, 3, "det", False, 0.0),
    ("one replica", 1, 1, "det", False, 0.0),
    ("8 replicas", 8, 3, "cnn", False, 0.5),
    ("32 replicas", 32, 3, "cnn", False, 0.5),
    ("tight budget", 3, 3, "cnn", True, 0.5),
)


def phase_profile_cluster():
    """Where a cluster_scan request's cycles go: the kernel timed (CUDA
    events, median of 3 after a warm call) on input variants that drop
    one part of the step each (the cnnselect choice's u and CDF reads,
    the hedge leg, the placement's replicas) or add one (eviction), at
    CLUSTER_TIME_N requests, in cycles a request at the highest SM
    clock."""
    from repro_torch.kernels import cluster_scan as CS
    clock = _sm_clock_mhz()
    N = CLUSTER_TIME_N
    rows = {}
    for label, Rn, K, kinds, budget, degr in CLUSTER_PROFILE_CASES:
        xs, init, const = cluster_inputs(N, Rn, K, N, has_budget=budget,
                                         kinds=kinds, tight=True,
                                         degr_p=degr)
        dev = cluster_tensors(xs, init, const, "cuda")
        _, ys = CS.cluster_scan(*dev, budget)
        ms = []
        for _ in range(3):
            e0, e1 = _events()
            e0.record()
            CS.cluster_scan(*dev, budget)
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        med = sorted(ms)[1]
        rows[label] = dict(
            R=Rn, K=K, kinds=kinds, budget=budget, ms=med,
            cycles_per_request=med * 1e-3 * clock * 1e6 / N,
            hedged=int(ys["hedged"].sum()), shed=int(ys["shed"].sum()),
            victims=(int((ys["vict1"] >= 0).sum()
                         + (ys["vict2"] >= 0).sum()) if budget else 0))
        log(f"profile_cluster {label}: {json.dumps(rows[label])}")
    return rows


# --------------------------------------------------------------------------
# Phase: recurrent (recurrentgemma-2b and mamba2-2.7b at full width)
# --------------------------------------------------------------------------

# Groups a run serves in turn, (prompt length, decode steps): for
# recurrentgemma a group at RG_T[0] whose 24 steps cross position 2048,
# where its local layers' ring wraps, then one at RG_T[1] > the window;
# for mamba2 a prompt of two whole SSD chunks (512) and one that ends in
# a padded chunk (300).
RG_GROUPS = ((RG_T[0], 24), (RG_T[1], 8))
MAMBA_GROUPS = ((512, 8), (300, 8))


def _recurrent_params():
    """Full-width random weights from seed 0 on the card: recurrentgemma-
    2b fp32 and its int8 execution tree (embeddings, norms and the RG-LRU
    mixer shared with the fp32 tree), and mamba2-2.7b fp32."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.quant.int8 import quantize_exec_tree, \
        tree_bytes_quantized
    t0 = time.perf_counter()
    rg32 = init_params(get_config("recurrentgemma_2b"), seed=0,
                       device="cuda")
    rg8 = quantize_exec_tree(rg32)
    m32 = init_params(get_config("mamba2_2_7b"), seed=0, device="cuda")
    torch.cuda.synchronize()
    gb = [tree_bytes_quantized(t) / 1e9 for t in (rg32, rg8, m32)]
    log(f"params: recurrentgemma-2b fp32 {gb[0]:.3f} GB, int8 {gb[1]:.3f} "
        f"GB; mamba2-2.7b fp32 {gb[2]:.3f} GB, in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"recurrentgemma_fp32": rg32, "recurrentgemma_int8": rg8,
            "mamba2_fp32": m32}


def _arch(name):
    return "mamba2_2_7b" if name.startswith("mamba2") else \
        "recurrentgemma_2b"


def _cfg(name, impl="cuda"):
    from repro_torch.configs import get_config
    return get_config(_arch(name), attn_impl=impl)


def _served_groups(eng, groups, rng):
    """The groups through the engine (graphs on the card): a prefill of
    random prompts, then greedy decode steps. Returns (the logits of
    every step, the tokens fed: per group the prompts, then each
    step's (B, 1) tokens)."""
    out, fed = [], []
    for T, n in groups:
        toks = [rng.integers(0, eng.cfg.vocab,
                             (eng.batch_size, T)).astype(np.int32)]
        out.append(eng.run_prefill(toks[0]))
        for _ in range(n):
            toks.append(out[-1].argmax(-1).astype(np.int32)[:, None])
            out.append(eng.run_decode(toks[-1]))
        fed.append(toks)
    return out, fed


def _eager_groups(cfg, params, fed, max_seq=RG_MAX_SEQ, masked=False):
    """The same tokens through `models.model` eagerly, a fresh cache a
    group: the logits of every step. masked: pass valid_from = 0, as the
    engine does for an attention-only pattern."""
    from repro_torch.models.model import decode_step, prefill
    out = []
    for toks in fed:
        T = toks[0].shape[1]
        vf = torch.zeros(toks[0].shape[0], dtype=torch.int32,
                         device="cuda") if masked else None
        lg, cache = prefill(params, torch.tensor(toks[0], device="cuda"),
                            cfg, max_seq, logits_last_only=True,
                            valid_from=vf)
        out.append(lg[:, 0].cpu().numpy())
        for i, tok in enumerate(toks[1:]):
            # [0]: no name left holding the cache past `del cache`.
            lg = decode_step(params, torch.tensor(tok, device="cuda"),
                             cache, T + i, cfg, valid_from=vf)[0]
            out.append(lg[:, 0].cpu().numpy())
        del cache
    return out


def _bit_equal(label, got, want, stats):
    unequal = [i for i, (g, w) in enumerate(zip(got, want))
               if not np.array_equal(g, w)]
    rel = max(float(np.abs(g - w).max() / np.abs(w).max())
              for g, w in zip(got, want))
    log(f"{label} graphs vs eager: {len(got)} steps, "
        f"bit-identical at {len(got) - len(unequal)} (unequal: {unequal}), "
        f"max |dlogit|/max|logit| = {rel:.3e}; captures="
        f"{stats.graph_captures} replays={stats.graph_replays} "
        f"compile_time_s={stats.compile_time_s:.3f}")
    require(len(got) == len(want) and not unequal,
            f"{label}: graph logits != eager logits")
    require(all(np.isfinite(g).all() for g in got),
            f"{label}: non-finite logits")


def phase_recurrent(params):
    """recurrentgemma-2b (fp32, int8) and mamba2-2.7b (fp32) at their
    published size through the engine (max_seq RG_MAX_SEQ, batch RG_B):
    the graphs against `models.model` run eagerly on a fresh cache, bit
    for bit at every step; recurrentgemma's cuda path against its naive
    path (int8: on the dequantized weights); mamba2's decode steps
    against one forward over the whole sequence."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import forward
    from repro_torch.serving.engine import InferenceEngine
    rng = np.random.default_rng(3)
    served = {}
    for name in ("recurrentgemma_fp32", "recurrentgemma_int8",
                 "mamba2_fp32"):
        p = params[name]
        cfg = _cfg(name)
        groups = MAMBA_GROUPS if name.startswith("mamba2") else RG_GROUPS
        t0 = time.perf_counter()
        with torch.no_grad():
            eng = InferenceEngine(cfg, p, batch_size=RG_B,
                                  max_seq=RG_MAX_SEQ, device="cuda")
            got, fed = _served_groups(eng, groups, rng)
            if name.startswith("recurrent"):
                # After the last group: its ring holds the window's last
                # 2048 positions, wrapped.
                pos = eng.cache["blocks"][2]["pos"]
                last = RG_T[1] + groups[1][1] - 1
                require(int(pos.max()) == last
                        and int(pos.min()) == last - RG_WINDOW + 1,
                        f"{name}: ring positions {int(pos.min())}.."
                        f"{int(pos.max())}")
            want = _eager_groups(cfg, p, fed)
        _bit_equal(f"recurrent {name} ({_arch(name)} full width, groups "
                   f"{groups})",
                   got, want, eng.stats)
        served[name] = (got, fed)
        del eng
        torch.cuda.empty_cache()
        if name.startswith("recurrent"):
            naive_p = _dequantized(p) if name.endswith("int8") else p
            before = ops.launch_counts()
            with torch.no_grad():
                naive = _eager_groups(_cfg(name, "naive"), naive_p, fed)
            require(ops.launch_counts() == before,
                    f"{name}: the naive run launched a kernel")
            del naive_p
            worst = max(float(np.abs(a - b).max() / np.abs(b).max())
                        for a, b in zip(want, naive))
            log(f"recurrent {name}: cuda vs naive"
                f"{' (dequantized weights)' if name.endswith('int8') else ''}"
                f" over {len(want)} steps: max |dlogit|/max|logit| = "
                f"{worst:.3e} (tol {LOGIT_TOL}); max|logit|="
                f"{max(float(np.abs(b).max()) for b in naive):.2f}")
            require(worst <= LOGIT_TOL, f"{name}: cuda vs naive {worst:.2e}")
        else:
            # Each group's steps against one forward over its prompt and
            # the tokens fed after it.
            worst, at = 0.0, 0
            for toks in fed:
                seq = torch.tensor(np.concatenate(toks, axis=1),
                                   device="cuda")
                T = toks[0].shape[1]
                with torch.no_grad():
                    full = forward(p, seq, cfg)[0][:, T - 1:].cpu().numpy()
                for i in range(len(toks)):
                    b = full[:, i]
                    worst = max(worst, float(np.abs(got[at + i] - b).max()
                                             / np.abs(b).max()))
                at += len(toks)
                del seq, full
            log(f"recurrent {name}: prefill + decode steps vs one forward "
                f"over the sequence (T = {[g[0] for g in groups]}): max "
                f"|dlogit|/max|logit| = {worst:.3e} (tol {LOGIT_TOL})")
            require(worst <= LOGIT_TOL,
                    f"{name}: decode vs forward {worst:.2e}")
        torch.cuda.empty_cache()
        log(f"recurrent {name}: {time.perf_counter() - t0:.1f} s")
    return _recurrent_sharded(params, served)


def _fed_groups(eng, fed):
    """The tokens `_served_groups` fed, through another engine: the
    logits of every step."""
    out = []
    for toks in fed:
        out.append(eng.run_prefill(toks[0]))
        out += [eng.run_decode(tok) for tok in toks[1:]]
    return out


def _recurrent_sharded(params, served):
    """Each recurrent candidate through InferenceEngine(parallel=) with
    its graphs on a one-rank NCCL mesh (1, 1) (RG-LRU width, SSD heads
    and recurrentgemma's MLP over the model axis, all of it on the one
    rank), fed the tokens the unsharded engine was fed: bit for bit its
    logits at every step (on one rank the sharded blocks run the
    unsharded operations: the gathered conv output is u itself, the SSD
    norm's averaged mean square its own). Returns the kernels' launches
    in these runs (replays included)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.sharding import make_parallel
    t0 = time.perf_counter()
    W = _cfg("recurrentgemma_fp32").lru_width
    # Each rank gathers the other model ranks' (B/dp, T, W/tp) slices of
    # the RG-LRU conv output a layer (fp32).
    log(f"recurrent sharded bytes into each rank an RG-LRU layer "
        f"(computed, not measured), recurrentgemma-2b on mesh (2, 2): "
        f"decode B={RG_B}: {(RG_B // 2) * W * 4 // 2} B; prefill B={RG_B} "
        f"T={RG_T[0]}: {(RG_B // 2) * RG_T[0] * W * 4 // 2} B")
    counts = {name: 0 for name in ops.KERNELS}
    counts["int8_matmul_prefill"] = 0
    with _nccl_one_rank() as mesh:
        par = make_parallel(mesh, "serve")
        for name, p in params.items():
            cfg = _cfg(name)
            want, fed = served[name]
            shards = _one_rank_shards(p, cfg, par,
                                      f"recurrent sharded {name}")
            ops.reset_launch_counts()
            with torch.no_grad(), _counting_all_reduce() as calls:
                eng = InferenceEngine(cfg, shards, parallel=par,
                                      batch_size=RG_B, max_seq=RG_MAX_SEQ,
                                      device="cuda")
                got = _fed_groups(eng, fed)
            for k, n in ops.launch_counts().items():
                counts[k] += n
            counts["int8_matmul_prefill"] += ops.int8_prefill_launches()
            unequal = [i for i, (g, w) in enumerate(zip(got, want))
                       if not np.array_equal(g, w)]
            st = eng.stats
            log(f"recurrent sharded {name}: nccl mesh (1, 1), graphs, "
                f"{len(got)} steps against the unsharded engine's: "
                f"bit-identical at {len(got) - len(unequal)} (unequal: "
                f"{unequal}), max |dlogit|/max|logit| = "
                f"{_rel(got, want):.3e}; captures={st.graph_captures} "
                f"replays={st.graph_replays}; nccl all_reduce calls from "
                f"the host (eager and captures) {len(calls)}")
            require(calls, f"recurrent sharded {name}: no nccl all_reduce")
            require(len(got) == len(want) and not unequal,
                    f"recurrent sharded {name}: logits != unsharded")
            require(st.graph_replays > 0,
                    f"recurrent sharded {name}: no replay")
            del eng, shards
            torch.cuda.empty_cache()
    log(f"recurrent sharded launches: {json.dumps(counts)}; "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("flash_attention", "decode_attention", "int8_matmul"):
        require(counts[name] > 0, f"recurrent sharded: {name} launched")
    return counts


def _serve_candidates(tag, engines, acc, n_requests, seed, kernels=None):
    """Candidates behind CNNSelectServer: profiling, then n_requests
    requests under cnnselect, budgets cycling between each two
    neighbouring candidates' means and a generous one, so the selection
    has a real choice to make. The launch counters are set to 0 just
    before and read just after: the launches by graph replays on this
    path of each of `kernels` (every kernel by default) must be > 0.
    Returns the path's counts and the candidates' measured profiles."""
    from repro_torch.kernels import ops
    from repro_torch.serving.batching import Request
    from repro_torch.serving.server import CNNSelectServer, ServedModel
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    with torch.no_grad():
        srv = CNNSelectServer(
            [ServedModel(name=n, engine=e, accuracy=acc[n],
                         size_bytes=e.resident_bytes)
             for n, e in engines.items()],
            t_threshold=30.0, policy="cnnselect", n_tokens=8)
        srv.profile_models(prompt_len=T_SERVE, reps=3)
        profs = srv.current_profiles()
        for p in profs:
            log(f"profile {p.name}: mu={p.mu:.2f} ms sigma={p.sigma:.2f} "
                f"acc={p.accuracy} size={p.size_bytes}")
        mus = sorted(p.mu for p in profs)
        budgets = [(a + b) / 2 for a, b in zip(mus, mus[1:])] + [mus[-1] * 3]
        rng = np.random.default_rng(seed)
        V = min(e.cfg.vocab for e in engines.values())
        for i in range(n_requests):
            sla = budgets[i % len(budgets)] + 40.0
            req = Request(arrival=0.0, rid=i,
                          prompt=rng.integers(0, V, T_SERVE)
                          .astype(np.int32),
                          t_input_ms=float(rng.uniform(5.0, 15.0)))
            rec = srv.handle(req, t_sla=sla)
            require(len(rec["tokens"]) == 8 and rec["e2e_ms"] > 0,
                    f"{tag} server request {i}")
            log(f"{tag} server req {i}: sla={sla:.1f} {json.dumps(rec)}")
        log(f"{tag} server summary: {json.dumps(srv.metrics.summary())}")
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts(),
                  int8_matmul_prefill=ops.int8_prefill_launches())
    replayed = ops.replayed_counts()
    for n, e in engines.items():
        st = e.stats
        log(f"serve engine {n}: graph captures {st.graph_captures}, "
            f"replays {st.graph_replays}, compile_time_s "
            f"{st.compile_time_s:.3f}, prefill {st.prefill_calls} calls "
            f"{st.prefill_time_s:.3f} s, decode {st.decode_calls} calls "
            f"{st.decode_time_s:.3f} s")
        require(st.graph_replays == st.prefill_calls + st.decode_calls,
                f"{n}: every prefill and decode a graph replay")
    log(f"serve {tag} launches: {json.dumps(counts)} (of them graph "
        f"replays: {json.dumps(replayed)}) in "
        f"{time.perf_counter() - t_start:.1f} s")
    for name in kernels or counts:
        require(replayed[name] > 0,
                f"{name} launched by a graph replay on the {tag} path")
    del srv
    return counts, profs


def phase_serve_recurrent(params):
    """The recurrent candidates behind CNNSelectServer (the
    recurrentgemma engines launch every kernel; mamba2 none). Returns
    the path's launch counts and measured profiles."""
    from repro_torch.serving.engine import InferenceEngine
    engines = {n: InferenceEngine(_cfg(n), p, batch_size=RG_B,
                                  max_seq=RG_MAX_SEQ, device="cuda")
               for n, p in params.items()}
    # Offline task scores of the candidates (set here, as the launcher
    # sets its tiers).
    acc = {"recurrentgemma_fp32": 0.72, "recurrentgemma_int8": 0.71,
           "mamba2_fp32": 0.70}
    counts, profs = _serve_candidates("recurrent", engines, acc, 9, 4)
    del engines
    torch.cuda.empty_cache()
    return counts, profs


# --------------------------------------------------------------------------
# Phase: dense (the five attention-only architectures at full width)
# --------------------------------------------------------------------------

def _dense_cfg(arch, impl="cuda"):
    from repro_torch.configs import get_config
    return get_config(arch, attn_impl=impl)


@contextlib.contextmanager
def _peak(label):
    """Log the card's memory at the start of the block and its peak over
    it (torch.cuda.max_memory_allocated), which must stay within
    PEAK_LIMIT_BYTES, and the block's seconds."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start, t0 = torch.cuda.memory_allocated(), time.perf_counter()
    yield
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: max_memory_allocated {peak / 1e9:.3f} GB (at the "
        f"start {start / 1e9:.3f} GB; limit {PEAK_LIMIT_BYTES / 1e9:.0f} "
        f"GB), {time.perf_counter() - t0:.1f} s")
    require(peak <= PEAK_LIMIT_BYTES,
            f"{label}: peak memory {peak / 1e9:.1f} GB")


def _log_tree(label, params):
    from repro_torch.quant.int8 import tree_bytes_quantized
    torch.cuda.synchronize()
    log(f"{label}: params {tree_bytes_quantized(params) / 1e9:.3f} "
        f"GB resident")


def _dense_gemma2(label, params, rng):
    """gemma2-9b through the engine at max_seq G2_MAX_SEQ, where its local
    ring (G2_WINDOW slots) is smaller than max_seq, so the engine refuses
    backfill as the reference does: the groups of G2_GROUPS (the first
    past the window: flash masks by window, the ring wraps), the graphs
    against `models.model` run eagerly on a fresh cache, bit for bit at
    every step; then the cuda path against the naive path at B = 1 (row
    0 of each group; the naive (T, T) logits at B = 4 would pass the
    memory limit), for int8 on the dequantized weights."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import InferenceEngine
    cfg = _dense_cfg("gemma2_9b")
    with torch.no_grad():
        eng = InferenceEngine(cfg, params, batch_size=B, max_seq=G2_MAX_SEQ)
        require(eng._maskable and not eng._backfillable,
                "gemma2_9b: the engine takes masks and refuses backfill")
        got, fed = _served_groups(eng, G2_GROUPS[:1], rng)
        # After the first group the local ring holds the window's last
        # positions, wrapped.
        pos = eng.cache["blocks"][0]["pos"]
        last = sum(G2_GROUPS[0]) - 1
        require(pos.shape[-1] == G2_WINDOW and int(pos.max()) == last
                and int(pos.min()) == last - G2_WINDOW + 1,
                f"gemma2_9b {label}: ring positions {int(pos.min())}.."
                f"{int(pos.max())}")
        more, fed2 = _served_groups(eng, G2_GROUPS[1:], rng)
        got, fed, stats = got + more, fed + fed2, eng.stats
        del eng, pos
        gc.collect()
        torch.cuda.empty_cache()
        want = _eager_groups(cfg, params, fed, G2_MAX_SEQ, masked=True)
    _bit_equal(f"dense gemma2_9b {label} (full width, max_seq {G2_MAX_SEQ}, "
               f"groups {G2_GROUPS})", got, want, stats)
    naive_p = _dequantized(params) if label == "int8" else params
    before = ops.launch_counts()
    with torch.no_grad():
        naive = _eager_groups(_dense_cfg("gemma2_9b", "naive"), naive_p,
                              [[t[:1] for t in toks] for toks in fed],
                              G2_MAX_SEQ, masked=True)
    require(ops.launch_counts() == before,
            f"gemma2_9b {label}: the naive run launched a kernel")
    del naive_p
    torch.cuda.empty_cache()
    worst = _worst_rel(f"gemma2_9b {label} cuda vs naive",
                       torch.from_numpy(np.stack([w[:1] for w in want])),
                       torch.from_numpy(np.stack(naive)))
    log(f"dense gemma2_9b {label}: cuda (B={B}, row 0) vs naive (B=1)"
        f"{' (dequantized weights)' if label == 'int8' else ''} over "
        f"{len(want)} steps of the groups {G2_GROUPS}: max |dlogit|/"
        f"max|logit| = {worst:.3e} (tol {LOGIT_TOL}); max|logit|="
        f"{max(float(np.abs(b).max()) for b in naive):.2f}")
    if label == "fp32":
        _g2_auto_vs_flash(params, rng)


def _g2_auto_vs_flash(params, rng):
    """gemma2-9b's prefill at T = G2_GROUPS[0][0] (B = 1, its row
    starting at G2_AUTO_VF, so the first key chunk lies below it and is
    skipped) under attn_impl "auto", which takes the chunked attention
    there (T² > 4096²), against the "cuda" flash path: every position's
    logits within LOGIT_TOL of max|logit|. Each path is timed once (CUDA
    events around the prefill)."""
    from repro_torch.models.model import prefill
    T = G2_GROUPS[0][0]
    cfgs = {impl: _dense_cfg("gemma2_9b", impl) for impl in ("auto", "cuda")}
    toks = torch.as_tensor(rng.integers(0, cfgs["auto"].vocab, (1, T)),
                           dtype=torch.int32, device="cuda")
    vf = torch.tensor([G2_AUTO_VF], dtype=torch.int32, device="cuda")
    out, ms = {}, {}
    for impl, cfg in cfgs.items():
        e0, e1 = _events()
        with torch.no_grad():
            e0.record()
            logits, cache = prefill(params, toks, cfg, G2_MAX_SEQ,
                                    valid_from=vf)
            e1.record()
        torch.cuda.synchronize()
        del cache
        out[impl], ms[impl] = logits, e0.elapsed_time(e1)
    worst = _worst_rel("gemma2_9b auto (chunked) vs cuda (flash)",
                       out["auto"], out["cuda"])
    log(f"dense gemma2_9b fp32: prefill B=1 T={T} valid_from "
        f"[{G2_AUTO_VF}] at max_seq {G2_MAX_SEQ}, attn_impl auto (chunked, "
        f"chunk {cfgs['auto'].attn_chunk}) vs cuda (flash): max |dlogit|/"
        f"max|logit| = {worst:.3e} (tol {LOGIT_TOL}); prefill ms (CUDA "
        f"events, one call each) auto {ms['auto']:.1f}, cuda "
        f"{ms['cuda']:.1f}")


def _dense_scheduled(label, arch, params, rng, cfg=None):
    """yi-9b / deepseek-coder-33b (or qwen3-moe-235b at its cut depth,
    cfg) through the engine on stablelm's schedule (graphs against
    eager, bit for bit), then the cuda path against the naive path on
    the same tree (for int8 the int8 kernel runs on both, so only the
    attention path differs): a ragged prefill at B x T_PREFILL and 16
    teacher-forced decode steps."""
    cfg = cfg or _dense_cfg(arch)
    _graphs_vs_eager(f"{arch} {label}", params, rng, cfg)
    lens = np.array([T_PREFILL, 300, 129, 37])
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, T_PREFILL)),
                           dtype=torch.int32, device="cuda")
    vf = torch.as_tensor(T_PREFILL - lens, dtype=torch.int32, device="cuda")
    forced = [torch.as_tensor(f, dtype=torch.int32, device="cuda")
              for f in rng.integers(0, cfg.vocab, (16, B, 1))]
    a, b = _cuda_vs_naive(f"{arch} {label}", cfg, params, params, toks, vf,
                          forced, S_CACHE)
    worst = _worst_rel(f"{arch} {label} cuda vs naive", a, b)
    log(f"{arch} {label}: prefill B={B} T={T_PREFILL} lengths="
        f"{lens.tolist()} + 16 decode steps, cuda vs naive attention (the "
        f"same tree): max |dlogit|/max|logit| = {worst:.3e} over 17 steps "
        f"(tol {LOGIT_TOL}); max|logit|={float(b.abs().max()):.2f}")


def _dense_embedded(label, arch, params, gen):
    """musicgen-large / chameleon-34b, model-level (the engine feeds
    tokens only, as the reference's): frame or patch embeddings drawn
    from the seed, a prefill at EMBED_T and EMBED_STEPS teacher-forced
    decode steps, each against one forward over the whole sequence
    (tests/test_decode.py:68), and the cuda path against the naive path
    on the same tree."""
    from repro_torch.models.model import forward
    cfg = _dense_cfg(arch)
    x = torch.randn((B, EMBED_T + EMBED_STEPS, cfg.d_model), generator=gen,
                    device="cuda")
    forced = [x[:, EMBED_T + s:EMBED_T + s + 1] for s in range(EMBED_STEPS)]
    a, b = _cuda_vs_naive(f"{arch} {label}", cfg, params, params,
                          x[:, :EMBED_T], None, forced, S_CACHE)
    with torch.no_grad():
        full = forward(params, x, cfg)[0][:, EMBED_T - 1:].transpose(0, 1)
    fwd = _worst_rel(f"{arch} {label} decode vs forward", a, full)
    worst = _worst_rel(f"{arch} {label} cuda vs naive", a, b)
    log(f"dense {arch} {label}: embeddings in, prefill B={B} T={EMBED_T} + "
        f"{EMBED_STEPS} teacher-forced decode steps: vs one forward over "
        f"the sequence max |dlogit|/max|logit| = {fwd:.3e}, cuda vs naive "
        f"attention (the same tree) {worst:.3e} (tol {LOGIT_TOL}); "
        f"max|logit|={float(b.abs().max()):.2f}")


def phase_dense():
    """The five attention-only architectures at published width and
    depth, one model at a time, each freed before the next (its peak
    memory logged and held under PEAK_LIMIT_BYTES): gemma2-9b fp32 and
    its int8 execution tree (`quantize_exec_tree`), yi-9b fp32, then the
    int8 trees of the two 34 B models built group by group
    (`tree_by_group`: their fp32 trees never fit the card):
    deepseek-coder-33b int8 through the engine, musicgen-large fp32 and
    chameleon-34b int8 model-level."""
    from repro_torch.models import init_params
    from repro_torch.quant.int8 import quantize_exec_tree
    rng = np.random.default_rng(6)
    gen = torch.Generator(device="cuda").manual_seed(6)
    with _peak("dense gemma2_9b fp32"):
        p32 = init_params(_dense_cfg("gemma2_9b"), seed=0)
        _log_tree("dense gemma2_9b fp32", p32)
        _dense_gemma2("fp32", p32, rng)
    with _peak("dense gemma2_9b int8"):
        p8 = quantize_exec_tree(p32)
        del p32     # the int8 tree keeps the embeddings and norms
        _log_tree("dense gemma2_9b int8", p8)
        _dense_gemma2("int8", p8, rng)
        del p8
    for arch, label in (("yi_9b", "fp32"), ("deepseek_coder_33b", "int8"),
                        ("musicgen_large", "fp32"), ("chameleon_34b", "int8")):
        with _peak(f"dense {arch} {label}"):
            cfg = _dense_cfg(arch)
            p = init_params(cfg, seed=0) if label == "fp32" else \
                tree_by_group(cfg, seed=0)
            _log_tree(f"dense {arch} {label}", p)
            if cfg.input_mode == "embeddings":
                _dense_embedded(label, arch, p, gen)
            else:
                _dense_scheduled(label, arch, p, rng)
            del p


def phase_serve_dense():
    """gemma2-9b int8 and yi-9b int8 (each built group by group from seed
    1) behind CNNSelectServer at max_seq S_CACHE. Returns the path's
    launch counts and measured profiles."""
    from repro_torch.serving.engine import InferenceEngine
    engines = {}
    with _peak("dense serve"):
        for name, arch in (("gemma2_int8", "gemma2_9b"),
                           ("yi_int8", "yi_9b")):
            cfg = _dense_cfg(arch)
            engines[name] = InferenceEngine(cfg, tree_by_group(cfg, seed=1),
                                            batch_size=B, max_seq=S_CACHE)
        # Offline task scores of the candidates (set here, as the
        # launcher sets its tiers).
        counts, profs = _serve_candidates(
            "dense", engines, {"gemma2_int8": 0.76, "yi_int8": 0.75}, 8, 7)
        del engines
    return counts, profs


# --------------------------------------------------------------------------
# Phase: moe (qwen3-moe-235b-a22b at published width, its depth cut)
# --------------------------------------------------------------------------

def moe_depth(cfg):
    """(layers, bytes of the embedding, head and final norm, bytes a
    layer): the most layers of cfg whose fp32 weights, with the
    embedding, the head and MOE_ACT_BYTES of activations, caches and
    graph pools, fit PEAK_LIMIT_BYTES."""
    fixed = dataclasses.replace(cfg, n_layers=0).param_count() * 4
    layer = cfg._block_params("moe") * 4
    return int((PEAK_LIMIT_BYTES - fixed - MOE_ACT_BYTES) // layer), \
        fixed, layer


def _moe_cfg(impl="cuda"):
    """qwen3-moe-235b-a22b at published width with its depth cut
    (moe_depth)."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH, attn_impl=impl)
    return dataclasses.replace(cfg, n_layers=moe_depth(cfg)[0])


def _graph_ms(fn, n):
    """Device-timeline ms of a replay of fn captured in a CUDA graph
    (`_timed` over n replays), after a warm-up call on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _timed(graph.replay, n)[1]


def _moe_step_times(eng, rng):
    """The step times of the moe engine, each as (wall ms, device-
    timeline ms) a call over MOE_TIMED calls (`_timed`): the graph steps
    through the engine (a group prefill at T_SERVE and T_PREFILL, decode
    steps after it; each returns host logits) and the same steps through
    `models.model` eagerly on the engine's cache. Then the MoE FFN's
    share of a decode step: the step captured and replayed as it is,
    and again with every layer's `moe_block_ffn` giving zeros (no
    expert runs), the device-timeline ms of a replay of each
    (`_graph_ms`); the FFN takes their difference."""
    from repro_torch.models import model as M
    from repro_torch.models.model import decode_step, prefill
    cfg, p = eng.cfg, eng.params
    out = {}
    for T in (T_SERVE, T_PREFILL):
        toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
        eng.run_prefill(toks)        # captured here at T_PREFILL
        out[f"prefill_T{T}_graph"] = _timed(lambda: eng.run_prefill(toks),
                                            MOE_TIMED)
        tt = torch.as_tensor(toks, device="cuda")
        out[f"prefill_T{T}_eager"] = _timed(lambda: prefill(
            p, tt, cfg, eng.max_seq, logits_last_only=True,
            valid_from=eng.valid_from, cache=eng.cache), MOE_TIMED)
    eng.run_prefill(rng.integers(0, cfg.vocab, (B, T_SERVE)).astype(np.int32))
    nxt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    out["decode_graph"] = _timed(lambda: eng.run_decode(nxt), MOE_TIMED)
    pos = torch.tensor(eng.cache_pos, dtype=torch.int32, device="cuda")
    tok = torch.as_tensor(nxt, device="cuda")

    def step():
        return decode_step(p, tok, eng.cache, pos, cfg,
                           valid_from=eng.valid_from)
    out["decode_eager"] = _timed(step, MOE_TIMED)
    with_ffn = _graph_ms(step, MOE_TIMED)
    ffn = M.moe_block_ffn
    M.moe_block_ffn = lambda p_, x, cfg_, parallel=None: (
        torch.zeros_like(x), torch.zeros((), device=x.device))
    try:
        without = _graph_ms(step, MOE_TIMED)
    finally:
        M.moe_block_ffn = ffn
    # A patch that no longer reaches the step would time the FFN twice.
    require(without < with_ffn, f"moe: the decode replay without the FFN "
            f"({without:.4f} ms) is not shorter than with it "
            f"({with_ffn:.4f} ms)")
    # The experts' bytes a decode step reads (every expert for every
    # token), over the FFN's ms: the rate it streams them at.
    expert_bytes = cfg.n_layers * 3 * cfg.moe.n_experts * cfg.d_model \
        * cfg.moe.d_ff_expert * 4
    out.update(decode_replay_ms=with_ffn, decode_replay_no_ffn_ms=without,
               moe_ffn_share_of_decode=1 - without / with_ffn,
               expert_bytes_per_step_GB=expert_bytes / 1e9,
               expert_stream_TB_s=expert_bytes / (with_ffn - without) / 1e9)
    return out


def phase_moe():
    """qwen3-moe-235b-a22b in fp32 at published width, its depth cut to
    moe_depth's layers (random weights from seed 0, init_params on the
    card), B = 4, max_seq S_CACHE, its peak held under PEAK_LIMIT_BYTES:
    stablelm's schedule through the engine (graphs against eager, bit
    for bit; the cuda path against the naive path, a ragged prefill at
    T_PREFILL and 16 teacher-forced steps); step times and the MoE FFN's
    share of a decode step; then MOE_REQUESTS requests through
    CNNSelectServer with this engine as the only candidate, on the same
    tree. Returns the path's launch counts."""
    from repro_torch.models import init_params
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.configs import get_config
    full = get_config(MOE_ARCH)
    depth, fixed, layer = moe_depth(full)
    cfg = _moe_cfg()
    log(f"moe {MOE_ARCH}: published width (d {cfg.d_model}, {cfg.n_heads} q "
        f"heads on {cfg.n_kv_heads} kv heads, hd {cfg.head_dim}, "
        f"{cfg.moe.n_experts} experts top {cfg.moe.top_k}, f "
        f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab}), fp32; depth cut "
        f"{full.n_layers} -> {depth} layers: {layer / 1e9:.3f} GB a layer, "
        f"{fixed / 1e9:.3f} GB embedding + head + norm, "
        f"{MOE_ACT_BYTES / 1e9:.0f} GB kept for activations, caches and "
        f"graph pools, limit {PEAK_LIMIT_BYTES / 1e9:.0f} GB")
    require(depth >= 1, "moe: no layer fits")
    rng = np.random.default_rng(9)
    with _peak(f"moe {MOE_ARCH} fp32 {depth} layers"):
        p = init_params(cfg, seed=0)
        _log_tree(f"moe {MOE_ARCH} fp32", p)
        _dense_scheduled("fp32", MOE_ARCH, p, rng, cfg=cfg)
        eng = InferenceEngine(cfg, p, batch_size=B, max_seq=S_CACHE)
        with torch.no_grad():
            eng.warmup(prompt_len=T_SERVE)
            times = _moe_step_times(eng, rng)
        log(f"moe {MOE_ARCH} step times ({depth} layers, B={B}; [wall ms, "
            f"device-timeline ms] a call over {MOE_TIMED} calls): "
            f"{json.dumps(times)}")
        # The engine serves from a fresh group: the timing above left its
        # cache at an arbitrary position.
        counts, _ = _serve_candidates(
            "moe", {"qwen3_moe_fp32": eng}, {"qwen3_moe_fp32": 0.8},
            MOE_REQUESTS, 10, kernels=("flash_attention", "decode_attention"))
        del eng
        shcounts = _moe_sharded(p, cfg)
        del p
    return counts, shcounts


@contextlib.contextmanager
def _counting_drops():
    """While the block runs (eagerly), each sharded MoE layer's dropped
    (token, choice) pairs, appended to the list it yields: the pairs
    sent to the dispatch buffer's dump slot (on a one-rank mesh every
    expert is local, so each is a pair past its expert's capacity)."""
    from repro_torch.models import moe as M
    real, drops = M._dispatch_slots, []

    def counted(idx, E_loc, off, C):
        slot = real(idx, E_loc, off, C)
        drops.append(int((slot == E_loc * C).sum()))
        return slot
    M._dispatch_slots = counted
    try:
        yield drops
    finally:
        M._dispatch_slots = real


def moe_mode_bytes(cfg, dp, tp, batch, T, es=4):
    """Computed (not measured): the bytes each rank of a (dp, tp) mesh
    receives a MoE layer a step in each moe_mode, beyond the closing
    sum over model that every mode makes: ep / tp gather the rest of
    its experts' d (its E/tp experts, or an ff/tp slice of all E) over
    data; ep2d / tp2d gather the other data ranks' tokens and receive
    their (dp - 1) shares of the ff partial sums in the reduce-scatter
    (B / dp rows each)."""
    m, d = cfg.moe, cfg.d_model
    local = 3 * m.n_experts * d * m.d_ff_expert * es / tp
    rows = (batch // dp) * T * d * es
    acts = 2 * (dp - 1) * rows
    return {"ep": local * (dp - 1) / dp, "tp": local * (dp - 1) / dp,
            "ep2d": acts, "tp2d": acts}


def _moe_sharded(p, cfg):
    """The sharded MoE (`moe_ffn_sharded`) through InferenceEngine(
    parallel=) with its graphs on a one-rank NCCL mesh (1, 1), on the
    phase's own tree (one-rank shards are views of it), in moe_mode
    ep2d, on the sharded phase's schedule (B = 4, a ragged prefill
    at T_SERVE, 16 decode steps, a backfill): (i) at capacity_factor =
    n_experts (nothing drops) within LOGIT_TOL of max|logit| of the
    unsharded engine (the dense path); (ii) at the config's capacity
    (pairs drop: C = 1 an expert at a decode step) graphs bit for bit
    its eager run, the dropped pairs logged a step. Returns the kernels'
    launches in the graph engines' runs (replays included)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.sharding import make_parallel
    t0 = time.perf_counter()
    from repro_torch.configs import get_config
    for arch in (MOE_ARCH, "grok_1_314b"):
        full = get_config(arch)
        log(f"moe sharded bytes into each rank a layer (computed, not "
            f"measured), {arch} fp32 on mesh (2, 2): decode B={B}: "
            f"{json.dumps(moe_mode_bytes(full, 2, 2, B, 1))}; prefill "
            f"B={B} T={T_PREFILL}: "
            f"{json.dumps(moe_mode_bytes(full, 2, 2, B, T_PREFILL))}")
    counts = {name: 0 for name in ops.KERNELS}
    feed = _sharded_feed(np.random.default_rng(22), cfg.vocab)
    kw = dict(batch_size=B, max_seq=S_CACHE, device="cuda")
    ample = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    def decode_ms(eng):
        """Host wall ms of a graph decode step (the engine's own clock,
        a device synchronise at each end)."""
        return eng.stats.decode_time_s / eng.stats.decode_calls * 1e3
    with torch.no_grad():
        eng = InferenceEngine(cfg, p, **kw)
        want = _sharded_engine_steps(eng, feed)
    step_ms, nccl = {"unsharded": decode_ms(eng)}, {}
    del eng
    torch.cuda.empty_cache()
    with _nccl_one_rank() as mesh:
        for mode in MOE_SHARD_MODES:
            par = make_parallel(mesh, "serve", moe_mode=mode)
            shards = _one_rank_shards(p, cfg, par, f"moe sharded {mode}")
            got = {}
            for label, c in (("ample", ample), ("config", cfg)):
                ops.reset_launch_counts()
                with torch.no_grad(), _counting_all_reduce() as calls:
                    eng = InferenceEngine(c, shards, parallel=par, **kw)
                    got[label] = _sharded_engine_steps(eng, feed)
                require(calls, f"moe sharded {mode} {label}: no nccl "
                        f"all_reduce")
                nccl[f"{mode} {label}"] = len(calls)
                for name, n in ops.launch_counts().items():
                    counts[name] += n
                require(eng.stats.graph_replays > 0,
                        f"moe sharded {mode} {label}: no replay")
                step_ms[f"{mode} capacity {c.moe.capacity_factor}"] = \
                    decode_ms(eng)
                del eng
                torch.cuda.empty_cache()
            marks = []
            with torch.no_grad(), _counting_drops() as drops:
                eager = _sharded_engine_steps(
                    InferenceEngine(cfg, shards, parallel=par, graphs=False,
                                    **kw),
                    feed, lambda: marks.append(len(drops)))
            torch.cuda.empty_cache()
            per_step = [sum(drops[a:b])
                        for a, b in zip([0] + marks[:-1], marks)]
            rel = _rel(got["ample"], want)
            unequal = [i for i, (g, e) in enumerate(zip(got["config"],
                                                         eager))
                       if not np.array_equal(g, e)]
            log(f"moe sharded {mode}: nccl mesh (1, 1), {cfg.n_layers} "
                f"layers, B={B} prefill T={T_SERVE} lengths={LENS_FIRST}, "
                f"{2 * SHARD_STEPS} decode steps, a backfill: (i) capacity "
                f"{ample.moe.capacity_factor} graphs vs unsharded engine max "
                f"|dlogit|/max|logit| = {rel:.3e} (limit {LOGIT_TOL}); (ii) "
                f"capacity {cfg.moe.capacity_factor} graphs vs eager "
                f"bit-identical at {len(eager) - len(unequal)} of "
                f"{len(eager)} (unequal: {unequal}); dropped (token, "
                f"choice) pairs a step, all layers: {per_step}")
            require(rel <= LOGIT_TOL, f"moe sharded {mode}: logits off")
            require(not unequal, f"moe sharded {mode}: graphs != eager")
            require(sum(per_step) > 0,
                    f"moe sharded {mode}: nothing dropped at capacity "
                    f"{cfg.moe.capacity_factor}")
            del shards
    log(f"moe sharded launches: {json.dumps(counts)}; nccl all_reduce "
        f"calls from the host (eager and captures): {json.dumps(nccl)}; "
        f"graph decode step "
        f"ms (host wall, mean of {2 * SHARD_STEPS}): {json.dumps(step_ms)}; "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("flash_attention", "decode_attention"):
        require(counts[name] > 0, f"moe sharded: {name} launched")
    return counts


# --------------------------------------------------------------------------
# Phase: sharded (the tensor-parallel serve path on torch.distributed)
# --------------------------------------------------------------------------

SHARD_STEPS = 8             # decode steps a side in the sharded checks
SHARD_B = 2                 # batch of the two-rank gloo run
SHARD_TIMEOUT = 300         # seconds the two gloo ranks may take
FD_S, FD_POS, FD_HEADS = 4096, 4096 + 700, (32, 4, 128)   # yi-9b's heads
FD_TOL = TOL[torch.float32]
# (b)'s moe_ffn_sharded cases on mesh (2, 1): (arch, moe_mode), reduced
# configs at capacity_factor = n_experts, B x T tokens; the FFN within
# SHARD_FFN_TOL of max|dense|, the aux loss within SHARD_AUX_TOL (the
# CPU tests' tolerances).
SHARD_MOE_CASES = (("qwen3_moe_235b", "ep"), ("qwen3_moe_235b", "ep2d"),
                   ("grok_1_314b", "tp"), ("grok_1_314b", "tp2d"))
SHARD_MOE_T = 8
SHARD_FFN_TOL, SHARD_AUX_TOL = 2e-5, 1e-6


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _sharded_feed(rng, V):
    """Fixed inputs of the sharded engine checks (every step's tokens
    given, so two engines whose logits differ in the last bits are fed
    alike): a left-padded group, SHARD_STEPS decode steps with a
    backfill into slot 1 half way, then SHARD_STEPS more."""
    row = np.zeros(T_SERVE, np.int32)
    row[T_SERVE - BACKFILL_LEN:] = rng.integers(0, V, BACKFILL_LEN)
    return (rng.integers(0, V, (B, T_SERVE)).astype(np.int32), row,
            rng.integers(0, V, (2 * SHARD_STEPS, B, 1)).astype(np.int32))


def _sharded_engine_steps(eng, feed, each=None):
    """The feed through the engine: the logits of every step. each: a
    callable run after every step."""
    prompts, row, toks = feed
    each = each or (lambda: None)
    out = [eng.run_prefill(prompts, lengths=LENS_FIRST)]
    each()
    for i in range(2 * SHARD_STEPS):
        if i == SHARD_STEPS:
            out.append(eng.prefill_row(row, 1, length=BACKFILL_LEN))
            each()
        out.append(eng.run_decode(toks[i]))
        each()
    return out


def _rel(got, want):
    return max(float(np.abs(g - w).max() / np.abs(w).max())
               for g, w in zip(got, want))


@contextlib.contextmanager
def _nccl_one_rank():
    """A one-rank NCCL process group over localhost for the block, and
    its mesh (1, 1) ("data", "model")."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _counting_all_reduce():
    """While the block runs, the torch.distributed.all_reduce calls made
    from the host (eager steps and graph captures; a replay makes
    none), one entry each in the list it yields."""
    import torch.distributed as dist
    real, calls = dist.all_reduce, []

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    dist.all_reduce = counted
    try:
        yield calls
    finally:
        dist.all_reduce = real


def _nccl_capture_check(par):
    """all_reduce, and the NCCL calls that all_gather and reduce_scatter
    make over an axis of more than one rank (`_all_gather_into`,
    `_reduce_scatter_into`), captured together in one CUDA graph on the
    one-rank NCCL group, replayed on 3 new inputs: over one rank each
    output is its input, bit for bit."""
    from repro_torch.sharding import (_all_gather_into, _reduce_scatter_into,
                                      all_reduce)
    group = par.mesh.get_group("model")
    x = torch.zeros((B, 4096), device="cuda")
    ar, ag, rs = (torch.zeros_like(x), torch.zeros((1,) + x.shape,
                  device="cuda"), torch.zeros_like(x))

    def body():
        ar.copy_(x)
        all_reduce(ar, par, ("data", "model"))
        _all_gather_into(ag, x, group)
        _reduce_scatter_into(rs, x, group)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()                  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    gen = torch.Generator(device="cuda").manual_seed(23)
    same = []
    for _ in range(3):
        x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        same.append([torch.equal(ar, x), torch.equal(ag[0], x),
                     torch.equal(rs, x)])
    log(f"sharded (a) nccl capture: all_reduce, all_gather's and "
        f"reduce_scatter's nccl calls in one CUDA graph, 3 replays on new "
        f"inputs, [all_reduce, all_gather, reduce_scatter] equal to the "
        f"input: {same}")
    require(all(all(r) for r in same), "sharded (a): nccl under capture")
    del graph


def _one_rank_shards(params, cfg, par, label):
    """shard_params on the one-rank mesh: every shard is its whole leaf,
    a view of the same storage (no copy of a 58 GB tree); logged and
    required."""
    from repro_torch.models.params import shard_params, tree_leaves
    shards = shard_params(params, cfg, par)
    pairs = list(zip(tree_leaves(params), tree_leaves(shards), strict=True))
    same = sum(a.data_ptr() == b.data_ptr() and a.shape == b.shape
               for a, b in pairs)
    log(f"{label}: shard_params on mesh (1, 1): {same} of {len(pairs)} "
        f"leaves share the unsharded leaf's storage (data_ptr equal)")
    require(same == len(pairs), f"{label}: a one-rank shard was copied")
    return shards


def _one_rank_nccl(p32, p8):
    """(a) A one-rank NCCL group and mesh (1, 1): full-width
    stablelm-1.6b, fp32 and int8, through InferenceEngine(parallel=)
    with graphs, against the unsharded engine (1e-4 of max|logit|) and
    against the same sharded engine run eagerly (bit for bit). Returns
    the kernels' launches in the graph engines' runs (replays
    included)."""
    from repro_torch.kernels import ops
    from repro_torch.models.params import shard_params
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.sharding import make_parallel
    cfg = _full_width("cuda")
    counts = {name: 0 for name in ops.KERNELS}
    counts["int8_matmul_prefill"] = 0
    with _nccl_one_rank() as mesh:
        par = make_parallel(mesh, "serve")
        for label, params in (("fp32", p32), ("int8", p8)):
            feed = _sharded_feed(np.random.default_rng(21), cfg.vocab)
            shards = shard_params(params, cfg, par)
            kw = dict(batch_size=B, max_seq=S_CACHE, device="cuda")
            with torch.no_grad():
                want = _sharded_engine_steps(
                    InferenceEngine(cfg, params, **kw), feed)
                eager = _sharded_engine_steps(InferenceEngine(
                    cfg, shards, parallel=par, graphs=False, **kw), feed)
                ops.reset_launch_counts()
                with _counting_all_reduce() as calls:
                    eng = InferenceEngine(cfg, shards, parallel=par, **kw)
                    got = _sharded_engine_steps(eng, feed)
                for name, n in ops.launch_counts().items():
                    counts[name] += n
                counts["int8_matmul_prefill"] += ops.int8_prefill_launches()
            unequal = [i for i, (g, e) in enumerate(zip(got, eager))
                       if not np.array_equal(g, e)]
            rel = _rel(got, want)
            st = eng.stats
            log(f"sharded (a) {label}: nccl mesh (1, 1), {cfg.name} full "
                f"width, B={B} prefill T={T_SERVE} lengths={LENS_FIRST}, "
                f"{2 * SHARD_STEPS} decode steps, a backfill into slot 1: "
                f"{len(got)} steps; graphs vs unsharded engine max "
                f"|dlogit|/max|logit| = {rel:.3e} (limit {LOGIT_TOL}); "
                f"graphs vs eager bit-identical at "
                f"{len(got) - len(unequal)} (unequal: {unequal}); "
                f"captures={st.graph_captures} replays={st.graph_replays}; "
                f"nccl all_reduce calls from the host (eager and captures) "
                f"{len(calls)}")
            require(rel <= LOGIT_TOL, f"sharded (a) {label}: logits off")
            require(calls, f"sharded (a) {label}: no nccl all_reduce")
            require(not unequal, f"sharded (a) {label}: graphs != eager")
            require(st.graph_replays > 0, f"sharded (a) {label}: no replay")
            del eng, shards
            torch.cuda.empty_cache()
        _nccl_capture_check(par)
    log(f"sharded (a) launches: {json.dumps(counts)}")
    for name in ("flash_attention", "decode_attention", "int8_matmul"):
        require(counts[name] > 0, f"sharded (a): {name} launched")
    return counts


def _sharded_rank(rank, world, port, out_dir):
    """(b) One of two gloo ranks on the one card (mesh (1, 2))."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref as R
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import flash_decode
    from repro_torch.models.model import decode_step, forward, prefill
    from repro_torch.models.params import init_params, shard_params
    from repro_torch.sharding import make_parallel, shard_leaf
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    res = {}
    try:
        par = make_parallel(make_mesh((1, world), ("data", "model")),
                            "serve")
        cfg = _full_width("cuda")
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randint(0, cfg.vocab, (SHARD_B, T_SERVE + SHARD_STEPS),
                          generator=gen, device="cuda", dtype=torch.int32)
        vf = torch.tensor([0, 20], dtype=torch.int32, device="cuda")
        params = init_params(cfg, seed=0, device="cuda")
        t0 = time.perf_counter()

        def run(p, parallel):
            fwd, _ = forward(p, x[:, :T_SERVE], cfg, parallel=parallel)
            pre, cache = prefill(p, x[:, :T_SERVE], cfg, S_CACHE,
                                 parallel=parallel, valid_from=vf)
            dec = []
            for i in range(SHARD_STEPS):
                lg, cache = decode_step(
                    p, x[:, T_SERVE + i:T_SERVE + i + 1], cache,
                    T_SERVE + i, cfg, parallel=parallel, valid_from=vf)
                dec.append(lg[:, 0])
            return [fwd, pre[:, -1], torch.stack(dec, 1)]
        with torch.no_grad():
            want = run(params, None)
            shards = shard_params(params, cfg, par)
            del params
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            got = run(shards, par)
            torch.cuda.synchronize()
        res["model_rel"] = {k: float((g - w).abs().max() / w.abs().max())
                            for k, g, w in zip(("forward", "prefill",
                                                "decode"), got, want)}
        res["model_s"] = {"unsharded": t1 - t0,
                          "sharded": time.perf_counter() - t1}
        del shards, got, want
        torch.cuda.empty_cache()

        # flash_decode_sharded on yi-9b's heads over a 4096-slot ring
        # that has wrapped, split over the two ranks, against the plain
        # decode attention over the whole cache.
        Hq, KV, hd = FD_HEADS
        ycfg = get_config("yi_9b")
        B4, S = 4, FD_S
        q = torch.randn((B4, 1, Hq, hd), generator=gen, device="cuda")
        kn = torch.randn((B4, 1, KV, hd), generator=gen, device="cuda")
        vn = torch.randn((B4, 1, KV, hd), generator=gen, device="cuda")
        ck = torch.randn((B4, S, KV, hd), generator=gen, device="cuda")
        cv = torch.randn((B4, S, KV, hd), generator=gen, device="cuda")
        # Stored positions of a ring past its wrap: slot s holds the
        # position p = s mod S in (FD_POS - S, FD_POS).
        s_idx = torch.arange(S, device="cuda")
        cpos = (FD_POS - S + (s_idx - (FD_POS - S)) % S).to(torch.int32)
        vfd = torch.tensor([0, FD_POS - 1000, FD_POS - 3, FD_POS + 5],
                           dtype=torch.int32, device="cuda")
        spec = (None, "model", None, None)
        sizes, coords = par.sizes, par.coords()
        lk, lv = (shard_leaf(t, spec, sizes, coords) for t in (ck, cv))
        lp = shard_leaf(cpos, ("model",), sizes, coords)
        cp = torch.tensor(FD_POS, dtype=torch.int32, device="cuda")
        with torch.no_grad():
            out = flash_decode.flash_decode_sharded(
                q, kn, vn, lk, lv, lp, cp, ycfg, par, window=S,
                valid_from=vfd)
            slot = FD_POS % S
            ck[:, slot], cv[:, slot], cpos[slot] = kn[:, 0], vn[:, 0], FD_POS
            ref = R.decode_attention_ref(
                q[:, 0], ck.transpose(1, 2), cv.transpose(1, 2), cpos,
                FD_POS, scale=ycfg.head_dim ** -0.5, window=S,
                valid_from=vfd)
        torch.cuda.synchronize()
        mine = slice(coords["model"] * (S // world),
                     (coords["model"] + 1) * (S // world))
        res["flash_decode"] = {
            "max_abs_err": float((out[:, 0] - ref).abs().max()),
            "empty_row_zero": bool((out[3] == 0).all()),
            "chunk_written": bool(torch.equal(lk, ck[:, mine])
                                  and torch.equal(lp, cpos[mine]))}
        res["moe_ffn"] = _sharded_moe_ffn(make_mesh((world, 1),
                                                    ("data", "model")))
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"sharded_rank{rank}.json", "w") as f:
        json.dump(res, f)


def _sharded_moe_ffn(mesh):
    """(b) moe_ffn_sharded on this rank's expert shards and batch rows
    over the two ranks' mesh (2, 1) (ep / tp gather the experts over
    data, ep2d / tp2d gather x and reduce-scatter the output: gloo's
    all_gather and reduce_scatter on CUDA tensors), its output gathered
    over data, against moe_ffn_dense on the whole batch (capacity
    n_experts: nothing drops); the aux loss against the dense loss over
    the rows each rank routes (its own in ep / tp, the gathered batch in
    ep2d / tp2d), averaged over the ranks."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.moe import (moe_ffn_dense, moe_ffn_sharded,
                                        moe_weight_specs)
    from repro_torch.models.params import init_params
    from repro_torch.sharding import all_gather, make_parallel, shard_leaf
    out = {}
    for arch, mode in SHARD_MOE_CASES:
        base = reduced_config(arch)
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=float(base.moe.n_experts)))
        p = {k: v[0] for k, v in
             init_params(cfg, seed=1, device="cuda")["blocks"][0].items()}
        par = make_parallel(mesh, "serve", moe_mode=mode)
        w_in, w_out = moe_weight_specs(mode, par.tp_axis, par.fsdp_axes)
        spec = {"w_gate": w_in, "w_up": w_in, "w_down": w_out}
        local = {k: shard_leaf(v, spec[k], par.sizes, par.coords())
                 if k in spec else v for k, v in p.items()}
        gen = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn((2 * par.dp_size, SHARD_MOE_T, cfg.d_model),
                        generator=gen, device="cuda")
        Bl = x.shape[0] // par.dp_size
        d = par.index(par.data_axes)
        with torch.no_grad():
            y, aux = moe_ffn_sharded(local, x[d * Bl:(d + 1) * Bl], cfg,
                                     par)
            y = all_gather(y, par, par.data_axes, 0)
            want, want_aux = moe_ffn_dense(p, x, cfg)
            if not mode.endswith("2d"):
                want_aux = sum(moe_ffn_dense(p, x[i:i + Bl], cfg)[1]
                               for i in range(0, x.shape[0], Bl)) / par.dp_size
        out[f"{arch} {mode}"] = {
            "rel": float((y - want).abs().max() / want.abs().max()),
            "aux_abs_err": abs(float(aux) - float(want_aux))}
    return out


def _two_gloo_ranks():
    """(b) Two gloo ranks on the one card (nccl refuses two ranks on one
    device), mesh (1, 2): full-width stablelm-1.6b fp32 forward,
    prefill and decode against the unsharded result, and
    flash_decode_sharded on yi-9b's heads against the plain decode
    attention; then mesh (2, 1): moe_ffn_sharded in every moe_mode
    against moe_ffn_dense; both ranks must pass."""
    import tempfile
    import torch.multiprocessing as mp
    out_dir = tempfile.mkdtemp(prefix="sharded_", dir=ROOT / "build")
    world = 2
    ctx = mp.start_processes(_sharded_rank,
                             args=(world, _free_port(), out_dir),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SHARD_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            require(time.monotonic() < deadline,
                    f"sharded (b): ranks done within {SHARD_TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    for rank in range(world):
        with open(Path(out_dir) / f"sharded_rank{rank}.json") as f:
            res = json.load(f)
        log(f"sharded (b) rank {rank}: gloo mesh (1, 2) on one card: "
            f"{json.dumps(res)}")
        for k, v in res["model_rel"].items():
            require(v <= LOGIT_TOL, f"sharded (b) rank {rank}: {k} logits")
        fd = res["flash_decode"]
        require(fd["max_abs_err"] <= FD_TOL,
                f"sharded (b) rank {rank}: flash_decode_sharded vs plain")
        require(fd["empty_row_zero"], f"sharded (b) rank {rank}: empty row")
        require(fd["chunk_written"],
                f"sharded (b) rank {rank}: the owner's cache write")
        for case, r in res["moe_ffn"].items():
            require(r["rel"] <= SHARD_FFN_TOL
                    and r["aux_abs_err"] <= SHARD_AUX_TOL,
                    f"sharded (b) rank {rank}: moe_ffn_sharded {case} vs "
                    f"dense")
    shutil.rmtree(out_dir)


def phase_sharded(p32, p8):
    t0 = time.perf_counter()
    counts = _one_rank_nccl(p32, p8)
    _two_gloo_ranks()
    log(f"sharded phase: {time.perf_counter() - t0:.1f} s")
    return counts


# --------------------------------------------------------------------------
# Phase: train (the training path at full width)
# --------------------------------------------------------------------------

def _to_card(d):
    return {k: torch.as_tensor(v, device="cuda") for k, v in d.items()}


def _leaf_worst(a_tree, b_tree):
    """Over the leaves: the largest max|a - b| / max|b| and max|a - b|
    (in float64), and whether every leaf is equal bit for bit."""
    from repro_torch.models.params import tree_leaves_sorted
    rel, diff, same = 0.0, 0.0, True
    for a, b in zip(tree_leaves_sorted(a_tree), tree_leaves_sorted(b_tree)):
        b = b.to(a.device)
        same = same and torch.equal(a, b.to(a.dtype))
        d = float((a.double() - b.double()).abs().max())
        rel = max(rel, d / max(float(b.abs().max()), 1e-30))
        diff = max(diff, d)
    return rel, diff, same


def _train_full(step_fn, cfg, opt, args):
    """TRAIN_STEPS launcher steps of full-width stablelm-1.6b (B x T of
    the launcher's defaults, the Markov task), each timed with CUDA
    events; a checkpoint after step TRAIN_CKPT_STEP, restored into a
    fresh ("meta") state as the launcher resumes, whose next step must
    give the uninterrupted run's loss and params. Returns the state after
    the resumed step."""
    from repro_torch.data import DataIterator, MarkovLMTask
    from repro_torch.models.params import tree_map
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.step import init_train_state
    it = DataIterator(MarkovLMTask(vocab=cfg.vocab), batch=args.batch,
                      seq=args.seq)
    # Drawn before the run: the Markov sampler's host time is not a step's.
    batches = [_to_card(next(it)) for _ in range(TRAIN_STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, opt, seed=0)
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    ck = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    mgr = CheckpointManager(str(ck), keep_n=1, save_interval=TRAIN_CKPT_STEP)
    losses, ms, after = [], [], None
    for b in batches:
        e0, e1 = _events()
        e0.record()
        state, m = step_fn(state, b)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(float(m["loss"]))
        s = int(state["step"])
        if s == TRAIN_CKPT_STEP:
            t0 = time.perf_counter()
            mgr.save(state, s)
            save_s = time.perf_counter() - t0
        elif s == TRAIN_CKPT_STEP + 1:
            after = (m["loss"].clone(),
                     tree_map(lambda t: t.cpu(), state["params"]))
    peak = torch.cuda.max_memory_allocated()
    tokens = args.batch * args.seq
    warm = sorted(ms[1:])
    med = warm[len(warm) // 2]
    log(f"train stablelm_1_6b full width ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, V {cfg.vocab}) fp32, mixed_precision(adamw("
        f"cosine lr {args.lr})), B={args.batch} T={args.seq} Markov: "
        f"{TRAIN_STEPS} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(last 5 mean {np.mean(losses[-5:]):.4f}); ms/step (CUDA events) "
        f"first {ms[0]:.3f}, median of the rest {med:.4f} (min "
        f"{warm[0]:.4f}, max {warm[-1]:.4f}), {tokens / med * 1e3:.1f} "
        f"tokens/s; train state {state_gb:.3f} GB, max_memory_allocated "
        f"{peak / 1e9:.3f} GB")
    log(f"train losses: {[round(x, 4) for x in losses]}")
    require(all(np.isfinite(losses)), f"train: losses {losses}")
    require(np.mean(losses[-5:]) < losses[0],
            f"train: the last 5 losses' mean {np.mean(losses[-5:]):.4f} is "
            f"not below the first {losses[0]:.4f}")

    target = tree_map(lambda t: t.to("meta"), state)
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    restored, manifest = mgr.restore_latest(target, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ck_gb = sum(f.stat().st_size for f in ck.rglob("*")) / 1e9
    require(manifest["step"] == TRAIN_CKPT_STEP,
            f"train: restored step {manifest['step']}")
    state, m = step_fn(restored, batches[TRAIN_CKPT_STEP])
    del restored
    loss_same = torch.equal(m["loss"], after[0].to(m["loss"].device))
    loss_rel = abs(float(m["loss"]) / float(after[0]) - 1)
    _, p_worst, p_same = _leaf_worst(state["params"], after[1])
    log(f"train checkpoint at step {TRAIN_CKPT_STEP}: {ck_gb:.3f} GB on "
        f"disk, save {save_s:.1f} s, restore into a meta target "
        f"{load_s:.1f} s; resumed step {TRAIN_CKPT_STEP + 1} against the "
        f"uninterrupted one: loss bit for bit {loss_same} (rel "
        f"{loss_rel:.2e}, tol {RESUME_LOSS_RTOL}), params bit for bit "
        f"{p_same}, max |dp| {p_worst:.3e} (tol {RESUME_TOL:.1e})")
    require(loss_rel <= RESUME_LOSS_RTOL and p_worst <= RESUME_TOL,
            "train: the resumed step differs from the uninterrupted one")
    shutil.rmtree(ck, ignore_errors=True)
    return state


def _train_long(state, cfg, opt):
    """One step of the full-width model at B=1, T=LONG_T under
    remat="block" with attn_impl "auto" (chunked attention there), then
    the same step under "naive" attention: loss, ms and peak memory of
    the step, and the peak of its loss and grads alone (the step's own
    peak is the optimizer update's, two train states at once)."""
    from repro_torch.data import MarkovLMTask
    from repro_torch.models import layers
    from repro_torch.training.step import (make_loss_fn, make_train_step,
                                           value_and_grad)
    batch = _to_card(MarkovLMTask(vocab=cfg.vocab).batch(0, 1, LONG_T))
    out = {}
    chunked = layers.ATTN_IMPLS["chunked"]
    calls = [0]

    def counted(*a, **kw):
        calls[0] += 1
        return chunked(*a, **kw)

    def peak_of(fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        e0, e1 = _events()
        e0.record()
        r = fn()
        e1.record()
        torch.cuda.synchronize()
        return r, e0.elapsed_time(e1), torch.cuda.max_memory_allocated()

    for impl in ("auto", "naive"):
        c = cfg.with_runtime(remat="block", attn_impl=impl)
        layers.ATTN_IMPLS["chunked"] = counted
        try:
            ms = []
            for _ in range(2):
                (new, m), t, peak = peak_of(
                    lambda: make_train_step(c, opt)(state, batch))
                del new
                ms.append(t)
            (_, gm), gms, gpeak = peak_of(lambda: value_and_grad(
                make_loss_fn(c), state["params"], batch)[0])
        finally:
            layers.ATTN_IMPLS["chunked"] = chunked
        loss = float(m["loss"])
        out[impl] = (loss, peak, gpeak)
        log(f"train long B=1 T={LONG_T} remat=block attn_impl={impl}: loss "
            f"{loss:.4f}; the step {ms[1]:.1f} ms (CUDA events; the first "
            f"of two {ms[0]:.1f}), {LONG_T / ms[1] * 1e3:.1f} tokens/s, "
            f"max_memory_allocated {peak / 1e9:.3f} GB;"
            f" loss and grads alone {gms:.1f} ms, {gpeak / 1e9:.3f} GB"
            + (f" (chunked attention calls over the three runs: {calls[0]})"
               if impl == "auto" else ""))
        require(np.isfinite(loss) and float(gm["loss"]) == loss,
                f"train long {impl}: loss {loss}, again {float(gm['loss'])}")
        if impl == "auto":
            # Once a layer forward, and again where the backward
            # recomputes the layer.
            require(calls[0] >= 2 * cfg.n_layers,
                    f"train long: auto took chunked {calls[0]} times, "
                    f"under twice a layer ({cfg.n_layers} layers) a run")
    rel = abs(out["auto"][0] / out["naive"][0] - 1)
    log(f"train long: chunked vs naive loss rel {rel:.2e} (tol "
        f"{LOSS64_RTOL}); loss-and-grads peak chunked "
        f"{out['auto'][2] / 1e9:.3f} GB, naive {out['naive'][2] / 1e9:.3f} "
        f"GB")
    require(rel <= LOSS64_RTOL, "train long: chunked and naive losses differ")


def _train_grads(cfg, args):
    """Two layers at full width: fp32 loss and grads against the same
    step in float64 on the card, and remat="block" against "none"."""
    from repro_torch.data import MarkovLMTask
    from repro_torch.models import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.training.step import make_loss_fn, value_and_grad
    c2 = dataclasses.replace(cfg, n_layers=2)
    c64 = c2.with_runtime(param_dtype="float64", compute_dtype="float64")
    p32 = init_params(c2, seed=1)
    p64 = tree_map(lambda t: t.double(), p32)
    batch = _to_card(MarkovLMTask(vocab=cfg.vocab).batch(
        0, args.batch, args.seq))
    (l32, _), g32 = value_and_grad(make_loss_fn(c2), p32, batch)
    (l64, _), g64 = value_and_grad(make_loss_fn(c64), p64, batch)
    del p64
    rel = abs(float(l32) / float(l64) - 1)
    worst, _, _ = _leaf_worst(g32, g64)
    del g64
    log(f"train grads, 2 layers at full width, B={args.batch} T={args.seq}: "
        f"fp32 vs float64 loss rel {rel:.2e} (tol {LOSS64_RTOL}), worst "
        f"grad leaf max|dg|/max|g64| {worst:.3e} (tol {GRAD64_TOL})")
    require(rel <= LOSS64_RTOL and worst <= GRAD64_TOL,
            "train grads: fp32 and float64 differ")
    (lremat, _), gr = value_and_grad(
        make_loss_fn(c2.with_runtime(remat="block")), p32, batch)
    rworst, _, rsame = _leaf_worst(gr, g32)
    log(f"train grads remat=block vs none: loss bit for bit "
        f"{torch.equal(lremat, l32)}, grads bit for bit {rsame}, worst leaf "
        f"{rworst:.3e} (tol {REMAT_TOL})")
    require(torch.equal(lremat, l32) and rworst <= REMAT_TOL,
            "train grads: remat=block and none differ")


def phase_train():
    """The training path at full width on the card (see the module
    docstring). No kernel runs here: training takes the plain attention,
    as the reference's does, and the phase requires that nothing
    launched one. Returns the phase's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    ops.reset_launch_counts()
    args = launcher.parse_args(["--steps", str(TRAIN_STEPS),
                                "--lr", str(TRAIN_LR)])
    cfg, opt, step_fn = launcher.build(args)
    state = _train_full(step_fn, cfg, opt, args)
    _train_long(state, cfg, opt)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    _train_grads(cfg, args)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launcher.main(["--steps", "2"])
    log(f"train: the launcher's CLI path (python -m repro_torch.launch."
        f"train --steps 2) {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    require(not any(counts.values()),
            f"train: the training path launched kernels {counts}")
    return counts


# --------------------------------------------------------------------------
# Phase: profile (not in the default run)
# --------------------------------------------------------------------------

def _profiled(fn, steps):
    """(wall ms, device kernel ms, kernel launches, kernel events) per
    call of fn over `steps` calls under torch.profiler. Wall and device
    time come from the same (profiled) calls, so wall holds the
    profiler's overhead. Kernel rows only: an operator row's device time
    repeats that of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    require(ev, "profiler recorded no device kernels")
    dev = sum(e.self_device_time_total for e in ev) / 1e3 / steps
    return wall, dev, sum(e.count for e in ev) / steps, ev


def _log_top(label, ev, steps, n):
    """The n kernels with the most device time: ms a step (all of a
    step's launches together) and launches a step."""
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:n]:
        ms = e.self_device_time_total / 1e3 / steps
        log(f"profile {label}   {ms:8.3f} ms/step  x{e.count / steps:5.0f}  "
            f"{e.key[:90]}")


def _share(ev, name, steps):
    """(device ms, launches) a step of the kernels whose name holds name."""
    kev = [e for e in ev if name in e.key]
    return (sum(e.self_device_time_total for e in kev) / 1e3 / steps,
            sum(e.count for e in kev) / steps)


def _timed(fn, n):
    """(wall ms, device-timeline ms) a call over n calls in a row: the
    host clock, and CUDA events recorded before the first call and after
    the last (the card's timeline, gaps included). Without profiler."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, e0.elapsed_time(e1) / n


PROFILE_STEPS, PROFILE_REPS = 64, 3
PROFILE_TRAIN_STEPS = 5


def phase_profile(p32, p8):
    """Where the time of a full-width decode step (B=4, context 64-127)
    and of a full-width prefill (B=4, T = 64 and 512) goes, through the
    engine's CUDA graphs ("graph") and through `models.model` called
    eagerly, as the engine ran before its graphs ("eager": tokens copied
    in, logits copied out, a fresh cache a prefill), on one card in one
    call. First without the profiler (host clock and CUDA events), then
    under torch.profiler (device kernel time, launches, idle share)."""
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.serving.engine import InferenceEngine
    cfg = _full_width("cuda")
    rng = np.random.default_rng(2)
    vf = torch.zeros((B,), dtype=torch.int32, device="cuda")
    for label, params in (("fp32", p32), ("int8", p8)):
        eng = InferenceEngine(cfg, params, batch_size=B, max_seq=S_CACHE)
        prompts = rng.integers(0, cfg.vocab, (B, T_SERVE)).astype(np.int32)
        toks = torch.tensor(prompts, device="cuda")

        def graph_group():
            nxt = eng.run_prefill(prompts).argmax(-1).astype(np.int32)
            return lambda: eng.run_decode(nxt[:, None])

        def eager_group():
            lg, cache = prefill(params, toks, cfg, S_CACHE,
                                logits_last_only=True, valid_from=vf)
            nxt = lg[:, 0].cpu().numpy().argmax(-1).astype(np.int32)[:, None]
            pos = itertools.count(T_SERVE)

            def step():
                lg, _ = decode_step(params, torch.tensor(nxt, device="cuda"),
                                    cache, next(pos), cfg, valid_from=vf)
                return lg[:, 0].cpu().numpy()
            return step
        groups = {"graph": graph_group, "eager": eager_group}
        with torch.no_grad():
            t0 = time.perf_counter()
            eng.warmup(T_SERVE)
            log(f"profile {label} warm-up and capture at T={T_SERVE}: "
                f"{time.perf_counter() - t0:.3f} s, captures "
                f"{eng.stats.graph_captures}")
            rows = {m: [] for m in groups}
            for r in range(PROFILE_REPS):
                for mode, group in groups.items():
                    rows[mode].append(_timed(group(), PROFILE_STEPS))
                    log(f"profile {label} decode {mode} rep {r}: wall "
                        f"{rows[mode][-1][0]:.4f} ms/step, device timeline "
                        f"{rows[mode][-1][1]:.4f} ms/step over "
                        f"{PROFILE_STEPS} steps (context {T_SERVE}-"
                        f"{T_SERVE + PROFILE_STEPS - 1})")
            graph_group()
            replay = eng._graphs["decode"].graph.replay
            _, dev = _timed(replay, PROFILE_STEPS)
            log(f"profile {label} decode graph replays alone (no copies, "
                f"no host wait): {dev:.4f} ms/replay device timeline")
            for mode, group in groups.items():
                wall = sorted(w for w, _ in rows[mode])[1]
                span = sorted(d for _, d in rows[mode])[1]
                log(f"profile {label} decode {mode}: median of "
                    f"{PROFILE_REPS} reps: wall {wall:.4f} ms/step, device "
                    f"timeline {span:.4f} ms/step")
                wall, dev, n_k, ev = _profiled(group(), 8)
                log(f"profile {label} decode step {mode} (profiler): wall "
                    f"{wall:.3f} ms, device kernels {dev:.3f} ms ({n_k:.0f} "
                    f"launches), "
                    + ", ".join("%s %.3f ms (%.0f launches)"
                                % (n, *_share(ev, n, 8))
                                for n in ("decode_attention", "int8_matmul"))
                    + f", device idle share {1 - dev / wall:.3f}")
                _log_top(f"{label} {mode}", ev, 8, 6)
        for T in (T_SERVE, T_PREFILL):
            ptoks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
            ttoks = torch.tensor(ptoks, device="cuda")
            calls = {
                "graph": lambda: eng.run_prefill(ptoks),
                "eager": lambda: prefill(
                    params, ttoks, cfg, S_CACHE, logits_last_only=True,
                    valid_from=vf)[0][:, 0].cpu().numpy()}
            with torch.no_grad():
                t0 = time.perf_counter()
                eng.run_prefill(ptoks)      # a first call at T: capture
                log(f"profile {label} prefill first call at T={T} (warm-up "
                    f"and capture): {time.perf_counter() - t0:.3f} s")
                for mode, fn in calls.items():
                    fn()
                    wall, span = _timed(fn, 5)
                    log(f"profile {label} prefill {mode} B={B} T={T}: wall "
                        f"{wall:.4f} ms, device timeline {span:.4f} ms "
                        f"(5 calls)")
                    wall, dev, n_k, ev = _profiled(fn, 3)
                    share = {n: _share(ev, n, 3)
                             for n in ("int8_matmul", "flash_attention")}
                    log(f"profile {label} prefill {mode} B={B} T={T} "
                        f"(profiler): wall {wall:.3f} ms, device kernels "
                        f"{dev:.3f} ms ({n_k:.0f} launches), "
                        + ", ".join(f"{n} {ms:.3f} ms ({c:.0f} launches)"
                                    for n, (ms, c) in share.items())
                        + f", device idle share {1 - dev / wall:.3f}")
                    _log_top(f"{label} {mode}", ev, 3, 4)
        st = eng.stats
        log(f"profile {label} engine: captures {st.graph_captures}, "
            f"replays {st.graph_replays}, compile_time_s "
            f"{st.compile_time_s:.3f}")
        del eng
        torch.cuda.empty_cache()


# The plain-torch functions of the recurrent mixers whose device time the
# recurrent profile reads (through torch.profiler ranges around them).
MIXER_FNS = {"rglru": ("rglru_scan", "rglru_step", "causal_conv1d"),
             "ssd": ("ssd_chunked", "ssd_step", "causal_conv1d")}


@contextlib.contextmanager
def _mixer_ranges():
    """Wrap each MIXER_FNS function, where its block looks it up, in a
    torch.profiler range named "<module>.<function>"."""
    from repro_torch.models import rglru, ssd
    saved = []
    for mod in (rglru, ssd):
        short = mod.__name__.rsplit(".", 1)[1]
        for name in MIXER_FNS[short]:
            fn = getattr(mod, name)

            def ranged(*a, _fn=fn, _label=f"{short}.{name}", **kw):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **kw)
            saved.append((mod, name, fn))
            setattr(mod, name, ranged)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _mixer_ms(fn, steps):
    """Device ms a call of fn of the kernels launched inside the mixer
    ranges, and of all kernels, under torch.profiler (eager calls: a
    range owns the kernels its operators launched)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    labels = {f"{m}.{n}" for m, names in MIXER_FNS.items() for n in names}
    torch.cuda.synchronize()
    with _mixer_ranges(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    ranges = {e.key: e.device_time_total / 1e3 / steps for e in ev
              if e.key in labels and e.device_type == DeviceType.CPU}
    kernels = sum(e.self_device_time_total for e in ev
                  if e.device_type == DeviceType.CUDA
                  and e.key not in labels) / 1e3 / steps
    return ranges, kernels


RPROFILE_STEPS = 16


def _profile_engine(tag, name, cfg, p, T, max_seq, masked=False):
    """Where the time of a full-width decode step and prefill (batch
    RG_B, prompt T) of one candidate goes, through the engine's graphs
    and through `models.model` called eagerly (masked: with valid_from =
    0, as the engine runs an attention-only pattern): wall and device
    timeline (CUDA events), then torch.profiler's device kernel time,
    launches and idle share, and the shares of the three kernels.
    Returns the eager decode step's and prefill's callables."""
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.serving.engine import InferenceEngine
    rng = np.random.default_rng(5)
    kernels = ("decode_attention", "flash_attention", "int8_matmul")
    eng = InferenceEngine(cfg, p, batch_size=RG_B, max_seq=max_seq,
                          device="cuda")
    prompts = rng.integers(0, cfg.vocab, (RG_B, T)).astype(np.int32)
    toks = torch.tensor(prompts, device="cuda")
    vf = torch.zeros((RG_B,), dtype=torch.int32, device="cuda") \
        if masked else None

    def graph_group():
        nxt = eng.run_prefill(prompts).argmax(-1).astype(np.int32)
        return lambda: eng.run_decode(nxt[:, None])

    def eager_group():
        lg, cache = prefill(p, toks, cfg, max_seq, logits_last_only=True,
                            valid_from=vf)
        nxt = lg[:, 0].cpu().numpy().argmax(-1).astype(np.int32)[:, None]
        pos = itertools.count(T)

        def step():
            lg, _ = decode_step(p, torch.tensor(nxt, device="cuda"),
                                cache, next(pos), cfg, valid_from=vf)
            return lg[:, 0].cpu().numpy()
        return step
    prefills = {
        "graph": lambda: eng.run_prefill(prompts),
        "eager": lambda: prefill(p, toks, cfg, max_seq,
                                 logits_last_only=True, valid_from=vf)[0][
            :, 0].cpu().numpy()}
    with torch.no_grad():
        t0 = time.perf_counter()
        eng.warmup(T)
        log(f"{tag} {name} warm-up and capture at T={T}: "
            f"{time.perf_counter() - t0:.3f} s")
        for mode, group in (("graph", graph_group), ("eager", eager_group)):
            wall, span = _timed(group(), RPROFILE_STEPS)
            log(f"{tag} {name} decode {mode} B={RG_B} context {T}-"
                f"{T + RPROFILE_STEPS - 1}: wall {wall:.4f} ms/step, "
                f"device timeline {span:.4f} ms/step")
            wall, dev, n_k, ev = _profiled(group(), 8)
            log(f"{tag} {name} decode step {mode} (profiler): wall "
                f"{wall:.3f} ms, device kernels {dev:.3f} ms ({n_k:.0f} "
                f"launches), "
                + ", ".join("%s %.3f ms (%.0f launches)"
                            % (k, *_share(ev, k, 8)) for k in kernels)
                + f", device idle share {1 - dev / wall:.3f}")
            _log_top(f"{name} decode {mode}", ev, 8, 6)
        for mode, fn in prefills.items():
            fn()
            wall, span = _timed(fn, 3)
            log(f"{tag} {name} prefill {mode} B={RG_B} T={T}: wall "
                f"{wall:.4f} ms, device timeline {span:.4f} ms (3 calls)")
            wall, dev, n_k, ev = _profiled(fn, 2)
            log(f"{tag} {name} prefill {mode} (profiler): wall "
                f"{wall:.3f} ms, device kernels {dev:.3f} ms ({n_k:.0f} "
                f"launches), "
                + ", ".join("%s %.3f ms (%.0f launches)"
                            % (k, *_share(ev, k, 2)) for k in kernels)
                + f", device idle share {1 - dev / wall:.3f}")
            _log_top(f"{name} prefill {mode}", ev, 2, 6)
    del eng
    torch.cuda.empty_cache()
    return eager_group, prefills["eager"]


def phase_profile_train():
    """Where a full-width train step's time goes (the train phase's
    model, optimizer and B x T): for the whole step and for its loss and
    grads alone, host wall and the card's timeline (CUDA events) over
    PROFILE_TRAIN_STEPS calls, then device kernel time and launches from
    torch.profiler and the kernels that take the most."""
    from repro_torch.data import MarkovLMTask
    from repro_torch.launch import train as launcher
    from repro_torch.training.step import (init_train_state, make_loss_fn,
                                           value_and_grad)
    args = launcher.parse_args(["--steps", str(TRAIN_STEPS),
                                "--lr", str(TRAIN_LR)])
    cfg, opt, step_fn = launcher.build(args)
    holder = [init_train_state(cfg, opt, seed=0)]
    batch = _to_card(MarkovLMTask(vocab=cfg.vocab).batch(
        0, args.batch, args.seq))
    loss_fn = make_loss_fn(cfg)

    def step():
        holder[0] = step_fn(holder[0], batch)[0]

    def grads():
        value_and_grad(loss_fn, holder[0]["params"], batch)
    n = PROFILE_TRAIN_STEPS
    for label, fn in (("step", step), ("loss and grads", grads)):
        fn()
        fn()
        wall, timeline = _timed(fn, n)
        pwall, dev, launches, ev = _profiled(fn, n)
        log(f"profile train {label} (B={args.batch} T={args.seq}, full "
            f"width): wall {wall:.2f} ms, timeline {timeline:.2f} ms (CUDA "
            f"events), device kernels {dev:.2f} ms in {launches:.0f} "
            f"launches, idle share {1 - dev / wall:.3f} (profiled wall "
            f"{pwall:.2f} ms)")
        _log_top(f"train {label}", ev, n, 10)
    del holder
    gc.collect()
    torch.cuda.empty_cache()


def phase_profile_recurrent(params):
    """Each recurrent candidate's steps (`_profile_engine`, prompt
    RG_T[0]), and (eager calls, profiler ranges) the device time of the
    plain-torch RG-LRU and SSD functions."""
    T = RG_T[0]
    for name, p in params.items():
        eager_group, eager_prefill = _profile_engine(
            "rprofile", name, _cfg(name), p, T, RG_MAX_SEQ)
        with torch.no_grad():
            ranges, dev = _mixer_ms(eager_group(), 8)
            log(f"rprofile {name} decode step eager, plain-torch mixer "
                f"functions: {json.dumps(ranges)} ms/step of {dev:.3f} ms "
                f"device kernels")
            ranges, dev = _mixer_ms(eager_prefill, 2)
            log(f"rprofile {name} prefill eager T={T}, plain-torch mixer "
                f"functions: {json.dumps(ranges)} ms/call of {dev:.3f} ms "
                f"device kernels")
        torch.cuda.empty_cache()


def phase_profile_dense():
    """Each dense engine candidate's steps (`_profile_engine`, batch
    RG_B, prompt T_PREFILL, max_seq S_CACHE), one model at a time:
    gemma2-9b fp32 and int8, yi-9b fp32, deepseek-coder-33b int8 (the
    int8 trees built group by group from seed 0)."""
    from repro_torch.models import init_params
    for arch, label in (("gemma2_9b", "fp32"), ("gemma2_9b", "int8"),
                        ("yi_9b", "fp32"), ("deepseek_coder_33b", "int8")):
        with _peak(f"dense profile {arch} {label}"):
            cfg = _dense_cfg(arch)
            p = init_params(cfg, seed=0) if label == "fp32" else \
                tree_by_group(cfg, seed=0)
            _profile_engine("dprofile", f"{arch}_{label}", cfg, p, T_PREFILL,
                            S_CACHE, masked=True)
            del p


# --------------------------------------------------------------------------
# Phase: tune (not in the default run)
# --------------------------------------------------------------------------

# Builds of csrc/int8_matmul.cu that the tune phase times: -D values of
# its tuning macros (ring depths, a forced tile) beside the default.
TUNE_VARIANTS = {
    "as built": (),
    "ring depths swapped": ("-DPF_LARGE_STAGES=3", "-DPF_SMALL_STAGES=2"),
    "128x128 always": ("-DPF_FORCE_TILE=128",),
    "64x64 always": ("-DPF_FORCE_TILE=64",),
}
# The dense models' w_down (K, N), the longest sums, timed at the M of
# chameleon-34b's prefill beside stablelm's projections.
TUNE_DENSE_KN = ((22016, 8192), (19200, 7168), (14336, 3584), (11008, 4096))


def phase_tune():
    """Device time of each prefill variant (fp32 x) at the full-width
    projections and the M of backfill (100) and prefill (B * T), and at
    the dense models' w_down, with the weight hot and cold in L2; and
    each variant's largest error against a float64 product, relative to
    max|ref|."""
    import ctypes
    from repro_torch.kernels import _build, ref as R
    from repro_torch.kernels.int8_matmul import _ARGTYPES
    libs = _build.build_variants(
        [("int8_matmul", f) for f in TUNE_VARIANTS.values()])
    fns = {}
    for name, flags in TUNE_VARIANTS.items():
        fns[name] = libs[("int8_matmul", flags)].int8_matmul_fwd
        fns[name].argtypes = _ARGTYPES
        fns[name].restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    shapes = ([(M, K, N) for M in (100, B * T_SERVE, 800, B * T_PREFILL)
               for K, N in PROJ_KN]
              + [(B * EMBED_T, K, N) for K, N in TUNE_DENSE_KN])
    for M, K, N in shapes:
        x = _randn(gen, (M, K), torch.float32)
        wq = torch.randint(-127, 128, (K, N), generator=gen,
                           device="cuda", dtype=torch.int8)
        sc = torch.rand((N,), generator=gen, device="cuda") * 1e-3
        out = torch.empty((M, N), device="cuda")
        args = (x.data_ptr(), wq.data_ptr(), sc.data_ptr(),
                out.data_ptr(), M, N, K, K, 0, stream)
        ref = R.int8_matmul_ref(x, wq, sc)
        tol = INT8_TOL[torch.float32] * float(ref.abs().max())
        exact = (x.double() @ (wq.double() * sc.double())).float()
        cold = copies(wq)   # a model's prefill reads each weight cold
        ms = {"hot": {}, "cold": {}, "rel_err_vs_float64": {}}
        for name, fn in fns.items():
            require(fn(*args) == 0, f"tune launch {name}")
            torch.cuda.synchronize()
            require(float((out - ref).abs().max()) <= tol,
                    f"tune {name} M={M} K={K} N={N} disagrees")
            ms["rel_err_vs_float64"][name] = float(
                (out - exact).abs().max() / exact.abs().max())
            ms["hot"][name] = bench_ms(lambda: fn(*args))
            ms["cold"][name] = bench_cold_ms(
                lambda w: fn(args[0], w.data_ptr(), *args[2:]), cold)
        del cold, exact
        torch.cuda.empty_cache()
        log(f"tune int8 prefill M={M} K={K} N={N} fp32 ms: "
            f"{json.dumps(ms)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %s"
                    % ", ".join(PHASES + EXTRA_PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if "sim" in phases and "serve" not in phases:
        ap.error("phase sim replays the serve phase's server: add serve")

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); this script runs only on the GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch
    except ImportError:
        sys.exit(f"chip_smoke: no src/repro_torch under {ROOT}; run it from "
                 f"a checkout of the repository")
    if Path(repro_torch.__file__).resolve().parents[2] != ROOT:
        sys.exit(f"chip_smoke: repro_torch from {repro_torch.__file__}, not "
                 f"from this checkout ({ROOT})")

    t0 = time.perf_counter()
    card = phase_build()
    results = {}
    if "kernels" in phases:
        phase_kernels(results)
    if "tune" in phases:
        phase_tune()
    scounts = phase_scan() if "scan" in phases else None
    if "scan_full" in phases:
        phase_scan_full()
    ccounts = phase_cluster() if "cluster" in phases else None
    if "profile_cluster" in phases:
        phase_profile_cluster()
    counts = rcounts = dcounts = shcounts = rshcounts = None
    # Profiles that the serve phases measured (the sim headline's zoo).
    measured = []
    if {"model", "serve", "profile", "sharded"} & set(phases):
        p32, p8 = _build_params()
        if "model" in phases:
            phase_model(p32, p8)
        if "serve" in phases:
            counts, served = phase_serve(p32, p8)
            measured += served["profiles"]
            if "sim" in phases:
                phase_sim(served)
            del served
        if "profile" in phases:
            phase_profile(p32, p8)
        if "sharded" in phases:
            shcounts = phase_sharded(p32, p8)
        del p32, p8
        torch.cuda.empty_cache()
    if {"recurrent", "profile_recurrent"} & set(phases):
        rparams = _recurrent_params()
        if "recurrent" in phases:
            rshcounts = phase_recurrent(rparams)
            rcounts, profs = phase_serve_recurrent(rparams)
            measured += profs
        if "profile_recurrent" in phases:
            phase_profile_recurrent(rparams)
        del rparams
        torch.cuda.empty_cache()
    if "dense" in phases:
        phase_dense()
        dcounts, profs = phase_serve_dense()
        measured += profs
    if "sim" in phases:
        phase_sim_headline(measured)
    if "profile_dense" in phases:
        phase_profile_dense()
    mcounts, mshcounts = phase_moe() if "moe" in phases else (None, None)
    tcounts = phase_train() if "train" in phases else None
    if "profile_train" in phases:
        phase_profile_train()
    log(f"card: {card}; wall {time.perf_counter() - t0:.1f} s")
    if results:
        kernels = []
        for name, meta in KERNEL_META.items():
            r = results[name]
            if name in ("queue_scan", "cluster_scan"):
                # Their main paths: the scan phase's open-loop simulate,
                # the cluster phase's check-row Cluster.run.
                path_counts = scounts if name == "queue_scan" else ccounts
                kernels.append(dict(
                    name=name, route="cuda", source=meta["source"],
                    replaces=meta["replaces"],
                    launches=(None if path_counts is None
                              else path_counts[name]),
                    **{k: r[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "pins", "bound_bytes_ms",
                        "bound_chain_ms", "fp64_add_cycles", "chain_links",
                        "sm_clock_mhz", "cycles_per_request", "shape")}))
                continue
            kernels.append(dict(
                name=name, route="cuda", source=meta["source"],
                replaces=meta["replaces"],
                launches=None if counts is None else counts[name],
                **({} if counts is None or name != "int8_matmul" else
                   {"prefill_launches": counts["int8_matmul_prefill"]}),
                # The recurrent path's own run (recurrentgemma-2b and
                # mamba2-2.7b behind CNNSelectServer).
                launches_recurrent=None if rcounts is None
                else rcounts[name],
                # The dense path's own run (gemma2-9b int8 and yi-9b int8
                # behind CNNSelectServer).
                launches_dense=None if dcounts is None else dcounts[name],
                # The moe path's own run (qwen3-moe-235b fp32, depth cut,
                # behind CNNSelectServer; no int8 kernel: its experts
                # compute in float only).
                launches_moe=None if mcounts is None else mcounts[name],
                # The sharded path's own run: stablelm-1.6b fp32 and
                # int8 through InferenceEngine(parallel=) on a one-rank
                # nccl mesh, graph replays included.
                launches_sharded=None if shcounts is None
                else shcounts[name],
                **({} if shcounts is None or name != "int8_matmul" else
                   {"prefill_launches_sharded":
                    shcounts["int8_matmul_prefill"]}),
                # The sharded MoE's runs: qwen3-moe-235b fp32 (depth
                # cut) through InferenceEngine(parallel=) on a one-rank
                # nccl mesh in moe_mode ep2d, graph replays
                # included (no int8 kernel).
                launches_sharded_moe=None if mshcounts is None
                else mshcounts[name],
                # The sharded recurrent blocks' runs: recurrentgemma-2b
                # fp32 and int8 and mamba2-2.7b fp32 the same way.
                launches_sharded_recurrent=None if rshcounts is None
                else rshcounts[name],
                # The training path's run: none (it runs the plain
                # attention; the kernels have no backward).
                launches_train=None if tcounts is None else tcounts[name],
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
                pins=r["pins"],
                **{k: r[k] for k in ("bound_fp32_cores_ms", "cold_ms",
                                     "library_cold_ms", "plan", "small_m",
                                     "prefill", "recurrentgemma", "dense",
                                     "rows")
                   if k in r},
                shape=r["shape"]))
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
