#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on a GPU.

    python3 chip_smoke.py

needs one NVIDIA GPU (written for an H100, sm_90a), ``nvcc`` and PyTorch
with CUDA; it imports only ``repro_torch`` (never jax, never the JAX
package).  Phases, each printing one JSON line; any failure exits non-zero:

  env      card name and power limit (nvidia-smi), torch and CUDA versions
  analysis python -m repro_torch.analysis --format json over the port's
           code (src/repro_torch, this script, tools, examples/torch_*.py)
           in a subprocess: exit 0, no failing finding; then the tag and
           parameter-path universes of every arch at published size on
           meta, each equal to the reduced one the CLI checks against
           (host only: run in a background process from the script's
           start, its record read after the last phase)
  build    nvcc-builds the kernel library from src/repro_torch/kernels/csrc
           and reports ptxas registers and spills of the dW, sampled_matmul
           and flash kernels
  kernels  every kernel against its plain PyTorch version ON THE CARD, at
           the main path's shapes and at ragged ones, bf16/f32/f16; timed
           with CUDA events beside the plain version, a library
           composition and the card's bound; the reference's unfused
           composition row_norms -> plan -> gather_scale -> sampled_matmul
           against fused_sampled_dw at full width; a plan index outside
           [0, n) ends each gathering kernel in a device-side assert
           (gather_scale on both routes and, on bulk, in every dtype;
           sampled_matmul on both of its wgmma tiles, fused_sampled_dw
           with and without its expert axis).  fused_sampled_dw's expert
           axis (E experts' dW in one launch) at the MoE phases' expert
           shapes (timed beside E launches of the call without the axis)
           and at ragged ones (E=3, odd k, k < 64, widths multiples of 8
           not of 64, duplicate indices, a misaligned view), E = 1 bit
           for bit the call without the axis; the routers' narrow dW
           flash_attention_fwd, fused_sampled_dw, sampled_matmul and
           gather_scale report the route each case took (launches_by_route;
           wgmma, or bulk for the gather, wherever the shape allows, edge
           shapes and misaligned operands included); gather_scale bit-equal
           three calls in a row at the bulk route's edges (rows packed to
           an item with a shorter last item, rows in pieces with a shorter
           last piece, B*k below the SM count, k = 1, every slot one row,
           the 2-D form; a misaligned view on the warp route), each timed
           shape on both routes pinned in turns (warp, bulk, bulk, warp)
           and L2-cold (a 128 MB write before each call) beside
           torch.gather;
           sampled_matmul's timed cases also time the kernel alone on
           operands planned once; flash bf16 is
           also held against the tensor-op models/attention.py;
           flash_attention_bwd against its plain version (bf16/f16,
           causal or not, G 1 / 6, ragged, Dh 16-128), the same bits on a
           second call, f32 refused, and timed at the train shape and
           nemotron-4-15b's (B=16, 48/8 heads of 128, S=2048) beside
           the backward of scaled_dot_product_attention
  autotune the tile tuner (repro_torch.kernels.autotune): refresh_table
           over DEFAULT_SWEEP into a temporary table, every candidate tile
           of both sampled-dW kernels held against the plain version and
           timed (time_ms); each shape's rule pick, tuned pick and times;
           the packaged table checked whole (every sweep key, each entry
           the fastest of its own candidates, the card named), its picks
           re-timed against the rule's where they differ (reported, not
           held); one train step of qwen2.5-3b at depth 1 under a
           KernelConfig(table_path=...) whose tiles differ from the rule
           launches the table's tiles (launches_by_tile); the CLI in
           process
  parity   one det_topk train step of a reduced config: card (kernels)
           against CPU (plain versions), f32
  train    qwen2.5-3b at published width, depth cut to 12 layers, B=4,
           S=1024, WTA-CRS at budget 0.3: 6 steps through
           get_config -> init_train_state -> make_train_step -> train_step;
           losses finite and falling, launch counts as expected (the
           training attention's flash_attention_fwd / _bwd once a layer
           each, read off a meta trace of the step), every
           fused_sampled_dw launch on the wgmma route (its launches by
           tile reported) and every gather_scale launch on bulk (so too
           in optim, moe, moe_wide)
  memory   the same for 2 steps under EXACT_CONFIG; both peaks side by side;
           then, in a child process with deterministic algorithms on, 2
           steps of the model at depth 3 (MEMORY_DEPTH) under the
           reference's `mixed` OptimSpec in four legs:
           exact and WTA-CRS 0.3 without remat, WTA-CRS under
           remat="wtacrs_names", exact under remat="full" — each remat
           leg's losses bit-equal to its `none` leg's, launches as
           launches_per_step implies (row_norms and gather_scale twice a
           plan under "full"), every peak
  adaptive Algorithm 1's whole loop at the same width on 8 samples: 10
           make_scheduled_train_step steps with the znorm cache and budget
           statistics, WTA-CRS on the MLP linears at a fixed 0.3 and under
           an ESSProportional controller; cache, stats and launch counts
           checked against what the resolved policies imply
  accumulate  the fixed policy for 3 steps at microbatches=2
  optim    nemotron-4-15b at published width, depth cut 32 -> 1, B=1,
           S=2048, WTA-CRS 0.3: 4 make_train_step steps from fresh
           parameters under each of three OptimSpecs of the reference's
           memory benchmark (factored_came, factored, mixed): losses
           finite and falling, launches as expected and on wgmma, the
           state's bytes on the card equal to memory_report's, peak
           memory, ms a step; one subspace refresh (SVD) of the mixed
           leg's widest leaf timed; dense AdamW's state from
           memory_report only
  run      the repro_torch.api façade at published width, depth cut 36 ->
           6 (RUN_DEPTH): Run(RunSpec(qwen2.5-3b, reduced=False)) under
           the adaptive
           policy, B=2, S=1024, 4 samples, 8 steps of Run.fit (losses
           falling, launch counts as the resolved policies imply, every
           fused_sampled_dw launch on wgmma, peak memory, ms a step),
           Run.report, Run.generate (2 x 128-token prompts, 32 greedy
           tokens) bit-equal to its hand-wired prefill-chunk + serve-step
           loop, Run.serve (4 ragged greedy requests) each bit-equal to
           the solo route at the pool's shapes
  resume   in a child process with deterministic algorithms on, in the
           background from the run phase on (its record read here): the
           reduced qwen2.5-3b under the adaptive policy on the card, 6
           uninterrupted Run.fit steps against 3 steps, save (blocking,
           then asynchronous), Run.restore and 3 more: params, optimizer,
           cache, statistics, history and budget trajectory bit-equal;
           Run.fit's losses bit-equal to the hand-wired scheduled step
  serve_parity  one prefill_step + 4 serve_steps of a reduced config: card
           (flash kernel) against CPU (plain version), f32
  prefill  qwen2.5-3b at published width and full depth (36 layers), B=4
           prompts of S=2048 through make_prefill_step: 36 flash launches a
           call, all on the wgmma route, last logits against the model's
           own forward
  decode   64 greedy serve_steps from the prefill's (padded) caches, the
           first 8 positions against a teacher-forced forward
  pool     ServeSession (8 slots, paged KV, chunked prefill) on its
           background loop, qwen2.5-3b at published width cut to 2 layers,
           serving 12 ragged greedy and 2 sampled requests; each greedy
           request bit-equal to itself served alone, the sampled ones
           repeatable, the solo route counted
  wide_serve  command-r-35b at published width (64/8 heads), depth cut
           40 -> 4: prefill of 2 x 2048 tokens through make_prefill_step
           (the flash kernel at 64/8 heads, wgmma) and 16 decode steps,
           each held against the model's own forward as in prefill/decode
  moe      granite-moe-1b-a400m at published width, depth cut 24 -> 6
           (MOE_DEPTH; 32 experts top-8): 6 WTA-CRS 0.3 steps at B=4, S=1024
           (every linear sampled: the router over B*S rows, each expert
           over its capacity slots, every expert's dW in one launch a
           weight); losses falling, lb_loss part of the loss, drop_frac,
           launches as launches_per_step implies and all on wgmma, peak,
           ms and device-busy ms a step; 2 exact steps for the peak; in a
           child process with deterministic algorithms on, 2 steps under
           remat none and wtacrs_names with bit-equal losses; prefill of
           4 x 2048 tokens against the forward; 16 bf16 decode steps
           (timed, their distance to a teacher-forced forward at capacity
           factor E / top-k, where no entry drops, measured), then 8 f32
           decode steps held against that forward in f32 (in bf16 a
           router logit rounded in another order flips top-k experts);
           4 greedy requests through the pool each bit-equal to itself
           alone and to the solo route
  moe_wide dbrx-132b at published width (48/8 heads of 128, 16 experts of
           6144 x 10752): depth 40 -> 2 prefills 2 x 2048 tokens and takes
           8 decode steps, checked as in moe; depth 1
           trains 3 WTA-CRS steps at B=1, S=2048 under the factored
           OptimSpec: losses falling, launches as implied and on wgmma,
           state bytes on the card equal to memory_report's, peak
  ssm      zamba2-2.7b at published width (d_model 2560, 80 Mamba2 heads
           of 64, state 64, the shared block's 32/32 heads of 80, d_ff
           10240, vocab 32000): depth 54 -> 12 trains 4 WTA-CRS 0.3 steps
           (every linear sampled, each use of the shared block its own
           plans) and 2 exact ones at B=2, S=2048, checked as in moe;
           the whole model (54 layers, 2.06 B parameters) trains 2 steps
           at B=1 under remat "full", its peak beside the reckoned one;
           at full depth a prefill of 2 x 2048 tokens (flash on its wgmma
           route at Dh 80) and 16 decode steps, their bf16 distance to the
           forward measured (at random weights the card's bf16 GEMM
           roundings, which differ with the row count, grow through the
           54 layers far past the forward's own floor), the same in f32
           held against the f32 forward at 5e-2; 4 pool requests at the
           first 6 layers (one pattern unit) each bit-equal to itself
           alone and to the solo route
  xlstm    xlstm-125m at published width, depth 12 -> 2: 3 WTA-CRS
           steps (the last one traced) and 1 exact step at B=4, S=1024,
           the device's idle share of a step (the host's per-time-step
           loop); prefill 2 x 1024 and 16 decode steps held against the
           forward in bf16 and in f32, 4 pool requests as in ssm
  vlm      qwen2-vl-2b at full size (28 layers, 12/2 heads of 128, M-RoPE;
           the vision frontend a stub: patch embeddings come in the batch):
           4 WTA-CRS steps (every linear sampled, vis_proj over the patch
           rows) and 1 exact step at B=4, S=1024 (256 patches, 768 text
           tokens of make_synthetic_batch), launches a step as the trace
           implies (113 row_norms and gather_scale, 197 dW); prefill of 4 x
           2048 (512 patches) through flash's wgmma route at group 6, 16
           M-RoPE decode steps, both held in bf16 against the forward; 4
           pool requests as in moe at the first 6 layers; Run.generate on
           2 text prompts
           bit-equal to the solo route
  whisper  whisper-base at full size (6 + 6 layers, 32768-row learned
           position tables; frame embeddings a stub): 4 WTA-CRS steps
           (xattn_k / xattn_v sampled over the frames) and 1 exact step at
           B=8 of 1024 frames and 1024 tokens, launches a step as implied
           (72 row_norms and gather_scale, 96 dW), the idle share;
           prime_cross_cache on 2 x 1024 frames and 16 greedy decode steps
           at a shared scalar position against the teacher-forced forward,
           in f32 and in bf16; ServeSpec, prefill and per-row positions
           refused as in the reference
  dp       data parallelism, in child processes: (a) one rank over NCCL,
           qwen2.5-3b at published width, depth 6, B=4, S=1024, WTA-CRS
           0.3 on every linear: 3 make_shardmap_dp_step steps under each
           gradient compression (none, bf16, int8), launches as the
           structure implies, the reduction of a gradient-sized tree timed
           with its payload, peaks; under det_topk and deterministic
           algorithms, `none` bit-equal to make_train_step; (b) two ranks
           sharing the card over gloo (CUDA tensors reduced through host
           memory), depth 2, B=4 (2 a rank): 2 WTA-CRS steps a mode, the
           ranks' parameters bit-identical (sha256), each compressed mean
           of the ranks' own gradients within its quantization bound,
           `none` against one rank on the global batch (exact linears in
           f32; det_topk on every linear with the batch in the ranks'
           shapes), and Run(mesh="host") at the same size (f32) under a
           CACHED_GRAD controller policy: cache and statistics equal the
           one-rank Run's (microbatches 2), ms a step
  tp       tensor and expert parallelism, two ranks sharing the card over
           gloo at model = 2 (one model group): qwen2.5-3b at published
           width, depth 2, B=2, S=1024: 2 WTA-CRS bf16 steps (loss falls,
           launches as the structure implies, the replicated leaves
           bit-identical across the ranks), 2 exact f32 steps held
           against one rank on the gathered parameters, a 2 x 2048
           prefill and 16 decode steps (the KV cache split on its
           sequence) held against one rank at the prefill phase's bf16
           floor; granite-moe-1b-a400m at published width, depth 3, 2
           WTA-CRS steps with 16 experts a rank; dbrx-132b at published
           width, depth 1, prefill and decode with 8 experts a rank (the
           distance to one rank measured); qwen2.5-3b at depth 1 under
           the factored_came / factored / mixed optimizer specs (3
           WTA-CRS bf16 steps, then 3 exact f32 steps held against one
           rank: factored slots and parameters at 1e-4 relative L2;
           mixed's energy at 1e-3 and parameters at twice one rank's
           microbatched spread; replicated slots bit-identical across the
           ranks), Run(mesh="host", model_parallel=2) (fit 4 steps with
           checkpoints at 2 and 4 written by rank 0 alone, a fresh Run
           from step 2 bit-equal under deterministic algorithms, the
           checkpoint restored at one rank in the parent, generate with
           caches split on head_dim and on the sequence, serve 6 requests
           from a pool split by page positions, f32 tokens equal to one
           rank's) and a column- and a row-parallel LoRA linear held
           against one rank; each collective's count, bytes and ms (a
           host round trip through gloo)
  dryrun   the train phase's cell (12 layers, B=4, S=1024, its WTA-CRS
           policy, one rank) traced on the meta device by
           launch/cost.py and held against the same step on the card:
           the predicted peak within 10 % of the measured one, each
           kernel's predicted launches equal to its real counter, the
           step's bound beside its device-busy ms; then the records of
           qwen2.5-3b and dbrx-132b x train_4k x single
           (repro_torch.launch.dryrun, run in background processes on the
           host from the script's start)

then the ``{"kernels": [...]}`` summary line, each phase's seconds, the
nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import glob
import hashlib
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch import optim as optim_lib  # noqa: E402
from repro_torch.analysis import (analyze_paths, csrc,  # noqa: E402
                                  kernel_contracts)
from repro_torch.analysis import policy_check  # noqa: E402
from repro_torch.api import DataSpec, Run, RunSpec  # noqa: E402
from repro_torch.core import (EXACT_CONFIG, BudgetSchedule,  # noqa: E402
                              ESSProportional, KernelConfig, LoRAConfig,
                              PolicyRules, RankController, Rule,
                              WTACRSConfig, plans)
from repro_torch.core import lora as lora_lib  # noqa: E402
from repro_torch.kernels import _build, autotune, costs  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import fused_sampling, ops  # noqa: E402
from repro_torch.kernels import gather_scale as gather_scale_mod  # noqa: E402
from repro_torch.kernels import row_norms as row_norms_mod  # noqa: E402
from repro_torch.kernels import \
    sampled_matmul as sampled_matmul_mod  # noqa: E402
from repro_torch.kernels.autotune import (HOST_LEAD_CYCLES,  # noqa: E402
                                          time_ms)
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import collectives  # noqa: E402
from repro_torch.launch import cost as cost_lib  # noqa: E402
from repro_torch.launch import dryrun as dryrun_lib  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import roofline as roofline_lib  # noqa: E402
from repro_torch.launch import sharding, train_steps  # noqa: E402
from repro_torch.models import attention as attention_mod  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import encdec, lm  # noqa: E402
from repro_torch.models import mlp as mlp_mod  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.serve import ServeSession, ServeSpec  # noqa: E402
from repro_torch.serve import pool as pool_lib  # noqa: E402
from repro_torch.train import (checkpoint, compression, data,  # noqa: E402
                               optim, znorm)

# Published dense peaks of one H100 SXM (NVIDIA data sheet), the yardstick
# every bound below is computed against.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}    # f32 outside the tensor cores

ALL_PHASES = ("env", "analysis", "build", "kernels", "autotune", "parity",
              "train",
              "memory", "adaptive", "accumulate", "optim", "run", "resume",
              "serve_parity", "prefill", "decode", "pool", "wide_serve",
              "moe", "moe_wide", "ssm", "xlstm", "vlm", "whisper", "dp",
              "tp", "dryrun")
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16"}

# Main-path shapes of qwen2.5-3b at B=4, S=1024, budget 0.3 (k = 307).
B, S, K = 4, 1024, 307
ROW_NORM_MAIN = [(B * S, 2048), (B * S, 11008)]
FUSED_MAIN = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]
ROW_NORM_RAGGED = [(33, 130), (7, 5)]
# The run phase: Run.fit on RUN_DEPTH-layer qwen2.5-3b at B=2, S=1024, its k set by
# the controller's budget level (run_budget_ks); Run.generate on GEN_ROWS
# prompts; Run.serve's ragged greedy requests as (prompt length, max_new)
RUN_STEPS, RUN_BATCH, RUN_SEQ, RUN_SAMPLES = 8, 2, 1024, 4
ROW_NORM_RUN = [(RUN_BATCH * RUN_SEQ, 2048), (RUN_BATCH * RUN_SEQ, 11008)]
GEN_ROWS, GEN_PROMPT, GEN_NEW = 2, 128, 32
RUN_SERVE = [(9, 24), (40, 16), (77, 32), (3, 20)]
# (B, k, n, d_in, d_out)
FUSED_RAGGED = [(2, 20, 50, 130, 70), (1, 16, 64, 32, 24), (3, 13, 40, 33, 17)]
# the wgmma route's edges: the k tail 307, d_in and d_out multiples of 8
# but not of 64 (plan slot 1 repeats slot 0: duplicate indices)
FUSED_EDGE = [(4, 307, 1024, 136, 200), (2, 307, 300, 2056, 72),
              (1, 65, 70, 8, 1032)]
# flash_attention_fwd as (B, H, KVH, Sq, Skv, Dh, causal): the prefill of
# qwen2.5-3b at B=4, S=2048; the same for minicpm-2b's heads (Dh 64,
# group 1); ragged and odd shapes
FLASH_MAIN = (4, 16, 2, 2048, 2048, 128, True)
FLASH_MINICPM = (4, 36, 36, 2048, 2048, 64, True)
FLASH_RAGGED = [(3, 2, 1, 50, 50, 16, True), (1, 4, 4, 33, 70, 64, False),
                (1, 4, 4, 32, 64, 128, True)]
# the wgmma route's edges: Sq != Skv, neither a multiple of its 128-row
# tiles, groups 8 and 6 (qwen2-vl-2b's) at both of its head dims, causal
# and not
FLASH_EDGE = [(1, 8, 1, 200, 333, 128, True), (1, 8, 1, 333, 200, 64, True),
              (2, 8, 1, 130, 130, 128, False), (1, 16, 2, 257, 129, 64, False),
              (1, 12, 2, 200, 333, 128, True), (2, 6, 1, 130, 130, 64, False)]
# ... and at the head dims it holds in a wider tile, whose columns past Dh
# arrive as zeros: zamba2's 80 (capacity 128) at Sq != Skv, group 1 and 8,
# causal and not; 72 and 88 (multiples of 8, not of 16: the last Q K^T
# k-step half zeros); 16 (the reduced configs'), 40 and 8 (capacity 64)
FLASH_PADDED = [(1, 8, 1, 200, 333, 80, True), (2, 4, 4, 333, 200, 80, False),
                (1, 32, 32, 130, 257, 80, True),
                (1, 12, 2, 257, 129, 72, False), (2, 4, 4, 200, 200, 88, True),
                (1, 8, 2, 200, 333, 16, True), (1, 4, 4, 130, 130, 40, False),
                (1, 2, 1, 33, 70, 8, True)]
# gather_scale: H' of the train path (B=4, n=1024, k=307) at both input
# widths; the reference sweep's 2-D (n, d, k) shapes; a batched
# (B, n, d, k) shape with repeated rows
GATHER_MAIN_D = (2048, 11008)
GATHER_RAGGED_2D = [(64, 96, 16), (50, 130, 20)]
GATHER_RAGGED_BATCHED = (3, 7, 5, 4)


def gather_edges(dtype):
    """The bulk route's edges as (B, n, d, k), d by element size, against
    its 4 KB items: rows of 2064 bytes, one an item (bf16 d = 1032); rows
    of 16400 bytes in five equal pieces (f32 d = 4100); rows of 1040 bytes
    three to an item with a shorter last item (B*k = 62); rows of 12304
    bytes in pieces of 3088 with a shorter last one; B*k below the SM
    count; k = 1 at a width cut into pieces."""
    item = torch.empty((), dtype=dtype).element_size()
    return [(2, 300, 2064 // item, 33), (2, 300, 16400 // item, 33),
            (2, 300, 1040 // item, 31), (2, 300, 12304 // item, 33),
            (1, 64, 2048, 5), (1, 50, 6144, 1)]

# sampled_matmul: the reference sweeps as 2-D (k, d_in, d_out, n) and
# batched (B, k, n, d_in, d_out)
SMM_SWEEP_2D = [(16, 32, 24, 64), (20, 130, 70, 50), (8, 16, 16, 16),
                (64, 128, 96, 200)]
SMM_SWEEP_BATCHED = [(2, 20, 50, 130, 70), (8, 12, 30, 33, 17)]
# the wgmma route's edges: 256 x 128 tiles in clusters of two with d_in not
# a multiple of 64, an odd count (7) of d_out tiles, the k tail 307 and
# k < 64, d_out a multiple of 8 but not of 64; 64 x 64 tiles at narrow
# edges (plan slot 1 repeats slot 0: duplicate indices)
SMM_EDGE = [(4, 307, 1024, 2056, 896), (2, 40, 300, 4096, 1160),
            (4, 307, 1024, 136, 200), (1, 65, 70, 8, 1032)]
# The optim phase: nemotron-4-15b at published width (d_model 6144, d_ff
# 24576, 48/8 heads of 128), depth cut 32 -> 2, B=1, S=2048, WTA-CRS 0.3
# (k = 614): its sampled linears' shapes; the wide_serve phase's prefill
# of command-r-35b (64/8 heads of 128) at B=2, S=2048, and the same at
# nemotron-4-15b's heads
OPT_STEPS, OPT_B, OPT_S = 4, 1, 2048
# (32 -> 2 -> 1: the mixed leg's first step SVDs every transformer matrix)
OPT_DEPTH = 1
OPT_K = WTACRSConfig(kind="wta_crs", budget=0.3,
                     min_rows=4).budget_rows(OPT_S)
ROW_NORM_OPTIM = [(OPT_B * OPT_S, 6144), (OPT_B * OPT_S, 24576)]
GATHER_OPTIM_D = (6144, 24576)
FUSED_OPTIM = [(6144, 24576), (24576, 6144), (6144, 6144), (6144, 1024)]
FLASH_COMMAND_R = (2, 64, 8, 2048, 2048, 128, True)
FLASH_NEMOTRON = (2, 48, 8, 2048, 2048, 128, True)
# flash_attention_bwd as (B, H, KVH, S, Dh): the table's train shape and
# nemotron-4-15b's train cell (B=16 S=2048), causal; then ragged and odd
# shapes as (B, H, KVH, Sq, Skv, Dh, causal)
FLASH_BWD_TIMED = [(4, 16, 2, 2048, 128), (16, 48, 8, 2048, 128)]
FLASH_BWD_RAGGED = [(2, 4, 4, 32, 32, 16, True), (1, 6, 1, 200, 333, 80, True),
                    (1, 6, 1, 333, 200, 128, True),
                    (2, 4, 4, 130, 77, 64, False),
                    (1, 12, 2, 257, 129, 72, False),
                    (1, 3, 3, 65, 1500, 64, False)]
# The MoE phases: granite-moe-1b-a400m at B=4, S=1024 and dbrx-132b at B=1,
# S=2048, WTA-CRS 0.3 on every linear.  Each expert samples its capacity
# slots (granite 1280, k = 384; dbrx 640, k = 192), the router the B*S
# rows (k = 1229 / 614); the prefills' flash heads
MOE_ARCH, MOE_STEPS, MOE_B, MOE_S = "granite-moe-1b-a400m", 6, 4, 1024
# the moe phase's depth (24 -> 6 to keep the script within half its time
# limit; every layer is a MoE block, so the cut keeps every kind of plan)
MOE_DEPTH = 6
WIDE_ARCH, WIDE_STEPS, WIDE_B, WIDE_S = "dbrx-132b", 3, 1, 2048
MOE_WTA = WTACRSConfig(kind="wta_crs", budget=0.3, min_rows=4)


def moe_shapes(arch, b, s):
    cfg = get_config(arch)
    cap = mlp_mod.moe_capacity(cfg, b * s)
    return {"e": cfg.n_experts, "d": cfg.d_model, "f": cfg.d_ff, "cap": cap,
            "k": MOE_WTA.budget_rows(cap), "rows": b * s,
            "k_router": MOE_WTA.budget_rows(b * s)}


GRANITE = moe_shapes(MOE_ARCH, MOE_B, MOE_S)
DBRX = moe_shapes(WIDE_ARCH, WIDE_B, WIDE_S)
FLASH_GRANITE = (4, 16, 8, 2048, 2048, 64, True)
FLASH_DBRX = (2, 48, 8, 2048, 2048, 128, True)
# the expert axis's edges as (E, B, k, n, d_in, d_out): E = 3, odd k and
# k < 64, d_in / d_out multiples of 8 but not of 64, the k tail 307
EXPERT_RAGGED = [(3, 2, 13, 40, 24, 16), (3, 1, 65, 70, 136, 200),
                 (2, 2, 307, 300, 72, 2056), (3, 1, 37, 50, 40, 8)]
# the moe phase's pool: (prompt length, max_new) of 4 greedy requests
# (also the ssm and xlstm phases')
MOE_SERVE = [(9, 12), (33, 8), (17, 16), (3, 10)]
# the ssm and vlm phases serve that pool at 6 layers (zamba2's one pattern
# unit: five Mamba2 blocks and the shared block; qwen2-vl-2b 28 -> 6): its
# three-way comparison is decode-bound on the host, ≈ 0.5 s a layer
SERVE_POOL_DEPTH = 6
# The recurrent phases, WTA-CRS 0.3 on every linear: zamba2-2.7b at
# published width, depth cut 54 -> 12 (two pattern units) at B=2, S=2048
# (k = 614), then at full depth under remat "full" at B=1; xlstm-125m at
# full size at B=4, S=1024 (k = 307).  Their sampled linears' (d_in,
# d_out), the row widths their plans and H' read, zamba2's prefill heads
# (32/32 of 80: the flash kernel's wgmma route at its 128-column capacity)
SSM_ARCH, SSM_DEPTH, SSM_STEPS, SSM_B, SSM_S = "zamba2-2.7b", 12, 4, 2, 2048
SSM_K = MOE_WTA.budget_rows(SSM_S)
SSM_ROW_D = (2560, 5120, 10240)
SSM_DW = [(2560, 10448), (5120, 2560), (2560, 2560), (2560, 10240),
          (10240, 2560)]
FLASH_ZAMBA2 = (2, 32, 32, 2048, 2048, 80, True)
XLSTM_ARCH, XLSTM_STEPS, XLSTM_B, XLSTM_S = "xlstm-125m", 3, 4, 1024
# the phase's depth: its steps, prefill and decode are a host loop over
# time steps, ≈ 20 s a layer in all (12 -> 6 -> 4 -> 2, one mLSTM and one
# sLSTM block, to keep the script within half its time limit)
XLSTM_DEPTH = 2
XLSTM_K = MOE_WTA.budget_rows(XLSTM_S)
XLSTM_ROW_D = (768, 1536)
XLSTM_DW = [(768, 3072), (1536, 1536), (1536, 8), (1536, 768), (768, 768)]
# The VLM and encoder-decoder phases, WTA-CRS 0.3 on every linear:
# qwen2-vl-2b at full size, B=4, S=1024 (256 patch and 768 text tokens;
# the blocks' plans over all 1024 rows, k = 307, vis_proj's over the 256
# patch rows, k = 77), its prefill heads (12/2 of 128: group 6 on the
# wgmma route), Run.generate's (prompt, new tokens); whisper-base at full
# size, B=8, S=2048 split into 1024 frames and 1024 tokens (k = 307 over
# each)
VLM_ARCH, VLM_STEPS, VLM_B, VLM_S = "qwen2-vl-2b", 4, 4, 1024
VLM_K = MOE_WTA.budget_rows(VLM_S)
VLM_VIS = registry.train_batch_specs(get_config(VLM_ARCH), VLM_B,
                                     VLM_S)["patches"][0][1]
VLM_VIS_K = MOE_WTA.budget_rows(VLM_VIS)
VLM_ROW_D = (1536, 8960)
VLM_DW = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)]
FLASH_VLM = (4, 12, 2, 2048, 2048, 128, True)
VLM_GEN = (32, 16)
WHISPER_ARCH, WHISPER_STEPS, WHISPER_B, WHISPER_S = "whisper-base", 4, 8, 2048
WHISPER_K = MOE_WTA.budget_rows(WHISPER_S // 2)
WHISPER_ROW_D = (512, 2048)
WHISPER_DW = [(512, 512), (512, 2048), (2048, 512)]
# The tp phase's recurrent and enc-dec legs at model = 2, one rank's shard
# of every sampled linear (column-parallel: half the outputs, Mamba2's
# in_proj half of each of its segments; row-parallel: half the inputs):
# zamba2-2.7b depth 54 -> 6 (one pattern unit) at B=2, S=1024; xlstm-125m
# depth 12 -> 2 (one mLSTM, one sLSTM) at B=2, S=512 (two 256-step
# chunks); whisper-base at full size, B=4 of 1024 frames + 1024 tokens
TP_ZAMBA_DEPTH, TP_XLSTM_DEPTH, TP_XLSTM_S, TP_WHISPER_B = 6, 2, 512, 4
TP_BLOCKS_GEN = 8
TP_BLOCK_SHAPES = (
    ("tp_zamba2", 2, 1024, (2560, 1280, 5120),
     [(2560, 5224), (2560, 2560), (2560, 1280), (1280, 2560), (2560, 5120),
      (5120, 2560)]),
    ("tp_xlstm", 2, TP_XLSTM_S, (768, 384),
     [(768, 1536), (768, 768), (768, 8), (384, 768)]),
    ("tp_whisper", TP_WHISPER_B, 1024, (512, 256, 1024),
     [(512, 256), (256, 512), (512, 1024), (1024, 512)]),
    # qwen2.5-3b's shards at model = 2 under the optimizer legs and
    # Run (q / k / v on one plan, wo row-parallel on 1024 features, the
    # MLP's 5504 a rank), and the LoRA leg's h·A down-projections (r = 16)
    ("tp_optim", 2, 1024, (2048, 1024, 5504),
     [(2048, 1024), (2048, 128), (1024, 2048), (2048, 5504), (5504, 2048)]),
    ("tp_run", 2, 1024, (2048, 1024, 5504),
     [(2048, 1024), (2048, 128), (1024, 2048), (2048, 5504), (5504, 2048)]),
    ("tp_lora", 2, 1024, (2048, 5504), [(2048, 16), (5504, 16)]))
FLASH_TP_ZAMBA2 = (2, 16, 16, 1024, 1024, 80, True)


def card_sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


# the script's start on the host clock: each phase line carries the
# seconds since then (``elapsed_s``), so a run shows where its time limit
# goes
STARTED = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - STARTED)
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# bytes written before an L2-cold call: above the H100's 50 MB L2
L2_FLUSH_BYTES = 128 * 2**20


def kernel_identifier(mangled):
    """The ``..._kernel`` identifier of a mangled kernel name: the one whose
    length is the number written just before it (a digit of the anonymous
    namespace's hash may run into that number)."""
    for m in re.finditer(r"_kernel(?=[IE])", mangled):
        for length in range(len("_kernel") + 1, m.end() + 1):
            start = m.end() - length
            if (re.match(r"[A-Za-z_]", mangled[start])
                    and mangled[:start].endswith(str(length))):
                return mangled[start:m.end()]
    return None


def ptxas_report(log, source):
    """{kernel instance: registers, spill bytes and static shared bytes}
    of the kernels nvcc built from ``source`` (a file of csrc/), read off
    the build log (ptxas prints no "bytes smem" for a kernel with none)."""
    tag = source.replace(".", "_")
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1) if tag in m.group(1) else None
            kernel = kernel_identifier(name) if name else None
            if kernel is None:
                name = None
            if name:
                dtype = ("bf16" if "bfloat16" in name else
                         "f16" if "__half" in name else "f32")
                args = ", ".join([dtype] + re.findall(r"L[ib](\d+)E", name))
                name = f"{kernel}<{args}>"
                out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            out[name]["smem"] = int(m.group(1)) if m else 0
    return out


def smem_cross_check(log):
    """The analyzer against the compiler: for every kernel instance ptxas
    reports, ``csrc.static_smem_bytes`` must equal ptxas's static shared
    bytes; at every launch site whose dynamic bytes resolve, static +
    dynamic must fit the card's opt-in limit a block, which must be
    PK004's default budget.  Fails on any mismatch."""
    sources = csrc.Program.load([str(_build.CSRC)])
    if sources.broken:
        fail(f"build: the source model cannot read {sources.broken}")
    checked, equal, unresolved, mismatched = 0, 0, [], []
    for path in sorted(_build.CSRC.glob("*.cu")):
        for inst, info in ptxas_report(log, path.name).items():
            kernel, args = inst[:-1].split("<", 1)
            dtype, *ints = [a.strip() for a in args.split(",")]
            ours = csrc.static_smem_bytes(sources, kernel, dtype,
                                          [int(i) for i in ints])
            checked += 1
            if ours is None:
                unresolved.append(inst)
            elif ours == info["smem"]:
                equal += 1
            else:
                mismatched.append((inst, ours, info["smem"]))
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    launches = kernel_contracts.resolve_launches(sources)
    resolved = [li for li in launches
                if li.static is not None and li.dynamic is not None]
    over = [(li.desc, li.static + li.dynamic) for li in resolved
            if li.static + li.dynamic > optin]
    rec = {"instances": checked, "equal": equal,
           "unresolved": len(unresolved), "launch_instances": len(launches),
           "launches_resolved": len(resolved),
           "largest_launch_bytes": max(
               (li.static + li.dynamic for li in resolved), default=0),
           "smem_per_block_optin": optin,
           "pk004_default_budget": kernel_contracts.DEFAULT_SMEM_BUDGET}
    if mismatched:
        fail(f"build: the analyzer's static shared bytes differ from "
             f"ptxas's (instance, analyzer, ptxas): {mismatched}")
    if checked == 0:
        fail("build: ptxas reported no kernel instance to check")
    if over:
        fail(f"build: launches over the card's {optin} bytes a block: "
             f"{over}")
    if optin != kernel_contracts.DEFAULT_SMEM_BUDGET:
        fail(f"build: the card's shared_memory_per_block_optin {optin} is "
             f"not PK004's default budget "
             f"{kernel_contracts.DEFAULT_SMEM_BUDGET}")
    return dict(rec, unresolved_instances=unresolved)


# ---------------------------------------------------------------------------
# analysis phase
# ---------------------------------------------------------------------------

ANALYSIS_PROC = []


def start_analysis():
    """``analysis_child`` in the background from the start (host CPU only,
    no card, so it needs no kernel): its seconds hide behind the card's
    phases, and ``phase_analysis`` reads its record at the end."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    log = tempfile.TemporaryFile("w+", dir=os.path.join(here, "build"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    ANALYSIS_PROC.append((log, subprocess.Popen(
        [sys.executable, "-c", CHILD, here, "analysis_child"],
        stdout=log, stderr=subprocess.STDOUT, env=env)))


def stop_analysis():
    for log, proc in ANALYSIS_PROC:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def analysis_child():
    """``python -m repro_torch.analysis --format json`` over the port's
    code (the package, this script, the tools, the port's examples), in a
    subprocess from the repo's root as its users run it (the live reduced
    universes, the port's baseline, paths relative to the root as the
    baseline's fingerprints are); then both universes reduced and at
    published size on ``meta`` for every arch.  Prints one JSON object:
    the CLI's exit code and output, each part's seconds, the archs whose
    published-size universe differs from the reduced one."""
    here = os.path.dirname(os.path.abspath(__file__))
    examples = sorted(glob.glob(os.path.join(here, "examples", "torch_*.py")))
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--format", "json",
         "src/repro_torch", "chip_smoke.py", "tools",
         *(os.path.relpath(p, here) for p in examples)],
        capture_output=True, text=True, cwd=here, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(here, "src")))
    seconds, universes = {"cli": time.perf_counter() - t0}, {}
    # every family's raw findings (before the baseline), by family, and
    # what the source model read of kernels/csrc
    t0 = time.perf_counter()
    paths = ["src/repro_torch", "chip_smoke.py", "tools",
             *(os.path.relpath(p, here) for p in examples)]
    cwd = os.getcwd()
    os.chdir(here)
    try:
        raw = analyze_paths(paths)
        sources = csrc.Program.load(["src/repro_torch"])
    finally:
        os.chdir(cwd)
    by_family = {}
    for f in raw:
        by_family[f.rule[:2]] = by_family.get(f.rule[:2], 0) + 1
    seconds["families_in_process"] = time.perf_counter() - t0
    for reduced in (True, False):
        size = "reduced" if reduced else "full"
        for kind, build in (("tags", policy_check.tag_universe),
                            ("paths", policy_check.param_path_universe)):
            t0 = time.perf_counter()
            universes[kind, size] = build(reduced=reduced)
            seconds[f"{kind}_{size}"] = time.perf_counter() - t0
    differ = {}
    for kind in ("tags", "paths"):
        small, full = universes[kind, "reduced"], universes[kind, "full"]
        differ[kind] = sorted(a for a in set(small) | set(full)
                              if small.get(a) != full.get(a))
    print(json.dumps({
        "raw_by_family": by_family,
        "sources": sorted(os.path.basename(p) for p in sources.files),
        "sources_broken": sorted(sources.broken),
        "kernels": len(sources.kernels()),
        "cli_rc": done.returncode, "cli_stdout": done.stdout,
        "cli_stderr": done.stderr[-3000:], "seconds": seconds,
        "differ": differ, "archs": len(universes["tags", "full"]),
        "distinct": {f"{kind}_{size}": len(set().union(*u.values()))
                     for (kind, size), u in universes.items()}}))


def phase_analysis():
    """The record of ``analysis_child`` (started in the background by
    ``start_analysis``): the CLI exited 0 with no failing finding, and
    every arch's published-size universes equal the reduced ones the CLI
    checks against."""
    log, proc = ANALYSIS_PROC[0]
    proc.wait(timeout=600)
    log.seek(0)
    out = log.read()
    if proc.returncode != 0:
        fail(f"analysis: the child exited {proc.returncode}: {out[-3000:]}")
    rec = json.loads(out.strip().splitlines()[-1])
    if rec["cli_rc"] != 0:
        fail(f"analysis: the CLI exited {rec['cli_rc']}: "
             f"{rec['cli_stdout'][-3000:]} {rec['cli_stderr']}")
    doc = json.loads(rec["cli_stdout"])
    if doc["failing"] != 0:
        fail(f"analysis: {doc['failing']} failing findings: {doc}")
    if any(rec["differ"].values()):
        fail(f"analysis: published-size universes differ from the reduced "
             f"ones the CLI checks against: {rec['differ']}")
    want = {os.path.basename(p) for p in glob.glob(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src", "repro_torch",
        "kernels", "csrc", "*.cu*"))}
    if rec["sources_broken"] or set(rec["sources"]) != want:
        fail(f"analysis: the source model read {rec['sources']} (broken "
             f"{rec['sources_broken']}), not kernels/csrc's {sorted(want)}")
    by_severity, by_family = {}, {}
    for f in doc["findings"]:
        by_severity[f["severity"]] = by_severity.get(f["severity"], 0) + 1
        by_family[f["rule"][:2]] = by_family.get(f["rule"][:2], 0) + 1
    emit({"phase": "analysis", "seconds": rec["seconds"],
          "findings_by_severity": by_severity,
          "findings_by_family": by_family,
          "raw_findings_by_family": rec["raw_by_family"],
          "sources": rec["sources"], "kernels": rec["kernels"],
          "suppressed": doc["suppressed"], "failing": doc["failing"],
          "archs": rec["archs"], "distinct": rec["distinct"]})


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------

def check_close(name, got, want, rtol, atol):
    """Max |got - want| (any devices); fails beyond atol + rtol * |want|."""
    got = got.to(torch.float64)
    want = want.to(got.device, torch.float64)
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    max_err = float(err.max())
    if bool((err > bound).any()):
        worst = float((err - bound).max())
        fail(f"{name}: disagrees: max_abs_err {max_err:.3e}, exceeds rtol "
             f"{rtol} / atol {atol:.3e} by {worst:.3e}")
    return max_err


def row_norms_case(n, d, dtype, gen, timed):
    x = torch.randn((n, d), generator=gen, device="cuda",
                    dtype=torch.float32).to(dtype)
    got = ops.row_norms(x)
    torch.cuda.synchronize()
    want = row_norms_mod.row_norms_plain(x)
    # Kernel and plain version both square and add in f32 from the same
    # values; only the order of the d additions differs, which moves a sum
    # of d positive terms by a few f32 ulps: rtol/atol 1e-5, whatever the
    # input dtype.
    rtol = atol = 1e-5
    case = {
        "name": "row_norms", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/row_norms.cu",
        "replaces": "src/repro/kernels/row_norms.py:49",
        "shape": [n, d], "dtype": DTYPE_NAMES[dtype],
        "max_abs_err": check_close(f"row_norms{(n, d)} {dtype}", got, want,
                                   rtol, atol),
        "tol": {"rtol": rtol, "atol": atol},
    }
    if timed:
        flops, nbytes = costs.row_norms(n, d, x.element_size())
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[torch.float32]
        case.update({
            "ms": time_ms(lambda: ops.row_norms(x)),
            "plain_ms": time_ms(lambda: row_norms_mod.row_norms_plain(x)),
            "library_ms": time_ms(lambda: torch.linalg.vector_norm(
                x, dim=-1, dtype=torch.float32)),
            "library": "torch.linalg.vector_norm(x, dim=-1, dtype=float32)",
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        })
    return case


def library_dw(hsub, dz, idx, scale):
    """The library composition of the same function: gather, scale, one
    batched contraction in the input dtype (f32 accumulation inside the
    GEMM, output rounded to the input dtype).  Timed as a yardstick only;
    the port never calls it."""
    b, k, _ = hsub.shape
    rows = idx.to(torch.int64)[:, :, None].expand(b, k, dz.shape[2])
    dz_sub = (torch.gather(dz, 1, rows).to(torch.float32)
              * scale[:, :, None]).to(dz.dtype)
    return torch.einsum("bki,bkj->ij", hsub, dz_sub)


def unique_rows(idx):
    """Distinct rows a (B, k) plan names, summed over the batch: the rows a
    gather must read at least once."""
    return sum(int(torch.unique(idx[i]).numel()) for i in range(idx.shape[0]))


def cold_ms(fn, reps: int = 20) -> float:
    """Median over ``reps`` single calls of ``fn``, each timed with CUDA
    events right after a write of ``L2_FLUSH_BYTES`` that evicts the 50 MB
    L2, so its inputs come from HBM (the warm ``time_ms`` can beat the HBM
    bound where the inputs fit in L2)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOST_LEAD_CYCLES // 10)
        flush.zero_()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def gather_scale_case(b, n, d, k, dtype, gen, timed, two_d=False,
                      same_row=False, misaligned=False):
    """``gather_scale`` against its plain version, bit for bit, three calls
    in a row; the plan repeats rows (slot 1 names slot 0's row, or with
    ``same_row`` every slot names one row), as sampling with replacement
    does; ``misaligned`` hands it a view 2 bytes (f32: 4) off a 16-byte
    boundary.  Timed: the two routes pinned through the C entry point in
    turns (warp, bulk, bulk, warp), each also L2-cold beside
    ``torch.gather``, the bound and the plain version."""
    x = torch.randn((b, n, d), generator=gen, device="cuda",
                    dtype=torch.float32).to(dtype)
    if misaligned:
        x = shifted(x)
    idx = torch.randint(0, n, (b, k), generator=gen, device="cuda"
                        ).to(torch.int32)
    if same_row:
        idx[:] = idx[:, :1]
    elif k > 1:
        idx[:, 1] = idx[:, 0]
    scale = torch.rand((b, k), generator=gen, device="cuda") * 2.0 + 0.25
    args = (x[0], idx[0], scale[0]) if two_d else (x, idx, scale)
    want = gather_scale_mod.gather_scale_plain(x, idx, scale)
    what = (f"gather_scale B={b} n={n} d={d} k={k} 2d={two_d} {dtype} "
            f"same_row={same_row} misaligned={misaligned}")
    # kernel and plain version make the same single f32 multiply and the
    # same single rounding of every element: equal to the bit (atol 0); a
    # missing proxy fence or ring wait would show only sometimes, so three
    # calls
    max_err, routes = 0.0, set()
    for _ in range(3):
        out = []
        routes.update(routes_taken("gather_scale", lambda: out.append(
            ops.gather_scale(*args))))
        torch.cuda.synchronize()
        max_err = max(max_err, check_close(
            what, out[0], want[0] if two_d else want, 0.0, 0.0))
    case = {
        "name": "gather_scale", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gather_scale.cu",
        "replaces": "src/repro/kernels/gather_scale.py:43",
        "shape": {"B": None if two_d else b, "n": n, "d": d, "k": k},
        "dtype": DTYPE_NAMES[dtype], "max_abs_err": max_err,
        "tol": {"rtol": 0.0, "atol": 0.0},
        "kernel_route": "+".join(sorted(routes)), "misaligned": misaligned,
        "duplicate_indices": "all" if same_row else k > 1,
    }
    if timed:
        flops, nbytes = costs.gather_scale(b, k, d, x.element_size(),
                                           distinct=unique_rows(idx))
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[torch.float32]

        def pinned(route):
            return lambda: gather_scale_mod.launch(x, idx, scale, route)

        def library():
            return torch.gather(x, 1, idx.to(torch.int64)[:, :, None].expand(
                b, k, d))
        warp_a = time_ms(pinned("warp"))
        bulk_a = time_ms(pinned("bulk"))
        bulk_b = time_ms(pinned("bulk"))
        warp_b = time_ms(pinned("warp"))
        case.update({
            "ms": (bulk_a + bulk_b) / 2, "warp_ms": (warp_a + warp_b) / 2,
            "turns_ms": {"warp": [warp_a, warp_b], "bulk": [bulk_a, bulk_b]},
            "plain_ms": time_ms(lambda: gather_scale_mod.gather_scale_plain(
                x, idx, scale)),
            "library_ms": time_ms(library),
            "library": "torch.gather(x, 1, idx.long()[:, :, None]"
                       ".expand(B, k, d)) (the plain H' gather)",
            "cold_ms": cold_ms(pinned("bulk")),
            "warp_cold_ms": cold_ms(pinned("warp")),
            "library_cold_ms": cold_ms(library),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        })
    return case


def dw_inputs(b, k, n, d_in, d_out, dtype, gen, dup=False):
    """Random operands of the sampled weight gradient; ``dup``: plan slot 1
    names slot 0's row, as sampling with replacement does."""
    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    hsub, dz = rnd((b, k, d_in)), rnd((b, n, d_out))
    idx = torch.randint(0, n, (b, k), generator=gen, device="cuda"
                        ).to(torch.int32)
    if dup and k > 1:
        idx[:, 1] = idx[:, 0]
    scale = torch.rand((b, k), generator=gen, device="cuda") * 2.0 + 0.25
    return hsub, dz, idx, scale


def dw_bound(hsub, dz, idx):
    """(bound seconds, bound_by) of the sampled weight gradient: the plan's
    distinct dz rows, H' and idx/scale read once, dW written once, against
    2*B*k*d_in*d_out flops on the unpadded k; with a leading expert axis,
    of all E experts' (E*B samples, E dWs)."""
    e = hsub.shape[0] if hsub.ndim == 4 else 1
    b, k, d_in = hsub.shape[-3:]
    flops, nbytes = costs.sampled_dw(
        e, b, k, d_in, dz.shape[-1], hsub.element_size(),
        distinct=unique_rows(idx.reshape(-1, k)))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[hsub.dtype]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# The two kernels of the sampled weight gradient: wrapper, plain version,
# source, the TPU kernel it replaces.
DW_KERNELS = {
    "fused_sampled_dw": (ops.fused_sampled_dw,
                         fused_sampling.fused_sampled_dw_plain,
                         "src/repro_torch/kernels/csrc/fused_sampled_dw.cu",
                         "src/repro/kernels/fused_sampling.py:127"),
    "sampled_matmul": (ops.sampled_matmul,
                       sampled_matmul_mod.sampled_matmul_plain,
                       "src/repro_torch/kernels/csrc/sampled_matmul.cu",
                       "src/repro/kernels/sampled_matmul.py:111"),
}


def routes_taken(name, run):
    """Call ``run()``; return the routes (``launches_by_route``) of kernel
    ``name`` whose counts it raised."""
    counts = getattr(ops, name).launches_by_route
    before = dict(counts)
    run()
    return sorted(r for r, c in counts.items() if c != before[r])


def dw_case(name, b, k, n, d_in, d_out, dtype, gen, timed, two_d=False,
            dup=False):
    """A sampled weight-gradient kernel of ``DW_KERNELS`` against its plain
    version (``fused_sampled_dw`` at both pinned tiles too, for bf16/f16;
    ``sampled_matmul`` takes what ``smm_route`` picks); ``two_d`` calls its
    2-D form.  Timed: beside its bound, plain version, the library
    composition, each pinned tile (``fused_sampled_dw``), and
    (``sampled_matmul``) the fused kernel at the same shape and the kernel
    alone on operands planned once."""
    kernel, plain, source, replaces = DW_KERNELS[name]
    hsub, dz, idx, scale = dw_inputs(b, k, n, d_in, d_out, dtype, gen, dup)
    want = plain(hsub, dz, idx, scale)
    # Kernel and plain version round dz*scale to the input dtype by the
    # same f32 multiply, so the factors of every product are bit-identical
    # and each product is exact in f32 (bf16/f16) or rounded alike (f32);
    # only the order of the B*k f32 additions differs.  For unit-variance
    # inputs that is a random walk of f32 roundings: rtol 1e-4 and
    # atol 1e-4 * sqrt(B*k) — far inside the 3e-2 a bf16 ROUNDING
    # difference would show, so a dropped slot or a misplaced rounding
    # fails.
    rtol, atol = 1e-4, 1e-4 * math.sqrt(b * k)
    args = (hsub[0], dz[0], idx[0], scale[0]) if two_d \
        else (hsub, dz, idx, scale)
    pinned = name == "fused_sampled_dw" and dtype != torch.float32
    max_err, routes = 0.0, set()
    for tile in (None, 64, 128) if pinned else (None,):
        out = []
        pin = {"tile": tile} if name == "fused_sampled_dw" else {}
        routes.update(routes_taken(name, lambda: out.append(
            kernel(*args, **pin))))
        torch.cuda.synchronize()
        max_err = max(max_err, check_close(
            f"{name} B={b} k={k} n={n} ({d_in},{d_out}) 2d={two_d} {dtype} "
            f"tile={tile}", out[0], want, rtol, atol))
    case = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "shape": {"B": None if two_d else b, "k": k, "n": n, "d_in": d_in,
                  "d_out": d_out},
        "dtype": DTYPE_NAMES[dtype], "max_abs_err": max_err,
        "tol": {"rtol": rtol, "atol": atol},
    }
    case["kernel_route"] = "+".join(sorted(routes))
    case["duplicate_indices"] = dup
    if name == "sampled_matmul":
        # the tile the wrapper took: the packaged table's, else the rule's
        tile = autotune.tile_for(None, name, args[0], args[1])
        r = sampled_matmul_mod.smm_route(
            d_in, d_out, dtype, _build.aligned16(args[0], args[1]),
            card_sms(), tile)
        tabled = autotune.load_table().lookup(name, autotune.shape_key(
            d_in, d_out, 1 if two_d else b, k, dtype), r.route)
        case["tile"] = {"d_in": r.tile_m, "d_out": r.tile_n,
                        "cluster": r.cluster,
                        "from": "rule" if tabled is None else "table"}
    if timed:
        bound_s, bound_by = dw_bound(hsub, dz, idx)
        case.update({
            "ms": time_ms(lambda: kernel(hsub, dz, idx, scale)),
            "plain_ms": time_ms(lambda: plain(hsub, dz, idx, scale)),
            "library_ms": time_ms(lambda: library_dw(hsub, dz, idx, scale)),
            "library": "torch.gather + scale + torch.einsum('bki,bkj->ij') "
                       "in the input dtype",
            "bound_ms": 1e3 * bound_s, "bound_by": bound_by,
        })
        if pinned:
            for tile in (64, 128):
                case[f"ms_tile{tile}"] = time_ms(
                    lambda: kernel(hsub, dz, idx, scale, tile=tile))
        if name == "sampled_matmul":
            case["fused_sampled_dw_ms"] = time_ms(
                lambda: ops.fused_sampled_dw(hsub, dz, idx, scale))
            # the kernel alone on operands planned once (the wrapper's share
            # is its host planning and, on the wmma / fma routes, the pad)
            planned = sampled_matmul_mod.plan_operands(hsub, dz, idx, scale,
                                                       r)
            case["kernel_alone_ms"] = time_ms(
                lambda: sampled_matmul_mod.launch(*planned, r))
    return case


def shifted(x):
    """``x``'s values in a view that starts 2 bytes past a 16-byte
    boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.flatten()
    return flat[1:].view(x.shape)


def dw_misaligned_case(name, dtype, gen):
    """A kernel of ``DW_KERNELS`` on operands that start 2 bytes off a
    16-byte boundary at a shape the wgmma route takes: the wmma route, held
    to the plain version at the dW tolerance."""
    b, k, n, d_in, d_out = 2, 70, 90, 128, 192
    hsub, dz, idx, scale = dw_inputs(b, k, n, d_in, d_out, dtype, gen)
    hsub, dz = shifted(hsub), shifted(dz)
    out = []
    routes = routes_taken(name, lambda: out.append(
        getattr(ops, name)(hsub, dz, idx, scale)))
    torch.cuda.synchronize()
    rtol, atol = 1e-4, 1e-4 * math.sqrt(b * k)
    want = fused_sampling.fused_sampled_dw_plain(hsub, dz, idx, scale)
    return {"name": name, "route": "cuda",
            "kernel_route": "+".join(routes), "misaligned": True,
            "shape": {"B": b, "k": k, "n": n, "d_in": d_in, "d_out": d_out},
            "dtype": DTYPE_NAMES[dtype],
            "max_abs_err": check_close(
                f"{name} misaligned {dtype}", out[0], want, rtol, atol),
            "tol": {"rtol": rtol, "atol": atol}}


def library_dw_experts(hsub, dz, idx, scale):
    """The library composition of the expert axis: gather, scale in f32,
    round to the input dtype, one torch.bmm over the experts.  Timed as a
    yardstick only; the port never calls it."""
    e, b, k, d_in = hsub.shape
    rows = idx.to(torch.int64)[..., None].expand(e, b, k, dz.shape[-1])
    dz_sub = (torch.gather(dz, 2, rows).to(torch.float32)
              * scale[..., None]).to(dz.dtype)
    return torch.bmm(hsub.reshape(e, b * k, d_in).transpose(1, 2),
                     dz_sub.reshape(e, b * k, -1))


def expert_dw_case(e, b, k, n, d_in, d_out, dtype, gen, timed, dup=False,
                   misaligned=False):
    """``fused_sampled_dw`` over its expert axis — E experts' (B, k) plans
    and dWs in one launch — against its plain version (rtol 1e-4, atol
    1e-4 * sqrt(B*k), as every dW case: the same factors, f32 sums in
    another order); the first expert alone through the axis bit-equal to
    the call without it.  Timed: beside its bound, the plain version, the
    library composition and E launches of the call without the axis."""
    parts = [dw_inputs(b, k, n, d_in, d_out, dtype, gen, dup)
             for _ in range(e)]
    hsub, dz, idx, scale = (torch.stack(x) for x in zip(*parts))
    del parts
    if misaligned:
        hsub, dz = shifted(hsub), shifted(dz)
    want = fused_sampling.fused_sampled_dw_plain(hsub, dz, idx, scale)
    rtol, atol = 1e-4, 1e-4 * math.sqrt(b * k)
    out = []
    routes = routes_taken("fused_sampled_dw", lambda: out.append(
        ops.fused_sampled_dw(hsub, dz, idx, scale)))
    torch.cuda.synchronize()
    what = (f"fused_sampled_dw E={e} B={b} k={k} n={n} ({d_in},{d_out}) "
            f"{dtype} misaligned={misaligned}")
    err = check_close(what, out[0], want, rtol, atol)
    del out, want
    one = ops.fused_sampled_dw(hsub[:1], dz[:1], idx[:1], scale[:1])
    alone = ops.fused_sampled_dw(hsub[0], dz[0], idx[0], scale[0])
    if not torch.equal(one[0], alone):
        fail(f"{what}: E = 1 is not the call without the axis bit for bit")
    case = {
        "name": "fused_sampled_dw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_sampled_dw.cu",
        "replaces": "src/repro/kernels/fused_sampling.py:127",
        "shape": {"E": e, "B": b, "k": k, "n": n, "d_in": d_in,
                  "d_out": d_out},
        "dtype": DTYPE_NAMES[dtype], "max_abs_err": err,
        "tol": {"rtol": rtol, "atol": atol}, "kernel_route": "+".join(routes),
        "misaligned": misaligned, "duplicate_indices": dup,
        "e1_bit_equal": True,
    }
    if timed:
        bound_s, bound_by = dw_bound(hsub, dz, idx)
        case.update({
            "ms": time_ms(lambda: ops.fused_sampled_dw(hsub, dz, idx,
                                                       scale)),
            "plain_ms": time_ms(lambda: fused_sampling.fused_sampled_dw_plain(
                hsub, dz, idx, scale), warmup=1, reps=3, inner=2),
            "library_ms": time_ms(lambda: library_dw_experts(hsub, dz, idx,
                                                             scale)),
            "library": "torch.gather + f32 scale + round + torch.bmm over "
                       "the experts",
            "e_launches_ms": time_ms(lambda: [ops.fused_sampled_dw(
                hsub[i], dz[i], idx[i], scale[i]) for i in range(e)]),
            "bound_ms": 1e3 * bound_s, "bound_by": bound_by,
        })
    return case


def composition_case(gen):
    """The reference's unfused composition at the train path's widest
    shape (B=4, n=1024, k=307, 2048 x 11008, bf16): row_norms -> WTA-CRS
    plan -> gather_scale(H', ones) -> sampled_matmul, against
    fused_sampled_dw on the same plan; and the benchmark's unfused form
    (per-sample gather_scale of dZ with the scale, then sampled_matmul on
    the identity plan).  The launches of this one untimed run are the
    sampled_matmul count of the summary.  Returns (case, launches, the
    sampled_matmul launches by route)."""
    dtype, d_in, d_out = torch.bfloat16, 2048, 11008
    h = torch.randn((B, S, d_in), generator=gen, device="cuda").to(dtype)
    dz = torch.randn((B, S, d_out), generator=gen, device="cuda").to(dtype)
    cfg = WTACRSConfig(kind="wta_crs", budget=K / S, min_rows=4)
    plan_gen = torch.Generator(device="cuda")
    plan_gen.manual_seed(1)
    ones = torch.ones((B, K), dtype=torch.float32, device="cuda")
    eye = torch.arange(K, dtype=torch.int32, device="cuda")[None].repeat(B, 1)

    def unfused_bench(hsub, idx, scale):
        dzg = torch.stack([ops.gather_scale(dz[i], idx[i], scale[i])
                           for i in range(B)])
        return ops.sampled_matmul(hsub, dzg, eye, ones)

    reset_launches()
    norms = ops.row_norms(h.reshape(-1, d_in)).reshape(B, S)
    plan = plans.build_batched_plans(plans.normalize_weights(norms), K,
                                     plan_gen, cfg)
    idx, scale = plan.idx, plan.scale
    hsub = ops.gather_scale(h, idx, ones)
    unfused = ops.sampled_matmul(hsub, dz, idx, scale)
    fused = ops.fused_sampled_dw(hsub, dz, idx, scale)
    bench = unfused_bench(hsub, idx, scale)
    torch.cuda.synchronize()
    launches = expect_launches("composition", {
        "row_norms": 1, "gather_scale": 1 + B, "sampled_matmul": 2,
        "fused_sampled_dw": 1})
    by_route = expect_route("composition", "sampled_matmul", "wgmma")
    # H' at unit scale is the plain row gather bit for bit
    rows = torch.gather(h, 1, idx.to(torch.int64)[:, :, None].expand(
        B, K, d_in))
    check_close("composition H' vs torch.gather", hsub, rows, 0.0, 0.0)
    # same factors (dZ*scale rounded once to bf16 on every route), f32 sums
    # in another order
    rtol, atol = 1e-4, 1e-4 * math.sqrt(B * K)
    err = check_close("composition sampled_matmul vs fused_sampled_dw",
                      unfused, fused, rtol, atol)
    err_bench = check_close("unfused bench form vs fused_sampled_dw",
                            bench, fused, rtol, atol)
    fused_ms = time_ms(lambda: ops.fused_sampled_dw(hsub, dz, idx, scale))
    unfused_ms = time_ms(lambda: unfused_bench(hsub, idx, scale))
    return {"name": "composition", "shape": {"B": B, "n": S, "k": K,
                                             "d_in": d_in, "d_out": d_out},
            "dtype": "bfloat16", "max_abs_err_vs_fused": err,
            "max_abs_err_bench_form_vs_fused": err_bench,
            "tol": {"rtol": rtol, "atol": atol},
            "fused_ms": fused_ms, "unfused_bench_form_ms": unfused_ms,
            "fused_vs_unfused": unfused_ms / fused_ms,
            "reference_floor": 1.2, "launches": launches,
            "sampled_matmul_launches_by_route": by_route}, launches, by_route


# The child of ``bad_index_cases``: one kernel handed a plan index outside
# [0, n); prints the first line of the error the synchronisation raises and
# the routes of the kernel's launches.
BAD_INDEX_CHILD = r"""
import sys
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import ops
name, d, dtype = sys.argv[2], int(sys.argv[3]), getattr(torch, sys.argv[4])
x = torch.ones((2, 8, d), dtype=dtype, device="cuda")
hsub = torch.ones((2, 32, d), dtype=dtype, device="cuda")
idx = torch.zeros((2, 32), dtype=torch.int32, device="cuda")
idx[1, 5] = 8
scale = torch.ones((2, 32), device="cuda")
fn = getattr(ops, name.replace("_experts", ""))
try:
    if name == "gather_scale":
        ops.gather_scale(x, idx, scale)
    elif name == "fused_sampled_dw_experts":
        # three experts, the bad index in the last one's plan
        ops.fused_sampled_dw(*(t[None].repeat((3,) + (1,) * t.ndim)
                               for t in (hsub, x)),
                             torch.cat([torch.zeros_like(idx)[None]] * 2
                                       + [idx[None]]),
                             scale[None].repeat(3, 1, 1))
    else:
        fn(hsub, x, idx, scale)
    torch.cuda.synchronize()
except RuntimeError as err:
    routes = sorted(r for r, c in fn.launches_by_route.items() if c)
    print(str(err).strip().splitlines()[0] + " [route " + "+".join(routes)
          + "]")
    sys.exit(0)
print("no error")
sys.exit(1)
"""
# (kernel, width, dtype): gather_scale at 64 takes the bulk route in every
# dtype, at 63 (bf16, a ragged row) the warp route; sampled_matmul at 64
# takes the 64 x 64 wgmma tile, at 2048 the 256 x 128 tiles in clusters of
# two
BAD_INDEX_KERNELS = (("gather_scale", 64, "bfloat16"),
                     ("gather_scale", 64, "float16"),
                     ("gather_scale", 64, "float32"),
                     ("gather_scale", 63, "bfloat16"),
                     ("sampled_matmul", 64, "bfloat16"),
                     ("sampled_matmul", 2048, "bfloat16"),
                     ("fused_sampled_dw", 64, "bfloat16"),
                     ("fused_sampled_dw_experts", 64, "bfloat16"))


def bad_index_cases():
    """Every kernel that gathers by a plan index, handed one outside
    [0, n): the launch must end in a device-side assert, raised at the
    next synchronisation, never in a row of zeros or a read out of range
    (gather_scale on both routes: the bulk route checks an index before it
    issues a copy from it).  One child process a case, all started
    together, since the assert ends its process's CUDA context."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    procs = {(name, d, dtype): subprocess.Popen(
        [sys.executable, "-c", BAD_INDEX_CHILD, src, name, str(d), dtype],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        for name, d, dtype in BAD_INDEX_KERNELS}
    out = {}
    try:
        for key, proc in procs.items():
            text, _ = proc.communicate(timeout=300)
            out[key] = (proc.returncode, text.strip())
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for (name, d, dtype), (code, msg) in out.items():
        what = f"{name} d={d} {dtype}"
        if code != 0 or "device-side assert" not in msg:
            fail(f"bad index: {what} ended with {msg!r} (exit {code}), "
                 f"expected a device-side assert")
        if name == "gather_scale":
            route = gather_scale_mod.gather_route(d, getattr(torch, dtype))
            if not msg.endswith(f"[route {route}]"):
                fail(f"bad index: {what} ended with {msg!r}, expected the "
                     f"{route} route")
    return {f"{name} d={d} {dtype}": msg
            for (name, d, dtype), (_, msg) in out.items()}


def flash_bound(bh, bkvh, sq, skv, dh, causal, dtype):
    """(bound seconds, bound_by): the useful flops (the visible keys of every
    query, two products) against the dtype's peak, each input read once
    and the output written once against the memory rate."""
    flops, nbytes = costs.flash(bh, bkvh, sq, skv, dh, causal,
                                torch.finfo(dtype).bits // 8)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations"


def flash_case(b, h, kvh, sq, skv, dh, causal, dtype, gen, timed,
               in_summary=False, vs_tensor_op=False, misaligned=False):
    """The flash kernel against its plain version; ``vs_tensor_op`` also
    against the port's tensor-op ``models/attention.py::flash_attention``
    (bf16/f16: it rounds p to the input dtype as the kernel does);
    ``misaligned``: q/k/v start 2 bytes off a 16-byte boundary."""
    bh, bkvh, group = b * h, b * kvh, h // kvh

    def rnd(shape):
        x = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        if not misaligned:
            return x
        flat = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
        flat[1:] = x.flatten()
        return flat[1:].view(shape)
    q, k, v = rnd((bh, sq, dh)), rnd((bkvh, skv, dh)), rnd((bkvh, skv, dh))
    out = []
    routes = routes_taken("flash_attention_fwd", lambda: out.append(
        ops.flash_attention_fwd(q, k, v, group=group, causal=causal)))
    got = out[0]
    torch.cuda.synchronize()
    want = flash_mod.flash_attention_fwd_plain(q, k, v, group=group,
                                               causal=causal)
    # Kernel and plain version both compute scores and the softmax
    # statistics in f32 from the same inputs and round the output once, so
    # in f32 they differ by summation order (2e-4, the reference's own
    # tolerance).  In bf16/f16 the kernel also rounds p once to the input
    # dtype before P V, as the model's own attention does, where the plain
    # version keeps it in f32: a relative 2^-9 (bf16) on each term, which
    # averages out over the keys, plus one ulp of the output's rounding
    # (1e-2: a dropped kv block or a wrong mask shows as ~3e-2 and more).
    rtol = atol = 2e-4 if dtype == torch.float32 else 1e-2
    what = (f"flash_attention_fwd BH={bh} BKVH={bkvh} Sq={sq} Skv={skv} "
            f"Dh={dh} causal={causal} {dtype} misaligned={misaligned}")
    case = {
        "name": "flash_attention_fwd", "route": "cuda",
        "kernel_route": "+".join(routes),
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:98",
        "shape": {"BH": bh, "BKVH": bkvh, "Sq": sq, "Skv": skv, "Dh": dh,
                  "causal": causal},
        "dtype": DTYPE_NAMES[dtype], "misaligned": misaligned,
        "max_abs_err": check_close(what, got, want, rtol, atol),
        "tol": {"rtol": rtol, "atol": atol},
    }
    if vs_tensor_op:
        # (BH, S, Dh) -> (B, S, H, Dh) and back; p rounded alike, the
        # running maxima taken over other blocks (512 against 128 keys):
        # the same 1e-2
        def bshd(x):
            return x.view(b, -1, x.shape[1], dh).transpose(1, 2)
        with torch.no_grad(), eager_attention():
            tensor_op = attention_mod.flash_attention(
                bshd(q), bshd(k), bshd(v), causal=causal)
        case["max_abs_err_vs_tensor_op"] = check_close(
            what + " vs models/attention.py::flash_attention", got,
            tensor_op.transpose(1, 2).reshape(bh, sq, dh), rtol, atol)
    if timed:
        bound_s, bound_by = flash_bound(bh, bkvh, sq, skv, dh, causal, dtype)
        q4, k4, v4 = (t.view(b, -1, t.shape[1], dh) for t in (q, k, v))
        case.update({
            "ms": time_ms(lambda: ops.flash_attention_fwd(
                q, k, v, group=group, causal=causal)),
            "plain_ms": time_ms(lambda: flash_mod.flash_attention_fwd_plain(
                q, k, v, group=group, causal=causal), warmup=1, reps=3,
                inner=3),
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, enable_gqa=True)),
            "library": "torch.nn.functional.scaled_dot_product_attention("
                       "is_causal, enable_gqa) on (B, H, S, Dh)",
            "bound_ms": 1e3 * bound_s, "bound_by": bound_by,
            "in_summary": in_summary,
        })
    return case


def flash_bwd_plain_by_heads(q, k, v, do, group, causal, kv_chunk=16):
    """The plain version a chunk of kv heads (and their query heads) at a
    time: its f32 scores of every head at once would not fit the card at
    the timed shapes."""
    out = [[], [], []]
    for h0 in range(0, k.shape[0], kv_chunk):
        h1 = min(h0 + kv_chunk, k.shape[0])
        for acc, part in zip(out, flash_mod.flash_attention_bwd_plain(
                q[h0 * group:h1 * group], k[h0:h1], v[h0:h1],
                do[h0 * group:h1 * group], group=group, causal=causal)):
            acc.append(part)
    return [torch.cat(parts) for parts in out]


def flash_bwd_case(b, h, kvh, sq, skv, dh, causal, dtype, gen, timed,
                   ptxas=None):
    """flash_attention_bwd against its plain version; the same bits on a
    second call (no sum crosses blocks); ``timed``: ms beside the counted
    bound (twice the forward's products) and the kernels' own (their 22
    products against the counted 8, over the visible keys), the plain
    version and the backward of scaled_dot_product_attention."""
    bh, bkvh, group = b * h, b * kvh, h // kvh

    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    q, do = rnd((bh, sq, dh)), rnd((bh, sq, dh))
    k, v = rnd((bkvh, skv, dh)), rnd((bkvh, skv, dh))
    got = ops.flash_attention_bwd(q, k, v, do, group=group, causal=causal)
    again = ops.flash_attention_bwd(q, k, v, do, group=group, causal=causal)
    torch.cuda.synchronize()
    what = (f"flash_attention_bwd BH={bh} BKVH={bkvh} Sq={sq} Skv={skv} "
            f"Dh={dh} causal={causal} {dtype}")
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        fail(f"{what}: two calls differ")
    want = flash_bwd_plain_by_heads(q, k, v, do, group, causal)
    # the plain version's products in another order (the tensor cores' f32
    # sums, the tiles'), one rounding to the dtype each: within two ulps of
    # the gradient's largest value (a dropped tile or a wrong mask shows
    # as a whole gradient's worth)
    errs = {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        tol = 2 ** -6 * max(1.0, float(w.abs().max()))
        errs[name] = check_close(f"{what} {name}", a, w, 0.0, tol)
    case = {"name": "flash_attention_bwd", "route": "cuda",
            "kernel_route": "wgmma",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": None,
            "shape": {"BH": bh, "BKVH": bkvh, "Sq": sq, "Skv": skv, "Dh": dh,
                      "causal": causal},
            "dtype": DTYPE_NAMES[dtype], "max_abs_err": max(errs.values()),
            "max_abs_err_by_gradient": errs, "bit_equal_repeat": True}
    if timed:
        flops, nbytes = costs.flash_bwd(bh, bkvh, sq, skv, dh, causal,
                                        torch.finfo(dtype).bits // 8)
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
        q4, k4, v4 = (t.view(b, -1, t.shape[1], dh).requires_grad_(True)
                      for t in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, enable_gqa=True)
        do4 = do.view(b, h, sq, dh)
        case.update({
            "ms": time_ms(lambda: ops.flash_attention_bwd(
                q, k, v, do, group=group, causal=causal)),
            "plain_ms": time_ms(lambda: flash_bwd_plain_by_heads(
                q, k, v, do, group, causal), warmup=1, reps=3, inner=1),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                lib_out, (q4, k4, v4), do4, retain_graph=True)),
            "library": "the backward of torch.nn.functional."
                       "scaled_dot_product_attention(is_causal, enable_gqa) "
                       "on (B, H, S, Dh)",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "own_bound_ms": 1e3 * max(t_ops * 22 / 8, t_bytes),
            "fwd_ms": time_ms(lambda: ops.flash_attention_fwd(
                q, k, v, group=group, causal=causal)),
            "ptxas": ptxas or {},
        })
        del lib_out
    return case


def phase_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(flash_case(*FLASH_MAIN, dtype, gen, timed=True,
                                in_summary=dtype == torch.bfloat16,
                                vs_tensor_op=dtype == torch.bfloat16))
    cases.append(flash_case(*FLASH_MINICPM, torch.bfloat16, gen, timed=True,
                            vs_tensor_op=True))
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for shape in FLASH_RAGGED:
            cases.append(flash_case(*shape, dtype, gen, timed=False))
    for dtype in (torch.bfloat16, torch.float16):
        for shape in FLASH_EDGE:
            cases.append(flash_case(*shape, dtype, gen, timed=False))
        for shape in FLASH_PADDED:
            cases.append(flash_case(*shape, dtype, gen, timed=False))
        # a wgmma shape whose operands start off a 16-byte boundary takes
        # the mma route, at a full and at a padded capacity
        for shape in (FLASH_EDGE[0], FLASH_PADDED[0]):
            cases.append(flash_case(*shape, dtype, gen, timed=False,
                                    misaligned=True))
        for shape in FLASH_BWD_RAGGED:
            cases.append(flash_bwd_case(*shape, dtype, gen, timed=False))
    bwd_ptxas = ptxas_report((_build.build().parent / "build.log")
                             .read_text(), "flash_attention_bwd.cu")
    for b, h, kvh, s, dh in FLASH_BWD_TIMED:
        cases.append(flash_bwd_case(b, h, kvh, s, s, dh, True, torch.bfloat16,
                                    gen, timed=True, ptxas=bwd_ptxas))
        torch.cuda.empty_cache()
    f32 = torch.zeros((2, 64, 64), device="cuda")
    try:
        ops.flash_attention_bwd(f32, f32[:1], f32[:1], f32, group=2)
    except ValueError:
        pass
    else:
        fail("flash_attention_bwd took float32 on the card")
    for dtype in (torch.bfloat16, torch.float32):
        for n, d in ROW_NORM_MAIN:
            cases.append(row_norms_case(n, d, dtype, gen, timed=True))
        for name in DW_KERNELS:
            for d_in, d_out in FUSED_MAIN:
                cases.append(dw_case(name, B, K, S, d_in, d_out, dtype, gen,
                                     timed=True))
    # the run phase's shapes, in its bf16, at every k its controller can
    # pin: 512 is a whole number of the wgmma route's 64-row k steps
    for n, d in ROW_NORM_RUN:
        cases.append(row_norms_case(n, d, torch.bfloat16, gen, timed=False))
    for k in run_budget_ks():
        for d in GATHER_MAIN_D:
            cases.append(gather_scale_case(RUN_BATCH, RUN_SEQ, d, k,
                                           torch.bfloat16, gen, timed=False))
        for d_in, d_out in FUSED_MAIN:
            cases.append(dw_case("fused_sampled_dw", RUN_BATCH, k, RUN_SEQ,
                                 d_in, d_out, torch.bfloat16, gen,
                                 timed=False))
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for n, d in ROW_NORM_RAGGED:
            cases.append(row_norms_case(n, d, dtype, gen, timed=False))
        for shape in FUSED_RAGGED:
            cases.append(dw_case("fused_sampled_dw", *shape, dtype, gen,
                                 timed=False))
    for dtype in (torch.bfloat16, torch.float16):
        for shape in FUSED_EDGE:
            cases.append(dw_case("fused_sampled_dw", *shape, dtype, gen,
                                 timed=False, dup=True))
        for shape in SMM_EDGE:
            cases.append(dw_case("sampled_matmul", *shape, dtype, gen,
                                 timed=False, dup=True))
        for name in DW_KERNELS:
            cases.append(dw_misaligned_case(name, dtype, gen))
    # a view that starts off a 16-byte boundary takes the element-wise path
    flat = torch.randn((64 * 256 + 8,), generator=gen, device="cuda")
    x = flat.to(torch.bfloat16)[1:1 + 64 * 256].reshape(64, 256)
    check_close("row_norms misaligned", ops.row_norms(x),
                row_norms_mod.row_norms_plain(x), 1e-5, 1e-5)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for d in GATHER_MAIN_D:
            cases.append(gather_scale_case(
                B, S, d, K, dtype, gen, timed=dtype != torch.float16))
        for n, d, k in GATHER_RAGGED_2D:
            cases.append(gather_scale_case(1, n, d, k, dtype, gen,
                                           timed=False, two_d=True))
        cases.append(gather_scale_case(*GATHER_RAGGED_BATCHED, dtype, gen,
                                       timed=False))
        for shape in gather_edges(dtype):
            cases.append(gather_scale_case(*shape, dtype, gen, timed=False))
        cases.append(gather_scale_case(2, 40, 1024, 64, dtype, gen,
                                       timed=False, same_row=True))
        cases.append(gather_scale_case(1, 128, 4096, 100, dtype, gen,
                                       timed=False, two_d=True))
        # a view off a 16-byte boundary at a bulk width takes the warp route
        cases.append(gather_scale_case(2, 60, 1024, 30, dtype, gen,
                                       timed=False, misaligned=True))
    for dtype in (torch.bfloat16, torch.float32):
        for k, d_in, d_out, n in SMM_SWEEP_2D:
            cases.append(dw_case("sampled_matmul", 1, k, n, d_in, d_out,
                                 dtype, gen, timed=False, two_d=True))
        for shape in SMM_SWEEP_BATCHED:
            cases.append(dw_case("sampled_matmul", *shape, dtype, gen,
                                 timed=False))
    # the optim phase's shapes (nemotron-4-15b, B=1, n=2048, k=614) and the
    # wide_serve prefill's heads, bf16, timed; ``phase`` names the phase
    # whose launches the summary counts
    bf16 = torch.bfloat16
    for n, d in ROW_NORM_OPTIM:
        cases.append(dict(row_norms_case(n, d, bf16, gen, timed=True),
                          phase="optim"))
    for d in GATHER_OPTIM_D:
        cases.append(dict(gather_scale_case(OPT_B, OPT_S, d, OPT_K, bf16, gen,
                                            timed=True), phase="optim"))
    for d_in, d_out in FUSED_OPTIM:
        cases.append(dict(dw_case("fused_sampled_dw", OPT_B, OPT_K, OPT_S,
                                  d_in, d_out, bf16, gen, timed=True),
                          phase="optim"))
    cases.append(dict(flash_case(*FLASH_COMMAND_R, bf16, gen, timed=True,
                                 in_summary=True), phase="wide_serve"))
    cases.append(flash_case(*FLASH_NEMOTRON, bf16, gen, timed=True))
    # the MoE phases' shapes, bf16, timed: row norms over every expert's
    # capacity slots (E*C rows) and the router's B*S rows, the experts' H'
    # (E samples of C rows), every expert's dW in one launch (wi/wg
    # d_model x d_ff, wo d_ff x d_model) and the router's narrow dW (d_out
    # = E); the prefills' flash heads
    for phase, m, flash in (("moe", GRANITE, FLASH_GRANITE),
                            ("moe_wide", DBRX, FLASH_DBRX)):
        for n, d in ((m["e"] * m["cap"], m["d"]), (m["e"] * m["cap"], m["f"]),
                     (m["rows"], m["d"])):
            cases.append(dict(row_norms_case(n, d, bf16, gen, timed=True),
                              phase=phase))
        for d in (m["d"], m["f"]):
            cases.append(dict(gather_scale_case(m["e"], m["cap"], d, m["k"],
                                                bf16, gen, timed=True),
                              phase=phase))
        for d_in, d_out in ((m["d"], m["f"]), (m["f"], m["d"])):
            cases.append(dict(expert_dw_case(m["e"], 1, m["k"], m["cap"],
                                             d_in, d_out, bf16, gen,
                                             timed=True), phase=phase))
            torch.cuda.empty_cache()
        cases.append(dict(dw_case("fused_sampled_dw", 1, m["k_router"],
                                  m["rows"], m["d"], m["e"], bf16, gen,
                                  timed=True), phase=phase))
        cases.append(dict(flash_case(*flash, bf16, gen, timed=True,
                                     in_summary=True), phase=phase))
    # the recurrent phases' shapes, bf16, timed: row norms and H' at every
    # width a plan reads, every sampled dW (zamba2's mamba_in d_out 10448 is
    # a multiple of 8, not of 64; xlstm's mlstm_if has d_out 8), zamba2's
    # prefill flash heads on the wgmma route (Dh 80)
    for phase, b, s, k, row_d, dws in (
            ("ssm", SSM_B, SSM_S, SSM_K, SSM_ROW_D, SSM_DW),
            ("xlstm", XLSTM_B, XLSTM_S, XLSTM_K, XLSTM_ROW_D, XLSTM_DW)):
        for d in row_d:
            cases.append(dict(row_norms_case(b * s, d, bf16, gen, timed=True),
                              phase=phase))
            cases.append(dict(gather_scale_case(b, s, d, k, bf16, gen,
                                                timed=True), phase=phase))
        for d_in, d_out in dws:
            cases.append(dict(dw_case("fused_sampled_dw", b, k, s, d_in,
                                      d_out, bf16, gen, timed=True),
                              phase=phase))
    cases.append(dict(flash_case(*FLASH_ZAMBA2, bf16, gen, timed=True,
                                 in_summary=True), phase="ssm"))
    # the tp phase's recurrent and enc-dec legs: one rank's shards at
    # model = 2, and zamba2's prefill at 16 heads of 80 a rank
    for phase, b, s, row_d, dws in TP_BLOCK_SHAPES:
        k = MOE_WTA.budget_rows(s)
        for d in row_d:
            cases.append(dict(row_norms_case(b * s, d, bf16, gen, timed=True),
                              phase=phase))
            cases.append(dict(gather_scale_case(b, s, d, k, bf16, gen,
                                                timed=True), phase=phase))
        for d_in, d_out in dws:
            cases.append(dict(dw_case("fused_sampled_dw", b, k, s, d_in,
                                      d_out, bf16, gen, timed=True),
                              phase=phase))
    cases.append(dict(flash_case(*FLASH_TP_ZAMBA2, bf16, gen, timed=True,
                                 in_summary=True), phase="tp_zamba2"))
    # the VLM and encoder-decoder phases' shapes, bf16, timed: row norms
    # and H' at every width a plan reads, every sampled dW; qwen2-vl-2b's
    # vis_proj plan over the B x 256 patch rows (k = 77: a k tail well
    # under the wgmma route's 64-row steps) and its prefill's flash heads
    # at group 6; whisper-base's plans over 1024 frames and 1024 tokens
    for phase, b, s, k, row_d, dws in (
            ("vlm", VLM_B, VLM_S, VLM_K, VLM_ROW_D, VLM_DW),
            ("whisper", WHISPER_B, WHISPER_S // 2, WHISPER_K, WHISPER_ROW_D,
             WHISPER_DW)):
        for d in row_d:
            cases.append(dict(row_norms_case(b * s, d, bf16, gen, timed=True),
                              phase=phase))
            cases.append(dict(gather_scale_case(b, s, d, k, bf16, gen,
                                                timed=True), phase=phase))
        for d_in, d_out in dws:
            cases.append(dict(dw_case("fused_sampled_dw", b, k, s, d_in,
                                      d_out, bf16, gen, timed=True),
                              phase=phase))
    d = get_config(VLM_ARCH).d_model
    cases.append(dict(row_norms_case(VLM_B * VLM_VIS, d, bf16, gen,
                                     timed=True), phase="vlm"))
    cases.append(dict(gather_scale_case(VLM_B, VLM_VIS, d, VLM_VIS_K, bf16,
                                        gen, timed=True), phase="vlm"))
    cases.append(dict(dw_case("fused_sampled_dw", VLM_B, VLM_VIS_K, VLM_VIS,
                              d, d, bf16, gen, timed=True), phase="vlm"))
    cases.append(dict(flash_case(*FLASH_VLM, bf16, gen, timed=True,
                                 in_summary=True), phase="vlm"))
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for shape in EXPERT_RAGGED:
            cases.append(expert_dw_case(*shape, dtype, gen, timed=False,
                                        dup=True))
    for dtype in (torch.bfloat16, torch.float16):
        cases.append(expert_dw_case(3, 2, 70, 90, 128, 192, dtype, gen,
                                    timed=False, misaligned=True))
    composition, comp_launches, comp_routes = composition_case(gen)
    # the route each case must have taken: the wgmma route wherever its
    # shape, dtype and alignment allow (every FLASH_EDGE / FUSED_EDGE case),
    # gather_scale's bulk route wherever a row is whole 16-byte chunks and
    # the operands are aligned
    for c in cases:
        if "kernel_route" not in c:
            continue
        dtype = getattr(torch, c["dtype"])
        aligned = not c.get("misaligned", False)
        sh = c["shape"]
        if c["name"] == "flash_attention_fwd":
            want = flash_mod.flash_route(sh["Dh"], dtype, aligned)
        elif c["name"] == "flash_attention_bwd":
            want = "wgmma"
        elif c["name"] == "fused_sampled_dw":
            want = fused_sampling.dw_route(sh["d_in"], sh["d_out"], dtype,
                                           aligned)
        elif c["name"] == "gather_scale":
            want = gather_scale_mod.gather_route(sh["d"], dtype, aligned)
        else:
            want = sampled_matmul_mod.smm_route(
                sh["d_in"], sh["d_out"], dtype, aligned, card_sms()).route
        if c["kernel_route"] != want:
            fail(f"{c['name']} {sh} {c['dtype']}: took the "
                 f"{c['kernel_route']} route, expected {want}")
    emit({"phase": "kernels", "cases": cases, "composition": composition,
          "bad_index": bad_index_cases()})
    return cases, comp_launches, comp_routes


# The autotune phase's train step: qwen2.5-3b at published width, depth cut
# 36 -> 1 (one step of each dW shape of the train path is all it shows)
AUTOTUNE_DEPTH = 1
# the CLI's in-process run: one row of the sweep
AUTOTUNE_CLI_SHAPES = "2048,256,4,307,bfloat16"


def checked_measure(errors):
    """A tuner ``measure`` that holds each candidate's output against the
    plain version on the tuner's own inputs (``autotune.sweep_inputs``) at
    the dW tolerance, keeps the error in ``errors``, then times it
    (``time_ms``): microseconds."""
    def measure(kernel, tile, d_in, d_out, b, k, dtype):
        args = autotune.sweep_inputs(d_in, d_out, b, k, dtype, "cuda")
        out = autotune.run_candidate(kernel, tile, *args)
        key = autotune.shape_key(d_in, d_out, b, k, dtype)
        # as dw_case: the same factors, only the order of the f32 sums
        errors[f"{kernel} {key} tile={tile}"] = check_close(
            f"autotune {kernel} {key} tile={tile}", out,
            fused_sampling.fused_sampled_dw_plain(*args), 1e-4,
            1e-4 * math.sqrt(b * k))
        return 1e3 * time_ms(lambda: autotune.run_candidate(kernel, tile,
                                                            *args))
    return measure


def phase_autotune(smi):
    sms = card_sms()
    errors, rows, clock = {}, [], {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        fresh = autotune.refresh_table(
            autotune.DEFAULT_SWEEP, os.path.join(tmp, "fresh.json"),
            measure=checked_measure(errors), card=smi)
        packaged = autotune.TuningTable.load(autotune.PACKAGED_TABLE)
        missing = [(kernel, autotune.shape_key(*row))
                   for row in autotune.DEFAULT_SWEEP
                   for kernel in autotune.KERNELS
                   if packaged.lookup(kernel, autotune.shape_key(*row))
                   is None]
        if missing or not packaged.card:
            fail(f"autotune: the packaged table lacks {missing} or names "
                 f"no card ({packaged.card!r})")
        for kernel, recs in packaged.entries.items():
            for key, e in recs.items():
                if (e.tile, e.us) != autotune.fastest(e.candidates_us):
                    fail(f"autotune: packaged {kernel} {key}: tile {e.tile} "
                         f"({e.us} us) is not the fastest of its "
                         f"candidates {e.candidates_us}")
        for row in autotune.DEFAULT_SWEEP:
            d_in, d_out, b, k, dtype = row
            key = autotune.shape_key(*row)
            route = fused_sampling.dw_route(d_in, d_out,
                                            autotune.torch_dtype(dtype))
            args = autotune.sweep_inputs(d_in, d_out, b, k, dtype, "cuda")
            for kernel in autotune.KERNELS:
                rule = autotune.default_blocks(kernel, route, d_in, d_out,
                                               sms=sms)
                e = fresh.entries[kernel][key]
                tiled = packaged.lookup(kernel, key, route)
                rec = {"kernel": kernel, "shape": key, "route": route,
                       "rule": rule, "tuned": e.tile,
                       "candidates_us": dict(e.candidates_us),
                       "packaged": tiled}
                if tiled != rule:
                    # the packaged pick against the rule's, re-timed here
                    rec["retimed_us"] = {
                        str(t): 1e3 * time_ms(
                            lambda t=t: autotune.run_candidate(kernel, t,
                                                               *args))
                        for t in (tiled, rule)}
                rows.append(rec)
        clock["refresh_and_retime_s"] = time.perf_counter() - t0
        # a table whose tile differs from the rule at the train path's
        # shapes reaches the launch: 64 at every one (the rule takes 128 at
        # three of the four)
        forced = autotune.TuningTable(card=smi)
        for d_in, d_out in FUSED_MAIN:
            forced.put("fused_sampled_dw", autotune.shape_key(
                d_in, d_out, B, K, "bfloat16"), "wgmma", 64)
        forced_path = forced.save(os.path.join(tmp, "forced.json"))
        cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                                  n_layers=AUTOTUNE_DEPTH)
        ds = data.SyntheticLM(cfg.vocab_size, S, B, seed=0)
        wta = WTACRSConfig(kind="wta_crs", budget=0.3, min_rows=4)
        reset_launches()
        losses, *_ = run_steps(cfg, wta.with_kernel(
            KernelConfig(table_path=forced_path)), 1, B, S, ds)
        by_tile = dict(ops.fused_sampled_dw.launches_by_tile)
        want = launches_per_step(cfg, cm.Policy(wtacrs=wta), S)
        if by_tile != {128: 0, 64: want["fused_sampled_dw"]} \
                or not math.isfinite(losses[0]):
            fail(f"autotune: a step under {forced_path} launched "
                 f"fused_sampled_dw by tile {by_tile} (loss {losses}), "
                 f"expected all {want['fused_sampled_dw']} on tile 64")
        clock["forced_step_s"] = (time.perf_counter() - t0
                                  - clock["refresh_and_retime_s"])
        cli_out = os.path.join(tmp, "cli.json")
        t1 = time.perf_counter()
        rc = autotune.main(["--out", cli_out, "--shapes",
                            AUTOTUNE_CLI_SHAPES])
        clock["cli_s"] = time.perf_counter() - t1
        cli = autotune.TuningTable.load(cli_out)
        if rc != 0 or cli.card != smi or sorted(cli.entries) != sorted(
                autotune.KERNELS):
            fail(f"autotune: the CLI returned {rc} and wrote {cli}")
    agree = sum(r["tuned"] == r["packaged"] for r in rows)
    emit({"phase": "autotune", "card": smi, "rows": rows,
          "max_abs_err": errors, "candidates": len(errors),
          "tuned_equal_packaged": f"{agree}/{len(rows)}",
          "forced_table_launches_by_tile": by_tile, "seconds": clock,
          "cli_entries": {k: {key: e.tile for key, e in v.items()}
                          for k, v in cli.entries.items()}})


# ---------------------------------------------------------------------------
# model phases
# ---------------------------------------------------------------------------

KERNEL_NAMES = ("row_norms", "gather_scale", "sampled_matmul",
                "fused_sampled_dw", "flash_attention_fwd",
                "flash_attention_bwd")


def reset_launches():
    for name in KERNEL_NAMES:
        fn = getattr(ops, name)
        fn.launches = 0
        for counts in ("launches_by_route", "launches_by_tile"):
            for key in getattr(fn, counts, {}):
                getattr(fn, counts)[key] = 0


def expect_route(what, name, route):
    """Fail unless every launch of kernel ``name`` since the last reset (at
    least one) took ``route``; returns its launches by route."""
    fn = getattr(ops, name)
    by_route = dict(fn.launches_by_route)
    if fn.launches == 0 or by_route[route] != fn.launches:
        fail(f"{what}: {name} launches by route {by_route}, expected all "
             f"{fn.launches} on the {route} route")
    return by_route


def launch_counts():
    return {name: getattr(ops, name).launches for name in KERNEL_NAMES}


def expect_launches(what, want):
    """Fail unless the counts since the last reset are ``want`` (kernels
    not named there: 0)."""
    want = {name: want.get(name, 0) for name in KERNEL_NAMES}
    got = launch_counts()
    if got != want:
        fail(f"{what}: kernel launches {got}, expected {want}")
    return got


def phase_parity():
    """The kernels inside the whole step: one det_topk train step (no
    random draw, so card and CPU build the same plan) of the reduced
    qwen2.5-3b in f32, card against CPU.  The norm gains are redrawn from
    [0.5, 1.5]: at their initial 1.0 all rows of a normed activation have
    the same length up to an ulp and top-k would be decided by the last
    bit, which card and CPU do not share."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b", reduced=True),
                              compute_dtype="float32")
    policy = cm.Policy(wtacrs=WTACRSConfig(kind="det_topk", budget=0.3,
                                           min_rows=4))
    ds = data.SyntheticLM(cfg.vocab_size, 64, 16, seed=1)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    start = train_steps.init_train_state(cfg, 0, device="cpu")["params"]
    for layer in start["layers"] + [start]:
        for name in ("norm1", "norm2", "final_norm"):
            if name in layer:
                g = layer[name]["gamma"]
                g.copy_(torch.rand(g.shape, generator=gen) + 0.5)
    out = {}
    for dev in ("cuda", "cpu"):
        params = optim.tree_map(lambda t: t.to(dev, copy=True), start)
        state = {"params": params, "opt": optim.adamw_init(params),
                 "step": 0, "base_seed": 1}
        step = train_steps.make_train_step(
            cfg, policy, optim.AdamWConfig(),
            optim.linear_warmup_constant(1e-3, 1), device=dev)
        reset_launches()
        state, m = step(state, ds.batch_at(0, 4))
        out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    [p.detach().cpu() for p in
                     optim.tree_leaves(state["params"])])
        expect_launches(f"parity on {dev}", launches_per_step(
            cfg, policy, 64) if dev == "cuda" else {})
    # f32 everywhere; card and CPU differ in summation order only: 1e-4
    rel = [abs(a - b) / max(abs(b), 1e-12)
           for a, b in zip(out["cuda"][:2], out["cpu"][:2])]
    perr = max(float((a - b).abs().max())
               for a, b in zip(out["cuda"][2], out["cpu"][2]))
    if max(rel) > 1e-4 or perr > 1e-4:
        fail(f"parity: card vs CPU loss/grad_norm rel {rel}, "
             f"max param diff {perr}")
    emit({"phase": "parity", "loss": out["cuda"][0],
          "loss_cpu": out["cpu"][0], "rel_loss_gnorm": rel,
          "max_param_diff": perr})


# one meta-device trace per configuration, however many steps are counted
trace_linears = functools.lru_cache(maxsize=None)(znorm.trace_linears)


def attention_structure(cfg, remat):
    """(flash_attention_fwd, flash_attention_bwd) launches of one
    microbatch's loss and gradient by the model's structure: where the
    compute dtype and head dim take the kernels (``flash_route`` gives
    ``wgmma``), one of each an attention call, the forward again under a
    remat's recompute.  A decoder attends once a layer that runs attention
    (``attention_layers``); an encoder-decoder once an encoder layer and
    twice a decoder layer (self- and cross-attention), and takes no
    remat."""
    if cfg.head_dim % 8 or flash_mod.flash_route(
            cfg.head_dim, cfg.cdtype, True) != "wgmma":
        return 0, 0
    if cfg.encoder_layers:
        calls = cfg.encoder_layers + 2 * cfg.n_layers
        return calls, calls
    calls = attention_layers(cfg)
    return calls * (1 if remat == "none" else 2), calls


@functools.lru_cache(maxsize=None)
def attention_launches(cfg, remat):
    """(flash_attention_fwd, flash_attention_bwd) launches of one
    microbatch's loss and gradient under ``remat``: the training
    attention's Function charges a meta launch of each kernel wherever it
    would launch on the card, so they are read off a trace of the step on
    ``meta`` (the batch of ``znorm.trace_linears``; the count does not
    depend on the shapes), and held to ``attention_structure``: a call
    that left the kernels reads 0 on the card and on ``meta`` alike."""
    params = registry.init_params(cfg, 0, device="meta")
    leaves = [p.requires_grad_(True) for p in optim.tree_leaves(params)
              if p.is_floating_point()]
    batch = {name: torch.empty(shape, dtype=dtype, device="meta")
             for name, (shape, dtype) in registry.train_batch_specs(
                 cfg, 2, 2 * len(cfg.pattern) * 4).items()}
    fwd, bwd = (ops.flash_attention_fwd.meta_launches,
                ops.flash_attention_bwd.meta_launches)
    loss, _ = registry.loss_fn(cfg, params, batch, cm.Policy(
        wtacrs=WTACRSConfig(kind="exact"), remat=remat))
    torch.autograd.grad(loss, leaves, allow_unused=True)
    got = (ops.flash_attention_fwd.meta_launches - fwd,
           ops.flash_attention_bwd.meta_launches - bwd)
    want = attention_structure(cfg, remat)
    if got != want:
        fail(f"{cfg.name} remat={remat}: the meta trace charges {got} "
             f"training attention launches a microbatch, the structure "
             f"{want}")
    return got


def launches_per_step(cfg, policy, seq, microbatches=1, batch=None):
    """Kernel launches one train step implies under a resolved ``policy``,
    read off the model's own linear calls (``znorm.trace_linears``) split
    into plans as ``Ctx.linear_shared`` splits them (``cm.plan_groups``): a
    plan whose tags sample at ``seq`` (``znorm.sampling_active_tags``;
    a rows-dim tag, the MoE router, samples the ``batch * seq`` rows of a
    microbatch) launches row_norms and gather_scale once — twice under
    ``remat="full"``, whose recompute builds the plan again, once under
    ``"wtacrs_names"``, whose recompute takes it from the stash — and
    fused_sampled_dw once per weight; an exact one launches nothing.  Each
    MoE expert FFN (``rec.expert_calls``) samples when its tag does at its
    capacity slots a sampling group (``models/mlp.py``): its plans launch
    the same, and its dW once a weight for all the experts.  The training
    attention launches ``attention_launches``."""
    rec = trace_linears(cfg)
    by_rows = [t for t in rec.tags if rec.dims[t] == cm.SAMPLED_DIM_ROWS]
    active = znorm.sampling_active_tags(
        policy, [t for t in rec.tags if t not in by_rows], seq_len=seq)
    if by_rows or rec.expert_calls:
        if batch is None:
            fail(f"launches_per_step: {cfg.name} samples over rows; give "
                 f"the batch")
        tokens = batch // microbatches * seq
        active |= znorm.sampling_active_tags(policy, by_rows,
                                             seq_len=tokens)
    plans_built = 2 if policy.remat == "full" else 1
    out = {"row_norms": 0, "gather_scale": 0, "fused_sampled_dw": 0}

    def plan(n_weights):
        out["row_norms"] += plans_built
        out["gather_scale"] += plans_built
        out["fused_sampled_dw"] += n_weights

    for call in rec.calls:
        for group in cm.plan_groups(policy, call):
            if group[0] in active:
                plan(len(group))
    out["flash_attention_fwd"], out["flash_attention_bwd"] = \
        attention_launches(cfg, policy.remat)
    for tag, weights_per_plan in rec.expert_calls:
        g = policy.moe_groups if tokens % policy.moe_groups == 0 else 1
        cap = g * mlp_mod.moe_capacity(cfg, tokens // g)
        slots = cap // (policy.moe_groups if cap % policy.moe_groups == 0
                        else 1)
        c = policy.config_for(tag)
        if not c.is_exact and c.budget_rows(slots) < slots:
            for n_weights in weights_per_plan:
                plan(n_weights)
    return {name: n * microbatches for name, n in out.items()}


def run_steps(cfg, wtacrs_cfg, n_steps, batch, seq, ds, keep=False,
              trace_last=False):
    """Fresh state, ``n_steps`` train steps; returns losses, step times
    (host clock around a step that ends in a synchronize) and the peak
    (``keep``: and the state and the step function, not freed;
    ``trace_last``: the last step runs under ``device_busy``, whose record
    is returned last, and its time is not among the step times)."""
    policy = cm.Policy(wtacrs=wtacrs_cfg, remat="none", flash_block=512)
    state = train_steps.init_train_state(cfg, 0)
    step = train_steps.make_train_step(
        cfg, policy, optim.AdamWConfig(),
        optim.linear_warmup_constant(1e-4, 2), microbatches=1,
        use_znorm_cache=False)
    # a sample of each leaf; of an untied embedding, rows of tokens the
    # data holds (a row no batch reads gets no gradient)
    rows = torch.from_numpy(np.unique(ds.batch_at(0, batch)["tokens"])[:64]
                            ).cuda().to(torch.int64)

    def sample(path, p):
        return (p[rows] if path == "embed" and not cfg.tie_embeddings
                else p[:64]).flatten()[:64]

    before = [sample(path, p).clone()
              for path, p in optim.named_leaves(state["params"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, traced = [], [], []
    for i in range(n_steps):
        if trace_last and i == n_steps - 1:
            out = []
            traced.append(device_busy(lambda: out.append(step(
                state, ds.batch_at(i, batch))), 1))
            state, m = out[0]
        else:
            t0 = time.perf_counter()
            state, m = step(state, ds.batch_at(i, batch))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    after = [sample(path, p)
             for path, p in optim.named_leaves(state["params"])]
    changed = sum(bool((a != b).any()) for a, b in zip(after, before))
    n_params = sum(p.numel() for p in optim.tree_leaves(state["params"]))
    if keep:
        return (losses, times, peak, changed, len(before), n_params, state,
                step, *traced)
    del state, step
    torch.cuda.empty_cache()
    return (losses, times, peak, changed, len(before), n_params, *traced)


def phase_train(cfg, ds, n_steps):
    reset_launches()
    wta = WTACRSConfig(kind="wta_crs", budget=0.3, min_rows=4)
    losses, times, peak, changed, n_leaves, n_params = run_steps(
        cfg, wta, n_steps, B, S, ds)
    launches = launch_counts()
    by_route = dict(ops.fused_sampled_dw.launches_by_route)
    by_tile = dict(ops.fused_sampled_dw.launches_by_tile)
    gather_routes = dict(ops.gather_scale.launches_by_route)
    emit({"phase": "train", "arch": cfg.name, "n_layers": cfg.n_layers,
          "n_params": n_params, "batch": B, "seq": S, "budget": 0.3,
          "losses": losses, "step_ms": times,
          "step_ms_median_after_first": statistics.median(times[1:]),
          "peak_bytes": peak, "launches": launches,
          "fused_sampled_dw_launches_by_route": by_route,
          "fused_sampled_dw_launches_by_tile": by_tile,
          "gather_scale_launches_by_route": gather_routes})
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train: loss did not fall: {losses}")
    per_step = launches_per_step(cfg, cm.Policy(wtacrs=wta), S)
    expect_launches("train", {name: n * n_steps
                              for name, n in per_step.items()})
    expect_route("train", "fused_sampled_dw", "wgmma")
    expect_route("train", "gather_scale", "bulk")
    # gamma of the norms and the biases move too: every leaf must change
    if changed != n_leaves:
        fail(f"train: only {changed} of {n_leaves} parameter leaves changed")
    return launches, peak


def mlp_policies(ctrl=None):
    """The fixed and adaptive policies of the reference's convergence
    benchmark: WTA-CRS on the MLP linears with the dataset gradient-norm
    cache driving the probabilities, exact attention; budget 0.3 fixed, or
    pinned by an ESS-proportional controller (``ctrl``, by default the
    benchmark's, whose far plateau takes 7 steps)."""
    rule_cfg = WTACRSConfig(kind="wta_crs", budget=0.3, min_rows=2,
                            norm_source="cached_grad")
    if ctrl is None:
        ctrl = ESSProportional(b_min=0.1, b_max=0.6, levels=6, warmup=2)
    fixed = cm.Policy(rules=PolicyRules.of(
        Rule.of("*mlp*", rule_cfg, BudgetSchedule.constant(0.3))))
    adaptive = cm.Policy(rules=PolicyRules.of(
        Rule.of("*mlp*", rule_cfg, ctrl)))
    return fixed, adaptive, ctrl


def run_budget_ks():
    """The k of every budget the run phase's controller can pin (its level
    grid) at n = RUN_SEQ, by the rule the sampled linears apply."""
    _, policy, ctrl = mlp_policies()
    rule_cfg = policy.rules.rules[0].config
    return sorted({rule_cfg.with_budget(b).budget_rows(RUN_SEQ)
                   for b in ctrl.grid()})


def resolved_policy(policy, trajectory, step):
    """The policy a scheduled step ran ``step`` under: schedules at the
    step, controller rules pinned to the budget its trajectory (initial
    pins and re-plans, each from its step on) held at that step."""
    pol = policy.at_step(step)
    budgets = {}
    for rec in trajectory:
        if rec["step"] <= step:
            budgets[rec["rule"]] = rec["budget"]
    if budgets:
        pol = pol.with_rule_budgets(
            tuple(budgets.get(i) for i in range(len(policy.rules.rules))))
    return pol


def run_cached(cfg, policy, n_steps, ds, microbatches=1):
    """Algorithm 1's whole loop: znorm cache over ``ds``'s sample ids,
    budget statistics, ``n_steps`` steps of make_scheduled_train_step.
    Returns what the gates and the report need."""
    tags = znorm.collect_linear_tags(cfg, policy=policy)
    state = train_steps.init_train_state(cfg, 0, znorm_tags=tags,
                                         n_dataset=ds.n_samples,
                                         budget_stats=True)
    step = train_steps.make_scheduled_train_step(
        cfg, policy, optim.AdamWConfig(),
        optim.linear_warmup_constant(1e-4, 2), use_znorm_cache=True,
        microbatches=microbatches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    want = {}
    losses, times, seen, sampled_steps = [], [], set(), {t: 0 for t in tags}
    for i in range(n_steps):
        batch = ds.batch_at(i, B)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        seen.update(int(s) for s in batch["sample_ids"])
        pol = resolved_policy(policy, step.budget_trajectory, i)
        for name, n in launches_per_step(cfg, pol, S, microbatches).items():
            want[name] = want.get(name, 0) + n
        for t in znorm.sampling_active_tags(pol, tags, seq_len=S):
            sampled_steps[t] += 1
    peak = torch.cuda.max_memory_allocated()
    launches = expect_launches(f"{cfg.name} cached loop", want)
    if not all(math.isfinite(x) for x in losses):
        fail(f"cached loop: non-finite loss in {losses}")
    ids = sorted(seen)
    cache = {t: state["znorm"][t].cpu() for t in tags}
    counts = {t: float(state["budget_stats"][t][znorm.STAT_COUNT])
              for t in tags}
    for t in tags:
        if sampled_steps[t] and not bool((cache[t][:, ids] != 1.0).all()):
            fail(f"cached loop: cache of {t} not rewritten for every seen "
                 f"sample")
        if counts[t] != sampled_steps[t]:
            fail(f"cached loop: stats of {t} count {counts[t]} updates for "
                 f"{sampled_steps[t]} sampled steps")
    out = {"losses": losses, "step_ms": times,
           "step_ms_median_after_first": statistics.median(times[1:]),
           "peak_bytes": peak, "launches": launches, "tags": len(tags),
           "seen_samples": len(ids), "stats_count": counts,
           "replans": step.replans, "compiled": len(step.compiled),
           "trajectory": step.budget_trajectory}
    del state, step
    torch.cuda.empty_cache()
    return out


def phase_adaptive(cfg, steps):
    """The fixed and the adaptive (ESSProportional) policy, ``steps`` steps
    each through make_scheduled_train_step with the znorm cache, on 8
    samples."""
    ds = data.SyntheticLM(cfg.vocab_size, S, 8, seed=0)
    fixed_pol, adaptive_pol, ctrl = mlp_policies()
    fixed = run_cached(cfg, fixed_pol, steps, ds)
    adaptive = run_cached(cfg, adaptive_pol, steps, ds)
    emit({"phase": "adaptive", "arch": cfg.name, "n_layers": cfg.n_layers,
          "batch": B, "seq": S, "samples": ds.n_samples, "steps": steps,
          "controller": "ESSProportional(b_min=0.1, b_max=0.6, levels=6, "
                        "warmup=2)",
          "fixed": fixed, "adaptive": adaptive,
          "final_loss_fixed": fixed["losses"][-1],
          "final_loss_adaptive": adaptive["losses"][-1]})
    for name, run in (("fixed", fixed), ("adaptive", adaptive)):
        if not run["losses"][-1] < run["losses"][0]:
            fail(f"adaptive: the {name} run's loss did not fall: "
                 f"{run['losses']}")
        if run["compiled"] > run["replans"] + 1:
            fail(f"adaptive: {run['compiled']} step functions for "
                 f"{run['replans']} re-plans in the {name} run")
    for rec in adaptive["trajectory"]:
        if not ctrl.b_min <= rec["budget"] <= ctrl.b_max:
            fail(f"adaptive: pinned budget {rec['budget']} outside "
                 f"[{ctrl.b_min}, {ctrl.b_max}]")
    return fixed["peak_bytes"]


def phase_accumulate(cfg, peak_m1, n_steps=3, microbatches=2):
    """The fixed cached-grad policy at microbatches=2: one stats update per
    optimizer step, the cache rewritten for all 4 samples."""
    ds = data.SyntheticLM(cfg.vocab_size, S, B, seed=0)
    fixed_pol, _, _ = mlp_policies()
    run = run_cached(cfg, fixed_pol, n_steps, ds, microbatches=microbatches)
    emit({"phase": "accumulate", "arch": cfg.name, "n_layers": cfg.n_layers,
          "batch": B, "seq": S, "microbatches": microbatches,
          "steps": n_steps, "run": run, "peak_bytes": run["peak_bytes"],
          "peak_bytes_microbatches_1": peak_m1})
    if run["seen_samples"] != B:
        fail(f"accumulate: saw {run['seen_samples']} of {B} samples")


def phase_memory(cfg, ds, wta_peak):
    """The legacy AdamW legs (exact here, WTA-CRS from the train phase),
    then the remat legs under the ``mixed`` spec in a child process."""
    losses, times, peak, *_ = run_steps(cfg, EXACT_CONFIG, 2, B, S, ds)
    if not all(math.isfinite(x) for x in losses):
        fail(f"memory: non-finite loss in {losses}")
    remat = run_child("memory_remat_child", timeout=900)
    emit({"phase": "memory", "exact_losses": losses, "exact_step_ms": times,
          "peak_bytes_exact": peak, "peak_bytes_wta_crs": wta_peak,
          "exact_over_wta_crs": (peak / wta_peak) if wta_peak else None,
          "mixed_spec": remat})


def mixed_spec():
    """The reference's ``mixed`` OptimSpec (``benchmarks/bench_memory.py``):
    low-rank moments (r=8) on the transformer matrices, momentum-free
    factored second moments on the embedding, dense elsewhere."""
    return optim_lib.OptimSpec.of(
        dict(pattern="unit/*", layout="lowrank", rank=8),
        dict(pattern="embed*", layout="factored", momentum=False))


# (estimator, remat) of the memory phase's legs under the mixed spec
REMAT_LEGS = [("exact", "none"), ("wta_crs", "none"),
              ("wta_crs", "wtacrs_names"), ("exact", "full")]


MEMORY_DEPTH = 3      # the remat legs: qwen2.5-3b, depth 36 -> 3 (12 until
                      # the model-axis slice, 6 until the analysis one)


def memory_remat_child():
    """The MEMORY_DEPTH-layer qwen2.5-3b of the memory phase under the ``mixed``
    spec, 2 steps a leg from fresh parameters (run in a child process with
    CUBLAS_WORKSPACE_CONFIG set and deterministic algorithms on): each
    remat leg's losses bit-equal to its ``none`` leg's, launches as
    ``launches_per_step`` implies, every peak."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                              n_layers=MEMORY_DEPTH)
    ds = data.SyntheticLM(cfg.vocab_size, S, B, seed=0)
    spec, legs = mixed_spec(), {}
    for est, remat in REMAT_LEGS:
        wcfg = (EXACT_CONFIG if est == "exact" else
                WTACRSConfig(kind="wta_crs", budget=0.3, min_rows=4))
        policy = cm.Policy(wtacrs=wcfg, remat=remat, flash_block=512)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        state = train_steps.init_train_state(cfg, 0, opt=spec)
        step = train_steps.make_train_step(
            cfg, policy, spec, optim.linear_warmup_constant(1e-4, 2))
        losses, times = [], []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, ds.batch_at(i, B))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
        per_step = launches_per_step(cfg, policy, S)
        launches = expect_launches(f"memory {est}/{remat}", {
            name: 2 * n for name, n in per_step.items()})
        if not all(math.isfinite(x) for x in losses):
            fail(f"memory {est}/{remat}: non-finite loss in {losses}")
        legs[f"{est}/{remat}"] = {
            "losses": losses, "step_ms": times,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches, "launches_per_step": per_step}
        del state, step
    for leg, base in (("wta_crs/wtacrs_names", "wta_crs/none"),
                      ("exact/full", "exact/none")):
        if legs[leg]["losses"] != legs[base]["losses"]:
            fail(f"memory: {leg} losses {legs[leg]['losses']} are not "
                 f"{base}'s {legs[base]['losses']} bit for bit")
    emit({"arch": cfg.name, "n_layers": cfg.n_layers, "batch": B, "seq": S,
          "spec": "mixed", "legs": legs, "remat_losses_bit_equal": True,
          "deterministic": True,
          "state_bytes_memory_report": optim_lib.memory_report(
              spec, registry.init_params(cfg, 0, device="meta"))[
                  "state_bytes"]})


def optim_specs():
    """Three of the reference's memory-benchmark specs
    (``benchmarks/bench_memory.py``)."""
    return {"factored_came": optim_lib.OptimSpec.of(
                dict(pattern="*", layout="factored", momentum=True)),
            "factored": optim_lib.OptimSpec.of(
                dict(pattern="*", layout="factored", momentum=False)),
            "mixed": mixed_spec()}


def phase_optim():
    """nemotron-4-15b at published width, depth cut to OPT_DEPTH, under three
    OptimSpecs: 4 steps each from fresh parameters; the state's bytes on
    the card against memory_report; one subspace refresh of the widest
    leaf timed.  Returns the phase's kernel launches."""
    cfg = dataclasses.replace(get_config("nemotron-4-15b"),
                              n_layers=OPT_DEPTH)
    if (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.vocab_size, cfg.tie_embeddings) != (6144, 24576, 48, 8, 128,
                                                    256000, False):
        fail(f"optim: not the published nemotron-4-15b: {cfg}")
    policy = cm.Policy(wtacrs=WTACRSConfig(kind="wta_crs", budget=0.3,
                                           min_rows=4))
    per_step = launches_per_step(cfg, policy, OPT_S)
    ds = data.SyntheticLM(cfg.vocab_size, OPT_S, OPT_B, seed=0)
    meta = registry.init_params(cfg, 0, device="meta")
    legs, launches = {}, {name: 0 for name in KERNEL_NAMES}
    for name, spec in optim_specs().items():
        report = optim_lib.memory_report(spec, meta)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = registry.init_params(cfg, 0)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        state = train_steps.init_train_state(cfg, 0, params=params,
                                             opt=spec)
        allocated = torch.cuda.memory_allocated() - before
        slots = [t for leaf in state["opt"]["leaves"].values()
                 for t in leaf.values()]
        if not all(t.is_cuda for t in slots):
            fail(f"optim {name}: optimizer state off the card")
        on_card = optim_lib.tree_bytes(state["opt"])
        if on_card != report["state_bytes"]:
            fail(f"optim {name}: {on_card} state bytes on the card, "
                 f"memory_report says {report['state_bytes']}")
        step = train_steps.make_train_step(
            cfg, policy, spec, optim.linear_warmup_constant(1e-4, 2))
        reset_launches()
        losses, times = [], []
        for i in range(OPT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, ds.batch_at(i, OPT_B))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated()
        got = expect_launches(f"optim {name}", {
            k: n * OPT_STEPS for k, n in per_step.items()})
        by_route = expect_route(f"optim {name}", "fused_sampled_dw",
                                "wgmma")
        gather_routes = expect_route(f"optim {name}", "gather_scale", "bulk")
        for k, n in got.items():
            launches[k] += n
        if not all(math.isfinite(x) for x in losses):
            fail(f"optim {name}: non-finite loss in {losses}")
        if not losses[-1] < losses[0]:
            fail(f"optim {name}: loss did not fall: {losses}")
        legs[name] = {
            "losses": losses, "step_ms": times,
            "step_ms_median_after_first": statistics.median(times[1:]),
            "peak_bytes": peak, "state_bytes_on_card": on_card,
            "state_bytes_memory_report": report["state_bytes"],
            "state_bytes_allocated": allocated,
            "memory_report": report, "launches": got,
            "fused_sampled_dw_launches_by_route": by_route,
            "gather_scale_launches_by_route": gather_routes}
        del state, step, params, m
    torch.cuda.empty_cache()
    # one subspace refresh (the SVD and the moments' rotation) of the mixed
    # leg's widest leaf, mlp/wi (6144 x 24576) at rank 8
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    g = torch.randn((cfg.d_model, cfg.d_ff), generator=gen, device="cuda")
    proj = torch.zeros((cfg.d_model, 8), device="cuda")
    mom = torch.zeros((8, cfg.d_ff), device="cuda")
    refresh_ms = time_ms(lambda: optim_lib.layouts.refresh_subspace(
        g, proj, mom, mom), warmup=1, reps=3, inner=1)
    del g, proj, mom
    torch.cuda.empty_cache()
    emit({"phase": "optim", "arch": cfg.name, "n_layers": cfg.n_layers,
          "n_params": sum(p.numel() for p in optim.tree_leaves(meta)),
          "batch": OPT_B, "seq": OPT_S, "budget": 0.3, "k": OPT_K,
          "steps": OPT_STEPS, "legs": legs,
          "dense_adamw_memory_report": optim_lib.memory_report(
              optim_lib.OptimSpec(), meta),
          "svd_refresh_ms_6144x24576_rank8": refresh_ms,
          "launches_per_step": per_step})
    return launches


# ---------------------------------------------------------------------------
# the Run façade
# ---------------------------------------------------------------------------

class StepClock:
    """Wraps Run.fit's dataset: each ``batch_at`` (the start of a step)
    follows a synchronize and notes the host clock, so ``step_ms`` gives
    each step's wall time, the last one ended by ``step_ms`` itself."""

    def __init__(self, ds):
        self.ds, self.n_samples, self.marks = ds, ds.n_samples, []

    def batch_at(self, step, batch_size):
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        return self.ds.batch_at(step, batch_size)

    def step_ms(self):
        torch.cuda.synchronize()
        ends = self.marks[1:] + [time.perf_counter()]
        return [1e3 * (b - a) for a, b in zip(self.marks, ends)]


RUN_DEPTH = 6         # qwen2.5-3b, depth 36 -> 6 (36 until the model-axis
                      # slice, 12 until the analysis one)


def phase_run():
    """The façade at published width, depth cut to RUN_DEPTH:
    Run(RunSpec(qwen2.5-3b, reduced=False)) with the adaptive phase's
    policy and its config's depth cut before init, Run.fit, Run.report,
    Run.generate and Run.serve (a ServeSpec cut alike) each against the
    solo route at their shapes."""
    _, policy, ctrl = mlp_policies()
    spec = RunSpec(arch="qwen2.5-3b", reduced=False, policy=policy,
                   steps=RUN_STEPS, batch_size=RUN_BATCH, lr=1e-4, warmup=2,
                   data=DataSpec(seq_len=RUN_SEQ, n_samples=RUN_SAMPLES))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = Run(spec)
    run.cfg = dataclasses.replace(run.cfg, n_layers=RUN_DEPTH)
    run.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = run.cfg
    if (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) != \
            (RUN_DEPTH, 2048, 11008, 151936):
        fail(f"run: not the published qwen2.5-3b: {cfg}")
    n_params = sum(p.numel() for p in optim.tree_leaves(run.state["params"]))
    clock = StepClock(run.dataset)
    reset_launches()
    run.fit(dataset=clock, log_every=1)
    step_ms = clock.step_ms()
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    by_route = expect_route("run", "fused_sampled_dw", "wgmma")
    traj = run.schedule_state.trajectory
    per_step = [launches_per_step(cfg, resolved_policy(policy, traj, i),
                                  RUN_SEQ) for i in range(RUN_STEPS)]
    expect_launches("run", {name: sum(p[name] for p in per_step)
                            for name in per_step[0]})
    losses = [h["loss"] for h in run.history]
    if not all(math.isfinite(x) for x in losses):
        fail(f"run: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        fail(f"run: loss did not fall: {losses}")
    if len(run.step_fn.compiled) > run.step_fn.replans + 1:
        fail(f"run: {len(run.step_fn.compiled)} step functions for "
             f"{run.step_fn.replans} re-plans")
    # every k the fit ran at was held against the plain versions in the
    # kernels phase
    rule_cfg, checked = policy.rules.rules[0].config, run_budget_ks()
    for rec in traj:
        if not ctrl.b_min <= rec["budget"] <= ctrl.b_max:
            fail(f"run: pinned budget {rec['budget']} outside "
                 f"[{ctrl.b_min}, {ctrl.b_max}]")
        k = rule_cfg.with_budget(rec["budget"]).budget_rows(RUN_SEQ)
        if k not in checked:
            fail(f"run: budget {rec['budget']} gives k = {k}, not among "
                 f"the kernels phase's {checked}")
    report = run.report()
    print(report, flush=True)

    # Run.generate: decode steps only (s = 1 a linear: exact, no kernel)
    prompts = data.SyntheticLM(cfg.vocab_size, GEN_PROMPT, GEN_ROWS,
                               seed=5).batch(np.arange(GEN_ROWS))["tokens"]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run.generate(prompts, GEN_NEW)
    torch.cuda.synchronize()
    gen_ms = 1e3 * (time.perf_counter() - t0)
    expect_launches("run generate", {})
    want, _ = solo_generate(cfg, run.state["params"], prompts, GEN_NEW,
                            spec.prefill_chunk, GEN_PROMPT + GEN_NEW)
    if got.tolist() != want:
        at = [first_difference(a, b) for a, b in zip(got.tolist(), want)]
        fail(f"run: Run.generate differs from the solo route at its "
             f"shapes, first at positions {at} (per row)")

    # Run.serve: the slot pool on the trained parameters
    corpus = data.SyntheticLM(cfg.vocab_size, 128, len(RUN_SERVE),
                              seed=6).batch(np.arange(len(RUN_SERVE)))
    reqs = [(list(corpus["tokens"][i, :n]), g)
            for i, (n, g) in enumerate(RUN_SERVE)]
    reset_launches()
    t0 = time.perf_counter()
    with run.serve(CutServeSpec(
            arch=spec.arch, reduced=False, policy=run.policy,
            prefill_chunk=spec.prefill_chunk, device="cuda", max_slots=4,
            page_size=16, max_len=128, n_layers=RUN_DEPTH)).start() as sess:
        handles = [sess.submit(p, max_new=g) for p, g in reqs]
        served = [h.result(timeout=600) for h in handles]
        serve_s = time.perf_counter() - t0
        stats, serve_report = sess.stats, sess.report()
    expect_launches("run serve", {})
    for i, ((p, g), toks) in enumerate(zip(reqs, served)):
        (solo,), _ = solo_generate(cfg, run.state["params"], [p], g,
                                   sess.spec.prefill_chunk,
                                   sess.spec.slot_len, sess.spec.max_slots)
        if solo != toks:
            fail(f"run: Run.serve request {i} (prompt {len(p)}) differs from "
                 f"the solo route at the pool's shapes, first at position "
                 f"{first_difference(solo, toks)}")
    emit({"phase": "run", "arch": cfg.name, "n_layers": cfg.n_layers,
          "n_params": n_params, "batch": RUN_BATCH, "seq": RUN_SEQ,
          "samples": RUN_SAMPLES, "steps": RUN_STEPS, "init_s": init_s,
          "losses": losses, "step_ms": step_ms,
          "step_ms_median_after_first": statistics.median(step_ms[1:]),
          "peak_bytes": peak, "replans": run.step_fn.replans,
          "compiled": len(run.step_fn.compiled), "trajectory": traj,
          "launches": launches, "launches_per_step": per_step[-1],
          "fused_sampled_dw_launches_by_route": by_route, "report": report,
          "generate": {"rows": GEN_ROWS, "prompt_len": GEN_PROMPT,
                       "new_tokens": GEN_NEW, "ms": gen_ms,
                       "ms_per_decode_step": gen_ms / (GEN_PROMPT - 1
                                                       + GEN_NEW),
                       "equal_to_solo_route": True},
          "serve": {"requests": RUN_SERVE, "wall_s": serve_s,
                    "decode_steps": stats["decode_steps"],
                    "prefill_chunks": stats["prefill_chunks"],
                    "equal_to_solo_route": len(reqs),
                    "report": serve_report}})
    del run, sess, got, want
    torch.cuda.empty_cache()
    return launches, by_route


def bits(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def state_differences(a, b):
    """Names of the parts of two train states that are not bit-equal."""
    out = [name for name in ("step", "base_seed") if a[name] != b[name]]
    if a["opt"].count != b["opt"].count:
        out.append("opt/count")
    for name, x, y in (("params", a["params"], b["params"]),
                       ("opt/m", a["opt"].m, b["opt"].m),
                       ("opt/v", a["opt"].v, b["opt"].v),
                       ("znorm", a.get("znorm", {}), b.get("znorm", {})),
                       ("budget_stats", a.get("budget_stats", {}),
                        b.get("budget_stats", {}))):
        lx, ly = optim.tree_leaves(x), optim.tree_leaves(y)
        if len(lx) != len(ly) or not all(
                torch.equal(bits(p), bits(q)) for p, q in zip(lx, ly)):
            out.append(name)
    return out


def resume_child(work):
    """Kill and resume on the card, bit-faithful (run in a child process
    with CUBLAS_WORKSPACE_CONFIG set and deterministic algorithms on):
    the reduced qwen2.5-3b under the adaptive policy, 6 uninterrupted
    steps against 3 steps, a checkpoint (blocking, then asynchronous, the
    killed run going on after it), Run.restore and the last 3 steps; and
    Run.fit against the hand-wired scheduled step.  The controller's
    warmup is 1, so its far plateau lies within the 6 steps."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _, policy, _ = mlp_policies(
        ESSProportional(b_min=0.1, b_max=0.6, levels=6, warmup=1))
    base = dict(arch="qwen2.5-3b", reduced=True, policy=policy, steps=6,
                batch_size=4, lr=1e-3, warmup=2,
                data=DataSpec(seq_len=64, n_samples=16))
    reset_launches()
    ref = Run(RunSpec(**base))
    ref.fit()
    launches = launch_counts()
    for name in ("row_norms", "gather_scale", "fused_sampled_dw"):
        if launches[name] == 0:
            fail(f"resume: {name} never launched: {launches}")
    moved = [r for r in ref.schedule_state.trajectory
             if r["prev"] is not None]
    if not moved:
        fail("resume: the controller never moved; the check is vacuous")
    losses = [h["loss"] for h in ref.history]

    spec, cfg = ref.spec, ref.cfg
    state = train_steps.init_train_state(
        cfg, spec.seed, znorm_tags=ref.tags, n_dataset=spec.data.n_samples,
        budget_stats=True)
    step = train_steps.make_scheduled_train_step(
        cfg, policy, spec.optimizer, spec.make_lr_schedule(),
        use_znorm_cache=True)
    hand = []
    for i in range(spec.steps):
        state, m = step(state, ref.dataset.batch_at(i, spec.batch_size))
        hand.append(float(m["loss"]))
    if hand != losses:
        fail(f"resume: Run.fit losses {losses} != hand-wired {hand}")
    del state, step

    saves = {}
    for block in (True, False):
        ck_spec = RunSpec(**base, checkpoint_dir=os.path.join(
            work, f"block_{block}"))
        killed = Run(ck_spec)
        killed.fit(steps=3)
        killed.save(block=block)
        killed.fit(steps=4)     # the run goes on past its checkpoint
        del killed
        step_dir = os.path.join(ck_spec.checkpoint_dir, "step_0000000003")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
        back = Run.restore(ck_spec, step=3)
        back.fit()
        diff = state_differences(ref.state, back.state)
        if diff:
            fail(f"resume (block={block}): not bit-equal in {diff}")
        if back.history != ref.history:
            fail(f"resume (block={block}): history differs")
        if back.schedule_state.trajectory != ref.schedule_state.trajectory:
            fail(f"resume (block={block}): trajectory "
                 f"{back.schedule_state.trajectory} != "
                 f"{ref.schedule_state.trajectory}")
        saves["blocking" if block else "async"] = {
            "checkpoint_bytes": nbytes, "bit_equal": True}
    emit({"losses": losses, "hand_wired_equal": True,
          "trajectory": ref.schedule_state.trajectory,
          "replans": ref.step_fn.replans, "launches": launches,
          "saves": saves, "deterministic": True,
          "cublas_workspace_config": os.environ.get(
              "CUBLAS_WORKSPACE_CONFIG")})


CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
getattr(chip_smoke, sys.argv[2])(*sys.argv[3:])
"""


def run_child(fn, *args, timeout):
    """``chip_smoke.<fn>(*args)`` in its own process with deterministic
    cuBLAS (deterministic algorithms are a process-wide switch, and cuBLAS
    reads its workspace setting when the CUDA context starts); returns the
    JSON object of its last line."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    done = subprocess.run([sys.executable, "-c", CHILD, here, fn, *args],
                          capture_output=True, text=True, timeout=timeout,
                          env=env)
    if done.returncode != 0:
        fail(f"{fn}: the child exited {done.returncode}: "
             f"{done.stderr.strip()[-3000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


RESUME_PROC = []


def start_resume():
    """``resume_child`` in its own process (deterministic cuBLAS), writing
    under a temporary directory in build/, in the background from the run
    phase on: a reduced model takes little of the card and one host core,
    and its checks are bit-equalities within the child, which no other
    process's work can move.  ``phase_resume`` reads its record."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="resume-", dir=os.path.join(here, "build"))
    out, err = (tempfile.TemporaryFile("w+", dir=work) for _ in range(2))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    RESUME_PROC.append((work, out, err, subprocess.Popen(
        [sys.executable, "-c", CHILD, here, "resume_child", work],
        stdout=out, stderr=err, text=True, env=env)))


def stop_resume():
    for work, out, err, proc in RESUME_PROC:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()
        shutil.rmtree(work, ignore_errors=True)


def phase_resume():
    """The record of ``resume_child``, started by ``start_resume``."""
    _, out, err, proc = RESUME_PROC[0]
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        fail("resume_child: the child did not end in 600 s")
    if proc.returncode != 0:
        err.seek(0)
        fail(f"resume_child: the child exited {proc.returncode}: "
             f"{err.read().strip()[-3000:]}")
    out.seek(0)
    rec = json.loads(out.read().strip().splitlines()[-1])
    emit({"phase": "resume", "arch": "qwen2.5-3b (reduced)", **rec,
          "wait_s": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# serving phases
# ---------------------------------------------------------------------------

def device_busy(fn, n):
    """``n`` calls of ``fn`` under torch.profiler tracing the card only:
    host wall time a call while traced (tracing slows the host), device
    time a call summed over the kernels and copies the trace holds, and
    their count a call.  The trace's raw events are summed as they come
    (building the profiler's per-event Python objects costs ≈0.3 ms an
    event: minutes at the million device ops of an xlstm-125m step)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    cuda = torch.autograd.DeviceType.CUDA
    by_name, total, count = {}, 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            ns = e.duration_ns()
            by_name[e.name()] = by_name.get(e.name(), 0) + ns
            total += ns
            count += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"traced_calls": n, "wall_ms_per_call_traced": wall / n,
            "device_busy_ms_per_call": total / 1e6 / n,
            "device_ops_per_call": count / n,
            "top_ms_per_call": [[name[:80], t / 1e6 / n] for name, t in top]}


def on_card(prompt):
    """A prompt (``tokens`` and, for a VLM, ``patches`` and
    ``positions3``; numpy or tensors) as tensors on the card."""
    return {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                ).cuda() for n, x in prompt.items()}


def prompt_rows(prompt, rows):
    """The sequences ``rows`` (a slice) of a prompt: ``positions3``
    (3, B, S) holds its batch on dim 1."""
    return {n: x[:, rows] if n == "positions3" else x[rows]
            for n, x in prompt.items()}


def prompt_len(prompt):
    """Positions a prompt fills: a VLM's patches and text together."""
    if "positions3" in prompt:
        return prompt["positions3"].shape[-1]
    return prompt["tokens"].shape[1]


@contextlib.contextmanager
def eager_attention():
    """The model's attention through its eager blockwise path on the card
    (``flash_attention.train_route`` refusing every call), whatever the
    dtype: the kernels' Function tiles by 128 keys whatever the block size,
    so a floor of bf16 roundings needs the eager path's block sizes, and
    the tensor-op reference of the kernels phase needs the eager path.
    ``models/attention.py::flash_attention`` looks ``train_route`` up on
    the module at every call (held by ``tests/test_torch_flash_train.py``'s
    ``test_flash_attention_reads_train_route_at_call``)."""
    route = flash_mod.train_route
    flash_mod.train_route = lambda *args, **kwargs: False
    try:
        yield
    finally:
        flash_mod.train_route = route


def forward_logits(cfg, params, batch, positions, flash_block,
                   per_row=False):
    """The model's own forward (tensor-op flash, p rounded to bf16) of
    ``batch`` (a prompt on the card) at ``positions``, with the given
    attention block size (``eager_attention``: on the card too, the
    attention runs the eager blockwise path, whose block size sets its
    order of roundings); ``per_row``: each sequence through the forward
    alone (batch 1), so every product runs at other shapes and rounds in
    another order."""
    if per_row:
        return torch.cat([forward_logits(cfg, params,
                                         prompt_rows(batch, slice(i, i + 1)),
                                         positions, flash_block)
                          for i in range(batch["tokens"].shape[0])])
    with torch.no_grad(), eager_attention():
        full, _ = registry.forward(cfg, params, batch,
                                   cm.Policy(flash_block=flash_block))
        out = full[:, positions].clone()
        del full
    return out


def close_to_forward(what, got, forward_a, forward_b, tol, *more,
                     hold=True):
    """Hold ``got`` against the forward at the reference's tolerance, or,
    where bf16 at this width does not reach it even between two block
    sizes of the forward itself (``forward_a`` vs ``forward_b``: the same
    function, another order of bf16 roundings; ``more``: other such
    evaluations, the largest distance counts), at 1.5x that measured
    floor.  Returns (max_abs_err, floor, the atol used); ``hold=False``
    only measures."""
    floor = max(float((f.double() - forward_a.double()).abs().max())
                for f in (forward_b, *more))
    atol = max(tol, 1.5 * floor)
    if not hold:
        return float((got.double() - forward_a.double()).abs().max()), \
            floor, atol
    return check_close(what, got, forward_a, tol, atol), floor, atol


def pad_kv(states, extra):
    """(R, B, S, KVH, Dh) caches -> (R, B, S + extra, KVH, Dh); recurrent
    states (no "k"/"v") as they are."""
    return tuple({n: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, extra))
                  if n in ("k", "v") else x for n, x in st.items()}
                 for st in states)


def recurrent(cfg):
    return any(b in ("mamba", "mlstm", "slstm") for b in cfg.pattern)


def teacher_forced(cfg, prompt, fed):
    """The prompt (its (b, s) tokens; a VLM's patches ahead of them) and
    the ``fed`` (b,) tokens as one sequence on the card, and the positions
    it fills.  A VLM's M-RoPE positions run on along all three streams,
    as decode's do.  A recurrent layer's forward takes whole chunks of 256
    positions (as the reference's): the sequence is filled up with token 0
    after the fed ones, which a causal forward does not let the checked
    positions see."""
    batch = on_card(prompt)
    seq = torch.cat([batch["tokens"].to(torch.int32),
                     torch.stack(fed, dim=1)], dim=1)
    total = prompt_len(prompt) + len(fed)
    if recurrent(cfg):
        total = -(-total // 256) * 256
        seq = torch.nn.functional.pad(seq, (0, total - seq.shape[1]))
    batch["tokens"] = seq
    if "positions3" in batch:
        b = seq.shape[0]
        batch["positions3"] = torch.arange(
            total, dtype=torch.int32, device="cuda").expand(3, b, total)
    return batch, total


def attention_layers(cfg):
    """Layers that run attention (dense, MoE or a use of the shared
    block): one flash launch each a prefill."""
    return sum(cfg.pattern[i % len(cfg.pattern)] in ("attn", "attn_moe",
                                                     "shared_attn")
               for i in range(cfg.n_layers))


def phase_serve_parity():
    """The kernel inside the serving path: one prefill_step and 4
    serve_steps of the reduced qwen2.5-3b in f32, card (kernel) against
    CPU (plain version), same parameters and prompts."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b", reduced=True),
                              compute_dtype="float32")
    start = registry.init_params(cfg, 0, device="cpu")
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    nxt = rng.randint(0, cfg.vocab_size, (4, 2)).astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        params = optim.tree_map(lambda t: t.to(dev, copy=True), start)
        prefill = train_steps.make_prefill_step(cfg, cm.Policy(), device=dev)
        serve = train_steps.make_serve_step(cfg, cm.Policy(), device=dev)
        reset_launches()
        last, states = prefill(params, {"tokens": prompts})
        expect_launches(f"serve_parity prefill on {dev}", {
            "row_norms": 0, "fused_sampled_dw": 0,
            "flash_attention_fwd": cfg.n_layers if dev == "cuda" else 0})
        states = pad_kv(states, 4)
        logits = []
        for t in range(4):
            _, lg, states = serve(params, nxt[t], 40 + t, states)
            logits.append(lg)
        out[dev] = [last, *logits] + [x for st in states for x in st.values()]
    # f32 on both sides; card and CPU differ in summation order only
    errs = [check_close(f"serve_parity tensor {i}", a, b, 1e-4, 1e-4)
            for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"]))]
    emit({"phase": "serve_parity", "max_abs_err_last_logits": errs[0],
          "max_abs_err_decode_logits": max(errs[1:5]),
          "max_abs_err_kv_states": max(errs[5:]),
          "tol": {"rtol": 1e-4, "atol": 1e-4}})


def phase_prefill(cfg, params, batch, seq, name="prefill", hold=True,
                  prompt=None):
    """make_prefill_step on the full model: warm-up + 3 timed calls, one
    flash launch an attention layer, on the route its heads take.  An MoE
    or recurrent model's floor also takes the forward row by row
    (``per_row``): a router logit rounded to bf16 in another order can flip
    a token's top-k experts, and the recurrent layers carry the GEMMs'
    shape-dependent bf16 roundings through every position; the prefill's
    products differ from the forward's in those ways too.  ``prompt``: the
    batch of ``seq`` positions (default ``SyntheticLM`` tokens; a VLM's
    carries its patches and positions3).  ``hold=False``: the distance is
    measured only.  Returns (launches, routes), the prompt, the last
    logits and the states."""
    prefill = train_steps.make_prefill_step(cfg, cm.Policy())
    if prompt is None:
        prompt = {"tokens": data.SyntheticLM(
            cfg.vocab_size, seq, batch, seed=0).batch_at(0, batch)["tokens"]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        last, states = prefill(params, prompt)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    n_attn = attention_layers(cfg)
    launches = expect_launches(name, {
        "row_norms": 0, "fused_sampled_dw": 0,
        "flash_attention_fwd": 4 * n_attn})
    route = flash_mod.flash_route(cfg.head_dim, cfg.cdtype, True)
    by_route = (expect_route(name, "flash_attention_fwd", route)
                if n_attn else {})
    if not bool(torch.isfinite(last.float()).all()):
        fail(f"{name}: non-finite last logits")
    trace = device_busy(lambda: prefill(params, prompt), 1)
    tt = on_card(prompt)
    # bf16: the kernel rounds p to bf16 as the forward's tensor-op flash
    # does, under running maxima over other blocks (128 keys against 512).
    # The reference holds prefill to its forward at
    # 3e-2 (vocab 256, 2 layers); at vocab 151936 the forward differs from
    # itself under another block size by more than that, so the floor is
    # measured beside it (close_to_forward)
    more = ([forward_logits(cfg, params, tt, -1, 512, per_row=True)]
            if cfg.n_experts or recurrent(cfg) else [])
    err, floor, atol = close_to_forward(
        f"{name} last logits vs forward", last,
        forward_logits(cfg, params, tt, -1, 512),
        forward_logits(cfg, params, tt, -1, 256), 3e-2, *more, hold=hold)
    ms = statistics.median(times[1:])
    emit({"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
          "batch": batch, "seq": seq, "prefill_ms": times,
          "prefill_ms_median_after_first": ms,
          "prompt_tokens_per_s": batch * seq / (ms / 1e3),
          "peak_bytes": peak, "launches": launches,
          "flash_launches_by_route": by_route,
          "flash_launches_per_call": n_attn,
          "max_abs_err_vs_forward": err,
          "forward_vs_itself_other_block": floor, "atol_used": atol,
          "held": hold, "profile": trace})
    return (launches, by_route), prompt, last, states


def phase_decode(cfg, params, prompt, last, states, n_gen=64, n_check=8,
                 name="decode", forward_cfg=None, hold=True):
    """``n_gen`` greedy serve_steps from the prefill's states (padded), the
    first ``n_check`` positions held against a teacher-forced forward (of
    ``forward_cfg``, default ``cfg``; ``hold=False``: only measured).  A
    VLM decodes on after its patches and text, ``pos`` on all three
    M-RoPE streams."""
    b, s = prompt["tokens"].shape[0], prompt_len(prompt)
    serve = train_steps.make_serve_step(cfg, cm.Policy())
    n_traced = 3
    states = pad_kv(states, n_gen + n_traced)
    tok = torch.argmax(last, dim=-1).to(torch.int32)
    fed, checked, times = [tok], [], []
    reset_launches()
    for g in range(n_gen):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, logits, states = serve(params, tok, s + g, states)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        if not bool(torch.isfinite(logits.float()).all()):
            fail(f"{name}: non-finite logits at step {g}")
        if g < n_check:
            checked.append(logits)
        fed.append(tok)
    traced = iter(range(s + n_gen, s + n_gen + n_traced))
    trace = device_busy(lambda: serve(params, tok, next(traced), states),
                        n_traced)
    launches = expect_launches(name, {
        "row_norms": 0, "fused_sampled_dw": 0, "flash_attention_fwd": 0})
    seq, total = teacher_forced(cfg, prompt, fed[:n_check])
    # the forward's tensor-op flash needs blocks that tile S + 8 = 8 * 257;
    # 5e-2 is the reference's decode-vs-forward tolerance, held as in the
    # prefill phase against the forward's own floor at this width
    pos = slice(s, s + n_check)
    fcfg = cfg if forward_cfg is None else forward_cfg
    # an MoE or recurrent model's floor also takes the forward row by row
    # (as prefill)
    more = ([forward_logits(fcfg, params, seq, pos, total // 8,
                            per_row=True)]
            if cfg.n_experts or recurrent(cfg) else [])
    err, floor, atol = close_to_forward(
        f"{name} logits vs teacher-forced forward",
        torch.stack(checked, dim=1),
        forward_logits(fcfg, params, seq, pos, total // 8),
        forward_logits(fcfg, params, seq, pos, total // 4), 5e-2,
        *more, hold=hold)
    ms = statistics.median(times)
    emit({"phase": name, "batch": b, "kv_len": s + n_gen + n_traced,
          "steps": n_gen, "step_ms_median": ms, "step_ms": times,
          "decode_tokens_per_s": b / (ms / 1e3), "launches": launches,
          "max_abs_err_vs_forward": err,
          "forward_vs_itself_other_block": floor, "atol_used": atol,
          "held": hold, "checked_positions": n_check, "profile": trace})


def solo_generate(cfg, params, prompts, gen, chunk, cache_len, rows=None):
    """The solo greedy route (the reference's Run.generate composition),
    written out apart from the façade and the pool: the (b, S) ``prompts``
    prefilled at batch b into a ``cache_len`` cache, ``chunk`` tokens a
    make_prefill_chunk_step call, then decoded at ``rows`` (default b) rows
    with the prompts in the first b.  Run.generate's shapes: rows = b,
    cache_len = S + gen; the pool's: b = 1, cache_len = slot_len,
    rows = max_slots.  Returns the (b, gen) tokens as lists and, per step,
    the gap between the two largest logits of row 0."""
    prompts = np.asarray(prompts, np.int64)
    b, s = prompts.shape
    rows = b if rows is None else rows
    policy = cm.Policy()
    states = registry.decode_state_init(cfg, b, cache_len)
    t = 0
    while t < s - 1:
        n = min(chunk, s - 1 - t)
        states = train_steps.make_prefill_chunk_step(cfg, policy, n)(
            params, prompts[:, t:t + n], t, states)
        t += n
    states = tuple({n: torch.cat([x, x.new_zeros(
        (x.shape[0], rows - b) + x.shape[2:])], dim=1)
        for n, x in st.items()} for st in states)
    serve = train_steps.make_serve_step(cfg, policy)
    tok = np.zeros(rows, np.int64)
    tok[:b] = prompts[:, -1]
    pos = np.zeros(rows, np.int64)
    out, gaps = [], []
    for g in range(gen):
        pos[:b] = s - 1 + g
        _, logits, states = serve(params, tok, pos, states)
        top2 = torch.topk(logits[0].float(), 2).values
        gaps.append(float(top2[0] - top2[1]))
        nxt = torch.argmax(logits.float(), dim=-1).cpu().numpy()
        tok[:b] = nxt[:b]
        out.append(nxt[:b])
    return np.stack(out, axis=1).tolist(), gaps


def first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


# (prompt length, max_new) of the pool load: 12 greedy, 2 sampled
POOL_GREEDY = [(1, 8), (5, 64), (17, 16), (32, 40), (33, 8), (64, 24),
               (100, 64), (128, 12), (9, 33), (48, 50), (77, 20), (120, 8)]
POOL_SAMPLED = [(20, 32), (90, 24)]
# the pool phase's depth: its three-way comparison (the load, each request
# alone, the solo route) is decode-bound on the host, ≈ 6 s a layer (36
# -> 12 -> 8 -> 2 to keep the script within half its time limit)
POOL_DEPTH = 2


@dataclasses.dataclass(frozen=True)
class CutServeSpec(ServeSpec):
    """A ServeSpec of the published arch cut to ``n_layers`` layers
    (ServeSpec itself serves whole configs)."""
    n_layers: int = 0

    @property
    def config(self):
        return dataclasses.replace(super().config, n_layers=self.n_layers)


def phase_pool(cfg, params):
    """The slot-pool server on ``cfg`` (qwen2.5-3b at published width,
    its depth cut to POOL_DEPTH) and the first layers of ``params``."""
    params = dict(params, layers=params["layers"][:cfg.n_layers])
    spec = CutServeSpec(arch="qwen2.5-3b", reduced=False, max_slots=8,
                        page_size=16, max_len=256, prefill_chunk=32,
                        top_k=50, device="cuda", n_layers=cfg.n_layers)
    corpus = data.SyntheticLM(cfg.vocab_size, 128,
                              len(POOL_GREEDY) + len(POOL_SAMPLED),
                              seed=3).batch(np.arange(14))["tokens"]
    greedy = [(list(corpus[i, :n]), g)
              for i, (n, g) in enumerate(POOL_GREEDY)]
    sampled = [(list(corpus[len(greedy) + i, :n]), g, 100 + i)
               for i, (n, g) in enumerate(POOL_SAMPLED)]
    reset_launches()
    with ServeSession(spec, params).start() as sess:
        t0 = time.perf_counter()
        hg = [sess.submit(p, max_new=g) for p, g in greedy]
        hs = [sess.submit(p, max_new=g, temperature=0.8, seed=7, uid=u)
              for p, g, u in sampled]
        got_g = [h.result(timeout=900) for h in hg]
        got_s = [h.result(timeout=900) for h in hs]
        wall = time.perf_counter() - t0
        stats, report = sess.stats, sess.report()
    launches = expect_launches("pool", {
        "row_norms": 0, "fused_sampled_dw": 0, "flash_attention_fwd": 0})
    for (p, g), toks in zip(greedy, got_g):
        if len(toks) != g:
            fail(f"pool: a request of {len(p)} prompt tokens got "
                 f"{len(toks)} of {g} tokens")

    # each greedy request alone through a pool of the same spec: bit-equal
    for i, ((p, g), toks) in enumerate(zip(greedy, got_g)):
        alone = ServeSession(spec, params)
        h = alone.submit(p, max_new=g)
        alone.run_until_idle()
        if h.result(timeout=0) != toks:
            fail(f"pool: greedy request {i} (prompt {len(p)}) differs from "
                 f"the same request served alone, first at position "
                 f"{first_difference(h.result(timeout=0), toks)}")
    # the sampled requests again, without the greedy load around them
    again = ServeSession(spec, params)
    hs2 = [again.submit(p, max_new=g, temperature=0.8, seed=7, uid=u)
           for p, g, u in sampled]
    again.run_until_idle()
    if [h.result(timeout=0) for h in hs2] != got_s:
        fail("pool: the sampled requests gave other tokens on a second run")
    # the solo route at the pool's shapes, counted (not asserted)
    solo_agree, solo_diff = 0, []
    for i, ((p, g), toks) in enumerate(zip(greedy, got_g)):
        (solo,), gaps = solo_generate(cfg, params, [p], g, spec.prefill_chunk,
                                      spec.slot_len, spec.max_slots)
        at = first_difference(solo, toks)
        if at is None:
            solo_agree += 1
        else:
            solo_diff.append({"request": i, "prompt_len": len(p),
                              "first_diverging_position": at,
                              "solo_top2_logit_gap": gaps[at]})
    launches_total = launch_counts()
    emit({"phase": "pool", "arch": cfg.name, "n_layers": cfg.n_layers,
          "spec": {"max_slots": spec.max_slots, "page_size": spec.page_size,
                   "max_len": spec.max_len,
                   "prefill_chunk": spec.prefill_chunk, "top_k": spec.top_k},
          "requests": len(greedy) + len(sampled), "wall_s": wall,
          "tokens_per_s": stats["tokens_generated"] / wall,
          "decode_steps": stats["decode_steps"],
          "prefill_chunks": stats["prefill_chunks"],
          "occupancy": stats["occupancy"], "stats": stats,
          "pool_bytes": pool_lib.pool_bytes(cfg, spec),
          "launches": launches, "greedy_equal_to_alone": len(greedy),
          "sampled_repeatable": len(sampled),
          "solo_route_agree": solo_agree, "solo_route_total": len(greedy),
          "solo_route_differences": solo_diff, "report": report})
    if launches_total != launches:
        fail(f"pool: the comparison runs launched kernels: "
             f"{launches_total}")


def phase_wide_serve():
    """command-r-35b at published width, depth cut to 4: a 2 x 2048-token
    prefill through the flash kernel at 64/8 heads and 16 decode steps,
    each against the model's own forward.  Returns the prefill's
    launches."""
    cfg = dataclasses.replace(get_config("command-r-35b"), n_layers=4)
    if (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.vocab_size, cfg.tie_embeddings) != (8192, 22528, 64, 8, 128,
                                                    256000, True):
        fail(f"wide_serve: not the published command-r-35b: {cfg}")
    params = registry.init_params(cfg, 0)
    (launches, _), *prefilled = phase_prefill(cfg, params, 2, 2048,
                                              name="wide_serve_prefill")
    phase_decode(cfg, params, *prefilled, n_gen=16,
                 name="wide_serve_decode")
    del params, prefilled
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# MoE phases
# ---------------------------------------------------------------------------

def published(what, cfg, want):
    """Fail unless ``cfg`` has the published widths ``want``."""
    got = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
           cfg.n_experts, cfg.moe_top_k, cfg.d_ff, cfg.vocab_size,
           cfg.tie_embeddings, cfg.capacity_factor)
    if got != want:
        fail(f"{what}: not the published {cfg.name}: {got} != {want}")


def no_drop(cfg):
    """``cfg`` at capacity factor E / top-k: every expert has a slot for
    every token, so no entry drops — what decode (capacity = the batch)
    always has.  The forward that decode is held against."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.moe_top_k)


def moe_aux(cfg, params, batch):
    """Exact forward of ``batch``: each layer's drop_frac and lb_loss (a
    walk of ``lm.apply_block``), the loss, its ce part and its lb_loss."""
    tb = train_steps._to_device(batch, params["embed"].device)
    ctx = cm.Ctx(policy=cm.Policy(), compute_dtype=cfg.cdtype)
    with torch.no_grad():
        h, positions = lm.embed_inputs(cfg, params, tb, ctx)
        drops, lbs = [], []
        for i, layer in enumerate(params["layers"]):
            h, aux = lm.apply_block(cfg, "attn_moe", layer, ctx, h,
                                    positions)
            drops.append(float(aux["drop_frac"]))
            lbs.append(float(aux["lb_loss"]))
        del h
        loss, aux = registry.loss_fn(cfg, params, tb, cm.Policy())
        logits, _ = registry.forward(cfg, params, tb, cm.Policy())
        ce = torch.nn.functional.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            tb["labels"].to(torch.int64).reshape(-1))
        del logits
    return drops, lbs, float(loss), float(ce), float(aux["lb_loss"])


def decode_f32(cfg, params, prompt, n_check, name):
    """Prefill and decode against the teacher-forced forward in f32
    compute (an MoE model at capacity factor E / top-k: nothing drops, as
    in decode): a prefill of ``prompt`` (the flash kernel's f32 route),
    ``n_check`` greedy serve_steps, the forward over prompt and fed tokens
    (filled up to whole chunks of 256 for a recurrent model), the
    prefill's last logits and every decode step's held at the reference's
    decode tolerance 5e-2.  In bf16 the comparison is ill-posed for these
    models at random weights: for an MoE model a router logit rounded in
    another order flips a token's top-k, and at the reference's expert
    initialisation (std 1/sqrt(E), ROADMAP Queue C) one flipped expert
    moves the logits by several units; a recurrent model carries the
    bf16 roundings of the card's GEMMs, which differ with the number of
    rows, through every later position and layer (ROADMAP Queue C).  In
    f32 neither is left at that size."""
    cfg32 = dataclasses.replace(no_drop(cfg) if cfg.n_experts else cfg,
                                compute_dtype="float32")
    b, s = prompt["tokens"].shape[0], prompt_len(prompt)
    dev = params["embed"].device
    last, states = train_steps.make_prefill_step(
        cfg32, cm.Policy(), device=dev)(params, prompt)
    states = pad_kv(states, n_check)
    serve = train_steps.make_serve_step(cfg32, cm.Policy(), device=dev)
    tok = torch.argmax(last, dim=-1).to(torch.int32)
    fed, got = [tok], [last]
    for g in range(n_check):
        tok, logits, states = serve(params, tok, s + g, states)
        got.append(logits)
        fed.append(tok)
    del states
    seq, total = teacher_forced(cfg, prompt, fed[:n_check])
    want = forward_logits(cfg32, params, seq, slice(s - 1, s + n_check),
                          total // 8)
    err = check_close(f"{name}: f32 prefill + decode vs teacher-forced "
                      f"forward", torch.stack(got, dim=1), want, 5e-2, 5e-2)
    torch.cuda.empty_cache()
    return {"phase": name, "batch": b, "prompt": s,
            "checked_positions": n_check, "compute_dtype": "float32",
            "capacity_factor": cfg32.capacity_factor,
            "max_abs_err_vs_forward": err,
            "tol": {"rtol": 5e-2, "atol": 5e-2}}


def pool_requests(cfg, params, what, depth=None):
    """``MOE_SERVE``'s greedy requests through a 4-slot pool of ``cfg``'s
    arch at ``cfg``'s depth, or cut to its first ``depth`` layers: each
    bit-equal to itself served alone through a pool of the same spec and
    to the solo route at the pool's shapes."""
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
        params = dict(params, layers=params["layers"][:depth])
    spec = CutServeSpec(arch=cfg.name, reduced=False, max_slots=4,
                        page_size=16, max_len=128, prefill_chunk=16,
                        device="cuda", n_layers=cfg.n_layers)
    corpus = data.SyntheticLM(cfg.vocab_size, 64, len(MOE_SERVE),
                              seed=4).batch(np.arange(len(MOE_SERVE)))[
                                  "tokens"]
    reqs = [(list(corpus[i, :n]), g) for i, (n, g) in enumerate(MOE_SERVE)]
    sess = ServeSession(spec, params)
    t0 = time.perf_counter()
    handles = [sess.submit(p, max_new=g) for p, g in reqs]
    sess.run_until_idle()
    wall = time.perf_counter() - t0
    got = [h.result(timeout=0) for h in handles]
    for i, ((p, g), toks) in enumerate(zip(reqs, got)):
        alone = ServeSession(spec, params)
        h = alone.submit(p, max_new=g)
        alone.run_until_idle()
        if h.result(timeout=0) != toks:
            fail(f"{what}: request {i} differs from itself served alone, "
                 f"first at {first_difference(h.result(timeout=0), toks)}")
        (solo,), _ = solo_generate(cfg, params, [p], g, spec.prefill_chunk,
                                   spec.slot_len, spec.max_slots)
        if solo != toks:
            fail(f"{what}: request {i} differs from the solo route at the "
                 f"pool's shapes, first at {first_difference(solo, toks)}")
    return {"n_layers": cfg.n_layers, "requests": len(reqs), "wall_s": wall,
            "tokens_per_s": sess.stats["tokens_generated"] / wall,
            "equal_to_alone_and_solo": len(reqs)}


def moe_remat_child():
    """granite-moe-1b-a400m of the moe phase, 2 WTA-CRS steps from fresh
    parameters under remat "none" and "wtacrs_names" (run in a child
    process with CUBLAS_WORKSPACE_CONFIG set and deterministic algorithms
    on): the losses bit-equal — step 2's loss reads step 1's gradients, so
    the load-balancing loss and the router's gradient through it survived
    the remat — launches as ``launches_per_step`` implies, the peaks."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_DEPTH)
    ds = data.SyntheticLM(cfg.vocab_size, MOE_S, MOE_B, seed=0)
    legs = {}
    for remat in ("none", "wtacrs_names"):
        policy = cm.Policy(wtacrs=MOE_WTA, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        state = train_steps.init_train_state(cfg, 0)
        step = train_steps.make_train_step(
            cfg, policy, optim.AdamWConfig(),
            optim.linear_warmup_constant(1e-4, 2))
        losses = []
        for i in range(2):
            state, m = step(state, ds.batch_at(i, MOE_B))
            losses.append(float(m["loss"]))
        per_step = launches_per_step(cfg, policy, MOE_S, batch=MOE_B)
        launches = expect_launches(f"moe remat {remat}", {
            name: 2 * n for name, n in per_step.items()})
        legs[remat] = {"losses": losses,
                       "peak_bytes": torch.cuda.max_memory_allocated(),
                       "launches": launches}
        del state, step
    if legs["wtacrs_names"]["losses"] != legs["none"]["losses"]:
        fail(f"moe: remat wtacrs_names losses "
             f"{legs['wtacrs_names']['losses']} are not none's "
             f"{legs['none']['losses']} bit for bit")
    emit({"arch": cfg.name, "legs": legs, "remat_losses_bit_equal": True,
          "deterministic": True})


def phase_moe():
    """granite-moe-1b-a400m at published width, depth cut to MOE_DEPTH:
    train, exact peak, the remat child, prefill, decode, the pool.  Returns the
    train steps' and the prefill's launches."""
    cfg = get_config(MOE_ARCH)
    published("moe", cfg, (1024, 16, 8, 64, 32, 8, 512, 49155, True, 1.25))
    if cfg.n_layers != 24:
        fail(f"moe: {cfg.n_layers} layers, the published model has 24")
    cfg = dataclasses.replace(cfg, n_layers=MOE_DEPTH)
    ds = data.SyntheticLM(cfg.vocab_size, MOE_S, MOE_B, seed=0)
    policy = cm.Policy(wtacrs=MOE_WTA)
    per_step = launches_per_step(cfg, policy, MOE_S, batch=MOE_B)
    reset_launches()
    (losses, times, peak, changed, n_leaves, n_params, state,
     step) = run_steps(cfg, MOE_WTA, MOE_STEPS, MOE_B, MOE_S, ds, keep=True)
    launches = expect_launches("moe train", {
        name: n * MOE_STEPS for name, n in per_step.items()})
    by_route = expect_route("moe train", "fused_sampled_dw", "wgmma")
    gather_routes = expect_route("moe train", "gather_scale", "bulk")
    if not all(math.isfinite(x) for x in losses):
        fail(f"moe: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        fail(f"moe: loss did not fall: {losses}")
    if changed != n_leaves:
        fail(f"moe: only {changed} of {n_leaves} parameter leaves changed")
    drops, lbs, loss, ce, lb = moe_aux(cfg, state["params"],
                                       ds.batch_at(0, MOE_B))
    # the loss is the cross-entropy plus 0.01 * lb_loss / n_layers, lb_loss
    # the layers' sum (f32 sums of the same terms in another order: 1e-5)
    if not (math.isfinite(lb) and lb > 0
            and abs(lb - sum(lbs)) <= 1e-5 * lb
            and abs(loss - (ce + 0.01 * lb / cfg.n_layers)) <= 1e-5 * loss):
        fail(f"moe: lb_loss {lb} (layers {sum(lbs)}), loss {loss}, ce {ce}")
    busy = device_busy(lambda: step(state, ds.batch_at(MOE_STEPS, MOE_B)),
                       1)
    del state, step
    torch.cuda.empty_cache()
    exact_losses, exact_times, exact_peak, *_ = run_steps(
        cfg, EXACT_CONFIG, 2, MOE_B, MOE_S, ds)
    remat = run_child("moe_remat_child", timeout=600)
    emit({"phase": "moe_train", "arch": cfg.name, "n_layers": cfg.n_layers,
          "n_params": n_params, "batch": MOE_B, "seq": MOE_S, "budget": 0.3,
          "capacity": GRANITE["cap"], "k_expert": GRANITE["k"],
          "k_router": GRANITE["k_router"], "losses": losses,
          "step_ms": times,
          "step_ms_median_after_first": statistics.median(times[1:]),
          "peak_bytes": peak, "lb_loss": lb, "lb_loss_by_layer": lbs,
          "ce_loss": ce, "loss": loss, "drop_frac_by_layer": drops,
          "launches": launches, "launches_per_step": per_step,
          "fused_sampled_dw_launches_by_route": by_route,
          "gather_scale_launches_by_route": gather_routes,
          "profile": busy, "exact_losses": exact_losses,
          "exact_step_ms": exact_times, "peak_bytes_exact": exact_peak,
          "remat_child": remat})
    params = registry.init_params(cfg, 0)
    (prefill_launches, _), prompt, _, states = phase_prefill(
        cfg, params, MOE_B, 2 * MOE_S, name="moe_prefill")
    del states
    # decode dispatches at capacity = the batch and never drops: it starts
    # from a prefill, and is held against a forward, that drop nothing
    last, states = train_steps.make_prefill_step(no_drop(cfg), cm.Policy())(
        params, prompt)
    phase_decode(cfg, params, prompt, last, states, n_gen=16, n_check=16,
                 name="moe_decode", forward_cfg=no_drop(cfg), hold=False)
    del last, states
    emit(decode_f32(cfg, params, prompt, 8, "moe_decode_f32"))
    emit({"phase": "moe_pool", "arch": cfg.name,
          **pool_requests(cfg, params, "moe pool")})
    del params
    torch.cuda.empty_cache()
    return dict(launches, flash_attention_fwd=prefill_launches[
        "flash_attention_fwd"])


def phase_moe_wide():
    """dbrx-132b at published width: depth 2 prefills and decodes, depth 1
    trains under the factored OptimSpec.  Returns the train steps' and the
    prefill's launches."""
    cfg = dataclasses.replace(get_config(WIDE_ARCH), n_layers=2)
    published("moe_wide", cfg, (6144, 48, 8, 128, 16, 4, 10752, 100352,
                                False, 1.25))
    params = registry.init_params(cfg, 0)
    (prefill_launches, _), prompt, _, states = phase_prefill(
        cfg, params, 2, WIDE_S, name="moe_wide_prefill")
    del states
    last, states = train_steps.make_prefill_step(no_drop(cfg), cm.Policy())(
        params, prompt)
    phase_decode(cfg, params, prompt, last, states, n_gen=8, n_check=8,
                 name="moe_wide_decode", forward_cfg=no_drop(cfg),
                 hold=False)
    del last, states
    emit(decode_f32(cfg, params, prompt, 8, "moe_wide_decode_f32"))
    del params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(cfg, n_layers=1)
    spec = optim_specs()["factored"]
    policy = cm.Policy(wtacrs=MOE_WTA)
    per_step = launches_per_step(cfg, policy, WIDE_S, batch=WIDE_B)
    meta = registry.init_params(cfg, 0, device="meta")
    report = optim_lib.memory_report(spec, meta)
    ds = data.SyntheticLM(cfg.vocab_size, WIDE_S, WIDE_B, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = train_steps.init_train_state(cfg, 0, opt=spec)
    on_card = optim_lib.tree_bytes(state["opt"])
    if on_card != report["state_bytes"]:
        fail(f"moe_wide: {on_card} state bytes on the card, memory_report "
             f"says {report['state_bytes']}")
    step = train_steps.make_train_step(
        cfg, policy, spec, optim.linear_warmup_constant(1e-4, 2))
    reset_launches()
    losses, times = [], []
    for i in range(WIDE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, ds.batch_at(i, WIDE_B))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    launches = expect_launches("moe_wide train", {
        k: n * WIDE_STEPS for k, n in per_step.items()})
    by_route = expect_route("moe_wide train", "fused_sampled_dw", "wgmma")
    gather_routes = expect_route("moe_wide train", "gather_scale", "bulk")
    if not all(math.isfinite(x) for x in losses):
        fail(f"moe_wide: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        fail(f"moe_wide: loss did not fall: {losses}")
    del state, step
    torch.cuda.empty_cache()
    emit({"phase": "moe_wide_train", "arch": cfg.name,
          "n_layers": cfg.n_layers,
          "n_params": sum(p.numel() for p in optim.tree_leaves(meta)),
          "batch": WIDE_B, "seq": WIDE_S, "budget": 0.3, "spec": "factored",
          "capacity": DBRX["cap"], "k_expert": DBRX["k"],
          "k_router": DBRX["k_router"], "losses": losses, "step_ms": times,
          "peak_bytes": peak, "state_bytes_on_card": on_card,
          "state_bytes_memory_report": report["state_bytes"],
          "memory_report": report, "launches": launches,
          "launches_per_step": per_step,
          "fused_sampled_dw_launches_by_route": by_route,
          "gather_scale_launches_by_route": gather_routes})
    return dict(launches, flash_attention_fwd=prefill_launches[
        "flash_attention_fwd"])

def published_ssm(what, cfg, want):
    """Fail unless ``cfg`` has the published widths ``want``."""
    got = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
           cfg.vocab_size, cfg.tie_embeddings, cfg.ssm_state,
           cfg.ssm_head_dim, cfg.ssm_expand, cfg.ssm_conv, cfg.pattern)
    if got != want:
        fail(f"{what}: not the published {cfg.name}: {got} != {want}")


def full_size_train(what, cfg, b, s, n_steps, n_exact, ds=None):
    """``n_steps`` WTA-CRS 0.3 steps (every linear sampled) and
    ``n_exact`` exact ones from fresh parameters at (b, s): losses finite
    and falling, every leaf moved, launches as ``launches_per_step``
    implies with every dW on wgmma and every H' on bulk, peaks, ms a step
    (host clock around a synchronized step, the untraced ones) and the
    last WTA-CRS step's device-busy ms (traced).  ``ds``: the batches
    (default ``SyntheticLM`` tokens of ``s`` positions).  Returns (record,
    launches)."""
    if ds is None:
        ds = data.SyntheticLM(cfg.vocab_size, s, b, seed=0)
    per_step = launches_per_step(cfg, cm.Policy(wtacrs=MOE_WTA), s, batch=b)
    reset_launches()
    (losses, times, peak, changed, n_leaves, n_params,
     busy) = run_steps(cfg, MOE_WTA, n_steps, b, s, ds, trace_last=True)
    launches = expect_launches(f"{what} train", {
        name: n * n_steps for name, n in per_step.items()})
    by_route = expect_route(f"{what} train", "fused_sampled_dw", "wgmma")
    gather_routes = expect_route(f"{what} train", "gather_scale", "bulk")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{what}: loss did not fall: {losses}")
    if changed != n_leaves:
        fail(f"{what}: only {changed} of {n_leaves} parameter leaves changed")
    exact_losses, exact_times, exact_peak, *_ = run_steps(
        cfg, EXACT_CONFIG, n_exact, b, s, ds)
    ms = statistics.median(times[1:])
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "n_params": n_params,
            "batch": b, "seq": s, "budget": 0.3,
            "k": MOE_WTA.budget_rows(s), "losses": losses, "step_ms": times,
            "step_ms_median_after_first": ms, "peak_bytes": peak,
            "launches": launches, "launches_per_step": per_step,
            "fused_sampled_dw_launches_by_route": by_route,
            "gather_scale_launches_by_route": gather_routes,
            "profile": busy,
            "device_idle_share": 1.0 - busy["device_busy_ms_per_call"] / ms,
            "exact_losses": exact_losses, "exact_step_ms": exact_times,
            "peak_bytes_exact": exact_peak}, launches


def ssm_full_depth(cfg, n_steps=2):
    """The whole zamba2-2.7b (54 layers) trains on one card: ``n_steps``
    WTA-CRS steps at B=1, S=2048 under remat "full" (each layer keeps only
    its input; the recompute redraws its plans).  The peak is reckoned
    beside the measured one: f32 parameters, gradients and both Adam
    moments (16 bytes a parameter), the 54 bf16 layer inputs and one Mamba
    layer's recompute (its SSD's (B, S/256, 256, 256, H) f32 products,
    about four alive at once)."""
    policy = cm.Policy(wtacrs=MOE_WTA, remat="full")
    per_step = launches_per_step(cfg, policy, SSM_S, batch=1)
    n_params = tensor_params(cfg)
    nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    reckoned = {"state": 16 * n_params,
                "layer_inputs": cfg.n_layers * SSM_S * cfg.d_model * 2,
                "one_layer_recompute": 4 * SSM_S * 256 * nh * 4}
    ds = data.SyntheticLM(cfg.vocab_size, SSM_S, 1, seed=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = train_steps.init_train_state(cfg, 0)
    step = train_steps.make_train_step(
        cfg, policy, optim.AdamWConfig(),
        optim.linear_warmup_constant(1e-4, 2))
    reset_launches()
    losses, times = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, ds.batch_at(i, 1))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    launches = expect_launches("ssm full depth", {
        name: n * n_steps for name, n in per_step.items()})
    if not all(math.isfinite(x) for x in losses):
        fail(f"ssm full depth: non-finite loss in {losses}")
    del state, step
    torch.cuda.empty_cache()
    return {"n_layers": cfg.n_layers, "n_params": n_params, "batch": 1,
            "seq": SSM_S, "remat": "full", "losses": losses,
            "step_ms": times, "peak_bytes": peak,
            "peak_bytes_reckoned": sum(reckoned.values()),
            "reckoning": reckoned, "launches": launches}


def recurrent_serve(what, cfg, params, b, s, hold_bf16, pool_depth=None):
    """Prefill b x s prompts in bf16 (timed), 16 greedy bf16 decode steps
    from its states (timed), each against the forward, the same prefill
    and 16 decode steps in f32 held against the f32 forward, and the
    pool's 4 greedy requests (at ``pool_depth`` layers where given).
    ``hold_bf16=False``: the bf16 distances are
    measured only — zamba2's are far above the forward's own floor at
    random weights (``decode_f32``).  Returns the bf16 prefill's
    launches."""
    (launches, _), prompt, last, states = phase_prefill(
        cfg, params, b, s, name=f"{what}_prefill", hold=hold_bf16)
    phase_decode(cfg, params, prompt, last, states, n_gen=16, n_check=16,
                 name=f"{what}_decode", hold=hold_bf16)
    del last, states
    torch.cuda.empty_cache()
    emit(decode_f32(cfg, params, prompt, 16, f"{what}_decode_f32"))
    emit({"phase": f"{what}_pool", "arch": cfg.name,
          **pool_requests(cfg, params, f"{what} pool", pool_depth)})
    return launches


def phase_ssm():
    """zamba2-2.7b at published width: depth 12 trains (4 WTA-CRS, 2 exact
    steps at B=2, S=2048), full depth trains 2 steps under remat "full"
    at B=1, and full depth serves (prefill through the flash kernel's wgmma
    route at 32/32 heads of 80, decode; the pool at SERVE_POOL_DEPTH; the
    bf16 distances to the forward measured, the f32 ones held).  Returns
    the depth-12 steps' and the prefill's launches."""
    t0 = time.perf_counter()
    full = get_config(SSM_ARCH)
    published_ssm("ssm", full, (
        2560, 32, 32, 80, 10240, 32000, False, 64, 64, 2, 4,
        ("mamba",) * 5 + ("shared_attn",)))
    if full.n_layers != 54:
        fail(f"ssm: {full.n_layers} layers, the published model has 54")
    rec, launches = full_size_train(
        "ssm", dataclasses.replace(full, n_layers=SSM_DEPTH), SSM_B, SSM_S,
        SSM_STEPS, 2)
    rec["full_depth"] = ssm_full_depth(full)
    emit({"phase": "ssm_train", **rec})
    params = registry.init_params(full, 0)
    prefill = recurrent_serve("ssm", full, params, SSM_B, SSM_S,
                              hold_bf16=False, pool_depth=SERVE_POOL_DEPTH)
    del params
    torch.cuda.empty_cache()
    emit({"phase": "ssm", "seconds": time.perf_counter() - t0})
    return dict(launches, flash_attention_fwd=prefill["flash_attention_fwd"])


def phase_xlstm():
    """xlstm-125m at published width, depth 12 cut to XLSTM_DEPTH: 3
    WTA-CRS and 1 exact step at B=4, S=1024, the share of the step that
    is the host's time loop (wall against device-busy), then prefill,
    decode and the pool.  Returns the train steps' launches."""
    t0 = time.perf_counter()
    cfg = get_config(XLSTM_ARCH)
    published_ssm("xlstm", cfg, (768, 4, 4, 192, 0, 50304, False, 0, 64, 2,
                                 4, ("mlstm", "slstm")))
    if cfg.n_layers != 12:
        fail(f"xlstm: {cfg.n_layers} layers, the published model has 12")
    cfg = dataclasses.replace(cfg, n_layers=XLSTM_DEPTH)
    rec, launches = full_size_train("xlstm", cfg, XLSTM_B, XLSTM_S,
                                    XLSTM_STEPS, 1)
    emit({"phase": "xlstm_train", **rec})
    params = registry.init_params(cfg, 0)
    recurrent_serve("xlstm", cfg, params, 2, XLSTM_S, hold_bf16=True)
    del params
    torch.cuda.empty_cache()
    emit({"phase": "xlstm", "seconds": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# the VLM and encoder-decoder phases
# ---------------------------------------------------------------------------

class FixedBatch:
    """One ``registry.make_synthetic_batch`` batch (seed 0, on the host) at
    every step: a step carries it to the card as a loader's batch.  A
    falling loss is then the optimizer's doing, not the next batch's
    luck."""

    def __init__(self, cfg, b, s):
        self.batch = registry.make_synthetic_batch(cfg, b, s, 0,
                                                   device="cpu")

    def batch_at(self, step, batch_size):
        return self.batch


def expect_per_step(what, cfg, s, b, want):
    """Fail unless ``launches_per_step`` (read off the model's trace) is
    ``want``, the count the model's structure gives."""
    got = launches_per_step(cfg, cm.Policy(wtacrs=MOE_WTA), s, batch=b)
    if got != want:
        fail(f"{what}: the trace implies {got} launches a step, the "
             f"structure {want}")


def published_vlm_encdec(what, cfg, want):
    """Fail unless ``cfg`` has the published widths and positions
    ``want``."""
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings,
           cfg.pos_mode, cfg.encoder_layers, cfg.max_learned_pos)
    if got != want:
        fail(f"{what}: not the published {cfg.name}: {got} != {want}")


def tensor_params(cfg):
    """Parameters in the tensors (not ``cfg.n_params()``'s formula)."""
    return sum(p.numel() for p in optim.tree_leaves(
        registry.init_params(cfg, 0, device="meta")))


def phase_vlm():
    """qwen2-vl-2b at full size (28 layers; the pool's cut): 4 WTA-CRS and 1
    exact step at B=4, S=1024 (256 patches, 768 text tokens; vis_proj
    sampled over the patch rows), prefill of 4 x 2048 (512 patches) on
    flash's wgmma route at 12/2 heads, 16 M-RoPE decode steps held in
    bf16, 4 pool requests at SERVE_POOL_DEPTH layers, Run.generate
    against the solo route.  Returns
    the train steps' and the prefill's launches."""
    t0 = time.perf_counter()
    cfg = get_config(VLM_ARCH)
    published_vlm_encdec("vlm", cfg, (28, 1536, 12, 2, 128, 8960, 151936,
                                      True, "mrope", 0, 4096))
    n_params = tensor_params(cfg)
    if n_params != 1_546_073_600 or cfg.n_params() != 1_543_569_408:
        fail(f"vlm: {n_params} parameters in the tensors, "
             f"{cfg.n_params()} from n_params()")
    # 28 layers of 4 plans and 7 dW, vis_proj's one plan and one dW; the
    # training attention's forward and backward once a layer
    expect_per_step("vlm", cfg, VLM_S, VLM_B, {
        "row_norms": 113, "gather_scale": 113, "fused_sampled_dw": 197,
        "flash_attention_fwd": 28, "flash_attention_bwd": 28})
    rec, launches = full_size_train("vlm", cfg, VLM_B, VLM_S, VLM_STEPS, 1,
                                    ds=FixedBatch(cfg, VLM_B, VLM_S))
    rec.update(vis_tokens=VLM_VIS, vis_k=VLM_VIS_K,
               n_params_formula=cfg.n_params(),
               peak_bytes_state=16 * n_params)
    emit({"phase": "vlm_train", **rec})
    params = registry.init_params(cfg, 0)
    prompt = registry.make_synthetic_batch(cfg, VLM_B, 2 * VLM_S, 1)
    del prompt["labels"]
    (prefill_launches, _), prompt, last, states = phase_prefill(
        cfg, params, VLM_B, 2 * VLM_S, name="vlm_prefill", prompt=prompt)
    phase_decode(cfg, params, prompt, last, states, n_gen=16, n_check=16,
                 name="vlm_decode")
    del last, states, prompt
    torch.cuda.empty_cache()
    emit({"phase": "vlm_pool", "arch": cfg.name,
          **pool_requests(cfg, params, "vlm pool", SERVE_POOL_DEPTH)})
    run = Run(RunSpec(arch=VLM_ARCH, reduced=False, batch_size=2,
                      data=DataSpec(seq_len=VLM_GEN[0], n_samples=2)))
    prompts = data.SyntheticLM(cfg.vocab_size, VLM_GEN[0], 2, seed=5).batch(
        np.arange(2))["tokens"]
    reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = run.generate(prompts, VLM_GEN[1])
    torch.cuda.synchronize()
    gen_ms = 1e3 * (time.perf_counter() - t1)
    expect_launches("vlm generate", {})
    want, _ = solo_generate(cfg, params, prompts, VLM_GEN[1],
                            run.spec.prefill_chunk, sum(VLM_GEN))
    if got.tolist() != want:
        at = [first_difference(a, b) for a, b in zip(got.tolist(), want)]
        fail(f"vlm: Run.generate differs from the solo route at its shapes, "
             f"first at positions {at} (per row)")
    emit({"phase": "vlm_generate", "rows": 2, "prompt_len": VLM_GEN[0],
          "new_tokens": VLM_GEN[1], "ms": gen_ms,
          "equal_to_solo_route": True})
    del run, params
    torch.cuda.empty_cache()
    emit({"phase": "vlm", "seconds": time.perf_counter() - t0})
    return dict(launches, flash_attention_fwd=prefill_launches[
        "flash_attention_fwd"])


def whisper_decode(cfg, params, frames, tokens, n_gen, name, hold):
    """``encdec.prime_cross_cache`` on ``frames``, then ``n_gen`` greedy
    serve_steps from ``tokens[:, 0]`` at the shared scalar position (each
    timed, the last 3 traced), held against the teacher-forced forward on
    the same frames and the fed tokens: at the reference's decode
    tolerance 5e-2, or 1.5x the forward's own floor at another flash block
    size (``close_to_forward``); ``hold=False`` only measures.  Returns the
    record."""
    b = frames.shape[0]
    serve = train_steps.make_serve_step(cfg, cm.Policy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        xk, xv = encdec.prime_cross_cache(cfg, params, frames, cm.Policy())
    torch.cuda.synchronize()
    prime_ms = 1e3 * (time.perf_counter() - t0)
    n_traced = 3
    state = encdec.decode_state_init(cfg, b, n_gen + n_traced,
                                     enc_len=frames.shape[1])
    state["xk"].copy_(xk)
    state["xv"].copy_(xv)
    del xk, xv
    tok = tokens[:, 0]
    fed, checked, times = [tok], [], []
    reset_launches()
    for g in range(n_gen):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok, logits, state = serve(params, tok, g, state)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t1))
        checked.append(logits)
        fed.append(tok)
    traced = iter(range(n_gen, n_gen + n_traced))
    trace = device_busy(lambda: serve(params, tok, next(traced), state),
                        n_traced)
    launches = expect_launches(name, {})
    del state
    forced = {"frames": frames, "tokens": torch.stack(fed[:n_gen], dim=1)}
    err, floor, atol = close_to_forward(
        f"{name} logits vs teacher-forced forward",
        torch.stack(checked, dim=1),
        forward_logits(cfg, params, forced, slice(None), 512),
        forward_logits(cfg, params, forced, slice(None), 256), 5e-2,
        hold=hold)
    ms = statistics.median(times)
    return {"phase": name, "compute_dtype": DTYPE_NAMES[cfg.cdtype],
            "batch": b, "frames": frames.shape[1], "steps": n_gen,
            "prime_cross_cache_ms": prime_ms, "step_ms_median": ms,
            "step_ms": times, "decode_tokens_per_s": b / (ms / 1e3),
            "launches": launches, "max_abs_err_vs_forward": err,
            "forward_vs_itself_other_block": floor, "atol_used": atol,
            "held": hold, "profile": trace}


def phase_whisper():
    """whisper-base at full size (6 + 6 layers, 32768-row position
    tables): 4 WTA-CRS and 1 exact step at B=8 of 1024 frames and 1024
    tokens (the reference's split of S = 2048; xattn_k / xattn_v sampled
    over the frames), the idle share; prime_cross_cache on 2 x 1024
    frames and 16 greedy decode steps against the teacher-forced forward,
    in f32 and in bf16; the refusals the reference has.  Returns the
    train steps' launches."""
    t0 = time.perf_counter()
    cfg = get_config(WHISPER_ARCH)
    published_vlm_encdec("whisper", cfg, (6, 512, 8, 8, 64, 2048, 51865,
                                          True, "learned", 6, 32768))
    n_params = tensor_params(cfg)
    if n_params != 104_182_272 or cfg.n_params() != 104_149_504:
        fail(f"whisper: {n_params} parameters in the tensors, "
             f"{cfg.n_params()} from n_params()")
    # an encoder layer's 4 plans and 6 dW, a decoder layer's 8 and 10; the
    # training attention once an encoder layer, twice a decoder layer (its
    # self- and cross-attention), forward and backward
    expect_per_step("whisper", cfg, WHISPER_S // 2, WHISPER_B, {
        "row_norms": 72, "gather_scale": 72, "fused_sampled_dw": 96,
        "flash_attention_fwd": 18, "flash_attention_bwd": 18})
    rec, launches = full_size_train(
        "whisper", cfg, WHISPER_B, WHISPER_S // 2, WHISPER_STEPS, 1,
        ds=FixedBatch(cfg, WHISPER_B, WHISPER_S))
    rec.update(frames=WHISPER_S // 2, n_params_formula=cfg.n_params())
    emit({"phase": "whisper_train", **rec})
    params = registry.init_params(cfg, 0)
    batch = registry.make_synthetic_batch(cfg, 2, WHISPER_S, 1)
    for dtype, hold in (("float32", True), ("bfloat16", True)):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        emit(whisper_decode(c, params, batch["frames"].to(c.cdtype),
                            batch["tokens"], 16, f"whisper_decode_{dtype}",
                            hold))
        torch.cuda.empty_cache()
    refused = {}
    try:
        ServeSpec(arch=WHISPER_ARCH, reduced=False, device="cuda")
    except ValueError as e:
        refused["serve_spec"] = str(e)
    try:
        train_steps.make_prefill_step(cfg, cm.Policy())(params, batch)
    except NotImplementedError as e:
        refused["prefill"] = str(e)
    state = registry.decode_state_init(cfg, 2, 4)
    try:
        registry.decode_step(cfg, params, batch["tokens"][:, 0],
                             torch.tensor([0, 1], device="cuda"), state,
                             cm.Policy())
    except NotImplementedError as e:
        refused["vector_pos"] = str(e)
    if sorted(refused) != ["prefill", "serve_spec", "vector_pos"]:
        fail(f"whisper: only {sorted(refused)} refused")
    del params, state, batch
    torch.cuda.empty_cache()
    emit({"phase": "whisper", "refused": refused,
          "seconds": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

DP_STEPS = 3            # (a): steps under each compression mode
DP_NCCL_DEPTH = 6       # (a): qwen2.5-3b at published width, depth 36 -> 6
DP_GLOO_DEPTH = 2       # (b): qwen2.5-3b at published width, depth 36 -> 2
DP_GLOO_STEPS = 2
DP_LR = 1e-4


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_payload(params, mode):
    """Bytes a rank hands to all_reduce for one gradient reduction: under
    int8 the reference's stacked leaves (one maximum each)."""
    leaves = optim.tree_leaves(params)
    if mode == "int8":
        leaves = [torch.empty((len(idx),) + tuple(leaves[idx[0]].shape),
                              device="meta")
                  for idx in optim_lib.reference_groups(params)]
    return compression.payload_bytes(leaves, mode)


def time_reduction(params, mesh, mode, grads, reps=3):
    """CUDA-event ms of ``reduce_gradients`` (the all-reduce and the
    compression) on a copy of ``grads``, median of ``reps`` after one
    warm-up; returns (ms, the last result)."""
    times = []
    for _ in range(reps + 1):
        copy = [g.clone() for g in grads]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = train_steps.reduce_gradients(copy, params, mesh, mode)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        del copy
    return statistics.median(times[1:]), out


def params_digest(params) -> str:
    """sha256 of every parameter's bytes, in ``named_leaves`` order."""
    h = hashlib.sha256()
    for p in optim.tree_leaves(params):
        h.update(bits(p).cpu().numpy())
    return h.hexdigest()


def dp_steps(cfg, policy, mesh, mode, ds, n_steps, what, keep_m1=False,
             microbatches=1):
    """A fresh state from seed 0 and ``n_steps`` of
    ``make_shardmap_dp_step`` on this rank's slice of each batch of B (or,
    with ``microbatches`` > 1, of ``make_train_step`` with that many
    microbatches, the whole batch on one rank): losses, step ms (host
    clock to a synchronize), peak, launches (checked against the
    structure's count; dW on wgmma in bf16, on fma in f32), the state, and
    (``keep_m1``: a copy the size of the parameters, in the peak) the first
    moments after the first step."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = train_steps.init_train_state(cfg, 0)
    sched = optim.linear_warmup_constant(DP_LR, 2)
    step = (train_steps.make_train_step(cfg, policy, optim.AdamWConfig(),
                                        sched, microbatches=microbatches)
            if microbatches > 1 else train_steps.make_shardmap_dp_step(
                cfg, policy, optim.AdamWConfig(), sched, mesh,
                compress=mode))
    reset_launches()
    losses, times, m1 = [], [], None
    for i in range(n_steps):
        if mesh.group is not None:
            dist.barrier(group=mesh.group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, sharding.shard_batch(ds.batch_at(i, B), mesh))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        if i == 0 and keep_m1:
            m1 = [x.clone() for x in optim.tree_leaves(state["opt"].m)]
    per_step = launches_per_step(cfg, policy, S, microbatches=microbatches)
    launches = expect_launches(what, {name: n * n_steps
                                      for name, n in per_step.items()})
    if per_step["fused_sampled_dw"]:       # an exact policy launches none
        expect_route(what, "fused_sampled_dw",
                     "fma" if cfg.cdtype == torch.float32 else "wgmma")
        expect_route(what, "gather_scale", "bulk")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: non-finite loss in {losses}")
    return {"losses": losses, "step_ms": times,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches, "launches_per_step": per_step}, state, m1


def dp_nccl_child(port):
    """(a) One rank over NCCL (a tcp://127.0.0.1 rendezvous), qwen2.5-3b
    at published width, depth 6, B=4, S=1024, WTA-CRS 0.3 on every
    linear: 3 make_shardmap_dp_step steps under each compression mode
    (losses falling, launches as the structure implies, dW on wgmma, H' on
    bulk, peak), the reduction of a gradient-sized tree timed (CUDA
    events) with its payload; then, under deterministic algorithms and
    det_topk, 2 steps of ``none`` bit-equal to make_train_step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda:0"))
    try:
        mesh = mesh_lib.make_host_mesh()
        cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                                  n_layers=DP_NCCL_DEPTH)
        ds = data.SyntheticLM(cfg.vocab_size, S, B, seed=0)
        wta = cm.Policy(wtacrs=WTACRSConfig(kind="wta_crs", budget=0.3,
                                            min_rows=4),
                        remat="none", flash_block=512)
        modes = {}
        for mode in compression.MODES:
            rec, state, _ = dp_steps(cfg, wta, mesh, mode, ds, DP_STEPS,
                                     f"dp nccl {mode}")
            if not rec["losses"][-1] < rec["losses"][0]:
                fail(f"dp nccl {mode}: loss did not fall: {rec['losses']}")
            params = state["params"]
            del state
            gen = torch.Generator(device="cuda")
            gen.manual_seed(1)
            grads = [1e-3 * torch.randn(p.shape, generator=gen,
                                        device="cuda")
                     for p in optim.tree_leaves(params)]
            rec["reduce_ms"], out = time_reduction(params, mesh, mode, grads)
            rec["payload_bytes"] = dp_payload(params, mode)
            modes[mode] = rec
            del params, grads, out
        # world 1: the all-reduce is the identity and the mean divides by
        # 1, so `none` is make_train_step's step bit for bit (det_topk
        # draws nothing, so the folded seed does not matter)
        torch.use_deterministic_algorithms(True)
        det = cm.Policy(wtacrs=WTACRSConfig(kind="det_topk", budget=0.3,
                                            min_rows=4),
                        remat="none", flash_block=512)
        sched = optim.linear_warmup_constant(DP_LR, 2)
        legs = {}
        for name in ("make_train_step", "make_shardmap_dp_step"):
            torch.cuda.empty_cache()
            state = train_steps.init_train_state(cfg, 0)
            step = (train_steps.make_train_step(cfg, det, optim.AdamWConfig(),
                                                sched)
                    if name == "make_train_step" else
                    train_steps.make_shardmap_dp_step(
                        cfg, det, optim.AdamWConfig(), sched, mesh))
            losses = []
            for i in range(2):
                state, m = step(state, sharding.shard_batch(
                    ds.batch_at(i, B), mesh))
                losses.append(float(m["loss"]))
            legs[name] = (losses, state["params"])
            del state, step
        (la, pa), (lb, pb) = legs.values()
        if la != lb or not all(torch.equal(bits(x), bits(y)) for x, y in zip(
                optim.tree_leaves(pa), optim.tree_leaves(pb))):
            fail(f"dp nccl: world-1 none is not make_train_step's step bit "
                 f"for bit: losses {lb} vs {la}")
        torch.use_deterministic_algorithms(False)
        emit({"backend": dist.get_backend(), "world": mesh.shape["data"],
              "arch": cfg.name, "n_layers": cfg.n_layers, "batch": B,
              "seq": S, "budget": 0.3, "modes": modes,
              "det_topk_none_equals_make_train_step": {
                  "losses": la, "bit_equal": True}})
    finally:
        dist.destroy_process_group()


def local_grads(cfg, policy, params, batch):
    """This rank's gradients of ``loss_fn`` over its slice (list, in
    ``tree_leaves`` order)."""
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = registry.loss_fn(cfg, params, {
            k: torch.as_tensor(v).cuda() for k, v in batch.items()
            if k != "sample_ids"}, policy, key=0)
        return list(torch.autograd.grad(loss, leaves))
    finally:
        for p in leaves:
            p.requires_grad_(False)


def quantization_bounds(grads, params, mesh, exact):
    """Per-element bounds of the compressed mean's distance to the exact
    one.  bf16 (8 significant bits: a rounding moves a value by at most
    2^-8 of it): each rank's cast and the bf16 sum each round once, so
    |mean_bf16 - mean| <= 2^-7 (1 + 2^-8) mean_r |g_r|.  int8: no value is
    clipped (|g_r| / scale <= 127) and each rank rounds to half a scale,
    so |mean_int8 - mean| <= scale / 2, with scale = sum_r max|g_r| / 127
    over the reference leaf.  Both with 1e-6 of mean_r |g_r| + |mean| for
    the f32 roundings around them."""
    mean_abs = train_steps.reduce_gradients([g.abs() for g in grads],
                                            params, mesh, "none")
    groups = optim_lib.reference_groups(params)
    amax = torch.stack([torch.stack([grads[i].abs().max() for i in idx]).max()
                        for idx in groups])
    dist.all_reduce(amax, group=mesh.group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    slack = [1e-6 * (m + e.abs()) for m, e in zip(mean_abs, exact)]
    out = {"bf16": [2.0 ** -7 * (1 + 2.0 ** -8) * m + sl
                    for m, sl in zip(mean_abs, slack)],
           "int8": [None] * len(grads)}
    for j, idx in enumerate(groups):
        for i in idx:
            out["int8"][i] = scale[j] / 2 + slack[i]
    return out


def redrawn_gains(params):
    """``params`` with every norm gain redrawn from [0.5, 1.5] (seed 1)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for path, p in optim.named_leaves(params):
        if path.endswith("gamma"):
            p.copy_(torch.rand(p.shape, generator=gen, device="cuda") + 0.5)
    return params


def dp_run_record(run, clock):
    st = run.state
    return {"losses": [h["loss"] for h in run.history],
            "step_ms": clock.step_ms(),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "znorm": {t: x.cpu() for t, x in st["znorm"].items()},
            "budget_stats": {t: x.cpu()
                             for t, x in st["budget_stats"].items()},
            "params_digest": params_digest(st["params"])}


def dp_run(spec, cfg, start):
    """A Run of ``cfg`` (the spec's arch, its depth cut) on the card from
    the parameters ``start``: Run.fit, each step timed."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = Run(spec)
    run.cfg = cfg
    run.init()
    with torch.no_grad():
        for dst, src in zip(optim.tree_leaves(run.state["params"]),
                            optim.tree_leaves(start)):
            dst.copy_(src)
    clock = StepClock(run.dataset)
    run.fit(clock)
    return dp_run_record(run, clock)


def dp_hold_run(host, alone, world):
    """``Run(mesh="host")`` against the one-rank Run on the global batch in
    the ranks' shapes (``world`` microbatches): the same plans on the same
    rows, so losses, znorm cache and statistics at rtol 1e-5 / atol 1e-6.
    A microbatch's taps come from its own slice's mean loss and a rank's
    are divided by W² (``make_train_step``), so the one-rank cache (the
    taps' square roots) is W times the ranks' (a power of two: exact).
    Returns the largest
    |difference| / |one rank's value| of each, and whether all were
    equal bit for bit."""
    if not np.allclose(host["losses"], alone["losses"], rtol=1e-5,
                       atol=1e-6):
        fail(f"dp gloo Run: losses {host['losses']} vs one rank "
             f"{alone['losses']}")
    same = host["losses"] == alone["losses"]
    worst = {}
    for name, scale in (("znorm", world), ("budget_stats", 1)):
        if set(host[name]) != set(alone[name]) or not alone[name]:
            fail(f"dp gloo Run: {name} tags {sorted(host[name])} vs one "
                 f"rank {sorted(alone[name])}")
        worst[name] = 0.0
        for t, x in alone[name].items():
            got = host[name][t] * scale
            if not torch.allclose(got, x, rtol=1e-5, atol=1e-6):
                fail(f"dp gloo Run: {name}/{t} differs from the "
                     f"one-rank Run's")
            same = same and torch.equal(got, x)
            rel = (got - x).abs() / x.abs().clamp(min=1e-30)
            worst[name] = max(worst[name], float(rel.max()))
    return {"max_rel_diff_one_rank": worst,
            "bit_equal_one_rank": bool(same)}


def dp_gloo_child(rank, port):
    """(b) One of two ranks sharing the card over gloo (CUDA tensors,
    reduced through host memory): qwen2.5-3b at published width, depth 2,
    global B=4 (2 a rank), S=1024.  2 make_shardmap_dp_step steps under
    each mode with WTA-CRS 0.3 on every linear (launches, losses, ms a
    step, the parameters' sha256 for the ranks' bit-identity); the
    reduction of the ranks' own first gradients timed and held to each
    mode's quantization bound; `none` against one rank on the global batch
    (rank 0), 2 steps each: with exact linears in f32 on the whole batch,
    and with det_topk on every linear in bf16 on the batch in the ranks'
    shapes (make_train_step, 2 microbatches), under deterministic
    algorithms (between batch shapes the GEMMs round activations
    differently and top-k flips where rows' norms tie to that rounding at
    the k-th place: layer 2's attn/wk in bf16, and in f32 a step-2 loss
    1.4e-5 off, on an H100); and Run(mesh="host") at the same size
    under a CACHED_GRAD controller policy against the one-rank Run in the
    ranks' shapes (rank 0), ms a step."""
    rank = int(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = mesh_lib.make_host_mesh()
        cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                                  n_layers=DP_GLOO_DEPTH)
        ds = data.SyntheticLM(cfg.vocab_size, S, B, seed=0)
        wta = cm.Policy(wtacrs=WTACRSConfig(kind="wta_crs", budget=0.3,
                                            min_rows=4),
                        remat="none", flash_block=512)
        modes = {}
        for mode in compression.MODES:
            rec, state, _ = dp_steps(cfg, wta, mesh, mode, ds,
                                     DP_GLOO_STEPS, f"dp gloo {mode}")
            rec["params_digest"] = params_digest(state["params"])
            modes[mode] = rec
            del state
        # the reduction of this rank's own gradients, timed, each mode
        # held to its quantization bound of the exact mean
        params = registry.init_params(cfg, 0)
        grads = local_grads(cfg, wta, params, sharding.shard_batch(
            ds.batch_at(0, B), mesh))
        # a host round trip of seconds: one timed call after the warm-up
        exact_ms, exact = time_reduction(params, mesh, "none", grads,
                                         reps=1)
        bounds = quantization_bounds(grads, params, mesh, exact)
        reduce = {"none": {"reduce_ms": exact_ms}}
        for mode in ("bf16", "int8"):
            ms, got = time_reduction(params, mesh, mode, grads, reps=1)
            # a zero bound (no rank has a gradient there) allows no error
            worst = 0.0
            for g, e, b in zip(got, exact, bounds[mode]):
                d = (g - e).abs()
                if bool((d[b == 0] > 0).any()):
                    worst = math.inf
                worst = max(worst, float((d / b.clamp(min=1e-30)).max()))
            if not worst <= 1.0:
                fail(f"dp gloo {mode}: the compressed mean is "
                     f"{worst:.3f}x its quantization bound from the exact")
            reduce[mode] = {"reduce_ms": ms, "worst_over_bound": worst}
            del got
        for mode in compression.MODES:
            reduce[mode]["payload_bytes"] = dp_payload(params, mode)
        del params, grads, exact, bounds
        # `none` against one rank on the global batch: exact linears in
        # f32, the batch whole; then det_topk on every linear in bf16, the
        # batch in the ranks' shapes (microbatches of B/2), where the plans
        # are the same by construction and halving is exact
        one = mesh_lib.Mesh({"data": 1, "model": 1}, ("data", "model"),
                            device=torch.device("cuda"))
        det = WTACRSConfig(kind="det_topk", budget=0.3, min_rows=4)
        for name, leg_cfg, wtacrs, mb in (
                ("none_exact_f32",
                 dataclasses.replace(cfg, compute_dtype="float32"),
                 EXACT_CONFIG, 1),
                ("none_det_topk", cfg, det, 2)):
            policy = cm.Policy(wtacrs=wtacrs, remat="none", flash_block=512)
            # (and on through the Run legs below)
            torch.use_deterministic_algorithms(mb > 1, warn_only=True)
            world1 = None
            if rank == 0:
                world1 = dp_steps(leg_cfg, policy, one, "none", ds,
                                  DP_GLOO_STEPS, f"dp world 1 {name}",
                                  keep_m1=True, microbatches=mb)
            dist.barrier()
            rec, state, m1 = dp_steps(leg_cfg, policy, mesh, "none", ds,
                                      DP_GLOO_STEPS, f"dp gloo {name}",
                                      keep_m1=True)
            rec["params_digest"] = params_digest(state["params"])
            if world1 is not None:
                ref, ref_state, ref_m1 = world1
                rec["losses_world1"] = ref["losses"]
                rec["world1_microbatches"] = mb
                dp_hold_to_world1(name, rec, m1, state["params"],
                                  (ref["losses"], ref_m1,
                                   ref_state["params"]))
                del ref_state, ref_m1
            modes[name] = rec
            del state, m1, world1
        # Run(mesh="host") against the one-rank Run on the global batch in
        # the ranks' shapes (microbatches 2): published width, depth 2,
        # f32 compute, B=4 of S=1024
        run_cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                                      n_layers=DP_GLOO_DEPTH,
                                      compute_dtype="float32")
        spec = dict(arch="qwen2.5-3b", reduced=False, steps=DP_GLOO_STEPS,
                    batch_size=B, lr=DP_LR, warmup=2,
                    data=DataSpec(seq_len=S, n_samples=DP_GLOO_STEPS * B),
                    policy=cm.Policy(rules=PolicyRules.of(Rule.of(
                        "*mlp*", WTACRSConfig(kind="det_topk", budget=0.3,
                                              min_rows=4,
                                              norm_source="cached_grad"),
                        ESSProportional(b_min=0.1, b_max=0.6, levels=6,
                                        warmup=1)))))
        start = redrawn_gains(registry.init_params(run_cfg, 0))
        alone = (dp_run(RunSpec(**spec, microbatches=2), run_cfg, start)
                 if rank == 0 else None)
        dist.barrier()
        host = dp_run(RunSpec(**spec, mesh="host"), run_cfg, start)
        torch.use_deterministic_algorithms(False)
        del start
        run_rec = {"n_layers": run_cfg.n_layers, "batch": B, "seq": S,
                   "losses": host["losses"], "step_ms": host["step_ms"],
                   "peak_bytes": host["peak_bytes"],
                   "params_digest": host["params_digest"]}
        if alone is not None:
            run_rec.update(
                losses_one_rank=alone["losses"],
                step_ms_one_rank=alone["step_ms"],
                peak_bytes_one_rank=alone["peak_bytes"],
                one_rank_microbatches=2,
                **dp_hold_run(host, alone, mesh.shape["data"]),
                cache_and_stats_equal_one_rank=True)
        emit({"rank": rank, "backend": dist.get_backend(),
              "world": mesh.shape["data"], "arch": cfg.name,
              "n_layers": cfg.n_layers, "global_batch": B,
              "rank_batch": B // 2, "seq": S, "modes": modes,
              "reduce": reduce, "run": run_rec})
    finally:
        dist.destroy_process_group()


def dp_hold_to_world1(what, rec, m1, params, ref):
    """`none` at two ranks against one rank on the global batch (f32): the
    sums run in another order.  Losses at rtol 1e-5; the first moments
    (linear in the mean gradient) at rtol 1e-5 with 1e-5 of the leaf's
    largest for atol: they carry the check.  The parameters after 2 steps
    at rtol 1e-5 / atol 1e-6 except where a gradient is as small as its
    rounding noise (Adam then moves by that noise over eps, by up to lr
    a step): at most 1e-4 of the elements."""
    losses, ref_m1, ref_params = ref
    if not np.allclose(rec["losses"], losses, rtol=1e-5, atol=0):
        fail(f"dp gloo {what}: losses {rec['losses']} vs world 1 {losses}")
    for i, (x, y) in enumerate(zip(m1, ref_m1)):
        if not torch.allclose(x, y, rtol=1e-5,
                              atol=1e-5 * float(y.abs().max())):
            d = (x - y).abs()
            fail(f"dp gloo {what}: first moments of leaf {i} "
                 f"{tuple(y.shape)} differ from world 1: max diff "
                 f"{float(d.max())}, leaf max {float(y.abs().max())}, "
                 f"elements off "
                 f"{int((d > 1e-5 * y.abs() + 1e-5 * y.abs().max()).sum())}")
    off = total = 0
    worst = 0.0
    for x, y in zip(optim.tree_leaves(params), optim.tree_leaves(ref_params)):
        d = (x - y).abs()
        off += int((d > 1e-6 + 1e-5 * y.abs()).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
    if off > total * 1e-4:
        fail(f"dp gloo {what}: {off} of {total} parameters off world 1 "
             f"(largest {worst})")
    rec["params_off_world1"] = off
    rec["params_max_diff_world1"] = worst
    rec["bit_equal_world1"] = bool(
        rec["losses"] == losses
        and all(torch.equal(x, y) for x, y in zip(m1, ref_m1))
        and all(torch.equal(x, y) for x, y in zip(
            optim.tree_leaves(params), optim.tree_leaves(ref_params))))


def run_children(fn, n, *args, timeout):
    """``chip_smoke.<fn>(rank, *args)`` in ``n`` processes at once (output
    to files under build/, so no pipe fills); returns the JSON object of
    each one's last line, by rank.  The first to fail ends them all: its
    peers would otherwise wait in a collective until the timeout."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix=f"{fn}-", dir=os.path.join(here, "build"))
    logs = [(open(os.path.join(work, f"{r}.out"), "w+"),
             open(os.path.join(work, f"{r}.err"), "w+")) for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, here, fn, str(r), *args],
        stdout=out, stderr=err, text=True, env=env)
        for r, (out, err) in enumerate(logs)]
    try:
        deadline = time.perf_counter() + timeout
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.perf_counter() > deadline:
                r = bad[0] if bad else None
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                if r is None:
                    fail(f"{fn}: the children did not end in {timeout} s")
                logs[r][1].seek(0)
                fail(f"{fn} rank {r}: the child exited "
                     f"{procs[r].returncode}: "
                     f"{logs[r][1].read().strip()[-3000:]}")
            time.sleep(0.5)
        outs = []
        for r, (p, (out, err)) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                err.seek(0)
                fail(f"{fn} rank {r}: the child exited {p.returncode}: "
                     f"{err.read().strip()[-3000:]}")
            out.seek(0)
            outs.append(json.loads(out.read().strip().splitlines()[-1]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()
        shutil.rmtree(work, ignore_errors=True)


def phase_dp():
    """Data parallelism (``launch/mesh.py``, ``train/compression.py``,
    ``make_shardmap_dp_step``, ``Run(mesh="host")``), each leg in child
    processes (a process group and deterministic cuBLAS are process-wide):
    (a) one rank over NCCL at full width, (b) two ranks sharing the card
    over gloo.  Returns (a)'s launches, all modes."""
    t0 = time.perf_counter()
    nccl = run_child("dp_nccl_child", str(free_port()), timeout=600)
    t1 = time.perf_counter()
    gloo = run_children("dp_gloo_child", 2, str(free_port()), timeout=600)
    t2 = time.perf_counter()
    for mode in gloo[0]["modes"]:
        digests = {r["modes"][mode]["params_digest"] for r in gloo}
        if len(digests) != 1:
            fail(f"dp gloo {mode}: the ranks' parameters differ")
    if len({r["run"]["params_digest"] for r in gloo}) != 1:
        fail("dp gloo Run: the ranks' parameters differ")
    launches = {name: sum(m["launches"][name]
                          for m in nccl["modes"].values())
                for name in ("row_norms", "gather_scale",
                             "fused_sampled_dw")}
    emit({"phase": "dp", "nccl_world1": nccl, "gloo_world2": gloo,
          "ranks_bit_identical": True, "nccl_s": t1 - t0,
          "gloo_s": t2 - t1, "launches": launches,
          "note": "the gloo ranks share one card and reduce through host "
                  "memory: their all-reduce ms are a host round trip, "
                  "not an interconnect's"})
    return launches


# ---------------------------------------------------------------------------
# tp: tensor and expert parallelism, two gloo ranks sharing the card
# ---------------------------------------------------------------------------

TP_DEPTH, TP_STEPS, TP_BATCH = 2, 2, 2      # qwen2.5-3b: depth 36 -> 2
TP_PROMPT_B, TP_PROMPT, TP_GEN = 2, 2 * S, 16
TP_GRANITE_DEPTH = 3                        # granite-moe-1b-a400m: 24 -> 3
TP_DBRX_DEPTH = 1                           # dbrx-132b: 40 -> 1
TP_LR = 1e-4


def tp_specs(cfg, mesh):
    params, axes = registry.abstract_params(cfg)
    return sharding.param_shardings(axes, params, mesh,
                                    rules=sharding.arch_rules(cfg, mesh))


def tp_replicated_digest(params, specs) -> str:
    """sha256 of every replicated (unsharded) parameter's bytes."""
    h = hashlib.sha256()
    for path, p in optim.named_leaves(params):
        if not any(specs[path]):
            h.update(bits(p).cpu().numpy())
    return h.hexdigest()


def tp_collectives(rec):
    return {f"{op} over {axis}": v for (op, axis), v in rec.by_axis().items()}


def tp_train(cfg, policy, mesh, ds, what, n_steps=TP_STEPS,
             microbatches=1):
    """``n_steps`` train steps of TP_BATCH sequences on this rank's shards
    of fresh parameters from seed 0 (the same on both ranks; ``mesh`` may
    be one rank's): losses, step ms, launches by route, each collective's
    count, bytes and ms (host clock, the card synchronised around it), the
    state."""
    specs = tp_specs(cfg, mesh)
    full = registry.init_params(cfg, 0)
    local = sharding.shard_params(full, specs, mesh)
    del full
    state = {"params": local, "opt": optim.adamw_init(local), "step": 0,
             "base_seed": cm.fold_seed(0, 7)}
    step = train_steps.make_train_step(
        cfg, policy, optim.AdamWConfig(), optim.linear_warmup_constant(TP_LR,
                                                                       2),
        mesh=mesh, microbatches=microbatches)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    with collectives.recording(timed=True) as rec:
        for i in range(n_steps):
            if mesh.model_group is not None:
                dist.barrier(group=mesh.model_group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, ds.batch_at(i, TP_BATCH))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: non-finite loss in {losses}")
    return {"losses": losses, "step_ms": times,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": launch_counts(),
            "launches_by_route": {n: dict(getattr(ops, n).launches_by_route)
                                  for n in KERNEL_NAMES
                                  if hasattr(getattr(ops, n),
                                             "launches_by_route")},
            "collectives": tp_collectives(rec)}, state, specs


def tp_serve(cfg, local, mesh, prompt, feed, n_gen=TP_GEN):
    """Prefill of ``prompt`` on this rank's shards (each rank keeps half
    the KV caches' positions and its heads' recurrent states), the states
    gathered, the caches padded by ``n_gen`` and split again
    (``sharding.decode_state_specs``), then ``n_gen`` decode steps fed
    ``feed``: the prefill's last logits, each step's logits (whole on
    every rank), prefill and decode ms, the collectives."""
    prefill = train_steps.make_prefill_step(cfg, cm.Policy(), mesh=mesh)
    serve = train_steps.make_serve_step(cfg, cm.Policy(), mesh=mesh)
    b, s = prompt["tokens"].shape
    with collectives.recording(timed=True) as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, states = prefill(local, prompt)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        states = sharding.gather_tree(states, sharding.decode_state_specs(
            cfg, registry.decode_state_init(cfg, b, s, device="meta"), mesh,
            b), mesh)
        states = pad_kv(states, n_gen)
        specs = sharding.decode_state_specs(cfg, states, mesh, b)
        states = sharding.shard_tree(states, specs, mesh)
        logits, times = [], []
        for t in range(n_gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, lg, states = serve(local, feed[:, t], s + t, states)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            logits.append(lg.float())
    return last.float(), torch.stack(logits), {
        "prefill_ms": prefill_ms, "decode_ms": times,
        "state_specs": {p: list(map(str, sp)) for p, sp in specs.items()},
        "collectives": tp_collectives(rec)}


def tp_one_rank_serve(cfg, params, prompt, feed, n_gen=TP_GEN):
    """The same prefill and decode on one rank (the whole parameters)."""
    prefill = train_steps.make_prefill_step(cfg, cm.Policy())
    serve = train_steps.make_serve_step(cfg, cm.Policy())
    last, states = prefill(params, prompt)
    states = pad_kv(states, n_gen)
    logits = []
    pos = prompt["tokens"].shape[1]
    for t in range(n_gen):
        _, lg, states = serve(params, feed[:, t], pos + t, states)
        logits.append(lg.float())
    return last.float(), torch.stack(logits)


def tp_distance(losses, m1, params, ref, ref_state):
    """(the losses' largest relative difference, each first-moment leaf's
    relative L2 error, the fraction of parameters beyond 1e-6 +
    1e-5·|p|, the largest parameter difference) of a run against one
    rank's."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                         ref["losses"]))
    m_rel = [float((x - y).norm() / y.norm().clamp(min=1e-30))
             for x, y in zip(m1, optim.tree_leaves(ref_state["opt"].m))]
    off = total = 0
    worst = 0.0
    for x, y in zip(optim.tree_leaves(params),
                    optim.tree_leaves(ref_state["params"])):
        d = (x - y).abs()
        off += int((d > 1e-6 + 1e-5 * y.abs()).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
    return loss_rel, m_rel, off / total, worst


def tp_hold_to_one_rank(rec, m1, params, ref, ref_state, n_steps=TP_STEPS,
                        floor=None):
    """The exact f32 steps at model = 2 against one rank: the losses at
    rtol 1e-5; each first-moment leaf (linear in the gradient) at a
    relative L2 error of 1e-4 — the ranks' GEMMs run at half the width,
    where cuBLAS picks other kernels and sums in another order, so an
    element's error is relative to the terms it sums, not to itself; the
    parameters after the steps: Adam moves an element by about lr a
    step, and where a gradient is as small as its rounding noise the two
    runs move it apart by up to 2·lr a step, so at most 1e-3 of the
    elements stand beyond 1e-6 + 1e-5·|p| and none beyond 2·lr a step.
    ``floor``: (record, state) of one rank running the batch as two
    microbatches — the same function, GEMMs of other shapes — whose
    distance to one rank, doubled, raises each bound where it is larger
    (zamba2: see ``tp_blocks``)."""
    loss_tol, m_tol, off_tol = 1e-5, 1e-4, 1e-3
    if floor is not None:
        f_loss, f_m, f_off, _ = tp_distance(
            floor[0]["losses"], optim.tree_leaves(floor[1]["opt"].m),
            floor[1]["params"], ref, ref_state)
        loss_tol = max(loss_tol, 2 * f_loss)
        m_tol = max(m_tol, 2 * max(f_m))
        off_tol = max(off_tol, 2 * f_off)
        rec.update(floor_loss_rel=f_loss, floor_m1_rel_l2_worst=max(f_m),
                   floor_params_off_fraction=f_off)
    loss_rel, m_rel, off, worst = tp_distance(rec["losses"], m1, params,
                                              ref, ref_state)
    if not loss_rel <= loss_tol:
        fail(f"tp exact f32: losses {rec['losses']} vs one rank "
             f"{ref['losses']} (rtol {loss_tol:.3g})")
    for i, (rel, y) in enumerate(zip(m_rel, optim.tree_leaves(
            ref_state["opt"].m))):
        if not rel <= m_tol:
            fail(f"tp exact f32: first moments of leaf {i} "
                 f"{tuple(y.shape)} are {rel:.3g} (relative L2) off one "
                 f"rank's (bound {m_tol:.3g})")
    if off > off_tol or worst > 2 * TP_LR * n_steps:
        fail(f"tp exact f32: {off:.3g} of the parameters off one rank "
             f"(bound {off_tol:.3g}; largest {worst})")
    rec.update(m1_rel_l2_worst=max(m_rel), params_off_fraction=off,
               params_max_diff_one_rank=worst, loss_rtol_used=loss_tol,
               m1_rel_l2_bound=m_tol, params_off_bound=off_tol)


TP_WTA = cm.Policy(wtacrs=MOE_WTA, remat="none", flash_block=512)
TP_EXACT = cm.Policy(wtacrs=EXACT_CONFIG, remat="none", flash_block=512)


def tp_leg_train(name, cfg, mesh, rank, ds, seq, batch, n_exact,
                 calibrate=False):
    """One leg's training at model = 2: 2 WTA-CRS bf16 steps (launches a
    step from ``launches_per_step``, every H' on ``bulk`` and every dW on
    ``wgmma``, the replicated leaves' digest), then ``n_exact`` exact f32
    steps held against one rank on the gathered parameters (rank 0);
    ``calibrate``: the bounds raised to twice one rank's own spread
    (``tp_hold_to_one_rank``'s floor)."""
    rec, state, specs = tp_train(cfg, TP_WTA, mesh, ds, f"tp {name} wta_crs")
    per_step = launches_per_step(cfg, TP_WTA, seq, batch=batch)
    if rec["launches"] != {n: TP_STEPS * per_step.get(n, 0)
                           for n in KERNEL_NAMES}:
        fail(f"tp {name}: launches {rec['launches']}, expected {TP_STEPS} "
             f"x {per_step}")
    routes = rec["launches_by_route"]
    if routes["gather_scale"].get("bulk", 0) != rec["launches"][
            "gather_scale"] or routes["fused_sampled_dw"].get(
                "wgmma", 0) != rec["launches"]["fused_sampled_dw"]:
        fail(f"tp {name}: launches by route {routes}")
    rec["launches_per_step_expected"] = per_step
    rec["replicated_digest"] = tp_replicated_digest(state["params"], specs)
    del state
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    exact, state, specs = tp_train(cfg32, TP_EXACT, mesh, ds,
                                   f"tp {name} exact", n_steps=n_exact)
    params = sharding.gather_params(state["params"], specs, mesh)
    m1 = optim.tree_leaves(sharding.gather_tree(state["opt"].m, specs, mesh))
    del state
    torch.cuda.empty_cache()
    if rank == 0:
        one = mesh_lib.Mesh({"data": 1, "model": 1}, ("data", "model"),
                            device=torch.device("cuda"))
        ref, ref_state, _ = tp_train(cfg32, TP_EXACT, one, ds,
                                     f"tp {name} one rank exact",
                                     n_steps=n_exact)
        exact["losses_one_rank"] = ref["losses"]
        exact["step_ms_one_rank"] = ref["step_ms"]
        exact["peak_bytes_one_rank"] = ref["peak_bytes"]
        floor = None
        if calibrate:
            f_rec, f_state, _ = tp_train(
                cfg32, TP_EXACT, one, ds, f"tp {name} one rank microbatched",
                n_steps=n_exact, microbatches=2)
            floor = (f_rec, f_state)
        tp_hold_to_one_rank(exact, m1, params, ref, ref_state, n_exact,
                            floor)
        del ref_state, floor
    del params, m1
    torch.cuda.empty_cache()
    return rec, exact


def tp_hold_serve(name, cfg, mesh, rank, prompt, feed, calibrate=False):
    """Prefill of ``prompt`` and TP_BLOCKS_GEN decode steps at model = 2 in
    f32, held against one rank (rank 0): f32, the ranks' partial sums in
    another order, at 2e-3 of the logits' largest magnitude (the
    reference's decode tolerance); ``calibrate``: or at twice one rank's
    own spread (one rank serving each sequence alone: the same function,
    GEMMs of other shapes) where that is larger.  Returns the record and,
    on rank 0, one rank's f32 (prefill, decode) logits."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    full = registry.init_params(cfg32, 0)
    local = sharding.shard_params(full, tp_specs(cfg32, mesh), mesh)
    if rank != 0:
        del full
    last, steps, rec = tp_serve(cfg32, local, mesh, prompt, feed,
                                TP_BLOCKS_GEN)
    rec["logits_digest"] = hashlib.sha256(
        torch.cat([last[None], steps]).cpu().numpy()).hexdigest()
    del local
    if rank == 0:
        want_last, want_steps = tp_one_rank_serve(cfg32, full, prompt, feed,
                                                  TP_BLOCKS_GEN)
        atol = 2e-3 * max(1.0, float(want_steps.abs().max()))
        if calibrate:
            rows = [tp_one_rank_serve(cfg32, full, prompt_rows(
                prompt, slice(i, i + 1)), feed[i:i + 1], TP_BLOCKS_GEN)
                for i in range(feed.shape[0])]
            floor = max(
                float((torch.cat([r[0] for r in rows]) - want_last).abs()
                      .max()),
                float((torch.cat([r[1] for r in rows], dim=1)
                       - want_steps).abs().max()))
            rec["one_rank_row_by_row_floor"] = floor
            atol = max(atol, 2 * floor)
        rec.update(prefill_max_abs_err_one_rank=check_close(
            f"tp {name} f32 prefill vs one rank", last, want_last, 0.0,
            atol), decode_max_abs_err_one_rank=check_close(
            f"tp {name} f32 decode vs one rank", steps, want_steps, 0.0,
            atol), atol_used=atol)
        del full
    torch.cuda.empty_cache()
    return rec, ((want_last, want_steps) if rank == 0 else None)


def tp_blocks(rank, mesh, out):
    """The recurrent and enc-dec legs at model = 2 (``models/ssm.py``'s
    heads path; ``models/encdec.py``): zamba2-2.7b and xlstm-125m at
    published width, whisper-base at full size (TP_BLOCK_SHAPES' cuts).
    Each trains (WTA-CRS bf16, then exact f32 against one rank), prefills
    (whisper: primes its cross caches) and decodes against one rank.
    Returns each leg's launches on this rank."""
    legs = {}
    # zamba2: 5 Mamba2 layers and the shared block, 40 Mamba2 heads and 16
    # attention heads of 80 a rank
    zcfg = dataclasses.replace(get_config("zamba2-2.7b"),
                               n_layers=TP_ZAMBA_DEPTH)
    zds = data.SyntheticLM(zcfg.vocab_size, S, TP_BATCH, seed=0)
    # the SSD's decays exp(seg_t - seg_s) are differences of cumulative
    # sums of dt·a reaching ~1e4 in f32 (|a| up to 80), so one rounding of
    # an input moves a decay by ~1e-3 of itself: the exact f32 steps are
    # held against one rank at twice one rank's own spread
    rec, exact = tp_leg_train("zamba2", zcfg, mesh, rank, zds, S, TP_BATCH,
                              TP_STEPS, calibrate=True)
    out["zamba2_wta_crs"], out["zamba2_exact_f32"] = rec, exact
    legs["tp_zamba2"] = dict(rec["launches"])
    toks = torch.from_numpy(data.SyntheticLM(
        zcfg.vocab_size, S + TP_BLOCKS_GEN, TP_PROMPT_B, seed=0).batch_at(
            0, TP_PROMPT_B)["tokens"]).cuda().to(torch.int64)
    prompt, feed = {"tokens": toks[:, :S]}, toks[:, S:]
    # bf16 prefill on flash's wgmma route (16 heads of 80 a rank) and decode,
    # and the same in f32: the f32 logits held against one rank's; the
    # bf16 ones (the ranks' all-reduced partial sums round in bf16 in
    # another order) against one rank's f32 ones at twice one rank's own
    # bf16 distance from them
    full = registry.init_params(zcfg, 0)
    local = sharding.shard_params(full, tp_specs(zcfg, mesh), mesh)
    if rank != 0:
        del full
    reset_launches()
    last, steps, zserve = tp_serve(zcfg, local, mesh, prompt, feed,
                                   TP_BLOCKS_GEN)
    route = flash_mod.flash_route(zcfg.head_dim, zcfg.cdtype, True)
    flash = expect_route("tp zamba2 prefill", "flash_attention_fwd", route)
    zserve["flash_launches_by_route"] = flash
    legs["tp_zamba2"]["flash_attention_fwd"] = flash[route]
    zserve["logits_digest"] = hashlib.sha256(
        torch.cat([last[None], steps]).cpu().numpy()).hexdigest()
    del local
    if rank == 0:
        want_last, want_steps = tp_one_rank_serve(zcfg, full, prompt, feed,
                                                  TP_BLOCKS_GEN)
        zserve["prefill_max_abs_err_one_rank"] = float(
            (last - want_last).abs().max())
        zserve["decode_max_abs_err_one_rank"] = float(
            (steps - want_steps).abs().max())
        del full
    torch.cuda.empty_cache()
    out["zamba2_serve_f32"], f32 = tp_hold_serve(
        "zamba2", zcfg, mesh, rank, prompt, feed, calibrate=True)
    if rank == 0:
        for what, got, one, truth in (("prefill", last, want_last, f32[0]),
                                      ("decode", steps, want_steps, f32[1])):
            floor = float((one - truth).abs().max())
            zserve[f"{what}_one_rank_bf16_vs_f32"] = floor
            zserve[f"{what}_max_abs_err_vs_one_rank_f32"] = check_close(
                f"tp zamba2 bf16 {what} vs one rank's f32", got, truth,
                0.0, 2 * floor)
    out["zamba2_serve_bf16"] = zserve
    # xlstm: one mLSTM and one sLSTM layer, 2 of 4 heads a rank; S = 512,
    # two chunks of 256 steps, so the chunk carry crosses
    xcfg = dataclasses.replace(get_config("xlstm-125m"),
                               n_layers=TP_XLSTM_DEPTH)
    xds = data.SyntheticLM(xcfg.vocab_size, TP_XLSTM_S, TP_BATCH, seed=0)
    rec, exact = tp_leg_train("xlstm", xcfg, mesh, rank, xds, TP_XLSTM_S,
                              TP_BATCH, 1)
    out["xlstm_wta_crs"], out["xlstm_exact_f32"] = rec, exact
    legs["tp_xlstm"] = dict(rec["launches"])
    toks = torch.from_numpy(data.SyntheticLM(
        xcfg.vocab_size, TP_XLSTM_S + TP_BLOCKS_GEN, TP_PROMPT_B,
        seed=0).batch_at(0, TP_PROMPT_B)["tokens"]).cuda().to(torch.int64)
    out["xlstm_serve_f32"] = tp_hold_serve(
        "xlstm", xcfg, mesh, rank, {"tokens": toks[:, :TP_XLSTM_S]},
        toks[:, TP_XLSTM_S:])[0]
    # whisper: 4 of 8 heads a rank in the encoder, the decoder and the
    # cross-attention; the tied head's 51865 rows do not divide 2 (whole)
    wcfg = get_config(WHISPER_ARCH)
    wds = FixedBatch(wcfg, TP_WHISPER_B, WHISPER_S)
    rec, exact = tp_leg_train("whisper", wcfg, mesh, rank, wds,
                              WHISPER_S // 2, TP_WHISPER_B, 1)
    out["whisper_wta_crs"], out["whisper_exact_f32"] = rec, exact
    legs["tp_whisper"] = dict(rec["launches"])
    out["whisper_serve"] = tp_whisper_serve(wcfg, mesh, rank)
    return legs


def tp_whisper_serve(cfg, mesh, rank):
    """``prime_cross_cache`` on 2 x 1024 frames at model = 2 (each rank its
    4 heads' cross caches) and TP_BLOCKS_GEN greedy decode steps, in f32
    and in bf16, each held as the whisper phase holds them, against one
    rank's teacher-forced forward on the fed tokens (5e-2, or 1.5x the
    forward's own floor at another flash block size), their distance to
    one rank's decode beside it."""
    params = registry.init_params(cfg, 0)
    local = sharding.shard_params(params, tp_specs(cfg, mesh), mesh)
    batch = registry.make_synthetic_batch(cfg, 2, WHISPER_S, 1)
    out = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        frames = batch["frames"].to(c.cdtype)
        serve = train_steps.make_serve_step(c, cm.Policy(), mesh=mesh)
        with collectives.recording(timed=True) as rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                xk, xv = encdec.prime_cross_cache(c, local, frames,
                                                  cm.Policy(), mesh=mesh)
            torch.cuda.synchronize()
            prime_ms = 1e3 * (time.perf_counter() - t0)
            whole = encdec.decode_state_init(c, 2, 128, frames.shape[1],
                                             device="meta")
            specs = sharding.decode_state_specs(c, whole, mesh, 2)
            state = sharding.shard_tree(encdec.decode_state_init(
                c, 2, 128, frames.shape[1]), specs, mesh)
            state["xk"].copy_(xk)
            state["xv"].copy_(xv)
            tok, fed, got, times = batch["tokens"][:, 0], [], [], []
            for g in range(TP_BLOCKS_GEN):
                fed.append(tok)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                tok, logits, state = serve(local, tok, g, state)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t1))
                got.append(logits.float())
        got = torch.stack(got, dim=1)
        leg = {"prime_cross_cache_ms": prime_ms, "decode_ms": times,
               "cross_cache_local": list(xk.shape),
               "state_specs": {p: list(map(str, sp))
                               for p, sp in specs.items()},
               "collectives": tp_collectives(rec),
               "logits_digest": hashlib.sha256(
                   got.cpu().numpy()).hexdigest()}
        del state, xk, xv
        if rank == 0:
            forced = {"frames": frames,
                      "tokens": torch.stack(fed, dim=1)}
            err, floor, atol = close_to_forward(
                f"tp whisper {dtype} decode vs one rank's forward", got,
                forward_logits(c, params, forced, slice(None), 512),
                forward_logits(c, params, forced, slice(None), 256), 5e-2)
            one = train_steps.make_serve_step(c, cm.Policy())
            with torch.no_grad():
                oxk, oxv = encdec.prime_cross_cache(c, params, frames,
                                                    cm.Policy())
            ostate = encdec.decode_state_init(c, 2, 128, frames.shape[1])
            ostate["xk"].copy_(oxk)
            ostate["xv"].copy_(oxv)
            ones = []
            for g, t in enumerate(fed):
                _, lg, ostate = one(params, t, g, ostate)
                ones.append(lg.float())
            leg.update(max_abs_err_vs_forward=err,
                       forward_vs_itself_other_block=floor, atol_used=atol,
                       decode_max_abs_err_one_rank=float(
                           (got - torch.stack(ones, dim=1)).abs().max()))
            del ostate, oxk, oxv
        out[dtype] = leg
        torch.cuda.empty_cache()
    return out


# The model axis's remaining edges, on the same two ranks:
# qwen2.5-3b at published width, depth TP_DEPTH, B=2, S=1024
TP_OPTIM_STEPS, TP_RUN_STEPS = 3, 4
# Run.generate's (prompt, new tokens) at B=2: 32 positions (< head_dim
# 128) split the caches on head_dim, 128 on the sequence (Run.prefill
# streams the prompt through decode steps, so 2 x 2048 would take
# thousands of them: cut to 112); bf16 at the first only
TP_GENERATE = ((16, 16), (112, 16))
# Run.serve's 6 requests (prompt, new tokens) in a pool of 4 slots of 128
# positions (pages of 16: each rank 8 positions of every page)
TP_SERVE = ((12, 8), (7, 12), (1, 10), (9, 6), (5, 9), (3, 4))
TP_LORA_R = 16
# the optimizer legs at depth 1 (cut from 4 for the script's time limit;
# mixed's first step SVDs every transformer matrix on model rank 0, one
# rank and one rank microbatched)
TP_OPTIM_DEPTH = 1
# Run's configs in the tp_run leg: depth 2, bf16 parameters (each
# checkpoint 0.93 GB to gather, write and read rather than 1.86)
TP_RUN_CONFIG = dict(n_layers=TP_DEPTH, param_dtype="bfloat16")


def tp_optim_specs():
    """bench_memory.py's factored_came, factored and mixed; mixed's
    low-rank rule carries a RankController (nothing migrates in a plain
    train step) so that its captured energy rides budget_stats."""
    specs = optim_specs()
    specs["mixed"] = optim_lib.OptimSpec.of(
        dict(pattern="unit/*", layout="lowrank", rank=8,
             controller=RankController()),
        dict(pattern="embed*", layout="factored", momentum=False))
    return specs


def tp_replicated_slots(state) -> Dict[str, str]:
    """sha256 of each optimizer slot a rank holds whole (the factored
    vectors, the low-rank subspace)."""
    out = {}
    for ref, slots in state["opt"]["leaves"].items():
        for name, t in slots.items():
            if name in ("v_row", "v_col", "u_row", "u_col", "proj") or (
                    name in ("m", "v") and "proj" in slots):
                out[f"{ref}/{name}"] = hashlib.sha256(
                    bits(t).cpu().numpy()).hexdigest()
    return out


def tp_optim_train(cfg, policy, spec, mesh, ds, n_steps, microbatches=1):
    """``n_steps`` steps under ``spec`` from seed 0's parameters on this
    rank's shards (``mesh`` may be one rank's): losses, step ms, peak, the
    state's bytes on the card, each step's collectives (a low-rank
    refresh's first step apart), launches by route; the state."""
    whole = train_steps.init_train_state(cfg, 0, opt=spec)
    sh_state, axes = train_steps.abstract_train_state(cfg, opt=spec)
    sh = train_steps.train_state_shardings(cfg, sh_state, axes, mesh)
    state = train_steps.shard_train_state(whole, sh, mesh)
    del whole
    torch.cuda.empty_cache()
    step = train_steps.make_train_step(
        cfg, policy, spec, optim.linear_warmup_constant(TP_LR, 2),
        mesh=mesh, microbatches=microbatches)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, colls = [], [], []
    for i in range(n_steps):
        if mesh.model_group is not None:
            dist.barrier(group=mesh.model_group)
        with collectives.recording(timed=True) as rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, ds.batch_at(i, TP_BATCH))
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        colls.append(tp_collectives(rec))
    if not all(math.isfinite(x) for x in losses):
        fail(f"tp_optim: non-finite loss in {losses}")
    return {"losses": losses, "step_ms": times,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "state_bytes_rank": optim_lib.tree_bytes(state["opt"]),
            "collectives_by_step": colls, "launches": launch_counts(),
            "launches_by_route": {n: dict(getattr(ops, n).launches_by_route)
                                  for n in KERNEL_NAMES
                                  if hasattr(getattr(ops, n),
                                             "launches_by_route")}}, \
        state, sh


def tp_rel_l2(got, want) -> float:
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp(min=1e-30))


def tp_optim_errors(state, ref):
    """({leaf: relative L2 against ``ref``} of the parameters and of the
    optimizer slots but CAME's instability vectors, {those: the same})."""
    errs = {f"params/{path}": tp_rel_l2(x, y) for (path, x), (_, y) in zip(
        optim.named_leaves(state["params"]),
        optim.named_leaves(ref["params"]))}
    unheld = {}
    for refp, slots in ref["opt"]["leaves"].items():
        for slot, y in slots.items():
            e = tp_rel_l2(state["opt"]["leaves"][refp][slot], y)
            (unheld if slot in ("u_row", "u_col") else errs)[
                f"{refp}/{slot}"] = e
    return errs, unheld


def tp_optim_leg(rank, mesh, cfg, ds):
    """Three steps under each spec at model = 2: bf16 WTA-CRS (launches,
    every H' on ``bulk`` and every dW on ``wgmma``, the replicated slots
    and parameters compared across the ranks by sha256), then exact f32
    held against one rank (rank 0): the factored specs' parameters and
    slots within 1e-4 relative L2 each (the dense layout's bound for its
    first moments), or, for a leaf CAME's confidence step amplifies beyond it,
    twice one rank's own microbatched spread on that leaf; mixed, where an SVD fixes its vectors only up to sign, at its
    captured energy within 1e-3 of one rank's and its parameters within
    twice the spread of one rank run as two microbatches."""
    out, launches = {}, dict.fromkeys(KERNEL_NAMES, 0)
    one = mesh_lib.Mesh({"data": 1, "model": 1}, ("data", "model"),
                        device=torch.device("cuda"))
    base = cfg
    for name, spec in tp_optim_specs().items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(base, n_layers=TP_OPTIM_DEPTH)
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        meta = registry.init_params(cfg, 0, device="meta")
        rec, state, sh = tp_optim_train(cfg, TP_WTA, spec, mesh, ds,
                                        TP_OPTIM_STEPS)
        for k in ("row_norms", "gather_scale", "fused_sampled_dw"):
            if rec["launches"][k] == 0:
                fail(f"tp_optim {name}: {k} never launched")
            launches[k] += rec["launches"][k]
        routes = rec["launches_by_route"]
        if routes["gather_scale"].get("bulk", 0) != rec["launches"][
                "gather_scale"] or routes["fused_sampled_dw"].get(
                    "wgmma", 0) != rec["launches"]["fused_sampled_dw"]:
            fail(f"tp_optim {name}: launches by route {routes}")
        rec["replicated_slots"] = tp_replicated_slots(state)
        rec["replicated_digest"] = tp_replicated_digest(
            state["params"], sh["params"])
        report = optim_lib.memory_report(spec, meta)
        rec["state_bytes_one_rank"] = report["state_bytes"]
        del state
        torch.cuda.empty_cache()
        exact, state, sh = tp_optim_train(cfg32, TP_EXACT, spec, mesh, ds,
                                          TP_OPTIM_STEPS)
        whole = train_steps.gather_train_state(state, sh, mesh)
        exact["replicated_slots"] = tp_replicated_slots(state)
        del state
        torch.cuda.empty_cache()
        if rank == 0:
            ref_rec, ref, _ = tp_optim_train(cfg32, TP_EXACT, spec, one, ds,
                                             TP_OPTIM_STEPS)
            exact["losses_one_rank"] = ref_rec["losses"]
            exact["step_ms_one_rank"] = ref_rec["step_ms"]
            exact["peak_bytes_one_rank"] = ref_rec["peak_bytes"]
            if not np.allclose(exact["losses"], ref_rec["losses"],
                               rtol=1e-5, atol=0):
                fail(f"tp_optim {name} exact f32: losses "
                     f"{exact['losses']} vs one rank {ref_rec['losses']}")
            if name != "mixed":
                # the parameters and the slots linear in the gradient's
                # statistics (CAME's momentum, the factored second
                # moments) at 1e-4 relative L2 each; CAME's instability
                # vectors, means of (u - m)^2 where u and m nearly cancel,
                # are measured only.  CAME's confidence step m / sqrt(U)
                # amplifies a rounding where U is small (attn/bk's
                # gradient): a leaf beyond 1e-4 is held at twice one
                # rank's own spread on it, run as two microbatches
                errs, unheld = tp_optim_errors(whole, ref)
                beyond = {k: e for k, e in errs.items() if not e <= 1e-4}
                if beyond:
                    _, floor_state, _ = tp_optim_train(
                        cfg32, TP_EXACT, spec, one, ds, TP_OPTIM_STEPS,
                        microbatches=2)
                    floor, _ = tp_optim_errors(floor_state, ref)
                    del floor_state
                    bad = {k: (e, floor[k]) for k, e in beyond.items()
                           if not e <= 2 * floor[k]}
                    if bad:
                        fail(f"tp_optim {name} exact f32: relative L2 off "
                             f"one rank's beyond 1e-4 and twice one "
                             f"rank's microbatched spread: {bad}")
                    exact["held_at_twice_the_microbatched_spread"] = {
                        k: (e, floor[k]) for k, e in beyond.items()}
                exact["worst_rel_l2_one_rank"] = sorted(
                    errs.items(), key=lambda kv: -kv[1])[:3]
                if unheld:
                    exact["instability_rel_l2_one_rank_worst"] = max(
                        unheld.values())
            else:
                key = optim_lib.rank_stat_key(0)
                e_tp = whole["budget_stats"][key]
                e_one = ref["budget_stats"][key]
                energy_err = float((e_tp - e_one).abs().max())
                if not energy_err <= 1e-3:
                    fail(f"tp_optim mixed: captured energy {e_tp.tolist()} "
                         f"vs one rank {e_one.tolist()}")
                _, floor, _ = tp_optim_train(cfg32, TP_EXACT, spec, one, ds,
                                             TP_OPTIM_STEPS, microbatches=2)
                d_tp = max(float((x - y).abs().max()) for x, y in zip(
                    optim.tree_leaves(whole["params"]),
                    optim.tree_leaves(ref["params"])))
                d_floor = max(float((x - y).abs().max()) for x, y in zip(
                    optim.tree_leaves(floor["params"]),
                    optim.tree_leaves(ref["params"])))
                if not d_tp <= 2 * d_floor:
                    fail(f"tp_optim mixed exact f32: parameters {d_tp:.3g} "
                         f"off one rank, its own spread {d_floor:.3g}")
                exact.update(energy=e_tp.tolist(),
                             energy_one_rank=e_one.tolist(),
                             energy_max_abs_err=energy_err,
                             params_max_diff_one_rank=d_tp,
                             params_max_diff_microbatched=d_floor)
                del floor
            del ref
        del whole
        torch.cuda.empty_cache()
        out[name] = {"wta_crs_bf16": rec, "exact_f32": exact,
                     "n_layers": cfg.n_layers,
                     "seconds": time.perf_counter() - t0}
        tp_log(f"tp_optim {name}", t0)
    return out, launches


@contextlib.contextmanager
def run_configs(**over):
    """``Run`` and ``ServeSpec`` build their configs with ``over``
    replaced (a depth cut, the compute dtype)."""
    from repro_torch.api import run as run_mod
    from repro_torch.serve import spec as serve_spec
    old = [(m, m.get_config) for m in (run_mod, serve_spec)]
    for m, get in old:
        m.get_config = (lambda g: lambda a, reduced=False: dataclasses.replace(
            g(a, reduced=reduced), **over))(get)
    try:
        yield
    finally:
        for m, get in old:
            m.get_config = get


def tp_run_spec(work, every=2, **kw):
    return RunSpec(arch="qwen2.5-3b", reduced=False, policy=TP_WTA,
                   steps=TP_RUN_STEPS, optimizer=optim_specs()["factored"],
                   batch_size=TP_BATCH, lr=TP_LR, warmup=2,
                   data=DataSpec(seq_len=S, n_samples=TP_BATCH * TP_RUN_STEPS),
                   checkpoint_dir=work, checkpoint_every=every, **kw)


def tp_params_digest(params) -> str:
    h = hashlib.sha256()
    for _, p in optim.named_leaves(params):
        h.update(bits(p).cpu().numpy())
    return h.hexdigest()


def tp_generate(run, prompts, gen, feed=None):
    """``Run.generate``'s greedy loop written out through ``prefill`` /
    ``decode`` (or fed ``feed``'s tokens after the prompt): the tokens,
    the last step's logits, the caches' split and local shape."""
    tok, pos, states = run.prefill(prompts, gen=gen)
    k = next(st["k"] for st in states if "k" in st)
    split = (lm.kv_split(run.cfg, k[0], run.mesh) if run.mesh is not None
             and run.mesh.shape["model"] > 1 else None)
    toks = []
    for i, t in enumerate(range(pos, pos + gen)):
        if feed is not None and i:
            tok = feed[:, i - 1]
        tok, logits, states = run.decode(tok, t, states)
        toks.append(tok)
    return torch.stack(toks, dim=1), logits.float(), split, tuple(k.shape)


def tp_log(what, t0):
    """A leg's seconds on the child's standard error (a failing child's
    last lines show how far it got)."""
    print(f"tp: {what} {time.perf_counter() - t0:.1f} s", file=sys.stderr,
          flush=True)


def tp_run_leg(rank, mesh, cfg, work):
    """``Run(mesh="host", model_parallel=2)`` at depth TP_DEPTH: ``fit``
    for 4 WTA-CRS steps under ``factored``, saving at steps 2 and 4 (only
    the global rank 0 writes); a fresh Run restored from the step-2
    checkpoint (nothing carried over but the files) fits to step 4 bit for
    bit under deterministic algorithms; ``generate`` at a cache split on
    head_dim and one split on the sequence, greedy f32 tokens equal to one
    rank's (rank 0), bf16 last logits held against one rank's f32 ones at
    twice one rank's own bf16 distance; ``serve`` 6 requests in f32,
    tokens equal to one rank's session at the pool's shapes."""
    out = {}
    torch.use_deterministic_algorithms(True)
    writes = []
    save = checkpoint.save

    def counted(*a, **kw):
        writes.append(int(a[1]))
        return save(*a, **kw)

    checkpoint.save = counted
    try:
        with run_configs(**TP_RUN_CONFIG):
            m2 = dict(mesh="host", model_parallel=2)
            reset_launches()
            t0 = time.perf_counter()
            run = Run(tp_run_spec(work, **m2))
            run.fit()
            fit_s = time.perf_counter() - t0
            launches = launch_counts()
            for k in ("row_norms", "gather_scale", "fused_sampled_dw"):
                if launches[k] == 0:
                    fail(f"tp_run: {k} never launched in Run.fit")
            whole = run.gathered_params()
            out.update(fit_s=fit_s, launches=launches,
                       losses=[h["loss"] for h in run.history],
                       params_digest=tp_params_digest(whole),
                       local_digest=tp_params_digest(run.state["params"]),
                       opt_digest=tp_params_digest(run.state["opt"][
                           "leaves"]))
            t0 = time.perf_counter()
            back = Run.restore(tp_run_spec(work, every=0, **m2), step=2)
            back.fit()
            out["resume_s"] = time.perf_counter() - t0
            tp_log(f"tp_run fit {fit_s:.1f} s, resume", t0)
            if (back.history != run.history
                    or tp_params_digest(back.state["params"])
                    != out["local_digest"]
                    or tp_params_digest(back.state["opt"]["leaves"])
                    != out["opt_digest"]):
                fail("tp_run: the run restored from step 2 is not bit-equal "
                     "to the uninterrupted run")
            out["resume_bit_equal"] = True
            local = run.state["params"]
            del back, run
            torch.cuda.empty_cache()
    finally:
        checkpoint.save = save
        torch.use_deterministic_algorithms(False)
    out["writes"] = writes
    if (rank == 0) != bool(writes):
        fail(f"tp_run rank {rank}: wrote checkpoints {writes}")
    corpus = data.SyntheticLM(cfg.vocab_size, 128, 2, seed=5).batch_at(
        0, 2)["tokens"]
    for dtype in ("float32", "bfloat16"):
        with run_configs(**TP_RUN_CONFIG, compute_dtype=dtype):
            gen = Run(tp_run_spec(None, every=0, mesh="host",
                                  model_parallel=2))
            gen._params = local
            one = None
            if rank == 0:
                one = Run(tp_run_spec(None, every=0))
                one._params = whole
            for prompt_len, n_new in TP_GENERATE:
                if dtype == "bfloat16" and prompt_len != TP_GENERATE[0][0]:
                    continue          # bf16 at the head_dim split only
                prompts = corpus[:, :prompt_len]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks, logits, split, local_k = tp_generate(gen, prompts,
                                                           n_new)
                torch.cuda.synchronize()
                if (dtype == "float32" and prompt_len == TP_GENERATE[0][0]
                        and not torch.equal(gen.generate(prompts, n_new),
                                            toks)):
                    fail("tp_run: Run.generate's greedy tokens differ from "
                         "its prefill / decode loop's")
                rec = {"split": split, "cache_local": list(local_k),
                       "ms_per_token": 1e3 * (time.perf_counter() - t0)
                       / (prompt_len - 1 + n_new),
                       "tokens_digest": hashlib.sha256(
                           toks.cpu().numpy()).hexdigest(),
                       "logits_digest": hashlib.sha256(
                           logits.cpu().numpy()).hexdigest()}
                want_split = ("seq" if prompt_len + n_new >= cfg.head_dim
                              else "dh")
                if split != want_split:
                    fail(f"tp_run generate {prompt_len}+{n_new}: caches "
                         f"split as {split}, expected {want_split}")
                if rank == 0 and dtype == "float32":
                    otoks, ologits, _, _ = tp_generate(one, prompts, n_new)
                    if not torch.equal(toks, otoks):
                        fail(f"tp_run generate {prompt_len}+{n_new} f32: "
                             f"tokens {toks.tolist()} vs one rank "
                             f"{otoks.tolist()}")
                    rec["last_logits_max_abs_err_one_rank"] = float(
                        (logits - ologits).abs().max())
                elif rank == 0:
                    # bf16 (the ranks' row-parallel partial sums round in
                    # bf16 before their all-reduce): one rank fed the
                    # tokens this run generated, in f32 and in bf16; the
                    # run's last logits held against one rank's f32 ones
                    # at twice one rank's own bf16 distance from them
                    _, ologits, _, _ = tp_generate(one, prompts, n_new,
                                                   feed=toks)
                    with run_configs(**TP_RUN_CONFIG,
                                     compute_dtype="float32"):
                        truth = Run(tp_run_spec(None, every=0))
                        truth._params = whole
                        _, tlogits, _, _ = tp_generate(truth, prompts, n_new,
                                                       feed=toks)
                    del truth
                    floor = float((ologits - tlogits).abs().max())
                    err = check_close(
                        f"tp_run generate {prompt_len}+{n_new} bf16 last "
                        f"logits vs one rank's f32", logits, tlogits, 0.0,
                        2 * floor)
                    rec.update(last_logits_max_abs_err_one_rank_f32=err,
                               one_rank_bf16_vs_f32=floor,
                               bf16_vs_one_rank_bf16=float(
                                   (logits - ologits).abs().max()))
                out[f"generate_{dtype}_{prompt_len}+{n_new}"] = rec
                tp_log(f"tp_run generate {dtype} {prompt_len}+{n_new}", t0)
            if dtype == "float32":
                prompts = [np.asarray(corpus[i % 2, :n]) for i, (n, _)
                           in enumerate(TP_SERVE)]
                geo = dict(max_slots=4, page_size=16, max_len=128)
                t0 = time.perf_counter()
                with gen.serve(**geo).start() as sess:
                    hs = [sess.submit(p, max_new=m)
                          for p, (_, m) in zip(prompts, TP_SERVE)]
                    got = [h.result(300) for h in hs]
                    pool_kv = sess.scheduler.shards.kv
                serve_s = time.perf_counter() - t0
                out["serve"] = {"seconds": serve_s, "pool_split": pool_kv,
                                "tokens": got}
                if pool_kv != "pages":
                    fail(f"tp_run serve: the pool split {pool_kv}")
                tp_log("tp_run serve", t0)
                if rank == 0:
                    sess = one.serve(**geo)
                    hs = [sess.submit(p, max_new=m)
                          for p, (_, m) in zip(prompts, TP_SERVE)]
                    sess.run_until_idle()
                    want = [h.result(0) for h in hs]
                    if got != want:
                        fail(f"tp_run serve f32: tokens {got} vs one rank's "
                             f"session {want}")
            del gen, one
            torch.cuda.empty_cache()
    return out, launches


def tp_lora_leg(rank, mesh):
    """A column-parallel (2048 -> 11008) and a row-parallel (11008 -> 2048)
    LoRA linear (r = 16, WTA-CRS 0.3 over B=2 x S=1024) at model = 2, in
    bf16 and f32: outputs and the gradients of h, A and B gathered and held
    against one rank's ``lora_linear`` on the whole weight (rank 0) with
    the same plan — f32 at 1e-4 relative L2 (the ranks' GEMMs at half
    width sum in another order), bf16 at twice one rank's own bf16
    distance from its f32 — and launches counted on this rank's calls that
    draw their own plans."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    d, f, b, s = 2048, 11008, TP_BATCH, S
    m = mesh_lib.model_index(mesh)
    k = MOE_WTA.budget_rows(s)
    lcfg = LoRAConfig(rank=TP_LORA_R, alpha=32.0, enabled=True)
    idx = torch.sort(torch.stack([torch.randperm(s, generator=gen,
                                                 device="cuda")[:k]
                                  for _ in range(b)]), dim=1).values
    scale = torch.rand((b, k), generator=gen, device="cuda") + 0.5
    plan = (idx.to(torch.int32), scale)
    out, launches = {}, dict.fromkeys(KERNEL_NAMES, 0)
    for mode, d_in, d_out in (("column", d, f), ("row", f, d)):
        h32 = torch.randn((b, s, d_in), generator=gen, device="cuda")
        w32 = torch.randn((d_in, d_out), generator=gen, device="cuda") \
            / math.sqrt(d_in)
        a32 = torch.randn((d_in, TP_LORA_R), generator=gen,
                          device="cuda") / math.sqrt(TP_LORA_R)
        b32 = torch.randn((TP_LORA_R, d_out), generator=gen,
                          device="cuda") / 10
        ct32 = torch.randn((b, s, d_out), generator=gen, device="cuda")
        col = mode == "column"
        half = (d_out if col else d_in) // 2
        part = slice(m * half, (m + 1) * half)
        results = {}
        for dtype in (torch.float32, torch.bfloat16):
            h, w, a, bb, ct = (x.to(dtype) for x in (h32, w32, a32, b32,
                                                     ct32))
            hl = (h if col else h[..., part]).clone().requires_grad_(True)
            wl = w[:, part] if col else w[part]
            al = (a if col else a[part]).clone().requires_grad_(True)
            bl = (bb[:, part] if col else bb).clone().requires_grad_(True)
            reset_launches()
            z = lora_lib.lora_linear_parallel(
                hl, wl, al, bl, lcfg, mode, mesh, cfg=MOE_WTA, plan=plan)
            (z * (ct[..., part] if col else ct)).sum().backward()
            # this rank's own plan: row_norms too
            zz = lora_lib.lora_linear_parallel(
                hl.detach().requires_grad_(True), wl,
                al.detach().requires_grad_(True), bl.detach(), lcfg, mode,
                mesh, key=5, cfg=MOE_WTA)
            zz.float().sum().backward()
            torch.cuda.synchronize()
            got_launches = launch_counts()
            for kname in ("row_norms", "gather_scale", "fused_sampled_dw"):
                if got_launches[kname] == 0:
                    fail(f"tp_lora {mode} {dtype}: {kname} never launched")
                launches[kname] += got_launches[kname]
            if dtype == torch.bfloat16:
                expect_route(f"tp_lora {mode}", "fused_sampled_dw", "wgmma")
            g = {"z": z.detach(), "h": hl.grad, "a": al.grad, "b": bl.grad}
            if col:
                g["z"] = sharding.gather_leaf(g["z"], (None, None, "model"),
                                              mesh)
                g["b"] = sharding.gather_leaf(g["b"], (None, "model"), mesh)
            else:
                g["h"] = sharding.gather_leaf(g["h"], (None, None, "model"),
                                              mesh)
                g["a"] = sharding.gather_leaf(g["a"], ("model", None), mesh)
            results[dtype] = g
            if rank == 0:
                ho = h.clone().requires_grad_(True)
                ao = a.clone().requires_grad_(True)
                bo = bb.clone().requires_grad_(True)
                zo = lora_lib.lora_linear(ho, w, ao, bo, lcfg, cfg=MOE_WTA,
                                          plan=plan)
                (zo * ct).sum().backward()
                results[("one", dtype)] = {"z": zo.detach(), "h": ho.grad,
                                           "a": ao.grad, "b": bo.grad}
        if rank == 0:
            rec = {}
            for name in ("z", "h", "a", "b"):
                truth = results[("one", torch.float32)][name]
                e32 = tp_rel_l2(results[torch.float32][name], truth)
                floor = tp_rel_l2(results[("one", torch.bfloat16)][name],
                                  truth)
                e16 = tp_rel_l2(results[torch.bfloat16][name], truth)
                if not e32 <= 1e-4:
                    fail(f"tp_lora {mode} f32 {name}: {e32:.3g} relative "
                         f"L2 off one rank")
                if not e16 <= 2 * floor:
                    fail(f"tp_lora {mode} bf16 {name}: {e16:.3g} relative "
                         f"L2 off one rank's f32, one rank's own bf16 "
                         f"{floor:.3g}")
                rec[name] = {"f32_rel_l2": e32, "bf16_rel_l2": e16,
                             "one_rank_bf16_rel_l2": floor}
            out[mode] = rec
        del results
        torch.cuda.empty_cache()
    return out, launches


def tp_restore_one_rank(work, rec):
    """The model-parallel run's step-4 checkpoint restored at one rank on
    the card: every key a one-rank state of the spec holds, with its shape
    (``checkpoint.restore`` checks) and dtype, and the parameters
    bit-equal to the ranks' gathered ones."""
    with run_configs(**TP_RUN_CONFIG):
        t0 = time.perf_counter()
        run = Run.restore(tp_run_spec(work, every=0), step=TP_RUN_STEPS)
        restore_s = time.perf_counter() - t0
    manifest = checkpoint.read_manifest(work, TP_RUN_STEPS)
    mine = {k: str(x.dtype).removeprefix("torch.")
            if isinstance(x, torch.Tensor) else "int64"
            for k, x in checkpoint._leaves(run.state)}
    if sorted(mine) != manifest["keys"] or mine != manifest["dtypes"]:
        fail("tp_run: the model-parallel checkpoint's keys or dtypes are "
             "not a one-rank state's")
    if tp_params_digest(run.state["params"]) != rec["params_digest"]:
        fail("tp_run: the parameters restored at one rank differ from the "
             "ranks' gathered ones")
    step_dir = os.path.join(work, f"step_{TP_RUN_STEPS:010d}")
    out = {"keys": len(mine), "restore_s": restore_s,
           "checkpoint_bytes": sum(
               os.path.getsize(os.path.join(step_dir, f))
               for f in os.listdir(step_dir)), "bit_equal": True}
    del run
    torch.cuda.empty_cache()
    return out


def tp_state_legs(rank, mesh, cfg, ds, work, out):
    """The optimizer, Run and LoRA legs; returns each one's launches on
    this rank."""
    legs = {}
    t0 = time.perf_counter()
    out["optim"], legs["tp_optim"] = tp_optim_leg(rank, mesh, cfg, ds)
    t1 = time.perf_counter()
    out["run"], legs["tp_run"] = tp_run_leg(rank, mesh, cfg, work)
    t2 = time.perf_counter()
    out["lora"], legs["tp_lora"] = tp_lora_leg(rank, mesh)
    out["state_legs_s"] = {"tp_optim": t1 - t0, "tp_run": t2 - t1,
                           "tp_lora": time.perf_counter() - t2}
    return legs


def tp_child(rank, port, work):
    """One of two ranks sharing the card over gloo at model = 2
    (``make_host_mesh(model_parallel=2)``: one model group).  qwen2.5-3b
    at published width, depth 2: 2 WTA-CRS bf16 steps (loss falls, the
    replicated leaves bit-identical across the ranks, launches as the
    structure implies); 2 exact f32 steps held against one rank on the
    gathered parameters (rank 0); a 2 x 2048 prefill and 16 decode steps
    held against one rank at the bf16 floor of phase prefill.
    granite-moe-1b-a400m at published width, depth 3, 2 WTA-CRS steps
    with 16 experts a rank.  dbrx-132b at published width, depth 1,
    prefill and decode with 8 experts a rank (bf16: the distance to one
    rank measured; a router logit rounded in another order flips top-k).
    Each collective's count, bytes and ms."""
    rank = int(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = mesh_lib.make_host_mesh(model_parallel=2)
        out = {"rank": rank, "mesh": dict(mesh.shape),
               "model_index": mesh_lib.model_index(mesh)}
        cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                                  n_layers=TP_DEPTH)
        ds = data.SyntheticLM(cfg.vocab_size, S, TP_BATCH, seed=0)
        wta = cm.Policy(wtacrs=WTACRSConfig(kind="wta_crs", budget=0.3,
                                            min_rows=4),
                        remat="none", flash_block=512)
        rec, state, specs = tp_train(cfg, wta, mesh, ds, "tp qwen wta_crs")
        if not rec["losses"][-1] < rec["losses"][0]:
            fail(f"tp qwen wta_crs: loss did not fall: {rec['losses']}")
        per_step = launches_per_step(cfg, wta, S)
        if rec["launches"] != {n: TP_STEPS * per_step.get(n, 0)
                               for n in KERNEL_NAMES}:
            fail(f"tp qwen wta_crs: launches {rec['launches']}, expected "
                 f"{TP_STEPS} x {per_step}")
        rec["replicated_digest"] = tp_replicated_digest(state["params"],
                                                        specs)
        out["qwen_wta_crs"] = rec
        del state
        # exact f32: the ranks' gathered parameters against one rank's
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        exact = cm.Policy(wtacrs=EXACT_CONFIG, remat="none", flash_block=512)
        rec, state, specs = tp_train(cfg32, exact, mesh, ds, "tp qwen exact")
        params = sharding.gather_params(state["params"], specs, mesh)
        m1 = optim.tree_leaves(sharding.gather_tree(state["opt"].m, specs,
                                                    mesh))
        del state
        if rank == 0:
            one = mesh_lib.Mesh({"data": 1, "model": 1}, ("data", "model"),
                                device=torch.device("cuda"))
            ref, ref_state, _ = tp_train(cfg32, exact, one, ds,
                                         "tp one rank exact")
            rec["losses_one_rank"] = ref["losses"]
            rec["step_ms_one_rank"] = ref["step_ms"]
            tp_hold_to_one_rank(rec, m1, params, ref, ref_state)
            del ref_state
        out["qwen_exact_f32"] = rec
        del params, m1
        torch.cuda.empty_cache()
        # prefill 2 x 2048 and 16 decode steps against one rank (bf16)
        full = registry.init_params(cfg, 0)
        local = sharding.shard_params(full, tp_specs(cfg, mesh), mesh)
        corpus = data.SyntheticLM(cfg.vocab_size, TP_PROMPT + TP_GEN,
                                  TP_PROMPT_B, seed=0).batch_at(
                                      0, TP_PROMPT_B)["tokens"]
        toks = torch.from_numpy(corpus).cuda().to(torch.int64)
        prompt = {"tokens": toks[:, :TP_PROMPT]}
        last, steps, serve_rec = tp_serve(cfg, local, mesh, prompt,
                                          toks[:, TP_PROMPT:])
        serve_rec["logits_digest"] = hashlib.sha256(
            torch.cat([last[None], steps]).cpu().numpy()).hexdigest()
        if not bool(torch.isfinite(steps).all() & torch.isfinite(last).all()):
            fail("tp qwen serve: non-finite logits")
        if rank == 0:
            want_last, want_steps = tp_one_rank_serve(cfg, full, prompt,
                                                      toks[:, TP_PROMPT:])
            tt = on_card(prompt)
            err, floor, atol = close_to_forward(
                "tp prefill last logits vs one rank", last, want_last,
                forward_logits(cfg, full, tt, -1, 512).float(), 3e-2,
                forward_logits(cfg, full, tt, -1, 256).float())
            derr = check_close("tp decode logits vs one rank", steps,
                               want_steps, 0.0, atol)
            serve_rec.update(prefill_max_abs_err_one_rank=err,
                             one_rank_vs_forward_floor=floor, atol_used=atol,
                             decode_max_abs_err_one_rank=derr)
        out["qwen_serve"] = serve_rec
        del full, local, last, steps
        torch.cuda.empty_cache()
        # the optimizer layouts, Run (checkpoints, generate, serve) and
        # LoRA over the model axis
        state_legs = tp_state_legs(rank, mesh, cfg, ds, work, out)
        # granite: expert parallel training, 16 experts a rank
        gcfg = dataclasses.replace(get_config(MOE_ARCH),
                                   n_layers=TP_GRANITE_DEPTH)
        gds = data.SyntheticLM(gcfg.vocab_size, S, TP_BATCH, seed=0)
        rec, state, specs = tp_train(gcfg, wta, mesh, gds, "tp granite")
        rec["experts_per_rank"] = int(
            state["params"]["layers"][0]["moe"]["wi"].shape[0])
        if rec["experts_per_rank"] != gcfg.n_experts // 2:
            fail(f"tp granite: {rec['experts_per_rank']} experts a rank")
        per_step = launches_per_step(gcfg, wta, S, batch=TP_BATCH)
        if rec["launches"] != {n: TP_STEPS * per_step.get(n, 0)
                               for n in KERNEL_NAMES}:
            fail(f"tp granite: launches {rec['launches']}, expected "
                 f"{TP_STEPS} x {per_step}")
        rec["replicated_digest"] = tp_replicated_digest(state["params"],
                                                        specs)
        out["granite"] = rec
        del state
        torch.cuda.empty_cache()
        # dbrx: expert parallel serving, 8 experts a rank, bf16 weights
        dcfg = dataclasses.replace(get_config("dbrx-132b"),
                                   n_layers=TP_DBRX_DEPTH,
                                   param_dtype="bfloat16")
        full = registry.init_params(dcfg, 0)
        local = sharding.shard_params(full, tp_specs(dcfg, mesh), mesh)
        if rank != 0:
            del full
        dtoks = torch.from_numpy(data.SyntheticLM(
            dcfg.vocab_size, TP_PROMPT + TP_GEN, TP_PROMPT_B,
            seed=0).batch_at(0, TP_PROMPT_B)["tokens"]).cuda().to(
                torch.int64)
        dprompt = {"tokens": dtoks[:, :TP_PROMPT]}
        last, steps, drec = tp_serve(dcfg, local, mesh, dprompt,
                                     dtoks[:, TP_PROMPT:])
        drec["experts_per_rank"] = int(
            local["layers"][0]["moe"]["wi"].shape[0])
        drec["logits_digest"] = hashlib.sha256(
            torch.cat([last[None], steps]).cpu().numpy()).hexdigest()
        if not bool(torch.isfinite(steps).all() & torch.isfinite(last).all()):
            fail("tp dbrx serve: non-finite logits")
        del local
        if rank == 0:
            want_last, want_steps = tp_one_rank_serve(
                dcfg, full, dprompt, dtoks[:, TP_PROMPT:])
            drec["prefill_max_abs_err_one_rank"] = float(
                (last - want_last).abs().max())
            drec["decode_max_abs_err_one_rank"] = float(
                (steps - want_steps).abs().max())
            del full
        out["dbrx_serve"] = drec
        torch.cuda.empty_cache()
        out["legs"] = tp_blocks(rank, mesh, out)
        out["legs"].update(state_legs)
        emit(out)
    finally:
        dist.destroy_process_group()


def phase_tp():
    """Tensor and expert parallelism (``tp_child``, two gloo ranks on the
    card): the ranks' replicated leaves and whole logits compared."""
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="tp-run-", dir=os.path.join(here, "build"))
    try:
        ranks = run_children("tp_child", 2, str(free_port()), work,
                             timeout=1000)
        restored = tp_restore_one_rank(work, ranks[0]["run"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name in ranks[0]["optim"]:
        for leg in ("wta_crs_bf16", "exact_f32"):
            a, b = (r["optim"][name][leg] for r in ranks)
            if a["replicated_slots"] != b["replicated_slots"]:
                fail(f"tp_optim {name} {leg}: the ranks' replicated "
                     f"optimizer slots differ")
            if a["losses"] != b["losses"]:
                fail(f"tp_optim {name} {leg}: the ranks' losses differ")
        if len({r["optim"][name]["wta_crs_bf16"]["replicated_digest"]
                for r in ranks}) != 1:
            fail(f"tp_optim {name}: the ranks' replicated parameters differ")
    for key in ranks[0]["run"]:
        if key.startswith("generate_") and len(
                {(r["run"][key]["tokens_digest"], r["run"][key][
                    "logits_digest"]) for r in ranks}) != 1:
            fail(f"tp_run {key}: the ranks' tokens or logits differ")
    if ranks[0]["run"]["serve"]["tokens"] != ranks[1]["run"]["serve"][
            "tokens"]:
        fail("tp_run serve: the ranks' tokens differ")
    for key in ("qwen_wta_crs", "granite", "zamba2_wta_crs",
                "xlstm_wta_crs", "whisper_wta_crs"):
        if len({r[key]["replicated_digest"] for r in ranks}) != 1:
            fail(f"tp {key}: the ranks' replicated parameters differ")
        if ranks[0][key]["losses"] != ranks[1][key]["losses"]:
            fail(f"tp {key}: the ranks' losses differ")
    for key in ("qwen_serve", "dbrx_serve", "zamba2_serve_bf16",
                "zamba2_serve_f32", "xlstm_serve_f32"):
        if len({r[key]["logits_digest"] for r in ranks}) != 1:
            fail(f"tp {key}: the ranks' logits differ")
    for dtype in ("float32", "bfloat16"):
        if len({r["whisper_serve"][dtype]["logits_digest"]
                for r in ranks}) != 1:
            fail(f"tp whisper {dtype}: the ranks' logits differ")
    legs = {leg: {n: sum(r["legs"][leg].get(n, 0) for r in ranks)
                  for n in KERNEL_NAMES} for leg in ranks[0]["legs"]}
    emit({"phase": "tp", "ranks": ranks, "seconds": time.perf_counter() - t0,
          "restored_one_rank": restored,
          "depths": {"qwen2.5-3b": TP_DEPTH,
                     "granite-moe-1b-a400m": TP_GRANITE_DEPTH,
                     "dbrx-132b": TP_DBRX_DEPTH,
                     "zamba2-2.7b": TP_ZAMBA_DEPTH,
                     "xlstm-125m": TP_XLSTM_DEPTH, "whisper-base": 6},
          "launches_by_leg": legs,
          "note": "two gloo ranks share one card: each collective's ms is "
                  "a host round trip, not an interconnect's"})
    return {n: sum(r[k]["launches"][n] for r in ranks
                   for k in ("qwen_wta_crs", "granite"))
            for n in KERNEL_NAMES}, legs


# ---------------------------------------------------------------------------
# dryrun: the train cell traced on meta against the real step; two
# production cells
# ---------------------------------------------------------------------------

DRYRUN_CELLS = ("qwen2.5-3b", "dbrx-132b", "zamba2-2.7b")
DRYRUN_PROCS = []


def start_dryrun_cells():
    """``python -m repro_torch.launch.dryrun`` for each of DRYRUN_CELLS x
    train_4k x single, in the background from the start (host CPU only, no
    card): their trace takes minutes of host time the card's phases can
    hide.  Returns the output directory."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    out = tempfile.mkdtemp(prefix="dryrun-", dir=os.path.join(here,
                                                               "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    for arch in DRYRUN_CELLS:
        log = open(os.path.join(out, f"{arch}.log"), "w")
        DRYRUN_PROCS.append((arch, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", "train_4k", "--mesh", "single", "--out", out],
            stdout=log, stderr=subprocess.STDOUT, env=env)))
    return out


def stop_dryrun_cells():
    for _, log, proc in DRYRUN_PROCS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def phase_dryrun(out_dir):
    """(1) The train phase's cell (12-layer qwen2.5-3b, B=4, S=1024, its
    WTA-CRS policy, AdamW) traced on ``meta`` on a 1 x 1 mesh and held
    against the same step on the card: the predicted peak within 10 % of
    the measured one (the step's arguments, state and batch, plus
    ``max_memory_allocated``'s rise over the bytes allocated before the
    step), each kernel's predicted launches equal to its real counter, the
    step's bound beside its device-busy ms.  (2) ``lower_cell`` of
    DRYRUN_CELLS x train_4k x single (started in the background), their
    records."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=12)
    ds = data.SyntheticLM(cfg.vocab_size, S, B, seed=0)
    policy = cm.Policy(wtacrs=WTACRSConfig(kind="wta_crs", budget=0.3,
                                           min_rows=4),
                       remat="none", flash_block=512)
    shape = InputShape("train_phase", S, B, "train")
    metas = {n: getattr(ops, n).meta_launches for n in KERNEL_NAMES}
    counter, _, _ = dryrun_lib.trace_step(
        cfg, shape, mesh_lib.make_mesh((1, 1), ("data", "model")), policy)
    predicted = {n: getattr(ops, n).meta_launches - metas[n]
                 for n in KERNEL_NAMES}
    trace_s = time.perf_counter() - t0
    # the same step on the card: one warm-up step, then the measured one
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    state = train_steps.init_train_state(cfg, 0)
    step = train_steps.make_train_step(
        cfg, policy, optim.AdamWConfig(), optim.linear_warmup_constant(1e-4,
                                                                       2))
    state, _ = step(state, ds.batch_at(0, B))
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             ds.batch_at(1, B).items() if k != "sample_ids"}
    args_bytes = cost_lib.tree_bytes([state["params"], state["opt"].m,
                                      state["opt"].v]) + cost_lib.tree_bytes(
                                          batch)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    max_alloc = torch.cuda.max_memory_allocated()
    measured = args_bytes + (max_alloc - before)
    real = launch_counts()
    busy = device_busy(lambda: step(state, batch), 1)
    del state, step, batch
    torch.cuda.empty_cache()
    if real != predicted:
        fail(f"dryrun: predicted launches {predicted}, the card's {real}")
    if counter.argument_bytes != args_bytes:
        fail(f"dryrun: predicted argument bytes {counter.argument_bytes}, "
             f"the card's {args_bytes}")
    ratio = counter.peak / measured
    if not 0.9 <= ratio <= 1.1:
        fail(f"dryrun: predicted peak {counter.peak} is {ratio:.3f}x the "
             f"measured {measured}")
    bound_s = max(counter.flops / roofline_lib.PEAK_FLOPS,
                  counter.bytes_accessed / roofline_lib.HBM_BW)
    cell = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": B,
            "seq": S, "trace_s": trace_s,
            "predicted_peak_bytes": counter.peak,
            "measured_peak_bytes": measured,
            "max_memory_allocated": max_alloc,
            "allocated_before_step": before,
            "argument_bytes": args_bytes, "peak_ratio": ratio,
            "predicted_launches": predicted, "real_launches": real,
            "flops": counter.flops, "bytes_accessed": counter.bytes_accessed,
            "bound_ms": 1e3 * bound_s,
            "device_busy_ms": busy["device_busy_ms_per_call"],
            "loss": float(m["loss"])}
    records = {}
    for arch, log, proc in DRYRUN_PROCS:
        try:
            proc.wait(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            fail(f"dryrun: the {arch} cell did not end")
        path = os.path.join(out_dir, f"{arch}__train_4k__single.json")
        if proc.returncode != 0 or not os.path.exists(path):
            log.flush()
            with open(log.name) as f:
                fail(f"dryrun: the {arch} cell exited {proc.returncode}: "
                     f"{f.read()[-3000:]}")
        with open(path) as f:
            rec = json.load(f)
        if rec["status"] != "ok" or not {"memory", "cost",
                                          "collectives"} <= set(rec):
            fail(f"dryrun: the {arch} cell: {rec}")
        rec["roofline"] = roofline_lib.roofline_terms(rec)
        records[arch] = rec
    stop_dryrun_cells()
    emit({"phase": "dryrun", "train_cell": cell, "cells": records,
          "seconds": time.perf_counter() - t0})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        fail(f"unknown phases {sorted(unknown)}")

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    # every f32 comparison below assumes full-precision f32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = autotune.card_line()
    dryrun_dir = start_dryrun_cells() if "dryrun" in phases else None
    if "analysis" in phases:
        start_analysis()
    try:
        return run_phases(phases, smi, dryrun_dir)
    finally:
        stop_dryrun_cells()
        stop_analysis()
        stop_resume()


PHASE_SECONDS = {}


def clocked(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds kept under ``name``."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + (
            time.perf_counter() - t0)


def run_phases(phases, smi, dryrun_dir) -> int:
    if "env" in phases:
        emit({"phase": "env", "gpu": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "device_name": torch.cuda.get_device_name(0),
              "capability": list(torch.cuda.get_device_capability(0))})
    if set(phases) & {"build", "kernels", "autotune", "parity", "train",
                      "memory", "adaptive", "accumulate", "optim", "run",
                      "resume", "serve_parity", "prefill", "wide_serve",
                      "moe", "moe_wide", "ssm", "xlstm", "vlm", "whisper",
                      "dp", "tp", "dryrun"}:
        t0 = time.perf_counter()
        lib = _build.build()
        _build.library()
        log = (lib.parent / "build.log").read_text()
        smm_ptxas = ptxas_report(log, "sampled_matmul.cu")
        t1 = time.perf_counter()
        smem_check = smem_cross_check(log)
        smem_check["seconds"] = time.perf_counter() - t1
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "smem_cross_check": smem_check,
              "library": os.path.relpath(lib),
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln],
              "sampled_matmul_ptxas": smm_ptxas,
              "fused_sampled_dw_ptxas": ptxas_report(
                  log, "fused_sampled_dw.cu"),
              "flash_attention_fwd_ptxas": ptxas_report(
                  log, "flash_attention_fwd.cu")})
        # the wgmma route holds 128 accumulators a thread: a spill there
        # would put the sum in local memory
        for kernel, info in smm_ptxas.items():
            if kernel.startswith("smm_wgmma_kernel") and (
                    info.get("spill_stores") or info.get("spill_loads")):
                fail(f"build: {kernel} spills: {info}")

    cases, launches, by_route = [], {}, {}
    if "kernels" in phases:
        cases, comp_launches, by_route["sampled_matmul"] = clocked(
            "kernels", phase_kernels)
        launches["sampled_matmul"] = comp_launches["sampled_matmul"]
    if "autotune" in phases:
        clocked("autotune", phase_autotune, smi)
    if "parity" in phases:
        clocked("parity", phase_parity)

    if set(phases) & {"train", "memory", "adaptive", "accumulate"}:
        cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=12)
        # as many samples as the batch holds: every step sees the same
        # sequences, so a falling loss is the optimizer's doing and not
        # the luck of the next batch
        ds = data.SyntheticLM(cfg.vocab_size, S, B, seed=0)
        wta_peak = peak_m1 = None
        if "train" in phases:
            train_launches, wta_peak = clocked("train", phase_train, cfg,
                                               ds, n_steps=6)
            for name in ("row_norms", "gather_scale", "fused_sampled_dw",
                         "flash_attention_bwd"):
                launches[name] = train_launches[name]
            for name in ("gather_scale", "fused_sampled_dw"):
                by_route[name] = dict(getattr(ops, name).launches_by_route)
        if "memory" in phases:
            clocked("memory", phase_memory, cfg, ds, wta_peak)
        if "adaptive" in phases:
            peak_m1 = clocked("adaptive", phase_adaptive, cfg, steps=10)
        if "accumulate" in phases:
            clocked("accumulate", phase_accumulate, cfg, peak_m1)
        del ds
        torch.cuda.empty_cache()
    phase_launches = {}
    if "optim" in phases:
        phase_launches["optim"] = clocked("optim", phase_optim)

    run_launches = {}
    if "resume" in phases:
        start_resume()      # after optim, the phase with the largest peak
    if "run" in phases:
        run_launches, _ = clocked("run", phase_run)
    if "resume" in phases:
        clocked("resume", phase_resume)

    if "serve_parity" in phases:
        clocked("serve_parity", phase_serve_parity)
    if set(phases) & {"prefill", "decode", "pool"}:
        # the serving slice: published widths and full depth, f32
        # parameters, bf16 compute, exact linears
        cfg = get_config("qwen2.5-3b")
        params = registry.init_params(cfg, 0)
        if "prefill" in phases or "decode" in phases:
            (serve_launches, flash_routes), *prefilled = clocked(
                "prefill", phase_prefill, cfg, params, B, 2 * S)
            launches["flash_attention_fwd"] = \
                serve_launches["flash_attention_fwd"]
            by_route["flash_attention_fwd"] = flash_routes
            if "decode" in phases:
                clocked("decode", phase_decode, cfg, params, *prefilled)
            del prefilled
        if "pool" in phases:
            clocked("pool", phase_pool,
                    dataclasses.replace(cfg, n_layers=POOL_DEPTH), params)
        del params
        torch.cuda.empty_cache()
    if "wide_serve" in phases:
        phase_launches["wide_serve"] = clocked("wide_serve",
                                               phase_wide_serve)
    if "moe" in phases:
        phase_launches["moe"] = clocked("moe", phase_moe)
    if "moe_wide" in phases:
        phase_launches["moe_wide"] = clocked("moe_wide", phase_moe_wide)
    if "ssm" in phases:
        phase_launches["ssm"] = clocked("ssm", phase_ssm)
    if "xlstm" in phases:
        phase_launches["xlstm"] = clocked("xlstm", phase_xlstm)
    if "vlm" in phases:
        phase_launches["vlm"] = clocked("vlm", phase_vlm)
    if "whisper" in phases:
        phase_launches["whisper"] = clocked("whisper", phase_whisper)
    dp_launches = {}
    if "dp" in phases:
        dp_launches = clocked("dp", phase_dp)
    tp_launches = {}
    if "tp" in phases:
        tp_launches, tp_legs = clocked("tp", phase_tp)
        phase_launches.update(tp_legs)
    if "dryrun" in phases:
        clocked("dryrun", phase_dryrun, dryrun_dir)
    if "analysis" in phases:
        clocked("analysis", phase_analysis)

    if set(phases) == set(ALL_PHASES):
        # the summary the port is judged by: the main paths' kernels at the
        # main paths' shapes in bf16, with the launches the train phase
        # (row_norms, gather_scale, fused_sampled_dw), the composition
        # (sampled_matmul) and the prefill phase (flash_attention_fwd)
        # counted — for the optim, wide_serve, moe, moe_wide, ssm, xlstm,
        # vlm and whisper shapes those phases' —
        # and beside them the launches of the Run phase's fit and of the
        # dp phase's one-rank NCCL leg (the train phase's shapes)
        summary = []
        for c in cases:
            if ("ms" in c and c["dtype"] == "bfloat16"
                    and c.get("in_summary", True)):
                counted = (phase_launches[c["phase"]] if "phase" in c
                           else launches)
                entry = dict(c, launches=counted[c["name"]],
                             launches_run=run_launches[c["name"]],
                             launches_dp=dp_launches.get(c["name"], 0),
                             launches_tp=tp_launches.get(c["name"], 0))
                if "phase" not in c and c["name"] in by_route:
                    entry["launches_by_route"] = by_route[c["name"]]
                summary.append(entry)
        emit({"kernels": summary})
    emit({"phase_seconds": PHASE_SECONDS,
          "total_s": time.perf_counter() - STARTED})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
