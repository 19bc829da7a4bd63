"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--only multicard_train,...]

Builds the six CUDA kernels from the sources in this checkout (one `nvcc`
per source, started together; the attention and RG-LRU builds go on while
the DES phases run), holds each against its plain PyTorch version on the
card, drives the port's paths and prints one JSON line per phase:

- the DES grid: the paper's 37 x 6 grid of 5000-job workloads through
  `run_packet_grid` (event-step kernel);
- the chaos axis: the same grid with launch/service.py's 3-cell fault
  axis, 37 x 6 x 3 = 666 lanes, each drawing its own threefry stream on
  the card (event-step kernel, chaos instantiations, float32 homog0.85
  and float64 hetero0.85); fused = chunked, `mode="seq"` on six flat
  lanes and an inert ChaosConfig against the fault-free grid held
  exactly, the card's streams bitwise the CPU's;
- the streaming service: `repro_torch.launch.service.main` at its
  defaults (intensity_step, 2000 jobs, windows of 250), fault-free,
  `--chaos` and `--float64`, each tick's oracle one dispatch of the
  event-step kernel; every tick's decisions equal those of the same
  service on the CPU over the trace's first 5 windows (a cut, the CPU's
  chaos run being ~25 s at 2000 jobs); one tick's [K, C] oracle block
  bitwise the chaos grid's column;
- the paper's sim driver: `repro_torch.launch.sim.main` at its defaults
  (homog0.85 as the reference's sim.py draws it, 5000 jobs, S = 0.05),
  its threshold held against the fused grid's column of that workload;
- the paper's whole study: its six flows as the two cohorts of
  paper_sweep.py's dtype policy (3 x 222 = 666 lanes each) through
  `run_cohort_grid`, one event-step launch a segment for all the lanes of
  a cohort, every member bitwise its own fused `run_packet_grid`, in the
  fused, chunked and seq layouts and under paper_sweep.py's 8-cell fault
  axis (5 328 lanes a cohort; the largest difference from the checked-in
  paper_chaos_grid.json printed, not gated); then the rigid FCFS and
  EASY-backfill baselines of every flow through `run_baselines` and
  `launch.sim.main(["--baselines"])`, one launch of the baselines kernel a
  policy a call, held against the plain version on homog0.85 and
  hetero0.85 uncut at the six init proportions and against the golden
  file's fcfs / backfill blocks; the event step's workload axis is held
  against the plain step at both cohorts' widths, fault-free (666 lanes)
  and under the fault axis (5 328 lanes), in `kernel_step` and
  `kernel_run`;
- the DES while-loop engine: `simulate_packet` over the same 222 lanes of
  both flows in one call each, one launch of the while-loop kernel a call
  (the group-formation decision inlined), beside its plain lockstep
  version (`impl="torch"`, the decision kernel once per lockstep
  formation); `run_packet_grid(mode="seq")` on three cells (one kernel
  launch a cell) and the legacy `vmap_k` / `vmap_s` layouts; each held
  against the fused grid (group counts and `ok` equal, metrics within
  rtol 1e-5 in float32 and 1e-12 in float64, the reference's own bounds);
- LM serving: `repro_torch.launch.serve.main` on granite-3-2b at full
  width and depth (40 layers, bf16, random weights from seed 0), 4 prompts
  of 2048 tokens, 32 new tokens each (flash-attention kernel in every
  layer of the prefill);
- hybrid serving: `repro_torch.launch.serve.main` on recurrentgemma-2b at
  full width and depth (26 layers, bf16, random weights from seed 0), 4
  prompts of 2048 tokens replayed one decode step a token (the ring of
  2048 slots wraps), 32 new tokens; no kernel on the decode path (gated:
  none launched); one `forward` over the replayed tokens (RG-LRU and
  attention kernels) against the replay's last 16 positions, reported;
  gated: (a) the full-width model in float32, B 1, the window cut to 64,
  96 tokens decoded against one `forward` at every position, and (b) the
  reduced config on the card against the same port on the CPU;
- the MoE and VLM branches of the decoder-only LM: pixtral-12b at full
  width and depth (40 layers, bf16, ~11.6 B random parameters),
  `generate` with patch embeddings at the first 1024 positions of 4
  prompts of 2048 tokens, 32 new tokens; qwen2-moe-a2.7b at full width
  and depth (24 layers, 60 experts top-4 and a shared expert) through
  `launch.serve.main` at the same shape, the share of the prefill's token
  choices dropped at capacity printed; arctic-480b at full width, its
  depth cut from 35 layers to 1 (128 experts top-2 and a dense residual,
  a GQA group of 7), one prompt of 2048 tokens, 8 new; each gated on one
  attention-kernel launch a layer in the prefill; then one qwen2-moe MoE
  layer at full width in float32 (both dispatches against the per-token
  dense mixture with capacity for every choice, and against each other
  under the config's drops), and the reduced pixtral, qwen2-moe and
  arctic `generate` and the reduced pixtral and qwen2-moe training on the
  card against the same on the CPU;
- the xLSTM and encoder-decoder families: `launch.serve.main` on
  xlstm-1.3b at full width and depth (48 blocks, 7 mLSTM : 1 sLSTM, bf16,
  ~1.9 B random parameters), 4 prompts of 512 tokens replayed one decode
  step a token, 32 new tokens, no kernel launched (gated), one `forward`
  against the replay's last 16 positions (reported), and gated: the
  full-width model in float32 cut to one pattern period (8 blocks), 130
  tokens decoded against one `forward`; then seamless-m4t-large-v2 at full
  width and depth (24 + 24 layers, bf16, ~1.37 B parameters) with frames
  [4, 512, 1024] drawn by launch/serve.py: one bidirectional
  attention-kernel launch an encoder layer and none in the teacher-forced
  replay or the decode (gated), the first and last encoder layers held
  against the plain attention, one `forward` against the replay's last
  16 positions (reported); the reduced xlstm and seamless `generate` and
  training on the card against the CPU join the MoE / VLM ones;
- the ML cluster: examples/cluster_scheduling_torch.py's sweep (300 jobs,
  8 k's, failures and stragglers) with `ClusterSim`'s policy calls on the
  card, its integer counters equal to a CPU run's;
- LM training: `repro_torch.launch.train.main` on recurrentgemma-2b at full
  width and depth (26 layers, bf16, random weights from seed 0), 3 AdamW
  steps of 2 x 4096 tokens (RG-LRU kernel forward and reverse in every
  recurrent layer, flash-attention kernel in every attention layer);
- checkpoints: `launch.train.main --ckpt-dir` on reduced
  recurrentgemma-2b on the card, 4 steps saving every 2, then `--resume`
  to 6; the same steps in memory saved by the async manager, stepped in
  place, restored;
- the assigned cell grid (`cells_path`): the meta dry run of all 32 cells
  (`launch/dryrun.py`, in worker processes off the card once every
  earlier phase has ended), then, through `dryrun.run_requested`,
  recurrentgemma-2b and xlstm-1.3b `long_500k` and recurrentgemma-2b `decode_32k` at their assigned shapes
  (decode steps from seeded caches at position seq - 1; no kernel
  launched, gated) and recurrentgemma-2b `prefill_32k` at the largest
  batch whose estimate fits (8 attention and 18 RG-LRU launches a
  prefill, gated); each cell's measured peak beside its estimate; both
  kernels at S = 32 768 against their plain versions at the gates below
  (at the prefill's batch: the attention's last 2 048 query rows of its
  first and last batch rows, the RG-LRU forward whole), and timed at the
  prefill's layer beside their bounds and SDPA;
- the multi-card path (`multicard_path`): N = torch.cuda.device_count()
  ranks under `torchrun --standalone --nproc-per-node N`, each on its own
  card, joined by `launch/multihost.py` (NCCL): both flows' 666-lane fault
  grids and the homog cohort study under paper_sweep.py's fault axis
  (5 328 lanes), their lane axes padded and split over the ranks, held
  bitwise against this process's one-rank fused runs; then the
  prefill_32k cells that fit four cards through `launch/dryrun.py --run
  --mesh` on the data x model mesh of the N cards (DTensor placements of
  the parameters' logical axes, the kernels and the recurrent families'
  time loops through `local_map` on each rank's shards): granite-3-2b in
  the DES ranks' group, then yi-6b, starcoder2-7b, phi3-medium-14b,
  pixtral-12b, seamless-m4t-large-v2, recurrentgemma-2b and xlstm-1.3b,
  each in a group of its own on four cards (MULTICARD_CELL_SECONDS), and
  xlstm-1.3b's float32 check in one more; on one card each family once
  (MULTICARD_ONE_CARD_ARCHS: not starcoder2-7b and phi3-medium-14b, yi's
  path at other widths), all in one group at B 2 (1 x 1 mesh; xlstm-1.3b
  cut to 8 of its 48 blocks and seamless-m4t-large-v2 to 6 + 6 of its
  24 + 24 layers there, MULTICARD_ONE_CARD_LAYERS); on four
  (data 2 x model 2) at the assigned B 32 x 32 768 where the per-card
  estimate (`dryrun.per_card_fit`, computed beforehand in workers off the
  card) fits and at the largest batch that fits where it does not (under
  `reduced`); with their collectives, seconds (the warm prefill split by
  CUDA events into its all-reduces and the rest, the xLSTM's sLSTM blocks
  apart), per-rank bytes beside the per-card estimate and launches, the
  last position's logits against one-card runs of the same seed.
  ``--only multicard_path`` runs only env, the builds and this phase, for
  a call on four cards (``multicard_path_des``, ``_dense``,
  ``_encdec_hybrid`` and ``_xlstm`` split it over four calls);
- the train step on a mesh (`multicard_train`): the cells of
  MULTICARD_TRAIN_CELLS, granite-3-2b train_4k at full width under tp,
  dp_zero1 and dp_zero3, pixtral-12b train_4k (the VLM family, its
  patch-embedding prefix spliced into the token embedding) and
  qwen2-moe-a2.7b train_4k (the MoE family: the einsum dispatch, its aux
  loss and the share of choices dropped printed) under tp
  (`launch/dryrun.py --run --mesh --strategy`, `launch.train --mesh`),
  each in a torchrun group of its own on four cards at the batch its
  per-card estimate admits, all on a 1 x 1 mesh at B 2 x 1 024 and 8
  layers on one card (``--only multicard_train_tp``, ``_dp_zero1``,
  ``_dp_zero3`` run one granite group, ``multicard_train_vlm`` pixtral's,
  ``multicard_train_moe`` qwen2-moe's;
  on four cards dp_zero3's also writes the per-card records of yi-6b,
  starcoder2-7b and phi3-medium-14b train_4k under dp_zero3, and
  pixtral's those of its train_4k cell under dp_zero1 and dp_zero3); its
  gates and their reasons are in `phase_multicard_train`'s docstring
  (the loss and gradient norm against one card on the same global batch at
  1e-2 / 5e-2 relative: bf16 runs that sum in another order; the gradient
  leaves at MULTICARD_LOGIT_TOL, for the reason given below for the
  logits; the first moment at 1e-6: the same float32 product; on four cards
  `launch.train`'s first loss at MULTICARD_TRAIN_SAME_TOL of the
  runner's cold step, which runs the same model on the same first batch,
  and, where the gates' pass runs every layer too (granite), its first
  step at that tolerance of the pass's and its loss falling over its
  steps).

`--profile` adds `serve_profile`: a warm prefill and 8 decode steps under
`torch.profiler` (device time by kind of kernel, idle share), and
`train_profile`, a warm training step the same way. It is off by default
because the profiler's first session in a process costs seconds of
set-up.

It needs one CUDA device and `nvcc`; with no device it exits non-zero and
prints no result. The last line of its standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

Tolerances of the kernel-vs-plain comparisons:

- event step: integer columns and group-log keys equal; float columns at
  most 2 ulp apart (the build uses -fmad=false and no fast math, so each
  operation rounds as PyTorch's elementwise ops do and the expected
  difference is 0; 2 ulp leaves room for a libm `log` that differs in its
  last bit); under the chaos axis, on a 1000-job cut, the engine's
  results the same way (integers equal, floats within 2 ulp);
- the chaos streams: bitwise (integer arithmetic); the service on the
  card against the CPU: decisions equal, waits / lost work / weights
  within rtol 1e-5 (float32) / 1e-12 (float64), as `seq_path`;
- group-formation decision: `j` and `m` equal; `dur` and `work` at most
  2 ulp apart (built like the event step, so the expected difference is
  0);
- baselines: job start times, run-start times and the makespan bitwise
  (0 ulp); jobs started, `ok` and `budget_exhausted` equal; the queue,
  busy and useful integrals at most 2 ulp apart (built like the event
  step; expected 0); the golden fcfs / backfill blocks within rtol 1e-9
  in float64; the cohorts: every field bitwise the members' own grids;
- while-loop engine: the final state's integer columns (group-log keys
  and node counts, counters, iterations), `n_groups`, `ok` and
  `budget_exhausted` equal; every float column of the final state, the
  group log and the job times at most 2 ulp apart (built like the event
  step; the expected difference is 0);
- flash attention: |kernel - plain| <= atol + tol * |plain| elementwise.
  float32 (the CUDA-core kernel): tol = atol = 2e-5 (sums in another
  order, FMA, CUDA's `expf`). bfloat16 (the Hopper kernel): tol = 2e-2
  (the output's rounding, as tests/test_kernels.py:46) and atol = 2e-2
  times the root mean square of the plain output. The two sides no longer
  round the same float32 result: the kernel's products run on the tensor
  cores with float32 sums in another order, and it carries p into the P.V
  product as two bf16 terms (hi + lo, about 2^-16 of p), where the plain
  version keeps p in float32; the outputs still differ by about one bf16
  step, 2^-7 * |plain|. A late row of a long causal sequence averages
  thousands of keys and is about 0.05 in size, so a fixed 2e-2 would let a
  kernel that drops a tile of keys pass. The attention backward (plain
  PyTorch, not a kernel) is held against autograd through the plain
  forward with the same bf16 bound.
- RG-LRU recurrence, forward and reverse: the same form of bound. float32:
  rtol 2e-4, atol 2e-5 (the reference's own tolerance for its kernel
  against its oracle, on inputs of unit size: the recurrence summed in
  another order, FMA, CUDA's `expf`); bfloat16 inputs: rtol 2e-2 and atol
  2e-2 times the RMS of the plain output, as for attention (outputs
  rounded once to bf16). A float32 / bfloat16 pair is held at the bound
  of each output's type. The cases with decays near 1, which keep a carry
  across every tile and block edge, draw b and dh at the scale the model's
  gates give them, so that the outputs stay of unit size (`lru_inputs`). The recurrent layers captured on the training
  path are held at the float32 bound with atol the smaller of 2e-5 and
  2e-4 times the plain output's RMS: their gradients are those of a mean
  over 8192 tokens, far below unit size (so that a fixed 2e-5 would pass
  an output of zeros), and their decays, near 1, sum thousands of steps
  (dlog_a's largest difference there is about 5e-5 of its RMS).
- the training step's first loss and gradient norm, kernels against both
  plain versions at reduced depth: relative difference at most
  TRAIN_PLAIN_GATE (a few times the measured gap).
- hybrid and xLSTM serving: (a) decode against forward in float32 at rtol
  = atol = 2e-2 (tests/test_archs.py's, for the bf16 KV cache both sides
  keep, and the xLSTM's one-token steps against its chunks of 64);
  (b) card against CPU on the reduced float32 config: every step's logits
  within 1e-4, and the greedy token equal wherever the CPU's top-2 gap
  exceeds 1e-3 (float32 matrix products summed in another order).
- the MoE layer in float32: |got - want| <= 2e-5 + 2e-4 * |want|
  (tests/test_archs.py:127's bound for the same oracle): float32 products
  summed in another order. The reduced MoE / VLM configs, card against
  CPU: greedy tokens equal, prefill logits and train losses within 1e-4
  (float32 throughout, the attention kernel held at 2e-5, the rest summed
  in another order).
- the ML cluster: integer counters equal to the CPU's (the float32 policy
  calls round alike on both; the float difference is printed).
- checkpoints: every restored leaf bitwise the saved one, bf16 included;
  the first resumed step's loss within rtol 2e-5 (the train gate of the
  tests) of the same step from the state in memory (expected: equal).
- the multi-card path: the split DES grids bitwise the one-rank grids (a
  lane does not depend on what shares its dispatch); each model cell's
  last-position logits within MULTICARD_LOGIT_TOL = 0.1 relative L2
  (||got - want|| / ||want|| over the vocabulary's entries; the padded
  ones, masked to -1e30, would swamp both norms) of the one-card B 1
  references, rows 0 and B - 1, and their greedy tokens equal or tied.
  The issue asks for equal tokens; a tie (the reference's margin between
  the two tokens at most MULTICARD_TIE = 2^-6 of its top logit, 2 bf16
  steps) is let pass because two bf16 runs that round differently can
  swap a top-2 pair one step apart, as random weights leave them. On a
  1 x 1 mesh every local tensor is the whole one and the expected
  difference is 0. On data 2 x model 2 each output projection is two bf16
  partial sums added by the all-reduce, and cuBLAS may split the narrower
  products otherwise, so each reduced product rounds differently (about
  2^-9 of its size). A bf16 run is itself that far from its float32 twin:
  on the CPU, 40 layers at d 1 024 on a model-2 mesh measured 0.022
  against one process, which was 0.018 from float32. A wrong split (a
  head on the wrong rank, a missing or doubled sum, a wrong vocabulary
  shard) moves the logits by their own size, 1e0; 0.1 sits between.
  xlstm-1.3b is the exception on four cards: with random weights it
  amplifies any rounding difference along the sequence, so its bf16 last
  logits are printed, not gated (`logits_gated` false on its line). It is
  held in float32 at its full length S 32 768, cut to 8 blocks, B 4: the
  logits at MULTICARD_FLOAT32_POSITIONS of that one run within
  MULTICARD_FLOAT32_TOL = 1e-2 of one-card B 1 prefills up to position
  MULTICARD_FLOAT32_GATED = 1 023 (greedy tokens equal or tied there),
  printed beyond, beside a witness: one card's row 0 with its embedding
  table scaled by 1 + 2^-22, whose drift from the unscaled run at the
  last position must exceed MULTICARD_LOGIT_TOL. The kernel launches a
  prefill on every rank (`dryrun.prefill_counts`: the attention kernel
  once an attention layer, the RG-LRU forward once a recurrent layer) and,
  where the model axis has 2 cards, the all-reduces (one after the embedding
  and one after each output projection, each of a rank's [B/data, S, d]
  bf16 activations) are gated exactly; each rank's peak beside its
  per-card estimate is printed (MULTICARD_PEAK_BAND, the band the
  estimate should hold), not gated.

Float32 matrix products run in full float32: TF32 is switched off for
matmuls and cuDNN before anything runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import importlib.util
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np
import torch

from repro_torch.ckpt import (CheckpointManager, restore_checkpoint,
                              save_checkpoint)
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import cohort as cohort_mod
from repro_torch.core import des, schedulers, sweep
from repro_torch.core.metrics import (SCALAR_METRIC_FIELDS, Metrics,
                                      efficiency_metrics)
from repro_torch.kernels import build
from repro_torch.kernels.baselines import kernel as base_kernel
from repro_torch.kernels.baselines import ops as base_ops
from repro_torch.kernels.flash_attention import kernel as attn_kernel
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)
from repro_torch.kernels.packet_select import kernel as select_kernel
from repro_torch.kernels.packet_select import ops as select_ops
from repro_torch.kernels.packet_select.ref import packet_select_ref
from repro_torch.kernels.packet_step import kernel as step_kernel
from repro_torch.kernels.packet_step import ops as step_ops
from repro_torch.kernels.packet_while import kernel as while_kernel
from repro_torch.kernels.packet_while import ops as while_ops
from repro_torch.kernels.rglru_scan import kernel as lru_kernel
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.configs import SHAPES, cells
from repro_torch.launch import dryrun, serve, sim, train
from repro_torch.launch import service as service_launch
from repro_torch.launch.mesh import FOUR_CARD
from repro_torch.models import encdec, hybrid, layers, lm, moe, xlstm
from repro_torch.models.layers import unembed
from repro_torch.models.registry import get_family
from repro_torch.serve.engine import generate, make_serve_step
from repro_torch.sharding.policy import single_device_policy
from repro_torch.train import data as train_data
from repro_torch.train.optim import AdamWConfig, global_norm, tree_leaves
from repro_torch.train.step import (init_state, make_loss_fn, make_train_step,
                                    state_for)
from repro_torch.service import ServiceConfig, run_service
from repro_torch.workload.lublin import (WorkloadParams, generate_workload,
                                         paper_workloads)
from repro_torch.workload.windows import (drift_scenarios, iter_windows,
                                          slice_window, WindowSpec)

ULP_BOUND = 2.0
SEG = des.SCAN_SEG
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ATTN_CASES = [
    # B, Sq, Skv, H, KV, hd, causal, window, softcap
    (2, 64, 64, 4, 2, 32, True, 0, 0.0),        # tests/test_kernels.py:24-31
    (1, 128, 128, 8, 8, 64, True, 0, 0.0),
    (2, 48, 48, 4, 1, 32, True, 16, 0.0),       # MQA + local window
    (1, 32, 96, 4, 2, 32, True, 0, 0.0),        # prefix offset (Skv > Sq)
    (2, 64, 64, 4, 4, 32, False, 0, 0.0),       # bidirectional
    (1, 40, 40, 2, 2, 16, True, 0, 0.0),        # ragged
    (1, 64, 64, 4, 4, 32, True, 0, 20.0),       # softcap 20
    (4, 2048, 2048, 32, 8, 64, True, 0, 0.0),   # granite-3-2b, main-path size
    (1, 512, 512, 10, 1, 256, True, 256, 0.0),  # recurrentgemma-2b layout
    (1, 1024, 1024, 32, 4, 128, True, 0, 0.0),  # yi-6b / phi3 / starcoder2
    (1, 1000, 1000, 8, 2, 64, True, 0, 0.0),    # ragged: not a multiple of 64
    (1, 1000, 1000, 10, 1, 256, True, 384, 0.0),  # ragged at hd 256, window
    (1, 40, 300, 10, 1, 256, True, 128, 0.0),   # Sq < 64, prefix, window
    (1, 512, 512, 8, 2, 128, True, 0, 30.0),    # softcap at hd 128
    (4, 2048, 2048, 32, 8, 128, True, 0, 0.0),  # pixtral-12b, main-path size
    (4, 2048, 2048, 16, 16, 128, True, 0, 0.0),  # qwen2-moe-a2.7b (MHA)
    (1, 2048, 2048, 56, 8, 128, True, 0, 0.0),  # arctic-480b: GQA group 7
    (4, 3072, 3072, 16, 16, 64, False, 0, 0.0),  # seamless encoder, MEMORY_LEN
    (4, 512, 512, 16, 16, 64, False, 0, 0.0),   # seamless encoder, its path
]
# largest |kernel - plain| of the CUDA-core bfloat16 kernel that the Hopper
# kernel replaced, on the first nine cases (the float32 kernel is the same
# kernel as then); H100 80GB HBM3 at 700 W; printed beside this run's,
# not gated
PREV_ATTN_ERR = {
    torch.float32: (5.960464477539062e-07, 1.0132789611816406e-06,
                    5.960464477539062e-07, 4.76837158203125e-07,
                    5.364418029785156e-07, 3.5762786865234375e-07,
                    8.344650268554688e-07, 1.430511474609375e-06,
                    1.3709068298339844e-06),
    torch.bfloat16: (7.62939453125e-06, 0.0009765625, 0.0, 0.000244140625,
                     3.814697265625e-06, 3.814697265625e-06, 0.0,
                     0.00390625, 0.0009765625),
}
GRANITE_CASE = ATTN_CASES[7]
SERVE_ARCH = "granite-3-2b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_SEED = 4, 2048, 32, 0
VLM_ARCH, MOE_ARCH, ARCTIC_ARCH = "pixtral-12b", "qwen2-moe-a2.7b", \
    "arctic-480b"
XLSTM_ARCH, ENCDEC_ARCH = "xlstm-1.3b", "seamless-m4t-large-v2"
#: the attention kernel's layer of each served architecture (seamless's
#: encoder at the reference's MEMORY_LEN frames)
LAYER_CASES = {SERVE_ARCH: GRANITE_CASE, VLM_ARCH: ATTN_CASES[14],
               MOE_ARCH: ATTN_CASES[15], ARCTIC_ARCH: ATTN_CASES[16],
               ENCDEC_ARCH: ATTN_CASES[17]}
ENCDEC_PATH_CASE = ATTN_CASES[18]   # the encoder layer of encdec_serve_path
ARCTIC_LAYERS, ARCTIC_BATCH, ARCTIC_NEW = 1, 1, 8   # depth cut from 35
MOE_LAYER_SHAPE = (2, 256)      # the float32 MoE layer gate: B, S
MOE_LAYER_TOL = (2e-4, 2e-5)    # rtol, atol: tests/test_archs.py:127
LM_REDUCED = (2, 24, 6)         # reduced card-vs-CPU: batch, prompt, new
LM_CPU_TOL = 1e-4               # prefill logits and train losses
LM_TRAIN_STEPS = 2
HYBRID_ARCH = "recurrentgemma-2b"     # served at granite's serve_path shape
HYBRID_TAIL = 16                # replayed positions held against a forward
HYBRID_F32_WINDOW, HYBRID_F32_TOKENS = 64, 96   # gate (a): the ring wraps
HYBRID_FORWARD_TOL = 2e-2       # tests/test_archs.py's rtol = atol
HYBRID_REDUCED = (2, 40, 8)     # gate (b): batch, prompt, new tokens
HYBRID_CPU_TOL, HYBRID_GAP = 1e-4, 1e-3
# the xLSTM and encoder-decoder serving paths: prompts of 512 tokens, a cut
# from granite's 2048 (each prompt token is one eager decode step); the
# recurrent replays cut further, host-bound at ~42 ms (recurrentgemma) and
# ~125 ms (xlstm) a step: HYBRID_PROMPT from 2048, XLSTM_PROMPT from 512
RECUR_PROMPT = 512
HYBRID_PROMPT = 512
XLSTM_PROMPT = 128
XLSTM_F32_TOKENS = 130          # float32 gate: chunks of 64, the last padded
CKPT_BATCH, CKPT_SEQ, CKPT_SEED = 2, 64, 0
CKPT_STEPS, CKPT_RESUME_STEPS = 4, 6
CKPT_LOSS_RTOL = 2e-5           # the train gate of tests/test_torch_train.py
LRU_TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (2e-2, 2e-2)}
LRU_CASES = [
    # B, S, D, with_h0, decays near 1 (see `lru_inputs`)
    (2, 64, 128, False, False),     # tests/test_kernels.py:64-70
    (1, 128, 256, True, False),
    (2, 50, 100, True, False),      # S and D not multiples of the block
    (1, 8, 512, False, False),
    (2, 4096, 2560, False, False),  # recurrentgemma-2b, main-path size
    (2, 4096, 2560, True, False),
    # each below also with one mixed pair (`lru_runs`): carries a tile or
    # block edge must not lose, under decays that keep them
    (2, 4096, 2560, True, True),    # the trained gates' regime
    (2, 1, 2560, True, True),       # S shorter than one tile
    (2, 8, 2560, False, True),
    (2, 4095, 2560, True, True),    # S one off a tile multiple
    (1, 4097, 2560, False, True),
    (2, 4096, 8, True, True),       # D a quarter of a column
    (2, 4096, 100, False, True),    # D a ragged last column
    (1, 300, 37, True, True),       # D odd
    (8, 4097, 530, True, True),     # 136 columns, the last ragged
]
LRU_MAIN = LRU_CASES[4]
LRU_MIXED_CASE = LRU_CASES[2]   # log_a and b of different types
LRU_EDGE_CASES = LRU_CASES[6:]  # each in both types and one mixed pair
TRAIN_PLAIN_GATE = {"loss": 5e-5, "grad_norm": 5e-4}
TRAIN_ARCH = "recurrentgemma-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_SEED = 2, 4096, 3, 0
# the recurrentgemma-2b attention layer of the training path
RG_ATTN_CASE = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 10, 1, 256, True, 2048, 0.0)
PLAIN_COMPARE_LAYERS = 5        # one (rec, rec, attn) repeat + the tail
CHAOS = dict(mtbf_chip_hours=50.0, ckpt_period=300.0, straggler_prob=0.05,
             straggler_factor=1.5, straggler_deadline=2.0)
# the plain version's prefix of each whole dispatch of kernel_run (0.7-2.5
# s a segment, host-bound; the kernel runs every dispatch to its end)
PLAIN_RUN_SEGMENTS = 5
SELECT_SHAPES = [(T, H) for T in (1, 222, 4096) for H in (1, 8, 130)]
SELECT_TIMED = [(222, 8, torch.float32), (222, 8, torch.float64),
                (1 << 20, 8, torch.float32)]
SELECT_GRAPH_LAUNCHES = 200     # launches captured in one CUDA graph
SEQ_RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}
SEQ_CELLS = (0, 18, 36)         # smallest, middle and largest k, S = 0.05
# the plain lockstep versions (host-bound) run on the first WHILE_CUT_JOBS
# jobs of a flow: `seq_path` and `baselines` hold the kernels against them
# there; `while_kernel` runs on a generated workload of WHILE_KERNEL_JOBS
WHILE_CUT_JOBS = 1000
WHILE_KERNEL_JOBS = 300
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "golden_metrics.json")
# the chaos grid: launch/service.py's 3-cell fault axis over the paper grid
CHAOS_SEQ_LANES = (0, 1, 200, 443, 664, 665)   # flat lanes run by mode=seq
CHAOS_STREAM_LANES = (0, 1, 665)   # streams held against the CPU's draw
CHAOS_CUT_KS = (50.0, 200.0, 1000.0)   # k rows of the kernel-vs-plain cut
# the service: launch/service.py's defaults (intensity_step, 2000 jobs on
# 100 nodes, 8 segments, windows of 250, s_prop 0.05, risk lambda 0.1)
SERVICE_RUNS = (("fault-free", []), ("chaos", ["--chaos"]),
                ("float64", ["--float64"]))
SERVICE_TRACE = dict(n_jobs=2000, nodes=100, n_segments=8)
SERVICE_WINDOW = 250
SERVICE_CPU_WINDOWS = 5    # the CPU side's cut: the trace's first 5 windows
SERVICE_ORACLE_WINDOW = 4  # the window whose [K, C] block is held to the grid
# the fault axis of benchmarks/paper_sweep.py :: chaos_grid_config(seed=0):
# MTBF (50, 200 h) x checkpoint period (120, 600 s) x straggler factor
# (1.5, 4.0), 8 cells, the checked-in paper_chaos_grid.json's axis
PAPER_CHAOS = dict(mtbf_chip_hours=np.repeat([50.0, 200.0], 4),
                   ckpt_period=np.tile(np.repeat([120.0, 600.0], 2), 2),
                   straggler_prob=0.1,
                   straggler_factor=np.tile([1.5, 4.0], 4),
                   straggler_deadline=2.0, seed=0)
CHAOS_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "benchmarks", "results", "paper_chaos_grid.json")
# the assigned cell grid (cells_path): the meta dry run of all 32 cells in
# worker processes off the card, after every earlier phase has ended
CELLS_DRYRUN_WORKERS = 6
CELLS_RUN = ("recurrentgemma-2b:long_500k", "xlstm-1.3b:long_500k",
             "recurrentgemma-2b:decode_32k", "recurrentgemma-2b:prefill_32k")
CELLS_PREFILL_LAUNCHES = {"flash_attention": 8, "lru_forward": 18,
                          "lru_reverse": 0}     # one recurrentgemma prefill
CELLS_ATTN_ROWS = 2048          # query rows of the S = 32 768 kernel check
# the multi-card path (multicard_path): N ranks under torchrun, one card each
MULTICARD_CELL = "granite-3-2b:prefill_32k"
MULTICARD_ONE_CARD_BATCH = 2    # a cell's batch on a mesh of one card (B 1
                                # on a data axis is a view DTensor refuses)
MULTICARD_ONE_CARD_SEQ = 4096   # its length there, cut from 32 768: the
                                # 1 x 1 mesh exercises the code paths, four
                                # cards the full length
MULTICARD_SECONDS = 600         # the ranks' limit; then all are killed
MULTICARD_LOGIT_TOL = 0.1       # relative L2 of the last logits, see above
# the other prefill_32k cells within four cards, cheapest first, each in a
# torchrun group of its own on four cards (a group's DTensor state cannot
# reach the next cell), all in one group on one card
MULTICARD_ARCHS = ("yi-6b", "starcoder2-7b", "phi3-medium-14b",
                   "pixtral-12b", "seamless-m4t-large-v2",
                   "recurrentgemma-2b", "xlstm-1.3b")
# on one card each family once: starcoder2-7b and phi3-medium-14b take
# yi-6b's dense GQA path at other widths, and run on four cards only
MULTICARD_ONE_CARD_ARCHS = ("yi-6b", "pixtral-12b", "seamless-m4t-large-v2",
                            "recurrentgemma-2b", "xlstm-1.3b")
# depths cut on one card, where a host-bound time loop (xLSTM) or the
# plain float32 cross attention over 32 768 frames (seamless) would take
# minutes of the one-card run's limit; four cards run every layer
MULTICARD_ONE_CARD_LAYERS = {"xlstm-1.3b": 8, "seamless-m4t-large-v2": 6}
MULTICARD_CELL_SECONDS = 600    # a cell's group's limit on four cards
# The issue asks for greedy tokens equal to one card's. Two bf16 runs that
# round their products differently can swap a top-2 pair whose gap is a
# bf16 step, so differing tokens count as a tie where the one-card
# reference's margin between the two is at most 2 bf16 steps of its top
# logit (the first four-card call's strict gate failed on yi-6b and
# pixtral-12b row 31, one step apart)
MULTICARD_TIE = 2.0 ** -6
# xlstm-1.3b with random weights amplifies any rounding difference along
# the sequence, so its last-position logits at S 32 768 cannot be held
# against one card. It is held in float32 at its full length, cut to one
# pattern period (7 mLSTM + 1 sLSTM blocks), B 4: logits at these
# positions of the one run against one-card B 1 prefills, within
# MULTICARD_FLOAT32_TOL at positions up to MULTICARD_FLOAT32_GATED (16
# mLSTM chunks, 1 024 sLSTM steps) and printed beyond; beside them a
# witness, the one-card row 0 again with its embedding table scaled by
# 1 + 2^-22 (a rounding-sized change), whose drift at the last position
# must exceed MULTICARD_LOGIT_TOL, or the exception is not warranted
MULTICARD_FLOAT32_LAYERS = {"xlstm-1.3b": 8}
MULTICARD_FLOAT32_BATCH = 4
MULTICARD_FLOAT32_POSITIONS = (0, 63, 511, 1023, 2047, 4095, 8191, 16383,
                               32767)
MULTICARD_FLOAT32_GATED = 1023
MULTICARD_FLOAT32_TOL = 1e-2    # relative L2; a wrong split moves it by 1
MULTICARD_FLOAT32_WITNESS = 2.0 ** -22
MULTICARD_CUT_SECONDS = 600     # the one-card group's limit, all the cells
MULTICARD_PEAK_BAND = (0.85, 1.05)  # measured peak / per-card estimate
# sharded decode (multicard_decode): the decode_32k cells within four cards,
# each on its mesh (phi3-medium-14b's 10 KV heads do not divide a model
# axis of 2 or 4, so its policy is seq_kv, the cache's time axis over
# "model", on data 1 x model 4), each in a torchrun group of its own on
# four cards, all three on a 1 x 1 mesh in one group at B 2 on one card
MULTICARD_DECODE = {"starcoder2-7b": {"data": 2, "model": 2},
                    "xlstm-1.3b": {"data": 2, "model": 2},
                    "phi3-medium-14b": {"data": 1, "model": 4}}
# a decode cell's group's limit: the three cells took 47.8 s in one group
# on one card at B 2 (NVIDIA H100 80GB HBM3, 700 W)
MULTICARD_DECODE_SECONDS = 300
# each cache tensor's rows 0 and B - 1 after the steps (the written K/V
# slot; the xLSTM's whole states) against the one-card B 1 runs': relative
# L2 within the logits' gate. On one card (1 x 1, B 2) the B 1 runs alone,
# other bf16 products, moved them up to 0.041 (xlstm's sLSTM c) and the
# logits up to 0.051
MULTICARD_CACHE_TOL = 0.1
# the step's collective bytes against a rank's cache shard, xlstm-1.3b:
# its mLSTM state must not be gathered
MULTICARD_DECODE_BYTES_SHARE = 0.01
DEC_TAG = "/decode"             # a group running `decode_cell_on_ranks`
# the train step on a mesh (multicard_train): train_4k cells at full width
# and depth on the data x model mesh, each an (arch, strategy) pair, each in
# a torchrun group of its own on four cards at the largest batch whose
# per-card estimate fits; all in one group on one card (1 x 1) at
# MULTICARD_TRAIN_ONE_CARD's batch, length and depth (cuts; launch.train,
# which takes no depth, at every layer there). granite-3-2b under tp (what
# `resolve` gives on data 2 x model 2), dp_zero1 and dp_zero3 (forced, as
# the dry run allows); pixtral-12b, the VLM family, and qwen2-moe-a2.7b,
# the MoE family, under tp (`resolve`'s)
MULTICARD_TRAIN_ARCH = "granite-3-2b"
MULTICARD_TRAIN_STRATEGIES = ("tp", "dp_zero1", "dp_zero3")
MULTICARD_TRAIN_VLM_ARCH = "pixtral-12b"
MULTICARD_TRAIN_MOE_ARCH = "qwen2-moe-a2.7b"
MULTICARD_TRAIN_CELLS = tuple(
    (MULTICARD_TRAIN_ARCH, s) for s in MULTICARD_TRAIN_STRATEGIES) + (
    (MULTICARD_TRAIN_VLM_ARCH, "tp"), (MULTICARD_TRAIN_MOE_ARCH, "tp"))
# the dense configs whose train_4k cell the reference's `resolve` gives
# dp_zero3 on its single pod: their per-card records on data 2 x model 2
# (meta, off the card, beside dp_zero3's runs on four cards; not run)
MULTICARD_TRAIN_ZERO3_RECORDS = ("yi-6b", "starcoder2-7b", "phi3-medium-14b")
# a cell's per-card records under the strategies it is not run at (four
# cards; meta, off the card, beside its group): pixtral-12b's under
# dp_zero1 (no batch fits) and dp_zero3
MULTICARD_TRAIN_RECORDS_ONLY = {MULTICARD_TRAIN_VLM_ARCH: ("dp_zero1",
                                                           "dp_zero3")}
MULTICARD_TRAIN_ONE_CARD = (2, 1024, 8)
# the one-card length where MULTICARD_TRAIN_ONE_CARD's is no longer than
# the arch's prefix: pixtral-12b's 1 024 patch embeddings would leave no
# text position, every label -1 and the loss 0
MULTICARD_TRAIN_ONE_CARD_SEQ = {MULTICARD_TRAIN_VLM_ARCH: 2048}
# on four cards, the depth of the gates' pass and its one-card reference
# where one card cannot hold the whole model's float32 gradients (a cut;
# the runner and launch.train run every layer): pixtral-12b at 20 of 40
# layers holds 12.2 GB of bf16 parameters, 24.5 GB of float32 gradients
# and a micro-batch's 12.2 GB of bf16 ones (the reference's peak is
# printed, `one_card_peak_bytes`); qwen2-moe-a2.7b's reference takes its
# B 18 whole (an MoE model's aux loss is not linear in the rows): its meta
# estimate (the one-card gradient pass under `MetaRun`) is 67.56 GB at 20
# of 24 layers, 76.70 GB at 24, over the 72 GB a cell may claim
MULTICARD_TRAIN_GATE_LAYERS = {MULTICARD_TRAIN_VLM_ARCH: 20,
                               MULTICARD_TRAIN_MOE_ARCH: 20}
# the archs whose launch.train runs --reduced on one card: 12.2 B
# (pixtral) and 14.3 B (qwen2-moe) parameters with their AdamW moments do
# not fit one card
MULTICARD_TRAIN_ONE_CARD_REDUCED = (MULTICARD_TRAIN_VLM_ARCH,
                                    MULTICARD_TRAIN_MOE_ARCH)
# an MoE cell's leaves are held in float32, by the gates' pass at this
# (batch, layers) and the cell's length against one card's float32 run of
# the same rows (MULTICARD_FLOAT32_TOL): in bf16 a rounding moves which
# choices a layer routes or drops (a third of them at capacity 342 under a
# random router), and so its leaves. One card's two dispatches, gather and
# einsum, both right, gave leaves 0.37 apart in bf16 and 1.7e-6 in float32
# (reduced qwen2-moe at d 256, 60 experts top-4, 8 layers, on the CPU);
# the bf16 leaves are printed, the bf16 loss and grad norm gated
MULTICARD_TRAIN_FLOAT32 = (2, 8)
# ... its depth on one card (a cut): 8 layers' 4.88 B parameters in float32
# with their gradients and AdamW moments are 78.0 GB before activations,
# more than the card holds; 4 layers' 2.59 B are 41.5 GB
MULTICARD_TRAIN_FLOAT32_ONE_CARD_LAYERS = 4
MULTICARD_TRAIN_SECONDS = 900   # a strategy's group's limit
# the whole run's workers making the records of multicard_path,
# multicard_decode and multicard_train while cells_path runs (a cut for
# time: the card waited ~85 s for them); few, beside cells_path's own
MULTICARD_EARLY_RECORD_WORKERS = 3
MULTICARD_TRAIN_STEPS = 4       # launch.train.main's steps on the stream
# ... on one card, where its losses are only held finite (a cut for time)
MULTICARD_TRAIN_ONE_CARD_STEPS = 2
MULTICARD_TRAIN_MICRO_ROWS = 4  # rows a micro-batch of the one-card run
# against the one-card run of the same global batch (its micro-batches'
# float32 gradients against the mesh's bf16 ones): relative differences
MULTICARD_TRAIN_TOL = {"loss": 1e-2, "grad_norm": 5e-2}
# the first moment after one AdamW step against (1 - b1) x the clipped
# gradient given to it: the same float32 product on each rank's shard
MULTICARD_MOMENT_TOL = 1e-6
# launch.train's first step against the gates' pass where both run every
# layer (four cards): the same seed, first batch, placements and code, so
# equal but for any reduction whose order on the cards may vary between
# calls (bitwise equal in the first four-card run): relative, loss and
# grad norm
MULTICARD_TRAIN_SAME_TOL = 1e-5
TRAIN_TAG = "/train."           # a group running `train_cell_on_ranks`
BASELINE_WORKSPACE_RING = 10_000    # 24 B a slot in float64: past 227 KB
BASELINE_CAP_ITERS = 500        # events a lane on the workspace case: a cap
                                # (a lane of 1 000 jobs takes ~2 000)


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# set-up of one dispatch at the paper's size
# --------------------------------------------------------------------------

class Dispatch:
    """The operands of one 222-lane dispatch over a paper workload."""

    device = torch.device("cuda", 0)

    def __init__(self, wl, dtype, with_chaos: bool, seed: int = 0,
                 ring: int | None = None):
        dev = self.device
        self.wl, self.with_chaos, self.W = wl, with_chaos, 1
        self.pw = des.pack_workload(wl, dtype, dev)
        self.tdt = self.pw.submit.dtype
        self.N, self.H = self.pw.n_jobs, self.pw.n_types
        self.M = int(wl.params.nodes)
        self.ring = des.resolve_ring(self.M, self.N, ring)
        ks = np.repeat(np.asarray(sweep.PAPER_SCALE_RATIOS, dtype),
                       len(sweep.PAPER_INIT_PROPS))
        ss = np.tile(np.asarray([wl.init_time_for_proportion(p)
                                 for p in sweep.PAPER_INIT_PROPS], dtype),
                     len(sweep.PAPER_SCALE_RATIOS))
        self.T = len(ks)
        self.k = torch.tensor(ks, device=dev).reshape(1, -1)
        self.s = torch.tensor(ss, device=dev).reshape(1, -1)
        self.p_j = torch.ones((self.H,), dtype=self.tdt, device=dev)
        self.tmax_j = torch.full((self.H,), 3600.0, dtype=self.tdt,
                                 device=dev)
        self.t_last = self.pw.t_last_submit.reshape(1, 1)
        self.R = 0
        self.kw = {}
        if with_chaos:
            chaos = des.ChaosConfig(max_requeues=self.N, **CHAOS)
            self.R = des.resolve_max_requeues(chaos, self.N)
            rng = np.random.default_rng(seed)
            u = rng.random((2, self.N + self.R, self.T)).astype(dtype)
            self.kw = dict(
                u1=torch.tensor(u[0], device=dev),
                u2=torch.tensor(u[1], device=dev),
                chaos_params=des.chaos_param_columns(chaos, self.T, self.tdt,
                                                     dev))
        self.budget = des.event_budget(self.N, self.R)
        self.n_segs = -(-self.budget // SEG)

    def initial_state(self):
        return des.initial_scan_state(self.H, self.ring, self.T, self.M,
                                      self.tdt, self.pw.submit.device)

    def new_logs(self, rows):
        dev = self.pw.submit.device
        return (torch.full((rows, self.T), des.KEY_PAD, dtype=torch.int32,
                           device=dev),
                torch.zeros((rows, self.T), dtype=self.tdt, device=dev),
                torch.zeros((rows, self.T), dtype=torch.int32, device=dev),
                torch.zeros((rows, self.T), dtype=self.tdt, device=dev))

    def steps(self, state, n_steps, step_impl, logs=None, log_offset=0):
        pw = self.pw
        return step_ops.packet_event_steps(
            pw.tj_prefw, pw.tj_submit, pw.submit, pw.jtype, self.k, self.s,
            self.p_j, self.tmax_j, self.t_last, state, logs=logs,
            log_offset=log_offset, n_steps=n_steps, r_cap=self.R,
            step_impl=step_impl, **self.kw)

    def any_active(self, state) -> bool:
        return bool(des.lane_active(state, self.N, self.with_chaos).any())

    def label(self):
        return (f"N={self.N} M={self.M} ring={self.ring} T={self.T} "
                f"{str(self.tdt).replace('torch.', '')} "
                f"chaos={'on' if self.with_chaos else 'off'}")

    def plan(self) -> dict:
        """The event-step kernel's launch plan for this dispatch: one lane
        a block, one warp a lane."""
        return dict(lanes_per_block=1, **step_kernel.launch_plan(
            self.H, self.ring, self.tdt == torch.float64)._asdict())


class CohortDispatch(Dispatch):
    """The operands of one cohort dispatch as `run_cohort_grid` gives them:
    W members of 222 lanes each, W * 222 lanes over the stacked tables;
    with `chaos` (a fault axis of C cells), 222 * C lanes a member, the
    streams (drawn as the engine draws them) and the fault columns
    ``[*, L]`` shared by the members."""

    def __init__(self, cohort, chaos: des.ChaosConfig | None = None):
        dev = self.device
        self.wl, self.with_chaos, self.W = None, chaos is not None, \
            cohort.n_workloads
        self.cohort = cohort
        self.pw = cohort.pack(dev)
        self.tdt = self.pw.submit.dtype
        self.N, self.H = self.pw.n_jobs, self.pw.n_types
        self.M, self.ring = cohort.m_nodes, cohort.ring
        K, S = len(sweep.PAPER_SCALE_RATIOS), len(sweep.PAPER_INIT_PROPS)
        C = sweep.chaos_axis_len(chaos)
        ks = np.repeat(np.asarray(sweep.PAPER_SCALE_RATIOS, cohort.dtype),
                       S * C)
        ss = [np.repeat(np.tile(np.asarray(
            [wl.init_time_for_proportion(p) for p in sweep.PAPER_INIT_PROPS],
            cohort.dtype), K), C) for wl in cohort.workloads]
        self.L = len(ks)
        self.T = self.W * self.L
        self.k = torch.tensor(np.tile(ks, self.W), device=dev).reshape(1, -1)
        self.s = torch.tensor(np.concatenate(ss), device=dev).reshape(1, -1)
        self.p_j = torch.ones((self.H,), dtype=self.tdt, device=dev)
        self.tmax_j = torch.full((self.H,), 3600.0, dtype=self.tdt,
                                 device=dev)
        self.t_last = self.pw.t_last_submit.reshape(self.W, 1)
        self.R, self.kw = des.resolve_max_requeues(chaos, self.N), {}
        if chaos is not None:
            lanes = sweep.chaos_lane_grid(chaos, K * S, cohort.dtype)[0]
            u1, u2 = des._chaos_streams(lanes, None, None, self.N + self.R,
                                        self.L, self.tdt, dev)
            self.kw = dict(u1=u1, u2=u2, chaos_params=des.chaos_param_columns(
                lanes, self.L, self.tdt, dev))
        self.budget = des.event_budget(self.N, self.R)
        self.n_segs = -(-self.budget // SEG)

    def label(self):
        return (f"cohort {self.cohort.label} W={self.W} x {self.L} lanes, "
                f"T={self.T}, ring={self.ring} "
                f"chaos={'on' if self.with_chaos else 'off'}")


def clone_state(state):
    return des.ScanState(*(c.clone() for c in state))


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in units of the last place; equal infinities are 0."""
    same = (a == b)
    if bool(same.all()):
        return 0.0
    a64, b64 = a.double(), b.double()
    mag = torch.maximum(a.abs(), b.abs())
    spacing = (torch.nextafter(mag, torch.full_like(mag, float("inf")))
               - mag).double()
    d = torch.where(same, torch.zeros_like(a64), (a64 - b64).abs() / spacing)
    d = torch.nan_to_num(d, nan=float("inf"))
    return float(d.max())


class Worst:
    """Largest kernel-vs-plain differences seen so far."""
    ulp = 0.0
    abs_err = 0.0


def compare(got_state, got_logs, want_state, want_logs, label):
    """Kernel result against the plain version's, per the stated bound."""
    for name, g, w in zip(des.ScanState._fields, got_state, want_state):
        if name not in des.FLOAT_STATE_COLS and not torch.equal(g, w):
            fail(f"{label}: integer column {name} differs")
    for name, g, w in zip(("key", "t", "m", "head_w"), got_logs, want_logs):
        if name in ("key", "m") and not torch.equal(g, w):
            fail(f"{label}: group-log {name} differs")
    floats = [(n, getattr(got_state, n), getattr(want_state, n))
              for n in des.FLOAT_STATE_COLS]
    floats += [("log_t", got_logs[1], want_logs[1]),
               ("log_head_w", got_logs[3], want_logs[3])]
    worst = 0.0
    for name, g, w in floats:
        u = ulp_diff(g, w)
        if u > ULP_BOUND:
            fail(f"{label}: float column {name} differs by {u} ulp "
                 f"(bound {ULP_BOUND})")
        worst = max(worst, u)
        finite = torch.isfinite(g) & torch.isfinite(w)
        if bool(finite.any()):
            Worst.abs_err = max(Worst.abs_err, float(
                (g[finite].double() - w[finite].double()).abs().max()))
    Worst.ulp = max(Worst.ulp, worst)
    return worst


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_env():
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True)
    emit("env", nvidia_smi=nvidia_smi_line(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         nvcc=nvcc.stdout.strip().splitlines()[-2:])


def start_builds(pool):
    """The kernels' libraries, one nvcc per source, started together.
    Returns {kernel module: future of its build's seconds}."""
    def timed_load(mod):
        t0 = time.perf_counter()
        mod.load()
        return time.perf_counter() - t0
    return {m: pool.submit(timed_load, m)
            for m in (step_kernel, attn_kernel, lru_kernel, select_kernel,
                      while_kernel, base_kernel)}


def phase_build(mod, built, describe=None):
    """Waits for one library's build and prints its ptxas lines (and, with
    `describe`, what it reads from the log per instantiation). Returns the
    build's seconds and its log."""
    secs = built.result()
    lib = build.library_path(build.CSRC_DIR / f"{mod.SOURCE}.cu", mod.FLAGS)
    log = lib.with_suffix(".log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    extra = {} if describe is None else {"instantiations": describe(log)}
    emit("build", seconds=secs, library=lib.name, ptxas=ptxas, **extra)
    return secs, log


def attention_instantiations(log: str) -> list:
    """Registers and spills of each attention kernel instantiation, read
    from the ptxas lines of its build log, with its dynamic shared memory
    (the library's own count)."""
    rows, cur = [], None
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            name = entry.group(1)
            kind = "sm90" if "sm90" in name else "cuda_cores"
            hd = int(re.search(r"attn_kernelILi(\d+)E", name).group(1))
            dtype = torch.bfloat16 if kind == "sm90" else torch.float32
            cur = dict(kernel=kind, dtype=str(dtype).replace("torch.", ""),
                       hd=hd, smem_bytes=attn_kernel.smem_bytes(dtype, hd))
            rows.append(cur)
        elif cur is not None and "spill stores" in ln:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", ln).groups()
            cur.update(spill_store_bytes=int(st), spill_load_bytes=int(ld))
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
    return sorted(rows, key=lambda r: (r["kernel"], r["hd"]))


def while_instantiations(log: str) -> list:
    """Registers and spills of each while-kernel instantiation, read from
    the ptxas lines of its build log, with the dynamic shared bytes its
    launch plan gives a lane of the paper's flows (homog0.85 in float32,
    ring 100; hetero0.85 in float64, ring 500; 8 types)."""
    rows, cur = [], None
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            f, chaos, smem = re.search(
                r"packet_while_kernelI([fd])Lb([01])ELb([01])E",
                entry.group(1)).groups()
            is_f64, chaos, in_smem = f == "d", chaos == "1", smem == "1"
            ring = 500 if is_f64 else 100
            cur = dict(dtype="float64" if is_f64 else "float32",
                       chaos=chaos, ring_in_smem=in_smem,
                       smem_bytes=(while_kernel.lane_smem_bytes(
                           ring, 8, is_f64, chaos) if in_smem else 0),
                       smem_shape=f"ring {ring}, 8 types")
            rows.append(cur)
        elif cur is not None and "spill stores" in ln:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", ln).groups()
            cur.update(spill_store_bytes=int(st), spill_load_bytes=int(ld))
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
    return sorted(rows, key=lambda r: (r["dtype"], r["chaos"],
                                       r["ring_in_smem"]))


def step_shapes(flows):
    """The dispatches `kernel_step` holds: the paper's two flows in both
    types, then rings the launch plan treats apart (shorter than a warp,
    not a multiple of 32, and columns too long for shared memory)."""
    shapes = [(flows[flow], dtype, None)
              for flow, dtype in (("homog0.85", np.float32),
                                  ("homog0.85", np.float64),
                                  ("hetero0.85", np.float32),
                                  ("hetero0.85", np.float64))]
    m16 = generate_workload(WorkloadParams(nodes=16, homogeneous=True,
                                           seed=1, daily_amplitude=0.3))
    m333 = generate_workload(WorkloadParams(nodes=333, seed=0))
    shapes += [(m16, np.float32, None), (m16, np.float64, None),
               (m333, np.float64, None)]
    # one lane's grp_end alone exceeds the 227 KB a block may opt into
    for dtype, itemsize in ((np.float32, 4), (np.float64, 8)):
        ring = step_kernel.SMEM_OPTIN // itemsize + 64
        shapes.append((flows["hetero0.85"], dtype, ring))
    return shapes


def paper_cohorts(flows):
    """The paper's six flows as benchmarks/paper_sweep.py groups them."""
    return cohort_mod.group_workloads(
        flows, {name: paper_dtype(wl) for name, wl in flows.items()})


def step_check(d: Dispatch):
    """n_steps = 1 against the plain step, from the initial state and from
    states the kernel reached after 3, 700, 2500 and 9000 steps."""
    state = d.initial_state()
    worst, at = 0.0, []
    done = 0
    for warm in (0, 3, 700, 2500, 9000):
        if warm > done:     # advance with the kernel itself
            d.steps(state, warm - done, "cuda")
            done = warm
        a, b = clone_state(state), clone_state(state)
        _, la = d.steps(a, 1, "cuda")
        _, lb = d.steps(b, 1, "torch")
        torch.cuda.synchronize()
        worst = max(worst, compare(a, la, b, lb, f"kernel_step {d.label()} "
                                                 f"after {warm} steps"))
        at.append(warm)
    emit("kernel_step", shape=d.label(), plan=d.plan(),
         states_after_steps=at, max_ulp=worst, ulp_bound=ULP_BOUND, ok=True)


def phase_kernel_step(flows):
    """n_steps = 1 from the initial state and from states taken mid-run,
    all eight instantiations (float32/float64 x chaos off/on x the ring in
    shared or device memory), the paper's rings and the shapes of
    `step_shapes`; then the workload axis at the widths the cohort study
    gives it: both paper cohorts, 3 x 222 = 666 lanes fault-free and
    3 x 1 776 = 5 328 lanes under paper_sweep.py's 8-cell fault axis (the
    streams and fault columns shared by the members, read at lane % L)."""
    for wl, dtype, ring in step_shapes(flows):
        for with_chaos in (False, True):
            step_check(Dispatch(wl, dtype, with_chaos, ring=ring))
    chaos = des.ChaosConfig(**PAPER_CHAOS)
    for c in paper_cohorts(flows):
        for axis in (None, chaos):
            step_check(CohortDispatch(c, axis))


def run_check(d: Dispatch, prefix: int):
    """The dispatch from its initial state to its end on the kernel, held
    against the plain version segment by segment on its first `prefix`
    segments (a fixed prefix: the plain version is host-bound). Returns
    the plain version's ms a segment."""
    a, b = d.initial_state(), d.initial_state()
    la, lb = d.new_logs(d.n_segs * SEG), d.new_logs(d.n_segs * SEG)
    worst, segs, plain_s = 0.0, 0, 0.0
    while segs < d.n_segs and d.any_active(a):
        d.steps(a, SEG, "cuda", la, segs * SEG)
        torch.cuda.synchronize()
        if segs < prefix:
            t0 = time.perf_counter()
            d.steps(b, SEG, "torch", lb, segs * SEG)
            torch.cuda.synchronize()
            plain_s += time.perf_counter() - t0
            rows = slice(segs * SEG, (segs + 1) * SEG)
            worst = max(worst, compare(
                a, tuple(x[rows] for x in la), b,
                tuple(x[rows] for x in lb),
                f"kernel_run {d.label()} segment {segs}"))
        segs += 1
    compared = min(segs, prefix)
    whole = not d.any_active(a)
    emit("kernel_run", shape=d.label(), segments=segs,
         segments_compared=compared, steps_compared=compared * SEG,
         budget=d.budget, whole_dispatch=whole,
         note=(("every lane drained" if whole else "the budget's end")
               + f" on the kernel; held against the plain version on its "
               f"first {compared} segments"),
         n_groups_total=int(a.n_groups.sum()),
         requeues_total=int(a.requeues.sum()),
         plain_seconds=plain_s, max_ulp=worst, ulp_bound=ULP_BOUND, ok=True)
    return 1e3 * plain_s / compared


def phase_kernel_run(flows):
    """A whole dispatch at full width on the kernel, held against the
    plain version segment by segment on its first PLAIN_RUN_SEGMENTS:
    homog0.85 float32 chaos off, then on, then hetero0.85 float64 (ring
    500); then the cohorts: M100-N5000-float32 fault-free (666 lanes),
    M500-N5000-float64 under the 8-cell fault axis (5 328 lanes). Returns
    the plain version's ms per segment (homog, chaos off), for the kernels
    line."""
    plain_ms = None
    for flow, dtype, with_chaos in (("homog0.85", np.float32, False),
                                    ("homog0.85", np.float32, True),
                                    ("hetero0.85", np.float64, False)):
        ms = run_check(Dispatch(flows[flow], dtype, with_chaos),
                       PLAIN_RUN_SEGMENTS)
        plain_ms = ms if plain_ms is None else plain_ms
    cohorts = {c.label: c for c in paper_cohorts(flows)}
    run_check(CohortDispatch(cohorts["M100-N5000-float32"]),
              PLAIN_RUN_SEGMENTS)
    run_check(CohortDispatch(cohorts["M500-N5000-float64"],
                             des.ChaosConfig(**PAPER_CHAOS)),
              PLAIN_RUN_SEGMENTS)
    return plain_ms


def check_golden():
    """The repo's own check of what comes out: the float64 golden grid
    (tests/golden/golden_metrics.json, `packet` block), on the card."""
    with open(GOLDEN) as f:
        gold = json.load(f)
    spec = gold["spec"]
    worst = 0.0
    for name, params in spec["workloads"].items():
        wl = generate_workload(WorkloadParams(**params))
        grid = sweep.run_packet_grid(wl, ks=spec["ks"],
                                     s_props=spec["s_props"],
                                     dtype=np.float64, mode="fused")
        want = gold["grids"][name]["packet"]
        if grid.n_groups.tolist() != want["n_groups"] or not grid.ok.all():
            fail(f"golden {name}: group counts differ")
        for f_ in SCALAR_METRIC_FIELDS:
            g, w = np.asarray(getattr(grid, f_)), np.asarray(want[f_])
            floor = {"avg_qlen": 1e-6, "full_util": 1e-6,
                     "useful_util": 1e-6}.get(f_, 1e-3)
            rel = float(np.max(np.abs(g - w) / np.maximum(np.abs(w), floor)))
            if not rel <= 1e-9:
                fail(f"golden {name}/{f_}: rel deviation {rel} > 1e-9")
            worst = max(worst, rel)
    return worst


def phase_main_path(flows):
    """`run_packet_grid` through the normal entry point, both paper flows,
    all 222 cells, fused and chunked. Returns the launch count and the
    fused grid of each flow."""
    step_ops.packet_event_steps.launches = 0
    ks = sweep.PAPER_SCALE_RATIOS
    fused = {}
    for flow, dtype in (("homog0.85", np.float32), ("hetero0.85", np.float64)):
        wl = flows[flow]
        grids, walls, launched = {}, {}, {}
        # in turns, so that neither layout is the only one to run cold
        for mode in ("fused", "chunked", "chunked", "fused"):
            before = step_ops.packet_event_steps.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = sweep.run_packet_grid(wl, dtype=dtype, mode=mode)
            torch.cuda.synchronize()
            walls.setdefault(mode, []).append(time.perf_counter() - t0)
            launched[mode] = step_ops.packet_event_steps.launches - before
            grids[mode] = g
        for mode, g in grids.items():
            if g.avg_wait.shape != (len(ks), len(sweep.PAPER_INIT_PROPS)):
                fail(f"main_path {flow}/{mode}: wrong grid shape")
            if not g.ok.all() or g.budget_exhausted.any():
                fail(f"main_path {flow}/{mode}: a cell is not ok")
            for f_ in SCALAR_METRIC_FIELDS:
                if not np.isfinite(getattr(g, f_)).all():
                    fail(f"main_path {flow}/{mode}: {f_} is not finite")
            for f_ in ("full_util", "useful_util"):
                u = getattr(g, f_)
                if u.min() < 0.0 or u.max() > 1.0:
                    fail(f"main_path {flow}/{mode}: {f_} outside [0, 1]")
            if launched[mode] < 1:
                fail(f"main_path {flow}/{mode}: the CUDA kernel never ran")
            thr = sweep.plateau_threshold(np.asarray(ks), g.avg_wait[:, 0])
            if not (np.isfinite(thr.threshold) and np.isfinite(thr.plateau)):
                fail(f"main_path {flow}/{mode}: plateau is not finite")
            events = int((wl.n_jobs + 2 * g.n_groups.astype(np.int64)).sum())
            wall = min(walls[mode])
            emit("main_path", flow=flow, n_jobs=wl.n_jobs,
                 m_nodes=int(wl.params.nodes), lanes=int(g.ok.size),
                 dtype=str(np.dtype(dtype)), mode=mode,
                 plan=sweep.sweep_plan(mode, g.ok.size, dtype=dtype),
                 run_order="fused, chunked, chunked, fused",
                 wall_seconds_runs=walls[mode], wall_seconds=wall,
                 launches=launched[mode], events=events,
                 events_per_second=events / wall,
                 plateau_k=thr.threshold, plateau_wait=thr.plateau, ok=True)
        for f_ in grids["fused"]._fields:
            if not np.array_equal(getattr(grids["fused"], f_),
                                  getattr(grids["chunked"], f_)):
                fail(f"main_path {flow}: fused and chunked differ in {f_}")
        fused[flow] = grids["fused"]
    launches = step_ops.packet_event_steps.launches
    emit("main_path_check", fused_equals_chunked=True,
         golden_max_rel_dev=check_golden(), golden_rtol=1e-9,
         launches=launches, ok=True)
    return launches, fused


def phase_stages(flows):
    """Where a fused grid's wall time goes: the three stages of
    `run_packet_grid`, each ended by a synchronise, on the host's clock."""
    for flow, dtype in (("homog0.85", np.float32), ("hetero0.85", np.float64)):
        wl = flows[flow]
        d = Dispatch(wl, dtype, False)      # lane arrays; warms the allocator
        best = None
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pw = des.pack_workload(wl, dtype)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = des.simulate_packet_scan_lanes(pw, d.k[0], d.s[0], d.M)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            m = efficiency_metrics(pw.submit, res, d.M, pw.t_last_submit)
            host = [x.cpu().numpy() for x in m]
            t3 = time.perf_counter()
            run = dict(pack_seconds=t1 - t0, engine_seconds=t2 - t1,
                       metrics_seconds=t3 - t2, total_seconds=t3 - t0)
            if best is None or run["total_seconds"] < best["total_seconds"]:
                best = run
        if not np.isfinite(host[0]).all():
            fail(f"stages {flow}: avg_wait is not finite")
        emit("main_path_stages", flow=flow, shape=d.label(), mode="fused",
             runs=3, best_of="total_seconds", **best)


def time_kernel(d: Dispatch):
    """CUDA-event time of a whole fused dispatch's launches at the main
    path's shapes, and what bounds the same work. Returns a dict."""
    # the number of segments the engine runs: until no lane is active
    state = d.initial_state()
    logs = d.new_logs(d.n_segs * SEG)
    segs = 0
    while segs < d.n_segs and d.any_active(state):
        d.steps(state, SEG, "cuda", logs, segs * SEG)
        segs += 1
    events = int((d.N + 2 * state.n_groups.long()).sum())
    times = []
    for _ in range(3):
        state = d.initial_state()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(segs):
            d.steps(state, SEG, "cuda", logs, i * SEG)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / segs)
    # bound: every operand read once, every output written once per launch;
    # operations counted for the events this run's data needed
    fsz = 8 if d.tdt == torch.float64 else 4
    tables = d.W * ((d.H * (d.N + 1) + d.H * d.N + d.N) * fsz + d.N * 4)
    lane_params = (2 * d.T + 2 * d.H + 1) * fsz
    state_bytes = sum(c.numel() * c.element_size() for c in state)
    log_bytes = SEG * d.T * (2 * 4 + 2 * fsz)
    bytes_per_launch = tables + lane_params + 2 * state_bytes + log_bytes
    # per event: the ring scan (3 compares a slot), the type loop (about 14
    # float/integer operations a type) and about 40 scalar operations
    ops_per_event = 3 * d.ring + 14 * d.H + 40
    ops_per_launch = ops_per_event * events / segs
    t_bytes = 1e3 * bytes_per_launch / HBM_BYTES_PER_S
    t_ops = 1e3 * ops_per_launch / FP32_OPS_PER_S
    return dict(shape=d.label(), plan=d.plan(), lanes=d.T,
                segments=segs, events=events,
                ms=min(times), ms_runs=times,
                ns_per_lane_step=1e6 * min(times) / SEG,
                ns_per_event=1e6 * min(times) * segs / events,
                bytes_per_launch=bytes_per_launch,
                ops_per_launch=ops_per_launch,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# the group-formation decision kernel and the while-loop engine (seq path)
# --------------------------------------------------------------------------

class SelectWorst:
    """Largest kernel-vs-plain decision difference seen so far."""
    ulp = 0.0
    abs_err = 0.0


def select_inputs(T: int, H: int, dtype, seed: int):
    """Decision operands on the card from a seed. From T = 16 on, the last
    five rows are the cases a random draw does not make: an all-empty row,
    two tied types, no free nodes, s = 0, and a tiny k whose node threshold
    exceeds 2**31."""
    dev = Dispatch.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev,
                                  dtype=torch.float64)
    sum_w, s_j = u(T, H) * 1e4, u(T, H) * 10 + 1
    p_j, oldest, t_max = 0.5 + 1.5 * u(T, H), u(T, H) * 100, \
        600 + 3000 * u(T, H)
    nonempty = u(T, H) > 0.3
    nonempty[:, 0] = True
    now, k = 200 + 1000 * u(T), 0.1 + 5 * u(T)
    m_free = torch.floor(1 + 100 * u(T)).to(torch.int32)
    if T >= 16:
        empty, tie, no_free, s_zero, tiny_k = range(T - 5, T)
        nonempty[empty] = False
        if H > 1:
            for a in (s_j, p_j, oldest, t_max):
                a[tie, -1] = a[tie, 0]
            sum_w[tie, 0] = sum_w[tie, -1] = 1e6
            nonempty[tie, -1] = True
        m_free[no_free] = 0
        s_j[s_zero] = 0.0
        k[tiny_k] = 1e-9
        sum_w[tiny_k] *= 1e3
    f = lambda a: a.to(dtype).contiguous()
    return (f(sum_w), f(s_j), f(p_j), f(oldest), f(t_max),
            nonempty.contiguous(), f(now), f(k), m_free)


def select_bytes_and_ops(T: int, H: int, dtype):
    """What one decision launch must move and compute: five [T, H] float
    operands and the bool mask read once, now / k / m_free read, j / m /
    dur / work written; per type about 9 operations (divide, subtract,
    max, divide, add, two multiplies, select, compare), per row 8."""
    fsz = torch.finfo(dtype).bits // 8
    nbytes = 5 * T * H * fsz + T * H + 2 * T * fsz + 4 * T + 4 * T \
        + 3 * T * fsz
    return nbytes, 9 * T * H + 8 * T


def time_select(T: int, H: int, dtype):
    """Kernel and plain version at one shape, in turns, by CUDA events:
    `ms`, the kernel's device time per launch, from a CUDA graph of
    SELECT_GRAPH_LAUNCHES wrapper calls replayed (so the host's time per
    call does not hide it); `stream_ms`, per call when the wrapper is
    called back to back (what the engine pays); and the bound."""
    args = select_inputs(T, H, dtype, seed=7)
    kernel = lambda: select_ops.fused_packet_select(*args, impl="cuda")
    kernel()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(SELECT_GRAPH_LAUNCHES):
            kernel()
    fns = {"graph": lambda: graph.replay(), "stream": kernel,
           "plain": lambda: packet_select_ref(*args)}
    runs = {name: [] for name in fns}
    order = ("graph", "stream", "plain", "plain", "stream", "graph")
    for name in order:
        runs[name].append(cuda_ms(fns[name], 5 if name == "graph" else 100)
                          / (SELECT_GRAPH_LAUNCHES if name == "graph"
                             else 1))
    nbytes, ops = select_bytes_and_ops(T, H, dtype)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / FP32_OPS_PER_S
    return dict(shape=f"T={T} H={H} {str(dtype).replace('torch.', '')}",
                ms=min(runs["graph"]), stream_ms=min(runs["stream"]),
                plain_ms=min(runs["plain"]), runs_ms=runs,
                run_order=", ".join(order), bytes=nbytes, ops=ops,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_select_kernel():
    """The decision kernel against its plain version on the card, both
    types, every listed shape; then its times. Returns the times."""
    shapes = []
    for dtype in (torch.float32, torch.float64):
        for T, H in SELECT_SHAPES:
            args = select_inputs(T, H, dtype, seed=1000 * T + H)
            got = select_ops.fused_packet_select(*args, impl="cuda")
            want = packet_select_ref(*args)
            torch.cuda.synchronize()
            label = f"T={T} H={H} {str(dtype).replace('torch.', '')}"
            for name, g, w in zip(("j", "m"), got[:2], want[:2]):
                if not torch.equal(g, w):
                    fail(f"select_kernel {label}: {name} differs")
            worst = 0.0
            for name, g, w in zip(("dur", "work"), got[2:], want[2:]):
                u = ulp_diff(g, w)
                if u > ULP_BOUND:
                    fail(f"select_kernel {label}: {name} differs by {u} "
                         f"ulp (bound {ULP_BOUND})")
                worst = max(worst, u)
                SelectWorst.abs_err = max(SelectWorst.abs_err, float(
                    (g.double() - w.double()).abs().max()))
            SelectWorst.ulp = max(SelectWorst.ulp, worst)
            shapes.append(dict(shape=label, max_ulp=worst))
    times = [time_select(*shape) for shape in SELECT_TIMED]
    emit("select_kernel", launches=select_ops.fused_packet_select.launches,
         launches_note="comparison and timing launches of this phase, "
                       "not of a path", shapes=shapes, j_m_equal=True,
         max_ulp=SelectWorst.ulp, ulp_bound=ULP_BOUND,
         max_abs_err=SelectWorst.abs_err, times=times, ok=True)
    return times


def check_grid(got: Metrics, want: Metrics, rtol: float, label: str):
    """`got` against the fused lane engine's grid: group counts and `ok`
    equal, every float metric within `rtol`. Returns the largest relative
    deviation."""
    if not (np.array_equal(got.n_groups, want.n_groups)
            and np.array_equal(got.ok, want.ok) and got.ok.all()):
        fail(f"{label}: group counts or ok differ from the fused grid")
    worst = 0.0
    for f_ in SCALAR_METRIC_FIELDS:
        g = np.asarray(getattr(got, f_), np.float64)
        w = np.asarray(getattr(want, f_), np.float64)
        if not np.all(np.abs(g - w) <= rtol * np.abs(w)):
            fail(f"{label}: {f_} differs from the fused grid beyond rtol "
                 f"{rtol}")
        dev = np.abs(g - w) / np.maximum(np.abs(w), 1e-300)
        worst = max(worst, float(np.max(np.where(g == w, 0.0, dev))))
    return worst


class WhileWorst:
    """Largest kernel-vs-plain while-engine difference seen so far."""
    ulp = 0.0
    abs_err = 0.0


class WhileCapture:
    """Stands in for `packet_while` in its module, so that `launches` is
    the wrapper's own count (the wrapper adds to it through its module's
    name): passes every call on, ends it with a synchronize, and keeps each
    call's arguments, final state, counts and host seconds."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, counts = self.fn(*args, **kw)
        torch.cuda.synchronize()
        self.calls.append(dict(args=args, kw=kw, state=state,
                               counts=dict(counts),
                               seconds=time.perf_counter() - t0))
        return state, counts


def while_runs(pw, k, s, M, impls, **kw):
    """`simulate_packet` through its normal entry point, once per entry of
    `impls` ("cuda": no `impl`, the default on the card; "torch": the plain
    lockstep engine by name), in that order. Gates each call
    on its launches: the kernel once and no decision launch; the plain
    version no kernel launch and one decision launch per lockstep
    formation. Returns one dict per run: the DesResult, the final state,
    the counts, the host seconds of the call and of the wrapper."""
    cap = WhileCapture(while_ops.packet_while)
    while_ops.packet_while = cap
    runs = []
    try:
        for impl in impls:
            stats = {}
            sel0 = select_ops.fused_packet_select.launches
            while0 = while_ops.packet_while.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = des.simulate_packet(
                pw, k, s, M, stats=stats,
                impl=None if impl == "cuda" else "torch", **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            sel = select_ops.fused_packet_select.launches - sel0
            launched = while_ops.packet_while.launches - while0
            if impl == "cuda" and (launched, sel) != (1, 0):
                fail(f"while engine: the kernel's call made {launched} "
                     f"packet_while and {sel} select launches, expected 1 "
                     f"and 0")
            if impl == "torch" and (launched, sel) != (0, stats["inner"]):
                fail(f"while engine: the plain call made {launched} "
                     f"packet_while launches and {sel} select launches for "
                     f"{stats['inner']} lockstep formations")
            call = cap.calls[-1]
            runs.append(dict(impl=impl, res=res, state=call["state"],
                             call=call, stats=stats, seconds=seconds,
                             wrapper_seconds=call["seconds"],
                             select_launches=sel, while_launches=launched))
    finally:
        while_ops.packet_while = cap.fn
    return runs


def compare_while(got, want, label):
    """The kernel's final state and DesResult against the plain version's:
    the integer columns (group log keys and node counts, counters, `iters`,
    `n_groups`) and `ok` / `budget_exhausted` equal, every float column of
    the state and the job times within ULP_BOUND. Returns the largest ulp
    difference."""
    gs, ws = got["state"], want["state"]
    for name, g, w in zip(des.DesState._fields, gs, ws):
        if name not in des.FLOAT_DES_COLS and not torch.equal(g, w):
            fail(f"{label}: integer column {name} differs")
    for name in ("ok", "budget_exhausted"):
        if not torch.equal(getattr(got["res"], name),
                           getattr(want["res"], name)):
            fail(f"{label}: {name} differs")
    floats = [(n, getattr(gs, n), getattr(ws, n))
              for n in des.FLOAT_DES_COLS]
    floats += [(n, getattr(got["res"], n), getattr(want["res"], n))
               for n in ("start_t", "run_start_t")]
    worst = 0.0
    for name, g, w in floats:
        u = ulp_diff(g, w)
        if u > ULP_BOUND:
            fail(f"{label}: float column {name} differs by {u} ulp "
                 f"(bound {ULP_BOUND})")
        worst = max(worst, u)
        finite = torch.isfinite(g) & torch.isfinite(w)
        if bool(finite.any()):
            WhileWorst.abs_err = max(WhileWorst.abs_err, float(
                (g[finite].double() - w[finite].double()).abs().max()))
    WhileWorst.ulp = max(WhileWorst.ulp, worst)
    return worst


def while_plan(run) -> dict:
    """The kernel's launch plan for the call of `run`."""
    st = run["state"]
    H, ring = int(st.head.shape[1]), int(st.grp_end.shape[1])
    return while_kernel.launch_plan(
        H, ring, st.t.dtype == torch.float64,
        run["call"]["kw"].get("u1") is not None)._asdict()


def time_while(run):
    """The kernel's CUDA-event ms per call on the operands of `run`'s call
    (each launch from a fresh initial state), warm, the bound of the same
    work and ns per lane step. Launches made here are taken off the
    wrapper's count again."""
    args, kw = run["call"]["args"], dict(run["call"]["kw"], impl="cuda")
    st = run["state"]
    T, H = (int(x) for x in st.head.shape)
    ring, L = int(st.grp_end.shape[1]), int(st.log_key.shape[1])
    dtype, dev = st.t.dtype, st.t.device
    M, max_iters = args[10], args[11]
    fresh = [des.initial_des_state(H, ring, L, T, M, dtype, dev)
             for _ in range(4)]
    before = while_ops.packet_while.launches
    times = []
    for i, state in enumerate(fresh):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        while_ops.packet_while(*args[:9], state, M, max_iters, **kw)
        stop.record()
        torch.cuda.synchronize()
        if i:                           # the first launch warms up
            times.append(start.elapsed_time(stop))
    while_ops.packet_while.launches = before
    for name, g, w in zip(des.DesState._fields, fresh[-1], st):
        if not torch.equal(g, w):
            fail(f"time_while: a timed launch's {name} differs from the "
                 f"main run's")
    # bytes: the tables, lane parameters and chaos streams read once, the
    # state columns read once and written once, the group log written
    # once; operations: per lane step a ring scan (3 a slot), the type
    # pass (about 14 a type) and about 40 scalar ones, for the steps this
    # run's lanes took
    prefw, tsub, submit, jtype = args[:4]
    fsz = st.t.element_size()
    tables = sum(x.numel() * x.element_size()
                 for x in (prefw, tsub, submit, jtype))
    params = sum(x.numel() * x.element_size() for x in args[4:9])
    streams = sum(x.numel() * x.element_size()
                  for x in (kw.get("u1"), kw.get("u2"))
                  if x is not None)
    if kw.get("chaos_params") is not None:
        streams += 5 * T * fsz
    log_cols = ("log_key", "log_t", "log_m", "log_headw")
    state_bytes = sum(c.numel() * c.element_size()
                      for n, c in zip(des.DesState._fields, st)
                      if n not in log_cols)
    log_bytes = sum(getattr(st, n).numel() * getattr(st, n).element_size()
                    for n in log_cols)
    nbytes = tables + params + streams + 2 * state_bytes + log_bytes
    # each lane's outer iterations plus formations: its dependent chain
    steps = st.iters.long() + st.n_groups.long()
    ops = (3 * ring + 14 * H + 40) * int(steps.sum())
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / FP32_OPS_PER_S
    ms = min(times)
    return dict(ms=ms, ms_runs=times, plan=while_plan(run),
                lane_steps_max=int(steps.max()),
                lane_steps_total=int(steps.sum()),
                ns_per_lane_step=1e6 * ms / int(steps.max()),
                bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def cut_workload(n_jobs: int = WHILE_CUT_JOBS):
    """homog0.85's generator cut to `n_jobs` jobs over the same share of
    its horizon, so that its jobs keep their sizes."""
    p = WorkloadParams(nodes=100, load=0.85, homogeneous=True, seed=1,
                       daily_amplitude=0.3)
    return generate_workload(dataclasses.replace(
        p, n_jobs=n_jobs, horizon=p.horizon * n_jobs / p.n_jobs))


def first_jobs(wl, n: int):
    """The workload's first `n` jobs (by submit time), on its nodes."""
    cut = {f: getattr(wl, f)[:n] for f in ("submit", "runtime", "nodes",
                                           "work", "jtype")}
    return dataclasses.replace(wl, params=dataclasses.replace(
        wl.params, n_jobs=n), **cut)


def phase_while_kernel():
    """The while-loop kernel against its plain version through
    `simulate_packet`, on the paper's 222 (k, s) lanes of a workload cut to
    WHILE_KERNEL_JOBS jobs:
    chaos in float32 and float64 with the lanes' columns in shared memory;
    columns past the shared-memory opt-in (the device-memory
    instantiation) in float32 and in float64 under chaos; and a
    `max_iters` that exhausts some lanes (float64, device memory). With
    the paper's two flows in `seq_path` (float32 and float64, shared
    memory, chaos off) that is seven of the eight instantiations."""
    wl = cut_workload(WHILE_KERNEL_JOBS)
    cases = []
    for dtype, with_chaos, past_optin, exhaust in (
            (np.float32, True, False, False),
            (np.float64, True, False, False),
            (np.float32, False, True, False),
            (np.float64, True, True, False),
            (np.float64, False, True, True)):
        d = Dispatch(wl, dtype, with_chaos, seed=17)
        kw, label_ring = {}, d.ring
        if with_chaos:
            kw = dict(chaos=des.ChaosConfig(max_requeues=d.N, **CHAOS),
                      u1=d.kw["u1"], u2=d.kw["u2"])
        if past_optin:
            # the shortest ring whose lane columns exceed the opt-in
            label_ring = next(
                r for r in range(1, 1 << 20)
                if while_kernel.lane_smem_bytes(
                    r, d.H, dtype == np.float64, with_chaos)
                > while_kernel.SMEM_OPTIN)
            kw["ring"] = label_ring
        if exhaust:
            # half the lanes end before their loops do
            free = while_runs(d.pw, d.k[0], d.s[0], d.M, ("cuda",), **kw)
            kw["max_iters"] = int(
                free[0]["state"].iters.double().median())
        runs = while_runs(d.pw, d.k[0], d.s[0], d.M, ("cuda", "torch"),
                          **kw)
        kernel, plain = runs
        label = (f"N={d.N} M={d.M} ring={label_ring} T={d.T} "
                 f"{np.dtype(dtype).name} "
                 f"chaos={'on' if with_chaos else 'off'}"
                 + (f" max_iters={kw['max_iters']}" if "max_iters" in kw
                    else ""))
        worst = compare_while(kernel, plain, f"while_kernel {label}")
        exhausted = int(kernel["res"].budget_exhausted.sum())
        if exhaust and not 0 < exhausted < d.T:
            fail(f"while_kernel {label}: {exhausted} of {d.T} lanes "
                 f"exhausted, expected some and not all")
        if with_chaos and int(kernel["res"].requeues.sum()) < 1:
            fail(f"while_kernel {label}: chaos injected no fault")
        if not exhaust and not bool(kernel["res"].ok.all()):
            fail(f"while_kernel {label}: a lane is not ok")
        plan = while_plan(kernel)
        if past_optin == plan["ring_in_smem"]:
            fail(f"while_kernel {label}: launch plan {plan}")
        cases.append(label)
        emit("while_kernel", shape=label, plan=plan,
             groups=int(kernel["res"].n_groups.sum()),
             requeues=int(kernel["res"].requeues.sum()),
             failures=int(kernel["res"].failures.sum()),
             lanes_exhausted=exhausted,
             kernel_wrapper_seconds=kernel["wrapper_seconds"],
             plain_wrapper_seconds=plain["wrapper_seconds"],
             plain_lockstep_formations=plain["stats"]["inner"],
             max_ulp=worst, ulp_bound=ULP_BOUND, ok=True)
    return cases


def phase_seq_path(flows, fused):
    """The while-loop engine on the card. `simulate_packet` over all 222
    lanes of each paper flow in one call: the kernel (the normal entry
    point, one launch a call) twice, its final states bitwise each other
    and its metrics against the fused grid of `phase_main_path`; then on
    the flow's first WHILE_CUT_JOBS jobs the kernel and the plain lockstep
    engine (impl="torch", one select-kernel launch per lockstep
    formation, host-bound), their final states held against each other.
    Then `run_packet_grid(mode="seq")` (step_impl="torch": the same entry
    point, one cell a call, one kernel launch a cell) on three cells and
    the legacy vmap_k / vmap_s layouts on the whole homog0.85 grid.
    Returns the select and packet_while launches of this path and the
    kernel's times."""
    select_ops.fused_packet_select.launches = 0
    while_ops.packet_while.launches = 0
    step_ops.packet_event_steps.launches = 0
    K, S = len(sweep.PAPER_SCALE_RATIOS), len(sweep.PAPER_INIT_PROPS)
    formations = kernel_calls = 0
    times = {}
    for flow, dtype in (("homog0.85", np.float32), ("hetero0.85", np.float64)):
        wl, want = flows[flow], fused[flow]
        d = Dispatch(wl, dtype, False)      # the grid's lanes, k major
        kernel_runs = while_runs(d.pw, d.k[0], d.s[0], d.M, ("cuda", "cuda"))
        compare_while(kernel_runs[1], kernel_runs[0],
                      f"seq_path {flow} kernel twice")
        cut = Dispatch(first_jobs(wl, WHILE_CUT_JOBS), dtype, False)
        cut_runs = while_runs(cut.pw, cut.k[0], cut.s[0], cut.M,
                              ("cuda", "torch"))
        runs = kernel_runs + cut_runs
        plain_runs = [r for r in cut_runs if r["impl"] == "torch"]
        kernel_calls += len(kernel_runs) + 1
        formations += sum(r["select_launches"] for r in plain_runs)
        worst = compare_while(cut_runs[0], plain_runs[0],
                              f"seq_path {flow} first {cut.N} jobs")
        m = efficiency_metrics(d.pw.submit, kernel_runs[0]["res"], d.M,
                               d.pw.t_last_submit)
        got = Metrics(*(x.cpu().numpy().reshape((K, S)) for x in m))
        rel = check_grid(got, want, SEQ_RTOL[np.dtype(dtype)],
                         f"seq_path {flow}")
        kst, pst = kernel_runs[0]["stats"], plain_runs[0]["stats"]
        t = time_while(kernel_runs[0])
        t.update(shape=f"{flow} N={d.N} M={d.M} ring={d.ring} T={d.T} "
                       f"{np.dtype(dtype).name}",
                 plain_ms=1e3 * plain_runs[0]["wrapper_seconds"],
                 plain_n_jobs=cut.N,
                 kernel_ms_at_plain_n_jobs=time_while(cut_runs[0])["ms"],
                 simulate_packet_seconds=min(r["seconds"]
                                             for r in kernel_runs),
                 plain_simulate_packet_seconds=plain_runs[0]["seconds"])
        times[flow] = t
        emit("seq_path", run="simulate_packet", flow=flow,
             dtype=str(np.dtype(dtype)), lanes=K * S, n_jobs=wl.n_jobs,
             plain_n_jobs=cut.N, ring=d.ring,
             run_order=[r["impl"] for r in runs],
             wall_seconds_runs={i: [r["seconds"] for r in runs
                                    if r["impl"] == i]
                                for i in ("cuda", "torch")},
             wall_seconds=t["simulate_packet_seconds"],
             plain_wall_seconds=t["plain_simulate_packet_seconds"],
             kernel_ms=t["ms"], kernel_ms_runs=t["ms_runs"],
             plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
             bound_by=t["bound_by"], ns_per_lane_step=t["ns_per_lane_step"],
             lane_steps_max=t["lane_steps_max"], plan=t["plan"],
             kernel_stats=kst, packet_while_launches=[
                 r["while_launches"] for r in kernel_runs],
             plain_outer_iterations=pst["outer"],
             plain_inner_iterations=pst["inner"],
             plain_select_launches=plain_runs[0]["select_launches"],
             plain_host_syncs=pst["syncs"],
             groups_formed=int(got.n_groups.sum()),
             kernel_vs_plain_max_ulp=worst, ulp_bound=ULP_BOUND,
             max_rel_dev_vs_fused=float(rel),
             rtol=SEQ_RTOL[np.dtype(dtype)], ok=True)

    wl, want = flows["homog0.85"], fused["homog0.85"]
    ks = [sweep.PAPER_SCALE_RATIOS[i] for i in SEQ_CELLS]
    sel0 = select_ops.fused_packet_select.launches
    while0 = while_ops.packet_while.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sweep.run_packet_grid(wl, ks=ks, s_props=[0.05], mode="seq",
                                step_impl="torch")
    wall = time.perf_counter() - t0
    launched = while_ops.packet_while.launches - while0
    sel = select_ops.fused_packet_select.launches - sel0
    # one cell a call, one kernel launch a cell, no decision launch
    if (launched, sel) != (len(ks), 0):
        fail(f"seq_path seq cells: {launched} packet_while and {sel} "
             f"select launches for {len(ks)} cells")
    kernel_calls += launched
    cells = Metrics(*(np.asarray(x)[list(SEQ_CELLS)][:, :1] for x in want))
    rel = check_grid(got, cells, SEQ_RTOL[np.dtype(np.float32)],
                     "seq_path seq cells")
    emit("seq_path", run="run_packet_grid(mode='seq', step_impl='torch')",
         flow="homog0.85", dtype="float32", ks=ks, s_prop=0.05,
         wall_seconds=wall, packet_while_launches=launched,
         select_launches=sel, max_rel_dev_vs_fused=float(rel), ok=True)

    for flag in ("vmap_k", "vmap_s"):
        before = step_ops.packet_event_steps.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sweep.run_packet_grid(wl, **{flag: True})
        wall = time.perf_counter() - t0
        launched = step_ops.packet_event_steps.launches - before
        if launched < 1:
            fail(f"seq_path {flag}: the event-step kernel never ran")
        rel = check_grid(got, want, SEQ_RTOL[np.dtype(np.float32)],
                         f"seq_path {flag}")
        emit("seq_path", run=f"run_packet_grid({flag}=True)",
             flow="homog0.85", dtype="float32", lanes=K * S,
             dispatches=S if flag == "vmap_k" else K, wall_seconds=wall,
             event_step_launches=launched, max_rel_dev_vs_fused=float(rel),
             ok=True)
    select_launches = select_ops.fused_packet_select.launches
    while_launches = while_ops.packet_while.launches
    if select_launches != formations or select_launches < 1:
        fail(f"seq_path: {select_launches} select launches for "
             f"{formations} lockstep formations of the plain runs")
    if while_launches != kernel_calls or while_launches < 1:
        fail(f"seq_path: {while_launches} packet_while launches for "
             f"{kernel_calls} kernel calls")
    return select_launches, while_launches, times


# --------------------------------------------------------------------------
# the chaos axis, the streaming service and the paper's sim driver
# --------------------------------------------------------------------------

def stream_bits(u: torch.Tensor) -> torch.Tensor:
    return u.view(torch.int32 if u.dtype == torch.float32 else torch.int64)


def compare_results(got, want, label):
    """Two DesResults of one dispatch, kernel against plain step: integer
    fields equal, float fields at most ULP_BOUND apart. Returns the worst
    ulp."""
    worst = 0.0
    for name, g, w in zip(des.DesResult._fields, got, want):
        if g.dtype.is_floating_point:
            u = ulp_diff(g, w)
            if u > ULP_BOUND:
                fail(f"{label}: {name} differs by {u} ulp (bound "
                     f"{ULP_BOUND})")
            worst = max(worst, u)
            finite = torch.isfinite(g) & torch.isfinite(w)
            if bool(finite.any()):
                Worst.abs_err = max(Worst.abs_err, float(
                    (g[finite].double() - w[finite].double()).abs().max()))
        elif not torch.equal(g, w):
            fail(f"{label}: {name} differs")
    Worst.ulp = max(Worst.ulp, worst)
    return worst


def chaos_cut_check():
    """The event-step kernel against its plain version under the chaos
    axis, through the scan engine on the card: `cut_workload()` (1000
    jobs), the k rows CHAOS_CUT_KS at S = 0.05, x C = 3 cells, each lane
    drawing its own stream (large k's: few groups, so the plain step,
    some 3 ms an event under chaos on the card, drains in seconds).
    Returns (label, worst ulp)."""
    wl = cut_workload()
    dev = Dispatch.device
    chaos = des.ChaosConfig(**service_launch.SERVICE_CHAOS)
    K, C = len(CHAOS_CUT_KS), sweep.chaos_axis_len(chaos)
    lanes, _ = sweep.chaos_lane_grid(chaos, K, np.float32)
    pw = des.pack_workload(wl, np.float32, dev)
    ks = np.repeat(np.asarray(CHAOS_CUT_KS, np.float32), C)
    ss = np.full(K * C, wl.init_time_for_proportion(0.05), np.float32)
    M = int(wl.params.nodes)
    got = des.simulate_packet_scan_lanes(pw, ks, ss, M, chaos=lanes,
                                         step_impl="cuda")
    want = des.simulate_packet_scan_lanes(pw, ks, ss, M, chaos=lanes,
                                          step_impl="torch")
    torch.cuda.synchronize()
    label = (f"cut N={pw.n_jobs} M={M} T={K * C} float32 chaos "
             f"(k {list(CHAOS_CUT_KS)} x {C} cells)")
    if int(got.requeues.sum()) < 1:
        fail(f"chaos_grid {label}: no fault injected")
    return label, compare_results(got, want, f"chaos_grid {label}")


def phase_chaos_grid(flows, fused):
    """`run_packet_grid` with launch/service.py's 3-cell chaos axis on the
    paper's two flows, uncut: 37 x 6 x 3 = 666 lanes, each drawing its own
    threefry stream on the card. Gates: chunked = fused exactly; mode="seq"
    on CHAOS_SEQ_LANES equals the fused grid's lanes exactly; an inert
    ChaosConfig() gives main_path's fault-free fused grid exactly; faults
    really injected; the card's streams for CHAOS_STREAM_LANES bitwise
    those of the same generator on the CPU; the event-step kernel against
    its plain version under chaos on a cut (`chaos_cut_check`). Returns
    the event-step launches of the two grids as a user calls them
    (mode="auto")."""
    K, S = len(sweep.PAPER_SCALE_RATIOS), len(sweep.PAPER_INIT_PROPS)
    path_launches = 0
    for flow, dtype in (("homog0.85", np.float32), ("hetero0.85", np.float64)):
        wl = flows[flow]
        chaos = des.ChaosConfig(**service_launch.SERVICE_CHAOS)
        C = sweep.chaos_axis_len(chaos)
        step_ops.packet_event_steps.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = sweep.run_packet_grid(wl, dtype=dtype, chaos=chaos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = step_ops.packet_event_steps.launches
        path_launches += launched
        label = f"chaos_grid {flow}"
        if grid.avg_wait.shape != (K, S, C):
            fail(f"{label}: grid shape {grid.avg_wait.shape}")
        if not grid.ok.all() or grid.budget_exhausted.any():
            fail(f"{label}: a lane is not ok")
        for f_ in SCALAR_METRIC_FIELDS + ("lost_work",):
            if not np.isfinite(getattr(grid, f_)).all():
                fail(f"{label}: {f_} is not finite")
        if grid.failures.sum() < 1 or grid.requeues.sum() < 1:
            fail(f"{label}: chaos injected no failure or requeue")
        if launched < 1:
            fail(f"{label}: the CUDA kernel never ran")
        t0 = time.perf_counter()
        chunked = sweep.run_packet_grid(wl, dtype=dtype, chaos=chaos,
                                        mode="chunked")
        chunked_wall = time.perf_counter() - t0
        for f_ in grid._fields:
            if not np.array_equal(getattr(grid, f_), getattr(chunked, f_)):
                fail(f"{label}: fused and chunked differ in {f_}")
        # mode="seq" on a few flat lanes: the layout's own code path
        np_dtype = np.dtype(dtype)
        ks_arr = np.asarray(sweep.PAPER_SCALE_RATIOS, np_dtype)
        s_vals = np.asarray([wl.init_time_for_proportion(p)
                             for p in sweep.PAPER_INIT_PROPS], np_dtype)
        k_lanes = np.repeat(ks_arr, S * C)
        s_lanes = np.repeat(np.tile(s_vals, K), C)
        chaos_l, _ = sweep.chaos_lane_grid(chaos, K * S, np_dtype)
        idx = np.asarray(CHAOS_SEQ_LANES)
        pw = des.pack_workload(wl, np_dtype, Dispatch.device)
        M = int(wl.params.nodes)
        t0 = time.perf_counter()
        seq = sweep._run_lanes(des.as_cohort(pw), k_lanes[idx][None],
                               s_lanes[idx][None], M,
                               des.resolve_ring(M, pw.n_jobs), "seq", None,
                               "cuda", Dispatch.device,
                               sweep._chaos_take(chaos_l, idx))
        seq = Metrics(*(x[0] for x in seq))
        seq_wall = time.perf_counter() - t0
        flat = Metrics(*(x.reshape((K * S * C,) + x.shape[3:])
                         for x in grid))
        for f_ in grid._fields:
            if not np.array_equal(getattr(seq, f_), getattr(flat, f_)[idx]):
                fail(f"{label}: mode=seq lanes {CHAOS_SEQ_LANES} differ from "
                     f"the fused grid in {f_}")
        inert = sweep.run_packet_grid(wl, dtype=dtype,
                                      chaos=des.ChaosConfig())
        for f_ in grid._fields:
            if not np.array_equal(getattr(inert, f_),
                                  getattr(fused[flow], f_)):
                fail(f"{label}: an inert ChaosConfig differs from the "
                     f"fault-free grid in {f_}")
        # the streams of a few lanes: the card's draw against the CPU's
        R = des.resolve_max_requeues(chaos, pw.n_jobs)
        cap = pw.n_jobs + R
        probe = des.ChaosConfig(seed=chaos.seed,
                                lane=np.asarray(CHAOS_STREAM_LANES))
        on_card = des.chaos_uniforms(probe, np_dtype, cap, Dispatch.device)
        on_cpu = des.chaos_uniforms(probe, np_dtype, cap, "cpu")
        if not torch.equal(stream_bits(on_card.cpu()), stream_bits(on_cpu)):
            fail(f"{label}: the card's streams differ from the CPU's for "
                 f"lanes {CHAOS_STREAM_LANES}")
        everyone = des.ChaosConfig(seed=chaos.seed,
                                   lane=np.arange(K * S * C))
        streams_ms = cuda_ms(lambda: des.chaos_uniforms(
            everyone, np_dtype, cap, Dispatch.device), 3)
        events = int((wl.n_jobs + 2 * grid.n_groups.astype(np.int64)).sum())
        emit("chaos_grid", flow=flow, n_jobs=wl.n_jobs, m_nodes=M,
             dtype=str(np_dtype), lanes=K * S * C, chaos_cells=C,
             chaos=dict(seed=chaos.seed, mtbf_chip_hours=[25, 100, 800],
                        ckpt_period=300, straggler_prob=0.1,
                        straggler_factor=[4, 1.5, 1.5]),
             mode="fused", wall_seconds=wall,
             chunked_wall_seconds=chunked_wall,
             seq_lanes=list(CHAOS_SEQ_LANES), seq_wall_seconds=seq_wall,
             launches=launched, events=events, events_per_second=events / wall,
             failures=int(grid.failures.sum()),
             straggler_kills=int(grid.straggler_kills.sum()),
             requeues=int(grid.requeues.sum()),
             requeued_jobs=int(grid.requeued_jobs.sum()),
             stream_rows=cap, stream_bytes=2 * cap * K * S * C *
             np_dtype.itemsize, streams_ms=streams_ms,
             stream_lanes_equal_cpu=list(CHAOS_STREAM_LANES),
             fused_equals_chunked=True, seq_equals_fused=True,
             inert_equals_fault_free=True, ok=True)
    t0 = time.perf_counter()
    label, worst = chaos_cut_check()
    emit("chaos_grid", run="kernel against the plain step", shape=label,
         seconds=time.perf_counter() - t0, max_ulp=worst,
         ulp_bound=ULP_BOUND, ok=True)
    return path_launches


def service_trace():
    return drift_scenarios(**SERVICE_TRACE)["intensity_step"]


def service_config(argv, device) -> ServiceConfig:
    """The ServiceConfig launch/service.py builds for `argv` at its
    defaults, on `device`."""
    return ServiceConfig(
        window_jobs=SERVICE_WINDOW, s_prop=0.05, mode="auto",
        dtype="float64" if "--float64" in argv else "float32",
        chaos=(des.ChaosConfig(**service_launch.SERVICE_CHAOS)
               if "--chaos" in argv else None),
        risk_lambda=0.1, device=device)


def compare_ticks(got, want, rtol, label):
    """The card's ticks against the CPU's: best and plateau k, each
    controller's realized and committed k, moves and reasons equal;
    best waits, lost work and regime weights within rtol."""
    def close(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return bool(np.all(np.abs(a - b) <= rtol * np.abs(b) + 1e-9))

    for tg, tw in zip(got, want):
        t = tg["tick"]
        for key in ("best_k", "plateau_k"):
            if tg[key] != tw[key]:
                fail(f"{label} tick {t}: {key} {tg[key]} != {tw[key]}")
        if not close(tg["best_wait"], tw["best_wait"]):
            fail(f"{label} tick {t}: best_wait beyond rtol {rtol}")
        for name, cw in tw["controllers"].items():
            cg = tg["controllers"][name]
            for key in ("realized_k", "committed_k", "moved", "reason"):
                if cg[key] != cw[key]:
                    fail(f"{label} tick {t} {name}: {key} {cg[key]} != "
                         f"{cw[key]}")
            for key in ("realized_lost", "weights"):
                if key in cw and not close(cg[key], cw[key]):
                    fail(f"{label} tick {t} {name}: {key} beyond rtol "
                         f"{rtol}")


def switches(ticks, name) -> int:
    return sum(1 for t in ticks if t["controllers"][name]["moved"]
               and t["controllers"][name]["reason"] != "bootstrap")


def phase_service_path():
    """`repro_torch.launch.service.main` at its defaults, run fault-free,
    with --chaos and with --float64, on the card (each tick's oracle one
    fused dispatch of the event-step kernel). Gates: every tick's best and
    plateau k and every controller's realized / committed k and switch
    count equal those of `run_service` on the CPU (device="cpu"), which
    runs the first SERVICE_CPU_WINDOWS windows of the same trace (a cut:
    ticks depend only on earlier windows; at 2000 jobs the CPU's chaos
    run alone takes ~25 s); waits, lost work and weights within SEQ_RTOL.
    Then the oracle's [K, C] block on one window against the chaos grid's
    column, bitwise. Returns the event-step launches of the three runs."""
    wl = service_trace()
    cut = slice_window(wl, 0, SERVICE_CPU_WINDOWS * SERVICE_WINDOW,
                       rebase=False)
    total = 0
    for name, argv in SERVICE_RUNS:
        config = service_config(argv, Dispatch.device)
        step_ops.packet_event_steps.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = service_launch.main(argv)
        wall = time.perf_counter() - t0
        launched = step_ops.packet_event_steps.launches
        total += launched
        label = f"service_path {name}"
        if out["n_ticks"] != SERVICE_TRACE["n_jobs"] // SERVICE_WINDOW:
            fail(f"{label}: {out['n_ticks']} ticks")
        cfg = out["config"]
        if (cfg["dtype"] != config.dtype or cfg["window_jobs"]
                != config.window_jobs or cfg["s_prop"] != config.s_prop
                or ("chaos" in cfg) != (config.chaos is not None)):
            fail(f"{label}: the launcher's config is not the one compared")
        if launched < out["n_ticks"]:
            fail(f"{label}: {launched} event-step launches for "
                 f"{out['n_ticks']} ticks")
        for t in out["ticks"]:
            if not np.isfinite(t["best_wait"]):
                fail(f"{label} tick {t['tick']}: best_wait not finite")
        t0 = time.perf_counter()
        cpu = run_service(cut, dataclasses.replace(config, device="cpu"))
        cpu_wall = time.perf_counter() - t0
        rtol = SEQ_RTOL[np.dtype(config.dtype)]
        head = out["ticks"][:SERVICE_CPU_WINDOWS]
        compare_ticks(head, cpu["ticks"], rtol, label)
        sw = {n: switches(head, n) for n in out["controllers"]}
        if sw != {n: s["switches"] for n, s in cpu["controllers"].items()}:
            fail(f"{label}: switch counts differ from the CPU's")
        ms = np.asarray(out["oracle"]["oracle_ms"])
        emit("service_path", run=name, argv=argv, scenario="intensity_step",
             n_jobs=SERVICE_TRACE["n_jobs"], window_jobs=SERVICE_WINDOW,
             candidates=len(config.ks), chaos_cells=config.n_chaos_cells,
             dtype=config.dtype, ticks=out["n_ticks"], wall_seconds=wall,
             oracle_ms_median=float(np.median(ms)),
             oracle_ms_max=float(ms.max()), oracle_ms=ms.tolist(),
             event_step_launches=launched,
             launches_per_tick=launched / out["n_ticks"],
             switches={n: s["switches"]
                       for n, s in out["controllers"].items()},
             k_trajectory={n: s["k_trajectory"]
                           for n, s in out["controllers"].items()},
             cpu_cut_windows=SERVICE_CPU_WINDOWS, cpu_wall_seconds=cpu_wall,
             cpu_ticks_equal=True, rtol=rtol, ok=True)
    # one tick's [K, C] block against the grid driver's chaos column
    win = next(w for i, (_, _, w) in enumerate(
        iter_windows(wl, WindowSpec(SERVICE_WINDOW)))
        if i == SERVICE_ORACLE_WINDOW)
    chaos = des.ChaosConfig(**service_launch.SERVICE_CHAOS)
    ks = sweep.PAPER_SCALE_RATIOS
    for dtype in (np.float32, np.float64):
        pw = des.pack_workload(win, dtype, Dispatch.device)
        block = sweep.run_window_oracle(
            pw, ks, win.init_time_for_proportion(0.05), win.params.nodes,
            chaos=chaos)
        column = sweep.run_packet_grid(win, ks=ks, s_props=[0.05],
                                       dtype=dtype, chaos=chaos)
        for f_ in block._fields:
            if not np.array_equal(getattr(block, f_),
                                  getattr(column, f_)[:, 0, :]):
                fail(f"service_path oracle block {np.dtype(dtype).name}: "
                     f"{f_} differs from the chaos grid's column")
    emit("service_path", run="oracle block vs grid column",
         window=SERVICE_ORACLE_WINDOW, shape=[len(ks), 3],
         dtypes=["float32", "float64"], bitwise=True, ok=True)
    return total


def phase_sim_path():
    """`repro_torch.launch.sim.main` at its defaults (homog0.85, 5000 jobs,
    init proportion 0.05): 37 lanes, one fused dispatch. Its workload is
    the reference sim.py's, drawn with the generator's default daily
    amplitude (0.6), not paper_workloads' homog0.85 (0.3) that main_path
    runs, so the gate holds its threshold against `plateau_threshold` over
    column 0 of the fused 37 x 6 grid of the same workload (and the
    column's waits bitwise against the sweep's)."""
    step_ops.packet_event_steps.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid, thr = sim.main([])
    wall = time.perf_counter() - t0
    launched = step_ops.packet_event_steps.launches
    if launched < 1:
        fail("sim_path: the CUDA kernel never ran")
    wl = generate_workload(WorkloadParams(n_jobs=5000, nodes=100, load=0.85,
                                          homogeneous=True, seed=1))
    full = sweep.run_packet_grid(wl, mode="fused")
    ks = np.asarray(sweep.PAPER_SCALE_RATIOS)
    want = sweep.plateau_threshold(ks, full.avg_wait[:, 0])
    if not np.array_equal(grid.avg_wait[:, 0], full.avg_wait[:, 0]):
        fail("sim_path: the sweep's waits differ from the grid's column")
    if (thr.threshold, thr.plateau) != (want.threshold, want.plateau):
        fail(f"sim_path: threshold {thr} != {want}")
    emit("sim_path", workload="homog0.85", n_jobs=5000, init_prop=0.05,
         lanes=len(ks), wall_seconds=wall, event_step_launches=launched,
         plateau_k=thr.threshold, plateau_wait=thr.plateau,
         threshold_equals_grid_column=True, ok=True)
    return launched


# --------------------------------------------------------------------------
# the paper's whole study: the cohorts and the rigid baselines
# --------------------------------------------------------------------------

def paper_dtype(wl):
    """benchmarks/paper_sweep.py's precision policy: heterogeneous flows
    in float64, homogeneous ones in float32."""
    return np.float32 if wl.params.homogeneous else np.float64


def grids_equal(got: Metrics, want: Metrics, label: str):
    for f_ in want._fields:
        g, w = np.asarray(getattr(got, f_)), np.asarray(getattr(want, f_))
        if g.shape != w.shape or g.dtype != w.dtype or not np.array_equal(
                g, w):
            fail(f"{label}: {f_} differs")


def timed_call(fn, *a, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def chaos_golden_deviation(grids: dict) -> dict:
    """The largest relative difference of each float field of the chaos
    cohort grids from benchmarks/results/paper_chaos_grid.json (written by
    the reference on a CPU with an older JAX, whose threefry bits may
    differ), and the number of cells whose integer fields differ.
    Printed, not gated."""
    with open(CHAOS_GOLDEN) as f:
        gold = json.load(f)["workloads"]
    out = {}
    for name, grid in grids.items():
        row = {}
        for f_ in grid._fields:
            g = np.asarray(getattr(grid, f_))
            w = np.asarray(gold[name][f_], g.dtype)
            if g.dtype.kind == "f":
                rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-3)
                row[f_] = float(np.max(np.where(g == w, 0.0, rel)))
            else:
                row[f_] = int(np.sum(g != w))
        out[name] = row
    return out


def phase_cohort_grid(flows):
    """The paper's six flows as the two cohorts of paper_sweep.py's dtype
    policy (M500-N5000-float64, M100-N5000-float32), each 3 x 222 = 666
    lanes, through `run_cohort_grid` as a user calls it. Gates: every
    member's grid bitwise its own fused `run_packet_grid`; one event-step
    launch a segment for the whole cohort (the launches of a study equal
    those of its longest member's grid); chunked = fused; `mode="seq"` on
    SEQ_CELLS (S = 0.05) bitwise the fused cells with the scan engine's
    lane and, with step_impl="torch", one `packet_while` launch a cell,
    bitwise `run_packet_grid(mode="seq")` and within SEQ_RTOL of the
    fused cells; a one-member cohort bitwise `run_packet_grid`. Then the
    same under paper_sweep.py's 8-cell fault axis (1 776 lanes a member,
    5 328 a cohort), bitwise the members' fused fault grids, with the
    largest difference from the checked-in paper_chaos_grid.json printed.
    Returns the event-step launches of the cohort studies and the kernel's
    times at the cohorts' width."""
    cohorts = paper_cohorts(flows)
    if [c.n_workloads for c in cohorts] != [3, 3]:
        fail(f"cohort_grid: {len(cohorts)} cohorts of "
             f"{[c.n_workloads for c in cohorts]} flows, not 2 of 3")
    K, S = len(sweep.PAPER_SCALE_RATIOS), len(sweep.PAPER_INIT_PROPS)
    seq_ks = [sweep.PAPER_SCALE_RATIOS[i] for i in SEQ_CELLS]
    path_launches, times = 0, {}
    for c in cohorts:
        label = f"cohort_grid {c.label}"
        walls, launched = [], []
        for _ in range(2):                  # cold, then warm
            step_ops.packet_event_steps.launches = 0
            grids, wall = timed_call(sweep.run_cohort_grid, c)
            walls.append(wall)
            launched.append(step_ops.packet_event_steps.launches)
        path_launches += sum(launched)
        member_walls, member_launches, fused = {}, {}, {}
        for name, wl in zip(c.names, c.workloads):
            before = step_ops.packet_event_steps.launches
            want, member_walls[name] = timed_call(
                sweep.run_packet_grid, wl, dtype=c.dtype)
            member_launches[name] = (step_ops.packet_event_steps.launches
                                     - before)
            grids_equal(grids[name], want, f"{label} {name} vs its fused "
                        f"run_packet_grid")
            if not want.ok.all():
                fail(f"{label} {name}: a cell is not ok")
            fused[name] = want
        if launched[0] != launched[1] or launched[1] != max(
                member_launches.values()):
            fail(f"{label}: {launched} launches a study, not one a segment "
                 f"of the longest member ({member_launches})")
        chunked, chunked_wall = timed_call(sweep.run_cohort_grid, c,
                                           mode="chunked")
        for name in c.names:
            grids_equal(chunked[name], fused[name], f"{label} chunked")
        seq, seq_wall = timed_call(sweep.run_cohort_grid, c, ks=seq_ks,
                                   s_props=[0.05], mode="seq")
        while0 = while_ops.packet_while.launches
        seq_while, seq_while_wall = timed_call(
            sweep.run_cohort_grid, c, ks=seq_ks, s_props=[0.05],
            mode="seq", step_impl="torch")
        while_launched = while_ops.packet_while.launches - while0
        if while_launched != len(seq_ks) * c.n_workloads:
            fail(f"{label} seq: {while_launched} packet_while launches for "
                 f"{len(seq_ks)} cells x {c.n_workloads} members")
        worst_seq = 0.0
        for name, wl in zip(c.names, c.workloads):
            cells = Metrics(*(np.asarray(x)[list(SEQ_CELLS)][:, :1]
                              for x in fused[name]))
            grids_equal(seq[name], cells, f"{label} seq {name}")
            grids_equal(seq_while[name], sweep.run_packet_grid(
                wl, ks=seq_ks, s_props=[0.05], dtype=c.dtype, mode="seq",
                step_impl="torch"), f"{label} seq (while kernel) {name}")
            worst_seq = max(worst_seq, check_grid(
                seq_while[name], cells, SEQ_RTOL[c.dtype],
                f"{label} seq (while kernel) {name}"))
        first = c.names[0]
        one = cohort_mod.group_workloads({first: c.workloads[0]},
                                         c.dtype)[0]
        grids_equal(sweep.run_cohort_grid(one)[first], fused[first],
                    f"{label} W=1")
        t = time_kernel(CohortDispatch(c))
        if t["segments"] != launched[1]:
            fail(f"{label}: {t['segments']} timed segments, {launched[1]} "
                 f"launches in the study")
        times[c.label] = t
        emit("cohort_grid", cohort=c.label, members=list(c.names),
             lanes=c.n_workloads * K * S,
             plan=sweep.sweep_plan("auto", K * S, c.n_workloads,
                                   dtype=c.dtype),
             wall_seconds_cold=walls[0], wall_seconds=walls[1],
             member_wall_seconds=member_walls,
             members_wall_seconds_sum=sum(member_walls.values()),
             launches=launched[1], member_launches=member_launches,
             kernel_ms=t["ms"], kernel_ms_runs=t["ms_runs"],
             ns_per_lane_step=t["ns_per_lane_step"],
             ns_per_event=t["ns_per_event"], events=t["events"],
             chunked_wall_seconds=chunked_wall, seq_cells=seq_ks,
             seq_wall_seconds=seq_wall,
             seq_while_kernel_wall_seconds=seq_while_wall,
             seq_while_kernel_launches=while_launched,
             seq_while_max_rel_dev_vs_fused=worst_seq,
             members_equal_fused=True, chunked_equal=True, seq_equal=True,
             one_member_equal=True, one_launch_a_segment=True, ok=True)

    chaos = des.ChaosConfig(**PAPER_CHAOS)
    C = sweep.chaos_axis_len(chaos)
    chaos_grids = {}
    for c in cohorts:
        label = f"cohort_grid {c.label} chaos"
        step_ops.packet_event_steps.launches = 0
        grids, wall = timed_call(sweep.run_cohort_grid, c, chaos=chaos)
        launched = step_ops.packet_event_steps.launches
        path_launches += launched
        member_walls, member_launches = {}, {}
        for name, wl in zip(c.names, c.workloads):
            before = step_ops.packet_event_steps.launches
            want, member_walls[name] = timed_call(
                sweep.run_packet_grid, wl, dtype=c.dtype, chaos=chaos)
            member_launches[name] = (step_ops.packet_event_steps.launches
                                     - before)
            if grids[name].avg_wait.shape != (K, S, C):
                fail(f"{label} {name}: grid shape "
                     f"{grids[name].avg_wait.shape}")
            grids_equal(grids[name], want, f"{label} {name} vs its fused "
                        f"run_packet_grid")
            if not want.ok.all() or want.failures.sum() < 1:
                fail(f"{label} {name}: a lane is not ok, or no failure")
            chaos_grids[name] = grids[name]
        if launched != max(member_launches.values()):
            fail(f"{label}: {launched} launches, not one a segment of the "
                 f"longest member ({member_launches})")
        R = des.resolve_max_requeues(chaos, c.n_jobs)
        rows = -(-des.event_budget(c.n_jobs, R) // SEG) * SEG
        emit("cohort_grid", cohort=c.label, chaos_cells=C,
             lanes=c.n_workloads * K * S * C, wall_seconds=wall,
             member_wall_seconds=member_walls,
             members_wall_seconds_sum=sum(member_walls.values()),
             launches=launched, member_launches=member_launches,
             log_bytes=rows * c.n_workloads * K * S * C * (
                 8 + 2 * c.dtype.itemsize),
             failures=int(sum(g.failures.sum() for g in grids.values())),
             requeues=int(sum(g.requeues.sum() for g in grids.values())),
             members_equal_fused=True, one_launch_a_segment=True, ok=True)
    emit("cohort_grid", run="chaos grids against paper_chaos_grid.json "
         "(not gated)", max_rel_dev_or_cells_differing=(
             chaos_golden_deviation(chaos_grids)))
    return path_launches, times


def baseline_instantiations(log: str) -> list:
    """Registers and spills of each baselines-kernel instantiation, read
    from the ptxas lines of its build log, with the lane bytes its launch
    plan gives the paper's flows (N = 5000, 64 candidates; ring 100 in
    float32, ring 500 in float64)."""
    rows, cur = [], None
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            f, bf = re.search(r"baselines_kernelI([fd])Lb([01])E",
                              entry.group(1)).groups()
            is_f64, backfill = f == "d", bf == "1"
            ring = 500 if is_f64 else 100
            plan = base_kernel.launch_plan(5000, ring, 64, is_f64, backfill)
            cur = dict(dtype="float64" if is_f64 else "float32",
                       policy="backfill" if backfill else "fcfs",
                       smem_bytes=plan.lane_bytes if plan.lane_in_smem
                       else 0, smem_shape=f"N 5000, ring {ring}, 64 "
                       f"candidates")
            rows.append(cur)
        elif cur is not None and "spill stores" in ln:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", ln).groups()
            cur.update(spill_store_bytes=int(st), spill_load_bytes=int(ld))
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
    return sorted(rows, key=lambda r: (r["dtype"], r["policy"]))


def baseline_operands(wl, dtype, s_props):
    pw = des.pack_workload(wl, dtype, Dispatch.device)
    s = torch.tensor([wl.init_time_for_proportion(p) for p in s_props],
                     dtype=pw.submit.dtype, device=Dispatch.device)
    return pw, s


def time_baselines(wl, dtype, policy):
    """CUDA-event ms of one `baselines` launch over the paper's six init
    proportions of `wl`, uncut, and what bounds the same work."""
    pw, s = baseline_operands(wl, dtype, sweep.PAPER_INIT_PROPS)
    M, N = int(wl.params.nodes), pw.n_jobs
    ring = des.resolve_ring(M, N)

    def call():
        return base_ops.baselines(pw.submit, pw.runtime, pw.nodes,
                                  pw.t_last_submit, s, M, policy=policy,
                                  max_iters=4 * N + 64, ring=ring)
    out = call()
    runs = [cuda_ms(call, 3) for _ in range(3)]
    events = int(out.iters.long().sum())
    starts = int(out.n_started.long().sum())
    T, fsz = int(s.shape[0]), pw.submit.element_size()
    # bytes: submit, runtime, nodes read once, the job times and the lane
    # scalars written once; operations: 16 an event and 24 a job start,
    # this run's counts (backfill's candidate tests and reservation sums,
    # which depend on the queue, are not counted: a lower bound)
    nbytes = N * (2 * fsz + 4) + T * fsz + T * N * 2 * fsz + T * (
        4 * fsz + 9)
    ops = 16 * events + 24 * starts
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / FP32_OPS_PER_S
    plan = base_kernel.launch_plan(N, ring, 64, dtype == np.float64,
                                   policy == "backfill")
    return dict(shape=f"N={N} M={M} ring={ring} T={T} "
                      f"{np.dtype(dtype).name} {policy}",
                ms=min(runs), ms_runs=runs, events=events,
                ns_per_event=1e6 * min(runs) / (events / T),
                bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                plan=plan._asdict())


def compare_baselines(got, want, label):
    """Kernel against plain version: job times bitwise, counts and flags
    equal, the float integrals within ULP_BOUND. Returns the worst ulp."""
    for name in ("start_t", "run_start_t", "makespan"):
        g, w = getattr(got, name), getattr(want, name)
        if not torch.equal(g, w):
            fail(f"{label}: {name} differs (gate: 0 ulp)")
    for name in ("n_groups", "ok", "budget_exhausted"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            fail(f"{label}: {name} differs")
    worst = 0.0
    for name in ("qlen_int", "busy_ns", "useful_ns"):
        g, w = getattr(got, name), getattr(want, name)
        u = ulp_diff(g, w)
        if u > ULP_BOUND:
            fail(f"{label}: {name} differs by {u} ulp (bound {ULP_BOUND})")
        worst = max(worst, u)
        BaseWorst.abs_err = max(BaseWorst.abs_err, float(
            (g.double() - w.double()).abs().max()))
    BaseWorst.ulp = max(BaseWorst.ulp, worst)
    return worst


class BaseWorst:
    """Largest kernel-vs-plain baselines difference seen so far."""
    ulp = 0.0
    abs_err = 0.0


def phase_baselines(flows):
    """`run_baselines` on all six paper flows, uncut, each in its policy
    dtype (6 init proportions x FCFS and backfill), and `launch.sim.main
    (["--baselines"])`, as a user calls them: one `baselines` launch a
    policy a call (gated). Then the kernel against its plain version
    (lanes in lockstep, host-bound) on the first WHILE_CUT_JOBS jobs of
    homog0.85 (float32) and hetero0.85 (float64), at the six init
    proportions, every lane to its end (job times
    at 0 ulp, counts and flags equal, integrals within 2 ulp; once more
    with a ring too long for shared memory, the workspace path, capped at
    BASELINE_CAP_ITERS events a lane), the golden file's
    fcfs / backfill blocks in float64 within rtol 1e-9, and each policy's
    kernel time on the uncut flows. Returns the path's launches, the
    timings and the plain version's ms."""
    base_ops.baselines.launches = 0
    calls = 0
    for name, wl in flows.items():
        dtype = paper_dtype(wl)
        bl, wall = timed_call(sweep.run_baselines, wl, dtype=dtype)
        calls += 1
        if list(bl) != ["backfill", "fcfs"]:
            fail(f"baselines {name}: policies {list(bl)}")
        for policy, m in bl.items():
            label = f"baselines {name} {policy}"
            if m.avg_wait.shape != (len(sweep.PAPER_INIT_PROPS),):
                fail(f"{label}: shape {m.avg_wait.shape}")
            if not m.ok.all() or (m.n_groups != wl.n_jobs).any():
                fail(f"{label}: not every job started")
            for f_ in SCALAR_METRIC_FIELDS:
                if not np.isfinite(getattr(m, f_)).all():
                    fail(f"{label}: {f_} is not finite")
            if m.full_util.max() > 1.0 or m.useful_util.min() < 0.0:
                fail(f"{label}: utilization outside [0, 1]")
        emit("baselines", flow=name, n_jobs=wl.n_jobs,
             dtype=np.dtype(dtype).name, wall_seconds=wall,
             avg_wait={p: m.avg_wait.tolist() for p, m in bl.items()},
             useful_util={p: m.useful_util.tolist() for p, m in bl.items()},
             ok=True)
    before = base_ops.baselines.launches
    out, sim_wall = timed_call(sim.main, ["--baselines"])
    calls += 1
    if len(out) != 3 or base_ops.baselines.launches - before != 2 or \
            not all(m.ok.all() for m in out[2].values()):
        fail("baselines: sim --baselines did not run both policies once")
    launches = base_ops.baselines.launches
    if launches != 2 * calls:
        fail(f"baselines: {launches} launches for {calls} calls of two "
             f"policies")
    emit("baselines", run="launch.sim.main(['--baselines'])",
         wall_seconds=sim_wall,
         baselines={p: dict(avg_wait=float(m.avg_wait[0]),
                            useful_util=float(m.useful_util[0]))
                    for p, m in out[2].items()},
         launches_on_path=launches, calls=calls, ok=True)

    plain_ms = {}
    # the main path's shapes cut to the first WHILE_CUT_JOBS jobs: the six
    # init proportions, the policy dtype's ring; every lane to its end (the
    # uncut flows' plain seconds stand in PERF.md). The last case, a ring of
    # BASELINE_WORKSPACE_RING slots, takes the device-memory workspace in
    # place of shared memory (launch plan) and stops every lane at
    # BASELINE_CAP_ITERS events (budget_exhausted in both versions)
    for flow, policy, ring, cap in (
            ("homog0.85", "fcfs", None, None),
            ("homog0.85", "backfill", None, None),
            ("hetero0.85", "fcfs", None, None),
            ("hetero0.85", "backfill", None, None),
            ("hetero0.85", "backfill", BASELINE_WORKSPACE_RING,
             BASELINE_CAP_ITERS)):
        wl = first_jobs(flows[flow], WHILE_CUT_JOBS)
        dtype = paper_dtype(flows[flow])
        pw, s = baseline_operands(wl, dtype, sweep.PAPER_INIT_PROPS)
        M, N = int(wl.params.nodes), pw.n_jobs
        fn = (schedulers.simulate_fcfs if policy == "fcfs"
              else schedulers.simulate_backfill)
        plan = base_kernel.launch_plan(
            N, des.resolve_ring(M, N, ring), 64, dtype == np.float64,
            policy == "backfill")
        if plan.lane_in_smem == (ring is not None):
            fail(f"baselines vs plain: ring {ring} gave the plan {plan}")
        label = f"baselines vs plain {flow} {policy} ring {ring}"
        got = fn(pw, s, M, ring=ring, max_iters=cap)
        want, plain_s = timed_call(fn, pw, s, M, ring=ring, max_iters=cap,
                                   impl="torch")
        worst = compare_baselines(got, want, label)
        exhausted = bool(got.budget_exhausted.all())
        if exhausted != (cap is not None) or bool(
                got.budget_exhausted.any()) != exhausted:
            fail(f"{label}: budget_exhausted {got.budget_exhausted.tolist()}"
                 f" with a cap of {cap} events")
        if cap is None:
            plain_ms[f"{flow} {policy}"] = 1e3 * plain_s
            if not bool((got.n_groups == N).all()):
                fail(f"{label}: not every job started")
        emit("baselines", run="kernel against the plain version",
             flow=flow, policy=policy, n_jobs=N,
             s_props=list(sweep.PAPER_INIT_PROPS),
             ring=des.resolve_ring(M, N, ring),
             max_iters=4 * N + 64 if cap is None else cap,
             plan=plan._asdict(), dtype=np.dtype(dtype).name,
             plain_seconds=plain_s, n_groups=got.n_groups.tolist(),
             budget_exhausted=exhausted, start_t_ulp=0.0, max_ulp=worst,
             ulp_bound=ULP_BOUND, ok=True)

    with open(GOLDEN) as f:
        gold = json.load(f)
    spec, worst_gold = gold["spec"], 0.0
    for name, params in spec["workloads"].items():
        bl = sweep.run_baselines(generate_workload(WorkloadParams(**params)),
                                 spec["s_props"], dtype=np.float64)
        for policy in ("fcfs", "backfill"):
            want = gold["grids"][name][policy]
            for f_ in SCALAR_METRIC_FIELDS:
                g = np.asarray(getattr(bl[policy], f_))
                w = np.asarray(want[f_])
                floor = {"avg_qlen": 1e-6, "full_util": 1e-6,
                         "useful_util": 1e-6}.get(f_, 1e-3)
                rel = float(np.max(np.abs(g - w) / np.maximum(np.abs(w),
                                                              floor)))
                if not rel <= 1e-9:
                    fail(f"baselines golden {name}/{policy}/{f_}: rel "
                         f"deviation {rel} > 1e-9")
                worst_gold = max(worst_gold, rel)
    times = {f"{flow} {policy}": time_baselines(flows[flow],
                                                paper_dtype(flows[flow]),
                                                policy)
             for flow in ("homog0.85", "hetero0.85")
             for policy in ("fcfs", "backfill")}
    emit("baselines", run="goldens and kernel times",
         golden_max_rel_dev=worst_gold, golden_rtol=1e-9, kernel=times,
         ok=True)
    return launches, times, plain_ms


# --------------------------------------------------------------------------
# flash attention and the serving path
# --------------------------------------------------------------------------

class AttnWorst:
    """Largest kernel-vs-plain attention difference seen so far, and each
    `phase_attention_kernel` case's, by (case, dtype)."""
    abs_err = 0.0
    cases = {}


def attn_inputs(case, dtype, seed):
    """q, k, v of one case on the card, standard normal, from a seed."""
    B, Sq, Skv, H, KV, hd = case[:6]
    gen = torch.Generator(device=Dispatch.device).manual_seed(seed)
    draw = lambda *shape: torch.randn(shape, generator=gen,
                                      device=Dispatch.device).to(dtype)
    return draw(B, Sq, H, hd), draw(B, Skv, KV, hd), draw(B, Skv, KV, hd)


def differences(got, want, rtol, label):
    """Fails unless the kernel's output has the plain version's shape and
    type and is finite. Returns (largest |got - want|, largest
    |got - want| - rtol * |want|, root mean square of `want`)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{label}: kernel gave {tuple(got.shape)} {got.dtype}, plain "
             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{label}: the kernel's output is not finite")
    d = (g - w).abs()
    return (float(d.max()), float((d - rtol * w.abs()).max()),
            float(w.square().mean().sqrt()))


def bounded_check(got, want, tol, label):
    """Kernel output against the plain version's: |got - want| <= atol +
    rtol * |want| elementwise, with tol = (rtol, atol) and, for bf16, atol
    scaled by the root mean square of `want`. Returns (largest absolute
    difference, the bound's absolute term)."""
    rtol, atol = tol
    err, excess, rms = differences(got, want, rtol, label)
    if want.dtype == torch.bfloat16:
        atol = atol * rms
    if excess > atol:
        fail(f"{label}: |kernel - plain| exceeds {atol} + {rtol}*|plain| "
             f"(largest excess {excess})")
    return err, atol


def attn_check(got, want, label):
    """`bounded_check` at the attention's tolerance (ATTN_TOL, relative and
    absolute alike); keeps the largest difference in AttnWorst."""
    tol = ATTN_TOL[want.dtype]
    err, atol = bounded_check(got, want, (tol, tol), label)
    AttnWorst.abs_err = max(AttnWorst.abs_err, err)
    return err, atol


def phase_attention_kernel():
    """The kernel against impl="torch" on every listed shape, both types."""
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(ATTN_CASES):
            B, Sq, Skv, H, KV, hd, causal, window, softcap = case
            q, k, v = attn_inputs(case, dtype, seed=i)
            kw = dict(causal=causal, window=window, softcap=softcap)
            got = attn_ops.flash_attention(q, k, v, impl="cuda", **kw)
            want = attn_ops.flash_attention(q, k, v, impl="torch", **kw)
            torch.cuda.synchronize()
            label = (f"B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} hd={hd} "
                     f"causal={causal} window={window} softcap={softcap} "
                     f"{str(dtype).replace('torch.', '')}")
            err, atol = attn_check(got, want, f"attention_kernel {label}")
            AttnWorst.cases[case, dtype] = err
            prev = PREV_ATTN_ERR[dtype]
            emit("attention_kernel", shape=label, max_abs_err=err,
                 previous_kernel_max_abs_err=prev[i] if i < len(prev)
                 else None, atol=atol, rtol=ATTN_TOL[dtype], ok=True)
            del q, k, v, got, want


class Capture:
    """Passes every call on to `fn` and keeps, detached, the positional
    arguments, keywords and output of the calls whose index is in `keep`.
    Stands in for a wrapper in its module, so `launches` is the wrapper's
    own count (a wrapper adds to it through its module's name)."""

    def __init__(self, fn, keep):
        self.fn, self.keep, self.calls, self.kept = fn, set(keep), 0, {}

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        if self.calls in self.keep:
            detach = lambda xs: [x.detach() if isinstance(x, torch.Tensor)
                                 else x for x in xs]
            self.kept[self.calls] = (detach(args), kw, detach(
                out if isinstance(out, tuple) else (out,)))
        self.calls += 1
        return out


def serve_argv():
    return ["--arch", SERVE_ARCH, "--batch", str(SERVE_BATCH),
            "--prompt-len", str(SERVE_PROMPT), "--max-new", str(SERVE_NEW),
            "--seed", str(SERVE_SEED)]


def serve_lm_path(phase, cfg, run, shape):
    """Drives one serving run `run(stats) -> tokens` of a model of
    `models/lm.py` with the attention kernel's first and last layers
    captured, the kernel counts zeroed just before and read just after,
    and gates: tokens of `shape` inside the vocabulary, finite prefill
    logits, one kernel launch a layer in the prefill (a decode step
    launches none), the captured layers against the plain attention.
    Returns (tokens, stats, fields to emit)."""
    n_layers = cfg.n_layers
    capture = Capture(attn_ops.flash_attention, (0, n_layers - 1))
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    layers.flash_attention = capture
    try:
        zero_kernel_counts()
        t0 = time.perf_counter()
        out = run(stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = attn_ops.flash_attention.launches
    finally:
        layers.flash_attention = attn_ops.flash_attention
    peak = torch.cuda.max_memory_allocated()
    logits = stats["prefill_logits"][..., :cfg.vocab_size]
    if out.shape != shape:
        fail(f"{phase}: tokens have shape {out.shape}, expected {shape}")
    if out.min() < 0 or out.max() >= cfg.vocab_size:
        fail(f"{phase}: a token lies outside [0, vocab)")
    if not bool(torch.isfinite(logits).all()):
        fail(f"{phase}: the prefill's logits are not finite")
    if launches != n_layers:
        fail(f"{phase}: {launches} flash-attention launches in one "
             f"prefill, expected {n_layers}")
    layer_err = {}
    for idx, ((q, k, v), kw, (got,)) in sorted(capture.kept.items()):
        layer_err[f"layer_{idx}"], _ = attn_check(
            got, attention_ref(q, k, v, **kw), f"{phase} layer {idx}")
    capture.kept.clear()
    B, new = out.shape
    gen_s = stats["prefill_seconds"] + stats["decode_seconds"]
    fields = dict(
        arch=cfg.name, n_layers=n_layers, d_model=cfg.d_model,
        heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", head_dim=cfg.hd,
        dtype=cfg.param_dtype, batch=B, max_new=new, launches=launches,
        captured_layers_max_abs_err=layer_err,
        prefill_seconds=stats["prefill_seconds"],
        decode_seconds=stats["decode_seconds"],
        decode_ms_per_step=1e3 * stats["decode_seconds"] / (new - 1),
        tokens_per_second=B * new / gen_s, main_wall_seconds=wall,
        peak_memory_bytes=peak, sample=out[0][:8].tolist())
    return out, stats, fields


def phase_serve_path(profile: bool):
    """`launch.serve.main` on full-width granite-3-2b, once; then the same
    parameters and prompts through a prefill with the plain attention, for
    comparison, and with `profile` a profiled warm run."""
    cfg = get_config(SERVE_ARCH)
    out, stats, fields = serve_lm_path(
        "serve_path", cfg, lambda stats: serve.main(serve_argv(), stats=stats),
        (SERVE_BATCH, SERVE_NEW))
    emit("serve_path", prompt_len=SERVE_PROMPT, **fields, ok=True)
    logits = stats["prefill_logits"][..., :cfg.vocab_size]

    # the same parameters and prompts again, through the prefill only (the
    # decode steps run no attention kernel): the plain attention by name
    cfg, pol, params, prompts, _ = serve.setup(
        SERVE_ARCH, False, SERVE_BATCH, SERVE_PROMPT, SERVE_SEED, None)
    plain_stats = {}
    layers.flash_attention = functools.partial(attn_ops.flash_attention,
                                               impl="torch")
    try:
        plain = generate(cfg, pol, params, prompts, max_new=1,
                         stats=plain_stats)
    finally:
        layers.flash_attention = attn_ops.flash_attention
    plain_logits = plain_stats["prefill_logits"][..., :cfg.vocab_size]
    emit("serve_plain_attention", impl="torch", stage="prefill",
         first_token_agreement=float((out[:, 0] == plain[:, 0]).mean()),
         first_tokens=out[:, 0].tolist(),
         plain_first_tokens=plain[:, 0].tolist(),
         last_position_logits_max_abs_diff=float(
             (logits.float() - plain_logits.float()).abs().max()),
         prefill_seconds=plain_stats["prefill_seconds"],
         note="not gated: bf16 near-ties can flip a greedy token")
    if profile:
        profile_serving(cfg, pol, params, prompts)
    return fields["launches"]


# ---------------------------------------------------- hybrid serving


def kernel_counts() -> dict:
    return {"lru_forward": lru_ops.lru_forward.launches,
            "lru_reverse": lru_ops.lru_reverse.launches,
            "flash_attention": attn_ops.flash_attention.launches}


def zero_kernel_counts():
    lru_ops.lru_forward.launches = 0
    lru_ops.lru_reverse.launches = 0
    attn_ops.flash_attention.launches = 0


def logit_agreement(got, want) -> dict:
    """Largest |got - want| over the RMS of `want`, and the share of
    positions whose argmax agrees (float32 logits [..., V])."""
    rms = float(want.square().mean().sqrt())
    return dict(max_abs_diff=float((got - want).abs().max()), want_rms=rms,
                max_abs_diff_over_rms=float((got - want).abs().max()) / rms,
                argmax_agreement=float(
                    (got.argmax(-1) == want.argmax(-1)).float().mean()))


def decode_all(cfg, pol, params, tokens, family=hybrid):
    """Logits [B, T, V] of decoding `tokens` [B, T] one step each through
    a recurrent `family` from a fresh cache of T slots (for the hybrid, a
    ring once T > local_window)."""
    B, T = tokens.shape
    cache = family.init_cache(cfg, pol, B, T, device=tokens.device)
    outs = []
    for i in range(T):
        lg, cache = family.decode_step(cfg, pol, params, cache,
                                       tokens[:, i:i + 1])
        outs.append(lg[..., :cfg.vocab_size].float())
    return torch.cat(outs, dim=1)


def hybrid_float32_gate():
    """Gate (a): full-width recurrentgemma-2b in float32, B 1, the window
    cut to HYBRID_F32_WINDOW so that a HYBRID_F32_TOKENS-token decode wraps
    its ring: decode logits against one `forward` (both kernels) at every
    position, rtol = atol = HYBRID_FORWARD_TOL."""
    cfg = get_config(HYBRID_ARCH).with_(
        param_dtype="float32", compute_dtype="float32",
        local_window=HYBRID_F32_WINDOW, attention_impl="pallas")
    pol = single_device_policy(cfg)
    gen = torch.Generator(device=Dispatch.device).manual_seed(SERVE_SEED)
    params = hybrid.init_params(cfg, pol, gen)
    toks = torch.randint(0, cfg.vocab_size, (1, HYBRID_F32_TOKENS),
                         generator=gen, device=Dispatch.device)
    with torch.inference_mode():
        dec = decode_all(cfg, pol, params, toks)
        hidden, _ = hybrid.forward(cfg, pol, params, toks)
        full = unembed(cfg, pol, hidden, params["embed"])[
            ..., :cfg.vocab_size].float()
    tol = HYBRID_FORWARD_TOL
    excess = float(((dec - full).abs() - tol - tol * full.abs()).max())
    out = dict(dtype="float32", batch=1, tokens=HYBRID_F32_TOKENS,
               local_window=HYBRID_F32_WINDOW, rtol=tol, atol=tol,
               excess=excess, **logit_agreement(dec, full))
    del params, hidden, dec, full
    gc.collect()
    torch.cuda.empty_cache()
    if not excess <= 0:
        fail(f"hybrid_serve_path: float32 decode differs from forward "
             f"beyond rtol = atol = {tol}: {out}")
    return out


def hybrid_reduced_gate():
    """Gate (b): the reduced config on the card against the same port on
    the CPU, the same parameters and tokens (the prompt, then the CPU's
    greedy continuation, fed to both): every decode step's logits within
    HYBRID_CPU_TOL, and the greedy token equal wherever the CPU's top-2
    gap exceeds HYBRID_GAP."""
    cfg = smoke_config(HYBRID_ARCH).with_(attention_impl="pallas")
    pol = single_device_policy(cfg)
    B, S, new = HYBRID_REDUCED
    cpu_params = hybrid.init_params(cfg, pol,
                                    torch.Generator().manual_seed(SERVE_SEED))
    card_params = tree_map(lambda t: t.to(Dispatch.device), cpu_params)
    prompts = torch.from_numpy(np.random.default_rng(SERVE_SEED).integers(
        0, cfg.vocab_size, (B, S)))
    cpu_out = generate(cfg, pol, cpu_params, prompts, max_new=new)
    card_out = generate(cfg, pol, card_params, prompts, max_new=new)
    seq = torch.cat([prompts, torch.from_numpy(cpu_out[:, 1:]).long()], 1)
    with torch.inference_mode():
        want = decode_all(cfg, pol, cpu_params, seq)
        got = decode_all(cfg, pol, card_params,
                         seq.to(Dispatch.device)).cpu()
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > HYBRID_GAP
    agree = got.argmax(-1) == want.argmax(-1)
    out = dict(batch=B, prompt_len=S, max_new=new,
               window=cfg.local_window, positions=int(seq.shape[1]),
               tol=HYBRID_CPU_TOL, top2_gap=HYBRID_GAP,
               near_ties=int((~clear).sum()),
               clear_argmax_agreement=float(agree[clear].float().mean()),
               generate_tokens_equal=bool(np.array_equal(cpu_out, card_out)),
               **logit_agreement(got, want))
    if not out["max_abs_diff"] <= HYBRID_CPU_TOL:
        fail(f"hybrid_serve_path: reduced decode on the card differs from "
             f"the CPU's by more than {HYBRID_CPU_TOL}: {out}")
    if not bool(agree[clear].all()):
        fail(f"hybrid_serve_path: a greedy token with a top-2 gap above "
             f"{HYBRID_GAP} differs between the card and the CPU: {out}")
    return out


def tree_map(fn, tree):
    """`fn` of every tensor of a nested dict / list, in its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def free_card():
    gc.collect()
    torch.cuda.empty_cache()


def replay_argv(arch, prompt_len):
    return ["--arch", arch, "--batch", str(SERVE_BATCH), "--prompt-len",
            str(prompt_len), "--max-new", str(SERVE_NEW), "--seed",
            str(SERVE_SEED)]


def replay_run(phase, arch, module, prompt_len):
    """`launch.serve.main` on `arch` at full width and depth, prompts of
    `prompt_len` tokens replayed one decode step a token, with
    `module.decode_step` captured over the replay's last HYBRID_TAIL calls,
    the kernel counts zeroed just before and read just after. Gates the
    number of decode steps, the tokens' shape and vocabulary and finite
    replayed logits. Returns (tokens, stats, replayed logits [B,
    HYBRID_TAIL, V] float32, launches, fields to emit)."""
    cfg = get_config(arch)
    S, V = prompt_len, cfg.vocab_size
    keep = range(S - 1 - HYBRID_TAIL, S - 1)     # the replay's last calls
    capture = Capture(module.decode_step, keep)
    free_card()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    module.decode_step = capture
    try:
        zero_kernel_counts()
        t0 = time.perf_counter()
        out = serve.main(replay_argv(arch, S), stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
    finally:
        module.decode_step = capture.fn
    peak = torch.cuda.max_memory_allocated()
    if capture.calls != (S - 1) + (SERVE_NEW - 1):
        fail(f"{phase}: {capture.calls} decode steps, expected {S - 1} "
             f"replayed + {SERVE_NEW - 1} generated")
    if out.shape != (SERVE_BATCH, SERVE_NEW):
        fail(f"{phase}: tokens have shape {out.shape}")
    if out.min() < 0 or out.max() >= V:
        fail(f"{phase}: a token lies outside [0, vocab)")
    replay = torch.cat([capture.kept[i][2][0] for i in keep], 1)[
        ..., :V].float()
    capture.kept.clear()
    if not bool(torch.isfinite(replay).all()):
        fail(f"{phase}: the replay's logits are not finite")
    generated = SERVE_BATCH * (SERVE_NEW - 1)
    seconds = stats["replay_seconds"] + stats["decode_seconds"] + \
        stats.get("encode_seconds", 0.0)
    fields = dict(
        arch=arch, dtype=cfg.param_dtype, batch=SERVE_BATCH, prompt_len=S,
        max_new=SERVE_NEW, replay_seconds=stats["replay_seconds"],
        replay_ms_per_step=1e3 * stats["replay_seconds"] / (S - 1),
        decode_seconds=stats["decode_seconds"],
        decode_ms_per_step=1e3 * stats["decode_seconds"] / (SERVE_NEW - 1),
        generated_tokens=generated, tokens_per_second=generated / seconds,
        decode_tokens_per_second=generated / stats["decode_seconds"],
        main_wall_seconds=wall, peak_memory_bytes=peak,
        sample=out[0][:8].tolist())
    return out, stats, replay, launches, fields


def check_first_column(phase, out, prompts):
    if not np.array_equal(out[:, 0], prompts[:, -1].cpu().numpy()):
        fail(f"{phase}: the first column is not the prompt's last token")


def phase_hybrid_serve_path():
    """`launch.serve.main` on full-width recurrentgemma-2b (bf16, a prompt
    of HYBRID_PROMPT tokens replayed token by token; its ring of 2048
    slots wraps in gate (a), at a window of 64), then one
    `forward` over the same tokens against the last HYBRID_TAIL replayed
    positions (reported, not gated), and the two gates. The kernel counts
    are zeroed before the serving run and read after it and at the end:
    the decode path launches none, each forward launches the RG-LRU kernel
    once a recurrent layer and the attention kernel once an attention
    layer."""
    phase = "hybrid_serve_path"
    out, _, replay, serve_launches, fields = replay_run(
        phase, HYBRID_ARCH, hybrid, HYBRID_PROMPT)
    if any(serve_launches.values()):
        fail(f"{phase}: the decode path launched kernels: {serve_launches}")
    # the same parameters and prompts: one forward over the replayed tokens
    S = HYBRID_PROMPT
    cfg, pol, params, prompts, _ = serve.setup(HYBRID_ARCH, False,
                                               SERVE_BATCH, S, SERVE_SEED,
                                               None)
    check_first_column(phase, out, prompts)
    _, n_rec, n_attn = hybrid._counts(cfg)
    with torch.inference_mode():
        hidden, _ = hybrid.forward(cfg, pol, params, prompts[:, :S - 1])
        full = unembed(cfg, pol, hidden[:, -HYBRID_TAIL:], params["embed"])[
            ..., :cfg.vocab_size].float()
    forward_check = logit_agreement(replay, full)
    del params, hidden, full, replay
    free_card()
    float32_gate = hybrid_float32_gate()
    reduced_gate = hybrid_reduced_gate()
    launches = kernel_counts()
    want = {"lru_forward": 2 * n_rec, "lru_reverse": 0,
            "flash_attention": 2 * n_attn}
    if launches != want:
        fail(f"{phase}: {launches} launches in the two forward checks, "
             f"expected {want}")
    emit(phase, n_layers=cfg.n_layers, d_model=cfg.d_model,
         d_rnn=cfg.d_rnn, window=cfg.local_window,
         heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", **fields,
         serve_launches=serve_launches, launches=launches,
         replay_tail_against_forward=dict(
             positions=HYBRID_TAIL, **forward_check,
             note="not gated: bf16 through 26 layers, the replay's "
                  "one-token steps against the forward's kernels"),
         float32_gate=float32_gate, reduced_card_against_cpu=reduced_gate,
         ok=True)
    return launches


# ------------------------------------------- MoE and VLM serving


class DropCount:
    """Stands in for `moe._route` (or, with `name`, `moe._route_logits`,
    which an MoE layer on a mesh calls on its rank's rows): passes every
    call on and, for a call over more than one position (a prefill, a
    train step), keeps on the card the number of choices routed past
    their expert's capacity (an expert's choices past C are those of rank
    >= C) and the number of choices."""

    def __init__(self, name: str = "_route"):
        self.fn, self.dropped, self.choices = getattr(moe, name), [], 0

    def __call__(self, *args):
        gate, idx, probs = self.fn(*args)
        cfg = args[-2]          # (p, cfg, x) or (cfg, logits)
        B, S, k = idx.shape
        if S > 1:
            E = probs.shape[-1]
            C = moe.capacity(S, k, E, cfg.capacity_factor)
            counts = torch.nn.functional.one_hot(
                idx.reshape(B, S * k), E).sum(1)              # [B, E]
            self.dropped.append((counts - C).clamp(min=0).sum())
            self.choices += idx.numel()
        return gate, idx, probs

    def share(self) -> float:
        return float(sum(self.dropped)) / max(self.choices, 1)


def phase_vlm_serve_path():
    """pixtral-12b at full width and depth (bf16, random weights from the
    serving seed): `serve.setup`, then `generate` with patch embeddings for
    the first `n_prefix` positions of every prompt, drawn on the card x
    0.02 as train/data.py draws them; 40 kernel launches a prefill."""
    free_card()
    cfg, pol, params, prompts, _ = serve.setup(
        VLM_ARCH, False, SERVE_BATCH, SERVE_PROMPT, SERVE_SEED, None)
    gen = torch.Generator(device=Dispatch.device).manual_seed(SERVE_SEED + 1)
    embeds = torch.randn((SERVE_BATCH, cfg.n_prefix, cfg.d_model),
                         generator=gen, device=Dispatch.device) * 0.02
    out, _, fields = serve_lm_path(
        "vlm_serve_path", cfg, lambda stats: generate(
            cfg, pol, params, prompts, max_new=SERVE_NEW, embeds=embeds,
            stats=stats), (SERVE_BATCH, SERVE_NEW))
    emit("vlm_serve_path", prompt_len=SERVE_PROMPT, n_prefix=cfg.n_prefix,
         parameters=sum(t.numel() for t in tree_leaves(params)),
         **fields, ok=True)
    return fields["launches"]


def moe_serve_argv():
    return ["--arch", MOE_ARCH, "--batch", str(SERVE_BATCH),
            "--prompt-len", str(SERVE_PROMPT), "--max-new", str(SERVE_NEW),
            "--seed", str(SERVE_SEED)]


def phase_moe_serve_path():
    """`launch.serve.main` on qwen2-moe-a2.7b at full width and depth (bf16,
    random weights from the serving seed, the gather dispatch), at
    granite's serving shape; 24 kernel launches a prefill. Reports the
    share of the prefill's token choices dropped at capacity (a decode
    step, C = 1 and one choice an expert a row, drops none)."""
    free_card()
    drops = DropCount()
    moe._route = drops
    try:
        out, _, fields = serve_lm_path(
            "moe_serve_path", get_config(MOE_ARCH),
            lambda stats: serve.main(moe_serve_argv(), stats=stats),
            (SERVE_BATCH, SERVE_NEW))
    finally:
        moe._route = drops.fn
    cfg = get_config(MOE_ARCH)
    emit("moe_serve_path", prompt_len=SERVE_PROMPT,
         experts=f"{cfg.n_experts} top-{cfg.experts_per_token}",
         prefill_capacity=moe.capacity(SERVE_PROMPT, cfg.experts_per_token,
                                       cfg.n_experts, cfg.capacity_factor),
         prefill_choices=drops.choices,
         prefill_dropped_share=drops.share(), **fields, ok=True)
    return fields["launches"]


def phase_arctic_serve_path():
    """arctic-480b at full width, its depth cut from 35 layers to
    ARCTIC_LAYERS (the whole model is ~960 GB of bf16): one prompt of
    SERVE_PROMPT tokens, ARCTIC_NEW new tokens; one kernel launch a
    prefill, at a GQA group of 7."""
    free_card()
    cfg = get_config(ARCTIC_ARCH).with_(n_layers=ARCTIC_LAYERS,
                                        attention_impl="pallas")
    pol = single_device_policy(cfg)
    gen = torch.Generator(device=Dispatch.device).manual_seed(SERVE_SEED)
    params = lm.init_params(cfg, pol, gen)
    prompts = torch.randint(0, cfg.vocab_size, (ARCTIC_BATCH, SERVE_PROMPT),
                            generator=gen, device=Dispatch.device)
    drops = DropCount()
    moe._route = drops
    try:
        out, _, fields = serve_lm_path(
            "arctic_serve_path", cfg, lambda stats: generate(
                cfg, pol, params, prompts, max_new=ARCTIC_NEW, stats=stats),
            (ARCTIC_BATCH, ARCTIC_NEW))
    finally:
        moe._route = drops.fn
    emit("arctic_serve_path", prompt_len=SERVE_PROMPT,
         depth_cut=f"{ARCTIC_LAYERS} of {get_config(ARCTIC_ARCH).n_layers}",
         experts=f"{cfg.n_experts} top-{cfg.experts_per_token}",
         gqa_group=cfg.n_heads // cfg.n_kv_heads,
         parameters=sum(t.numel() for t in tree_leaves(params)),
         prefill_dropped_share=drops.share(), **fields, ok=True)
    return fields["launches"]


# ------------------------------------- xLSTM and encoder-decoder serving


def phase_xlstm_gate():
    """Full-width xlstm-1.3b in float32, cut to one pattern period (7 mLSTM
    + 1 sLSTM blocks), B 1, XLSTM_F32_TOKENS tokens (the forward's chunks
    of 64 carry their state twice and end padded): decode logits against
    one `forward` at every position, rtol = atol = HYBRID_FORWARD_TOL
    (tests/test_archs.py's); no kernel launched."""
    free_card()
    zero_kernel_counts()
    full_cfg = get_config(XLSTM_ARCH)
    cfg = full_cfg.with_(param_dtype="float32", compute_dtype="float32",
                         n_layers=len(full_cfg.xlstm_pattern))
    pol = single_device_policy(cfg)
    gen = torch.Generator(device=Dispatch.device).manual_seed(SERVE_SEED)
    params = xlstm.init_params(cfg, pol, gen)
    toks = torch.randint(0, cfg.vocab_size, (1, XLSTM_F32_TOKENS),
                         generator=gen, device=Dispatch.device)
    with torch.inference_mode():
        dec = decode_all(cfg, pol, params, toks, family=xlstm)
        hidden, _ = xlstm.forward(cfg, pol, params, toks)
        full = unembed(cfg, pol, hidden, params["embed"])[
            ..., :cfg.vocab_size].float()
    tol = HYBRID_FORWARD_TOL
    excess = float(((dec - full).abs() - tol - tol * full.abs()).max())
    out = dict(dtype="float32", n_layers=cfg.n_layers, batch=1,
               tokens=XLSTM_F32_TOKENS, chunk=cfg.mlstm_chunk, rtol=tol,
               atol=tol, excess=excess, **logit_agreement(dec, full))
    del params, hidden, dec, full
    free_card()
    if not excess <= 0:
        fail(f"xlstm_gate: float32 decode differs from forward beyond "
             f"rtol = atol = {tol}: {out}")
    if any(kernel_counts().values()):
        fail(f"xlstm_gate: kernels launched: {kernel_counts()}")
    emit("xlstm_gate", arch=XLSTM_ARCH, d_model=cfg.d_model, **out, ok=True)


def phase_xlstm_serve_path():
    """`launch.serve.main` on full-width xlstm-1.3b (bf16, 48 blocks, the
    prompt replayed token by token through `models/xlstm.py::decode_step`):
    no kernel launched, gated. Then one `forward` over the replayed tokens
    against the replay's last HYBRID_TAIL positions (reported, not gated);
    gated: none launched there either. Returns the attention kernel's
    launches (0)."""
    phase = "xlstm_serve_path"
    out, _, replay, serve_launches, fields = replay_run(
        phase, XLSTM_ARCH, xlstm, XLSTM_PROMPT)
    if any(serve_launches.values()):
        fail(f"{phase}: the xLSTM path launched kernels: {serve_launches}")
    cfg, pol, params, prompts, _ = serve.setup(
        XLSTM_ARCH, False, SERVE_BATCH, XLSTM_PROMPT, SERVE_SEED, None)
    check_first_column(phase, out, prompts)
    tail = lambda c, p, h: unembed(c, pol, h[:, -HYBRID_TAIL:], p["embed"])[
        ..., :c.vocab_size].float()
    with torch.inference_mode():
        hidden, _ = xlstm.forward(cfg, pol, params,
                                  prompts[:, :XLSTM_PROMPT - 1])
        full = tail(cfg, params, hidden)
        # the same weights and tokens in float32: how far bf16 alone moves
        # the forward's logits through 48 random blocks
        cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
        params32 = tree_map(lambda t: t.float(), params)
        del hidden
        hidden, _ = xlstm.forward(cfg32, pol, params32,
                                  prompts[:, :XLSTM_PROMPT - 1])
        full32 = tail(cfg32, params32, hidden)
    forward_check = logit_agreement(replay, full)
    bf16_check = logit_agreement(full, full32)
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params, params32, hidden, full, full32, replay
    free_card()
    launches = kernel_counts()
    if any(launches.values()):
        fail(f"{phase}: the forward checks launched kernels: {launches}")
    emit(phase, n_layers=cfg.n_layers, d_model=cfg.d_model,
         heads=cfg.n_heads, mlstm_head_dim=2 * cfg.d_model // cfg.n_heads,
         pattern="".join(cfg.xlstm_pattern), parameters=n_params, **fields,
         serve_launches=serve_launches, launches=launches,
         replay_tail_against_forward=dict(
             positions=HYBRID_TAIL, **forward_check,
             note="not gated: bf16 through 48 blocks, the replay's "
                  "one-token steps against the forward's chunks of 64"),
         bf16_forward_against_float32_forward=dict(
             positions=HYBRID_TAIL, **bf16_check,
             note="not gated: the same weights (bf16 values) and tokens, "
                  "the forward in float32"),
         ok=True)
    return launches["flash_attention"]


def phase_encdec_serve_path():
    """`launch.serve.main` on full-width seamless-m4t-large-v2 (bf16, 24 +
    24 layers, frames [B, RECUR_PROMPT, d] from the serving seed): gated,
    one attention-kernel launch a layer of the encoder, bidirectional, and
    none in the teacher-forced replay or the decode; the first and last
    encoder layers' kernel outputs against the plain attention. Then one
    `forward` over the same frames and replayed tokens (the encoder and
    the decoder's causal layers on the kernel) against the replay's last
    HYBRID_TAIL positions, reported. Returns the launches a generate."""
    phase = "encdec_serve_path"
    cfg = get_config(ENCDEC_ARCH)
    n_enc = cfg.n_enc_layers
    capture = Capture(attn_ops.flash_attention, (0, n_enc - 1))
    layers.flash_attention = capture
    try:
        out, stats, replay, launches, fields = replay_run(
            phase, ENCDEC_ARCH, encdec, RECUR_PROMPT)
    finally:
        layers.flash_attention = attn_ops.flash_attention
    want = {"lru_forward": 0, "lru_reverse": 0, "flash_attention": n_enc}
    if launches != want:
        fail(f"{phase}: {launches} kernel launches in one generate, "
             f"expected {want}")
    layer_err = {}
    for idx, ((q, k, v), kw, (got,)) in sorted(capture.kept.items()):
        if kw.get("causal", True) or q.shape[1] != RECUR_PROMPT:
            fail(f"{phase}: encoder layer {idx} called the kernel with "
                 f"{kw} at S {q.shape[1]}")
        layer_err[f"encoder_layer_{idx}"], _ = attn_check(
            got, attention_ref(q, k, v, **kw), f"{phase} layer {idx}")
    capture.kept.clear()
    cfg, pol, params, prompts, embeds = serve.setup(
        ENCDEC_ARCH, False, SERVE_BATCH, RECUR_PROMPT, SERVE_SEED, None)
    check_first_column(phase, out, prompts)
    with torch.inference_mode():
        hidden, _ = encdec.forward(cfg, pol, params,
                                   prompts[:, :RECUR_PROMPT - 1], embeds)
        full = unembed(cfg, pol, hidden[:, -HYBRID_TAIL:], params["embed"])[
            ..., :cfg.vocab_size].float()
    forward_check = logit_agreement(replay, full)
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params, hidden, full, replay, embeds
    free_card()
    emit(phase, n_enc_layers=n_enc, n_dec_layers=cfg.n_dec_layers,
         d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
         head_dim=cfg.hd, d_ff=cfg.d_ff, frames=RECUR_PROMPT,
         parameters=n_params, encode_seconds=stats["encode_seconds"],
         **fields, launches=launches["flash_attention"],
         captured_layers_max_abs_err=layer_err,
         replay_tail_against_forward=dict(
             positions=HYBRID_TAIL, **forward_check,
             note="not gated: bf16 through 24 + 24 layers, the replay's "
                  "one-token steps (bf16 KV cache) against decode_train's "
                  "causal kernel"),
         ok=True)
    return launches["flash_attention"]


def moe_mixture(p, cfg, x):
    """The per-token dense top-k mixture of the reference's oracle
    (tests/test_archs.py:104-128), computed expert by expert over every
    token: torch.topk (not the port's stable sort) on float32 logits."""
    probs = torch.softmax(x.float() @ p["router"], -1)
    gate, idx = torch.topk(probs, cfg.experts_per_token)
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        w = (gate * (idx == e)).sum(-1, keepdim=True)       # [B, S, 1]
        h = torch.nn.functional.silu(x @ p["wg"][e]) * (x @ p["wi"][e])
        out += w * (h @ p["wo"][e])
    return out


def phase_moe_layer():
    """One qwen2-moe MoE layer at full width in float32 on the card, B x S
    = MOE_LAYER_SHAPE: with capacity_factor E / k (C = S: nothing drops)
    gather and einsum each against the dense mixture; at the config's
    capacity_factor, gather against einsum under the same drops; both at
    MOE_LAYER_TOL."""
    free_card()
    cfg = get_config(MOE_ARCH).with_(param_dtype="float32",
                                     compute_dtype="float32")
    pol = single_device_policy(cfg)
    gen = torch.Generator(device=Dispatch.device).manual_seed(SERVE_SEED)
    p = moe.moe_init(gen, cfg, pol)
    B, S = MOE_LAYER_SHAPE
    x = torch.randn((B, S, cfg.d_model), generator=gen,
                    device=Dispatch.device) * 0.5
    rtol, atol = MOE_LAYER_TOL
    all_cf = cfg.n_experts / cfg.experts_per_token
    results = {}
    with torch.inference_mode():
        want = moe_mixture(p, cfg, x)
        for impl in ("gather", "einsum"):
            got, _ = moe.moe_forward(p, cfg.with_(capacity_factor=all_cf),
                                     pol, x, impl=impl)
            err, _ = bounded_check(got, want, (rtol, atol),
                                   f"moe_layer {impl} vs mixture")
            results[f"{impl}_vs_mixture_max_abs_err"] = err
        drops = DropCount()
        moe._route = drops
        try:
            g, _ = moe.moe_forward(p, cfg, pol, x, impl="gather")
        finally:
            moe._route = drops.fn
        e, _ = moe.moe_forward(p, cfg, pol, x, impl="einsum")
        err, _ = bounded_check(g, e, (rtol, atol), "moe_layer gather vs "
                               "einsum under drops")
    emit("moe_layer", arch=MOE_ARCH, dtype="float32", batch=B, seq=S,
         capacity_all=moe.capacity(S, cfg.experts_per_token, cfg.n_experts,
                                   all_cf),
         capacity=moe.capacity(S, cfg.experts_per_token, cfg.n_experts,
                               cfg.capacity_factor),
         dropped_share=drops.share(), gather_vs_einsum_max_abs_err=err,
         mixture_rms=float(want.square().mean().sqrt()), rtol=rtol,
         atol=atol, **results, ok=True)


def cpu_drawn_init(cfg, pol, gen, ocfg=None):
    """`init_state` with the parameters drawn on the CPU from `gen`'s seed
    and moved to `gen`'s device: the same weights as a CPU run's."""
    params = get_family(cfg).init_params(cfg, pol, torch.Generator(
    ).manual_seed(gen.initial_seed()))
    return state_for(tree_map(lambda t: t.to(gen.device), params), ocfg)


def reduced_generate(arch) -> dict:
    """`generate` on the reduced config, the card against the CPU, the
    same parameters (drawn on the CPU), prompts and embeds (patch
    embeddings, or an encoder-decoder's frames): greedy tokens equal, and
    within LM_CPU_TOL the prefill's logits (families of `models/lm.py`) or
    the last decode step's (the recurrent families and encdec, whose
    prompt is replayed)."""
    cfg = smoke_config(arch).with_(attention_impl="pallas")
    pol = single_device_policy(cfg)
    family = get_family(cfg)
    B, S, new = LM_REDUCED
    cpu_params = family.init_params(cfg, pol,
                                    torch.Generator().manual_seed(SERVE_SEED))
    card_params = tree_map(lambda t: t.to(Dispatch.device), cpu_params)
    rng = np.random.default_rng(SERVE_SEED)
    prompts = rng.integers(0, cfg.vocab_size, (B, S))
    n = S if cfg.family == "encdec" else cfg.n_prefix
    embeds = None
    if cfg.embeds_input:
        embeds = (rng.standard_normal((B, n, cfg.d_model))
                  * 0.02).astype(np.float32)
    prefill = cfg.family in lm.LM_FAMILIES
    last = (S - 1) + (new - 1) - 1          # the last replayed-or-decoded step

    def run(params):
        stats = {}
        capture = Capture(family.decode_step, () if prefill else (last,))
        family.decode_step = capture
        try:
            out = generate(cfg, pol, params, prompts, max_new=new,
                           embeds=embeds, stats=stats)
        finally:
            family.decode_step = capture.fn
        logits = stats["prefill_logits"] if prefill else \
            capture.kept[last][2][0]
        return out, logits[..., :cfg.vocab_size].float().cpu()

    cpu_out, cpu_logits = run(cpu_params)
    card_out, card_logits = run(card_params)
    diff = float((card_logits - cpu_logits).abs().max())
    which = "prefill" if prefill else "last_step"
    out = dict(batch=B, prompt_len=S, max_new=new,
               embeds=embeds is not None, logits=which,
               logits_max_abs_diff=diff,
               tokens_equal=bool(np.array_equal(cpu_out, card_out)))
    if not out["tokens_equal"]:
        fail(f"lm_reduced: {arch}'s greedy tokens differ between the card "
             f"and the CPU: {cpu_out.tolist()} against {card_out.tolist()}")
    if not diff <= LM_CPU_TOL:
        fail(f"lm_reduced: {arch}'s {which} logits on the card differ from "
             f"the CPU's by {diff} > {LM_CPU_TOL}")
    return out


def lm_reduced_train(arch) -> dict:
    """LM_TRAIN_STEPS steps of `launch.train.main --reduced` on the card
    against the same on the CPU, the card's parameters drawn on the CPU
    (`cpu_drawn_init`): every loss within LM_CPU_TOL."""
    argv = ["--arch", arch, "--reduced", "--steps", str(LM_TRAIN_STEPS),
            "--batch", "2", "--seq", "32", "--seed", str(SERVE_SEED)]
    cpu, card = {}, {}
    train.main(argv + ["--device", "cpu"], stats=cpu)
    train.init_state = cpu_drawn_init
    try:
        train.main(argv, stats=card)
    finally:
        train.init_state = init_state
    diff = float(np.abs(np.subtract(card["losses"], cpu["losses"])).max())
    if not diff <= LM_CPU_TOL:
        fail(f"lm_reduced: {arch}'s train losses on the card "
             f"{card['losses']} differ from the CPU's {cpu['losses']} by "
             f"more than {LM_CPU_TOL}")
    return dict(steps=LM_TRAIN_STEPS, losses=card["losses"],
                cpu_losses=cpu["losses"], max_abs_diff=diff)


def phase_lm_reduced():
    """The reduced configs on the card against the CPU: pixtral (with
    embeds), qwen2-moe, arctic, xlstm and seamless (with frames)
    `generate`; pixtral, qwen2-moe, xlstm and seamless training."""
    gates = {arch: reduced_generate(arch) for arch in (
        VLM_ARCH, MOE_ARCH, ARCTIC_ARCH, XLSTM_ARCH, ENCDEC_ARCH)}
    trains = {arch: lm_reduced_train(arch)
              for arch in (VLM_ARCH, MOE_ARCH, XLSTM_ARCH, ENCDEC_ARCH)}
    emit("lm_reduced", generate=gates, train=trains, tol=LM_CPU_TOL,
         ok=True)


# ------------------------------------------------------- the ML cluster


def load_example(name: str):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CLUSTER_INT_METRICS = ("jobs", "unfinished", "groups", "failures",
                       "straggler_kills", "requeues", "requeued_jobs")


def phase_cluster_path():
    """examples/cluster_scheduling_torch.py's sweep, uncut (300 jobs, 8 k's,
    failures and stragglers), with `ClusterSim`'s policy calls on the card,
    then on the CPU: the integer counters equal, the largest relative
    difference of the float metrics printed."""
    ex = load_example("cluster_scheduling_torch")
    card, cpu, seconds = {}, {}, {}
    for k in ex.KS:
        t0 = time.perf_counter()
        card[k] = ex.run(k)
        seconds[k] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in ex.KS:
        cpu[k] = ex.run(k, device="cpu")
    cpu_seconds = time.perf_counter() - t0
    worst = 0.0
    for k in ex.KS:
        for name in CLUSTER_INT_METRICS:
            if card[k][name] != cpu[k][name]:
                fail(f"cluster_path k={k}: {name} {card[k][name]} on the "
                     f"card, {cpu[k][name]} on the CPU")
        for name in set(cpu[k]) - set(CLUSTER_INT_METRICS):
            a, b = card[k][name], cpu[k][name]
            worst = max(worst, abs(a - b) / max(abs(b), 1e-300))
    emit("cluster_path", jobs=ex.JOBS, ks=list(ex.KS), n_chips=1024,
         seconds_per_k={str(k): s for k, s in seconds.items()},
         seconds=sum(seconds.values()), cpu_seconds=cpu_seconds,
         float_max_rel_diff=worst,
         groups={str(k): card[k]["groups"] for k in ex.KS},
         failures={str(k): card[k]["failures"] for k in ex.KS},
         avg_wait={str(k): card[k]["avg_wait"] for k in ex.KS}, ok=True)


# ----------------------------------------------------------- checkpoints


def state_leaves(state) -> list:
    return tree_leaves([state.params, state.opt.m, state.opt.v])


def phase_ckpt_path():
    """`launch.train.main` on reduced recurrentgemma-2b on the card with
    --ckpt-dir: CKPT_STEPS steps saving every --ckpt-every, then --resume to
    CKPT_RESUME_STEPS. Beside it, the same steps held in memory: their
    state saved by the async manager, stepped in place, restored, every
    leaf bitwise the state at the save; the first resumed step's loss
    against the same step from the state in memory; the parameters in
    bf16 saved and restored bitwise. Returns the kernel counts."""
    cfg = smoke_config(TRAIN_ARCH).with_(attention_impl="pallas")
    pol = single_device_policy(cfg)
    argv = ["--arch", TRAIN_ARCH, "--reduced", "--batch", str(CKPT_BATCH),
            "--seq", str(CKPT_SEQ), "--seed", str(CKPT_SEED),
            "--ckpt-every", "2", "--log-every", "1"]
    zero_kernel_counts()
    with tempfile.TemporaryDirectory() as root:
        main_dir, mem_dir, bf16_dir = (os.path.join(root, d)
                                       for d in ("main", "mem", "bf16"))
        first, resumed = {}, {}
        train.main(argv + ["--ckpt-dir", main_dir, "--steps",
                           str(CKPT_STEPS)], stats=first)
        train.main(argv + ["--ckpt-dir", main_dir, "--steps",
                           str(CKPT_RESUME_STEPS), "--resume"],
                   stats=resumed)
        launches = kernel_counts()
        files = sorted(os.listdir(main_dir))
        if resumed["start"] != CKPT_STEPS:
            fail(f"ckpt_path: resumed at step {resumed['start']}, expected "
                 f"{CKPT_STEPS}")
        want_files = [f"ckpt_{s:08d}.npz"
                      for s in range(2, CKPT_RESUME_STEPS + 1, 2)][-3:]
        if files != want_files:
            fail(f"ckpt_path: files {files}, expected {want_files}")

        # the same steps in memory, from the same seed and batches
        ocfg = AdamWConfig(lr=3e-3, warmup_steps=10,
                           total_steps=CKPT_RESUME_STEPS)
        gen = torch.Generator(device=Dispatch.device).manual_seed(CKPT_SEED)
        state = init_state(cfg, pol, gen, ocfg)
        step_fn = make_train_step(cfg, pol, ocfg)
        it = train_data.batches(cfg, train_data.DataConfig(
            batch=CKPT_BATCH, seq=CKPT_SEQ, seed=CKPT_SEED))
        batches = [{k: torch.from_numpy(v).to(Dispatch.device).long()
                    for k, v in next(it).items()} for _ in range(CKPT_STEPS)]
        for b in batches:
            state, _ = step_fn(state, b)
        main_file, _ = restore_checkpoint(main_dir, state, step=CKPT_STEPS)
        main_vs_memory = max(float((a.detach() - b.detach()).abs().max())
                             for a, b in zip(state_leaves(main_file),
                                             state_leaves(state)))
        del main_file
        saved = [x.detach().clone() for x in state_leaves(state)]
        mgr = CheckpointManager(mem_dir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(CKPT_STEPS, state, {"arch": cfg.name})
        snapshot_s = time.perf_counter() - t0
        # the resumed run restarted its batches: its first step takes the
        # first batch
        state, mets = step_fn(state, batches[0])
        memory_loss = float(mets["loss"])
        t0 = time.perf_counter()
        mgr.wait()
        wait_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, meta = restore_checkpoint(mem_dir, state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = state_leaves(restored)
        if meta["step"] != CKPT_STEPS or restored.opt.step != CKPT_STEPS:
            fail(f"ckpt_path: restored step {meta['step']} / "
                 f"{restored.opt.step}, expected {CKPT_STEPS}")
        bad = [i for i, (g, w) in enumerate(zip(got, saved))
               if g.device != w.device or not torch.equal(g, w)]
        if len(got) != len(saved) or bad:
            fail(f"ckpt_path: restored leaves {bad} differ from the state "
                 f"at the save")
        bf16 = tree_map(lambda t: t.detach().to(torch.bfloat16),
                        restored.params)
        save_checkpoint(bf16_dir, CKPT_STEPS, bf16)
        bf16_back, _ = restore_checkpoint(bf16_dir,
                                          tree_map(torch.zeros_like, bf16))
        bf16_bad = [i for i, (g, w) in enumerate(zip(
            tree_leaves(bf16_back), tree_leaves(bf16)))
            if g.dtype != torch.bfloat16
            or not torch.equal(g.view(torch.int16), w.view(torch.int16))]
        if bf16_bad:
            fail(f"ckpt_path: bf16 leaves {bf16_bad} restored unlike saved")
        bytes_on_disk = os.path.getsize(
            os.path.join(mem_dir, f"ckpt_{CKPT_STEPS:08d}.npz"))
    resumed_loss = resumed["losses"][0]
    rel = abs(resumed_loss - memory_loss) / abs(memory_loss)
    if not rel <= CKPT_LOSS_RTOL:
        fail(f"ckpt_path: the first resumed loss {resumed_loss} differs from "
             f"the same step in memory {memory_loss} by {rel} (relative)")
    emit("ckpt_path", arch=TRAIN_ARCH, reduced=True, batch=CKPT_BATCH,
         seq=CKPT_SEQ, steps=CKPT_STEPS, resumed_to=CKPT_RESUME_STEPS,
         files=files, losses=first["losses"], resumed_losses=resumed["losses"],
         first_resumed_loss=resumed_loss, same_step_in_memory_loss=memory_loss,
         resumed_loss_equal=resumed_loss == memory_loss,
         resumed_loss_rel_diff=rel, gate=CKPT_LOSS_RTOL,
         main_file_vs_memory_max_abs_diff=main_vs_memory,
         leaves=len(saved), restored_bitwise=True, bf16_restored_bitwise=True,
         save_snapshot_seconds=snapshot_s, save_write_wait_seconds=wait_s,
         restore_seconds=restore_s, checkpoint_bytes=bytes_on_disk,
         launches=launches, ok=True)
    return launches



PROFILE_DECODE_STEPS = 8
MATMUL_KERNEL_MARKS = ("gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet")


def kernel_times(prof) -> dict:
    """{kernel name: (device us, launches)} of a profiler session."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        out[e.key] = (e.self_device_time_total, e.count)
    return out


def summarize(name, wall_s, times, steps=1):
    """Device time of one profiled stage, by kind of kernel, per step,
    against the stage's unprofiled host-clock wall `wall_s`."""
    busy_ms = 1e-3 * sum(t for t, _ in times.values()) / steps
    wall_ms = 1e3 * wall_s / steps
    kinds = {"flash_attention": 0.0, "lru_scan": 0.0, "matmul": 0.0,
             "other": 0.0}
    for key, (t, _) in times.items():
        low = key.lower()
        kind = ("flash_attention" if "attn_kernel" in low else
                "lru_scan" if "lru_kernel" in low else
                "matmul" if any(m in low for m in MATMUL_KERNEL_MARKS) else
                "other")
        kinds[kind] += 1e-3 * t / steps
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(stage=name, steps=steps, wall_ms=wall_ms,
                device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms if busy_ms else None,
                by_kind_ms=kinds,
                launches=sum(c for _, c in times.values()) // steps,
                top_kernels=[dict(name=k[:90], ms=1e-3 * t / steps,
                                  launches=c // steps)
                             for k, (t, c) in top])


@torch.inference_mode()
def profile_serving(cfg, pol, params, prompts):
    """Where a warm serving run's time goes: one prefill and
    PROFILE_DECODE_STEPS decode steps timed on the host clock (each stage
    ended by a synchronize), then the same stages under torch.profiler for
    the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    step = make_serve_step(cfg, pol)
    max_len = prompts.shape[1] + PROFILE_DECODE_STEPS

    def prefill():
        hidden, cache = lm.prefill(cfg, pol, params, prompts, max_len)
        logits = unembed(cfg, pol, hidden[:, -1:], params["embed"])
        torch.cuda.synchronize()
        return torch.argmax(logits, dim=-1), cache

    def decode(tok, cache):
        for _ in range(PROFILE_DECODE_STEPS):
            tok, cache = step(params, cache, tok)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, cache = prefill()
    t1 = time.perf_counter()
    decode(tok, cache)
    t2 = time.perf_counter()
    with profile(activities=acts) as prof_p:
        tok, cache = prefill()
    with profile(activities=acts) as prof_d:
        decode(tok, cache)
    for name, wall, prof, steps in (
            ("prefill", t1 - t0, prof_p, 1),
            ("decode", t2 - t1, prof_d, PROFILE_DECODE_STEPS)):
        emit("serve_profile", **summarize(name, wall, kernel_times(prof),
                                          steps))


def cuda_ms(fn, reps: int) -> float:
    """CUDA-event ms per call over `reps` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_attention(case):
    """Kernel, plain version and SDPA on one model's layer at its serving
    path's size (bf16, causal or bidirectional as the case says), in
    turns; and what bounds the same work."""
    B, Sq, Skv, H, KV, hd, causal, window, softcap = case
    q, k, v = attn_inputs(case, torch.bfloat16, seed=100)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kw = dict(causal=causal)
    kernel = lambda: attn_ops.flash_attention(q, k, v, impl="cuda", **kw)
    plain = lambda: attn_ops.flash_attention(q, k, v, impl="torch", **kw)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    runs = {"kernel": [], "plain": [], "library": []}
    for name in ("kernel", "plain", "library", "library", "plain", "kernel"):
        fn = {"kernel": kernel, "plain": plain, "library": library}[name]
        runs[name].append(cuda_ms(fn, 3 if name == "plain" else 20))
    lib_err = float((library().transpose(1, 2).float()
                     - plain().float()).abs().max())
    # visible (query, key) pairs: causal cases have Sq == Skv
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
    flops = 4 * B * H * hd * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())   # q, k, v, o
    t_ops = 1e3 * flops / BF16_OPS_PER_S
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    mask = "causal" if causal else "bidirectional"
    return dict(shape=f"B={B} S={Sq} H={H} KV={KV} hd={hd} {mask} bf16",
                ms=min(runs["kernel"]), plain_ms=min(runs["plain"]),
                library_ms=min(runs["library"]), runs_ms=runs,
                run_order="kernel, plain, library, library, plain, kernel",
                library_max_abs_err_vs_plain=lib_err, flops=flops,
                bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


# --------------------------------------------------------------------------
# the RG-LRU kernel and the training path
# --------------------------------------------------------------------------

class LruWorst:
    """Largest kernel-vs-plain RG-LRU difference seen so far."""
    abs_err = 0.0


def lru_inputs(case, a_dtype, b_dtype, seed):
    """log_a (in `a_dtype`), b (in `b_dtype`), h0 (float32 or None) and
    the reverse's dh (in `b_dtype`), dh_last on the card, from a seed.
    log_a as tests/test_kernels.py draws it (decays in about [0.72, 0.99],
    so a carry fades within a few dozen steps), or, for a case with decays
    near 1, as the trained gates of models/hybrid.py :: rglru_gates make
    it: log_a = -1e-4 exp(z / 2), a carry that lasts the whole sequence,
    and b and dh scaled as that function scales its input, by
    sqrt(1 - a^2), which keeps h and g of unit size as the float32 bound
    assumes. (Unscaled, h grows to about sqrt(S) = 64 and the plain
    version's own float32 error, some 1e-3, exceeds the bound's 2e-5 where
    h crosses zero, against float64 and against any other order.)"""
    B, S, D, with_h0, near_one = case
    gen = torch.Generator(device=Dispatch.device).manual_seed(seed)
    draw = lambda *shape: torch.randn(shape, generator=gen,
                                      device=Dispatch.device)
    log_a = -torch.exp(draw(B, S, D) * 0.5) * (1e-4 if near_one else 0.1)
    a = torch.exp(log_a)
    scale = (torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) if near_one
             else 1.0)
    b = (draw(B, S, D) * scale).to(b_dtype)
    h0 = draw(B, D) if with_h0 else None
    dh = (draw(B, S, D) * scale).to(b_dtype)
    return log_a.to(a_dtype), b, h0, dh, draw(B, D)


def lru_runs():
    """(seed, case, log_a's type, b's type) of every `lru_kernel` check:
    every listed shape in float32 and in bf16, then one shape with each
    mixed pair, then every edge case with one mixed pair, the pairs in
    turn."""
    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        for i, case in enumerate(LRU_CASES):
            yield i, case, dtype, dtype
    pairs = ((bf16, f32), (f32, bf16))
    for a_dtype, b_dtype in pairs:
        yield 6, LRU_MIXED_CASE, a_dtype, b_dtype
    for i, case in enumerate(LRU_EDGE_CASES):
        yield 100 + i, case, *pairs[i % 2]


def phase_lru_kernel():
    """Forward and reverse launches against impl="torch" on every run of
    `lru_runs`. One type: that type's bound for every output (a bf16
    kernel also rounds dh0 to bf16). A mixed pair, which the wrapper widens
    to float32: each output at its own type's bound."""
    name_of = lambda dt: str(dt).replace("torch.", "")
    for seed, case, a_dtype, b_dtype in lru_runs():
        log_a, b, h0, dh, dh_last = lru_inputs(case, a_dtype, b_dtype, seed)
        types = (name_of(b_dtype) if a_dtype == b_dtype else
                 f"log_a {name_of(a_dtype)} b {name_of(b_dtype)}")
        label = (f"B={case[0]} S={case[1]} D={case[2]} "
                 f"h0={'yes' if case[3] else 'no'} "
                 f"decays={'near 1' if case[4] else 'wide'} {types}")
        got = lru_ops.lru_forward(log_a, b, h0, impl="cuda")
        want = lru_ops.lru_forward(log_a, b, h0, impl="torch")
        h = want[0]
        got_r = lru_ops.lru_reverse(log_a, dh, h, h0, dh_last, impl="cuda")
        want_r = lru_ops.lru_reverse(log_a, dh, h, h0, dh_last,
                                     impl="torch")
        torch.cuda.synchronize()
        errs, tols = {}, {}
        for name, g, w in zip(("h", "h_last", "db", "dlog_a", "dh0"),
                              got + got_r, want + want_r):
            tol = LRU_TOL[b_dtype if a_dtype == b_dtype else w.dtype]
            errs[name], _ = bounded_check(g, w, tol,
                                          f"lru_kernel {label} {name}")
            tols[name] = tol
        LruWorst.abs_err = max(LruWorst.abs_err, *errs.values())
        emit("lru_kernel", shape=label, max_abs_err=errs,
             rtol_atol=tols, ok=True)
        del log_a, b, h0, dh, dh_last, got, want, got_r, want_r, h


def phase_attention_grad():
    """The attention Function at recurrentgemma-2b's layer of the training
    path (forward by the kernel, backward plain): its forward output and
    its gradients against autograd through the plain forward; and the
    forward kernel's and the backward's times there. Returns a dict for the
    kernels line."""
    B, Sq, Skv, H, KV, hd, causal, window, softcap = RG_ATTN_CASE
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v = (x.requires_grad_() for x in
               attn_inputs(RG_ATTN_CASE, torch.bfloat16, seed=200))
    do = torch.randn(q.shape, generator=torch.Generator(
        device=Dispatch.device).manual_seed(201),
        device=Dispatch.device).to(torch.bfloat16)
    out = attn_ops.flash_attention(q, k, v, impl="cuda", **kw)
    got = (out.detach(),) + torch.autograd.grad(out, (q, k, v), do)
    out = attention_ref(q, k, v, **kw)
    want = (out.detach(),) + torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        errs[name], _ = attn_check(g, w, f"attention_grad {name}")
    del out, got, want
    q, k, v = (x.detach() for x in (q, k, v))
    # SDPA has no window argument: the causal window as a boolean mask
    pos = torch.arange(Sq, device=q.device)
    visible = ((pos[None, :] <= pos[:, None])
               & (pos[None, :] > pos[:, None] - window))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    runs = {"kernel_forward": [], "plain_backward": [], "library": []}
    fns = {"kernel_forward": lambda: attn_ops.flash_attention(
               q, k, v, impl="cuda", **kw),
           "plain_backward": lambda: attention_bwd_ref(q, k, v, do, **kw),
           "library": lambda: torch.nn.functional.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=visible, enable_gqa=True)}
    order = ("kernel_forward", "plain_backward", "library", "library",
             "plain_backward", "kernel_forward")
    for name in order:
        runs[name].append(cuda_ms(fns[name], 3))
    lib_err = float((fns["library"]().transpose(1, 2).float()
                     - attention_ref(q, k, v, **kw).float()).abs().max())
    shape = (f"B={B} S={Sq} H={H} KV={KV} hd={hd} causal window={window} "
             f"bf16")
    # visible (query, key) pairs of a causal window (Sq == Skv); the
    # forward does 2 products of hd per pair (QK^T, PV), the backward 5
    # (QK^T again, dP, dV, dQ, dK); bf16 inputs, so the bf16 peak bounds
    # both
    pairs = B * H * sum(min(i + 1, window) for i in range(Sq))
    elem = 2                                        # bytes of bf16
    bounds = {}
    for name, flops, nbytes in (
            ("forward", 4 * hd * pairs,
             elem * (2 * q.numel() + k.numel() + v.numel())),
            ("backward", 10 * hd * pairs,
             elem * (3 * q.numel() + 2 * (k.numel() + v.numel())))):
        t_ops = 1e3 * flops / BF16_OPS_PER_S
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        bounds[name] = dict(flops=flops, bytes=nbytes,
                            bound_ms=max(t_ops, t_bytes),
                            bound_by="operations" if t_ops >= t_bytes
                            else "bytes")
    out = dict(shape=shape, kernel_forward_ms=min(runs["kernel_forward"]),
               plain_backward_ms=min(runs["plain_backward"]),
               library_ms=min(runs["library"]),
               library="torch.nn.functional.scaled_dot_product_attention("
                       "attn_mask=<causal window of 2048 as bool>, "
                       "enable_gqa=True), timed as the yardstick only",
               library_max_abs_err_vs_plain=lib_err, runs_ms=runs,
               run_order=", ".join(order), bounds=bounds)
    emit("attention_grad", max_abs_err=errs,
         note="the backward is plain PyTorch (attention_bwd_ref), not a "
              "kernel: the TPU package has none to port", ok=True, **out)
    return out


def train_argv():
    return ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
            "--seed", str(TRAIN_SEED), "--log-every", "1"]


def phase_train_path():
    """`launch.train.main` on full recurrentgemma-2b for TRAIN_STEPS steps,
    its launches counted per step; in the first step, the kernel outputs of
    the first and the last recurrent layer (forward, and the reverse of the
    same two layers) and of the first and the last attention layer against
    the plain versions. Returns the launch counts."""
    cfg = get_config(TRAIN_ARCH)
    pat, reps, tail = hybrid._split(cfg)
    n_rec = sum(t == "rec" for t in list(pat) * reps + list(tail))
    n_attn = cfg.n_layers - n_rec
    rec_in_reps = sum(t == "rec" for t in pat) * reps
    attn_in_reps = sum(t == "attn" for t in pat) * reps
    # per step: forward of every layer, the repeats' forward again under
    # remat in the backward, the reverse walk once per recurrent layer
    want = {"lru_forward": n_rec + rec_in_reps, "lru_reverse": n_rec,
            "flash_attention": n_attn + attn_in_reps}
    # calls 0 and n_rec - 1 of the first step: layer 0 forward and the last
    # recurrent layer's forward; in the backward the last layer's reverse
    # comes first and layer 0's last
    fwd_capture = Capture(hybrid.chunked_lru, (0, n_rec - 1))
    rev_capture = Capture(lru_ops.lru_reverse, (0, n_rec - 1))
    attn_capture = Capture(attn_ops.flash_attention, (0, n_attn - 1))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    lru_ops.lru_forward.launches = 0
    lru_ops.lru_reverse.launches = 0
    attn_ops.flash_attention.launches = 0
    hybrid.chunked_lru, lru_ops.lru_reverse = fwd_capture, rev_capture
    layers.flash_attention = attn_capture
    try:
        t0 = time.perf_counter()
        train.main(train_argv(), stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"lru_forward": lru_ops.lru_forward.launches,
               "lru_reverse": lru_ops.lru_reverse.launches,
               "flash_attention": attn_ops.flash_attention.launches}
    finally:
        hybrid.chunked_lru = fwd_capture.fn
        lru_ops.lru_reverse = rev_capture.fn
        layers.flash_attention = attn_capture.fn
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()

    if not np.isfinite(stats["losses"]).all():
        fail(f"train_path: a loss is not finite: {stats['losses']}")
    per_step = {k: v / TRAIN_STEPS for k, v in got.items()}
    if per_step != want:
        fail(f"train_path: launches per step {per_step}, expected {want}")
    # the float32 bound, atol the smaller of its own and rtol * the plain
    # output's RMS (see the top); every layer is measured before the gate
    rtol, atol = LRU_TOL[torch.float32]
    layer_err = {}

    def check(name, got_, want_):
        err, excess, rms = differences(got_, want_, rtol, f"train_path {name}")
        layer_err[name] = dict(max_abs_err=err, excess=excess, plain_rms=rms,
                               atol=min(atol, rtol * rms))

    for idx, ((a, bx, _), _, (out,)) in sorted(fwd_capture.kept.items()):
        layer = "first" if idx == 0 else "last"
        plain = lru_ops.chunked_lru(a, bx, impl="torch")
        check(f"forward_{layer}_rec_layer", out, plain)
    for idx, ((log_a, dh, h, h0, dh_last, _), _, outs) in sorted(
            rev_capture.kept.items()):
        layer = "last" if idx == 0 else "first"
        plain = lru_ops.lru_reverse(log_a, dh, h, h0, dh_last, impl="torch")
        for name, g, w in zip(("db", "dlog_a", "dh0"), outs, plain):
            check(f"reverse_{layer}_rec_layer_{name}", g, w)
    if any(e["excess"] > e["atol"] for e in layer_err.values()):
        fail(f"train_path: a captured recurrent layer exceeds |kernel - "
             f"plain| <= atol + {rtol}*|plain|: {layer_err}")
    LruWorst.abs_err = max(LruWorst.abs_err,
                           *(e["max_abs_err"] for e in layer_err.values()))
    for idx, ((q, k, v), kw, (out,)) in sorted(attn_capture.kept.items()):
        layer = "first" if idx == 0 else "last"
        err, _ = attn_check(out, attention_ref(q, k, v, **kw),
                            f"train_path {layer} attention layer")
        layer_err[f"forward_{layer}_attn_layer"] = dict(max_abs_err=err)
    for c in (fwd_capture, rev_capture, attn_capture):
        c.kept.clear()
    warm = stats["step_seconds"][1:] or stats["step_seconds"]
    sec = sum(warm) / len(warm)
    emit("train_path", arch=TRAIN_ARCH, n_layers=cfg.n_layers,
         d_model=cfg.d_model, d_rnn=cfg.d_rnn,
         heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", window=cfg.local_window,
         dtype=cfg.param_dtype, remat=cfg.remat, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, steps=TRAIN_STEPS, launches=got,
         launches_per_step=per_step, expected_per_step=want,
         losses=stats["losses"], grad_norms=stats["grad_norms"],
         step_seconds=stats["step_seconds"],
         seconds_per_step_warm=sec,
         tokens_per_second_warm=TRAIN_BATCH * TRAIN_SEQ / sec,
         main_wall_seconds=wall, peak_memory_bytes=peak,
         captured_layers_max_abs_err=layer_err, ok=True)
    return got


def phase_train_plain_kernels():
    """The first step's loss and gradient norm with the kernels and with
    both kernels' plain versions, at full width and reduced depth (one
    (rec, rec, attn) repeat + the two-block tail), the same parameters
    and batch, gated at TRAIN_PLAIN_GATE."""
    cfg = get_config(TRAIN_ARCH).with_(n_layers=PLAIN_COMPARE_LAYERS,
                                       attention_impl="pallas")
    pol = single_device_policy(cfg)
    batch = next(train_data.batches(cfg, train_data.DataConfig(
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=TRAIN_SEED)))
    batch = {k: torch.from_numpy(v).to(Dispatch.device).long()
             for k, v in batch.items()}
    res = {}
    for run in ("kernels", "plain"):
        gen = torch.Generator(device=Dispatch.device).manual_seed(TRAIN_SEED)
        params = hybrid.init_params(cfg, pol, gen)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if run == "plain":
            hybrid.chunked_lru = functools.partial(lru_ops.chunked_lru,
                                                   impl="torch")
            layers.flash_attention = functools.partial(
                attn_ops.flash_attention, impl="torch")
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = make_loss_fn(cfg, pol)(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            gn = float(global_norm(grads))
            res[run] = dict(loss=float(loss.detach()), grad_norm=gn,
                            seconds=time.perf_counter() - t0)
        finally:
            hybrid.chunked_lru = lru_ops.chunked_lru
            layers.flash_attention = attn_ops.flash_attention
        del params, leaves, grads, loss
        gc.collect()
        torch.cuda.empty_cache()
    rel = {k: abs(res["kernels"][k] - res["plain"][k]) / abs(res["plain"][k])
           for k in TRAIN_PLAIN_GATE}
    if not all(np.isfinite([r[k] for r in res.values()
                            for k in TRAIN_PLAIN_GATE])):
        fail(f"train_plain_kernels: not finite: {res}")
    if any(rel[k] > TRAIN_PLAIN_GATE[k] for k in rel):
        fail(f"train_plain_kernels: kernels and plain versions differ by "
             f"{rel} (relative), over {TRAIN_PLAIN_GATE}")
    emit("train_plain_kernels", arch=TRAIN_ARCH, n_layers=cfg.n_layers,
         d_model=cfg.d_model, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         first_step=res, relative_difference=rel, gate=TRAIN_PLAIN_GATE,
         note="reduced depth, full width; the same parameters and batch",
         ok=True)


def profile_training():
    """Where a warm training step's time goes: full recurrentgemma-2b as in
    `train_path`, one step to warm up, one timed on the host clock (ended
    by a synchronize), then one under torch.profiler for the device time
    by kind of kernel."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(TRAIN_ARCH).with_(attention_impl="pallas")
    pol = single_device_policy(cfg)
    ocfg = AdamWConfig(warmup_steps=10, total_steps=TRAIN_STEPS)
    gen = torch.Generator(device=Dispatch.device).manual_seed(TRAIN_SEED)
    state = init_state(cfg, pol, gen, ocfg)
    step = make_train_step(cfg, pol, ocfg)
    batch = next(train_data.batches(cfg, train_data.DataConfig(
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=TRAIN_SEED)))
    batch = {k: torch.from_numpy(v).to(Dispatch.device).long()
             for k, v in batch.items()}
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    emit("train_profile", **summarize("train step", wall,
                                      kernel_times(prof)))
    del state
    gc.collect()
    torch.cuda.empty_cache()


def _dryrun_worker():
    """A dry-run worker: off the card, one thread (meta work is Python)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)


def cells_dryrun() -> tuple[list, float]:
    """The meta dry run of every assigned cell (`dryrun.lower_cell` on the
    production single-pod mesh) in CELLS_DRYRUN_WORKERS spawned processes,
    in the foreground: nothing else runs meanwhile. Returns the records in
    `cells()`'s order and the seconds the whole took."""
    t0 = time.perf_counter()
    with ProcessPoolExecutor(CELLS_DRYRUN_WORKERS,
                             multiprocessing.get_context("spawn"),
                             initializer=_dryrun_worker) as pool:
        futures = [pool.submit(dryrun.lower_cell, a, sh) for a, sh in cells()]
        records = [f.result() for f in futures]
    return records, time.perf_counter() - t0


def dryrun_summary(rec) -> dict:
    """One record of the dry run in a line's room."""
    out = dict(cell=f"{rec['arch']}:{rec['shape']}",
               strategy=rec["policy"]["strategy"],
               attn_mode=rec["policy"]["attn_mode"],
               kv_repeat=rec["policy"]["kv_repeat"],
               expert_pad=rec["policy"]["expert_pad"],
               params=rec["params"], estimate_bytes=rec["peak_bytes_estimate"],
               fits_one_card=rec["fits_one_card"], flops=rec["flops"],
               flops_analytic=rec["flops_analytic"],
               meta_seconds=rec["meta_seconds"])
    if not rec["fits_one_card"]:
        out["min_cards_lower_bound"] = rec["min_cards"]
    return out


def cells_attention_check(B):
    """The attention kernel at recurrentgemma-2b's prefill_32k layer (S =
    32 768, 10 / 1 heads, hd 256, window 2048) at the prefill's batch B:
    the last CELLS_ATTN_ROWS query rows of batch rows 0 and B - 1 against
    the plain version over every key (the full plain scores would be
    1.4 TB), at the bf16 gate; then the kernel's ms beside its bound and
    SDPA's (the causal window as a boolean mask, `enable_gqa`, under the
    cuDNN backend: the flash and efficient backends refuse a mask with
    GQA, and the math one would hold [B, 10, S, S] float32 scores)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    S, H, KV, hd, window = 32768, 10, 1, 256, 2048
    kw = dict(causal=True, window=window)
    pos = torch.arange(S, device=Dispatch.device)
    visible = ((pos[None, :] <= pos[:, None])
               & (pos[None, :] > pos[:, None] - window))

    def sdpa(q, k, v):
        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=visible, enable_gqa=True).transpose(1, 2)

    q, k, v = attn_inputs((B, S, S, H, KV, hd), torch.bfloat16, seed=401)
    got = attn_ops.flash_attention(q, k, v, impl="cuda", **kw)
    lib = sdpa(q, k, v)
    errs, lib_errs = {}, {}
    for row in sorted({0, B - 1}):
        rows = slice(row, row + 1)
        want = attention_ref(q[rows, -CELLS_ATTN_ROWS:], k[rows], v[rows],
                             **kw)
        errs[row], atol = attn_check(
            got[rows, -CELLS_ATTN_ROWS:].contiguous(), want,
            f"cells_path attention at S=32768, batch row {row}")
        lib_errs[row] = float((lib[rows, -CELLS_ATTN_ROWS:].float()
                               - want.float()).abs().max())
        del want
    del got, lib
    free_card()
    fns = {"kernel": lambda: attn_ops.flash_attention(q, k, v, impl="cuda",
                                                       **kw),
           "library": lambda: sdpa(q, k, v)}
    order = ("kernel", "library", "library", "kernel")
    runs = {name: [] for name in fns}
    for name in order:
        runs[name].append(cuda_ms(fns[name], 5 if name == "kernel" else 2))
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    del q, k, v, fns, visible
    free_card()
    flops = 4 * B * H * hd * attn_ops.visible_pairs(S, S, True, window)
    t_ops = 1e3 * flops / BF16_OPS_PER_S
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return dict(
        shape=f"B={B} S={S} H={H} KV={KV} hd={hd} causal window={window} "
              f"bf16", max_abs_err=max(errs.values()), atol=atol,
        max_abs_err_by_batch_row=errs,
        checked=f"batch rows {sorted(errs)}, each its last "
                f"{CELLS_ATTN_ROWS} query rows against all {S} keys",
        ms=min(runs["kernel"]), library_ms=min(runs["library"]),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        flops=flops, bytes=nbytes,
        library="torch.nn.functional.scaled_dot_product_attention(attn_mask="
                "<causal window as bool>, enable_gqa=True) under "
                "SDPBackend.CUDNN_ATTENTION; timed as the yardstick only",
        library_max_abs_err_vs_plain=max(lib_errs.values()), runs_ms=runs,
        run_order=", ".join(order))


def cells_lru_check(B):
    """The RG-LRU kernel at the same layer (S = 32 768, D 2560): forward and
    reverse against the plain version at B 1 in float32 (the model's type)
    and bf16, and the forward at the prefill's batch B in float32, at the
    existing gates; the forward's ms at B beside its bound and the plain
    version's."""
    S, D = 32768, 2560
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        log_a, b, _, dh, dh_last = lru_inputs((1, S, D, False, False), dtype,
                                              dtype, seed=410)
        got = lru_ops.lru_forward(log_a, b, impl="cuda")
        want = lru_ops.lru_forward(log_a, b, impl="torch")
        got_r = lru_ops.lru_reverse(log_a, dh, want[0], None, dh_last,
                                    impl="cuda")
        want_r = lru_ops.lru_reverse(log_a, dh, want[0], None, dh_last,
                                     impl="torch")
        name = str(dtype).replace("torch.", "")
        for out, g, w in zip(("h", "h_last", "db", "dlog_a", "dh0"),
                             got + got_r, want + want_r):
            errs[f"{name} {out}"], _ = bounded_check(
                g, w, LRU_TOL[dtype], f"cells_path lru {name} {out}")
        LruWorst.abs_err = max(LruWorst.abs_err, *errs.values())
        del log_a, b, dh, dh_last, got, want, got_r, want_r
    free_card()
    log_a, b, _, _, _ = lru_inputs((B, S, D, False, False), torch.float32,
                                   torch.float32, seed=411)
    got = lru_ops.lru_forward(log_a, b, impl="cuda")
    want = lru_ops.lru_forward(log_a, b, impl="torch")
    for out, g, w in zip(("h", "h_last"), got, want):
        errs[f"float32 B={B} forward {out}"], _ = bounded_check(
            g, w, LRU_TOL[torch.float32],
            f"cells_path lru float32 B={B} forward {out}")
    LruWorst.abs_err = max(LruWorst.abs_err, *errs.values())
    del got, want
    free_card()
    runs = {"forward": [], "plain_forward": []}
    for name in ("forward", "plain_forward", "plain_forward", "forward"):
        impl = "cuda" if name == "forward" else "torch"
        runs[name].append(cuda_ms(lambda: lru_ops.lru_forward(
            log_a, b, impl=impl), 3 if impl == "torch" else 10))
    del log_a, b
    free_card()
    bounds = lru_bounds(B, S, D, torch.float32)["forward"]
    return dict(shape=f"B={B} S={S} D={D} float32, no h0",
                checked=f"B=1 S={S} D={D} float32 and bfloat16, forward and "
                        f"reverse; B={B} float32 forward",
                max_abs_err=errs,
                ms=min(runs["forward"]), plain_ms=min(runs["plain_forward"]),
                bound_ms=bounds["bound_ms"], bound_by=bounds["bound_by"],
                bytes=bounds["bytes"], runs_ms=runs,
                run_order="forward, plain, plain, forward")


def phase_cells_path():
    """The assigned cell grid: the 32 records of the meta dry run
    (`cells_dryrun`), then CELLS_RUN on the card at their assigned shapes
    through `dryrun.run_requested` (a prefill whose estimate does not fit
    at B 32 at the largest batch whose estimate fits, printed under
    `reduced`), each gated: finite logits of the cell's shape, no kernel
    launched by a decode step, exactly CELLS_PREFILL_LAUNCHES a prefill;
    then both kernels at S = 32 768 held against their plain versions and
    timed. Returns (launches of the runs, the attention's and the RG-LRU's
    dicts for the kernels line)."""
    records, seconds = cells_dryrun()
    fit = [f"{r['arch']}:{r['shape']}" for r in records if r["fits_one_card"]]
    emit("cells_dryrun", cells=len(records), fit_one_card=len(fit),
         fitting=fit, seconds=seconds,
         meta_seconds_sum=sum(r["meta_seconds"] for r in records),
         records=[dryrun_summary(r) for r in records], ok=True)
    return cells_runs({f"{r['arch']}:{r['shape']}": r for r in records})


def cells_runs(by_cell: dict):
    """CELLS_RUN on the card from their dry-run records, gated, then both
    kernels at S = 32 768 (see `phase_cells_path`)."""
    free_card()
    zero_kernel_counts()
    launches = kernel_counts()
    runs = {}
    for cell in CELLS_RUN:
        rec = by_cell[cell]
        arch, shape = cell.split(":")
        run = dryrun.run_requested(rec)
        if "skipped" in run:
            fail(f"cells_path: {cell}: {run['skipped']}")
        kind = SHAPES[shape].kind
        vocab = layers.padded_vocab(get_config(arch))
        if not run["finite"] or run["output_shape"] != [run["batch"], 1,
                                                        vocab]:
            fail(f"cells_path: {cell}: logits {run['output_shape']}, "
                 f"finite {run['finite']}")
        n_calls = 2 if kind == "prefill" else \
            dryrun.RUN_WARM + dryrun.RUN_STEPS
        expect = ({k: v * n_calls for k, v in
                   CELLS_PREFILL_LAUNCHES.items()} if kind == "prefill"
                  else {k: 0 for k in CELLS_PREFILL_LAUNCHES})
        if run["launches"] != expect:
            fail(f"cells_path: {cell} launched {run['launches']}, expected "
                 f"{expect}")
        est = (run.get("estimate_at_reduced_batch")
               or rec["peak_bytes_estimate"])
        runs[cell] = dict(run, estimate_bytes=est,
                          peak_over_estimate=run["peak_bytes"] / est)
        emit("cells_run", cell=cell, **runs[cell], ok=True)
        free_card()
    after = kernel_counts()
    launches = {k: after[k] - launches[k] for k in after}
    B = runs["recurrentgemma-2b:prefill_32k"]["batch"]
    attn = cells_attention_check(B)
    lru = cells_lru_check(B)
    emit("cells_path", runs=runs, launches=launches,
         prefill_batch=B, attention_at_32k=attn, lru_at_32k=lru, ok=True)
    return launches, attn, lru


def lru_bounds(B, S, D, dtype):
    """Bytes, operations and the least time of one forward and one reverse
    launch over [B, S, D] with no h0. Bytes: the forward reads log_a and b
    and writes h and h_last; the reverse reads log_a, dh, h and dh_last
    (float32) and writes db, dlog_a and dh0; each once. Operations: one exp
    and one FMA an element forward, one exp, one add and two multiplies
    reverse."""
    n, e = B * S * D, torch.finfo(dtype).bits // 8
    bounds = {}
    for name, nbytes, ops in (("forward", e * (3 * n + B * D), 2 * n),
                              ("reverse", e * (5 * n + B * D) + 4 * B * D,
                               4 * n)):
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * ops / FP32_OPS_PER_S
        bounds[name] = dict(bytes=nbytes, ops=ops,
                            bound_ms=max(t_bytes, t_ops),
                            bound_by="bytes" if t_bytes >= t_ops
                            else "operations")
    return bounds


def time_lru():
    """At the main path's shape in float32, as the model runs it: the
    kernel, the plain version and a copy of the forward's bytes
    (`torch.add(log_a, b, out=h)`, a yardstick of the rate the card
    reaches, not a library computing the recurrence), forward and reverse,
    in turns. The kernel alone in bf16 at that shape, and in float32 at
    batch 1 (80 blocks for 132 SMs). And what bounds the same work."""
    _, S, D = LRU_MAIN[:3]
    out = {}
    for name, B, dtype in (("float32", 2, torch.float32),
                           ("bfloat16", 2, torch.bfloat16),
                           ("float32_batch_1", 1, torch.float32)):
        log_a, b, _, dh, dh_last = lru_inputs((B, S, D, False, False),
                                              dtype, dtype, seed=300)
        h, _ = lru_ops.lru_forward(log_a, b, impl="torch")
        plan = lru_kernel.launch_plan(B, S, D, dtype == torch.bfloat16,
                                      False)
        copy_out = torch.empty_like(b)
        fns = {"forward": lambda: lru_ops.lru_forward(log_a, b,
                                                      impl="cuda"),
               "reverse": lambda: lru_ops.lru_reverse(
                   log_a, dh, h, None, dh_last, impl="cuda")}
        order = ["forward", "reverse"]
        if name == "float32":
            fns.update(
                plain_forward=lambda: lru_ops.lru_forward(log_a, b,
                                                          impl="torch"),
                plain_reverse=lambda: lru_ops.lru_reverse(
                    log_a, dh, h, None, dh_last, impl="torch"),
                copy=lambda: torch.add(log_a, b, out=copy_out))
            order += ["plain_forward", "plain_reverse", "copy"]
        order += order[::-1]
        runs = {k: [] for k in fns}
        for fn_name in order:
            runs[fn_name].append(cuda_ms(fns[fn_name], 5 if "plain" in
                                         fn_name else 50))
        bounds = lru_bounds(B, S, D, dtype)
        best = {k: min(v) for k, v in runs.items()}
        out[name] = dict(
            shape=f"B={B} S={S} D={D} {str(dtype)[6:]}, no h0",
            launch_plan=plan._asdict(), ms=best["forward"],
            reverse_ms=best["reverse"],
            plain_ms=best.get("plain_forward"),
            reverse_plain_ms=best.get("plain_reverse"),
            copy_yardstick_ms=best.get("copy"),
            bound_share=bounds["forward"]["bound_ms"] / best["forward"],
            reverse_bound_share=(bounds["reverse"]["bound_ms"]
                                 / best["reverse"]),
            runs_ms=runs, run_order=", ".join(order), bounds=bounds)
        del log_a, b, dh, dh_last, h, copy_out
    return out


def lru_instantiations(log: str) -> list:
    """Registers, spills and shared bytes of each RG-LRU kernel
    instantiation, read from the ptxas lines of its build log."""
    rows, cur = [], None
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            dt, rev = re.search(r"lru_kernelI(f|13__nv_bfloat16)Lb([01])E",
                                entry.group(1)).groups()
            cur = dict(dtype="float32" if dt == "f" else "bfloat16",
                       direction="reverse" if rev == "1" else "forward")
            rows.append(cur)
        elif cur is not None and "spill stores" in ln:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", ln).groups()
            cur.update(spill_store_bytes=int(st), spill_load_bytes=int(ld))
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(smem.group(1)) if smem else 0
    return sorted(rows, key=lambda r: (r["dtype"], r["direction"]))


# --------------------------------------------------------------------------
# multicard_path: the DES lanes and a model cell over the ranks of a group
# --------------------------------------------------------------------------

def multicard_axes(n: int) -> dict:
    """The mesh of `n` cards: the four-card cut of the production mesh,
    data 2 x model 2, at n = 4; 1 x 1 on one card."""
    model = 2 if n % 2 == 0 else 1
    return {"data": n // model, "model": model}


def des_multicard_runs(flows) -> tuple[dict, dict]:
    """The fused paths `multicard_path` splits: both flows' 666-lane fault
    grids (launch/service.py's chaos axis) and the homog cohort study under
    paper_sweep.py's 8-cell fault axis (5 328 lanes), each twice (cold,
    warm). Returns ({name: Metrics}, {name: walls, launches, plan})."""
    K, S = len(sweep.PAPER_SCALE_RATIOS), len(sweep.PAPER_INIT_PROPS)
    grids, runs = {}, {}

    def twice(name, fn, plan, lanes):
        walls, launched = [], []
        for _ in range(2):
            step_ops.packet_event_steps.launches = 0
            out, wall = timed_call(fn)
            walls.append(wall)
            launched.append(step_ops.packet_event_steps.launches)
        runs[name] = dict(lanes=lanes, wall_seconds_cold=walls[0],
                          wall_seconds=walls[1], launches=launched[1],
                          launches_cold=launched[0],
                          n_devices=plan["n_devices"],
                          lane_pad=plan["lane_pad"],
                          lane_axis=plan["n_lanes"])
        return out

    chaos = des.ChaosConfig(**service_launch.SERVICE_CHAOS)
    C = sweep.chaos_axis_len(chaos)
    for flow, dtype in (("homog0.85", np.float32), ("hetero0.85", np.float64)):
        plan = sweep.sweep_plan("auto", K * S, chaos=chaos, dtype=dtype)
        grids[f"fault_grid {flow}"] = twice(
            f"fault_grid {flow}", functools.partial(
                sweep.run_packet_grid, flows[flow], dtype=dtype, chaos=chaos),
            plan, K * S * C)
    cohort = next(c for c in paper_cohorts(flows) if c.dtype == np.float32)
    chaos = des.ChaosConfig(**PAPER_CHAOS)
    C = sweep.chaos_axis_len(chaos)
    plan = sweep.sweep_plan("auto", K * S, cohort.n_workloads, chaos=chaos,
                            dtype=cohort.dtype)
    study = twice(f"cohort_fault_axis {cohort.label}", functools.partial(
        sweep.run_cohort_grid, cohort, chaos=chaos), plan,
        cohort.n_workloads * K * S * C)
    for name, grid in study.items():
        grids[f"cohort_fault_axis {name}"] = grid
    return grids, runs


def _metrics_arrays(grids: dict) -> dict:
    return {f"{name}|{f_}": np.asarray(x) for name, g in grids.items()
            for f_, x in zip(g._fields, g)}


def multicard_one_card_logits(cfg, pol, axes, batch, dev,
                              seq=SHAPES["prefill_32k"].seq, positions=None,
                              witness=None):
    """The one-card references of the mesh run's last-position logits,
    same seed: at B <= 2, PR 24's one-card `--run` path (`build_step` at
    the run's shape, rows 0 and B - 1); at the assigned batch, one-card
    B 1 prefills of rows 0 and B - 1 of the same draw. Returns {row:
    logits [1, Vp]}; with `positions` (B > 2), {row: logits [P, Vp]} at
    those positions, and with `witness` also {"witness": row 0's [P, Vp]
    from a forward whose embedding table is scaled by 1 + witness (the
    unembedding keeps the table)}."""
    shape = dataclasses.replace(SHAPES["prefill_32k"], batch=batch, seq=seq)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = sorted({0, batch - 1})
    if batch <= 2:
        step = dryrun.build_step(cfg, pol, shape, dev, gen)
        logits = step.fn()[:, -1]
        del step
        return {r: logits[r:r + 1].float().cpu() for r in rows}
    fam = get_family(cfg)
    params = fam.init_params(cfg, pol, gen)
    inputs = dryrun.random_inputs(cfg, shape, gen, dev)
    embeds = inputs.get("embeds")
    runs = [(r, r, params) for r in rows]
    if witness is not None:
        runs.append(("witness", 0, dict(params, embed=params["embed"]
                                        * (1 + witness))))
    out = {}
    with torch.no_grad():
        for key, r, p in runs:
            hidden, _ = fam.forward(
                cfg, pol, p, inputs["tokens"][r:r + 1],
                None if embeds is None else embeds[r:r + 1])
            at = hidden[:, -1:] if positions is None else \
                hidden[:, list(positions)]
            logits = unembed(cfg, pol, at, params["embed"]).float().cpu()
            out[key] = logits[:, -1] if positions is None else logits[0]
            del hidden
    del params, inputs, embeds, runs
    return out


def multicard_record(arch: str, axes: dict, batch, layers, seq=None,
                     shape_name: str = "prefill_32k",
                     strategy: str = "auto") -> dict:
    """A cell's dry-run record on the mesh of `axes` (its depth cut to
    `layers` where given, a train cell's strategy `strategy`), with its
    per-card estimate at the cell's batch and length (at `batch` and `seq`
    where given): the meta work of `dryrun --mesh`, done in a worker off
    the card."""
    rec = dryrun.lower_cell(arch, shape_name, axes=axes, layers=layers,
                            strategy=strategy)
    cfg, shape, _, pol = dryrun.resolved_cell(arch, shape_name, axes=axes,
                                              layers=layers,
                                              strategy=strategy)
    if batch is not None:
        shape = dataclasses.replace(shape, batch=batch)
    if seq is not None:
        shape = dataclasses.replace(shape, seq=seq)
    rec["per_card"] = dryrun.per_card_fit(cfg, pol, shape, axes)
    return rec


def cell_file(outdir: str, arch: str, what: str) -> str:
    return os.path.join(outdir, f"{arch}.{what}")


def start_multicard_records(pool, n: int, archs) -> dict:
    """`multicard_record` of `archs`' cells on the mesh of n cards,
    submitted to `pool` (spawned workers off the card): {arch: future}."""
    axes = multicard_axes(n)
    batch = MULTICARD_ONE_CARD_BATCH if n == 1 else None
    seq = MULTICARD_ONE_CARD_SEQ if n == 1 else None
    cut = MULTICARD_ONE_CARD_LAYERS if n == 1 else {}
    return {a: pool.submit(multicard_record, a, axes, batch, cut.get(a),
                           seq) for a in archs}


def cell_of(outdir: str, arch: str, axes: dict):
    """`dryrun.resolved_cell` of a cell as its records file has it (the
    depth cut where it is)."""
    with open(cell_file(outdir, arch, "records.json")) as f:
        cut = json.load(f)[0].get("cut_layers")
    return dryrun.resolved_cell(arch, "prefill_32k", axes=axes,
                                layers=cut[1] if cut else None)


def mesh_cell_on_ranks(outdir: str, arch: str, out: dict):
    """One prefill_32k cell through `dryrun.main(["--records", ..., "--run",
    "--mesh", ...])` on this group's ranks (rank 0 saves the record and
    the logits), then, on rank 0, its one-card references."""
    import torch.distributed as dist

    from repro_torch.launch import multihost
    rank, n = multihost.process_index(), multihost.device_count()
    dev = torch.device("cuda", torch.cuda.current_device())
    axes = multicard_axes(n)
    argv = ["--records", cell_file(outdir, arch, "records.json"), "--run",
            "--seed", "0",
            "--mesh", ",".join(f"{k}={v}" for k, v in axes.items()),
            "--out", cell_file(outdir, arch, "cell.json"),
            "--logits-out", cell_file(outdir, arch, "logits.pt")]
    if n == 1:
        argv += ["--batch", str(MULTICARD_ONE_CARD_BATCH),
                 "--seq", str(MULTICARD_ONE_CARD_SEQ)]
    zero_kernel_counts()
    dryrun.main(argv)
    out["cell_launches"][arch] = kernel_counts()
    free_card()
    dist.barrier()
    if rank == 0:
        cfg, _, _, pol = cell_of(outdir, arch, axes)
        with open(cell_file(outdir, arch, "cell.json")) as f:
            run = json.load(f)[0]["run"]
        t0 = time.perf_counter()
        ref = multicard_one_card_logits(cfg, pol, axes, run["batch"], dev,
                                        seq=run["seq"])
        out["one_card_seconds"][arch] = time.perf_counter() - t0
        torch.save(ref, cell_file(outdir, arch, "one_card_logits.pt"))
        free_card()
    dist.barrier()


def float32_check_on_ranks(outdir: str, arch: str, out: dict):
    """A cell of MULTICARD_FLOAT32_LAYERS in float32, its depth cut to
    that many layers, at MULTICARD_FLOAT32_BATCH x the cell's length,
    through the same mesh runner (`dryrun.mesh_prefill`, seed 0), its
    logits at MULTICARD_FLOAT32_POSITIONS; rank 0 saves them and then its
    one-card B 1 references of rows 0 and B - 1 and the witness."""
    import torch.distributed as dist

    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import policy as policy_lib
    n = multihost.device_count()
    dev = torch.device("cuda", torch.cuda.current_device())
    axes = multicard_axes(n)
    cfg = dryrun.cut_depth(dryrun.cell_config(arch),
                           MULTICARD_FLOAT32_LAYERS[arch]).with_(
        param_dtype="float32", compute_dtype="float32")
    shape = dataclasses.replace(SHAPES["prefill_32k"],
                                batch=MULTICARD_FLOAT32_BATCH)
    pol = policy_lib.resolve(cfg, axes, shape.batch, "prefill",
                             seq=shape.seq)
    mesh = make_mesh(axes)
    t0 = time.perf_counter()
    with dryrun.expandable_segments(dev):
        fn, _, _, _ = dryrun.mesh_prefill(cfg, pol, shape, mesh, 0, dev,
                                       MULTICARD_FLOAT32_POSITIONS)
        logits = fn()
        torch.cuda.synchronize(dev)
        del fn
    out["float32_seconds"] = time.perf_counter() - t0
    if multihost.process_index() == 0:
        torch.save(logits.cpu(), cell_file(outdir, arch, "f32.logits.pt"))
    del logits
    free_card()
    dist.barrier()
    if multihost.process_index() == 0:
        t0 = time.perf_counter()
        ref = multicard_one_card_logits(
            cfg, pol, axes, shape.batch, dev, shape.seq,
            MULTICARD_FLOAT32_POSITIONS, MULTICARD_FLOAT32_WITNESS)
        out["float32_one_card_seconds"] = time.perf_counter() - t0
        torch.save(ref, cell_file(outdir, arch, "f32.one_card_logits.pt"))
        free_card()
    dist.barrier()


def check_float32(arch: str, outdir: str, n: int, wall: float):
    """`float32_check_on_ranks`' logits against its one-card references at
    each of MULTICARD_FLOAT32_POSITIONS, beside the witness's drift there:
    gated at positions up to MULTICARD_FLOAT32_GATED (relative L2 within
    MULTICARD_FLOAT32_TOL, greedy tokens equal or tied), and the witness's
    drift at the last position above MULTICARD_LOGIT_TOL. Emits its line;
    raises CellFailure."""
    cfg = dryrun.cell_config(arch)
    V = cfg.vocab_size
    logits = torch.load(cell_file(outdir, arch, "f32.logits.pt"))
    ref = torch.load(cell_file(outdir, arch, "f32.one_card_logits.pt"))
    witness_ref = ref.pop("witness")
    P = MULTICARD_FLOAT32_POSITIONS
    errs = {r: [relative_l2(logits[r, i], w[i], V) for i in range(len(P))]
            for r, w in ref.items()}
    witness = [relative_l2(witness_ref[i], ref[0][i], V)
               for i in range(len(P))]
    gated = [i for i, p in enumerate(P) if p <= MULTICARD_FLOAT32_GATED]
    greedy, greedy_ok = {}, True
    for r, w in ref.items():
        pairs = [greedy_pair(logits[r, i], w[i], V) for i in gated]
        greedy[r] = [pair for _, pair in pairs]
        greedy_ok = greedy_ok and all(ok_i for ok_i, _ in pairs)
    worst = max(errs[r][i] for r in errs for i in gated)
    ok = (worst <= MULTICARD_FLOAT32_TOL and greedy_ok
          and witness[-1] > MULTICARD_LOGIT_TOL)
    emit("multicard_float32", run=f"{arch}:prefill_32k", ranks=n,
         mesh=multicard_axes(n), dtype="float32",
         layers=[cfg.n_layers, MULTICARD_FLOAT32_LAYERS[arch]],
         batch=MULTICARD_FLOAT32_BATCH, seq=SHAPES["prefill_32k"].seq,
         positions=list(P), gated_positions=[P[i] for i in gated],
         logits_rel_l2_vs_one_card=errs, tol=MULTICARD_FLOAT32_TOL,
         witness_scale=MULTICARD_FLOAT32_WITNESS,
         witness_rel_l2_row0=witness,
         witness_floor_at_last=MULTICARD_LOGIT_TOL,
         greedy_at_gated_vs_one_card=greedy, ranks_wall_seconds=wall,
         ok=ok)
    if not ok:
        raise CellFailure(f"{arch} in float32: relative L2 {errs} at {P} "
                          f"(gated to {MULTICARD_FLOAT32_GATED}), greedy "
                          f"{greedy}, witness {witness}")


def multicard_rank(outdir: str, archs: str = ""):
    """One rank of `multicard_path`, under torchrun: joins the group
    (`multihost.initialize`: this rank's card, NCCL); without `archs`,
    runs the split DES paths (rank 0 saves the grids), then granite's
    cell; with `archs` (comma-separated), those cells
    (`mesh_cell_on_ranks` each). Writes rank<r>.json (rank<r>.<archs>.json
    with `archs`)."""
    import torch.distributed as dist

    from repro_torch.launch import multihost
    facts = multihost.initialize(timeout_s=300)
    rank = facts["process_id"]
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"facts": facts, "card": torch.cuda.get_device_name(dev),
           "cuda_device": dev.index, "cell_launches": {},
           "one_card_seconds": {}, "cell_seconds": {}}
    if not archs:
        flows = paper_workloads(0)
        grids, out["des"] = des_multicard_runs(flows)
        if rank == 0:
            np.savez(os.path.join(outdir, "des.npz"),
                     **_metrics_arrays(grids))
        del grids, flows
        free_card()
        dist.barrier()
    for arch in archs.split(",") if archs else [MULTICARD_CELL.split(":")[0]]:
        if arch.endswith(F32_TAG):
            float32_check_on_ranks(outdir, arch[:-len(F32_TAG)], out)
        elif arch.endswith(DEC_TAG):
            decode_cell_on_ranks(outdir, arch[:-len(DEC_TAG)], out)
        elif TRAIN_TAG in arch:
            train_cell_on_ranks(outdir, *arch.split(TRAIN_TAG), out)
        else:
            mesh_cell_on_ranks(outdir, arch, out)
    name = rank_file(rank, archs)
    with open(os.path.join(outdir, name), "w") as f:
        json.dump(out, f)
    dist.barrier()
    multihost.shutdown()


F32_TAG = "/float32"             # a group running `float32_check_on_ranks`


def rank_file(rank: int, archs: str = "") -> str:
    return (f"rank{rank}.{archs.replace('/', '.')}.json" if archs
            else f"rank{rank}.json")


class CellFailure(Exception):
    """A multicard cell that failed a gate: the phase goes on to the next
    cell and fails at its end."""


def run_multicard_ranks(n: int, outdir: str, archs: str = "",
                        limit: float = MULTICARD_SECONDS) -> str:
    """`multicard_rank` in n processes under torchrun, in a session of its
    own: past `limit` seconds every process of it is killed. Returns what
    the ranks printed; raises CellFailure if they failed or were
    killed."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", os.path.abspath(__file__),
           "--multicard-rank", outdir]
    if archs:
        cmd += ["--multicard-cells", archs]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=limit)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        print(log[-8000:], flush=True)
        raise CellFailure(f"the {n} ranks of {archs or 'the DES and '
                          + MULTICARD_CELL} outlived {limit} s and were "
                          f"killed")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    for ln in log.splitlines():
        if ln.startswith("[dryrun]") or "Error" in ln or "error" in ln:
            print(ln[:2000], flush=True)
    if proc.returncode != 0:
        print(log[-8000:], flush=True)
        raise CellFailure(f"a rank of {archs or MULTICARD_CELL} failed "
                          f"(torchrun exit {proc.returncode})")
    return log


def relative_l2(got: torch.Tensor, want: torch.Tensor, vocab: int) -> float:
    """||got - want|| / ||want|| over the vocabulary's logits (the padded
    entries, masked to -1e30, left out: they would swamp both norms)."""
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    return float((got - want).norm() / want.norm())


def greedy_pair(got, want, vocab: int) -> tuple[bool, list]:
    """The greedy token of logits `got` against that of the reference's
    `want` (each [Vp]): (equal or tied, [got's, want's, the reference's
    margin between the two]). A tie: that margin at most MULTICARD_TIE of
    the reference's top logit (2 bf16 steps)."""
    got, want = got[:vocab].float(), want[:vocab].float()
    g, a = int(got.argmax()), int(want.argmax())
    margin = float(want[a] - want[g])
    return (g == a or margin <= MULTICARD_TIE * abs(float(want[a])),
            [g, a, margin])


def greedy_rows(logits, ref: dict, vocab: int) -> tuple[bool, dict]:
    """`greedy_pair` of the last position of each reference row against
    the one-card reference's: (all equal or tied, {row: pair})."""
    rows, ok = {}, True
    for r, w in ref.items():
        ok_r, rows[r] = greedy_pair(logits[r, -1], w[0], vocab)
        ok = ok and ok_r
    return ok, rows


def check_mesh_cell(arch: str, outdir: str, ranks: list, n: int,
                    wall: float) -> dict:
    """The gates of one prefill_32k cell on the mesh of n cards (see
    `phase_multicard_path`); emits its line. Returns its launches over the
    ranks; raises CellFailure."""
    with open(cell_file(outdir, arch, "cell.json")) as f:
        rec = json.load(f)[0]
    run = rec["run"]
    logits = torch.load(cell_file(outdir, arch, "logits.pt"))
    ref = torch.load(cell_file(outdir, arch, "one_card_logits.pt"))
    axes = multicard_axes(n)
    cfg = cell_of(outdir, arch, axes)[0]
    counts = dryrun.prefill_counts(cfg)
    B = run["batch"]
    if run["output_shape"] != [B, 1, layers.padded_vocab(cfg)] or \
            not run["finite"]:
        raise CellFailure(f"{arch}: logits {run['output_shape']}, finite "
                          f"{run['finite']}")
    kernels = ("flash_attention", "lru_forward")
    for r, rk in enumerate(run["ranks"]):
        one = {k: rk["launches"][k] for k in kernels}
        two = {k: ranks[r]["cell_launches"][arch][k] for k in kernels}
        if one != {k: counts[k] for k in kernels} or \
                two != {k: 2 * counts[k] for k in kernels} or \
                rk["launches"]["lru_reverse"]:
            raise CellFailure(f"{arch}: rank {r} launched {rk['launches']} "
                              f"in one prefill and {two} in two, not "
                              f"{counts} a prefill")
    n_ar = run["collectives"]["op_count"].get("all-reduce", 0)
    ar_bytes = run["collectives"]["op_bytes"].get("all-reduce", 0)
    act = B // axes["data"] * run["seq"] * cfg.d_model * 2   # bf16 [B/d,S,d]
    if axes["model"] > 1 and (n_ar != counts["all_reduces"]
                              or ar_bytes != n_ar * act):
        raise CellFailure(f"{arch}: {n_ar} all-reduces of {ar_bytes} B, not "
                          f"{counts['all_reduces']} of {act} B")
    errs = {r: relative_l2(logits[r:r + 1, -1], w, cfg.vocab_size)
            for r, w in ref.items()}
    greedy_ok, greedy = greedy_rows(logits, ref, cfg.vocab_size)
    top2 = {r: [float(x) for x in w[0, :cfg.vocab_size].topk(2).values]
            for r, w in ref.items()}
    # a chaotic stack's last logits are not held on a mesh of several
    # cards: it is held in float32 at chosen positions (`check_float32`)
    gated = arch not in MULTICARD_FLOAT32_LAYERS or n == 1
    peaks = [rk["peak_bytes"] for rk in run["ranks"]]
    est = run["peak_bytes_estimate_per_card"]
    line = dict(
        run=f"{arch}:prefill_32k", ranks=n, mesh=axes, batch=B,
        seq=run["seq"], reduced=run.get("reduced"), seconds=run["seconds"],
        seconds_each=run["seconds_each"],
        tokens_per_second=run["tokens_per_second"],
        device_ms_by_rank=[rk.get("device_ms") for rk in run["ranks"]],
        all_reduce_ms_by_rank=[rk.get("all_reduce_ms")
                               for rk in run["ranks"]],
        rest_ms_by_rank=[rk.get("rest_ms") for rk in run["ranks"]],
        redistribution_ms_by_rank=[rk.get("redistribution_ms")
                                   for rk in run["ranks"]],
        span_ms_by_rank=[rk.get("span_ms") for rk in run["ranks"]],
        collectives=run["collectives"],
        all_reduces_expected=(counts["all_reduces"] if axes["model"] > 1
                              else None),
        launches_expected=counts,
        launches_by_rank=[rk["launches"] for rk in run["ranks"]],
        peak_bytes_by_rank=peaks,
        setup_peak_bytes_by_rank=[rk.get("setup_peak_bytes")
                                  for rk in run["ranks"]],
        resident_bytes_by_rank=[rk.get("resident_bytes")
                                for rk in run["ranks"]],
        argument_bytes_by_rank=[rk["argument_bytes"] for rk in run["ranks"]],
        argument_bytes_estimate_per_card=run[
            "argument_bytes_estimate_per_card"],
        peak_bytes_estimate_per_card=est,
        peak_bytes_estimate_per_card_at_full_batch=run.get(
            "peak_bytes_estimate_per_card_at_full_batch", est),
        peak_over_per_card_estimate=max(peaks) / est,
        peak_within_band=(MULTICARD_PEAK_BAND[0] <= max(peaks) / est
                          <= MULTICARD_PEAK_BAND[1]),
        peak_bytes_estimate_one_card=run["peak_bytes_estimate_one_card"],
        cards=[rk["device"] for rk in run["ranks"]],
        cuda_device_by_rank=[rk["cuda_device"] for rk in ranks],
        policy=rec["policy"], logits_rel_l2_vs_one_card=errs,
        logits_tol=MULTICARD_LOGIT_TOL if gated else None,
        logits_gated=gated,
        logits_held_by=None if gated else "multicard_float32",
        greedy_rows_vs_one_card=greedy, one_card_top2=top2,
        one_card_seconds=ranks[0]["one_card_seconds"][arch],
        ranks_wall_seconds=wall)
    if gated and (max(errs.values()) > MULTICARD_LOGIT_TOL
                  or not greedy_ok):
        emit("multicard_path", **line, ok=False)
        raise CellFailure(f"{arch}: last-position logits against one card, "
                          f"relative L2 {errs} (tolerance "
                          f"{MULTICARD_LOGIT_TOL}), greedy {greedy}")
    emit("multicard_path", **line, ok=True)
    return {k: sum(rk["cell_launches"][arch][k] for rk in ranks)
            for k in kernels}


def multicard_des_and_granite(n: int, outdir: str, mine, mine_runs,
                              check_cells) -> int:
    """The DES ranks' group (`multicard_rank` without cells: the split
    grids, then granite's cell), its DES gates against this process's
    one-rank runs `mine` / `mine_runs`, and granite's gates
    (`check_cells`).
    Returns the event-step launches of the ranks."""
    t0 = time.perf_counter()
    try:
        run_multicard_ranks(n, outdir)
    except CellFailure as e:
        fail(f"multicard_path: {e}")
    ranks_seconds = time.perf_counter() - t0
    ranks = []
    for r in range(n):
        with open(os.path.join(outdir, rank_file(r))) as f:
            ranks.append(json.load(f))
    saved = np.load(os.path.join(outdir, "des.npz"))
    want = _metrics_arrays(mine)
    if sorted(saved.files) != sorted(want):
        fail("multicard_path: the ranks saved other grids")
    for key, x in want.items():
        g = saved[key]
        if g.dtype != x.dtype or g.shape != x.shape or not np.array_equal(
                g, x):
            fail(f"multicard_path: {key} split over {n} ranks differs from "
                 f"the one-rank fused grid")
    des_launches = 0
    for name, one in mine_runs.items():
        per_rank = [rk["des"][name] for rk in ranks]
        launched = [p["launches"] for p in per_rank]
        des_launches += sum(launched) + sum(p["launches_cold"]
                                            for p in per_rank)
        if max(launched) != one["launches"] or min(launched) < 1:
            fail(f"multicard_path {name}: launches by rank {launched}, the "
                 f"one-rank run {one['launches']}")
        for p in per_rank:
            if p["n_devices"] != n or p["lane_pad"] != (-p["lane_axis"]) % n:
                fail(f"multicard_path {name}: plan n_devices "
                     f"{p['n_devices']}, lane_pad {p['lane_pad']}")
        emit("multicard_path", run=name, ranks=n, lanes=one["lanes"],
             lane_pad=per_rank[0]["lane_pad"],
             one_rank_wall_seconds=one["wall_seconds"],
             one_rank_wall_seconds_cold=one["wall_seconds_cold"],
             wall_seconds_by_rank=[p["wall_seconds"] for p in per_rank],
             wall_seconds_cold_by_rank=[p["wall_seconds_cold"]
                                        for p in per_rank],
             launches_by_rank=launched, one_rank_launches=one["launches"],
             bitwise_one_rank=True, ok=True)
    check_cells([MULTICARD_CELL.split(":")[0]], ranks, ranks_seconds)
    return des_launches


#: `--only` groups that split multicard_path's cells over calls on four
#: cards, each group within one call: the DES ranks' group with
#: granite-3-2b; the dense and VLM cells; the encoder-decoder and hybrid
#: cells; xlstm-1.3b with its float32 check (its host-bound time loops make
#: it the longest). `--only multicard_path` runs them all in one call
MULTICARD_PATH_GROUPS = {
    "multicard_path_des": ("des",),
    "multicard_path_dense": ("yi-6b", "starcoder2-7b", "phi3-medium-14b",
                             "pixtral-12b"),
    "multicard_path_encdec_hybrid": ("seamless-m4t-large-v2",
                                     "recurrentgemma-2b"),
    "multicard_path_xlstm": ("xlstm-1.3b", "xlstm-1.3b" + F32_TAG)}


def multicard_path_archs(n: int, only=None) -> list:
    """The cells whose records `phase_multicard_path` needs on n cards
    (`only`'s group's, where given): granite-3-2b's with the DES, then the
    prefill cells that run."""
    want = lambda name: only is None or name in only
    cells_run = [a for a in (MULTICARD_ARCHS if n > 1
                             else MULTICARD_ONE_CARD_ARCHS) if want(a)]
    return [MULTICARD_CELL.split(":")[0]] * want("des") + cells_run


def phase_multicard_path(flows, only=None, futures=None):
    """The multi-card path over the N = torch.cuda.device_count() cards:
    ranks under torchrun (`multicard_rank`), each on its own card. First,
    off the card and while the one-rank DES runs below go on, every cell's
    dry-run record with its per-card estimate (`multicard_record`, spawned
    workers, or `futures` from `start_multicard_records` of
    `multicard_path_archs` where the caller submitted them earlier). The
    DES: both flows' 666-lane fault grids and the homog
    cohort study under the 8-cell fault axis through the split fused path,
    held bitwise against this process's one-rank fused runs (`only`, a
    group of MULTICARD_PATH_GROUPS, runs that group's part alone); gates: every
    rank holds the whole grid (rank 0's saved), `sweep_plan` gives
    n_devices N and the pad, one event-step launch a segment (no rank more
    than the one-rank run, the rank with the longest lane exactly as
    many). The model cells, through `dryrun --records ... --run --mesh` on
    the data x model mesh of N cards: granite-3-2b prefill_32k in the DES
    group, then MULTICARD_ARCHS' prefill_32k (each in a group of its own
    under MULTICARD_CELL_SECONDS on four cards, at the batch its per-card
    estimate admits; all in one group on one card), every cell at
    MULTICARD_ONE_CARD_BATCH and the depths of MULTICARD_ONE_CARD_LAYERS
    on one card; gates for each (`check_mesh_cell`):
    finite logits, `dryrun.prefill_counts`' kernel launches a prefill on
    every rank (the attention kernel once an attention layer, the RG-LRU
    forward once a recurrent layer; a wrapper on the card launches its
    kernel or raises, so no plain version ran) and its all-reduces where
    the model axis has 2 cards, each of one rank's [B/data, S, d] bf16
    activations, and the last position's logits of rows 0 and B - 1
    within MULTICARD_LOGIT_TOL (relative L2) of the one-card B 1
    references (`multicard_one_card_logits`), their greedy tokens equal.
    Each rank's peak stands beside the per-card estimate (within
    MULTICARD_PEAK_BAND or not: printed), and the warm prefill's device
    time beside its all-reduces'. A cell that fails does not stop the
    next; the phase fails at the end. On four cards, each cell of
    MULTICARD_FLOAT32_LAYERS is also held in float32 at a cut depth
    (`float32_check_on_ranks`, `check_float32`), in a group of its own.
    Returns the launches of the ranks, for the kernels line."""
    n = torch.cuda.device_count()
    outdir = tempfile.mkdtemp(prefix="multicard_")
    granite = MULTICARD_CELL.split(":")[0]
    want = lambda name: only is None or name in only
    des = want("des")
    f32 = [a + F32_TAG for a in MULTICARD_FLOAT32_LAYERS
           if want(a + F32_TAG)] if n > 1 else []
    archs = multicard_path_archs(n, only)
    cells_run = archs[1:] if des else archs
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max(len(archs), 1),
                             multiprocessing.get_context("spawn"),
                             initializer=_dryrun_worker) as pool:
        if futures is None:
            futures = start_multicard_records(pool, n, archs)
        mine, mine_runs = des_multicard_runs(flows) if des else (None, None)
        records = {a: f.result() for a, f in futures.items()}
    records_seconds = time.perf_counter() - t0
    for arch, rec in records.items():
        with open(cell_file(outdir, arch, "records.json"), "w") as f:
            json.dump([rec], f)
    emit("multicard_records", seconds=records_seconds, mesh=multicard_axes(n),
         cells={a: dict(one_card=r["peak_bytes_estimate"],
                        per_card=r["per_card"]["peak_bytes_estimate_per_card"],
                        batch=r["per_card"]["batch"],
                        batch_that_fits=r["per_card"]["batch_that_fits"],
                        per_card_meta_seconds=sum(
                            e["meta_seconds"]
                            for e in r["per_card"]["estimates"].values()))
                for a, r in records.items()})
    free_card()
    launches = {"packet_event_steps": 0, "flash_attention": 0,
                "lru_forward": 0}
    failures = {}

    def check_cells(archs_run, ranks_of, wall):
        for arch in archs_run:
            try:
                if arch.endswith(F32_TAG):
                    check_float32(arch[:-len(F32_TAG)], outdir, n, wall)
                    continue
                got = check_mesh_cell(arch, outdir, ranks_of, n, wall)
            except CellFailure as e:
                failures[arch] = str(e)
                continue
            for k, v in got.items():
                launches[k] += v

    if des:
        launches["packet_event_steps"] = multicard_des_and_granite(
            n, outdir, mine, mine_runs, check_cells)
    groups = ([tuple(cells_run)] if n == 1 and cells_run
              else [(a,) for a in cells_run + f32])
    for group in groups:
        tag = ",".join(group)
        t0 = time.perf_counter()
        try:
            run_multicard_ranks(n, outdir, tag, MULTICARD_CUT_SECONDS
                                if n == 1 else MULTICARD_CELL_SECONDS)
        except CellFailure as e:
            for arch in group:
                failures[arch] = str(e)
            continue
        wall = time.perf_counter() - t0
        group_ranks = []
        for r in range(n):
            with open(os.path.join(outdir, rank_file(r, tag))) as f:
                group_ranks.append(json.load(f))
        check_cells(group, group_ranks, wall)
    if failures:
        fail(f"multicard_path: {len(failures)} of {len(archs) + len(f32)} "
             f"cells failed: {failures}")
    return launches


def decode_axes(arch: str, n: int) -> dict:
    """A decode cell's mesh on n cards: MULTICARD_DECODE's on four, 1 x 1
    on one."""
    return MULTICARD_DECODE[arch] if n > 1 else multicard_axes(1)


def decode_cell_on_ranks(outdir: str, arch: str, out: dict):
    """One decode_32k cell through `dryrun.main(["--records", ..., "--run",
    "--mesh", ...])` on this group's ranks: the cache drawn shard by shard,
    RUN_WARM + RUN_STEPS steps; rank 0 saves the record and the logits,
    every rank its parts of the cache's rows 0 and B - 1 (`--rows-out`).
    Then, on rank 0, the one-card B 1 runs of those rows
    (`decode_one_card`)."""
    import torch.distributed as dist

    from repro_torch.launch import multihost
    n = multihost.device_count()
    dev = torch.device("cuda", torch.cuda.current_device())
    axes = decode_axes(arch, n)
    argv = ["--records", cell_file(outdir, arch, "decode.records.json"),
            "--run", "--seed", "0",
            "--mesh", ",".join(f"{k}={v}" for k, v in axes.items()),
            "--out", cell_file(outdir, arch, "decode.cell.json"),
            "--logits-out", cell_file(outdir, arch, "decode.logits.pt"),
            "--rows-out", cell_file(outdir, arch, "decode.rows")]
    if n == 1:
        argv += ["--batch", str(MULTICARD_ONE_CARD_BATCH)]
    zero_kernel_counts()
    t0 = time.perf_counter()
    dryrun.main(argv)
    out["cell_seconds"][arch] = time.perf_counter() - t0
    out["cell_launches"][arch] = kernel_counts()
    free_card()
    dist.barrier()
    if multihost.process_index() == 0:
        with open(cell_file(outdir, arch, "decode.cell.json")) as f:
            rec = json.load(f)[0]
        cfg, shape, _, pol = dryrun.resolved_cell(arch, "decode_32k",
                                                  axes=axes)
        t0 = time.perf_counter()
        ref = decode_one_card(cfg, pol, rec["run"]["batch"], shape.seq, dev)
        out["one_card_seconds"][arch] = time.perf_counter() - t0
        torch.save(ref, cell_file(outdir, arch, "decode.one_card.pt"))
        free_card()
    dist.barrier()


def decode_one_card(cfg, pol, batch: int, seq: int, dev) -> dict:
    """The one-card references of a decode cell's rows 0 and B - 1, same
    seed: the parameters and tokens of the mesh run's draw, each row's
    cache drawn alone (`dryrun.filled_cache(rows=[r])`, bitwise the mesh's
    shards of that row), then the run's RUN_WARM + RUN_STEPS steps at
    position seq - 1 at B 1. Returns {row: {"logits": [Vp] float32,
    "rows": `dryrun.local_rows` of the cache after the steps}}."""
    fam = get_family(cfg)
    shape = dataclasses.replace(SHAPES["decode_32k"], batch=batch, seq=seq)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = fam.init_params(cfg, pol, gen)
    tokens = dryrun.random_inputs(cfg, shape, gen, dev)["tokens"]
    out = {}
    with torch.no_grad():
        for r in sorted({0, batch - 1}):
            cache = dryrun.filled_cache(cfg, pol, batch, seq,
                                        torch.Generator().manual_seed(0),
                                        dev, rows=[r])
            for _ in range(dryrun.RUN_WARM + dryrun.RUN_STEPS):
                logits, _ = fam.decode_step(cfg, pol, params, cache,
                                            tokens[r:r + 1])
            rows = dryrun.local_rows(cache, [0], seq - 1, seq)
            out[r] = {"logits": logits[0, -1].float().cpu(),
                      "rows": {k: [(r, o, t) for _, o, t in v]
                               for k, v in rows.items()}}
            del cache
    del params, tokens
    return out


def cache_rows_l2(outdir: str, arch: str, n: int, ref: dict) -> dict:
    """Each cache tensor's rows 0 and B - 1 after the mesh run's steps,
    the ranks' parts put against the one-card runs' (`decode_one_card`):
    {tensor: relative L2 over the rows}, and the elements held, which
    must cover the one-card rows."""
    diff, norm, held = {}, {}, {}
    for r in range(n):
        parts = torch.load(cell_file(outdir, arch, f"decode.rows.rank{r}"))
        for name, got in parts.items():
            for row, offs, t in got:
                _, at, want = ref[row]["rows"][name][0]
                want = want[(slice(None),) + tuple(
                    slice(o - a, o - a + k)
                    for o, a, k in zip(offs, at, t.shape[1:]))]
                if want.shape != t.shape:
                    raise CellFailure(f"{arch}: cache {name} row {row} part "
                                      f"{list(t.shape)} at {offs} against "
                                      f"{list(want.shape)}")
                diff[name] = diff.get(name, 0.0) + float(
                    (t.float() - want.float()).pow(2).sum())
                norm[name] = norm.get(name, 0.0) + float(
                    want.float().pow(2).sum())
                held[name] = held.get(name, 0) + t.numel()
    need = {name: sum(w.numel() for row in ref for _, _, w in
                      ref[row]["rows"][name]) for name in diff}
    if any(held[k] < need[k] for k in need):
        raise CellFailure(f"{arch}: the ranks held {held} elements of the "
                          f"rows, the one-card rows have {need}")
    return {k: (diff[k] / norm[k]) ** 0.5 if norm[k] else diff[k] ** 0.5
            for k in diff}


def check_decode_cell(arch: str, outdir: str, ranks: list, n: int,
                      wall: float):
    """The gates of one decode_32k cell on its mesh of n cards (see
    `phase_multicard_decode`); emits its line; raises CellFailure."""
    with open(cell_file(outdir, arch, "decode.cell.json")) as f:
        rec = json.load(f)[0]
    run = rec["run"]
    axes = decode_axes(arch, n)
    cfg, _, _, pol = dryrun.resolved_cell(arch, "decode_32k", axes=axes)
    B, V = run["batch"], cfg.vocab_size
    logits = torch.load(cell_file(outdir, arch, "decode.logits.pt"))
    ref = torch.load(cell_file(outdir, arch, "decode.one_card.pt"))
    problems = []
    if run["output_shape"] != [B, 1, layers.padded_vocab(cfg)] or \
            not run["finite"]:
        problems.append(f"logits {run['output_shape']}, finite "
                        f"{run['finite']}")
    errs = {r: relative_l2(logits[r, -1], w["logits"], V)
            for r, w in ref.items()}
    greedy = {r: greedy_pair(logits[r, -1], w["logits"], V)
              for r, w in ref.items()}
    if max(errs.values()) > MULTICARD_LOGIT_TOL or \
            not all(ok for ok, _ in greedy.values()):
        problems.append(f"logits against one card {errs}, greedy {greedy}")
    cache_l2 = cache_rows_l2(outdir, arch, n, ref)
    if max(cache_l2.values()) > MULTICARD_CACHE_TOL:
        problems.append(f"cache rows against one card {cache_l2}")
    launched = [rk["launches"] for rk in run["ranks"]] + [
        rk["cell_launches"][arch] for rk in ranks]
    if any(any(x.values()) for x in launched):
        problems.append(f"kernels launched on the decode path: {launched}")
    if any(str(rk["device"]).startswith("cpu") for rk in run["ranks"]):
        problems.append(f"a rank ran on the CPU: "
                        f"{[rk['device'] for rk in run['ranks']]}")
    got = {k: [run["collectives"]["op_count"][k],
               run["collectives"]["op_bytes"][k]]
           for k in run["collectives"]["op_count"]}
    want = dryrun.decode_counts(cfg, pol, B, axes) if n > 1 else None
    if want is not None and got != want:
        problems.append(f"collectives {got}, decode_counts {want}")
    cache_bytes = run["ranks"][0]["cache_bytes"]
    share = sum(run["collectives"]["op_bytes"].values()) / cache_bytes
    if arch == "xlstm-1.3b" and n > 1 and share >= \
            MULTICARD_DECODE_BYTES_SHARE:
        problems.append(f"collective bytes a step {share:.4f} of the cache "
                        f"shard")
    peaks = [rk["peak_bytes"] for rk in run["ranks"]]
    est = run["peak_bytes_estimate_per_card"]
    in_band = MULTICARD_PEAK_BAND[0] <= max(peaks) / est <= \
        MULTICARD_PEAK_BAND[1]
    if not in_band:
        problems.append(f"peak {max(peaks)} against the per-card estimate "
                        f"{est}")
    emit("multicard_decode", run=f"{arch}:decode_32k", ranks=n, mesh=axes,
         policy=rec["policy"], batch=B, seq=run["seq"],
         reduced=run.get("reduced"), ms_per_step=run["ms_per_step"],
         ms_per_step_by_rank=[rk.get("device_ms") for rk in run["ranks"]],
         ms_per_step_host=run["ms_per_step_host"],
         first_step_seconds=run["first_step_seconds"],
         tokens_per_second=run["tokens_per_second"],
         steps=run["steps"], warm_steps=run["warm_steps"],
         redistribution_ms_by_rank=[rk.get("redistribution_ms")
                                    for rk in run["ranks"]],
         collective_ms_rank0=sum(ms for _, ms in (run["ranks"][0].get(
             "redistribution_ms") or {}).values()),
         rest_ms_by_rank=[rk.get("rest_ms") for rk in run["ranks"]],
         collectives=run["collectives"], decode_counts=want,
         collective_bytes_over_cache_shard=share,
         cache_bytes_by_rank=[rk["cache_bytes"] for rk in run["ranks"]],
         peak_bytes_by_rank=peaks, peak_bytes_estimate_per_card=est,
         peak_over_per_card_estimate=max(peaks) / est,
         peak_within_band=in_band,
         setup_peak_bytes_by_rank=[rk.get("setup_peak_bytes")
                                   for rk in run["ranks"]],
         argument_bytes_by_rank=[rk["argument_bytes"]
                                 for rk in run["ranks"]],
         argument_bytes_estimate_per_card=run[
             "argument_bytes_estimate_per_card"],
         peak_bytes_estimate_one_card=run["peak_bytes_estimate_one_card"],
         logits_rel_l2_vs_one_card=errs, logits_tol=MULTICARD_LOGIT_TOL,
         greedy_rows_vs_one_card={r: pair for r, (_, pair) in
                                  greedy.items()},
         cache_rows_rel_l2_vs_one_card=cache_l2,
         cache_tol=MULTICARD_CACHE_TOL, launches_by_rank=launched,
         cards=[rk["device"] for rk in run["ranks"]],
         cell_seconds=ranks[0]["cell_seconds"][arch],
         one_card_seconds=ranks[0]["one_card_seconds"][arch],
         ranks_wall_seconds=wall, ok=not problems)
    if problems:
        raise CellFailure(f"{arch} decode: " + "; ".join(problems))


def decode_record_futures(pool, n: int) -> dict:
    """`multicard_record` of each decode_32k cell of MULTICARD_DECODE on
    its mesh of n cards, submitted to `pool` (spawned workers off the
    card): {arch: future}."""
    return {a: pool.submit(
        multicard_record, a, decode_axes(a, n),
        MULTICARD_ONE_CARD_BATCH if n == 1 else None, None, None,
        "decode_32k") for a in MULTICARD_DECODE}


def phase_multicard_decode(futures=None):
    """Sharded decode over the N = torch.cuda.device_count() cards. First,
    off the card, each decode_32k cell's dry-run record on its mesh with
    its per-card estimate (`multicard_record`, spawned workers, or
    `futures` from `decode_record_futures` where the caller submitted them
    earlier; on four cards the largest batch that fits where B 128 does
    not). Then each
    cell through `dryrun --records ... --run --mesh` (`decode_cell_on_
    ranks`): on four cards starcoder2-7b and xlstm-1.3b on data 2 x model
    2 (tp_heads) and phi3-medium-14b on data 1 x model 4 (seq_kv), each in
    a torchrun group of its own under MULTICARD_DECODE_SECONDS; on one
    card all three on a 1 x 1 mesh at MULTICARD_ONE_CARD_BATCH in one
    group. The parameters, tokens and cache come from seed 0, every rank
    drawing only its shard of the cache. Gates (`check_decode_cell`):
    finite logits of the shape; the logits of rows 0 and B - 1 after
    RUN_WARM + RUN_STEPS steps within MULTICARD_LOGIT_TOL of one-card B 1
    runs of the same rows and weights, greedy equal or tied; their cache
    rows within MULTICARD_CACHE_TOL; where the model axis has several
    cards, a step's collectives equal to `dryrun.decode_counts`, and for
    xlstm-1.3b their bytes under MULTICARD_DECODE_BYTES_SHARE of a rank's
    cache shard; each rank's peak within MULTICARD_PEAK_BAND of the
    per-card estimate; no kernel launched (decode attention is an einsum:
    no attention kernel, plain or not). A cell that fails does not stop
    the next; the phase fails at the end."""
    n = torch.cuda.device_count()
    outdir = tempfile.mkdtemp(prefix="multicard_decode_")
    archs = list(MULTICARD_DECODE)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(len(archs), multiprocessing.get_context("spawn"),
                             initializer=_dryrun_worker) as pool:
        if futures is None:
            futures = decode_record_futures(pool, n)
        records = {a: f.result() for a, f in futures.items()}
    for arch, rec in records.items():
        with open(cell_file(outdir, arch, "decode.records.json"), "w") as f:
            json.dump([rec], f)
    emit("multicard_decode_records", seconds=time.perf_counter() - t0,
         cells={a: dict(mesh=decode_axes(a, n),
                        decode_attn=r["policy"]["decode_attn"],
                        one_card=r["peak_bytes_estimate"],
                        per_card=r["per_card"]["peak_bytes_estimate_per_card"],
                        batch=r["per_card"]["batch"],
                        batch_that_fits=r["per_card"]["batch_that_fits"],
                        estimates={b: dict(
                            peak=e["peak_bytes_estimate"],
                            arguments=e["argument_bytes"],
                            cache=e["cache_bytes"],
                            collective_count=e["collective_count"],
                            collective_bytes=e["collective_bytes"])
                            for b, e in r["per_card"]["estimates"].items()})
                for a, r in records.items()})
    free_card()
    failures = {}
    groups = ([tuple(archs)] if n == 1 else [(a,) for a in archs])
    for group in groups:
        tag = ",".join(a + DEC_TAG for a in group)
        t0 = time.perf_counter()
        try:
            run_multicard_ranks(n, outdir, tag, MULTICARD_DECODE_SECONDS)
        except CellFailure as e:
            for arch in group:
                failures[arch] = str(e)
            continue
        wall = time.perf_counter() - t0
        group_ranks = []
        for r in range(n):
            with open(os.path.join(outdir, rank_file(r, tag))) as f:
                group_ranks.append(json.load(f))
        for arch in group:
            try:
                check_decode_cell(arch, outdir, group_ranks, n, wall)
            except CellFailure as e:
                failures[arch] = str(e)
    if failures:
        fail(f"multicard_decode: {len(failures)} of {len(archs)} cells "
             f"failed: {failures}")


def leaf_names(tree, prefix="") -> list:
    """Dotted names of a parameter tree's leaves, in `tree_leaves`
    order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in leaf_names(t, f"{prefix}{i}.")]
    return [prefix[:-1]]


def held_leaves(params, n_layers: int) -> list:
    """Indices (in `tree_leaves` order) of the gradient leaves held
    against one card: the embedding's, the first and the last layer's."""
    first, last = "layers.0.", f"layers.{n_layers - 1}."
    return [i for i, n in enumerate(leaf_names(params))
            if n == "embed" or n.startswith(first) or n.startswith(last)]


def train_key(arch: str, strategy: str) -> str:
    """A train cell's name in the ranks' files and records."""
    return f"{arch}.train-{strategy}"


def one_card_train_shape(arch: str):
    """(batch, length, layers) of a train cell on one card:
    MULTICARD_TRAIN_ONE_CARD, its length MULTICARD_TRAIN_ONE_CARD_SEQ's
    where that has one for the arch."""
    batch, seq, layers = MULTICARD_TRAIN_ONE_CARD
    return batch, MULTICARD_TRAIN_ONE_CARD_SEQ.get(arch, seq), layers


def train_shape(n: int, rec: dict, arch: str):
    """(batch, length, layers) of a train cell's runner on n cards: the
    per-card estimate's batch, the cell's length and every layer on four,
    `one_card_train_shape` on one."""
    if n == 1:
        return one_card_train_shape(arch)
    return (rec["per_card"]["batch_that_fits"], SHAPES["train_4k"].seq,
            get_config(arch).n_layers)


def gate_layers(n: int, arch: str) -> int:
    """The depth of a train cell's gates' pass and its one-card reference:
    the runner's on one card, MULTICARD_TRAIN_GATE_LAYERS' cut (else every
    layer) on four."""
    if n == 1:
        return MULTICARD_TRAIN_ONE_CARD[2]
    return MULTICARD_TRAIN_GATE_LAYERS.get(arch, get_config(arch).n_layers)


def train_cell_on_ranks(outdir: str, arch: str, strategy: str, out: dict):
    """One strategy's train_4k cell on this group's ranks, in three parts.
    (1) `dryrun.main(["--records", ..., "--run", "--mesh", ...,
    "--strategy", ...])`: a cold step and RUN_TRAIN_STEPS timed ones
    (rank 0 saves the record). (2) `launch.train.main(["--mesh", ...])`,
    the user's entry point: MULTICARD_TRAIN_STEPS steps (on one card
    MULTICARD_TRAIN_ONE_CARD_STEPS) on the synthetic
    stream, each rank reading its rows (on one card --reduced for
    MULTICARD_TRAIN_ONE_CARD_REDUCED). (3) The gates' pass at
    `gate_layers`' depth on the same parameters and first batch (seed 0)
    against one card (`gates_pass`); for an MoE model also at float32 on
    MULTICARD_TRAIN_FLOAT32's batch and depth (on one card
    MULTICARD_TRAIN_FLOAT32_ONE_CARD_LAYERS'). The kernel counts are
    zeroed before (1) and read when the mesh part of (3) ends."""
    import torch.distributed as dist

    from repro_torch.launch import multihost

    n = multihost.device_count()
    dev = torch.device("cuda", torch.cuda.current_device())
    axes = multicard_axes(n)
    key = train_key(arch, strategy)
    records = cell_file(outdir, key, "records.json")
    with open(records) as f:
        batch, seq, _ = train_shape(n, json.load(f)[0], arch)
    depth = gate_layers(n, arch)
    mesh_arg = ",".join(f"{k}={v}" for k, v in axes.items())
    argv = ["--records", records, "--run", "--seed", "0", "--mesh",
            mesh_arg, "--strategy", strategy,
            "--out", cell_file(outdir, key, "cell.json")]
    if n == 1:
        argv += ["--batch", str(batch), "--seq", str(seq)]
    zero_kernel_counts()
    t0 = time.perf_counter()
    dryrun.main(argv)
    out["cell_seconds"][key] = time.perf_counter() - t0
    free_card()
    dist.barrier()
    stats = {}
    t0 = time.perf_counter()
    reduced = n == 1 and arch in MULTICARD_TRAIN_ONE_CARD_REDUCED
    steps = MULTICARD_TRAIN_ONE_CARD_STEPS if n == 1 else MULTICARD_TRAIN_STEPS
    with dryrun.expandable_segments(dev):
        train.main(["--arch", arch, "--mesh", mesh_arg, "--strategy",
                    strategy, "--batch", str(batch), "--seq", str(seq),
                    "--steps", str(steps), "--log-every",
                    "1", "--seed", "0"] + (["--reduced"] if reduced else []),
                   stats)
    out.setdefault("train_main", {})[key] = dict(
        stats, seconds=time.perf_counter() - t0, reduced=reduced)
    free_card()
    dist.barrier()
    gates, out["cell_launches"][key] = gates_pass(arch, strategy, axes,
                                                  batch, seq, depth)
    if get_config(arch).n_experts:
        # bf16 rounding moves an MoE layer's routes and drops: its leaves
        # are held in float32 (MULTICARD_TRAIN_FLOAT32)
        f32_batch, f32_layers = MULTICARD_TRAIN_FLOAT32
        if n == 1:
            f32_layers = MULTICARD_TRAIN_FLOAT32_ONE_CARD_LAYERS
        gates["float32"], _ = gates_pass(arch, strategy, axes, f32_batch,
                                         seq, f32_layers, torch.float32)
    out.setdefault("train_gates", {})[key] = gates
    dist.barrier()


def train_gathers(arch: str, strategy: str, n: int, layers: int,
                  batch: int, seq: int) -> dict:
    """The all-gathers a train step of a cell issues on n cards, by what
    they gather: {"weights": (count, operand bytes, group size),
    "router_logits": (...)}. Under tp and dp_zero3 each ZeRO-3 weight (a
    leaf of the parameter tree whose logical axes hold embed_fsdp:
    granite-3-2b's and pixtral-12b's 7 a layer, wq, wk, wv, wo and the
    SwiGLU's wi, wg, wo; qwen2-moe-a2.7b's 10, the attention's four, the
    experts' wi, wg, wo and the shared expert's three) is made whole twice
    a step, in the forward and the remat recompute, from a rank's 1/n
    shard: over "data" under tp, over the n ranks under dp_zero3. Under tp
    an MoE layer's router logits are gathered over "model" twice a layer
    too, from a rank's [batch / data, seq, E / model] float32. None under
    dp_zero1."""
    if strategy not in ("tp", "dp_zero3"):
        return {}
    from repro_torch.device import meta_generator
    from repro_torch.sharding import partitioning

    axes = multicard_axes(n)
    cfg, _, _, pol = dryrun.resolved_cell(arch, "train_4k", axes=axes,
                                          strategy=strategy, layers=layers)
    fam = get_family(cfg)
    fsdp = tree_leaves(partitioning.map_axes(lambda ax: "embed_fsdp" in ax,
                                             fam.param_axes(cfg, pol)))
    weights = [p for f, p in zip(fsdp, tree_leaves(
        fam.init_params(cfg, pol, meta_generator()))) if f]
    out = {"weights": (2 * len(weights), 2 * sum(
        p.numel() * p.element_size() // n for p in weights),
        axes["data"] if strategy == "tp" else n)}
    if cfg.n_experts and strategy == "tp":
        E = pol.expert_pad or cfg.n_experts
        out["router_logits"] = (
            2 * layers, 2 * layers * (batch // axes["data"]) * seq
            * (E // axes["model"]) * 4, axes["model"])
    return out


def gates_pass(arch: str, strategy: str, axes: dict, batch: int, seq: int,
               layers: int, dtype=None) -> tuple:
    """`train_cell_on_ranks`' part (3) at (batch, seq, layers), in the
    config's dtypes or, where given, in `dtype`: the gradients on the
    mesh (seed 0, `make_grad_fn`, reduced to the parameters' placements),
    the held leaves gathered, the AdamW update and its first moment
    against (1 - b1) x the clipped gradient on each rank's shards; an MoE
    model's aux term and the share of its choices dropped (`DropCount` on
    each rank's rows); then, on rank 0, the one-card run of the same
    global batch (the ranks' shards concatenated) in micro-batches of
    MULTICARD_TRAIN_MICRO_ROWS rows (an MoE model's whole: its aux loss is
    not linear in the rows), its peak recorded. Returns (this rank's
    gates, the kernel launches counted when the mesh part ends)."""
    import torch.distributed as dist

    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import optim as optim_lib
    from repro_torch.train.step import make_grad_fn

    rank = multihost.process_index()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg, shape, _, pol = dryrun.resolved_cell(arch, "train_4k", axes=axes,
                                              strategy=strategy, layers=layers)
    if dtype is not None:
        name = str(dtype).removeprefix("torch.")
        cfg = cfg.with_(param_dtype=name, compute_dtype=name)
    shape = dataclasses.replace(shape, batch=batch, seq=seq)
    mesh = make_mesh(axes, "cuda")
    ocfg = AdamWConfig()
    t0 = time.perf_counter()
    with dryrun.expandable_segments(dev):
        gen = torch.Generator(device=dev).manual_seed(0)
        params = dryrun.distribute(get_family(cfg).init_params(cfg, pol, gen),
                                   dryrun.param_specs(cfg, pol, mesh))
        state = state_for(params, ocfg)
        rows = dryrun.mesh_batch(cfg, pol, shape, mesh, 0, dev)
        drops = DropCount("_route_logits")
        moe._route_logits = drops
        try:
            loss, mets, grads = make_grad_fn(cfg, pol, mesh=mesh)(params,
                                                                  rows)
        finally:
            moe._route_logits = drops.fn
        keep = held_leaves(params, cfg.n_layers)
        held = {i: grads[i] for i in keep}
        whole = {i: g.full_tensor().float().cpu() for i, g in held.items()}
        gn = float(global_norm(grads))
        optim_lib.apply(ocfg, state.opt, params, grads, optim_lib.decay_mask(
            params, get_family(cfg).STACKED_KEYS))
        del grads
        scale = min(1.0, ocfg.grad_clip / max(gn, 1e-9))
        moment_err = max(
            float((state.opt.m[i].to_local() - (1 - ocfg.b1) * scale
                   * g.to_local().float()).norm()
                  / state.opt.m[i].to_local().norm().clamp_min(1e-30))
            for i, g in held.items())
        names = leaf_names(params)
        del params, state, rows, held
    launches = kernel_counts()
    free_card()
    gates = {"loss": float(loss), "grad_norm": gn, "layers": cfg.n_layers,
             "moment_rel_l2": moment_err, "seconds": time.perf_counter() - t0}
    if "aux" in mets:
        # an MoE model's aux term (in the loss) and its choices dropped
        gates.update(aux=float(mets["aux"].to_local()),
                     dropped_share=drops.share(), choices=drops.choices)
    dist.barrier()
    if rank == 0:
        t0 = time.perf_counter()
        one = single_device_policy(cfg)
        with dryrun.expandable_segments(dev):
            torch.cuda.reset_peak_memory_stats(dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            params = get_family(cfg).init_params(cfg, one, gen)
            for p in tree_leaves(params):
                p.requires_grad_(True)
            count = dryrun.batch_unit(pol, axes)
            parts = [next(train_data.batches(cfg, train_data.DataConfig(
                batch=batch, seq=seq, seed=0, host_id=i, n_hosts=count)))
                for i in range(count)]
            spec = dryrun.input_specs(cfg, dataclasses.replace(shape, batch=1))
            glob = {k: torch.from_numpy(np.concatenate([p[k] for p in parts]))
                    .to(dev, spec[k].dtype) for k in parts[0]}
            # an MoE model's aux loss is not linear in the rows: its
            # batch whole, as on the mesh
            n_micro = (1 if cfg.n_experts
                       else max(1, batch // MULTICARD_TRAIN_MICRO_ROWS))
            loss1, mets1, g1 = make_grad_fn(cfg, one, n_micro=n_micro)(
                params, glob)
            if "aux" in mets1:
                gates["one_card_aux"] = float(mets1["aux"])
            gates.update(
                one_card_loss=float(loss1),
                one_card_grad_norm=float(global_norm(g1)),
                one_card_micro_batches=n_micro,
                one_card_layers=cfg.n_layers,
                one_card_peak_bytes=torch.cuda.max_memory_allocated(dev),
                leaves_rel_l2={names[i]: float(
                    (whole[i] - g1[i].float().cpu()).norm()
                    / g1[i].float().cpu().norm().clamp_min(1e-30))
                    for i in whole},
                one_card_seconds=time.perf_counter() - t0)
            del params, g1, glob
        free_card()
    dist.barrier()
    return gates, launches


def attention_train_cases(n: int, cells) -> dict:
    """The attention kernel's shapes on the multicard_train path, cut to
    (at most) 2 batch rows a call, by train cell (`train_key`): each
    cell's rank shard of its arch's layer ([rows, S, H / model, hd] under
    tp: granite-3-2b's 32 / 8 heads of hd 64 and pixtral-12b's 32 / 8 of hd
    128 at 16 / 4, qwen2-moe-a2.7b's 16 / 16 of hd 128 at 8 / 8; all the
    heads under dp_zero1 and dp_zero3), S 4 096 on four cards, the
    one-card length on one."""
    axes = multicard_axes(n)
    out = {}
    for arch, strategy in cells:
        cfg = get_config(arch)
        S = (SHAPES["train_4k"].seq if n > 1
             else one_card_train_shape(arch)[1])
        m = axes["model"] if strategy == "tp" else 1
        out[train_key(arch, strategy)] = (
            2, S, S, cfg.n_heads // m, cfg.n_kv_heads // m, cfg.hd, True, 0,
            0.0)
    return out


def zero3_moment_bytes(arch: str, layers: int, n: int) -> int:
    """A rank's AdamW moment bytes under dp_zero3 on n cards, the config at
    `layers` layers: a 1/n shard of every leaf whose logical axes hold
    ``embed_fsdp`` (the block weights), the rest whole; from the meta
    parameter tree."""
    from repro_torch.device import meta_generator
    from repro_torch.sharding import partitioning

    cfg = dryrun.cut_depth(dryrun.cell_config(arch), layers)
    pol = single_device_policy(cfg)
    fam = get_family(cfg)
    fsdp = tree_leaves(partitioning.map_axes(lambda ax: "embed_fsdp" in ax,
                                             fam.param_axes(cfg, pol)))
    params = tree_leaves(fam.init_params(cfg, pol, meta_generator()))
    size = getattr(torch, dryrun._moment_dtype(cfg)).itemsize
    return 2 * size * sum(p.numel() // (n if f else 1)
                          for f, p in zip(fsdp, params))


def check_train_cell(arch: str, strategy: str, outdir: str, ranks: list,
                     n: int, wall: float) -> dict:
    """The gates of one train cell (see `phase_multicard_train`); emits its
    line. Returns the attention kernel's launches over the ranks; raises
    CellFailure."""
    key = train_key(arch, strategy)
    with open(cell_file(outdir, key, "cell.json")) as f:
        rec = json.load(f)[0]
    run = rec["run"]
    axes = multicard_axes(n)
    cfg = get_config(arch)
    L = train_shape(n, rec, arch)[2]
    problems = []
    if not run["finite"] or not all(np.isfinite(run["losses"])):
        problems.append(f"losses {run['losses']}")
    # AdamW on one batch: the loss falls over the runner's steps
    if not run["losses"][-1] < run["losses"][0]:
        problems.append(f"the loss does not fall over the steps on one "
                        f"batch: {run['losses']}")
    # the forward and the remat recompute launch the kernel once a layer
    want = {"flash_attention": 2 * L * dryrun.RUN_TRAIN_STEPS,
            "lru_forward": 0, "lru_reverse": 0}
    for r, rk in enumerate(run["ranks"]):
        if rk["launches"] != want:
            problems.append(f"rank {r} launched {rk['launches']} in "
                            f"{dryrun.RUN_TRAIN_STEPS} steps, not {want}")
    est = rec["per_card"]["estimates"][str(run["batch"])]
    got_ops = {k: int(v) for k, v in run["collectives"]["op_count"].items()}
    meta_ops = {k: int(v) for k, v in est["collective_count"].items()}
    if n > 1 and got_ops != meta_ops:
        problems.append(f"collectives {got_ops}, the meta step's {meta_ops}")
    # under tp and dp_zero3 every all-gather is a ZeRO-3 weight made whole
    # (over "data" under tp, a group of 2; over "data" and "model" together
    # under dp_zero3, a group of 4), twice a weight a layer (forward,
    # recompute): a rank's shard each, or under tp an MoE layer's router
    # logits over "model", twice a layer; none under dp_zero1
    want_gathers = train_gathers(arch, strategy, n, L, run["batch"],
                                 run["seq"])
    gathers = (sum(c for c, _, _ in want_gathers.values()),
               sum(b for _, b, _ in want_gathers.values()))
    got_gathers = (got_ops.get("all-gather", 0),
                   int(run["collectives"]["op_bytes"].get("all-gather", 0)))
    if n > 1 and got_gathers != gathers:
        problems.append(f"all-gathers {got_gathers} (count, bytes), the "
                        f"weights' and router logits' {gathers}")
    by_group = run["collectives"]["by_group"]
    if n > 1 and want_gathers:
        want_groups = {}
        for count, _, group in want_gathers.values():
            key_g = f"all-gather/{group}"
            want_groups[key_g] = want_groups.get(key_g, 0) + count
        if strategy == "dp_zero3":
            # each weight's gradient reduce-scattered back onto its shard
            # by one collective over the four ranks, once a step
            want_groups[f"reduce-scatter/{n}"] = \
                want_gathers["weights"][0] // 2
        got_groups = {k: v for k, v in by_group.items()
                      if k.split("/")[0] in {w.split("/")[0]
                                             for w in want_groups}}
        if got_groups != want_groups:
            problems.append(f"collectives by group {got_groups}, the "
                            f"weights' {want_groups}")
    peaks = [rk["peak_bytes"] for rk in run["ranks"]]
    peak_ratio = max(peaks) / run["peak_bytes_estimate_per_card"]
    if not MULTICARD_PEAK_BAND[0] <= peak_ratio <= MULTICARD_PEAK_BAND[1]:
        problems.append(f"peak {max(peaks)}: {peak_ratio} of the per-card "
                        f"estimate, outside {MULTICARD_PEAK_BAND}")
    # each rank's moments: a 1/n shard of every ZeRO-3 block weight's under
    # dp_zero3, the embedding table and the norms whole
    moments = [rk["cache_bytes"] for rk in run["ranks"]]
    if strategy == "dp_zero3":
        want_moments = zero3_moment_bytes(arch, L, n)
        if moments != [want_moments] * n:
            problems.append(f"moment bytes by rank {moments}, "
                            f"{want_moments} each expected")
    gates = ranks[0]["train_gates"][key]
    tm = ranks[0]["train_main"][key]
    for k, tol in MULTICARD_TRAIN_TOL.items():
        rel = abs(gates[k] - gates[f"one_card_{k}"]) / abs(
            gates[f"one_card_{k}"])
        gates[f"{k}_rel_vs_one_card"] = rel
        if rel > tol:
            problems.append(f"{k} {gates[k]} against one card's "
                            f"{gates[f'one_card_{k}']} ({rel} > {tol})")
    worst = max(gates["leaves_rel_l2"].values())
    f32 = gates.get("float32")
    if f32 is None and worst > MULTICARD_LOGIT_TOL:
        problems.append(f"gradient leaves rel L2 up to {worst}")
    if f32 is not None:
        # an MoE model's leaves, held in float32 (MULTICARD_TRAIN_FLOAT32)
        for k in ("loss", "grad_norm"):
            rel = abs(f32[k] - f32[f"one_card_{k}"]) / abs(
                f32[f"one_card_{k}"])
            f32[f"{k}_rel_vs_one_card"] = rel
            if rel > MULTICARD_FLOAT32_TOL:
                problems.append(f"float32 {k} {f32[k]} against one card's "
                                f"{f32[f'one_card_{k}']} ({rel} > "
                                f"{MULTICARD_FLOAT32_TOL})")
        f32_worst = max(f32["leaves_rel_l2"].values())
        if f32_worst > MULTICARD_FLOAT32_TOL:
            problems.append(f"float32 gradient leaves rel L2 up to "
                            f"{f32_worst}")
    moment_errs = [rk["train_gates"][key]["moment_rel_l2"] for rk in ranks]
    if f32 is not None:
        moment_errs += [rk["train_gates"][key]["float32"]["moment_rel_l2"]
                        for rk in ranks]
    if max(moment_errs) > MULTICARD_MOMENT_TOL:
        problems.append(f"first moments {moment_errs}")
    if not all(np.isfinite(tm["losses"])):
        problems.append(f"launch.train's losses {tm['losses']}")
    # the user's entry point computes what the runner's cold step computes
    # where both run the same model (every layer: four cards): the same
    # seed, parameters, first batch and placements
    if n > 1:
        rel = abs(tm["losses"][0] - run["losses"][0]) / abs(run["losses"][0])
        gates["train_main_loss_rel_vs_cold_step"] = rel
        if rel > MULTICARD_TRAIN_SAME_TOL:
            problems.append(f"launch.train's first loss {tm['losses'][0]}, "
                            f"the runner's cold step's {run['losses'][0]} "
                            f"({rel} > {MULTICARD_TRAIN_SAME_TOL})")
    # and what the gates' pass computes where that runs every layer too
    # (granite on four cards), and learns
    same = n > 1 and gates["layers"] == cfg.n_layers
    if same:
        for k, got in (("loss", tm["losses"][0]),
                       ("grad_norm", tm["grad_norms"][0])):
            rel = abs(got - gates[k]) / abs(gates[k])
            gates[f"train_main_{k}_rel"] = rel
            if rel > MULTICARD_TRAIN_SAME_TOL:
                problems.append(f"launch.train's first {k} {got}, the "
                                f"gates' pass's {gates[k]} ({rel} > "
                                f"{MULTICARD_TRAIN_SAME_TOL})")
        if not tm["losses"][-1] < tm["losses"][0]:
            problems.append(f"launch.train's loss does not fall over its "
                            f"steps: {tm['losses']}")
    line = dict(
        run=f"{arch}:train_4k", strategy=strategy, ranks=n, mesh=axes,
        batch=run["batch"], seq=run["seq"], reduced=run.get("reduced"),
        policy=rec["policy"], ms_per_step=run["ms_per_step"],
        ms_per_step_host=run["ms_per_step_host"],
        first_step_seconds=run["first_step_seconds"],
        tokens_per_second=run["tokens_per_second"],
        device_ms_by_rank=[rk.get("device_ms") for rk in run["ranks"]],
        redistribution_ms_by_rank=[rk.get("redistribution_ms")
                                   for rk in run["ranks"]],
        rest_ms_by_rank=[rk.get("rest_ms") for rk in run["ranks"]],
        collectives=run["collectives"], meta_collectives=meta_ops,
        all_gathers_expected=gathers, all_gathers_by_what=want_gathers,
        aux_by_step=run.get("aux"), train_main_aux=tm.get("aux"),
        attention_launches_per_rank_per_step=[
            rk["launches"]["flash_attention"] / dryrun.RUN_TRAIN_STEPS
            for rk in run["ranks"]],
        attention_launches_expected_per_step=2 * L,
        launches_by_rank=[rk["cell_launches"][key] for rk in ranks],
        peak_bytes_by_rank=peaks,
        peak_bytes_estimate_per_card=run["peak_bytes_estimate_per_card"],
        peak_over_per_card_estimate=peak_ratio,
        peak_band=MULTICARD_PEAK_BAND, gate_layers=gates["layers"],
        argument_bytes_by_rank=[rk["argument_bytes"] for rk in run["ranks"]],
        moment_bytes_by_rank=moments, collectives_by_group=by_group,
        argument_bytes_estimate_per_card=run[
            "argument_bytes_estimate_per_card"],
        setup_peak_bytes_by_rank=[rk.get("setup_peak_bytes")
                                  for rk in run["ranks"]],
        peak_bytes_estimate_one_card=run["peak_bytes_estimate_one_card"],
        cell_losses=run["losses"], train_main_losses=tm["losses"],
        train_main_grad_norms=tm["grad_norms"],
        train_main_step_seconds=tm["step_seconds"],
        train_main_shard_by_rank=[rk["train_main"][key]["shard"]
                                  for rk in ranks],
        train_main_gated=same, train_main_reduced=tm.get("reduced"),
        gates=gates,
        moment_rel_l2_by_rank=moment_errs,
        leaves_gated_in="float32" if f32 is not None else "bf16",
        tolerances=dict(MULTICARD_TRAIN_TOL, leaves=MULTICARD_LOGIT_TOL,
                        float32=MULTICARD_FLOAT32_TOL,
                        moment=MULTICARD_MOMENT_TOL,
                        train_main=MULTICARD_TRAIN_SAME_TOL),
        cell_seconds=ranks[0]["cell_seconds"][key],
        cards=[rk["device"] for rk in run["ranks"]], ranks_wall_seconds=wall)
    if problems:
        emit("multicard_train", **line, ok=False)
        raise CellFailure(f"{arch} {strategy}: " + "; ".join(problems))
    emit("multicard_train", **line, ok=True)
    return sum(rk["cell_launches"][key]["flash_attention"] for rk in ranks)


def train_record_futures(pool, n: int, cells) -> dict:
    """`multicard_record` of each train cell of `cells` on the mesh of n
    cards (on one card at `one_card_train_shape`), submitted to `pool`
    (spawned workers off the card): {(arch, strategy): future}."""
    axes = multicard_axes(n)
    futures = {}
    for arch, strategy in cells:
        batch, seq, depth = (one_card_train_shape(arch) if n == 1
                             else (None, None, None))
        futures[arch, strategy] = pool.submit(
            multicard_record, arch, axes, batch, depth, seq, "train_4k",
            strategy)
    return futures


def phase_multicard_train(only=None, futures=None):
    """The train step on a mesh over the N = torch.cuda.device_count()
    cards: the train_4k cells of MULTICARD_TRAIN_CELLS at full width and
    depth (`only`'s, where given: ``--only multicard_train_<strategy>`` for
    one of granite-3-2b's, ``multicard_train_vlm`` for pixtral-12b's and
    ``multicard_train_moe`` for qwen2-moe-a2.7b's under tp). First, off
    the card, each cell's
    dry-run record on the mesh with its per-card estimate
    (`multicard_record`, spawned workers, or `futures` from
    `train_record_futures` where the caller submitted them earlier: on
    four cards the largest batch,
    a multiple of the batch axes' size, whose estimate fits; on one card
    MULTICARD_TRAIN_ONE_CARD). Then the attention kernel against its plain
    version at each cell's rank shard of the layer
    (`attention_train_cases`), timed beside its bound, and each cell
    through `train_cell_on_ranks`: in a torchrun group of its own under
    MULTICARD_TRAIN_SECONDS on four cards, all in one group on one card.
    Gates (`check_train_cell`): finite losses; the attention kernel twice a
    layer a step on every rank (forward and remat recompute; its gradient
    is plain, R5) and no RG-LRU launch; each rank's peak within
    MULTICARD_PEAK_BAND of the per-card estimate; on several cards the
    cold step's
    collectives equal to the meta step's, and under tp and dp_zero3
    exactly the all-gathers `train_gathers` counts from the arch's
    parameter tree (2 x 7 a layer for granite and pixtral, 2 x 10 for
    qwen2-moe, each a rank's shard of a ZeRO-3 weight: no batch gathered;
    over "data", a group of 2, under tp, over the four ranks under
    dp_zero3, where each weight's gradient is also one reduce-scatter over
    the four, 7 a layer; beside them under tp qwen2-moe's router logits
    over "model", 2 x 1 a layer) and
    under dp_zero3 each rank's moment bytes a quarter of the block
    weights' moments and the rest whole (`zero3_moment_bytes`); the gates'
    pass (at `gate_layers`' depth: every layer but where
    MULTICARD_TRAIN_GATE_LAYERS cuts it) against the one-card run of the
    same global batch at that depth: the first
    step's loss and gradient norm within MULTICARD_TRAIN_TOL, the
    embedding's and the first and last layers' gradient leaves
    within MULTICARD_LOGIT_TOL (relative L2), the first moment within
    MULTICARD_MOMENT_TOL of (1 - b1) x the clipped gradient; the loss
    falls over the runner's 1 + RUN_TRAIN_STEPS steps on its one batch;
    `launch.train.main`'s MULTICARD_TRAIN_STEPS (one card:
    MULTICARD_TRAIN_ONE_CARD_STEPS) losses on the stream are
    finite. On four cards `launch.train` and the runner run the same model
    (every layer), so its first loss is the runner's cold step's within
    MULTICARD_TRAIN_SAME_TOL (the same seed, parameters, first batch and
    placements); where the gates' pass runs every layer too (granite), its
    first step's loss and gradient norm are also the pass's within that
    tolerance, and its loss falls from its first step to its
    last (a batch of 72-80 x 4 096 tokens averages away the batch-to-batch
    wander seen on one card below; on four H100s it fell 0.067 under tp
    and 0.075 under dp_zero1 over four steps). On one card `launch.train`,
    which takes no depth, runs every layer beside the pass's cut (pixtral
    its reduced config), so its
    first step is another model's; there its losses are only held finite,
    and not to fall: on fresh batches of B 2 x 1 024 a random model's loss
    over four warm-up steps wanders (11.2106, 11.2026, 11.2345, 11.2114).
    The first AdamW update
    is not held: at step 1 it is about lr x sign(g), and a near-zero
    gradient's sign flips with bf16 order noise between two runs equally
    right. A cell that fails does not stop the next; the
    phase fails at the end. On four cards the phase also writes, off the
    card in the same workers while the groups run, per-card records on
    data 2 x model 2 (the estimate at B 256 and the largest batch that
    fits; not run): with granite's dp_zero3 cell, those of
    MULTICARD_TRAIN_ZERO3_RECORDS' train_4k cells under dp_zero3
    (`multicard_train_zero3_records`); with pixtral's cell, those of its
    train_4k cell under MULTICARD_TRAIN_RECORDS_ONLY's strategies
    (`multicard_train_records_only`). Returns, for the kernels line, the
    attention kernel's launches over the ranks and its check and times at
    each cell's shard, by cell (`train_key`)."""
    n = torch.cuda.device_count()
    cells = tuple(only or MULTICARD_TRAIN_CELLS)
    outdir = tempfile.mkdtemp(prefix="multicard_train_")
    axes = multicard_axes(n)
    archs = {a for a, _ in cells}
    extra = []
    if n > 1:
        if (MULTICARD_TRAIN_ARCH, "dp_zero3") in cells:
            extra += [(a, "dp_zero3") for a in MULTICARD_TRAIN_ZERO3_RECORDS]
        extra += [(a, s) for a, ss in MULTICARD_TRAIN_RECORDS_ONLY.items()
                  if a in archs for s in ss]
    t0 = time.perf_counter()
    # the cells' records first (the groups wait for them), then the others
    # while the groups run
    with ProcessPoolExecutor(min(6, len(cells) + len(extra)),
                             multiprocessing.get_context("spawn"),
                             initializer=_dryrun_worker) as pool:
        if futures is None:
            futures = train_record_futures(pool, n, cells)
        others = {c: pool.submit(multicard_record, c[0], dict(FOUR_CARD),
                                 None, None, None, "train_4k", c[1])
                  for c in extra}
        failures, launches, attn = run_train_groups(axes, n, outdir, cells,
                                                    futures)
        t1 = time.perf_counter()
        others = {c: f.result() for c, f in others.items()}
    zero3 = {a: r for (a, _), r in others.items()
             if a in MULTICARD_TRAIN_ZERO3_RECORDS}
    if zero3:
        emit("multicard_train_zero3_records", mesh=dict(FOUR_CARD),
             seconds=time.perf_counter() - t0,
             seconds_after_groups=time.perf_counter() - t1,
             cells={a: records_summary(r) for a, r in zero3.items()})
    for arch in MULTICARD_TRAIN_RECORDS_ONLY:
        recs = {s: r for (a, s), r in others.items() if a == arch}
        if recs:
            emit("multicard_train_records_only", arch=arch,
                 mesh=dict(FOUR_CARD), seconds=time.perf_counter() - t0,
                 seconds_after_groups=time.perf_counter() - t1,
                 batch_that_fits={s: r["per_card"]["batch_that_fits"]
                                  for s, r in recs.items()},
                 strategies={s: records_summary(r) for s, r in recs.items()})
    if failures:
        fail(f"multicard_train: {len(failures)} of {len(cells)} cells "
             f"failed: {failures}")
    return launches, attn


def records_summary(rec: dict) -> dict:
    """What a `multicard_record` of a train cell says, for its line: the
    strategy, the estimates one card and per card, the batch that fits,
    and each batch's estimate built."""
    per_card = rec["per_card"]
    return dict(strategy=rec["policy"]["strategy"],
                batch_axes=rec["policy"]["batch_axes"],
                one_card=rec["peak_bytes_estimate"],
                per_card=per_card["peak_bytes_estimate_per_card"],
                batch=per_card["batch"],
                batch_that_fits=per_card["batch_that_fits"],
                estimates={b: dict(
                    peak=e["peak_bytes_estimate"],
                    arguments=e["argument_bytes"],
                    moments=e["moment_bytes"],
                    collective_count=e["collective_count"],
                    collective_bytes=e["collective_bytes"],
                    meta_seconds=e["meta_seconds"])
                    for b, e in per_card["estimates"].items()})


def run_train_groups(axes: dict, n: int, outdir: str, cells,
                     futures) -> tuple:
    """`phase_multicard_train`'s part on the card: the attention kernel
    against its plain version at each cell's shard while the records
    (`futures`, by cell) are made, then the cells' groups and their gates.
    Returns (failures, launches, the attention kernel's checks and times),
    each by cell (`train_key`)."""
    t0 = time.perf_counter()
    attn = {}
    for key, case in attention_train_cases(n, cells).items():
        q, k, v = attn_inputs(case, torch.bfloat16, seed=7)
        got = attn_ops.flash_attention(q, k, v, impl="cuda", causal=True)
        want = attn_ops.flash_attention(q, k, v, impl="torch", causal=True)
        err, atol = attn_check(got, want, f"multicard_train {key} "
                               f"attention {case}")
        del q, k, v, got, want
        attn[key] = dict(time_attention(case), max_abs_err=err, atol=atol)
    records = {c: f.result() for c, f in futures.items()}
    for c, rec in records.items():
        with open(cell_file(outdir, train_key(*c), "records.json"),
                  "w") as f:
            json.dump([rec], f)
    emit("multicard_train_records", seconds=time.perf_counter() - t0,
         mesh=axes, attention=attn,
         cells={train_key(*c): records_summary(r)
                for c, r in records.items()})
    free_card()
    failures, launches = {}, {}
    groups = ([cells] if n == 1 else [(c,) for c in cells])
    for group in groups:
        tag = ",".join(f"{a}{TRAIN_TAG}{s}" for a, s in group)
        t0 = time.perf_counter()
        try:
            run_multicard_ranks(n, outdir, tag, MULTICARD_TRAIN_SECONDS)
        except CellFailure as e:
            for c in group:
                failures[train_key(*c)] = str(e)
            continue
        wall = time.perf_counter() - t0
        group_ranks = []
        for r in range(n):
            with open(os.path.join(outdir, rank_file(r, tag))) as f:
                group_ranks.append(json.load(f))
        for arch, s in group:
            try:
                launches[train_key(arch, s)] = check_train_cell(
                    arch, s, outdir, group_ranks, n, wall)
            except CellFailure as e:
                failures[train_key(arch, s)] = str(e)
    return failures, launches, attn


def phase_kernels(flows, des_launches, plain_ms, attn_launches, attn_grad,
                  train_launches, select_times, select_launches, attn_build,
                  while_launches, while_times, while_build, lru_build,
                  cohort_times, base_launches, base_times, base_plain_ms,
                  base_build, hybrid_launches, ckpt_launches, lm_launches,
                  cells_out, multicard_launches, train_out):
    cells_launches, cells_attn, cells_lru = cells_out
    train_launches_by, train_attn = train_out
    main = time_kernel(Dispatch(flows["homog0.85"], np.float32, False))
    others = [time_kernel(Dispatch(flows["hetero0.85"], np.float64, False)),
              time_kernel(Dispatch(flows["homog0.85"], np.float32, True))]
    line = {"kernels": [{
        "name": "packet_event_steps",
        "route": "cuda",
        "source": "src/repro_torch/csrc/packet_step.cu",
        "replaces": "src/repro/kernels/packet_step/kernel.py:41",
        "launches": sum(des_launches.values()),
        "launches_by_path": dict(
            des_launches,
            multicard_path=multicard_launches["packet_event_steps"]),
        "max_abs_err": Worst.abs_err,
        "max_ulp": Worst.ulp,
        "ms": main["ms"],
        "plain_ms": plain_ms,
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "unit": f"one launch = {SEG} events for every lane, averaged over "
                f"a whole fused dispatch; {main['shape']}",
        "plan": main["plan"],
        "ns_per_lane_step": main["ns_per_lane_step"],
        "ns_per_event": main["ns_per_event"],
        "bound_rates": {"bytes_per_s": HBM_BYTES_PER_S,
                        "ops_per_s": FP32_OPS_PER_S},
        "main_shape": main,
        "other_shapes": others,
        "cohort_shapes": cohort_times,
    }]}
    attn = time_attention(GRANITE_CASE)
    by_path = {"serve_path": attn_launches,
               "train_path": train_launches["flash_attention"],
               "hybrid_serve_path": hybrid_launches["flash_attention"],
               "ckpt_path": ckpt_launches["flash_attention"],
               "cells_path": cells_launches["flash_attention"],
               "multicard_path": multicard_launches["flash_attention"],
               "multicard_train": sum(train_launches_by.values())}
    by_path.update(lm_launches)
    layer_times = {}
    for name, case, path in (
            (VLM_ARCH, LAYER_CASES[VLM_ARCH], "vlm_serve_path"),
            (MOE_ARCH, LAYER_CASES[MOE_ARCH], "moe_serve_path"),
            (ARCTIC_ARCH, LAYER_CASES[ARCTIC_ARCH], "arctic_serve_path"),
            (ENCDEC_ARCH, LAYER_CASES[ENCDEC_ARCH], "encdec_serve_path"),
            (f"{ENCDEC_ARCH} at {RECUR_PROMPT} frames", ENCDEC_PATH_CASE,
             "encdec_serve_path")):
        layer_times[name] = dict(
            time_attention(case), launches=lm_launches[path], path=path,
            max_abs_err=AttnWorst.cases[case, torch.bfloat16])
    layer_times["recurrentgemma-2b prefill_32k"] = dict(
        cells_attn, launches=cells_launches["flash_attention"],
        path="cells_path")
    for arch, strategy in MULTICARD_TRAIN_CELLS:
        key = train_key(arch, strategy)
        layer_times[f"{arch} train_4k, a {strategy} rank's shard"] = dict(
            train_attn[key], launches=train_launches_by[key],
            path="multicard_train")
    line["kernels"].append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:34",
        "launches": attn_launches,
        "max_abs_err": AttnWorst.abs_err,
        "ms": attn["ms"],
        "plain_ms": attn["plain_ms"],
        "bound_ms": attn["bound_ms"],
        "bound_by": attn["bound_by"],
        "library_ms": attn["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention("
                   "is_causal=<the layer's mask>, enable_gqa=True), timed "
                   "as the yardstick only",
        "unit": f"one launch = one layer's attention; {attn['shape']}",
        "bound_rates": {"bytes_per_s": HBM_BYTES_PER_S,
                        "ops_per_s": BF16_OPS_PER_S},
        "main_shape": attn,
        "launches_by_path": by_path,
        "layers": layer_times,
        "recurrentgemma_layer": attn_grad,
        "build_seconds": attn_build[0],
        "instantiations": attention_instantiations(attn_build[1]),
    })
    lru_all = time_lru()
    lru = lru_all["float32"]
    line["kernels"].append({
        "name": "lru_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:36",
        "launches": train_launches["lru_forward"]
                    + train_launches["lru_reverse"],
        "launches_forward": train_launches["lru_forward"],
        "launches_reverse": train_launches["lru_reverse"],
        "launches_by_path": {
            "train_path": train_launches["lru_forward"]
                          + train_launches["lru_reverse"],
            "hybrid_serve_path": hybrid_launches["lru_forward"],
            "ckpt_path": ckpt_launches["lru_forward"]
                         + ckpt_launches["lru_reverse"],
            "cells_path": cells_launches["lru_forward"]
                          + cells_launches["lru_reverse"],
            "multicard_path": multicard_launches["lru_forward"]},
        "max_abs_err": LruWorst.abs_err,
        "ms": lru["ms"],
        "plain_ms": lru["plain_ms"],
        "bound_ms": lru["bounds"]["forward"]["bound_ms"],
        "bound_by": lru["bounds"]["forward"]["bound_by"],
        "library_ms": None,
        "reverse_ms": lru["reverse_ms"],
        "reverse_plain_ms": lru["reverse_plain_ms"],
        "reverse_bound_ms": lru["bounds"]["reverse"]["bound_ms"],
        "bound_share": lru["bound_share"],
        "reverse_bound_share": lru["reverse_bound_share"],
        "copy_yardstick_ms": lru["copy_yardstick_ms"],
        "launch_plan": lru["launch_plan"],
        "unit": f"one forward launch (ms, plain_ms, bound_ms) and one "
                f"reverse launch (reverse_*) over one recurrent layer; "
                f"{lru['shape']}; copy_yardstick_ms is "
                f"torch.add(log_a, b, out=h), the forward's bytes, a "
                f"yardstick of the card's rate and not a library computing "
                f"the recurrence: no single PyTorch call computes it",
        "bound_rates": {"bytes_per_s": HBM_BYTES_PER_S,
                        "ops_per_s": FP32_OPS_PER_S},
        "main_shape": lru,
        "bfloat16_main_shape": lru_all["bfloat16"],
        "float32_batch_1": lru_all["float32_batch_1"],
        "prefill_32k_layer": dict(cells_lru,
                                  launches=cells_launches["lru_forward"],
                                  path="cells_path"),
        "build_seconds": lru_build[0],
        "instantiations": lru_instantiations(lru_build[1]),
    })
    sel = select_times[0]           # (222, 8) float32: the engine's shape
    line["kernels"].append({
        "name": "packet_select",
        "route": "cuda",
        "source": "src/repro_torch/csrc/packet_select.cu",
        "replaces": "src/repro/kernels/packet_select/kernel.py:24",
        "launches": select_launches,
        "max_abs_err": SelectWorst.abs_err,
        "max_ulp": SelectWorst.ulp,
        "ms": sel["ms"],
        "plain_ms": sel["plain_ms"],
        "bound_ms": sel["bound_ms"],
        "bound_by": sel["bound_by"],
        "library_ms": None,
        "stream_ms": sel["stream_ms"],
        "unit": f"one launch = one group-formation decision for every "
                f"lane; {sel['shape']} (the 222-lane plain while engine, "
                f"impl='torch', of seq_path); ms from a "
                f"CUDA graph of {SELECT_GRAPH_LAUNCHES} launches, "
                f"stream_ms per wrapper call back to back; no single "
                f"PyTorch call computes this decision",
        "bound_rates": {"bytes_per_s": HBM_BYTES_PER_S,
                        "ops_per_s": FP32_OPS_PER_S},
        "main_shape": sel,
        "other_shapes": select_times[1:],
    })
    wt = while_times["homog0.85"]
    line["kernels"].append({
        "name": "packet_while",
        "route": "cuda",
        "source": "src/repro_torch/csrc/packet_while.cu",
        "replaces": "src/repro/kernels/packet_select/kernel.py:24 (the "
                    "decision, inlined) and the while loop of "
                    "src/repro/core/des.py:595",
        "launches": while_launches,
        "max_abs_err": WhileWorst.abs_err,
        "max_ulp": WhileWorst.ulp,
        "ms": wt["ms"],
        "plain_ms": wt["plain_ms"],
        "bound_ms": wt["bound_ms"],
        "bound_by": wt["bound_by"],
        "library_ms": None,
        "ns_per_lane_step": wt["ns_per_lane_step"],
        "unit": f"one launch = one simulate_packet call over the 222 "
                f"lanes of {wt['shape']}, every lane run to its end; ms by "
                f"CUDA events, warm; plain_ms the plain lockstep engine "
                f"(impl='torch') on the flow's first {wt['plain_n_jobs']} "
                f"jobs (the kernel there: kernel_ms_at_plain_n_jobs), host "
                f"clock ended by a synchronize; no single PyTorch call "
                f"computes this loop",
        "bound_rates": {"bytes_per_s": HBM_BYTES_PER_S,
                        "ops_per_s": FP32_OPS_PER_S},
        "main_shape": wt,
        "other_shapes": [while_times["hetero0.85"]],
        "build_seconds": while_build[0],
        "instantiations": while_instantiations(while_build[1]),
    })
    bt = base_times["hetero0.85 backfill"]
    line["kernels"].append({
        "name": "baselines",
        "route": "cuda",
        "source": "src/repro_torch/csrc/baselines.cu",
        "replaces": "src/repro/core/schedulers.py:66 (the while loop of "
                    "simulate_fcfs / simulate_backfill, run by "
                    "run_baselines at src/repro/core/sweep.py:1002; not a "
                    "Pallas kernel)",
        "launches": base_launches,
        "max_abs_err": BaseWorst.abs_err,
        "max_ulp": BaseWorst.ulp,
        "ms": bt["ms"],
        "plain_ms": base_plain_ms["hetero0.85 backfill"],
        "bound_ms": bt["bound_ms"],
        "bound_by": bt["bound_by"],
        "library_ms": None,
        "ns_per_event": bt["ns_per_event"],
        "unit": f"one launch = one policy over the six init proportions "
                f"of a paper flow, every lane to its end; {bt['shape']}; "
                f"ms by CUDA events, warm; plain_ms the plain lockstep "
                f"version (impl='torch') on the flow's first "
                f"{WHILE_CUT_JOBS} jobs, host clock ended by a synchronize; "
                f"no single PyTorch call computes this loop",
        "bound_rates": {"bytes_per_s": HBM_BYTES_PER_S,
                        "ops_per_s": FP32_OPS_PER_S},
        "main_shape": bt,
        "other_shapes": [t for k, t in base_times.items()
                         if k != "hetero0.85 backfill"],
        "plain_ms_shapes": base_plain_ms,
        "build_seconds": base_build[0],
        "instantiations": baseline_instantiations(base_build[1]),
    })
    print(json.dumps(line), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a warm serving run and a warm "
                         "training step (torch.profiler)")
    ap.add_argument("--only", type=str, default="",
                    help="comma-separated phases to run after env and the "
                         f"builds, alone: {', '.join(ONLY_PHASES)}")
    ap.add_argument("--multicard-rank", type=str, default="",
                    help=argparse.SUPPRESS)
    ap.add_argument("--multicard-cells", type=str, default="",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    if args.multicard_rank:
        multicard_rank(args.multicard_rank, args.multicard_cells)
        return
    if args.only:
        return main_only([p for p in args.only.split(",") if p])
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t
        return out

    with ThreadPoolExecutor(4) as pool:
        builds = start_builds(pool)
        timed("env", phase_env)
        timed("build packet_step", phase_build, step_kernel,
              builds[step_kernel])
        flows = timed("workloads", paper_workloads, 0)
        timed("kernel_step", phase_kernel_step, flows)
        plain_ms = timed("kernel_run", phase_kernel_run, flows)
        launches, fused = timed("main_path", phase_main_path, flows)
        timed("main_path_stages", phase_stages, flows)
        timed("build packet_select, wait", phase_build, select_kernel,
              builds[select_kernel])
        select_times = timed("select_kernel", phase_select_kernel)
        while_build = timed("build packet_while, wait", phase_build,
                            while_kernel, builds[while_kernel],
                            while_instantiations)
        timed("while_kernel", phase_while_kernel)
        select_launches, while_launches, while_times = timed(
            "seq_path", phase_seq_path, flows, fused)
        des_launches = {
            "main_path": launches,
            "chaos_grid": timed("chaos_grid", phase_chaos_grid, flows,
                                fused),
            "service_path": timed("service_path", phase_service_path),
            "sim_path": timed("sim_path", phase_sim_path)}
        timed("cluster_path", phase_cluster_path)
        des_launches["cohort_grid"], cohort_times = timed(
            "cohort_grid", phase_cohort_grid, flows)
        base_build = timed("build baselines, wait", phase_build, base_kernel,
                           builds[base_kernel], baseline_instantiations)
        base_launches, base_times, base_plain_ms = timed(
            "baselines", phase_baselines, flows)
        attn_build = timed("build flash_attention, wait", phase_build,
                           attn_kernel, builds[attn_kernel])
        lru_build = timed("build rglru_scan, wait", phase_build, lru_kernel,
                          builds[lru_kernel], lru_instantiations)
    timed("attention_kernel", phase_attention_kernel)
    attn_launches = timed("serve_path", phase_serve_path, args.profile)
    hybrid_launches = timed("hybrid_serve_path", phase_hybrid_serve_path)
    lm_launches = {
        "vlm_serve_path": timed("vlm_serve_path", phase_vlm_serve_path),
        "moe_serve_path": timed("moe_serve_path", phase_moe_serve_path),
        "arctic_serve_path": timed("arctic_serve_path",
                                   phase_arctic_serve_path),
        "xlstm_serve_path": timed("xlstm_serve_path",
                                  phase_xlstm_serve_path)}
    timed("xlstm_gate", phase_xlstm_gate)
    lm_launches["encdec_serve_path"] = timed("encdec_serve_path",
                                             phase_encdec_serve_path)
    timed("moe_layer", phase_moe_layer)
    timed("lm_reduced", phase_lm_reduced)
    timed("lru_kernel", phase_lru_kernel)
    attn_grad = timed("attention_grad", phase_attention_grad)
    train_launches = timed("train_path", phase_train_path)
    timed("train_plain_kernels", phase_train_plain_kernels)
    ckpt_launches = timed("ckpt_path", phase_ckpt_path)
    if args.profile:
        timed("train_profile", profile_training)
    # the multicard phases' records (meta, off the card) are made while
    # cells_path runs, not while the card waits for them
    n = torch.cuda.device_count()
    with ProcessPoolExecutor(MULTICARD_EARLY_RECORD_WORKERS,
                             multiprocessing.get_context("spawn"),
                             initializer=_dryrun_worker) as early:
        path_records = start_multicard_records(early, n,
                                               multicard_path_archs(n))
        decode_records = decode_record_futures(early, n)
        train_records = train_record_futures(early, n, MULTICARD_TRAIN_CELLS)
        cells_out = timed("cells_path", phase_cells_path)
        multicard_launches = timed("multicard_path", phase_multicard_path,
                                   flows, None, path_records)
        timed("multicard_decode", phase_multicard_decode, decode_records)
        train_out = timed("multicard_train", phase_multicard_train, None,
                          train_records)
    timed("kernels", phase_kernels, flows, des_launches, plain_ms,
          attn_launches, attn_grad, train_launches, select_times,
          select_launches, attn_build, while_launches, while_times,
          while_build, lru_build, cohort_times, base_launches, base_times,
          base_plain_ms, base_build, hybrid_launches, ckpt_launches,
          lm_launches, cells_out, multicard_launches, train_out)
    finish(t0, seconds)


def finish(t0, seconds):
    emit("done", total_seconds=time.perf_counter() - t0,
         phase_seconds=seconds)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


#: the phases `--only` runs, each with the workloads it needs
ONLY_PHASES = {"multicard_path": lambda: phase_multicard_path(
    paper_workloads(0)), "multicard_decode": phase_multicard_decode,
    "multicard_train": phase_multicard_train,
    **{f"multicard_train_{s}": functools.partial(
        phase_multicard_train, ((MULTICARD_TRAIN_ARCH, s),))
       for s in MULTICARD_TRAIN_STRATEGIES},
    "multicard_train_vlm": functools.partial(
        phase_multicard_train, ((MULTICARD_TRAIN_VLM_ARCH, "tp"),)),
    "multicard_train_moe": functools.partial(
        phase_multicard_train, ((MULTICARD_TRAIN_MOE_ARCH, "tp"),)),
    **{name: functools.partial(
        lambda only: phase_multicard_path(
            paper_workloads(0) if "des" in only else None, only), group)
       for name, group in MULTICARD_PATH_GROUPS.items()}}


def main_only(phases):
    """`--only`: env, every build (one nvcc a source, together), then the
    named phases in order; no kernels line."""
    unknown = [p for p in phases if p not in ONLY_PHASES]
    if unknown:
        fail(f"--only: unknown phases {unknown}; available: "
             f"{list(ONLY_PHASES)}")
    t0 = time.perf_counter()
    seconds = {}
    with ThreadPoolExecutor(4) as pool:
        builds = start_builds(pool)
        phase_env()
        for mod, fut in builds.items():
            phase_build(mod, fut)
    seconds["env and builds"] = time.perf_counter() - t0
    for name in phases:
        t = time.perf_counter()
        ONLY_PHASES[name]()
        seconds[name] = time.perf_counter() - t
    finish(t0, seconds)


if __name__ == "__main__":
    main()
