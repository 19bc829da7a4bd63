"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

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
- LM training: `repro_torch.launch.train.main` on recurrentgemma-2b at full
  width and depth (26 layers, bf16, random weights from seed 0), 3 AdamW
  steps of 2 x 4096 tokens (RG-LRU kernel forward and reverse in every
  recurrent layer, flash-attention kernel in every attention layer).

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

Float32 matrix products run in full float32: TF32 is switched off for
matmuls and cuDNN before anything runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
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
from repro_torch.launch import serve, sim, train
from repro_torch.launch import service as service_launch
from repro_torch.models import hybrid, layers, lm
from repro_torch.models.layers import unembed
from repro_torch.serve.engine import generate, make_serve_step
from repro_torch.sharding.policy import single_device_policy
from repro_torch.train import data as train_data
from repro_torch.train.optim import AdamWConfig, global_norm, tree_leaves
from repro_torch.train.step import init_state, make_loss_fn, make_train_step
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
PLAIN_RUN_SECONDS = 150.0       # per plain whole-dispatch run, then a prefix
COHORT_CHAOS_PLAIN_SECONDS = 30.0   # the 5 328-lane fault cohort's prefix
SELECT_SHAPES = [(T, H) for T in (1, 222, 4096) for H in (1, 8, 130)]
SELECT_TIMED = [(222, 8, torch.float32), (222, 8, torch.float64),
                (1 << 20, 8, torch.float32)]
SELECT_GRAPH_LAUNCHES = 200     # launches captured in one CUDA graph
SEQ_RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}
SEQ_CELLS = (0, 18, 36)         # smallest, middle and largest k, S = 0.05
PLAIN_TURN_SECONDS = 20.0       # a second plain while-engine run below this
WHILE_CUT_JOBS = 1000           # the cut workload of `while_kernel`
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
BASELINE_WORKSPACE_RING = 10_000    # 24 B a slot in float64: past 227 KB
BASELINE_CAP_ITERS = 2500       # events a lane on the workspace case: a cap


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


def run_check(d: Dispatch, max_seconds: float):
    """The dispatch from its initial state, kernel against plain version,
    segment by segment, until every lane drained or the plain version's
    time passed `max_seconds`. Returns the plain version's ms a segment."""
    a, b = d.initial_state(), d.initial_state()
    la, lb = d.new_logs(d.n_segs * SEG), d.new_logs(d.n_segs * SEG)
    worst, segs, plain_s = 0.0, 0, 0.0
    while segs < d.n_segs and d.any_active(a):
        d.steps(a, SEG, "cuda", la, segs * SEG)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d.steps(b, SEG, "torch", lb, segs * SEG)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        rows = slice(segs * SEG, (segs + 1) * SEG)
        worst = max(worst, compare(
            a, tuple(x[rows] for x in la), b, tuple(x[rows] for x in lb),
            f"kernel_run {d.label()} segment {segs}"))
        segs += 1
        if plain_s > max_seconds:
            break
    whole = not d.any_active(a)
    emit("kernel_run", shape=d.label(), segments=segs,
         steps_compared=segs * SEG, budget=d.budget, whole_dispatch=whole,
         note=("every lane drained" if whole else
               "compared on a prefix of the budget at full width: the "
               "plain version's time limit was reached"),
         n_groups_total=int(a.n_groups.sum()),
         requeues_total=int(a.requeues.sum()),
         plain_seconds=plain_s, max_ulp=worst, ulp_bound=ULP_BOUND, ok=True)
    return 1e3 * plain_s / segs


def phase_kernel_run(flows):
    """A whole dispatch at full width, kernel against plain version, segment
    by segment: homog0.85 float32 chaos off, then on, then hetero0.85
    float64 (ring 500); then the cohorts: M100-N5000-float32 fault-free
    (666 lanes) to its end, M500-N5000-float64 under the 8-cell fault axis
    (5 328 lanes) on a prefix. Returns the plain version's ms per segment
    (homog, chaos off), for the kernels line."""
    plain_ms = None
    for flow, dtype, with_chaos in (("homog0.85", np.float32, False),
                                    ("homog0.85", np.float32, True),
                                    ("hetero0.85", np.float64, False)):
        ms = run_check(Dispatch(flows[flow], dtype, with_chaos),
                       PLAIN_RUN_SECONDS)
        plain_ms = ms if plain_ms is None else plain_ms
    cohorts = {c.label: c for c in paper_cohorts(flows)}
    run_check(CohortDispatch(cohorts["M100-N5000-float32"]),
              PLAIN_RUN_SECONDS)
    run_check(CohortDispatch(cohorts["M500-N5000-float64"],
                             des.ChaosConfig(**PAPER_CHAOS)),
              COHORT_CHAOS_PLAIN_SECONDS)
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
                 plan=sweep.sweep_plan(mode, g.ok.size, dtype),
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


def while_runs(pw, k, s, M, impls, plain_limit=None, **kw):
    """`simulate_packet` through its normal entry point, once per entry of
    `impls` ("cuda": no `impl`, the default on the card; "torch": the plain
    lockstep engine by name), in that order; a second plain run is skipped
    when the first took longer than `plain_limit` seconds. Gates each call
    on its launches: the kernel once and no decision launch; the plain
    version no kernel launch and one decision launch per lockstep
    formation. Returns one dict per run: the DesResult, the final state,
    the counts, the host seconds of the call and of the wrapper."""
    cap = WhileCapture(while_ops.packet_while)
    while_ops.packet_while = cap
    runs = []
    try:
        for impl in impls:
            plain_runs = [r for r in runs if r["impl"] == "torch"]
            if impl == "torch" and plain_runs and plain_limit is not None \
                    and plain_runs[0]["seconds"] > plain_limit:
                continue
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


def cut_workload():
    """homog0.85's generator cut to WHILE_CUT_JOBS jobs over the same share
    of its horizon, so that its jobs keep their sizes."""
    p = WorkloadParams(nodes=100, load=0.85, homogeneous=True, seed=1,
                       daily_amplitude=0.3)
    return generate_workload(dataclasses.replace(
        p, n_jobs=WHILE_CUT_JOBS,
        horizon=p.horizon * WHILE_CUT_JOBS / p.n_jobs))


def phase_while_kernel():
    """The while-loop kernel against its plain version through
    `simulate_packet`, on the paper's 222 (k, s) lanes of a cut workload:
    chaos in float32 and float64 with the lanes' columns in shared memory;
    columns past the shared-memory opt-in (the device-memory
    instantiation) in float32 and in float64 under chaos; and a
    `max_iters` that exhausts some lanes (float64, device memory). With
    the paper's two flows in `seq_path` (float32 and float64, shared
    memory, chaos off) that is seven of the eight instantiations."""
    wl = cut_workload()
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
    point, one launch a call) and the plain lockstep engine (impl="torch",
    one select-kernel launch per lockstep formation) in turns, kernel,
    plain, plain, kernel (the second plain run only where the first took
    under PLAIN_TURN_SECONDS); their final states held against each other
    and the kernel's metrics against the fused grid of `phase_main_path`.
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
        runs = while_runs(d.pw, d.k[0], d.s[0], d.M,
                          ("cuda", "torch", "torch", "cuda"),
                          plain_limit=PLAIN_TURN_SECONDS)
        kernel_runs = [r for r in runs if r["impl"] == "cuda"]
        plain_runs = [r for r in runs if r["impl"] == "torch"]
        kernel_calls += len(kernel_runs)
        formations += sum(r["select_launches"] for r in plain_runs)
        worst = max(compare_while(k_, plain_runs[0], f"seq_path {flow}")
                    for k_ in kernel_runs)
        m = efficiency_metrics(d.pw.submit, kernel_runs[0]["res"], d.M,
                               d.pw.t_last_submit)
        got = Metrics(*(x.cpu().numpy().reshape((K, S)) for x in m))
        rel = check_grid(got, want, SEQ_RTOL[np.dtype(dtype)],
                         f"seq_path {flow}")
        kst, pst = kernel_runs[0]["stats"], plain_runs[0]["stats"]
        t = time_while(kernel_runs[0])
        t.update(shape=f"{flow} N={d.N} M={d.M} ring={d.ring} T={d.T} "
                       f"{np.dtype(dtype).name}",
                 plain_ms=1e3 * min(r["wrapper_seconds"]
                                    for r in plain_runs),
                 simulate_packet_seconds=min(r["seconds"]
                                             for r in kernel_runs),
                 plain_simulate_packet_seconds=min(r["seconds"]
                                                   for r in plain_runs))
        times[flow] = t
        emit("seq_path", run="simulate_packet", flow=flow,
             dtype=str(np.dtype(dtype)), lanes=K * S, n_jobs=wl.n_jobs,
             ring=d.ring, run_order=[r["impl"] for r in runs],
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
             plan=sweep.sweep_plan("auto", K * S, c.dtype,
                                   n_workloads=c.n_workloads),
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
    (lanes in lockstep) on homog0.85 (float32) and hetero0.85 (float64),
    uncut, at the six init proportions, every lane to its end (job times
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
    # the main path's shapes: N = 5000, the six init proportions, the
    # policy dtype's ring; every lane to its end. The last case, a ring of
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
        wl = flows[flow]
        dtype = paper_dtype(wl)
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
    """Largest kernel-vs-plain attention difference seen so far."""
    abs_err = 0.0


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


def phase_serve_path(profile: bool):
    """`launch.serve.main` on full-width granite-3-2b, once; then the same
    parameters and prompts through a prefill with the plain attention, for
    comparison, and with `profile` a profiled warm run."""
    cfg = get_config(SERVE_ARCH)
    n_layers = cfg.n_layers
    capture = Capture(attn_ops.flash_attention, (0, n_layers - 1))
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    layers.flash_attention = capture
    try:
        attn_ops.flash_attention.launches = 0
        t0 = time.perf_counter()
        out = serve.main(serve_argv(), stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = attn_ops.flash_attention.launches
    finally:
        layers.flash_attention = attn_ops.flash_attention
    peak = torch.cuda.max_memory_allocated()

    if out.shape != (SERVE_BATCH, SERVE_NEW):
        fail(f"serve_path: tokens have shape {out.shape}")
    if out.min() < 0 or out.max() >= cfg.vocab_size:
        fail("serve_path: a token lies outside [0, vocab)")
    logits = stats["prefill_logits"][..., :cfg.vocab_size]
    if not bool(torch.isfinite(logits).all()):
        fail("serve_path: the prefill's logits are not finite")
    if launches != n_layers:
        fail(f"serve_path: {launches} flash-attention launches in one "
             f"prefill, expected {n_layers}")
    layer_err = {}
    for idx, ((q, k, v), kw, (got,)) in sorted(capture.kept.items()):
        want = attention_ref(q, k, v, **kw)
        layer_err[f"layer_{idx}"], _ = attn_check(
            got, want, f"serve_path layer {idx}")
    capture.kept.clear()
    new_tokens = SERVE_BATCH * SERVE_NEW
    gen_s = stats["prefill_seconds"] + stats["decode_seconds"]
    emit("serve_path", arch=SERVE_ARCH, n_layers=n_layers,
         d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
         dtype=cfg.param_dtype, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
         max_new=SERVE_NEW, launches=launches,
         captured_layers_max_abs_err=layer_err,
         prefill_seconds=stats["prefill_seconds"],
         decode_seconds=stats["decode_seconds"],
         decode_ms_per_step=1e3 * stats["decode_seconds"] / (SERVE_NEW - 1),
         tokens_per_second=new_tokens / gen_s,
         main_wall_seconds=wall, peak_memory_bytes=peak,
         sample=out[0][:8].tolist(), ok=True)

    # the same parameters and prompts again, through the prefill only (the
    # decode steps run no attention kernel): the plain attention by name
    cfg, pol, params, prompts = serve.setup(SERVE_ARCH, False, SERVE_BATCH,
                                            SERVE_PROMPT, SERVE_SEED, None)
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


def time_attention():
    """Kernel, plain version and SDPA on granite-3-2b's layer at the main
    path's size (bf16, causal), in turns; and what bounds the same work."""
    B, Sq, Skv, H, KV, hd, causal, window, softcap = GRANITE_CASE
    q, k, v = attn_inputs(GRANITE_CASE, torch.bfloat16, seed=100)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kernel = lambda: attn_ops.flash_attention(q, k, v, impl="cuda")
    plain = lambda: attn_ops.flash_attention(q, k, v, impl="torch")
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    runs = {"kernel": [], "plain": [], "library": []}
    for name in ("kernel", "plain", "library", "library", "plain", "kernel"):
        fn = {"kernel": kernel, "plain": plain, "library": library}[name]
        runs[name].append(cuda_ms(fn, 3 if name == "plain" else 20))
    lib_err = float((library().transpose(1, 2).float()
                     - plain().float()).abs().max())
    pairs = Sq * (Sq + 1) // 2           # causal, Sq == Skv: visible pairs
    flops = 4 * B * H * hd * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())   # q, k, v, o
    t_ops = 1e3 * flops / BF16_OPS_PER_S
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return dict(shape=f"B={B} S={Sq} H={H} KV={KV} hd={hd} causal bf16",
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


def phase_kernels(flows, des_launches, plain_ms, attn_launches, attn_grad,
                  train_launches, select_times, select_launches, attn_build,
                  while_launches, while_times, while_build, lru_build,
                  cohort_times, base_launches, base_times, base_plain_ms,
                  base_build):
    main = time_kernel(Dispatch(flows["homog0.85"], np.float32, False))
    others = [time_kernel(Dispatch(flows["hetero0.85"], np.float64, False)),
              time_kernel(Dispatch(flows["homog0.85"], np.float32, True))]
    line = {"kernels": [{
        "name": "packet_event_steps",
        "route": "cuda",
        "source": "src/repro_torch/csrc/packet_step.cu",
        "replaces": "src/repro/kernels/packet_step/kernel.py:41",
        "launches": sum(des_launches.values()),
        "launches_by_path": des_launches,
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
    attn = time_attention()
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
                   "is_causal=True, enable_gqa=True), timed as the "
                   "yardstick only",
        "unit": f"one launch = one layer's attention; {attn['shape']}",
        "bound_rates": {"bytes_per_s": HBM_BYTES_PER_S,
                        "ops_per_s": BF16_OPS_PER_S},
        "main_shape": attn,
        "launches_by_path": {"serve_path": attn_launches,
                             "train_path": train_launches["flash_attention"]},
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
                f"(impl='torch') on the same operands, host clock ended by "
                f"a synchronize; no single PyTorch call computes this loop",
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
                f"version (impl='torch') on the same operands, host clock "
                f"ended by a synchronize; no single PyTorch call computes "
                f"this loop",
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
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
    timed("lru_kernel", phase_lru_kernel)
    attn_grad = timed("attention_grad", phase_attention_grad)
    train_launches = timed("train_path", phase_train_path)
    timed("train_plain_kernels", phase_train_plain_kernels)
    if args.profile:
        timed("train_profile", profile_training)
    timed("kernels", phase_kernels, flows, des_launches, plain_ms,
          attn_launches, attn_grad, train_launches, select_times,
          select_launches, attn_build, while_launches, while_times,
          while_build, lru_build, cohort_times, base_launches, base_times,
          base_plain_ms, base_build)
    emit("done", total_seconds=time.perf_counter() - t0,
         phase_seconds=seconds)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
