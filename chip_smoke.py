"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from the sources in this checkout, holds it against
its plain PyTorch version on the card, drives the port's main path (the
paper's 37 x 6 grid of 5000-job workloads through `run_packet_grid`) and
prints one JSON line per phase. It needs one CUDA device and `nvcc`; with
no device it exits non-zero and prints no result. The last line of its
standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

Tolerance of every kernel-vs-plain comparison: integer columns and group-log
keys equal; float columns at most 2 ulp apart (the build uses -fmad=false
and no fast math, so each operation rounds as PyTorch's elementwise ops do
and the expected difference is 0; 2 ulp leaves room for a libm `log` that
differs in its last bit).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np
import torch

from repro_torch.core import des, sweep
from repro_torch.core.metrics import SCALAR_METRIC_FIELDS, efficiency_metrics
from repro_torch.kernels import build
from repro_torch.kernels.packet_step import kernel as step_kernel
from repro_torch.kernels.packet_step import ops as step_ops
from repro_torch.workload.lublin import (WorkloadParams, generate_workload,
                                         paper_workloads)

ULP_BOUND = 2.0
SEG = des.SCAN_SEG
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
CHAOS = dict(mtbf_chip_hours=50.0, ckpt_period=300.0, straggler_prob=0.05,
             straggler_factor=1.5, straggler_deadline=2.0)
PLAIN_RUN_SECONDS = 150.0       # per plain whole-dispatch run, then a prefix
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "golden_metrics.json")


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

    def __init__(self, wl, dtype, with_chaos: bool, seed: int = 0):
        dev = self.device
        self.wl, self.with_chaos = wl, with_chaos
        self.pw = des.pack_workload(wl, dtype, dev)
        self.tdt = self.pw.submit.dtype
        self.N, self.H = self.pw.n_jobs, self.pw.n_types
        self.M = int(wl.params.nodes)
        self.ring = des.resolve_ring(self.M, self.N)
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


def phase_build():
    t0 = time.perf_counter()
    step_kernel.load()
    secs = time.perf_counter() - t0
    lib = build.library_path(build.CSRC_DIR / f"{step_kernel.SOURCE}.cu")
    log = lib.with_suffix(".log").read_text().splitlines()
    ptxas = [ln.strip() for ln in log if "registers" in ln or "spill" in ln]
    emit("build", seconds=secs, library=lib.name, ptxas=ptxas)


def phase_kernel_step(flows):
    """n_steps = 1 from the initial state and from states taken mid-run,
    all four instantiations, both ring sizes."""
    for flow, dtype in ((("homog0.85"), np.float32), ("homog0.85", np.float64),
                        ("hetero0.85", np.float32), ("hetero0.85", np.float64)):
        for with_chaos in (False, True):
            d = Dispatch(flows[flow], dtype, with_chaos)
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
                worst = max(worst, compare(a, la, b, lb,
                                           f"kernel_step {d.label()} "
                                           f"after {warm} steps"))
                at.append(warm)
            emit("kernel_step", shape=d.label(), states_after_steps=at,
                 max_ulp=worst, ulp_bound=ULP_BOUND, ok=True)


def phase_kernel_run(flows):
    """A whole dispatch at full width, kernel against plain version, segment
    by segment; chaos off, then on. Returns the plain version's ms per
    segment (chaos off), for the kernels line."""
    plain_ms = None
    for with_chaos in (False, True):
        d = Dispatch(flows["homog0.85"], np.float32, with_chaos)
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
            if plain_s > PLAIN_RUN_SECONDS:
                break
        whole = not d.any_active(a)
        if not with_chaos:
            plain_ms = 1e3 * plain_s / segs
        emit("kernel_run", shape=d.label(), segments=segs,
             steps_compared=segs * SEG, budget=d.budget,
             whole_dispatch=whole,
             note=("every lane drained" if whole else
                   "compared on a prefix of the budget at full width: the "
                   "plain version's time limit was reached"),
             n_groups_total=int(a.n_groups.sum()),
             requeues_total=int(a.requeues.sum()),
             plain_seconds=plain_s, max_ulp=worst, ulp_bound=ULP_BOUND,
             ok=True)
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
    all 222 cells, fused and chunked. Returns the launch count."""
    step_ops.packet_event_steps.launches = 0
    ks = sweep.PAPER_SCALE_RATIOS
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
    launches = step_ops.packet_event_steps.launches
    emit("main_path_check", fused_equals_chunked=True,
         golden_max_rel_dev=check_golden(), golden_rtol=1e-9,
         launches=launches, ok=True)
    return launches


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
    tables = (d.H * (d.N + 1) + d.H * d.N + d.N) * fsz + d.N * 4
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
    return dict(shape=d.label(), segments=segs, events=events,
                ms=min(times), ms_runs=times,
                bytes_per_launch=bytes_per_launch,
                ops_per_launch=ops_per_launch,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(flows, launches, plain_ms):
    main = time_kernel(Dispatch(flows["homog0.85"], np.float32, False))
    others = [time_kernel(Dispatch(flows["hetero0.85"], np.float64, False)),
              time_kernel(Dispatch(flows["homog0.85"], np.float32, True))]
    line = {"kernels": [{
        "name": "packet_event_steps",
        "route": "cuda",
        "source": "src/repro_torch/csrc/packet_step.cu",
        "replaces": "src/repro/kernels/packet_step/kernel.py:41",
        "launches": launches,
        "max_abs_err": Worst.abs_err,
        "max_ulp": Worst.ulp,
        "ms": main["ms"],
        "plain_ms": plain_ms,
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "unit": f"one launch = {SEG} events for every lane, averaged over "
                f"a whole fused dispatch; {main['shape']}",
        "bound_rates": {"bytes_per_s": HBM_BYTES_PER_S,
                        "ops_per_s": FP32_OPS_PER_S},
        "main_shape": main,
        "other_shapes": others,
    }]}
    print(json.dumps(line), flush=True)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    t0 = time.perf_counter()
    phase_env()
    phase_build()
    flows = paper_workloads(0)
    phase_kernel_step(flows)
    plain_ms = phase_kernel_run(flows)
    launches = phase_main_path(flows)
    phase_stages(flows)
    phase_kernels(flows, launches, plain_ms)
    emit("done", total_seconds=time.perf_counter() - t0)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
