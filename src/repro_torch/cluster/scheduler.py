"""The paper's technique as a first-class ML-cluster feature.

Mapping (DESIGN.md §2): a *job type* = an (arch x step-shape) pair whose
"initialization" is XLA compilation + checkpoint restore + mesh setup —
type-keyed and amortizable across a group exactly like the paper's s_j. A
*job* = a training/eval task of that type, moldable over its data-parallel
width with ~linear speedup (work measured in chip-seconds). The Packet
algorithm (repro.core.packet — the same policy functions the DES and the
Pallas kernel use) forms per-type meta-jobs and sizes their chip slice by
the scale ratio k: exec_time ~= k x init_time.

On top of the paper's model, the production concerns:
  * failure injection — exponential chip-slice failures; the running group
    loses progress since its last checkpoint and its *remaining* work is
    requeued (checkpoint period bounds the loss),
  * straggler mitigation — group duration is stretched by a straggler
    factor; if it exceeds ``straggler_deadline`` x the expected duration,
    the group is killed at the deadline and the unfinished remainder is
    re-dispatched (re-queued at the front via its original submit time),
  * elastic slices — a requeued remainder may be regrouped and run on a
    different number of chips (the checkpoint layer's elastic re-shard is
    what makes this legal for training jobs).

This event-driven simulator is intentionally host-side Python (rich
semantics, modest event counts); the paper's 1332-experiment grid runs on
the lane-batched DES in repro_torch.core.des.

The counterpart of the reference's `repro/cluster/scheduler.py`. The event
heap, the queues, the random draws (numpy's ``default_rng(cfg.seed)``, in
the reference's order) and the accounting stay on the host in float64, as
there. The two policy calls, `queue_weights` and `m_threshold`, run
through `repro_torch.core.packet` on the simulator's device (``device=None``
means the card) in float32: the reference hands them float64 numpy rows
and Python floats, which JAX with x64 off computes in float32, so the
port's argmax ties and node thresholds round as the reference's do.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import packet as policy
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class JobType:
    name: str                  # e.g. "yi-6b:train_4k"
    init_time: float           # s_j: compile + restore + mesh setup (s)
    tp_degree: int = 1         # chips per model shard (slice granularity)
    priority: float = 1.0
    t_max: float = 3600.0


@dataclasses.dataclass
class MLJob:
    jid: int
    jtype: int                 # index into the type table
    submit: float
    work: float                # chip-seconds on one chip-slice (moldable)
    done_work: float = 0.0     # checkpointed progress
    start: float = math.inf    # first time its group started
    finish: float = math.inf


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    n_chips: int = 1024
    scale_ratio: float = 4.0
    ckpt_period: float = 300.0          # seconds between checkpoints
    mtbf_chip_hours: float = 0.0        # 0 = no failures
    straggler_prob: float = 0.0
    straggler_factor: float = 1.5
    straggler_deadline: float = 2.0     # kill at deadline x expected
    seed: int = 0


def slice_for(m_chips: int, tp_degree: int) -> tuple[int, int]:
    """Moldable slice shape (dp, tp): dp = chips // tp (>= 1 group rule)."""
    dp = max(m_chips // tp_degree, 1)
    return dp, tp_degree


class ClusterSim:
    """Event-driven Packet scheduler over an ML cluster. The policy calls
    run on `device` (None: the card, raises without one)."""

    def __init__(self, types: list[JobType], cfg: ClusterConfig,
                 device=None):
        self.types = types
        self.cfg = cfg
        self.device = resolve_device(device)
        self._s_j = self._f32([t.init_time for t in types])
        self._p_j = self._f32([t.priority for t in types])
        self._tmax = self._f32([t.t_max for t in types])
        self.rng = np.random.default_rng(cfg.seed)
        self.queues: list[list[MLJob]] = [[] for _ in types]
        self.events: list = []           # (time, seq, kind, payload)
        self._seq = 0
        self.t = 0.0
        self.free = cfg.n_chips
        self.jobs: dict[int, MLJob] = {}
        self.groups = 0
        self.busy_cs = 0.0               # busy chip-seconds
        self.useful_cs = 0.0
        self.lost_cs = 0.0               # work lost to failures
        self.requeues = 0
        self.requeued_jobs = 0           # individual members re-queued
        self.failures = 0
        self.straggler_kills = 0

    # ----------------------------------------------------------- events
    def _push(self, t, kind, payload):
        self._seq += 1
        heapq.heappush(self.events, (t, self._seq, kind, payload))

    def submit(self, job: MLJob):
        self.jobs[job.jid] = job
        self._push(job.submit, "submit", job)

    # -------------------------------------------------------- scheduling
    def _f32(self, x) -> torch.Tensor:
        """A float64 host value as a float32 tensor on the device."""
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _weights(self):
        sum_w = np.array([sum(j.work - j.done_work for j in q)
                          for q in self.queues])
        s_j = np.array([t.init_time for t in self.types])
        oldest = np.array([min((j.submit for j in q), default=np.inf)
                           for q in self.queues])
        nonempty = np.array([len(q) > 0 for q in self.queues])
        w = policy.queue_weights(self._f32(sum_w), self._s_j, self._p_j,
                                 self._f32(oldest), self._f32(self.t),
                                 self._tmax,
                                 torch.as_tensor(nonempty,
                                                 device=self.device))
        return w.cpu().numpy(), sum_w, s_j

    def _schedule(self):
        """Paper Steps 1-5, repeatedly until blocked."""
        while self.free > 0 and any(self.queues):
            w, sum_w, s_j = self._weights()
            j = int(np.argmax(w))
            if not np.isfinite(w[j]):
                break
            jt = self.types[j]
            work = float(sum_w[j])
            m_thr = int(policy.m_threshold(self._f32(work),
                                           self._f32(self.cfg.scale_ratio),
                                           self._f32(s_j[j])))
            # slice granularity: groups allocate whole TP slices
            m_thr = max(math.ceil(m_thr / jt.tp_degree) * jt.tp_degree,
                        jt.tp_degree)
            m = min(m_thr, self.free - self.free % jt.tp_degree)
            if m < jt.tp_degree:
                break
            members = self.queues[j]
            self.queues[j] = []
            exp_dur = jt.init_time + work / m
            dur = exp_dur
            stretched = self.rng.random() < self.cfg.straggler_prob
            if stretched:
                dur = jt.init_time + (work / m) * self.cfg.straggler_factor
            deadline = self.cfg.straggler_deadline * exp_dur
            killed = dur > deadline
            end = self.t + min(dur, deadline)
            for job in members:
                job.start = min(job.start, self.t)
            self.free -= m
            self.groups += 1
            self._push(end, "finish", {
                "jtype": j, "m": m, "t0": self.t, "members": members,
                "killed": killed, "dur": min(dur, deadline),
                "stretch": (self.cfg.straggler_factor if stretched else 1.0),
            })

    # ----------------------------------------------------------- failures
    def _maybe_fail(self, grp) -> Optional[float]:
        """Absolute failure time of the group, or None if it survives.

        Drawn lazily when the group's scheduled end is processed: a
        failure is *resolved* at group end — the chips stay held for the
        full duration (restart-in-place semantics), and the failure time
        only decides how much work since the last checkpoint is lost.
        The returned instant is ``t0 + t_fail``, the group start plus an
        exponential draw at the slice's aggregate chip failure rate.
        """
        if self.cfg.mtbf_chip_hours <= 0:
            return None
        rate = grp["m"] / (self.cfg.mtbf_chip_hours * 3600.0)
        t_fail = self.rng.exponential(1.0 / rate) if rate > 0 else np.inf
        return grp["t0"] + t_fail if t_fail < grp["dur"] else None

    # --------------------------------------------------------------- run
    def run(self):
        while self.events:
            t, _, kind, payload = heapq.heappop(self.events)
            self.t = t
            if kind == "submit":
                self.queues[payload.jtype].append(payload)
                self._schedule()
            elif kind == "finish":
                self._finish(payload)
        return self.metrics()

    def _finish(self, grp):
        jt = self.types[grp["jtype"]]
        m, t0 = grp["m"], grp["t0"]
        dur = grp["dur"]
        self.busy_cs += m * dur
        fail_t = self._maybe_fail(grp)
        run_span = dur - jt.init_time
        if fail_t is not None:
            self.failures += 1
            run_done = max(min(fail_t - t0, dur) - jt.init_time, 0.0)
            ckpt_done = math.floor(run_done / self.cfg.ckpt_period) * \
                self.cfg.ckpt_period
            self.lost_cs += (run_done - ckpt_done) * m
            self.useful_cs += ckpt_done * m
            self._requeue(grp, ckpt_done * m / grp["stretch"])
        elif grp["killed"]:
            self.straggler_kills += 1
            run_done = max(dur - jt.init_time, 0.0)
            done_work = run_done * m / grp["stretch"]
            self.useful_cs += run_done * m
            self._requeue(grp, done_work)
        else:
            self.useful_cs += run_span * m
            for job in grp["members"]:
                job.done_work = job.work
                # members of a completing group always carry finish=inf
                # (a job with a finite finish was fully credited earlier
                # and never requeued), so this group's end IS the job's
                # last completion time — including for jobs that failed
                # or were killed in earlier groups and requeued here.
                job.finish = t0 + dur
        self.free += m
        self._schedule()

    def _requeue(self, grp, done_work: float):
        """Credit completed work to members in order; requeue the rest."""
        self.requeues += 1
        remaining = done_work
        for job in grp["members"]:
            need = job.work - job.done_work
            credit = min(need, remaining)
            job.done_work += credit
            remaining -= credit
            if job.work - job.done_work > 1e-9:
                self.queues[job.jtype].append(job)
                self.requeued_jobs += 1
            else:
                job.finish = self.t

    # ----------------------------------------------------------- metrics
    def metrics(self) -> dict:
        jobs = list(self.jobs.values())
        waits = [j.start - j.submit for j in jobs if np.isfinite(j.start)]
        span = max((j.finish for j in jobs if np.isfinite(j.finish)),
                   default=self.t)
        denom = self.cfg.n_chips * max(span, 1e-9)
        return {
            "jobs": len(jobs),
            "unfinished": sum(1 for j in jobs
                              if j.work - j.done_work > 1e-9),
            "groups": self.groups,
            "avg_wait": float(np.mean(waits)) if waits else 0.0,
            "med_wait": float(np.median(waits)) if waits else 0.0,
            "full_util": self.busy_cs / denom,
            "useful_util": self.useful_cs / denom,
            "lost_chip_seconds": self.lost_cs,
            "failures": self.failures,
            "straggler_kills": self.straggler_kills,
            "requeues": self.requeues,
            "requeued_jobs": self.requeued_jobs,
            "makespan": span,
        }


def workload_from_arrival_rate(types: list[JobType], n_jobs: int,
                               horizon: float, mean_work: float,
                               seed: int = 0) -> list[MLJob]:
    """Poisson arrivals, exponential work, zipf-ish type popularity."""
    rng = np.random.default_rng(seed)
    pw = 1.0 / np.arange(1, len(types) + 1)
    pw /= pw.sum()
    jobs = []
    for i in range(n_jobs):
        jobs.append(MLJob(
            jid=i, jtype=int(rng.choice(len(types), p=pw)),
            submit=float(rng.uniform(0, horizon)),
            work=float(rng.exponential(mean_work))))
    jobs.sort(key=lambda j: j.submit)
    return jobs
