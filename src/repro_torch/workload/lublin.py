"""Lublin–Feitelson supercomputer workload generator (numpy only).

Implements the statistical model of Lublin & Feitelson, "The Workload on
Parallel Supercomputers: Modeling the Characteristics of Rigid Jobs",
JPDC 2003 [29 in the paper] — the generator the paper's 6 workflows are
built from:

  * node counts: serial fraction + power-of-two bias + two-stage log-uniform,
  * runtimes: ln(runtime) ~ hyper-gamma, mixture weight linear in log2(nodes),
  * arrivals: heavy-tailed gaps modulated by a daily cycle,

plus the paper's "modified generator" that produces *more homogeneous*
workflows (reduced runtime variance, narrower size range), and load
calibration: runtimes are scaled so the *calculated load*
``rho = sum(e_i * n_i) / (M * horizon)`` hits the requested 0.85 / 0.90 / 0.95.

The paper's experiments: 5000 jobs over 4 days, 8 job types,
M = 500 nodes (heterogeneous flows) or M = 100 (homogeneous flows).

This is the PyTorch port's own copy of `repro.workload.lublin`: the same
numpy generator calls in the same order, so `Workload.golden_digest()`
matches the reference's for every seed (tests/test_torch_workload.py).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Mapping

import numpy as np

DAY = 86400.0

# Lublin's published "batch" model constants.
SERIAL_PROB = 0.244
POW2_PROB = 0.75
ULOW = 0.8          # log2 of smallest parallel size
UPROB = 0.86        # probability of the low range of the two-stage uniform
# ln(runtime) hyper-gamma:
A1, B1 = 4.2, 0.94
A2, B2 = 312.0, 0.03
PA, PB = -0.0054, 0.78
# ln(inter-arrival gap) gamma (daytime model):
AARR, BARR = 10.23, 0.4871


@dataclasses.dataclass(frozen=True)
class WorkloadParams:
    n_jobs: int = 5000
    horizon: float = 4 * DAY          # submit window (last submit ~ horizon)
    n_types: int = 8                  # paper: 8 job types
    nodes: int = 500                  # M: 500 heterogeneous / 100 homogeneous
    load: float = 0.85                # calculated load rho
    homogeneous: bool = False         # paper's "modified generator"
    seed: int = 0
    daily_amplitude: float = 0.6      # arrival-rate daily cycle strength
    homog_shrink: float = 0.25        # ln-runtime variance shrink factor


@dataclasses.dataclass(frozen=True)
class Workload:
    """A generated workflow. All arrays are length n_jobs, sorted by submit."""
    submit: np.ndarray       # submit times, seconds, float64
    runtime: np.ndarray      # e_i: runtime on n_i nodes, seconds
    nodes: np.ndarray        # n_i: rigid requested node count
    work: np.ndarray         # w_i = e_i * n_i (single-node duration, node-s)
    jtype: np.ndarray        # tau_i in [0, n_types)
    params: WorkloadParams

    @property
    def n_jobs(self) -> int:
        return int(self.submit.shape[0])

    @property
    def horizon(self) -> float:
        return float(self.submit[-1])

    def calculated_load(self) -> float:
        return float(self.work.sum() / (self.params.nodes * self.params.horizon))

    def init_time_for_proportion(self, s_prop: float) -> float:
        """Constant per-job initialization time s giving average init
        proportion S = n*s / (n*s + sum(e_i))  =>  s = S/(1-S) * mean(e)."""
        if not (0.0 <= s_prop < 1.0):
            raise ValueError(f"init proportion must be in [0,1), got {s_prop}")
        return float(s_prop / (1.0 - s_prop) * self.runtime.mean())

    def golden_digest(self) -> dict[str, str]:
        """Stable per-array content digests for regression pinning.

        Returns sha256 hex digests of `submit`/`runtime`/`nodes`/`jtype`,
        floats rounded to 1e-6 s before hashing so bit-identical generator
        output is required only up to libm rounding. Workload drift (an
        accidental generator change) then breaks the determinism suite
        instead of masquerading as a simulator regression downstream.
        """
        def h(a, decimals=None):
            a = np.ascontiguousarray(
                np.asarray(a, np.float64).round(decimals) if decimals is not None
                else np.asarray(a, np.int64))
            return hashlib.sha256(a.tobytes()).hexdigest()

        return {"submit": h(self.submit, 6), "runtime": h(self.runtime, 6),
                "nodes": h(self.nodes), "jtype": h(self.jtype)}


def _hyper_gamma_ln_runtime(rng: np.random.Generator, log2n: np.ndarray) -> np.ndarray:
    """ln(runtime) ~ p*Gamma(a1,b1) + (1-p)*Gamma(a2,b2), p linear in log2(n)."""
    p = np.clip(PA * log2n + PB, 0.01, 0.99)
    pick1 = rng.random(log2n.shape) < p
    g1 = rng.gamma(A1, B1, size=log2n.shape)
    g2 = rng.gamma(A2, B2, size=log2n.shape)
    return np.where(pick1, g1, g2)


def _node_counts(rng: np.random.Generator, shape, max_nodes: int,
                 homogeneous: bool) -> np.ndarray:
    """Lublin two-stage log-uniform with power-of-two bias.

    `shape` may be an int (one workload) or a tuple ``(R, n)`` (R replica
    workloads drawn in one vectorized pass — see `generate_workload_batch`).
    """
    uhi = np.log2(max_nodes)
    umed = (uhi - ULOW) * 0.625 + ULOW      # Lublin: medium point
    if homogeneous:
        # The paper's "modified generator" is described only as "more
        # homogeneous"; calibrated against the paper's absolute queue-time
        # scale (Tables 1-2) this matches 8-32-node jobs: mean work per job
        # is pinned by the load calibration, so wider jobs mean shorter
        # runtimes, which reproduces the paper's 50%-init median collapse
        # (Fig 7) and the 5%-top / 50%-bottom plateau ordering (Fig 8).
        # See EXPERIMENTS.md §Paper-repro for the calibration study.
        u = rng.uniform(3.0, 5.0, size=shape)
        return np.clip(np.round(2.0 ** u), 1, max_nodes).astype(np.int64)
    serial = rng.random(shape) < SERIAL_PROB
    low = rng.random(shape) < UPROB
    u = np.where(low,
                 rng.uniform(ULOW, umed, size=shape),
                 rng.uniform(umed, uhi, size=shape))
    pow2 = rng.random(shape) < POW2_PROB
    size = np.where(pow2, np.round(u), u)
    nodes = np.clip(np.round(2.0 ** size), 1, max_nodes).astype(np.int64)
    return np.where(serial, 1, nodes)


def _arrivals(rng: np.random.Generator, shape, horizon: float,
              amplitude: float) -> np.ndarray:
    """Heavy-tailed gaps (exp of gamma), warped by a daily cycle, rescaled to
    fill [0, horizon]. Shape-polymorphic along the leading axes: each row of
    a ``(R, n)`` draw is an independent arrival process."""
    ln_gap = rng.gamma(AARR, BARR, size=shape)
    gaps = np.exp(ln_gap - ln_gap.mean(axis=-1, keepdims=True))  # mean ~1
    t = np.cumsum(gaps, axis=-1)
    t = t / t[..., -1:] * horizon
    # daily cycle: compress gaps at daytime peak, stretch at night, by warping
    # time through the inverse cumulative rate of
    # r(t) = 1 + A*cos(2*pi*(t - peak)/DAY).
    peak = 0.58 * DAY                              # ~14:00 peak
    phase = 2 * np.pi * (t - peak) / DAY
    # cumulative of r is t + A*DAY/(2pi)*sin(phase); invert approximately by
    # one Newton step from identity (amplitude < 1 keeps it monotone).
    warped = t - amplitude * DAY / (2 * np.pi) * np.sin(phase)
    warped = np.sort(warped - warped.min(axis=-1, keepdims=True), axis=-1)
    return warped / np.maximum(warped[..., -1:], 1e-9) * horizon


def generate_workload(params: WorkloadParams) -> Workload:
    rng = np.random.default_rng(params.seed)
    n = params.n_jobs

    nodes = _node_counts(rng, n, params.nodes, params.homogeneous)
    ln_rt = _hyper_gamma_ln_runtime(rng, np.log2(nodes.astype(np.float64)))
    if params.homogeneous:
        # paper's modified generator: shrink runtime spread around the mean
        ln_rt = ln_rt.mean() + (ln_rt - ln_rt.mean()) * params.homog_shrink
    runtime = np.exp(ln_rt)
    runtime = np.clip(runtime, 1.0, 2 * DAY)

    submit = _arrivals(rng, n, params.horizon, params.daily_amplitude)

    # job types: skewed categorical (a few popular types), as in production.
    type_weights = 1.0 / np.arange(1, params.n_types + 1)
    type_weights /= type_weights.sum()
    jtype = rng.choice(params.n_types, size=n, p=type_weights).astype(np.int64)

    # calibrate runtimes so the calculated load matches params.load exactly
    raw_load = (runtime * nodes).sum() / (params.nodes * params.horizon)
    runtime = runtime * (params.load / raw_load)

    order = np.argsort(submit, kind="stable")
    submit, runtime, nodes, jtype = (a[order] for a in (submit, runtime, nodes, jtype))
    work = runtime * nodes
    return Workload(submit=submit, runtime=runtime, nodes=nodes.astype(np.int64),
                    work=work, jtype=jtype, params=params)


def generate_workload_batch(params: WorkloadParams,
                            n_replicas: int,
                            name_fmt: str = "rep{r:03d}") -> dict[str, Workload]:
    """R replica workloads of one parameter set, drawn in ONE vectorized pass.

    Every distribution is drawn once with shape ``(R, n_jobs)`` from a
    single stream seeded by ``params.seed``, then split row-wise. All
    replicas share every static — ``(nodes, n_jobs, n_types)`` — by
    construction, so the whole batch lands in one sweep cohort
    (`repro_torch.core.cohort.group_workloads`).

    Replica r is NOT the same stream as ``generate_workload(seed=...)`` for
    any seed; determinism is per ``(params.seed, n_replicas)`` batch, and
    the digests equal the reference's batch for the same arguments.
    """
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    rng = np.random.default_rng(params.seed)
    shape = (n_replicas, params.n_jobs)

    nodes = _node_counts(rng, shape, params.nodes, params.homogeneous)
    ln_rt = _hyper_gamma_ln_runtime(rng, np.log2(nodes.astype(np.float64)))
    if params.homogeneous:
        mu = ln_rt.mean(axis=-1, keepdims=True)
        ln_rt = mu + (ln_rt - mu) * params.homog_shrink
    runtime = np.clip(np.exp(ln_rt), 1.0, 2 * DAY)

    submit = _arrivals(rng, shape, params.horizon, params.daily_amplitude)

    type_weights = 1.0 / np.arange(1, params.n_types + 1)
    type_weights /= type_weights.sum()
    jtype = rng.choice(params.n_types, size=shape,
                       p=type_weights).astype(np.int64)

    # per-replica load calibration, exactly as in generate_workload
    raw_load = (runtime * nodes).sum(axis=-1, keepdims=True) / \
        (params.nodes * params.horizon)
    runtime = runtime * (params.load / raw_load)

    out = {}
    for r in range(n_replicas):
        order = np.argsort(submit[r], kind="stable")
        sub_r, rt_r = submit[r][order], runtime[r][order]
        nd_r, jt_r = nodes[r][order], jtype[r][order]
        out[name_fmt.format(r=r)] = Workload(
            submit=sub_r, runtime=rt_r, nodes=nd_r.astype(np.int64),
            work=rt_r * nd_r, jtype=jt_r, params=params)
    return out


def workload_statics(wl: Workload) -> tuple[int, int, int]:
    """The static signature that decides batch compatibility: two workloads
    can share one stacked sweep dispatch iff these (plus the simulation
    dtype and ring, which `repro_torch.core.cohort.cohort_key` adds) all
    match."""
    return (int(wl.params.nodes), wl.n_jobs, int(wl.params.n_types))


def group_by_statics(flows: Mapping[str, Workload]) -> dict[tuple, list[str]]:
    """Workload names grouped by `workload_statics`, insertion-ordered.

    The workload-level half of cohort grouping: `repro_torch.core.cohort`
    refines these groups with the simulation dtype to build
    `WorkloadCohort`s."""
    groups: dict[tuple, list[str]] = {}
    for name, wl in flows.items():
        groups.setdefault(workload_statics(wl), []).append(name)
    return groups


def paper_workloads(seed: int = 0) -> dict[str, Workload]:
    """The paper's 6 workflows: {hetero,homog} x load {0.85, 0.90, 0.95}.

    Heterogeneous flows run on 500 nodes, homogeneous on 100 (paper §6).
    """
    flows = {}
    for load in (0.85, 0.90, 0.95):
        flows[f"hetero{load:.2f}"] = generate_workload(WorkloadParams(
            nodes=500, load=load, homogeneous=False, seed=seed))
        flows[f"homog{load:.2f}"] = generate_workload(WorkloadParams(
            nodes=100, load=load, homogeneous=True, seed=seed + 1,
            daily_amplitude=0.3))
    return flows
