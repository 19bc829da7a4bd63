"""Actuate stage + tick loop: play a trace through the streaming service.

The port's copy of `repro.service.driver`, on the port's oracle: every
tick packs its window with `pack_workload` on the service's device
(``ServiceConfig.device``; None = the CUDA card, ``"cpu"`` by name) and
runs `repro_torch.core.sweep.run_window_oracle` there, one dispatch of the
event-step kernel's lanes on the card. The rest is host-side numpy.

`run_service` drives the monitor → decide → actuate loop (see the
package docstring): it cuts a trace into fixed-shape
windows, runs the fused lane oracle once per tick, lets every registered
controller decide on the SAME curve, and scores what each controller's
held k actually realized on that window. The committed k takes effect on
the *next* tick (one-tick actuation delay — a live scheduler retunes for
traffic it hasn't seen yet), except the bootstrap tick, where the service
turns on with the oracle's first recommendation.

Regret bookkeeping per controller and tick:

* ``regret_wait``   = avg_wait(realized k) - min over candidates (>= 0)
* ``regret_useful`` = max useful_util over candidates - realized (>= 0)
* ``wait_vs_plateau`` (signed) = avg_wait(realized k) - avg_wait at the
  offline `plateau_threshold` recommendation for this window's curve —
  the per-window hindsight application of the paper's offline tuning
  rule. Negative means the controller beat the offline rule.

Fault-aware mode (``ServiceConfig.chaos``): the oracle sweeps a C-cell
`ChaosConfig` axis per tick ([K, C] curves from one fused program), one
designated cell (``chaos_env_cell``) plays the true environment — every
hindsight reference and realized metric reads that column — and each
controller owns a `FaultRegimeEstimator` fed by the fault telemetry its
own committed k realized, so decide weights the regime the service
actually lives in. Fault-blind controllers then decide on the
weight-expected wait curve; `FaultAwareController` adds the λ·lost term
(the A/B the reference's `benchmarks/controller_sweep.py --chaos`
gates).

Degradation (``on_budget_exhausted="degrade"`` + the `TickFaults` hook):
a tick whose oracle exhausted its event budget (or was forced to by
`TickFaults.exhaust_budget`) no longer kills the stream — the service
holds every controller's last-good k, appends a per-tick health entry,
and retries the oracle on the next tick, raising only after
``max_consecutive_degraded`` consecutive degraded ticks. Budget errors
that DO surface (policy "raise") name the tick index and window bounds.

Everything returned is JSON-ready. The chaos machinery, health records
and degrade bookkeeping only engage (and only add their output keys)
when configured.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.des import (ChaosConfig, chaos_is_inert,
                                  pack_workload, resolve_ring)
from repro_torch.core.sweep import (PAPER_SCALE_RATIOS, chaos_axis_len,
                                    plateau_threshold, run_window_oracle)
from repro_torch.device import resolve_device
from repro_torch.service.controller import (FaultAwareController,
                                            HysteresisController,
                                            NaiveController)
from repro_torch.service.monitor import (FaultRegimeEstimator,
                                         RollingMonitor, window_signals)
from repro_torch.workload.lublin import Workload
from repro_torch.workload.windows import WindowSpec, iter_windows, n_dropped

_ON_BUDGET_POLICIES = ("raise", "warn", "ignore", "degrade")
_ORACLE_MODES = ("auto", "seq", "chunked", "fused")
_DTYPES = ("float32", "float64")

#: WindowSignals float fields blanked by a dropped-telemetry tick fault
_TELEMETRY_FIELDS = ("span", "arrival_rate", "mean_runtime", "runtime_cv",
                     "mean_nodes", "offered_load", "init_time")


@dataclasses.dataclass(frozen=True)
class TickFaults:
    """Injectable service-loop faults, keyed by tick index.

    The degradation harness's test double: deterministic faults on chosen
    ticks, so a suite can prove the loop completes every tick. Three fault kinds:

    * ``exhaust_budget`` — the tick's oracle result is treated as having
      exhausted its event budget (the metrics are discarded under
      "degrade", surfaced per `on_budget_exhausted` otherwise), exactly
      as if the window itself had blown through `event_budget`.
    * ``nan_telemetry`` — the realized fault telemetry fed to the
      `FaultRegimeEstimator` is replaced with NaN (the estimator must
      carry its EWMAs forward).
    * ``drop_telemetry`` — the window's monitor signals never arrive:
      the `RollingMonitor` sees NaN for every float signal (carrying its
      EWMAs forward) and the oracle runs on the last smoothed init time
      instead of the window's raw one.
    """

    exhaust_budget: frozenset = frozenset()
    nan_telemetry: frozenset = frozenset()
    drop_telemetry: frozenset = frozenset()

    def __post_init__(self):
        for name in ("exhaust_budget", "nan_telemetry", "drop_telemetry"):
            val = getattr(self, name)
            if not isinstance(val, frozenset):
                if isinstance(val, (str, bytes)) or not isinstance(
                        val, Iterable):
                    raise ValueError(
                        f"TickFaults.{name} must be an iterable of tick "
                        f"indices, got {val!r}")
                object.__setattr__(self, name, frozenset(val))
            bad = [t for t in getattr(self, name)
                   if not isinstance(t, int) or t < 0]
            if bad:
                raise ValueError(
                    f"TickFaults.{name} must hold non-negative ints, "
                    f"got {sorted(bad, key=repr)}")


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs of one service run (all ticks share them).

    Validated eagerly in ``__post_init__`` — a bad dtype / mode /
    tolerance / policy raises at construction, not deep inside tick N.

    The fault-aware block only engages when ``chaos`` is set: the oracle
    then sweeps the config's chaos lane axis each tick ([K, C] curves),
    ``chaos_env_cell`` indexes the axis cell that plays the true
    environment (realized metrics and hindsight references read that
    column), ``risk_lambda`` prices expected lost work (machine-seconds)
    in seconds of wait for `FaultAwareController`, and ``fault_alpha`` /
    ``fault_temperature`` parameterize each controller's
    `FaultRegimeEstimator`. ``on_budget_exhausted="degrade"`` makes the
    loop survive budget-exhausted windows (hold last-good k, health
    entry, retry next tick, raise after ``max_consecutive_degraded``
    consecutive degraded ticks). ``device`` is where the oracle runs:
    None means the CUDA card (resolved, and raising without one, when
    `run_service` starts), ``"cpu"`` the plain PyTorch path.
    """
    ks: tuple[float, ...] = PAPER_SCALE_RATIOS   # candidate scale ratios
    s_prop: float = 0.05          # init proportion fed to the monitor
    window_jobs: int = 400        # jobs per control-tick window
    stride_jobs: int | None = None  # window start spacing (None: tumbling)
    dtype: str = "float32"        # oracle dtype
    mode: str = "auto"            # oracle dispatch layout
    rel_tol: float = 0.05         # the 5% plateau band (paper's tolerance)
    abs_tol: float | None = None  # plateau abs slack (None: float32 envelope)
    ewm_alpha: float = 0.5        # monitor smoothing weight
    on_budget_exhausted: str = "raise"
    chaos: ChaosConfig | None = None   # C-cell fault axis for the oracle
    chaos_env_cell: int = 0       # axis cell playing the true environment
    risk_lambda: float = 1.0      # wait-seconds per machine-second lost
    adapt_lambda: bool = False    # close the λ loop on realized telemetry
    lambda_alpha: float = 0.3     # λ-loop EWMA weight (realized wait/lost)
    lambda_span: float = 10.0     # live λ clipped to [λ0/span, λ0·span]
    fault_alpha: float = 0.5      # fault-regime estimator EWMA weight
    fault_temperature: float = 0.25   # regime-weight softmax temperature
    max_consecutive_degraded: int = 3  # degrade-mode retry bound
    device: object = None         # oracle device (None: the CUDA card)

    def __post_init__(self):
        if len(self.ks) < 1:
            raise ValueError("ServiceConfig.ks needs at least one candidate")
        if self.window_jobs < 1:
            raise ValueError(
                f"window_jobs must be >= 1, got {self.window_jobs}")
        if self.stride_jobs is not None and self.stride_jobs < 1:
            raise ValueError(
                f"stride_jobs must be >= 1 or None, got {self.stride_jobs}")
        if not (self.s_prop > 0):
            raise ValueError(f"s_prop must be > 0, got {self.s_prop}")
        if self.dtype not in _DTYPES:
            raise ValueError(
                f"dtype must be one of {_DTYPES}, got {self.dtype!r}")
        if self.mode not in _ORACLE_MODES:
            raise ValueError(
                f"mode must be one of {_ORACLE_MODES}, got {self.mode!r} "
                f"(the window oracle has no vmap_k/vmap_s layout)")
        if self.rel_tol < 0:
            raise ValueError(f"rel_tol must be >= 0, got {self.rel_tol}")
        if self.abs_tol is not None and self.abs_tol < 0:
            raise ValueError(
                f"abs_tol must be >= 0 or None, got {self.abs_tol}")
        if not (0.0 < self.ewm_alpha <= 1.0):
            raise ValueError(
                f"ewm_alpha must be in (0, 1], got {self.ewm_alpha}")
        if self.on_budget_exhausted not in _ON_BUDGET_POLICIES:
            raise ValueError(
                f"on_budget_exhausted must be one of {_ON_BUDGET_POLICIES}, "
                f"got {self.on_budget_exhausted!r}")
        if self.risk_lambda < 0:
            raise ValueError(
                f"risk_lambda must be >= 0, got {self.risk_lambda}")
        if not (0.0 < self.lambda_alpha <= 1.0):
            raise ValueError(
                f"lambda_alpha must be in (0, 1], got {self.lambda_alpha}")
        if not (self.lambda_span >= 1.0):
            raise ValueError(
                f"lambda_span must be >= 1, got {self.lambda_span}")
        if not (0.0 < self.fault_alpha <= 1.0):
            raise ValueError(
                f"fault_alpha must be in (0, 1], got {self.fault_alpha}")
        if not (self.fault_temperature > 0):
            raise ValueError(
                f"fault_temperature must be > 0, "
                f"got {self.fault_temperature}")
        if self.max_consecutive_degraded < 1:
            raise ValueError(
                f"max_consecutive_degraded must be >= 1, "
                f"got {self.max_consecutive_degraded}")
        if self.chaos is not None:
            n_cells = chaos_axis_len(self.chaos)    # validates the axis too
            if not (0 <= self.chaos_env_cell < n_cells):
                raise ValueError(
                    f"chaos_env_cell={self.chaos_env_cell} out of range for "
                    f"the {n_cells}-cell chaos axis")
            if chaos_is_inert(self.chaos):
                raise ValueError(
                    "ServiceConfig.chaos is inert (zero failure and "
                    "straggler rates); pass chaos=None for a fault-free "
                    "service instead")

    def np_dtype(self):
        return np.dtype(self.dtype)

    @property
    def n_chaos_cells(self) -> int:
        return 1 if self.chaos is None else chaos_axis_len(self.chaos)


def default_controllers(config: ServiceConfig):
    """The study set for this config: with a chaos axis, the risk-aware
    controller plus its fault-blind foils; without, the fault-blind pair
    (plateau hysteresis vs. the naive arg-best)."""
    blind = [HysteresisController(rel_tol=config.rel_tol,
                                  abs_tol=config.abs_tol),
             NaiveController()]
    if config.chaos is None:
        return blind
    return [FaultAwareController(rel_tol=config.rel_tol,
                                 abs_tol=config.abs_tol,
                                 risk_lambda=config.risk_lambda,
                                 adapt_lambda=config.adapt_lambda,
                                 lambda_alpha=config.lambda_alpha,
                                 lambda_span=config.lambda_span)] + blind


def _controller_summary(rec: dict, aw_best: np.ndarray,
                        with_chaos: bool) -> dict:
    realized = np.asarray(rec["realized_wait"], np.float64)
    regret_w = np.asarray(rec["regret_wait"], np.float64)
    regret_u = np.asarray(rec["regret_useful"], np.float64)
    vs_plat = np.asarray(rec["wait_vs_plateau"], np.float64)
    total_best = float(np.sum(aw_best))
    out = {
        "n_ticks": len(realized),
        "switches": int(rec["switches"]),
        "mean_regret_wait": float(regret_w.mean()) if len(realized) else 0.0,
        "total_regret_wait": float(regret_w.sum()),
        # relative to the hindsight per-tick optimum's total wait
        "rel_regret_wait": float(regret_w.sum() / max(total_best, 1e-9)),
        "mean_regret_useful": (float(regret_u.mean())
                               if len(realized) else 0.0),
        "mean_wait_vs_plateau": (float(vs_plat.mean())
                                 if len(realized) else 0.0),
        "mean_realized_wait": (float(realized.mean())
                               if len(realized) else 0.0),
        "k_trajectory": [float(k) for k in rec["k"]],
    }
    if with_chaos:
        lost = np.asarray(rec["realized_lost"], np.float64)
        out["total_lost_work"] = float(lost.sum())
        out["mean_realized_lost"] = float(lost.mean()) if len(lost) else 0.0
    return out


def _chaos_config_provenance(config: ServiceConfig) -> dict:
    """JSON-ready record of the fault-aware knobs (chaos axes included)."""
    c = config.chaos
    return {
        "n_cells": config.n_chaos_cells,
        "env_cell": int(config.chaos_env_cell),
        "risk_lambda": float(config.risk_lambda),
        "adapt_lambda": bool(config.adapt_lambda),
        "lambda_alpha": float(config.lambda_alpha),
        "lambda_span": float(config.lambda_span),
        "fault_alpha": float(config.fault_alpha),
        "fault_temperature": float(config.fault_temperature),
        "seed": int(c.seed),
        "mtbf_chip_hours": np.asarray(c.mtbf_chip_hours,
                                      np.float64).tolist(),
        "ckpt_period": np.asarray(c.ckpt_period, np.float64).tolist(),
        "straggler_prob": np.asarray(c.straggler_prob, np.float64).tolist(),
        "straggler_factor": np.asarray(c.straggler_factor,
                                       np.float64).tolist(),
        "straggler_deadline": np.asarray(c.straggler_deadline,
                                         np.float64).tolist(),
    }


def _nan_signals(sig):
    """The dropped-telemetry form of a WindowSignals: floats gone NaN."""
    return sig._replace(**{f: float("nan") for f in _TELEMETRY_FIELDS})


def run_service(wl: Workload,
                config: ServiceConfig = ServiceConfig(),
                controllers: Sequence | None = None,
                tick_faults: TickFaults | None = None) -> dict:
    """Play one trace through the service; score every controller.

    All controllers consume the same per-tick oracle curve (one
    `run_window_oracle` call per tick, shared), so their regrets differ
    only by policy. Controllers are stateful — pass fresh instances.
    `tick_faults` injects deterministic faults into chosen ticks (see
    `TickFaults`); with ``config.on_budget_exhausted="degrade"`` the loop
    completes every tick regardless, holding the last-good k and
    recording per-tick ``health`` entries.

    Each tick's ``oracle_ms`` is host-clock time around the oracle call;
    the call ends with the copy of its metrics to numpy, which waits for
    the device, so the time includes the device's work.
    """
    if controllers is None:
        controllers = default_controllers(config)
    names = [c.name for c in controllers]
    if len(set(names)) != len(names):
        raise ValueError(f"controller names must be unique, got {names}")
    faults = tick_faults
    policy = config.on_budget_exhausted
    track_health = policy == "degrade" or faults is not None
    with_chaos = config.chaos is not None
    K, C = len(config.ks), config.n_chaos_cells
    env = int(config.chaos_env_cell)

    dtype = config.np_dtype()
    dev = resolve_device(config.device)
    spec = WindowSpec(config.window_jobs, config.stride_jobs)
    m_nodes = int(wl.params.nodes)
    ks = np.asarray(config.ks, np.float64)
    monitor = RollingMonitor(alpha=config.ewm_alpha)
    estimators = {n: FaultRegimeEstimator(alpha=config.fault_alpha,
                                          temperature=config.fault_temperature)
                  for n in names} if with_chaos else {}
    # per-controller [C] telemetry predictions at last tick's realized k,
    # mapped onto weights at the NEXT tick's decide
    pred: dict[str, dict | None] = {n: None for n in names}

    live: dict[str, float | None] = {n: None for n in names}
    rec = {n: {"k": [], "realized_wait": [], "regret_wait": [],
               "regret_useful": [], "wait_vs_plateau": [],
               "realized_lost": [], "switches": 0}
           for n in names}
    ticks = []
    health = []
    aw_best_all = []
    consec_degraded = 0

    for t, (lo, hi, win) in enumerate(iter_windows(wl, spec)):
        dropped = (faults is not None and t in faults.drop_telemetry
                   and monitor.has_state)
        nan_tel = faults is not None and t in faults.nan_telemetry
        forced = faults is not None and t in faults.exhaust_budget

        sig = window_signals(win, config.s_prop)
        smooth = monitor.observe(_nan_signals(sig) if dropped else sig)
        # dropped telemetry: the raw window never arrived — steer the
        # oracle by the last smoothed init time instead
        s_init = smooth["ewm_init_time"] if dropped else sig.init_time

        pw = pack_workload(win, dtype, dev)
        ring = resolve_ring(m_nodes, pw.n_jobs)
        t0 = time.perf_counter()
        m = run_window_oracle(pw, config.ks, s_init, m_nodes,
                              ring=ring, mode=config.mode,
                              chaos=config.chaos,
                              on_budget_exhausted="ignore", device=dev)
        oracle_ms = (time.perf_counter() - t0) * 1e3
        exhausted = bool(np.any(np.asarray(m.budget_exhausted))) or forced
        tick_label = (f"run_service tick {t} (window jobs "
                      f"[{int(lo)}, {int(hi)}))")

        if exhausted and policy != "ignore":
            why = ("forced budget exhaustion (TickFaults)" if forced
                   else "oracle lane(s) exhausted the event budget")
            msg = (f"{tick_label}: {why} — schedules for this window are "
                   f"untrustworthy; raise the event budget, or run with "
                   f"on_budget_exhausted='degrade' to hold the last-good "
                   f"k and continue")
            if policy == "raise":
                raise RuntimeError(msg)
            if policy == "warn":
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
            else:                   # degrade: hold last-good k, no scoring
                consec_degraded += 1
                if consec_degraded > config.max_consecutive_degraded:
                    raise RuntimeError(
                        f"{tick_label}: {consec_degraded} consecutive "
                        f"degraded ticks exceed max_consecutive_degraded="
                        f"{config.max_consecutive_degraded} — the oracle "
                        f"never recovered; giving up")
                tick = {"tick": t, "window": [int(lo), int(hi)],
                        "signals": smooth, "oracle_ms": float(oracle_ms),
                        "degraded": True, "controllers": {}}
                for ctl in controllers:
                    name = ctl.name
                    if live[name] is None:
                        # degraded before bootstrap: start on the median
                        # candidate — the most conservative plateau guess
                        live[name] = float(ks[len(ks) // 2])
                        reason = "degraded-bootstrap"
                    else:
                        reason = "degraded-hold"
                    rec[name]["k"].append(float(live[name]))
                    tick["controllers"][name] = {
                        "realized_k": float(live[name]),
                        "committed_k": float(live[name]),
                        "moved": False, "reason": reason}
                ticks.append(tick)
                health.append({
                    "tick": t, "window": [int(lo), int(hi)], "ok": False,
                    "degraded": True, "cause": why,
                    "consecutive_degraded": consec_degraded,
                    "dropped_telemetry": bool(dropped),
                    "held_k": {n: float(live[n]) for n in names}})
                continue
        consec_degraded = 0

        aw2 = np.asarray(m.avg_wait, np.float64).reshape(K, -1)
        uu2 = np.asarray(m.useful_util, np.float64).reshape(K, -1)
        lost2 = np.asarray(m.lost_work, np.float64).reshape(K, -1)
        fail2 = np.asarray(m.failures, np.float64).reshape(K, -1)
        req2 = np.asarray(m.requeues, np.float64).reshape(K, -1)
        # hindsight references live in the true environment's cell
        aw = aw2[:, env]
        uu = uu2[:, env]
        i_best = int(np.argmin(aw))
        best_uu = float(np.max(uu))
        plat = plateau_threshold(ks, aw, rel_tol=config.rel_tol,
                                 abs_tol=config.abs_tol)
        i_plat = int(np.argmin(np.abs(ks - plat.threshold)))
        aw_best_all.append(float(aw[i_best]))

        tick = {"tick": t, "window": [int(lo), int(hi)],
                "signals": smooth, "oracle_ms": float(oracle_ms),
                "best_k": float(ks[i_best]),
                "best_wait": float(aw[i_best]),
                "plateau_k": float(plat.threshold),
                "plateau_wait": float(aw[i_plat]),
                "controllers": {}}

        for ctl in controllers:
            name = ctl.name
            if with_chaos:
                est = estimators[name]
                weights = (est.weights(pred[name])
                           if pred[name] is not None
                           else np.full(C, 1.0 / C))
                if getattr(ctl, "fault_aware", False):
                    dec = ctl.decide(ks, aw2, lost=lost2 / m_nodes,
                                     weights=weights)
                else:
                    dec = ctl.decide(ks, aw2 @ weights)
            else:
                dec = ctl.decide(ks, aw)
            # actuation delay: tick t realizes the k held coming INTO the
            # tick; the new decision takes effect at t+1. Bootstrap tick
            # realizes the first decision (the service starts with it).
            k_real = live[name] if live[name] is not None else dec.k
            live[name] = dec.k
            i_real = int(np.argmin(np.abs(ks - k_real)))
            r = rec[name]
            r["k"].append(float(k_real))
            r["realized_wait"].append(float(aw[i_real]))
            r["regret_wait"].append(float(aw[i_real] - aw[i_best]))
            r["regret_useful"].append(float(best_uu - uu[i_real]))
            r["wait_vs_plateau"].append(float(aw[i_real] - aw[i_plat]))
            if dec.moved and dec.reason != "bootstrap":
                r["switches"] += 1
            ctl_tick = {
                "realized_k": float(k_real), "committed_k": float(dec.k),
                "moved": bool(dec.moved), "reason": dec.reason,
                "hold_tol": float(dec.hold_tol)}
            if with_chaos:
                # realized fault telemetry (true environment's cell at the
                # realized k) closes the estimator's loop; NaN injection
                # exercises its carry-forward hardening
                lost_real = float(lost2[i_real, env] / m_nodes)
                r["realized_lost"].append(lost_real)
                obs = ((float("nan"),) * 3 if nan_tel
                       else (float(fail2[i_real, env]),
                             float(req2[i_real, env]),
                             float(lost2[i_real, env])))
                est_out = estimators[name].observe(*obs)
                pred[name] = {"failures": fail2[i_real, :],
                              "requeues": req2[i_real, :],
                              "lost_work": lost2[i_real, :]}
                if getattr(ctl, "fault_aware", False):
                    # close the λ loop: the realized wait/lost pair at
                    # this tick's realized k re-prices lost work for the
                    # NEXT tick's decide (no-op unless adapt_lambda)
                    ctl_tick["risk_lambda"] = float(ctl.live_lambda)
                    obs_wait = float("nan") if nan_tel else float(aw[i_real])
                    obs_lost = float("nan") if nan_tel else lost_real
                    ctl.observe_realized(obs_wait, obs_lost)
                ctl_tick["weights"] = [float(x) for x in weights]
                ctl_tick["realized_lost"] = lost_real
                ctl_tick["fault_ewm"] = {k: v for k, v in est_out.items()
                                         if k != "carried"}
                if est_out["carried"]:
                    ctl_tick["carried_telemetry"] = est_out["carried"]
            tick["controllers"][name] = ctl_tick
        ticks.append(tick)
        if track_health:
            health.append({
                "tick": t, "window": [int(lo), int(hi)], "ok": True,
                "degraded": False, "consecutive_degraded": 0,
                "dropped_telemetry": bool(dropped),
                "nan_telemetry": bool(nan_tel),
                "budget_warned": bool(exhausted and policy == "warn")})

    if not ticks:
        raise ValueError(
            f"trace of {len(wl.submit)} jobs yields no full "
            f"{config.window_jobs}-job window")

    aw_best_arr = np.asarray(aw_best_all, np.float64)
    cfg_out = {
        "ks": [float(k) for k in config.ks], "s_prop": config.s_prop,
        "window_jobs": config.window_jobs,
        "stride_jobs": spec.stride, "dtype": str(dtype),
        "mode": config.mode, "rel_tol": config.rel_tol,
        "m_nodes": m_nodes, "device": str(dev),
        "n_dropped_jobs": int(n_dropped(len(wl.submit), spec)),
    }
    if policy != "raise":
        cfg_out["on_budget_exhausted"] = policy
    if with_chaos:
        cfg_out["chaos"] = _chaos_config_provenance(config)
    out = {
        "config": cfg_out,
        "n_ticks": len(ticks),
        "oracle": {
            "best_k": [t["best_k"] for t in ticks if "best_k" in t],
            "plateau_k": [t["plateau_k"] for t in ticks if "plateau_k" in t],
            "total_best_wait": float(aw_best_arr.sum()),
            "oracle_ms": [t["oracle_ms"] for t in ticks],
        },
        "controllers": {n: _controller_summary(rec[n], aw_best_arr,
                                               with_chaos)
                        for n in names},
        "ticks": ticks,
    }
    if track_health:
        out["health"] = health
        out["n_degraded_ticks"] = sum(1 for h in health if h["degraded"])
    return out
