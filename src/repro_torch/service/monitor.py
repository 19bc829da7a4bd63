"""Monitor stage: windowed + rolling workload signals for the controller.

The port's own copy of `repro.service.monitor` (numpy only), bound to the
port's `Workload`.

`window_signals` reduces one job window to the quantities the decide
stage and the provenance log care about; `RollingMonitor` smooths them
across ticks (EWMA) and exposes per-tick deltas, so drift shows up as a
signal trend rather than window-to-window noise. The one signal that is
load-bearing (not just observability) is `init_time`: the paper's init
proportion s maps to seconds through the *window's* mean runtime, so the
oracle is always asked about the traffic actually on the floor.

`FaultRegimeEstimator` is the fault-side monitor: it smooths the
*realized* fault telemetry (failures / requeues / lost_work the
committed k actually saw last tick) and maps the smoothed rates onto the
chaos lane axis of the tick oracle — a weight per chaos cell,
concentrated on the regime whose predicted telemetry is closest to what
the service is actually living through. The decide stage
(`FaultAwareController`) takes expectations under these weights, so an
environment regime shift moves the weights (within a few EWMA
half-lives) instead of requiring a forecast.

Both monitors survive corrupted telemetry: a NaN/Inf signal component
carries the last finite EWMA forward (counted, reported), and only a
non-finite value at bootstrap — when there is no finite history to carry
— raises a named error. `reset()` returns either monitor to its
pre-first-tick state for reuse across service runs.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import numpy as np

from repro_torch.workload.lublin import Workload


class WindowSignals(NamedTuple):
    """One window, reduced to controller-facing scalars (all float64)."""
    n_jobs: int
    span: float            # seconds covered by the window's submits
    arrival_rate: float    # jobs per second
    mean_runtime: float    # seconds
    runtime_cv: float      # coefficient of variation — homogeneity proxy
    mean_nodes: float      # mean requested node count
    offered_load: float    # sum(work) / (M * span): the calculated rho
    init_time: float       # seconds of group init the s proportion buys here


def window_signals(wl: Workload, s_prop: float) -> WindowSignals:
    """Reduce a window (a `slice_window` output) to `WindowSignals`.

    `init_time` follows `Workload.init_time_for_proportion`: s_prop is a
    proportion of the mean runtime, evaluated on THIS window, so a
    homogeneity or intensity shift moves the oracle's s operand with it.
    """
    submit = np.asarray(wl.submit, np.float64)
    runtime = np.asarray(wl.runtime, np.float64)
    n = len(submit)
    if n == 0:
        raise ValueError("window_signals needs a non-empty window")
    span = float(max(submit[-1] - submit[0], 1.0))
    mean_rt = float(runtime.mean())
    return WindowSignals(
        n_jobs=n,
        span=span,
        arrival_rate=n / span,
        mean_runtime=mean_rt,
        runtime_cv=float(runtime.std() / max(mean_rt, 1e-12)),
        mean_nodes=float(np.asarray(wl.nodes, np.float64).mean()),
        offered_load=float(np.asarray(wl.work, np.float64).sum()
                           / (wl.params.nodes * span)),
        init_time=float(wl.init_time_for_proportion(s_prop)),
    )


#: WindowSignals fields the monitor smooths (the rest are structural)
_SMOOTHED = ("arrival_rate", "mean_runtime", "runtime_cv", "mean_nodes",
             "offered_load", "init_time")


class RollingMonitor:
    """EWMA over window signals, with per-tick drift deltas.

    ``alpha`` is the weight of the newest window (alpha=1 disables
    smoothing). `observe` returns a flat dict — raw signals, their
    smoothed values (``ewm_*``), and the change of each smoothed value
    since the previous tick (``delta_*``) — ready for the driver's
    per-tick provenance log.

    Telemetry hardening: a non-finite (NaN/Inf) signal component carries
    the last finite EWMA forward for that component (its ``delta_*`` is
    0.0 and its name lands in the returned ``"carried"`` list, which is
    present only on such degraded ticks). A non-finite component on the
    FIRST observation has no finite history to carry and raises a named
    ValueError. `has_state` is True once a first window was observed;
    `reset()` clears the EWMA state for reuse across service runs.
    """

    def __init__(self, alpha: float = 0.5):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self._ewm: dict[str, float] | None = None

    @property
    def has_state(self) -> bool:
        return self._ewm is not None

    def reset(self) -> None:
        """Forget all smoothed state (back to the pre-first-tick state)."""
        self._ewm = None

    def observe(self, sig: WindowSignals) -> dict[str, float]:
        raw = sig._asdict()
        prev = self._ewm
        ewm = {}
        carried = []
        for name in _SMOOTHED:
            x = float(raw[name])
            if not math.isfinite(x):
                if prev is None:
                    raise ValueError(
                        f"RollingMonitor.observe: signal {name!r} is "
                        f"non-finite ({x}) on the first observation — no "
                        f"finite EWMA to carry forward")
                carried.append(name)
                ewm[name] = prev[name]
                continue
            ewm[name] = (x if prev is None
                         else self.alpha * x + (1 - self.alpha) * prev[name])
        out = {k: (int(v) if k == "n_jobs" else float(v))
               for k, v in raw.items()}
        out.update({f"ewm_{k}": v for k, v in ewm.items()})
        out.update({f"delta_{k}": (0.0 if prev is None else ewm[k] - prev[k])
                    for k in _SMOOTHED})
        if carried:
            out["carried"] = carried
        self._ewm = ewm
        return out


#: realized fault-telemetry components the regime estimator smooths, in
#: the order `FaultRegimeEstimator.observe` takes them
FAULT_SIGNALS = ("failures", "requeues", "lost_work")


class FaultRegimeEstimator:
    """EWMA fault-regime estimator: realized telemetry → chaos-cell weights.

    Each tick the service *realizes* one (k, chaos-environment) cell and
    observes its fault telemetry — failures, requeue rounds, lost work.
    `observe` smooths those (EWMA, weight ``alpha`` on the newest tick);
    `weights` then scores every cell of the oracle's chaos axis by how
    close its *predicted* telemetry (the previous tick's [K, C] curves at
    the committed k) sits to the smoothed observations, returning a
    normalized weight vector over the C cells:

        d_c   = mean over signals of |pred_c - ewm| / max_c |pred_c|
        w_c   ∝ exp(-d_c / temperature)

    The per-signal normalization makes the distance dimensionless (chip
    -seconds of lost work and failure counts contribute equally); the
    ``temperature`` sets how sharply weight concentrates on the nearest
    regime (→0 approaches one-hot, large values approach uniform).
    Before any finite observation — and whenever no observed signal has a
    matching prediction — `weights` is uniform: the estimator starts
    agnostic and sharpens as realized faults arrive.

    Telemetry hardening mirrors `RollingMonitor`: a non-finite observed
    component keeps its last finite EWMA (carried forward, counted in
    ``n_carried`` and named in the returned ``"carried"`` list); a
    component that was never finite simply stays unobserved and is
    skipped by `weights`, so a NaN-poisoned stream degrades toward the
    uniform prior instead of propagating NaN into the decide step.
    `reset()` forgets all state for reuse across service runs.
    """

    def __init__(self, alpha: float = 0.5, temperature: float = 0.25):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if not (temperature > 0.0):
            raise ValueError(
                f"temperature must be > 0, got {temperature}")
        self.alpha = float(alpha)
        self.temperature = float(temperature)
        self._ewm: dict[str, float] = {}
        self.n_carried = 0

    @property
    def has_state(self) -> bool:
        return bool(self._ewm)

    def reset(self) -> None:
        """Forget all smoothed state and carry counters."""
        self._ewm = {}
        self.n_carried = 0

    def observe(self, failures: float, requeues: float,
                lost_work: float) -> dict:
        """Fold one tick's realized fault telemetry into the EWMAs.

        Returns the smoothed values (``ewm_*``, only for components that
        have seen at least one finite observation) plus a ``"carried"``
        list naming non-finite components whose EWMA was carried forward
        this tick (empty list when the telemetry was clean).
        """
        obs = dict(zip(FAULT_SIGNALS, (failures, requeues, lost_work)))
        carried = []
        for name, x in obs.items():
            x = float(x)
            if not math.isfinite(x):
                carried.append(name)        # keep the last finite EWMA
                continue
            prev = self._ewm.get(name)
            self._ewm[name] = (x if prev is None
                               else self.alpha * x
                               + (1 - self.alpha) * prev)
        self.n_carried += len(carried)
        out = {f"ewm_{k}": float(v) for k, v in self._ewm.items()}
        out["carried"] = carried
        return out

    def weights(self, cell_signals: Mapping[str, "np.ndarray"]) -> np.ndarray:
        """Weight per chaos cell given each cell's predicted telemetry.

        ``cell_signals`` maps signal names (a subset of `FAULT_SIGNALS`)
        to equal-length [C] arrays — cell c's predicted value of that
        signal at the committed k (from the previous tick's oracle
        curves). Returns a float64 [C] vector summing to 1. Uniform when
        nothing has been observed yet or no observed signal has a
        prediction; mismatched lengths raise, naming the fields.
        """
        lens = {name: np.asarray(v).shape for name, v in cell_signals.items()}
        uniq = set(lens.values())
        if not lens or len(uniq) > 1 or any(len(s) != 1 for s in uniq):
            detail = ", ".join(f"{n}{list(s)}" for n, s in sorted(lens.items()))
            raise ValueError(
                f"cell_signals must be non-empty equal-length 1-D arrays, "
                f"got {detail or 'nothing'}")
        C = next(iter(uniq))[0]
        if C < 1:
            raise ValueError("cell_signals arrays must have length >= 1")
        dist = np.zeros(C, np.float64)
        n_used = 0
        for name in FAULT_SIGNALS:
            if name not in cell_signals or name not in self._ewm:
                continue
            pred = np.asarray(cell_signals[name], np.float64)
            scale = max(float(np.max(np.abs(pred))), 1e-12)
            dist += np.abs(pred - self._ewm[name]) / scale
            n_used += 1
        if n_used == 0:
            return np.full(C, 1.0 / C)
        z = -(dist / n_used) / self.temperature
        w = np.exp(z - z.max())
        return w / w.sum()
