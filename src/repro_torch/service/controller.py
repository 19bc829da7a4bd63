"""Decide stage: plateau-aware hysteresis over a tick's tuning curve.

The port's own copy of `repro.service.controller` (numpy only), bound to
the port's `plateau_threshold` and `FLOAT32_AVG_WAIT_RTOL`.

The oracle hands decide() the avg_wait curve over the candidate k's for
the most recent window. The paper's central empirical fact is that this
curve has a wide, flat plateau around its optimum (that's why
`plateau_threshold` reports a *smallest sufficient* k, not a unique
arg-min) — under window noise the arg-best hops between near-tied plateau
members every tick. `HysteresisController` therefore treats the plateau,
not the arg-min, as the stability region: hold the current k while its
wait stays within the plateau band of the new best, move (to the new
arg-best) only when it leaves. `NaiveController` commits the arg-best
unconditionally and is the A/B foil the reference's
`benchmarks/controller_sweep.py` gates against (hysteresis must match its
regret with fewer switches).

`FaultAwareController` is the risk-aware variant for chaos-axis ticks:
the oracle then returns [K, C] curves (per candidate k, per fault
regime) and the fault-regime estimator a weight per cell. It scalarizes
the wait/lost-work frontier — cost(k) = E_w[wait] + λ · E_w[lost] —
and runs the SAME plateau-band hysteresis on the cost curve, so the
plateau stability story survives going fault-aware: among near-tied
plateau members the λ term breaks ties toward the k that loses the
least work under the regime the service actually lives in. The
fault-blind `HysteresisController` deciding on E_w[wait] alone is its
A/B foil (the reference's `benchmarks/controller_sweep.py --chaos`
gates the pair).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.sweep import FLOAT32_AVG_WAIT_RTOL, plateau_threshold


class Decision(NamedTuple):
    """One decide() outcome, with the evidence it was based on."""
    k: float            # the committed scale ratio (actuated next tick)
    moved: bool         # did the controller change k this tick
    reason: str         # "bootstrap" | "hold" | "left-plateau" | "argbest"
    best_k: float       # this tick's hindsight arg-best candidate
    best_wait: float    # avg_wait at best_k
    hold_tol: float     # the plateau band half-width used (seconds)
    plateau_k: float    # offline plateau_threshold recommendation (provenance)


def _validate_curve(ks, avg_wait) -> tuple[np.ndarray, np.ndarray]:
    ks = np.asarray(ks, np.float64)
    w = np.asarray(avg_wait, np.float64)
    if ks.ndim != 1 or ks.shape != w.shape or len(ks) == 0:
        raise ValueError(
            f"decide() wants matching 1-D ks/avg_wait, got {ks.shape} "
            f"and {w.shape}")
    if not np.all(np.isfinite(w)):
        raise ValueError("avg_wait curve contains non-finite values")
    return ks, w


class HysteresisController:
    """Commit arg-best k, but only when the held k leaves the 5% plateau.

    The hold band reuses `plateau_threshold`'s tolerance model:
    ``rel_tol * best_wait + abs_tol``, with ``abs_tol`` defaulting to the
    measured float32 avg_wait envelope (`FLOAT32_AVG_WAIT_RTOL`, scaled
    by the plateau level) so float noise alone can never trigger a move.
    Stateful: one instance per controlled stream.
    """

    name = "hysteresis"

    def __init__(self, rel_tol: float = 0.05, abs_tol: float | None = None):
        if rel_tol < 0:
            raise ValueError(f"rel_tol must be >= 0, got {rel_tol}")
        self.rel_tol = float(rel_tol)
        self.abs_tol = abs_tol
        self.k: float | None = None

    def decide(self, ks, avg_wait) -> Decision:
        ks, w = _validate_curve(ks, avg_wait)
        return self._decide_on_curve(ks, w)

    def _decide_on_curve(self, ks: np.ndarray, w: np.ndarray) -> Decision:
        """Plateau-band hysteresis over a validated 1-D cost curve.

        `decide` hands this the avg_wait curve; `FaultAwareController`
        hands it the scalarized wait+λ·lost cost curve. The hold rule is
        identical either way — that IS the refactor's point.
        """
        i_best = int(np.argmin(w))
        best_k, best_w = float(ks[i_best]), float(w[i_best])
        plat = plateau_threshold(ks, w, rel_tol=self.rel_tol,
                                 abs_tol=self.abs_tol)
        abs_tol = (FLOAT32_AVG_WAIT_RTOL * max(best_w, 1.0)
                   if self.abs_tol is None else float(self.abs_tol))
        tol = self.rel_tol * max(best_w, 1.0) + abs_tol

        held = np.flatnonzero(ks == self.k) if self.k is not None else []
        if len(held) == 0:
            # first tick, or the candidate grid changed under us
            self.k = best_k
            return Decision(best_k, True, "bootstrap", best_k, best_w,
                            tol, plat.threshold)
        if float(w[held[0]]) <= best_w + tol:
            return Decision(float(self.k), False, "hold", best_k, best_w,
                            tol, plat.threshold)
        self.k = best_k
        return Decision(best_k, True, "left-plateau", best_k, best_w,
                        tol, plat.threshold)


class FaultAwareController(HysteresisController):
    """Plateau hysteresis on the risk-scalarized wait/lost-work frontier.

    Chaos-axis decide: `avg_wait` and `lost` arrive as [K, C] curves
    (candidate k × chaos cell, from `run_window_oracle(chaos=...)`) and
    ``weights`` as the fault-regime estimator's [C] cell weights. The
    controller scalarizes

        cost(k) = Σ_c w_c · wait[k, c]  +  λ · Σ_c w_c · lost[k, c]

    and applies the inherited plateau-band hysteresis to the cost curve:
    hold the committed k while its cost stays inside the 5% plateau band
    of the new cost-best, move only when it leaves. λ (``risk_lambda``)
    prices one unit of expected lost work (the service driver feeds lost
    work in machine-seconds, i.e. chip-seconds / M) in seconds of
    average wait; λ=0 reduces exactly to the fault-blind
    `HysteresisController` on the expected-wait curve (pinned in
    tests/test_torch_service.py).

    [K] inputs (no chaos axis) and ``lost=None`` / ``weights=None``
    (uniform cells, zero lost work) are accepted, so the controller
    degrades gracefully to fault-blind behavior when the oracle has no
    chaos axis to offer. Decision.best_wait then reports the *cost* at
    the cost-best k — the quantity the hysteresis band was applied to —
    not the raw wait (the driver records realized waits separately).

    Closed λ loop (``adapt_lambda=True``): a fixed λ prices lost work for
    a fault regime the operator guessed at configuration time; when the
    environment drifts (MTBF shifts, a straggler storm), the λ·lost term
    either swamps the wait objective or vanishes from it. The adaptive
    mode re-prices online from the *realized* trade the service actually
    lives: the driver feeds every tick's realized (wait, lost) pair to
    `observe_realized`, two EWMAs track their magnitudes, and decide()
    scalarizes with

        λ_t = clip(λ0 · ewm_wait / max(ewm_lost, eps),
                   λ0 / lambda_span, λ0 · lambda_span)

    i.e. λ0 becomes a unitless risk weight — the fraction of the realized
    wait budget the controller keeps trading against lost work — and the
    EWMA ratio converts it to the live price in wait-seconds per
    machine-second. A loss-heavy regime cheapens each unit (the lost term
    stays commensurate with wait instead of drowning it); a quiet regime
    raises the price, deterring risky k while losses are rare. Until the
    first telemetry arrives — and always when ``adapt_lambda=False`` (the
    default) — `live_lambda` is exactly ``risk_lambda``, so the fixed-λ
    controller's decisions are preserved bitwise (pinned in
    tests/test_torch_service.py). Non-finite telemetry is carried
    forward, matching the `FaultRegimeEstimator` hardening.
    """

    name = "fault_aware"
    fault_aware = True      # the driver's dispatch marker (extra operands)

    #: floor for the realized-lost EWMA in the λ ratio (machine-seconds);
    #: keeps a quiet regime's price finite before the span clip applies
    LOST_EPS = 1e-9

    def __init__(self, rel_tol: float = 0.05, abs_tol: float | None = None,
                 risk_lambda: float = 1.0, adapt_lambda: bool = False,
                 lambda_alpha: float = 0.3, lambda_span: float = 10.0):
        super().__init__(rel_tol=rel_tol, abs_tol=abs_tol)
        if risk_lambda < 0:
            raise ValueError(
                f"risk_lambda must be >= 0, got {risk_lambda}")
        if not (0.0 < lambda_alpha <= 1.0):
            raise ValueError(
                f"lambda_alpha must be in (0, 1], got {lambda_alpha}")
        if not (lambda_span >= 1.0):
            raise ValueError(
                f"lambda_span must be >= 1, got {lambda_span}")
        self.risk_lambda = float(risk_lambda)
        self.adapt_lambda = bool(adapt_lambda)
        self.lambda_alpha = float(lambda_alpha)
        self.lambda_span = float(lambda_span)
        self.ewm_wait: float | None = None
        self.ewm_lost: float | None = None

    @property
    def live_lambda(self) -> float:
        """The λ decide() prices lost work with on the next curve."""
        if (not self.adapt_lambda or self.ewm_wait is None
                or self.ewm_lost is None):
            return self.risk_lambda
        ratio = self.ewm_wait / max(self.ewm_lost, self.LOST_EPS)
        return float(np.clip(self.risk_lambda * ratio,
                             self.risk_lambda / self.lambda_span,
                             self.risk_lambda * self.lambda_span))

    def observe_realized(self, wait: float, lost: float) -> None:
        """Fold one tick's realized (avg_wait, lost machine-seconds) pair
        into the λ EWMAs. Non-finite samples are carried forward."""
        a = self.lambda_alpha
        if np.isfinite(wait):
            self.ewm_wait = (float(wait) if self.ewm_wait is None
                             else (1 - a) * self.ewm_wait + a * float(wait))
        if np.isfinite(lost):
            self.ewm_lost = (float(lost) if self.ewm_lost is None
                             else (1 - a) * self.ewm_lost + a * float(lost))

    @staticmethod
    def _expect(name: str, curve, weights: np.ndarray | None) -> np.ndarray:
        """[K] expectation of a [K] or [K, C] curve under the cell weights."""
        arr = np.asarray(curve, np.float64)
        if arr.ndim == 1:
            return arr
        if arr.ndim != 2:
            raise ValueError(
                f"decide() wants a [K] or [K, C] {name} curve, got shape "
                f"{arr.shape}")
        if weights is None:
            return arr.mean(axis=1)
        wts = np.asarray(weights, np.float64)
        if wts.shape != (arr.shape[1],):
            raise ValueError(
                f"weights shape {wts.shape} does not match the {name} "
                f"curve's chaos axis [{arr.shape[1]}]")
        return arr @ wts

    def decide(self, ks, avg_wait, lost=None, weights=None) -> Decision:
        e_wait = self._expect("avg_wait", avg_wait, weights)
        ks, e_wait = _validate_curve(ks, e_wait)
        if lost is None:
            cost = e_wait
        else:
            e_lost = self._expect("lost", lost, weights)
            if e_lost.shape != e_wait.shape:
                raise ValueError(
                    f"lost curve reduces to shape {e_lost.shape}, "
                    f"expected {e_wait.shape}")
            if not np.all(np.isfinite(e_lost)):
                raise ValueError("lost curve contains non-finite values")
            cost = e_wait + self.live_lambda * e_lost
        return self._decide_on_curve(ks, cost)


class NaiveController:
    """Every-tick arg-best commit — the no-hysteresis A/B foil."""

    name = "naive"

    def __init__(self):
        self.k: float | None = None

    def decide(self, ks, avg_wait) -> Decision:
        ks, w = _validate_curve(ks, avg_wait)
        i_best = int(np.argmin(w))
        best_k, best_w = float(ks[i_best]), float(w[i_best])
        plat = plateau_threshold(ks, w)
        moved = self.k is None or best_k != self.k
        reason = "bootstrap" if self.k is None else "argbest"
        self.k = best_k
        return Decision(best_k, moved, reason, best_k, best_w, 0.0,
                        plat.threshold)
