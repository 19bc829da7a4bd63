"""The port's streaming service against `repro.service`, on the CPU.

  * the hand cases of tests/test_service.py, tests/test_service_faults.py
    and tests/test_adaptive_lambda.py (controllers, monitor, regime
    estimator, `ServiceConfig` / `TickFaults` validation, the degrade
    harness), run through `repro_torch.service`;
  * `run_window_oracle`, ``[K]`` and ``[K, C]``: bitwise the port's own
    grid column, and against the reference's oracle: integer counters
    equal, float metrics within rtol 1e-5 (float32) / 1e-12 (float64),
    the cross-engine bound of tests/test_torch_chaos_grid.py;
  * `run_service` on ``drift_scenarios(n_jobs=600)`` (windows of 150
    jobs, the paper's 37 k's), fault-free and with the 3-cell chaos axis,
    against the reference's `run_service`: every tick's `best_k`,
    `plateau_k` and each controller's realized and committed k, and every
    controller's switch count, equal; realized waits, lost work and
    regrets within the same rtol (with an absolute floor of 1e-6 s for
    regrets, which are differences of near-equal waits).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

from repro_torch.core import des as tdes
from repro_torch.core import sweep as tsweep
from repro_torch.service import (FaultAwareController, FaultRegimeEstimator,
                                 HysteresisController, NaiveController,
                                 ServiceConfig, TickFaults,
                                 default_controllers, run_service)
from repro_torch.service.monitor import RollingMonitor, window_signals
from repro_torch.workload.lublin import WorkloadParams, generate_workload
from repro_torch.workload.windows import (drift_scenarios, drift_workload,
                                          slice_window)
from test_torch_reference import load_reference

KS = np.array([1.0, 2.0, 4.0, 8.0, 16.0])
AXIS = dict(mtbf_chip_hours=np.array([25.0, 100.0, 800.0]),
            ckpt_period=300.0, straggler_prob=0.1,
            straggler_factor=np.array([4.0, 1.5, 1.5]), seed=7)
CHAOS3 = tdes.ChaosConfig(**AXIS)
ORACLE_FIELDS = ("avg_wait", "lost_work", "useful_util", "requeued_jobs",
                 "failures", "requeues", "straggler_kills", "ok")
INT_FIELDS = ("n_groups", "ok", "failures", "straggler_kills", "requeues",
              "requeued_jobs", "budget_exhausted")
FLOAT_FIELDS = ("avg_wait", "med_wait", "avg_qlen", "full_util",
                "useful_util", "avg_run_wait", "lost_work")
RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}
_SERVICE_KW = dict(ks=(0.5, 2.0, 8.0, 40.0), window_jobs=200,
                   mode="chunked", device="cpu")


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _window(n_jobs=250, hi=200, seed=4):
    wl = generate_workload(WorkloadParams(
        n_jobs=n_jobs, nodes=100, load=0.9, homogeneous=True, seed=seed))
    return slice_window(wl, 0, hi)


def _trace(n_jobs=800, segments=4):
    return drift_workload(
        WorkloadParams(n_jobs=n_jobs, nodes=100, load=0.9, homogeneous=True,
                       seed=9, daily_amplitude=0.3),
        loads=[0.9] * segments)


# --------------------------------------------------------------------------
# decide: hand-built curves
# --------------------------------------------------------------------------

class TestHysteresisDecide:
    def test_bootstrap_commits_argbest(self):
        d = HysteresisController().decide(KS, [100.0, 50.0, 10.0, 9.0, 10.0])
        assert d.k == 8.0 and d.moved and d.reason == "bootstrap"
        assert d.best_k == 8.0 and d.best_wait == 9.0

    def test_holds_inside_stable_plateau(self):
        c = HysteresisController()
        c.decide(KS, [100.0, 50.0, 10.0, 9.0, 10.0])
        d = c.decide(KS, [100.0, 50.0, 9.5, 10.0, 9.4])
        assert not d.moved and d.k == 8.0 and d.reason == "hold"
        for w in ([99.0, 48.0, 9.3, 9.6, 9.5], [101.0, 51.0, 9.9, 9.7, 9.6]):
            assert not c.decide(KS, w).moved

    def test_moves_when_leaving_plateau(self):
        c = HysteresisController()
        c.decide(KS, [100.0, 50.0, 10.0, 9.0, 10.0])
        d = c.decide(KS, [100.0, 50.0, 30.0, 25.0, 5.0])
        assert d.moved and d.k == 16.0 and d.reason == "left-plateau"

    def test_grid_change_rebootstraps(self):
        c = HysteresisController()
        c.decide(KS, [5.0, 4.0, 3.0, 2.0, 1.0])
        d = c.decide(KS * 10, [5.0, 4.0, 3.0, 2.0, 1.0])
        assert d.reason == "bootstrap" and d.k == 160.0

    @pytest.mark.parametrize("ks,w", [
        (KS, [1.0, 2.0]), ([], []), (KS, [1.0, 2.0, np.nan, 4.0, 5.0])])
    def test_validation(self, ks, w):
        with pytest.raises(ValueError):
            HysteresisController().decide(ks, w)

    def test_negative_tolerance_raises(self):
        with pytest.raises(ValueError, match="rel_tol"):
            HysteresisController(rel_tol=-0.1)

    def test_zero_tolerance_degenerates_to_naive(self):
        strict = HysteresisController(rel_tol=0.0, abs_tol=0.0)
        naive = NaiveController()
        for w in ([3.0, 2.0, 1.0, 2.0, 3.0], [3.0, 2.0, 1.5, 1.0, 3.0],
                  [1.0, 2.0, 3.0, 4.0, 5.0]):
            assert strict.decide(KS, w).k == naive.decide(KS, w).k

    def test_naive_switches_whenever_argbest_moves(self):
        c = NaiveController()
        assert c.decide(KS, [3.0, 2.0, 1.0, 2.0, 3.0]).k == 4.0
        d = c.decide(KS, [3.0, 2.0, 1.01, 1.0, 3.0])
        assert d.moved and d.k == 8.0 and d.reason == "argbest"
        assert not c.decide(KS, [3.0, 2.0, 1.5, 1.0, 3.0]).moved

    def test_decisions_equal_the_reference_controllers(self, ref):
        curves = ([100.0, 50.0, 10.0, 9.0, 10.0], [100.0, 50.0, 9.5, 10.0,
                  9.4], [100.0, 50.0, 30.0, 25.0, 5.0], [7.0, 6.0, 6.1, 6.2,
                  6.05])
        pairs = [(HysteresisController(), ref.service.HysteresisController()),
                 (NaiveController(), ref.service.NaiveController())]
        for mine, theirs in pairs:
            for w in curves:
                assert tuple(mine.decide(KS, w)) == tuple(theirs.decide(KS, w))


class TestFaultAwareDecide:
    WAIT2 = np.array([[100.0, 110.0], [10.0, 11.0],
                      [10.2, 11.2], [10.4, 11.4]])
    LOST2 = np.array([[900.0, 1800.0], [40.0, 80.0],
                      [20.0, 40.0], [1.0, 2.0]])
    KS4 = np.array([1.0, 4.0, 8.0, 16.0])
    W = np.array([0.5, 0.5])

    def test_lambda_zero_is_fault_blind_on_expected_wait(self):
        w = np.array([0.25, 0.75])
        fa = FaultAwareController(risk_lambda=0.0)
        fb = HysteresisController()
        for c in (self.WAIT2, self.WAIT2[:, ::-1], self.WAIT2 * 1.5):
            assert (fa.decide(self.KS4, c, lost=self.LOST2, weights=w).k
                    == fb.decide(self.KS4, c @ w).k)

    def test_high_lambda_leaves_plateau_toward_low_lost(self):
        assert HysteresisController().decide(
            self.KS4, self.WAIT2 @ self.W).k == 4.0
        fa = FaultAwareController(risk_lambda=1.0)
        d = fa.decide(self.KS4, self.WAIT2, lost=self.LOST2, weights=self.W)
        assert d.k == 16.0 and d.reason == "bootstrap"
        d2 = fa.decide(self.KS4, self.WAIT2 * 1.001, lost=self.LOST2,
                       weights=self.W)
        assert not d2.moved and d2.reason == "hold"

    def test_weights_shift_the_expectation(self):
        calm = FaultAwareController(risk_lambda=0.2).decide(
            self.KS4, self.WAIT2, lost=self.LOST2, weights=np.array([1.0, 0]))
        harsh = FaultAwareController(risk_lambda=0.2).decide(
            self.KS4, self.WAIT2, lost=self.LOST2, weights=np.array([0, 1.0]))
        assert harsh.best_wait > calm.best_wait

    def test_1d_and_default_inputs_accepted(self):
        assert FaultAwareController().decide(
            KS, [100.0, 50.0, 10.0, 9.0, 10.0]).k == 8.0
        assert FaultAwareController().decide(self.KS4, self.WAIT2).k == 4.0

    def test_validation(self):
        fa = FaultAwareController()
        with pytest.raises(ValueError, match="chaos axis"):
            fa.decide(self.KS4, self.WAIT2, weights=np.ones(3))
        with pytest.raises(ValueError, match=r"\[K\] or \[K, C\]"):
            fa.decide(self.KS4, self.WAIT2[:, :, None])
        with pytest.raises(ValueError, match="non-finite"):
            fa.decide(self.KS4, self.WAIT2, lost=self.LOST2 * np.nan,
                      weights=self.W)
        with pytest.raises(ValueError, match="risk_lambda"):
            FaultAwareController(risk_lambda=-0.5)
        with pytest.raises(ValueError, match="lambda_alpha"):
            FaultAwareController(lambda_alpha=0.0)
        with pytest.raises(ValueError, match="lambda_span"):
            FaultAwareController(lambda_span=0.5)

    def test_adaptive_lambda_hand_sequence(self):
        fa = FaultAwareController(risk_lambda=0.5, adapt_lambda=True,
                                  lambda_alpha=0.25, lambda_span=100.0)
        assert fa.live_lambda == 0.5
        fa.observe_realized(200.0, 40.0)
        assert fa.live_lambda == pytest.approx(0.5 * 200.0 / 40.0)
        fa.observe_realized(100.0, 80.0)
        assert fa.ewm_wait == pytest.approx(0.75 * 200.0 + 0.25 * 100.0)
        assert fa.ewm_lost == pytest.approx(0.75 * 40.0 + 0.25 * 80.0)
        lam = fa.live_lambda
        fa.observe_realized(float("nan"), float("nan"))
        assert fa.live_lambda == lam

    def test_adaptive_lambda_span_clip_and_flip(self):
        hi = FaultAwareController(risk_lambda=2.0, adapt_lambda=True,
                                  lambda_span=5.0)
        hi.observe_realized(1000.0, 0.0)
        assert hi.live_lambda == 10.0
        lo = FaultAwareController(risk_lambda=2.0, adapt_lambda=True,
                                  lambda_span=5.0)
        lo.observe_realized(1.0, 1e6)
        assert lo.live_lambda == 0.4
        quiet = FaultAwareController(adapt_lambda=True, lambda_span=1000.0)
        drenched = FaultAwareController(adapt_lambda=True, lambda_span=1000.0)
        quiet.observe_realized(10.0, 10.0)
        drenched.observe_realized(1.0, 500.0)
        assert quiet.decide(self.KS4, self.WAIT2, lost=self.LOST2,
                            weights=self.W).k == 16.0
        assert drenched.decide(self.KS4, self.WAIT2, lost=self.LOST2,
                               weights=self.W).k == 4.0

    def test_fixed_lambda_ignores_telemetry(self):
        fixed = FaultAwareController(risk_lambda=0.1)
        fed = FaultAwareController(risk_lambda=0.1)
        rng = np.random.default_rng(3)
        for _ in range(6):
            scale = 1.0 + 0.3 * float(rng.standard_normal())
            assert (fixed.decide(self.KS4, self.WAIT2 * scale,
                                 lost=self.LOST2, weights=self.W)
                    == fed.decide(self.KS4, self.WAIT2 * scale,
                                  lost=self.LOST2, weights=self.W))
            fed.observe_realized(float(rng.uniform(1, 1e4)),
                                 float(rng.uniform(0, 1e4)))
        assert fed.live_lambda == 0.1


# --------------------------------------------------------------------------
# monitor and regime estimator
# --------------------------------------------------------------------------

def _signals(lo=0, hi=150, seed=2):
    wl = generate_workload(WorkloadParams(
        n_jobs=300, nodes=100, load=0.9, homogeneous=True, seed=seed))
    return window_signals(slice_window(wl, lo, hi), 0.05)


class TestMonitor:
    def test_window_signals_equal_the_reference(self, ref):
        wl = generate_workload(WorkloadParams(
            n_jobs=300, nodes=100, load=0.9, homogeneous=True, seed=2))
        win = slice_window(wl, 50, 250)
        sig = window_signals(win, 0.05)
        assert tuple(sig) == tuple(ref.service.window_signals(win, 0.05))
        assert sig.n_jobs == 200
        assert sig.arrival_rate == pytest.approx(200 / sig.span)
        assert sig.init_time == win.init_time_for_proportion(0.05)

    def test_empty_window_raises(self):
        win = _window()
        empty = win.__class__(**{f: getattr(win, f)[:0] for f in (
            "submit", "runtime", "nodes", "work", "jtype")},
            params=win.params)
        with pytest.raises(ValueError, match="non-empty"):
            window_signals(empty, 0.05)

    def test_rolling_monitor_smooths_and_deltas(self):
        sig, sig2 = _signals(0, 150), _signals(150, 300)
        m = RollingMonitor(alpha=0.5)
        first = m.observe(sig)
        assert first["ewm_offered_load"] == sig.offered_load
        assert first["delta_offered_load"] == 0.0
        second = m.observe(sig2)
        assert second["ewm_offered_load"] == pytest.approx(
            0.5 * sig2.offered_load + 0.5 * sig.offered_load)
        with pytest.raises(ValueError, match="alpha"):
            RollingMonitor(alpha=0.0)

    def test_nan_carries_last_finite_ewma(self):
        m = RollingMonitor(alpha=0.5)
        sig = _signals()
        first = m.observe(sig)
        second = m.observe(sig._replace(offered_load=float("nan"),
                                        init_time=float("inf")))
        assert second["ewm_offered_load"] == first["ewm_offered_load"]
        assert second["ewm_init_time"] == first["ewm_init_time"]
        assert second["delta_offered_load"] == 0.0
        assert set(second["carried"]) == {"offered_load", "init_time"}
        assert "carried" not in m.observe(sig)

    def test_nan_at_bootstrap_raises_named(self):
        with pytest.raises(ValueError, match="offered_load"):
            RollingMonitor().observe(
                _signals()._replace(offered_load=float("nan")))

    def test_reset_and_has_state(self):
        m = RollingMonitor(alpha=0.5)
        assert not m.has_state
        m.observe(_signals())
        assert m.has_state
        m.reset()
        assert not m.has_state
        assert m.observe(_signals(150, 300))["delta_offered_load"] == 0.0

    def test_monitor_equals_the_reference(self, ref):
        mine, theirs = RollingMonitor(0.3), ref.service.RollingMonitor(0.3)
        for lo in (0, 50, 150):
            sig = _signals(lo, lo + 150)
            assert mine.observe(sig) == theirs.observe(sig)


class TestFaultRegimeEstimator:
    def test_uniform_before_any_observation(self):
        w = FaultRegimeEstimator().weights({"failures": [10.0, 1.0, 0.1]})
        np.testing.assert_allclose(w, [1 / 3] * 3)

    def test_concentrates_on_matching_cell(self):
        est = FaultRegimeEstimator(alpha=1.0, temperature=0.25)
        est.observe(failures=10.0, requeues=12.0, lost_work=5000.0)
        w = est.weights({"failures": np.array([10.0, 1.0, 0.0]),
                         "requeues": np.array([12.0, 2.0, 0.0]),
                         "lost_work": np.array([5000.0, 400.0, 0.0])})
        assert int(np.argmax(w)) == 0 and w[0] > 0.9 and w[1] > w[2]
        assert w.sum() == pytest.approx(1.0)

    def test_ewma_math_and_regime_shift(self):
        est = FaultRegimeEstimator(alpha=0.5)
        est.observe(10.0, 0.0, 0.0)
        assert est.observe(20.0, 0.0, 0.0)["ewm_failures"] == 15.0
        cells = {"failures": np.array([0.5, 15.0, 40.0])}
        assert int(np.argmax(est.weights(cells))) == 1
        for _ in range(4):
            est.observe(40.0, 0.0, 0.0)
        assert int(np.argmax(est.weights(cells))) == 2

    def test_temperature_sets_concentration(self):
        cells = {"failures": np.array([10.0, 5.0, 0.0])}
        sharp = FaultRegimeEstimator(temperature=0.01)
        flat = FaultRegimeEstimator(temperature=100.0)
        for est in (sharp, flat):
            est.observe(10.0, 0.0, 0.0)
        assert sharp.weights(cells)[0] > 0.999
        np.testing.assert_allclose(flat.weights(cells), 1 / 3, atol=0.01)

    def test_nan_telemetry_carries_forward(self):
        est = FaultRegimeEstimator(alpha=0.5)
        est.observe(10.0, 2.0, 100.0)
        out = est.observe(float("nan"), float("inf"), 200.0)
        assert set(out["carried"]) == {"failures", "requeues"}
        assert out["ewm_failures"] == 10.0 and out["ewm_lost_work"] == 150.0
        assert est.n_carried == 2

    def test_never_observed_signal_degrades_to_uniform(self):
        est = FaultRegimeEstimator()
        out = est.observe(float("nan"), float("nan"), float("nan"))
        assert len(out["carried"]) == 3 and "ewm_failures" not in out
        np.testing.assert_allclose(est.weights(
            {"failures": np.array([1.0, 2.0])}), [0.5, 0.5])

    def test_mismatched_cells_raise_named(self):
        est = FaultRegimeEstimator()
        est.observe(1.0, 1.0, 1.0)
        with pytest.raises(ValueError, match="failures"):
            est.weights({"failures": np.array([1.0, 2.0]),
                         "requeues": np.array([1.0, 2.0, 3.0])})
        with pytest.raises(ValueError, match="non-empty"):
            est.weights({})

    def test_reset_and_validation(self):
        est = FaultRegimeEstimator()
        est.observe(float("nan"), 1.0, 1.0)
        assert est.has_state and est.n_carried == 1
        est.reset()
        assert not est.has_state and est.n_carried == 0
        with pytest.raises(ValueError, match="alpha"):
            FaultRegimeEstimator(alpha=0.0)
        with pytest.raises(ValueError, match="temperature"):
            FaultRegimeEstimator(temperature=0.0)

    def test_weights_equal_the_reference(self, ref):
        mine = FaultRegimeEstimator(alpha=0.4, temperature=0.3)
        theirs = ref.service.FaultRegimeEstimator(alpha=0.4, temperature=0.3)
        cells = {"failures": np.array([9.0, 3.0, 0.5]),
                 "lost_work": np.array([800.0, 90.0, 4.0])}
        for obs in ((4.0, 5.0, 300.0), (8.0, 9.0, 700.0),
                    (float("nan"), 2.0, 50.0)):
            assert mine.observe(*obs) == theirs.observe(*obs)
            assert np.array_equal(mine.weights(cells), theirs.weights(cells))


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

class TestServiceConfigValidation:
    BAD = [dict(window_jobs=0), dict(stride_jobs=0), dict(s_prop=0.0),
           dict(dtype="float16"), dict(dtype="int32"), dict(mode="vmap_k"),
           dict(mode="warp"), dict(rel_tol=-0.01), dict(abs_tol=-1.0),
           dict(ewm_alpha=0.0), dict(ewm_alpha=1.5),
           dict(on_budget_exhausted="explode"), dict(risk_lambda=-1.0),
           dict(fault_alpha=0.0), dict(fault_temperature=0.0),
           dict(max_consecutive_degraded=0), dict(ks=()),
           dict(chaos=CHAOS3, chaos_env_cell=3),
           dict(chaos=CHAOS3, chaos_env_cell=-1),
           dict(chaos=tdes.ChaosConfig())]

    @pytest.mark.parametrize("kw", BAD,
                             ids=[str(sorted(b.items()))[:40] for b in BAD])
    def test_bad_field_raises(self, kw):
        with pytest.raises(ValueError):
            ServiceConfig(**kw)

    def test_good_configs_construct(self):
        assert ServiceConfig().device is None
        cfg = ServiceConfig(chaos=CHAOS3, chaos_env_cell=2,
                            on_budget_exhausted="degrade", device="cpu")
        assert cfg.n_chaos_cells == 3

    def test_tick_faults_validation(self):
        tf = TickFaults(exhaust_budget=[2, 1], nan_telemetry={3})
        assert tf.exhaust_budget == frozenset({1, 2})
        with pytest.raises(ValueError, match="non-negative"):
            TickFaults(exhaust_budget=[-1])
        with pytest.raises(ValueError, match="iterable"):
            TickFaults(drop_telemetry="012")

    def test_default_device_is_the_card(self, monkeypatch):
        import torch
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_service(_trace(), ServiceConfig(ks=(1.0,), window_jobs=200))


# --------------------------------------------------------------------------
# the window oracle
# --------------------------------------------------------------------------

def _oracle(win, ks, dtype=np.float32, **kw):
    pw = tdes.pack_workload(win, dtype, device="cpu")
    return tsweep.run_window_oracle(pw, ks, win.init_time_for_proportion(
        0.05), win.params.nodes, device="cpu", **kw)


class TestWindowOracle:
    KS4 = (0.5, 2.0, 8.0, 40.0)

    @pytest.mark.parametrize("mode", ["chunked", "fused", "seq"])
    def test_matches_the_grid_column_bitwise(self, mode):
        win = _window()
        grid = tsweep.run_packet_grid(win, ks=self.KS4, s_props=[0.05],
                                      mode=mode, device="cpu")
        m = _oracle(win, self.KS4, mode=mode)
        for f in m._fields:
            a, b = getattr(m, f), getattr(grid, f)
            assert a.shape == (len(self.KS4),)
            assert np.array_equal(a, b[:, 0]), f

    @pytest.mark.parametrize("dtype", [np.float32, np.float64],
                             ids=["float32", "float64"])
    def test_chaos_block_matches_the_grid_column_bitwise(self, dtype):
        win = _window()
        grid = tsweep.run_packet_grid(win, ks=self.KS4, s_props=[0.05],
                                      dtype=dtype, mode="chunked",
                                      chunk_lanes=5, chaos=CHAOS3,
                                      device="cpu")
        m = _oracle(win, self.KS4, dtype, mode="fused", chaos=CHAOS3)
        for f in m._fields:
            a, b = getattr(m, f), getattr(grid, f)
            assert a.shape == (len(self.KS4), 3), f
            assert np.array_equal(a, b[:, 0, :]), f

    def test_chaos_layouts_agree_bitwise(self):
        win = _window()
        outs = [_oracle(win, self.KS4, mode=mode, chaos=CHAOS3)
                for mode in ("seq", "chunked", "fused")]
        for f in ORACLE_FIELDS:
            for other in outs[1:]:
                assert np.array_equal(getattr(outs[0], f),
                                      getattr(other, f)), f

    @pytest.mark.parametrize("chaos", [False, True], ids=["plain", "chaos"])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64],
                             ids=["float32", "float64"])
    def test_against_the_reference_oracle(self, ref, dtype, chaos):
        win = _window()
        s = win.init_time_for_proportion(0.05)
        kw = {}
        if chaos:
            kw = dict(chaos=ref.des.ChaosConfig(**AXIS))
        with ref.precision.dtype_scope(dtype):
            pw = ref.des.pack_workload(win, dtype)
        want = ref.sweep.run_window_oracle(pw, self.KS4, s, win.params.nodes,
                                           mode="fused", **kw)
        got = _oracle(win, self.KS4, dtype, mode="fused",
                      chaos=CHAOS3 if chaos else None)
        if chaos:
            assert np.asarray(want.failures).sum() > 0
        for f in INT_FIELDS:
            w = np.asarray(getattr(want, f))
            assert getattr(got, f).shape == w.shape, f
            assert np.array_equal(getattr(got, f), w), f
        for f in FLOAT_FIELDS:
            np.testing.assert_allclose(getattr(got, f),
                                       np.asarray(getattr(want, f)), atol=0,
                                       rtol=RTOL[np.dtype(dtype)], err_msg=f)

    def test_inert_chaos_is_the_fault_free_program(self):
        win = _window()
        base = _oracle(win, KS, mode="chunked")
        inert = _oracle(win, KS, mode="chunked", chaos=tdes.ChaosConfig())
        assert all(np.array_equal(a, b) for a, b in zip(base, inert))
        assert base.avg_wait.shape == (len(KS),)

    def test_scalar_active_chaos_keeps_1d_leaves(self):
        m = _oracle(_window(), (2.0, 8.0), mode="chunked",
                    chaos=tdes.ChaosConfig(mtbf_chip_hours=50.0))
        assert m.avg_wait.shape == (2,) and m.failures.sum() > 0

    def test_rejects_grid_layouts_and_empty_ks(self):
        wl = generate_workload(WorkloadParams(
            n_jobs=50, nodes=20, load=0.9, homogeneous=True, seed=4))
        pw = tdes.pack_workload(wl, device="cpu")
        with pytest.raises(ValueError, match="grid layout"):
            tsweep.run_window_oracle(pw, (1.0,), 10.0, 20, mode="vmap_k",
                                     device="cpu")
        with pytest.raises(ValueError, match="at least one candidate"):
            tsweep.run_window_oracle(pw, (), 10.0, 20, device="cpu")

    def test_budget_message_names_the_chaos_cell(self):
        bad = np.zeros((4, 3), bool)
        bad[2, 1] = True
        m = tsweep.Metrics(*([None] * 13), budget_exhausted=bad)
        with pytest.raises(RuntimeError, match=r"run_window_oracle: 1 "
                           r"lane\(s\) .*\(i_k=2, i_chaos=1, k=8\)"):
            tsweep._enforce_budget(m, "raise", "run_window_oracle",
                                   self.KS4, axis_names=("i_k", "i_chaos"))


# --------------------------------------------------------------------------
# the loop: invariants and the degrade harness
# --------------------------------------------------------------------------

class TestRunService:
    @pytest.fixture(scope="class")
    def result(self):
        config = ServiceConfig(**_SERVICE_KW)
        return run_service(_trace(600, 3), config,
                           default_controllers(config))

    def test_tick_count_and_shapes(self, result):
        assert result["n_ticks"] == 3 and len(result["oracle"]["best_k"]) == 3
        assert set(result["controllers"]) == {"hysteresis", "naive"}
        assert result["config"]["device"] == "cpu"

    def test_regret_nonnegative_by_construction(self, result):
        for name, s in result["controllers"].items():
            assert s["mean_regret_wait"] >= -1e-12, name
            assert s["mean_regret_useful"] >= -1e-12, name

    def test_one_tick_actuation_delay(self, result):
        for name in result["controllers"]:
            for prev, cur in zip(result["ticks"], result["ticks"][1:]):
                assert (cur["controllers"][name]["realized_k"]
                        == prev["controllers"][name]["committed_k"]), name

    def test_hysteresis_never_switches_more_than_naive(self, result):
        h = result["controllers"]["hysteresis"]
        assert h["switches"] <= 1
        assert h["switches"] <= result["controllers"]["naive"]["switches"]

    def test_provenance_recorded(self, result):
        t = result["ticks"][0]
        assert {"signals", "oracle_ms", "best_k", "plateau_k"} <= set(t)
        assert t["controllers"]["hysteresis"]["reason"] == "bootstrap"

    def test_too_short_trace_raises(self):
        with pytest.raises(ValueError, match="no full"):
            run_service(_trace(600, 3), ServiceConfig(window_jobs=10_000,
                                                      device="cpu"))

    def test_duplicate_controller_names_rejected(self):
        with pytest.raises(ValueError, match="unique"):
            run_service(_trace(600, 3),
                        ServiceConfig(ks=(1.0, 2.0), window_jobs=200,
                                      device="cpu"),
                        [NaiveController(), NaiveController()])


class TestDegradeHarness:
    def test_raise_policy_names_tick_and_window(self):
        with pytest.raises(RuntimeError, match=r"tick 1 .*\[200, 400\)"):
            run_service(_trace(), ServiceConfig(**_SERVICE_KW),
                        tick_faults=TickFaults(exhaust_budget={1}))

    def test_warn_policy_completes_with_context(self):
        config = ServiceConfig(on_budget_exhausted="warn", **_SERVICE_KW)
        with pytest.warns(RuntimeWarning, match="tick 1"):
            out = run_service(_trace(), config,
                              tick_faults=TickFaults(exhaust_budget={1}))
        assert out["n_ticks"] == 4 and out["n_degraded_ticks"] == 0
        assert out["health"][1]["budget_warned"]

    def test_degrade_policy_completes_every_tick(self):
        config = ServiceConfig(on_budget_exhausted="degrade", **_SERVICE_KW)
        out = run_service(_trace(), config,
                          tick_faults=TickFaults(exhaust_budget={1}))
        assert out["n_ticks"] == 4 and out["n_degraded_ticks"] == 1
        bad = out["ticks"][1]
        assert bad["degraded"] and "best_k" not in bad
        for name, c in bad["controllers"].items():
            assert c["reason"] == "degraded-hold"
            assert (c["realized_k"]
                    == out["ticks"][0]["controllers"][name]["committed_k"])
        for s in out["controllers"].values():
            assert s["n_ticks"] == 3 and len(s["k_trajectory"]) == 4

    def test_degraded_bootstrap_and_bounded_retry(self):
        config = ServiceConfig(on_budget_exhausted="degrade",
                               max_consecutive_degraded=1, **_SERVICE_KW)
        out = run_service(_trace(), config,
                          tick_faults=TickFaults(exhaust_budget={0, 2}))
        for c in out["ticks"][0]["controllers"].values():
            assert c["reason"] == "degraded-bootstrap"
            assert c["realized_k"] == 8.0       # median of (0.5, 2, 8, 40)
        assert out["n_degraded_ticks"] == 2
        with pytest.raises(RuntimeError, match="consecutive degraded"):
            run_service(_trace(), config,
                        tick_faults=TickFaults(exhaust_budget={1, 2}))

    def test_default_output_schema(self):
        out = run_service(_trace(), ServiceConfig(**_SERVICE_KW))
        assert sorted(out) == ["config", "controllers", "n_ticks", "oracle",
                               "ticks"]
        assert "on_budget_exhausted" not in out["config"]
        assert "chaos" not in out["config"]

    def test_nan_and_dropped_telemetry_survive_with_chaos(self):
        config = ServiceConfig(chaos=CHAOS3, on_budget_exhausted="degrade",
                               **_SERVICE_KW)
        out = run_service(_trace(), config, tick_faults=TickFaults(
            nan_telemetry={1}, drop_telemetry={2}, exhaust_budget={3}))
        assert out["n_ticks"] == 4 and out["n_degraded_ticks"] == 1
        t1 = out["ticks"][1]["controllers"]["fault_aware"]
        assert t1["carried_telemetry"] == ["failures", "requeues",
                                           "lost_work"]
        assert out["health"][2]["dropped_telemetry"]
        assert "carried" in out["ticks"][2]["signals"]
        for t in out["ticks"]:
            for c in t["controllers"].values():
                if "weights" in c:
                    w = np.asarray(c["weights"])
                    assert np.all(np.isfinite(w))
                    assert w.sum() == pytest.approx(1.0)


# --------------------------------------------------------------------------
# the loop against the reference's
# --------------------------------------------------------------------------

SCENARIO_JOBS, SCENARIO_WINDOW = 600, 150


@pytest.fixture(scope="module")
def scenarios():
    return drift_scenarios(n_jobs=SCENARIO_JOBS)


def service_pair(ref, wl, dtype="float32", chaos=False):
    kw = dict(window_jobs=SCENARIO_WINDOW, dtype=dtype, risk_lambda=0.1)
    mine = ServiceConfig(device="cpu", chaos=CHAOS3 if chaos else None,
                         **kw)
    theirs = ref.service.ServiceConfig(
        chaos=ref.des.ChaosConfig(**AXIS) if chaos else None, **kw)
    return (run_service(wl, mine, default_controllers(mine)),
            ref.service.run_service(wl, theirs,
                                    ref.service.default_controllers(theirs)))


def close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


def assert_same_service(got, want, dtype):
    rtol = RTOL[np.dtype(dtype)]
    assert got["n_ticks"] == want["n_ticks"] == 4
    assert got["oracle"]["best_k"] == want["oracle"]["best_k"]
    assert got["oracle"]["plateau_k"] == want["oracle"]["plateau_k"]
    for tg, tw in zip(got["ticks"], want["ticks"]):
        assert tg["signals"] == tw["signals"]
        close(tg["best_wait"], tw["best_wait"], rtol)
        for name, cw in tw["controllers"].items():
            cg = tg["controllers"][name]
            for key in ("realized_k", "committed_k", "moved", "reason"):
                assert cg[key] == cw[key], (tg["tick"], name, key)
            for key in ("weights", "realized_lost", "risk_lambda"):
                if key in cw:
                    close(cg[key], cw[key], rtol, atol=1e-9)
    assert list(got["controllers"]) == list(want["controllers"])
    for name, sw in want["controllers"].items():
        sg = got["controllers"][name]
        assert sg["switches"] == sw["switches"], name
        assert sg["k_trajectory"] == sw["k_trajectory"], name
        for key in ("mean_realized_wait", "total_lost_work",
                    "mean_realized_lost"):
            if key in sw:
                close(sg[key], sw[key], rtol, atol=1e-9)
        for key in ("total_regret_wait", "mean_regret_useful",
                    "mean_wait_vs_plateau"):
            close(sg[key], sw[key], rtol, atol=1e-6)


@pytest.mark.parametrize("name", ["steady", "intensity_ramp",
                                  "intensity_step", "homogeneity_ramp",
                                  "homogeneity_step"])
def test_run_service_fault_free_equals_the_reference(ref, scenarios, name):
    got, want = service_pair(ref, scenarios[name])
    assert_same_service(got, want, np.float32)


@pytest.mark.parametrize("name", ["intensity_step", "homogeneity_step"])
def test_run_service_with_chaos_equals_the_reference(ref, scenarios, name):
    got, want = service_pair(ref, scenarios[name], chaos=True)
    assert "fault_aware" in got["controllers"]
    assert_same_service(got, want, np.float32)


def test_run_service_float64_equals_the_reference(ref, scenarios):
    got, want = service_pair(ref, scenarios["intensity_step"], "float64",
                             chaos=True)
    assert got["config"]["dtype"] == "float64"
    assert_same_service(got, want, np.float64)
