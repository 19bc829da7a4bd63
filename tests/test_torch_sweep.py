"""The whole ported path: `run_packet_grid(device="cpu")` of the port.

  * against the reference's ``run_packet_grid(step_impl="pallas",
    mode="fused")`` on a 4 x 3 grid, both dtypes: `n_groups`, `ok`,
    `budget_exhausted` and the integer counters equal; float metrics rtol
    1e-6 (float32) / 1e-12 (float64);
  * fused equals chunked exactly inside the port;
  * against tests/golden/golden_metrics.json (`packet` block, float64,
    rtol 1e-9 over max(|golden|, floor): the tolerance and floors of
    tests/test_golden_metrics.py);
  * `plateau_threshold` equal to the reference's on the same curve;
  * `sweep_plan` / `resolve_mode` take the reference's arguments, and the
    plan equals the reference's on the keys they share, chaos block
    included.
"""
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

from repro_torch.core import des as tdes
from repro_torch.core import sweep as tsweep
from repro_torch.core.metrics import METRIC_REL_FLOORS, SCALAR_METRIC_FIELDS
from repro_torch.workload.lublin import WorkloadParams, generate_workload
from test_torch_reference import load_reference

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "golden_metrics.json")
KS = (0.5, 2.0, 20.0, 200.0)
S_PROPS = (0.05, 0.3, 0.5)
WORKLOADS = {
    "hetero": dict(n_jobs=200, nodes=96, load=0.9, homogeneous=False,
                   seed=17),
    "homog": dict(n_jobs=200, nodes=48, load=0.9, homogeneous=True, seed=18,
                  daily_amplitude=0.3),
}
RTOL = {np.dtype(np.float32): 1e-6, np.dtype(np.float64): 1e-12}
INT_FIELDS = ("n_groups", "ok", "failures", "straggler_kills", "requeues",
              "requeued_jobs", "budget_exhausted")


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def port_grid(name, dtype, **kw):
    wl = generate_workload(WorkloadParams(**WORKLOADS[name]))
    return tsweep.run_packet_grid(wl, ks=KS, s_props=S_PROPS, dtype=dtype,
                                  device="cpu", **kw)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_grid_against_reference(ref, name, dtype):
    wl = generate_workload(WorkloadParams(**WORKLOADS[name]))
    want = ref.core.run_packet_grid(wl, ks=KS, s_props=S_PROPS, dtype=dtype,
                                    mode="fused", step_impl="pallas")
    got = port_grid(name, dtype, mode="fused")
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert g.shape == (len(KS), len(S_PROPS)) and g.dtype == w.dtype, f
        if f in INT_FIELDS:
            assert np.array_equal(g, w), f
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL[np.dtype(dtype)],
                                       atol=0, err_msg=f)
    assert got.ok.all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("name", list(WORKLOADS))
@pytest.mark.parametrize("chunk_lanes", [5, 12])
def test_fused_equals_chunked_exactly(name, dtype, chunk_lanes):
    fused = port_grid(name, dtype, mode="fused")
    chunked = port_grid(name, dtype, mode="chunked", chunk_lanes=chunk_lanes)
    for f in fused._fields:
        assert np.array_equal(getattr(fused, f), getattr(chunked, f)), f
    auto = port_grid(name, dtype)      # mode="auto" is the fused layout
    assert np.array_equal(auto.avg_wait, fused.avg_wait)


@pytest.mark.parametrize("name", list(WORKLOADS))
@pytest.mark.parametrize("mode", ["fused", "chunked"])
def test_against_golden_float64(golden, name, mode):
    spec = golden["spec"]
    assert tuple(spec["ks"]) == KS and tuple(spec["s_props"]) == S_PROPS
    assert spec["workloads"][name] == {"daily_amplitude": 0.6,
                                       **WORKLOADS[name]}
    got = port_grid(name, np.float64, mode=mode)
    want = golden["grids"][name]["packet"]
    for f in SCALAR_METRIC_FIELDS:
        g, w = getattr(got, f), np.asarray(want[f], np.float64)
        rel = np.abs(g - w) / np.maximum(np.abs(w), METRIC_REL_FLOORS[f])
        assert rel.max() <= 1e-9, (f, rel.max())
    assert got.n_groups.astype(int).tolist() == want["n_groups"]
    assert got.ok.all()


def test_float32_forms_the_golden_groups(golden):
    """The golden grid is decision-flip-free: float32 schedules match."""
    for name in WORKLOADS:
        got = port_grid(name, np.float32)
        assert got.n_groups.astype(int).tolist() == \
            golden["grids"][name]["packet"]["n_groups"]


@pytest.mark.parametrize("case", range(6))
def test_plateau_threshold_equals_reference(ref, case):
    rng = np.random.default_rng(case)
    ks = np.asarray(tsweep.PAPER_SCALE_RATIOS)
    curve = 500.0 + 4e4 * np.exp(-ks / rng.uniform(0.5, 30.0)) + \
        rng.normal(0, 5.0, ks.shape)
    if case % 2:
        perm = rng.permutation(len(ks))
        ks, curve = ks[perm], curve[perm]
    kw = {} if case < 4 else dict(rel_tol=0.01, abs_tol=0.5, plateau_tail=3)
    got = tsweep.plateau_threshold(ks, curve, **kw)
    want = ref.sweep.plateau_threshold(ks, curve, **kw)
    assert tuple(got) == tuple(want)
    assert type(got).__name__ == "PlateauResult"


def test_plateau_threshold_on_a_real_curve(ref):
    got = port_grid("homog", np.float64)
    a = tsweep.plateau_threshold(KS, got.avg_wait[:, 0])
    b = ref.sweep.plateau_threshold(KS, got.avg_wait[:, 0])
    assert tuple(a) == tuple(b) and np.isfinite(a.plateau)


def test_plateau_threshold_rejects_bad_input():
    with pytest.raises(ValueError, match="equal-length"):
        tsweep.plateau_threshold([1.0, 2.0], [1.0])
    with pytest.raises(ValueError, match="at least one"):
        tsweep.plateau_threshold([], [])


def test_paper_axes_match_reference(ref):
    assert tsweep.PAPER_SCALE_RATIOS == ref.sweep.PAPER_SCALE_RATIOS
    assert tsweep.PAPER_INIT_PROPS == ref.sweep.PAPER_INIT_PROPS
    assert tsweep.CHUNK_LANES == ref.sweep.CHUNK_LANES
    assert tsweep.FLOAT32_AVG_WAIT_RTOL == ref.sweep.FLOAT32_AVG_WAIT_RTOL
    assert len(tsweep.PAPER_SCALE_RATIOS) * len(tsweep.PAPER_INIT_PROPS) == 222


def test_lane_order_matches_reference(ref):
    rng = np.random.default_rng(0)
    k, s = rng.uniform(0.1, 1000, 50), rng.uniform(1, 4000, 50)
    assert np.array_equal(tsweep.lane_order(k, s), ref.sweep.lane_order(k, s))
    assert np.array_equal(tsweep.predicted_lane_events(k, s),
                          ref.sweep.predicted_lane_events(k, s))


def test_budget_policies():
    wl = generate_workload(WorkloadParams(**WORKLOADS["homog"]))
    m = tsweep.run_packet_grid(wl, ks=KS, s_props=S_PROPS, device="cpu")
    bad = m._replace(budget_exhausted=np.array(
        [[True, False, False]] + [[False] * 3] * 3))
    with pytest.raises(RuntimeError, match=r"i_k=0, i_s=0, k=0.5, s_prop=0.05"):
        tsweep._enforce_budget(bad, "raise", "grid", KS, S_PROPS)
    with pytest.warns(RuntimeWarning, match="1 lane"):
        tsweep._enforce_budget(bad, "warn", "grid", KS, S_PROPS)
    tsweep._enforce_budget(bad, "ignore", "grid")
    tsweep._enforce_budget(m, "raise", "grid")        # nothing exhausted
    with pytest.raises(ValueError, match="on_budget_exhausted"):
        tsweep._enforce_budget(m, "explode", "grid")
    assert tsweep._format_budget_cells(np.array([False, True])) == "(lane=1)"


def test_sweep_plan_records_what_ran():
    plan = tsweep.sweep_plan("auto", 222, dtype=np.float64, device="cpu")
    assert plan["mode"] == "fused" and plan["requested_mode"] == "auto"
    assert plan["step_impl"] == "torch" and plan["device_name"] == "cpu"
    assert plan["dtype"] == "float64" and plan["n_lanes"] == 222
    assert tsweep.sweep_plan("chunked", 8, device="cpu")["chunk_lanes"] == 64


# the keys the port's plan shares with the reference's; "step_impl" names
# another engine on each side, and "auto" resolves to "fused" in the port
# at every lane count (ROADMAP.md, deliberate differences); "n_devices"
# and "lane_pad" at world size 1, one JAX device here
PLAN_SHARED_KEYS = ("requested_mode", "mode", "n_lanes", "n_workloads",
                    "total_experiments", "chunk_lanes", "n_devices",
                    "lane_pad")
PLAN_CHAOS = {
    "none": None,
    "inert": dict(),
    "scalar": dict(mtbf_chip_hours=50.0, straggler_prob=0.05, seed=3),
    # benchmarks/paper_sweep.py's 8-cell fault axis
    "axis8": dict(mtbf_chip_hours=np.repeat([50.0, 200.0], 4),
                  straggler_prob=np.tile([0.0, 0.05], 4),
                  ckpt_period=np.tile([300.0, 300.0, 600.0, 600.0], 2),
                  seed=11, max_requeues=40),
}


@pytest.mark.parametrize("chaos", list(PLAN_CHAOS), ids=list(PLAN_CHAOS))
@pytest.mark.parametrize("mode,n_workloads", [("fused", 1), ("chunked", 3)])
def test_sweep_plan_takes_the_reference_call(ref, chaos, mode, n_workloads):
    """paper_sweep.py's own call, ``sweep_plan(mode, n_grid, w,
    chaos=chaos)``, gives the reference's plan on the shared keys and its
    chaos block (absent for no chaos and for an inert config)."""
    kw = PLAN_CHAOS[chaos]
    tchaos = None if kw is None else tdes.ChaosConfig(**kw)
    jchaos = None if kw is None else ref.des.ChaosConfig(**kw)
    got = tsweep.sweep_plan(mode, 222, n_workloads, chaos=tchaos,
                            device="cpu")
    want = ref.sweep.sweep_plan(mode, 222, n_workloads, chaos=jchaos)
    assert {k: got[k] for k in PLAN_SHARED_KEYS} == \
        {k: want[k] for k in PLAN_SHARED_KEYS}
    assert got.get("chaos") == want.get("chaos")
    assert ("chaos" in got) == (chaos in ("scalar", "axis8"))
    assert got["layout"] == [n_workloads, got["n_lanes"]]
    assert got["n_lanes"] == 222 * (8 if chaos == "axis8" else 1)


def test_resolve_mode_takes_step_impl_fourth(ref):
    assert tsweep.resolve_mode("auto", 222, 1, "cuda") == "fused"
    assert tsweep.resolve_mode("seq", 222, 3, "torch") == "seq"
    assert tsweep.resolve_mode("chunked", 8, 1, None) == "chunked"
    with pytest.raises(ValueError, match="unknown step_impl"):
        tsweep.resolve_mode("fused", 222, 1, "pallas")
    with pytest.raises(ValueError, match="unknown step_impl"):
        tsweep.sweep_plan("fused", 222, 1, None, "xla", device="cpu")
    # the reference takes the same positions
    assert ref.sweep.resolve_mode("chunked", 8, 1, "xla") == "chunked"
