"""The workload axis of the port: `repro_torch.core.cohort`,
`run_cohort_grid` and the event step's cohort dispatch, on the CPU.

  * grouping, stacking and `cohort_key` case for case as
    tests/test_cohort.py holds the reference's, errors included, and each
    key equal to the reference's `cohort_key`;
  * `generate_workload_batch` digests equal to the reference's;
  * `run_cohort_grid` against the reference's `run_cohort_grid`
    (``mode="fused"``), float32 and float64, fault-free and with a 3-cell
    chaos axis: `n_groups`, `ok` and the counters equal; float metrics
    within rtol 1e-6 / 1e-12 fault-free (tests/test_torch_sweep.py) and
    1e-5 / 1e-12 under chaos (tests/test_torch_chaos_grid.py: XLA
    contracts a multiply-add the port rounds twice); float32 `lost_work`
    under chaos within the bound its failure times give: XLA's float32
    `log` and PyTorch's part by at most 1 ulp (shown on the lanes' own
    streams, with the failure times t_fail = -log(u) * mtbf * 3600 / m
    then at most T_FAIL_ULPS apart), and each failure adds
    ``(run_done - ckpt_done) * m`` with run_done <= t_fail <= the lane's
    makespan, so a lane's `lost_work` parts by at most failures x
    (M x RUN_DONE_ULPS ulp(makespan) + 2 ulp(lost_work));
  * `run_cohort_grid` bitwise equal to the port's per-member
    `run_packet_grid` in every layout, chaos on and off; the vmap layouts
    refused;
  * the plain `packet_event_steps` with W = 2 bitwise equal to two W = 1
    calls, chaos on and off, and its cohort operand checks before any
    build;
  * one cell of benchmarks/results/paper_chaos_grid.json (hetero0.85, k
    1000, S 0.05, fault cell 0): the port gives the reference's result
    under jax 0.9, and neither gives the file's, which older threefry bits
    wrote (ROADMAP.md Queue 3, R7).
"""
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.core import cohort as tcohort
from repro_torch.core import des as tdes
from repro_torch.core import sweep as tsweep
from repro_torch.core.metrics import efficiency_metrics
from repro_torch.kernels import build as tbuild
from repro_torch.kernels.packet_step import kernel as tstep_kernel
from repro_torch.kernels.packet_step import ops as tstep_ops
from repro_torch.workload import lublin as tlublin
from test_torch_reference import load_reference

KS = (0.5, 2.0, 8.0, 300.0)
SP = (0.05, 0.5)
AXIS = dict(mtbf_chip_hours=np.array([25.0, 100.0, 800.0]),
            ckpt_period=300.0, straggler_prob=0.1,
            straggler_factor=np.array([4.0, 1.5, 1.5]), seed=11)
RTOL = {np.dtype(np.float32): 1e-6, np.dtype(np.float64): 1e-12}
CHAOS_RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}
T_FAIL_ULPS = 3     # a 1-ulp log, then the product and the quotient round
RUN_DONE_ULPS = T_FAIL_ULPS + 1     # run_done = min(t_fail, dur) - s rounds
INT_FIELDS = ("n_groups", "ok", "failures", "straggler_kills", "requeues",
              "requeued_jobs", "budget_exhausted")


def make_flows(loads, n_jobs=120, nodes=32, homogeneous=True, seed0=1,
               **kw):
    return {f"{'homog' if homogeneous else 'hetero'}{ld:.2f}":
            tlublin.generate_workload(tlublin.WorkloadParams(
                n_jobs=n_jobs, nodes=nodes, load=ld,
                homogeneous=homogeneous, seed=seed0 + i, **kw))
            for i, ld in enumerate(loads)}


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture(scope="module")
def homog_flows():
    return make_flows((0.85, 0.95))


@pytest.fixture(scope="module")
def hetero_flows():
    return make_flows((0.85, 0.90), n_jobs=110, nodes=64, homogeneous=False,
                      seed0=3)


FLOW_DTYPES = {"homog": np.float32, "hetero": np.float64}


@pytest.fixture(scope="module")
def flows(homog_flows, hetero_flows):
    return {"homog": homog_flows, "hetero": hetero_flows}


def assert_grids_equal(got, want, context):
    for f in want._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.shape == b.shape and a.dtype == b.dtype, (context, f)
        assert np.array_equal(a, b), (context, f)


# --------------------------------------------------------------------------
# grouping and stacking
# --------------------------------------------------------------------------

class TestGrouping:
    def test_same_statics_one_cohort(self, homog_flows):
        cohorts = tcohort.group_workloads(homog_flows, np.float32)
        assert len(cohorts) == 1
        assert cohorts[0].names == tuple(homog_flows)
        assert cohorts[0].key == tcohort.CohortKey(32, 120, 8, "float32", 32)
        assert cohorts[0].label == "M32-N120-float32"
        assert cohorts[0].n_workloads == 2 and cohorts[0].ring == 32
        for wl in homog_flows.values():
            assert tcohort.cohort_key(wl, np.float32) == cohorts[0].key

    def test_mixed_statics_split_into_two_cohorts(self, homog_flows,
                                                  hetero_flows):
        cohorts = tcohort.group_workloads({**homog_flows, **hetero_flows},
                                          np.float32)
        assert len(cohorts) == 2
        assert cohorts[0].names == tuple(homog_flows)
        assert cohorts[1].names == tuple(hetero_flows)

    def test_dtype_splits_cohorts(self, homog_flows):
        names = list(homog_flows)
        cohorts = tcohort.group_workloads(
            homog_flows, {names[0]: np.float32, names[1]: np.float64})
        assert {c.key.dtype for c in cohorts} == {"float32", "float64"}

    def test_missing_dtype_mapping_raises(self, homog_flows):
        with pytest.raises(ValueError, match="no dtype given"):
            tcohort.group_workloads(homog_flows,
                                    {list(homog_flows)[0]: np.float32})

    def test_paper_flow_shapes_form_two_cohorts(self):
        """The paper's layout (hetero M=500 / homog M=100) under the
        paper_sweep dtype policy collapses to exactly two cohorts."""
        fl = {**make_flows((0.85, 0.90, 0.95), n_jobs=100, nodes=100),
              **make_flows((0.85, 0.90, 0.95), n_jobs=100, nodes=500,
                           homogeneous=False, seed0=11)}
        dtypes = {n: (np.float32 if wl.params.homogeneous else np.float64)
                  for n, wl in fl.items()}
        cohorts = tcohort.group_workloads(fl, dtypes)
        assert [c.n_workloads for c in cohorts] == [3, 3]
        assert [c.label for c in cohorts] == ["M100-N100-float32",
                                              "M500-N100-float64"]

    def test_group_by_statics_helper(self, homog_flows, hetero_flows):
        groups = tlublin.group_by_statics({**homog_flows, **hetero_flows})
        assert groups == {(32, 120, 8): list(homog_flows),
                          (64, 110, 8): list(hetero_flows)}

    def test_chaos_folds_the_requeue_bound_into_the_key(self, homog_flows):
        wl = next(iter(homog_flows.values()))
        chaos = tdes.ChaosConfig(mtbf_chip_hours=50.0)
        assert tcohort.cohort_key(wl, np.float32, chaos).max_requeues == 120
        capped = tdes.ChaosConfig(mtbf_chip_hours=50.0, max_requeues=7)
        assert tcohort.cohort_key(wl, np.float32, capped).max_requeues == 7
        inert = tcohort.cohort_key(wl, np.float32, tdes.ChaosConfig())
        assert inert == tcohort.cohort_key(wl, np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("chaos", [None, dict(mtbf_chip_hours=50.0),
                                   dict(straggler_prob=0.2, max_requeues=9),
                                   dict()],
                         ids=["none", "mtbf", "capped", "inert"])
@pytest.mark.parametrize("which", ["homog", "hetero"])
def test_cohort_key_equals_the_reference(ref, flows, which, dtype, chaos):
    for wl in flows[which].values():
        want = ref.core.cohort_key(
            wl, dtype, None if chaos is None else ref.des.ChaosConfig(
                **chaos))
        got = tcohort.cohort_key(
            wl, dtype, None if chaos is None else tdes.ChaosConfig(**chaos))
        assert tuple(got) == tuple(want)


class TestStacking:
    def test_stacked_leading_axis(self, homog_flows):
        spw = tcohort.stack_workloads(list(homog_flows.values()),
                                      device="cpu")
        assert spw.n_jobs == 120 and spw.n_types == 8
        assert spw.submit.shape == (2, 120)
        assert spw.tj_prefw.shape == (2, 8, 121)
        assert spw.t_last_submit.shape == (2,)
        assert spw.submit.dtype == torch.float32
        for w, wl in enumerate(homog_flows.values()):
            one = tdes.pack_workload(wl, np.float32, "cpu")
            member = tdes.member_workload(spw, w)
            for name, a, b in zip(one._fields, member, one):
                if isinstance(b, torch.Tensor):
                    assert torch.equal(a, b), name

    @pytest.mark.parametrize("field,other", [
        ("n_jobs", dict(n_jobs=80, nodes=32)),
        ("m_nodes", dict(n_jobs=120, nodes=64)),
        ("n_types", dict(n_jobs=120, nodes=32, n_types=5)),
    ])
    def test_mismatched_statics_raise_by_name(self, homog_flows, field,
                                              other):
        odd = tlublin.generate_workload(tlublin.WorkloadParams(
            load=0.9, homogeneous=True, seed=9, **other))
        with pytest.raises(ValueError, match=f"mismatched {field}"):
            tcohort.stack_workloads([next(iter(homog_flows.values())), odd],
                                    device="cpu")

    def test_empty_raises(self):
        with pytest.raises(ValueError, match="at least one"):
            tcohort.stack_workloads([], device="cpu")

    def test_cohort_pack_is_cached(self, homog_flows):
        cohort = tcohort.group_workloads(homog_flows, np.float64)[0]
        assert cohort.pack("cpu") is cohort.pack("cpu")
        assert cohort.pack("cpu").submit.dtype == torch.float64

    def test_stack_equals_the_reference(self, ref, hetero_flows):
        want = ref.core.stack_workloads(list(hetero_flows.values()),
                                        np.float64)
        got = tcohort.stack_workloads(list(hetero_flows.values()),
                                      np.float64, "cpu")
        for name in ("submit", "work", "cumw", "runtime", "tj_submit",
                     "tj_prefw", "t_last_submit", "jtype", "rank", "nodes"):
            w = np.asarray(getattr(want, name))
            assert np.array_equal(getattr(got, name).numpy(), w), name


# --------------------------------------------------------------------------
# the replica generator
# --------------------------------------------------------------------------

@pytest.mark.parametrize("params,n", [
    (dict(n_jobs=100, nodes=32, load=0.9, homogeneous=True, seed=5), 3),
    (dict(n_jobs=60, nodes=16, load=0.85, seed=7), 2),
    (dict(n_jobs=200, nodes=500, load=0.95, seed=0), 4),
    (dict(n_jobs=50, nodes=100, load=0.9, homogeneous=True, seed=1,
          daily_amplitude=0.3), 1),
])
def test_batch_digests_equal_the_reference(ref, params, n):
    got = tlublin.generate_workload_batch(tlublin.WorkloadParams(**params),
                                          n)
    want = ref.lublin.generate_workload_batch(
        ref.lublin.WorkloadParams(**params), n)
    assert list(got) == list(want)
    for name in want:
        assert got[name].golden_digest() == want[name].golden_digest()
        assert tlublin.workload_statics(got[name]) == \
            ref.lublin.workload_statics(want[name])


def test_batch_replicas_land_in_one_cohort_and_differ():
    reps = tlublin.generate_workload_batch(tlublin.WorkloadParams(
        n_jobs=100, nodes=32, load=0.9, homogeneous=True, seed=5), 3)
    assert list(reps) == ["rep000", "rep001", "rep002"]
    assert len(tcohort.group_workloads(reps, np.float32)) == 1
    assert len({wl.golden_digest()["submit"] for wl in reps.values()}) == 3
    for wl in reps.values():
        assert wl.calculated_load() == pytest.approx(0.9)
        assert (np.diff(wl.submit) >= 0).all()


def test_bad_replica_count_raises():
    with pytest.raises(ValueError, match="n_replicas"):
        tlublin.generate_workload_batch(tlublin.WorkloadParams(n_jobs=10), 0)


# --------------------------------------------------------------------------
# run_cohort_grid
# --------------------------------------------------------------------------

def cohort_of(flows, which):
    return tcohort.group_workloads(flows[which], FLOW_DTYPES[which])[0]


@pytest.fixture(scope="module")
def fused(flows):
    """The fused cohort study of each flow set, chaos off and on."""
    return {(which, chaos): tsweep.run_cohort_grid(
        cohort_of(flows, which), KS, SP, mode="fused", device="cpu",
        chaos=tdes.ChaosConfig(**AXIS) if chaos else None)
        for which in FLOW_DTYPES for chaos in (False, True)}


def chaos_lanes(cohort):
    """The [W, K * S * C] (k, s) lanes and the chaos lane grid that
    `run_cohort_grid` gives the engine for KS x SP x AXIS."""
    chaos = tdes.ChaosConfig(**AXIS)
    C, dt = tsweep.chaos_axis_len(chaos), cohort.dtype
    s_mat = np.asarray([[wl.init_time_for_proportion(p) for p in SP]
                        for wl in cohort.workloads], dt)
    k_l2 = np.broadcast_to(np.repeat(np.asarray(KS, dt), len(SP) * C),
                           (cohort.n_workloads, len(KS) * len(SP) * C))
    s_l2 = np.repeat(np.tile(s_mat, (1, len(KS))), C, axis=1)
    return k_l2, s_l2, tsweep.chaos_lane_grid(chaos, len(KS) * len(SP),
                                              dt)[0]


def lost_work_f32_bound(cohort, grids):
    """{name: [K, S, C]} the most a float32 chaos lane's `lost_work` may
    part from the reference's by the failure times' rounding (module
    docstring): failures x (M x RUN_DONE_ULPS ulp(makespan) +
    2 ulp(lost_work)), with each lane's makespan from the port's engine."""
    k_l2, s_l2, lanes = chaos_lanes(cohort)
    res = tdes.simulate_packet_scan_lanes(cohort.pack("cpu"), k_l2, s_l2,
                                          cohort.m_nodes, chaos=lanes,
                                          device="cpu")
    out = {}
    for w, name in enumerate(cohort.names):
        m = grids[name]
        span = res.makespan[w].numpy().reshape(m.lost_work.shape)
        out[name] = m.failures * (
            cohort.m_nodes * RUN_DONE_ULPS * np.spacing(span)
            + 2 * np.spacing(np.abs(m.lost_work))).astype(np.float64)
    return out


def test_float32_failure_times_part_by_the_log_alone(ref, flows):
    """The cause of the float32 `lost_work` bound, on the failure draws of
    the chaos lanes that test_cohort_grid_against_the_reference runs: the
    two frameworks' float32 `log` part by at most 1 ulp (and do part),
    the failure times by at most T_FAIL_ULPS, for every mtbf of the axis
    and every group size up to M."""
    jnp = ref.jax.numpy
    cohort = cohort_of(flows, "homog")
    lanes = chaos_lanes(cohort)[2]
    u2 = tdes.chaos_uniforms(lanes, np.float32, 2 * cohort.n_jobs,
                             "cpu")[..., 1].reshape(-1)
    tiny = float(np.finfo(np.float32).tiny)

    def ulps(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.abs(a - b) / np.spacing(
            np.maximum(np.abs(a), np.abs(b)).astype(np.float32))

    uj = jnp.maximum(jnp.asarray(u2.numpy()), tiny)
    ut = torch.clamp(u2, min=tiny)
    log_ulps = ulps(jnp.log(uj), torch.log(ut).numpy())
    assert log_ulps.max() == 1.0 and (log_ulps > 0).mean() > 0.01
    for mtbf in np.unique(AXIS["mtbf_chip_hours"]):
        scale = np.float32(mtbf * 3600.0)
        for m in range(1, cohort.m_nodes + 1):
            tj = -jnp.log(uj) * scale / np.float32(m)
            tt = -torch.log(ut) * float(scale) / torch.tensor(
                float(m), dtype=torch.float32)
            assert ulps(tj, tt.numpy()).max() <= T_FAIL_ULPS, (mtbf, m)


@pytest.mark.parametrize("chaos", [False, True], ids=["plain", "chaos"])
@pytest.mark.parametrize("which", ["homog", "hetero"])
def test_cohort_grid_against_the_reference(ref, flows, fused, which, chaos):
    dtype = np.dtype(FLOW_DTYPES[which])
    rcohort = ref.core.group_workloads(flows[which], dtype)[0]
    want = ref.core.run_cohort_grid(
        rcohort, KS, SP, mode="fused",
        chaos=ref.des.ChaosConfig(**AXIS) if chaos else None)
    got = fused[which, chaos]
    assert list(got) == list(want)
    rtol = (CHAOS_RTOL if chaos else RTOL)[dtype]
    lost_bound = (lost_work_f32_bound(cohort_of(flows, which), got)
                  if chaos and dtype == np.float32 else None)
    for name in want:
        for f in want[name]._fields:
            w, g = np.asarray(getattr(want[name], f)), getattr(got[name], f)
            assert g.shape == w.shape and g.dtype == w.dtype, (name, f)
            if f in INT_FIELDS:
                assert np.array_equal(g, w), (name, f)
            elif f == "lost_work" and lost_bound is not None:
                d = np.abs(g.astype(np.float64) - w.astype(np.float64))
                assert np.all(d <= lost_bound[name]), (name, f)
            else:
                np.testing.assert_allclose(g, w, rtol=rtol, atol=0,
                                           err_msg=f"{name}/{f}")
        assert got[name].ok.all()
        if chaos:
            assert got[name].failures.sum() > 0


@pytest.mark.parametrize("mode", ["fused", "chunked", "seq"])
@pytest.mark.parametrize("chaos", [False, True], ids=["plain", "chaos"])
@pytest.mark.parametrize("which", ["homog", "hetero"])
def test_cohort_equals_the_per_member_driver(flows, fused, which, chaos,
                                             mode):
    """Every layout of the cohort study is, member by member, the per-
    workload `run_packet_grid` fused grid, bit for bit (a lane does not
    depend on its dispatch companions; chaos lane ids per grid cell).
    `seq`, one engine dispatch a cell, runs two k's at the first S."""
    axis = tdes.ChaosConfig(**AXIS) if chaos else None
    ks, sp = (KS[:2], SP[:1]) if mode == "seq" else (KS, SP)
    got = (fused[which, chaos] if mode == "fused" else
           tsweep.run_cohort_grid(cohort_of(flows, which), ks, sp, mode=mode,
                                  chunk_lanes=3, chaos=axis, device="cpu"))
    for name, wl in flows[which].items():
        want = tsweep.run_packet_grid(wl, ks, sp, dtype=FLOW_DTYPES[which],
                                      mode="fused", chaos=axis,
                                      device="cpu")
        assert_grids_equal(got[name], want, f"{which}/{mode}/{name}")


def test_members_keep_their_own_results(fused):
    a, b = (fused["homog", False][n].avg_wait for n in fused["homog", False])
    assert not np.array_equal(a, b)


def test_single_member_cohort_is_run_packet_grid(homog_flows):
    name, wl = next(iter(homog_flows.items()))
    cohort = tcohort.group_workloads({name: wl}, np.float32)[0]
    got = tsweep.run_cohort_grid(cohort, KS, SP, mode="chunked",
                                 chunk_lanes=5, device="cpu")
    assert_grids_equal(got[name], tsweep.run_packet_grid(
        wl, KS, SP, mode="chunked", device="cpu"), "W=1")


@pytest.mark.parametrize("mode", ["vmap_k", "vmap_s"])
def test_legacy_vmap_modes_are_refused(homog_flows, mode):
    cohort = tcohort.group_workloads(homog_flows, np.float32)[0]
    with pytest.raises(ValueError, match="no cohort layout"):
        tsweep.run_cohort_grid(cohort, KS, SP, mode=mode, device="cpu")


def test_budget_is_enforced_per_member(homog_flows, monkeypatch):
    """An exhausted lane is reported under its member's name."""
    cohort = tcohort.group_workloads(homog_flows, np.float32)[0]
    monkeypatch.setattr(tdes, "event_budget", lambda n, r=0: 40)
    with pytest.raises(RuntimeError,
                       match=r"run_cohort_grid\[homog0\.85\]: .* exhausted"):
        tsweep.run_cohort_grid(cohort, KS, SP, device="cpu")
    with pytest.warns(RuntimeWarning) as caught:
        tsweep.run_cohort_grid(cohort, KS, SP, device="cpu",
                               on_budget_exhausted="warn")
    assert [str(w.message).split(":")[0] for w in caught] == [
        "run_cohort_grid[homog0.85]", "run_cohort_grid[homog0.95]"]


def test_sweep_plan_reports_the_cohort_layout():
    plan = tsweep.sweep_plan("auto", 222, 3, dtype=np.float64,
                             device="cpu")
    assert plan["mode"] == "fused" and plan["layout"] == [3, 222]
    assert plan["total_experiments"] == 666 and plan["n_workloads"] == 3
    assert tsweep.resolve_mode("auto", 222, 3) == "fused"
    with pytest.raises(ValueError, match="at least one workload"):
        tsweep.resolve_mode("fused", 222, 0)


# --------------------------------------------------------------------------
# the event step's workload axis (plain version) and its operand checks
# --------------------------------------------------------------------------

def step_operands(spw, L, seed, chaos):
    """Lane parameters, state and (under chaos) shared streams for a
    dispatch of W members x L lanes over the stacked `spw`."""
    W, tdt = int(spw.submit.shape[0]), spw.submit.dtype
    T, H, N = W * L, spw.n_types, spw.n_jobs
    rng = np.random.default_rng(seed)
    k = torch.tensor(rng.uniform(0.5, 50.0, T), dtype=tdt).reshape(1, T)
    s = torch.tensor(rng.uniform(10.0, 500.0, T), dtype=tdt).reshape(1, T)
    kw, R = {}, 0
    if chaos:
        R = N
        u = torch.tensor(rng.random((2, N + R, L)), dtype=tdt)
        kw = dict(u1=u[0].contiguous(), u2=u[1].contiguous(),
                  chaos_params=tdes.chaos_param_columns(tdes.ChaosConfig(
                      mtbf_chip_hours=5.0, straggler_prob=0.3,
                      straggler_factor=3.0), L, tdt, "cpu"))
    fixed = (torch.ones(H, dtype=tdt), torch.full((H,), 3600.0, dtype=tdt))
    return k, s, fixed, kw, R


@pytest.mark.parametrize("chaos", [False, True], ids=["plain", "chaos"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_plain_step_cohort_equals_member_calls(homog_flows, dtype, chaos):
    spw = tcohort.stack_workloads(list(homog_flows.values()), dtype, "cpu")
    W, L, ring, M = 2, 5, 16, 16
    k, s, (p_j, tmax_j), kw, R = step_operands(spw, L, 0, chaos)
    st = tdes.initial_scan_state(spw.n_types, ring, W * L, M,
                                 spw.submit.dtype, "cpu")
    st, logs = tstep_ops.packet_event_steps(
        spw.tj_prefw, spw.tj_submit, spw.submit, spw.jtype, k, s, p_j,
        tmax_j, spw.t_last_submit.reshape(W, 1), st, n_steps=260, r_cap=R,
        **kw)
    assert int(st.n_groups.sum()) > 0
    if chaos:
        assert int(st.requeues.sum()) > 0
    for w in range(W):
        pw, cols = tdes.member_workload(spw, w), slice(w * L, (w + 1) * L)
        one = tdes.initial_scan_state(spw.n_types, ring, L, M,
                                      spw.submit.dtype, "cpu")
        one, one_logs = tstep_ops.packet_event_steps(
            pw.tj_prefw, pw.tj_submit, pw.submit, pw.jtype,
            k[:, cols].contiguous(), s[:, cols].contiguous(), p_j, tmax_j,
            pw.t_last_submit.reshape(1, 1), one, n_steps=260, r_cap=R, **kw)
        for name, a, b in zip(tdes.ScanState._fields, st, one):
            assert torch.equal(a[:, cols], b), (w, name)
        for a, b in zip(logs, one_logs):
            assert torch.equal(a[:, cols], b), w


@pytest.fixture()
def no_build(monkeypatch):
    """Any build attempt fails the test."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel build was attempted")
    monkeypatch.setattr(tbuild, "build_library", refuse)
    monkeypatch.setattr(tstep_kernel, "load", refuse)


@pytest.mark.parametrize("case,match", [
    ("t_last_one", r"t_last has shape \(1, 1\), expected \(2, 1\)"),
    ("submit_flat", r"submit has shape \(120,\), expected \(2, 120\)"),
    ("jtype_short", r"jtype has shape \(1, 120\), expected \(2, 120\)"),
    ("tsub_flat", r"tj_submit has shape \(8, 120\), expected \(2, 8, 120\)"),
    ("odd_lanes", "do not split into 2 members"),
    ("u1_all_lanes", r"u1 has shape \(240, 10\), expected \(240, 5\)"),
    ("params_all_lanes", r"chaos_params.mtbf_chip_hours has shape "
                         r"\(1, 10\), expected \(1, 5\)"),
])
def test_cohort_operand_errors_come_before_any_build(homog_flows, no_build,
                                                     case, match):
    spw = tcohort.stack_workloads(list(homog_flows.values()), device="cpu")
    k, s, (p_j, tmax_j), kw, R = step_operands(spw, 5, 1, True)
    args = dict(tj_prefw=spw.tj_prefw, tj_submit=spw.tj_submit,
                submit=spw.submit, jtype=spw.jtype, k=k, s=s, p_j=p_j,
                tmax_j=tmax_j, t_last=spw.t_last_submit.reshape(2, 1))
    T = 10
    if case == "t_last_one":
        args["t_last"] = spw.t_last_submit[:1].reshape(1, 1)
    elif case == "submit_flat":
        args["submit"] = spw.submit[0]
    elif case == "jtype_short":
        args["jtype"] = spw.jtype[:1]
    elif case == "tsub_flat":
        args["tj_submit"] = spw.tj_submit[0]
    elif case == "odd_lanes":
        T = 9
        args["k"], args["s"] = k[:, :9].contiguous(), s[:, :9].contiguous()
    elif case == "u1_all_lanes":
        kw["u1"] = torch.rand(240, 10)
    elif case == "params_all_lanes":
        kw["chaos_params"] = tdes.chaos_param_columns(
            tdes.ChaosConfig(mtbf_chip_hours=5.0), 10, torch.float32, "cpu")
    st = tdes.initial_scan_state(8, 16, T, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match=match):
        tstep_ops.packet_event_steps(state=st, r_cap=R, step_impl="torch",
                                     **args, **kw)


CHAOS_GOLDEN = os.path.join(os.path.dirname(__file__), os.pardir,
                            "benchmarks", "results", "paper_chaos_grid.json")


def test_chaos_golden_cell_is_bound_to_old_streams(ref):
    """Cell (k 1000, S 0.05, fault cell 0) of hetero0.85 in the paper's
    fault study, lane id (36 * 6 + 0) * 8 + 0 = 1728, float64: the
    workload is the file's (digests equal) and the port equals the
    reference under jax 0.9, but the file's counts are other ones: the
    streams it was written with are not jax 0.9's."""
    with open(CHAOS_GOLDEN) as f:
        gold = json.load(f)
    wl = tlublin.paper_workloads(0)["hetero0.85"]
    assert wl.golden_digest() == gold["workload_digests"]["hetero0.85"]
    cells = gold["chaos_cells"]
    kw = {f: cells[f][0] for f in ("mtbf_chip_hours", "ckpt_period",
                                   "straggler_prob", "straggler_factor",
                                   "straggler_deadline")}
    k, s_init, lane = 1000.0, wl.init_time_for_proportion(0.05), 1728
    with ref.precision.dtype_scope(np.float64):
        rpw = ref.des.pack_workload(wl, np.float64)
        want = ref.des.simulate_packet_scan(
            rpw, k, s_init, 500, chaos=ref.des.ChaosConfig(
                seed=0, lane=lane, **kw))
        want = ref.metrics.efficiency_metrics(rpw.submit, want, 500,
                                              rpw.t_last_submit)
    pw = tdes.pack_workload(wl, np.float64, "cpu")
    got = efficiency_metrics(pw.submit, tdes.simulate_packet_scan(
        pw, k, s_init, 500, device="cpu", chaos=tdes.ChaosConfig(
            seed=0, lane=lane, **kw)), 500, pw.t_last_submit)
    for f in ("n_groups", "failures", "requeues", "straggler_kills"):
        assert int(getattr(got, f)) == int(np.asarray(getattr(want, f))), f
    np.testing.assert_allclose(float(got.avg_wait),
                               float(np.asarray(want.avg_wait)), rtol=1e-12)
    file_groups = gold["workloads"]["hetero0.85"]["n_groups"][36][0][0]
    assert int(got.n_groups) == 3485 and file_groups == 3651
