"""The port's while-loop engine and single-lane engines against the reference.

`simulate_packet` (lane-batched, lockstep; its decisions through
`fused_packet_select`'s plain version on the CPU), `simulate_packet_reference`
(the seed oracle) and `simulate_packet_scan` (one lane of the scan engine)
against the reference's engines of the same names, on the hand cases of
tests/test_des_equivalence.py, reduced Lublin workloads over a (k, s)
grid, other ring sizes, priorities and t_max, s = 0 and a tiny k. Then the
grid layouts `seq`, `vmap_k`, `vmap_s` against `fused`
(test_des_equivalence.py:205-255), and chaos through `simulate_packet`
with the reference's `chaos_uniforms` as operands (the hand cases of
tests/test_chaos.py).

Bounds: `n_groups`, `ok`, `budget_exhausted` and the integer counters
exact, and so is `start_t` (a group's start is an event time) without
chaos; the other floats within rtol = atol = 1e-6 (float32, the
reference's `assert_des_equal`) and 1e-12 (float64). Under chaos the
reference's XLA build contracts a multiply-add of the stretched duration
into an FMA, so its event times can sit 1 ulp from the port's (float64,
lane 2 below); there `start_t` is held at the float bound and the port's
while engine bitwise to its scan engine. Every reference engine is the
scalar call, jit-compiled once per workload.
"""
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from conftest import make_workload as ref_make_workload
from repro_torch.core import des as tdes
from repro_torch.core import sweep as tsweep
from repro_torch.kernels.packet_select import ops as tselect
from repro_torch.workload import lublin as tlublin
from test_torch_reference import load_reference

DTYPES = [np.float32, np.float64]
IDS = ["float32", "float64"]
TOL = {np.dtype(np.float32): 1e-6, np.dtype(np.float64): 1e-12}
EXACT = ("n_groups", "ok", "budget_exhausted", "failures",
         "straggler_kills", "requeues", "requeued_jobs")
HAND_CASES = [
    # (submit, runtime, nodes, jtype, n_types, M, k, s)
    ([0.0], [100.0], [1], [0], 2, 10, 1.0, 50.0),
    ([0.0, 1.0, 2.0], [100.0, 40.0, 60.0], [1, 1, 1], [0, 0, 0], 1, 1,
     1000.0, 10.0),
    ([0.0, 0.0], [120.0, 120.0], [1, 1], [0, 0], 1, 100, 0.5, 60.0),
    ([0.0, 0.0, 5.0, 6.0], [50.0, 80.0, 30.0, 20.0], [1, 1, 1, 1],
     [0, 1, 0, 1], 2, 4, 2.0, 15.0),
    ([0.0], [100.0], [1], [0], 1, 2, 0.1, 10.0),
    ([float(i) for i in range(12)], [10.0] * 12, [1] * 12,
     [0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0], 2, 6, 4.0, 8.0),
]
LUBLIN = {
    "small_workload": dict(n_jobs=300, nodes=64, load=0.9, homogeneous=True,
                           seed=7),
    "hetero_workload": dict(n_jobs=300, nodes=128, load=0.85,
                            homogeneous=False, seed=3),
}
KS = [0.3, 2.0, 20.0, 500.0]
S_PROPS = [0.05, 0.3, 0.5]


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def port_workload(submit, runtime, nodes, jtype, n_types, m_nodes):
    """The port's Workload built as tests/conftest.py builds the
    reference's."""
    submit, runtime = (np.asarray(a, np.float64) for a in (submit, runtime))
    nodes, jtype = (np.asarray(a, np.int64) for a in (nodes, jtype))
    order = np.argsort(submit, kind="stable")
    p = tlublin.WorkloadParams(n_jobs=len(submit), nodes=m_nodes,
                               n_types=n_types,
                               horizon=float(submit.max()))
    return tlublin.Workload(submit=submit[order], runtime=runtime[order],
                            nodes=nodes[order],
                            work=(runtime * nodes)[order],
                            jtype=jtype[order], params=p)


def workloads(name):
    """(port workload, reference workload) of a reduced Lublin flow."""
    ref = load_reference()
    p = LUBLIN[name]
    return (tlublin.generate_workload(tlublin.WorkloadParams(**p)),
            ref.lublin.generate_workload(ref.lublin.WorkloadParams(**p)))


class RefEngine:
    """One reference engine on one workload, jit-compiled once, called
    per (k, s) as the scalar call; results as numpy."""

    def __init__(self, ref, name, rwl, dtype, **kw):
        self.ref, self.dtype = ref, dtype
        m = int(rwl.params.nodes)
        with ref.precision.dtype_scope(dtype):
            self.pw = ref.des.pack_workload(rwl, dtype)
            fn = getattr(ref.des, name)
            self.fn = ref.jax.jit(
                lambda k, s: fn(self.pw, k, s, m, **kw))

    def __call__(self, k, s):
        jnp = self.ref.jnp
        with self.ref.precision.dtype_scope(self.dtype):
            res = self.fn(jnp.asarray(k, self.dtype),
                          jnp.asarray(s, self.dtype))
            return {f: np.asarray(getattr(res, f)) for f in res._fields}


def assert_same(got, want, dtype, label="", exact_start=True):
    """`got` a port DesResult of one lane, `want` a numpy dict."""
    tol = TOL[np.dtype(dtype)]
    exact = EXACT + (("start_t",) if exact_start else ())
    for f in tdes.DesResult._fields:
        g = getattr(got, f).numpy()
        w = want[f]
        assert g.shape == w.shape, (label, f)
        if f in exact:
            assert np.array_equal(g, w), f"{label}: {f} differs"
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=f"{label}: {f}")


def lane(res, i):
    return tdes.DesResult(*(x[i] for x in res))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("case", range(len(HAND_CASES)))
def test_hand_case(ref, case, dtype):
    submit, runtime, nodes, jtype, h, m, k, s = HAND_CASES[case]
    wl = port_workload(submit, runtime, nodes, jtype, h, m)
    rwl = ref_make_workload(submit, runtime, nodes, jtype, h, m)
    pw = tdes.pack_workload(wl, dtype, device="cpu")
    for name in ("simulate_packet", "simulate_packet_reference",
                 "simulate_packet_scan"):
        got = getattr(tdes, name)(pw, k, s, m, device="cpu")
        want = RefEngine(ref, name, rwl, dtype)(k, s)
        assert_same(got, want, dtype, f"{name} case {case}")


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("name", list(LUBLIN))
def test_reduced_lublin_grid(ref, name, dtype):
    """All (k, s) cells as lanes of ONE call against the scalar reference
    calls; the oracle and the scan engine on the grid's corners."""
    wl, rwl = workloads(name)
    m = int(wl.params.nodes)
    pw = tdes.pack_workload(wl, dtype, device="cpu")
    cells = [(np.asarray(k, dtype), np.asarray(
        wl.init_time_for_proportion(p), dtype)) for k in KS for p in S_PROPS]
    ks, ss = (np.asarray(x) for x in zip(*cells))
    got = tdes.simulate_packet(pw, ks, ss, m, device="cpu")
    want = RefEngine(ref, "simulate_packet", rwl, dtype)
    for i, (k, s) in enumerate(cells):
        assert_same(lane(got, i), want(k, s), dtype, f"lane {i}")
    assert got.ok.all()
    for name_ in ("simulate_packet_reference", "simulate_packet_scan"):
        engine = RefEngine(ref, name_, rwl, dtype)
        for k, s in (cells[0], cells[-1]):
            assert_same(getattr(tdes, name_)(pw, k, s, m, device="cpu"),
                        engine(k, s), dtype, f"{name_} k={k}")


@pytest.mark.parametrize("ring", [None, 512, 48])
def test_ring_size_does_not_change_results(ref, ring):
    """A ring large enough for the concurrent groups is a capacity, not a
    policy (48 of 64 nodes still holds every concurrent group here)."""
    wl, rwl = workloads("small_workload")
    m = int(wl.params.nodes)
    s = wl.init_time_for_proportion(0.3)
    pw = tdes.pack_workload(wl, np.float32, device="cpu")
    base = tdes.simulate_packet(pw, 2.0, s, m, device="cpu")
    got = tdes.simulate_packet(pw, 2.0, s, m, ring=ring, device="cpu")
    for f in tdes.DesResult._fields:
        assert torch.equal(getattr(got, f), getattr(base, f)), f
    want = RefEngine(ref, "simulate_packet", rwl, np.float32,
                     ring=ring)(2.0, s)
    assert_same(got, want, np.float32, f"ring {ring}")


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_priorities_and_t_max(ref, dtype):
    wl, rwl = workloads("small_workload")
    m = int(wl.params.nodes)
    s = wl.init_time_for_proportion(0.3)
    pri = np.linspace(2.0, 0.5, wl.params.n_types)
    tmx = np.full(wl.params.n_types, 600.0)
    pw = tdes.pack_workload(wl, dtype, device="cpu")
    got = tdes.simulate_packet(pw, [1.0, 4.0], s, m, priority=pri,
                               t_max=tmx, device="cpu")
    oracle = tdes.simulate_packet_reference(pw, 4.0, s, m, priority=pri,
                                            t_max=tmx, device="cpu")
    for i, k in enumerate((1.0, 4.0)):
        want = RefEngine(ref, "simulate_packet", rwl, dtype, priority=pri,
                         t_max=tmx)(k, s)
        assert_same(lane(got, i), want, dtype, f"k={k}")
    want = RefEngine(ref, "simulate_packet_reference", rwl, dtype,
                     priority=pri, t_max=tmx)(4.0, s)
    assert_same(oracle, want, dtype, "oracle")


@pytest.mark.parametrize("dtype,ks,s_prop", [
    (np.float64, [0.5, 8.0, 300.0], 0.0),      # s = 0: duration unclamped
    (np.float32, [1e-9], 0.05),                # threshold above 2**31
    (np.float64, [1e-9], 0.05),
], ids=["s_zero_float64", "tiny_k_float32", "tiny_k_float64"])
def test_edge_parameters(ref, dtype, ks, s_prop):
    """Where the TPU select kernel and the policy part (s = 0), and where
    the int32 cast of the node threshold saturates (tiny k): the port
    gives the reference engine's schedule."""
    wl, rwl = workloads("small_workload")
    m = int(wl.params.nodes)
    s = wl.init_time_for_proportion(s_prop)
    pw = tdes.pack_workload(wl, dtype, device="cpu")
    got = tdes.simulate_packet(pw, ks, s, m, device="cpu")
    want = RefEngine(ref, "simulate_packet", rwl, dtype)
    for i, k in enumerate(ks):
        assert_same(lane(got, i), want(k, s), dtype, f"k={k}")
    assert got.ok.all()


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_lanes_equal_their_single_lane_calls(dtype):
    """A lane's result does not depend on its companions: bitwise equal to
    the same (k, s) run alone."""
    wl, _ = workloads("hetero_workload")
    m = int(wl.params.nodes)
    pw = tdes.pack_workload(wl, dtype, device="cpu")
    ks = np.asarray([0.3, 20.0, 2.0, 500.0], dtype)
    ss = np.asarray([wl.init_time_for_proportion(p)
                     for p in (0.5, 0.05, 0.3, 0.05)], dtype)
    both = tdes.simulate_packet(pw, ks, ss, m, device="cpu")
    for i in range(len(ks)):
        alone = tdes.simulate_packet(pw, ks[i], ss[i], m, device="cpu")
        for f in tdes.DesResult._fields:
            assert torch.equal(getattr(alone, f), getattr(both, f)[i]), f


def test_scalar_call_squeezes_and_broadcasts():
    wl, _ = workloads("small_workload")
    m = int(wl.params.nodes)
    pw = tdes.pack_workload(wl, np.float32, device="cpu")
    s = wl.init_time_for_proportion(0.2)
    one = tdes.simulate_packet(pw, 2.0, s, m, device="cpu")
    assert one.n_groups.shape == () and one.start_t.shape == (300,)
    two = tdes.simulate_packet(pw, [2.0, 2.0], s, m, device="cpu")
    assert two.n_groups.shape == (2,) and two.start_t.shape == (2, 300)
    assert torch.equal(two.start_t[1], one.start_t)
    with pytest.raises(ValueError, match="equal-length"):
        tdes.simulate_packet(pw, [1.0, 2.0], [s, s, s], m, device="cpu")


def test_loop_counts_and_one_select_call_per_formation(monkeypatch):
    """`stats` reports the lockstep loops; every inner iteration takes its
    decision in exactly one call of `fused_packet_select`."""
    calls = []
    real = tselect.fused_packet_select

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tselect, "fused_packet_select", counting)
    wl, _ = workloads("small_workload")
    m = int(wl.params.nodes)
    pw = tdes.pack_workload(wl, np.float32, device="cpu")
    ks = np.asarray([0.3, 2.0, 20.0], np.float32)
    stats = {}
    res = tdes.simulate_packet(pw, ks, 900.0, m, device="cpu", stats=stats)
    assert stats["inner"] == len(calls) > 0
    assert all(shape == (3, wl.params.n_types) for shape in calls)
    assert stats["syncs"] == stats["outer"] + stats["inner"] + 1
    # the outer loop runs as long as the longest lane: N + its groups
    assert stats["outer"] == 300 + int(res.n_groups.max())


def test_iteration_cap_flags_budget(ref):
    wl, rwl = workloads("small_workload")
    m = int(wl.params.nodes)
    s = wl.init_time_for_proportion(0.2)
    pw = tdes.pack_workload(wl, np.float32, device="cpu")
    got = tdes.simulate_packet(pw, [2.0, 20.0], s, m, max_iters=40,
                               device="cpu")
    assert got.budget_exhausted.all() and not got.ok.any()
    want = RefEngine(ref, "simulate_packet", rwl, np.float32,
                     max_iters=40)(2.0, s)
    assert_same(lane(got, 0), want, np.float32, "capped")


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_host_entry_point(ref, dtype):
    wl, rwl = workloads("small_workload")
    got = tdes.simulate_packet_host(wl, 8.0, 0.3, dtype, device="cpu")
    with ref.precision.dtype_scope(dtype):
        want = ref.des.simulate_packet_host(rwl, 8.0, 0.3, dtype)
    assert isinstance(got.start_t, np.ndarray)
    assert got.start_t.dtype == np.dtype(dtype)
    assert_same(tdes.DesResult(*(torch.as_tensor(x) for x in got)),
                {f: np.asarray(getattr(want, f)) for f in want._fields},
                dtype, "host")


# ------------------------------------------------------------ grid layouts

GRID_KW = dict(ks=[0.5, 8.0, 100.0], s_props=[0.05, 0.5], device="cpu")
GRID_FIELDS = ("avg_wait", "med_wait", "avg_qlen", "full_util",
               "useful_util", "avg_run_wait")
GRID_RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("layout", ["seq", "vmap_k", "vmap_s"])
def test_grid_layouts_match_fused(layout, dtype):
    """seq / vmap_k / vmap_s are dispatch layouts, not policies
    (test_des_equivalence.py:205-255)."""
    wl, _ = workloads("small_workload")
    kw = ({"mode": "seq"} if layout == "seq" else {layout: True})
    g = tsweep.run_packet_grid(wl, dtype=dtype, **kw, **GRID_KW)
    fused = tsweep.run_packet_grid(wl, dtype=dtype, mode="fused", **GRID_KW)
    assert g.avg_wait.shape == (3, 2) and g.ok.all()
    assert g.avg_wait.dtype == np.dtype(dtype)
    assert np.array_equal(g.n_groups, fused.n_groups)
    for f in GRID_FIELDS:
        np.testing.assert_allclose(getattr(g, f), getattr(fused, f),
                                   rtol=GRID_RTOL[np.dtype(dtype)],
                                   err_msg=f"{layout}:{f}")


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_seq_grid_matches_the_reference_seq_grid(ref, dtype):
    wl, rwl = workloads("hetero_workload")
    got = tsweep.run_packet_grid(wl, dtype=dtype, mode="seq", **GRID_KW)
    kw = {k: v for k, v in GRID_KW.items() if k != "device"}
    want = ref.sweep.run_packet_grid(rwl, dtype=dtype, mode="seq", **kw)
    assert np.array_equal(got.n_groups, np.asarray(want.n_groups))
    for f in GRID_FIELDS:
        np.testing.assert_allclose(getattr(got, f),
                                   np.asarray(getattr(want, f)),
                                   rtol=GRID_RTOL[np.dtype(dtype)],
                                   err_msg=f)


def test_grid_argument_errors_are_the_references():
    wl, _ = workloads("small_workload")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tsweep.run_packet_grid(wl, vmap_k=True, vmap_s=True, **GRID_KW)
    with pytest.raises(ValueError, match="not both"):
        tsweep.run_packet_grid(wl, vmap_k=True, mode="seq", **GRID_KW)
    with pytest.raises(ValueError, match="no vmap_k/vmap_s layout"):
        tsweep.run_packet_grid(wl, vmap_s=True, chaos=tdes.ChaosConfig(),
                               **GRID_KW)


# -------------------------------------------------------------------- chaos

def chaos_pair(ref, **params):
    return ref.des.ChaosConfig(**params), tdes.ChaosConfig(**{
        k: v for k, v in params.items() if k not in ("seed", "lane")})


def chaos_run(ref, rwl, wl, params, k, s, dtype=np.float64):
    """(port result, reference result as numpy) of one chaos experiment
    through both while engines, the port fed the reference's streams; the
    port's while engine is first held bitwise to its own scan engine."""
    rch, tch = chaos_pair(ref, **params)
    m = int(wl.params.nodes)
    n = wl.n_jobs
    cap = n + tdes.resolve_max_requeues(tch, n)
    with ref.precision.dtype_scope(dtype):
        u = np.array(ref.des.chaos_uniforms(rch, dtype, cap))
    want = RefEngine(ref, "simulate_packet", rwl, dtype, chaos=rch)(k, s)
    pw = tdes.pack_workload(wl, dtype, device="cpu")
    got = tdes.simulate_packet(pw, k, s, m, chaos=tch, u1=u[:, :1],
                               u2=u[:, 1:], device="cpu")
    scan = tdes.simulate_packet_scan(pw, k, s, m, chaos=tch, u1=u[:, 0],
                                     u2=u[:, 1], device="cpu")
    for f in tdes.DesResult._fields:
        assert torch.equal(getattr(got, f), getattr(scan, f)), f
    return got, want, u


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("lane_id", [0, 2, 7])
def test_chaos_workload_lanes(ref, lane_id, dtype):
    """tests/test_chaos.py::TestEngineChaosParity's cells."""
    p = dict(n_jobs=80, nodes=32, load=0.9, homogeneous=True, seed=5)
    wl = tlublin.generate_workload(tlublin.WorkloadParams(**p))
    rwl = ref.lublin.generate_workload(ref.lublin.WorkloadParams(**p))
    s = wl.init_time_for_proportion(0.2)
    got, want, _ = chaos_run(
        ref, rwl, wl, dict(mtbf_chip_hours=0.02, ckpt_period=120.0,
                           straggler_prob=0.3, seed=11, lane=lane_id),
        0.5, s, dtype)
    assert bool(got.ok) and int(got.failures) > 0
    assert_same(got, want, dtype, f"lane {lane_id}", exact_start=False)


CLUSTER_SIM_CASES = {
    # tests/test_chaos.py::TestClusterSimDifferential, with their hand
    # results: (submit, runtime, k, chaos params, n_groups, failures,
    # kills, requeued_jobs, makespan or None)
    "failure_requeue": ([0.0, 0.0], [6000.0, 6000.0], 2.0,
                        dict(mtbf_chip_hours=1.0, ckpt_period=300.0,
                             seed=82, lane=0), 2, 1, 0, None, None),
    "straggler_cascade": ([0.0, 0.0], [6000.0, 6000.0], 0.25,
                          dict(straggler_prob=1.0, straggler_factor=4.0,
                               straggler_deadline=2.0, seed=0, lane=0,
                               max_requeues=8), 7, 0, 6, None, 12700.0),
    # seed 118, not test_chaos.py's 6: jax 0.9 draws other threefry bits
    # (`jax_threefry_partitionable`), and 118 is the first seed whose
    # failure times give this case there (checked below)
    "partial_credit": ([0.0, 1.0, 2.0], [6000.0, 4000.0, 6000.0], 0.25,
                       dict(mtbf_chip_hours=1.0, ckpt_period=300.0,
                            seed=118, lane=0), 3, 1, 0, 1, 5300.0),
    "residual_carry": ([0.0], [6000.0], 0.25,
                       dict(straggler_prob=1.0, straggler_factor=4.0,
                            straggler_deadline=2.0, seed=0, lane=0,
                            max_requeues=8), 5, 0, 4, 4, 6500.0),
}


@pytest.mark.parametrize("case", list(CLUSTER_SIM_CASES))
def test_chaos_hand_case(ref, case):
    submit, runtime, k, params, groups, fails, kills, rq_jobs, makespan = \
        CLUSTER_SIM_CASES[case]
    n = len(submit)
    wl = port_workload(submit, runtime, [1] * n, [0] * n, 1, 4)
    rwl = ref_make_workload(submit, runtime, [1] * n, [0] * n, 1, 4)
    got, want, u = chaos_run(ref, rwl, wl, params, k, 100.0)
    t_fails = [-math.log(max(u[g, 1], 5e-324)) * 900.0 for g in range(3)]
    if case == "partial_credit":        # the streams give the hand model
        assert t_fails[0] > 1600.0 and t_fails[2] > 1100.0
        assert 1600.0 <= t_fails[1] < 1900.0     # => ckpt_done == 1500
        assert float(got.lost_work) == pytest.approx(
            (t_fails[1] - 100.0 - 1500.0) * 4, rel=1e-12)
    assert_same(got, want, np.float64, case, exact_start=False)
    assert bool(got.ok) and int(got.n_groups) == groups
    assert int(got.failures) == fails and int(got.straggler_kills) == kills
    if rq_jobs is not None:
        assert int(got.requeued_jobs) == rq_jobs
    if makespan is not None:
        assert float(got.makespan) == makespan
    if case == "failure_requeue":       # the hand model of test_chaos.py
        t_fail = t_fails[0]
        assert 500.0 < t_fail < 1500.0
        ckpt_done = 300.0 * math.floor((t_fail - 100.0) / 300.0)
        assert float(got.lost_work) == pytest.approx(
            (t_fail - 100.0 - ckpt_done) * 4, rel=1e-12)
        assert float(got.makespan) == pytest.approx(
            1600.0 + 100.0 + (12000.0 - 4 * ckpt_done) / 4.0)


def test_inert_chaos_is_the_fault_free_schedule(ref):
    wl, _ = workloads("small_workload")
    m = int(wl.params.nodes)
    s = wl.init_time_for_proportion(0.2)
    pw = tdes.pack_workload(wl, np.float32, device="cpu")
    cap = wl.n_jobs + tdes.resolve_max_requeues(tdes.ChaosConfig(),
                                                wl.n_jobs)
    u = np.random.default_rng(0).random((2, cap, 1)).astype(np.float32)
    a = tdes.simulate_packet(pw, 2.0, s, m, device="cpu")
    b = tdes.simulate_packet(pw, 2.0, s, m, chaos=tdes.ChaosConfig(),
                             u1=u[0], u2=u[1], device="cpu")
    for f in tdes.DesResult._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    with pytest.raises(ValueError, match="u1 and u2"):
        tdes.simulate_packet(pw, 2.0, s, m, chaos=tdes.ChaosConfig(),
                             device="cpu")
