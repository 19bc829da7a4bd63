"""The port's packed tables and lane engine against `repro.core.des`.

`pack_workload`: every table equal, both dtypes (the numpy prefix sums are
the same code). `simulate_packet_scan_lanes(device="cpu")` against the
reference's with ``step_impl="pallas"`` (its kernel in interpret mode) on
the `small_workload` / `hetero_workload` shapes of tests/conftest.py:

  * exact: the group-log-derived `start_t`, `n_groups`, `ok`,
    `budget_exhausted` and the integer counters;
  * `run_start_t`, `makespan` and the integrals: rtol 1e-6 (float32) /
    1e-12 (float64) — XLA may contract a multiply-add that PyTorch eager
    rounds twice.

A truncated budget gives the same `budget_exhausted` lanes. Under chaos
both sides consume the reference's `chaos_uniforms` arrays.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.core import des as tdes
from repro_torch.workload.lublin import WorkloadParams, generate_workload
from test_torch_reference import load_reference

WORKLOADS = {
    "small_workload": dict(n_jobs=300, nodes=64, load=0.9, homogeneous=True,
                           seed=7),
    "hetero_workload": dict(n_jobs=300, nodes=128, load=0.85,
                            homogeneous=False, seed=3),
}
KS = [0.1, 0.5, 1.0, 2.0, 8.0, 50.0, 300.0, 1000.0]
S_PROPS = [0.05, 0.5]
RTOL = {np.dtype(np.float32): 1e-6, np.dtype(np.float64): 1e-12}
EXACT = ("start_t", "n_groups", "ok", "budget_exhausted", "failures",
         "straggler_kills", "requeues", "requeued_jobs")
CLOSE = ("run_start_t", "qlen_int", "busy_ns", "useful_ns", "makespan",
         "lost_work")
CHAOS_KW = dict(mtbf_chip_hours=2.0, ckpt_period=120.0, straggler_prob=0.3,
                straggler_factor=2.0, straggler_deadline=1.5)


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def lanes_for(wl, dtype, n_k=len(KS)):
    ks = np.repeat(np.asarray(KS[:n_k], dtype), len(S_PROPS))
    ss = np.tile(np.asarray([wl.init_time_for_proportion(p)
                             for p in S_PROPS], dtype), n_k)
    return ks, ss


def ref_lanes(ref, wl, dtype, ks, ss, chaos=None, **kw):
    """The reference engine through its kernel path, as numpy."""
    with ref.precision.dtype_scope(dtype):
        pw = ref.des.pack_workload(wl, dtype)
        fn = ref.jax.jit(lambda k, s: ref.des.simulate_packet_scan_lanes(
            pw, k, s, int(wl.params.nodes), chaos=chaos, step_impl="pallas",
            **kw))
        res = fn(ref.jnp.asarray(ks), ref.jnp.asarray(ss))
        return {f: np.asarray(getattr(res, f)) for f in res._fields}


def port_lanes(wl, dtype, ks, ss, **kw):
    pw = tdes.pack_workload(wl, dtype, device="cpu")
    res = tdes.simulate_packet_scan_lanes(pw, ks, ss, int(wl.params.nodes),
                                          device="cpu", **kw)
    return {f: getattr(res, f).numpy() for f in res._fields}


def assert_result_parity(got, want, dtype):
    for f in EXACT:
        assert got[f].shape == want[f].shape, f
        assert np.array_equal(got[f], want[f]), f"{f} differs"
    for f in CLOSE:
        assert got[f].dtype == want[f].dtype == np.dtype(dtype), f
        np.testing.assert_allclose(got[f], want[f], rtol=RTOL[np.dtype(dtype)],
                                   atol=0, err_msg=f)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("name", list(WORKLOADS))
class TestAgainstReference:
    def test_pack_workload_tables_equal(self, ref, name, dtype):
        wl = generate_workload(WorkloadParams(**WORKLOADS[name]))
        with ref.precision.dtype_scope(dtype):
            want = ref.des.pack_workload(wl, dtype)
            want = {f: np.asarray(getattr(want, f)) for f in (
                "submit", "work", "jtype", "rank", "cumw", "nodes",
                "runtime", "tj_submit", "tj_prefw", "t_last_submit")}
        got = tdes.pack_workload(wl, dtype, device="cpu")
        assert (got.n_types, got.n_jobs) == (8, 300)
        for f, w in want.items():
            g = getattr(got, f).numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, f
            assert np.array_equal(g, w), f

    def test_engine(self, ref, name, dtype):
        wl = generate_workload(WorkloadParams(**WORKLOADS[name]))
        ks, ss = lanes_for(wl, dtype)
        got = port_lanes(wl, dtype, ks, ss)
        want = ref_lanes(ref, wl, dtype, ks, ss)
        assert want["ok"].all() and not want["budget_exhausted"].any()
        assert_result_parity(got, want, dtype)

    def test_truncated_budget(self, ref, name, dtype):
        wl = generate_workload(WorkloadParams(**WORKLOADS[name]))
        ks, ss = lanes_for(wl, dtype)
        kw = dict(budget=400, seg=50)
        got = port_lanes(wl, dtype, ks, ss, **kw)
        want = ref_lanes(ref, wl, dtype, ks, ss, **kw)
        # the budget genuinely bit some lanes and spared others
        assert want["budget_exhausted"].any()
        assert np.array_equal(got["budget_exhausted"],
                              want["budget_exhausted"])
        assert np.array_equal(got["ok"], want["ok"])
        assert not got["ok"][got["budget_exhausted"]].any()
        assert_result_parity(got, want, dtype)

    def test_seg_boundary_is_invisible(self, ref, name, dtype):
        wl = generate_workload(WorkloadParams(**WORKLOADS[name]))
        ks, ss = lanes_for(wl, dtype, n_k=3)
        a = port_lanes(wl, dtype, ks, ss)
        b = port_lanes(wl, dtype, ks, ss, seg=37)
        for f in a:
            assert np.array_equal(a[f], b[f]), f


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_engine_under_chaos(ref, dtype):
    """Chaos on both sides from the reference's own uniform streams."""
    jnp = ref.jnp
    wl = generate_workload(WorkloadParams(n_jobs=150, nodes=32, load=0.9,
                                          homogeneous=False, seed=5))
    ks, ss = lanes_for(wl, dtype, n_k=4)
    T, N = len(ks), wl.n_jobs
    with ref.precision.dtype_scope(dtype):
        chaos_j = ref.des.ChaosConfig(lane=jnp.arange(T), seed=11, **CHAOS_KW)
        chaos_b = ref.jax.tree.map(
            lambda x: jnp.broadcast_to(jnp.asarray(x), (T,)), chaos_j)
        u = np.asarray(ref.jax.vmap(
            lambda c: ref.des.chaos_uniforms(c, dtype, 2 * N))(chaos_b))
    want = ref_lanes(ref, wl, dtype, ks, ss, chaos=chaos_j)
    got = port_lanes(
        wl, dtype, ks, ss, chaos=tdes.ChaosConfig(seed=11, **CHAOS_KW),
        u1=torch.tensor(np.ascontiguousarray(u[:, :, 0].T)),
        u2=torch.tensor(np.ascontiguousarray(u[:, :, 1].T)))
    assert want["requeues"].max() > 0 and want["ok"].all()
    for f in EXACT:
        assert np.array_equal(got[f], want[f]), f"{f} differs"
    for f in CLOSE:
        np.testing.assert_allclose(
            got[f], want[f], atol=0, err_msg=f,
            rtol=1e-12 if dtype == np.float64 else 1e-5)


def test_lane_results_do_not_depend_on_companions():
    wl = generate_workload(WorkloadParams(**WORKLOADS["small_workload"]))
    ks, ss = lanes_for(wl, np.float32)
    full = port_lanes(wl, np.float32, ks, ss)
    part = port_lanes(wl, np.float32, ks[3:7], ss[3:7])
    for f in full:
        assert np.array_equal(full[f][3:7], part[f]), f


def test_state_and_packed_tables_round_trip_from_numpy():
    wl = generate_workload(WorkloadParams(**WORKLOADS["small_workload"]))
    pw = tdes.pack_workload(wl, np.float64, device="cpu")
    fields = {f: getattr(pw, f).numpy() for f in (
        "submit", "work", "jtype", "rank", "cumw", "nodes", "runtime",
        "tj_submit", "tj_prefw", "t_last_submit")}
    fields.update(n_types=pw.n_types, n_jobs=pw.n_jobs)
    pw2 = tdes.packed_from_numpy(fields, "cpu")
    assert all(torch.equal(getattr(pw, f), getattr(pw2, f)) for f in fields
               if f not in ("n_types", "n_jobs"))
    st = tdes.initial_scan_state(8, 64, 5, 64, torch.float64,
                                 torch.device("cpu"))
    cols = {f: getattr(st, f).numpy() for f in st._fields}
    st2 = tdes.scan_state_from_numpy(cols, "cpu")
    assert len(st2) == tdes.N_STATE_COLS == 23
    for a, b in zip(st, st2):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a copy, never a view of the caller's arrays
    st2.m_free.zero_()
    assert (cols["m_free"] == 64).all()
    with pytest.raises(ValueError, match=r"\[rows, T\]"):
        tdes.scan_state_from_numpy({**cols, "t": cols["t"][0]}, "cpu")


@pytest.mark.parametrize("n,r,want", [(5000, 0, 15064), (5000, 5000, 25064),
                                      (0, 0, 67)])
def test_event_budget(n, r, want):
    assert tdes.event_budget(n, r) == want


@pytest.mark.parametrize("m,n,ring,want", [(100, 5000, None, 100),
                                           (500, 300, None, 300),
                                           (500, 5000, 7, 7), (0, 10, None, 1)])
def test_resolve_ring(m, n, ring, want):
    assert tdes.resolve_ring(m, n, ring) == want


def test_chaos_config_helpers():
    assert tdes.chaos_is_inert(None) and tdes.chaos_is_inert(tdes.ChaosConfig())
    live = tdes.ChaosConfig(mtbf_chip_hours=np.array([0.0, 3.0]))
    assert not tdes.chaos_is_inert(live)
    assert tdes.resolve_max_requeues(None, 50) == 0
    assert tdes.resolve_max_requeues(live, 50) == 50
    assert tdes.resolve_max_requeues(
        tdes.ChaosConfig(max_requeues=3), 50) == 3
