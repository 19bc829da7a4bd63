"""The rigid baselines of the port, FCFS and EASY backfill, on the CPU.

  * `simulate_fcfs` / `simulate_backfill` (the plain version, lanes in
    lockstep) against the reference's on seeded random small workloads
    whose runtimes and submit times lie on a coarse grid, so that running
    jobs end at the same instant and the reservation's stable order of
    ends decides `free_at_shadow`: `start_t`, `n_groups`, `ok` and
    `budget_exhausted` equal, the float integrals within rtol 1e-6
    (float32) / 1e-12 (float64), tests/test_torch_sweep.py's bound; rings
    too short for every running job, a capped event count and a shallow
    candidate walk included;
  * `run_baselines` against the golden file's fcfs / backfill blocks
    (float64, rtol 1e-9 over max(|golden|, floor)) and against the
    reference's `run_baselines` in both dtypes;
  * the wrapper's routing (the plain version on CPU tensors, `"cuda"`
    there raises, no `try` around the launch), its operand checks before
    any build, and the kernel's launch plan.
"""
import dataclasses
import inspect
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.core import des as tdes
from repro_torch.core import schedulers as tsched
from repro_torch.core import sweep as tsweep
from repro_torch.core.metrics import METRIC_REL_FLOORS, SCALAR_METRIC_FIELDS
from repro_torch.kernels import build as tbuild
from repro_torch.kernels.baselines import kernel as tkernel
from repro_torch.kernels.baselines import ops as tops
from repro_torch.workload import lublin as tlublin
from test_torch_reference import load_reference

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "golden_metrics.json")
RTOL = {np.dtype(np.float32): 1e-6, np.dtype(np.float64): 1e-12}
INT_FIELDS = ("n_groups", "ok", "budget_exhausted", "failures",
              "straggler_kills", "requeues", "requeued_jobs")
POLICIES = ("fcfs", "backfill")


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def tied_workload(seed: int, n_jobs: int = 90, nodes: int = 24):
    """A rigid workload on a coarse grid: submits on 50 s steps, runtimes
    among a few multiples of 100 s, node counts up to the cluster, so that
    jobs started at one instant often end at one instant."""
    rng = np.random.default_rng(seed)
    submit = np.sort(rng.integers(0, 60, n_jobs) * 50.0)
    runtime = rng.choice([100.0, 200.0, 300.0, 600.0], n_jobs)
    n = rng.choice([1, 2, 3, 4, 6, 8, 12, nodes], n_jobs,
                   p=[.2, .2, .15, .15, .1, .1, .05, .05]).astype(np.int64)
    params = tlublin.WorkloadParams(n_jobs=n_jobs, nodes=nodes, seed=seed)
    return tlublin.Workload(submit=submit, runtime=runtime, nodes=n,
                            work=runtime * n,
                            jtype=rng.integers(0, 8, n_jobs),
                            params=params)


def ref_result(ref, wl, policy, dtype, s, **kw):
    """The reference's DesResult of one lane, as numpy."""
    fn = (ref.core.simulate_fcfs if policy == "fcfs"
          else ref.core.simulate_backfill)
    with ref.precision.dtype_scope(dtype):
        pw = ref.des.pack_workload(wl, dtype)
        out = fn(pw, s, int(wl.params.nodes), **kw)
        return tdes.DesResult(*(np.asarray(x) for x in out))


def assert_result_close(got, want, dtype, label):
    for f in tdes.DesResult._fields:
        g, w = getattr(got, f).numpy(), getattr(want, f)
        assert g.shape == w.shape, (label, f)
        if f in INT_FIELDS or f == "start_t":
            assert np.array_equal(g, w), (label, f)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL[np.dtype(dtype)],
                                       atol=0, err_msg=f"{label}: {f}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", range(4))
def test_against_the_reference_with_ties(ref, seed, policy, dtype):
    wl = tied_workload(seed)
    pw = tdes.pack_workload(wl, dtype, "cpu")
    s_vals = (0.0, 50.0, 130.0)
    fn = tsched.simulate_fcfs if policy == "fcfs" else \
        tsched.simulate_backfill
    lanes = fn(pw, np.asarray(s_vals, dtype), wl.params.nodes)
    assert lanes.start_t.shape == (3, wl.n_jobs)
    for t, s in enumerate(s_vals):
        want = ref_result(ref, wl, policy, dtype, s)
        assert bool(want.ok)
        got = tdes.DesResult(*(x[t] for x in lanes))
        assert_result_close(got, want, dtype, f"seed {seed} s={s}")


def reservation_ties(wl, dtype, s):
    """How many pairs of running jobs with equal finite ends stood side
    by side in the sorts of a backfill run's reservations (where the
    stable order of the sort can decide `free_at_shadow`)."""
    count = 0
    real = torch.argsort

    def spy(x, *a, **kw):
        nonlocal count
        out = real(x, *a, **kw)
        ends = torch.gather(x, 1, out)
        fin = torch.isfinite(ends)
        count += int(((ends[:, 1:] == ends[:, :-1]) & fin[:, 1:]).sum())
        return out

    torch.argsort = spy
    try:
        tsched.simulate_backfill(tdes.pack_workload(wl, dtype, "cpu"), s,
                                 wl.params.nodes)
    finally:
        torch.argsort = real
    return count


def test_the_tied_workloads_tie_in_the_reservation():
    """The workloads above do put equal ends into the reservation's sort,
    so the stable-order rule is exercised, not merely allowed."""
    assert all(reservation_ties(tied_workload(seed), np.float64, 50.0) > 0
               for seed in range(4))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kw", [dict(ring=3), dict(ring=1),
                                dict(max_iters=40), dict(ring=5,
                                                         max_iters=100)],
                         ids=["ring3", "ring1", "capped", "ring5-capped"])
def test_short_rings_and_capped_runs(ref, policy, kw):
    wl = tied_workload(7, n_jobs=60)
    pw = tdes.pack_workload(wl, np.float64, "cpu")
    fn = tsched.simulate_fcfs if policy == "fcfs" else \
        tsched.simulate_backfill
    got = fn(pw, 40.0, wl.params.nodes, **kw)
    want = ref_result(ref, wl, policy, np.float64, 40.0, **kw)
    assert_result_close(got, want, np.float64, str(kw))
    if "max_iters" in kw:
        assert bool(got.budget_exhausted) and not bool(got.ok)


@pytest.mark.parametrize("depth", [1, 3, 8])
def test_shallow_backfill_walks(ref, depth):
    wl = tied_workload(11)
    pw = tdes.pack_workload(wl, np.float64, "cpu")
    got = tsched.simulate_backfill(pw, 60.0, wl.params.nodes,
                                   backfill_depth=depth)
    want = ref_result(ref, wl, "backfill", np.float64, 60.0,
                      backfill_depth=depth)
    assert_result_close(got, want, np.float64, f"depth {depth}")


def test_backfill_jumps_the_queue_and_fcfs_does_not():
    wl = tied_workload(2)
    pw = tdes.pack_workload(wl, np.float64, "cpu")
    fcfs = tsched.simulate_fcfs(pw, 0.0, wl.params.nodes)
    bf = tsched.simulate_backfill(pw, 0.0, wl.params.nodes)
    assert np.all(np.diff(fcfs.start_t.numpy()) >= 0)   # submit order
    assert np.any(np.diff(bf.start_t.numpy()) < 0)      # someone jumped
    assert int(fcfs.n_groups) == int(bf.n_groups) == wl.n_jobs
    assert torch.equal(fcfs.run_start_t, fcfs.start_t + 0.0)
    for f in ("lost_work", "failures", "requeues"):
        assert float(getattr(bf, f)) == 0


# --------------------------------------------------------------------------
# run_baselines: goldens and the reference's driver
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["hetero", "homog"])
def test_against_golden_float64(golden, name):
    spec = golden["spec"]
    wl = tlublin.generate_workload(tlublin.WorkloadParams(
        **spec["workloads"][name]))
    got = tsweep.run_baselines(wl, spec["s_props"], dtype=np.float64,
                               device="cpu")
    assert list(got) == ["backfill", "fcfs"]
    for policy in POLICIES:
        want = golden["grids"][name][policy]
        for f in SCALAR_METRIC_FIELDS:
            g = getattr(got[policy], f)
            w = np.asarray(want[f], np.float64)
            assert g.dtype == np.float64
            rel = np.abs(g - w) / np.maximum(np.abs(w), METRIC_REL_FLOORS[f])
            assert rel.max() <= 1e-9, (policy, f, rel.max())
        assert bool(want["ok"]) and got[policy].ok.all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("homogeneous", [True, False],
                         ids=["homog", "hetero"])
def test_run_baselines_against_the_reference(ref, homogeneous, dtype):
    wl = tlublin.generate_workload(tlublin.WorkloadParams(
        n_jobs=160, nodes=24 if homogeneous else 48, load=0.95,
        homogeneous=homogeneous, seed=3))
    s_props = (0.05, 0.3, 0.5)
    want = ref.core.run_baselines(wl, s_props, dtype=dtype)
    got = tsweep.run_baselines(wl, s_props, dtype=dtype, device="cpu")
    assert list(got) == list(want)
    for policy in want:
        for f in want[policy]._fields:
            w, g = np.asarray(getattr(want[policy], f)), \
                getattr(got[policy], f)
            assert g.shape == w.shape == (3,) and g.dtype == w.dtype, f
            if f in INT_FIELDS:
                assert np.array_equal(g, w), (policy, f)
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL[np.dtype(dtype)],
                                           atol=0, err_msg=f"{policy}/{f}")


# --------------------------------------------------------------------------
# the wrapper: routing and operand checks
# --------------------------------------------------------------------------

@pytest.fixture()
def no_build(monkeypatch):
    """Any build attempt fails the test."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel build was attempted")
    monkeypatch.setattr(tbuild, "build_library", refuse)
    monkeypatch.setattr(tkernel, "load", refuse)


def operands(dtype=torch.float32):
    wl = tied_workload(1, n_jobs=30, nodes=12)
    pw = tdes.pack_workload(wl, dtype, "cpu")
    s = torch.tensor([0.0, 80.0], dtype=dtype)
    return dict(submit=pw.submit, runtime=pw.runtime, nodes=pw.nodes,
                t_last=pw.t_last_submit, s=s, m_nodes=12)


@pytest.mark.parametrize("policy", POLICIES)
def test_cpu_default_is_the_plain_version(no_build, policy):
    before = tops.baselines.launches
    a = tops.baselines(**operands(), policy=policy, max_iters=184, ring=12)
    b = tops.baselines(**operands(), policy=policy, max_iters=184, ring=12,
                       impl="torch")
    assert tops.baselines.launches == before
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name
    assert a.drained.all() and (a.n_started == 30).all()
    assert (a.iters == 60).all()          # one event per submit and finish


def test_cuda_on_cpu_tensors_and_unknown_choices_raise(no_build):
    kw = dict(max_iters=10, ring=4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.baselines(**operands(), policy="fcfs", impl="cuda", **kw)
    with pytest.raises(ValueError, match="unknown impl"):
        tops.baselines(**operands(), policy="fcfs", impl="xla", **kw)
    with pytest.raises(ValueError, match="unknown baseline policy"):
        tops.baselines(**operands(), policy="sjf", **kw)
    pw = tdes.pack_workload(tied_workload(1, 30, 12), np.float32, "cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tsched.simulate_backfill(pw, 10.0, 12, impl="cuda")


@pytest.mark.parametrize("field,value,match", [
    ("submit", torch.zeros(29), "runtime has shape"),
    ("runtime", torch.zeros(30, dtype=torch.float64), "runtime has dtype"),
    ("nodes", torch.ones(30), "nodes has dtype"),
    ("nodes", torch.ones(60, dtype=torch.int32)[::2],
     "nodes must be contiguous"),
    ("t_last", torch.ones(1), "t_last has shape"),
    ("s", torch.zeros(2, 1), "submit must be"),
    ("s", torch.zeros(4)[::2], "s must be contiguous"),
    ("s", torch.zeros(2, dtype=torch.float16), "float32 or float64"),
])
def test_operand_errors_come_before_any_build(no_build, field, value, match):
    kw = operands()
    kw[field] = value
    with pytest.raises(ValueError, match=match):
        tops.baselines(**kw, policy="backfill", max_iters=10, ring=4)


@pytest.mark.parametrize("kw,match", [
    (dict(ring=0), "ring must be"), (dict(depth=-1), "depth"),
    (dict(max_iters=-1), "max_iters"),
])
def test_bad_sizes_raise(no_build, kw, match):
    args = dict(max_iters=10, ring=4, depth=8)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        tops.baselines(**operands(), policy="backfill", **args)


def test_no_except_around_the_launch():
    """On a CUDA tensor the wrapper launches the kernel or raises: no
    `try`/`except` could give way to the plain version, and the launch
    counter moves only next to the launch."""
    src = inspect.getsource(tops)
    code = "\n".join(line.split("#")[0] for line in src.splitlines())
    assert "except" not in code and "try:" not in code
    assert code.count("launches += 1") == 1


def test_scalar_init_time_squeezes_the_lane_axis():
    wl = tied_workload(4, n_jobs=40)
    pw = tdes.pack_workload(wl, np.float64, "cpu")
    one = tsched.simulate_backfill(pw, 75.0, wl.params.nodes)
    lanes = tsched.simulate_backfill(pw, [75.0, 0.0], wl.params.nodes)
    assert one.start_t.shape == (40,) and one.n_groups.dim() == 0
    for f in tdes.DesResult._fields:
        assert torch.equal(getattr(one, f), getattr(lanes, f)[0]), f
    with pytest.raises(ValueError, match="scalar or a \\[T\\] lane"):
        tsched.simulate_fcfs(pw, np.zeros((2, 2)), wl.params.nodes)


# --------------------------------------------------------------------------
# the kernel's launch plan (pure Python: no card needed)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("N,ring,depth,is_f64,backfill,nbytes", [
    (5000, 100, 64, False, False, 1600),        # homog f32 FCFS: 100 x 16
    (5000, 100, 64, False, True, 2488),         # + 256 + 157 words (632)
    (5000, 500, 64, True, True, 12888),         # 500 x 24 + 256 + 632
    (5000, 500, 64, True, False, 12000),
    (1, 1, 0, False, True, 40),                 # 4 parts of 8 + 8
    (33, 3, 5, True, True, 112),                # 2 x 24 + 2 x 16 + 24 + 8
])
def test_launch_plan_sizes(N, ring, depth, is_f64, backfill, nbytes):
    plan = tkernel.launch_plan(N, ring, depth, is_f64, backfill)
    assert plan.lane_bytes == tkernel.lane_bytes(N, ring, depth, is_f64,
                                                 backfill) == nbytes
    assert plan.lane_in_smem
    assert plan.started_words == (-(-N // 32) if backfill else 0)


@pytest.mark.parametrize("is_f64", [False, True], ids=["f32", "f64"])
def test_launch_plan_moves_to_the_workspace_past_the_opt_in(is_f64):
    per_slot = 2 * (8 if is_f64 else 4) + 8
    ring = tkernel.SMEM_OPTIN // per_slot
    while tkernel.lane_bytes(100, ring, 64, is_f64, True) > \
            tkernel.SMEM_OPTIN:
        ring -= 1
    assert tkernel.launch_plan(100, ring, 64, is_f64, True).lane_in_smem
    past = tkernel.launch_plan(100, ring + 8, 64, is_f64, True)
    assert not past.lane_in_smem and past.lane_bytes > tkernel.SMEM_OPTIN
    huge = tkernel.launch_plan(10_000_000, 100, 64, is_f64, True)
    assert not huge.lane_in_smem


@pytest.mark.parametrize("args", [(0, 100, 64, False, True),
                                  (10, 0, 64, True, False),
                                  (10, 5, -1, False, True)])
def test_launch_plan_rejects_what_no_launch_has(args):
    with pytest.raises(ValueError):
        tkernel.launch_plan(*args)


def test_reference_workload_fields_are_the_ports():
    """`tied_workload` builds the port's Workload; the reference reads the
    same fields (its pack_workload takes it as its own)."""
    ref = load_reference()
    names = {f.name for f in dataclasses.fields(tlublin.Workload)}
    assert names == {f.name for f in dataclasses.fields(
        ref.lublin.Workload)}
