"""The port's ML-cluster scheduler (`repro_torch.cluster`) against the
reference's `repro.cluster.scheduler.ClusterSim`.

The reference's own tests (tests/test_ckpt_cluster.py:76-221) fail at
collection under jax 0.9 (ROADMAP.md R1), so each is ported here as a
parity test through `load_reference`: the same job types, configuration
and workload go through both simulators (the port's on the CPU), the
reference's assertions are kept, and every metric is held against the
reference's:

  * ``jobs``, ``groups``, ``failures``, ``straggler_kills``, ``requeues``,
    ``requeued_jobs`` and ``unfinished`` exactly;
  * the float metrics (waits, utilizations, lost chip-seconds, makespan)
    and each job's start, finish and credited work at rtol 1e-12: both
    sides keep the accounting in float64 on the host, and the policy calls
    round in float32 on both (JAX with x64 off; the port by design), so
    the expected difference is 0.

Also the sweep of examples/cluster_scheduling.py (its 8 k's, 1 024 chips,
failures and stragglers, seed 7) with its job count cut from 300 to 60,
through the port's examples/cluster_scheduling_torch.py.
"""
import importlib.util
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch import cluster as tcluster
from repro_torch.cluster import scheduler as tsched
from test_torch_reference import load_reference

INT_METRICS = ("jobs", "unfinished", "groups", "failures", "straggler_kills",
               "requeues", "requeued_jobs")
FLOAT_RTOL = 1e-12
TYPES = [("yi-6b:train_4k", 120.0, 16), ("qwen2-moe:train_4k", 300.0, 16),
         ("granite:eval", 60.0, 8)]
EXAMPLE_KS = (0.25, 0.5, 1, 2, 4, 8, 16, 64)
EXAMPLE_JOBS = 60           # the example's 300, cut


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def assert_same_metrics(got: dict, want: dict):
    assert set(got) == set(want)
    for k in INT_METRICS:
        assert got[k] == want[k], k
    for k in set(want) - set(INT_METRICS):
        np.testing.assert_allclose(got[k], want[k], rtol=FLOAT_RTOL,
                                   atol=0, err_msg=k)


def assert_same_jobs(tsim, jsim):
    for field in ("start", "finish", "done_work"):
        got = np.array([getattr(tsim.jobs[i], field)
                        for i in sorted(tsim.jobs)])
        want = np.array([getattr(jsim.jobs[i], field)
                         for i in sorted(jsim.jobs)])
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=0,
                                   err_msg=field)


def run_both(ref, cfg_kw, n_jobs=120, horizon=4 * 3600.0,
             mean_work=64 * 600.0, seed=0, types=TYPES):
    """(port metrics, port sim) after holding both against each other."""
    sims = []
    for mod, extra in ((ref.cluster, {}), (tsched, {"device": "cpu"})):
        jt = [mod.JobType(n, init_time=s, tp_degree=tp)
              for n, s, tp in types]
        sim = mod.ClusterSim(jt, mod.ClusterConfig(**cfg_kw), **extra)
        for j in mod.workload_from_arrival_rate(jt, n_jobs, horizon,
                                                mean_work, seed=seed):
            sim.submit(j)
        sims.append((sim.run(), sim))
    (want, jsim), (got, tsim) = sims
    assert_same_metrics(got, want)
    assert_same_jobs(tsim, jsim)
    return got, tsim


# -------------------------------- tests/test_ckpt_cluster.py, as parity


def test_all_work_completes(ref):
    m, _ = run_both(ref, dict(n_chips=256, scale_ratio=2.0))
    assert m["unfinished"] == 0
    assert m["groups"] <= m["jobs"]           # grouping really groups
    assert 0 < m["useful_util"] <= m["full_util"] <= 1.0 + 1e-9


def test_grouping_amortizes_init(ref):
    m, _ = run_both(ref, dict(n_chips=256, scale_ratio=2.0))
    assert m["groups"] < m["jobs"]


@pytest.mark.parametrize("k", [0.25, 4.0, 64.0])
def test_scale_ratio_tradeoff_matches_paper(ref, k):
    m, _ = run_both(ref, dict(n_chips=256, scale_ratio=k), seed=3)
    assert m["unfinished"] == 0


def test_useful_share_grows_with_k(ref):
    ratio = {}
    for k in (0.25, 64.0):
        m, _ = run_both(ref, dict(n_chips=256, scale_ratio=k), seed=3)
        ratio[k] = m["useful_util"] / max(m["full_util"], 1e-9)
    assert ratio[64.0] >= ratio[0.25] - 1e-6


def test_failures_requeue_and_finish(ref):
    m, _ = run_both(ref, dict(n_chips=256, scale_ratio=2.0,
                              ckpt_period=120.0, mtbf_chip_hours=50.0,
                              seed=1), n_jobs=80)
    assert m["unfinished"] == 0
    assert m["failures"] > 0
    assert m["requeues"] >= m["failures"]
    assert m["lost_chip_seconds"] >= 0.0


def test_ckpt_period_bounds_lost_work(ref):
    lost = {}
    for period in (60.0, 1800.0):
        m, _ = run_both(ref, dict(n_chips=256, scale_ratio=2.0,
                                  ckpt_period=period, mtbf_chip_hours=30.0,
                                  seed=5), n_jobs=100, seed=5)
        lost[period] = m["lost_chip_seconds"] / max(m["failures"], 1)
    assert lost[60.0] <= lost[1800.0] + 1e-6


def test_straggler_mitigation(ref):
    m, _ = run_both(ref, dict(n_chips=256, scale_ratio=2.0,
                              straggler_prob=0.5, straggler_factor=4.0,
                              straggler_deadline=1.5, seed=2), n_jobs=60)
    assert m["straggler_kills"] > 0
    assert m["unfinished"] == 0


def test_slice_granularity(ref):
    for m_chips, tp in ((256, 16), (100, 16), (8, 16), (7, 1)):
        assert tcluster.slice_for(m_chips, tp) == \
            ref.cluster.slice_for(m_chips, tp)
    assert tcluster.slice_for(100, 16) == (6, 16)
    m, _ = run_both(ref, dict(n_chips=64, scale_ratio=1.0))
    assert m["unfinished"] == 0


class _FixedRng:
    """Deterministic rng stub: scripted uniform + exponential streams."""

    def __init__(self, uniforms=(), exponentials=()):
        self.uniforms = list(uniforms)
        self.exponentials = list(exponentials)
        self.exp_scales = []

    def random(self):
        return self.uniforms.pop(0) if self.uniforms else 1.0

    def exponential(self, scale):
        self.exp_scales.append(scale)
        return self.exponentials.pop(0) * scale if self.exponentials \
            else math.inf


def single_job_both(ref, exponentials, work=6000.0, init_time=100.0):
    """One job on 4 chips through both simulators, each with the same
    scripted draws. Returns (port metrics, port sim)."""
    out = []
    for mod, extra in ((ref.cluster, {}), (tsched, {"device": "cpu"})):
        cfg = mod.ClusterConfig(n_chips=4, scale_ratio=2.0,
                                ckpt_period=300.0, mtbf_chip_hours=1.0)
        sim = mod.ClusterSim([mod.JobType("t", init_time=init_time,
                                          tp_degree=1)], cfg, **extra)
        sim.submit(mod.MLJob(jid=0, jtype=0, submit=0.0, work=work))
        sim.rng = _FixedRng(exponentials=exponentials)
        out.append((sim.run(), sim))
    (want, jsim), (got, tsim) = out
    assert_same_metrics(got, want)
    assert_same_jobs(tsim, jsim)
    assert tsim.rng.exp_scales == jsim.rng.exp_scales
    return got, tsim


def test_failure_time_is_group_relative(ref):
    m, sim = single_job_both(ref, [0.75])
    assert sim.rng.exp_scales == [900.0, 900.0]
    assert m["failures"] == 1 and m["requeues"] == 1
    assert m["lost_chip_seconds"] == pytest.approx(275.0 * 4)
    assert m["makespan"] == pytest.approx(1600.0 + 100.0 + 4800.0 / 4)


def test_failure_past_duration_is_survival(ref):
    m, _ = single_job_both(ref, [5.0])
    assert m["failures"] == 0 and m["requeues"] == 0
    assert m["lost_chip_seconds"] == 0.0
    assert m["makespan"] == pytest.approx(1600.0)


def test_requeued_job_reports_last_completion(ref):
    m, sim = single_job_both(ref, [0.75])
    assert m["unfinished"] == 0
    end = 1600.0 + 100.0 + 4800.0 / 4
    assert sim.jobs[0].finish == pytest.approx(end)
    assert sim.jobs[0].start == 0.0
    assert m["makespan"] == pytest.approx(end)


# ------------------------------------------- examples/cluster_scheduling.py


@pytest.fixture(scope="module")
def example():
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "cluster_scheduling_torch.py")
    spec = importlib.util.spec_from_file_location("cluster_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k", EXAMPLE_KS)
def test_example_sweep_cut(ref, example, k):
    """examples/cluster_scheduling_torch.py's `run` against the reference's
    ClusterSim on examples/cluster_scheduling.py's configuration."""
    assert example.KS == EXAMPLE_KS
    got = example.run(k, "cpu", EXAMPLE_JOBS)
    types = [ref.cluster.JobType(t.name, init_time=t.init_time,
                                 tp_degree=t.tp_degree)
             for t in example.TYPES]
    sim = ref.cluster.ClusterSim(types, ref.cluster.ClusterConfig(
        n_chips=1024, scale_ratio=k, ckpt_period=300.0,
        mtbf_chip_hours=200.0, straggler_prob=0.03, seed=7))
    for j in ref.cluster.workload_from_arrival_rate(
            types, EXAMPLE_JOBS, example.HORIZON, example.MEAN_WORK, seed=7):
        sim.submit(j)
    assert_same_metrics(got, sim.run())
    assert got["unfinished"] == 0 and got["jobs"] == EXAMPLE_JOBS


def test_example_prints_its_table(example, capsys):
    example.main(["--device", "cpu", "--jobs", str(EXAMPLE_JOBS)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["k", "|", "avg", "wait", "med", "wait",
                                "groups", "full", "util", "useful", "fails",
                                "lost", "chip-h"]
    assert [float(ln.split("|")[0]) for ln in lines[1:9]] == \
        [float(k) for k in EXAMPLE_KS]


# ----------------------------------------------------------- the policy calls


def test_policy_calls_round_in_float32_as_the_reference(ref):
    """The weights and node thresholds of the same queues at the same time
    are bitwise the reference's (float32 on both sides)."""
    sims = []
    for mod, extra in ((ref.cluster, {}), (tsched, {"device": "cpu"})):
        jt = [mod.JobType(n, init_time=s, tp_degree=tp)
              for n, s, tp in TYPES]
        sim = mod.ClusterSim(jt, mod.ClusterConfig(), **extra)
        for j in mod.workload_from_arrival_rate(jt, 40, 3600.0, 1e4, seed=9):
            sim.queues[j.jtype].append(j)
        sim.t = 1234.5678901
        sims.append(sim)
    jw, jsum, js = sims[0]._weights()
    tw, tsum, ts = sims[1]._weights()
    assert tw.dtype == np.float32 == np.asarray(jw).dtype
    np.testing.assert_array_equal(tw, np.asarray(jw))
    np.testing.assert_array_equal(tsum, jsum)
    for work in (1e4 / 3.0, 123456.789, 7.0):
        for k in (0.1, 0.25, 3.0, 1000.0):
            want = int(ref.packet.m_threshold(work, k, js[1]))
            got = int(tsched.policy.m_threshold(
                sims[1]._f32(work), sims[1]._f32(k), sims[1]._f32(ts[1])))
            assert got == want, (work, k)


def test_cluster_sim_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsched.ClusterSim([tsched.JobType("t", 10.0)], tsched.ClusterConfig())
