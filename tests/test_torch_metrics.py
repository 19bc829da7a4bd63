"""`efficiency_metrics` of the port against `repro.core.metrics`.

Both sides get the same DesResult arrays, made from a seed with numpy
(one lane at a time on the JAX side, all lanes at once in the port).
Tolerance: rtol 1e-6 (float32) / 1e-12 (float64) — the means are sums
taken in another order. The median is the midpoint of the two middle
values on both sides (even N), checked exactly, with unstarted (+inf)
jobs included.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.core import des as tdes
from repro_torch.core import metrics as tmetrics
from test_torch_reference import load_reference

RTOL = {np.dtype(np.float32): 1e-6, np.dtype(np.float64): 1e-12}


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def make_result(dtype, n_jobs, n_lanes, seed, n_unstarted=0):
    rng = np.random.default_rng(seed)
    submit = np.sort(rng.uniform(0, 3e5, n_jobs)).astype(dtype)
    start = (submit[None, :] + rng.gamma(1.5, 2e3, (n_lanes, n_jobs))
             ).astype(dtype)
    start[:, rng.random(n_jobs) < 0.3] = submit[rng.random(n_jobs) < 0.3][0]
    run_start = (start + rng.uniform(10, 500, (n_lanes, n_jobs))
                 ).astype(dtype)
    if n_unstarted:
        start[:, -n_unstarted:] = np.inf
        run_start[:, -n_unstarted:] = np.inf
    f = lambda lo, hi: rng.uniform(lo, hi, n_lanes).astype(dtype)
    i = lambda hi: rng.integers(0, hi, n_lanes).astype(np.int32)
    fields = dict(
        start_t=start, run_start_t=run_start, qlen_int=f(0, 1e7),
        busy_ns=f(0, 2e7), useful_ns=f(0, 2e7), n_groups=i(n_jobs),
        makespan=f(3e5, 4e5), ok=rng.random(n_lanes) < 0.8,
        budget_exhausted=rng.random(n_lanes) < 0.2, lost_work=f(0, 1e4),
        failures=i(9), straggler_kills=i(9), requeues=i(9),
        requeued_jobs=i(99))
    return submit, fields


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("n_jobs,n_unstarted", [(300, 0), (301, 0),
                                                (300, 170), (301, 151)],
                         ids=["even", "odd", "even-inf-middle",
                              "odd-inf-middle"])
def test_against_reference(ref, dtype, n_jobs, n_unstarted):
    n_lanes, m_nodes = 5, 64
    submit, fields = make_result(dtype, n_jobs, n_lanes, 3, n_unstarted)
    t_last = submit[-1]
    got = tmetrics.efficiency_metrics(
        torch.tensor(submit),
        tdes.DesResult(**{k: torch.tensor(v) for k, v in fields.items()}),
        m_nodes, torch.tensor(t_last))
    rtol = RTOL[np.dtype(dtype)]
    with ref.precision.dtype_scope(dtype):
        jnp = ref.jnp
        for lane in range(n_lanes):
            res = ref.des.DesResult(**{k: jnp.asarray(v[lane])
                                       for k, v in fields.items()})
            want = ref.metrics.efficiency_metrics(
                jnp.asarray(submit), res, m_nodes, jnp.asarray(t_last))
            for f in want._fields:
                w = np.asarray(getattr(want, f))
                g = getattr(got, f)[lane].numpy()
                assert g.dtype == w.dtype, f
                if f == "med_wait" or w.dtype.kind in "bi":
                    assert np.array_equal(g, w), (f, g, w)
                else:
                    np.testing.assert_allclose(g, w, rtol=rtol, atol=0,
                                               err_msg=f)


def test_median_is_the_midpoint_not_the_lower_value():
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0], [1.0, 2.0, 3.0, float("inf")]])
    assert tmetrics._median_last(x).tolist() == [2.5, 2.5]
    assert torch.median(x[0]).item() == 2.0      # what torch alone would give
    y = torch.tensor([1.0, float("inf"), float("inf")])
    assert tmetrics._median_last(y).item() == float("inf")


def test_metric_field_tables_match_reference(ref):
    assert tmetrics.SCALAR_METRIC_FIELDS == ref.metrics.SCALAR_METRIC_FIELDS
    assert tmetrics.METRIC_REL_FLOORS == ref.metrics.METRIC_REL_FLOORS
    assert tmetrics.Metrics._fields == ref.metrics.Metrics._fields
