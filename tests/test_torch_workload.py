"""The port's own copy of the Lublin generator against the reference's.

`repro_torch.workload.lublin` keeps the same numpy generator calls in the
same order, so `golden_digest()` (sha256 of the arrays, floats rounded to
1e-6 s) must equal the reference module's, and the raw arrays must be
bitwise equal.
"""
import dataclasses

import numpy as np
import pytest

from repro.workload import lublin as ref_lublin   # numpy-only, imports alone
from repro_torch.workload import lublin as t_lublin

CASES = {
    "small_workload": dict(n_jobs=300, nodes=64, load=0.9, homogeneous=True,
                           seed=7),
    "hetero_workload": dict(n_jobs=300, nodes=128, load=0.85,
                            homogeneous=False, seed=3),
    "paper_hetero0.85": dict(nodes=500, load=0.85, homogeneous=False, seed=0),
    "paper_homog0.90": dict(nodes=100, load=0.90, homogeneous=True, seed=1,
                            daily_amplitude=0.3),
}


@pytest.mark.parametrize("name", list(CASES))
def test_digest_matches_reference(name):
    want = ref_lublin.generate_workload(ref_lublin.WorkloadParams(
        **CASES[name]))
    got = t_lublin.generate_workload(t_lublin.WorkloadParams(**CASES[name]))
    assert got.golden_digest() == want.golden_digest()
    for f in ("submit", "runtime", "nodes", "work", "jtype"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert dataclasses.asdict(got.params) == dataclasses.asdict(want.params)


def test_paper_workloads_match_reference():
    got, want = t_lublin.paper_workloads(0), ref_lublin.paper_workloads(0)
    assert list(got) == list(want)
    for name in want:
        assert got[name].golden_digest() == want[name].golden_digest(), name
    assert got["homog0.85"].params.nodes == 100
    assert got["hetero0.85"].params.nodes == 500
    assert got["hetero0.85"].n_jobs == 5000


@pytest.mark.parametrize("s_prop", [0.0, 0.05, 0.5])
def test_init_time_for_proportion(s_prop):
    p = CASES["small_workload"]
    got = t_lublin.generate_workload(t_lublin.WorkloadParams(**p))
    want = ref_lublin.generate_workload(ref_lublin.WorkloadParams(**p))
    assert got.init_time_for_proportion(s_prop) == \
        want.init_time_for_proportion(s_prop)


def test_init_proportion_out_of_range_raises():
    wl = t_lublin.generate_workload(t_lublin.WorkloadParams(n_jobs=20))
    with pytest.raises(ValueError, match="init proportion"):
        wl.init_time_for_proportion(1.0)


def test_calculated_load_hits_the_target():
    wl = t_lublin.generate_workload(t_lublin.WorkloadParams(
        **CASES["hetero_workload"]))
    assert abs(wl.calculated_load() - 0.85) < 1e-9
    assert (np.diff(wl.submit) >= 0).all()
