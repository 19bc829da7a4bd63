"""The DES lanes split over the ranks of a process group, on the CPU.

Four gloo ranks (`test_torch_multihost.run_ranks`) run the fused layouts,
whose lane axis each rank pads with sentinel lanes, runs a block of and
all-gathers (`core/sweep.py`): the reference's own 4-device case
(tests/test_sweep_modes.py:158-230: 80 jobs, 6 lanes, pad 2; the
two-member cohort), the paper's 222-lane grid with chaos on (pad 2, each
lane's fault stream following its lane id), a two-member cohort of such
workloads under that chaos and one window-oracle tick. Every rank's grids are bitwise the fused grids
of one process without a group, the reference's ``np.asarray`` gather;
the split's helpers follow the reference's contract on its cases.
"""
import hashlib

import numpy as np
import pytest

from repro_torch.core import (ChaosConfig, group_workloads, lane_padding,
                              run_cohort_grid, run_packet_grid,
                              run_window_oracle)
from repro_torch.core import sweep as tsweep
from repro_torch.core.des import pack_workload
from repro_torch.workload.lublin import WorkloadParams, generate_workload
from test_torch_multihost import run_ranks
from test_torch_reference import load_reference

KS, S_PROPS = [0.5, 8.0, 100.0], [0.05, 0.5]      # 6 lanes: 6 % 4 != 0
CHAOS = dict(mtbf_chip_hours=50.0, ckpt_period=300.0, straggler_prob=0.05,
             seed=5)
ORACLE_KS = list(tsweep.PAPER_SCALE_RATIOS)       # 37 lanes: pad 3


def small(seed, load=0.9):
    return generate_workload(WorkloadParams(
        n_jobs=80, nodes=32, load=load, homogeneous=True, seed=seed))


def paper_size(seed=3):
    return generate_workload(WorkloadParams(
        n_jobs=400, nodes=32, load=0.9, homogeneous=True, seed=seed))


def grids():
    """Every grid of the group, by name: numpy Metrics."""
    wl, other, big = small(7), small(8, 0.95), paper_size()
    chaos = ChaosConfig(**CHAOS)
    out = {"fused": run_packet_grid(wl, ks=KS, s_props=S_PROPS,
                                    mode="fused", device="cpu")}
    cohort = group_workloads({"a": wl, "b": other}, np.float32)[0]
    for name, m in run_cohort_grid(cohort, ks=KS, s_props=S_PROPS,
                                   mode="fused", device="cpu").items():
        out[f"cohort_{name}"] = m
    out["paper_chaos"] = run_packet_grid(big, chaos=chaos, device="cpu")
    cohort = group_workloads({"a": big, "b": paper_size(4)},
                             np.float32)[0]
    for name, m in run_cohort_grid(cohort, chaos=chaos,
                                   device="cpu").items():
        out[f"paper_cohort_{name}"] = m
    pw = pack_workload(big, np.float32, "cpu")
    out["oracle"] = run_window_oracle(
        pw, ORACLE_KS, big.init_time_for_proportion(0.1), 32, chaos=chaos,
        device="cpu")
    return out


def digest(grid) -> str:
    h = hashlib.sha256()
    for x in grid:
        x = np.asarray(x)
        h.update(str((x.dtype, x.shape)).encode() + x.tobytes())
    return h.hexdigest()


_RANKS = r"""
import json, sys
import numpy as np
from repro_torch.core import cohort_lane_sharding, lane_padding, lane_sharding
from repro_torch.launch import multihost
from test_torch_lane_sharding import digest, grids

multihost.initialize(timeout_s=60, device="cpu")
contract = {"pad": lane_padding(6),
            "lane8_pad": lane_sharding(8, pad=True) is not None,
            "lane6": lane_sharding(6) is None,
            "cohort8_pad": cohort_lane_sharding(8, pad=True) is not None,
            "cohort6": cohort_lane_sharding(6) is None,
            "cohort_spec": list(cohort_lane_sharding(8, pad=True).spec)}
out = grids()
if multihost.process_index() == 0:
    np.savez(sys.argv[1] + "/grids.npz", **{
        f"{name}.{f}": np.asarray(x) for name, g in out.items()
        for f, x in zip(g._fields, g)})
print(json.dumps({"contract": contract,
                  "digests": {k: digest(g) for k, g in out.items()}}))
multihost.shutdown()
"""


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The group's results: each rank's digests and rank 0's grids."""
    tmp = tmp_path_factory.mktemp("lanes")
    outs = run_ranks(_RANKS, 4, tmp)
    saved = np.load(tmp / "grids.npz")
    return outs, {k: saved[k] for k in saved.files}


@pytest.fixture(scope="module")
def alone():
    return grids()


def test_the_split_follows_the_reference_contract(split):
    for out in split[0]:
        assert out["contract"] == {
            "pad": 2, "lane8_pad": True, "lane6": True, "cohort8_pad": True,
            "cohort6": True, "cohort_spec": [None, "lane"]}


@pytest.mark.parametrize("name", ["fused", "cohort_a", "cohort_b",
                                  "paper_chaos", "paper_cohort_a",
                                  "paper_cohort_b", "oracle"])
def test_split_grid_is_bitwise_the_one_process_grid(split, alone, name):
    outs, saved = split
    want = alone[name]
    for f, x in zip(want._fields, want):
        got = saved[f"{name}.{f}"]
        assert got.dtype == x.dtype and got.shape == x.shape, f
        assert np.array_equal(got, x), f
    # every rank holds the whole grid, not its block
    assert {o["digests"][name] for o in outs} == {digest(want)}


def test_split_grid_keeps_the_seq_schedules(alone):
    """The reference's own check of its 4-device case: the fused grid's
    group counts equal mode="seq"'s (here on one process; the split grid
    is bitwise it)."""
    seq = run_packet_grid(small(7), ks=KS, s_props=S_PROPS, mode="seq",
                          device="cpu")
    fused = alone["fused"]
    assert fused.ok.all() and fused.avg_wait.shape == (3, 2)
    np.testing.assert_array_equal(fused.n_groups, seq.n_groups)
    np.testing.assert_allclose(fused.avg_wait, seq.avg_wait, rtol=1e-5,
                               atol=1e-5)


def test_split_cohort_members_are_their_solo_grids(alone):
    """The reference's cohort check: each member of the split cohort
    (bitwise the one-process cohort above) is bitwise its solo fused
    grid."""
    for name, wl in (("cohort_a", small(7)), ("cohort_b", small(8, 0.95))):
        solo = run_packet_grid(wl, ks=KS, s_props=S_PROPS, mode="fused",
                               device="cpu")
        for f, x in zip(solo._fields, solo):
            assert np.array_equal(getattr(alone[name], f), x), (name, f)


def test_chaos_grid_really_faults(alone):
    g = alone["paper_chaos"]
    assert g.avg_wait.shape == (37, 6) and g.failures.sum() > 0
    assert alone["oracle"].avg_wait.shape == (37,)


@pytest.mark.parametrize("n_lanes,n_devices", [
    (222, 1), (222, 2), (222, 4), (222, 8), (4, 4), (1, 4), (5328, 4),
    (666, 8), (37, 4)])
def test_lane_padding_is_the_reference(n_lanes, n_devices):
    ref = load_reference()
    assert lane_padding(n_lanes, n_devices) == \
        ref.sweep.lane_padding(n_lanes, n_devices)


def test_one_rank_splits_nothing():
    """Without a group the split helpers give the reference's one-device
    answers."""
    ref = load_reference()
    for n in (1, 6, 8, 222):
        assert tsweep.lane_sharding(n) is None
        assert tsweep.lane_sharding(n, pad=True) is None
        assert tsweep.cohort_lane_sharding(n, pad=True) is None
        assert ref.sweep.lane_sharding(n, pad=True) is None
        assert lane_padding(n) == ref.sweep.lane_padding(n) == 0


@pytest.mark.parametrize("rank,want", [(0, (0, 56)), (1, (56, 112)),
                                       (3, (168, 224))])
def test_lane_block(rank, want):
    sh = tsweep.LaneSharding(224, 4, rank, ("lane",))
    assert (sh.lanes.start, sh.lanes.stop) == want
