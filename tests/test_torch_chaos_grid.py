"""The chaos axis of the port's grid driver against `repro.core.sweep`.

`run_packet_grid(chaos=<3-cell axis>, device="cpu")` returns ``[K, S, C]``
leaves that draw their own streams (`chaos_uniforms`, bitwise the
reference's):

  * seq = chunked = fused bitwise inside the port (every field), the
    chunked layout with a padded last chunk;
  * against the reference's ``run_packet_grid(..., chaos=...)``:
    `n_groups`, `ok`, `failures`, `straggler_kills`, `requeues`,
    `requeued_jobs` and `budget_exhausted` equal; float metrics within
    rtol 1e-5 (float32) / 1e-12 (float64), the cross-engine chaos bound of
    tests/test_torch_des.py (XLA contracts a multiply-add into an FMA that
    the port rounds twice; measured: a few ulp, lost_work's long float32
    sum up to ~1e-5 relative);
  * `chaos_axis_len`'s two errors, by message;
  * the engines with a ChaosConfig and no streams equal the same calls
    given the reference's streams.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.core import des as tdes
from repro_torch.core import sweep as tsweep
from repro_torch.core.metrics import SCALAR_METRIC_FIELDS
from repro_torch.workload.lublin import WorkloadParams, generate_workload
from test_torch_reference import load_reference

KS = (0.5, 2.0, 20.0)
S_PROPS = (0.05, 0.3)
AXIS = dict(mtbf_chip_hours=np.array([25.0, 100.0, 800.0]),
            ckpt_period=300.0, straggler_prob=0.1,
            straggler_factor=np.array([4.0, 1.5, 1.5]), seed=11)
FLOWS = {
    "homog": (dict(n_jobs=150, nodes=32, load=0.9, homogeneous=True, seed=4,
                   daily_amplitude=0.3), np.float32),
    "hetero": (dict(n_jobs=150, nodes=64, load=0.9, homogeneous=False,
                    seed=4), np.float64),
}
RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}
INT_FIELDS = ("n_groups", "ok", "failures", "straggler_kills", "requeues",
              "requeued_jobs", "budget_exhausted")
FLOAT_FIELDS = SCALAR_METRIC_FIELDS + ("lost_work",)
ENGINE_CHAOS = dict(mtbf_chip_hours=2.0, ckpt_period=120.0,
                    straggler_prob=0.3, straggler_factor=2.5,
                    straggler_deadline=1.8)


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def flow(name):
    params, dtype = FLOWS[name]
    return generate_workload(WorkloadParams(**params)), dtype


@pytest.fixture(scope="module")
def grids():
    """Every layout of both flows, computed once."""
    out = {}
    for name in FLOWS:
        wl, dtype = flow(name)
        for mode in ("fused", "chunked", "seq"):
            out[name, mode] = tsweep.run_packet_grid(
                wl, ks=KS, s_props=S_PROPS, dtype=dtype, mode=mode,
                chunk_lanes=4, chaos=tdes.ChaosConfig(**AXIS), device="cpu")
    return out


@pytest.mark.parametrize("mode", ["chunked", "seq"])
@pytest.mark.parametrize("name", list(FLOWS))
def test_layouts_agree_bitwise(grids, name, mode):
    fused, got = grids[name, "fused"], grids[name, mode]
    assert fused.avg_wait.shape == (len(KS), len(S_PROPS), 3)
    for f in fused._fields:
        assert np.array_equal(getattr(got, f), getattr(fused, f)), f


@pytest.mark.parametrize("name", list(FLOWS))
def test_against_the_reference_grid(ref, grids, name):
    wl, dtype = flow(name)
    want = ref.core.run_packet_grid(wl, ks=KS, s_props=S_PROPS, dtype=dtype,
                                    mode="fused",
                                    chaos=ref.des.ChaosConfig(**AXIS))
    got = grids[name, "fused"]
    assert np.asarray(want.failures).sum() > 0
    assert np.asarray(want.requeues).sum() > 0
    for f in INT_FIELDS:
        w = np.asarray(getattr(want, f))
        assert getattr(got, f).shape == w.shape, f
        assert np.array_equal(getattr(got, f), w), f
    for f in FLOAT_FIELDS:
        w = np.asarray(getattr(want, f))
        assert getattr(got, f).dtype == w.dtype == np.dtype(dtype), f
        np.testing.assert_allclose(getattr(got, f), w, atol=0, err_msg=f,
                                   rtol=RTOL[np.dtype(dtype)])


def test_chaos_injects_and_inert_chaos_is_fault_free(grids):
    wl, dtype = flow("homog")
    got = grids["homog", "fused"]
    assert got.failures.sum() > 0 and got.ok.all()
    # the calm cell (MTBF 800 h) fails least
    assert got.failures[..., 2].sum() < got.failures[..., 0].sum()
    plain = tsweep.run_packet_grid(wl, ks=KS, s_props=S_PROPS, dtype=dtype,
                                   device="cpu")
    inert = tsweep.run_packet_grid(wl, ks=KS, s_props=S_PROPS, dtype=dtype,
                                   chaos=tdes.ChaosConfig(), device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(plain, inert))


def test_scalar_chaos_keeps_the_grid_shape(ref):
    wl, dtype = flow("homog")
    chaos = dict(mtbf_chip_hours=50.0, straggler_prob=0.1, seed=3)
    got = tsweep.run_packet_grid(wl, ks=KS[:2], s_props=S_PROPS[:1],
                                 dtype=dtype, chaos=tdes.ChaosConfig(**chaos),
                                 device="cpu")
    want = ref.core.run_packet_grid(wl, ks=KS[:2], s_props=S_PROPS[:1],
                                    dtype=dtype,
                                    chaos=ref.des.ChaosConfig(**chaos))
    assert got.avg_wait.shape == (2, 1)
    for f in INT_FIELDS:
        assert np.array_equal(getattr(got, f), np.asarray(getattr(want, f)))


class TestChaosAxisLen:
    def test_lengths(self):
        assert tsweep.chaos_axis_len(None) == 1
        assert tsweep.chaos_axis_len(tdes.ChaosConfig()) == 1
        assert tsweep.chaos_axis_len(tdes.ChaosConfig(**AXIS)) == 3
        assert tsweep.chaos_axis_len(tdes.ChaosConfig(
            mtbf_chip_hours=np.array([5.0]), straggler_prob=0.1)) == 1

    def test_mismatched_lengths_raise_by_name(self):
        chaos = tdes.ChaosConfig(mtbf_chip_hours=np.array([1.0, 2.0]),
                                 straggler_prob=np.array([0.1, 0.2, 0.3]))
        with pytest.raises(ValueError, match=r"mismatched chaos-axis "
                           r"lengths: mtbf_chip_hours\[2\], "
                           r"straggler_prob\[3\]"):
            tsweep.chaos_axis_len(chaos)

    def test_two_dimensional_parameter_raises(self):
        chaos = tdes.ChaosConfig(ckpt_period=np.ones((2, 2)))
        with pytest.raises(ValueError, match=r"ChaosConfig.ckpt_period must "
                           r"be a scalar or a 1-D chaos axis"):
            tsweep.chaos_axis_len(chaos)

    def test_lane_grid_is_grid_major_chaos_minor(self):
        lanes, C = tsweep.chaos_lane_grid(tdes.ChaosConfig(**AXIS), 2,
                                          np.float32)
        assert C == 3
        assert lanes.lane.tolist() == list(range(6))
        assert lanes.mtbf_chip_hours.tolist() == [25, 100, 800] * 2
        assert lanes.ckpt_period.dtype == np.float32
        assert lanes.seed == 11


def ref_streams(ref, dtype, lanes, cap, seed=11):
    """The reference's [cap, T] u1 / u2 for the given lane ids."""
    with ref.precision.dtype_scope(dtype):
        u = np.stack([np.asarray(ref.des.chaos_uniforms(
            ref.des.ChaosConfig(seed=seed, lane=int(lane)), dtype, cap))
            for lane in lanes])
    return (torch.tensor(np.ascontiguousarray(u[:, :, 0].T)),
            torch.tensor(np.ascontiguousarray(u[:, :, 1].T)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_engines_draw_the_reference_streams(ref, dtype):
    wl = generate_workload(WorkloadParams(n_jobs=120, nodes=32, load=0.9,
                                          homogeneous=False, seed=5))
    N, M = wl.n_jobs, int(wl.params.nodes)
    pw = tdes.pack_workload(wl, dtype, device="cpu")
    lanes = np.array([0, 7, 665, 3])
    ks = np.array([0.5, 2.0, 8.0, 40.0])
    ss = np.full(4, wl.init_time_for_proportion(0.1))
    chaos = tdes.ChaosConfig(seed=11, lane=lanes, **ENGINE_CHAOS)
    u1, u2 = ref_streams(ref, dtype, lanes, 2 * N)
    for engine in (tdes.simulate_packet_scan_lanes, tdes.simulate_packet):
        own = engine(pw, ks, ss, M, chaos=chaos, device="cpu")
        given = engine(pw, ks, ss, M, chaos=chaos, u1=u1, u2=u2,
                       device="cpu")
        assert int(own.requeues.sum()) > 0
        for f in tdes.DesResult._fields:
            assert torch.equal(getattr(own, f), getattr(given, f)), f
    one = tdes.simulate_packet_scan(
        pw, ks[2], ss[2], M, device="cpu",
        chaos=tdes.ChaosConfig(seed=11, lane=665, **ENGINE_CHAOS))
    lane2 = tdes.simulate_packet_scan_lanes(pw, ks, ss, M, chaos=chaos,
                                            device="cpu")
    for f in tdes.DesResult._fields:
        assert torch.equal(getattr(one, f), getattr(lane2, f)[2]), f
