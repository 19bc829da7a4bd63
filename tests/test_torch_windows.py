"""The port's windowing layer against `repro.workload.windows`.

`repro_torch.workload.windows` is a numpy copy bound to the port's
generator: window bounds, slices (raw and rebased), the packed tables of a
window in both dtypes, `iter_windows*` and the drift scenarios equal the
reference's array by array, bit for bit, and the drift digests are those
pinned by tests/test_windows.py.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses

import numpy as np
import pytest

from repro_torch.core import des as tdes
from repro_torch.workload import windows as tw
from repro_torch.workload.lublin import WorkloadParams, generate_workload
from test_torch_reference import load_reference

PARAMS = WorkloadParams(n_jobs=600, nodes=100, load=0.9, homogeneous=True,
                        seed=5)
FIELDS = ("submit", "runtime", "nodes", "work", "jtype")
# drift_scenarios(n_jobs=320, nodes=100, n_segments=4): the digests of
# tests/test_windows.py :: GOLDEN
GOLDEN = {
    "steady": {
        "submit": "484664cfa46c63c70a9fe7b2f30124e7cb01292827b6adcbb432bd5fd625828a",
        "runtime": "b21858f93a76eb595474ac10ca578bbe84b48300b42454373761605989d263f8",
        "nodes": "ed16e9ba74a6809655cb8629519c6c2fa6f8c32a6a05566d01ee0552a005fd16",
        "jtype": "511ce8a53ba5ef6f7f0cfd9a9fcb134faa11e45ffe363322afbaea3ed235d83b",
    },
    "intensity_ramp": {
        "submit": "484664cfa46c63c70a9fe7b2f30124e7cb01292827b6adcbb432bd5fd625828a",
        "runtime": "3effd4602039af071a872fb7af1316155b4dd7fba2e492fdb3c8f0075f027d1b",
        "nodes": "ed16e9ba74a6809655cb8629519c6c2fa6f8c32a6a05566d01ee0552a005fd16",
        "jtype": "511ce8a53ba5ef6f7f0cfd9a9fcb134faa11e45ffe363322afbaea3ed235d83b",
    },
    "intensity_step": {
        "submit": "484664cfa46c63c70a9fe7b2f30124e7cb01292827b6adcbb432bd5fd625828a",
        "runtime": "bd18cd4d03d2f63eb926579c4c4adc1409ce21ac084225617f1330f61d3ec2fd",
        "nodes": "ed16e9ba74a6809655cb8629519c6c2fa6f8c32a6a05566d01ee0552a005fd16",
        "jtype": "511ce8a53ba5ef6f7f0cfd9a9fcb134faa11e45ffe363322afbaea3ed235d83b",
    },
    "homogeneity_ramp": {
        "submit": "484664cfa46c63c70a9fe7b2f30124e7cb01292827b6adcbb432bd5fd625828a",
        "runtime": "b8805bc46af9e05e3adbbf56bdf2ff1169e8c86de422521c5a9ec5fd72d1f265",
        "nodes": "ed16e9ba74a6809655cb8629519c6c2fa6f8c32a6a05566d01ee0552a005fd16",
        "jtype": "511ce8a53ba5ef6f7f0cfd9a9fcb134faa11e45ffe363322afbaea3ed235d83b",
    },
    "homogeneity_step": {
        "submit": "05e5566675be4515bdf6e22efc2b5acfa4cc832603651184b9b929b7564cb435",
        "runtime": "2ff08aeccdc4c93a42b264f141af8f1278077985e15c75261409cafb4e355c65",
        "nodes": "2d3aca7b5c64d5afff5f9b9b40dc1999e4c0691b7f8f218beffaf701e52c5cac",
        "jtype": "6165026fb1746ef1d82f249744aa6f6493da07b05eb555c91941d412a526be18",
    },
}
SPECS = [tw.WindowSpec(200), tw.WindowSpec(200, stride_jobs=100),
         tw.WindowSpec(250, stride_jobs=300), tw.WindowSpec(150, rebase=False)]


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def ref_spec(ref, spec):
    return ref.windows.WindowSpec(spec.window_jobs, spec.stride_jobs,
                                  spec.rebase)


def assert_same_workload(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert dataclasses.asdict(got.params) == dataclasses.asdict(want.params)


@pytest.mark.parametrize("n_jobs", [0, 100, 590, 600])
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_bounds_and_dropped_match_the_reference(ref, spec, n_jobs):
    rs = ref_spec(ref, spec)
    assert tw.window_bounds(n_jobs, spec) == ref.windows.window_bounds(
        n_jobs, rs)
    assert tw.n_dropped(n_jobs, spec) == ref.windows.n_dropped(n_jobs, rs)


def test_hand_bounds():
    assert tw.window_bounds(600, tw.WindowSpec(200, stride_jobs=100)) == [
        (0, 200), (100, 300), (200, 400), (300, 500), (400, 600)]
    assert tw.window_bounds(590, tw.WindowSpec(200)) == [(0, 200),
                                                        (200, 400)]
    assert tw.n_dropped(590, tw.WindowSpec(200)) == 190
    assert tw.n_dropped(100, tw.WindowSpec(200)) == 100


@pytest.mark.parametrize("rebase", [True, False])
def test_slice_window_matches_the_reference(ref, rebase):
    wl = generate_workload(PARAMS)
    got = tw.slice_window(wl, 100, 300, rebase=rebase)
    want = ref.windows.slice_window(wl, 100, 300, rebase=rebase)
    assert_same_workload(got, want)
    if not rebase:
        for f in FIELDS:
            assert np.shares_memory(getattr(got, f), getattr(wl, f))
    else:
        assert got.submit[0] == 0.0
        assert np.shares_memory(got.runtime, wl.runtime)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_packed_window_is_a_bitwise_slice(ref, dtype):
    """The per-job packed tables of a window are slices of the full
    trace's, and every packed table equals the reference's packing."""
    wl = generate_workload(PARAMS)
    full = tdes.pack_workload(wl, dtype, device="cpu")
    win = tw.slice_window(wl, 150, 350, rebase=False)
    pw = tdes.pack_workload(win, dtype, device="cpu")
    for f in ("work", "runtime", "nodes", "jtype"):
        a = getattr(pw, f).numpy()
        b = getattr(full, f).numpy()[150:350]
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    with ref.precision.dtype_scope(dtype):
        want = ref.des.pack_workload(
            ref.windows.slice_window(wl, 150, 350, rebase=False), dtype)
        for f in ("submit", "work", "tj_submit", "tj_prefw", "cumw",
                  "rank", "t_last_submit"):
            assert np.array_equal(getattr(pw, f).numpy(),
                                  np.asarray(getattr(want, f))), f


def test_out_of_range_raises():
    wl = generate_workload(PARAMS)
    for lo, hi in ((-1, 10), (10, 10), (590, 601), (300, 200)):
        with pytest.raises(ValueError, match="out of range"):
            tw.slice_window(wl, lo, hi)


def test_invalid_spec():
    with pytest.raises(ValueError, match="window_jobs"):
        tw.WindowSpec(0)
    with pytest.raises(ValueError, match="stride_jobs"):
        tw.WindowSpec(10, stride_jobs=0)


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_iter_windows_matches_the_reference(ref, spec):
    wl = generate_workload(PARAMS)
    got = list(tw.iter_windows(wl, spec))
    want = list(ref.windows.iter_windows(wl, ref_spec(ref, spec)))
    assert [(lo, hi) for lo, hi, _ in got] == [(lo, hi) for lo, hi, _ in
                                               want]
    for (_, _, a), (_, _, b) in zip(got, want):
        assert_same_workload(a, b)
    shapes = {tuple(x.shape for x in tdes.pack_workload(w, device="cpu")[:10])
              for _, _, w in got}
    assert len(shapes) == 1      # every window packs to the same shapes


def test_iter_windows_batch_matches_the_reference(ref):
    flows = {f"r{r}": generate_workload(dataclasses.replace(
        PARAMS, n_jobs=300, seed=PARAMS.seed + r)) for r in range(2)}
    got = list(tw.iter_windows_batch(flows, tw.WindowSpec(150)))
    want = list(ref.windows.iter_windows_batch(flows,
                                               ref.windows.WindowSpec(150)))
    assert [r[:3] for r in got] == [("r0", 0, 150), ("r0", 150, 300),
                                    ("r1", 0, 150), ("r1", 150, 300)]
    assert [r[:3] for r in got] == [r[:3] for r in want]
    for a, b in zip(got, want):
        assert_same_workload(a[3], b[3])


@pytest.mark.parametrize("kw", [
    dict(n_jobs=320, nodes=100, n_segments=4),
    dict(n_jobs=600, nodes=100, n_segments=8, seed=3)], ids=["320", "600"])
def test_drift_scenarios_match_the_reference(ref, kw):
    got = tw.drift_scenarios(**kw)
    want = ref.windows.drift_scenarios(**kw)
    assert list(got) == list(want)
    for name in got:
        assert_same_workload(got[name], want[name])


def test_golden_digests():
    got = {n: wl.golden_digest() for n, wl in tw.drift_scenarios(
        n_jobs=320, nodes=100, n_segments=4).items()}
    assert got == GOLDEN


def test_drift_workload_overrides_match_the_reference(ref):
    base = dataclasses.replace(PARAMS, n_jobs=200)
    kw = dict(loads=[0.8, 0.95], homogeneous=[True, False],
              homog_shrinks=0.5)
    assert_same_workload(tw.drift_workload(base, **kw),
                         ref.windows.drift_workload(base, **kw))


def test_drift_segment_count_validation():
    base = dataclasses.replace(PARAMS, n_jobs=100)
    with pytest.raises(ValueError, match="n_segments"):
        tw.drift_workload(base)
    with pytest.raises(ValueError, match="3 entries but the scenario has 4"):
        tw.drift_workload(base, n_segments=4, loads=[0.9] * 3)
    with pytest.raises(ValueError, match="too small"):
        tw.drift_workload(base, n_segments=200)
