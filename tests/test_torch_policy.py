"""The port's policy formulas against `repro.core.packet`: exact.

Same inputs, made from a seed with numpy, go through the JAX functions and
their PyTorch counterparts; every output must be bitwise equal (each
formula is a short chain of elementwise IEEE operations in the same
order), in float32 and float64, per lane (``[T]``) and over ``[H, T]``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.core import packet as tpacket
from test_torch_reference import load_reference

DTYPES = [np.float32, np.float64]
IDS = ["float32", "float64"]


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def both(ref, dtype, fn_name, *args):
    """Run `fn_name` on both sides; bool/int arrays pass through as is."""
    with ref.precision.dtype_scope(dtype):
        want = np.asarray(getattr(ref.packet, fn_name)(
            *(ref.jnp.asarray(a) for a in args)))
    got = getattr(tpacket, fn_name)(*(torch.tensor(a) for a in args)).numpy()
    return got, want


def inputs(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    work = rng.gamma(2.0, 5e4, shape).astype(dtype)
    work[rng.random(shape) < 0.2] = 0
    k = (10.0 ** rng.uniform(-1, 3, shape[-1])).astype(dtype)
    s = rng.uniform(1.0, 4000.0, shape[-1]).astype(dtype)
    m_free = rng.integers(0, 500, shape[-1]).astype(np.int32)
    return work, k, s, m_free


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("shape", [(64,), (8, 16)], ids=["lane", "HxT"])
@pytest.mark.parametrize("seed", [0, 1])
class TestAgainstReference:
    def test_m_threshold(self, ref, dtype, shape, seed):
        work, k, s, _ = inputs(dtype, shape, seed)
        got, want = both(ref, dtype, "m_threshold", work, k, s)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)

    def test_group_nodes(self, ref, dtype, shape, seed):
        work, k, s, m_free = inputs(dtype, shape, seed)
        got, want = both(ref, dtype, "group_nodes", work, k, s, m_free)
        assert np.array_equal(got, want)
        assert got.min() >= 0 and (got <= m_free).all()

    def test_group_duration(self, ref, dtype, shape, seed):
        work, k, s, m_free = inputs(dtype, shape, seed)
        m = np.asarray(tpacket.group_nodes(*(torch.tensor(a) for a in (
            work, k, s, m_free))))
        got, want = both(ref, dtype, "group_duration", work, s, m)
        assert got.dtype == want.dtype == np.dtype(dtype)
        assert np.array_equal(got, want)

    def test_queue_weights(self, ref, dtype, shape, seed):
        rng = np.random.default_rng(seed + 10)
        H, T = 8, shape[-1]
        sum_w = rng.gamma(2.0, 5e4, (H, T)).astype(dtype)
        s = rng.uniform(1.0, 4000.0, T).astype(dtype)
        prio = rng.uniform(0.5, 2.0, (H, 1)).astype(dtype)
        oldest = rng.uniform(0.0, 3e5, (H, T)).astype(dtype)
        oldest[rng.random((H, T)) < 0.2] = np.inf
        now = rng.uniform(0.0, 3e5, T).astype(dtype)
        t_max = np.full((H, 1), 3600.0, dtype)
        nonempty = rng.random((H, T)) < 0.7
        got, want = both(ref, dtype, "queue_weights", sum_w, s, prio, oldest,
                         now, t_max, nonempty)
        assert np.array_equal(got, want)
        assert np.isneginf(got[~nonempty]).all()
        # ties and order decide schedules: the argmax agrees too
        assert np.array_equal(got.argmax(0), want.argmax(0))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("k,nodes", [(0.5, 8), (1.0, 4), (2.0, 2), (4.0, 1)])
def test_paper_worked_example(dtype, k, nodes):
    """Fig. 3: s = 1 min, total work 4 node-minutes."""
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    work = torch.tensor([240.0], dtype=tdt)
    s = torch.tensor([60.0], dtype=tdt)
    kk = torch.tensor([k], dtype=tdt)
    m = tpacket.group_nodes(work, kk, s, torch.tensor([100],
                                                      dtype=torch.int32))
    assert int(m) == nodes
    dur = tpacket.group_duration(work, s, m)
    assert float(dur) == 60.0 + 240.0 / nodes
    # fewer free nodes than the threshold: the group takes what is free
    m2 = tpacket.group_nodes(work, kk, s, torch.tensor([1],
                                                       dtype=torch.int32))
    assert int(m2) == 1


def test_no_free_nodes_gives_zero_and_safe_duration():
    work = torch.tensor([500.0])
    m = tpacket.group_nodes(work, torch.tensor([1.0]), torch.tensor([10.0]),
                            torch.tensor([0], dtype=torch.int32))
    assert int(m) == 0
    assert torch.isfinite(tpacket.group_duration(work, torch.tensor([10.0]),
                                                 m)).all()
