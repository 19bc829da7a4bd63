"""The port's threefry stream generator against `jax.random`, bit for bit.

`repro_torch.core.prng` reproduces the raw keys of `PRNGKey` and
`fold_in` and the float32 / float64 draws of `uniform` under the
partitionable threefry layout (jax 0.9's default), and
`repro_torch.core.des.chaos_uniforms` the reference's per-lane chaos
streams. Every comparison is of bit patterns (`np.array_equal` on the
unsigned views): the generator is integer arithmetic, so any difference
is a fault.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.core import des as tdes
from repro_torch.core import prng
from test_torch_reference import load_reference

SEEDS = [0, 6, 11, 118, 2**31 + 5]
LANES = [0, 1, 665, 2**31 - 1]
CAPS = [1, 7, 2 * 240]
DTYPES = [np.float32, np.float64]
BITS = {np.dtype(np.float32): np.uint32, np.dtype(np.float64): np.uint64}


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(BITS[a.dtype])


def test_the_reference_draws_partitionable_threefry(ref):
    assert ref.jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS + [2**32 + 7, -1])
def test_prng_key_words(ref, seed):
    want = np.asarray(ref.jax.random.key_data(ref.jax.random.PRNGKey(seed)))
    got = prng.PRNGKey(seed).numpy().astype(np.uint32)
    assert want.dtype == np.uint32 and np.array_equal(got, want)


def test_prng_key_refuses_a_seed_past_int64():
    with pytest.raises(ValueError, match="int64"):
        prng.PRNGKey(2**63)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_words(ref, seed):
    jr, jnp = ref.jax.random, ref.jnp
    base = jr.PRNGKey(seed)
    want = np.stack([np.asarray(jr.key_data(jr.fold_in(
        base, jnp.asarray(lane, jnp.uint32)))) for lane in LANES])
    got = prng.fold_in(prng.PRNGKey(seed), np.asarray(LANES))
    assert tuple(got.shape) == (len(LANES), 2)
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    one = prng.fold_in(prng.PRNGKey(seed), LANES[2])
    assert np.array_equal(one.numpy().astype(np.uint32), want[2])


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 2), (2, 3, 4)])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_uniform_bits(ref, shape, dtype):
    jr = ref.jax.random
    with ref.precision.dtype_scope(dtype):
        want = np.asarray(jr.uniform(jr.PRNGKey(7), shape, dtype=dtype))
    got = prng.uniform(prng.PRNGKey(7), shape,
                       getattr(torch, np.dtype(dtype).name)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(bits(got), bits(want))
    assert got.min() >= 0.0 and got.max() < 1.0


def test_uniform_refuses_other_types():
    with pytest.raises(ValueError, match="float32 or float64"):
        prng.uniform(prng.PRNGKey(0), (2,), torch.float16)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_chaos_uniforms_bitwise(ref, dtype, seed, cap):
    """Every lane of LANES, one call each on the reference's side and one
    vectorised call on the port's."""
    with ref.precision.dtype_scope(dtype):
        want = np.stack([np.asarray(ref.des.chaos_uniforms(
            ref.des.ChaosConfig(seed=seed, lane=lane), dtype, cap))
            for lane in LANES])
    got = tdes.chaos_uniforms(
        tdes.ChaosConfig(seed=seed, lane=np.asarray(LANES)), dtype, cap,
        device="cpu").numpy()
    assert got.shape == (len(LANES), max(1, cap), 2)
    assert np.array_equal(bits(got), bits(want))
    scalar = tdes.chaos_uniforms(tdes.ChaosConfig(seed=seed, lane=LANES[1]),
                                 dtype, cap, device="cpu").numpy()
    assert np.array_equal(bits(scalar), bits(want[1]))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_chaos_uniforms_seed_past_32_bits(ref, dtype):
    """Float32 draws key the seed as JAX's 32-bit mode does (high word
    zeroed), float64 ones as its 64-bit scope does."""
    seed = 2**32 + 7
    with ref.precision.dtype_scope(dtype):
        want = np.asarray(ref.des.chaos_uniforms(
            ref.des.ChaosConfig(seed=seed, lane=3), dtype, 9))
    got = tdes.chaos_uniforms(tdes.ChaosConfig(seed=seed, lane=3), dtype, 9,
                              device="cpu").numpy()
    assert np.array_equal(bits(got), bits(want))


def test_chaos_uniforms_cap_floor_and_lane_tensor(ref):
    a = tdes.chaos_uniforms(tdes.ChaosConfig(seed=11, lane=2), np.float32, 0,
                            device="cpu")
    assert tuple(a.shape) == (1, 2)
    lanes = torch.tensor([2, 5], dtype=torch.int32)
    b = tdes.chaos_uniforms(tdes.ChaosConfig(seed=11, lane=lanes),
                            np.float32, 1, device="cpu")
    assert torch.equal(b[0], a)
