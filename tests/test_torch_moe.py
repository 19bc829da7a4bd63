"""The port's MoE layer against the reference's `repro.models.moe`.

On the reduced float32 configs of qwen2-moe-a2.7b and arctic-480b (4
experts, top-2, d 64, expert f 64), with the reference's own `moe_init`
parameters carried over as numpy arrays and the same inputs made with
numpy:

- routes (the top-k expert indices) equal, gates and router probabilities
  within 1e-5; a failure prints the smallest margin between the k-th and
  (k+1)-th probability, so that a flip at a near tie shows as one;
- capacity equal over a grid of (S, k, E, cf);
- both dispatches (gather, einsum) within rtol = atol = 1e-5 of the
  reference's, at the config's capacity factor 1.25 and at 0.5 (choices
  dropped, asserted), and the aux loss within 1e-6;
- with capacity for every choice, both against the per-token dense top-k
  mixture, the reference's own oracle (tests/test_archs.py:104), at its
  rtol 2e-4 / atol 2e-5;
- ties go to the lower expert index, as `jax.lax.top_k` gives them;
- a router wider than ``n_experts`` masks its dead experts, as the
  reference's does;
- the gradients of the gather dispatch against `jax.grad` of the
  reference's within 1e-5 of each leaf's largest magnitude.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import moe as tmoe
from repro_torch.sharding.policy import single_device_policy
from test_torch_reference import load_reference

ARCHS = ("qwen2-moe-a2.7b", "arctic-480b")
TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def setup(ref, arch, seed=0, **overrides):
    """(jc, jpol, jp, tc, tpol, tp): the reference's `moe_init` parameters
    on both sides."""
    jc = ref.configs.smoke_config(arch, **overrides)
    tc = smoke_config(arch, **overrides)
    jpol = ref.policy.single_device_policy(jc)
    jp, _ = ref.layers.unbox(ref.moe.moe_init(ref.jax.random.PRNGKey(seed),
                                              jc, jpol))
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    return jc, jpol, jp, tc, single_device_policy(tc), tp


def inputs(B=2, S=16, d=64, seed=3):
    return (np.random.default_rng(seed).standard_normal((B, S, d))
            * 0.5).astype(np.float32)


def margin(probs: np.ndarray, k: int) -> float:
    """Smallest gap between the k-th and (k+1)-th router probability."""
    top = -np.sort(-probs, axis=-1)
    return float((top[..., k - 1] - top[..., k]).min())


def assert_routes_equal(ti, ji, probs, k):
    assert np.array_equal(ti, ji), (
        f"routes differ; smallest top-{k} margin {margin(probs, k):.3e}")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_structure(ref, arch):
    """Router [d, E] float32 beside experts in the param dtype, as the
    reference's (a bf16 variant of the reduced config)."""
    jc = ref.configs.smoke_config(arch, param_dtype="bfloat16")
    jp, _ = ref.layers.unbox(ref.moe.moe_init(
        ref.jax.random.PRNGKey(0), jc, ref.policy.single_device_policy(jc)))
    tc = smoke_config(arch, param_dtype="bfloat16")
    got = tmoe.moe_init(torch.Generator().manual_seed(0), tc,
                        single_device_policy(tc))
    assert sorted(got) == sorted(jp)
    for k, v in jp.items():
        assert tuple(got[k].shape) == v.shape, k
    assert got["router"].dtype == torch.float32
    assert np.asarray(jp["router"]).dtype == np.float32
    for k in ("wi", "wg", "wo"):
        assert got[k].dtype == torch.bfloat16
        assert np.asarray(jp[k]).dtype.name == "bfloat16"
    # drawn at the reference's scales: experts 1/sqrt(d), router 0.02
    s = 1.0 / np.sqrt(tc.d_model)
    np.testing.assert_allclose(float(got["wi"].float().std()), s, rtol=0.05)
    np.testing.assert_allclose(float(got["router"].std()), 0.02, rtol=0.1)


def test_capacity_is_the_references(ref):
    for S in (1, 7, 16, 2048):
        for k in (1, 2, 4):
            for E in (4, 60, 128):
                for cf in (0.5, 1.25, 15.0):
                    assert tmoe.capacity(S, k, E, cf) == \
                        ref.moe.capacity(S, k, E, cf), (S, k, E, cf)
    assert tmoe.capacity(2048, 4, 60, 1.25) == 171
    assert tmoe.capacity(2048, 2, 128, 1.25) == 40


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(ref, arch):
    jc, _, jp, tc, _, tp = setup(ref, arch)
    x = inputs()
    jg, ji, jpr = ref.moe._route(jp, jc, ref.jnp.asarray(x))
    tg, ti, tpr = tmoe._route(tp, tc, torch.from_numpy(x))
    jpr = np.asarray(jpr)
    assert_routes_equal(ti.numpy(), np.asarray(ji), jpr,
                        tc.experts_per_token)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(tpr.numpy(), jpr, **TOL)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5"])
@pytest.mark.parametrize("impl", ["gather", "einsum"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(ref, arch, impl, cf):
    jc, jpol, jp, tc, tpol, tp = setup(ref, arch, capacity_factor=cf)
    x = inputs()
    jo, ja = ref.moe.moe_forward(jp, jc, jpol, ref.jnp.asarray(x), impl=impl)
    to, ta = tmoe.moe_forward(tp, tc, tpol, torch.from_numpy(x), impl=impl)
    _, ti, _ = tmoe._route(tp, tc, torch.from_numpy(x))
    counts = torch.stack([torch.bincount(r.reshape(-1), minlength=4)
                          for r in ti])
    C = tmoe.capacity(16, tc.experts_per_token, 4, cf)
    if cf == 0.5:
        assert bool((counts > C).any())           # choices are dropped
    assert to.dtype == torch.float32 and to.shape == (2, 16, 64)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=AUX_TOL)


@pytest.mark.parametrize("impl", ["gather", "einsum"])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_for_all_is_the_dense_mixture(ref, arch, impl):
    """With capacity for every choice (cf 8, the reference's oracle test),
    the layer is each token's gate-weighted top-k expert mixture."""
    jc, jpol, jp, tc, tpol, tp = setup(ref, arch, capacity_factor=8.0,
                                       shared_expert_d_ff=0)
    x = inputs(seed=4)
    out, _ = tmoe.moe_forward(tp, tc, tpol, torch.from_numpy(x), impl=impl)
    # oracle in numpy from the reference's top-k
    probs = np.asarray(ref.jax.nn.softmax(
        ref.jnp.asarray(x) @ jp["router"], -1))
    gate, idx = ref.jax.lax.top_k(probs, tc.experts_per_token)
    gate = np.asarray(gate / gate.sum(-1, keepdims=True))
    idx = np.asarray(idx)
    w = {k: np.asarray(v) for k, v in jp.items()}
    want = np.zeros_like(x)
    for b in range(x.shape[0]):
        for s in range(x.shape[1]):
            for j in range(tc.experts_per_token):
                e = idx[b, s, j]
                a = x[b, s] @ w["wg"][e]
                h = a / (1 + np.exp(-a)) * (x[b, s] @ w["wi"][e])
                want[b, s] += gate[b, s, j] * (h @ w["wo"][e])
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_gather_equals_einsum_under_drops(arch):
    tc = smoke_config(arch, capacity_factor=0.5)
    tpol = single_device_policy(tc)
    tp = tmoe.moe_init(torch.Generator().manual_seed(2), tc, tpol)
    x = torch.from_numpy(inputs(B=3, S=24, seed=5))
    g, ga = tmoe.moe_forward(tp, tc, tpol, x, impl="gather")
    e, ea = tmoe.moe_forward(tp, tc, tpol, x, impl="einsum")
    a, aa = tmoe.moe_forward(tp, tc, tpol, x)            # "auto"
    np.testing.assert_allclose(g.numpy(), e.numpy(), **TOL)
    assert float(ga) == float(ea)
    assert torch.equal(a, g) and float(aa) == float(ga)  # auto is gather


def test_ties_go_to_the_lower_index(ref):
    """A router of zeros makes every probability 1/E: top-k is experts
    0..k-1, as jax.lax.top_k gives it; then pairs of tied columns."""
    jc, jpol, jp, tc, tpol, tp = setup(ref, "qwen2-moe-a2.7b")
    x = inputs()
    for router in (np.zeros((64, 4), np.float32),
                   np.repeat(np.random.default_rng(9).standard_normal(
                       (64, 2)).astype(np.float32), 2, axis=1)):
        jp2 = dict(jp, router=ref.jnp.asarray(router))
        tp2 = dict(tp, router=torch.from_numpy(router))
        _, ji, _ = ref.moe._route(jp2, jc, ref.jnp.asarray(x))
        _, ti, _ = tmoe._route(tp2, tc, torch.from_numpy(x))
        assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(np.asarray(ji)[..., 0] % 2, np.zeros((2, 16)))
    zero = tmoe._route(dict(tp, router=torch.zeros(64, 4)), tc,
                       torch.from_numpy(x))[1]
    assert (zero == torch.tensor([0, 1])).all()


@pytest.mark.parametrize("impl", ["gather", "einsum"])
def test_padded_router_masks_dead_experts(ref, impl):
    """A router of 6 columns over 4 live experts (a tree padded for an
    expert-parallel mesh): the dead experts get no choice, as in the
    reference."""
    jc, jpol, jp, tc, tpol, tp = setup(ref, "arctic-480b")
    rng = np.random.default_rng(6)
    pad = {"router": rng.standard_normal((64, 6)).astype(np.float32),
           "wi": rng.standard_normal((6, 64, 64)).astype(np.float32) / 8,
           "wg": rng.standard_normal((6, 64, 64)).astype(np.float32) / 8,
           "wo": rng.standard_normal((6, 64, 64)).astype(np.float32) / 8}
    x = inputs()
    jo, ja = ref.moe.moe_forward({k: ref.jnp.asarray(v) for k, v in
                                  pad.items()}, jc, jpol, ref.jnp.asarray(x),
                                 impl=impl)
    to, ta = tmoe.moe_forward({k: torch.from_numpy(v) for k, v in
                               pad.items()}, tc, tpol, torch.from_numpy(x),
                              impl=impl)
    _, ti, tpr = tmoe._route({"router": torch.from_numpy(pad["router"])},
                             tc, torch.from_numpy(x))
    assert int(ti.max()) < 4 and float(tpr[..., 4:].max()) == 0.0
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=AUX_TOL)


def test_unknown_impl_raises():
    tc = smoke_config("qwen2-moe-a2.7b")
    with pytest.raises(ValueError, match="unknown moe impl"):
        tmoe.moe_forward({}, tc, single_device_policy(tc),
                         torch.zeros(1, 1, 64), impl="sorted")


@pytest.mark.parametrize("arch", ARCHS)
def test_gather_gradients_match_reference(ref, arch):
    """d(sum(out * r) + aux) / d(x, router, wi, wg, wo), with drops."""
    jc, jpol, jp, tc, tpol, tp = setup(ref, arch, capacity_factor=0.5)
    x = inputs(seed=7)
    r = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        o, a = ref.moe.moe_forward_gather(p, jc, jpol, xx)
        return (o * r).sum() + a

    jgp, jgx = ref.jax.grad(jloss, argnums=(0, 1))(jp, ref.jnp.asarray(x))
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    o, a = tmoe.moe_forward_gather(tp, tc, tpol, tx)
    grads = torch.autograd.grad((o * torch.from_numpy(r)).sum() + a,
                                [tx] + [tp[k] for k in sorted(tp)])
    wants = [np.asarray(jgx)] + [np.asarray(jgp[k]) for k in sorted(tp)]
    for g, w in zip(grads, wants):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())

