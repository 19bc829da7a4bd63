"""The port's transformer building blocks against the reference's.

Every layer function of `repro_torch.models.layers` is run on the same
numpy inputs and parameters as its `repro.models.layers` counterpart, on
the reduced (float32) configs, and compared at rtol 1e-5 (atol 1e-5 where
values pass through zero): the two sides compute the same float32
expressions, with matrix products and reductions summed in another order.
The KV cache is bf16 on both sides, as `lm.prefill` makes it.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import math

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import layers as T
from repro_torch.sharding.policy import single_device_policy
from test_torch_reference import load_reference

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def cfgs(ref, arch, **kw):
    jc = ref.configs.smoke_config(arch, **kw)
    tc = smoke_config(arch, **kw)
    return jc, ref.policy.single_device_policy(jc), tc, \
        single_device_policy(tc)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def attn_params(rng, cfg):
    d, hd = cfg.d_model, cfg.hd
    s = 1.0 / math.sqrt(d)
    return {"wq": rand(rng, d, cfg.n_heads * hd, scale=s),
            "wk": rand(rng, d, cfg.n_kv_heads * hd, scale=s),
            "wv": rand(rng, d, cfg.n_kv_heads * hd, scale=s),
            "wo": rand(rng, cfg.n_heads * hd, d, scale=s)}


def jx(ref, tree):
    return {k: ref.jnp.asarray(v) for k, v in tree.items()}


def tt(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_apply_norm(ref, norm_type):
    rng = np.random.default_rng(0)
    x = rand(rng, 2, 5, 64, scale=3.0)
    p = {"scale": rand(rng, 64), "bias": rand(rng, 64)}
    if norm_type == "rmsnorm":
        del p["bias"]
    want = ref.layers.apply_norm(jx(ref, p), ref.jnp.asarray(x), 1e-6,
                                 norm_type)
    close(T.apply_norm(tt(p), torch.from_numpy(x), 1e-6, norm_type), want)


def test_norm_init(ref):
    for norm_type in ("rmsnorm", "layernorm"):
        p = T.norm_init(8, torch.float32, norm_type)
        want = ref.layers.norm_init(8, np.float32, norm_type)
        assert sorted(p) == sorted(want)
        for k in p:
            np.testing.assert_array_equal(p[k].numpy(),
                                          np.asarray(want[k].v))


@pytest.mark.parametrize("hd,theta", [(16, 10_000.0), (64, 5_000_000.0)])
def test_rope(ref, hd, theta):
    np.testing.assert_allclose(T.rope_freqs(hd, theta).numpy(),
                               np.asarray(ref.layers.rope_freqs(hd, theta)),
                               rtol=1e-6)
    rng = np.random.default_rng(1)
    x = rand(rng, 2, 7, 3, hd)
    pos = np.arange(7)[None, :] + 1000
    want = ref.layers.apply_rope(ref.jnp.asarray(x), ref.jnp.asarray(pos),
                                 theta)
    got = T.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    close(got, want, rtol=1e-5, atol=1e-4)      # angles up to ~1000 rad


def test_repeat_kv(ref):
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    for r in (1, 3):
        np.testing.assert_array_equal(
            T._repeat_kv(torch.from_numpy(x), r).numpy(),
            np.asarray(ref.layers._repeat_kv(ref.jnp.asarray(x), r)))


@pytest.mark.parametrize("causal,window,softcap,chunk", [
    (True, 0, 0.0, 512), (True, 0, 0.0, 8), (True, 6, 0.0, 8),
    (False, 0, 0.0, 8), (True, 0, 5.0, 8)])
def test_chunked_sdpa(ref, causal, window, softcap, chunk):
    rng = np.random.default_rng(2)
    q, k, v = rand(rng, 2, 20, 4, 16), rand(rng, 2, 20, 2, 16), \
        rand(rng, 2, 20, 2, 16)
    kw = dict(causal=causal, window=window, offset=0, softcap=softcap,
              chunk=chunk)
    want = ref.layers._chunked_sdpa(*map(ref.jnp.asarray, (q, k, v)), **kw)
    close(T._chunked_sdpa(*map(torch.from_numpy, (q, k, v)), **kw), want)


def test_attn_init(ref):
    _, _, tc, _ = cfgs(ref, "granite-3-2b")
    gen = torch.Generator().manual_seed(0)
    p = T.attn_init(gen, tc)
    hd = tc.hd
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "wq": (64, tc.n_heads * hd), "wk": (64, tc.n_kv_heads * hd),
        "wv": (64, tc.n_kv_heads * hd), "wo": (tc.n_heads * hd, 64)}
    again = T.attn_init(torch.Generator().manual_seed(0), tc)
    assert all(torch.equal(p[k], again[k]) for k in p)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("window", [0, 5])
def test_attn_forward(ref, impl, window):
    jc, jp, tc, tp = cfgs(ref, "granite-3-2b", attention_impl=impl)
    rng = np.random.default_rng(3)
    p = attn_params(rng, tc)
    x = rand(rng, 2, 12, 64)
    pos = np.arange(12)[None, :]
    wy, (wk, wv) = ref.layers.attn_forward(jx(ref, p), jc, jp,
                                           ref.jnp.asarray(x),
                                           ref.jnp.asarray(pos),
                                           window=window)
    gy, (gk, gv) = T.attn_forward(tt(p), tc, tp, torch.from_numpy(x),
                                  torch.from_numpy(pos), window=window)
    close(gy, wy)
    close(gk, wk)
    close(gv, wv)


@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
def test_attn_decode(ref, ring):
    """Several steps against a bf16 cache; with a ring the positions wrap
    past the window."""
    window = 8 if ring else 0
    T_len = 8 if ring else 16
    jc, jp, tc, tp = cfgs(ref, "granite-3-2b")
    rng = np.random.default_rng(4)
    p = attn_params(rng, tc)
    B, KV, hd = 2, tc.n_kv_heads, tc.hd
    cache0 = rand(rng, 2, B, T_len, KV, hd)
    jk = ref.jnp.asarray(cache0[0], ref.jnp.bfloat16)
    jv = ref.jnp.asarray(cache0[1], ref.jnp.bfloat16)
    tk = torch.from_numpy(cache0[0]).to(torch.bfloat16)
    tv = torch.from_numpy(cache0[1]).to(torch.bfloat16)
    for pos in (3, 5, 11) if ring else (3, 4, 15):
        x = rand(rng, B, 1, 64)
        wy, jk, jv = ref.layers.attn_decode(jx(ref, p), jc, jp,
                                            ref.jnp.asarray(x), jk, jv, pos,
                                            window=window)
        gy, tk, tv = T.attn_decode(tt(p), tc, tp, torch.from_numpy(x), tk,
                                   tv, pos, window=window)
        close(gy, wy)
        np.testing.assert_array_equal(tk.float().numpy(),
                                      np.asarray(jk, np.float32))
        np.testing.assert_array_equal(tv.float().numpy(),
                                      np.asarray(jv, np.float32))


def test_attn_decode_per_sequence_positions(ref):
    jc, jp, tc, tp = cfgs(ref, "granite-3-2b")
    rng = np.random.default_rng(5)
    p = attn_params(rng, tc)
    cache = rand(rng, 2, 2, 10, tc.n_kv_heads, tc.hd)
    x = rand(rng, 2, 1, 64)
    pos = np.array([2, 7], np.int32)
    wy, jk, _ = ref.layers.attn_decode(
        jx(ref, p), jc, jp, ref.jnp.asarray(x),
        ref.jnp.asarray(cache[0], ref.jnp.bfloat16),
        ref.jnp.asarray(cache[1], ref.jnp.bfloat16), ref.jnp.asarray(pos))
    gy, tk, _ = T.attn_decode(
        tt(p), tc, tp, torch.from_numpy(x),
        torch.from_numpy(cache[0]).to(torch.bfloat16),
        torch.from_numpy(cache[1]).to(torch.bfloat16), torch.from_numpy(pos))
    close(gy, wy)
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(jk, np.float32))


def test_attn_decode_past_the_cache_raises(ref):
    _, _, tc, tp = cfgs(ref, "granite-3-2b")
    p = tt(attn_params(np.random.default_rng(6), tc))
    cache = torch.zeros((1, 4, tc.n_kv_heads, tc.hd), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not fit"):
        T.attn_decode(p, tc, tp, torch.zeros((1, 1, 64)), cache,
                      cache.clone(), 4)


@pytest.mark.parametrize("arch,mlp_type", [("granite-3-2b", "swiglu"),
                                           ("starcoder2-7b", "gelu")])
def test_mlp(ref, arch, mlp_type):
    jc, jp, tc, tp = cfgs(ref, arch)
    assert tc.mlp_type == mlp_type
    gen = torch.Generator().manual_seed(1)
    p = T.mlp_init(gen, tc)
    assert sorted(p) == sorted(ref.layers.mlp_init(
        ref.jax.random.PRNGKey(0), jc))
    x = np.random.default_rng(7).standard_normal((2, 5, 64)) \
        .astype(np.float32) * 2
    want = ref.layers.mlp_forward({k: ref.jnp.asarray(v.numpy())
                                   for k, v in p.items()}, jc, jp,
                                  ref.jnp.asarray(x))
    close(T.mlp_forward(p, tc, tp, torch.from_numpy(x)), want)


def test_gelu_is_the_tanh_approximation(ref):
    """jax.nn.gelu defaults to the tanh form; the exact erf form differs
    by up to ~1e-3 and would fail this."""
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(ref.jax.nn.gelu(ref.jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_unembed_masks_the_padding(ref, softcap):
    jc, jp, tc, tp = cfgs(ref, "granite-3-2b", logit_softcap=softcap)
    vp = T.padded_vocab(tc)
    assert vp == ref.layers.padded_vocab(jc) == 256
    rng = np.random.default_rng(8)
    emb, x = rand(rng, vp, 64), rand(rng, 2, 1, 64, scale=4.0)
    want = ref.layers.unembed(jc, jp, ref.jnp.asarray(x),
                              ref.jnp.asarray(emb))
    got = T.unembed(tc, tp, torch.from_numpy(x), torch.from_numpy(emb))
    close(got, want)
    assert (got[..., tc.vocab_size:] == -1e30).all()


@pytest.mark.parametrize("vocab,want", [(251, 256), (256, 256),
                                        (49155, 49168), (49152, 49152)])
def test_padded_vocab(ref, vocab, want):
    jc, _, tc, _ = cfgs(ref, "granite-3-2b", vocab_size=vocab)
    assert T.padded_vocab(tc) == ref.layers.padded_vocab(jc) == want


def test_inits_are_seeded_normals(ref):
    gen = torch.Generator().manual_seed(3)
    w = T.dense_init(gen, 256, 512, torch.bfloat16)
    e = T.embed_init(gen, 512, 64, torch.float32)
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (256, 512)
    assert abs(float(w.float().std()) - 1 / 16) < 2e-3
    assert abs(float(e.std()) - 0.02) < 1e-3
    assert torch.equal(
        w, T.dense_init(torch.Generator().manual_seed(3), 256, 512,
                        torch.bfloat16))
