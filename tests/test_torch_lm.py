"""The port's decoder-only LM against the reference's `repro.models.lm`.

The reference's parameters (its own `init_params` from a fixed key,
unboxed, as numpy arrays) are carried over with `params_from_jax`, so both
sides hold the same weights. On the reduced float32 config of every arch
of the module (the four dense ones, the MoE qwen2-moe-a2.7b and
arctic-480b, the VLM backbone pixtral-12b, fed frontend embeddings for its
first ``n_prefix`` positions, once more with ``head_dim`` 32 so that
``n_heads * hd != d_model``): the forward's hidden states and aux loss,
the prefill's hidden states and bf16 KV cache, then four decode steps'
logits (each step fed the reference's greedy token).

Tolerances: hidden states and logits rtol/atol 1e-4 (float32 through a
few layers, summed in another order); the MoE aux loss 1e-6; the bf16
cache may differ by one bf16 rounding where a float32 value lands near a
rounding boundary, so it gets 1e-2 relative, and must agree exactly on at
least 99 % of entries. The MoE routes of every layer are the reference's
where the router's top-k margin is wide: a flip at a near tie would show
as a logit difference, not be hidden by these tolerances.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.models import encdec as tencdec
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tregistry
from repro_torch.models import xlstm as txlstm
from repro_torch.models.config import ModelConfig, reduced
from repro_torch.models.convert import params_from_jax
from repro_torch.sharding.policy import Policy, single_device_policy
from test_torch_reference import load_reference

DENSE = ("granite-3-2b", "starcoder2-7b", "yi-6b", "phi3-medium-14b")
MOE_VLM = ("qwen2-moe-a2.7b", "arctic-480b", "pixtral-12b")
#: (arch, config overrides) of the MoE / VLM parity cases
LM_CASES = [(a, {}) for a in MOE_VLM] + [("pixtral-12b", {"head_dim": 32})]
LM_IDS = list(MOE_VLM) + ["pixtral-12b-hd32"]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def jax_params(ref, cfg, seed=0):
    pol = ref.policy.single_device_policy(cfg)
    boxed = ref.lm.init_params(cfg, pol, ref.jax.random.PRNGKey(seed))
    params, _ = ref.layers.unbox(boxed)
    return params


def numpy_tree(ref, params):
    return ref.jax.tree.map(np.asarray, params)


def fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


class TestConfigs:
    @pytest.mark.parametrize("arch", DENSE + ("recurrentgemma-2b",) + MOE_VLM)
    def test_full_and_smoke_configs_equal_the_reference(self, ref, arch):
        assert fields(tconfigs.get_config(arch)) == fields(
            ref.configs.get_config(arch))
        assert fields(tconfigs.smoke_config(arch)) == fields(
            ref.configs.smoke_config(arch))

    @pytest.mark.parametrize("arch", [
        "qwen2-moe-a2.7b", "arctic-480b", "pixtral-12b", "xlstm-1.3b",
        "recurrentgemma-2b", "seamless-m4t-large-v2"])
    def test_reduced_is_the_reference_rule_for_every_family(self, ref, arch):
        """The port's `reduced` applied to each of the reference's full
        configs gives the reference's smoke config, field by field."""
        full = ref.configs.get_config(arch)
        mine = reduced(ModelConfig(**fields(full)))
        assert fields(mine) == fields(ref.configs.smoke_config(arch))

    def test_archs_and_dtypes(self, ref):
        assert tconfigs.ARCHS == ref.configs.ARCHS
        cfg = tconfigs.get_config("granite-3-2b")
        assert cfg.pdtype() == cfg.cdtype() == torch.bfloat16
        assert tconfigs.smoke_config("granite-3-2b").pdtype() == torch.float32
        assert cfg.hd == 64 and cfg.with_(head_dim=32).hd == 32

    @pytest.mark.parametrize("arch", ["xlstm-1.3b", "seamless-m4t-large-v2"])
    def test_unported_archs_raise(self, ref, arch):
        """Once the refusal of the two architectures the port lacked; now
        their configs are the reference's, field for field."""
        assert fields(tconfigs.get_config(arch)) == fields(
            ref.configs.get_config(arch))
        assert fields(tconfigs.smoke_config(arch)) == fields(
            ref.configs.smoke_config(arch))

    def test_unknown_arch_is_a_value_error(self):
        with pytest.raises(ValueError, match="unknown arch"):
            tconfigs.get_config("gpt-5")


class TestRegistry:
    @pytest.mark.parametrize("family", ["encdec", "ssm"])
    def test_unported_families_raise(self, ref, family):
        """Once the refusal of the two families the port lacked; now
        `get_family` serves each with its module, as the reference's
        `FAMILIES` does, and every family of the reference is served."""
        want = {"encdec": tencdec, "ssm": txlstm}[family]
        cfg = tconfigs.smoke_config("granite-3-2b").with_(family=family)
        assert tregistry.get_family(cfg) is want
        assert set(tregistry.FAMILIES) == set(ref.registry.FAMILIES)

    def test_unknown_family_is_a_value_error(self):
        cfg = tconfigs.smoke_config("granite-3-2b").with_(family="rnn")
        with pytest.raises(ValueError, match="unknown model family"):
            tregistry.get_family(cfg)

    def test_dense(self):
        fam = tregistry.get_family(tconfigs.smoke_config("yi-6b"))
        assert fam.decode_step is tlm.decode_step

    @pytest.mark.parametrize("family", ["moe", "vlm"])
    def test_moe_and_vlm_families_are_the_lm(self, family):
        """As the reference's `FAMILIES` maps them."""
        arch = {"moe": "qwen2-moe-a2.7b", "vlm": "pixtral-12b"}[family]
        cfg = tconfigs.smoke_config(arch)
        assert cfg.family == family
        assert tregistry.get_family(cfg) is tlm
        dense = tconfigs.smoke_config("granite-3-2b").with_(family=family)
        assert tregistry.get_family(dense) is tlm

    def test_moe_branch_follows_n_experts(self):
        """A dense config given experts takes the MoE branch, as the
        reference's `_layer_init` keys it on ``n_experts``; arctic's dense
        residual and qwen2-moe's shared expert are its parallel MLP."""
        gen = torch.Generator().manual_seed(0)
        cfg = tconfigs.smoke_config("yi-6b").with_(
            n_experts=4, experts_per_token=2, expert_d_ff=32)
        p = tlm.init_params(cfg, single_device_policy(cfg), gen)
        assert "moe" in p["layers"][0] and "mlp" not in p["layers"][0]
        for arch, f in (("qwen2-moe-a2.7b", 64), ("arctic-480b", 128)):
            cfg = tconfigs.smoke_config(arch)
            layer = tlm.init_params(cfg, single_device_policy(cfg),
                                    gen)["layers"][0]
            assert tuple(layer["mlp"]["wi"].shape) == (64, f)
            assert tuple(layer["moe"]["wi"].shape) == (4, 64, 64)

    def test_policy_is_the_identity(self):
        pol = single_device_policy(tconfigs.smoke_config("yi-6b"))
        x = torch.ones(3)
        assert pol.constrain(x, "batch") is x
        assert pol == Policy() and pol.kv_repeat == 1


class TestParams:
    def test_init_params_has_the_reference_structure(self, ref):
        """Same leaves, shapes and dtypes as the reference's tree, per
        layer (a bf16 variant of the reduced config)."""
        jc = ref.configs.smoke_config("starcoder2-7b",
                                      param_dtype="bfloat16")
        tc = tconfigs.smoke_config("starcoder2-7b", param_dtype="bfloat16")
        want = numpy_tree(ref, jax_params(ref, jc))
        gen = torch.Generator().manual_seed(0)
        got = tlm.init_params(tc, single_device_policy(tc), gen)
        assert len(got["layers"]) == tc.n_layers
        assert tuple(got["embed"].shape) == want["embed"].shape
        assert got["embed"].dtype == torch.bfloat16
        flat = ref.jax.tree_util.tree_flatten_with_path(want["layers"])[0]
        for path, leaf in flat:
            keys = [p.key for p in path]
            for layer in got["layers"]:
                t = layer
                for k in keys:
                    t = t[k]
                assert tuple(t.shape) == leaf.shape[1:], keys
                assert t.dtype == torch.bfloat16, keys
        assert got["norm"].keys() == want["norm"].keys()

    def test_params_from_jax_keeps_values_and_dtypes(self, ref):
        jc = ref.configs.smoke_config("granite-3-2b", param_dtype="bfloat16")
        tc = tconfigs.smoke_config("granite-3-2b", param_dtype="bfloat16")
        tree = numpy_tree(ref, jax_params(ref, jc))
        p = params_from_jax(tc, tree, device="cpu")
        assert p["embed"].dtype == torch.bfloat16
        np.testing.assert_array_equal(p["embed"].float().numpy(),
                                      tree["embed"].astype(np.float32))
        np.testing.assert_array_equal(
            p["layers"][1]["attn"]["wq"].float().numpy(),
            tree["layers"]["attn"]["wq"][1].astype(np.float32))

    def test_params_from_jax_default_device_is_the_card(self, ref,
                                                        monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        tc = tconfigs.smoke_config("granite-3-2b")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_jax(tc, {"embed": np.zeros((1, 1)), "layers": {},
                                 "norm": {}})


def both(ref, arch, impl="xla"):
    jc = ref.configs.smoke_config(arch, attention_impl=impl)
    tc = tconfigs.smoke_config(arch, attention_impl=impl)
    jp = jax_params(ref, jc, seed=1)
    tp = params_from_jax(tc, numpy_tree(ref, jp), device="cpu")
    return (jc, ref.policy.single_device_policy(jc), jp,
            tc, single_device_policy(tc), tp)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_four_decode_steps(ref, arch):
    jc, jpol, jp, tc, tpol, tp = both(ref, arch, impl="pallas")
    tokens = np.random.default_rng(11).integers(
        0, jc.vocab_size, (2, 9)).astype(np.int32)
    max_len = 9 + 4
    jh, jcache = ref.lm.prefill(jc, jpol, jp, ref.jnp.asarray(tokens),
                                max_len)
    th, tcache = tlm.prefill(tc, tpol, tp, torch.from_numpy(tokens).long(),
                             max_len)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert tcache.pos == int(jcache.pos) == 9
    for got, want in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        assert got.dtype == torch.bfloat16
        g, w = got.float().numpy(), np.asarray(want, np.float32)
        np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-2)
        assert (g == w).mean() >= 0.99

    tok = np.argmax(np.asarray(ref.layers.unembed(
        jc, jpol, jh[:, -1:], jp["embed"])), -1).astype(np.int32)
    for _ in range(4):
        jl, jcache = ref.lm.decode_step(jc, jpol, jp, jcache,
                                        ref.jnp.asarray(tok))
        tl, tcache = tlm.decode_step(tc, tpol, tp, tcache,
                                     torch.from_numpy(tok).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    assert tcache.pos == int(jcache.pos) == 13


def test_forward(ref):
    jc, jpol, jp, tc, tpol, tp = both(ref, "starcoder2-7b")
    tokens = np.random.default_rng(12).integers(
        0, jc.vocab_size, (2, 11)).astype(np.int32)
    jh, jaux = ref.lm.forward(jc, jpol, jp, ref.jnp.asarray(tokens))
    th, taux = tlm.forward(tc, tpol, tp, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert float(taux) == float(jaux) == 0.0


def test_init_cache_with_a_window(ref):
    tc = tconfigs.smoke_config("granite-3-2b").with_(local_window=8)
    cache = tlm.init_cache(tc, single_device_policy(tc), 2, 20)
    assert tuple(cache.k.shape) == (tc.n_layers, 2, 8, tc.n_kv_heads, tc.hd)
    assert cache.k.dtype == torch.bfloat16 and cache.pos == 0


def test_windowed_prefill_writes_a_ring(ref):
    """A prompt longer than the window leaves the last `window` positions
    in ring order, as the reference writes them."""
    jc, jpol, jp, tc, tpol, tp = both(ref, "granite-3-2b")
    jc, tc = jc.with_(local_window=8), tc.with_(local_window=8)
    tokens = np.random.default_rng(13).integers(
        0, jc.vocab_size, (1, 13)).astype(np.int32)
    jh, jcache = ref.lm.prefill(jc, jpol, jp, ref.jnp.asarray(tokens), 20)
    th, tcache = tlm.prefill(tc, tpol, tp, torch.from_numpy(tokens).long(),
                             20)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    g, w = tcache.k.float().numpy(), np.asarray(jcache.k, np.float32)
    np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-2)


def prompt_inputs(cfg, B, S, seed):
    """Tokens [B, S] and, for a VLM backbone, frontend embeddings
    [B, n_prefix, d] at train/data.py's scale (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    embeds = None
    if cfg.embeds_input:
        embeds = (rng.standard_normal((B, cfg.n_prefix, cfg.d_model))
                  * 0.02).astype(np.float32)
    return tokens, embeds


def both_with(ref, arch, overrides, impl="xla"):
    jc = ref.configs.smoke_config(arch, attention_impl=impl, **overrides)
    tc = tconfigs.smoke_config(arch, attention_impl=impl, **overrides)
    jp = jax_params(ref, jc, seed=1)
    tp = params_from_jax(tc, numpy_tree(ref, jp), device="cpu")
    return (jc, ref.policy.single_device_policy(jc), jp,
            tc, single_device_policy(tc), tp)


def as_jax(ref, embeds):
    return None if embeds is None else ref.jnp.asarray(embeds)


def as_torch(embeds):
    return None if embeds is None else torch.from_numpy(embeds)


@pytest.mark.parametrize("arch,overrides", LM_CASES, ids=LM_IDS)
def test_moe_and_vlm_forward(ref, arch, overrides):
    """Hidden states and the aux loss (the MoE load-balance term, times
    router_aux_loss / n_layers; 0 for pixtral)."""
    jc, jpol, jp, tc, tpol, tp = both_with(ref, arch, overrides)
    tokens, embeds = prompt_inputs(jc, 2, 11, seed=14)
    jh, jaux = ref.lm.forward(jc, jpol, jp, ref.jnp.asarray(tokens),
                              as_jax(ref, embeds))
    th, taux = tlm.forward(tc, tpol, tp, torch.from_numpy(tokens).long(),
                           as_torch(embeds))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)
    assert (float(taux) > 0) == bool(tc.n_experts)
    if embeds is not None:      # the prefix is the embeddings, not tokens
        th2, _ = tlm.forward(tc, tpol, tp, torch.from_numpy(tokens).long())
        assert not torch.allclose(th, th2)


@pytest.mark.parametrize("arch,overrides", LM_CASES, ids=LM_IDS)
def test_moe_and_vlm_prefill_and_four_decode_steps(ref, arch, overrides):
    """As test_prefill_and_four_decode_steps, through the attention
    kernel's path (the reference's Pallas kernel in interpret mode, the
    port's plain version). The MoE prefill routes at the capacity of the
    prompt's length, and each decode step at C = 1, on both sides."""
    jc, jpol, jp, tc, tpol, tp = both_with(ref, arch, overrides, "pallas")
    assert (tc.n_heads * tc.hd != tc.d_model) == ("head_dim" in overrides)
    tokens, embeds = prompt_inputs(jc, 2, 9, seed=15)
    max_len = 9 + 4
    jh, jcache = ref.lm.prefill(jc, jpol, jp, ref.jnp.asarray(tokens),
                                max_len, embeds=as_jax(ref, embeds))
    th, tcache = tlm.prefill(tc, tpol, tp, torch.from_numpy(tokens).long(),
                             max_len, embeds=as_torch(embeds))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert tcache.pos == int(jcache.pos) == 9
    for got, want in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        assert got.dtype == torch.bfloat16
        g, w = got.float().numpy(), np.asarray(want, np.float32)
        np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-2)
        assert (g == w).mean() >= 0.99

    tok = np.argmax(np.asarray(ref.layers.unembed(
        jc, jpol, jh[:, -1:], jp["embed"])), -1).astype(np.int32)
    for _ in range(4):
        jl, jcache = ref.lm.decode_step(jc, jpol, jp, jcache,
                                        ref.jnp.asarray(tok))
        tl, tcache = tlm.decode_step(tc, tpol, tp, tcache,
                                     torch.from_numpy(tok).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    assert tcache.pos == int(jcache.pos) == 13


def test_embeds_cast_to_the_table_dtype_first(ref):
    """bf16 parameters, float32 compute: the embeddings round to bf16 (the
    table's dtype) before the compute cast, as the reference's."""
    jc = ref.configs.smoke_config("pixtral-12b", param_dtype="bfloat16")
    tc = tconfigs.smoke_config("pixtral-12b", param_dtype="bfloat16")
    tp = params_from_jax(tc, numpy_tree(ref, jax_params(ref, jc)),
                         device="cpu")
    jp = jax_params(ref, jc)
    tokens, embeds = prompt_inputs(jc, 2, 7, seed=16)
    want = ref.lm.embed_tokens(jc, ref.policy.single_device_policy(jc), jp,
                               ref.jnp.asarray(tokens), ref.jnp.asarray(embeds))
    got = tlm.embed_tokens(tc, single_device_policy(tc), tp,
                           torch.from_numpy(tokens).long(),
                           torch.from_numpy(embeds))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got[:, :4].numpy(),
        torch.from_numpy(embeds).to(torch.bfloat16).float().numpy())


def test_params_from_jax_keeps_the_moe_router_float32(ref):
    """The reference's MoE tree (router float32, experts bf16, stacked
    [L, ...]) unstacks per layer with its dtypes and values."""
    jc = ref.configs.smoke_config("qwen2-moe-a2.7b", param_dtype="bfloat16")
    tc = tconfigs.smoke_config("qwen2-moe-a2.7b", param_dtype="bfloat16")
    tree = numpy_tree(ref, jax_params(ref, jc))
    p = params_from_jax(tc, tree, device="cpu")
    moe = p["layers"][1]["moe"]
    assert moe["router"].dtype == torch.float32
    assert all(moe[k].dtype == torch.bfloat16 for k in ("wi", "wg", "wo"))
    np.testing.assert_array_equal(moe["router"].numpy(),
                                  tree["layers"]["moe"]["router"][1])
    np.testing.assert_array_equal(
        moe["wo"].float().numpy(),
        tree["layers"]["moe"]["wo"][1].astype(np.float32))
    assert p["layers"][0]["mlp"]["wi"].shape == (64, 64)   # shared expert
