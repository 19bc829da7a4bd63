"""The port's policy resolution, size model and parameter shapes against
the reference's: exact.

`sharding.policy.resolve` is pure Python in both packages; every field of
the resolved `Policy` (rules and notes included) must be equal for every
architecture, input shape, production mesh and strategy. `models.analysis`
must give the reference's floats, and under a resolved production policy
the port's shape-only parameter tree (`device.meta_generator`) must hold
the reference's `jax.eval_shape` leaves, through `models/convert.py`'s
names, for all ten full configs: MoE padding and KV replication included.
"""
import importlib
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.device import meta_generator
from repro_torch.launch import mesh as tmesh
from repro_torch.models import analysis as tanalysis
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_family
from repro_torch.sharding import partitioning as tpart
from repro_torch.sharding.policy import (HBM_BUDGET, Policy, resolve,
                                         single_device_policy)
from repro_torch.train.optim import tree_leaves
from test_torch_reference import load_reference

MESH1 = tmesh.SINGLE_POD
MESH2 = tmesh.MULTI_POD
STRATEGIES = ("auto", "tp", "dp_zero1", "dp_zero3", "dp_seq")
FIELDS = ("rules", "strategy", "attn_mode", "decode_attn", "kv_repeat",
          "expert_pad", "batch_axes", "notes")


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def ref_module(ref, name):
    """A module of the reference not in `load_reference`'s namespace (the
    loader has patched JAX for it)."""
    return importlib.import_module(name)


def test_meshes_and_budget_are_the_reference_s(ref):
    jpart = ref_module(ref, "repro.sharding.partitioning")
    jpol = ref_module(ref, "repro.sharding.policy")
    assert tpart.LOGICAL_RULES == jpart.LOGICAL_RULES
    assert tpart.TP_ONLY_RULES == jpart.TP_ONLY_RULES
    assert HBM_BUDGET == jpol.HBM_BUDGET
    assert (MESH1, MESH2) == ({"data": 16, "model": 16},
                              {"pod": 2, "data": 16, "model": 16})
    assert tmesh.production_axes() == MESH1
    assert tmesh.production_axes(multi_pod=True) == MESH2
    assert tmesh.production_axes() is not MESH1
    assert tmesh.mesh_devices(MESH1) == 256
    assert tmesh.mesh_devices(MESH2) == 512
    assert tmesh.mesh_devices(tmesh.HOST) == 1


@pytest.mark.parametrize("axes", [("batch", None, "heads"),
                                  ("embed_fsdp", "mlp"), (None,), ()])
def test_logical_spec_holds_the_partition_spec_entries(ref, axes):
    jpart = ref_module(ref, "repro.sharding.partitioning")
    pol = resolve(tconfigs.get_config("yi-6b"), MESH2, 256, "train",
                  strategy="tp")
    for rules in (tpart.LOGICAL_RULES, pol.rules):
        assert tpart.logical_spec(axes, rules) == tuple(
            jpart.logical_spec(axes, rules))
    assert pol.spec(axes) == tpart.logical_spec(axes, pol.rules)
    x = torch.ones(2)
    assert tpart.constrain(x, "batch") is x and pol.constrain(x) is x


@pytest.mark.parametrize("mesh", [MESH1, MESH2], ids=["pod", "multipod"])
@pytest.mark.parametrize("shape", list(tconfigs.SHAPES))
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_resolve_equals_the_reference(ref, arch, shape, mesh):
    """Every field, rules and notes included, for every strategy."""
    s = tconfigs.SHAPES[shape]
    jc, tc = ref.configs.get_config(arch), tconfigs.get_config(arch)
    for strategy in STRATEGIES:
        want = ref.policy.resolve(jc, mesh, s.batch, s.kind, seq=s.seq,
                                  strategy=strategy)
        got = resolve(tc, mesh, s.batch, s.kind, seq=s.seq,
                      strategy=strategy)
        for f in FIELDS:
            assert getattr(got, f) == getattr(want, f), (strategy, f)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_single_device_policy_equals_the_reference(ref, arch):
    jc, tc = ref.configs.get_config(arch), tconfigs.get_config(arch)
    want = ref.policy.single_device_policy(jc)
    got = single_device_policy(tc)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    if not tc.n_experts:         # the defaults are the no-op policy's
        assert got == Policy()


class TestReferenceCases:
    """tests/test_policy_hlo.py:15-74, restated against the port."""

    def test_tp_heads_when_divisible(self):
        pol = resolve(tconfigs.get_config("qwen2-moe-a2.7b"), MESH1, 256,
                      "train", seq=4096, strategy="tp")
        assert pol.attn_mode == "tp_heads" and pol.kv_repeat == 1
        assert pol.expert_pad == 64                  # 60 -> 64 for EP=16

    def test_kv_replication_exactness_condition(self):
        pol = resolve(tconfigs.get_config("yi-6b"), MESH1, 256, "train",
                      strategy="tp")
        assert pol.attn_mode == "tp_heads" and pol.kv_repeat == 4
        pol = resolve(tconfigs.get_config("granite-3-2b"), MESH1, 256,
                      "train", strategy="tp")
        assert pol.kv_repeat == 2

    @pytest.mark.parametrize("arch", ["phi3-medium-14b", "starcoder2-7b",
                                      "arctic-480b"])
    def test_dp_batch_for_odd_heads(self, arch):
        pol = resolve(tconfigs.get_config(arch), MESH1, 256, "train",
                      strategy="tp")
        assert pol.attn_mode == "dp_batch"
        assert pol.rules["heads"] is None
        assert "model" in pol.rules["attn_batch"]

    def test_multipod_odd_heads_fall_back(self):
        pol = resolve(tconfigs.get_config("phi3-medium-14b"), MESH2, 256,
                      "train", strategy="tp")
        assert pol.attn_mode == "none"

    def test_decode_seq_kv_fallback(self):
        pol = resolve(tconfigs.get_config("starcoder2-7b"), MESH1, 128,
                      "decode", seq=32768)
        assert pol.decode_attn == "seq_kv"
        assert pol.rules["cache_seq"] == "model"

    @pytest.mark.parametrize("step", ["prefill", "decode"])
    def test_serve_never_fsdp(self, step):
        for arch in tconfigs.ARCHS:
            pol = resolve(tconfigs.get_config(arch), MESH1, 32, step,
                          seq=32768)
            assert pol.rules["embed_fsdp"] is None, arch
            assert pol.strategy == "serve"

    def test_auto_strategy_napkin_math(self):
        pol = resolve(tconfigs.get_config("granite-3-2b"), MESH1, 256,
                      "train", seq=4096)
        assert pol.strategy in ("dp_zero1", "dp_zero3")
        pol = resolve(tconfigs.get_config("arctic-480b"), MESH1, 256,
                      "train", seq=4096)
        assert pol.strategy == "tp"
        assert any("napkin" in n for n in pol.notes)

    def test_batch_1_not_sharded(self):
        pol = resolve(tconfigs.get_config("xlstm-1.3b"), MESH1, 1, "decode",
                      seq=524288)
        assert pol.batch_axes is None


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_analysis_equals_the_reference(ref, arch):
    """The reference's floats exactly, with and without expert padding."""
    ja = ref_module(ref, "repro.models.analysis")
    jc, tc = ref.configs.get_config(arch), tconfigs.get_config(arch)
    assert tanalysis.family_counts(tc) == ja.family_counts(jc)
    assert tanalysis.param_dtype_bytes(tc) == ja.param_dtype_bytes(jc)
    assert tanalysis.pad16(tc.vocab_size) == ja.pad16(jc.vocab_size)
    for pad in (0, 64, 128):
        got, want = tanalysis.param_count(tc, pad), ja.param_count(jc, pad)
        assert type(got) is float and got == want, pad
    assert tanalysis.active_param_count(tc) == ja.active_param_count(jc)


def shapes_of(tree, path=""):
    """{path: (shape, dtype)} of a nested dict / list of tensors."""
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in shapes_of(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, t in enumerate(tree)
                for k2, v2 in shapes_of(t, f"{path}/{i}").items()}
    return {path: (tuple(tree.shape), tree.dtype)}


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_meta_params_have_the_reference_leaf_shapes(ref, arch):
    """Under resolve(MESH1, 256, "train", "tp"): the port's shape-only
    build equals the reference's eval_shape of init_params, leaf by leaf,
    through convert.py's names; nothing is allocated."""
    jax, jnp = ref.jax, ref.jnp
    jc, tc = ref.configs.get_config(arch), tconfigs.get_config(arch)
    jpol = ref.policy.resolve(jc, MESH1, 256, "train", strategy="tp")
    tpol = resolve(tc, MESH1, 256, "train", strategy="tp")
    fam = ref.registry.get_family(jc)
    boxed = jax.eval_shape(lambda k: fam.init_params(jc, jpol, k),
                           jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = shapes_of(params_from_jax(tc, ref.layers.unbox(boxed)[0],
                                     device="meta"))
    got_tree = get_family(tc).init_params(tc, tpol, meta_generator())
    got = shapes_of(got_tree)
    assert got == want
    assert all(x.device.type == "meta" for x in tree_leaves(got_tree))
    if tc.n_experts:
        E = tpol.expert_pad
        assert got["/layers/0/moe/router"][0] == (tc.d_model, E)
        assert got["/layers/0/moe/wi"][0][0] == E


def test_padded_experts_take_no_token():
    """A router padded to expert_pad (qwen2-moe: 60 -> 64 under EP 16)
    gives the padded experts no token: the reference's mask."""
    from repro_torch.models import moe as tmoe
    cfg = tconfigs.smoke_config("qwen2-moe-a2.7b").with_(n_experts=6)
    pol = Policy(expert_pad=8)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(gen, cfg, pol)
    assert tuple(p["router"].shape) == (cfg.d_model, 8)
    assert tuple(p["wi"].shape)[0] == 8
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    gate, idx, probs = tmoe._route(p, cfg, x)
    assert int(idx.max()) < 6 and float(probs[..., 6:].max()) == 0.0


@pytest.mark.parametrize("rules,want", [({"expert": "model"}, "einsum"),
                                        ({"expert": None}, "gather")])
def test_moe_auto_reads_the_expert_rule(monkeypatch, rules, want):
    from repro_torch.models import moe as tmoe
    cfg = tconfigs.smoke_config("qwen2-moe-a2.7b")
    pol = Policy(rules=dict(tpart.LOGICAL_RULES, **rules))
    calls = []
    for name in ("gather", "einsum"):
        monkeypatch.setattr(tmoe, f"moe_forward_{name}",
                            lambda *a, name=name: calls.append(name))
    tmoe.moe_forward({}, cfg, pol, None, impl="auto")
    assert calls == [want]
