"""The port's hybrid LM (recurrentgemma-2b's family) against the reference's
`repro.models.hybrid`.

The reference's parameters (its own `init_params` from a fixed key,
unboxed, as numpy arrays) are carried over with `params_from_jax`, so both
sides hold the same weights. On the reduced float32 config (4 layers: one
(rec, rec, attn) repeat and a one-block tail, d_rnn 64, window 16, S 40 >
window): the building blocks, the forward's hidden states and the training
loss under both attention paths, ``"pallas"`` (the reference's Pallas
kernels in interpret mode; the port's kernel wrappers, which take their
plain versions on CPU tensors) and ``"xla"`` (the associative scan and the
chunked softmax on both sides).

Tolerances: building blocks rtol/atol 1e-5 (the same float32 expressions,
products summed in another order); hidden states and losses 1e-4 (float32
through four blocks, the recurrence in another order).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.models import hybrid as thybrid
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tregistry
from repro_torch.models.convert import params_from_jax
from repro_torch.sharding.policy import single_device_policy
from repro_torch.train import optim as toptim
from repro_torch.train import step as tstep
from test_torch_reference import load_reference

ARCH = "recurrentgemma-2b"
TOL = dict(rtol=1e-4, atol=1e-4)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def jax_params(ref, cfg, seed):
    pol = ref.policy.single_device_policy(cfg)
    init = ref.jax.jit(lambda key: ref.layers.unbox(
        ref.hybrid.init_params(cfg, pol, key))[0])
    return init(ref.jax.random.PRNGKey(seed))


def numpy_tree(ref, params):
    return ref.jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def carried(ref):
    """(reference params as numpy, port params) of the reduced config."""
    jc = ref.configs.smoke_config(ARCH)
    tree = numpy_tree(ref, jax_params(ref, jc, seed=2))
    return tree, params_from_jax(smoke_config(ARCH), tree, device="cpu")


def both_cfgs(ref, impl):
    jc = ref.configs.smoke_config(ARCH, attention_impl=impl)
    tc = smoke_config(ARCH, attention_impl=impl)
    return (jc, ref.policy.single_device_policy(jc), tc,
            single_device_policy(tc))


def tokens(ref, seed, B=2, S=40):
    jc = ref.configs.smoke_config(ARCH)
    return np.random.default_rng(seed).integers(
        0, jc.vocab_size, (B, S)).astype(np.int32)


def rec_params(tree, i=0):
    """One recurrent block's RG-LRU parameters, numpy and torch."""
    p = {k: v for k, v in tree["reps"][f"b{i}_rec"]["rec"].items()
         if k != "ln"}
    npy = {k: np.array(v[0]) for k, v in p.items()}
    npy["ln"] = {"scale": np.array(
        tree["reps"][f"b{i}_rec"]["rec"]["ln"]["scale"][0])}
    tt = {k: torch.from_numpy(v) for k, v in npy.items() if k != "ln"}
    tt["ln"] = {"scale": torch.from_numpy(npy["ln"]["scale"])}
    return npy, tt


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               **(tol or BLOCK_TOL))


class TestParams:
    def test_params_from_jax_unstacks_the_repeats(self, ref, carried):
        tree, p = carried
        tc = smoke_config(ARCH)
        assert len(p["reps"]) == 1 and set(p["tail"]) == {"t0_rec"}
        assert set(p["reps"][0]) == {"b0_rec", "b1_rec", "b2_attn"}
        for block in (*p["reps"][0].values(), *p["tail"].values()):
            assert not any(k.startswith("kind_") for k in block)
        np.testing.assert_array_equal(
            p["reps"][0]["b1_rec"]["rec"]["wr"].numpy(),
            tree["reps"]["b1_rec"]["rec"]["wr"][0])
        np.testing.assert_array_equal(
            p["tail"]["t0_rec"]["rec"]["lam"].numpy(),
            tree["tail"]["t0_rec"]["rec"]["lam"])
        assert p["embed"].shape == (tlayers.padded_vocab(tc), tc.d_model)

    def test_init_params_has_the_reference_structure(self, ref):
        """Same leaves (less the kind_ markers), shapes and dtypes as the
        reference's tree, in a bf16 variant: wr, wi and lam stay float32."""
        jc = ref.configs.smoke_config(ARCH, param_dtype="bfloat16")
        tc = smoke_config(ARCH, param_dtype="bfloat16")
        want = numpy_tree(ref, jax_params(ref, jc, seed=0))
        got = thybrid.init_params(tc, single_device_policy(tc),
                                  torch.Generator().manual_seed(0))
        flat = ref.jax.tree_util.tree_flatten_with_path(want)[0]
        n = 0
        for path, leaf in flat:
            keys = [k.key for k in path]
            if keys[-1].startswith("kind_"):
                continue
            t = got
            for k in keys:
                t = t[k]
                if k == "reps":
                    t = t[0]
            shape = leaf.shape[1:] if keys[0] == "reps" else leaf.shape
            assert tuple(t.shape) == shape, keys
            assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), keys
            n += 1
        assert n == len(toptim.tree_leaves(got))

    def test_lam_init_gives_the_griffin_decay_range(self):
        """a^c = exp(-c softplus(lam)) lies in [0.9, 0.999]."""
        tc = smoke_config(ARCH)
        p = thybrid.rglru_init(torch.Generator().manual_seed(1), tc)
        ac = torch.exp(-thybrid.LRU_C * torch.nn.functional.softplus(p["lam"]))
        assert float(ac.min()) >= 0.9 - 1e-6 and float(ac.max()) <= 0.999 + 1e-6


class TestBlocks:
    @pytest.mark.parametrize("with_state", [False, True],
                             ids=["fresh", "state"])
    def test_causal_conv(self, ref, with_state):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((2, 9, 16)).astype(np.float32)
        kern = rng.standard_normal((4, 16)).astype(np.float32)
        st = rng.standard_normal((2, 3, 16)).astype(np.float32)
        jst = ref.jnp.asarray(st) if with_state else None
        tst = torch.from_numpy(st) if with_state else None
        want, wstate = ref.hybrid._causal_conv(ref.jnp.asarray(x),
                                               ref.jnp.asarray(kern), jst)
        got, gstate = tlayers.causal_conv(torch.from_numpy(x),
                                          torch.from_numpy(kern), tst)
        close(got, want)
        close(gstate, wstate)

    def test_rglru_gates(self, ref, carried):
        npy, tt = rec_params(carried[0])
        u = np.random.default_rng(4).standard_normal((2, 11, 64)).astype(
            np.float32)
        ja, jb = ref.hybrid.rglru_gates(
            {k: ref.jnp.asarray(v) for k, v in npy.items() if k != "ln"},
            ref.jnp.asarray(u))
        ta, tb = thybrid.rglru_gates(tt, torch.from_numpy(u))
        assert ta.dtype == tb.dtype == torch.float32
        close(ta, ja)
        close(tb, jb)

    @pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
    def test_lru_scan(self, ref, with_h0):
        rng = np.random.default_rng(5)
        a = rng.uniform(0.5, 1.0, (2, 37, 8)).astype(np.float32)
        bx = rng.standard_normal((2, 37, 8)).astype(np.float32)
        h0 = rng.standard_normal((2, 8)).astype(np.float32)
        want = ref.hybrid.lru_scan(ref.jnp.asarray(a), ref.jnp.asarray(bx),
                                   ref.jnp.asarray(h0) if with_h0 else None)
        got = thybrid.lru_scan(torch.from_numpy(a), torch.from_numpy(bx),
                               torch.from_numpy(h0) if with_h0 else None)
        close(got, want)
        # the kernel path's plain version computes the same recurrence
        close(lru_ops.chunked_lru(torch.from_numpy(a), torch.from_numpy(bx),
                                  torch.from_numpy(h0) if with_h0 else None),
              want)

    @pytest.mark.parametrize("impl", ["pallas", "xla"])
    def test_rglru_forward_with_state(self, ref, carried, impl):
        jc, jpol, tc, tpol = both_cfgs(ref, impl)
        npy, tt = rec_params(carried[0], i=1)
        rng = np.random.default_rng(6)
        x = rng.standard_normal((2, 12, 64)).astype(np.float32)
        h0 = rng.standard_normal((2, 64)).astype(np.float32)
        cst = rng.standard_normal((2, 3, 64)).astype(np.float32)
        jp = ref.jax.tree.map(ref.jnp.asarray, npy)
        wy, (wh, wc) = ref.hybrid.rglru_forward(
            jp, jc, jpol, ref.jnp.asarray(x),
            state=(ref.jnp.asarray(h0), ref.jnp.asarray(cst)),
            return_state=True)
        gy, (gh, gc) = thybrid.rglru_forward(
            tt, tc, tpol, torch.from_numpy(x),
            state=(torch.from_numpy(h0), torch.from_numpy(cst)),
            return_state=True)
        close(gy, wy, **TOL)
        close(gh, wh, **TOL)
        close(gc, wc)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_forward_hidden_states_and_loss(ref, carried, impl):
    jc, jpol, tc, tpol = both_cfgs(ref, impl)
    tree, tp = carried
    jp = ref.jax.tree.map(ref.jnp.asarray, tree)
    toks = tokens(ref, seed=11)
    labels = tokens(ref, seed=12)
    labels[:, :3] = -1
    jh, jaux = ref.hybrid.forward(jc, jpol, jp, ref.jnp.asarray(toks))
    th, taux = thybrid.forward(tc, tpol, tp, torch.from_numpy(toks).long())
    close(th, jh, **TOL)
    assert float(taux) == float(jaux) == 0.0

    batch = {"tokens": ref.jnp.asarray(toks), "labels": ref.jnp.asarray(labels)}
    jl, jm = ref.train_step.make_loss_fn(jc, jpol)(jp, batch)
    tl, tm = tstep.make_loss_fn(tc, tpol)(
        tp, {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()})
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert int(tm["tokens"]) == int(jm["tokens"]) == 2 * 40 - 6


class Counter:
    """Passes calls on to `fn` and counts them."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_remat_recomputes_each_repeat_and_changes_nothing(ref, carried,
                                                          monkeypatch, remat):
    """One forward + backward of the reduced model (1 repeat of (rec, rec,
    attn) + a rec tail): under remat="full" the repeat's 2 RG-LRU and 1
    attention forwards run again in the backward, the tail's do not; the
    reverse walk runs once per recurrent layer. The gradients are those of
    remat="none"."""
    tc = smoke_config(ARCH, attention_impl="pallas")
    tpol = single_device_policy(tc)
    _, tp = carried
    toks = torch.from_numpy(tokens(ref, seed=13)).long()
    batch = {"tokens": toks, "labels": toks.roll(-1, dims=1)}

    def grads(cfg):
        lru = Counter(thybrid.chunked_lru)
        attn = Counter(tlayers.flash_attention)
        rev = Counter(lru_ops.lru_reverse)
        monkeypatch.setattr(thybrid, "chunked_lru", lru)
        monkeypatch.setattr(tlayers, "flash_attention", attn)
        monkeypatch.setattr(lru_ops, "lru_reverse", rev)
        params = tstep.state_for(_clone(tp)).params
        loss, _ = tstep.make_loss_fn(cfg, tpol)(params, batch)
        g = torch.autograd.grad(loss, toptim.tree_leaves(params))
        monkeypatch.undo()
        return loss.detach(), g, (lru.calls, rev.calls, attn.calls)

    base_loss, base_g, _ = grads(tc.with_(remat="none"))
    loss, g, calls = grads(tc.with_(remat=remat))
    assert calls == ((5, 3, 2) if remat == "full" else (3, 3, 1))
    assert float(loss) == float(base_loss)
    for x, y in zip(g, base_g):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


class TestFamilyRouting:
    def test_registry_resolves_the_hybrid_module(self):
        fam = tregistry.get_family(smoke_config(ARCH))
        assert fam is thybrid
        assert fam.forward is thybrid.forward
        assert fam.decode_step is thybrid.decode_step

    def test_dense_prefill_refuses_the_hybrid_family(self, carried):
        tc = smoke_config(ARCH)
        pol = single_device_policy(tc)
        with pytest.raises(ValueError, match="runs the dense family"):
            tlm.prefill(tc, pol, carried[1], torch.zeros((1, 4)).long(), 8)

    def test_dense_families_still_route_to_lm(self):
        assert tregistry.get_family(smoke_config("granite-3-2b")) is tlm
        assert attn_ops.flash_attention.launches == 0
