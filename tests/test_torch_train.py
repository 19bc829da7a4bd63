"""The port's training step against the reference's `repro.train`.

The reference's parameters are carried over with `params_from_jax`; both
sides then take the same AdamW steps on the same synthetic batches. Under
jax 0.9 `jax.grad` through either Pallas kernel fails
(`_pallas_call_jvp_rule`, ROADMAP.md R5), so the reference's step runs its
``"xla"`` path (associative scan, chunked softmax); the port runs both of
its paths, ``"pallas"`` (the kernels' autograd Functions, their plain
versions on the CPU, so that the RG-LRU's hand-written reverse walk and the
attention's hand-written backward are what is checked) and ``"xla"``
(autograd through plain ops).

Tolerances:
- loss and grad norm: rtol 2e-5 (float32 through a few blocks, sums in
  another order; seen: up to 2e-7 and 1e-6);
- every gradient leaf: rtol 1e-4 plus atol 2e-5 of the leaf's largest
  magnitude (seen: up to 7e-6 of it);
- the parameters after each step: at least 99 % of every leaf within 1e-6,
  and every element within 2 lr per step taken. AdamW's m / sqrt(v) is
  about sign(g) for every gradient far above eps = 1e-8, so an element
  whose gradient is near 0 (seen: 0.4 % of a leaf) can move by up to 2 lr
  on one side and not on the other, from a gradient difference of 1e-9.
  A wrong decay, clip or bias correction moves most of a leaf by more than
  1e-6 (lr * weight_decay * |p| is 3e-5 for |p| = 0.1).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch import train as tlaunch
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_family
from repro_torch.sharding.policy import single_device_policy
from repro_torch.train import data as tdata
from repro_torch.train import loss as tloss
from repro_torch.train import optim as toptim
from repro_torch.train import step as tstep
from test_torch_reference import load_reference

ARCHS = ("recurrentgemma-2b", "granite-3-2b")
#: the MoE (aux loss in the loss) and VLM (embeds, masked prefix) branches
MOE_VLM = ("qwen2-moe-a2.7b", "pixtral-12b")
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=10)
BATCH, SEQ, STEPS = 4, 24, 2
SCALAR_TOL = dict(rtol=2e-5, atol=0)


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture(scope="module")
def ref_init(ref):
    """Reference parameters of each reduced arch, from one key."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jc = ref.configs.smoke_config(arch)
            pol = ref.policy.single_device_policy(jc)
            fam = ref.registry.get_family(jc)
            init = ref.jax.jit(lambda k: ref.layers.unbox(
                fam.init_params(jc, pol, k))[0])
            cache[arch] = init(ref.jax.random.PRNGKey(3))
        return cache[arch]
    return get


def ref_batches(ref, arch):
    jc = ref.configs.smoke_config(arch)
    it = ref.train_data.batches(jc, ref.train_data.DataConfig(
        batch=BATCH, seq=SEQ, seed=1))
    return [next(it) for _ in range(STEPS)]


def torch_batch(b):
    """Tokens and labels as integers, a VLM's embeds as float32."""
    return {k: torch.from_numpy(v) if k == "embeds" else
            torch.from_numpy(v).long() for k, v in b.items()}


@pytest.fixture(scope="module")
def ref_runs(ref, ref_init):
    """The reference's "xla" train step, STEPS steps from the same
    parameters: per step (loss, grad norm, parameters as numpy)."""
    cache = {}

    def get(arch, n_micro):
        if (arch, n_micro) not in cache:
            jc = ref.configs.smoke_config(arch, attention_impl="xla")
            pol = ref.policy.single_device_policy(jc)
            ocfg = ref.train_optim.AdamWConfig(**OPT)
            state = ref.train_step.TrainState(
                params=ref_init(arch),
                opt=ref.train_optim.init(ocfg, ref_init(arch)))
            step = ref.jax.jit(ref.train_step.make_train_step(
                jc, pol, ocfg, n_micro=n_micro))
            out = []
            for b in ref_batches(ref, arch):
                state, mets = step(state, b)
                out.append((float(mets["loss"]), float(mets["grad_norm"]),
                            ref.jax.tree.map(np.asarray, state.params)))
            cache[arch, n_micro] = out
        return cache[arch, n_micro]
    return get


def carried(ref, ref_init, arch, impl):
    tc = smoke_config(arch, attention_impl=impl)
    tree = ref.jax.tree.map(np.asarray, ref_init(arch))
    return tc, single_device_policy(tc), params_from_jax(tc, tree,
                                                         device="cpu")


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(ref, ref_init, ref_runs, arch, n_micro,
                                     impl):
    tc, tpol, tp = carried(ref, ref_init, arch, impl)
    ocfg = toptim.AdamWConfig(**OPT)
    state = tstep.state_for(tp, ocfg)
    step = tstep.make_train_step(tc, tpol, ocfg, n_micro=n_micro)
    for i, (b, (jl, jgn, jparams)) in enumerate(
            zip(ref_batches(ref, arch), ref_runs(arch, n_micro))):
        state, mets = step(state, torch_batch(b))
        np.testing.assert_allclose(float(mets["loss"]), jl, **SCALAR_TOL)
        np.testing.assert_allclose(float(mets["grad_norm"]), jgn,
                                   **SCALAR_TOL)
        want = toptim.tree_leaves(params_from_jax(tc, jparams, device="cpu"))
        got = toptim.tree_leaves(state.params)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            d = (g.detach() - w).abs()
            assert float(d.max()) <= 2 * OPT["lr"] * (i + 1)
            assert float((d <= 1e-6).float().mean()) >= 0.99
    assert state.opt.step == STEPS


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", MOE_VLM)
def test_moe_and_vlm_train_steps_match_reference(ref, ref_init, ref_runs,
                                                  arch, impl):
    """As test_train_steps_match_reference, one and two steps, n_micro 1:
    qwen2-moe's loss carries the router's aux term, pixtral's batches
    carry embeds for the prefix whose labels are -1."""
    test_train_steps_match_reference(ref, ref_init, ref_runs, arch, 1, impl)
    b = ref_batches(ref, arch)[0]
    assert ("embeds" in b) == (arch == "pixtral-12b")
    if "embeds" in b:
        assert (b["labels"][:, :4] == -1).all()
        assert torch_batch(b)["embeds"].abs().min() > 0


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS + MOE_VLM)
def test_every_gradient_leaf_matches_reference(ref, ref_init, arch, impl):
    jc = ref.configs.smoke_config(arch, attention_impl="xla")
    jpol = ref.policy.single_device_policy(jc)
    b = ref_batches(ref, arch)[0]
    vg = ref.jax.jit(ref.jax.value_and_grad(
        ref.train_step.make_loss_fn(jc, jpol), has_aux=True))
    (jl, _), jg = vg(ref_init(arch), b)
    tc, tpol, tp = carried(ref, ref_init, arch, impl)
    params = tstep.state_for(tp).params
    loss, _ = tstep.make_loss_fn(tc, tpol)(params, torch_batch(b))
    got = torch.autograd.grad(loss, toptim.tree_leaves(params))
    want = toptim.tree_leaves(params_from_jax(
        tc, ref.jax.tree.map(np.asarray, jg), device="cpu"))
    np.testing.assert_allclose(float(loss.detach()), float(jl), **SCALAR_TOL)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=2e-5 * scale)


def fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", ARCHS + ("pixtral-12b",
                                          "seamless-m4t-large-v2"))
def test_batches_are_the_references_bit_for_bit(ref, arch):
    """The synthetic stream, including the embeds of the VLM and
    encoder-decoder configs (their configs rebuilt from the reference's
    fields: the port does not have those families yet)."""
    jc = ref.configs.smoke_config(arch)
    tc = ModelConfig(**fields(jc))
    for dc in (dict(batch=4, seq=16, seed=0), dict(batch=6, seq=9, seed=5,
                                                   host_id=1, n_hosts=2)):
        jit = ref.train_data.batches(jc, ref.train_data.DataConfig(**dc))
        tit = tdata.batches(tc, tdata.DataConfig(**dc))
        for _ in range(2):
            want, got = next(jit), next(tit)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("chunk,softcap,z_loss", [
    (16, 0.0, 0.0), (7, 0.0, 0.0), (16, 30.0, 1e-4)],
    ids=["divides", "ragged", "softcap_zloss"])
def test_chunked_ce_matches_reference(ref, chunk, softcap, z_loss):
    """Value and gradients (hidden, embedding) against the reference's;
    ignored labels and the padded vocab rows (251 of 256) included."""
    jc = ref.configs.smoke_config("granite-3-2b", logit_softcap=softcap)
    tc = smoke_config("granite-3-2b", logit_softcap=softcap)
    rng = np.random.default_rng(8)
    h = rng.standard_normal((2, 40, 64)).astype(np.float32)
    w = (rng.standard_normal((256, 64)) * 0.1).astype(np.float32)
    labels = rng.integers(0, 251, (2, 40)).astype(np.int32)
    labels[:, :5] = -1
    jpol = ref.policy.single_device_policy(jc)

    def jloss(hh, ww):
        return ref.train_loss.chunked_ce(jc, jpol, hh, ww,
                                         ref.jnp.asarray(labels), chunk=chunk,
                                         z_loss=z_loss)

    (jl, jm), jg = ref.jax.jit(ref.jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(ref.jnp.asarray(h),
                                              ref.jnp.asarray(w))
    th, tw = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    tl, tm = tloss.chunked_ce(tc, single_device_policy(tc), th, tw,
                              torch.from_numpy(labels), chunk=chunk,
                              z_loss=z_loss)
    tg = torch.autograd.grad(tl, (th, tw))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    assert int(tm["tokens"]) == int(jm["tokens"]) == 2 * 35
    for g, wnt in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-4,
                                   atol=1e-7)


def test_lr_schedule_matches_reference(ref):
    jcfg = ref.train_optim.AdamWConfig(lr=1e-3, warmup_steps=5,
                                       total_steps=12, min_lr_frac=0.2)
    tcfg = toptim.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=12,
                              min_lr_frac=0.2)
    for step in range(0, 15):
        want = float(ref.train_optim.lr_at(jcfg, ref.jnp.asarray(step)))
        np.testing.assert_allclose(toptim.lr_at(tcfg, step), want,
                                   rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_is_the_references(ref, ref_init, arch):
    """Weight decay on the leaves of rank >= 2 in the reference's stacked
    layout, given the family's stacked keys: norm scales and lam of the
    stacked blocks decay, those of the hybrid tail and the final norm do
    not."""
    tc, _, tp = carried(ref, ref_init, arch, "xla")
    stacked = get_family(tc).STACKED_KEYS
    # the reference's own rule, leaf by leaf, carried over like the weights
    rule = ref.jax.tree.map(lambda x: np.full(x.shape, x.ndim >= 2),
                            ref_init(arch))
    want = [bool(m.all()) for m in toptim.tree_leaves(
        params_from_jax(tc, rule, device="cpu"))]
    assert toptim.decay_mask(tp, stacked) == want
    if arch == "recurrentgemma-2b":
        mask = dict(zip(map(id, toptim.tree_leaves(tp)),
                        toptim.decay_mask(tp, stacked)))
        assert mask[id(tp["reps"][0]["b0_rec"]["rec"]["lam"])]
        assert not mask[id(tp["tail"]["t0_rec"]["rec"]["lam"])]
        assert not mask[id(tp["norm"]["scale"])]


class TestLaunch:
    ARGV = ["--arch", "recurrentgemma-2b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "32"]

    def test_reduced_on_the_cpu_by_name(self, capsys):
        stats = {}
        loss = tlaunch.main(self.ARGV, stats=stats)
        assert len(stats["losses"]) == len(stats["step_seconds"]) == 3
        assert np.isfinite(stats["losses"]).all()
        assert loss == stats["losses"][-1]
        assert all(s > 0 for s in stats["step_seconds"])
        assert "[train] done: 3 steps" in capsys.readouterr().out

    def test_microbatches_and_the_dense_family(self):
        stats = {}
        tlaunch.main(["--arch", "granite-3-2b", "--reduced", "--device",
                      "cpu", "--steps", "2", "--batch", "4", "--seq", "16",
                      "--n-micro", "2"], stats=stats)
        assert np.isfinite(stats["losses"]).all()

    def test_vlm_trains_on_its_embeds(self, monkeypatch):
        """pixtral's batches reach the step with their frontend embeddings
        as float32, equal to the data stream's (an integer cast would
        make every one 0), and the aux-free loss is finite."""
        seen = []
        make = tlaunch.make_train_step

        def recording(*a, **kw):
            step = make(*a, **kw)

            def run(state, batch):
                seen.append({k: v.clone() for k, v in batch.items()})
                return step(state, batch)
            return run

        monkeypatch.setattr(tlaunch, "make_train_step", recording)
        stats = {}
        tlaunch.main(["--arch", "pixtral-12b", "--reduced", "--device",
                      "cpu", "--steps", "2", "--batch", "2", "--seq", "16"],
                     stats=stats)
        it = tdata.batches(smoke_config("pixtral-12b"),
                           tdata.DataConfig(batch=2, seq=16, seed=0))
        assert len(seen) == 2 and np.isfinite(stats["losses"]).all()
        for got in seen:
            want = next(it)
            assert got["embeds"].dtype == torch.float32
            assert got["tokens"].dtype == got["labels"].dtype == torch.long
            np.testing.assert_array_equal(got["embeds"].numpy(),
                                          want["embeds"])
            np.testing.assert_array_equal(got["labels"].numpy(),
                                          want["labels"])

    @pytest.mark.parametrize("resume", [False, True],
                             ids=["ckpt-dir", "resume"])
    def test_checkpoint_flags(self, resume, tmp_path):
        """Files every --ckpt-every steps and at the end; --resume goes on
        from the latest (tests/test_torch_ckpt.py holds the losses against
        the reference's)."""
        ck = str(tmp_path / "ck")
        argv = self.ARGV + ["--ckpt-dir", ck, "--ckpt-every", "2"]
        stats = {}
        tlaunch.main(argv, stats=stats)
        assert sorted(os.listdir(ck)) == ["ckpt_00000002.npz",
                                          "ckpt_00000003.npz"]
        if resume:
            tlaunch.main(argv + ["--steps", "5", "--resume"], stats=stats)
            assert stats["start"] == 3 and len(stats["losses"]) == 2
            assert sorted(os.listdir(ck)) == [
                f"ckpt_{s:08d}.npz" for s in (3, 4, 5)]
