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

The xLSTM and encoder-decoder families (their own tests): each step taken
from the reference's whole state before it, at the bounds above, but the
xLSTM's share within 1e-6 is counted over the model and its gradient
leaves are held at atol 1e-3 of their largest magnitude: its float32
gradients lie 2e-4 of that from a float64 run on both sides alike (the
tests' docstrings give the numbers).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch import train as tlaunch
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
#: the xLSTM family and the encoder-decoder (embeds: the encoder's frames)
SSM_ENCDEC = ("xlstm-1.3b", "seamless-m4t-large-v2")
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


@pytest.fixture(scope="module")
def ref_states(ref, ref_init):
    """The reference's "xla" train step, STEPS steps from the same
    parameters, n_micro 1: its whole state (parameters, AdamW moments and
    step, as numpy) before the first step and after each, with each step's
    (loss, grad norm)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jc = ref.configs.smoke_config(arch, attention_impl="xla")
            ocfg = ref.train_optim.AdamWConfig(**OPT)
            state = ref.train_step.TrainState(
                params=ref_init(arch),
                opt=ref.train_optim.init(ocfg, ref_init(arch)))
            step = ref.jax.jit(ref.train_step.make_train_step(
                jc, ref.policy.single_device_policy(jc), ocfg))
            states = [ref.jax.tree.map(np.asarray, state)]
            mets = []
            for b in ref_batches(ref, arch):
                state, m = step(state, b)
                states.append(ref.jax.tree.map(np.asarray, state))
                mets.append((float(m["loss"]), float(m["grad_norm"])))
            cache[arch] = states, mets
        return cache[arch]
    return get


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", SSM_ENCDEC)
def test_xlstm_and_encdec_train_steps_match_reference(ref, ref_states, arch,
                                                      impl):
    """One and two steps, n_micro 1, each taken by the port from the
    reference's whole state before it (parameters, AdamW moments, step):
    loss and grad norm within 2e-5, every parameter within 2 lr, and at
    least 99 % of the parameters within 1e-6, of every leaf for seamless
    and of the whole model for the xLSTM. The xLSTM's stacked blocks (its
    1-D gate biases and block norms decay, R6); the encoder-decoder's
    batches carry the encoder's frames as embeds (under "pallas" the
    encoder runs the attention kernel's Function bidirectionally, the
    decoder causally).

    Why each step starts from the reference's state, and why the xLSTM's
    share is counted over the model: an AdamW step moves an element by
    about lr times a ratio of its gradients (lr * sign(g) at the first
    step), so an element whose gradient is within float32 noise of 0 parts
    by up to 2 lr, and this config's noise is large (its gradients lie
    2e-4 of their leaf's largest magnitude from a float64 run of the same
    step, the reference's as the port's: tests/xlstm_float64_noise.py). Seen: one element of the
    64 of the sLSTM norm scale parts at the first step, and, carried into
    the second step, it moves that step's loss by 4e-5 of itself."""
    states, mets = ref_states(arch)
    tc = smoke_config(arch, attention_impl=impl)
    tpol = single_device_policy(tc)
    ocfg = toptim.AdamWConfig(**OPT)
    step = tstep.make_train_step(tc, tpol, ocfg)
    leaves = lambda tree: toptim.tree_leaves(params_from_jax(tc, tree,
                                                             device="cpu"))
    for i, (b, (jl, jgn)) in enumerate(zip(ref_batches(ref, arch), mets)):
        before, after = states[i], states[i + 1]
        state = tstep.state_for(params_from_jax(tc, before.params,
                                                device="cpu"), ocfg)
        state = state._replace(opt=toptim.OptState(
            step=int(before.opt.step), m=leaves(before.opt.m),
            v=leaves(before.opt.v)))
        state, m = step(state, torch_batch(b))
        np.testing.assert_allclose(float(m["loss"]), jl, **SCALAR_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), jgn, **SCALAR_TOL)
        assert state.opt.step == int(after.opt.step) == i + 1
        got = toptim.tree_leaves(state.params)
        want = leaves(after.params)
        assert len(got) == len(want)
        near = []
        for g, w in zip(got, want):
            d = (g.detach() - w).abs()
            assert float(d.max()) <= 2 * OPT["lr"]
            near.append((d <= 1e-6).flatten())
            if arch != "xlstm-1.3b":
                assert float(near[-1].float().mean()) >= 0.99
        assert float(torch.cat(near).float().mean()) >= 0.99
    b = ref_batches(ref, arch)[0]
    assert ("embeds" in b) == (arch == "seamless-m4t-large-v2")
    if "embeds" in b:
        assert b["embeds"].shape == (BATCH, SEQ, 64)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_xlstm_gradient_leaves_match_reference(ref, ref_init, impl):
    """As test_every_gradient_leaf_matches_reference, at the noise of this
    config's gradients: every leaf within rtol 1e-4 plus atol 1e-3 of its
    largest magnitude. Against a float64 run of the same step the
    reference's leaves lie up to 2.1e-4 of that magnitude off and the
    port's 1.8e-4; port against reference, 3.9e-4 (the first mLSTM block's
    conv kernel), while one block alone agrees with float64 within 6e-7 on
    both sides (tests/xlstm_float64_noise.py prints these numbers)."""
    check_gradient_leaves(ref, ref_init, "xlstm-1.3b", impl, 1e-3)


def check_gradient_leaves(ref, ref_init, arch, impl, atol_frac):
    """The port's gradient of the first batch's loss against the
    reference's "xla" one, leaf by leaf: rtol 1e-4 plus atol `atol_frac`
    of the leaf's largest magnitude; the loss at SCALAR_TOL."""
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
                                   atol=atol_frac * scale)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS + MOE_VLM + ("seamless-m4t-large-v2",))
def test_every_gradient_leaf_matches_reference(ref, ref_init, arch, impl):
    check_gradient_leaves(ref, ref_init, arch, impl, 2e-5)


def fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", ARCHS + ("pixtral-12b",
                                          "seamless-m4t-large-v2"))
def test_batches_are_the_references_bit_for_bit(ref, arch):
    """The synthetic stream, including the embeds of the VLM and
    encoder-decoder configs (the port's own configs, which equal the
    reference's field for field)."""
    jc = ref.configs.smoke_config(arch)
    tc = smoke_config(arch)
    assert fields(tc) == fields(jc)
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


@pytest.mark.parametrize("arch", ARCHS + SSM_ENCDEC)
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
    if arch == "xlstm-1.3b":
        mask = dict(zip(map(id, toptim.tree_leaves(tp)),
                        toptim.decay_mask(tp, stacked)))
        assert mask[id(tp["blocks"][0]["b0_m"]["gate_bias"])]
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
