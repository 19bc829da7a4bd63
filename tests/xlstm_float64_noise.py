"""How far float32 rounding carries the reduced xLSTM, on both sides.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/xlstm_float64_noise.py

Runs the port's `models/xlstm.py` in float64 as the truth (its float32
casts, which follow the reference's, widened for the run) beside the
port's and the reference's float32, with the weights, tokens and batches of
tests/test_torch_xlstm.py and tests/test_torch_train.py, and prints, as a
share of the float64 result's largest magnitude: the forward's hidden
states, the logits of twelve decode steps (the 7:1 pattern), every
gradient leaf of the first training batch, and one mLSTM block's
gradients alone. These are the numbers behind the xLSTM tolerances of
those two test files. CPU only; about a minute.
"""
import contextlib
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import torch

import test_torch_train as T
import test_torch_xlstm as X
from repro_torch.models.convert import params_from_jax
from repro_torch.train import optim as toptim
from repro_torch.train import step as tstep


@contextlib.contextmanager
def float64_port():
    """The port's explicit float32 casts and allocations widened to
    float64 (its code follows the reference's float32 casts)."""
    f, zeros, full = torch.Tensor.float, torch.zeros, torch.full
    wide = lambda fn: lambda *a, **k: fn(*a, **(
        {**k, "dtype": torch.float64} if k.get("dtype") == torch.float32
        else k))
    torch.Tensor.float = lambda self, *a, **k: (
        self if self.dtype == torch.float64 else f(self, *a, **k))
    torch.zeros, torch.full = wide(zeros), wide(full)
    try:
        yield
    finally:
        torch.Tensor.float, torch.zeros, torch.full = f, zeros, full


def as64(tree):
    if isinstance(tree, dict):
        return {k: as64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as64(v) for v in tree]
    return tree.detach().double()


def shares(port, ref, truth):
    """(port - truth, reference - truth, port - reference) over the
    truth's largest magnitude."""
    p, r, t = (np.asarray(x, np.float64) for x in (port, ref, truth))
    m = np.abs(t).max()
    return (np.abs(p - t).max() / m, np.abs(r - t).max() / m,
            np.abs(p - r).max() / m)


def show(label, s):
    print(f"{label:34s} port {s[0]:.2g}  reference {s[1]:.2g}  "
          f"port-reference {s[2]:.2g}  (of the float64 max)")


def main():
    ref = X.load_reference()
    jc, jpol, jp, tc, tpol, tp = X.both(ref)
    tc64 = tc.with_(param_dtype="float64", compute_dtype="float64")
    tp64 = as64(tp)

    toks = X.prompts(60, 2, 20)          # test_forward_matches_reference
    want, _ = ref.xlstm.forward(jc, jpol, jp, toks)
    with torch.no_grad():
        got, _ = X.txlstm.forward(tc, tpol, tp, torch.from_numpy(toks).long())
        with float64_port():
            truth, _ = X.txlstm.forward(tc64, tpol, tp64,
                                        torch.from_numpy(toks).long())
    show("forward hidden states", shares(got, want, truth))

    B, S = 2, 12                         # test_decode_steps_match_reference
    toks = X.prompts(61, B, S)
    jcache = ref.xlstm.init_cache(jc, jpol, B, S)
    tcache = X.txlstm.init_cache(tc, tpol, B, S, device="cpu")
    c64 = X.txlstm.init_cache(tc64, tpol, B, S, torch.float64, device="cpu")
    step = ref.jax.jit(lambda p, c, t: ref.xlstm.decode_step(jc, jpol, p, c,
                                                             t))
    V = tc.vocab_size
    with torch.inference_mode():
        for i in range(S):
            t = toks[:, i:i + 1]
            jl, jcache = step(jp, jcache, t)
            tl, tcache = X.txlstm.decode_step(tc, tpol, tp, tcache,
                                              torch.from_numpy(t))
            with float64_port():
                l64, c64 = X.txlstm.decode_step(tc64, tpol, tp64, c64,
                                                torch.from_numpy(t))
            show(f"decode step {i} logits", shares(
                tl[..., :V], np.asarray(jl)[..., :V], l64[..., :V]))

    arch = "xlstm-1.3b"                  # test_torch_train.py's first batch
    jc = ref.configs.smoke_config(arch, attention_impl="xla")
    jpol = ref.policy.single_device_policy(jc)
    fam = ref.registry.get_family(jc)
    jp0 = ref.jax.jit(lambda k: ref.layers.unbox(fam.init_params(
        jc, jpol, k))[0])(ref.jax.random.PRNGKey(3))
    b = T.ref_batches(ref, arch)[0]
    jg = ref.jax.jit(ref.jax.grad(lambda p, bb: ref.train_step.make_loss_fn(
        jc, jpol)(p, bb)[0]))(jp0, b)
    tc = X.smoke_config(arch, attention_impl="xla")
    tree = ref.jax.tree.map(np.asarray, jp0)
    want = toptim.tree_leaves(params_from_jax(
        tc, ref.jax.tree.map(np.asarray, jg), device="cpu"))

    def grads(cfg, params):
        params = tstep.state_for(params).params
        loss, _ = tstep.make_loss_fn(cfg, tpol)(params, T.torch_batch(b))
        return torch.autograd.grad(loss, toptim.tree_leaves(params))

    got = grads(tc, params_from_jax(tc, tree, device="cpu"))
    with float64_port():
        truth = grads(tc.with_(param_dtype="float64",
                               compute_dtype="float64"),
                      as64(params_from_jax(tc, tree, device="cpu")))
    worst = np.max([shares(g.detach(), w, t.detach())
                    for g, w, t in zip(got, want, truth)], axis=0)
    show("gradient leaves (worst of each)", worst)

    # one mLSTM block alone, a random cotangent
    jc, jpol, jp, tc, tpol, tp = X.both(ref)
    jb, tb = X.reference_block(jp, "b0_m"), tp["blocks"][0]["b0_m"]
    x, gy = X.draw(50, 2, 24, 64), X.draw(51, 2, 24, 64)
    jgb = ref.jax.grad(lambda p: (ref.xlstm.mlstm_forward(
        p, jc, jpol, ref.jnp.asarray(x)) * gy).sum())(jb)

    def block_grads(cfg, p, dt):
        p = {k: ({kk: vv.detach().to(dt).requires_grad_()
                  for kk, vv in v.items()} if isinstance(v, dict) else
                 v.detach().to(dt).requires_grad_()) for k, v in p.items()}
        y = X.txlstm.mlstm_forward(p, cfg, tpol, torch.from_numpy(x).to(dt))
        leaves = [p[k][kk] if isinstance(p[k], dict) else p[k]
                  for k in sorted(p) for kk in (sorted(p[k]) if isinstance(
                      p[k], dict) else [None])]
        return torch.autograd.grad((y * torch.from_numpy(gy).to(dt)).sum(),
                                   leaves)

    got = block_grads(tc, tb, torch.float32)
    with float64_port():
        truth = block_grads(tc.with_(param_dtype="float64",
                                     compute_dtype="float64"), tb,
                            torch.float64)
    want = [np.asarray(jgb[k][kk] if isinstance(jgb[k], dict) else jgb[k])
            for k in sorted(jgb) for kk in (sorted(jgb[k]) if isinstance(
                jgb[k], dict) else [None])]
    worst = np.max([shares(g, w, t) for g, w, t in zip(got, want, truth)],
                   axis=0)
    show("one mLSTM block's gradients", worst)


if __name__ == "__main__":
    sys.exit(main())
