"""The port's hybrid serving (recurrentgemma-2b's family) against the
reference's `repro.models.hybrid` decode and `repro.serve.engine.generate`.

The reference's parameters (its `init_params` from a fixed key, unboxed, as
numpy arrays) are carried over with `params_from_jax`, so both sides hold
the same weights. On the reduced float32 config (4 layers, d_rnn 64,
local_window 16):

  * `generate` gives the reference's greedy tokens, first column (the
    prompt's last token) included, on B 2, a prompt of 20 tokens and 8 new
    tokens: the ring of 16 slots wraps;
  * each decode step's logits and the state it leaves (RG-LRU states, conv
    tails, ring KV caches, position) against the reference's `decode_step`:
    |port - reference| <= 1e-5 |reference| + 1e-5 max|reference| (float32,
    the same expressions with products summed in another order; seen: at
    most 7e-7 where the largest logit is 0.64, about 1e-6 of it);
  * decode against the full-sequence `forward`, the port's counterparts of
    the reference's tests/test_archs.py::test_recurrent_decode_matches_forward
    and ::test_local_window_ring_cache at their rtol = atol = 2e-2, on
    every position; a cache shorter than the window (not a ring, and
    decoding past its end raises) and a ring of exactly ``max_len ==
    local_window`` slots;
  * `launch/serve.py --arch recurrentgemma-2b --reduced --device cpu`
    prints the tokens the reference's `generate` gives for the same
    parameters and prompts.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.models import hybrid as thybrid
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import unembed
from repro_torch.serve import engine as tengine
from repro_torch.sharding.policy import single_device_policy
from test_torch_reference import load_reference

ARCH = "recurrentgemma-2b"
STEP_RTOL = 1e-5            # decode_step against the reference's
FORWARD_TOL = dict(rtol=2e-2, atol=2e-2)   # decode against forward


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def reference_params(ref, jc, seed):
    pol = ref.policy.single_device_policy(jc)
    init = ref.jax.jit(lambda key: ref.layers.unbox(
        ref.hybrid.init_params(jc, pol, key))[0])
    return init(ref.jax.random.PRNGKey(seed))


def both(ref, seed=2, **overrides):
    """(reference cfg, pol, params; port cfg, pol, params), same weights."""
    jc = ref.configs.smoke_config(ARCH, **overrides)
    jp = reference_params(ref, jc, seed)
    tc = smoke_config(ARCH, **overrides)
    tp = params_from_jax(tc, ref.jax.tree.map(np.asarray, jp), device="cpu")
    return (jc, ref.policy.single_device_policy(jc), jp,
            tc, single_device_policy(tc), tp)


def prompts(seed, B, S, vocab=251):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def assert_step_close(got, want, label):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    bound = STEP_RTOL * np.abs(want) + STEP_RTOL * np.abs(want).max()
    excess = np.abs(got - want) - bound
    assert excess.max() <= 0, (
        f"{label}: |port - reference| exceeds the bound by "
        f"{excess.max():.3g}")


def no_kernel(*args, **kw):
    raise AssertionError("a kernel wrapper was called on the decode path")


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_generate_gives_the_reference_tokens(ref, impl, monkeypatch):
    jc, jpol, jp, tc, tpol, tp = both(ref, attention_impl=impl)
    # S = 1 never reaches a kernel wrapper, on either side
    monkeypatch.setattr(thybrid, "chunked_lru", no_kernel)
    monkeypatch.setattr(tlayers, "flash_attention", no_kernel)
    p = prompts(21, 2, 20)
    assert tc.local_window == 16 < 20      # the ring wraps
    want = np.asarray(ref.engine.generate(jc, jpol, jp, p, max_new=8))
    stats = {}
    got = tengine.generate(tc, tpol, tp, p, max_new=8, stats=stats)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], p[:, -1])   # first column
    assert stats["replay_seconds"] > 0 and stats["decode_seconds"] > 0
    assert "prefill_seconds" not in stats


def replay_both(ref, B, S, max_len, seed=2, **overrides):
    """Token-by-token decode of the same prompt on both sides; checks
    every step's logits and returns the final caches."""
    jc, jpol, jp, tc, tpol, tp = both(ref, seed, **overrides)
    toks = prompts(seed + 1, B, S)
    jcache = ref.hybrid.init_cache(jc, jpol, B, max_len)
    tcache = thybrid.init_cache(tc, tpol, B, max_len, device="cpu")
    step = ref.jax.jit(lambda p, c, t: ref.hybrid.decode_step(
        jc, jpol, p, c, t))
    with torch.inference_mode():
        for i in range(S):
            jl, jcache = step(jp, jcache, toks[:, i:i + 1])
            tl, tcache = thybrid.decode_step(
                tc, tpol, tp, tcache, torch.from_numpy(toks[:, i:i + 1]))
            assert tuple(tl.shape) == (B, 1, 256)
            assert_step_close(tl.numpy()[..., :tc.vocab_size],
                              np.asarray(jl)[..., :jc.vocab_size],
                              f"step {i} logits")
    return jcache, tcache


@pytest.mark.parametrize("S,max_len", [(20, 28), (20, 16), (12, 12)],
                         ids=["ring-wraps", "ring-exactly-window",
                              "shorter-than-window"])
def test_decode_step_matches_the_reference(ref, S, max_len):
    jcache, tcache = replay_both(ref, 2, S, max_len)
    assert tcache.pos == int(jcache.pos) == S
    assert tuple(tcache.k.shape) == tuple(jcache.k.shape)
    assert tcache.k.dtype == torch.bfloat16          # even for float32
    assert tcache.h.dtype == tcache.conv.dtype == torch.float32
    for name in ("h", "conv", "k", "v"):
        assert_step_close(getattr(tcache, name).float().numpy(),
                          np.asarray(getattr(jcache, name), np.float32),
                          f"cache.{name}")


def test_cache_shapes_follow_the_window(ref):
    tc = smoke_config(ARCH)
    pol = single_device_policy(tc)
    ring = thybrid.init_cache(tc, pol, 3, 40, device="cpu")
    assert tuple(ring.h.shape) == (3, 3, 64)         # 3 rec layers of 4
    assert tuple(ring.conv.shape) == (3, 3, 3, 64)   # W - 1 = 3
    assert tuple(ring.k.shape) == (1, 3, 16, 1, 16)  # T = window
    assert ring.pos == 0
    short = thybrid.init_cache(tc, pol, 3, 10, torch.float32, device="cpu")
    assert short.k.shape[2] == 10 and short.k.dtype == torch.float32
    jc = ref.configs.smoke_config(ARCH)
    jring = ref.hybrid.init_cache(jc, ref.policy.single_device_policy(jc),
                                  3, 40)
    assert tuple(jring.k.shape) == tuple(ring.k.shape)
    assert tuple(jring.conv.shape) == tuple(ring.conv.shape)


def decode_against_forward(tc, B, S, max_len, seed=0):
    """(decode logits [B, S, V], forward logits [B, S, V]) of one prompt,
    from the port's own parameters."""
    pol = single_device_policy(tc)
    params = thybrid.init_params(tc, pol,
                                 torch.Generator().manual_seed(seed))
    toks = torch.from_numpy(prompts(seed + 7, B, S))
    with torch.inference_mode():
        hidden, _ = thybrid.forward(tc, pol, params, toks)
        full = unembed(tc, pol, hidden, params["embed"])
        cache = thybrid.init_cache(tc, pol, B, max_len, device="cpu")
        outs = []
        for i in range(S):
            lg, cache = thybrid.decode_step(tc, pol, params, cache,
                                            toks[:, i:i + 1])
            outs.append(lg)
    return torch.cat(outs, dim=1), full


def test_recurrent_decode_matches_forward():
    """tests/test_archs.py::test_recurrent_decode_matches_forward: B 1,
    S 12, a cache of S + 4 (no wrap)."""
    dec, full = decode_against_forward(smoke_config(ARCH), 1, 12, 16)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **FORWARD_TOL)


def test_local_window_ring_cache():
    """tests/test_archs.py::test_local_window_ring_cache: window 8, S 20,
    the ring of 8 slots wraps twice; every position is compared (the
    reference compares the last 4)."""
    tc = smoke_config(ARCH, local_window=8)
    pol = single_device_policy(tc)
    assert thybrid.init_cache(tc, pol, 1, 20, device="cpu").k.shape[2] == 8
    dec, full = decode_against_forward(tc, 1, 20, 20)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **FORWARD_TOL)


@pytest.mark.parametrize("max_len,S", [(12, 12), (16, 24)],
                         ids=["shorter-than-window", "ring-exactly-window"])
def test_decode_matches_forward_at_the_cache_edges(max_len, S):
    dec, full = decode_against_forward(smoke_config(ARCH), 2, S, max_len)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **FORWARD_TOL)


def test_decoding_past_a_short_cache_raises():
    tc = smoke_config(ARCH)
    pol = single_device_policy(tc)
    params = thybrid.init_params(tc, pol, torch.Generator().manual_seed(0))
    cache = thybrid.init_cache(tc, pol, 1, 4, device="cpu")   # not a ring
    tok = torch.zeros((1, 1), dtype=torch.long)
    with torch.inference_mode():
        for _ in range(4):
            _, cache = thybrid.decode_step(tc, pol, params, cache, tok)
        with pytest.raises(ValueError, match="does not fit"):
            thybrid.decode_step(tc, pol, params, cache, tok)


def test_init_cache_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thybrid.init_cache(tc, single_device_policy(tc), 1, 8)


def reference_tree(tp):
    """The reference's hybrid parameter tree (leaves numpy, the repeats
    stacked along a leading axis) of the port's parameters."""
    leaf = lambda x: x.detach().float().numpy()

    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) \
            else leaf(t)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack([leaf(t) for t in trees])

    return {k: (stack(v) if k == "reps" else walk(v)) for k, v in tp.items()}


def test_serve_command_line_prints_the_reference_tokens(ref, capsys):
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "20", "--max-new", "6", "--seed", "4", "--device", "cpu"]
    out = tserve.main(argv)
    printed = capsys.readouterr().out
    assert f"[serve] {ARCH}: generated (2, 6)" in printed
    assert f"sample: {out[0][:8].tolist()}" in printed
    _, _, params, toks, _ = tserve.setup(ARCH, True, 2, 20, 4, "cpu")
    jc = ref.configs.smoke_config(ARCH, attention_impl="pallas")
    want = ref.engine.generate(jc, ref.policy.single_device_policy(jc),
                               reference_tree(params), toks.numpy(),
                               max_new=6)
    np.testing.assert_array_equal(out, np.asarray(want))
    np.testing.assert_array_equal(out[:, 0], toks[:, -1].numpy())
