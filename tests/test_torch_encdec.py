"""The port's encoder-decoder family (seamless-m4t-large-v2) against the
reference's `repro.models.encdec`, its serving and its decode.

The reference's parameters (its `init_params` from a fixed key, unboxed, as
numpy arrays) are carried over with `params_from_jax`, so both sides hold
the same weights. On the reduced float32 config (2 + 2 layers, d 64, 4
heads against 2 KV heads, so that the cross attention and its K/V are
grouped (GQA), head dim 16, layernorm, gelu), with ``attention_impl="pallas"`` on both
sides (the reference's flash-attention kernel in interpret mode, the
port's plain version; the encoder calls it bidirectionally, the decoder
causally) and frames drawn standard normal x 0.02 as launch/serve.py
draws them:

  * `sinusoid` up to the reference's MEMORY_LEN positions; the cross
    attention (`layers.cross_attn_forward`, the plain chunked softmax on
    both sides, longer than one query chunk once); `encode`;
    `decode_train`; `prefill_cross_kv`; `forward`'s hidden states; every
    `decode_step`'s logits and the self-attention KV cache it leaves
    (teacher-forced, from the cross K/V of `prefill_cross_kv`). Bound:
    |port - reference| <= 1e-5 |reference| + 1e-5 max|reference| (float32,
    the same expressions with products summed in another order; seen: at
    most 3e-7 of it), but `sinusoid` at MEMORY_LEN positions: there the
    frequencies' float32 `exp` parts by an ulp between the frameworks and
    the angle reaches 3 071 rad, so that test derives its bound from the
    angle (see it);
  * `generate` gives the reference's greedy tokens, first column (the
    prompt's last token) included, with the cross K/V as long as the
    memory (not MEMORY_LEN);
  * one decode step a position, teacher-forced, against `forward` at every
    position: the port's counterpart of the reference's
    tests/test_archs.py::test_recurrent_decode_matches_forward at its
    rtol = atol = 2e-2 (the decode's bf16 self-attention cache);
  * `launch/serve.py --arch seamless-m4t-large-v2 --reduced --device cpu`
    prints the tokens the reference's `generate` gives for the same
    parameters, prompts and frames.

The train steps are held in tests/test_torch_train.py.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import unembed
from repro_torch.serve import engine as tengine
from repro_torch.sharding.policy import single_device_policy
from test_torch_reference import load_reference

ARCH = "seamless-m4t-large-v2"
RTOL = 1e-5                 # against the reference, relative + of the max
FORWARD_TOL = dict(rtol=2e-2, atol=2e-2)   # decode against forward


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture(scope="module")
def carried(ref):
    """(reference cfg, pol, params; port cfg, pol, params), same weights."""
    jc = ref.configs.smoke_config(ARCH, attention_impl="pallas")
    jpol = ref.policy.single_device_policy(jc)
    init = ref.jax.jit(lambda key: ref.layers.unbox(
        ref.encdec.init_params(jc, jpol, key))[0])
    jp = init(ref.jax.random.PRNGKey(2))
    tc = smoke_config(ARCH, attention_impl="pallas")
    tp = params_from_jax(tc, ref.jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jpol, jp, tc, single_device_policy(tc), tp


def close(got, want, label=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    bound = RTOL * np.abs(want) + RTOL * np.abs(want).max()
    excess = np.abs(got - want) - bound
    assert excess.max() <= 0, (
        f"{label}: |port - reference| exceeds the bound by "
        f"{excess.max():.3g}")


def frames(seed, B, S, d=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, d)) * 0.02).astype(np.float32)


def prompts(seed, B, S, vocab=251):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def test_full_config(ref):
    cfg = get_config(ARCH)
    assert (cfg.n_enc_layers, cfg.n_dec_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_ff) == (24, 24, 1024, 16, 16, 8192)
    assert tencdec.MEMORY_LEN == ref.encdec.MEMORY_LEN == 3072
    red = smoke_config(ARCH)
    assert (red.n_heads, red.n_kv_heads) == (4, 2)        # GQA when reduced


@pytest.mark.parametrize("S,dim", [(20, 64), (3072, 1024)],
                         ids=["reduced", "memory_len"])
def test_sinusoid(ref, S, dim):
    """The frequencies within 1 ulp (float32 `exp` in each framework), so
    the angle pos * freq within 2^-22 of itself, and each sin / cos within
    that plus its own rounding: |port - reference| <= 2^-21 (angle + 1),
    twice that (seen: 2.3e-4 at 3 071 rad, where an ulp of the angle is
    2.4e-4)."""
    want = np.asarray(ref.encdec.sinusoid(ref.jnp.arange(S), dim))
    got = tencdec.sinusoid(torch.arange(S), dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (S, dim)
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half)
    angle = np.arange(S)[:, None] * np.concatenate([freqs, freqs])
    bound = 2.0 ** -21 * (angle + 1)
    excess = np.abs(got.numpy() - want) - bound
    assert excess.max() <= 0, excess.max()
    if S <= 20:                  # angles below 20 rad: the common bound
        close(got, want, "sinusoid")


@pytest.mark.parametrize("S,Tm", [(7, 20), (600, 9)],
                         ids=["short", "two_query_chunks"])
def test_cross_attention(ref, carried, S, Tm):
    jc, jpol, jp, tc, tpol, tp = carried
    jx = {k: np.asarray(v)[0] for k, v in jp["dec"]["xattn"].items()}
    x, mem = frames(3, 2, S) * 50, frames(4, 2, Tm) * 50
    want, (wk, wv) = ref.layers.cross_attn_forward(
        jx, jc, jpol, ref.jnp.asarray(x), ref.jnp.asarray(mem))
    got, (gk, gv) = tlayers.cross_attn_forward(
        tp["dec"][0]["xattn"], tc, tpol, torch.from_numpy(x),
        torch.from_numpy(mem))
    close(got, want, "out")
    assert gk.shape[2] == tc.n_kv_heads        # grouped, not repeated
    close(gk, wk, "k")
    close(gv, wv, "v")


def test_encode_and_prefill_cross_kv(ref, carried):
    jc, jpol, jp, tc, tpol, tp = carried
    emb = frames(5, 2, 24)
    want = ref.encdec.encode(jc, jpol, jp, ref.jnp.asarray(emb))
    with torch.no_grad():
        got = tencdec.encode(tc, tpol, tp, torch.from_numpy(emb))
    close(got, want, "memory")
    wk, wv = ref.encdec.prefill_cross_kv(jc, jpol, jp, want)
    with torch.no_grad():
        gk, gv = tencdec.prefill_cross_kv(tc, tpol, tp, got)
    assert tuple(gk.shape) == (2, 2, 24, 2, 16)       # [Ld, B, Tm, KV, hd]
    close(gk, wk, "xk")
    close(gv, wv, "xv")


def test_decode_train_and_forward(ref, carried):
    jc, jpol, jp, tc, tpol, tp = carried
    emb, toks = frames(6, 2, 24), prompts(7, 2, 18)
    memory = ref.encdec.encode(jc, jpol, jp, ref.jnp.asarray(emb))
    want = ref.encdec.decode_train(jc, jpol, jp, toks, memory)
    with torch.no_grad():
        got = tencdec.decode_train(tc, tpol, tp,
                                   torch.from_numpy(toks).long(),
                                   torch.from_numpy(np.array(memory)))
    close(got, want, "decode_train")
    fwant, aux = ref.encdec.forward(jc, jpol, jp, toks, embeds=emb)
    with torch.no_grad():
        fgot, faux = tencdec.forward(tc, tpol, tp,
                                     torch.from_numpy(toks).long(),
                                     torch.from_numpy(emb))
    close(fgot, fwant, "forward")
    assert float(faux) == float(aux) == 0.0


def test_forward_without_frames_raises(carried):
    tc, tpol, tp = carried[3:]
    with pytest.raises(ValueError, match="embeds"):
        tencdec.forward(tc, tpol, tp, torch.zeros((1, 4)).long())


def test_decode_steps_match_reference(ref, carried):
    jc, jpol, jp, tc, tpol, tp = carried
    B, S, Tm = 2, 10, 14
    emb, toks = frames(8, B, Tm), prompts(9, B, S)
    memory = ref.encdec.encode(jc, jpol, jp, ref.jnp.asarray(emb))
    xk, xv = ref.encdec.prefill_cross_kv(jc, jpol, jp, memory)
    jcache = ref.encdec.init_cache(jc, jpol, B, S)._replace(xk=xk, xv=xv)
    with torch.inference_mode():
        tmem = tencdec.encode(tc, tpol, tp, torch.from_numpy(emb))
        txk, txv = tencdec.prefill_cross_kv(tc, tpol, tp, tmem)
    tcache = tencdec.init_cache(tc, tpol, B, S, memory_len=0,
                                device="cpu")._replace(xk=txk, xv=txv)
    assert tcache.k.dtype == torch.bfloat16 == tencdec.init_cache(
        tc, tpol, 1, 2, device="cpu").xk.dtype      # even for float32
    assert tuple(tcache.k.shape) == tuple(jcache.k.shape)
    step = ref.jax.jit(lambda p, c, t: ref.encdec.decode_step(
        jc, jpol, p, c, t))
    with torch.inference_mode():
        for i in range(S):
            jl, jcache = step(jp, jcache, toks[:, i:i + 1])
            tl, tcache = tencdec.decode_step(
                tc, tpol, tp, tcache, torch.from_numpy(toks[:, i:i + 1]))
            close(tl[..., :tc.vocab_size], np.asarray(jl)[..., :jc.vocab_size],
                  f"step {i} logits")
    assert tcache.pos == int(jcache.pos) == S
    close(tcache.k.float(), np.asarray(jcache.k, np.float32), "cache.k")
    close(tcache.v.float(), np.asarray(jcache.v, np.float32), "cache.v")


def test_generate_gives_the_reference_tokens(ref, carried):
    jc, jpol, jp, tc, tpol, tp = carried
    p, emb = prompts(10, 2, 12), frames(11, 2, 30)
    want = np.asarray(ref.engine.generate(jc, jpol, jp, p, max_new=8,
                                          embeds=emb))
    stats = {}
    got = tengine.generate(tc, tpol, tp, p, max_new=8, embeds=emb,
                           stats=stats)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], p[:, -1])    # first column
    for key in ("encode_seconds", "replay_seconds", "decode_seconds"):
        assert stats[key] > 0, key
    assert "prefill_seconds" not in stats


def test_generate_without_frames_raises(carried):
    tc, tpol, tp = carried[3:]
    with pytest.raises(ValueError, match="embeds"):
        tengine.generate(tc, tpol, tp, prompts(1, 1, 4), max_new=2)


def test_decode_matches_forward():
    """One decode step a position, teacher-forced, against the forward's
    logits at every position: B 1, S 12, a cache of S + 4."""
    tc = smoke_config(ARCH, attention_impl="pallas")
    pol = single_device_policy(tc)
    params = tencdec.init_params(tc, pol, torch.Generator().manual_seed(0))
    S = 12
    toks = torch.from_numpy(prompts(12, 1, S)).long()
    emb = torch.from_numpy(frames(13, 1, 16))
    with torch.inference_mode():
        hidden, _ = tencdec.forward(tc, pol, params, toks, emb)
        full = unembed(tc, pol, hidden, params["embed"])
        xk, xv = tencdec.prefill_cross_kv(tc, pol, params, tencdec.encode(
            tc, pol, params, emb))
        cache = tencdec.init_cache(tc, pol, 1, S + 4, memory_len=0,
                                   device="cpu")._replace(xk=xk, xv=xv)
        outs = []
        for i in range(S):
            lg, cache = tencdec.decode_step(tc, pol, params, cache,
                                            toks[:, i:i + 1])
            outs.append(lg)
    dec = torch.cat(outs, dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **FORWARD_TOL)


def test_init_cache_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tencdec.init_cache(tc, single_device_policy(tc), 1, 8)


def reference_tree(tp):
    """The reference's encoder-decoder parameter tree (leaves numpy, the
    layers stacked along a leading axis) of the port's parameters."""
    leaf = lambda x: x.detach().float().numpy()

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack([leaf(t) for t in trees])

    walk = lambda t: ({k: walk(v) for k, v in t.items()}
                      if isinstance(t, dict) else leaf(t))
    return {k: (stack(v) if k in tencdec.STACKED_KEYS else walk(v))
            for k, v in tp.items()}


def test_serve_command_line_prints_the_reference_tokens(ref, capsys):
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "20", "--max-new", "6", "--seed", "4", "--device", "cpu"]
    out = tserve.main(argv)
    printed = capsys.readouterr().out
    assert f"[serve] {ARCH}: generated (2, 6)" in printed
    _, _, params, toks, emb = tserve.setup(ARCH, True, 2, 20, 4, "cpu")
    assert tuple(emb.shape) == (2, 20, 64) and emb.dtype == torch.float32
    assert 0.01 < float(emb.std()) < 0.03
    jc = ref.configs.smoke_config(ARCH, attention_impl="pallas")
    want = ref.engine.generate(jc, ref.policy.single_device_policy(jc),
                               reference_tree(params), toks.numpy(),
                               max_new=6, embeds=emb.numpy())
    np.testing.assert_array_equal(out, np.asarray(want))
    np.testing.assert_array_equal(out[:, 0], toks[:, -1].numpy())
