"""The port's xLSTM family (xlstm-1.3b) against the reference's
`repro.models.xlstm`, its serving and its decode.

The reference's parameters (its `init_params` from a fixed key, unboxed, as
numpy arrays) are carried over with `params_from_jax`, so both sides hold
the same weights. On the reduced float32 config (8 blocks, 7 mLSTM : 1
sLSTM, d 64, 4 heads, mLSTM head dim 32, chunk 8), with
``attention_impl="pallas"`` on both sides (the family runs no attention
and no kernel: neither package has one for the mLSTM or the sLSTM):

  * `mlstm_scan` at S = 1, S a multiple of the chunk (16), S padded to it
    (13), and from a given state; `slstm_seq` from its zero state (m = -1e9)
    and from a given one; each block's body, with and without a state.
    Bound: |port - reference| <= 1e-5 |reference| + 1e-5 max|reference|
    (float32, the same expressions with products summed in another order;
    seen: at most 6.2e-7 of max|reference|);
  * through the whole model, the same form of bound with 2e-5:
    `forward`'s hidden states, and every `decode_step`'s logits and the
    state it leaves over twelve steps, for the 7:1 pattern, the pattern
    ("m",) (one placeholder sLSTM layer in the cache) and the pattern
    ("s",) (one placeholder mLSTM layer). Float32 rounding grows through
    the eight recurrent blocks on both sides alike: against a float64 run
    of the port (tests/xlstm_float64_noise.py prints these numbers), the
    reference's hidden states are 2.9e-5 of their max
    off and the port's 2.0e-5, the reference's twelfth-step logits 1.1e-5
    and the port's 5.8e-6; port against reference (seen): hidden states
    9.4e-6, logits 1.5e-5, the state 1.4e-5 of the max;
  * `generate` gives the reference's greedy tokens, first column (the
    prompt's last token) included;
  * decode against the full-sequence `forward`, the port's counterpart of
    the reference's tests/test_archs.py::test_recurrent_decode_matches_forward
    at its rtol = atol = 2e-2, every position, once with S a multiple of
    the chunk and once padded;
  * `launch/serve.py --arch xlstm-1.3b --reduced --device cpu` prints the
    tokens the reference's `generate` gives for the same parameters and
    prompts.

The train steps are held in tests/test_torch_train.py.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import xlstm as txlstm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import unembed
from repro_torch.serve import engine as tengine
from repro_torch.sharding.policy import single_device_policy
from test_torch_reference import load_reference

ARCH = "xlstm-1.3b"
RTOL = 1e-5                 # against the reference, relative + of the max
DEEP_RTOL = 2e-5            # the same, through the whole model (docstring)
FORWARD_TOL = dict(rtol=2e-2, atol=2e-2)   # decode against forward
#: patterns of the decode parity: xlstm-1.3b's, and one of each kind alone
PATTERNS = {"7m1s": {}, "m-only": {"xlstm_pattern": ("m",)},
            "s-only": {"xlstm_pattern": ("s",), "n_layers": 2}}


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def both(ref, seed=2, **overrides):
    """(reference cfg, pol, params; port cfg, pol, params), same weights."""
    jc = ref.configs.smoke_config(ARCH, attention_impl="pallas", **overrides)
    jpol = ref.policy.single_device_policy(jc)
    init = ref.jax.jit(lambda key: ref.layers.unbox(
        ref.xlstm.init_params(jc, jpol, key))[0])
    jp = init(ref.jax.random.PRNGKey(seed))
    tc = smoke_config(ARCH, attention_impl="pallas", **overrides)
    tp = params_from_jax(tc, ref.jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jpol, jp, tc, single_device_policy(tc), tp


@pytest.fixture(scope="module")
def carried(ref):
    return both(ref)


def close(got, want, label="", rtol=RTOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    bound = rtol * np.abs(want) + rtol * np.abs(want).max()
    excess = np.abs(got - want) - bound
    assert excess.max() <= 0, (
        f"{label}: |port - reference| exceeds the bound by "
        f"{excess.max():.3g}")


def draw(seed, *shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def prompts(seed, B, S, vocab=251):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


class TestConfig:
    def test_full_config(self, ref):
        cfg = get_config(ARCH)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads) == (48, 2048, 4)
        assert txlstm._mlstm_dims(cfg) == (4096, 4, 1024)
        assert txlstm._slstm_ff(cfg.d_model) == ref.xlstm._slstm_ff(2048)
        assert txlstm._pattern(cfg) == ref.xlstm._pattern(
            ref.configs.get_config(ARCH))

    def test_a_pattern_that_does_not_divide_the_depth_raises(self):
        with pytest.raises(ValueError, match="not a multiple"):
            txlstm._pattern(smoke_config(ARCH, n_layers=9))

    def test_param_shapes_are_the_references(self, carried):
        jc, jpol, jp, tc, tpol, tp = carried
        mine = txlstm.init_params(tc, tpol, torch.Generator().manual_seed(0))
        assert len(mine["blocks"]) == len(tp["blocks"]) == 1
        for name, bp in tp["blocks"][0].items():
            assert sorted(mine["blocks"][0][name]) == sorted(bp)
            for k, v in bp.items():
                got = mine["blocks"][0][name][k]
                if isinstance(v, dict):
                    assert {kk: tuple(x.shape) for kk, x in got.items()} == \
                        {kk: tuple(x.shape) for kk, x in v.items()}
                else:
                    assert tuple(got.shape) == tuple(v.shape), (name, k)
                    assert got.dtype == v.dtype, (name, k)
        assert mine["blocks"][0]["b0_m"]["gate_bias"].tolist() == \
            [1.0, -1.0] * 4


class TestMLSTMScan:
    @pytest.mark.parametrize("S,with_state", [(1, False), (16, False),
                                              (13, False), (11, True)],
                             ids=["S1", "multiple", "padded", "state"])
    def test_matches_reference(self, ref, S, with_state):
        B, H, dh, chunk = 2, 4, 32, 8
        q, k, v = (draw(10 + i, B, S, H, dh) for i in range(3))
        k = k / np.float32(np.sqrt(dh))
        lf = np.array(ref.jax.nn.log_sigmoid(draw(13, B, S, H, shift=1.0)))
        li = np.array(ref.jax.nn.log_sigmoid(draw(14, B, S, H,
                                                    shift=-1.0)))
        C0 = draw(15, B, H, dh, dh, scale=0.1) if with_state else \
            np.zeros((B, H, dh, dh), np.float32)
        n0 = np.abs(draw(16, B, H, dh)) if with_state else \
            np.zeros((B, H, dh), np.float32)
        jn = ref.jnp.asarray
        want, wst = ref.xlstm.mlstm_scan(
            jn(q), jn(k), jn(v), jn(lf), jn(li),
            ref.xlstm.MLSTMState(jn(C0), jn(n0)), chunk)
        t = torch.from_numpy
        got, gst = txlstm.mlstm_scan(t(q), t(k), t(v), t(lf), t(li),
                                     txlstm.MLSTMState(t(C0), t(n0)), chunk)
        close(got, want, "out")
        close(gst.C, wst.C, "C")
        close(gst.n, wst.n, "n")

    def test_padding_leaves_the_state_of_the_unpadded_steps(self):
        """Identity steps: a 13-step scan in chunks of 8 (3 padded) ends in
        the state of the same steps in one chunk of 13 (no padding), and
        the first chunk's outputs agree. Later outputs need not: the
        reference's normaliser carries q.k in `nvec` (``scores / scale``),
        so its outputs depend on where chunks begin (the port keeps that
        expression as written)."""
        B, S, H, dh = 1, 13, 2, 8
        q, k, v = (torch.from_numpy(draw(20 + i, B, S, H, dh))
                   for i in range(3))
        lf = torch.nn.functional.logsigmoid(torch.from_numpy(
            draw(23, B, S, H, shift=1.0)))
        li = torch.nn.functional.logsigmoid(torch.from_numpy(
            draw(24, B, S, H)))
        z = txlstm.MLSTMState(torch.zeros(B, H, dh, dh), torch.zeros(B, H, dh))
        o8, s8 = txlstm.mlstm_scan(q, k, v, lf, li, z, 8)
        o13, s13 = txlstm.mlstm_scan(q, k, v, lf, li, z, 13)
        assert tuple(o8.shape) == tuple(o13.shape) == (B, S, H, dh)
        torch.testing.assert_close(o8[:, :8], o13[:, :8], rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(s8.C, s13.C, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(s8.n, s13.n, rtol=1e-5, atol=1e-6)


def reference_block(jp, name):
    """Repeat 0's block `name` of the reference's stacked parameters."""
    return {k: (v[0] if not isinstance(v, dict) else
                {kk: vv[0] for kk, vv in v.items()})
            for k, v in jp["blocks"][name].items()}


class TestBlocks:
    def test_causal_conv(self, ref):
        x, kern = draw(30, 2, 9, 16), draw(31, 4, 16)
        st = draw(32, 2, 3, 16)
        for state in (None, st):
            want, wst = ref.xlstm._causal_conv(
                ref.jnp.asarray(x), ref.jnp.asarray(kern),
                None if state is None else ref.jnp.asarray(state))
            got, gst = tlayers.causal_conv(
                torch.from_numpy(x), torch.from_numpy(kern),
                None if state is None else torch.from_numpy(state))
            close(got, want, "conv")
            close(gst, wst, "conv state")

    @pytest.mark.parametrize("state", [False, True], ids=["zero", "given"])
    def test_slstm_seq(self, ref, carried, state):
        jc, jpol, jp, tc, tpol, tp = carried
        B, S, d = 2, 9, tc.d_model
        wx = draw(40, B, S, 4 * d)
        if state:
            h0, c0, n0 = (draw(41 + i, B, d, scale=0.5) for i in range(3))
            n0 = np.abs(n0) + 1
            m0 = draw(44, B, d)
        else:
            h0 = c0 = n0 = np.zeros((B, d), np.float32)
            m0 = np.full((B, d), -1e9, np.float32)
        jst = ref.xlstm.SLSTMState(*map(ref.jnp.asarray, (h0, c0, n0, m0)))
        tst = txlstm.SLSTMState(*map(torch.from_numpy, (h0, c0, n0, m0)))
        want, wfin = ref.xlstm.slstm_seq(reference_block(jp, "b7_s"), jc,
                                         jpol, ref.jnp.asarray(wx), jst)
        got, gfin = txlstm.slstm_seq(tp["blocks"][0]["b7_s"], tc, tpol,
                                     torch.from_numpy(wx), tst)
        close(got, want, "h")
        for g, w, name in zip(gfin, wfin, "hcnm"):
            close(g, w, name)

    @pytest.mark.parametrize("name", ["b0_m", "b3_m", "b7_s"])
    @pytest.mark.parametrize("state", [False, True], ids=["fresh", "state"])
    def test_block_body(self, ref, carried, name, state):
        """The block's body (no residual) on x [2, 11, d], with its final
        state; with a state, from the state that its first 5 steps leave."""
        jc, jpol, jp, tc, tpol, tp = carried
        jfn, tfn = ((ref.xlstm.mlstm_forward, txlstm.mlstm_forward)
                    if name.endswith("m") else
                    (ref.xlstm.slstm_forward, txlstm.slstm_forward))
        jb, tb = reference_block(jp, name), tp["blocks"][0][name]
        x = draw(50, 2, 11, tc.d_model)
        jst = tst = None
        if state:
            _, jst = jfn(jb, jc, jpol, ref.jnp.asarray(x[:, :5]),
                         return_state=True)
            with torch.no_grad():
                _, tst = tfn(tb, tc, tpol, torch.from_numpy(x[:, :5]),
                             return_state=True)
            x = x[:, 5:]
        want, wst = jfn(jb, jc, jpol, ref.jnp.asarray(x), state=jst,
                        return_state=True)
        with torch.no_grad():
            got, gst = tfn(tb, tc, tpol, torch.from_numpy(x), state=tst,
                           return_state=True)
        close(got, want, name)
        flat = lambda s: [a for p in s for a in (p if isinstance(p, tuple)
                                                  else (p,))]
        for g, w in zip(flat(gst), flat(wst)):
            close(g, w, f"{name} state")


def test_forward_matches_reference(ref, carried):
    jc, jpol, jp, tc, tpol, tp = carried
    toks = prompts(60, 2, 20)
    want, waux = ref.xlstm.forward(jc, jpol, jp, toks)
    with torch.no_grad():
        got, aux = txlstm.forward(tc, tpol, tp, torch.from_numpy(toks).long())
    close(got, want, "hidden", DEEP_RTOL)
    assert float(aux) == float(waux) == 0.0


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_decode_steps_match_reference(ref, pattern):
    jc, jpol, jp, tc, tpol, tp = both(ref, **PATTERNS[pattern])
    B, S = 2, 12
    toks = prompts(61, B, S)
    jcache = ref.xlstm.init_cache(jc, jpol, B, S)
    tcache = txlstm.init_cache(tc, tpol, B, S, device="cpu")
    for name in ("mC", "mn", "mconv", "sh", "sc", "sn", "sm"):
        assert tuple(getattr(tcache, name).shape) == tuple(
            getattr(jcache, name).shape), name
    step = ref.jax.jit(lambda p, c, t: ref.xlstm.decode_step(
        jc, jpol, p, c, t))
    with torch.inference_mode():
        for i in range(S):
            jl, jcache = step(jp, jcache, toks[:, i:i + 1])
            tl, tcache = txlstm.decode_step(
                tc, tpol, tp, tcache, torch.from_numpy(toks[:, i:i + 1]))
            close(tl[..., :tc.vocab_size], np.asarray(jl)[..., :jc.vocab_size],
                  f"step {i} logits", DEEP_RTOL)
    assert tcache.pos == int(jcache.pos) == S
    for name in ("mC", "mn", "mconv", "sh", "sc", "sn", "sm"):
        assert getattr(tcache, name).dtype == torch.float32
        close(getattr(tcache, name), getattr(jcache, name), f"cache.{name}",
              DEEP_RTOL)


def test_generate_gives_the_reference_tokens(ref, carried):
    jc, jpol, jp, tc, tpol, tp = carried
    p = prompts(62, 2, 20)
    want = np.asarray(ref.engine.generate(jc, jpol, jp, p, max_new=8))
    stats = {}
    got = tengine.generate(tc, tpol, tp, p, max_new=8, stats=stats)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], p[:, -1])    # first column
    assert stats["replay_seconds"] > 0 and stats["decode_seconds"] > 0
    assert "prefill_seconds" not in stats and "encode_seconds" not in stats


@pytest.mark.parametrize("S", [12, 16], ids=["padded", "multiple"])
def test_recurrent_decode_matches_forward(S):
    """tests/test_archs.py::test_recurrent_decode_matches_forward: B 1, a
    cache of S + 4; the forward's chunks of 8 end padded at S 12."""
    tc = smoke_config(ARCH)
    pol = single_device_policy(tc)
    params = txlstm.init_params(tc, pol, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(prompts(7, 1, S)).long()
    with torch.inference_mode():
        hidden, _ = txlstm.forward(tc, pol, params, toks)
        full = unembed(tc, pol, hidden, params["embed"])
        cache = txlstm.init_cache(tc, pol, 1, S + 4, device="cpu")
        outs = []
        for i in range(S):
            lg, cache = txlstm.decode_step(tc, pol, params, cache,
                                           toks[:, i:i + 1])
            outs.append(lg)
    dec = torch.cat(outs, dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **FORWARD_TOL)


def test_init_cache_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        txlstm.init_cache(tc, single_device_policy(tc), 1, 8)


def reference_tree(tp):
    """The reference's xLSTM parameter tree (leaves numpy, the repeats
    stacked along a leading axis) of the port's parameters."""
    leaf = lambda x: x.detach().float().numpy()

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack([leaf(t) for t in trees])

    walk = lambda t: ({k: walk(v) for k, v in t.items()}
                      if isinstance(t, dict) else leaf(t))
    return {k: (stack(v) if k == "blocks" else walk(v))
            for k, v in tp.items()}


def test_serve_command_line_prints_the_reference_tokens(ref, capsys):
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "20", "--max-new", "6", "--seed", "4", "--device", "cpu"]
    out = tserve.main(argv)
    printed = capsys.readouterr().out
    assert f"[serve] {ARCH}: generated (2, 6)" in printed
    _, _, params, toks, embeds = tserve.setup(ARCH, True, 2, 20, 4, "cpu")
    assert embeds is None
    jc = ref.configs.smoke_config(ARCH, attention_impl="pallas")
    want = ref.engine.generate(jc, ref.policy.single_device_policy(jc),
                               reference_tree(params), toks.numpy(),
                               max_new=6)
    np.testing.assert_array_equal(out, np.asarray(want))
    np.testing.assert_array_equal(out[:, 0], toks[:, -1].numpy())
