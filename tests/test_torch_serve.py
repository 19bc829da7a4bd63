"""The port's serving path against the reference's `repro.serve.engine`.

`generate` must give the SAME greedy tokens as the reference's on the
reduced granite-3-2b and starcoder2-7b (float32, weights carried over with
`params_from_jax`, B = 2, prompt 20, 6 new tokens), under both attention
paths: ``"pallas"`` (the reference's Pallas kernel in interpret mode; the
port's flash-attention wrapper, which takes its plain version on CPU
tensors) and ``"xla"`` (the chunked softmax on both sides). Both sides
round the KV cache through bf16 at the same places, so the tokens agree
exactly, not to a tolerance. The same on the reduced MoE qwen2-moe-a2.7b
and arctic-480b (their prefill routing at the prompt's capacity, a decode
step at C = 1, on both sides) and the VLM backbone pixtral-12b, given
frontend embeddings for its first ``n_prefix`` positions.

Also: the command line on the CPU (the MoE and VLM archs included, text
only, as the reference's), its refusal without a card, and the unported
families (the hybrid family's serving is held in
tests/test_torch_hybrid_serve.py).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.launch import serve as tserve
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine as tengine
from repro_torch.sharding.policy import single_device_policy
from test_torch_reference import load_reference


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def setup_both(ref, arch, impl):
    jc = ref.configs.smoke_config(arch, attention_impl=impl)
    tc = smoke_config(arch, attention_impl=impl)
    jpol = ref.policy.single_device_policy(jc)
    boxed = ref.lm.init_params(jc, jpol, ref.jax.random.PRNGKey(5))
    jp, _ = ref.layers.unbox(boxed)
    tp = params_from_jax(tc, ref.jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jpol, jp, tc, single_device_policy(tc), tp


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "starcoder2-7b"])
def test_generate_gives_the_reference_tokens(ref, arch, impl):
    jc, jpol, jp, tc, tpol, tp = setup_both(ref, arch, impl)
    prompts = np.random.default_rng(21).integers(
        0, jc.vocab_size, (2, 20)).astype(np.int32)
    want = ref.engine.generate(jc, jpol, jp, prompts, max_new=6)
    got = tengine.generate(tc, tpol, tp, prompts, max_new=6)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert attn_ops.flash_attention.launches == 0     # no kernel on the CPU


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "arctic-480b",
                                  "pixtral-12b"])
def test_moe_and_vlm_generate_give_the_reference_tokens(ref, arch):
    jc, jpol, jp, tc, tpol, tp = setup_both(ref, arch, "pallas")
    rng = np.random.default_rng(22)
    prompts = rng.integers(0, jc.vocab_size, (2, 20)).astype(np.int32)
    embeds = None
    if jc.embeds_input:
        embeds = (rng.standard_normal((2, jc.n_prefix, jc.d_model))
                  * 0.02).astype(np.float32)
    want = ref.engine.generate(jc, jpol, jp, prompts, max_new=6,
                               embeds=None if embeds is None
                               else ref.jnp.asarray(embeds))
    stats = {}
    got = tengine.generate(tc, tpol, tp, prompts, max_new=6, embeds=embeds,
                           stats=stats)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert tuple(stats["prefill_logits"].shape) == (2, 1, 256)
    if embeds is not None:      # the embeddings reach the prefill
        plain = {}
        text = tengine.generate(tc, tpol, tp, prompts, max_new=1,
                                stats=plain)
        assert text.shape == (2, 1)
        assert not torch.equal(plain["prefill_logits"],
                               stats["prefill_logits"])


def test_serve_step_is_greedy_decode(ref):
    _, _, _, tc, tpol, tp = setup_both(ref, "granite-3-2b", "xla")
    from repro_torch.models import lm
    prompts = torch.randint(0, tc.vocab_size, (2, 5),
                            generator=torch.Generator().manual_seed(0))
    _, cache = lm.prefill(tc, tpol, tp, prompts, 8)
    tok = prompts[:, -1:]
    nxt, cache2 = tengine.make_serve_step(tc, tpol)(tp, cache, tok)
    assert nxt.shape == (2, 1) and cache2.pos == 6
    logits, _ = lm.decode_step(tc, tpol, tp, cache._replace(pos=5), tok)
    assert torch.equal(nxt, torch.argmax(logits, dim=-1))


def test_generate_reports_its_stages(ref):
    _, _, _, tc, tpol, tp = setup_both(ref, "granite-3-2b", "pallas")
    stats = {}
    out = tengine.generate(tc, tpol, tp, np.zeros((1, 4), np.int32),
                           max_new=3, stats=stats)
    assert out.shape == (1, 3)
    assert stats["prefill_seconds"] > 0 and stats["decode_seconds"] > 0
    assert tuple(stats["prefill_logits"].shape) == (1, 1, 256)


class TestLaunch:
    def test_reduced_on_the_cpu_by_name(self, capsys):
        out = tserve.main(["--arch", "granite-3-2b", "--reduced",
                           "--batch", "2", "--prompt-len", "8",
                           "--max-new", "4", "--device", "cpu"])
        assert out.shape == (2, 4)
        assert (out >= 0).all() and (out < 251).all()
        assert "[serve] granite-3-2b: generated (2, 4)" in capsys.readouterr().out

    def test_same_seed_same_tokens(self):
        argv = ["--arch", "starcoder2-7b", "--reduced", "--batch", "1",
                "--prompt-len", "6", "--max-new", "3", "--device", "cpu"]
        assert np.array_equal(tserve.main(argv), tserve.main(argv))

    def test_setup_serves_the_kernel_path(self):
        cfg, _, params, prompts, embeds = tserve.setup(
            "granite-3-2b", True, 2, 8, 0, "cpu")
        assert cfg.attention_impl == "pallas"
        assert tuple(prompts.shape) == (2, 8)
        assert params["embed"].device.type == "cpu"
        assert embeds is None          # frames are drawn for encdec only

    def test_default_device_is_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.main(["--arch", "granite-3-2b", "--reduced"])

    @pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "arctic-480b",
                                      "pixtral-12b"])
    def test_moe_and_vlm_archs_serve_by_name(self, arch, capsys):
        out = tserve.main(["--arch", arch, "--reduced", "--batch", "2",
                           "--prompt-len", "8", "--max-new", "3",
                           "--device", "cpu"])
        assert out.shape == (2, 3) and (out < 251).all()
        assert f"[serve] {arch}: generated (2, 3)" in capsys.readouterr().out

    @pytest.mark.parametrize("arch", ["xlstm-1.3b", "seamless-m4t-large-v2"])
    def test_unported_arch_raises(self, arch, capsys):
        """Once the refusal of the two families the port lacked; now both
        serve by name from the command line."""
        out = tserve.main(["--arch", arch, "--reduced", "--batch", "2",
                           "--prompt-len", "8", "--max-new", "3",
                           "--device", "cpu"])
        assert out.shape == (2, 3) and (out < 251).all()
        assert f"[serve] {arch}: generated (2, 3)" in capsys.readouterr().out
