"""The port's flash-attention module against the reference's.

The plain PyTorch version (`repro_torch.kernels.flash_attention.ref`,
reached through the public wrapper `ops.flash_attention` on CPU tensors) is
held against the reference's Pallas kernel run in interpret mode on the CPU
(`repro.kernels.flash_attention.ops.flash_attention`, ``bq = bkv = 32``, as
`tests/test_kernels.py` runs it) and against the reference's oracle
`attention_ref`, on the same numpy inputs.

Tolerances (abs + rel, as `tests/test_kernels.py:46`): 2e-5 in float32
(the same function summed in another order) and 2e-2 in bfloat16 (both
sides round the float32 result to bf16 once; a sum that lands near a
rounding boundary may round the other way).

The gradient (`AttentionFunction`, whose backward is the plain
`attention_bwd_ref` on every device) is held against autograd through the
port's `attention_ref` and against `jax.grad` of the reference's
`attention_ref`: float32 rtol 1e-4, atol 2e-5 (dK and dV sum over every
query of a KV group, in another order); bfloat16 2e-2 as above.

The CUDA kernels themselves run only on the card: `chip_smoke.py` holds
them against this plain version there (bfloat16: the Hopper kernel, which
carries p into the P.V product as two bf16 terms; float32: the CUDA-core
kernel). Here the tests hold what surrounds them: the dispatch by type,
the checks that refuse what the TMA copies cannot take, and the binding,
each before anything is built.
"""
import ctypes
import types
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention.ref import attention_ref
from test_torch_reference import load_reference

CASES = [
    # B, Sq, Skv, H, KV, hd, causal, window, softcap
    (2, 64, 64, 4, 2, 32, True, 0, 0.0),        # tests/test_kernels.py:24-31
    (1, 128, 128, 8, 8, 64, True, 0, 0.0),
    (2, 48, 48, 4, 1, 32, True, 16, 0.0),       # MQA + local window
    (1, 32, 96, 4, 2, 32, True, 0, 0.0),        # prefix offset (Skv > Sq)
    (2, 64, 64, 4, 4, 32, False, 0, 0.0),       # bidirectional
    (1, 40, 40, 2, 2, 16, True, 0, 0.0),        # ragged
    (1, 64, 64, 4, 4, 32, True, 0, 20.0),       # softcap 20
    (1, 128, 128, 32, 8, 64, True, 0, 0.0),     # granite-3-2b's head layout
]
DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}
GRAD_CASES = [
    # B, Sq, Skv, H, KV, hd, causal, window, softcap
    (2, 64, 64, 4, 2, 32, True, 0, 0.0),        # causal GQA
    (2, 48, 48, 4, 1, 32, True, 16, 0.0),       # MQA + local window
    (1, 32, 96, 4, 2, 32, True, 0, 0.0),        # prefix offset (Skv > Sq)
    (2, 64, 64, 4, 4, 32, False, 0, 0.0),       # bidirectional
    (1, 64, 64, 4, 4, 32, True, 0, 20.0),       # softcap 20
    (1, 600, 600, 2, 1, 16, True, 100, 0.0),    # MQA, window, 2 query blocks
]
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def inputs(case, seed):
    B, Sq, Skv, H, KV, hd = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), dtype=np.float32),
            rng.standard_normal((B, Skv, KV, hd), dtype=np.float32),
            rng.standard_normal((B, Skv, KV, hd), dtype=np.float32))


def to_jax(ref, arrays, dtype_name):
    return [ref.jnp.asarray(a, getattr(ref.jnp, dtype_name)) for a in arrays]


def to_torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_version_matches_reference_kernel_and_oracle(ref, case,
                                                           dtype_name):
    causal, window, softcap = case[6:]
    dtype, tol = DTYPES[dtype_name]
    arrays = inputs(case, seed=sum(case[:6]))
    qj, kj, vj = to_jax(ref, arrays, dtype_name)
    want_kernel = ref.attn_ops.flash_attention(
        qj, kj, vj, causal=causal, window=window, softcap=softcap, bq=32,
        bkv=32)
    want_oracle = ref.attn_ref.attention_ref(
        qj, kj, vj, causal=causal, window=window, softcap=softcap)
    q, k, v = to_torch(arrays, dtype)
    got = tops.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    assert got.dtype == dtype and tuple(got.shape) == tuple(q.shape)
    for want in (want_kernel, want_oracle):
        np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_gradient_matches_autograd_and_jax_grad(ref, case):
    causal, window, softcap = case[6:]
    kw = dict(causal=causal, window=window, softcap=softcap)
    arrays = inputs(case, seed=sum(case[:6]) + 1)
    do = np.random.default_rng(9).standard_normal(
        arrays[0].shape).astype(np.float32)
    jnp = ref.jnp

    def jloss(q, k, v):
        return jnp.sum(ref.attn_ref.attention_ref(q, k, v, **kw) * do)

    want_jax = ref.jax.jit(ref.jax.grad(jloss, argnums=(0, 1, 2)))(
        *to_jax(ref, arrays, "float32"))
    q, k, v = (x.requires_grad_() for x in to_torch(arrays, torch.float32))
    tdo = torch.from_numpy(do)
    out = tops.flash_attention(q, k, v, **kw)
    assert type(out.grad_fn).__name__ == "AttentionFunctionBackward"
    got = torch.autograd.grad(out, (q, k, v), tdo)
    want_torch = torch.autograd.grad(attention_ref(q, k, v, **kw), (q, k, v),
                                     tdo)
    for g, wt, wj in zip(got, want_torch, want_jax):
        np.testing.assert_allclose(as_f32(g), as_f32(wt), **GRAD_TOL)
        np.testing.assert_allclose(as_f32(g), as_f32(wj), **GRAD_TOL)


def test_gradient_in_bfloat16():
    """MQA with a window (recurrentgemma's layout, narrow), bf16 inputs:
    the gradients in bf16 against autograd through the plain forward."""
    case = (2, 80, 80, 4, 1, 32, True, 24, 0.0)
    q, k, v = (x.requires_grad_() for x in
               to_torch(inputs(case, seed=5), torch.bfloat16))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)
                     ).to(torch.bfloat16)
    kw = dict(causal=True, window=24)
    got = torch.autograd.grad(tops.flash_attention(q, k, v, **kw), (q, k, v),
                              do)
    want = torch.autograd.grad(attention_ref(q, k, v, **kw), (q, k, v), do)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(as_f32(g), as_f32(w), rtol=2e-2,
                                   atol=2e-2)


class TestRouting:
    def args(self, dtype=torch.float32):
        return to_torch(inputs(CASES[0], seed=1), dtype)

    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self):
        before = tops.flash_attention.launches
        q, k, v = self.args()
        a = tops.flash_attention(q, k, v)
        b = tops.flash_attention(q, k, v, impl="torch")
        assert torch.equal(a, b)
        assert torch.equal(a, attention_ref(q, k, v))
        assert tops.flash_attention.launches == before == 0

    def test_cuda_by_name_on_cpu_tensors_raises(self):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            tops.flash_attention(*self.args(), impl="cuda")

    def test_no_autograd_function_without_a_gradient(self):
        """Serving runs under inference mode: the forward alone."""
        q, k, v = self.args()
        assert tops.flash_attention(q, k, v).grad_fn is None
        q.requires_grad_()
        with torch.inference_mode():
            assert tops.flash_attention(q, k, v).grad_fn is None
        out = tops.flash_attention(q, k, v)
        assert type(out.grad_fn).__name__ == "AttentionFunctionBackward"

    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError, match="unknown impl"):
            tops.flash_attention(*self.args(), impl="pallas")

    def test_resolution(self):
        assert tops.resolve_impl(None, torch.device("cpu")) == "torch"
        assert tops.resolve_impl(None, torch.device("cuda", 0)) == "cuda"
        assert tops.resolve_impl("torch", torch.device("cuda", 0)) == "torch"


@pytest.fixture
def no_build(monkeypatch):
    """Fails a test that would build or open the CUDA library."""
    def refuse(*args, **kw):
        raise AssertionError("the CUDA library was built or opened")
    monkeypatch.setattr(tkernel.build, "load_library", refuse)
    monkeypatch.setattr(tkernel, "_lib", None)


def misaligned(shape, dtype):
    """A contiguous tensor of `shape` whose data starts 2 bytes past a
    16-byte boundary."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 8, dtype=dtype)
    start = next(i for i in range(1, 8)
                 if (flat.data_ptr() + i * flat.element_size()) % 16)
    return flat[start:start + n].view(shape)


class TestChecks:
    def test_float16_is_refused(self):
        q, k, v = to_torch(inputs(CASES[0], seed=2), torch.float16)
        with pytest.raises(ValueError, match="dtype must be one of"):
            tops.flash_attention(q, k, v)

    def test_mixed_dtypes_are_refused(self):
        q, k, v = to_torch(inputs(CASES[0], seed=2), torch.float32)
        with pytest.raises(ValueError, match="has dtype"):
            tops.flash_attention(q, k.to(torch.bfloat16), v)

    def test_heads_must_divide(self):
        q, k, v = to_torch(inputs((1, 8, 8, 3, 2, 16), seed=3),
                           torch.float32)
        with pytest.raises(ValueError, match="H % KV"):
            tops.flash_attention(q, k, v)

    def test_k_and_v_shapes_must_agree(self):
        q, k, v = to_torch(inputs(CASES[0], seed=4), torch.float32)
        with pytest.raises(ValueError, match="k and v"):
            tops.flash_attention(q, k, v[:, :-1])
        with pytest.raises(ValueError, match="k and v"):
            tops.flash_attention(q, k[..., :16], v[..., :16])

    def test_rank_is_checked(self):
        q, k, v = to_torch(inputs(CASES[0], seed=5), torch.float32)
        with pytest.raises(ValueError, match="4-D"):
            tops.flash_attention(q[0], k, v)

    def test_tensors_only(self):
        q, k, v = inputs(CASES[0], seed=6)
        with pytest.raises(TypeError, match="must be a tensor"):
            tops.flash_attention(q, k, v)

    @pytest.mark.parametrize("name", ["q", "k", "v"])
    def test_tma_refuses_an_unaligned_base_before_any_build(self, no_build,
                                                            name):
        args = dict(zip("qkv", to_torch(inputs(CASES[1], seed=7),
                                        torch.bfloat16)))
        args[name] = misaligned(tuple(args[name].shape), torch.bfloat16)
        assert args[name].is_contiguous() and args[name].data_ptr() % 16
        with pytest.raises(ValueError, match=f"{name} must start on a "
                                             f"16-byte boundary"):
            tops._forward(args["q"], args["k"], args["v"], True, 0, 0.0,
                          "cuda")

    @pytest.mark.parametrize("name", ["q", "k", "v"])
    def test_tma_refuses_a_non_contiguous_input_before_any_build(
            self, no_build, name):
        args = dict(zip("qkv", to_torch(inputs(CASES[1], seed=8),
                                        torch.bfloat16)))
        x = args[name]
        args[name] = x.transpose(1, 2).contiguous().transpose(1, 2)
        assert torch.equal(args[name], x) and not args[name].is_contiguous()
        with pytest.raises(ValueError, match=f"{name} must be contiguous"):
            tops._forward(args["q"], args["k"], args["v"], True, 0, 0.0,
                          "cuda")

    def test_grid_limit_before_any_build(self, no_build):
        q = torch.zeros((tops.MAX_GRID_Y + 1, 1, 1, 16), dtype=torch.bfloat16)
        k = torch.zeros((tops.MAX_GRID_Y + 1, 1, 1, 16), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="exceeds the grid"):
            tops.check_launchable(q, k, k)

    def test_aligned_contiguous_inputs_pass(self):
        tops.check_launchable(*to_torch(inputs(CASES[1], seed=9),
                                        torch.bfloat16))


class TestBinding:
    def test_flags_are_the_stated_ones(self):
        flags = " ".join(tkernel.FLAGS)
        assert "arch=compute_90a,code=sm_90a" in flags and "-O3" in flags
        assert "-fmad=false" not in flags and "use_fast_math" not in flags

    def test_head_dims(self):
        assert tkernel.HEAD_DIMS == (16, 32, 64, 128, 256)

    def test_unsupported_head_dim_raises_before_any_build(self, no_build):
        with pytest.raises(ValueError, match="no instantiation"):
            tkernel.launch(torch.bfloat16, 96, 0, 0, 0, 0, (1, 1, 1, 1, 1),
                           True, 0, 0.0, 1.0, 0)
        with pytest.raises(ValueError, match="no instantiation"):
            tkernel.smem_bytes(torch.float32, 96)

    def test_dtype_dispatch_is_stated(self, monkeypatch):
        """bfloat16 goes to the Hopper kernel (kind 1), float32 to the
        CUDA-core kernel (kind 0): one C call each, no other."""
        assert tkernel.KIND == {torch.float32: 0, torch.bfloat16: 1}
        calls = []
        fake = types.SimpleNamespace(
            flash_attention_launch=lambda *a: calls.append(a) or 0)
        monkeypatch.setattr(tkernel, "load", lambda: fake)
        for dtype, kind in ((torch.bfloat16, 1), (torch.float32, 0)):
            assert tkernel.launch(dtype, 64, 16, 32, 48, 64,
                                  (2, 5, 7, 4, 2), True, 3, 0.5, 0.125,
                                  99) == 0
            assert calls[-1][:2] == (kind, 64)
            assert calls[-1][6:13] == (2, 5, 7, 4, 2, 1, 3)
        assert len(calls) == 2

    @pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
    def test_other_dtypes_raise_before_any_build(self, no_build, dtype):
        with pytest.raises(ValueError, match="no kernel for"):
            tkernel.launch(dtype, 64, 0, 0, 0, 0, (1, 1, 1, 1, 1), True, 0,
                           0.0, 1.0, 0)
        with pytest.raises(ValueError, match="no kernel for"):
            tkernel.smem_bytes(dtype, 64)

    def test_c_signature(self, monkeypatch):
        """The types the binding gives the two C functions: kind, head dim,
        four device pointers, B, Sq, Skv, H, KV, causal, window, softcap,
        scale, the stream; and (kind, head dim) -> bytes."""
        fake = types.SimpleNamespace(
            flash_attention_launch=types.SimpleNamespace(),
            flash_attention_smem_bytes=types.SimpleNamespace())
        monkeypatch.setattr(tkernel.build, "load_library",
                            lambda name, flags: fake)
        monkeypatch.setattr(tkernel, "_lib", None)
        assert tkernel.load() is fake
        c = ctypes
        assert fake.flash_attention_launch.argtypes == (
            [c.c_int, c.c_int] + [c.c_void_p] * 4 + [c.c_int] * 7
            + [c.c_float] * 2 + [c.c_void_p])
        assert fake.flash_attention_launch.restype is c.c_int
        assert fake.flash_attention_smem_bytes.argtypes == [c.c_int, c.c_int]
        assert fake.flash_attention_smem_bytes.restype is c.c_int
