"""The port's RG-LRU recurrence module against the reference's.

The plain PyTorch forward (`repro_torch.kernels.rglru_scan.ref.lru_ref`,
reached through the public wrapper `ops.lru_chunked` on CPU tensors) is
held against the reference's Pallas kernel run in interpret mode on the
CPU (`repro.kernels.rglru_scan.kernel.lru_chunked`, as
`tests/test_kernels.py:64-84` runs it) and against the reference's oracle
`lru_ref`, on the same numpy inputs. The autograd Function's backward (the
plain reverse walk on the CPU) is held against `jax.grad` of the
reference's `lru_ref` and against float64 finite differences
(`torch.autograd.gradcheck`).

Tolerances: float32 rtol 2e-4, atol 2e-5, the reference's own for its
kernel against its oracle (the same recurrence summed in another order:
a chunked closed form against an associative scan); bfloat16 inputs 2e-2
(both sides round one float32 result to bf16, so they differ by at most
one bf16 step). Gradients: rtol 1e-4, atol 1e-5 (float32 sums of the
reverse recurrence in another order).

The CUDA kernel runs only on the card: `chip_smoke.py` holds it against
this plain version there.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.kernels.rglru_scan import kernel as tkernel
from repro_torch.kernels.rglru_scan import ops as tops
from repro_torch.kernels.rglru_scan.ref import lru_ref, lru_reverse_ref
from test_torch_reference import load_reference

LRU_CASES = [
    # B, S, D, chunk, with_h0 (tests/test_kernels.py:64-70)
    (2, 64, 128, 16, False),
    (1, 128, 256, 32, True),
    (2, 50, 100, 16, True),     # non-multiples: padding path
    (1, 8, 512, 128, False),    # chunk > S
]
DTYPES = {"float32": (torch.float32, dict(rtol=2e-4, atol=2e-5)),
          "bfloat16": (torch.bfloat16, dict(rtol=2e-2, atol=2e-2))}
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def inputs(B, S, D, with_h0, seed):
    rng = np.random.default_rng(seed)
    log_a = (-np.exp(rng.standard_normal((B, S, D)) * 0.5) * 0.1
             ).astype(np.float32)
    b = rng.standard_normal((B, S, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32) if with_h0 else None
    return log_a, b, h0


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("case", LRU_CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_forward_matches_reference_kernel_and_oracle(ref, case,
                                                           dtype_name):
    B, S, D, chunk, with_h0 = case
    tdtype, tol = DTYPES[dtype_name]
    log_a, b, h0 = inputs(B, S, D, with_h0, seed=sum(case[:3]))
    jdt = getattr(ref.jnp, dtype_name)
    jb = ref.jnp.asarray(b, jdt)
    jh0 = None if h0 is None else ref.jnp.asarray(h0)
    want_kernel = ref.lru_kernel.lru_chunked(
        ref.jnp.asarray(log_a), jb, jh0, chunk=chunk, bd=128, interpret=True)
    want_oracle = ref.jax.jit(ref.lru_ref.lru_ref)(ref.jnp.asarray(log_a),
                                                  jb, jh0)
    tb = torch.from_numpy(b).to(tdtype)
    th0 = None if h0 is None else torch.from_numpy(h0)
    h, h_last = tops.lru_chunked(torch.from_numpy(log_a), tb, th0)
    assert h.dtype == h_last.dtype == tdtype
    assert tuple(h.shape) == (B, S, D) and tuple(h_last.shape) == (B, D)
    for wh, wl in (want_kernel, want_oracle):
        np.testing.assert_allclose(as_f32(h), as_f32(wh), **tol)
        np.testing.assert_allclose(as_f32(h_last), as_f32(wl), **tol)


def test_decay_bound():
    """Stability (tests/test_kernels.py:88): with |b| <= 1 and a < 1 the
    state stays bounded by |b| / (1 - a)."""
    S, D = 256, 64
    log_a = torch.full((1, S, D), float(np.log(0.9)))
    b = torch.ones((1, S, D)) * 0.5
    h, _ = tops.lru_chunked(log_a, b)
    assert float(h.abs().max()) <= 0.5 / (1 - 0.9) + 1e-3


@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
@pytest.mark.parametrize("shape", [(2, 50, 100), (1, 130, 8)],
                         ids=["2x50x100", "1x130x8"])
def test_function_gradients_match_jax_grad(ref, shape, with_h0):
    """d/d(log_a, b, h0) of <h, w> + <h_last, w_last>, the Function's
    reverse walk against `jax.grad` of the reference's oracle."""
    B, S, D = shape
    log_a, b, h0 = inputs(B, S, D, with_h0, seed=S + D)
    rng = np.random.default_rng(7)
    w = rng.standard_normal((B, S, D)).astype(np.float32)
    w_last = rng.standard_normal((B, D)).astype(np.float32)
    jnp, jax = ref.jnp, ref.jax

    def jloss(la, bb, hh):
        h, hl = ref.lru_ref.lru_ref(la, bb, hh)
        return jnp.sum(h * w) + jnp.sum(hl * w_last)

    jargs = [jnp.asarray(log_a), jnp.asarray(b),
             None if h0 is None else jnp.asarray(h0)]
    argnums = (0, 1, 2) if with_h0 else (0, 1)
    want = jax.jit(jax.grad(jloss, argnums=argnums))(*jargs)

    targs = [torch.from_numpy(x).requires_grad_() for x in (log_a, b)]
    if with_h0:
        targs.append(torch.from_numpy(h0).requires_grad_())
    h, hl = tops.lru_chunked(*targs[:2], targs[2] if with_h0 else None)
    loss = (h * torch.from_numpy(w)).sum() + (hl * torch.from_numpy(w_last)).sum()
    got = torch.autograd.grad(loss, targs)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(as_f32(g), as_f32(wnt), **GRAD_TOL)


@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
def test_gradcheck_float64(with_h0):
    gen = torch.Generator().manual_seed(3)
    # S = 70 > ref.CHUNK: the carry between chunks is differentiated too
    log_a = (-torch.rand((1, 70, 2), generator=gen, dtype=torch.float64)
             * 0.5).requires_grad_()
    b = torch.randn((1, 70, 2), generator=gen,
                    dtype=torch.float64).requires_grad_()
    args = (log_a, b)
    if with_h0:
        args += (torch.randn((1, 2), generator=gen,
                             dtype=torch.float64).requires_grad_(),)
    fn = lambda la, bb, *h0: tops.lru_chunked(la, bb, h0[0] if h0 else None)
    assert torch.autograd.gradcheck(fn, args)


def test_reverse_ref_is_the_forward_run_backwards():
    """The plain reverse against autograd through the plain forward (in
    float64, where autograd can follow `lru_ref`'s own arithmetic)."""
    gen = torch.Generator().manual_seed(4)
    la = (-torch.rand((2, 33, 6), generator=gen, dtype=torch.float64)
          ).requires_grad_()
    b = torch.randn((2, 33, 6), generator=gen,
                    dtype=torch.float64).requires_grad_()
    h0 = torch.randn((2, 6), generator=gen, dtype=torch.float64
                     ).requires_grad_()
    dh = torch.randn((2, 33, 6), generator=gen, dtype=torch.float64)
    dl = torch.randn((2, 6), generator=gen, dtype=torch.float64)
    h, hl = lru_ref(la, b, h0)
    want = torch.autograd.grad((h * dh).sum() + (hl * dl).sum(), (b, la, h0))
    got = lru_reverse_ref(la.detach(), dh, h.detach(), h0.detach(), dl)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


class TestRouting:
    def args(self, dtype=torch.float32):
        log_a, b, h0 = inputs(2, 16, 8, True, seed=1)
        return (torch.from_numpy(log_a), torch.from_numpy(b).to(dtype),
                torch.from_numpy(h0))

    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self):
        fwd, rev = tops.lru_forward.launches, tops.lru_reverse.launches
        la, b, h0 = self.args()
        a = tops.lru_chunked(la, b, h0)
        c = tops.lru_chunked(la, b, h0, impl="torch")
        assert all(torch.equal(x, y) for x, y in zip(a, c))
        assert all(torch.equal(x, y) for x, y in zip(a, lru_ref(la, b, h0)))
        la.requires_grad_()
        tops.lru_chunked(la, b, h0)[0].sum().backward()
        assert (tops.lru_forward.launches, tops.lru_reverse.launches) == (
            fwd, rev) == (0, 0)

    def test_cuda_by_name_on_cpu_tensors_raises(self):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            tops.lru_chunked(*self.args(), impl="cuda")

    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError, match="unknown impl"):
            tops.lru_chunked(*self.args(), impl="pallas")

    def test_no_autograd_without_a_gradient(self):
        h, _ = tops.lru_chunked(*self.args())
        assert h.grad_fn is None
        la, b, h0 = self.args()
        h, _ = tops.lru_chunked(la, b.requires_grad_(), h0)
        assert type(h.grad_fn).__name__ == "LRUFunctionBackward"
        with torch.no_grad():
            assert tops.lru_chunked(la, b, h0)[0].grad_fn is None

    def test_chunked_lru_clamps_the_decay_before_the_log(self):
        """a = 0 gives log a = log(1e-37), finite, and forgets the state,
        as the reference's `jnp.maximum(a, 1e-37)` does."""
        la, b, h0 = self.args()
        a = torch.exp(la)
        a[:, 5] = 0.0
        h = tops.chunked_lru(a, b, h0)
        assert bool(torch.isfinite(h).all())
        want, _ = lru_ref(torch.log(torch.clamp_min(a, 1e-37)), b, h0)
        torch.testing.assert_close(h, want)
        torch.testing.assert_close(h[:, 5], b[:, 5])


class TestChecks:
    def test_float16_is_refused(self):
        x = torch.zeros((1, 4, 4), dtype=torch.float16)
        with pytest.raises(ValueError, match="must be one of"):
            tops.lru_chunked(x, x)

    def test_shapes_must_agree(self):
        with pytest.raises(ValueError, match="same non-empty shape"):
            tops.lru_chunked(torch.zeros((1, 4, 4)), torch.zeros((1, 5, 4)))
        with pytest.raises(ValueError, match="h0 must be"):
            tops.lru_chunked(torch.zeros((1, 4, 4)), torch.zeros((1, 4, 4)),
                             torch.zeros((4,)))

    def test_rank_is_checked(self):
        with pytest.raises(ValueError, match=r"\[B, S, D\]"):
            tops.lru_chunked(torch.zeros((4, 4)), torch.zeros((4, 4)))

    def test_tensors_only(self):
        with pytest.raises(TypeError, match="must be a tensor"):
            tops.lru_chunked(np.zeros((1, 2, 2)), torch.zeros((1, 2, 2)))


class TestBinding:
    def test_flags_are_the_stated_ones(self):
        flags = " ".join(tkernel.FLAGS)
        assert "arch=compute_90a,code=sm_90a" in flags and "-O3" in flags
        assert "-fmad=false" not in flags and "use_fast_math" not in flags

    def test_kernel_dtypes(self):
        assert tops.KERNEL_DTYPES == (torch.float32, torch.bfloat16)
