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
this plain version there. What of it runs in Python is tested here: its
launch plan (every element walked once, within CUDA's limits, its
constants the source's), the binding's argument types against the
source's signature, and
`ref.lru_tiled`, the kernel's decomposition of the recurrence in plain
PyTorch (tiles, warp chunks, carries, the reverse's q_t = a_t g_t walk with
h_{t-1} shifted across every edge), against the reference's oracle, its
Pallas kernel in interpret mode and the vjp of its oracle, on edge shapes
and on decays near 1 that keep a carry across every tile.
"""
import itertools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.kernels.rglru_scan import kernel as tkernel
from repro_torch.kernels.rglru_scan import ops as tops
from repro_torch.kernels.rglru_scan.ref import (lru_ref, lru_reverse_ref,
                                                lru_tiled)
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


# --------------------------------------------------------------------------
# the kernel's decomposition: launch plan and its plain walk
# --------------------------------------------------------------------------

PLAN_S = (1, 8, 63, 4095, 4096, 4097)
PLAN_D = (8, 100, 2560)
PLAN_B = (1, 2)
CUDA_GRID = (2 ** 31 - 1, 65_535, 65_535)


def block_spans(plan, B, S, D, reverse):
    """Yields, for every block of the launch and every warp in it, the
    elements that warp walks: ``(block, warp, b, times, features)`` with
    ``times`` a range of t in walk order (descending in reverse) and
    ``features`` a range of d: csrc/rglru_scan.cu's mapping. Block
    (blockIdx.x, blockIdx.y) is column blockIdx.x of batch row blockIdx.y
    and walks every tile of it."""
    col_n = tkernel.COLUMN
    for b, col in itertools.product(range(plan.grid[1]),
                                    range(plan.grid[0])):
        feats = range(col * col_n, min(D, (col + 1) * col_n))
        for k, w in itertools.product(range(plan.tiles), range(plan.warps)):
            i0 = (k * plan.warps + w) * plan.steps
            i1 = min(S, i0 + plan.steps)
            if i0 >= S:
                continue
            times = (range(S - 1 - i0, S - 1 - i1, -1) if reverse
                     else range(i0, i1))
            yield (col, b), w, b, times, feats


def coverage(plan, B, S, D, reverse):
    """How many times the plan's warps walk each (b, t, d)."""
    seen = np.zeros((B, S, D), np.uint8)
    for _, _, b, times, feats in block_spans(plan, B, S, D, reverse):
        t0, t1 = min(times[0], times[-1]), max(times[0], times[-1]) + 1
        seen[b, t0:t1, feats.start:feats.stop] += 1
    return seen


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B", PLAN_B)
@pytest.mark.parametrize("D", PLAN_D)
@pytest.mark.parametrize("S", PLAN_S)
def test_launch_plan_walks_every_element_once(S, D, B, bf16):
    """Both directions: every (b, t, d) in exactly one warp's chunk of one
    block, within CUDA's grid and block limits and below the shared
    memory that needs an opt-in."""
    for reverse in (False, True):
        plan = tkernel.launch_plan(B, S, D, bf16, reverse)
        assert plan.block == 32 * plan.warps <= 1024
        assert plan.grid == (plan.cols, B, 1)
        assert all(1 <= g <= m for g, m in zip(plan.grid, CUDA_GRID))
        assert plan.smem_bytes <= 48 * 1024     # static, no opt-in
        assert plan.tiles * plan.warps * plan.steps >= S > (
            plan.tiles - 1) * plan.warps * plan.steps
        assert plan.cols * tkernel.COLUMN >= D > (
            plan.cols - 1) * tkernel.COLUMN
        assert len(plan.ints()) == tkernel.N_PLAN
        assert (coverage(plan, B, S, D, reverse) == 1).all()


def test_launch_plan_main_shape():
    """recurrentgemma-2b's layer (B 2, S 4096, D 2560): 160 blocks, one a
    column of 32 features, each walking 32 tiles of 8 warps x 16 steps,
    in float32 and in bfloat16 alike."""
    for bf16 in (False, True):
        plan = tkernel.launch_plan(2, 4096, 2560, bf16, bf16)
        assert (plan.grid, plan.block, plan.tiles, plan.steps) == (
            (80, 2, 1), 256, 32, 16)
        assert plan.smem_bytes == 4096


@pytest.mark.parametrize("args", [(0, 4, 4), (1, 0, 4), (1, 4, 0),
                                  (70_000, 16, 2560),
                                  (65_535, (1 << 30) + 1, 2560)])
def test_launch_plan_refuses_what_no_grid_holds(args):
    with pytest.raises(ValueError):
        tkernel.launch_plan(*args, False, False)


def test_plan_constants_match_the_source():
    """The plan's WARPS, STEPS and SMEM_BYTES are the constants of
    csrc/rglru_scan.cu (which also checks them at each launch)."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC_DIR / "rglru_scan.cu").read_text()
    const = lambda name: re.search(rf"constexpr int {name} = ([^;]+);",
                                   src).group(1)
    assert int(const("WARPS")) == tkernel.WARPS
    assert int(const("STEPS")) == tkernel.STEPS
    assert const("SMEM_BYTES") == "2 * 2 * WARPS * 32 * (int)sizeof(float)"
    assert tkernel.SMEM_BYTES == 2 * 2 * tkernel.WARPS * tkernel.COLUMN * 4


def near_one_inputs(B, S, D, seed):
    """log_a = -1e-4 exp(z / 2), b and dh scaled by sqrt(1 - a^2), as
    chip_smoke.py's near-1 cases (the trained gates' regime: a carry that
    lasts the whole sequence, h of unit size); h0 and dh_last unit."""
    rng = np.random.default_rng(seed)
    log_a = -np.exp(rng.standard_normal((B, S, D)) * 0.5) * 1e-4
    scale = np.sqrt(np.maximum(1.0 - np.exp(2 * log_a), 1e-12))
    b = rng.standard_normal((B, S, D)) * scale
    dh = rng.standard_normal((B, S, D)) * scale
    h0, dh_last = (rng.standard_normal((B, D)) for _ in range(2))
    return [x.astype(np.float32) for x in (log_a, b, h0, dh, dh_last)]


TILED_SHAPES = [(2, 1, 100), (1, 8, 100), (2, 63, 37), (1, 300, 8),
                (1, 4095, 8), (2, 4097, 8)]
TILED_IDS = ["x".join(map(str, s)) for s in TILED_SHAPES]


@pytest.mark.parametrize("decays", ["near_one", "wide"])
@pytest.mark.parametrize("bf16_plan", [False, True], ids=["f32plan",
                                                          "bf16plan"])
@pytest.mark.parametrize("shape", TILED_SHAPES, ids=TILED_IDS)
def test_tiled_walk_forward_matches_the_reference(ref, shape, bf16_plan,
                                                  decays):
    """The kernel's decomposition of the forward (float32 inputs) against
    the reference's oracle and its Pallas kernel in interpret mode, at
    the float32 tolerance, with h0."""
    B, S, D = shape
    if decays == "near_one":
        log_a, b, h0, _, _ = near_one_inputs(B, S, D, seed=S + D)
    else:
        log_a, b, h0 = inputs(B, S, D, True, seed=S + D)
    plan = tkernel.launch_plan(B, S, D, bf16_plan, False)
    h, h_last = lru_tiled(torch.from_numpy(log_a), torch.from_numpy(b),
                          torch.from_numpy(h0), plan=plan)
    jnp = ref.jnp
    args = (jnp.asarray(log_a), jnp.asarray(b), jnp.asarray(h0))
    wants = [ref.jax.jit(ref.lru_ref.lru_ref)(*args)]
    if S <= 300:
        wants.append(ref.lru_kernel.lru_chunked(*args, chunk=16, bd=128,
                                                interpret=True))
    tol = DTYPES["float32"][1]
    for wh, wl in wants:
        np.testing.assert_allclose(as_f32(h), as_f32(wh), **tol)
        np.testing.assert_allclose(as_f32(h_last), as_f32(wl), **tol)


@pytest.fixture(scope="module")
def ref_vjp(ref):
    """(h, dlog_a, db, dh0) of the reference's oracle and its vjp for the
    cotangents (dh, dh_last), jit-compiled once per shape."""
    jax = ref.jax

    def fwd_and_vjp(log_a, b, h0, dh, dh_last):
        (h, _), vjp = jax.vjp(ref.lru_ref.lru_ref, log_a, b, h0)
        return (h,) + vjp((dh, dh_last))
    return jax.jit(fwd_and_vjp)


@pytest.mark.parametrize("decays", ["near_one", "wide"])
@pytest.mark.parametrize("bf16_plan", [False, True], ids=["f32plan",
                                                          "bf16plan"])
@pytest.mark.parametrize("shape", TILED_SHAPES, ids=TILED_IDS)
def test_tiled_walk_reverse_matches_the_plain_reverse(ref_vjp, shape,
                                                      bf16_plan, decays):
    """The kernel's reverse (the q_t = a_t g_t walk, h_{t-1} shifted across
    every tile and chunk edge, h0 at t = 0, dh_last as the first carry)
    against `lru_reverse_ref` in float64 (the same function summed in
    another order, so rtol 1e-10), and in float32 against the vjp of the
    reference's oracle at the gradient tolerance."""
    B, S, D = shape
    if decays == "near_one":
        log_a, b, h0, dh, dh_last = near_one_inputs(B, S, D, seed=S * D)
    else:
        log_a, b, h0 = inputs(B, S, D, True, seed=S * D)
        rng = np.random.default_rng(S)
        dh = rng.standard_normal((B, S, D)).astype(np.float32)
        dh_last = rng.standard_normal((B, D)).astype(np.float32)
    plan = tkernel.launch_plan(B, S, D, bf16_plan, True)
    t64 = [torch.from_numpy(x).double() for x in (log_a, b, h0, dh, dh_last)]
    la, bb, hh0, ddh, ddl = t64
    h, _ = lru_ref(la, bb, hh0)
    got = lru_tiled(la, ddh, ddl, hh0, h, plan=plan, reverse=True)
    want = lru_reverse_ref(la, ddh, h, hh0, ddl)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)

    jh, dla_w, db_w, dh0_w = ref_vjp(log_a, b, h0, dh, dh_last)
    t32 = [torch.from_numpy(x) for x in (log_a, dh, dh_last, h0)]
    db, dla, dh0 = lru_tiled(t32[0], t32[1], t32[2], t32[3],
                             torch.from_numpy(np.array(jh)), plan=plan,
                             reverse=True)
    for g, w in ((db, db_w), (dla, dla_w), (dh0, dh0_w)):
        np.testing.assert_allclose(as_f32(g), as_f32(w), **GRAD_TOL)


def test_binding_matches_the_sources_signature():
    """`ARGTYPES` against the parameters of `rglru_scan_launch` in
    csrc/rglru_scan.cu, one by one."""
    import ctypes
    import re
    from repro_torch.kernels import build
    src = (build.CSRC_DIR / "rglru_scan.cu").read_text()
    params = re.search(r'extern "C" int rglru_scan_launch\(([^)]*)\)',
                       src).group(1)
    kinds = {"int": ctypes.c_int, "const void*": ctypes.c_void_p,
             "void*": ctypes.c_void_p,
             "const int*": ctypes.POINTER(ctypes.c_int)}
    want = [kinds[" ".join(p.split()[:-1])] for p in params.split(",")]
    assert tkernel.ARGTYPES == want
    assert len(tkernel.launch_plan(1, 1, 1, False, False).ints()) == (
        tkernel.N_PLAN)
