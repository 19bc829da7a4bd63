"""The while-loop engine's wrapper, `packet_while`, on the CPU.

Its plain version (the lanes in lockstep, `kernels/packet_while/ref.py`)
is what `simulate_packet` runs on CPU tensors: called directly on a fresh
`DesState`, then through the engine's post-pass, it gives
`simulate_packet`'s result field by field, and that result is bitwise the
scan engine's (`simulate_packet_scan_lanes`, which shares no loop code
with it) and, within the reference's bounds, the reference's
`simulate_packet`, on reduced Lublin workloads in float32 and float64
with chaos off and on. Then the routing (`impl`), the operand checks that
come before any build, the kernel's launch plan (pure Python) and the
`stats` keys of each implementation. The kernel itself runs only on the
card: `chip_smoke.py` holds it against this plain version there.
"""
import inspect
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.core import des as tdes
from repro_torch.kernels import build as tbuild
from repro_torch.kernels.packet_while import kernel as tkernel
from repro_torch.kernels.packet_while import ops as tops
from repro_torch.workload import lublin as tlublin
from test_torch_reference import load_reference

DTYPES = [np.float32, np.float64]
IDS = ["float32", "float64"]
TOL = {np.dtype(np.float32): 1e-6, np.dtype(np.float64): 1e-12}
EXACT = ("n_groups", "ok", "budget_exhausted", "failures",
         "straggler_kills", "requeues", "requeued_jobs")
FLOWS = {
    "homog": dict(n_jobs=200, nodes=32, load=0.9, homogeneous=True, seed=5),
    "hetero": dict(n_jobs=200, nodes=64, load=0.85, homogeneous=False,
                   seed=3),
}
LANES = [(0.5, 0.05), (2.0, 0.3), (20.0, 0.05), (300.0, 0.5)]
CHAOS = dict(mtbf_chip_hours=0.05, ckpt_period=120.0, straggler_prob=0.3)


def setup(flow, dtype, with_chaos, seed=0):
    """The operands `simulate_packet` hands the wrapper, built here from
    the workload on the CPU: (workload, packed, k, s, chaos kwargs of
    simulate_packet)."""
    wl = tlublin.generate_workload(tlublin.WorkloadParams(**FLOWS[flow]))
    pw = tdes.pack_workload(wl, dtype, device="cpu")
    k = np.asarray([kk for kk, _ in LANES], dtype)
    s = np.asarray([wl.init_time_for_proportion(p) for _, p in LANES],
                   dtype)
    kw = {}
    if with_chaos:
        chaos = tdes.ChaosConfig(**CHAOS)
        L = wl.n_jobs + tdes.resolve_max_requeues(chaos, wl.n_jobs)
        u = np.random.default_rng(seed).random((2, L, len(LANES)))
        kw = dict(chaos=chaos, u1=u[0].astype(dtype), u2=u[1].astype(dtype))
    return wl, pw, k, s, kw


def wrapper_operands(pw, k, s, m, kw):
    """Positional operands and keywords of `packet_while` for the lanes
    (k, s), a fresh DesState among them, as `simulate_packet` makes them."""
    dtype = pw.submit.dtype
    H, N, T = pw.n_types, pw.n_jobs, len(k)
    R = tdes.resolve_max_requeues(kw.get("chaos"), N)
    st = tdes.initial_des_state(H, tdes.resolve_ring(m, N), N + R, T, m,
                                dtype, "cpu")
    chaos_kw = {}
    if kw:
        cols = tdes.chaos_param_columns(kw["chaos"], T, dtype, "cpu")
        chaos_kw = dict(u1=torch.tensor(kw["u1"]), u2=torch.tensor(kw["u2"]),
                        chaos_params=tdes.ChaosParams(*(c[0] for c in cols)),
                        r_cap=R)
    args = (pw.tj_prefw, pw.tj_submit, pw.submit, pw.jtype,
            torch.tensor(k), torch.tensor(s),
            torch.ones((H,), dtype=dtype),
            torch.full((H,), 3600.0, dtype=dtype), pw.t_last_submit, st, m,
            4 * N + 64 + 2 * R)
    return args, chaos_kw


def assert_equal(got, want, label):
    for f in tdes.DesResult._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), (label, f)


@pytest.mark.parametrize("with_chaos", [False, True], ids=["plain", "chaos"])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("flow", list(FLOWS))
def test_plain_wrapper_is_the_engine(flow, dtype, with_chaos):
    """The wrapper on a fresh state, then the post-pass, gives
    `simulate_packet`'s result field by field, and the scan engine's."""
    wl, pw, k, s, kw = setup(flow, dtype, with_chaos)
    m = int(wl.params.nodes)
    args, chaos_kw = wrapper_operands(pw, k, s, m, kw)
    before = tops.packet_while.launches
    st, counts = tops.packet_while(*args, **chaos_kw)
    assert st is args[9]                        # updated in place
    assert tops.packet_while.launches == before
    assert set(counts) == {"outer", "inner", "syncs"}
    got = tdes.des_result(pw, st, torch.tensor(s), with_chaos)
    assert got.ok.all()
    if with_chaos:
        assert int(got.requeues.sum()) > 0 and int(got.failures.sum()) > 0
    want = tdes.simulate_packet(pw, k, s, m, device="cpu", **kw)
    assert_equal(got, want, "simulate_packet")
    scan = tdes.simulate_packet_scan_lanes(
        pw, k, s, m, device="cpu", chaos=kw.get("chaos"),
        u1=kw.get("u1"), u2=kw.get("u2"))
    assert_equal(got, scan, "scan engine")


@pytest.mark.parametrize("with_chaos", [False, True], ids=["plain", "chaos"])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_plain_wrapper_matches_the_reference_engine(dtype, with_chaos):
    """Lane by lane against the reference's `simulate_packet` (the scalar
    call, jit-compiled once). Under chaos lane i draws the reference's own
    stream (`chaos_uniforms` with ``lane=i``), which the port takes as the
    columns of `u1` / `u2`; there `start_t` is held at the float bound, as
    tests/test_torch_des_seq.py says why."""
    ref = load_reference()
    wl, pw, k, s, _ = setup("homog", dtype, False)
    m, N = int(wl.params.nodes), wl.n_jobs
    rwl = ref.lublin.generate_workload(
        ref.lublin.WorkloadParams(**FLOWS["homog"]))
    kw, rch = {}, [None] * len(LANES)
    with ref.precision.dtype_scope(dtype):
        if with_chaos:
            rch = [ref.des.ChaosConfig(**CHAOS, seed=11, lane=i)
                   for i in range(len(LANES))]
            u = np.stack([np.asarray(ref.des.chaos_uniforms(c, dtype, 2 * N))
                          for c in rch], axis=1)          # [2N, T, 2]
            kw = dict(chaos=tdes.ChaosConfig(**CHAOS), u1=u[..., 0],
                      u2=u[..., 1])
        args, chaos_kw = wrapper_operands(pw, k, s, m, kw)
        st, _ = tops.packet_while(*args, **chaos_kw)
        got = tdes.des_result(pw, st, torch.tensor(s), with_chaos)
        rpw = ref.des.pack_workload(rwl, dtype)
        tol = TOL[np.dtype(dtype)]
        exact = EXACT + (() if with_chaos else ("start_t",))
        for i in range(len(LANES)):
            want = ref.jax.jit(lambda kk, ss: ref.des.simulate_packet(
                rpw, kk, ss, m, chaos=rch[i]))(ref.jnp.asarray(k[i]),
                                               ref.jnp.asarray(s[i]))
            for f in tdes.DesResult._fields:
                g = getattr(got, f)[i].numpy()
                w = np.asarray(getattr(want, f))
                if f in exact:
                    assert np.array_equal(g, w), (i, f)
                else:
                    np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                               err_msg=f"lane {i}: {f}")
    assert got.ok.all()
    if with_chaos:
        assert int(got.requeues.sum()) > 0


def test_iteration_cap_is_the_engine_budget():
    """A `max_iters` below what the lanes need: the capped lanes stop with
    their `iters` at the cap, as `simulate_packet` reports them."""
    wl, pw, k, s, _ = setup("hetero", np.float32, False)
    m = int(wl.params.nodes)
    args, _ = wrapper_operands(pw, k, s, m, {})
    full, _ = tops.packet_while(*args)
    cap = int(full.iters.double().median())
    args, _ = wrapper_operands(pw, k, s, m, {})
    st, _ = tops.packet_while(*args[:11], cap)
    got = tdes.des_result(pw, st, torch.tensor(s), False)
    assert bool((st.iters <= cap).all())
    assert torch.equal(got.budget_exhausted, full.iters > cap)
    assert 0 < int(got.budget_exhausted.sum()) < len(LANES)
    want = tdes.simulate_packet(pw, k, s, m, max_iters=cap, device="cpu")
    assert_equal(got, want, "capped")


# --------------------------------------------------------------------------
# routing and operand checks
# --------------------------------------------------------------------------

@pytest.fixture()
def no_build(monkeypatch):
    """Any build attempt fails the test."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel build was attempted")
    monkeypatch.setattr(tbuild, "build_library", refuse)
    monkeypatch.setattr(tkernel, "load", refuse)


def small():
    wl = tlublin.generate_workload(tlublin.WorkloadParams(
        n_jobs=40, nodes=8, load=0.9, homogeneous=True, seed=2))
    pw = tdes.pack_workload(wl, np.float32, device="cpu")
    return wl, pw


def test_cpu_default_is_the_plain_version(no_build):
    wl, pw = small()
    args, _ = wrapper_operands(pw, np.float32([1.0, 5.0]),
                               np.float32([30.0, 30.0]), 8, {})
    before = tops.packet_while.launches
    st, counts = tops.packet_while(*args)
    assert set(counts) == {"outer", "inner", "syncs"}
    assert tops.packet_while.launches == before
    st2, _ = tops.packet_while(*wrapper_operands(
        pw, np.float32([1.0, 5.0]), np.float32([30.0, 30.0]), 8, {})[0],
        impl="torch")
    for name, a, b in zip(tdes.DesState._fields, st, st2):
        assert torch.equal(a, b), name


def test_cuda_on_cpu_tensors_and_unknown_impls_raise(no_build):
    wl, pw = small()
    args, _ = wrapper_operands(pw, np.float32([1.0]), np.float32([30.0]), 8,
                               {})
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.packet_while(*args, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        tops.packet_while(*args, impl="xla")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tdes.simulate_packet(pw, 1.0, 30.0, 8, device="cpu", impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        tdes.simulate_packet(pw, 1.0, 30.0, 8, device="cpu", impl="triton")


@pytest.mark.parametrize("where,value,match", [
    (4, torch.ones((3,)), "k has shape"),
    (3, torch.zeros((40,)), "jtype has dtype"),
    (6, torch.ones((8,), dtype=torch.float64), "p_j has dtype"),
    (8, torch.ones((1,)), "t_end has shape"),
    (0, torch.ones((41, 9)).t(), "tj_prefw must be contiguous"),
    ("grp_end", torch.full((2, 8), float("inf"))[:, ::2],
     "state.grp_end must be contiguous"),
    ("grp_m", torch.zeros((2, 4), dtype=torch.int32), "state.grp_m has shape"),
    ("head", torch.zeros((8, 2), dtype=torch.int32).t(),
     "state.head must be contiguous"),
    ("log_m", torch.zeros((2, 40)), "state.log_m has dtype"),
    ("iters", torch.zeros((3,), dtype=torch.int32), "state.iters has shape"),
])
def test_operand_errors_come_before_any_build(no_build, where, value, match):
    wl, pw = small()
    args, _ = wrapper_operands(pw, np.float32([1.0, 5.0]),
                               np.float32([30.0, 30.0]), 8, {})
    args = list(args)
    if isinstance(where, int):
        args[where] = value
    else:
        args[9] = args[9]._replace(**{where: value})
    with pytest.raises(ValueError, match=match):
        tops.packet_while(*args)


def test_chaos_operands_come_together(no_build):
    wl, pw = small()
    args, _ = wrapper_operands(pw, np.float32([1.0]), np.float32([30.0]), 8,
                               {})
    with pytest.raises(ValueError, match="together"):
        tops.packet_while(*args, u1=torch.ones((40, 1)))
    with pytest.raises(TypeError, match="DesState"):
        tops.packet_while(*args[:9], tuple(args[9]), *args[10:])


def test_no_except_around_the_launch():
    """On a CUDA tensor the wrapper launches the kernel or raises: the
    source has no `try`/`except` that could give way to the plain
    version, and the launch counter moves only next to the launch."""
    src = inspect.getsource(tops)
    code = "\n".join(line.split("#")[0] for line in src.splitlines())
    assert "except" not in code and "try:" not in code
    assert code.count("launches += 1") == 1


# --------------------------------------------------------------------------
# the kernel's launch plan (pure Python: no card needed)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("H,ring,is_f64,chaos,smem", [
    (8, 100, False, False, 864),     # homog0.85 float32: 100 x 8 + 8 x 8
    (8, 500, True, False, 6064),     # hetero0.85 float64: 500 x 12 + 64
    (8, 100, False, True, 2560),     # chaos: 100 x (3 x 4 + 12) + 8 x 20
    (8, 500, True, True, 18224),     # chaos: 500 x (3 x 8 + 12) + 8 x 28
    (1, 1, False, False, 16),
    (40, 333, True, True, 13108),    # 333 x 36 + 40 x 28
], ids=["homog-f32", "hetero-f64", "homog-f32-chaos", "hetero-f64-chaos",
        "ring1", "H40-ring333-chaos"])
def test_launch_plan_keeps_the_lane_in_shared_memory(H, ring, is_f64, chaos,
                                                     smem):
    plan = tkernel.launch_plan(H, ring, is_f64, chaos)
    assert plan.ring_in_smem
    assert plan.smem_bytes == tkernel.lane_smem_bytes(ring, H, is_f64,
                                                      chaos) == smem


@pytest.mark.parametrize("chaos", [False, True], ids=["plain", "chaos"])
@pytest.mark.parametrize("is_f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("H", [1, 8, 33])
def test_launch_plan_switches_at_the_opt_in_exactly(H, is_f64, chaos):
    """The longest ring whose lane fits the opt-in stays in shared memory;
    one slot more takes the device-memory instantiation, and no ring,
    however long, is refused."""
    per_slot = tkernel.lane_smem_bytes(2, H, is_f64, chaos) - \
        tkernel.lane_smem_bytes(1, H, is_f64, chaos)
    fixed = tkernel.lane_smem_bytes(1, H, is_f64, chaos) - per_slot
    ring = (tkernel.SMEM_OPTIN - fixed) // per_slot
    inside = tkernel.launch_plan(H, ring, is_f64, chaos)
    assert inside.ring_in_smem and inside.smem_bytes <= tkernel.SMEM_OPTIN
    outside = tkernel.launch_plan(H, ring + 1, is_f64, chaos)
    assert not outside.ring_in_smem and outside.smem_bytes == 0
    huge = tkernel.launch_plan(H, 10_000_000, is_f64, chaos)
    assert huge == (0, False)


@pytest.mark.parametrize("args", [(0, 100, False, False),
                                  (8, 0, True, True), (8, -1, False, True)])
def test_launch_plan_rejects_what_no_launch_has(args):
    with pytest.raises(ValueError):
        tkernel.launch_plan(*args)


# --------------------------------------------------------------------------
# the stats of each implementation
# --------------------------------------------------------------------------

def test_plain_stats_keys():
    wl, pw = small()
    stats = {}
    tdes.simulate_packet(pw, [1.0, 9.0], 30.0, 8, device="cpu", stats=stats)
    assert set(stats) == {"outer", "inner", "syncs"}
    assert stats["syncs"] == stats["outer"] + stats["inner"] + 1


def test_kernel_stats_keys(monkeypatch):
    """The kernel's branch of `simulate_packet`, with the launch stood in
    for by the plain version on the CPU: `launches`, the largest outer
    iterations and formations of a lane, and one host sync (the read of
    those maxima). The lockstep outer loop runs as long as the longest
    lane, so `outer_max` is the plain version's `outer`."""
    real = tops.packet_while

    def as_kernel(*args, impl=None, **kw):
        state, _ = real(*args, impl="torch", **kw)
        return state, {"launches": 1, "syncs": 0}

    wl, pw = small()
    plain = {}
    want = tdes.simulate_packet(pw, [1.0, 9.0], 30.0, 8, device="cpu",
                                stats=plain)
    monkeypatch.setattr(tdes, "resolve_impl", lambda impl, dev: "cuda")
    monkeypatch.setattr(tops, "packet_while", as_kernel)
    stats = {}
    got = tdes.simulate_packet(pw, [1.0, 9.0], 30.0, 8, device="cpu",
                               stats=stats)
    assert set(stats) == {"launches", "outer_max", "inner_max", "syncs"}
    assert stats["launches"] == 1 and stats["syncs"] == 1
    assert stats["outer_max"] == plain["outer"]
    assert stats["inner_max"] == int(want.n_groups.max())
    assert_equal(got, want, "stand-in")
