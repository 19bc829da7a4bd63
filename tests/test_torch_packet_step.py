"""The port's event-step module against the reference's fused kernel.

The plain PyTorch step (`repro_torch.kernels.packet_step.ref`, reached
through the public wrapper `ops.packet_event_steps` on CPU tensors) is held
against `repro.kernels.packet_step.ops.fused_packet_step` run in interpret
mode on the CPU, from the SAME numpy state (carried across with
`scan_state_from_numpy`), in both dtypes, chaos off and on.

Tolerances
----------
Fault-free: every one of the 23 state columns and 4 log records equal;
floats bitwise, except the three time integrals (`qlen_int`, `busy_ns`,
`useful_ns`), which get 2 ulp because XLA may contract their multiply-add
into an FMA and PyTorch eager does not. Chaos: integer columns and log
keys equal on these seeds (float64); float columns rtol 1e-12 (the two
sides use different `log` implementations and XLA may contract
``s + (work/m)*factor``).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import inspect

import numpy as np
import pytest
import torch

from repro_torch.core import des as tdes
from repro_torch.kernels.packet_step import kernel as tkernel
from repro_torch.kernels.packet_step import ops as tops
from repro_torch.kernels.packet_step.ref import packet_step_ref
from test_torch_reference import load_reference

INTEGRALS = ("qlen_int", "busy_ns", "useful_ns")
CHAOS_KW = dict(mtbf_chip_hours=2.0, ckpt_period=120.0, straggler_prob=0.3,
                straggler_factor=2.0, straggler_deadline=1.5)


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def ulp_diff(a, b):
    """Largest difference in units of the last place of `b`'s dtype."""
    a = np.asarray(a)
    b = np.asarray(b)
    both_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
    d = np.abs(np.where(both_inf, 0.0, a.astype(np.float64) -
                        b.astype(np.float64)))
    spacing = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(b.dtype))
    spacing = np.where(np.isfinite(spacing), spacing, 1.0)
    return float(np.max(d / spacing)) if d.size else 0.0


class Case:
    """One workload + lane batch, packed on both sides."""

    def __init__(self, ref, dtype, with_chaos, n_jobs=160, nodes=48,
                 homogeneous=False, seed=5, n_lanes=8, chaos_seed=11,
                 max_requeues=None):
        self.ref = ref
        self.dtype = np.dtype(dtype)
        jnp = ref.jnp
        self.wl = ref.lublin.generate_workload(ref.lublin.WorkloadParams(
            n_jobs=n_jobs, nodes=nodes, load=0.9, homogeneous=homogeneous,
            seed=seed))
        rng = np.random.default_rng(seed + 100)
        self.k = (10.0 ** rng.uniform(-1.0, 2.5, n_lanes)).astype(dtype)
        s_hi = self.wl.init_time_for_proportion(0.5)
        self.s = rng.uniform(0.05 * s_hi, s_hi, n_lanes).astype(dtype)
        self.T, self.N, self.H = n_lanes, n_jobs, self.wl.params.n_types
        self.m_nodes = nodes
        self.ring = ref.des.resolve_ring(nodes, n_jobs)
        with ref.precision.dtype_scope(dtype):
            self.pw_j = ref.des.pack_workload(self.wl, dtype)
            self.chaos = None
            self.R = 0
            self.u1 = self.u2 = None
            self.chaos_cols = None
            if with_chaos:
                self.chaos = ref.des.ChaosConfig(
                    lane=jnp.arange(n_lanes), seed=chaos_seed,
                    max_requeues=max_requeues, **CHAOS_KW)
                self.R = ref.des.resolve_max_requeues(self.chaos, n_jobs)
                L_cap = n_jobs + self.R
                chaos_b = ref.jax.tree.map(
                    lambda x: jnp.broadcast_to(jnp.asarray(x), (n_lanes,)),
                    self.chaos)
                u = np.asarray(ref.jax.vmap(
                    lambda c: ref.des.chaos_uniforms(c, dtype, L_cap))(
                        chaos_b))
                self.u1 = np.ascontiguousarray(u[:, :, 0].T)
                self.u2 = np.ascontiguousarray(u[:, :, 1].T)
                self.chaos_cols = tuple(
                    np.full((1, n_lanes), CHAOS_KW[f], dtype) for f in (
                        "mtbf_chip_hours", "ckpt_period", "straggler_prob",
                        "straggler_factor", "straggler_deadline"))
        self.pw_fields = {f: np.asarray(getattr(self.pw_j, f)) for f in (
            "submit", "work", "jtype", "rank", "cumw", "nodes", "runtime",
            "tj_submit", "tj_prefw", "t_last_submit")}
        self.pw_fields.update(n_types=self.H, n_jobs=self.N)
        self.pw_t = tdes.packed_from_numpy(self.pw_fields, "cpu")

    def initial_state_np(self):
        st = tdes.initial_scan_state(
            self.H, self.ring, self.T, self.m_nodes,
            torch.float32 if self.dtype == np.float32 else torch.float64,
            torch.device("cpu"))
        return {f: getattr(st, f).numpy().copy() for f in st._fields}

    def ref_steps(self, state_np, n_steps):
        """`n_steps` of the reference kernel (interpret mode, under jit and
        `lax.scan`). Returns (state dict, 4 logs [n_steps, T]) as numpy."""
        ref, jnp = self.ref, self.ref.jnp
        with ref.precision.dtype_scope(self.dtype):
            pw = self.pw_j
            cols = ref.des._ScanState(**{f: jnp.asarray(v)
                                         for f, v in state_np.items()})
            k_col = jnp.asarray(self.k)[None, :]
            s_col = jnp.asarray(self.s)[None, :]
            H, dt = self.H, self.dtype
            p_j = jnp.ones((H,), dt)
            tmax_j = jnp.full((H,), 3600.0, dt)
            t_last = jnp.reshape(pw.t_last_submit, (1, 1))
            u1 = None if self.u1 is None else jnp.asarray(self.u1)
            u2 = None if self.u2 is None else jnp.asarray(self.u2)
            cp = (None if self.chaos_cols is None
                  else tuple(jnp.asarray(c) for c in self.chaos_cols))

            def step(c, _):
                return ref.step_ops.fused_packet_step(
                    pw.tj_prefw, pw.tj_submit, pw.submit, pw.jtype, k_col,
                    s_col, p_j, tmax_j, t_last, c, u1=u1, u2=u2,
                    chaos_params=cp, r_cap=self.R)

            run = ref.jax.jit(lambda c: ref.jax.lax.scan(
                step, c, None, length=n_steps))
            out, ys = run(cols)
            state = {f: np.asarray(getattr(out, f)) for f in out._fields}
            logs = tuple(np.asarray(y)[:, 0, :] for y in ys)
        return state, logs

    def port_steps(self, state_np, n_steps):
        """The same through the port's public wrapper on CPU tensors."""
        pw = self.pw_t
        tdt = pw.submit.dtype
        st = tdes.scan_state_from_numpy(state_np, "cpu")
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=tdt)
        kw = {}
        if self.u1 is not None:
            kw = dict(u1=as_t(self.u1), u2=as_t(self.u2),
                      chaos_params=tdes.ChaosParams(
                          *(as_t(c) for c in self.chaos_cols)))
        st, logs = tops.packet_event_steps(
            pw.tj_prefw, pw.tj_submit, pw.submit, pw.jtype,
            as_t(self.k[None, :]), as_t(self.s[None, :]),
            torch.ones((self.H,), dtype=tdt),
            torch.full((self.H,), 3600.0, dtype=tdt),
            pw.t_last_submit.reshape(1, 1), st, n_steps=n_steps,
            r_cap=self.R, **kw)
        return ({f: getattr(st, f).numpy() for f in st._fields},
                tuple(b.numpy() for b in logs))


def assert_step_parity(got, want, with_chaos, dtype, label):
    (g_state, g_logs), (w_state, w_logs) = got, want
    for name, g, w in zip(("key", "t", "m", "head_w"), g_logs, w_logs):
        if name in ("key", "m"):
            assert np.array_equal(g, w), f"{label}: log {name} differs"
    for f in tdes.ScanState._fields:
        g, w = g_state[f], w_state[f]
        assert g.shape == w.shape and g.dtype == w.dtype, (label, f)
        if f not in tdes.FLOAT_STATE_COLS:
            assert np.array_equal(g, w), f"{label}: int column {f} differs"
    floats = [(f, g_state[f], w_state[f]) for f in tdes.FLOAT_STATE_COLS]
    floats += [("log_t", g_logs[1], w_logs[1]),
               ("log_head_w", g_logs[3], w_logs[3])]
    for f, g, w in floats:
        if with_chaos:
            np.testing.assert_allclose(g, w, rtol=1e-12 if dtype == np.float64
                                       else 1e-5, atol=0,
                                       err_msg=f"{label}: {f}")
        elif f in INTEGRALS:
            assert ulp_diff(g, w) <= 2, (label, f, ulp_diff(g, w))
        else:
            assert np.array_equal(g, w), f"{label}: float column {f} differs"


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("homogeneous", [False, True],
                         ids=["hetero", "homog"])
class TestFaultFree:
    def test_one_step_from_mid_run_states(self, ref, dtype, homogeneous):
        c = Case(ref, dtype, False, homogeneous=homogeneous)
        state = c.initial_state_np()
        for warm in (0, 37, 150, 260):
            if warm:
                state, _ = c.ref_steps(c.initial_state_np(), warm)
            assert_step_parity(c.port_steps(state, 1), c.ref_steps(state, 1),
                               False, c.dtype, f"warm={warm}")

    def test_run_of_steps(self, ref, dtype, homogeneous):
        c = Case(ref, dtype, False, homogeneous=homogeneous, n_jobs=140,
                 nodes=24)
        state = c.initial_state_np()
        n = tdes.event_budget(c.N)
        got, want = c.port_steps(state, n), c.ref_steps(state, n)
        assert_step_parity(got, want, False, c.dtype, "full run")
        # the run really drained and formed groups on both sides
        assert (want[0]["next_sub"] == c.N).all()
        assert (want[0]["n_groups"] > 0).all()
        assert np.isinf(got[0]["grp_end"]).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
class TestChaos:
    def test_one_step_from_mid_run_states(self, ref, dtype):
        c = Case(ref, dtype, True)
        for warm in (0, 45, 180, 400):
            state = c.initial_state_np()
            if warm:
                state, _ = c.ref_steps(state, warm)
            assert_step_parity(c.port_steps(state, 1), c.ref_steps(state, 1),
                               True, c.dtype, f"warm={warm}")

    def test_run_of_steps(self, ref, dtype):
        c = Case(ref, dtype, True, n_jobs=120, nodes=32, n_lanes=6)
        state = c.initial_state_np()
        n = tdes.event_budget(c.N, c.R)
        got, want = c.port_steps(state, n), c.ref_steps(state, n)
        assert_step_parity(got, want, True, c.dtype, "full chaos run")
        assert want[0]["requeues"].max() > 0      # the fault path ran
        assert want[0]["requeued_jobs"].max() > 0

    def test_requeue_cap_hits(self, ref, dtype):
        c = Case(ref, dtype, True, n_jobs=120, nodes=32, n_lanes=6,
                 chaos_seed=3, max_requeues=2)
        state = c.initial_state_np()
        n = tdes.event_budget(c.N, c.R)
        got, want = c.port_steps(state, n), c.ref_steps(state, n)
        assert_step_parity(got, want, True, c.dtype, "requeue cap")
        assert want[0]["requeues"].max() == 2


def test_wrapper_updates_state_in_place_and_ref_does_not(ref):
    c = Case(ref, np.float32, False, n_lanes=6)
    st = tdes.scan_state_from_numpy(c.initial_state_np(), "cpu")
    before = st.next_sub.clone()
    pw = c.pw_t
    args = (pw.tj_prefw, pw.tj_submit, pw.submit, pw.jtype,
            torch.as_tensor(c.k[None, :]), torch.as_tensor(c.s[None, :]),
            torch.ones(c.H), torch.full((c.H,), 3600.0),
            pw.t_last_submit.reshape(1, 1))
    new, y = packet_step_ref(*args, st)
    assert torch.equal(st.next_sub, before) and new.next_sub.sum() > 0
    assert all(rec.shape == (1, c.T) for rec in y)
    out, _ = tops.packet_event_steps(*args, st)
    assert out is st and torch.equal(st.next_sub, new.next_sub)


def test_log_rows_land_at_the_offset(ref):
    c = Case(ref, np.float32, False, n_lanes=6)
    st = tdes.scan_state_from_numpy(c.initial_state_np(), "cpu")
    pw = c.pw_t
    T = c.T
    logs = (torch.full((12, T), -7, dtype=torch.int32), torch.full((12, T), -7.0),
            torch.full((12, T), -7, dtype=torch.int32), torch.full((12, T), -7.0))
    tops.packet_event_steps(
        pw.tj_prefw, pw.tj_submit, pw.submit, pw.jtype,
        torch.as_tensor(c.k[None, :]), torch.as_tensor(c.s[None, :]),
        torch.ones(c.H), torch.full((c.H,), 3600.0),
        pw.t_last_submit.reshape(1, 1), st, logs=logs, log_offset=4,
        n_steps=5)
    assert (logs[0][:4] == -7).all() and (logs[0][9:] == -7).all()
    assert (logs[0][4:9] != -7).all()


class TestWrapperGuards:
    @pytest.fixture()
    def call(self, ref):
        c = Case(ref, np.float32, False, n_lanes=6)
        pw = c.pw_t

        def make(**over):
            st = tdes.scan_state_from_numpy(c.initial_state_np(), "cpu")
            kw = dict(tj_prefw=pw.tj_prefw, tj_submit=pw.tj_submit,
                      submit=pw.submit, jtype=pw.jtype,
                      k=torch.as_tensor(c.k[None, :]),
                      s=torch.as_tensor(c.s[None, :]), p_j=torch.ones(c.H),
                      tmax_j=torch.full((c.H,), 3600.0),
                      t_last=pw.t_last_submit.reshape(1, 1), state=st)
            kw.update(over)
            return kw
        return make

    def test_cuda_step_on_cpu_tensors_raises(self, call):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            tops.packet_event_steps(**call(), step_impl="cuda")

    def test_unknown_step_impl_raises(self, call):
        with pytest.raises(ValueError, match="unknown step_impl"):
            tops.packet_event_steps(**call(), step_impl="pallas")

    def test_wrong_dtype_raises(self, call):
        with pytest.raises(ValueError, match="dtype"):
            tops.packet_event_steps(**call(k=torch.ones((1, 6),
                                                        dtype=torch.float64)))

    def test_wrong_shape_raises(self, call):
        with pytest.raises(ValueError, match="shape"):
            tops.packet_event_steps(**call(p_j=torch.ones(3)))

    def test_non_contiguous_raises(self, call):
        kw = call()
        kw["tj_submit"] = kw["tj_submit"].t().contiguous().t()
        with pytest.raises(ValueError, match="contiguous"):
            tops.packet_event_steps(**kw)

    def test_partial_chaos_operands_raise(self, call):
        with pytest.raises(ValueError, match="come together"):
            tops.packet_event_steps(**call(), u1=torch.ones((4, 6)))

    def test_packed_code_overflow_raises(self, call):
        n = 40000
        kw = call(tj_prefw=torch.zeros((8, n + 1)))
        with pytest.raises(ValueError, match="overflows the int32"):
            tops.packet_event_steps(**kw)

    def test_log_rows_out_of_range_raise(self, call):
        logs = (torch.zeros((4, 6), dtype=torch.int32), torch.zeros((4, 6)),
                torch.zeros((4, 6), dtype=torch.int32), torch.zeros((4, 6)))
        with pytest.raises(ValueError, match="do not fit"):
            tops.packet_event_steps(**call(), logs=logs, log_offset=2,
                                    n_steps=3)


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

@pytest.mark.parametrize("H,ring,is_f64,smem", [
    (8, 100, False, 464),       # homog0.85 float32: 400 + 64 bytes
    (8, 500, True, 4064),       # hetero0.85 float64: 4000 + 64
    (8, 1, False, 68),          # ring 1: 4 + 64
    (8, 16, True, 192),         # ring 16, shorter than a warp: 128 + 64
    (40, 333, True, 2984),      # 40 types, ring 333: 2664 + 320
], ids=["homog-f32-ring100", "hetero-f64-ring500", "ring1", "ring16",
        "H40-ring333"])
def test_launch_plan_keeps_the_ring_in_shared_memory(H, ring, is_f64, smem):
    plan = tkernel.launch_plan(H, ring, is_f64)
    assert plan.ring_in_smem
    assert plan.smem_bytes == tkernel.lane_smem_bytes(ring, H, is_f64) == smem
    assert plan.smem_bytes <= tkernel.SMEM_OPTIN


@pytest.mark.parametrize("ring,is_f64", [(29_040, True), (29_100, True),
                                         (58_080, False), (58_100, False),
                                         (1_000_000, True)])
def test_launch_plan_takes_rings_beyond_the_shared_memory_opt_in(
        ring, is_f64):
    """One lane's columns beyond 232 448 bytes: the device-memory ring,
    never a refusal; just inside, the shared-memory ring."""
    per_lane = tkernel.lane_smem_bytes(ring, 8, is_f64)
    plan = tkernel.launch_plan(8, ring, is_f64)
    assert plan.ring_in_smem == (per_lane <= tkernel.SMEM_OPTIN)
    assert plan.smem_bytes == (per_lane if plan.ring_in_smem else 0)


@pytest.mark.parametrize("is_f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("H", [1, 8, 33])
def test_launch_plan_switches_at_the_opt_in_exactly(H, is_f64):
    """The longest ring whose columns fit the opt-in stays in shared
    memory; one slot more takes the device-memory ring."""
    itemsize = 8 if is_f64 else 4
    ring = (tkernel.SMEM_OPTIN - 8 * H) // itemsize
    inside = tkernel.launch_plan(H, ring, is_f64)
    assert inside.ring_in_smem and inside.smem_bytes <= tkernel.SMEM_OPTIN
    outside = tkernel.launch_plan(H, ring + 1, is_f64)
    assert not outside.ring_in_smem and outside.smem_bytes == 0


@pytest.mark.parametrize("args", [(0, 100, False), (8, 0, False),
                                  (8, -1, True)])
def test_launch_plan_rejects_what_no_launch_has(args):
    with pytest.raises(ValueError):
        tkernel.launch_plan(*args)
