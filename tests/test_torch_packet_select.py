"""The port's group-formation decision against the reference's.

`repro_torch.kernels.packet_select.ref.packet_select_ref` (what the CUDA
kernel computes, and what the wrapper runs on CPU tensors) against the
reference's Pallas kernel in interpret mode (`packet_select(...,
interpret=True)`, float32 only) and against its policy oracle
(`repro.kernels.packet_select.ref.packet_select_ref`, both dtypes), on
inputs made with numpy from a seed. Carried over from
tests/test_kernels.py (H in {8, 64, 128, 130}, the paper's Fig. 3
example), with rows the random draw never makes: an all-empty row, tied
weights, no free nodes, s = 0 and a tiny k (a node threshold above 2**31).

Bounds: `j` and `m` exact, `dur` rtol 1e-5, `work` rtol 1e-6 in float32;
1e-12 for both in float64. Where the TPU kernel and the policy differ
(the duration's s clamp, `kernel.py:28, 44`), the port follows the policy:
pinned at s = 0 in float64 below.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.kernels.packet_select import ops as tops
from repro_torch.kernels.packet_select.ref import packet_select_ref
from test_torch_reference import load_reference

RTOL = {np.float32: (1e-5, 1e-6), np.float64: (1e-12, 1e-12)}  # dur, work
N_RANDOM = 16
SPECIAL_ROWS = ("empty", "tie", "no_free_nodes", "s_zero", "tiny_k",
                "s_zero_tiny_k")


@pytest.fixture(scope="module")
def rsel():
    """The reference's kernel entry and policy oracle (imported after the
    R1/R2 patches, never at collection)."""
    load_reference()
    from repro.kernels.packet_select import kernel, ref
    return kernel.packet_select, ref.packet_select_ref


def queues(seed: int, H: int):
    """Random decision inputs as numpy float64 (rows of tests/test_kernels
    `_rand_queues`, priorities and t_max varied), then the special rows."""
    rng = np.random.default_rng(seed)
    T = N_RANDOM + len(SPECIAL_ROWS)
    sum_w = np.abs(rng.standard_normal((T, H))) * 1e4
    s_j = np.abs(rng.standard_normal((T, H))) * 10 + 1
    p_j = rng.uniform(0.5, 2.0, (T, H))
    oldest = np.abs(rng.standard_normal((T, H))) * 100
    t_max = rng.uniform(600.0, 3600.0, (T, H))
    nonempty = rng.random((T, H)) > 0.3
    nonempty[:, 0] = True
    now = np.abs(rng.standard_normal(T)) * 1000 + 200
    k = np.abs(rng.standard_normal(T)) * 5 + 0.1
    m_free = np.round(np.abs(rng.standard_normal(T)) * 100 + 1)
    r = {name: N_RANDOM + i for i, name in enumerate(SPECIAL_ROWS)}
    nonempty[r["empty"]] = False
    if H > 1:       # the first and last type weigh exactly the same, most
        row = r["tie"]
        for a in (sum_w, s_j, p_j, oldest, t_max):
            a[row, -1] = a[row, 0]
        sum_w[row, [0, -1]] = 1e6
        nonempty[row, [0, -1]] = True
    m_free[r["no_free_nodes"]] = 0
    s_j[[r["s_zero"], r["s_zero_tiny_k"]]] = 0.0
    k[[r["tiny_k"], r["s_zero_tiny_k"]]] = 1e-9
    sum_w[[r["tiny_k"], r["s_zero_tiny_k"]]] *= 1e3
    return sum_w, s_j, p_j, oldest, t_max, nonempty, now, k, m_free


def port_args(args, dtype):
    sum_w, s_j, p_j, oldest, t_max, nonempty, now, k, m_free = args
    f = lambda a: torch.tensor(np.asarray(a, dtype))
    return (f(sum_w), f(s_j), f(p_j), f(oldest), f(t_max),
            torch.tensor(nonempty), f(now), f(k),
            torch.tensor(m_free.astype(np.int32)))


def ref_args(ref, args, dtype):
    jnp = ref.jnp
    sum_w, s_j, p_j, oldest, t_max, nonempty, now, k, m_free = args
    f = lambda a: jnp.asarray(np.asarray(a, dtype))
    return (f(sum_w), f(s_j), f(p_j), f(oldest), f(t_max),
            f(nonempty.astype(dtype)), f(now), f(k), f(m_free))


def assert_decisions_equal(got, want, dtype):
    j, m, dur, work = (np.asarray(x) for x in got)
    wj, wm, wdur, wwork = (np.asarray(x) for x in want)
    rtol_dur, rtol_work = RTOL[dtype]
    np.testing.assert_array_equal(j, wj)
    np.testing.assert_array_equal(m, wm)
    np.testing.assert_allclose(dur, wdur, rtol=rtol_dur)
    np.testing.assert_allclose(work, wwork, rtol=rtol_work)


@pytest.mark.parametrize("H", [8, 64, 128, 130])
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_the_tpu_kernel_in_interpret_mode(rsel, H, seed):
    ref = load_reference()
    kernel, _ = rsel
    args = queues(seed, H)
    got = packet_select_ref(*port_args(args, np.float32))
    want = kernel(*ref_args(ref, args, np.float32), interpret=True)
    assert_decisions_equal(got, want, np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("H", [1, 8, 64, 130])
def test_matches_the_policy_oracle(rsel, H, dtype):
    ref = load_reference()
    _, oracle = rsel
    args = queues(10 + H, H)
    got = packet_select_ref(*port_args(args, dtype))
    with ref.precision.dtype_scope(dtype):
        want = oracle(*ref_args(ref, args, dtype))
        want = tuple(np.asarray(x) for x in want)
    assert got[1].dtype == getattr(torch, np.dtype(dtype).name)
    assert_decisions_equal(got, want, dtype)


def test_special_rows_decide_as_the_policy_says():
    sum_w, s_j, p_j, oldest, t_max, nonempty, now, k, m_free = \
        queues(3, 8)
    j, m, dur, work = packet_select_ref(*port_args(
        (sum_w, s_j, p_j, oldest, t_max, nonempty, now, k, m_free),
        np.float64))
    r = {name: N_RANDOM + i for i, name in enumerate(SPECIAL_ROWS)}
    assert int(j[r["empty"]]) == 0                 # all -inf: first index
    assert int(j[r["tie"]]) == 0                   # first of the tied pair
    assert float(m[r["no_free_nodes"]]) == 0.0
    assert float(dur[r["no_free_nodes"]]) == pytest.approx(
        s_j[r["no_free_nodes"], int(j[r["no_free_nodes"]])] +
        float(work[r["no_free_nodes"]]))
    for name in ("tiny_k", "s_zero_tiny_k"):        # saturates, then m_free
        assert float(m[r[name]]) == m_free[r[name]]
    # s = 0: the duration is work / m exactly, no 1e-9 added
    row = r["s_zero"]
    assert float(dur[row]) == float(work[row]) / float(m[row])


def test_duration_adds_the_unclamped_init_time():
    """float64, s = 0 and a tiny work: the TPU kernel's clamped s would add
    1e-9 to a duration of 1e-6; the policy (and the port) adds 0."""
    one = lambda v, dt=torch.float64: torch.tensor([v], dtype=dt)
    rows = lambda v: torch.full((1, 1), v, dtype=torch.float64)
    j, m, dur, work = tops.fused_packet_select(
        rows(4e-6), rows(0.0), rows(1.0), rows(0.0), rows(3600.0),
        torch.ones((1, 1), dtype=torch.bool), one(0.0), one(1.0),
        one(4, torch.int32))
    assert float(m[0]) == 4.0
    assert float(dur[0]) == 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,nodes,dur", [(0.5, 8, 1.5), (1.0, 4, 2.0),
                                         (2.0, 2, 3.0), (4.0, 1, 5.0)])
def test_paper_worked_example(rsel, dtype, k, nodes, dur):
    """Paper Fig. 3: s = 1 min, work 4 node-min: k = 0.5 -> 8 nodes and
    1.5 min (init 1 + exec 4 / 8), ..., k = 4 -> 1 node and 5 min."""
    rows = lambda v: torch.full((1, 1), v, dtype=dtype)
    lane = lambda v: torch.tensor([v], dtype=dtype)
    got = tops.fused_packet_select(
        rows(4.0), rows(1.0), rows(1.0), rows(0.0), rows(3600.0),
        torch.ones((1, 1), dtype=torch.bool), lane(0.0), lane(k),
        torch.tensor([100], dtype=torch.int32))
    assert int(got[0][0]) == 0 and int(got[1][0]) == nodes
    assert float(got[2][0]) == dur and float(got[3][0]) == 4.0
    if dtype == torch.float32:
        ref = load_reference()
        kernel, _ = rsel
        one = lambda v: ref.jnp.full((1, 1), v, ref.jnp.float32)
        want = kernel(one(4.0), one(1.0), one(1.0), one(0.0), one(3600.0),
                      one(1.0), ref.jnp.asarray([0.0], ref.jnp.float32),
                      ref.jnp.asarray([k], ref.jnp.float32),
                      ref.jnp.asarray([100.0], ref.jnp.float32),
                      interpret=True)
        assert_decisions_equal(got, want, np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_wrapper_on_cpu_is_the_plain_version(dtype):
    args = port_args(queues(5, 8), dtype)
    before = tops.fused_packet_select.launches
    got = tops.fused_packet_select(*args)
    want = packet_select_ref(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tops.fused_packet_select.launches == before   # no kernel ran
    assert got[0].dtype == torch.int32
