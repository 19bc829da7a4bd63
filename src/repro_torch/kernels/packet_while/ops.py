"""Public wrapper of the while-loop DES engine kernel.

`packet_while` runs every lane of a lane-major `DesState` to its end: the
reference's while loop (one event an outer iteration, then groups formed
until the lane is blocked), the group-formation decision inside it. The
28 state columns, the ``[T, L]`` group log among them, are UPDATED IN
PLACE.

On CUDA tensors it launches the hand-written kernel
(`repro_torch/csrc/packet_while.cu`): ONE launch for the whole run, each
lane a warp that runs its own loop, no host in the loop; or it raises,
and nothing falls back to the plain version. On CPU tensors it runs the
plain PyTorch version (`ref.py`, the lanes in lockstep, a decision call
per formation). ``impl="torch"`` asks for the plain version by name on
either device; ``impl="cuda"`` on CPU tensors raises.

`packet_while.launches` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import torch

from repro_torch.core.des import FLOAT_DES_COLS, ChaosParams, DesState
from repro_torch.kernels.packet_while import kernel as _kernel
from repro_torch.kernels.packet_while.ref import packet_while_ref
from repro_torch.kernels.routing import check_operand, resolve_impl

DTYPES = (torch.float32, torch.float64)
PER_TYPE_COLS = ("head", "tail", "pool_w", "pool_oldest", "pool_code")
RING_COLS = ("grp_end", "grp_m", "grp_jtype", "grp_rem_w", "grp_rem_cnt",
             "grp_rem_oldest")
LOG_COLS = ("log_key", "log_t", "log_m", "log_headw")


def packet_while(tj_prefw, tj_submit, submit, jtype, k, s, p_j, tmax_j,
                 t_end, state: DesState, m_nodes: int, max_iters: int,
                 u1=None, u2=None, chaos_params=None, *, r_cap: int = 0,
                 impl: str | None = None) -> tuple[DesState, dict]:
    """Run every lane of `state` until its loop ends.

    Operands: ``tj_prefw [H, N+1]``, ``tj_submit [H, N]``, ``submit
    [N]``, ``jtype [N]`` int32, ``k``/``s`` ``[T]``, ``p_j``/``tmax_j``
    ``[H]``, `t_end` a 0-d tensor (the metric window's end), `state` a
    `DesState` of ``[T]`` scalars, ``[T, H]`` per-type rows, ``[T, ring]``
    ring rows and ``[T, L]`` log rows; `m_nodes` the cluster's nodes and
    `max_iters` the cap on each lane's outer iterations. Under chaos
    ``u1``/``u2`` ``[L, T]`` and `chaos_params`, the five ``[T]`` fault
    columns (all three or none), with `r_cap` requeues injected at most.

    Returns ``(state, counts)``, `state` the same tensors. `counts` of the
    plain version: ``outer`` and ``inner``, its lockstep iterations, and
    ``syncs``, its host reads; of the kernel: ``launches`` (1) and
    ``syncs`` (0).
    """
    if not isinstance(state, DesState):
        raise TypeError("state must be a DesState")
    device, dtype = state.t.device, state.t.dtype
    impl = resolve_impl(impl, device)
    if dtype not in DTYPES:
        raise ValueError(f"state must be float32 or float64, got {dtype}")
    if tj_prefw.dim() != 2 or state.t.dim() != 1 or state.grp_end.dim() != 2 \
            or state.log_key.dim() != 2:
        raise ValueError("tj_prefw must be [H, N+1], state.t [T], "
                         "state.grp_end [T, ring], state.log_key [T, L]")
    H, N = int(tj_prefw.shape[0]), int(tj_prefw.shape[1]) - 1
    T = int(state.t.shape[0])
    ring, L = int(state.grp_end.shape[1]), int(state.log_key.shape[1])
    m_nodes, max_iters, r_cap = int(m_nodes), int(max_iters), int(r_cap)
    if min(N, H, T, ring, L) < 1:
        raise ValueError("N, H, T, ring and L must all be >= 1")
    if 2 * N * (N + 1) >= 2 ** 31:
        raise ValueError(
            f"n_jobs={N} overflows the int32 packed codes j*(N+1)+tail and "
            f"(lo*2+frag)*(N+1)+cnt, which need 2*N*(N+1) < 2**31")
    has_chaos = u1 is not None
    if (u2 is not None) != has_chaos or (chaos_params is not None) != has_chaos:
        raise ValueError("u1, u2 and chaos_params come together or not at all")

    i32 = torch.int32
    for name, x, shape, dt in (
            ("tj_prefw", tj_prefw, (H, N + 1), dtype),
            ("tj_submit", tj_submit, (H, N), dtype),
            ("submit", submit, (N,), dtype), ("jtype", jtype, (N,), i32),
            ("k", k, (T,), dtype), ("s", s, (T,), dtype),
            ("p_j", p_j, (H,), dtype), ("tmax_j", tmax_j, (H,), dtype),
            ("t_end", t_end, (), dtype)):
        check_operand(name, x, shape, dt, device)
    for name, x in zip(DesState._fields, state):
        cols = (H if name in PER_TYPE_COLS else ring if name in RING_COLS
                else L if name in LOG_COLS else None)
        check_operand(f"state.{name}", x, (T,) if cols is None else (T, cols),
                      dtype if name in FLOAT_DES_COLS else i32, device)
    if has_chaos:
        check_operand("u1", u1, (L, T), dtype, device)
        check_operand("u2", u2, (L, T), dtype, device)
        if len(chaos_params) != len(ChaosParams._fields):
            raise ValueError("chaos_params must hold the five fault columns")
        for name, x in zip(ChaosParams._fields, chaos_params):
            check_operand(f"chaos_params.{name}", x, (T,), dtype, device)

    if impl == "torch":
        counts = packet_while_ref(
            tj_prefw, tj_submit, submit, jtype, k, s, p_j, tmax_j, t_end,
            state, m_nodes, max_iters, u1=u1, u2=u2,
            chaos_params=chaos_params, r_cap=r_cap)
        return state, counts

    inputs = [tj_prefw, tj_submit, submit, jtype, k, s, p_j, tmax_j, t_end]
    inputs += [u1, u2, *chaos_params] if has_chaos else [None] * 7
    dims = (T, H, N, ring, L, m_nodes, r_cap, max_iters,
            max(N.bit_length(), 1))
    is_f64 = dtype == torch.float64
    plan = _kernel.launch_plan(H, ring, is_f64, has_chaos)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel.launch(
            is_f64, has_chaos,
            [0 if x is None else x.data_ptr() for x in inputs],
            [x.data_ptr() for x in state], dims, plan, stream)
    if err != 0:
        raise RuntimeError(f"packet_while kernel launch failed: "
                           f"cudaGetLastError() = {err}")
    packet_while.launches += 1
    return state, {"launches": 1, "syncs": 0}


packet_while.launches = 0
