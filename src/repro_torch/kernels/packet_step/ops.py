"""Public wrapper of the fused DES event-step kernel.

`packet_event_steps` advances every lane of a dispatch by `n_steps`
events: the 23 ``[rows, T]`` state columns are UPDATED IN PLACE and rows
``log_offset .. log_offset + n_steps - 1`` of the four group-log buffers
are written. With ``n_steps = 1`` it is the function of the reference's
`repro.kernels.packet_step.ops.fused_packet_step`.

On CUDA tensors it launches the hand-written kernel
(`repro_torch/csrc/packet_step.cu`) or raises; there is no path from a
failed launch to the plain version. On CPU tensors it runs the plain
PyTorch version (`ref.py`). ``step_impl="torch"`` asks for the plain
version by name on either device.

`packet_event_steps.launches` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import torch

from repro_torch.core.des import (FLOAT_STATE_COLS, N_STATE_COLS,
                                  ChaosParams, ScanState)
from repro_torch.kernels.packet_step import kernel as _kernel
from repro_torch.kernels.packet_step.ref import packet_steps_ref
from repro_torch.kernels.routing import check_operand

#: the recognized per-event step implementations
STEP_IMPLS = ("cuda", "torch")


def resolve_step_impl(step_impl: str | None, device: torch.device) -> str:
    """Default: the kernel on a CUDA device, the plain version on the CPU.
    ``"cuda"`` on a CPU device raises."""
    if step_impl is None:
        return "cuda" if device.type == "cuda" else "torch"
    if step_impl not in STEP_IMPLS:
        raise ValueError(f"unknown step_impl {step_impl!r}; "
                         f"available: {STEP_IMPLS}")
    if step_impl == "cuda" and device.type != "cuda":
        raise ValueError("step_impl='cuda' needs CUDA tensors; these live "
                         f"on {device} (use step_impl='torch' there)")
    return step_impl


def packet_event_steps(tj_prefw, tj_submit, submit, jtype, k, s, p_j,
                       tmax_j, t_last, state: ScanState, logs=None,
                       log_offset: int = 0, n_steps: int = 1, u1=None,
                       u2=None, chaos_params=None, *, r_cap: int = 0,
                       step_impl: str | None = None):
    """Advance every lane by `n_steps` events.

    Operands: ``tj_prefw [H, N+1]``, ``tj_submit [H, N]``, ``submit [N]``,
    ``jtype [N]`` int32, ``k``/``s`` ``[1, T]``, ``p_j``/``tmax_j``
    ``[H]``, ``t_last [1, 1]``, `state` a `ScanState` of ``[rows, T]``
    columns; under chaos ``u1``/``u2`` ``[L_cap, T]`` and `chaos_params`,
    the five ``[1, T]`` fault columns (all three or none). `logs` is the
    4-tuple ``(key, t, m, head_w)`` of ``[rows, T]`` buffers; when None,
    ``[n_steps, T]`` buffers are allocated. Returns ``(state, logs)`` with
    `state` the same tensors, updated in place.
    """
    device = state.t.device
    dtype = state.t.dtype
    step_impl = resolve_step_impl(step_impl, device)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"state must be float32 or float64, got {dtype}")
    if tj_prefw.dim() != 2 or state.t.dim() != 2:
        raise ValueError("tj_prefw must be [H, N+1] and state.t [1, T]")
    H, N = int(tj_prefw.shape[0]), int(tj_prefw.shape[1]) - 1
    T = int(state.t.shape[1])
    ring = int(state.grp_end.shape[0])
    n_steps, log_offset, r_cap = int(n_steps), int(log_offset), int(r_cap)
    if N < 1 or H < 1 or T < 1 or ring < 1 or n_steps < 1:
        raise ValueError("N, H, T, ring and n_steps must all be >= 1")
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
            ("k", k, (1, T), dtype), ("s", s, (1, T), dtype),
            ("p_j", p_j, (H,), dtype), ("tmax_j", tmax_j, (H,), dtype),
            ("t_last", t_last, (1, 1), dtype)):
        check_operand(name, x, shape, dt, device)
    if len(state) != N_STATE_COLS:
        raise ValueError(f"state must have {N_STATE_COLS} columns")
    rows_of = {"head": H, "tail": H, "pool_w": H, "pool_oldest": H,
               "pool_code": H, "grp_end": ring, "grp_m": ring,
               "grp_jtype": ring, "grp_rem_w": ring, "grp_rem_cnt": ring,
               "grp_rem_oldest": ring}
    for name, x in zip(ScanState._fields, state):
        check_operand(f"state.{name}", x, (rows_of.get(name, 1), T),
               dtype if name in FLOAT_STATE_COLS else i32, device)
    L_cap = 1
    if has_chaos:
        L_cap = int(u1.shape[0])
        check_operand("u1", u1, (L_cap, T), dtype, device)
        check_operand("u2", u2, (L_cap, T), dtype, device)
        if len(chaos_params) != len(ChaosParams._fields):
            raise ValueError("chaos_params must hold the five fault columns")
        for name, x in zip(ChaosParams._fields, chaos_params):
            check_operand(f"chaos_params.{name}", x, (1, T), dtype, device)
    if logs is None:
        if log_offset != 0:
            raise ValueError("log_offset needs caller-owned log buffers")
        logs = (torch.empty((n_steps, T), dtype=i32, device=device),
                torch.empty((n_steps, T), dtype=dtype, device=device),
                torch.empty((n_steps, T), dtype=i32, device=device),
                torch.empty((n_steps, T), dtype=dtype, device=device))
    if len(logs) != 4:
        raise ValueError("logs must be the 4-tuple (key, t, m, head_w)")
    rows = int(logs[0].shape[0])
    if log_offset < 0 or log_offset + n_steps > rows:
        raise ValueError(f"log rows {log_offset}..{log_offset + n_steps - 1} "
                         f"do not fit buffers of {rows} rows")
    for name, x, dt in zip(("log_key", "log_t", "log_m", "log_headw"), logs,
                           (i32, dtype, i32, dtype)):
        check_operand(name, x, (rows, T), dt, device)

    if step_impl == "torch":
        new = packet_steps_ref(
            tj_prefw, tj_submit, submit, jtype, k, s, p_j, tmax_j, t_last,
            state, logs, log_offset, n_steps, u1=u1, u2=u2,
            chaos_params=chaos_params, r_cap=r_cap)
        for old_col, new_col in zip(state, new):
            old_col.copy_(new_col)
        return state, logs

    inputs = [tj_prefw, tj_submit, submit, jtype, k, s, p_j, tmax_j, t_last]
    inputs += [u1, u2, *chaos_params] if has_chaos else [None] * 7
    dims = (T, H, N, ring, r_cap, L_cap, max(N.bit_length(), 1), log_offset,
            n_steps)
    is_f64 = dtype == torch.float64
    plan = _kernel.launch_plan(H, ring, is_f64)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel.launch(
            is_f64, has_chaos,
            [0 if x is None else x.data_ptr() for x in inputs],
            [x.data_ptr() for x in state], [x.data_ptr() for x in logs],
            dims, plan, stream)
    if err != 0:
        raise RuntimeError(f"packet_step kernel launch failed: "
                           f"cudaGetLastError() = {err}")
    packet_event_steps.launches += 1
    return state, logs


packet_event_steps.launches = 0
