"""Public wrapper of the rigid baseline schedulers' kernel.

`baselines` runs FCFS or EASY backfill over ``[T]`` lanes (one init time
each) from the empty cluster to the end of every lane and returns a
`BaselineOut`.

On CUDA tensors it launches the hand-written kernel
(`repro_torch/csrc/baselines.cu`): ONE launch for the whole run, each
lane a warp that runs its own event loop to its end, no host in the loop;
or it raises, and nothing falls back to the plain version. On CPU tensors
it runs the plain PyTorch version (`ref.py`, the lanes in lockstep).
``impl="torch"`` asks for the plain version by name on either device;
``impl="cuda"`` on CPU tensors raises.

`baselines.launches` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.baselines import kernel as _kernel
from repro_torch.kernels.baselines.ref import (POLICIES, BaselineOut,
                                               baselines_ref)
from repro_torch.kernels.routing import check_operand, resolve_impl

DTYPES = (torch.float32, torch.float64)


def baselines(submit, runtime, nodes, t_last, s, m_nodes: int, *,
              policy: str, max_iters: int, ring: int, depth: int = 64,
              impl: str | None = None) -> BaselineOut:
    """Run every lane of one baseline policy to its end.

    Operands: ``submit``/``runtime`` ``[N]``, ``nodes [N]`` int32, `t_last`
    0-d (the metric window's end), ``s [T]`` the lanes' init times, all
    contiguous on one device in float32 or float64; `policy` ``"fcfs"`` or
    ``"backfill"``; `m_nodes` the cluster's nodes, `max_iters` the cap on
    each lane's events, `ring` the slots for running jobs, `depth` the
    backfill candidates a pass. Every operand is checked before anything
    is built or launched.
    """
    device, dtype = s.device, s.dtype
    impl = resolve_impl(impl, device)
    if policy not in POLICIES:
        raise ValueError(f"unknown baseline policy {policy!r}; available: "
                         f"{POLICIES}")
    if dtype not in DTYPES:
        raise ValueError(f"s must be float32 or float64, got {dtype}")
    if submit.dim() != 1 or s.dim() != 1:
        raise ValueError("submit must be [N] and s [T]")
    N, T = int(submit.shape[0]), int(s.shape[0])
    m_nodes, max_iters, ring, depth = (int(m_nodes), int(max_iters),
                                       int(ring), int(depth))
    if min(N, T, ring) < 1 or depth < 0 or max_iters < 0:
        raise ValueError("N, T and ring must be >= 1, depth and max_iters "
                         ">= 0")
    for name, x, shape, dt in (
            ("submit", submit, (N,), dtype),
            ("runtime", runtime, (N,), dtype),
            ("nodes", nodes, (N,), torch.int32),
            ("t_last", t_last, (), dtype), ("s", s, (T,), dtype)):
        check_operand(name, x, shape, dt, device)

    if impl == "torch":
        return baselines_ref(submit, runtime, nodes, t_last, s, m_nodes,
                             policy=policy, max_iters=max_iters, ring=ring,
                             depth=depth)

    out = BaselineOut(
        start_t=torch.empty((T, N), dtype=dtype, device=device),
        run_start_t=torch.empty((T, N), dtype=dtype, device=device),
        makespan=torch.empty((T,), dtype=dtype, device=device),
        qlen_int=torch.empty((T,), dtype=dtype, device=device),
        busy_ns=torch.empty((T,), dtype=dtype, device=device),
        useful_ns=torch.empty((T,), dtype=dtype, device=device),
        n_started=torch.empty((T,), dtype=torch.int32, device=device),
        drained=torch.empty((T,), dtype=torch.bool, device=device),
        iters=torch.empty((T,), dtype=torch.int32, device=device))
    is_f64 = dtype == torch.float64
    backfill = policy == "backfill"
    plan = _kernel.launch_plan(N, ring, depth, is_f64, backfill)
    work = (None if plan.lane_in_smem else torch.empty(
        (T, plan.lane_bytes), dtype=torch.uint8, device=device))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel.launch(
            is_f64, backfill,
            [x.data_ptr() for x in (submit, runtime, nodes, t_last, s)],
            [x.data_ptr() for x in out],
            0 if work is None else work.data_ptr(),
            (T, N, ring, depth, m_nodes, max_iters), plan, stream)
    if err != 0:
        raise RuntimeError(f"baselines kernel launch failed: "
                           f"cudaGetLastError() = {err}")
    baselines.launches += 1
    return out


baselines.launches = 0
