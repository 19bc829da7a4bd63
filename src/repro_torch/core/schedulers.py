"""Baseline schedulers: FCFS and conservative EASY backfill (rigid jobs).

Counterpart of `repro.core.schedulers`. The paper sweeps only the Packet
algorithm; its predecessor work compares grouping against the backfill
scheduling that production job-management systems use. Both baselines run
on the *rigid* view of the workload (each job alone on its requested n_i
nodes for s + e_i seconds, paying its own initialization), with the
event skeleton of the reference: one event an iteration (the earlier of
the next submission and the first finishing job), the queue integral by
the scalar ``next_sub - n_started``, a ring of ``resolve_ring(M, N)``
slots, then a scheduling pass.

Both functions take one init time or ``[T]`` lanes of them and run every
lane to its end in `repro_torch.kernels.baselines.ops.baselines`: on CUDA
tensors ONE launch of the hand-written kernel, on CPU tensors (or with
``impl="torch"``) its plain version, the lanes in lockstep. They return
the reference's `DesResult`: `n_groups` is the number of jobs started,
`run_start_t` is ``start_t + s``, the fault counters and `lost_work` are
zero.
"""
from __future__ import annotations

import torch

from repro_torch.core.des import (DesResult, PackedWorkload, _is_scalar,
                                  _lane_tensor, resolve_ring)
from repro_torch.kernels.baselines import ops as _ops
from repro_torch.kernels.routing import resolve_impl

BACKFILL_DEPTH = 64     # waiting jobs tried behind the blocked head


def _simulate(pw: PackedWorkload, s_init, m_nodes, policy: str,
              max_iters, ring, depth: int, impl) -> DesResult:
    dev = pw.submit.device
    impl = resolve_impl(impl, dev)
    N = pw.n_jobs
    dtype = pw.submit.dtype
    squeeze = _is_scalar(s_init)
    s = _lane_tensor(s_init, dtype, dev)
    if s.dim() != 1:
        raise ValueError(f"s_init must be a scalar or a [T] lane array, "
                         f"got shape {tuple(s.shape)}")
    s = s.contiguous()
    out = _ops.baselines(
        pw.submit, pw.runtime, pw.nodes, pw.t_last_submit, s, int(m_nodes),
        policy=policy, max_iters=4 * N + 64 if max_iters is None
        else int(max_iters), ring=resolve_ring(m_nodes, N, ring),
        depth=depth, impl=impl)
    drained = out.drained
    ok = drained & torch.all(torch.isfinite(out.start_t), dim=1)
    zf = torch.zeros_like(out.qlen_int)
    zi = torch.zeros_like(out.n_started)
    res = DesResult(start_t=out.start_t, run_start_t=out.run_start_t,
                    qlen_int=out.qlen_int, busy_ns=out.busy_ns,
                    useful_ns=out.useful_ns, n_groups=out.n_started,
                    makespan=out.makespan, ok=ok, budget_exhausted=~drained,
                    lost_work=zf, failures=zi, straggler_kills=zi,
                    requeues=zi, requeued_jobs=zi)
    return DesResult(*(x[0] for x in res)) if squeeze else res


def simulate_fcfs(pw: PackedWorkload, s_init, m_nodes,
                  max_iters: int | None = None, ring: int | None = None,
                  impl: str | None = None) -> DesResult:
    """Strict FCFS: the head of the queue blocks everything behind it.

    `s_init` is one init time or ``[T]`` lanes (then every field has a
    leading lane axis). `max_iters` caps each lane's events (default
    ``4N + 64``; a lane that hits it reports `budget_exhausted`). `impl`
    as in `repro_torch.kernels.routing.resolve_impl`; the tensors of `pw`
    decide the device.
    """
    return _simulate(pw, s_init, m_nodes, "fcfs", max_iters, ring, 0, impl)


def simulate_backfill(pw: PackedWorkload, s_init, m_nodes,
                      backfill_depth: int = BACKFILL_DEPTH,
                      max_iters: int | None = None, ring: int | None = None,
                      impl: str | None = None) -> DesResult:
    """Conservative EASY backfill.

    The head job gets a reservation at the *shadow time* (the earliest
    instant enough nodes will be free, the running jobs taken in stable
    order of their ends); waiting jobs within `backfill_depth` behind it
    may jump ahead iff they fit now and either finish before the shadow
    time or use only the `extra` nodes the reservation does not need.
    Shadow and extra are computed once a pass. Arguments as
    `simulate_fcfs`.
    """
    return _simulate(pw, s_init, m_nodes, "backfill", max_iters, ring,
                     int(backfill_depth), impl)
