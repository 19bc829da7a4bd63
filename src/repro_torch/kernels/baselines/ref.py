"""Plain PyTorch version of the rigid baseline schedulers.

`baselines_ref` runs the reference's `repro.core.schedulers` over ``[T]``
lanes (one init time each) in lockstep: the event skeleton
(`_event_skeleton`: the earlier of the next submission and the first
finishing job, the queue integral by the scalar ``next_sub - n_started``)
around one of its two scheduling passes:

  * ``"fcfs"`` — start the head of the queue while it fits and a ring slot
    is free (`simulate_fcfs`);
  * ``"backfill"`` — EASY backfill (`simulate_backfill`): start from the
    head while it fits, then reserve the shadow time of the blocked head
    (the running jobs in stable order of their ends, the cumulative free
    nodes at the first that frees enough) and let up to `depth` waiting
    jobs behind it jump ahead if they fit now and end before the shadow
    time or use only the `extra` nodes.

Every loop stops when no lane is active, and every update is masked. The
backfill walk over its candidates is taken a start at a time: each round
starts, on every lane, the first candidate after the last one started
that passes under the lane's current state. That is the job the
reference's walk (`fori_loop` over the candidates, the state changing
only when a job starts) starts next, since the candidates before it were
tested against the same state; the number of rounds is the number of
jobs backfilled, not `depth`.

This is what one launch of the CUDA kernel (`repro_torch/csrc/
baselines.cu`) computes. It is used on the CPU, by the tests and by the
comparisons of `chip_smoke.py`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.des import INF, _window_overlap

POLICIES = ("fcfs", "backfill")


class BaselineOut(NamedTuple):
    """What a baseline run leaves, per lane: ``[T, N]`` job times and
    ``[T]`` scalars."""
    start_t: torch.Tensor      # [T, N] +inf for a job never started
    run_start_t: torch.Tensor  # [T, N] start_t + s
    makespan: torch.Tensor     # [T] the last event's time
    qlen_int: torch.Tensor     # [T]
    busy_ns: torch.Tensor      # [T]
    useful_ns: torch.Tensor    # [T]
    n_started: torch.Tensor    # [T] int32
    drained: torch.Tensor      # [T] bool: no submission and no job left
    iters: torch.Tensor        # [T] int32 outer iterations (events)


def baselines_ref(submit, runtime, nodes, t_last, s, m_nodes: int, *,
                  policy: str, max_iters: int, ring: int,
                  depth: int = 64) -> BaselineOut:
    """Run every lane to its end. ``submit``/``runtime`` ``[N]``, ``nodes
    [N]`` int32, `t_last` 0-d (the metric window's end), ``s [T]`` init
    times; `m_nodes`, the cluster's nodes; `max_iters` caps each lane's
    events; `ring` slots for running jobs; `depth` backfill candidates a
    pass."""
    dev, dtype = s.device, s.dtype
    N, T = int(submit.shape[0]), int(s.shape[0])
    lanes = torch.arange(T, device=dev)
    idx = torch.arange(N, device=dev)
    zi = torch.zeros((), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    inf = torch.full((), INF, dtype=dtype, device=dev)

    t = torch.zeros((T,), dtype=dtype, device=dev)
    next_sub = torch.zeros((T,), dtype=torch.int32, device=dev)
    head_ptr = torch.zeros((T,), dtype=torch.int32, device=dev)
    started = torch.zeros((T, N), dtype=torch.bool, device=dev)
    m_free = torch.full((T,), int(m_nodes), dtype=torch.int32, device=dev)
    grp_end = torch.full((T, ring), INF, dtype=dtype, device=dev)
    grp_m = torch.zeros((T, ring), dtype=torch.int32, device=dev)
    start_t = torch.full((T, N), INF, dtype=dtype, device=dev)
    qlen_int = torch.zeros((T,), dtype=dtype, device=dev)
    busy = torch.zeros((T,), dtype=dtype, device=dev)
    useful = torch.zeros((T,), dtype=dtype, device=dev)
    n_started = torch.zeros((T,), dtype=torch.int32, device=dev)
    iters = torch.zeros((T,), dtype=torch.int32, device=dev)

    def start_job(mask, i):
        """`_start_job` of job ``i [T]`` on the lanes of `mask`."""
        nonlocal busy, useful, m_free, n_started
        i = i.long()
        dur = s + runtime[i]
        t_fin = t + dur
        slot = torch.argmax(torch.isinf(grp_end).to(torch.int8), dim=1)
        m = nodes[i]
        m_f = m.to(dtype)
        busy = torch.where(mask, busy + m_f * _window_overlap(
            t, t_fin, t_last), busy)
        useful = torch.where(mask, useful + m_f * _window_overlap(
            t + s, t_fin, t_last), useful)
        started[lanes, i] = started[lanes, i] | mask
        m_free = m_free - torch.where(mask, m, zi)
        grp_end[lanes, slot] = torch.where(mask, t_fin, grp_end[lanes, slot])
        grp_m[lanes, slot] = torch.where(mask, m, grp_m[lanes, slot])
        start_t[lanes, i] = torch.where(mask, t, start_t[lanes, i])
        n_started = n_started + mask.to(torch.int32)

    def slot_free():
        return torch.any(torch.isinf(grp_end), dim=1)

    def fcfs_pass(act):
        nonlocal head_ptr
        while True:
            i = torch.clamp(head_ptr, max=N - 1)
            can = (act & (head_ptr < next_sub) &
                   (nodes[i.long()] <= m_free) & slot_free())
            if not bool(can.any()):
                return
            start_job(can, i)
            head_ptr = head_ptr + can.to(torch.int32)

    def waiting_head():
        waiting = (idx[None, :] < next_sub[:, None]) & ~started
        head = torch.argmax(waiting.to(torch.int8), dim=1)
        return waiting, torch.any(waiting, dim=1), head

    def backfill_pass(act):
        # 1) start jobs from the head while they fit
        while True:
            waiting, any_wait, head = waiting_head()
            can = (act & any_wait & (nodes[head] <= m_free) & slot_free())
            if not bool(can.any()):
                break
            start_job(can, head)
        # 2) the blocked head's reservation
        waiting, any_wait, head = waiting_head()
        n_head = torch.where(any_wait, nodes[head], one)
        order = torch.argsort(grp_end, dim=1, stable=True)
        ends = torch.gather(grp_end, 1, order)
        frees = (torch.cumsum(torch.gather(grp_m, 1, order), dim=1,
                              dtype=torch.int32) + m_free[:, None])
        enough = frees >= n_head[:, None]
        shadow_i = torch.argmax(enough.to(torch.int8), dim=1)
        any_enough = torch.any(enough, dim=1)
        shadow = torch.where(any_enough, ends[lanes, shadow_i], inf)
        free_at_shadow = torch.where(any_enough, frees[lanes, shadow_i],
                                     m_free)
        extra = torch.clamp(free_at_shadow - n_head, min=0)
        # 3) up to `depth` waiting jobs behind the head, in index order
        key = torch.where(waiting & (idx[None, :] != head[:, None]),
                          idx[None, :], N)
        cand = torch.sort(key, dim=1).values[:, :depth]        # N = none
        valid = cand < N
        c = torch.clamp(cand, max=N - 1)
        # ends before the shadow time, or within the extra nodes: fixed for
        # the pass (shadow and extra are not updated as jobs backfill)
        ok_res = (((t + s)[:, None] + runtime[c] <= shadow[:, None]) |
                  (nodes[c] <= extra[:, None]))
        tried = torch.zeros_like(valid)
        q = torch.arange(cand.shape[1], device=dev)
        while True:
            passing = (valid & ~tried & ok_res & (nodes[c] <= m_free[:, None])
                       & (act & any_wait & slot_free())[:, None])
            go = torch.any(passing, dim=1)
            if not bool(go.any()):
                return
            first = torch.argmax(passing.to(torch.int8), dim=1)
            start_job(go, c[lanes, first])
            tried = tried | (go[:, None] & (q[None, :] <= first[:, None]))

    sched = fcfs_pass if policy == "fcfs" else backfill_pass
    while True:
        act = (((next_sub < N) | ~torch.all(torch.isinf(grp_end), dim=1)) &
               (iters < max_iters))
        if not bool(act.any()):
            break
        t_sub = torch.where(next_sub < N,
                            submit[torch.clamp(next_sub, max=N - 1).long()],
                            inf)
        slot = torch.argmin(grp_end, dim=1)
        t_fin = grp_end[lanes, slot]
        take_sub = t_sub <= t_fin
        t_new = torch.where(take_sub, t_sub, t_fin)
        n_wait = (next_sub - n_started).to(dtype)
        qlen_int = torch.where(act, qlen_int + n_wait * _window_overlap(
            t, t_new, t_last), qlen_int)
        t = torch.where(act, t_new, t)
        sub = act & take_sub
        fin = act & ~take_sub
        next_sub = next_sub + sub.to(torch.int32)
        m_free = m_free + torch.where(fin, grp_m[lanes, slot], zi)
        grp_end[lanes, slot] = torch.where(fin, inf, grp_end[lanes, slot])
        grp_m[lanes, slot] = torch.where(fin, zi, grp_m[lanes, slot])
        sched(act)
        iters = iters + act.to(torch.int32)

    drained = (next_sub >= N) & torch.all(torch.isinf(grp_end), dim=1)
    return BaselineOut(start_t=start_t, run_start_t=start_t + s[:, None],
                       makespan=t, qlen_int=qlen_int, busy_ns=busy,
                       useful_ns=useful, n_started=n_started,
                       drained=drained, iters=iters)
