"""Plain PyTorch version of the fused DES event step.

`packet_step_ref` advances every lane of a dispatch by ONE event on
``[state, T]`` tensors: the same function as the reference's
`repro.kernels.packet_step.kernel.event_step_kernel`, mirrored operation
for operation with `torch.gather`-style indexing, `torch.where` and
indexed writes. `packet_steps_ref` loops it for `n_steps` events and
writes the group-log rows, which is what one launch of the CUDA kernel
(`repro_torch/csrc/packet_step.cu`) computes.

It is used by the CPU tests, by the comparison phases of `chip_smoke.py`,
and by nothing on the main path when a card is present.
"""
from __future__ import annotations

import torch

from repro_torch.core import packet
from repro_torch.core.des import (INF, KEY_PAD, ChaosParams, ScanState,
                                  _chaos_outcome, _pool_decode,
                                  _resolve_remnant, _window_overlap)


def packet_step_ref(tj_prefw, tj_submit, submit, jtype, k, s, p_j, tmax_j,
                    t_last, state: ScanState, u1=None, u2=None,
                    chaos_params=None, *, r_cap: int = 0):
    """One event for every lane. Operands as `ops.packet_event_steps`;
    returns ``(new_state, (key, t, m, head_w))`` with ``[1, T]`` records
    and leaves `state` untouched."""
    has_chaos = u1 is not None
    N = int(submit.shape[0])
    prefw, tsub = tj_prefw, tj_submit
    k = k[0]
    s = s[0]
    t_last = t_last.reshape(())

    t = state.t[0]
    next_sub = state.next_sub[0]
    head, tail = state.head, state.tail
    m_free = state.m_free[0]
    grp_end, grp_m = state.grp_end, state.grp_m
    pool_w, pool_oldest, pool_code = (state.pool_w, state.pool_oldest,
                                      state.pool_code)
    grp_jtype, grp_rem_w = state.grp_jtype, state.grp_rem_w
    grp_rem_cnt, grp_rem_oldest = state.grp_rem_cnt, state.grp_rem_oldest
    requeues = state.requeues[0]
    n_groups = state.n_groups[0]

    dtype = t.dtype
    dev = t.device
    T = t.shape[0]
    lanes = torch.arange(T, device=dev)
    zero_f = torch.zeros((), dtype=dtype, device=dev)
    inf_f = torch.full((), INF, dtype=dtype, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    one_i = torch.ones((), dtype=torch.int32, device=dev)
    key_pad = torch.full((), KEY_PAD, dtype=torch.int32, device=dev)

    nonempty = tail > head                                   # [H, T]
    if has_chaos:
        nonempty = nonempty | (pool_code > 0)
    free_mask = torch.isinf(grp_end)                         # [ring, T]
    queued = torch.any(nonempty, dim=0)                      # [T]
    active = ((next_sub < N) | torch.any(~free_mask, dim=0) |
              torch.any(tail > head, dim=0))
    if has_chaos:
        active = active | torch.any(pool_code > 0, dim=0)
    can_sched = (m_free > 0) & queued & torch.any(free_mask, dim=0)
    do_sched = active & can_sched
    do_event = active & ~can_sched

    # greedy scheduling pass (paper Steps 1-5), masked unless do_sched
    sum_w = (torch.gather(prefw, 1, tail.long()) -
             torch.gather(prefw, 1, head.long()))            # [H, T]
    oldest = torch.gather(tsub, 1, torch.clamp(head, max=N - 1).long())
    if has_chaos:
        sum_w = sum_w + pool_w
        oldest = torch.minimum(oldest, pool_oldest)
    w = packet.queue_weights(sum_w, s, p_j[:, None], oldest, t,
                             tmax_j[:, None], nonempty)
    j = torch.argmax(w, dim=0)                               # [T] int64
    j32 = j.to(torch.int32)
    work = sum_w[j, lanes]
    m_grp = packet.group_nodes(work, k, s, m_free)
    dur = packet.group_duration(work, s, m_grp)
    # torch.argmax takes no bool tensor: cast the free mask
    sslot = torch.argmax(free_mask.to(torch.int8), dim=0)
    head_j = head[j, lanes]
    tail_j = tail[j, lanes]
    head_w = prefw[j, head_j.long()]
    if not has_chaos:
        t_gfin = t + dur
        useful_end = t_gfin
    else:
        chaos = ChaosParams(*(c[0] for c in chaos_params))
        L_cap = u1.shape[0]
        gslot = torch.clamp(n_groups, max=L_cap - 1).long()
        out_c = _chaos_outcome(chaos, u1[gslot, lanes], u2[gslot, lanes],
                               requeues < r_cap, s, work, m_grp, dur)
        t_gfin = t + out_c.dur
        useful_end = torch.where(out_c.failed,
                                 t + s + out_c.ckpt_done, t_gfin)
        requeued = do_sched & (out_c.failed | out_c.killed)
        p_cnt, p_lo, p_frag = _pool_decode(pool_code[j, lanes], N)
        has_pool = p_cnt > 0
        qlo = torch.where(has_pool, p_lo, head_j)
        res0 = torch.where(has_pool, torch.maximum(
            head_w - prefw[j, qlo.long()] - pool_w[j, lanes], zero_f),
            zero_f)
        walk_ok = ~(has_pool & p_frag)
        avail = res0 + out_c.credit
        span_code = 1 + qlo * (N + 1) + tail_j
        rem_agg = work - out_c.credit
        a_has = requeued & (rem_agg > 1e-9)
        a_cnt = (tail_j - head_j) + p_cnt
        code = torch.where(requeued & walk_ok, span_code,
                           torch.where(a_has, -a_cnt, zero_i))
        stash_w = torch.where(
            requeued & walk_ok, avail,
            torch.where(a_has, torch.maximum(rem_agg, zero_f), zero_f))
        stash_old = torch.where(a_has & ~walk_ok, oldest[j, lanes], inf_f)
    busy_inc = m_grp.to(dtype) * _window_overlap(t, t_gfin, t_last)
    useful_inc = m_grp.to(dtype) * _window_overlap(t + s, useful_end, t_last)

    # event step (submission or completion), masked unless do_event
    sub_idx = torch.clamp(next_sub, max=N - 1).long()
    t_sub = torch.where(next_sub < N, submit[sub_idx], inf_f)
    eslot = torch.argmin(grp_end, dim=0)
    t_efin = grp_end[eslot, lanes]
    take_sub = t_sub <= t_efin
    t_new = torch.where(take_sub, t_sub, t_efin)
    qlen = torch.sum(tail - head, dim=0).to(dtype)
    if has_chaos:
        qlen = qlen + torch.sum(pool_code % (N + 1), dim=0).to(dtype)
    q_inc = qlen * _window_overlap(t, t_new, t_last)
    sub_j = jtype[sub_idx].long()

    do_submit = do_event & take_sub
    do_finish = do_event & ~take_sub

    new_head = head.clone()
    new_head[j, lanes] = torch.where(do_sched, tail_j, head_j)
    new_tail = tail.clone()
    new_tail[sub_j, lanes] = tail[sub_j, lanes] + torch.where(
        do_submit, one_i, zero_i)
    new_m_free = (m_free - torch.where(do_sched, m_grp, zero_i)
                  + torch.where(do_finish, grp_m[eslot, lanes], zero_i))
    new_grp_end = grp_end.clone()
    new_grp_end[sslot, lanes] = torch.where(do_sched, t_gfin,
                                            grp_end[sslot, lanes])
    new_grp_end[eslot, lanes] = torch.where(do_finish, inf_f,
                                            new_grp_end[eslot, lanes])
    new_grp_m = grp_m.clone()
    new_grp_m[sslot, lanes] = torch.where(do_sched, m_grp,
                                          grp_m[sslot, lanes])
    new_grp_m[eslot, lanes] = torch.where(do_finish, zero_i,
                                          new_grp_m[eslot, lanes])

    y_key = torch.where(do_sched, j32 * (N + 1) + tail_j, key_pad)
    y_t = torch.where(do_sched, t, zero_f)
    y_m = torch.where(do_sched, m_grp, zero_i)
    y_hw = torch.where(do_sched, head_w, zero_f)

    if not has_chaos:
        chaos_upd = {}
    else:
        # finish resolves the stashed requeue span into its member set (the
        # deferred credit walk) and merges it back into the per-type pool
        j_f = grp_jtype[eslot, lanes]
        jf = j_f.long()
        cnt_r, rem_w_r, rem_old_r, rem_lo_r, rem_hi_r, walk_r = (
            _resolve_remnant(prefw, tsub, N, j_f, grp_rem_cnt[eslot, lanes],
                             grp_rem_w[eslot, lanes],
                             grp_rem_oldest[eslot, lanes]))
        old_cnt, old_lo, old_frag = _pool_decode(pool_code[jf, lanes], N)
        inc = do_finish & (cnt_r > 0)
        was_empty = old_cnt == 0
        contig = rem_hi_r == head[jf, lanes]
        frag = torch.where(
            inc, old_frag | ~walk_r | ~was_empty | ~contig, old_frag)
        new_lo = torch.where(was_empty, rem_lo_r,
                             torch.minimum(old_lo, rem_lo_r))
        new_code = ((new_lo * 2 + frag.to(torch.int32))
                    * (N + 1) + old_cnt + cnt_r)
        new_pool_w = pool_w.clone()
        new_pool_w[j, lanes] = torch.where(do_sched, zero_f,
                                           pool_w[j, lanes])
        new_pool_w[jf, lanes] = new_pool_w[jf, lanes] + torch.where(
            do_finish, rem_w_r, zero_f)
        new_pool_oldest = pool_oldest.clone()
        new_pool_oldest[j, lanes] = torch.where(do_sched, inf_f,
                                                pool_oldest[j, lanes])
        new_pool_oldest[jf, lanes] = torch.minimum(
            new_pool_oldest[jf, lanes],
            torch.where(do_finish, rem_old_r, inf_f))
        new_pool_code = pool_code.clone()
        new_pool_code[j, lanes] = torch.where(do_sched, zero_i,
                                              pool_code[j, lanes])
        new_pool_code[jf, lanes] = torch.where(inc, new_code,
                                               new_pool_code[jf, lanes])
        new_grp_jtype = grp_jtype.clone()
        new_grp_jtype[sslot, lanes] = torch.where(do_sched, j32,
                                                  grp_jtype[sslot, lanes])
        new_grp_rem_w = grp_rem_w.clone()
        new_grp_rem_w[sslot, lanes] = torch.where(do_sched, stash_w,
                                                  grp_rem_w[sslot, lanes])
        new_grp_rem_w[eslot, lanes] = torch.where(
            do_finish, zero_f, new_grp_rem_w[eslot, lanes])
        new_grp_rem_cnt = grp_rem_cnt.clone()
        new_grp_rem_cnt[sslot, lanes] = torch.where(
            do_sched, code, grp_rem_cnt[sslot, lanes])
        new_grp_rem_cnt[eslot, lanes] = torch.where(
            do_finish, zero_i, new_grp_rem_cnt[eslot, lanes])
        new_grp_rem_oldest = grp_rem_oldest.clone()
        new_grp_rem_oldest[sslot, lanes] = torch.where(
            do_sched, stash_old, grp_rem_oldest[sslot, lanes])
        new_grp_rem_oldest[eslot, lanes] = torch.where(
            do_finish, inf_f, new_grp_rem_oldest[eslot, lanes])
        chaos_upd = dict(
            pool_w=new_pool_w, pool_oldest=new_pool_oldest,
            pool_code=new_pool_code, grp_jtype=new_grp_jtype,
            grp_rem_w=new_grp_rem_w, grp_rem_cnt=new_grp_rem_cnt,
            grp_rem_oldest=new_grp_rem_oldest,
            lost_work=(state.lost_work[0] + torch.where(
                do_sched, out_c.lost, zero_f))[None, :],
            failures=(state.failures[0] + torch.where(
                do_sched & out_c.failed, one_i, zero_i))[None, :],
            straggler_kills=(state.straggler_kills[0] + torch.where(
                do_sched & out_c.killed & ~out_c.failed, one_i,
                zero_i))[None, :],
            requeues=(requeues + torch.where(requeued, one_i,
                                             zero_i))[None, :],
            requeued_jobs=(state.requeued_jobs[0] + torch.where(
                do_finish, cnt_r, zero_i))[None, :])

    new_state = state._replace(
        t=torch.where(do_event, t_new, t)[None, :],
        next_sub=(next_sub + torch.where(do_submit, one_i, zero_i))[None, :],
        head=new_head, tail=new_tail, m_free=new_m_free[None, :],
        grp_end=new_grp_end, grp_m=new_grp_m,
        qlen_int=(state.qlen_int[0] +
                  torch.where(do_event, q_inc, zero_f))[None, :],
        busy_ns=(state.busy_ns[0] +
                 torch.where(do_sched, busy_inc, zero_f))[None, :],
        useful_ns=(state.useful_ns[0] +
                   torch.where(do_sched, useful_inc, zero_f))[None, :],
        n_groups=(n_groups + torch.where(do_sched, one_i, zero_i))[None, :],
        **chaos_upd)
    y = (y_key[None, :], y_t[None, :], y_m[None, :], y_hw[None, :])
    return new_state, y


def packet_steps_ref(tj_prefw, tj_submit, submit, jtype, k, s, p_j, tmax_j,
                     t_last, state: ScanState, logs, log_offset: int,
                     n_steps: int, u1=None, u2=None, chaos_params=None, *,
                     r_cap: int = 0) -> ScanState:
    """`n_steps` events for every lane: a Python loop over
    `packet_step_ref` that writes rows ``log_offset .. log_offset +
    n_steps - 1`` of the four ``[rows, T]`` log buffers IN PLACE and
    returns the final state (new tensors; `state` is left untouched)."""
    for i in range(n_steps):
        state, y = packet_step_ref(
            tj_prefw, tj_submit, submit, jtype, k, s, p_j, tmax_j, t_last,
            state, u1=u1, u2=u2, chaos_params=chaos_params, r_cap=r_cap)
        for buf, rec in zip(logs, y):
            buf[log_offset + i] = rec[0]
    return state
