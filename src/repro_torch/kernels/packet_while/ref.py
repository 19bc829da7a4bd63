"""Plain PyTorch version of the while-loop DES engine.

`packet_while_ref` runs the reference's while-loop engine (an event loop
with a nested group-formation loop) over lanes in lockstep, on a
lane-major `DesState` that it UPDATES IN PLACE: each loop runs until no
lane is active, and every update is masked so that a lane that is done or
blocked is untouched. Every inner iteration takes its decision (queue
weights, argmax, node count, duration) in ONE call of
`fused_packet_select` over all lanes, with that wrapper's own routing: on
CUDA tensors the hand-written decision kernel, on CPU tensors its plain
version. It is what one launch of the CUDA kernel
(`repro_torch/csrc/packet_while.cu`) computes.

It is the engine on the CPU, the ``impl="torch"`` engine on the card, and
the comparison of `chip_smoke.py`.
"""
from __future__ import annotations

import torch

from repro_torch.core.des import (CREDIT_EPS, INF, DesState, _chaos_outcome,
                                  _pool_decode, _resolve_remnant,
                                  _window_overlap)


def packet_while_ref(tj_prefw, tj_submit, submit, jtype, k, s, p_j, tmax_j,
                     t_end, st: DesState, m_nodes: int, max_iters: int,
                     u1=None, u2=None, chaos_params=None, *,
                     r_cap: int = 0) -> dict:
    """Run every lane of `st` to its end. Operands as `ops.packet_while`.

    Returns the lockstep loop counts: ``outer`` and ``inner`` iterations
    and ``syncs``, the host's boolean reads (one per loop test)."""
    from repro_torch.kernels.packet_select.ops import fused_packet_select

    has_chaos = u1 is not None
    H, N = int(tj_prefw.shape[0]), int(tj_prefw.shape[1]) - 1
    T, L = int(st.log_key.shape[0]), int(st.log_key.shape[1])
    R = int(r_cap)
    dtype, dev = st.t.dtype, st.t.device
    cp = chaos_params
    prefw, tsub = tj_prefw, tj_submit
    lanes = torch.arange(T, device=dev)
    w_off = torch.arange(H, device=dev) * (N + 1)   # flat rows of tj_prefw
    s_off = torch.arange(H, device=dev) * N         # flat rows of tj_submit
    # the decision's per-type operands that do not change
    s_rows = s[:, None].expand(T, H).contiguous()
    p_rows = p_j.expand(T, H).contiguous()
    tmax_rows = tmax_j.expand(T, H).contiguous()
    zero_f = torch.zeros((), dtype=dtype, device=dev)
    inf_f = torch.full((), INF, dtype=dtype, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    i32 = torch.int32
    m_nodes = int(m_nodes)

    def more():
        """[T]: the outer loop's condition per lane. A group holds at least
        one node until its end, so "a group is running" is m_free < M."""
        return (((st.next_sub < N) | (st.m_free < m_nodes)) &
                (st.iters < max_iters))

    def finish_remnant(slot, do_fin):
        """Chaos at a group's end: merge the stashed requeue into the
        type's pool (the deferred credit walk), clear the slot's stash."""
        j_f = st.grp_jtype[lanes, slot]
        jf = j_f.long()
        cnt, rem_w, rem_old, rem_lo, rem_hi, walk = _resolve_remnant(
            prefw, tsub, N, j_f, st.grp_rem_cnt[lanes, slot],
            st.grp_rem_w[lanes, slot], st.grp_rem_oldest[lanes, slot])
        pool_code = st.pool_code[lanes, jf]
        old_cnt, old_lo, old_frag = _pool_decode(pool_code, N)
        inc = cnt > 0
        was_empty = old_cnt == 0
        # the remnant span abuts the live window only if no formation of
        # this type ran while the group held it
        contig = rem_hi == st.head[lanes, jf]
        frag = torch.where(inc, old_frag | ~walk | ~was_empty | ~contig,
                           old_frag)
        new_lo = torch.where(was_empty, rem_lo,
                             torch.minimum(old_lo, rem_lo))
        new_code = (new_lo * 2 + frag.to(i32)) * (N + 1) + old_cnt + cnt
        st.pool_w[lanes, jf] = st.pool_w[lanes, jf] + torch.where(
            do_fin, rem_w, zero_f)
        st.pool_oldest[lanes, jf] = torch.minimum(
            st.pool_oldest[lanes, jf], torch.where(do_fin, rem_old, inf_f))
        st.pool_code[lanes, jf] = torch.where(do_fin & inc, new_code,
                                              pool_code)
        st.grp_rem_w[lanes, slot] = torch.where(
            do_fin, zero_f, st.grp_rem_w[lanes, slot])
        st.grp_rem_cnt[lanes, slot] = torch.where(
            do_fin, zero_i, st.grp_rem_cnt[lanes, slot])
        st.grp_rem_oldest[lanes, slot] = torch.where(
            do_fin, inf_f, st.grp_rem_oldest[lanes, slot])
        st.requeued_jobs.add_(torch.where(do_fin, cnt, zero_i))

    def event(act):
        """One event in every lane of `act`: a submission or a finish."""
        sub_idx = torch.clamp(st.next_sub, max=N - 1).long()
        t_sub = torch.where(st.next_sub < N, submit[sub_idx], inf_f)
        slot = torch.argmin(st.grp_end, dim=1)
        t_fin = st.grp_end[lanes, slot]
        take_sub = t_sub <= t_fin
        t_new = torch.where(take_sub, t_sub, t_fin)
        # queue-length integral over the elapsed interval (clipped)
        qlen = torch.sum(st.tail - st.head, dim=1).to(dtype)
        if has_chaos:
            qlen = qlen + torch.sum(st.pool_code % (N + 1), dim=1).to(dtype)
        q_inc = qlen * _window_overlap(st.t, t_new, t_end)
        st.qlen_int.copy_(torch.where(act, st.qlen_int + q_inc,
                                      st.qlen_int))
        st.t.copy_(torch.where(act, t_new, st.t))
        do_sub = act & take_sub
        do_fin = act & ~take_sub
        st.tail.index_put_((lanes, jtype[sub_idx].long()),
                           do_sub.to(i32), accumulate=True)
        st.next_sub.add_(do_sub)
        if has_chaos:
            finish_remnant(slot, do_fin)
        st.m_free.add_(torch.where(do_fin, st.grp_m[lanes, slot], zero_i))
        st.grp_end[lanes, slot] = torch.where(do_fin, inf_f, t_fin)
        st.grp_m[lanes, slot] = torch.where(do_fin, zero_i,
                                            st.grp_m[lanes, slot])
        st.iters.add_(act)

    def form(sched, nonempty, free):
        """One group in every lane of `sched` (paper Steps 1-5); `free`
        marks the free ring slots."""
        sum_w = (torch.take(prefw, st.tail + w_off) -
                 torch.take(prefw, st.head + w_off))
        oldest = torch.take(tsub, torch.clamp(st.head, max=N - 1) + s_off)
        if has_chaos:
            # requeued remainder counts toward weight / age / emptiness
            sum_w = sum_w + st.pool_w
            oldest = torch.minimum(oldest, st.pool_oldest)
        j, m, dur, work = fused_packet_select(
            sum_w, s_rows, p_rows, oldest, tmax_rows, nonempty, st.t, k,
            st.m_free)
        jl = j.long()
        m_grp = m.to(i32)
        slot = torch.argmax(free.to(torch.int8), dim=1)   # first free
        gslot = torch.clamp(st.n_groups, max=L - 1).long()
        head_j = st.head[lanes, jl]
        tail_j = st.tail[lanes, jl]
        head_w = prefw[jl, head_j.long()]
        if not has_chaos:
            t_fin = st.t + dur
            useful_end = t_fin
        else:
            out = _chaos_outcome(cp, u1[gslot, lanes], u2[gslot, lanes],
                                 st.requeues < R, s, work, m_grp, dur)
            t_fin = st.t + out.dur
            useful_end = torch.where(out.failed, st.t + s + out.ckpt_done,
                                     t_fin)
            requeued = out.failed | out.killed
            # stash the requeue span for the finish (see finish_remnant)
            p_cnt, p_lo, p_frag = _pool_decode(st.pool_code[lanes, jl], N)
            has_pool = p_cnt > 0
            qlo = torch.where(has_pool, p_lo, head_j)
            res0 = torch.where(has_pool, torch.maximum(
                head_w - prefw[jl, qlo.long()] - st.pool_w[lanes, jl],
                zero_f), zero_f)
            walk_ok = ~(has_pool & p_frag)
            span_code = 1 + qlo * (N + 1) + tail_j
            rem_agg = work - out.credit
            a_has = requeued & (rem_agg > CREDIT_EPS)
            a_cnt = (tail_j - head_j) + p_cnt
            code = torch.where(requeued & walk_ok, span_code,
                               torch.where(a_has, -a_cnt, zero_i))
            stash_w = torch.where(
                requeued & walk_ok, res0 + out.credit,
                torch.where(a_has, torch.maximum(rem_agg, zero_f), zero_f))
            stash_old = torch.where(a_has & ~walk_ok, oldest[lanes, jl],
                                    inf_f)
            for col, val in ((st.grp_jtype, j), (st.grp_rem_w, stash_w),
                             (st.grp_rem_cnt, code),
                             (st.grp_rem_oldest, stash_old)):
                col[lanes, slot] = torch.where(sched, val, col[lanes, slot])
            for col, val in ((st.pool_w, zero_f), (st.pool_oldest, inf_f),
                             (st.pool_code, zero_i)):
                col[lanes, jl] = torch.where(sched, val, col[lanes, jl])
            st.lost_work.add_(torch.where(sched, out.lost, zero_f))
            st.failures.add_(sched & out.failed)
            st.straggler_kills.add_(sched & out.killed & ~out.failed)
            st.requeues.add_(sched & requeued)
        m_f = m_grp.to(dtype)
        busy_inc = m_f * _window_overlap(st.t, t_fin, t_end)
        useful_inc = m_f * _window_overlap(st.t + s, useful_end, t_end)
        # O(1) group-log append; job times reconstructed after the loop
        for col, val in ((st.log_key, j * (N + 1) + tail_j),
                         (st.log_t, st.t), (st.log_m, m_grp),
                         (st.log_headw, head_w)):
            col[lanes, gslot] = torch.where(sched, val, col[lanes, gslot])
        st.head[lanes, jl] = torch.where(sched, tail_j, head_j)  # drain all
        st.m_free.sub_(torch.where(sched, m_grp, zero_i))
        st.grp_end[lanes, slot] = torch.where(sched, t_fin,
                                              st.grp_end[lanes, slot])
        st.grp_m[lanes, slot] = torch.where(sched, m_grp,
                                            st.grp_m[lanes, slot])
        st.busy_ns.add_(torch.where(sched, busy_inc, zero_f))
        st.useful_ns.add_(torch.where(sched, useful_inc, zero_f))
        st.n_groups.add_(sched)

    counts = {"outer": 0, "inner": 0, "syncs": 1}
    act = more()
    go = bool(act.any())
    while go:
        counts["outer"] += 1
        event(act)
        while True:
            nonempty = st.tail > st.head
            if has_chaos:
                nonempty = nonempty | (st.pool_code > 0)
            free = st.grp_end == INF
            sched = (act & (st.m_free > 0) & torch.any(nonempty, dim=1) &
                     torch.any(free, dim=1))
            # the outer test rides on the inner test's sync; it is read
            # only once no lane forms a group, when the state is final
            nxt = more()
            any_sched, go = torch.stack((sched.any(), nxt.any())).tolist()
            counts["syncs"] += 1
            if not any_sched:
                break
            counts["inner"] += 1
            form(sched, nonempty, free)
        act = nxt
    return counts
