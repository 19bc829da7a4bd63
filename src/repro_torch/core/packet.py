"""Pure functions of the Packet group-scheduling policy (paper §5), torch.

  * queue weight      W(T_j) = C_j * P_j * (1 + T_cur_j / T_max_j),
                      C_j = (sum of queued work) / s_j
  * group node count  m_threshold = ceil(sum_work / (k * s_j)),
                      m_group = min(m_threshold, m_free)
  * group duration    d = s_j + sum_work / m_group

Paper's worked example (Fig. 3): s = 1 min, total work 4 node-minutes:
k = 0.5 -> 8 nodes, k = 1 -> 4 nodes, k = 2 -> 2 nodes, k = 4 -> 1 node.

All functions are shape-polymorphic over broadcastable tensors (they are
called per lane and over ``[H, T]``) and keep the reference's exact order
of operations, so per-element results round identically.

The node threshold is cast to int32 as XLA casts it: NaN gives 0 and a
value outside the int32 range its nearest limit (a tiny `k` makes
``ceil(work / (k * s))`` exceed 2**31, where PyTorch's own cast is
undefined and gives INT_MIN on x86).
"""
from __future__ import annotations

import torch


def queue_weights(sum_work, s_j, priority, oldest_submit, now, t_max,
                  nonempty):
    """Packet queue weights over the job types (paper Step 2); -inf for
    empty queues. See `repro.core.packet.queue_weights` for the operands."""
    c_j = sum_work / torch.clamp(s_j, min=1e-9)
    t_cur = torch.clamp(now - oldest_submit, min=0.0)
    w = c_j * priority * (1.0 + t_cur / torch.clamp(t_max, min=1e-9))
    return torch.where(nonempty, w, torch.full_like(w, float("-inf")))


def m_threshold(sum_work, k, s_j):
    """Nodes so the group's execution time is ~= k x its init time (Step 4)."""
    m = torch.ceil(sum_work / (torch.clamp(k, min=1e-9) *
                               torch.clamp(s_j, min=1e-9)))
    return saturating_int32(torch.clamp(m, min=1.0))


def saturating_int32(x):
    """float -> int32 as XLA converts: NaN -> 0, out-of-range values to the
    nearer int32 limit. float64 holds both limits exactly."""
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    return torch.clamp(x, -2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


def group_nodes(sum_work, k, s_j, m_free):
    """m_group = min(m_threshold, m_free); 0 if no free nodes."""
    m = torch.minimum(m_threshold(sum_work, k, s_j), m_free)
    return torch.clamp(m, min=0)


def group_duration(sum_work, s_j, m_group):
    """Initialization once, then all jobs back-to-back with linear speed-up."""
    return s_j + sum_work / torch.clamp(m_group, min=1).to(sum_work.dtype)
