"""Plain PyTorch version of the Packet group-formation decision.

`packet_select_ref` takes one decision per row of a ``[T, H]`` batch:
queue weights over the H job types, the first-index argmax, the node count
and the group's duration. It is built from the port's policy functions
(`repro_torch.core.packet`), as the reference's
`repro.kernels.packet_select.ref` is built from `repro.core.packet`, so
it follows the policy where the TPU kernel differs from it: the duration
uses the UNCLAMPED init time ``s_j[j]`` (only the weight and the node
threshold clamp it at 1e-9), empty queues weigh -inf, and the node
threshold is cast to int32 before the minimum with `m_free`.

It is used by the CPU tests, by the comparison phase of `chip_smoke.py`
and by the engine on CPU tensors; on CUDA tensors nothing on the main path
calls it.
"""
from __future__ import annotations

import torch

from repro_torch.core import packet


def packet_select_ref(sum_w, s_j, p_j, oldest, t_max, nonempty, now, k,
                      m_free):
    """One decision per row.

    ``sum_w, s_j, p_j, oldest, t_max`` are ``[T, H]`` floats, `nonempty`
    ``[T, H]`` bool, ``now, k`` ``[T]`` floats and `m_free` ``[T]`` int32.
    Returns ``(j [T] int32, m [T], dur [T], work [T])`` with `m` the
    group's node count as an integer-valued float of the input dtype.
    """
    w = packet.queue_weights(sum_w, s_j, p_j, oldest, now[:, None], t_max,
                             nonempty)
    j = torch.argmax(w, dim=1, keepdim=True)        # first index on ties
    work = torch.gather(sum_w, 1, j)[:, 0]
    s_sel = torch.gather(s_j, 1, j)[:, 0]
    m = packet.group_nodes(work, k, s_sel, m_free)
    dur = packet.group_duration(work, s_sel, m)
    return j[:, 0].to(torch.int32), m.to(sum_w.dtype), dur, work
