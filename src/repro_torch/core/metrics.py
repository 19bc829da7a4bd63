"""JMS efficiency metrics (paper §3), batched over the lane axis.

  1. full utilization    — busy node-seconds / (M * window)   (init counts)
  2. useful utilization  — useful node-seconds / (M * window) (init is idle)
  3. job queue time      — group start - submit (avg and median)
  4. queue length        — time-average number of waiting jobs

All metrics are measured over the window [0, last submit]; the simulation
itself runs to drain. Every metric inherits the simulation dtype and stays
on the device of the `DesResult` it is computed from.

The means over the job axis are sums in a fixed pairwise tree
(`_sum_last`), not `torch.mean`: a CUDA reduction picks its order from
the tensor's shape, so a lane's mean would depend on how many lanes share
its dispatch (one in `mode="seq"`, 666 in a fused chaos grid). The tree's
order depends only on the job count, so every layout, and the CPU, give a
lane the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# The scalar per-experiment metric fields (excludes n_groups/ok bookkeeping)
# and the near-zero floors used whenever a *relative* comparison of metric
# values is made: |a - b| / max(|b|, floor).
SCALAR_METRIC_FIELDS = ("avg_wait", "med_wait", "avg_qlen", "full_util",
                        "useful_util", "avg_run_wait")
METRIC_REL_FLOORS = {"avg_wait": 1e-3, "med_wait": 1e-3, "avg_run_wait": 1e-3,
                     "avg_qlen": 1e-6, "full_util": 1e-6, "useful_util": 1e-6}


class Metrics(NamedTuple):
    avg_wait: object      # seconds
    med_wait: object      # seconds
    avg_qlen: object      # jobs
    full_util: object     # [0, 1]
    useful_util: object   # [0, 1]
    avg_run_wait: object  # secondary: wait until the job's own run start
    n_groups: object
    ok: object
    # chaos lane outputs (zeros / False without a ChaosConfig)
    lost_work: object         # chip-seconds lost past checkpoints
    failures: object          # failed groups
    straggler_kills: object   # deadline kills (failure wins ties)
    requeues: object          # requeue rounds (failed or killed)
    requeued_jobs: object     # individual members requeued
    budget_exhausted: object  # event budget hit: truncated run


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a pairwise tree of elementwise adds: the
    axis zero-padded to a power of two, then halves added until one
    column is left. The order of the adds depends only on the axis
    length."""
    n = x.shape[-1]
    width = 1 << max(0, (n - 1).bit_length())
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _mean_last(x: torch.Tensor) -> torch.Tensor:
    return _sum_last(x) / x.shape[-1]


def _median_last(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis as the midpoint of the two middle values
    (`torch.median` returns the lower one for an even count). +inf entries
    sort last and propagate when they reach the middle."""
    n = x.shape[-1]
    srt, _ = torch.sort(x, dim=-1)
    return (srt[..., (n - 1) // 2] + srt[..., n // 2]) * 0.5


def efficiency_metrics(submit, result, m_nodes, t_last_submit) -> Metrics:
    """Paper §3 metrics from a DesResult whose per-job fields are
    ``[..., N]`` and whose per-lane fields are ``[...]``.

    Args:
      submit: [N] job submit times.
      result: DesResult (any number of leading lane axes).
      m_nodes: cluster size M.
      t_last_submit: 0-d tensor, metric window end.
    """
    window = torch.clamp(t_last_submit, min=1e-9)
    denom = m_nodes * window
    wait = torch.clamp(result.start_t - submit, min=0.0)
    run_wait = torch.clamp(result.run_start_t - submit, min=0.0)
    return Metrics(
        avg_wait=_mean_last(wait),
        med_wait=_median_last(wait),
        avg_qlen=result.qlen_int / window,
        full_util=result.busy_ns / denom,
        useful_util=result.useful_ns / denom,
        avg_run_wait=_mean_last(run_wait),
        n_groups=result.n_groups,
        ok=result.ok,
        lost_work=result.lost_work,
        failures=result.failures,
        straggler_kills=result.straggler_kills,
        requeues=result.requeues,
        requeued_jobs=result.requeued_jobs,
        budget_exhausted=result.budget_exhausted)
