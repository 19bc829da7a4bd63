"""Workload cohorts: the workload axis of the batched sweep.

Counterpart of `repro.core.cohort`. The paper's study is 6 workflows x 37
scale ratios x 6 init proportions = 1332 experiments. A cohort is a set of
workloads that can share one dispatch of the scan engine: their cluster
size M (the engine's node count), job count N and type count H (the table
shapes), simulation dtype and ring size (the state's shape), and under
chaos the requeue bound R (the log and budget), all equal. `cohort_key`
is that tuple; `group_workloads` partitions a named workload dict by it.
Under the precision policy of benchmarks/paper_sweep.py the paper's 6
flows form exactly two cohorts:

  * 3 heterogeneous flows — M=500, N=5000, float64,
  * 3 homogeneous flows  — M=100, N=5000, float32.

`stack_workloads` packs each member (`repro_torch.core.des.pack_workload`)
and stacks the `PackedWorkload` tensors along a new leading ``[W]`` axis:
the result is a PackedWorkload whose tensors carry shape ``[W, ...]``
(``t_last_submit`` ``[W]``) and whose ``n_types`` / ``n_jobs`` are the
shared values. The scan engine takes it with ``[W, L]`` lanes and runs
the W * L lanes as one dispatch: on the card one launch of the event-step
kernel per segment, each lane reading its member's tables
(`repro_torch.core.des.simulate_packet_scan_lanes`,
`repro_torch.core.sweep.run_cohort_grid`).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import precision
from repro_torch.core.des import (ChaosConfig, PackedWorkload,
                                  chaos_is_inert, pack_workload,
                                  resolve_max_requeues, resolve_ring)
from repro_torch.device import resolve_device
from repro_torch.workload.lublin import Workload, workload_statics


class CohortKey(NamedTuple):
    """The statics shared by every member of a cohort."""
    m_nodes: int     # cluster size M (one value for every lane)
    n_jobs: int      # N: table shapes + event budget
    n_types: int     # H: per-type table shapes
    dtype: str       # simulation precision
    ring: int        # running-group ring size (state shape)
    # requeue-round bound R (0 without chaos): sizes the group log (N + R)
    # and the event budget, so it is a static like N
    max_requeues: int = 0


def cohort_key(wl: Workload, dtype=np.float32,
               chaos: ChaosConfig | None = None) -> CohortKey:
    """The statics tuple deciding which stacked dispatch a workload joins.

    A `chaos` config contributes its resolved requeue bound
    (`resolve_max_requeues`); inert configs (all-zero rates) count as no
    chaos, R = 0, as the run drivers treat them.
    """
    if chaos_is_inert(chaos):
        chaos = None
    m_nodes, n_jobs, n_types = workload_statics(wl)
    return CohortKey(m_nodes, n_jobs, n_types,
                     precision.canonical_dtype(dtype).name,
                     resolve_ring(m_nodes, n_jobs),
                     resolve_max_requeues(chaos, n_jobs))


@dataclasses.dataclass(frozen=True)
class WorkloadCohort:
    """Named workloads sharing one CohortKey, ready to run as one dispatch."""
    names: tuple[str, ...]
    workloads: tuple[Workload, ...]
    key: CohortKey

    @property
    def n_workloads(self) -> int:
        return len(self.names)

    @property
    def m_nodes(self) -> int:
        return self.key.m_nodes

    @property
    def n_jobs(self) -> int:
        return self.key.n_jobs

    @property
    def ring(self) -> int:
        return self.key.ring

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(self.key.dtype)

    @property
    def label(self) -> str:
        """Stable provenance label, e.g. ``M100-N5000-float32``."""
        return f"M{self.key.m_nodes}-N{self.key.n_jobs}-{self.key.dtype}"

    def pack(self, device=None) -> PackedWorkload:
        """Members packed and stacked along a leading ``[W]`` axis on
        `device` (None = the CUDA card). Cached per device on first use:
        members and dtype are immutable, so repeated studies over one
        cohort skip the host repack and the upload."""
        dev = resolve_device(device)
        cache = self.__dict__.setdefault("_packed", {})
        if dev not in cache:
            cache[dev] = stack_workloads(self.workloads, self.dtype, dev)
        return cache[dev]


def stack_workloads(workloads: Sequence[Workload], dtype=np.float32,
                    device=None) -> PackedWorkload:
    """Pack same-static workloads and stack them along a leading axis.

    The result is a PackedWorkload whose tensors have shape ``[W, ...]``
    (the 0-d `t_last_submit` becomes ``[W]``) and whose ``n_types`` /
    ``n_jobs`` are the shared values, on `device` (None = the CUDA card).
    Mismatched statics raise at once, naming the field.
    """
    if not workloads:
        raise ValueError("stack_workloads needs at least one workload")
    stats = [workload_statics(wl) for wl in workloads]
    for i, field in enumerate(("m_nodes", "n_jobs", "n_types")):
        vals = sorted({s[i] for s in stats})
        if len(vals) > 1:
            raise ValueError(
                f"cannot stack workloads with mismatched {field}: {vals}; "
                f"split them into compatible cohorts with group_workloads()")
    dev = resolve_device(device)
    pws = [pack_workload(wl, dtype, dev) for wl in workloads]
    return PackedWorkload(
        *(torch.stack(xs, dim=0) for xs in zip(*(p[:-2] for p in pws))),
        n_types=pws[0].n_types, n_jobs=pws[0].n_jobs)


def group_workloads(flows: Mapping[str, Workload],
                    dtypes=np.float32,
                    chaos: ChaosConfig | None = None) -> list[WorkloadCohort]:
    """Partition named workloads into batch-compatible cohorts.

    ``dtypes`` is either one dtype for every workload or a mapping
    ``name -> dtype`` (e.g. the per-workload precision policy of
    benchmarks/paper_sweep.py, which runs heterogeneous flows in float64).
    ``chaos`` (for a fault sweep) folds the requeue bound into each key.
    Cohorts come back in first-member insertion order, and members keep
    their insertion order within each cohort.
    """
    if isinstance(dtypes, Mapping):
        missing = [n for n in flows if n not in dtypes]
        if missing:
            raise ValueError(f"no dtype given for workloads {missing}")
        dtype_of = lambda name: np.dtype(dtypes[name])
    else:
        dtype_of = lambda name: np.dtype(dtypes)

    members: dict[CohortKey, list[tuple[str, Workload]]] = {}
    for name, wl in flows.items():
        members.setdefault(cohort_key(wl, dtype_of(name), chaos), []).append(
            (name, wl))
    return [WorkloadCohort(names=tuple(n for n, _ in mem),
                           workloads=tuple(w for _, w in mem), key=key)
            for key, mem in members.items()]
