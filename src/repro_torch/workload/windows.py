"""Rolling windows and drift scenarios over the Lublin generator (numpy).

The port's own copy of `repro.workload.windows`, bound to the port's
`repro_torch.workload.lublin`: the same numpy calls in the same order, so
windows and drift traces are bitwise the reference's
(tests/test_torch_windows.py). It is the workload-facing half of the
streaming service (`repro_torch.service`): the service consumes a trace
as a sequence of fixed-size job windows and retunes the scale ratio k
once per window ("control tick").

Two guarantees anchor everything downstream:

* **Window-is-a-slice, bitwise.** `slice_window(wl, lo, hi)` returns
  arrays that are exact numpy slices of the full trace. With
  ``rebase=True`` (the simulation-facing default) only `submit` is
  shifted, in float64, so the window starts at t=0; windowed runs are
  reproducible from (seed, lo, hi) alone.

* **Fixed window shapes.** `window_bounds` yields only *full* windows of
  `window_jobs` jobs (a partial tail is dropped, reported via
  `n_dropped`), so every window packs to a `PackedWorkload` of the same
  shapes and every control tick is the same dispatch.

Drift scenarios: `drift_workload` concatenates per-segment
`generate_workload` traces (per-segment load / homogeneity knobs, seeded
from a base seed) with submit times shifted onto a common clock, giving
seed-stable intensity/homogeneity ramps and step changes; the canonical
set is `drift_scenarios`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Mapping, Sequence

import numpy as np

from repro_torch.workload.lublin import (Workload, WorkloadParams,
                                         generate_workload)


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """How to cut a trace into control-tick windows.

    window_jobs: jobs per window (the static shape every tick shares).
    stride_jobs: jobs between consecutive window starts; defaults to
        window_jobs (non-overlapping tumbling windows). A smaller stride
        gives overlapping rolling windows.
    rebase: shift each window's submit times so the window opens at t=0
        (what the DES expects); rebase=False keeps the raw bitwise slice.
    """

    window_jobs: int
    stride_jobs: int | None = None
    rebase: bool = True

    def __post_init__(self):
        if self.window_jobs < 1:
            raise ValueError(f"window_jobs must be >= 1, got {self.window_jobs}")
        if self.stride_jobs is not None and self.stride_jobs < 1:
            raise ValueError(f"stride_jobs must be >= 1, got {self.stride_jobs}")

    @property
    def stride(self) -> int:
        return self.window_jobs if self.stride_jobs is None else self.stride_jobs


def window_bounds(n_jobs: int, spec: WindowSpec) -> list[tuple[int, int]]:
    """[lo, hi) job-index bounds of every *full* window in a trace.

    Only windows with exactly ``spec.window_jobs`` jobs are returned so all
    windows share one static shape; a short tail is dropped (see
    `n_dropped`). Empty list if the trace is shorter than one window.
    """
    if n_jobs < 0:
        raise ValueError(f"n_jobs must be >= 0, got {n_jobs}")
    bounds = []
    lo = 0
    while lo + spec.window_jobs <= n_jobs:
        bounds.append((lo, lo + spec.window_jobs))
        lo += spec.stride
    return bounds


def n_dropped(n_jobs: int, spec: WindowSpec) -> int:
    """Jobs past the last full window (never simulated by the service)."""
    bounds = window_bounds(n_jobs, spec)
    return n_jobs if not bounds else n_jobs - bounds[-1][1]


def slice_window(wl: Workload, lo: int, hi: int, rebase: bool = True) -> Workload:
    """Jobs [lo, hi) of a trace as a Workload.

    With rebase=False every array is a bitwise numpy slice of the parent
    (zero-copy views). With rebase=True (default) `submit` is shifted by
    ``-submit[lo]`` in float64 so the window starts at t=0 — the form the
    DES measures over — while runtime/nodes/work/jtype stay bitwise
    slices. Jobs in a trace are sorted by submit, so [lo, hi) is also a
    contiguous time interval.
    """
    if not (0 <= lo < hi <= len(wl.submit)):
        raise ValueError(
            f"window [{lo}, {hi}) out of range for trace of {len(wl.submit)} jobs")
    submit = wl.submit[lo:hi]
    if rebase:
        submit = submit - wl.submit[lo]
    params = dataclasses.replace(
        wl.params, n_jobs=hi - lo,
        horizon=float(max(wl.submit[hi - 1] - wl.submit[lo], 1.0)))
    return Workload(submit=submit, runtime=wl.runtime[lo:hi],
                    nodes=wl.nodes[lo:hi], work=wl.work[lo:hi],
                    jtype=wl.jtype[lo:hi], params=params)


def iter_windows(wl: Workload, spec: WindowSpec
                 ) -> Iterator[tuple[int, int, Workload]]:
    """Yield (lo, hi, window) for every full window of a trace in order."""
    for lo, hi in window_bounds(len(wl.submit), spec):
        yield lo, hi, slice_window(wl, lo, hi, rebase=spec.rebase)


def iter_windows_batch(flows: Mapping[str, Workload], spec: WindowSpec
                       ) -> Iterator[tuple[str, int, int, Workload]]:
    """`iter_windows` over a name -> trace mapping (e.g. batch replicas)."""
    for name, wl in flows.items():
        for lo, hi, win in iter_windows(wl, spec):
            yield name, lo, hi, win


def _broadcast(value, n: int, name: str) -> list:
    if isinstance(value, (list, tuple, np.ndarray)):
        seq = list(value)
        if len(seq) != n:
            raise ValueError(
                f"{name} has {len(seq)} entries but the scenario has "
                f"{n} segments")
        return seq
    return [value] * n


def drift_workload(base: WorkloadParams,
                   *,
                   n_segments: int | None = None,
                   loads: float | Sequence[float] | None = None,
                   homogeneous: bool | Sequence[bool] | None = None,
                   homog_shrinks: float | Sequence[float] | None = None,
                   ) -> Workload:
    """A seed-stable trace whose statistics drift across segments.

    The trace is S back-to-back `generate_workload` segments, each with
    `base.n_jobs // S` jobs over `base.horizon / S` seconds; segment i
    uses seed ``base.seed + i`` and may override load / homogeneity /
    homog_shrink. Segment submit times are shifted onto a common clock
    (segment i occupies [i, i+1) * horizon/S — the generator pins each
    segment's arrivals to exactly its horizon, so the concatenation is
    nondecreasing). M (nodes) and n_types are fixed across segments, so
    every window of the result packs to the same shapes.

    Segment count comes from n_segments or the longest per-segment
    sequence; every sequence argument must match it.
    """
    seqs = [len(v) for v in (loads, homogeneous, homog_shrinks)
            if isinstance(v, (list, tuple, np.ndarray))]
    if n_segments is None:
        if not seqs:
            raise ValueError(
                "pass n_segments or at least one per-segment sequence")
        n_segments = max(seqs)
    if n_segments < 1:
        raise ValueError(f"n_segments must be >= 1, got {n_segments}")
    loads = _broadcast(base.load if loads is None else loads,
                       n_segments, "loads")
    homogeneous = _broadcast(
        base.homogeneous if homogeneous is None else homogeneous,
        n_segments, "homogeneous")
    homog_shrinks = _broadcast(
        base.homog_shrink if homog_shrinks is None else homog_shrinks,
        n_segments, "homog_shrinks")

    seg_jobs = base.n_jobs // n_segments
    if seg_jobs < 1:
        raise ValueError(
            f"n_jobs={base.n_jobs} too small for {n_segments} segments")
    seg_horizon = float(base.horizon) / n_segments

    parts = []
    for i in range(n_segments):
        params = dataclasses.replace(
            base, n_jobs=seg_jobs, horizon=seg_horizon,
            load=float(loads[i]), homogeneous=bool(homogeneous[i]),
            homog_shrink=float(homog_shrinks[i]), seed=base.seed + i)
        seg = generate_workload(params)
        parts.append(dataclasses.replace(seg, submit=seg.submit + i * seg_horizon))

    submit = np.concatenate([p.submit for p in parts])
    if np.any(np.diff(submit) < 0):  # pragma: no cover - segments are pinned
        raise AssertionError("drift segments produced non-monotone submits")
    out_params = dataclasses.replace(base, n_jobs=seg_jobs * n_segments)
    return Workload(
        submit=submit,
        runtime=np.concatenate([p.runtime for p in parts]),
        nodes=np.concatenate([p.nodes for p in parts]),
        work=np.concatenate([p.work for p in parts]),
        jtype=np.concatenate([p.jtype for p in parts]),
        params=out_params)


def drift_scenarios(n_jobs: int = 4000, nodes: int = 100, seed: int = 0,
                    n_segments: int = 8) -> dict[str, Workload]:
    """The canonical controller-study scenarios.

    ``steady`` is the zero-drift control (same segmented construction, so
    any regret it shows is window noise, not drift); the other four drift
    either arrival intensity (offered load) or job homogeneity, as a ramp
    or a step. All share M=nodes and n_types, so all windows of all
    scenarios pack to the same shapes.
    """
    base = WorkloadParams(n_jobs=n_jobs, nodes=nodes, load=0.90,
                          homogeneous=True, seed=seed, daily_amplitude=0.3)
    s = n_segments
    ramp = np.linspace(0.82, 0.96, s)
    shrink_ramp = np.linspace(0.15, 0.95, s)
    return {
        "steady": drift_workload(base, loads=[0.90] * s),
        "intensity_ramp": drift_workload(base, loads=ramp),
        "intensity_step": drift_workload(
            base, loads=[0.85] * (s // 2) + [0.95] * (s - s // 2)),
        "homogeneity_ramp": drift_workload(base, homog_shrinks=shrink_ramp),
        "homogeneity_step": drift_workload(
            base, homogeneous=[True] * (s // 2) + [False] * (s - s // 2)),
    }
