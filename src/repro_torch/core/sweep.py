"""The experiment grid of the paper as batched lane dispatches.

One workload's whole (scale ratio k x init proportion S) grid is flattened
into a lane axis of ``len(ks) * len(s_props)`` experiments (222 per
workload for the paper's grid) and driven through the lane-batched scan
engine (`repro_torch.core.des.simulate_packet_scan_lanes`) in one of two
dispatch layouts:

  * ``"chunked"`` — lanes sorted by *predicted event count* (monotone
    decreasing in k * s) and processed as a few equal-width dispatches.
    Lanes of similar event count retire together, so the engine's
    segmented early exit stops each chunk near its own step count.
  * ``"fused"``   — ONE dispatch over all lanes.

Both layouts give every lane the same result (a lane does not depend on
its dispatch companions), which the tests pin exactly. Three more layouts
run one part of the grid per call, as the reference's do:

  * ``"seq"``     — one cell per call. ``step_impl="torch"`` runs the
    while-loop engine (`simulate_packet`, one lane, with its default
    implementation: one launch of the while-loop kernel on the card, the
    plain lockstep version on the CPU), the reference's ``"xla"`` path;
    ``step_impl="cuda"`` runs one lane of the scan engine through the
    event-step kernel, the reference's ``"pallas"`` path. Under chaos
    every cell is one lane of the scan engine, whatever `step_impl`, as
    in the reference: only a shared engine makes seq, chunked and fused
    agree bitwise.
  * ``vmap_k=True`` / ``vmap_s=True`` (legacy) — one init-proportion
    column, or one scale-ratio row, per dispatch of the scan engine.

The chaos axis: a `ChaosConfig` whose fault parameters are C-long arrays
(`chaos_axis_len`) makes C lanes of every (k, s) cell (`chaos_lane_grid`:
grid-major, chaos-minor, lane ids the flat index in grid order, assigned
before any chunk sorting), and the grid's leaves ``[K, S, C]``.
`run_window_oracle` is one control tick of the streaming service: all
candidate k's (times the chaos axis) on one packed window.

The workload axis: `run_cohort_grid` runs the grids of a `WorkloadCohort`
(`repro_torch.core.cohort`) as ONE study, ``[W, L]`` lanes through the
scan engine's cohort dispatch (one launch per segment for all W * L lanes
on the card), each member's grid bitwise the one `run_packet_grid` gives
it. `run_baselines` runs the rigid FCFS and EASY-backfill baselines
(`repro_torch.core.schedulers`) over the init-proportion axis.

Over several cards: the fused layout (of the grid, the cohort study and
the window oracle) splits its lane axis over the ranks of the default
process group (`repro_torch.launch.multihost`), as the reference splits it
over every device (`sweep.py:532-556, 684-709`). The axis is padded with
`lane_padding` sentinel lanes that repeat the last lane (its chaos fields
and lane id too, so a sentinel replays that lane's streams), each rank
runs its contiguous block (`lane_sharding`, `cohort_lane_sharding`) on its
own card, the blocks are all-gathered and the sentinels sliced off: every
rank returns the whole grid, bitwise the one-rank fused grid, since a lane
does not depend on what shares its dispatch. Without a process group, or
in a group of one rank, nothing is split.
"""
from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import precision
from repro_torch.core.des import (ChaosConfig, DesResult, PackedWorkload,
                                  as_cohort, chaos_is_inert, member_workload,
                                  pack_workload, resolve_ring,
                                  simulate_packet, simulate_packet_scan,
                                  simulate_packet_scan_lanes)
from repro_torch.core.metrics import Metrics, efficiency_metrics
from repro_torch.core.schedulers import simulate_backfill, simulate_fcfs
from repro_torch.device import resolve_device
from repro_torch.kernels.packet_step.ops import (STEP_IMPLS,
                                                 resolve_step_impl)
from repro_torch.launch import multihost
from repro_torch.workload.lublin import Workload

# the paper's 37 scale-ratio values: 0.1..1 step .1, 1..10 step 1,
# 10..100 step 10, 100..1000 step 100
PAPER_SCALE_RATIOS: tuple[float, ...] = tuple(
    round(v, 1) for v in itertools.chain(
        (i / 10 for i in range(1, 10)),
        range(1, 10),
        range(10, 100, 10),
        range(100, 1001, 100)))
# 5% then 10%..50% step 10% (paper §6)
PAPER_INIT_PROPS: tuple[float, ...] = (0.05, 0.10, 0.20, 0.30, 0.40, 0.50)

assert len(PAPER_SCALE_RATIOS) == 37

SWEEP_MODES = ("auto", "seq", "chunked", "fused", "vmap_k", "vmap_s")
CHUNK_LANES = 64          # chunked-mode dispatch width
# Same-schedule float32 deviation ceiling for avg_wait over the full paper
# grid, from the reference's dtype study (10x the worst rounding-only
# deviation). The default absolute-slack scale in `plateau_threshold`.
FLOAT32_AVG_WAIT_RTOL = 0.031


_BUDGET_CELLS_SHOWN = 8    # exhausted cells named per message


def _format_budget_cells(bad: np.ndarray, ks=None, s_props=None,
                         axis_names=None) -> str:
    """Name the exhausted cells: indices along the metric axes
    ((i_k, i_s[, i_chaos]) for a grid, a flat lane index for an ``[L]``
    mask) plus the actual k / s_prop values when the caller's axes are
    known. `axis_names` overrides the axis labels (the window oracle's
    second axis is the chaos cell). Truncated after `_BUDGET_CELLS_SHOWN`
    entries."""
    if bad.ndim == 0:
        return "the single experiment"
    idx = np.argwhere(bad)
    if axis_names is not None:
        names = tuple(axis_names)[:bad.ndim]
    else:
        names = (("i_k", "i_s", "i_chaos")[:bad.ndim] if bad.ndim <= 3
                 else tuple(f"i{d}" for d in range(bad.ndim)))
    shown = []
    for cell in idx[:_BUDGET_CELLS_SHOWN]:
        cell = tuple(int(v) for v in cell)
        parts = ([f"lane={cell[0]}"] if bad.ndim == 1 else
                 [f"{n}={v}" for n, v in zip(names, cell)])
        if bad.ndim >= 2:
            if ks is not None and cell[0] < len(ks):
                parts.append(f"k={float(ks[cell[0]]):g}")
            if s_props is not None and cell[1] < len(s_props):
                parts.append(f"s_prop={float(s_props[cell[1]]):g}")
        shown.append("(" + ", ".join(parts) + ")")
    more = len(idx) - len(shown)
    return "; ".join(shown) + (f"; ... {more} more" if more > 0 else "")


def _enforce_budget(metrics, policy: str, label: str,
                    ks=None, s_props=None, axis_names=None):
    """raise / warn / ignore when any lane hit its event budget.

    A truncated lane means its schedule (and every metric) stops early, so
    the default is to raise. The message names the exhausted cells."""
    if policy not in ("raise", "warn", "ignore"):
        raise ValueError(f"on_budget_exhausted must be 'raise', 'warn' or "
                         f"'ignore', got {policy!r}")
    if policy == "ignore":
        return
    bad = np.asarray(metrics.budget_exhausted)
    n_bad = int(bad.sum())
    if n_bad:
        msg = (f"{label}: {n_bad} lane(s) exhausted the event budget at "
               f"[{_format_budget_cells(bad, ks, s_props, axis_names)}] — "
               f"schedules are truncated; raise max_requeues/budget or "
               f"pass on_budget_exhausted='ignore' to keep them")
        if policy == "raise":
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def predicted_lane_events(k_lanes, s_lanes) -> np.ndarray:
    """Relative event-count predictor used to sort lanes into chunks.

    The engine's step count is N + 2G where G is the number of groups
    formed, and G is monotone *decreasing* in both k and s, so the product
    k * s is a monotone proxy. Only the ORDER matters."""
    score = np.asarray(k_lanes, np.float64) * np.asarray(s_lanes, np.float64)
    return -score        # descending events == ascending k * s


def lane_order(k_lanes, s_lanes) -> np.ndarray:
    """Stable lane permutation: predicted-longest lanes first."""
    return np.argsort(-predicted_lane_events(k_lanes, s_lanes), kind="stable")


def lane_padding(n_lanes: int, n_devices: int | None = None) -> int:
    """Sentinel lanes needed to round n_lanes up to a device multiple
    (`n_devices` None: the process group's ranks)."""
    if n_devices is None:
        n_devices = multihost.device_count()
    return (-int(n_lanes)) % max(1, int(n_devices))


class LaneSharding(NamedTuple):
    """This rank's contiguous block of a lane axis of `n_lanes` split over
    `n_ranks` ranks: the split the reference's ``PartitionSpec("lane")``
    makes (`spec`; ``(None, "lane")`` for a cohort's ``[W, lanes]``, whose
    workload axis every rank keeps whole)."""
    n_lanes: int
    n_ranks: int
    rank: int
    spec: tuple

    @property
    def lanes(self) -> slice:
        block = -(-self.n_lanes // self.n_ranks)
        start = min(self.rank * block, self.n_lanes)
        return slice(start, min(start + block, self.n_lanes))


def _lane_split(n_lanes: int, pad: bool, spec: tuple):
    n = multihost.device_count()
    if n <= 1 or (not pad and int(n_lanes) % n != 0):
        return None
    return LaneSharding(int(n_lanes), n, multihost.process_index(), spec)


def lane_sharding(n_lanes: int, pad: bool = False):
    """The split of the experiment lane axis over the process group's
    ranks, or None: on one rank, and (by default) when the lane count does
    not divide the rank count. ``pad=True`` declares that the caller pads
    the lane axis with `lane_padding` sentinel lanes first, as the fused
    layout does, so that any lane count splits (the reference's
    contract, `sweep.py:371-390`)."""
    return _lane_split(n_lanes, pad, ("lane",))


def cohort_lane_sharding(n_lanes: int, pad: bool = False):
    """`lane_sharding` for a cohort's ``[W, lanes]`` batch: the lane axis
    split over the ranks, the workload axis whole on every rank, so that
    cohort and single-workload dispatches split alike."""
    return _lane_split(n_lanes, pad, (None, "lane"))


def resolve_mode(mode: str, n_lanes: int, n_workloads: int = 1,
                 step_impl: str | None = None) -> str:
    """Resolve mode='auto' to the concrete dispatch layout; validate others.

    ``"auto"`` is ``"fused"`` at every lane count: one warp runs one
    lane, so the paper's 222 lanes are 222 warps that a GPU runs side by
    side, and sorted chunks dispatched one after the other measured
    slower on an H100 (PERF.md, Findings). The reference's thresholds
    (`CHUNKED_MIN_LANES`, the device count) were measured for XLA on a
    CPU and are not carried over. `n_lanes` (lanes per workload) and
    `n_workloads` (a cohort's members, `run_cohort_grid`) are validated
    only; so is `step_impl` (None, or one of the event step's
    ``STEP_IMPLS``), taken fourth as the reference takes it, so that every
    caller rejects a typo up front. Unknown strings raise ValueError."""
    if mode not in SWEEP_MODES:
        raise ValueError(
            f"unknown sweep mode {mode!r}; available: {SWEEP_MODES}")
    if step_impl is not None and step_impl not in STEP_IMPLS:
        raise ValueError(f"unknown step_impl {step_impl!r}; "
                         f"available: {STEP_IMPLS}")
    if int(n_lanes) < 1:
        raise ValueError(f"a sweep needs at least one lane, got {n_lanes}")
    if int(n_workloads) < 1:
        raise ValueError(f"a sweep needs at least one workload, got "
                         f"{n_workloads}")
    return "fused" if mode == "auto" else mode


def sweep_plan(mode: str, n_lanes: int, n_workloads: int = 1,
               chaos: ChaosConfig | None = None,
               step_impl: str | None = None, *, dtype=np.float32,
               device=None) -> dict:
    """The resolve_mode decision plus its inputs, for provenance: which
    layout ran, which event-step implementation, on which device and in
    which dtype. The positional parameters are the reference's.
    ``n_workloads > 1`` describes a cohort study: the plan then reports the
    ``[W, lanes]`` layout `run_cohort_grid` runs. A `chaos` config (an
    inert one counts as none, as in the run_* functions) multiplies the lane
    axis by its length C and records the fault grid (seed, requeue bound,
    parameter values) in the reference's ``"chaos"`` block. ``n_devices``
    is the process group's ranks and ``lane_pad`` the sentinel lanes the
    fused layout adds to split over them, as the reference defines them
    (`sweep.py:466-467`)."""
    dev = resolve_device(device)
    if chaos_is_inert(chaos):
        chaos = None
    C = chaos_axis_len(chaos)
    n_lanes = int(n_lanes) * C
    W = int(n_workloads)
    resolved = resolve_mode(mode, n_lanes, W, step_impl)
    plan = {
        "requested_mode": mode,
        "mode": resolved,
        "step_impl": resolve_step_impl(step_impl, dev),
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "dtype": str(precision.canonical_dtype(dtype)),
        "n_lanes": n_lanes,
        "n_workloads": W,
        "total_experiments": W * n_lanes,
        "layout": [W, n_lanes],
        "n_devices": multihost.device_count(),
        "lane_pad": lane_padding(n_lanes) if resolved == "fused" else 0,
        "chunk_lanes": CHUNK_LANES if resolved == "chunked" else None,
    }
    if chaos is not None:
        plan["chaos"] = {
            "axis_len": C,
            "requeue_credit": "per-member",
            "seed": int(chaos.seed),
            "max_requeues": (None if chaos.max_requeues is None
                             else int(chaos.max_requeues)),
            **{f: np.asarray(getattr(chaos, f), np.float64).tolist()
               for f in CHAOS_AXIS_FIELDS}}
    return plan


#: the ChaosConfig fields that may carry a chaos lane axis
CHAOS_AXIS_FIELDS = ("mtbf_chip_hours", "ckpt_period", "straggler_prob",
                     "straggler_factor", "straggler_deadline")


def chaos_axis_len(chaos: ChaosConfig | None) -> int:
    """Length C of the chaos lane axis: 1 for a scalar ChaosConfig, else the
    shared leading dim of its array-valued fault parameters.

    Scalar/array mixes are legal (scalars broadcast over the axis), but
    every array-valued parameter must share ONE length and be 1-D; both
    violations raise here, naming the offending fields."""
    if chaos is None:
        return 1
    sizes: dict[str, int] = {}
    for name in CHAOS_AXIS_FIELDS:
        x = getattr(chaos, name)
        nd = np.ndim(x)
        if nd > 1:
            raise ValueError(
                f"ChaosConfig.{name} must be a scalar or a 1-D chaos axis, "
                f"got shape {np.shape(x)}")
        if nd:
            sizes[name] = int(np.shape(x)[0])
    arrays = {n: s for n, s in sizes.items() if s != 1}
    uniq = sorted(set(arrays.values()))
    if len(uniq) > 1:
        detail = ", ".join(f"{n}[{s}]" for n, s in sorted(arrays.items()))
        raise ValueError(
            f"ChaosConfig fault parameters have mismatched chaos-axis "
            f"lengths: {detail}; array-valued parameters must share one "
            f"leading length (scalars broadcast)")
    return uniq[0] if uniq else 1


_CHAOS_LANE_FIELDS = CHAOS_AXIS_FIELDS + ("lane",)


def chaos_lane_grid(chaos: ChaosConfig, n_grid: int, dtype) -> tuple:
    """Broadcast a ChaosConfig over the flat (k, s) lane axis.

    Returns ``(chaos_lanes, C)``: every fault parameter becomes an
    ``[n_grid * C]`` numpy array in the simulation dtype (grid-major,
    chaos-minor: cell i owns the C consecutive lanes from ``i * C``) and
    `lane` the flat lane index, assigned in GRID order before any chunk
    sorting, so a lane's stream is the same in every dispatch layout."""
    C = chaos_axis_len(chaos)
    np_dtype = precision.canonical_dtype(dtype)

    def tile(x):
        return np.tile(np.broadcast_to(np.asarray(x, np_dtype), (C,)),
                       n_grid)

    lanes = dataclasses.replace(
        chaos, **{f: tile(getattr(chaos, f)) for f in CHAOS_AXIS_FIELDS},
        lane=np.arange(n_grid * C, dtype=np.int32))
    return lanes, C


def _chaos_take(chaos_lanes: ChaosConfig | None, idx) -> ChaosConfig | None:
    """The lanes `idx` (an index array, or one index for the scalar
    ChaosConfig of one cell) of a `chaos_lane_grid` output."""
    if chaos_lanes is None:
        return None
    return dataclasses.replace(chaos_lanes, **{
        f: getattr(chaos_lanes, f)[idx] for f in _CHAOS_LANE_FIELDS})


def _lane_metric_tensors(spw, k_l2, s_l2, m_nodes, ring, step_impl,
                         device, chaos=None) -> Metrics:
    """One dispatch of ``[W, L]`` lanes over a stacked workload (W = 1 for
    one workload): engine + metrics, as tensors ``[W, L]`` on the
    engine's device. The metrics are taken member by member on ``[L]``
    lanes, the shapes a member's own dispatch gives them, so that no
    reduction's order depends on the cohort's width."""
    res = simulate_packet_scan_lanes(spw, k_l2, s_l2, m_nodes, ring=ring,
                                     chaos=chaos, step_impl=step_impl,
                                     device=device)
    rows = []
    for w in range(int(spw.submit.shape[0])):
        pw_w = member_workload(spw, w)
        rows.append(efficiency_metrics(
            pw_w.submit, DesResult(*(x[w] for x in res)), m_nodes,
            pw_w.t_last_submit))
    return Metrics(*(torch.stack(x) for x in zip(*rows)))


def _numpy(m: Metrics) -> Metrics:
    return Metrics(*(x.cpu().numpy() for x in m))


def _lane_metrics(spw, k_l2, s_l2, m_nodes, ring, step_impl, device,
                  chaos=None) -> Metrics:
    """`_lane_metric_tensors` as numpy leaves ``[W, L]``."""
    return _numpy(_lane_metric_tensors(spw, k_l2, s_l2, m_nodes, ring,
                                       step_impl, device, chaos))


def _gather_lanes(x: torch.Tensor, sharding: LaneSharding) -> torch.Tensor:
    """The ranks' ``[W, block]`` blocks of one metric, all-gathered into
    ``[W, n_lanes]`` on every rank (booleans travel as bytes)."""
    import torch.distributed as dist

    flag = x.dtype == torch.bool
    part = (x.to(torch.uint8) if flag else x).t().contiguous()   # [blk, W]
    out = part.new_empty((sharding.n_lanes,) + tuple(part.shape[1:]))
    dist.all_gather_into_tensor(out, part)
    out = out.t()
    return out.bool() if flag else out


def _run_lanes_fused(spw, k_l2, s_l2, m_nodes, ring, step_impl, device,
                     chaos_l=None) -> Metrics:
    """All ``[W, L]`` lanes in one dispatch; over several ranks the lane
    axis padded with sentinel lanes (the last lane repeated, its chaos
    fields and lane id too), each rank's block run on its card, the
    blocks all-gathered and the sentinels sliced off. Numpy leaves
    ``[W, L]``, the same on every rank."""
    L = int(k_l2.shape[1])
    pad = lane_padding(L)
    sharding = cohort_lane_sharding(L + pad, pad=True)
    if sharding is None:
        return _lane_metrics(spw, k_l2, s_l2, m_nodes, ring, step_impl,
                             device, chaos_l)
    lanes = np.concatenate([np.arange(L), np.full(pad, L - 1)])
    block = lanes[sharding.lanes]
    local = _lane_metric_tensors(spw, k_l2[:, block], s_l2[:, block],
                                 m_nodes, ring, step_impl, device,
                                 _chaos_take(chaos_l, block))
    return _numpy(Metrics(*(_gather_lanes(x, sharding)[:, :L]
                            for x in local)))


def _run_lane_chunks(spw, k_l2, s_l2, m_nodes, ring, chunk: int,
                     step_impl, device, chaos=None) -> Metrics:
    """Sorted equal-width ``[W, width]`` chunks through the engine, then
    unsort.

    The requested `chunk` width only sets the number of dispatches
    (ceil(L / chunk)); the actual width is balanced to ceil(L / n_chunks)
    (222 lanes at width 64 -> 4 dispatches of 56). The lane order is
    computed once, from the first member's (k, s) row (`lane_order`), and
    shared: the k grid is the same for every member and the init times
    differ only by a positive per-workload factor, so k * s sorts every
    row alike. The last chunk is padded to that width by repeating its
    last lane (its lane id and fault parameters too); the inverse
    permutation restores grid order."""
    L = int(k_l2.shape[1])
    n_chunks = max(1, -(-L // max(1, chunk)))
    width = -(-L // n_chunks)
    order = lane_order(k_l2[0], s_l2[0])
    chunks = []
    for c in range(0, L, width):
        idx = order[c:c + width]
        pad = width - len(idx)
        if pad:
            idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
        out = _lane_metrics(spw, k_l2[:, idx], s_l2[:, idx], m_nodes, ring,
                            step_impl, device, _chaos_take(chaos, idx))
        chunks.append(Metrics(*(x[:, :width - pad] for x in out)))
    gathered = Metrics(*(np.concatenate(x, axis=1) for x in zip(*chunks)))
    inv = np.empty_like(order)
    inv[order] = np.arange(L)
    return Metrics(*(x[:, inv] for x in gathered))


def _cell_metrics(pw, k, s, m_nodes, ring, step_impl, device, chaos=None):
    """One cell of mode='seq', as numpy leaves of shape []: the while
    engine for ``step_impl="torch"``, one scan-engine lane through the
    event-step kernel for ``"cuda"``. A cell under chaos is always one
    scan-engine lane (with `step_impl`'s step), the engine of the batched
    layouts, so that its draws and roundings are theirs exactly."""
    if step_impl == "torch" and chaos is None:
        res = simulate_packet(pw, k, s, m_nodes, ring=ring, device=device)
    else:
        res = simulate_packet_scan(pw, k, s, m_nodes, ring=ring,
                                   chaos=chaos, step_impl=step_impl,
                                   device=device)
    m = efficiency_metrics(pw.submit, res, m_nodes, pw.t_last_submit)
    return Metrics(*(x.cpu().numpy() for x in m))


def _stack(parts, axis: int) -> Metrics:
    return Metrics(*(np.stack(x, axis=axis) for x in zip(*parts)))


def _run_lanes(spw, k_l2, s_l2, m_nodes, ring, mode: str,
               chunk_lanes, step_impl, device, chaos_l) -> Metrics:
    """``[W, L]`` lanes over a stacked workload in one of the layouts seq
    / chunked / fused, as numpy leaves ``[W, L]``; `chaos_l` is None or a
    `chaos_lane_grid` output aligned with the L lanes of a member."""
    if mode == "seq":
        return _stack([_stack([_cell_metrics(
            member_workload(spw, w), k_l2[w, i], s_l2[w, i], m_nodes, ring,
            step_impl, device, _chaos_take(chaos_l, i))
            for i in range(k_l2.shape[1])], axis=0)
            for w in range(k_l2.shape[0])], axis=0)
    if mode == "chunked":
        return _run_lane_chunks(spw, k_l2, s_l2, m_nodes, ring,
                                max(1, int(chunk_lanes or CHUNK_LANES)),
                                step_impl, device, chaos_l)
    return _run_lanes_fused(spw, k_l2, s_l2, m_nodes, ring, step_impl,
                            device, chaos_l)


def run_packet_grid(wl: Workload,
                    ks: Sequence[float] = PAPER_SCALE_RATIOS,
                    s_props: Sequence[float] = PAPER_INIT_PROPS,
                    dtype=np.float32,
                    vmap_s: bool = False,
                    vmap_k: bool = False,
                    mode: str = "auto",
                    chunk_lanes: int | None = None,
                    chaos: ChaosConfig | None = None,
                    on_budget_exhausted: str = "raise",
                    step_impl: str | None = None,
                    device=None) -> Metrics:
    """Metrics over the (scale ratio x init proportion) grid of one workload.

    Returns a Metrics tuple of numpy arrays of shape
    ``[len(ks), len(s_props)]``, or ``[len(ks), len(s_props), C]`` when
    `chaos` carries a C-long fault-parameter axis (`chaos_axis_len`; an
    inert config runs the fault-free program). `device=None` runs on the
    CUDA card (and raises without one); ``device="cpu"`` runs the plain
    PyTorch versions on the CPU. `step_impl` is ``"cuda"`` | ``"torch"``
    (default by device). `mode` is one of SWEEP_MODES (see the module
    docstring); the legacy ``vmap_k=True`` / ``vmap_s=True`` flags select
    the column and row layouts and exclude each other, `mode` and
    `chaos`, as in the reference. `on_budget_exhausted` ("raise" | "warn"
    | "ignore") governs lanes whose schedules were truncated by the event
    budget. `chunk_lanes` overrides the chunked-mode dispatch width.
    """
    if vmap_k and vmap_s:
        raise ValueError("vmap_k=True and vmap_s=True are mutually "
                         "exclusive batching layouts; pass at most one "
                         "(or use mode='fused' for the full lane axis)")
    if (vmap_k or vmap_s) and mode != "auto":
        raise ValueError("pass either mode= or the legacy vmap_k/vmap_s "
                         "flags, not both")
    if chaos is not None and (vmap_k or vmap_s):
        raise ValueError("chaos sweeps have no vmap_k/vmap_s layout; use "
                         "mode='seq'/'chunked'/'fused'")
    if chaos_is_inert(chaos):
        chaos = None        # zero-rate config: the fault-free program
    K, S = len(ks), len(s_props)
    C = chaos_axis_len(chaos)
    mode = ("vmap_k" if vmap_k else "vmap_s" if vmap_s
            else resolve_mode(mode, K * S * C, 1, step_impl))
    dev = resolve_device(device)
    step_impl = resolve_step_impl(step_impl, dev)
    np_dtype = precision.canonical_dtype(dtype)

    spw = as_cohort(pack_workload(wl, np_dtype, dev))
    m_nodes = int(wl.params.nodes)
    ring = resolve_ring(m_nodes, spw.n_jobs)
    s_vals = np.asarray([wl.init_time_for_proportion(p) for p in s_props],
                        np_dtype)
    ks_arr = np.asarray(ks, np_dtype)
    if mode == "vmap_k":        # one init-proportion column per dispatch
        out = _stack([_lane_metrics(spw, ks_arr[None],
                                    np.full((1, K), s, np_dtype), m_nodes,
                                    ring, step_impl, dev)
                      for s in s_vals], axis=2)
    elif mode == "vmap_s":      # one scale-ratio row per dispatch
        out = _stack([_lane_metrics(spw, np.full((1, S), k, np_dtype),
                                    s_vals[None], m_nodes, ring, step_impl,
                                    dev)
                      for k in ks_arr], axis=1)
    else:
        chaos_l = (None if chaos is None
                   else chaos_lane_grid(chaos, K * S, np_dtype)[0])
        out = _run_lanes(spw, np.repeat(ks_arr, S * C)[None],
                         np.repeat(np.tile(s_vals, K), C)[None], m_nodes,
                         ring, mode, chunk_lanes, step_impl, dev, chaos_l)
    shape = (K, S) if C == 1 else (K, S, C)
    out = Metrics(*(x[0].reshape(shape) for x in out))
    _enforce_budget(out, on_budget_exhausted, "run_packet_grid", ks, s_props)
    return out


# --------------------------------------------------------------------------
# The workload axis (repro_torch.core.cohort).
# --------------------------------------------------------------------------

def run_cohort_grid(cohort, ks: Sequence[float] = PAPER_SCALE_RATIOS,
                    s_props: Sequence[float] = PAPER_INIT_PROPS,
                    mode: str = "auto",
                    chunk_lanes: int | None = None,
                    chaos: ChaosConfig | None = None,
                    on_budget_exhausted: str = "raise",
                    step_impl: str | None = None,
                    device=None) -> dict:
    """Per-workload ``[K, S]`` Metrics for every member of a
    `WorkloadCohort`, computed as ONE batched study over the stacked
    workload axis.

    Returns ``{name: Metrics}`` of numpy leaves ``[len(ks), len(s_props)]``
    (``[K, S, C]`` when `chaos` carries a C-long fault axis), each equal,
    bit for bit, to ``run_packet_grid(wl, ks, s_props, dtype=cohort.dtype,
    mode=mode)``: a lane does not depend on what shares its dispatch. The
    chaos lane ids are assigned per grid cell, not per member, so every
    member draws the same streams (common random numbers).

    Modes: ``"fused"`` (``"auto"``) is one cohort dispatch of all W * L
    lanes; ``"chunked"`` runs sorted ``[W, width]`` chunks of them;
    ``"seq"`` delegates to ``run_packet_grid(mode="seq")`` member by member
    (with ``step_impl="torch"`` and no chaos, the while-loop engine: one
    launch of its kernel a cell on the card); the legacy vmap layouts have
    no cohort form and raise. Init proportions are converted per member
    (s depends on each workload's mean runtime), so the ``[W, S]`` init
    times differ across the workload axis. `device`, `step_impl` and
    `on_budget_exhausted` as in `run_packet_grid`; a budget-exhausted lane
    is reported under its member's name.
    """
    if chaos_is_inert(chaos):
        chaos = None        # zero-rate config: the fault-free program
    K, S = len(ks), len(s_props)
    W = cohort.n_workloads
    C = chaos_axis_len(chaos)
    resolved = resolve_mode(mode, K * S * C, W, step_impl)
    if resolved in ("vmap_k", "vmap_s"):
        raise ValueError(
            f"mode {resolved!r} has no cohort layout; use run_packet_grid "
            f"per workload for the legacy column/row batchings")
    if resolved == "seq":
        return {name: run_packet_grid(wl, ks, s_props, dtype=cohort.dtype,
                                      mode="seq", chaos=chaos,
                                      on_budget_exhausted=on_budget_exhausted,
                                      step_impl=step_impl, device=device)
                for name, wl in zip(cohort.names, cohort.workloads)}

    dev = resolve_device(device)
    step_impl = resolve_step_impl(step_impl, dev)
    np_dtype = cohort.dtype
    spw = cohort.pack(dev)
    m_nodes, ring = cohort.m_nodes, cohort.ring
    ks_arr = np.asarray(ks, np_dtype)
    s_mat = np.stack([np.asarray([wl.init_time_for_proportion(p)
                                  for p in s_props], np_dtype)
                      for wl in cohort.workloads])                  # [W, S]
    k_l2 = np.broadcast_to(np.repeat(ks_arr, S * C), (W, K * S * C))
    s_l2 = np.repeat(np.tile(s_mat, (1, K)), C, axis=1)
    chaos_l = (None if chaos is None
               else chaos_lane_grid(chaos, K * S, np_dtype)[0])
    lanes = _run_lanes(spw, k_l2, s_l2, m_nodes, ring, resolved,
                       chunk_lanes, step_impl, dev, chaos_l)
    shape = (K, S) if C == 1 else (K, S, C)
    out = {name: Metrics(*(x[w].reshape(shape) for x in lanes))
           for w, name in enumerate(cohort.names)}
    for name, m in out.items():
        _enforce_budget(m, on_budget_exhausted, f"run_cohort_grid[{name}]",
                        ks, s_props)
    return out


def run_window_oracle(pw: PackedWorkload,
                      ks: Sequence[float],
                      s_init: float,
                      m_nodes: int,
                      ring: int | None = None,
                      mode: str = "auto",
                      chunk_lanes: int | None = None,
                      chaos: ChaosConfig | None = None,
                      on_budget_exhausted: str = "raise",
                      step_impl: str | None = None,
                      device=None) -> Metrics:
    """One control tick of the streaming service: all candidate scale
    ratios on a pre-packed workload window, as one batched lane dispatch.

    `run_packet_grid` re-cut for the monitor -> decide -> actuate loop of
    `repro_torch.service`: the caller packs the window (`pack_workload`
    on a `slice_window` output, on `device`) and passes ONE init time
    `s_init` in seconds, so the returned leaves are ``[len(ks)]``, the
    tick's tuning curve. A `chaos` config with a C-long fault axis
    expands the tick to ``K * C`` lanes and the leaves to
    ``[len(ks), C]``, with the lane ids `chaos_lane_grid` gives (k-major,
    chaos-minor), exactly those of ``run_packet_grid(ks, s_props=[s],
    chaos=...)``: the block is bitwise that grid's ``[:, 0, :]``. An
    inert config runs the fault-free program; a scalar active one keeps
    ``[K]`` leaves. The dtype is the packed window's. Modes as in
    `run_packet_grid` minus the vmap layouts (``"auto"`` is ``"fused"``).
    """
    K = len(ks)
    if K < 1:
        raise ValueError("run_window_oracle needs at least one candidate k")
    if chaos_is_inert(chaos):
        chaos = None        # zero-rate config: the fault-free program
    C = chaos_axis_len(chaos)
    resolved = resolve_mode(mode, K * C, 1, step_impl)
    if resolved in ("vmap_k", "vmap_s"):
        raise ValueError(
            f"mode={resolved!r} is a grid layout; the window oracle has a "
            "single lane axis — use 'auto', 'seq', 'chunked' or 'fused'")
    dev = resolve_device(device)
    step_impl = resolve_step_impl(step_impl, dev)
    np_dtype = precision.canonical_dtype(pw.submit.dtype)
    m_nodes = int(m_nodes)
    ring = resolve_ring(m_nodes, pw.n_jobs) if ring is None else int(ring)
    chaos_l = (None if chaos is None
               else chaos_lane_grid(chaos, K, np_dtype)[0])
    lanes = _run_lanes(as_cohort(pw), np.repeat(np.asarray(ks, np_dtype),
                                                C)[None],
                       np.full((1, K * C), s_init, np_dtype), m_nodes, ring,
                       resolved, chunk_lanes, step_impl, dev, chaos_l)
    shape = (K,) if C == 1 else (K, C)
    out = Metrics(*(x[0].reshape(shape) for x in lanes))
    _enforce_budget(out, on_budget_exhausted, "run_window_oracle", ks,
                    axis_names=("i_k", "i_chaos"))
    return out


def run_baselines(wl: Workload, s_props: Sequence[float] = PAPER_INIT_PROPS,
                  dtype=np.float32, device=None) -> dict[str, Metrics]:
    """FCFS and EASY-backfill metrics per init proportion (rigid jobs).

    Returns ``{"backfill": Metrics, "fcfs": Metrics}`` (the reference's
    key order) of numpy leaves ``[len(s_props)]`` in `dtype`. Each policy
    runs all init proportions
    as one lane dispatch (`repro_torch.core.schedulers`): on the card one
    launch of the baselines kernel a policy, on the CPU (``device="cpu"``)
    its plain version.
    """
    dev = resolve_device(device)
    np_dtype = precision.canonical_dtype(dtype)
    pw = pack_workload(wl, np_dtype, dev)
    m_nodes = int(wl.params.nodes)
    s_vals = np.asarray([wl.init_time_for_proportion(p) for p in s_props],
                        np_dtype)
    out = {}
    for name, simulate in (("backfill", simulate_backfill),
                           ("fcfs", simulate_fcfs)):
        res = simulate(pw, s_vals, m_nodes)
        m = efficiency_metrics(pw.submit, res, m_nodes, pw.t_last_submit)
        out[name] = Metrics(*(x.cpu().numpy() for x in m))
    return out


class PlateauResult(NamedTuple):
    """`plateau_threshold` output: the tuned scale ratio AND the plateau
    level it converged to."""
    threshold: float    # smallest k after which avg_wait stays near plateau
    plateau: float      # the large-k plateau value (median of the tail)


def plateau_threshold(ks, avg_wait, rel_tol: float = 0.05,
                      abs_tol: float | None = None,
                      plateau_tail: int = 5) -> PlateauResult:
    """The paper's actionable output: the smallest scale ratio after which
    the average queue time stays within tolerance of its large-k plateau.

    `ks` need not arrive sorted — both arrays are sorted together by k;
    mismatched or empty inputs raise. The tolerance band is
    ``rel_tol * max(plateau, 1) + abs_tol`` where `abs_tol` defaults to
    ``FLOAT32_AVG_WAIT_RTOL * max(plateau, 1)``.
    """
    ks = np.atleast_1d(np.asarray(ks, np.float64))
    w = np.atleast_1d(np.asarray(avg_wait, np.float64))
    if ks.ndim != 1 or ks.shape != w.shape:
        raise ValueError(f"ks and avg_wait must be equal-length 1-D arrays, "
                         f"got shapes {ks.shape} and {w.shape}")
    if ks.size == 0:
        raise ValueError("plateau_threshold needs at least one scale ratio")
    order = np.argsort(ks, kind="stable")
    ks, w = ks[order], w[order]
    tail = max(1, min(int(plateau_tail), len(w)))
    plateau = float(np.median(w[-tail:]))
    ref = max(plateau, 1e-9)
    if abs_tol is None:
        abs_tol = FLOAT32_AVG_WAIT_RTOL * max(ref, 1.0)
    good = np.abs(w - plateau) <= rel_tol * max(ref, 1.0) + abs_tol
    # find first index from which all subsequent are good
    for i in range(len(ks)):
        if good[i:].all():
            return PlateauResult(float(ks[i]), plateau)
    return PlateauResult(float(ks[-1]), plateau)
