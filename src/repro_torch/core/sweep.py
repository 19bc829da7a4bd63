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
    event-step kernel, the reference's ``"pallas"`` path.
  * ``vmap_k=True`` / ``vmap_s=True`` (legacy) — one init-proportion
    column, or one scale-ratio row, per dispatch of the scan engine.

Not ported yet, and raising `NotImplementedError` rather than running
something else: a non-inert `chaos` operand of `run_packet_grid` (the
chaos axis needs a uniform-stream generator); see ROADMAP.md, Queue 1.
"""
from __future__ import annotations

import itertools
import warnings
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import precision
from repro_torch.core.des import (ChaosConfig, chaos_is_inert, pack_workload,
                                  resolve_ring, simulate_packet,
                                  simulate_packet_scan,
                                  simulate_packet_scan_lanes)
from repro_torch.core.metrics import Metrics, efficiency_metrics
from repro_torch.device import resolve_device
from repro_torch.kernels.packet_step.ops import resolve_step_impl
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


def _format_budget_cells(bad: np.ndarray, ks=None, s_props=None) -> str:
    """Name the exhausted cells: (i_k, i_s) grid indices for a ``[K, S]``
    mask, a flat lane index for a ``[L]`` one, plus the actual k / s_prop
    values when the caller's axes are known. Truncated after
    `_BUDGET_CELLS_SHOWN` entries."""
    shown = []
    idx = np.argwhere(bad)
    for cell in idx[:_BUDGET_CELLS_SHOWN]:
        cell = tuple(int(v) for v in cell)
        if bad.ndim == 1:
            parts = [f"lane={cell[0]}"]
        else:
            parts = [f"{n}={v}" for n, v in zip(("i_k", "i_s"), cell)]
            if ks is not None:
                parts.append(f"k={float(ks[cell[0]]):g}")
            if s_props is not None:
                parts.append(f"s_prop={float(s_props[cell[1]]):g}")
        shown.append("(" + ", ".join(parts) + ")")
    more = len(idx) - len(shown)
    return "; ".join(shown) + (f"; ... {more} more" if more > 0 else "")


def _enforce_budget(metrics, policy: str, label: str,
                    ks=None, s_props=None):
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
               f"[{_format_budget_cells(bad, ks, s_props)}] — schedules "
               f"are truncated; raise the budget or pass "
               f"on_budget_exhausted='ignore' to keep them")
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


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, Queue 1: "
        f"{item}); no other layout is substituted for it")


def resolve_mode(mode: str, n_lanes: int) -> str:
    """Resolve mode='auto' to the concrete dispatch layout; validate others.

    ``"auto"`` is ``"fused"`` at every lane count: one warp runs one
    lane, so the paper's 222 lanes are 222 warps that a GPU runs side by
    side, and sorted chunks dispatched one after the other measured
    slower on an H100 (PERF.md, Findings). The reference's thresholds
    (`CHUNKED_MIN_LANES`, the device count) were measured for XLA on a
    CPU and are not carried over. `n_lanes` is validated only. Unknown
    strings raise ValueError."""
    if mode not in SWEEP_MODES:
        raise ValueError(
            f"unknown sweep mode {mode!r}; available: {SWEEP_MODES}")
    if int(n_lanes) < 1:
        raise ValueError(f"a sweep needs at least one lane, got {n_lanes}")
    return "fused" if mode == "auto" else mode


def sweep_plan(mode: str, n_lanes: int, dtype=np.float32,
               step_impl: str | None = None, device=None) -> dict:
    """The resolve_mode decision plus its inputs, for provenance: which
    layout ran, which event-step implementation, on which device and in
    which dtype."""
    dev = resolve_device(device)
    resolved = resolve_mode(mode, int(n_lanes))
    return {
        "requested_mode": mode,
        "mode": resolved,
        "step_impl": resolve_step_impl(step_impl, dev),
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "dtype": str(precision.canonical_dtype(dtype)),
        "n_lanes": int(n_lanes),
        "chunk_lanes": CHUNK_LANES if resolved == "chunked" else None,
    }


def _lane_metrics(pw, k_lanes, s_lanes, m_nodes, ring, step_impl, device):
    """One dispatch: engine + metrics, returned as numpy leaves [L]."""
    res = simulate_packet_scan_lanes(pw, k_lanes, s_lanes, m_nodes,
                                     ring=ring, step_impl=step_impl,
                                     device=device)
    m = efficiency_metrics(pw.submit, res, m_nodes, pw.t_last_submit)
    return Metrics(*(x.cpu().numpy() for x in m))


def _run_lane_chunks(pw, k_lanes, s_lanes, m_nodes, ring, chunk: int,
                     step_impl, device) -> Metrics:
    """Sorted equal-width chunks through the engine, then unsort.

    The requested `chunk` width only sets the number of dispatches
    (ceil(L / chunk)); the actual width is balanced to ceil(L / n_chunks)
    (222 lanes at width 64 -> 4 dispatches of 56). The last chunk is
    padded to that width by repeating its last lane; the inverse
    permutation restores grid order."""
    L = int(k_lanes.shape[0])
    n_chunks = max(1, -(-L // max(1, chunk)))
    width = -(-L // n_chunks)
    order = lane_order(k_lanes, s_lanes)
    chunks = []
    for c in range(0, L, width):
        idx = order[c:c + width]
        pad = width - len(idx)
        if pad:
            idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
        out = _lane_metrics(pw, k_lanes[idx], s_lanes[idx], m_nodes, ring,
                            step_impl, device)
        chunks.append(Metrics(*(x[:width - pad] for x in out)))
    gathered = Metrics(*(np.concatenate(x, axis=0) for x in zip(*chunks)))
    inv = np.empty_like(order)
    inv[order] = np.arange(L)
    return Metrics(*(x[inv] for x in gathered))


def _cell_metrics(pw, k, s, m_nodes, ring, step_impl, device):
    """One cell of mode='seq', as numpy leaves of shape []: the while
    engine for ``step_impl="torch"``, one scan-engine lane through the
    event-step kernel for ``"cuda"``."""
    if step_impl == "torch":
        res = simulate_packet(pw, k, s, m_nodes, ring=ring, device=device)
    else:
        res = simulate_packet_scan(pw, k, s, m_nodes, ring=ring,
                                   step_impl=step_impl, device=device)
    m = efficiency_metrics(pw.submit, res, m_nodes, pw.t_last_submit)
    return Metrics(*(x.cpu().numpy() for x in m))


def _stack(parts, axis: int) -> Metrics:
    return Metrics(*(np.stack(x, axis=axis) for x in zip(*parts)))


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
    ``[len(ks), len(s_props)]``. `device=None` runs on the CUDA card (and
    raises without one); ``device="cpu"`` runs the plain PyTorch versions
    on the CPU. `step_impl` is ``"cuda"`` | ``"torch"`` (default by
    device). `mode` is one of SWEEP_MODES (see the module docstring); the
    legacy ``vmap_k=True`` / ``vmap_s=True`` flags select the column and
    row layouts and exclude each other, `mode` and `chaos`, as in the
    reference. `on_budget_exhausted` ("raise" | "warn" | "ignore") governs
    lanes whose schedules were truncated by the event budget.
    `chunk_lanes` overrides the chunked-mode dispatch width.

    A non-inert `chaos` raises NotImplementedError (no fault grid yet).
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
    if not chaos_is_inert(chaos):
        raise _not_ported(
            "a non-inert chaos operand of run_packet_grid",
            "chaos axis of `run_packet_grid` with a threefry generator")
    K, S = len(ks), len(s_props)
    mode = ("vmap_k" if vmap_k else "vmap_s" if vmap_s
            else resolve_mode(mode, K * S))
    dev = resolve_device(device)
    step_impl = resolve_step_impl(step_impl, dev)
    np_dtype = precision.canonical_dtype(dtype)

    pw = pack_workload(wl, np_dtype, dev)
    m_nodes = int(wl.params.nodes)
    ring = resolve_ring(m_nodes, pw.n_jobs)
    s_vals = np.asarray([wl.init_time_for_proportion(p) for p in s_props],
                        np_dtype)
    ks_arr = np.asarray(ks, np_dtype)
    if mode == "seq":
        cells = _stack([_cell_metrics(pw, k, s, m_nodes, ring, step_impl,
                                      dev)
                        for k in ks_arr for s in s_vals], axis=0)
        out = Metrics(*(x.reshape((K, S) + x.shape[1:]) for x in cells))
    elif mode == "vmap_k":      # one init-proportion column per dispatch
        out = _stack([_lane_metrics(pw, ks_arr, np.full(K, s, np_dtype),
                                    m_nodes, ring, step_impl, dev)
                      for s in s_vals], axis=1)
    elif mode == "vmap_s":      # one scale-ratio row per dispatch
        out = _stack([_lane_metrics(pw, np.full(S, k, np_dtype), s_vals,
                                    m_nodes, ring, step_impl, dev)
                      for k in ks_arr], axis=0)
    else:
        k_lanes = np.repeat(ks_arr, S)
        s_lanes = np.tile(s_vals, K)
        if mode == "chunked":
            lanes = _run_lane_chunks(pw, k_lanes, s_lanes, m_nodes, ring,
                                     max(1, int(chunk_lanes or CHUNK_LANES)),
                                     step_impl, dev)
        else:                   # fused
            lanes = _lane_metrics(pw, k_lanes, s_lanes, m_nodes, ring,
                                  step_impl, dev)
        out = Metrics(*(x.reshape((K, S) + x.shape[1:]) for x in lanes))
    _enforce_budget(out, on_budget_exhausted, "run_packet_grid", ks, s_props)
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
