"""Lane-batched discrete-event simulator of the Packet algorithm, PyTorch.

Counterpart of `repro.core.des` for the batched-lane scan engine
(`simulate_packet_scan_lanes`): every lane is one (scale ratio k, init time
s) experiment over the same packed workload. State is carried as
``[state, T]`` columns with the lanes on the minor axis (scalars as
``[1, T]``, per-type rows as ``[H, T]``, ring rows as ``[ring, T]``), the
layout of the reference's event-step kernel, so neighbouring GPU threads
touch neighbouring addresses.

The engine on a GPU
-------------------
A host loop runs at most ``n_segs = budget / seg`` segments and stops when
no lane is active. Each segment is ONE call of
`repro_torch.kernels.packet_step.ops.packet_event_steps`, which advances
every lane by `seg` events and writes `seg` rows of the four
``[budget, T]`` group-log buffers; on a CUDA tensor that is one launch of
the hand-written kernel with the event loop inside it. The host reads one
boolean per segment. Extra segments past a lane's drain point are masked
no-ops, so a lane's result does not depend on its companions.

Why the simulation vectorizes, the group log and the chaos (fault
injection) semantics are documented in `repro.core.des`; the arithmetic
here keeps that module's order of operations so schedules and integer
counters agree exactly.

Chaos operands
--------------
The reference draws its per-lane uniform streams from `jax.random`
(threefry), which torch cannot reproduce. The engine therefore takes the
streams as operands: ``u1`` (straggler draw) and ``u2`` (failure draw) of
shape ``[L_cap, T]`` with ``L_cap = N + R``, row g being consumed by the
g-th group formed in a lane.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import precision
from repro_torch.device import resolve_device
from repro_torch.workload.lublin import Workload

INF = float("inf")
CREDIT_EPS = 1e-9    # "fully credited" threshold of the requeue credit walk
KEY_PAD = int(np.iinfo(np.int32).max)   # log key of a step that forms no group


def resolve_ring(m_nodes, n_jobs: int, ring: int | None = None) -> int:
    """Ring size for the running-group buffer: every running group holds at
    least one node, so at most ``min(M, N)`` run concurrently."""
    if ring is not None:
        return max(1, int(ring))
    m = int(m_nodes)
    return max(1, min(m, n_jobs if n_jobs else m))


class PackedWorkload(NamedTuple):
    """Device-resident, per-type-indexed form of a Workload.

    H = n_types, N = n_jobs. Per-type tables are rank-indexed (rank r =
    r-th job of that type in submit order), padded with +inf / 0.
    """
    submit: torch.Tensor      # [N]  global submit order
    work: torch.Tensor        # [N]  w_i = e_i * n_i
    jtype: torch.Tensor       # [N]  int32
    rank: torch.Tensor        # [N]  int32 rank of job i within its type
    cumw: torch.Tensor        # [N]  per-type prefix work *before* job i
    nodes: torch.Tensor       # [N]  int32 rigid node request (baselines)
    runtime: torch.Tensor     # [N]  e_i on n_i nodes (baselines)
    tj_submit: torch.Tensor   # [H, N]   submit of type j's rank-r job
    tj_prefw: torch.Tensor    # [H, N+1] prefix sums of work per type
    t_last_submit: torch.Tensor  # 0-d: metric window end (paper §3)
    n_types: int
    n_jobs: int


_PW_FLOAT_FIELDS = ("submit", "work", "cumw", "runtime", "tj_submit",
                    "tj_prefw", "t_last_submit")
_PW_INT_FIELDS = ("jtype", "rank", "nodes")


def packed_from_numpy(fields: dict, device) -> PackedWorkload:
    """Build a PackedWorkload from the reference `PackedWorkload`'s fields
    given as numpy arrays (plus `n_types`, `n_jobs`), on `device`.

    The float dtype is taken from ``fields["submit"]``. This system has no
    weights; carrying packed tables and scan state across is its
    counterpart, and the parity tests use it so both sides start equal.
    """
    dev = resolve_device(device)
    np_dtype = precision.canonical_dtype(np.asarray(fields["submit"]).dtype)
    tdt = precision.torch_dtype(np_dtype)
    out = {}
    for name in _PW_FLOAT_FIELDS:
        out[name] = torch.tensor(np.asarray(fields[name], np_dtype),
                                 dtype=tdt, device=dev)
    for name in _PW_INT_FIELDS:
        out[name] = torch.tensor(np.asarray(fields[name], np.int32),
                                 dtype=torch.int32, device=dev)
    return PackedWorkload(n_types=int(fields["n_types"]),
                          n_jobs=int(fields["n_jobs"]), **out)


def pack_workload(wl: Workload, dtype=np.float32,
                  device=None) -> PackedWorkload:
    """Build the per-type-indexed tables with numpy segment prefix sums and
    place them on `device` (None = the CUDA card).

    A stable sort by type turns each type into one contiguous segment, so
    per-type ranks and prefix work are plain offset arithmetic on one
    global cumsum. `dtype` selects the simulation precision for every
    float table and, through them, every downstream accumulator.
    """
    dev = resolve_device(device)
    np_dtype = precision.canonical_dtype(dtype)
    H, N = wl.params.n_types, wl.n_jobs
    jt = np.asarray(wl.jtype, np.int64)
    w = np.asarray(wl.work, np.float64)
    submit = np.asarray(wl.submit, np.float64)

    order = np.argsort(jt, kind="stable")
    jt_s = jt[order]
    w_s = w[order]
    counts = np.bincount(jt, minlength=H)
    seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(N)
    rank_s = pos - seg_start[jt_s]                      # rank within type
    cum = np.concatenate([[0.0], np.cumsum(w_s)])
    cumw_s = cum[pos] - cum[seg_start[jt_s]]            # prefix work in type

    rank = np.zeros(N, np.int32)
    cumw = np.zeros(N, np.float64)
    rank[order] = rank_s.astype(np.int32)
    cumw[order] = cumw_s

    tj_submit = np.full((H, N), np.inf)
    tj_submit[jt_s, rank_s] = submit[order]
    tj_prefw = np.zeros((H, N + 1), np.float64)
    tj_prefw[jt_s, rank_s + 1] = cumw_s + w_s
    # extend prefix sums into the padding so prefw[tail] is always valid
    # (work >= 0 makes each row nondecreasing, so a running max fills pads)
    tj_prefw = np.maximum.accumulate(tj_prefw, axis=1)

    return packed_from_numpy(dict(
        submit=np.asarray(wl.submit).astype(np_dtype),
        work=np.asarray(wl.work).astype(np_dtype),
        jtype=wl.jtype, rank=rank, cumw=cumw.astype(np_dtype),
        nodes=wl.nodes, runtime=np.asarray(wl.runtime).astype(np_dtype),
        tj_submit=tj_submit.astype(np_dtype),
        tj_prefw=tj_prefw.astype(np_dtype),
        t_last_submit=np.asarray(wl.submit[-1]).astype(np_dtype),
        n_types=H, n_jobs=N), dev)


# --------------------------------------------------------------------------
# Chaos: fault-injection parameters and per-group outcome.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Fault-injection operand of the engine (see `repro.core.des`).

    The five fault parameters are scalars or ``[T]`` lane arrays. `lane`
    and `seed` identify the reference's per-lane uniform stream and are
    carried for provenance only: this engine takes the streams as the
    operands ``u1``/``u2``. ``max_requeues=None`` resolves to the job
    count N at simulation time.
    """
    mtbf_chip_hours: object = 0.0     # 0 = no failures
    ckpt_period: object = 300.0
    straggler_prob: object = 0.0
    straggler_factor: object = 1.5
    straggler_deadline: object = 2.0
    lane: object = 0
    seed: int = 0
    max_requeues: int | None = None


def resolve_max_requeues(chaos: ChaosConfig | None, n_jobs: int) -> int:
    """Static requeue-injection budget R: 0 without chaos, N by default."""
    if chaos is None:
        return 0
    if chaos.max_requeues is None:
        return max(1, int(n_jobs))
    return max(0, int(chaos.max_requeues))


def chaos_is_inert(chaos: ChaosConfig | None) -> bool:
    """True when `chaos` cannot inject any fault: None, or all-zero failure
    and straggler rates (e.g. the default ChaosConfig())."""
    if chaos is None:
        return True
    mtbf = np.asarray(chaos.mtbf_chip_hours)
    prob = np.asarray(chaos.straggler_prob)
    return bool(np.all(mtbf == 0) and np.all(prob == 0))


class ChaosParams(NamedTuple):
    """The five fault parameters as tensors broadcastable over lanes."""
    mtbf_chip_hours: torch.Tensor
    ckpt_period: torch.Tensor
    straggler_prob: torch.Tensor
    straggler_factor: torch.Tensor
    straggler_deadline: torch.Tensor


class _ChaosOutcome(NamedTuple):
    dur: torch.Tensor        # effective duration (stretch/kill applied)
    failed: torch.Tensor     # failure strikes before the (effective) end
    killed: torch.Tensor     # straggler deadline kill (failure wins ties)
    ckpt_done: torch.Tensor  # checkpointed run seconds at failure time
    credit: torch.Tensor     # work credited toward completion
    lost: torch.Tensor       # chip-seconds lost past the last checkpoint


def _chaos_outcome(chaos: ChaosParams, u1, u2, inject, s, work, m_grp,
                   dur0) -> _ChaosOutcome:
    """Per-group fault outcome; every branch is a `torch.where` whose
    no-fault value is the exact fault-free expression. Precedence: a
    failure before the effective end wins over a deadline kill, which wins
    over plain completion."""
    dtype = work.dtype
    m_f = m_grp.to(dtype)
    tiny = float(torch.finfo(dtype).tiny)
    prob, factor = chaos.straggler_prob, chaos.straggler_factor
    s_dead, mtbf, ckpt = (chaos.straggler_deadline, chaos.mtbf_chip_hours,
                          chaos.ckpt_period)

    stretched = inject & (u1 < prob)
    dur_s = torch.where(stretched, s + (work / m_f) * factor, dur0)
    deadline = s_dead * dur0                     # x expected duration
    killed = inject & (dur_s > deadline)
    dur = torch.where(killed, deadline, dur_s)
    t_fail = -torch.log(torch.clamp(u2, min=tiny)) * (mtbf * 3600.0) / m_f
    failed = inject & (mtbf > 0) & (t_fail < dur)
    run_done = torch.clamp(torch.minimum(t_fail, dur) - s, min=0.0)
    ckpt_done = torch.floor(run_done / torch.clamp(ckpt, min=tiny)) * ckpt
    stretch = torch.where(stretched, factor, torch.ones_like(factor))
    credit = torch.where(
        failed, ckpt_done * m_f / stretch,
        torch.where(killed, torch.clamp(dur - s, min=0.0) * m_f / stretch,
                    work))
    lost = torch.where(failed, (run_done - ckpt_done) * m_f,
                       torch.zeros_like(work))
    return _ChaosOutcome(dur, failed, killed, ckpt_done, credit, lost)


def _window_overlap(a, b, t_end):
    """Length of [a, b] clipped to the metric window [0, t_end]."""
    return torch.clamp(torch.minimum(b, t_end) - torch.minimum(a, t_end),
                       min=0.0)


def _credit_cut(tj_prefw, j, lo, hi, target):
    """Largest rank in [lo, hi] with ``tj_prefw[j, rank] <= target``, as a
    fixed-trip branchless binary search (``ceil(log2(N + 1))`` gathers)."""
    steps = max(int(tj_prefw.shape[1] - 1).bit_length(), 1)
    jl = j.long()
    for _ in range(steps):
        mid = (lo + hi + 1) >> 1
        go = tj_prefw[jl, mid.long()] <= target
        lo = torch.where(go, mid, lo)
        hi = torch.where(go, hi, mid - 1)
    return lo


def _resolve_remnant(tj_prefw, tj_submit, n_jobs: int, j_f, code, stored_w,
                     stored_old):
    """Resolve a ring slot's requeue stash at group finish.

    Returns ``(cnt, w, oldest, lo, hi, walk)``: the remnant member set to
    merge into the type's pool. Walk path (``code > 0``): decode the span,
    run the in-order credit walk via `_credit_cut`, derive count / work /
    oldest from the static prefix sums. Frag path (``code < 0``) passes
    the stored aggregates through; ``code == 0`` is an empty remnant.
    """
    N = n_jobs
    zero_f = torch.zeros_like(stored_w)
    jl = j_f.long()
    walk = code > 0
    span = torch.clamp(code - 1, min=0)
    qlo = (span // (N + 1)).to(torch.int32)
    hi = (span % (N + 1)).to(torch.int32)
    qlo_w = tj_prefw[jl, qlo.long()]
    hi_w = tj_prefw[jl, hi.long()]
    target = qlo_w + stored_w + CREDIT_EPS
    cut = _credit_cut(tj_prefw, j_f, qlo, hi, target)
    cut_w = tj_prefw[jl, cut.long()]
    m_res = torch.maximum(stored_w - (cut_w - qlo_w), zero_f)
    m_w = torch.maximum(hi_w - cut_w - m_res, zero_f)
    m_cnt = hi - cut
    m_old = tj_submit[jl, torch.clamp(cut, max=N - 1).long()]
    return (torch.where(walk, m_cnt, -code),
            torch.where(walk, m_w, stored_w),
            torch.where(walk & (m_cnt > 0), m_old, stored_old),
            torch.where(walk, cut, torch.zeros_like(cut)),
            hi,
            walk)


def _pool_decode(code, n_jobs: int):
    """(count, head rank, fragmented) from a packed `pool_code` value."""
    cnt = code % (n_jobs + 1)
    meta = code // (n_jobs + 1)
    return cnt, meta >> 1, (meta & 1) == 1


# --------------------------------------------------------------------------
# Results and the post-pass.
# --------------------------------------------------------------------------

class DesResult(NamedTuple):
    start_t: torch.Tensor
    run_start_t: torch.Tensor
    qlen_int: torch.Tensor
    busy_ns: torch.Tensor
    useful_ns: torch.Tensor
    n_groups: torch.Tensor
    makespan: torch.Tensor
    ok: torch.Tensor           # drained within the budget, every job started
    budget_exhausted: torch.Tensor  # step budget hit: truncated run
    lost_work: torch.Tensor    # chip-seconds lost to failures (not clipped)
    failures: torch.Tensor
    straggler_kills: torch.Tensor
    requeues: torch.Tensor     # requeue batches (one per failed/killed group)
    requeued_jobs: torch.Tensor  # individual members re-entering the queue


def _reconstruct_job_times(pw: PackedWorkload, log_key, log_t, log_m,
                           log_headw, s_lane):
    """Post-pass over all lanes at once: job -> its group by sorted lookup.

    The logs are lane-major here, ``[T, L]``; `s_lane` is the ``[T]`` init
    time. Within a type, group tails strictly increase and partition that
    type's ranks, so job (j, r) belongs to the type-j group with the
    smallest tail > r: encoding groups as ``j * (N+1) + tail`` and jobs as
    ``j * (N+1) + rank`` makes that one sorted lookup per lane. Unused log
    slots carry the int32-max pad key and sort last; `covered` rejects
    them, so jobs never grouped (budget hit) keep start = +inf.
    """
    N = pw.n_jobs
    T, L = log_key.shape
    dtype = pw.submit.dtype
    skey, order = torch.sort(log_key, dim=1, stable=True)
    q = (pw.jtype * (N + 1) + pw.rank).unsqueeze(0).expand(T, N).contiguous()
    ppos = torch.searchsorted(skey, q, right=True)
    g = torch.gather(order, 1, torch.clamp(ppos, max=L - 1))
    covered = (ppos < L) & (
        torch.gather(log_key, 1, g) // (N + 1) == pw.jtype.unsqueeze(0))
    t0 = torch.gather(log_t, 1, g)
    m_g = torch.clamp(torch.gather(log_m, 1, g), min=1).to(dtype)
    inf = torch.full((), INF, dtype=dtype, device=t0.device)
    start_t = torch.where(covered, t0, inf)
    run_start = (t0 + s_lane.unsqueeze(1) +
                 (pw.cumw.unsqueeze(0) - torch.gather(log_headw, 1, g)) / m_g)
    run_start_t = torch.where(covered, run_start, inf)
    return start_t, run_start_t


# --------------------------------------------------------------------------
# Event-budget scan engine over a whole dispatch of lanes.
# --------------------------------------------------------------------------

EVENT_BUDGET_SLACK = 64   # headroom over the 3N analytic step bound
SCAN_SEG = 256            # default segment length (early-exit granularity)


def event_budget(n_jobs: int, max_requeues: int = 0) -> int:
    """Safe per-lane step budget: each step consumes one event (at most
    N + G) or forms one group (G), and G <= N + R, so ``3N + 2R + slack``
    steps always drain a lane."""
    return 3 * max(1, int(n_jobs)) + 2 * max(0, int(max_requeues)) + \
        EVENT_BUDGET_SLACK


class ScanState(NamedTuple):
    """The 23 state columns, each ``[rows, T]`` with lanes minor."""
    t: torch.Tensor            # [1, T] current time
    next_sub: torch.Tensor     # [1, T] index of next submission
    head: torch.Tensor         # [H, T] per-type queue window start (rank)
    tail: torch.Tensor         # [H, T] per-type queue window end (rank)
    m_free: torch.Tensor       # [1, T] free nodes
    grp_end: torch.Tensor      # [ring, T] completion time (+inf = free slot)
    grp_m: torch.Tensor        # [ring, T] nodes held
    qlen_int: torch.Tensor     # [1, T]
    busy_ns: torch.Tensor      # [1, T]
    useful_ns: torch.Tensor    # [1, T]
    n_groups: torch.Tensor     # [1, T]
    # chaos state (zeros / untouched when chaos is None)
    pool_w: torch.Tensor       # [H, T] requeued remainder work per type
    pool_oldest: torch.Tensor  # [H, T] oldest submit among requeued jobs
    pool_code: torch.Tensor    # [H, T] packed (head rank, fragmented, count)
    grp_jtype: torch.Tensor    # [ring, T]
    grp_rem_w: torch.Tensor    # [ring, T] available credit / aggregate work
    grp_rem_cnt: torch.Tensor  # [ring, T] span code / negated count
    grp_rem_oldest: torch.Tensor  # [ring, T] aggregate oldest (frag path)
    lost_work: torch.Tensor    # [1, T]
    failures: torch.Tensor     # [1, T]
    straggler_kills: torch.Tensor  # [1, T]
    requeues: torch.Tensor     # [1, T]
    requeued_jobs: torch.Tensor  # [1, T]


N_STATE_COLS = len(ScanState._fields)
#: which state columns hold floats (the rest are int32)
FLOAT_STATE_COLS = ("t", "grp_end", "qlen_int", "busy_ns", "useful_ns",
                    "pool_w", "pool_oldest", "grp_rem_w", "grp_rem_oldest",
                    "lost_work")


def scan_state_from_numpy(cols: dict, device) -> ScanState:
    """Build a ScanState from the reference `_ScanState`'s 23 columns given
    as numpy arrays in the ``[rows, T]`` layout, on `device`."""
    dev = resolve_device(device)
    out = {}
    for name in ScanState._fields:
        a = np.asarray(cols[name])
        if a.ndim != 2:
            raise ValueError(f"state column {name!r} must be [rows, T], "
                             f"got shape {a.shape}")
        if name in FLOAT_STATE_COLS:
            tdt = precision.torch_dtype(a.dtype)
        else:
            a = a.astype(np.int32)
            tdt = torch.int32
        out[name] = torch.tensor(a, dtype=tdt, device=dev)   # a copy
    return ScanState(**out)


def initial_scan_state(n_types: int, ring: int, n_lanes: int, m_nodes: int,
                       dtype: torch.dtype, device) -> ScanState:
    """The empty-cluster state of a dispatch of `n_lanes` lanes."""
    H, T = n_types, n_lanes

    def zf(rows):
        return torch.zeros((rows, T), dtype=dtype, device=device)

    def zi(rows):
        return torch.zeros((rows, T), dtype=torch.int32, device=device)

    def inf(rows):
        return torch.full((rows, T), INF, dtype=dtype, device=device)

    return ScanState(
        t=zf(1), next_sub=zi(1), head=zi(H), tail=zi(H),
        m_free=torch.full((1, T), int(m_nodes), dtype=torch.int32,
                          device=device),
        grp_end=inf(ring), grp_m=zi(ring),
        qlen_int=zf(1), busy_ns=zf(1), useful_ns=zf(1), n_groups=zi(1),
        pool_w=zf(H), pool_oldest=inf(H), pool_code=zi(H),
        grp_jtype=zi(ring), grp_rem_w=zf(ring), grp_rem_cnt=zi(ring),
        grp_rem_oldest=inf(ring),
        lost_work=zf(1), failures=zi(1), straggler_kills=zi(1),
        requeues=zi(1), requeued_jobs=zi(1))


def lane_active(cols: ScanState, n_jobs: int, has_chaos: bool):
    """[T] bool: the lane still has a submission, a running group or a
    queued job (or, under chaos, a requeued pool member) to process."""
    act = ((cols.next_sub[0] < n_jobs) |
           torch.any(~torch.isinf(cols.grp_end), dim=0) |
           torch.any(cols.tail > cols.head, dim=0))
    if has_chaos:
        act = act | torch.any(cols.pool_code > 0, dim=0)
    return act


def chaos_param_columns(chaos: ChaosConfig, n_lanes: int,
                        dtype: torch.dtype, device) -> ChaosParams:
    """The five fault parameters as ``[1, T]`` columns on `device`."""
    def col(x):
        a = np.broadcast_to(np.asarray(x, np.float64), (n_lanes,))
        return torch.tensor(a, dtype=dtype, device=device).reshape(
            1, n_lanes)
    return ChaosParams(col(chaos.mtbf_chip_hours), col(chaos.ckpt_period),
                       col(chaos.straggler_prob), col(chaos.straggler_factor),
                       col(chaos.straggler_deadline))


def _lane_tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return torch.atleast_1d(x).to(device=device, dtype=dtype)
    return torch.tensor(np.atleast_1d(np.asarray(x, np.float64)),
                        dtype=dtype, device=device)


def simulate_packet_scan_lanes(pw: PackedWorkload, k, s_init, m_nodes,
                               priority=None, t_max=None,
                               ring: int | None = None,
                               budget: int | None = None,
                               seg: int | None = None,
                               chaos: ChaosConfig | None = None,
                               step_impl: str | None = None,
                               u1=None, u2=None,
                               device=None) -> DesResult:
    """A whole dispatch of (k, s) lanes through the scan engine.

    `k` and `s_init` are ``[T]`` lane arrays (tensors or numpy); `chaos`
    (optional) carries scalar or ``[T]`` fault parameters and then `u1` /
    `u2`, the ``[N + R, T]`` uniform streams, are required. Returns a
    DesResult whose every field has a leading lane axis.

    `device=None` means the CUDA card and must be where `pw` lives; only
    ``device="cpu"`` runs on the CPU. `step_impl` is ``"cuda"`` (the
    hand-written kernel, the default on a CUDA device) or ``"torch"`` (the
    plain PyTorch step, the default on the CPU). ``"cuda"`` on CPU tensors
    raises; ``"torch"`` on a CUDA device runs only when asked for by name.

    The scan state and the four ``[budget, T]`` log buffers are allocated
    once and UPDATED IN PLACE by every segment; the host loop reads one
    boolean per segment and stops when no lane is active.
    """
    from repro_torch.kernels.packet_step import ops as _step_ops  # cycle

    dev = resolve_device(device)
    if pw.submit.device != dev:
        raise ValueError(f"packed workload lives on {pw.submit.device}, "
                         f"engine was asked to run on {dev}")
    step_impl = _step_ops.resolve_step_impl(step_impl, dev)
    H, N = pw.n_types, pw.n_jobs
    ring = resolve_ring(m_nodes, N, ring)
    R = resolve_max_requeues(chaos, N)
    L_cap = N + R
    budget = event_budget(N, R) if budget is None else max(1, int(budget))
    seg = SCAN_SEG if seg is None else max(1, int(seg))
    n_segs = -(-budget // seg)
    budget = n_segs * seg               # segments tile the log exactly
    dtype = pw.submit.dtype
    k = _lane_tensor(k, dtype, dev)
    s = _lane_tensor(s_init, dtype, dev)
    T = int(k.shape[0])
    if s.shape != k.shape:
        raise ValueError(f"k and s_init must be equal-length lane arrays, "
                         f"got {tuple(k.shape)} and {tuple(s.shape)}")
    m_nodes = int(m_nodes)
    p_j = (torch.ones((H,), dtype=dtype, device=dev) if priority is None
           else _lane_tensor(priority, dtype, dev))
    tmax_j = (torch.full((H,), 3600.0, dtype=dtype, device=dev)
              if t_max is None else _lane_tensor(t_max, dtype, dev))

    has_chaos = chaos is not None
    if not has_chaos:
        if u1 is not None or u2 is not None:
            raise ValueError("u1/u2 were given without a ChaosConfig")
        chaos_params = None
    else:
        if u1 is None or u2 is None:
            raise ValueError(
                "a ChaosConfig needs the uniform streams u1 and u2 "
                f"([{L_cap}, {T}]) as operands: the port has no stream "
                "generator of its own yet (ROADMAP.md Queue 1, chaos axis "
                "with a threefry generator)")
        u1 = u1.to(device=dev, dtype=dtype).contiguous()
        u2 = u2.to(device=dev, dtype=dtype).contiguous()
        if tuple(u1.shape) != (L_cap, T) or tuple(u2.shape) != (L_cap, T):
            raise ValueError(f"u1/u2 must have shape [{L_cap}, {T}], got "
                             f"{tuple(u1.shape)} and {tuple(u2.shape)}")
        chaos_params = chaos_param_columns(chaos, T, dtype, dev)

    k_col = k.reshape(1, T).contiguous()
    s_col = s.reshape(1, T).contiguous()
    t_last = pw.t_last_submit.reshape(1, 1)

    cols = initial_scan_state(H, ring, T, m_nodes, dtype, dev)
    logs = (torch.full((budget, T), KEY_PAD, dtype=torch.int32, device=dev),
            torch.zeros((budget, T), dtype=dtype, device=dev),
            torch.zeros((budget, T), dtype=torch.int32, device=dev),
            torch.zeros((budget, T), dtype=dtype, device=dev))

    s_idx = 0
    while s_idx < n_segs and bool(lane_active(cols, N, has_chaos).any()):
        _step_ops.packet_event_steps(
            pw.tj_prefw, pw.tj_submit, pw.submit, pw.jtype, k_col, s_col,
            p_j, tmax_j, t_last, cols, logs=logs, log_offset=s_idx * seg,
            n_steps=seg, u1=u1, u2=u2, chaos_params=chaos_params, r_cap=R,
            step_impl=step_impl)
        s_idx += 1

    # rows past the last segment run are still pads: leave them out
    rows = max(1, s_idx * seg)
    lane_logs = tuple(buf[:rows].t().contiguous() for buf in logs)
    start_t, run_start_t = _reconstruct_job_times(pw, *lane_logs, s)
    drained = ((cols.next_sub[0] >= N) &
               torch.all(torch.isinf(cols.grp_end), dim=0) &
               torch.all(cols.head == cols.tail, dim=0))
    if has_chaos:
        drained = drained & torch.all(cols.pool_code == 0, dim=0)
    ok = drained & torch.all(torch.isfinite(start_t), dim=1)
    return DesResult(start_t=start_t, run_start_t=run_start_t,
                     qlen_int=cols.qlen_int[0], busy_ns=cols.busy_ns[0],
                     useful_ns=cols.useful_ns[0], n_groups=cols.n_groups[0],
                     makespan=cols.t[0], ok=ok, budget_exhausted=~drained,
                     lost_work=cols.lost_work[0], failures=cols.failures[0],
                     straggler_kills=cols.straggler_kills[0],
                     requeues=cols.requeues[0],
                     requeued_jobs=cols.requeued_jobs[0])
