"""Lane-batched discrete-event simulator of the Packet algorithm, PyTorch.

Counterpart of `repro.core.des`. Every lane is one (scale ratio k, init
time s) experiment over the same packed workload. Four engines:

  * `simulate_packet_scan_lanes` — the batched-lane scan engine of the
    grid sweep. State is carried as ``[state, T]`` columns with the lanes
    on the minor axis (scalars as ``[1, T]``, per-type rows as ``[H, T]``,
    ring rows as ``[ring, T]``), the layout of the reference's event-step
    kernel, so neighbouring GPU threads touch neighbouring addresses.
  * `simulate_packet` — the reference's while-loop engine (an event loop
    with a nested group-formation loop) with lane-major ``[T, ...]``
    state. On the card it is ONE launch of the while-loop kernel
    (`kernels/packet_while`), each lane a warp that runs its own loops
    with the group-formation decision inlined; its plain version runs the
    lanes in lockstep, each group formation taking its decision in one
    call of the select kernel (`kernels/packet_select`). This is the
    sweep's ``mode="seq"`` path with ``step_impl="torch"``.
  * `simulate_packet_scan` — one lane of the scan engine.
  * `simulate_packet_reference` — the reference's seed oracle, one lane,
    eager O(N) writes per group; an independent check, off the main path.

The scan engine on a GPU
------------------------
A host loop runs at most ``n_segs = budget / seg`` segments and stops when
no lane is active. Each segment is ONE call of
`repro_torch.kernels.packet_step.ops.packet_event_steps`, which advances
every lane by `seg` events and writes `seg` rows of the four
``[budget, T]`` group-log buffers; on a CUDA tensor that is one launch of
the hand-written kernel with the event loop inside it. The host reads one
boolean per segment. Extra segments past a lane's drain point are masked
no-ops, so a lane's result does not depend on its companions.

A cohort (`repro_torch.core.cohort`) is one dispatch too: a PackedWorkload
stacked along a leading ``[W]`` axis with ``[W, L]`` lanes runs as
``T = W * L`` lanes, each reading its member's tables, one launch and one
boolean read per segment for the whole cohort; the job times and the
drain masks are then taken per member.

Why the simulation vectorizes, the group log and the chaos (fault
injection) semantics are documented in `repro.core.des`; the arithmetic
here keeps that module's order of operations so schedules and integer
counters agree exactly.

Chaos streams
-------------
Under chaos a lane consumes one uniform stream: ``u1`` (straggler draw)
and ``u2`` (failure draw), row g taken by the g-th group the lane forms.
`chaos_uniforms` draws them as the reference does, with threefry keyed by
``fold_in(PRNGKey(chaos.seed), chaos.lane)`` (`repro_torch.core.prng`,
bitwise `jax.random`), on the engine's device. The engines draw them
themselves when no streams are given; ``u1`` / ``u2`` of shape
``[L_cap, T]`` (``L_cap = N + R``) may still be passed as operands.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import packet, precision, prng
from repro_torch.device import resolve_device
from repro_torch.kernels.routing import resolve_impl
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


def member_workload(pw: PackedWorkload, w: int) -> PackedWorkload:
    """Member `w` of a stacked PackedWorkload (tensors ``[W, ...]``), as
    views."""
    return PackedWorkload(*(x[w] for x in pw[:-2]), n_types=pw.n_types,
                          n_jobs=pw.n_jobs)


def as_cohort(pw: PackedWorkload) -> PackedWorkload:
    """One workload as a stacked PackedWorkload of one member (views with
    a leading ``[1]`` axis)."""
    return PackedWorkload(*(x.unsqueeze(0) for x in pw[:-2]),
                          n_types=pw.n_types, n_jobs=pw.n_jobs)


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

    The five fault parameters are scalars or ``[T]`` lane arrays. `seed`
    and `lane` (a scalar or ``[T]`` lane ids) key each lane's uniform
    stream, ``fold_in(PRNGKey(seed), lane)`` (`chaos_uniforms`); the
    sweep sets `lane` to the flat grid index, so a lane's draws do not
    depend on its dispatch layout. ``max_requeues=None`` resolves to the
    job count N at simulation time.
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


def chaos_uniforms(chaos: ChaosConfig, dtype, n_groups_cap: int,
                   device=None) -> torch.Tensor:
    """The per-lane uniform streams of `repro.core.des.chaos_uniforms`, bit
    for bit: ``uniform(fold_in(PRNGKey(chaos.seed), lane), (cap, 2))``
    with ``cap = max(1, n_groups_cap)``, row g = (straggler draw, failure
    draw) of the g-th group a lane forms. Returns ``lane.shape + [cap, 2]``
    on `device` (None = the CUDA card): ``[cap, 2]`` for a scalar
    ``chaos.lane``, ``[T, cap, 2]`` for ``[T]`` lane ids. A float64 draw
    keys the seed as the reference's 64-bit scope does."""
    dev = resolve_device(device)
    tdt = precision.torch_dtype(dtype)
    key = prng.PRNGKey(chaos.seed, x64=tdt == torch.float64, device=dev)
    return prng.uniform(prng.fold_in(key, chaos.lane),
                        (max(1, int(n_groups_cap)), 2), tdt)


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


def _chaos_streams(chaos, u1, u2, L_cap: int, T: int, dtype, device):
    """The ``[L_cap, T]`` uniform streams on `device`: given as operands,
    or (with neither given) drawn from ``chaos.seed`` and ``chaos.lane``
    by `chaos_uniforms`; refused without a ChaosConfig or one without the
    other."""
    if chaos is None:
        if u1 is not None or u2 is not None:
            raise ValueError("u1/u2 were given without a ChaosConfig")
        return None, None
    if u1 is None and u2 is None:
        lane = chaos.lane
        lanes = (torch.broadcast_to(lane, (T,)) if isinstance(
            lane, torch.Tensor) else np.broadcast_to(np.asarray(lane), (T,)))
        u = chaos_uniforms(dataclasses.replace(chaos, lane=lanes), dtype,
                           L_cap, device)
        return (u[:, :, 0].t().contiguous(), u[:, :, 1].t().contiguous())
    if u1 is None or u2 is None:
        raise ValueError("pass both uniform streams u1 and u2, or neither "
                         "(then the engine draws them from chaos.seed and "
                         "chaos.lane)")
    u1, u2 = ((u if isinstance(u, torch.Tensor) else torch.tensor(
        np.asarray(u))).to(device=device, dtype=dtype).contiguous()
              for u in (u1, u2))
    if tuple(u1.shape) != (L_cap, T) or tuple(u2.shape) != (L_cap, T):
        raise ValueError(f"u1/u2 must have shape [{L_cap}, {T}], got "
                         f"{tuple(u1.shape)} and {tuple(u2.shape)}")
    return u1, u2


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
    (optional) carries scalar or ``[T]`` fault parameters and lane ids.
    Its ``[N + R, T]`` uniform streams are drawn on the device from
    ``chaos.seed`` and ``chaos.lane`` (`chaos_uniforms`, as the reference
    draws them), unless both `u1` and `u2` are given. Returns a DesResult
    whose every field has a leading lane axis.

    A cohort: `pw` stacked along a leading ``[W]`` axis
    (`repro_torch.core.cohort.stack_workloads`) takes ``[W, L]`` lane
    arrays and runs the ``W * L`` lanes as one dispatch; `chaos`, `u1`
    and `u2` then describe the ``L`` lanes of one member and are shared
    by all W (the reference's common random numbers), and every field of
    the result has the leading axes ``[W, L]``. Lane (w, l) gives what
    lane l of member w alone gives, bit for bit.

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
    stacked = pw.submit.dim() == 2
    if not stacked:                     # one workload: a cohort of one
        pw = as_cohort(pw)
    W = int(pw.submit.shape[0])
    k = _lane_tensor(k, dtype, dev)
    s = _lane_tensor(s_init, dtype, dev)
    if s.shape != k.shape or k.dim() != (2 if stacked else 1) or (
            stacked and int(k.shape[0]) != W):
        want = f"[{W}, L]" if stacked else "[T]"
        raise ValueError(f"k and s_init must be equal-length {want} lane "
                         f"arrays, got {tuple(k.shape)} and "
                         f"{tuple(s.shape)}")
    k, s = k.reshape(W, -1), s.reshape(W, -1)
    L = int(k.shape[1])
    T = W * L
    m_nodes = int(m_nodes)
    p_j = (torch.ones((H,), dtype=dtype, device=dev) if priority is None
           else _lane_tensor(priority, dtype, dev))
    tmax_j = (torch.full((H,), 3600.0, dtype=dtype, device=dev)
              if t_max is None else _lane_tensor(t_max, dtype, dev))

    has_chaos = chaos is not None
    u1, u2 = _chaos_streams(chaos, u1, u2, L_cap, L, dtype, dev)
    chaos_params = (chaos_param_columns(chaos, L, dtype, dev) if has_chaos
                    else None)

    k_col = k.reshape(1, T).contiguous()
    s_col = s.reshape(1, T).contiguous()
    t_last = pw.t_last_submit.reshape(W, 1)

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
    drained = ((cols.next_sub[0] >= N) &
               torch.all(torch.isinf(cols.grp_end), dim=0) &
               torch.all(cols.head == cols.tail, dim=0))
    if has_chaos:
        drained = drained & torch.all(cols.pool_code == 0, dim=0)
    # the post-pass member by member, each on its own slice of the logs
    times = [_reconstruct_job_times(
        member_workload(pw, w),
        *(buf[:rows, w * L:(w + 1) * L].t().contiguous() for buf in logs),
        s[w]) for w in range(W)]
    start_t, run_start_t = (torch.stack(x) for x in zip(*times))
    lane = lambda col: col[0].reshape(W, L)
    drained = drained.reshape(W, L)
    ok = drained & torch.all(torch.isfinite(start_t), dim=-1)
    res = DesResult(start_t=start_t, run_start_t=run_start_t,
                    qlen_int=lane(cols.qlen_int), busy_ns=lane(cols.busy_ns),
                    useful_ns=lane(cols.useful_ns),
                    n_groups=lane(cols.n_groups), makespan=lane(cols.t),
                    ok=ok, budget_exhausted=~drained,
                    lost_work=lane(cols.lost_work),
                    failures=lane(cols.failures),
                    straggler_kills=lane(cols.straggler_kills),
                    requeues=lane(cols.requeues),
                    requeued_jobs=lane(cols.requeued_jobs))
    return res if stacked else DesResult(*(x[0] for x in res))


# --------------------------------------------------------------------------
# The while-loop engine, in lockstep over lanes.
# --------------------------------------------------------------------------

class DesState(NamedTuple):
    """State of the while-loop engine, lane-major: scalars ``[T]``, per-type
    rows ``[T, H]``, the ring ``[T, ring]`` and the group log ``[T, L]``
    (``L = N + R``). The fields are the reference's `DesState`."""
    t: torch.Tensor
    next_sub: torch.Tensor
    head: torch.Tensor
    tail: torch.Tensor
    m_free: torch.Tensor
    grp_end: torch.Tensor
    grp_m: torch.Tensor
    log_key: torch.Tensor
    log_t: torch.Tensor
    log_m: torch.Tensor
    log_headw: torch.Tensor
    qlen_int: torch.Tensor
    busy_ns: torch.Tensor
    useful_ns: torch.Tensor
    n_groups: torch.Tensor
    iters: torch.Tensor        # outer-loop iterations of the lane
    pool_w: torch.Tensor
    pool_oldest: torch.Tensor
    pool_code: torch.Tensor
    grp_jtype: torch.Tensor
    grp_rem_w: torch.Tensor
    grp_rem_cnt: torch.Tensor
    grp_rem_oldest: torch.Tensor
    lost_work: torch.Tensor
    failures: torch.Tensor
    straggler_kills: torch.Tensor
    requeues: torch.Tensor
    requeued_jobs: torch.Tensor


#: which DesState columns hold floats (the rest are int32)
FLOAT_DES_COLS = ("t", "grp_end", "log_t", "log_headw", "qlen_int",
                  "busy_ns", "useful_ns", "pool_w", "pool_oldest",
                  "grp_rem_w", "grp_rem_oldest", "lost_work")


def initial_des_state(n_types: int, ring: int, log_cap: int, n_lanes: int,
                      m_nodes: int, dtype: torch.dtype, device) -> DesState:
    """The empty-cluster state of `n_lanes` lanes of the while engine."""
    T = n_lanes

    def full(cols, value, dt):
        shape = (T,) if cols is None else (T, cols)
        return torch.full(shape, value, dtype=dt, device=device)

    f, i = dtype, torch.int32
    return DesState(
        t=full(None, 0.0, f), next_sub=full(None, 0, i),
        head=full(n_types, 0, i), tail=full(n_types, 0, i),
        m_free=full(None, int(m_nodes), i),
        grp_end=full(ring, INF, f), grp_m=full(ring, 0, i),
        log_key=full(log_cap, KEY_PAD, i), log_t=full(log_cap, 0.0, f),
        log_m=full(log_cap, 0, i), log_headw=full(log_cap, 0.0, f),
        qlen_int=full(None, 0.0, f), busy_ns=full(None, 0.0, f),
        useful_ns=full(None, 0.0, f), n_groups=full(None, 0, i),
        iters=full(None, 0, i),
        pool_w=full(n_types, 0.0, f), pool_oldest=full(n_types, INF, f),
        pool_code=full(n_types, 0, i), grp_jtype=full(ring, 0, i),
        grp_rem_w=full(ring, 0.0, f), grp_rem_cnt=full(ring, 0, i),
        grp_rem_oldest=full(ring, INF, f), lost_work=full(None, 0.0, f),
        failures=full(None, 0, i), straggler_kills=full(None, 0, i),
        requeues=full(None, 0, i), requeued_jobs=full(None, 0, i))


def _is_scalar(x) -> bool:
    return x.dim() == 0 if isinstance(x, torch.Tensor) else np.ndim(x) == 0


def simulate_packet(pw: PackedWorkload, k, s_init, m_nodes, priority=None,
                    t_max=None, max_iters: int | None = None,
                    ring: int | None = None,
                    chaos: ChaosConfig | None = None, u1=None, u2=None,
                    device=None, stats: dict | None = None,
                    impl: str | None = None) -> DesResult:
    """The Packet DES as the reference's while-loop engine, over lanes.

    An outer loop takes one event per iteration (the earlier of the next
    submission and the first running group's end); after each event an
    inner loop forms groups (paper Steps 1-5) until the lane is blocked.
    `k` and `s_init` are scalars or ``[T]`` lanes (a scalar broadcasts);
    a lane's result does not depend on its companions: lane t gives the
    reference's `simulate_packet` with ``(k[t], s_init[t])``. With scalar
    `k` and `s_init` the lane axis is squeezed from the result.

    The loops run in `repro_torch.kernels.packet_while.ops.packet_while`.
    `impl` is ``"cuda"`` (the default on CUDA tensors): ONE launch of the
    hand-written kernel, each lane a warp that runs its own loop with the
    group-formation decision inlined. ``"torch"`` (the default on CPU
    tensors) is the plain version: the lanes in lockstep, each loop
    stopping when no lane is active, every update masked, and every inner
    iteration taking its decision in ONE call of `fused_packet_select`
    over all lanes (on CUDA tensors the decision kernel, on CPU tensors
    its plain version). ``"cuda"`` on CPU tensors raises. The job times
    come from `_reconstruct_job_times` over the ``[T, N + R]`` group log,
    in PyTorch on the engine's device. `device=None` means the CUDA card
    and must be where `pw` lives.

    `chaos` as in `simulate_packet_scan_lanes`: lane t draws its stream
    from ``chaos.seed`` and its lane id (``[N + R]`` rows, row g consumed
    by the g-th group it forms) unless `u1` and `u2` (``[N + R, T]``) are
    given. `max_iters` caps each lane's outer iterations
    (default ``4N + 64 + 2R``; a lane that hits it reports
    `budget_exhausted`). If `stats` is a dict, it receives the counts of
    this call. The plain version's: ``outer`` and ``inner``, its lockstep
    iterations, and ``syncs``, its host reads (one boolean read per loop
    test). The kernel's: ``launches`` (1), ``outer_max`` and
    ``inner_max``, the largest outer iterations and group formations of
    a lane, and ``syncs`` (1: the read of those two maxima, made only
    when `stats` is asked for).
    """
    from repro_torch.kernels.packet_while import ops as _while_ops  # cycle

    dev = resolve_device(device)
    if pw.submit.device != dev:
        raise ValueError(f"packed workload lives on {pw.submit.device}, "
                         f"engine was asked to run on {dev}")
    impl = resolve_impl(impl, dev)
    H, N = pw.n_types, pw.n_jobs
    ring = resolve_ring(m_nodes, N, ring)
    R = resolve_max_requeues(chaos, N)
    L = N + R                       # group-log capacity: G <= N + requeues
    dtype = pw.submit.dtype
    squeeze = _is_scalar(k) and _is_scalar(s_init)
    k = _lane_tensor(k, dtype, dev)
    s = _lane_tensor(s_init, dtype, dev)
    T = max(int(k.shape[0]), int(s.shape[0]))
    if k.dim() != 1 or s.dim() != 1 or {int(k.shape[0]),
                                        int(s.shape[0])} - {1, T}:
        raise ValueError(f"k and s_init must be scalars or equal-length "
                         f"lane arrays, got {tuple(k.shape)} and "
                         f"{tuple(s.shape)}")
    k = k.expand(T).contiguous()
    s = s.expand(T).contiguous()
    p_j = (torch.ones((H,), dtype=dtype, device=dev) if priority is None
           else _lane_tensor(priority, dtype, dev)).expand(H).contiguous()
    tmax_j = (torch.full((H,), 3600.0, dtype=dtype, device=dev)
              if t_max is None else _lane_tensor(t_max, dtype, dev)
              ).expand(H).contiguous()
    if max_iters is None:
        max_iters = 4 * N + 64 + 2 * R
    has_chaos = chaos is not None
    u1, u2 = _chaos_streams(chaos, u1, u2, L, T, dtype, dev)
    cp = (ChaosParams(*(c[0] for c in
                        chaos_param_columns(chaos, T, dtype, dev)))
          if has_chaos else None)
    st = initial_des_state(H, ring, L, T, int(m_nodes), dtype, dev)

    st, counts = _while_ops.packet_while(
        pw.tj_prefw, pw.tj_submit, pw.submit, pw.jtype, k, s, p_j, tmax_j,
        pw.t_last_submit, st, int(m_nodes), int(max_iters), u1=u1, u2=u2,
        chaos_params=cp, r_cap=R, impl=impl)
    if stats is not None and impl == "cuda":
        outer_max, inner_max = torch.stack(
            (st.iters.max(), st.n_groups.max())).tolist()
        counts = dict(counts, outer_max=outer_max, inner_max=inner_max,
                      syncs=counts["syncs"] + 1)

    res = des_result(pw, st, s, has_chaos)
    if stats is not None:
        stats.update(counts)
    return DesResult(*(x[0] for x in res)) if squeeze else res


def des_result(pw: PackedWorkload, st: DesState, s, has_chaos: bool
               ) -> DesResult:
    """The while engine's post-pass over a final `DesState`: the job times
    from the ``[T, L]`` group log (`_reconstruct_job_times`, `s` the
    ``[T]`` init times) and the drain test, in PyTorch on the state's
    device."""
    start_t, run_start_t = _reconstruct_job_times(
        pw, st.log_key, st.log_t, st.log_m, st.log_headw, s)
    drained = ((st.next_sub >= pw.n_jobs) &
               torch.all(torch.isinf(st.grp_end), dim=1) &
               torch.all(st.head == st.tail, dim=1))
    if has_chaos:
        drained = drained & torch.all(st.pool_code == 0, dim=1)
    ok = drained & torch.all(torch.isfinite(start_t), dim=1)
    return DesResult(start_t=start_t, run_start_t=run_start_t,
                     qlen_int=st.qlen_int, busy_ns=st.busy_ns,
                     useful_ns=st.useful_ns, n_groups=st.n_groups,
                     makespan=st.t, ok=ok, budget_exhausted=~drained,
                     lost_work=st.lost_work, failures=st.failures,
                     straggler_kills=st.straggler_kills,
                     requeues=st.requeues, requeued_jobs=st.requeued_jobs)


# --------------------------------------------------------------------------
# Single-lane entry points.
# --------------------------------------------------------------------------

def _one_lane(x):
    if isinstance(x, torch.Tensor):
        return x.reshape(1)
    return np.reshape(np.asarray(x, np.float64), 1)


def simulate_packet_scan(pw: PackedWorkload, k, s_init, m_nodes,
                         priority=None, t_max=None, ring: int | None = None,
                         budget: int | None = None, seg: int | None = None,
                         chaos: ChaosConfig | None = None,
                         step_impl: str | None = None, u1=None, u2=None,
                         device=None) -> DesResult:
    """One (k, s) experiment through the scan engine: a one-lane dispatch
    of `simulate_packet_scan_lanes` with the lane axis squeezed. Under
    chaos the lane draws its stream unless `u1` and `u2`, its ``[N + R]``
    streams, are given."""
    u1, u2 = (None if u is None else torch.as_tensor(np.asarray(u) if not
              isinstance(u, torch.Tensor) else u).reshape(-1, 1)
              for u in (u1, u2))
    res = simulate_packet_scan_lanes(
        pw, _one_lane(k), _one_lane(s_init), m_nodes, priority=priority,
        t_max=t_max, ring=ring, budget=budget, seg=seg, chaos=chaos,
        step_impl=step_impl, u1=u1, u2=u2, device=device)
    return DesResult(*(x[0] for x in res))


REFERENCE_RING = 512     # the seed oracle's fixed ring


def simulate_packet_reference(pw: PackedWorkload, k, s_init, m_nodes,
                              priority=None, t_max=None,
                              max_iters: int | None = None,
                              device=None) -> DesResult:
    """The seed implementation of the reference, one experiment: a host
    loop over events with eager O(N) writes of every job's start times per
    group, a fixed ring of 512 and the plain policy functions. No chaos.

    It shares nothing with `simulate_packet` but the policy formulas, so
    it stays an independent check of that engine; nothing on the main
    path calls it.
    """
    dev = resolve_device(device)
    if pw.submit.device != dev:
        raise ValueError(f"packed workload lives on {pw.submit.device}, "
                         f"engine was asked to run on {dev}")
    H, N = pw.n_types, pw.n_jobs
    dtype = pw.submit.dtype
    k = _lane_tensor(k, dtype, dev)[0]
    s = _lane_tensor(s_init, dtype, dev)[0]
    s_j = s.expand(H)
    p_j = (torch.ones((H,), dtype=dtype, device=dev) if priority is None
           else _lane_tensor(priority, dtype, dev))
    tmax_j = (torch.full((H,), 3600.0, dtype=dtype, device=dev)
              if t_max is None else _lane_tensor(t_max, dtype, dev))
    if max_iters is None:
        max_iters = 4 * N + 64
    t_end = pw.t_last_submit
    types = torch.arange(H, device=dev)
    inf_f = torch.full((), INF, dtype=dtype, device=dev)
    t = torch.zeros((), dtype=dtype, device=dev)
    qlen_int, busy, useful = (torch.zeros((), dtype=dtype, device=dev)
                              for _ in range(3))
    head = torch.zeros((H,), dtype=torch.int32, device=dev)
    tail = torch.zeros((H,), dtype=torch.int32, device=dev)
    m_free = torch.tensor(int(m_nodes), dtype=torch.int32, device=dev)
    grp_end = torch.full((REFERENCE_RING,), INF, dtype=dtype, device=dev)
    grp_m = torch.zeros((REFERENCE_RING,), dtype=torch.int32, device=dev)
    start_t = torch.full((N,), INF, dtype=dtype, device=dev)
    run_start_t = torch.full((N,), INF, dtype=dtype, device=dev)
    next_sub = n_groups = iters = 0

    while ((next_sub < N or bool(torch.any(~torch.isinf(grp_end))))
           and iters < max_iters):
        t_sub = pw.submit[next_sub] if next_sub < N else inf_f
        slot = int(torch.argmin(grp_end))
        t_fin = grp_end[slot].clone()
        take_sub = bool(t_sub <= t_fin)
        t_new = t_sub if take_sub else t_fin
        qlen = torch.sum(tail - head).to(dtype)
        qlen_int = qlen_int + qlen * _window_overlap(t, t_new, t_end)
        t = t_new
        if take_sub:
            tail[int(pw.jtype[next_sub])] += 1
            next_sub += 1
        else:
            m_free = m_free + grp_m[slot]
            grp_end[slot] = INF
            grp_m[slot] = 0
        while (bool(m_free > 0) and bool(torch.any(tail > head))
               and bool(torch.any(torch.isinf(grp_end)))):
            nonempty = tail > head
            sum_w = pw.tj_prefw[types, tail.long()] - \
                pw.tj_prefw[types, head.long()]
            oldest = pw.tj_submit[types, torch.clamp(head, max=N - 1).long()]
            w = packet.queue_weights(sum_w, s_j, p_j, oldest, t, tmax_j,
                                     nonempty)
            j = int(torch.argmax(w))
            work = sum_w[j]
            m_grp = packet.group_nodes(work, k, s_j[j], m_free)
            dur = packet.group_duration(work, s_j[j], m_grp)
            slot = int(torch.argmax(torch.isinf(grp_end).to(torch.int8)))
            t_grp_fin = t + dur
            in_grp = ((pw.jtype == j) & (pw.rank >= head[j]) &
                      (pw.rank < tail[j]))
            start_t = torch.where(in_grp, t, start_t)
            head_w = pw.tj_prefw[j, int(head[j])]
            run_start = t + s_j[j] + (pw.cumw - head_w) / m_grp.to(dtype)
            run_start_t = torch.where(in_grp, run_start, run_start_t)
            m_f = m_grp.to(dtype)
            busy = busy + m_f * _window_overlap(t, t_grp_fin, t_end)
            useful = useful + m_f * _window_overlap(t + s_j[j], t_grp_fin,
                                                    t_end)
            head[j] = tail[j]
            m_free = m_free - m_grp
            grp_end[slot] = t_grp_fin
            grp_m[slot] = m_grp
            n_groups += 1
        iters += 1

    drained = (next_sub >= N and bool(torch.all(torch.isinf(grp_end)))
               and bool(torch.all(head == tail)))
    ok = drained and bool(torch.all(torch.isfinite(start_t)))
    zero_f = torch.zeros((), dtype=dtype, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    as_i = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    as_b = lambda v: torch.tensor(v, dtype=torch.bool, device=dev)
    return DesResult(start_t=start_t, run_start_t=run_start_t,
                     qlen_int=qlen_int, busy_ns=busy, useful_ns=useful,
                     n_groups=as_i(n_groups), makespan=t, ok=as_b(ok),
                     budget_exhausted=as_b(not drained), lost_work=zero_f,
                     failures=zero_i, straggler_kills=zero_i,
                     requeues=zero_i, requeued_jobs=zero_i)


def simulate_packet_host(wl: Workload, k: float, s_prop: float,
                         dtype=np.float32, device=None) -> DesResult:
    """Convenience entry point: a workload, a scale ratio and an init
    proportion in, the while engine's DesResult as numpy arrays out."""
    pw = pack_workload(wl, dtype, device)
    s = wl.init_time_for_proportion(s_prop)
    res = simulate_packet(pw, k, s, wl.params.nodes, device=device)
    return DesResult(*(x.cpu().numpy() for x in res))
