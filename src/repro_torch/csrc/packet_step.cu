// Fused DES event-step kernel of the Packet scheduling simulator, for Hopper.
//
// Replaces the TPU kernel `event_step_kernel` of
// src/repro/kernels/packet_step/kernel.py (launched by `fused_packet_step`
// in src/repro/kernels/packet_step/ops.py). That kernel advances every lane
// of a dispatch by ONE event per invocation and is called once per event
// from a scan. A GPU block cannot carry state from one launch to the next
// for free, so here the event loop lives inside the kernel: one launch
// advances every lane by `n_steps` events, updates the 23 state columns in
// place and writes rows `log_offset .. log_offset + n_steps - 1` of the four
// `[rows, T]` group-log buffers. With `n_steps = 1` it is exactly the TPU
// kernel's function.
//
// What bounds it on this card: latency, not bytes or arithmetic. Every lane
// is a dependent chain of about 3N events, and the next event cannot start
// before this one's writes. Each event scans the lane's ring of running
// groups (first free slot, earliest finish), walks the H job types (queue
// sums, weights, argmax) and then forms a group or consumes one event.
//
// What this design does about that: ONE WARP PER LANE, one lane a block
// (grid T, 32 threads), so the 222 lanes of the paper's grid are 222 warps
// over the whole card instead of 7 warps on 7 SMs. Inside a warp:
// - the ring's `grp_end` column lives in dynamic shared memory for the
//   whole launch (staged at the start, written back at the end), beside the
//   lane's `head` and `tail` rows; thread i scans slots i, i+32, ... (the
//   other ring columns are touched at one slot per event and stay in
//   device memory). Where one lane's columns do not fit the 227 KB a block
//   may opt into, the RING_SMEM = false instantiation scans the same
//   columns in device memory with the same split; the launch plan
//   (kernel.py :: launch_plan) picks it and sizes the shared memory, so no
//   shape is refused;
// - thread h computes type h's queue sum and weight (a loop of stride 32
//   for H > 32); the priorities and T_max of the first 32 types stay in
//   registers, and the next submission and the finishing slot's node count
//   are loaded before the scans that do not need them, so that their
//   latency hides behind the scans;
// - the formation and the finish are scalar: every thread of the warp runs
//   them on the same operands (uniform control flow, no broadcast needed),
//   in the order of operations of the one-thread-per-lane design, and
//   thread 0 alone writes, between two __syncwarp()s;
// - a warp stops as soon as its lane has drained (the activity flag is the
//   same in all 32 threads) and pads its remaining log rows.
// An event is then a chain of shared loads, one round of gathers into the
// [H, N+1] tables, warp reductions (redux.sync, shuffles, votes), two
// divides per type in parallel and the scalar update with its divides:
// 1.0 µs (float32, ring 100) to 1.6 µs (float64, ring 500) a lane step on
// an H100 80GB HBM3 at 700 W (PERF.md). What it does not do: keep the type
// tables in shared memory (every event gathers them from L2), or stop a
// dispatch on the card (the host reads one boolean a segment); and a
// launch of few steps still pays for staging the ring.
//
// The workload axis (a cohort): the T lanes of a launch may be W members
// of L = T / W lanes each, lane `blockIdx.x` belonging to member
// w = lane / L. It reads that member's tables (prefw, tsub, submit, jtype
// at the member's offsets) and t_last[w]; its own lane parameters and state
// columns stay at index `lane` of the [*, T] operands. The chaos streams
// u1 / u2 [L_cap, L] and the five fault columns [1, L] are shared by the
// members (common random numbers) and read at the lane's index within its
// member, lane % L. With W = 1 every address is the one-workload kernel's.
// The paper's two cohorts are 3 x 222 = 666 lanes a launch (3 x 666 under
// the chaos axis), where one workload gave 222 warps to 132 SMs.
//
// Why the warp reductions equal the serial first-index rules. `grp_end`
// holds finite times and +inf (a free slot) only, never NaN, so `<` and
// `==` order it totally (-0 and +0 compare equal, as in the serial scan).
// - first free slot: each thread keeps the least free slot of its own
//   subset; the least of those (__reduce_min_sync) is the least free slot
//   overall, or none (then sslot = 0, as serially);
// - earliest finish: each thread scans its slots in increasing order with
//   a strict `<` from (+inf, its first slot), so it keeps the first index
//   of its subset's minimum (its first slot when that minimum is +inf).
//   The warp's minimum comes from __reduce_min_sync over order-preserving
//   integer keys (equal values, -0 and +0 included, have equal keys), and
//   the least index among the
//   threads at that minimum is the first index of the minimum overall,
//   which is what the serial `e < t_efin` walk from slot 0 returns, and
//   slot 0 when every slot is +inf. t_efin is the winning thread's own
//   value, so its bits are those of grp_end[eslot];
// - argmax over types: the serial rule `h == 0 || w > best_w` starts from
//   w_0; if w_0 is NaN nothing compares greater and j = 0; otherwise best
//   is the running maximum of the non-NaN weights, replaced only by a
//   strictly greater one, so j is the first index of the largest non-NaN
//   weight (-0 and +0 tie). A plain max-reduction of the weights would not
//   give this (a NaN between two finite weights breaks its associativity),
//   so the warp reduces keys instead: the order-preserving key of each
//   non-NaN weight, the largest key for a NaN at type 0 and 0, below every
//   non-NaN key, for a NaN elsewhere and for threads past H. The first
//   index of the largest key (__reduce_max_sync, then __reduce_min_sync
//   over the indices at it) is then the serial j in both cases; a later
//   block of 32 types replaces it only with a strictly larger key;
// - queue sums are integer sums (__reduce_add_sync), exact in any order.
//
// Arithmetic contract: compiled with -fmad=false and without fast math, so
// every multiply, add and divide rounds on its own, in the order the plain
// PyTorch version (repro_torch/kernels/packet_step/ref.py) uses. Ties in the
// argmax over types, the first free ring slot and the argmin over the ring
// all resolve to the FIRST index.

#include <cuda_runtime.h>
#include <math.h>
#include <float.h>
#include <limits.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

template <typename F> struct Lim;
template <> struct Lim<float> {
  __device__ static float tiny() { return FLT_MIN; }
  __device__ static float inf() { return __int_as_float(0x7f800000); }
};
template <> struct Lim<double> {
  __device__ static double tiny() { return DBL_MIN; }
  __device__ static double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
};

__device__ inline float f_log(float x) { return logf(x); }
__device__ inline double f_log(double x) { return log(x); }
__device__ inline float f_floor(float x) { return floorf(x); }
__device__ inline double f_floor(double x) { return floor(x); }
__device__ inline float f_ceil(float x) { return ceilf(x); }
__device__ inline double f_ceil(double x) { return ceil(x); }
__device__ inline float f_min(float a, float b) { return fminf(a, b); }
__device__ inline double f_min(double a, double b) { return fmin(a, b); }
__device__ inline float f_max(float a, float b) { return fmaxf(a, b); }
__device__ inline double f_max(double a, double b) { return fmax(a, b); }

template <typename F>
struct Params {
  // workload tables ([W] leading) and lane parameters (read only)
  const F* prefw;    // [W, H, N+1]
  const F* tsub;     // [W, H, N]
  const F* submit;   // [W, N]
  const int* jtype;  // [W, N]
  const F* k;        // [1, T]
  const F* s;        // [1, T]
  const F* p_j;      // [H]
  const F* tmax_j;   // [H]
  const F* t_last;   // [W, 1]
  // chaos operands (null when HAS_CHAOS is false)
  const F* u1;       // [L_cap, L], shared by the W members
  const F* u2;       // [L_cap, L]
  const F* mtbf;     // [1, L]
  const F* ckpt;
  const F* prob;
  const F* factor;
  const F* dead;
  // the 23 state columns, updated in place
  F* t; int* next_sub; int* head; int* tail; int* m_free;
  F* grp_end; int* grp_m;
  F* qlen_int; F* busy_ns; F* useful_ns; int* n_groups;
  F* pool_w; F* pool_oldest; int* pool_code;
  int* grp_jtype; F* grp_rem_w; int* grp_rem_cnt; F* grp_rem_oldest;
  F* lost_work; int* failures; int* straggler_kills; int* requeues;
  int* requeued_jobs;
  // group-log buffers [rows, T]
  int* log_key; F* log_t; int* log_m; F* log_hw;
  int T, H, N, ring, r_cap, L_cap, cut_steps, log_offset, n_steps, W;
};

// Length of [a, b] clipped to the metric window [0, t_end].
template <typename F>
__device__ inline F window_overlap(F a, F b, F t_end) {
  return f_max(f_min(b, t_end) - f_min(a, t_end), F(0));
}

// Order-preserving unsigned keys of finite values and infinities (no NaN):
// a < b exactly when key(a) < key(b), and equal values (-0 and +0
// included, through the + 0) have equal keys.
__device__ inline unsigned order_key(float x) {
  const unsigned b = __float_as_uint(x + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ inline unsigned long long order_key(double x) {
  const unsigned long long b =
      static_cast<unsigned long long>(__double_as_longlong(x + 0.0));
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

// The least `idx` among the threads whose `v` is the warp's minimum.
__device__ inline int warp_first_min(float v, int idx) {
  const unsigned k = order_key(v);
  const unsigned kmin = __reduce_min_sync(FULL, k);
  return __reduce_min_sync(FULL, k == kmin ? idx : INT_MAX);
}
__device__ inline int warp_first_min(double v, int idx) {
  const unsigned long long k = order_key(v);
  const unsigned hi = (unsigned)(k >> 32), lo = (unsigned)k;
  const unsigned mhi = __reduce_min_sync(FULL, hi);
  const unsigned mlo = __reduce_min_sync(FULL, hi == mhi ? lo : 0xffffffffu);
  return __reduce_min_sync(FULL, (hi == mhi && lo == mlo) ? idx : INT_MAX);
}

// Key of type h's weight for the first-index argmax under the serial rule
// `h == 0 || w > best_w`: the order of the weights, except that a NaN at
// type 0 wins (no weight compares greater than it) and a NaN elsewhere
// never does (it compares greater than nothing), as serially.
__device__ inline unsigned long long weight_key(float w, int h) {
  return isnan(w) ? (h == 0 ? 0xffffffffull : 0ull)
                  : (unsigned long long)order_key(w);
}
__device__ inline unsigned long long weight_key(double w, int h) {
  return isnan(w) ? (h == 0 ? ~0ull : 0ull) : order_key(w);
}

// The warp's largest key: one redux.sync for the 32-bit keys of a float,
// two for the 64-bit keys of a double (high word, then low word).
__device__ inline unsigned long long warp_max_key(unsigned long long k,
                                                  float) {
  return __reduce_max_sync(FULL, (unsigned)k);
}
__device__ inline unsigned long long warp_max_key(unsigned long long k,
                                                  double) {
  const unsigned hi = (unsigned)(k >> 32), lo = (unsigned)k;
  const unsigned mhi = __reduce_max_sync(FULL, hi);
  const unsigned mlo = __reduce_max_sync(FULL, hi == mhi ? lo : 0u);
  return ((unsigned long long)mhi << 32) | mlo;
}

// The log row of a step that forms no group.
template <typename F>
__device__ inline void write_pad(int* key, F* t, int* m, F* hw, int row) {
  key[row] = 0x7fffffff; t[row] = F(0); m[row] = 0; hw[row] = F(0);
}

template <typename F, bool HAS_CHAOS, bool RING_SMEM>
__global__ void __launch_bounds__(32)
packet_step_kernel(const Params<F> p) {
  const int lid = threadIdx.x;
  const int lane = blockIdx.x;
  const int T = p.T, H = p.H, N = p.N, ring = p.ring;
  const int N1 = N + 1;
  // the lane's member of the cohort and its index there
  const int L = T / p.W;
  const int w = lane / L;
  const int il = lane - w * L;
  const F* prefw = p.prefw + (long long)w * H * N1;
  const F* tsub = p.tsub + (long long)w * H * N;
  const F* submit = p.submit + (long long)w * N;
  const int* jtype = p.jtype + (long long)w * N;
  const F INF = Lim<F>::inf();
  const F EPS9 = F(1e-9);
  const bool lead = lid == 0;

  // the ring's grp_end [ring] of F, then the head and tail rows [H] of
  // int: shared memory or the state columns themselves, at stride 1 or T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  F* ring_p; int* head_p; int* tail_p; int rs;
  if constexpr (RING_SMEM) {
    ring_p = reinterpret_cast<F*>(smem_raw);
    head_p = reinterpret_cast<int*>(smem_raw + (long long)ring * sizeof(F));
    tail_p = head_p + H;
    rs = 1;
    for (int r = lid; r < ring; r += 32) ring_p[r] = p.grp_end[r * T + lane];
    for (int h = lid; h < H; h += 32) {
      head_p[h] = p.head[h * T + lane];
      tail_p[h] = p.tail[h * T + lane];
    }
    __syncwarp();
  } else {
    ring_p = p.grp_end + lane; head_p = p.head + lane;
    tail_p = p.tail + lane; rs = T;
  }

  // per-lane scalars: the same value in every thread of the warp
  const F k = p.k[lane], s = p.s[lane], t_last = p.t_last[w];
  F t = p.t[lane], qlen_int = p.qlen_int[lane], busy_ns = p.busy_ns[lane],
    useful_ns = p.useful_ns[lane], lost_work = 0;
  F c_mtbf = 0, c_ckpt = 0, c_prob = 0, c_factor = 0, c_dead = 0;
  int next_sub = p.next_sub[lane], m_free = p.m_free[lane],
      n_groups = p.n_groups[lane], failures = 0, kills = 0, requeues = 0,
      requeued_jobs = 0;
  if (HAS_CHAOS) {
    c_mtbf = p.mtbf[il]; c_ckpt = p.ckpt[il]; c_prob = p.prob[il];
    c_factor = p.factor[il]; c_dead = p.dead[il];
    lost_work = p.lost_work[lane]; failures = p.failures[lane];
    kills = p.straggler_kills[lane]; requeues = p.requeues[lane];
    requeued_jobs = p.requeued_jobs[lane];
  }
  const F s_c = f_max(s, EPS9);   // maximum(s, 1e-9)
  const F k_c = f_max(k, EPS9);
  // the priority and max(T_max, 1e-9) of type lid, for the whole launch
  const F pj0 = lid < H ? p.p_j[lid] : F(0);
  const F tm0 = lid < H ? f_max(p.tmax_j[lid], EPS9) : F(1);

  int step = 0;
  for (; step < p.n_steps; ++step) {
    // the next submission, loaded now so that its latency hides behind
    // the scans (only a submission event uses it)
    const int sub_idx = min(next_sub, N - 1);
    const F sub_t = submit[sub_idx];
    const int sub_j = jtype[sub_idx];

    // ---- the ring: first free slot, first index of the minimum, any busy
    F vmin = INF;
    int vidx = lid, vfree = INT_MAX;
    bool busy = false;
#pragma unroll 4
    for (int r = lid; r < ring; r += 32) {
      const F e = ring_p[r * rs];
      const bool fr = isinf(e);
      vfree = (fr && vfree == INT_MAX) ? r : vfree;
      busy |= !fr;
      if (e < vmin) { vmin = e; vidx = r; }
    }
    const int eslot = warp_first_min(vmin, vidx);
    const F t_efin = __shfl_sync(FULL, vmin, eslot & 31);
    int sslot = __reduce_min_sync(FULL, vfree);
    const bool any_free = sslot != INT_MAX;
    if (!any_free) sslot = 0;
    const bool any_busy = __any_sync(FULL, busy);
    // what a finish of slot eslot reads, loaded behind the type loop
    const int e_m = p.grp_m[eslot * T + lane];

    // ---- the types: queue sums, weights, first argmax
    bool any_win = false, any_pool = false;
    int qpart = 0, ppart = 0, j = 0, head_j = 0, tail_j = 0, pc_j = 0;
    unsigned long long best_key = 0;
    F work = 0, oldest_j = INF, head_w = 0, pool_w_j = 0;
    for (int h0 = 0; h0 < H; h0 += 32) {
      const int h = h0 + lid;
      F w = -INF, sw = 0, old = INF, pw_hd = 0, pw = 0;
      int hd = 0, tl = 0, pc = 0;
      if (h < H) {
        hd = head_p[h * rs];
        tl = tail_p[h * rs];
        bool ne = tl > hd;
        any_win |= ne;
        qpart += tl - hd;
        pw_hd = prefw[h * N1 + hd];
        sw = prefw[h * N1 + tl] - pw_hd;
        old = tsub[h * N + min(hd, N - 1)];
        if (HAS_CHAOS) {
          pc = p.pool_code[h * T + lane];
          pw = p.pool_w[h * T + lane];
          ne |= pc > 0;
          any_pool |= pc > 0;
          ppart += pc % N1;
          sw = sw + pw;
          old = f_min(old, p.pool_oldest[h * T + lane]);
        }
        const F pj = h0 == 0 ? pj0 : p.p_j[h];
        const F tm = h0 == 0 ? tm0 : f_max(p.tmax_j[h], EPS9);
        const F c_j = sw / s_c;
        const F t_cur = f_max(t - old, F(0));
        w = (c_j * pj) * (F(1) + t_cur / tm);
        w = ne ? w : -INF;
      }
      // the first type of the largest key; a later block of 32 types
      // replaces it only with a strictly larger key
      const unsigned long long kw = h < H ? weight_key(w, h) : 0ull;
      const unsigned long long kmax = warp_max_key(kw, F(0));
      const int imax = __reduce_min_sync(FULL, kw == kmax ? lid : INT_MAX);
      int hit = -1;
      if (h0 == 0 || kmax > best_key) {
        best_key = kmax; j = h0 + imax; hit = imax;
      }
      if (hit >= 0) {
        work = __shfl_sync(FULL, sw, hit);
        oldest_j = __shfl_sync(FULL, old, hit);
        head_j = __shfl_sync(FULL, hd, hit);
        tail_j = __shfl_sync(FULL, tl, hit);
        head_w = __shfl_sync(FULL, pw_hd, hit);
        if (HAS_CHAOS) {
          pc_j = __shfl_sync(FULL, pc, hit);
          pool_w_j = __shfl_sync(FULL, pw, hit);
        }
      }
    }
    const int qsum = __reduce_add_sync(FULL, qpart);
    const int psum = HAS_CHAOS ? __reduce_add_sync(FULL, ppart) : 0;
    any_win = __any_sync(FULL, any_win);
    if (HAS_CHAOS) any_pool = __any_sync(FULL, any_pool);
    // a type is queued when its window or (under chaos) its pool is not empty
    const bool queued = any_win || any_pool;
    const bool active = (next_sub < N) || any_busy || queued;
    const bool can_sched = (m_free > 0) && queued && any_free;

    // the lane has drained: it stays so, the rest of its rows are pads
    if (!active) break;
    const int row = (p.log_offset + step) * T + lane;

    if (can_sched) {
      // ---- form one group (paper Steps 1-5) ----
      F m_thr = f_ceil(work / (k_c * s_c));
      m_thr = f_max(m_thr, F(1));
      int m_grp = min((int)m_thr, m_free);
      m_grp = max(m_grp, 0);
      const F m_f = (F)m_grp;
      const F dur = s + work / (F)max(m_grp, 1);
      F t_gfin, useful_end;
      F stash_w = 0, stash_old = INF;
      int code = 0;
      if (!HAS_CHAOS) {
        t_gfin = t + dur;
        useful_end = t_gfin;
      } else {
        const F tiny = Lim<F>::tiny();
        const bool inject = requeues < p.r_cap;
        const int gslot = min(n_groups, p.L_cap - 1);
        const F u1v = p.u1[gslot * L + il];
        const F u2v = p.u2[gslot * L + il];
        const bool stretched = inject && (u1v < c_prob);
        const F dur_s = stretched ? s + (work / m_f) * c_factor : dur;
        const F deadline = c_dead * dur;
        const bool killed = inject && (dur_s > deadline);
        const F dur_c = killed ? deadline : dur_s;
        const F t_fail =
            -f_log(f_max(u2v, tiny)) * (c_mtbf * F(3600)) / m_f;
        const bool failed = inject && (c_mtbf > F(0)) && (t_fail < dur_c);
        const F run_done = f_max(f_min(t_fail, dur_c) - s, F(0));
        const F ckpt_done =
            f_floor(run_done / f_max(c_ckpt, tiny)) * c_ckpt;
        const F stretch = stretched ? c_factor : F(1);
        const F credit =
            failed ? ckpt_done * m_f / stretch
                   : (killed ? f_max(dur_c - s, F(0)) * m_f / stretch
                             : work);
        const F lost = failed ? (run_done - ckpt_done) * m_f : F(0);

        t_gfin = t + dur_c;
        useful_end = failed ? (t + s) + ckpt_done : t_gfin;
        const bool requeued = failed || killed;
        // stash the requeue span + credit for the finish event
        const int p_cnt = pc_j % N1;
        const int meta = pc_j / N1;
        const int p_lo = meta >> 1;
        const bool p_frag = (meta & 1) == 1;
        const bool has_pool = p_cnt > 0;
        const int qlo = has_pool ? p_lo : head_j;
        const F res0 =
            has_pool ? f_max((head_w - prefw[j * N1 + qlo]) - pool_w_j,
                             F(0))
                     : F(0);
        const bool walk_ok = !(has_pool && p_frag);
        const F avail = res0 + credit;
        const int span_code = 1 + qlo * N1 + tail_j;
        const F rem_agg = work - credit;
        const bool a_has = requeued && (rem_agg > EPS9);
        const int a_cnt = (tail_j - head_j) + p_cnt;
        const bool walk_req = requeued && walk_ok;
        code = walk_req ? span_code : (a_has ? -a_cnt : 0);
        stash_w = walk_req ? avail : (a_has ? f_max(rem_agg, F(0)) : F(0));
        stash_old = (a_has && !walk_ok) ? oldest_j : INF;

        lost_work = lost_work + lost;
        failures += failed ? 1 : 0;
        kills += (killed && !failed) ? 1 : 0;
        requeues += requeued ? 1 : 0;
      }
      const F busy_inc = m_f * window_overlap(t, t_gfin, t_last);
      const F useful_inc = m_f * window_overlap(t + s, useful_end, t_last);
      m_free -= m_grp;
      busy_ns = busy_ns + busy_inc;
      useful_ns = useful_ns + useful_inc;
      n_groups += 1;

      __syncwarp();   // every thread has read what thread 0 overwrites
      if (lead) {
        if (HAS_CHAOS) {
          p.pool_w[j * T + lane] = F(0);
          p.pool_oldest[j * T + lane] = INF;
          p.pool_code[j * T + lane] = 0;
          p.grp_jtype[sslot * T + lane] = j;
          p.grp_rem_w[sslot * T + lane] = stash_w;
          p.grp_rem_cnt[sslot * T + lane] = code;
          p.grp_rem_oldest[sslot * T + lane] = stash_old;
        }
        head_p[j * rs] = tail_j;
        ring_p[sslot * rs] = t_gfin;
        p.grp_m[sslot * T + lane] = m_grp;
        p.log_key[row] = j * N1 + tail_j;
        p.log_t[row] = t;
        p.log_m[row] = m_grp;
        p.log_hw[row] = head_w;
      }
    } else {
      // ---- consume one event: a submission or a group finish ----
      const F t_sub = (next_sub < N) ? sub_t : INF;
      const bool take_sub = t_sub <= t_efin;
      const F t_new = take_sub ? t_sub : t_efin;
      F qlen = (F)qsum;
      if (HAS_CHAOS) qlen = qlen + (F)psum;
      const F q_inc = qlen * window_overlap(t, t_new, t_last);

      if (take_sub) {
        const int new_tail = tail_p[sub_j * rs] + 1;
        next_sub += 1;
        __syncwarp();
        if (lead) tail_p[sub_j * rs] = new_tail;
      } else {
        int j_f = 0, new_code = 0, cnt_r = 0;
        bool inc = false;
        F new_pool_w = 0, new_pool_old = INF;
        if (HAS_CHAOS) {
          // resolve the stashed requeue span into its member set (the
          // deferred credit walk) and merge it into the per-type pool
          j_f = p.grp_jtype[eslot * T + lane];
          const int code = p.grp_rem_cnt[eslot * T + lane];
          const F stored_w = p.grp_rem_w[eslot * T + lane];
          const F stored_old = p.grp_rem_oldest[eslot * T + lane];
          const F* row_w = prefw + j_f * N1;
          const bool walk = code > 0;
          const int span = max(code - 1, 0);
          const int qlo = span / N1;
          const int hi = span % N1;
          const F qlo_w = row_w[qlo];
          const F hi_w = row_w[hi];
          const F target = (qlo_w + stored_w) + EPS9;
          int lo = qlo, hi2 = hi;
          for (int it = 0; it < p.cut_steps; ++it) {
            const int mid = (lo + hi2 + 1) >> 1;
            const bool go = row_w[mid] <= target;
            lo = go ? mid : lo;
            hi2 = go ? hi2 : mid - 1;
          }
          const int cut = lo;
          const F cut_w = row_w[cut];
          const F m_res = f_max(stored_w - (cut_w - qlo_w), F(0));
          const F m_w = f_max((hi_w - cut_w) - m_res, F(0));
          const int m_cnt = hi - cut;
          const F m_old = tsub[j_f * N + min(cut, N - 1)];
          cnt_r = walk ? m_cnt : -code;
          const F rem_w_r = walk ? m_w : stored_w;
          const F rem_old_r = (walk && m_cnt > 0) ? m_old : stored_old;
          const int rem_lo_r = walk ? cut : 0;

          const int opc = p.pool_code[j_f * T + lane];
          const int old_cnt = opc % N1;
          const int ometa = opc / N1;
          const int old_lo = ometa >> 1;
          const bool old_frag = (ometa & 1) == 1;
          inc = cnt_r > 0;
          const bool was_empty = old_cnt == 0;
          const bool contig = hi == head_p[j_f * rs];
          const bool frag =
              inc ? (old_frag || !walk || !was_empty || !contig) : old_frag;
          const int new_lo = was_empty ? rem_lo_r : min(old_lo, rem_lo_r);
          new_code = (new_lo * 2 + (frag ? 1 : 0)) * N1 + old_cnt + cnt_r;
          new_pool_w = p.pool_w[j_f * T + lane] + rem_w_r;
          new_pool_old = f_min(p.pool_oldest[j_f * T + lane], rem_old_r);
          requeued_jobs += cnt_r;
        }
        m_free += e_m;
        __syncwarp();   // every thread has read what thread 0 overwrites
        if (lead) {
          if (HAS_CHAOS) {
            p.pool_w[j_f * T + lane] = new_pool_w;
            p.pool_oldest[j_f * T + lane] = new_pool_old;
            if (inc) p.pool_code[j_f * T + lane] = new_code;
            p.grp_rem_w[eslot * T + lane] = F(0);
            p.grp_rem_cnt[eslot * T + lane] = 0;
            p.grp_rem_oldest[eslot * T + lane] = INF;
          }
          ring_p[eslot * rs] = INF;
          p.grp_m[eslot * T + lane] = 0;
        }
      }
      t = t_new;
      qlen_int = qlen_int + q_inc;
      if (lead) write_pad(p.log_key, p.log_t, p.log_m, p.log_hw, row);
    }
    __syncwarp();   // thread 0's writes are seen by the next event's reads
  }

  // rows after the lane drained
  for (int st = step + lid; st < p.n_steps; st += 32)
    write_pad(p.log_key, p.log_t, p.log_m, p.log_hw,
              (p.log_offset + st) * T + lane);
  if (RING_SMEM) {
    for (int r = lid; r < ring; r += 32) p.grp_end[r * T + lane] = ring_p[r];
    for (int h = lid; h < H; h += 32) {
      p.head[h * T + lane] = head_p[h];
      p.tail[h * T + lane] = tail_p[h];
    }
  }
  if (!lead) return;
  p.t[lane] = t; p.next_sub[lane] = next_sub; p.m_free[lane] = m_free;
  p.qlen_int[lane] = qlen_int; p.busy_ns[lane] = busy_ns;
  p.useful_ns[lane] = useful_ns; p.n_groups[lane] = n_groups;
  if (HAS_CHAOS) {
    p.lost_work[lane] = lost_work; p.failures[lane] = failures;
    p.straggler_kills[lane] = kills; p.requeues[lane] = requeues;
    p.requeued_jobs[lane] = requeued_jobs;
  }
}

template <typename F, bool HAS_CHAOS, bool RING_SMEM>
int launch_variant(const Params<F>& p, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        packet_step_kernel<F, HAS_CHAOS, RING_SMEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  packet_step_kernel<F, HAS_CHAOS, RING_SMEM>
      <<<p.T, 32, (size_t)smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename F, bool HAS_CHAOS>
int launch(const void* const* in, void* const* st, void* const* logs,
           const int* dims, const int* plan, cudaStream_t stream) {
  Params<F> p;
  p.prefw = (const F*)in[0]; p.tsub = (const F*)in[1];
  p.submit = (const F*)in[2]; p.jtype = (const int*)in[3];
  p.k = (const F*)in[4]; p.s = (const F*)in[5];
  p.p_j = (const F*)in[6]; p.tmax_j = (const F*)in[7];
  p.t_last = (const F*)in[8];
  p.u1 = (const F*)in[9]; p.u2 = (const F*)in[10];
  p.mtbf = (const F*)in[11]; p.ckpt = (const F*)in[12];
  p.prob = (const F*)in[13]; p.factor = (const F*)in[14];
  p.dead = (const F*)in[15];
  p.t = (F*)st[0]; p.next_sub = (int*)st[1]; p.head = (int*)st[2];
  p.tail = (int*)st[3]; p.m_free = (int*)st[4]; p.grp_end = (F*)st[5];
  p.grp_m = (int*)st[6]; p.qlen_int = (F*)st[7]; p.busy_ns = (F*)st[8];
  p.useful_ns = (F*)st[9]; p.n_groups = (int*)st[10];
  p.pool_w = (F*)st[11]; p.pool_oldest = (F*)st[12];
  p.pool_code = (int*)st[13]; p.grp_jtype = (int*)st[14];
  p.grp_rem_w = (F*)st[15]; p.grp_rem_cnt = (int*)st[16];
  p.grp_rem_oldest = (F*)st[17]; p.lost_work = (F*)st[18];
  p.failures = (int*)st[19]; p.straggler_kills = (int*)st[20];
  p.requeues = (int*)st[21]; p.requeued_jobs = (int*)st[22];
  p.log_key = (int*)logs[0]; p.log_t = (F*)logs[1];
  p.log_m = (int*)logs[2]; p.log_hw = (F*)logs[3];
  p.T = dims[0]; p.H = dims[1]; p.N = dims[2]; p.ring = dims[3];
  p.r_cap = dims[4]; p.L_cap = dims[5]; p.cut_steps = dims[6];
  p.log_offset = dims[7]; p.n_steps = dims[8]; p.W = dims[9];
  const long long smem = plan[0];
  const bool ring_in_smem = plan[1] != 0;
  // a plan that does not hold what the shared-memory ring touches is
  // refused before any launch
  const long long need =
      (long long)p.ring * sizeof(F) + 2LL * p.H * sizeof(int);
  if ((ring_in_smem && smem < need) || (!ring_in_smem && smem != 0))
    return (int)cudaErrorInvalidValue;
  if (p.W < 1 || p.T % p.W != 0) return (int)cudaErrorInvalidValue;
  if (ring_in_smem) return launch_variant<F, HAS_CHAOS, true>(p, smem, stream);
  return launch_variant<F, HAS_CHAOS, false>(p, 0, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   in[16]:  the 9 read-only operands, then the 7 chaos operands (or null)
//   st[23]:  the state columns in ScanState order
//   logs[4]: key, t, m, head_w
//   dims[10]: T, H, N, ring, r_cap, L_cap, cut_steps, log_offset, n_steps,
//            W (the cohort's members; T lanes = W x L)
//   plan[2]: dynamic shared bytes of the block, ring in shared memory (1)
//            or device memory (0); kernel.py :: launch_plan makes it
// Launches T blocks of one warp (one lane each) on `stream`, does not
// synchronise, allocates nothing. Returns cudaGetLastError() of the launch
// (0 = accepted), or the error of raising the block's shared-memory limit,
// or cudaErrorInvalidValue for a plan that does not hold the shape.
extern "C" int packet_step_launch(int is_f64, int has_chaos,
                                  const void* const* in, void* const* st,
                                  void* const* logs, const int* dims,
                                  const int* plan, void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  if (is_f64) {
    return has_chaos ? launch<double, true>(in, st, logs, dims, plan, cs)
                     : launch<double, false>(in, st, logs, dims, plan, cs);
  }
  return has_chaos ? launch<float, true>(in, st, logs, dims, plan, cs)
                   : launch<float, false>(in, st, logs, dims, plan, cs);
}
