// While-loop DES engine of the Packet scheduling simulator, for Hopper,
// with the group-formation decision inlined.
//
// Replaces two things of the reference. First, the TPU kernel
// `_select_kernel` of src/repro/kernels/packet_select/kernel.py (entry
// `packet_select`), the group-formation decision, which the port's plain
// engine calls once per formation over all lanes (and which the port's
// csrc/packet_select.cu still computes on that plain path). Second, the
// while loop around it: `simulate_packet` of src/repro/core/des.py, an
// event loop with a nested group-formation loop, which the reference runs
// under `lax.while_loop` and the port's plain version
// (repro_torch/kernels/packet_while/ref.py) runs over the lanes in
// lockstep, with some 40 eager launches an event, 55 and a decision launch
// a formation and a host read of a boolean at every loop test. Here ONE
// launch runs every lane to its end:
//
//     while ((next_sub < N || m_free < M) && iters < max_iters) {
//       event();                               // a submission or a finish
//       while (m_free > 0 && any free slot && any queued type) form();
//     }
//
// What bounds it on this card: latency. A lane is a dependent chain of its
// outer iterations plus its formations (about 6 600 steps a lane for the
// paper's homog0.85 flow, 15 000 for hetero0.85): each step reads what
// the last one wrote. The bytes (the workload's tables, read once, and
// the group log and final state, written once) and the operations (a ring
// scan and a pass over the job types a step) bound a 222-lane call at
// 0.01-0.07 ms (PERF.md); the chain's latency is what is left.
//
// What this design does about that: ONE WARP PER LANE, one lane a block
// (grid T, 32 threads), and no host in the loop. The lanes are
// independent, so each warp runs its own loop to its own end: there is no
// lockstep, and a short lane does not wait for a long one. Inside a warp:
// - the lane's per-type rows (`head`, `tail`, and under chaos the pools)
//   and ring rows (`grp_end`, `grp_m`, and under chaos the requeue stash)
//   live in dynamic shared memory for the whole launch, staged at the
//   start and written back at the end. Where they do not fit the 227 KB a
//   block may opt into, the RING_SMEM = false instantiation works on the
//   same rows of the lane-major state in device memory (stride 1 either
//   way); the launch plan (kernel.py :: launch_plan) picks it and sizes
//   the shared memory, so no shape is refused;
// - the ring scans run over 32 threads (thread i takes slots i, i + 32,
//   ...) and end in warp reductions (redux.sync over order-preserving
//   keys): the earliest finish for an event, the first free slot for a
//   formation. A scan is made only when the ring changed since the last:
//   a finish frees one slot, so the first free slot after it is the
//   lesser of the old one and that slot, and a submission changes nothing;
// - the decision's per-type phase runs one type a thread (a loop of stride
//   32 for H > 32): queue sum, age and weight, then the first-index argmax
//   by warp reductions; the priorities and T_max of the first 32 types
//   stay in registers for the whole launch;
// - the scalar updates of `event` and `form` run uniformly in every thread
//   of the warp on the same operands (no broadcast needed); thread 0 alone
//   writes, between two __syncwarp()s;
// - the group log [T, L], the output the post-pass reads, is written row
//   by row (a formed group a row) to device memory; the workload's tables
//   `tj_prefw` [H, N+1], `tj_submit` [H, N], `submit` [N] and `jtype` [N]
//   are read by every lane through the read-only path and stay in L2.
// What it does not do: run more than one lane a warp or more than one
// workload a launch, so 222 warps leave most of each SM's issue slots
// idle; or overlap one step's loads with the last step's scalar update.
//
// Why the warp reductions equal the plain version's first-index rules.
// `grp_end` holds finite times and +inf (a free slot) only, never NaN, so
// `<` and `==` order it totally (-0 and +0 compare equal).
// - first free slot (`torch.argmax(free.to(int8))`): each thread keeps the
//   least free slot of its subset; the least of those (__reduce_min_sync)
//   is the least free slot overall; a formation runs only when one exists;
// - earliest finish (`torch.argmin(grp_end)`, the first index of the
//   minimum, 0 when every slot is +inf): each thread scans its slots in
//   increasing order with a strict `<` from (+inf, its first slot), so it
//   keeps the first index of its subset's minimum (its first slot when that
//   minimum is +inf). The warp's minimum comes from __reduce_min_sync over
//   order-preserving integer keys (equal values have equal keys), and the
//   least index among the threads at that minimum is the first index of
//   the minimum overall; its time is the winning thread's own value, so
//   its bits are those of grp_end[slot];
// - argmax over types (`packet_select.cu`'s serial `h == 0 || w > best`):
//   that rule starts from w_0; if w_0 is NaN nothing compares greater and
//   j = 0; otherwise it keeps the first index of the largest non-NaN
//   weight (-0 and +0 tie). The warp reduces keys: the order-preserving
//   key of each non-NaN weight, the largest key for a NaN at type 0 and 0,
//   below every non-NaN key, for a NaN elsewhere and for threads past H.
//   The first index of the largest key (__reduce_max_sync, then
//   __reduce_min_sync over the indices at it) is then the serial j; a
//   later block of 32 types replaces it only with a strictly larger key;
// - queue lengths are integer sums (__reduce_add_sync), exact in any
//   order, cast once to the float type, as the plain `torch.sum(...).to()`.
//
// Arithmetic contract: compiled with -fmad=false and without fast math, so
// every multiply, add and divide rounds on its own, in the order of the
// plain version: the decision as csrc/packet_select.cu computes it (the
// duration adds the unclamped s, the node threshold is cast to int32 as
// XLA casts, saturating), the chaos outcome, the credit walk and the pool
// merge as core/des.py's `_chaos_outcome`, `_resolve_remnant` and
// `_pool_decode`, the queue-length integral as `qlen * overlap` with
// `qlen` an integer sum cast once. The helpers shared with
// csrc/packet_step.cu (the order-preserving keys, the warp reductions,
// the window overlap) are copied here rather than moved into a header, so
// that the event-step kernel's build stays as it was measured.

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

// maximum(x, lo) with torch.clamp's NaN rule: a NaN stays NaN.
template <typename F>
__device__ inline F clamp_min(F x, F lo) { return x < lo ? lo : x; }

// float -> int32 as XLA converts: NaN -> 0, out of range -> nearer limit.
template <typename F>
__device__ inline int saturating_int32(F x) {
  if (isnan(x)) return 0;
  if (x >= F(2147483648.0)) return 2147483647;
  if (x <= F(-2147483648.0)) return -2147483647 - 1;
  return (int)x;
}

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
// `h == 0 || w > best`: the order of the weights, except that a NaN at
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

template <typename F>
struct Params {
  // workload tables and lane parameters (read only)
  const F* prefw;    // [H, N+1]
  const F* tsub;     // [H, N]
  const F* submit;   // [N]
  const int* jtype;  // [N]
  const F* k;        // [T]
  const F* s;        // [T]
  const F* p_j;      // [H]
  const F* tmax_j;   // [H]
  const F* t_end;    // []
  // chaos operands (null when HAS_CHAOS is false)
  const F* u1;       // [L, T]
  const F* u2;       // [L, T]
  const F* mtbf;     // [T]
  const F* ckpt;
  const F* prob;
  const F* factor;
  const F* dead;
  // the 28 DesState columns, lane-major, updated in place
  F* t; int* next_sub; int* head; int* tail; int* m_free;
  F* grp_end; int* grp_m;
  int* log_key; F* log_t; int* log_m; F* log_hw;
  F* qlen_int; F* busy_ns; F* useful_ns; int* n_groups; int* iters;
  F* pool_w; F* pool_oldest; int* pool_code;
  int* grp_jtype; F* grp_rem_w; int* grp_rem_cnt; F* grp_rem_oldest;
  F* lost_work; int* failures; int* straggler_kills; int* requeues;
  int* requeued_jobs;
  int T, H, N, ring, L, M, r_cap, max_iters, cut_steps;
};

// One lane's per-type and ring rows: in shared memory, or the lane's rows
// of the state columns themselves.
template <typename F>
struct Cols {
  F* end; int* m;                              // ring
  int* head; int* tail;                        // types
  F* rem_w; F* rem_old; int* jt; int* rem_cnt; // ring, chaos
  F* pool_w; F* pool_old; int* pool_code;      // types, chaos
};

template <typename F, bool HAS_CHAOS, bool RING_SMEM>
__global__ void __launch_bounds__(32)
packet_while_kernel(const Params<F> p) {
  const int lid = threadIdx.x;
  const int lane = blockIdx.x;
  const int T = p.T, H = p.H, N = p.N, ring = p.ring;
  const int N1 = N + 1;
  const F INF = Lim<F>::inf();
  const F EPS9 = F(1e-9);
  const bool lead = lid == 0;
  const size_t ro = (size_t)lane * ring, ho = (size_t)lane * H;

  // the float rows first, then the int rows (kernel.py :: lane_smem_bytes)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cols<F> c{};
  if constexpr (RING_SMEM) {
    F* fp = reinterpret_cast<F*>(smem_raw);
    c.end = fp; fp += ring;
    if (HAS_CHAOS) {
      c.rem_w = fp; fp += ring;
      c.rem_old = fp; fp += ring;
      c.pool_w = fp; fp += H;
      c.pool_old = fp; fp += H;
    }
    int* ip = reinterpret_cast<int*>(fp);
    c.m = ip; ip += ring;
    c.head = ip; ip += H;
    c.tail = ip; ip += H;
    if (HAS_CHAOS) {
      c.jt = ip; ip += ring;
      c.rem_cnt = ip; ip += ring;
      c.pool_code = ip;
    }
    for (int r = lid; r < ring; r += 32) {
      c.end[r] = p.grp_end[ro + r];
      c.m[r] = p.grp_m[ro + r];
      if (HAS_CHAOS) {
        c.rem_w[r] = p.grp_rem_w[ro + r];
        c.rem_old[r] = p.grp_rem_oldest[ro + r];
        c.jt[r] = p.grp_jtype[ro + r];
        c.rem_cnt[r] = p.grp_rem_cnt[ro + r];
      }
    }
    for (int h = lid; h < H; h += 32) {
      c.head[h] = p.head[ho + h];
      c.tail[h] = p.tail[ho + h];
      if (HAS_CHAOS) {
        c.pool_w[h] = p.pool_w[ho + h];
        c.pool_old[h] = p.pool_oldest[ho + h];
        c.pool_code[h] = p.pool_code[ho + h];
      }
    }
    __syncwarp();
  } else {
    c.end = p.grp_end + ro; c.m = p.grp_m + ro;
    c.head = p.head + ho; c.tail = p.tail + ho;
    c.rem_w = p.grp_rem_w + ro; c.rem_old = p.grp_rem_oldest + ro;
    c.jt = p.grp_jtype + ro; c.rem_cnt = p.grp_rem_cnt + ro;
    c.pool_w = p.pool_w + ho; c.pool_old = p.pool_oldest + ho;
    c.pool_code = p.pool_code + ho;
  }
  int* const log_key = p.log_key + (size_t)lane * p.L;
  F* const log_t = p.log_t + (size_t)lane * p.L;
  int* const log_m = p.log_m + (size_t)lane * p.L;
  F* const log_hw = p.log_hw + (size_t)lane * p.L;

  // per-lane scalars: the same value in every thread of the warp
  const F k = p.k[lane], s = p.s[lane], t_end = p.t_end[0];
  F t = p.t[lane], qlen_int = p.qlen_int[lane], busy_ns = p.busy_ns[lane],
    useful_ns = p.useful_ns[lane], lost_work = 0;
  F c_mtbf = 0, c_ckpt = 0, c_prob = 0, c_factor = 0, c_dead = 0;
  int next_sub = p.next_sub[lane], m_free = p.m_free[lane],
      n_groups = p.n_groups[lane], iters = p.iters[lane], failures = 0,
      kills = 0, requeues = 0, requeued_jobs = 0;
  if (HAS_CHAOS) {
    c_mtbf = p.mtbf[lane]; c_ckpt = p.ckpt[lane]; c_prob = p.prob[lane];
    c_factor = p.factor[lane]; c_dead = p.dead[lane];
    lost_work = p.lost_work[lane]; failures = p.failures[lane];
    kills = p.straggler_kills[lane]; requeues = p.requeues[lane];
    requeued_jobs = p.requeued_jobs[lane];
  }
  const F s_c = clamp_min(s, EPS9);   // the decision's clamped s and k
  const F k_c = clamp_min(k, EPS9);
  // the priority and clamped T_max of type lid, for the whole launch
  const F pj0 = lid < H ? p.p_j[lid] : F(0);
  const F tm0 = lid < H ? clamp_min(p.tmax_j[lid], EPS9) : F(1);

  // the ring's first index of the minimum (eslot, t_efin) and first free
  // slot (sslot, any_free); eslot is stale after a finish
  int eslot = 0, sslot = 0;
  bool any_free = false, stale = true;
  F t_efin = INF;
  auto scan_ring = [&]() {
    F vmin = INF;
    int vidx = lid, vfree = INT_MAX;
#pragma unroll 4
    for (int r = lid; r < ring; r += 32) {
      const F e = c.end[r];
      vfree = (e == INF && vfree == INT_MAX) ? r : vfree;
      if (e < vmin) { vmin = e; vidx = r; }
    }
    eslot = warp_first_min(vmin, vidx);
    t_efin = __shfl_sync(FULL, vmin, eslot & 31);
    sslot = __reduce_min_sync(FULL, vfree);
    any_free = sslot != INT_MAX;
    stale = false;
  };

  while ((next_sub < N || m_free < p.M) && iters < p.max_iters) {
    // ---- one event: the next submission or the earliest finish ----
    // the submission's operands, loaded before the scans that do not
    // need them
    const int sub_idx = min(next_sub, N - 1);
    const F sub_t = __ldg(p.submit + sub_idx);
    const int sub_j = __ldg(p.jtype + sub_idx);
    if (stale) scan_ring();
    int qpart = 0, ppart = 0;
    for (int h = lid; h < H; h += 32) {
      qpart += c.tail[h] - c.head[h];
      if (HAS_CHAOS) ppart += c.pool_code[h] % N1;
    }
    const F t_sub = next_sub < N ? sub_t : INF;
    const bool take_sub = t_sub <= t_efin;
    const F t_new = take_sub ? t_sub : t_efin;
    F qlen = (F)__reduce_add_sync(FULL, qpart);
    if (HAS_CHAOS) qlen = qlen + (F)__reduce_add_sync(FULL, ppart);
    const F q_inc = qlen * window_overlap(t, t_new, t_end);
    qlen_int = qlen_int + q_inc;
    t = t_new;
    if (take_sub) {
      const int new_tail = c.tail[sub_j] + 1;
      next_sub += 1;
      __syncwarp();
      if (lead) c.tail[sub_j] = new_tail;
    } else {
      int j_f = 0, new_code = 0;
      bool inc = false;
      F new_pool_w = 0, new_pool_old = INF;
      if (HAS_CHAOS) {
        // resolve the stashed requeue span into its member set (the
        // deferred credit walk) and merge it into the type's pool
        j_f = c.jt[eslot];
        const int code = c.rem_cnt[eslot];
        const F stored_w = c.rem_w[eslot];
        const F stored_old = c.rem_old[eslot];
        const F* row_w = p.prefw + (size_t)j_f * N1;
        const bool walk = code > 0;
        const int span = max(code - 1, 0);
        const int qlo = span / N1;
        const int hi = span % N1;
        const F qlo_w = __ldg(row_w + qlo);
        const F hi_w = __ldg(row_w + hi);
        const F target = (qlo_w + stored_w) + EPS9;
        int lo = qlo, hi2 = hi;
        for (int it = 0; it < p.cut_steps; ++it) {
          const int mid = (lo + hi2 + 1) >> 1;
          const bool go = __ldg(row_w + mid) <= target;
          lo = go ? mid : lo;
          hi2 = go ? hi2 : mid - 1;
        }
        const int cut = lo;
        const F cut_w = __ldg(row_w + cut);
        const F m_res = f_max(stored_w - (cut_w - qlo_w), F(0));
        const F m_w = f_max((hi_w - cut_w) - m_res, F(0));
        const int m_cnt = hi - cut;
        const F m_old = __ldg(p.tsub + (size_t)j_f * N + min(cut, N - 1));
        const int cnt_r = walk ? m_cnt : -code;
        const F rem_w_r = walk ? m_w : stored_w;
        const F rem_old_r = (walk && m_cnt > 0) ? m_old : stored_old;
        const int rem_lo_r = walk ? cut : 0;

        const int opc = c.pool_code[j_f];
        const int old_cnt = opc % N1;
        const int ometa = opc / N1;
        const int old_lo = ometa >> 1;
        const bool old_frag = (ometa & 1) == 1;
        inc = cnt_r > 0;
        const bool was_empty = old_cnt == 0;
        const bool contig = hi == c.head[j_f];
        const bool frag =
            inc ? (old_frag || !walk || !was_empty || !contig) : old_frag;
        const int new_lo = was_empty ? rem_lo_r : min(old_lo, rem_lo_r);
        new_code = (new_lo * 2 + (frag ? 1 : 0)) * N1 + old_cnt + cnt_r;
        new_pool_w = c.pool_w[j_f] + rem_w_r;
        new_pool_old = f_min(c.pool_old[j_f], rem_old_r);
        requeued_jobs += cnt_r;
      }
      m_free += c.m[eslot];
      __syncwarp();   // every thread has read what thread 0 overwrites
      if (lead) {
        if (HAS_CHAOS) {
          c.pool_w[j_f] = new_pool_w;
          c.pool_old[j_f] = new_pool_old;
          if (inc) c.pool_code[j_f] = new_code;
          c.rem_w[eslot] = F(0);
          c.rem_cnt[eslot] = 0;
          c.rem_old[eslot] = INF;
        }
        c.end[eslot] = INF;
        c.m[eslot] = 0;
      }
      // the slot just freed; the earliest finish is now stale
      sslot = any_free ? min(sslot, eslot) : eslot;
      any_free = true;
      stale = true;
    }
    iters += 1;
    __syncwarp();   // thread 0's writes are seen by the reads that follow

    // ---- form groups until the lane is blocked (paper Steps 1-5) ----
    while (m_free > 0 && any_free) {
      bool queued = false;
      for (int h = lid; h < H; h += 32) {
        queued |= c.tail[h] > c.head[h];
        if (HAS_CHAOS) queued |= c.pool_code[h] > 0;
      }
      if (!__any_sync(FULL, queued)) break;

      // the types: queue sums, ages, weights, first argmax
      int j = 0, head_j = 0, tail_j = 0, pc_j = 0;
      unsigned long long best_key = 0;
      F work = 0, oldest_j = INF, head_w = 0, pool_w_j = 0;
      for (int h0 = 0; h0 < H; h0 += 32) {
        const int h = h0 + lid;
        F w = -INF, sw = 0, old = INF, pw_hd = 0, pwv = 0;
        int hd = 0, tl = 0, pc = 0;
        if (h < H) {
          hd = c.head[h];
          tl = c.tail[h];
          bool ne = tl > hd;
          const F* row_w = p.prefw + (size_t)h * N1;
          pw_hd = __ldg(row_w + hd);
          sw = __ldg(row_w + tl) - pw_hd;
          old = __ldg(p.tsub + (size_t)h * N + min(hd, N - 1));
          if (HAS_CHAOS) {
            pc = c.pool_code[h];
            pwv = c.pool_w[h];
            ne = ne || pc > 0;
            // requeued remainder counts toward weight / age / emptiness
            sw = sw + pwv;
            old = f_min(old, c.pool_old[h]);
          }
          const F pj = h0 == 0 ? pj0 : p.p_j[h];
          const F tm = h0 == 0 ? tm0 : clamp_min(p.tmax_j[h], EPS9);
          const F c_j = sw / s_c;
          const F t_cur = clamp_min(t - old, F(0));
          w = (c_j * pj) * (F(1) + t_cur / tm);
          w = ne ? w : -INF;
        }
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
            pool_w_j = __shfl_sync(FULL, pwv, hit);
          }
        }
      }

      // node count and duration (packet_select.cu's decision)
      F m_thr = f_ceil(work / (k_c * s_c));
      m_thr = clamp_min(m_thr, F(1));
      int m_grp = min(saturating_int32(m_thr), m_free);
      m_grp = max(m_grp, 0);
      const F m_f = (F)m_grp;
      const F dur = s + work / (F)max(m_grp, 1);
      const int gslot = min(n_groups, p.L - 1);
      F t_gfin, useful_end;
      F stash_w = 0, stash_old = INF;
      int code = 0;
      if (!HAS_CHAOS) {
        t_gfin = t + dur;
        useful_end = t_gfin;
      } else {
        const F tiny = Lim<F>::tiny();
        const bool inject = requeues < p.r_cap;
        const F u1v = __ldg(p.u1 + (size_t)gslot * T + lane);
        const F u2v = __ldg(p.u2 + (size_t)gslot * T + lane);
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
            has_pool ? f_max((head_w - __ldg(p.prefw + (size_t)j * N1 + qlo))
                                 - pool_w_j, F(0))
                     : F(0);
        const bool walk_ok = !(has_pool && p_frag);
        const int span_code = 1 + qlo * N1 + tail_j;
        const F rem_agg = work - credit;
        const bool a_has = requeued && (rem_agg > EPS9);
        const int a_cnt = (tail_j - head_j) + p_cnt;
        const bool walk_req = requeued && walk_ok;
        code = walk_req ? span_code : (a_has ? -a_cnt : 0);
        stash_w = walk_req ? res0 + credit
                           : (a_has ? f_max(rem_agg, F(0)) : F(0));
        stash_old = (a_has && !walk_ok) ? oldest_j : INF;

        lost_work = lost_work + lost;
        failures += failed ? 1 : 0;
        kills += (killed && !failed) ? 1 : 0;
        requeues += requeued ? 1 : 0;
      }
      const F busy_inc = m_f * window_overlap(t, t_gfin, t_end);
      const F useful_inc = m_f * window_overlap(t + s, useful_end, t_end);
      m_free -= m_grp;
      busy_ns = busy_ns + busy_inc;
      useful_ns = useful_ns + useful_inc;
      n_groups += 1;

      __syncwarp();   // every thread has read what thread 0 overwrites
      if (lead) {
        if (HAS_CHAOS) {
          c.jt[sslot] = j;
          c.rem_w[sslot] = stash_w;
          c.rem_cnt[sslot] = code;
          c.rem_old[sslot] = stash_old;
          c.pool_w[j] = F(0);
          c.pool_old[j] = INF;
          c.pool_code[j] = 0;
        }
        log_key[gslot] = j * N1 + tail_j;
        log_t[gslot] = t;
        log_m[gslot] = m_grp;
        log_hw[gslot] = head_w;
        c.head[j] = tail_j;   // drain all
        c.end[sslot] = t_gfin;
        c.m[sslot] = m_grp;
      }
      __syncwarp();   // thread 0's writes are seen by the scan
      scan_ring();
    }
  }

  if (RING_SMEM) {
    for (int r = lid; r < ring; r += 32) {
      p.grp_end[ro + r] = c.end[r];
      p.grp_m[ro + r] = c.m[r];
      if (HAS_CHAOS) {
        p.grp_rem_w[ro + r] = c.rem_w[r];
        p.grp_rem_oldest[ro + r] = c.rem_old[r];
        p.grp_jtype[ro + r] = c.jt[r];
        p.grp_rem_cnt[ro + r] = c.rem_cnt[r];
      }
    }
    for (int h = lid; h < H; h += 32) {
      p.head[ho + h] = c.head[h];
      p.tail[ho + h] = c.tail[h];
      if (HAS_CHAOS) {
        p.pool_w[ho + h] = c.pool_w[h];
        p.pool_oldest[ho + h] = c.pool_old[h];
        p.pool_code[ho + h] = c.pool_code[h];
      }
    }
  }
  if (!lead) return;
  p.t[lane] = t; p.next_sub[lane] = next_sub; p.m_free[lane] = m_free;
  p.qlen_int[lane] = qlen_int; p.busy_ns[lane] = busy_ns;
  p.useful_ns[lane] = useful_ns; p.n_groups[lane] = n_groups;
  p.iters[lane] = iters;
  if (HAS_CHAOS) {
    p.lost_work[lane] = lost_work; p.failures[lane] = failures;
    p.straggler_kills[lane] = kills; p.requeues[lane] = requeues;
    p.requeued_jobs[lane] = requeued_jobs;
  }
}

// Shared bytes one lane's rows need (kernel.py :: lane_smem_bytes).
template <typename F>
long long lane_smem_bytes(int ring, int H, bool chaos) {
  const long long n_float = ring + (chaos ? 2LL * ring + 2LL * H : 0);
  const long long n_int = ring + 2LL * H + (chaos ? 2LL * ring + H : 0);
  return n_float * (long long)sizeof(F) + n_int * 4;
}

template <typename F, bool HAS_CHAOS, bool RING_SMEM>
int launch_variant(const Params<F>& p, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        packet_while_kernel<F, HAS_CHAOS, RING_SMEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  packet_while_kernel<F, HAS_CHAOS, RING_SMEM>
      <<<p.T, 32, (size_t)smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename F, bool HAS_CHAOS>
int launch(const void* const* in, void* const* st, const int* dims,
           const int* plan, cudaStream_t stream) {
  Params<F> p;
  p.prefw = (const F*)in[0]; p.tsub = (const F*)in[1];
  p.submit = (const F*)in[2]; p.jtype = (const int*)in[3];
  p.k = (const F*)in[4]; p.s = (const F*)in[5];
  p.p_j = (const F*)in[6]; p.tmax_j = (const F*)in[7];
  p.t_end = (const F*)in[8];
  p.u1 = (const F*)in[9]; p.u2 = (const F*)in[10];
  p.mtbf = (const F*)in[11]; p.ckpt = (const F*)in[12];
  p.prob = (const F*)in[13]; p.factor = (const F*)in[14];
  p.dead = (const F*)in[15];
  p.t = (F*)st[0]; p.next_sub = (int*)st[1]; p.head = (int*)st[2];
  p.tail = (int*)st[3]; p.m_free = (int*)st[4]; p.grp_end = (F*)st[5];
  p.grp_m = (int*)st[6]; p.log_key = (int*)st[7]; p.log_t = (F*)st[8];
  p.log_m = (int*)st[9]; p.log_hw = (F*)st[10]; p.qlen_int = (F*)st[11];
  p.busy_ns = (F*)st[12]; p.useful_ns = (F*)st[13];
  p.n_groups = (int*)st[14]; p.iters = (int*)st[15];
  p.pool_w = (F*)st[16]; p.pool_oldest = (F*)st[17];
  p.pool_code = (int*)st[18]; p.grp_jtype = (int*)st[19];
  p.grp_rem_w = (F*)st[20]; p.grp_rem_cnt = (int*)st[21];
  p.grp_rem_oldest = (F*)st[22]; p.lost_work = (F*)st[23];
  p.failures = (int*)st[24]; p.straggler_kills = (int*)st[25];
  p.requeues = (int*)st[26]; p.requeued_jobs = (int*)st[27];
  p.T = dims[0]; p.H = dims[1]; p.N = dims[2]; p.ring = dims[3];
  p.L = dims[4]; p.M = dims[5]; p.r_cap = dims[6]; p.max_iters = dims[7];
  p.cut_steps = dims[8];
  if (p.T < 1 || p.H < 1 || p.N < 1 || p.ring < 1 || p.L < 1)
    return (int)cudaErrorInvalidValue;
  const long long smem = plan[0];
  const bool ring_in_smem = plan[1] != 0;
  // a plan that does not hold the lane's rows is refused before any launch
  const long long need = lane_smem_bytes<F>(p.ring, p.H, HAS_CHAOS);
  if ((ring_in_smem && smem < need) || (!ring_in_smem && smem != 0))
    return (int)cudaErrorInvalidValue;
  if (ring_in_smem) return launch_variant<F, HAS_CHAOS, true>(p, smem, stream);
  return launch_variant<F, HAS_CHAOS, false>(p, 0, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   in[16]:  prefw, tsub, submit, jtype, k, s, p_j, tmax_j, t_end, then the
//            7 chaos operands u1, u2, mtbf, ckpt, prob, factor, dead (or
//            null)
//   st[28]:  the DesState columns in their order, lane-major
//   dims[9]: T, H, N, ring, L, M, r_cap, max_iters, cut_steps
//   plan[2]: dynamic shared bytes of the block, the lane's rows in shared
//            memory (1) or device memory (0); kernel.py :: launch_plan
//            makes it
// Launches T blocks of one warp (one lane each) on `stream`, does not
// synchronise, allocates nothing. Returns cudaGetLastError() of the launch
// (0 = accepted), or the error of raising the block's shared-memory limit,
// or cudaErrorInvalidValue for sizes or a plan that do not hold the shape.
extern "C" int packet_while_launch(int is_f64, int has_chaos,
                                   const void* const* in, void* const* st,
                                   const int* dims, const int* plan,
                                   void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  if (is_f64) {
    return has_chaos ? launch<double, true>(in, st, dims, plan, cs)
                     : launch<double, false>(in, st, dims, plan, cs);
  }
  return has_chaos ? launch<float, true>(in, st, dims, plan, cs)
                   : launch<float, false>(in, st, dims, plan, cs);
}
