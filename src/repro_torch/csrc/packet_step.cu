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
// is a dependent chain of about 3N events; each event is a handful of
// gathers into the per-type prefix tables plus a scan of the lane's ring of
// running groups, and the next event cannot start before this one's writes.
// The paper's grid has 222 lanes per workload, which is 7 warps: they occupy
// 7 of the 132 SMs and the rest of the card idles.
//
// What this design does about that: one thread per lane, state kept in the
// lane-minor `[state, T]` layout so the 32 threads of a warp read
// neighbouring addresses, per-lane scalars held in registers across the
// whole loop and written back once per launch, one warp per block so the
// warps spread over separate SMs, and a block stops early (filling its
// remaining log rows with pads) once all of its lanes have drained. What it
// does not do: split one lane's ring scan or type loop across threads, keep
// the ring in shared memory, or batch several workloads into one launch to
// fill the card. Those are later work.
//
// Arithmetic contract: compiled with -fmad=false and without fast math, so
// every multiply, add and divide rounds on its own, in the order the plain
// PyTorch version (repro_torch/kernels/packet_step/ref.py) uses. Ties in the
// argmax over types, the first free ring slot and the argmin over the ring
// all resolve to the FIRST index.

#include <cuda_runtime.h>
#include <math.h>
#include <float.h>

namespace {

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
  // workload tables and lane parameters (read only)
  const F* prefw;    // [H, N+1]
  const F* tsub;     // [H, N]
  const F* submit;   // [N]
  const int* jtype;  // [N]
  const F* k;        // [1, T]
  const F* s;        // [1, T]
  const F* p_j;      // [H]
  const F* tmax_j;   // [H]
  const F* t_last;   // [1, 1]
  // chaos operands (null when HAS_CHAOS is false)
  const F* u1;       // [L_cap, T]
  const F* u2;       // [L_cap, T]
  const F* mtbf;     // [1, T]
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
  int T, H, N, ring, r_cap, L_cap, cut_steps, log_offset, n_steps;
};

// Length of [a, b] clipped to the metric window [0, t_end].
template <typename F>
__device__ inline F window_overlap(F a, F b, F t_end) {
  return f_max(f_min(b, t_end) - f_min(a, t_end), F(0));
}

template <typename F, bool HAS_CHAOS>
__global__ void packet_step_kernel(const Params<F> p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = lane < p.T;
  const int T = p.T, H = p.H, N = p.N, ring = p.ring;
  const int N1 = N + 1;
  const F INF = Lim<F>::inf();
  const F EPS9 = F(1e-9);
  const int KEY_PAD = 0x7fffffff;

  // per-lane scalars live in registers across the whole loop
  F k = 0, s = 0, t_last = 0, t = 0, qlen_int = 0, busy_ns = 0,
    useful_ns = 0, lost_work = 0;
  F c_mtbf = 0, c_ckpt = 0, c_prob = 0, c_factor = 0, c_dead = 0;
  int next_sub = 0, m_free = 0, n_groups = 0, failures = 0, kills = 0,
      requeues = 0, requeued_jobs = 0;
  if (valid) {
    k = p.k[lane]; s = p.s[lane]; t_last = p.t_last[0];
    t = p.t[lane]; next_sub = p.next_sub[lane]; m_free = p.m_free[lane];
    qlen_int = p.qlen_int[lane]; busy_ns = p.busy_ns[lane];
    useful_ns = p.useful_ns[lane]; n_groups = p.n_groups[lane];
    if (HAS_CHAOS) {
      c_mtbf = p.mtbf[lane]; c_ckpt = p.ckpt[lane]; c_prob = p.prob[lane];
      c_factor = p.factor[lane]; c_dead = p.dead[lane];
      lost_work = p.lost_work[lane]; failures = p.failures[lane];
      kills = p.straggler_kills[lane]; requeues = p.requeues[lane];
      requeued_jobs = p.requeued_jobs[lane];
    }
  }
  const F s_c = f_max(s, EPS9);   // maximum(s, 1e-9)
  const F k_c = f_max(k, EPS9);

  int step = 0;
  for (; step < p.n_steps; ++step) {
    bool active = false, can_sched = false;
    int sslot = 0, eslot = 0, j = 0, qsum = 0, psum = 0;
    F t_efin = INF, work = 0, oldest_j = INF;

    if (valid) {
      // one pass over the ring: first free slot, earliest finish, any busy
      bool any_free = false, any_busy = false;
      t_efin = p.grp_end[lane];
      for (int r = 0; r < ring; ++r) {
        const F e = p.grp_end[r * T + lane];
        const bool fr = isinf(e);
        if (fr && !any_free) { sslot = r; any_free = true; }
        any_busy |= !fr;
        if (e < t_efin) { t_efin = e; eslot = r; }
      }
      // one pass over the types: queue sums, weights, first argmax
      bool queued = false, any_win = false, any_pool = false;
      F best_w = 0;
      for (int h = 0; h < H; ++h) {
        const int hd = p.head[h * T + lane];
        const int tl = p.tail[h * T + lane];
        bool ne = tl > hd;
        any_win |= ne;
        qsum += tl - hd;
        F sw = p.prefw[h * N1 + tl] - p.prefw[h * N1 + hd];
        F old = p.tsub[h * N + min(hd, N - 1)];
        if (HAS_CHAOS) {
          const int pc = p.pool_code[h * T + lane];
          ne |= pc > 0;
          any_pool |= pc > 0;
          psum += pc % N1;
          sw = sw + p.pool_w[h * T + lane];
          old = f_min(old, p.pool_oldest[h * T + lane]);
        }
        queued |= ne;
        const F c_j = sw / s_c;
        const F t_cur = f_max(t - old, F(0));
        F w = (c_j * p.p_j[h]) *
              (F(1) + t_cur / f_max(p.tmax_j[h], EPS9));
        w = ne ? w : -INF;
        if (h == 0 || w > best_w) {
          best_w = w; j = h; work = sw; oldest_j = old;
        }
      }
      active = (next_sub < N) || any_busy || any_win ||
               (HAS_CHAOS && any_pool);
      can_sched = (m_free > 0) && queued && any_free;
    }

    // the whole block has drained: stop, the rest of its rows are pads
    if (__syncthreads_and(!active)) break;
    if (!valid) continue;

    const int row = (p.log_offset + step) * T + lane;
    if (!active) {
      p.log_key[row] = KEY_PAD; p.log_t[row] = F(0);
      p.log_m[row] = 0; p.log_hw[row] = F(0);
      continue;
    }

    if (can_sched) {
      // ---- form one group (paper Steps 1-5) ----
      F m_thr = f_ceil(work / (k_c * s_c));
      m_thr = f_max(m_thr, F(1));
      int m_grp = min((int)m_thr, m_free);
      m_grp = max(m_grp, 0);
      const F m_f = (F)m_grp;
      const F dur = s + work / (F)max(m_grp, 1);
      const int head_j = p.head[j * T + lane];
      const int tail_j = p.tail[j * T + lane];
      const F head_w = p.prefw[j * N1 + head_j];
      F t_gfin, useful_end;
      if (!HAS_CHAOS) {
        t_gfin = t + dur;
        useful_end = t_gfin;
      } else {
        const F tiny = Lim<F>::tiny();
        const bool inject = requeues < p.r_cap;
        const int gslot = min(n_groups, p.L_cap - 1);
        const F u1v = p.u1[gslot * T + lane];
        const F u2v = p.u2[gslot * T + lane];
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
        const int pc = p.pool_code[j * T + lane];
        const int p_cnt = pc % N1;
        const int meta = pc / N1;
        const int p_lo = meta >> 1;
        const bool p_frag = (meta & 1) == 1;
        const bool has_pool = p_cnt > 0;
        const int qlo = has_pool ? p_lo : head_j;
        const F pool_w_j = p.pool_w[j * T + lane];
        const F res0 =
            has_pool ? f_max((head_w - p.prefw[j * N1 + qlo]) - pool_w_j,
                             F(0))
                     : F(0);
        const bool walk_ok = !(has_pool && p_frag);
        const F avail = res0 + credit;
        const int span_code = 1 + qlo * N1 + tail_j;
        const F rem_agg = work - credit;
        const bool a_has = requeued && (rem_agg > EPS9);
        const int a_cnt = (tail_j - head_j) + p_cnt;
        const bool walk_req = requeued && walk_ok;
        const int code = walk_req ? span_code : (a_has ? -a_cnt : 0);
        const F stash_w =
            walk_req ? avail : (a_has ? f_max(rem_agg, F(0)) : F(0));
        const F stash_old = (a_has && !walk_ok) ? oldest_j : INF;

        p.pool_w[j * T + lane] = F(0);
        p.pool_oldest[j * T + lane] = INF;
        p.pool_code[j * T + lane] = 0;
        p.grp_jtype[sslot * T + lane] = j;
        p.grp_rem_w[sslot * T + lane] = stash_w;
        p.grp_rem_cnt[sslot * T + lane] = code;
        p.grp_rem_oldest[sslot * T + lane] = stash_old;
        lost_work = lost_work + lost;
        failures += failed ? 1 : 0;
        kills += (killed && !failed) ? 1 : 0;
        requeues += requeued ? 1 : 0;
      }
      const F busy_inc = m_f * window_overlap(t, t_gfin, t_last);
      const F useful_inc = m_f * window_overlap(t + s, useful_end, t_last);

      p.head[j * T + lane] = tail_j;
      m_free -= m_grp;
      p.grp_end[sslot * T + lane] = t_gfin;
      p.grp_m[sslot * T + lane] = m_grp;
      busy_ns = busy_ns + busy_inc;
      useful_ns = useful_ns + useful_inc;
      n_groups += 1;

      p.log_key[row] = j * N1 + tail_j;
      p.log_t[row] = t;
      p.log_m[row] = m_grp;
      p.log_hw[row] = head_w;
    } else {
      // ---- consume one event: a submission or a group finish ----
      const int sub_idx = min(next_sub, N - 1);
      const F t_sub = (next_sub < N) ? p.submit[sub_idx] : INF;
      const bool take_sub = t_sub <= t_efin;
      const F t_new = take_sub ? t_sub : t_efin;
      F qlen = (F)qsum;
      if (HAS_CHAOS) qlen = qlen + (F)psum;
      const F q_inc = qlen * window_overlap(t, t_new, t_last);

      if (take_sub) {
        const int sub_j = p.jtype[sub_idx];
        next_sub += 1;
        p.tail[sub_j * T + lane] += 1;
      } else {
        if (HAS_CHAOS) {
          // resolve the stashed requeue span into its member set (the
          // deferred credit walk) and merge it into the per-type pool
          const int j_f = p.grp_jtype[eslot * T + lane];
          const int code = p.grp_rem_cnt[eslot * T + lane];
          const F stored_w = p.grp_rem_w[eslot * T + lane];
          const F stored_old = p.grp_rem_oldest[eslot * T + lane];
          const F* row_w = p.prefw + j_f * N1;
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
          const F m_old = p.tsub[j_f * N + min(cut, N - 1)];
          const int cnt_r = walk ? m_cnt : -code;
          const F rem_w_r = walk ? m_w : stored_w;
          const F rem_old_r = (walk && m_cnt > 0) ? m_old : stored_old;
          const int rem_lo_r = walk ? cut : 0;

          const int opc = p.pool_code[j_f * T + lane];
          const int old_cnt = opc % N1;
          const int ometa = opc / N1;
          const int old_lo = ometa >> 1;
          const bool old_frag = (ometa & 1) == 1;
          const bool inc = cnt_r > 0;
          const bool was_empty = old_cnt == 0;
          const bool contig = hi == p.head[j_f * T + lane];
          const bool frag =
              inc ? (old_frag || !walk || !was_empty || !contig) : old_frag;
          const int new_lo = was_empty ? rem_lo_r : min(old_lo, rem_lo_r);
          const int new_code =
              (new_lo * 2 + (frag ? 1 : 0)) * N1 + old_cnt + cnt_r;

          p.pool_w[j_f * T + lane] = p.pool_w[j_f * T + lane] + rem_w_r;
          p.pool_oldest[j_f * T + lane] =
              f_min(p.pool_oldest[j_f * T + lane], rem_old_r);
          if (inc) p.pool_code[j_f * T + lane] = new_code;
          p.grp_rem_w[eslot * T + lane] = F(0);
          p.grp_rem_cnt[eslot * T + lane] = 0;
          p.grp_rem_oldest[eslot * T + lane] = INF;
          requeued_jobs += cnt_r;
        }
        m_free += p.grp_m[eslot * T + lane];
        p.grp_end[eslot * T + lane] = INF;
        p.grp_m[eslot * T + lane] = 0;
      }
      t = t_new;
      qlen_int = qlen_int + q_inc;

      p.log_key[row] = KEY_PAD; p.log_t[row] = F(0);
      p.log_m[row] = 0; p.log_hw[row] = F(0);
    }
  }

  if (!valid) return;
  // rows this block skipped by stopping early
  for (; step < p.n_steps; ++step) {
    const int row = (p.log_offset + step) * T + lane;
    p.log_key[row] = KEY_PAD; p.log_t[row] = F(0);
    p.log_m[row] = 0; p.log_hw[row] = F(0);
  }
  p.t[lane] = t; p.next_sub[lane] = next_sub; p.m_free[lane] = m_free;
  p.qlen_int[lane] = qlen_int; p.busy_ns[lane] = busy_ns;
  p.useful_ns[lane] = useful_ns; p.n_groups[lane] = n_groups;
  if (HAS_CHAOS) {
    p.lost_work[lane] = lost_work; p.failures[lane] = failures;
    p.straggler_kills[lane] = kills; p.requeues[lane] = requeues;
    p.requeued_jobs[lane] = requeued_jobs;
  }
}

template <typename F, bool HAS_CHAOS>
int launch(const void* const* in, void* const* st, void* const* logs,
           const int* dims, int block, cudaStream_t stream) {
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
  p.log_offset = dims[7]; p.n_steps = dims[8];
  const int grid = (p.T + block - 1) / block;
  packet_step_kernel<F, HAS_CHAOS><<<grid, block, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   in[16]:  the 9 read-only operands, then the 7 chaos operands (or null)
//   st[23]:  the state columns in ScanState order
//   logs[4]: key, t, m, head_w
//   dims[9]: T, H, N, ring, r_cap, L_cap, cut_steps, log_offset, n_steps
// Launches on `stream`, does not synchronise, allocates nothing. Returns
// cudaGetLastError() of the launch (0 = accepted).
extern "C" int packet_step_launch(int is_f64, int has_chaos,
                                  const void* const* in, void* const* st,
                                  void* const* logs, const int* dims,
                                  int block, void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  if (is_f64) {
    return has_chaos ? launch<double, true>(in, st, logs, dims, block, cs)
                     : launch<double, false>(in, st, logs, dims, block, cs);
  }
  return has_chaos ? launch<float, true>(in, st, logs, dims, block, cs)
                   : launch<float, false>(in, st, logs, dims, block, cs);
}
