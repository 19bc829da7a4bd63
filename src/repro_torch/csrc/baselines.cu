// Rigid baseline schedulers of the Packet scheduling study, for Hopper:
// strict FCFS and EASY backfill, each lane run to its end in one launch.
//
// Replaces the reference's `lax.while_loop` programs `simulate_fcfs` and
// `simulate_backfill` (src/repro/core/schedulers.py), which
// `run_baselines` runs over the init-proportion axis as one XLA program
// (src/repro/core/sweep.py, `_baseline_lanes`). They are not Pallas
// kernels; this kernel is the counterpart of the whole loop, as
// packet_while.cu is of the while-loop engine. Each job runs alone on its
// requested nodes for s + e_i seconds. The event loop (the earlier of the
// next submission and the first finishing job, the queue integral by the
// scalar next_sub - n_started) runs a scheduling pass after every event:
//   FCFS      start the head of the queue while it fits and a slot is free;
//   backfill  the same from the head, then the blocked head's reservation
//             (shadow time and extra nodes) and up to `depth` waiting jobs
//             behind it that fit now and end before the shadow time or use
//             only the extra nodes.
//
// What bounds it: latency. A lane is a chain of about 2N dependent events,
// each a scan of the lane's running jobs and, for backfill, a walk of its
// candidates. ONE WARP PER LANE, one lane a block (grid T, 32 threads):
// - the lane's ring (`grp_end`, `grp_m`), its running jobs kept SORTED by
//   (end, slot), its candidates and its started set (one bit a job) live
//   in dynamic shared memory, or, past the 227 KB a block may opt into, in
//   a device-memory workspace of the same layout (kernel.py ::
//   launch_plan). The sorted list makes the first-index argmin of the
//   ring its first entry and gives the reservation's stable order
//   directly: the reference sorts the ring with a stable argsort, so ends
//   that tie are taken in slot order, and the cumulative free nodes at the
//   first entry that frees enough depend on that order. An insert or a
//   removal shifts the list by one entry, 32 entries at a time;
// - the reservation's cumulative sums are a warp scan over the sorted
//   list; the first entry that frees enough is a warp minimum;
// - the candidates (the first `depth` waiting jobs after the head, in
//   index order) are gathered by ballots over the started set; the
//   sequential walk over them is taken a start at a time: a ballot finds
//   the first candidate after the last one started that passes under the
//   current state, which is the one the sequential walk starts next (the
//   state changes only when a job starts);
// - the head is a pointer to the first job never started (monotone: every
//   job before it has started), which is the reference's argmax of the
//   waiting mask when it is below next_sub;
// - the scalar state is the same in every thread of the warp; thread 0
//   alone writes the lane's columns, between two __syncwarp()s.
// What it does not do: put more than one lane in a block (a `run_baselines`
// call has 6 lanes a policy, so most of the card idles, and the call's
// time is one lane's chain), or split a lane's events over warps, which
// are dependent.
//
// Arithmetic contract: compiled with -fmad=false and without fast math, so
// every multiply and add rounds on its own, in the order the plain
// PyTorch version (repro_torch/kernels/baselines/ref.py) uses: a job ends
// at t + (s + e_i), the busy and useful integrals add m * overlap, a
// candidate ends before the shadow time when (t + s) + e_i <= shadow.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

template <typename F> __device__ inline F inf_of();
template <> __device__ inline float inf_of<float>() {
  return __int_as_float(0x7f800000);
}
template <> __device__ inline double inf_of<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}
__device__ inline float f_min(float a, float b) { return fminf(a, b); }
__device__ inline double f_min(double a, double b) { return fmin(a, b); }
__device__ inline float f_max(float a, float b) { return fmaxf(a, b); }
__device__ inline double f_max(double a, double b) { return fmax(a, b); }

template <typename F>
struct Params {
  const F* submit;    // [N]
  const F* runtime;   // [N]
  const int* nodes;   // [N]
  const F* t_last;    // [] the metric window's end
  const F* s;         // [T] init time of each lane
  F* start_t;         // [T, N]
  F* run_start_t;     // [T, N]
  F* makespan;        // [T]
  F* qlen_int;        // [T]
  F* busy_ns;         // [T]
  F* useful_ns;       // [T]
  int* n_started;     // [T]
  unsigned char* drained;  // [T] bool
  int* iters;         // [T]
  unsigned char* work;     // [T, lane_bytes] when not in shared memory
  int T, N, ring, depth, M, max_iters, lane_bytes, started_words;
};

// Length of [a, b] clipped to the metric window [0, t_end].
template <typename F>
__device__ inline F window_overlap(F a, F b, F t_end) {
  return f_max(f_min(b, t_end) - f_min(a, t_end), F(0));
}

__host__ __device__ inline long long up8(long long b) {
  return (b + 7) / 8 * 8;
}

// One lane: its columns and its scalar state (the same in every thread).
template <typename F>
struct Lane {
  F* grp_end;       // [ring] end of the job in the slot, +inf = free
  F* sorted_end;    // [nr] the running jobs' ends, sorted by (end, slot)
  int* grp_m;       // [ring] nodes held by the slot's job
  int* sorted_slot; // [nr]
  int* cand;        // [depth] backfill candidates
  unsigned* started;  // [N / 32] one bit a job (backfill)
  F* start_t;       // the lane's row [N]
  F* run_start_t;   // the lane's row [N]
  F t, s, t_end, qlen, busy, useful;
  int next_sub, head_ptr, m_free, nr, n_started;
};

template <typename F>
__device__ inline int first_free_slot(const Lane<F>& L, int ring, int lid) {
  for (int base = 0; base < ring; base += 32) {
    const int r = base + lid;
    const unsigned b = __ballot_sync(FULL, r < ring && isinf(L.grp_end[r]));
    if (b) return base + __ffs(b) - 1;
  }
  return 0;
}

// Insert (e, slot) into the sorted running list.
template <typename F>
__device__ inline void sorted_insert(Lane<F>& L, F e, int slot, int lid) {
  int cnt = 0;
  for (int q = lid; q < L.nr; q += 32) {
    const F v = L.sorted_end[q];
    cnt += (v < e || (v == e && L.sorted_slot[q] < slot)) ? 1 : 0;
  }
  const int p = __reduce_add_sync(FULL, cnt);
  // shift entries [p, nr) up by one, the highest 32 first
  for (int hi = L.nr; hi > p; hi -= 32) {
    const int q = hi - 1 - lid;
    const bool mv = q >= p;
    F v = F(0);
    int sl = 0;
    if (mv) { v = L.sorted_end[q]; sl = L.sorted_slot[q]; }
    __syncwarp();
    if (mv) { L.sorted_end[q + 1] = v; L.sorted_slot[q + 1] = sl; }
    __syncwarp();
  }
  if (lid == 0) { L.sorted_end[p] = e; L.sorted_slot[p] = slot; }
  __syncwarp();
  L.nr += 1;
}

// Remove the first entry of the sorted running list.
template <typename F>
__device__ inline void sorted_pop_front(Lane<F>& L, int lid) {
  for (int lo = 1; lo < L.nr; lo += 32) {
    const int q = lo + lid;
    const bool mv = q < L.nr;
    F v = F(0);
    int sl = 0;
    if (mv) { v = L.sorted_end[q]; sl = L.sorted_slot[q]; }
    __syncwarp();
    if (mv) { L.sorted_end[q - 1] = v; L.sorted_slot[q - 1] = sl; }
    __syncwarp();
  }
  L.nr -= 1;
}

__device__ inline bool is_started(const unsigned* started, int i) {
  return (started[i >> 5] >> (i & 31)) & 1u;
}

// Start rigid job i now (it fits and a slot is free).
template <typename F, bool BACKFILL>
__device__ inline void start_job(Lane<F>& L, const Params<F>& p, int i,
                                 int lid) {
  const F rt = p.runtime[i];
  const int m = p.nodes[i];
  const F dur = L.s + rt;
  const F t_fin = L.t + dur;
  const int slot = first_free_slot(L, p.ring, lid);
  const F m_f = (F)m;
  L.busy = L.busy + m_f * window_overlap(L.t, t_fin, L.t_end);
  L.useful = L.useful + m_f * window_overlap(L.t + L.s, t_fin, L.t_end);
  L.m_free -= m;
  L.n_started += 1;
  __syncwarp();   // every thread has read what thread 0 overwrites
  if (lid == 0) {
    L.grp_end[slot] = t_fin;
    L.grp_m[slot] = m;
    L.start_t[i] = L.t;
    L.run_start_t[i] = L.t + L.s;
    if (BACKFILL) L.started[i >> 5] |= 1u << (i & 31);
  }
  __syncwarp();
  sorted_insert(L, t_fin, slot, lid);
}

template <typename F>
__device__ inline void fcfs_pass(Lane<F>& L, const Params<F>& p, int lid) {
  while (L.head_ptr < L.next_sub && L.nr < p.ring &&
         p.nodes[L.head_ptr] <= L.m_free) {
    start_job<F, false>(L, p, L.head_ptr, lid);
    L.head_ptr += 1;
  }
}

template <typename F>
__device__ inline void backfill_pass(Lane<F>& L, const Params<F>& p,
                                     int lid) {
  const F INF = inf_of<F>();
  const int N = p.N, ring = p.ring;
  // 1) start jobs from the head while they fit
  while (L.head_ptr < L.next_sub && L.nr < ring &&
         p.nodes[L.head_ptr] <= L.m_free) {
    start_job<F, true>(L, p, L.head_ptr, lid);
    int h = L.head_ptr + 1;
    while (h < N && is_started(L.started, h)) ++h;
    L.head_ptr = h;
  }
  if (!(L.head_ptr < L.next_sub) || L.nr >= ring || p.depth == 0) return;

  // 2) the first `depth` waiting jobs after the head, in index order
  int ncand = 0;
  for (int base = L.head_ptr + 1; base < L.next_sub && ncand < p.depth;
       base += 32) {
    const int i = base + lid;
    const bool w = i < L.next_sub && !is_started(L.started, i);
    const unsigned b = __ballot_sync(FULL, w);
    const int pos = ncand + __popc(b & ((1u << lid) - 1u));
    if (w && pos < p.depth) L.cand[pos] = i;
    ncand += __popc(b);
  }
  ncand = min(ncand, p.depth);
  __syncwarp();
  if (ncand == 0) return;

  // 3) the blocked head's reservation: the cumulative free nodes along the
  // running jobs sorted by (end, slot), the first entry reaching n_head
  const int n_head = p.nodes[L.head_ptr];
  const int nr = L.nr;
  const int per = (nr + 31) / 32;
  const int q0 = lid * per, q1 = min(q0 + per, nr);
  int part = 0;
  for (int q = q0; q < q1; ++q) part += L.grp_m[L.sorted_slot[q]];
  int incl = part;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, d);
    if (lid >= d) incl += v;
  }
  int run = L.m_free + incl - part;
  int hit = INT_MAX, hit_free = 0;
  for (int q = q0; q < q1; ++q) {
    run += L.grp_m[L.sorted_slot[q]];
    if (run >= n_head) { hit = q; hit_free = run; break; }
  }
  const int first = __reduce_min_sync(FULL, hit);
  F shadow = INF;
  int free_at = L.m_free;
  if (first != INT_MAX) {
    shadow = L.sorted_end[first];
    free_at = __shfl_sync(FULL, hit_free, first / per);
  }
  const int extra = max(free_at - n_head, 0);

  // 4) backfill: a start at a time, the first candidate after the last
  // one started that passes under the current state
  const F t_s = L.t + L.s;
  int last = -1;
  while (L.nr < ring) {
    int found = INT_MAX;
    for (int base = 0; base < ncand; base += 32) {
      const int q = base + lid;
      bool pass = false;
      if (q < ncand && q > last) {
        const int i = L.cand[q];
        const int m = p.nodes[i];
        pass = m <= L.m_free &&
               ((t_s + p.runtime[i] <= shadow) || m <= extra);
      }
      const unsigned b = __ballot_sync(FULL, pass);
      if (b) { found = base + __ffs(b) - 1; break; }
    }
    if (found == INT_MAX) break;
    start_job<F, true>(L, p, L.cand[found], lid);
    last = found;
  }
}

template <typename F, bool BACKFILL>
__global__ void __launch_bounds__(32)
baselines_kernel(const Params<F> p) {
  const int lid = threadIdx.x;
  const int lane = blockIdx.x;
  const int N = p.N, ring = p.ring;
  const F INF = inf_of<F>();

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      p.work ? p.work + (long long)lane * p.lane_bytes : smem_raw;
  const size_t fsz = sizeof(F);
  Lane<F> L;
  L.grp_end = reinterpret_cast<F*>(base);
  L.sorted_end = reinterpret_cast<F*>(base + up8(ring * fsz));
  L.grp_m = reinterpret_cast<int*>(base + 2 * up8(ring * fsz));
  L.sorted_slot =
      reinterpret_cast<int*>(base + 2 * up8(ring * fsz) + up8(ring * 4LL));
  unsigned char* tail = base + 2 * up8(ring * fsz) + 2 * up8(ring * 4LL);
  L.cand = reinterpret_cast<int*>(tail);
  L.started = reinterpret_cast<unsigned*>(tail + up8(p.depth * 4LL));
  L.start_t = p.start_t + (long long)lane * N;
  L.run_start_t = p.run_start_t + (long long)lane * N;

  for (int r = lid; r < ring; r += 32) { L.grp_end[r] = INF; L.grp_m[r] = 0; }
  if (BACKFILL)
    for (int w = lid; w < p.started_words; w += 32) L.started[w] = 0u;
  for (int i = lid; i < N; i += 32) {
    L.start_t[i] = INF;
    L.run_start_t[i] = INF;
  }
  __syncwarp();

  L.t = F(0); L.s = p.s[lane]; L.t_end = *p.t_last;
  L.qlen = F(0); L.busy = F(0); L.useful = F(0);
  L.next_sub = 0; L.head_ptr = 0; L.m_free = p.M; L.nr = 0;
  L.n_started = 0;
  int iters = 0;

  while ((L.next_sub < N || L.nr > 0) && iters < p.max_iters) {
    const F t_sub = L.next_sub < N ? p.submit[L.next_sub] : INF;
    // the first-index argmin of the ring is the sorted list's first entry
    int slot = 0;
    F t_fin = INF;
    if (L.nr > 0) { slot = L.sorted_slot[0]; t_fin = L.sorted_end[0]; }
    const bool take_sub = t_sub <= t_fin;
    const F t_new = take_sub ? t_sub : t_fin;
    const F n_wait = (F)(L.next_sub - L.n_started);
    L.qlen = L.qlen + n_wait * window_overlap(L.t, t_new, L.t_end);
    L.t = t_new;
    if (take_sub) {
      L.next_sub += 1;
    } else {
      L.m_free += L.grp_m[slot];
      __syncwarp();
      if (lid == 0) { L.grp_end[slot] = INF; L.grp_m[slot] = 0; }
      __syncwarp();
      sorted_pop_front(L, lid);
    }
    if (BACKFILL) backfill_pass(L, p, lid); else fcfs_pass(L, p, lid);
    ++iters;
  }

  if (lid != 0) return;
  p.makespan[lane] = L.t;
  p.qlen_int[lane] = L.qlen;
  p.busy_ns[lane] = L.busy;
  p.useful_ns[lane] = L.useful;
  p.n_started[lane] = L.n_started;
  p.drained[lane] = (L.next_sub >= N && L.nr == 0) ? 1 : 0;
  p.iters[lane] = iters;
}

template <typename F, bool BACKFILL>
int launch(const void* const* in, void* const* out, void* work,
           const int* dims, const int* plan, cudaStream_t stream) {
  Params<F> p;
  p.submit = (const F*)in[0]; p.runtime = (const F*)in[1];
  p.nodes = (const int*)in[2]; p.t_last = (const F*)in[3];
  p.s = (const F*)in[4];
  p.start_t = (F*)out[0]; p.run_start_t = (F*)out[1];
  p.makespan = (F*)out[2]; p.qlen_int = (F*)out[3];
  p.busy_ns = (F*)out[4]; p.useful_ns = (F*)out[5];
  p.n_started = (int*)out[6]; p.drained = (unsigned char*)out[7];
  p.iters = (int*)out[8];
  p.T = dims[0]; p.N = dims[1]; p.ring = dims[2]; p.depth = dims[3];
  p.M = dims[4]; p.max_iters = dims[5];
  p.lane_bytes = plan[0];
  const bool in_smem = plan[1] != 0;
  p.started_words = plan[2];
  p.work = in_smem ? nullptr : (unsigned char*)work;
  // a plan that does not hold what the lane touches is refused before any
  // launch
  const long long need =
      2 * up8((long long)p.ring * sizeof(F)) + 2 * up8(p.ring * 4LL) +
      (BACKFILL ? up8(p.depth * 4LL) + up8(p.started_words * 4LL) : 0);
  if (p.lane_bytes < need || (BACKFILL && p.started_words * 32LL < p.N) ||
      (!in_smem && work == nullptr) || p.T < 1 || p.N < 1 || p.ring < 1)
    return (int)cudaErrorInvalidValue;
  const long long smem = in_smem ? p.lane_bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        baselines_kernel<F, BACKFILL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  baselines_kernel<F, BACKFILL><<<p.T, 32, (size_t)smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   in[5]:   submit, runtime, nodes, t_last, s
//   out[9]:  start_t, run_start_t, makespan, qlen_int, busy_ns, useful_ns,
//            n_started, drained, iters (the fields of ref.py's BaselineOut)
//   work:    the [T, lane_bytes] device workspace, or null when the lane's
//            columns live in shared memory
//   dims[6]: T, N, ring, depth, M, max_iters
//   plan[3]: lane bytes, lane in shared memory (1) or the workspace (0),
//            started-set words; kernel.py :: launch_plan makes it
// Launches T blocks of one warp (one lane each) on `stream`, does not
// synchronise, allocates nothing. Returns cudaGetLastError() of the launch
// (0 = accepted), the error of raising the block's shared-memory limit, or
// cudaErrorInvalidValue for a plan that does not hold the shape.
extern "C" int baselines_launch(int is_f64, int backfill,
                                const void* const* in, void* const* out,
                                void* work, const int* dims,
                                const int* plan, void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  if (is_f64) {
    return backfill ? launch<double, true>(in, out, work, dims, plan, cs)
                    : launch<double, false>(in, out, work, dims, plan, cs);
  }
  return backfill ? launch<float, true>(in, out, work, dims, plan, cs)
                  : launch<float, false>(in, out, work, dims, plan, cs);
}
