// Diagonal linear recurrence h_t = exp(log_a_t) * h_{t-1} + b_t, forward
// and reverse, for Hopper.
//
// Replaces the TPU kernel `_lru_kernel` of
// src/repro/kernels/rglru_scan/kernel.py (launched by `lru_chunked` there
// and wrapped by src/repro/kernels/rglru_scan/ops.py :: chunked_lru, the
// RG-LRU of src/repro/models/hybrid.py). It computes what that kernel
// computes, not block for block. Forward, for every (batch b, feature d):
//
//   c = h0[b, d] (0 without h0)
//   for t = 0 .. S-1:  c = exp(log_a[b, t, d]) * c + x[b, t, d];  h[b, t, d] = c
//   h_last[b, d] = c
//
// Reverse (the backward of the forward, which the TPU package does not
// have), for the incoming gradient dh and dh_last:
//
//   g_t = dh_t + a_{t+1} * g_{t+1}   (a_S = 1; the carry starts at dh_last)
//   dlog_a_t = g_t * a_t * h_{t-1}   (h_{-1} = h0)
//   h_last = a_0 * g_0               (the gradient of h0)
//
// with g written where the forward writes h (the gradient of x is g). The
// kernel walks it as a recurrence of the forward's form in q_t = a_t * g_t,
// from t = S-1 down to 0: g_t = dh_t + q_{t+1}, q_t = a_t * g_t, q_S =
// dh_last. Its decays are a_t itself, not the shifted a_{t+1}, so a chunk
// of steps needs no row from its neighbour; the one shifted operand is
// h_{t-1} (h0 at t = 0), and h_last is the last carry, q_0.
//
// Layouts: log_a, x, h, dlog_a and h_fwd [B, S, D], h0, the initial carry
// and h_last [B, D], all contiguous. log_a, x, h_fwd and the outputs are
// all float32 or all bfloat16 (the wrapper widens a mixed pair to float32,
// exactly); h0 and the initial carry are float32. Arithmetic is float32
// throughout.
//
// What bounds it on this card: bytes. A step is one exp and two or three
// multiply-adds per element against 12 bytes (two float32 loads and a
// store) forward and 20 reverse, far below the card's 20 operations per
// byte in float32. The least time is the bytes over 3.35 TB/s (0.075 ms
// forward, 0.125 ms reverse at recurrentgemma-2b's B 2, S 4096, D 2560).
// Reaching it takes some 2-3 MB of loads in flight (Little's law at about
// a microsecond of latency under load), which one thread per (b, d)
// walking the whole sequence one step at a time cannot give when B * D is
// a few thousand.
//
// What this design does about that: the parallelism comes from the
// sequence. A block is WARPS warps on one batch row and one column of 32
// features, a feature a lane, so every step's row of a warp is one
// coalesced line (128 bytes in float32, 64 in bfloat16). The block walks
// its column's sequence in tiles of WARPS x STEPS steps, and warp w takes
// steps [w STEPS, (w + 1) STEPS) of each tile:
//
//   1. every thread loads its STEPS steps of every operand into registers,
//      all loads issued before any is used (a bfloat16 kept as its bits
//      until the walk widens it, so that no load waits on the one before);
//   2. walk 1, from a zero state: the chunk's aggregate (A, H), the product
//      of its decays and its end state, so that end = A * carry + H;
//   3. the WARPS aggregates meet in shared memory (two buffers, so one
//      __syncthreads a tile); the carry entering warp w is the tile's
//      carry folded through the aggregates of warps < w, and the fold of
//      all of them is the next tile's carry, kept in registers;
//   4. the next tile's loads are issued (a register double buffer), then
//      walk 2 from the warp's carry: the outputs, each written once.
//
// One launch a call; each input element is read from device memory once
// and each output written once. The grid is a block per (column, batch
// row): 160 at recurrentgemma-2b's width and batch, two blocks an SM
// resident, 2 x 8 x 32 x 16 steps of loads in flight an SM.
//
// What it does not do: split a column's sequence over blocks (a decoupled
// look-back between blocks was measured no faster at the main shape in
// float32, and needs a workspace and a zeroing launch), so a shape with
// fewer columns than the card has SMs leaves SMs idle; TMA or cp.async
// loads (registers carry them); loads of more than one element a thread,
// or two bfloat16 features a thread (that halves the blocks, to 80 at the
// main width, and was measured slower).
//
// Arithmetic contract: float32, fused multiply-adds allowed, expf from
// CUDA's libm, no fast math. The plain PyTorch version
// (repro_torch/kernels/rglru_scan/ref.py) reaches the same function in
// another order (a scan inside chunks of 64 steps, then the carries
// between them), so the two agree to a stated tolerance, not bitwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;                 // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr int STEPS = 16;                // steps a warp walks a tile
constexpr int TILE = WARPS * STEPS;      // steps a tile
constexpr int BLOCKS_PER_SM = 2;
// a block's static shared memory: the warps' aggregates, two buffers
constexpr int SMEM_BYTES = 2 * 2 * WARPS * 32 * (int)sizeof(float);

// Loads of one element keep its bits as they are (a bfloat16 zero-extended
// to 32 bits), and `widen` makes its float32 value where the walk uses it:
// widened at the load, each load's register is waited on at once and the
// loads of a chunk go out one after another, not together.
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __uint_as_float(*reinterpret_cast<const unsigned short*>(p));
}
template <typename T> __device__ __forceinline__ float widen(float v) {
  if constexpr (sizeof(T) == 2)
    return __uint_as_float(__float_as_uint(v) << 16);
  return v;
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T> struct Args {
  const T* log_a;
  const T* x;
  const float* c0;      // the initial carry: h0 forward, dh_last reverse
  const float* h0;      // reverse: h_{-1}
  const T* h_fwd;       // reverse: the forward's h
  T* h;                 // h forward, g reverse
  T* dlog_a;            // reverse
  T* h_last;            // the last carry: h_last forward, dh0 reverse
  int S, D, tiles;
};

// The STEPS steps of the warp's chunk from step i0 (in walk order: time i0
// forward, S - 1 - i0 reverse), as `load` leaves them; a lane past D (`in`
// false) loads nothing. Steps past the end give log a = 0 and x = 0, which
// carry the state unchanged. The reverse also loads h_{t-1} for t > 0.
template <typename T, bool REV>
__device__ __forceinline__ void load_chunk(
    const Args<T>& p, long long base, bool in, int i0, float (&la)[STEPS],
    float (&xs)[STEPS], float (&hp)[STEPS]) {
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    const int i = i0 + u;
    la[u] = xs[u] = hp[u] = 0.f;
    if (in && i < p.S) {
      const int t = REV ? p.S - 1 - i : i;
      const long long at = base + (long long)t * p.D;
      la[u] = load(p.log_a + at);
      xs[u] = load(p.x + at);
      if (REV && t > 0) hp[u] = load(p.h_fwd + at - p.D);
    }
  }
}

// Walk 1 from a zero state: the chunk's aggregate (A, H); la becomes a,
// xs its float32 values.
template <typename T, bool REV>
__device__ __forceinline__ void walk_aggregate(float (&la)[STEPS],
                                               float (&xs)[STEPS], float& A,
                                               float& H) {
  A = 1.f;
  H = 0.f;
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    const float a = expf(widen<T>(la[u]));
    la[u] = a;
    xs[u] = widen<T>(xs[u]);
    H = REV ? a * (xs[u] + H) : a * H + xs[u];
    A *= a;
  }
}

// Walk 2 from the carry c: every output of the chunk, written once. h0 is
// the reverse's h_{-1}.
template <typename T, bool REV>
__device__ __forceinline__ void walk_outputs(
    const Args<T>& p, long long base, bool in, int i0,
    const float (&a)[STEPS], const float (&xs)[STEPS],
    const float (&hp)[STEPS], float h0, float c) {
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    const int i = i0 + u;
    const int t = REV ? p.S - 1 - i : i;
    float out, dla = 0.f;
    if constexpr (REV) {
      out = xs[u] + c;
      c = a[u] * out;
      dla = c * (t > 0 ? widen<T>(hp[u]) : h0);
    } else {
      c = a[u] * c + xs[u];
      out = c;
    }
    if (in && i < p.S) {
      const long long at = base + (long long)t * p.D;
      store(p.h + at, out);
      if constexpr (REV) store(p.dlog_a + at, dla);
    }
  }
}

template <typename T, bool REV>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
lru_kernel(const Args<T> p) {
  __shared__ float s_a[2][WARPS][32], s_h[2][WARPS][32];
  static_assert(sizeof(s_a) + sizeof(s_h) == SMEM_BYTES,
                "SMEM_BYTES is the plan's shared bytes");
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;
  const bool in = d < p.D;
  const long long row = (long long)blockIdx.y * p.D + d;
  const long long base = (long long)blockIdx.y * p.S * p.D + d;

  float la[STEPS], xs[STEPS], hp[STEPS];   // hp: reverse only
  float carry = (p.c0 != nullptr && in) ? p.c0[row] : 0.f;
  const float h0 = (REV && p.h0 != nullptr && in) ? p.h0[row] : 0.f;
  load_chunk<T, REV>(p, base, in, w * STEPS, la, xs, hp);

  for (int k = 0, par = 0;; ++k, par ^= 1) {
    float A, H;
    walk_aggregate<T, REV>(la, xs, A, H);
    s_a[par][w][lane] = A;
    s_h[par][w][lane] = H;
    __syncthreads();

    // the carry entering this warp's chunk, and the tile's end
    float c = carry, end = carry;
    for (int j = 0; j < WARPS; ++j) {
      end = s_a[par][j][lane] * end + s_h[par][j][lane];
      if (j == w - 1) c = end;
    }
    const int i0 = k * TILE + w * STEPS;
    const bool more = k + 1 < p.tiles;
    float la_n[STEPS], xs_n[STEPS], hp_n[STEPS];
    // the next tile's loads go out before this tile's second walk
    if (more) load_chunk<T, REV>(p, base, in, i0 + TILE, la_n, xs_n, hp_n);
    walk_outputs<T, REV>(p, base, in, i0, la, xs, hp, h0, c);
    carry = end;
    if (!more) {
      if (w == 0 && in) store(p.h_last + row, carry);
      return;
    }
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      la[u] = la_n[u];
      xs[u] = xs_n[u];
      hp[u] = hp_n[u];
    }
  }
}

template <typename T>
int launch_typed(int reverse, const void* log_a, const void* x,
                 const void* c0, const void* h0, const void* h_fwd, void* h,
                 void* dlog_a, void* h_last, int B, int S, int D,
                 const int* plan, cudaStream_t stream) {
  const int cols = (D + 31) / 32;
  const int tiles = (S + TILE - 1) / TILE;
  // the plan is kernel.py :: launch_plan's; refuse one made for another
  // build of this file
  if (plan[0] != WARPS || plan[1] != STEPS || plan[2] != cols ||
      plan[3] != tiles || plan[4] != SMEM_BYTES || B > 65535)
    return -1;
  Args<T> a;
  a.log_a = static_cast<const T*>(log_a);
  a.x = static_cast<const T*>(x);
  a.c0 = static_cast<const float*>(c0);
  a.h0 = static_cast<const float*>(h0);
  a.h_fwd = static_cast<const T*>(h_fwd);
  a.h = static_cast<T*>(h);
  a.dlog_a = static_cast<T*>(dlog_a);
  a.h_last = static_cast<T*>(h_last);
  a.S = S;
  a.D = D;
  a.tiles = tiles;
  const dim3 grid(cols, B);
  if (reverse) {
    lru_kernel<T, true><<<grid, THREADS, 0, stream>>>(a);
  } else {
    lru_kernel<T, false><<<grid, THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Enqueue one launch on `stream`; every tensor operand is bfloat16 when
// `bf16` is set, else float32. Forward (reverse = 0): h and h_last from
// log_a, x and the initial state c0 (null: 0). Reverse (reverse = 1): the
// gradient walk with x = dh and c0 = dh_last (null: 0), writing g into h,
// dlog_a from h_fwd (the forward's h) and h0 (the forward's initial state,
// null: 0), and the gradient of h0 into h_last.
//
// `plan` is five ints from kernel.py :: launch_plan: warps a block, steps
// a warp per tile, feature columns, tiles a column and shared bytes a
// block; each must be this build's. Returns cudaGetLastError() after the
// launch (0 when it was accepted), or -1 for dimensions or a plan it
// cannot take, or a missing operand.
extern "C" int rglru_scan_launch(int bf16, int reverse, const void* log_a,
                                 const void* x, const void* c0,
                                 const void* h0, const void* h_fwd, void* h,
                                 void* dlog_a, void* h_last, int B, int S,
                                 int D, const int* plan, void* stream) {
  if (B < 1 || S < 1 || D < 1 || plan == nullptr) return -1;
  if (log_a == nullptr || x == nullptr || h == nullptr || h_last == nullptr)
    return -1;
  if (reverse && (dlog_a == nullptr || h_fwd == nullptr)) return -1;
  cudaStream_t cs = (cudaStream_t)stream;
  if (bf16) {
    return launch_typed<__nv_bfloat16>(reverse, log_a, x, c0, h0, h_fwd, h,
                                       dlog_a, h_last, B, S, D, plan, cs);
  }
  return launch_typed<float>(reverse, log_a, x, c0, h0, h_fwd, h, dlog_a,
                             h_last, B, S, D, plan, cs);
}
