// Packet group-formation decision of the scheduling simulator, for Hopper.
//
// Replaces the TPU kernel `_select_kernel` of
// src/repro/kernels/packet_select/kernel.py (entry `packet_select`). One
// decision per row of a [T, H] batch (T lanes, H job types): queue weights
// W_h = (sum_w / s) * P * (1 + max(now - oldest, 0) / T_max), -inf for an
// empty queue, the first-index argmax j, the node count
// m = max(min(int32(max(ceil(work / (k * s_j)), 1)), m_free), 0) and the
// group's duration s_j + work / max(m, 1). The plain version of the DES
// while-loop engine (repro_torch/kernels/packet_while/ref.py, what
// `simulate_packet(..., impl="torch")` runs) calls it once per lockstep
// group formation over all of its lanes; on the card the engine itself
// runs csrc/packet_while.cu, which has this decision inlined.
//
// What bounds it on this card: latency. At the engine's shape (222 lanes x
// 8 types) a launch moves about 50 KB and does a few thousand operations,
// so its bounds are hundredths of a microsecond and the launch itself (a
// few microseconds) is the whole cost. Only at a million rows does it
// approach its bytes bound.
//
// What this design does about that: nothing beyond being simple and
// correct. One thread per row walks that row's H types in registers; rows
// are contiguous, so a warp's first loads fetch the lines its later
// iterations hit in L1. There is no padding of H to 128 (that was the
// TPU's lane width). What it does not do: split a row across a warp for
// large H, fuse the gathers that build its operands, or run inside the
// engine's event loop. Fewer launches, not a faster one, were what the
// engine needed (PERF.md): csrc/packet_while.cu runs the whole loop, this
// decision inside it, in one launch.
//
// Semantics: those of the policy functions (repro_torch/core/packet.py)
// and of the plain version (kernels/packet_select/ref.py), where the TPU
// kernel differs from them: the duration adds the UNCLAMPED s_j (only the
// weight and the threshold clamp it at 1e-9), and the threshold is cast to
// int32 as XLA casts (NaN -> 0, saturating) before the minimum with m_free.
// Compiled with -fmad=false and without fast math, so every operation
// rounds on its own, in the plain version's order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <typename F> struct Lim;
template <> struct Lim<float> {
  __device__ static float inf() { return __int_as_float(0x7f800000); }
};
template <> struct Lim<double> {
  __device__ static double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
};

__device__ inline float f_ceil(float x) { return ceilf(x); }
__device__ inline double f_ceil(double x) { return ceil(x); }

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

template <typename F>
__global__ void packet_select_kernel(
    const F* __restrict__ sum_w, const F* __restrict__ s_j,
    const F* __restrict__ p_j, const F* __restrict__ oldest,
    const F* __restrict__ t_max, const bool* __restrict__ nonempty,
    const F* __restrict__ now, const F* __restrict__ k,
    const int* __restrict__ m_free, int* __restrict__ j_out,
    F* __restrict__ m_out, F* __restrict__ dur_out, F* __restrict__ work_out,
    int T, int H) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= T) return;
  const size_t base = (size_t)row * H;
  const F EPS9 = F(1e-9);
  const F INF = Lim<F>::inf();
  const F t = now[row];

  // Step 2: weights and the first-index argmax over the types
  int j = 0;
  F best = 0;
  for (int h = 0; h < H; ++h) {
    const F c_j = sum_w[base + h] / clamp_min(s_j[base + h], EPS9);
    const F t_cur = clamp_min(t - oldest[base + h], F(0));
    F w = (c_j * p_j[base + h]) *
          (F(1) + t_cur / clamp_min(t_max[base + h], EPS9));
    w = nonempty[base + h] ? w : -INF;
    if (h == 0 || w > best) { best = w; j = h; }
  }

  // Step 4: node count and duration of the group that drains queue j
  const F work = sum_w[base + j];
  const F s_sel = s_j[base + j];
  F m_thr = f_ceil(work / (clamp_min(k[row], EPS9) * clamp_min(s_sel, EPS9)));
  m_thr = clamp_min(m_thr, F(1));
  int m = min(saturating_int32(m_thr), m_free[row]);
  m = max(m, 0);
  j_out[row] = j;
  m_out[row] = (F)m;
  dur_out[row] = s_sel + work / (F)max(m, 1);
  work_out[row] = work;
}

template <typename F>
int launch(const void* const* in, void* const* out, int T, int H, int block,
           cudaStream_t stream) {
  const int grid = (T + block - 1) / block;
  packet_select_kernel<F><<<grid, block, 0, stream>>>(
      (const F*)in[0], (const F*)in[1], (const F*)in[2], (const F*)in[3],
      (const F*)in[4], (const bool*)in[5], (const F*)in[6], (const F*)in[7],
      (const int*)in[8], (int*)out[0], (F*)out[1], (F*)out[2], (F*)out[3],
      T, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   in[9]:  sum_w, s_j, p_j, oldest, t_max [T, H] (float or double),
//           nonempty [T, H] bool, now, k [T] (float or double),
//           m_free [T] int32
//   out[4]: j [T] int32, m, dur, work [T] (float or double)
// Launches on `stream`, does not synchronise, allocates nothing. Returns
// cudaGetLastError() of the launch (0 = accepted, -1 = refused sizes).
extern "C" int packet_select_launch(int is_f64, const void* const* in,
                                    void* const* out, int T, int H,
                                    int block, void* stream) {
  if (T < 1 || H < 1 || block < 1) return -1;
  cudaStream_t cs = (cudaStream_t)stream;
  return is_f64 ? launch<double>(in, out, T, H, block, cs)
                : launch<float>(in, out, T, H, block, cs);
}
