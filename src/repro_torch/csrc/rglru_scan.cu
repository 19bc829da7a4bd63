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
// The TPU kernel gets the same function from a [c, c] matrix of decays
// exp(La_t - La_s) per chunk, dense VPU work chosen for the TPU; here the
// recurrence is walked step by step in a register.
//
// Reverse (the backward of the forward, which the TPU package does not
// have): the same walk from t = S-1 down to 0, with the decays shifted by
// one step, so that for the incoming gradient dh it computes
//
//   g_t = dh_t + a_{t+1} * g_{t+1}   (a_S = 1; the carry starts at dh_last)
//   dlog_a_t = g_t * a_t * h_{t-1}   (h_{-1} = h0), fused into the walk
//   h_last = a_0 * g_0               (the gradient of h0)
//
// with g written where the forward writes h. The gradient of x is g.
//
// Layouts: log_a, x, h, dlog_a and h_fwd [B, S, D], h0, the initial carry
// and h_last [B, D], all contiguous. log_a, x, h_fwd and the outputs are
// all float32 or all bfloat16 (the wrapper widens a mixed pair to float32,
// exactly); h0 and the initial carry are float32. Arithmetic is float32
// throughout.
//
// What bounds it on this card: bytes. A step is one exp and one fused
// multiply-add per element against 12 bytes (two float32 loads and a
// store) forward and 20 reverse, far below the card's 20 operations per
// byte in float32. The least time is the bytes over 3.35 TB/s (0.075 ms
// forward at recurrentgemma-2b's B 2, S 4096, D 2560).
//
// What this simple design does about that: one thread per (b, d), 32
// threads (one warp) per block over neighbouring features, so every load
// and store of a warp is one coalesced 128-byte line, and the grid spreads
// the B * D / 32 warps over as many SMs as it can. The steps are
// dependent, so a thread keeps the next U steps' inputs in flight while it
// walks the current U (double buffering in registers).
// What it does not do: split the sequence over several threads or
// blocks (a chunked scan with a carry pass), which is what would put
// enough bytes in flight to approach the bound when B * D is only a few
// thousand (5 120 threads fill 160 warps of the card's 132 SMs x 64 warp
// slots); keep h in shared memory; or use TMA / cp.async bulk loads.
//
// Arithmetic contract: float32, fused multiply-adds allowed, expf from
// CUDA's libm, no fast math. The plain PyTorch version
// (repro_torch/kernels/rglru_scan/ref.py) reaches the same function in
// another order (a scan inside chunks, then the carries between them), so
// the two agree to a stated tolerance, not bitwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 32;   // one warp per block
constexpr int U = 16;         // steps per register buffer

__device__ inline float ld(const float* p) { return __ldg(p); }

__device__ inline float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ inline void st(float* p, float v) { *p = v; }

__device__ inline void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One buffer of U steps: step i0 + u of the walk, i.e. time
// t = i0 + u forward or S - 1 - (i0 + u) in reverse. Steps past the end
// load log a = 0 and x = 0, as the reference pads. The reverse also loads
// h_{t-1} (hm1 = h0 at t = 0) for dlog_a.
template <typename T, bool REV>
__device__ inline void load_steps(const T* __restrict__ log_a,
                                  const T* __restrict__ x,
                                  const T* __restrict__ h_fwd, float hm1,
                                  long long base, int i0, int S, int D,
                                  float* la, float* xs, float* hp) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = i0 + u;
    const int t = REV ? S - 1 - i : i;
    const bool ok = i < S;
    const long long at = base + (long long)t * D;
    la[u] = ok ? ld(log_a + at) : 0.f;
    xs[u] = ok ? ld(x + at) : 0.f;
    if constexpr (REV) {
      hp[u] = !ok ? 0.f : (t > 0 ? ld(h_fwd + at - D) : hm1);
    }
  }
}

template <typename T, bool REV>
__global__ void __launch_bounds__(THREADS)
lru_kernel(const T* __restrict__ log_a, const T* __restrict__ x,
           const float* __restrict__ c0, const float* __restrict__ h0,
           const T* __restrict__ h_fwd, T* __restrict__ h,
           T* __restrict__ dlog_a, T* __restrict__ h_last, int S, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  const long long row = (long long)blockIdx.y * D + d;    // [B, D]
  const long long base = (long long)blockIdx.y * S * D + d;
  const float hm1 = (REV && h0 != nullptr) ? h0[row] : 0.f;

  float c = c0 != nullptr ? c0[row] : 0.f;
  float a_next = 1.f;   // reverse: the decay of step t + 1 (1 past the end)
  float la[U], xs[U], hp[U];
  load_steps<T, REV>(log_a, x, h_fwd, hm1, base, 0, S, D, la, xs, hp);
  for (int i0 = 0; i0 < S; i0 += U) {
    float la_n[U], xs_n[U], hp_n[U];
    // the next buffer's loads go out before this buffer's dependent chain
    load_steps<T, REV>(log_a, x, h_fwd, hm1, base, i0 + U, S, D, la_n, xs_n,
                       hp_n);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u;
      if (i < S) {
        const int t = REV ? S - 1 - i : i;
        const long long at = base + (long long)t * D;
        const float a = expf(la[u]);
        if constexpr (REV) {
          c = a_next * c + xs[u];
          st(dlog_a + at, c * a * hp[u]);
          a_next = a;
        } else {
          c = a * c + xs[u];
        }
        st(h + at, c);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      la[u] = la_n[u];
      xs[u] = xs_n[u];
      if constexpr (REV) hp[u] = hp_n[u];
    }
  }
  st(h_last + row, REV ? a_next * c : c);
}

template <typename T>
int launch(int reverse, const void* log_a, const void* x, const void* c0,
           const void* h0, const void* h_fwd, void* h, void* dlog_a,
           void* h_last, int B, int S, int D, cudaStream_t stream) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  auto* la = static_cast<const T*>(log_a);
  auto* xx = static_cast<const T*>(x);
  auto* cc = static_cast<const float*>(c0);
  auto* hh = static_cast<const float*>(h0);
  auto* hf = static_cast<const T*>(h_fwd);
  auto* out = static_cast<T*>(h);
  auto* dla = static_cast<T*>(dlog_a);
  auto* last = static_cast<T*>(h_last);
  if (reverse) {
    lru_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        la, xx, cc, hh, hf, out, dla, last, S, D);
  } else {
    lru_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        la, xx, cc, hh, hf, out, dla, last, S, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Enqueue one launch on `stream`; every tensor operand is bfloat16 when
// `bf16` is set, else float32. Forward (reverse = 0): h and h_last from
// log_a, x and the initial state c0 (null: 0). Reverse (reverse = 1): the
// gradient walk with x = dh and c0 = dh_last (null: 0), writing g into h,
// dlog_a from h_fwd (the forward's h) and h0 (the forward's initial state,
// null: 0), and the gradient of h0 into h_last. Returns cudaGetLastError()
// after the launch (0 when it was accepted), or -1 for dimensions the grid
// cannot take or a missing operand.
extern "C" int rglru_scan_launch(int bf16, int reverse, const void* log_a,
                                 const void* x, const void* c0,
                                 const void* h0, const void* h_fwd, void* h,
                                 void* dlog_a, void* h_last, int B, int S,
                                 int D, void* stream) {
  if (B < 1 || S < 1 || D < 1 || B > 65535) return -1;
  if (log_a == nullptr || x == nullptr || h == nullptr || h_last == nullptr)
    return -1;
  if (reverse && (dlog_a == nullptr || h_fwd == nullptr)) return -1;
  cudaStream_t cs = (cudaStream_t)stream;
  if (bf16) {
    return launch<__nv_bfloat16>(reverse, log_a, x, c0, h0, h_fwd, h, dlog_a,
                                 h_last, B, S, D, cs);
  }
  return launch<float>(reverse, log_a, x, c0, h0, h_fwd, h, dlog_a, h_last,
                       B, S, D, cs);
}
