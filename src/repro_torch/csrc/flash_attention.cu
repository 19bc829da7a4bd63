// Blocked online-softmax attention (forward) for Hopper.
//
// Replaces the TPU kernel `_attn_kernel` of
// src/repro/kernels/flash_attention/kernel.py (launched by
// `flash_attention_bhsd` there and wrapped by
// src/repro/kernels/flash_attention/ops.py). It computes what that kernel
// computes, not block for block: for query row i of head h and the keys of
// KV head h / (H / KV),
//
//   s_j = q_i . k_j / sqrt(hd)        (then tanh(s / c) * c with a soft-cap)
//   s_j = -1e30 where key j is masked (padding k_pos < Skv, causal
//         k_pos <= q_pos + off, window k_pos > q_pos + off - window,
//         with off = Skv - Sq)
//   o_i = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
//
// with the running max m and the running sums kept as the TPU kernel keeps
// them (m, l and the accumulator rescaled by exp(m_prev - m_new) at each
// update of the state). Every quantity is float32: q, k and
// v are widened on load (bf16 through __bfloat162float), p is NOT rounded
// to bf16 before the P.V product, and only the output is rounded to the
// input type. KV tiles that are masked for every row of the block are
// skipped with the TPU kernel's predicate. Query head h reads KV head
// h / (H / KV) by index: repeated K/V is never materialised. Ragged Sq and
// Skv are handled by masks inside the kernel (no padding copy).
//
// Layouts: q and o [B, Sq, H, hd], k and v [B, Skv, KV, hd], contiguous,
// float32 or bfloat16; hd in {16, 32, 64, 128, 256}.
//
// What bounds it on this card: at prefill lengths, arithmetic. The work is
// 4 * B * H * hd * (visible pairs) operations against about
// 2 * (q + o) + 2 * (k + v) bytes, several hundred operations per byte, so
// the least time is set by the tensor cores' bf16 rate (989 TFLOP/s dense).
//
// What this simple design does about that: very little yet. One block of
// 256 threads per (query tile, b * H); a query row is shared by hd / 16
// neighbouring threads, each holding 16 of its dims of q and of the
// accumulator in registers, the dot products finished by warp shuffles. A
// tile of 64 keys and 64 values is staged in shared memory as float32
// (dynamic shared memory, 128 KB at hd = 256), and the block walks its live
// tiles with the softmax state in registers, updated once per 32 keys
// (the TPU kernel updates it once per KV tile). The heaviest causal query
// tiles are scheduled first. What it does not do: use the tensor cores
// (`wgmma` or `mma.sync`), load tiles with TMA or `cp.async` in a ring that
// overlaps the arithmetic, specialise warps, keep more than one query row
// per thread to reuse each shared-memory read, or split the keys of one
// query tile over several blocks for short-query decoding. It runs the
// products on the float32 CUDA cores; those are later work.
//
// Arithmetic contract: float32 throughout, fused multiply-adds allowed
// (no -fmad=false here), expf / tanhf from CUDA's libm, no fast math. Sums
// run in another order than the plain PyTorch version
// (repro_torch/kernels/flash_attention/ref.py), so the two agree to a
// stated tolerance (2e-5 absolute plus relative in float32, 2e-2 in bf16),
// not bitwise. Rows that see no key at all are outside the contract, as
// they are for the TPU kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;   // per block
constexpr int BKV = 64;        // keys per shared-memory tile
constexpr int SUB = 32;        // keys per update of the softmax state
constexpr int DPT = 16;        // dims of a query row held by one thread
constexpr float NEG_INF = -1e30f;

__device__ inline float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ inline float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ inline void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ inline void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

// One block: BQ = THREADS / (HD / 16) query rows of one (b, h). Thread
// `part` of a row holds dims 4 * (part + TPR * i) .. + 3 for i < 4, so the
// threads of a row read neighbouring 16-byte words of a shared-memory row.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
            int H, int KV, int causal, int window, float softcap,
            float scale) {
  constexpr int TPR = HD / DPT;        // threads per query row
  constexpr int BQ = THREADS / TPR;    // query rows per block
  constexpr int NV = DPT / 4;          // float4 words per thread
  extern __shared__ float4 smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BKV * HD;

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int qpos = q0 + row;
  const bool q_ok = qpos < Sq;
  const int off = Skv - Sq;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 qr[NV];
  float4 acc[NV];
  const long long q_base = ((long long)(b * (long long)Sq + qpos) * H + h) *
                           HD;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    qr[i] = q_ok ? load4(q + q_base + 4 * (part + TPR * i)) : zero;
    acc[i] = zero;
  }
  float m = NEG_INF;
  float l = 0.f;

  const int n_kv = (Skv + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BKV;
    // the TPU kernel's predicate for a tile masked for every row of the
    // block (rows past Sq included); later tiles are then masked too
    if (causal && k0 > q0 + BQ - 1 + off) break;
    if (window > 0 && k0 + BKV - 1 <= q0 - window + off) continue;

    __syncthreads();   // every thread is done with the previous tile
    for (int e = tid; e < BKV * HD / 4; e += THREADS) {
      const int j = e / (HD / 4);
      const int c = 4 * (e % (HD / 4));
      float4 kk = zero;
      float4 vv = zero;
      if (k0 + j < Skv) {   // keys past Skv stay zero: finite under p = 0
        const long long base =
            ((long long)(b * (long long)Skv + k0 + j) * KV + kvh) * HD + c;
        kk = load4(k + base);
        vv = load4(v + base);
      }
      reinterpret_cast<float4*>(Ks)[e] = kk;
      reinterpret_cast<float4*>(Vs)[e] = vv;
    }
    __syncthreads();

    // the softmax state is updated once per SUB keys (the TPU kernel does
    // it once per KV tile: the same function up to rounding); SUB scores
    // per thread keep the registers below the launch bound without spills
    for (int j0 = 0; j0 < BKV; j0 += SUB) {
      float s[SUB];
      float m_cur = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = j0 + jj;
        const float4* kr = reinterpret_cast<const float4*>(Ks + j * HD);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const float4 kk = kr[part + TPR * i];
          dot += qr[i].x * kk.x + qr[i].y * kk.y + qr[i].z * kk.z +
                 qr[i].w * kk.w;
        }
#pragma unroll
        for (int w = TPR / 2; w > 0; w >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, w);
        }
        float sc = dot * scale;
        if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
        const int kp = k0 + j;
        bool live = kp < Skv;
        if (causal) live = live && kp <= qpos + off;
        if (window > 0) live = live && kp > qpos + off - window;
        s[jj] = live ? sc : NEG_INF;
        m_cur = fmaxf(m_cur, s[jj]);
      }

      const float m_new = fmaxf(m, m_cur);
      const float alpha = expf(m - m_new);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        acc[i].x *= alpha;
        acc[i].y *= alpha;
        acc[i].z *= alpha;
        acc[i].w *= alpha;
      }
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = expf(s[jj] - m_new);
        psum += p;
        const float4* vr =
            reinterpret_cast<const float4*>(Vs + (j0 + jj) * HD);
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const float4 vv = vr[part + TPR * i];
          acc[i].x += p * vv.x;
          acc[i].y += p * vv.y;
          acc[i].z += p * vv.z;
          acc[i].w += p * vv.w;
        }
      }
      l = l * alpha + psum;
      m = m_new;
    }
  }

  if (q_ok) {
    const float lm = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      store4(o + q_base + 4 * (part + TPR * i),
             make_float4(acc[i].x / lm, acc[i].y / lm, acc[i].z / lm,
                         acc[i].w / lm));
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  constexpr int BQ = THREADS / (HD / DPT);
  const int smem = 2 * BKV * HD * (int)sizeof(float);
  auto kern = attn_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, causal,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int Sq, int Skv, int H, int KV, int causal, int window,
              float softcap, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                           softcap, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                           softcap, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                           softcap, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                            softcap, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                            softcap, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

// Enqueue one launch on `stream`. Returns cudaGetLastError() after the
// launch (0 when it was accepted), the error of cudaFuncSetAttribute if
// that failed, or -1 for a head dim without an instantiation.
extern "C" int flash_attention_launch(int is_bf16, int hd, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int H, int KV,
                                      int causal, int window, float softcap,
                                      float scale, void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  if (is_bf16) {
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Skv, H, KV,
                                    causal, window, softcap, scale, cs);
  }
  return launch_hd<float>(hd, q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                          softcap, scale, cs);
}
