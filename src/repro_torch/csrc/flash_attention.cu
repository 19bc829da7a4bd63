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
// with a running max m, the running sums and the accumulator rescaled by
// exp(m_prev - m_new) at each update, as the TPU kernel keeps them. KV
// tiles that are masked for every row of a block are skipped with the TPU
// kernel's predicate. Query head h reads KV head h / (H / KV) by index:
// repeated K/V is never materialised. Ragged Sq and Skv need no padding
// copy. Layouts: q and o [B, Sq, H, hd], k and v [B, Skv, KV, hd],
// contiguous; hd in {16, 32, 64, 128, 256}.
//
// Two kernels, chosen by the type of the inputs (a dispatch by type, not a
// fallback: a failed launch of either is reported, never retried with the
// other):
//
// - bfloat16: `sm90::attn_kernel`, written for the tensor cores of sm_90a.
// - float32: `cuda_cores::attn_kernel`, every product on the float32 CUDA
//   cores. TF32 tensor cores would miss the float32 contract below, and no
//   model of the port runs attention in float32.
//
// What bounds it on this card: at prefill lengths, arithmetic. The work is
// 4 * B * H * hd * (visible pairs) operations against about
// 2 * (q + o) + 2 * (k + v) bytes, several hundred operations per byte, so
// the least time is set by the tensor cores' bf16 rate (989 TFLOP/s dense).
//
// What the bfloat16 design does about that. One block of three warpgroups
// per (128 query rows, b * H), the heaviest causal query tiles first and
// the query heads of one KV head in neighbouring blocks, so their K/V tiles
// are shared in L2:
//
// - a producer warpgroup, cut to 24 registers a thread by `setmaxnreg`, in
//   which one thread issues TMA tiled copies: the 128 x hd query tile once,
//   then K and V tiles of BKV keys (128, or 64 at hd 256) into a ring of
//   two stages. Each copy completes on a "full" mbarrier; the consumers
//   free a stage on an "empty" mbarrier. The tensor maps are 4-D over the
//   model layout (hd, heads, S, B) with boxes of at most 64 columns (hd 128
//   and 256 take 2 and 4 boxes a tile) and the swizzle of the box's inner
//   bytes (32, 64 or 128 B); rows past Sq or Skv arrive as zeros.
// - two consumer warpgroups of 64 query rows each, raised to 240 registers
//   a thread (the O accumulator alone is hd / 2 of them), which share every
//   stage. Per tile: S = Q K^T by `wgmma` m64n{BKV}k16 with Q and K from
//   shared memory, K-major; scale, soft-cap, and the masks only on tiles
//   that cross the diagonal, the window's edge or Skv; a tile dead for a
//   warpgroup's 64 rows is waited for and released but not computed; the
//   online softmax in float32 in the log2 domain (exp2f), each row's max
//   and sum over the four threads of a quad; P split in registers into two
//   bf16 terms, hi = bf16(p) and lo = bf16(p - hi), each the register A
//   operand of m64n{hd}k16 (the accumulator fragment of the first product
//   is the A fragment of the second), O += P_hi V + P_lo V with V from
//   shared memory, MN-major (the descriptor's transpose bit).
// - epilogue: O / max(l, 1e-30) rounded once to bf16, written swizzled into
//   the warpgroup's own rows of the query tile, stored by TMA, which drops
//   rows past Sq.
//
// What it does not do yet: overlap the two warpgroups' softmax with each
// other's products (pingpong scheduling), overlap a warpgroup's softmax
// with its next Q K^T product, keep one persistent block per SM that walks
// many tiles, split the keys of one query tile over several blocks for
// short-query decoding, skip the lo term of P where it cannot matter, or
// use fp8. The float32 kernel uses no tensor
// cores, loads synchronously and keeps one query row per 16 dims a thread.
//
// Arithmetic contract.
//
// - bfloat16 (changed from the plain version's): both products run on the
//   tensor cores with float32 accumulation. p enters the P.V product as
//   hi + lo, two bf16 terms that carry it to about 2^-16 relative, where
//   the TPU kernel and the plain version (repro_torch/kernels/
//   flash_attention/ref.py) keep p in float32; l sums the float32 p.
//   FlashAttention-2/3 and SDPA round p to one bf16 term; here that failed
//   the stated bound on the card (an early row of a causal sequence
//   averages two or three keys, and a 2^-9 error in their weights moved
//   the output by 2.3e-3 where the bound allowed 1.8e-3), so the P.V
//   product is issued twice. exp2f of log2-scaled scores in place of expf;
//   the output is rounded to bf16 once. Held to 2e-2 relative plus 2e-2
//   times the output's root mean square.
// - float32: float32 throughout, fused multiply-adds allowed (no
//   -fmad=false here), expf / tanhf from CUDA's libm, no fast math. Held to
//   2e-5 absolute plus relative.
//
// Sums run in another order than the plain version, so neither is bitwise
// equal to it. Rows that see no key at all are outside the contract, as
// they are for the TPU kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

namespace cuda_cores {

constexpr int THREADS = 256;   // per block
constexpr int BKV = 64;        // keys per shared-memory tile
constexpr int SUB = 32;        // keys per update of the softmax state
constexpr int DPT = 16;        // dims of a query row held by one thread

__device__ inline float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ inline void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <int HD>
constexpr int smem_bytes() {
  return 2 * BKV * HD * (int)sizeof(float);
}

// One block: BQ = THREADS / (HD / 16) query rows of one (b, h). Thread
// `part` of a row holds dims 4 * (part + TPR * i) .. + 3 for i < 4, so the
// threads of a row read neighbouring 16-byte words of a shared-memory row.
// A tile of 64 keys and 64 values is staged in shared memory; the softmax
// state is updated once per 32 keys, the dot products finished by warp
// shuffles.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, int Sq,
            int Skv, int H, int KV, int causal, int window, float softcap,
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

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  constexpr int BQ = THREADS / (HD / DPT);
  constexpr int smem = smem_bytes<HD>();
  auto kern = attn_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, KV,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace cuda_cores

// ---------------------------------------------------------------------------
// bfloat16: the Hopper kernel (wgmma fed by a TMA ring)
// ---------------------------------------------------------------------------

namespace sm90 {

constexpr int BQ = 128;            // query rows per block
constexpr int ROWS = 64;           // query rows per consumer warpgroup
constexpr int CONSUMERS = BQ / ROWS;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int STAGES = 2;          // K/V ring
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90
constexpr float LOG2E = 1.4426950408889634f;

static_assert(128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <= 65536,
              "the register file of one SM");

struct Barriers {
  uint64_t q;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

template <int HD>
struct Tile {
  static constexpr int BKV = HD == 256 ? 64 : 128;   // keys per stage
  static constexpr int CW = HD < 64 ? HD : 64;       // columns per TMA box
  static constexpr int CWB = 2 * CW;                 // bytes of a box row
  static constexpr int NCH = HD / CW;                // boxes across a row
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;      // one K or V tile
  // 1024 to align the tiles for the swizzle, then Q, the ring, barriers
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES +
                              (int)sizeof(Barriers);
  static_assert(SMEM <= SMEM_LIMIT, "dynamic shared memory of one block");
  static_assert(KV_BYTES % 1024 == 0 && (BQ * CWB) % 1024 == 0,
                "every tile starts on a swizzle atom");
};

// The block whose first query row is q0 reads KV tiles [*lo, *hi): the TPU
// kernel's predicate for a tile masked for every row of the block.
__device__ inline void kv_range(int q0, int Skv, int off, int bkv,
                                int causal, int window, int* lo, int* hi) {
  const int n_kv = (Skv + bkv - 1) / bkv;
  *hi = n_kv;
  if (causal) {
    const int last = q0 + BQ - 1 + off;       // last key any row sees
    *hi = last < 0 ? 0 : min(n_kv, last / bkv + 1);
  }
  *lo = 0;
  if (window > 0) {
    const int first = q0 + off - window + 1;  // first key any row sees
    *lo = first > 0 ? first / bkv : 0;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
attn_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap to, int Sq, int Skv, int H,
            int KV, int causal, int window, float softcap, float scale) {
  using T = Tile<HD>;
  constexpr int BKV = T::BKV;
  constexpr int CW = T::CW;
  constexpr int CWB = T::CWB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023))
                              & 1023);
  uint8_t* q_s = base;                        // [NCH][BQ][CW]
  uint8_t* ring = base + T::Q_BYTES;          // [STAGES][K, V][NCH][BKV][CW]
  Barriers* bars = reinterpret_cast<Barriers*>(
      ring + STAGES * 2 * T::KV_BYTES);

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int off = Skv - Sq;
  int kt_lo, kt_hi;
  kv_range(q0, Skv, off, BKV, causal, window, &kt_lo, &kt_hi);

  if (threadIdx.x == 0) {
    hopper::mbar_init(&bars->q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&bars->full[s], 1);
      hopper::mbar_init(&bars->empty[s], 128 * CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every copy ----
    hopper::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      hopper::mbar_arrive_expect_tx(&bars->q, T::Q_BYTES);
      for (int c = 0; c < T::NCH; ++c) {
        hopper::tma_load_4d(q_s + c * BQ * CWB, &tq, &bars->q, c * CW, h, q0,
                            b);
      }
      for (int i = 0; i < kt_hi - kt_lo; ++i) {
        const int s = i % STAGES;
        const int k0 = (kt_lo + i) * BKV;
        uint8_t* k_s = ring + s * 2 * T::KV_BYTES;
        uint8_t* v_s = k_s + T::KV_BYTES;
        hopper::mbar_wait(&bars->empty[s], ((i / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&bars->full[s], 2 * T::KV_BYTES);
        for (int c = 0; c < T::NCH; ++c) {
          hopper::tma_load_4d(k_s + c * BKV * CWB, &tk, &bars->full[s],
                              c * CW, kvh, k0, b);
        }
        for (int c = 0; c < T::NCH; ++c) {
          hopper::tma_load_4d(v_s + c * BKV * CWB, &tv, &bars->full[s],
                              c * CW, kvh, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    hopper::regs_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % 128;
    const int r0 = 16 * (t / 32) + (t % 32) / 4;   // rows r0 and r0 + 8
    const int cq = 2 * (t % 4);                     // columns cq, cq + 1
    const int qa = q0 + ROWS * wg;                  // the warpgroup's first row
    const int qp0 = qa + r0;
    const int qp1 = qp0 + 8;
    const uint8_t* q_wg = q_s + ROWS * wg * CWB;

    float o[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF;   // running max, log2 domain
    float l0 = 0.f, l1 = 0.f;           // this thread's part of the sums

    hopper::mbar_wait(&bars->q, 0);
    for (int i = 0; i < kt_hi - kt_lo; ++i) {
      const int s = i % STAGES;
      const int k0 = (kt_lo + i) * BKV;
      const uint8_t* k_s = ring + s * 2 * T::KV_BYTES;
      const uint8_t* v_s = k_s + T::KV_BYTES;
      hopper::mbar_wait(&bars->full[s], (i / STAGES) & 1);
      const bool dead = (causal && k0 > qa + ROWS - 1 + off) ||
                        (window > 0 && k0 + BKV - 1 <= qa + off - window);
      if (!dead) {
        // S = Q K^T over hd / 16 steps of 16 dims
        float sc[BKV / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) {
          const int c = 16 * j / CW;
          const int inner = 2 * (16 * j % CW);
          hopper::Wgmma<BKV>::ss(
              sc,
              hopper::smem_desc(q_wg + c * BQ * CWB + inner, 16, 8 * CWB,
                                CWB),
              hopper::smem_desc(k_s + c * BKV * CWB + inner, 16, 8 * CWB,
                                CWB),
              j > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(sc);

        // scale, soft-cap, masks (only where a mask can bite), row maxima
        const bool edge = k0 + BKV > Skv ||
                          (causal && k0 + BKV - 1 > qa + off) ||
                          (window > 0 && k0 <= qa + ROWS - 1 + off - window);
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) {
          float x = sc[e] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          x *= LOG2E;
          if (edge) {
            const int kp = k0 + 8 * (e / 4) + cq + (e & 1);
            const int qp = (e & 2) ? qp1 : qp0;
            bool live = kp < Skv;
            if (causal) live = live && kp <= qp + off;
            if (window > 0) live = live && kp > qp + off - window;
            if (!live) x = NEG_INF;
          }
          sc[e] = x;
          if (e & 2) {
            mx1 = fmaxf(mx1, x);
          } else {
            mx0 = fmaxf(mx0, x);
          }
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float a0 = exp2f(m0 - mx0);
        const float a1 = exp2f(m1 - mx1);
        m0 = mx0;
        m1 = mx1;

        // P as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), laid
        // out as the A fragments of the P V product
        uint32_t p_hi[BKV / 4], p_lo[BKV / 4];
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int e = 0; e < BKV / 2; e += 2) {
          const float mr = (e & 2) ? m1 : m0;
          const float x0 = exp2f(sc[e] - mr);
          const float x1 = exp2f(sc[e + 1] - mr);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const float2 h = __bfloat1622float2(hi);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(x0 - h.x, x1 - h.y);
          if (e & 2) {
            ps1 += x0 + x1;
          } else {
            ps0 += x0 + x1;
          }
          p_hi[e / 2] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[e / 2] = *reinterpret_cast<const uint32_t*>(&lo);
        }
        l0 = l0 * a0 + ps0;
        l1 = l1 * a1 + ps1;
#pragma unroll
        for (int e = 0; e < HD / 2; ++e) o[e] *= (e & 2) ? a1 : a0;

        // O += P_hi V + P_lo V over BKV / 16 steps of 16 keys
        hopper::fence_regs(o);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          const uint64_t dv = hopper::smem_desc(v_s + kk * 16 * CWB,
                                                BKV * CWB, 8 * CWB, CWB);
          hopper::Wgmma<HD>::rs(o, &p_hi[4 * kk], dv);
          hopper::Wgmma<HD>::rs(o, &p_lo[4 * kk], dv);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(o);
      }
      hopper::mbar_arrive(&bars->empty[s]);
    }

    // epilogue: normalise, round once, write swizzled into this
    // warpgroup's rows of the Q tile (read by no one any more), TMA store
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f);
    const float d1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int e = 0; e < HD / 2; e += 2) {
      const int r = ROWS * wg + ((e & 2) ? r0 + 8 : r0);
      const int col = 8 * (e / 4) + cq;
      const uint32_t at = (col / CW) * BQ * CWB + r * CWB + 2 * (col % CW);
      const uint32_t sw = at ^ (((at >> 7) & (CWB / 16 - 1)) << 4);
      const float d = (e & 2) ? d1 : d0;
      *reinterpret_cast<__nv_bfloat162*>(q_s + sw) =
          __floats2bfloat162_rn(o[e] / d, o[e + 1] / d);
    }
    hopper::fence_async_shared();
    hopper::named_barrier(1 + wg, 128);
    if (t == 0 && qa < Sq) {
      for (int c = 0; c < T::NCH; ++c) {
        hopper::tma_store_4d(&to, q_s + c * BQ * CWB + ROWS * wg * CWB,
                             c * CW, h, qa, b);
      }
      hopper::tma_store_wait_all();
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The CUDA driver's cuTensorMapEncodeTiled through the runtime, so that
// the library needs no -lcuda; null if the CUDA driver has none.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A 4-D map over a contiguous bf16 tensor [batch, seq, heads, hd], boxes of
// `cw` columns x 1 head x `rows` rows x 1 batch, swizzled by the box's
// inner bytes; elements outside the tensor read as zeros.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int hd,
                int heads, int seq, int batch, int cw, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * hd * heads,
                                 2ull * hd * heads * seq};
  const cuuint32_t box[4] = {(cuuint32_t)cw, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : cw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  CUtensorMap tq, tk, tv, to;
  CUresult r = encode(fn, &tq, q, HD, H, Sq, B, T::CW, BQ);
  if (r == CUDA_SUCCESS) r = encode(fn, &tk, k, HD, KV, Skv, B, T::CW, T::BKV);
  if (r == CUDA_SUCCESS) r = encode(fn, &tv, v, HD, KV, Skv, B, T::CW, T::BKV);
  if (r == CUDA_SUCCESS) r = encode(fn, &to, o, HD, H, Sq, B, T::CW, ROWS);
  if (r != CUDA_SUCCESS) return -1000 - (int)r;
  auto kern = attn_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, T::SMEM, stream>>>(tq, tk, tv, to, Sq, Skv, H, KV,
                                           causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace sm90

// kind 0: float32 (CUDA cores); kind 1: bfloat16 (sm90)
template <int HD>
int launch(int kind, const void* q, const void* k, const void* v, void* o,
           int B, int Sq, int Skv, int H, int KV, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  if (kind == 1) {
    return sm90::launch<HD>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                            softcap, scale, stream);
  }
  return cuda_cores::launch<HD>(q, k, v, o, B, Sq, Skv, H, KV, causal,
                                window, softcap, scale, stream);
}

template <int HD>
int smem_bytes(int kind) {
  return kind == 1 ? sm90::Tile<HD>::SMEM : cuda_cores::smem_bytes<HD>();
}

}  // namespace

// Enqueue one launch on `stream`; `kind` 0 for float32 inputs, 1 for
// bfloat16. Returns cudaGetLastError() after the launch (0 when it was
// accepted), the error of cudaFuncSetAttribute if that failed, -1 for a
// head dim or kind without a kernel, -2 if the CUDA driver has no
// cuTensorMapEncodeTiled, and -1000 - CUresult if it refused a tensor map.
extern "C" int flash_attention_launch(int kind, int hd, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int H, int KV,
                                      int causal, int window, float softcap,
                                      float scale, void* stream) {
  if (kind != 0 && kind != 1) return -1;
  cudaStream_t cs = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return launch<16>(kind, q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                        softcap, scale, cs);
    case 32:
      return launch<32>(kind, q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                        softcap, scale, cs);
    case 64:
      return launch<64>(kind, q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                        softcap, scale, cs);
    case 128:
      return launch<128>(kind, q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                         softcap, scale, cs);
    case 256:
      return launch<256>(kind, q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                         softcap, scale, cs);
    default:
      return -1;
  }
}

// Dynamic shared memory, in bytes, of the kernel for (`kind`, `hd`), or -1.
extern "C" int flash_attention_smem_bytes(int kind, int hd) {
  if (kind != 0 && kind != 1) return -1;
  switch (hd) {
    case 16: return smem_bytes<16>(kind);
    case 32: return smem_bytes<32>(kind);
    case 64: return smem_bytes<64>(kind);
    case 128: return smem_bytes<128>(kind);
    case 256: return smem_bytes<256>(kind);
    default: return -1;
  }
}
