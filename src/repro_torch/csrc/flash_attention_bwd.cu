// Flash-attention backward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/ops.py:_bwd_vjp, the JAX
// package's custom_vjp backward (the vjp of the plain oracle under
// recompute: the TPU has no backward kernel). It computes the same
// gradient from the forward's saved log-sum-exp L, FlashAttention-2 style,
// so no (Sq, Sk) matrix ever reaches device memory.
//
// What it computes: for the forward's causal / windowed GQA attention (q
// (B, Hq, Sq, d), k and v (B, Hkv, Sk, d), q head h on kv head h / (Hq /
// Hkv), query row r sees key c iff c <= r + (Sk - Sq) when causal and
// c > r + (Sk - Sq) - window when window > 0), given out, dO and L
// (float32, (B, Hq, Sq), +inf on a row that sees no key):
//   D_r   = sum_c dO_rc O_rc                      (float32)
//   P_rc  = exp(scale q_r . k_c - L_r)             (0 where not seen)
//   dV_c  = sum_{h in group, r} P_rc dO_r
//   dS_rc = P_rc (dO_r . v_c - D_r)
//   dK_c  = scale sum_{h in group, r} dS_rc q_r
//   dQ_r  = scale sum_c dS_rc k_c
//
// What bounds it on the H100: the operations. Five products of a (q, k)
// pair per head dim (S, dP, dV, dK, dQ: 10 flops) against the forward's
// two; at llama3.2-3b's training shape (2 x 24/8 heads x 2048 x 128) that
// is 1.29e11 flops, 0.130 ms at the bf16 tensor-core rate, against 0.02
// ms for its 63 MB of inputs and outputs.
//
// Three kernels a call (four when the GQA group is split), all in a fixed
// order of summation: no atomics, so two calls give the same bits.
//   * D: one warp a row, lanes over the head dim, a butterfly of shuffles.
//   * dK/dV: one block per (b, kv head, 64 keys; 32 in float32), and per
//     part of the GQA group when there are too few such blocks to fill
//     the card (recurrentgemma-2b: one kv head, 32 key blocks a row). The
//     block keeps its keys' K and V in shared memory and loops over its
//     group's q heads and over the query tiles that the causal window
//     lets see its keys, recomputing P from L, with dK and dV in
//     registers. A split group writes float32 partials that a fourth
//     kernel adds in split order.
//   * dQ: one block per (b, q head, 64 query rows; 32 in float32), looping
//     over the key tiles its rows see, dQ in registers.
//
// bfloat16 runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate), with the forward's fragment tricks: an accumulator tile of
// m16n8 has the A fragment's layout, so P^T and dS^T (dK/dV) and dS (dQ)
// feed the next product from registers; P and dS are rounded to bf16
// before their products, as the forward rounds P before P V. In dK/dV a
// warp owns 16 keys and computes S^T = K Q^T and dP^T = V dO^T with keys
// as rows; Q and dO tiles (with L and D) stream through a two-stage
// cp.async ring. At d 256 one warp's dK and dV accumulators alone would be
// 256 f32 registers a thread, so eight warps split the work: warps 0-3
// compute P^T and dV, warps 4-7 P^T again, dP^T, dS^T and dK, each for the
// same 16 keys (P^T is recomputed rather than passed through shared
// memory). dQ keeps the forward's shape: four warps of 16 rows, K and V
// tiles (64 rows, 32 at d 256) in a two-stage ring.
//
// float32 keeps plain FMA (tensor cores would mean TF32): tiles in shared
// memory as f32 (rows padded by one float), each of 128 threads owning a
// (2 x 4) patch of the score tile and a (2 x d/8) patch of the
// accumulators.
//
// Every device kernel's name starts with fa2_bwd_ (a profile sums them by
// that). Head dims 16, 32, 64, 80, 128 and 256, one instantiation each.
// Ragged Sq and Sk are masked in the kernels; tiles that no row sees are
// never loaded. A simple right kernel first: wgmma, TMA and warp specialisation
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

__device__ __forceinline__ bool visible(int kc, int qr, int Sq, int Sk,
                                        int off, int causal, int window) {
  bool ok = kc < Sk && qr < Sq;
  if (causal) ok = ok && kc <= qr + off;
  if (window > 0) ok = ok && kc > qr + off - window;
  return ok;
}

// The queries that keys [k_lo, k_hi] can be seen by, as query tiles of BQ
// rows: [*qt_begin, *qt_begin + *n_qt)
__device__ __forceinline__ void query_tiles(int k_lo, int k_hi, int Sq,
                                            int off, int causal, int window,
                                            int BQ, int* qt_begin,
                                            int* n_qt) {
  const int r_begin = causal ? max(0, k_lo - off) : 0;
  int r_end = Sq;
  if (window > 0) r_end = min(r_end, k_hi - off + window);
  *qt_begin = r_begin / BQ;
  *n_qt = r_end > r_begin ? (r_end + BQ - 1) / BQ - *qt_begin : 0;
}

// The keys rows [q_lo, q_hi] can see, as key tiles of BK rows:
// [*kt_begin, *kt_end)
__device__ __forceinline__ void key_tiles(int q_lo, int q_hi, int Sk, int off,
                                          int causal, int window, int BK,
                                          int* kt_begin, int* kt_end) {
  int k_end = Sk;
  if (causal) k_end = min(k_end, q_hi + off + 1);
  const int k_begin = window > 0 ? max(0, q_lo + off - window + 1) : 0;
  *kt_begin = k_begin / BK;
  *kt_end = k_end > k_begin ? (k_end + BK - 1) / BK : *kt_begin;
}

// ---------------------------------------------------------------------------
// D = rowsum(dO * O), float32: one warp a row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) fa2_bwd_delta(
    const T* __restrict__ o, const T* __restrict__ dO,
    float* __restrict__ delta, long long rows, int d) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;   // the whole warp leaves together
  const T* a = o + row * d;
  const T* b = dO + row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += to_f32(a[c]) * to_f32(b[c]);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) delta[row] = s;
}

// dK, dV = the sum over splits of the float32 partials, in split order.
// part: (splits, 2, n), dK's before dV's
template <typename T>
__global__ void __launch_bounds__(256) fa2_bwd_sum_parts(
    const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
    long long n, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < splits; ++s) {
      a += part[(2 * (long long)s) * n + i];
      c += part[(2 * (long long)s + 1) * n + i];
    }
    store_as(dk + i, a);
    store_as(dv + i, c);
  }
}

// ---------------------------------------------------------------------------
// float32: FMA
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 128;   // 16 row groups x 8 column lanes

template <int D>
struct FmaTile {
  static constexpr int BK = 32;           // keys a dK/dV block, a dQ step
  static constexpr int BQ = 32;           // queries a dK/dV step, a dQ block
  static constexpr int RM = 2;            // rows a thread: BK / 16 = BQ / 16
  static constexpr int CN = 4;            // score columns a thread: 32 / 8
  static constexpr int DN = D / 8;        // accumulator columns a thread
  static constexpr int ST = D + 1;        // padded row stride
  static constexpr int PST = 32 + 1;      // padded row stride of P / dS
  // dK/dV: K, V, Q, dO tiles, L, D, P^T and dS^T
  static constexpr size_t smem_kv =
      sizeof(float) * ((size_t)(BK + BK + BQ + BQ) * ST + 2 * BQ +
                       2 * (size_t)BK * PST);
  // dQ: Q, dO, K, V tiles and dS
  static constexpr size_t smem_q =
      sizeof(float) * ((size_t)(BQ + BQ + BK + BK) * ST + (size_t)BQ * PST);
};

template <int D>
__global__ void __launch_bounds__(kFmaThreads) fa2_bwd_fma_dkdv(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ part,
    int Hq, int Hkv, int Sq, int Sk, int causal, int window, float scale,
    int splits) {
  using TL = FmaTile<D>;
  constexpr int BK = TL::BK, BQ = TL::BQ, RM = TL::RM, CN = TL::CN;
  constexpr int DN = TL::DN, ST = TL::ST, PST = TL::PST;
  extern __shared__ float fsm[];
  float* Ks = fsm;                 // (BK, ST)
  float* Vs = Ks + BK * ST;        // (BK, ST)
  float* Qs = Vs + BK * ST;        // (BQ, ST)
  float* dOs = Qs + BQ * ST;       // (BQ, ST)
  float* Ls = dOs + BQ * ST;       // (BQ)
  float* Ds = Ls + BQ;             // (BQ)
  float* Ps = Ds + BQ;             // (BK, PST): P^T
  float* dSs = Ps + BK * PST;      // (BK, PST): dS^T

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int k_lo = blockIdx.x * BK;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int split = blockIdx.z;
  const int g = Hq / Hkv;
  const int h_begin = hk * g + split * g / splits;
  const int h_end = hk * g + (split + 1) * g / splits;
  const int off = Sk - Sq;
  const size_t kv_base = ((size_t)b * Hkv + hk) * (size_t)Sk * D;

  for (int i = tid; i < BK * D; i += kFmaThreads) {
    const int r = i / D, c = i % D;
    const bool in = k_lo + r < Sk;
    Ks[r * ST + c] = in ? k[kv_base + (size_t)(k_lo + r) * D + c] : 0.f;
    Vs[r * ST + c] = in ? v[kv_base + (size_t)(k_lo + r) * D + c] : 0.f;
  }

  int qt_begin, n_qt;
  query_tiles(k_lo, min(k_lo + BK, Sk) - 1, Sq, off, causal, window, BQ,
              &qt_begin, &n_qt);

  float acc_v[RM][DN], acc_k[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc_v[i][j] = acc_k[i][j] = 0.f;

  for (int h = h_begin; h < h_end; ++h) {
    const size_t q_base = ((size_t)b * Hq + h) * (size_t)Sq;
    for (int qt = qt_begin; qt < qt_begin + n_qt; ++qt) {
      const int q_lo = qt * BQ;
      __syncthreads();   // the previous tile is consumed
      for (int i = tid; i < BQ * D; i += kFmaThreads) {
        const int r = i / D, c = i % D;
        const bool in = q_lo + r < Sq;
        const size_t at = (q_base + q_lo + r) * D + c;
        Qs[r * ST + c] = in ? q[at] : 0.f;
        dOs[r * ST + c] = in ? dO[at] : 0.f;
      }
      if (tid < BQ) {
        const bool in = q_lo + tid < Sq;
        Ls[tid] = in ? lse[q_base + q_lo + tid] : pos_inf();
        Ds[tid] = in ? delta[q_base + q_lo + tid] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T on this thread's (keys, queries)
      float s[RM][CN], dp[RM][CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < D; ++kk) {
        float kv[RM], vv[RM], qv[CN], dov[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          kv[i] = Ks[(ty * RM + i) * ST + kk];
          vv[i] = Vs[(ty * RM + i) * ST + kk];
        }
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          qv[j] = Qs[(tx + 8 * j) * ST + kk];
          dov[j] = dOs[(tx + 8 * j) * ST + kk];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            s[i][j] += kv[i] * qv[j];
            dp[i][j] += vv[i] * dov[j];
          }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int kc = k_lo + ty * RM + i, qc = tx + 8 * j;
          const float p = visible(kc, q_lo + qc, Sq, Sk, off, causal, window)
                              ? expf(s[i][j] * scale - Ls[qc])
                              : 0.f;
          Ps[(ty * RM + i) * PST + qc] = p;
          dSs[(ty * RM + i) * PST + qc] = p * (dp[i][j] - Ds[qc]);
        }
      __syncthreads();   // P^T and dS^T complete

      // dV += P^T dO, dK += dS^T Q
      for (int c = 0; c < BQ; ++c) {
        float pv[RM], dsv[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          pv[i] = Ps[(ty * RM + i) * PST + c];
          dsv[i] = dSs[(ty * RM + i) * PST + c];
        }
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          const float dov = dOs[c * ST + tx + 8 * j];
          const float qv = Qs[c * ST + tx + 8 * j];
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            acc_v[i][j] += pv[i] * dov;
            acc_k[i][j] += dsv[i] * qv;
          }
        }
      }
    }
  }

  const size_t n = (size_t)gridDim.y * Sk * D;   // B * Hkv * Sk * D
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kc = k_lo + ty * RM + i;
    if (kc >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const size_t at = kv_base + (size_t)kc * D + tx + 8 * j;
      if (splits == 1) {
        dk[at] = acc_k[i][j] * scale;
        dv[at] = acc_v[i][j];
      } else {
        part[2 * split * n + at] = acc_k[i][j] * scale;
        part[(2 * split + 1) * n + at] = acc_v[i][j];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads) fa2_bwd_fma_dq(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk, int causal,
    int window, float scale) {
  using TL = FmaTile<D>;
  constexpr int BK = TL::BK, BQ = TL::BQ, RM = TL::RM, CN = TL::CN;
  constexpr int DN = TL::DN, ST = TL::ST, PST = TL::PST;
  extern __shared__ float fsm[];
  float* Qs = fsm;                 // (BQ, ST)
  float* dOs = Qs + BQ * ST;       // (BQ, ST)
  float* Ks = dOs + BQ * ST;       // (BK, ST)
  float* Vs = Ks + BK * ST;        // (BK, ST)
  float* dSs = Vs + BK * ST;       // (BQ, PST)

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q_lo = blockIdx.x * BQ;
  const int off = Sk - Sq;
  const size_t q_base = (size_t)bh * Sq;
  const size_t kv_base = ((size_t)b * Hkv + hk) * (size_t)Sk * D;

  for (int i = tid; i < BQ * D; i += kFmaThreads) {
    const int r = i / D, c = i % D;
    const bool in = q_lo + r < Sq;
    const size_t at = (q_base + q_lo + r) * D + c;
    Qs[r * ST + c] = in ? q[at] : 0.f;
    dOs[r * ST + c] = in ? dO[at] : 0.f;
  }
  float lr[RM], dr[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qr = q_lo + ty * RM + i;
    lr[i] = qr < Sq ? lse[q_base + qr] : pos_inf();
    dr[i] = qr < Sq ? delta[q_base + qr] : 0.f;
  }

  int kt_begin, kt_end;
  key_tiles(q_lo, min(q_lo + BQ, Sq) - 1, Sk, off, causal, window, BK,
            &kt_begin, &kt_end);

  float acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * BK;
    __syncthreads();   // the previous tile is consumed
    for (int i = tid; i < BK * D; i += kFmaThreads) {
      const int r = i / D, c = i % D;
      const bool in = k_lo + r < Sk;
      Ks[r * ST + c] = in ? k[kv_base + (size_t)(k_lo + r) * D + c] : 0.f;
      Vs[r * ST + c] = in ? v[kv_base + (size_t)(k_lo + r) * D + c] : 0.f;
    }
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float qv[RM], dov[RM], kv[CN], vv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        qv[i] = Qs[(ty * RM + i) * ST + kk];
        dov[i] = dOs[(ty * RM + i) * ST + kk];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        kv[j] = Ks[(tx + 8 * j) * ST + kk];
        vv[j] = Vs[(tx + 8 * j) * ST + kk];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += dov[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int qr = q_lo + ty * RM + i, kc = k_lo + tx + 8 * j;
        const float p = visible(kc, qr, Sq, Sk, off, causal, window)
                            ? expf(s[i][j] * scale - lr[i])
                            : 0.f;
        dSs[(ty * RM + i) * PST + tx + 8 * j] = p * (dp[i][j] - dr[i]);
      }
    __syncthreads();   // dS complete

    // dQ += dS K
    for (int c = 0; c < BK; ++c) {
      float dsv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) dsv[i] = dSs[(ty * RM + i) * PST + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const float kv = Ks[c * ST + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][j] += dsv[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qr = q_lo + ty * RM + i;
    if (qr >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DN; ++j)
      dq[(q_base + qr) * D + tx + 8 * j] = acc[i][j] * scale;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync.m16n8k16)
// ---------------------------------------------------------------------------

template <int D>
struct MmaTile {
  // dK/dV: 64 keys a block, 16 a warp; at d 256 a second set of four
  // warps takes dK (kSplit)
  static constexpr bool kSplit = D == 256;
  static constexpr int kKvThreads = kSplit ? 256 : 128;
  static constexpr int BKV = 64;
  static constexpr int BQ = D <= 64 ? 64 : 32;     // queries a step
  // dQ: 64 rows a block, 16 a warp; key tiles of 64 rows (32 at d 256)
  static constexpr int kQThreads = 128;
  static constexpr int BM = 64;
  static constexpr int BKQ = D == 256 ? 32 : 64;
  static constexpr int ST = D + 8;                 // row stride: +16 bytes
  static constexpr size_t smem_kv =
      sizeof(bf16) * (size_t)ST * (2 * BKV + 4 * BQ) + sizeof(float) * 4 * BQ;
  static constexpr size_t smem_q =
      sizeof(bf16) * (size_t)ST * (2 * BM + 4 * BKQ);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of columns [16 ks, 16 ks + 16) of an m16n8 accumulator row
// of n-blocks: the accumulator's layout is the A fragment's
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (&x)[N][4],
                                         int ks) {
  a[0] = pack_bf16(x[2 * ks][0], x[2 * ks][1]);
  a[1] = pack_bf16(x[2 * ks][2], x[2 * ks][3]);
  a[2] = pack_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]);
  a[3] = pack_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3]);
}

// lane addresses into a (rows, ST) bf16 tile at row 0 for ldmatrix x4:
// the A fragment of 16 rows (add 32 bytes a k-step of 16 columns)
__device__ __forceinline__ uint32_t a_addr(const bf16* s, int ST, int lane) {
  return smem_u32(s + (lane % 16) * ST + 8 * (lane / 16));
}
// B fragments of two n-blocks of 8 rows each, the tile's rows being the n
// index (S = A B with B^T stored row-major: K for Q K^T); add
// (8 j ST + 16 ks) * 2 bytes for n-blocks (j, j + 1) at k-step ks
__device__ __forceinline__ uint32_t bt_addr(const bf16* s, int ST, int lane) {
  return smem_u32(s + (8 * (lane / 16) + lane % 8) * ST + 8 * ((lane / 8) % 2));
}
// B fragments of two n-blocks of 8 columns each, the tile's rows being the
// k index (B stored row-major: V for P V), read transposed; add
// (16 ks ST + 8 j) * 2 bytes
__device__ __forceinline__ uint32_t b_addr(const bf16* s, int ST, int lane) {
  return smem_u32(s + (lane % 8 + 8 * ((lane / 8) % 2)) * ST + 8 * (lane / 16));
}

// rows [r0, r0 + R) of a (rows, D) bf16 matrix into s (row stride ST),
// zero past the last row; the caller commits the cp.async group
template <int D, int R, int ST, int NT>
__device__ __forceinline__ void stage_rows(bf16* s, const bf16* g, int r0,
                                           int rows) {
  constexpr int CPR = D / 8;               // 16-byte chunks a row
  for (int e = threadIdx.x; e < R * CPR; e += NT) {
    const int r = e / CPR, c = (e % CPR) * 8;
    const bool in = r0 + r < rows;
    cp_async16(smem_u32(s + r * ST + c),
               in ? g + (size_t)(r0 + r) * D + c : g, in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(MmaTile<D>::kKvThreads) fa2_bwd_mma_dkdv(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
    int Hq, int Hkv, int Sq, int Sk, int causal, int window, float scale,
    float scale_log2, int splits) {
  using TL = MmaTile<D>;
  constexpr int BKV = TL::BKV, BQ = TL::BQ, ST = TL::ST;
  constexpr int NT = TL::kKvThreads;
  constexpr int NQ = BQ / 8;                 // query n-blocks of S^T
  constexpr int ND = D / 8;                  // n-blocks of dK, dV
  constexpr int NACC = TL::kSplit ? 1 : 2;   // accumulators a warp
  extern __shared__ __align__(16) unsigned char bsm[];
  bf16* Ks = reinterpret_cast<bf16*>(bsm);   // (BKV, ST)
  bf16* Vs = Ks + BKV * ST;                  // (BKV, ST)
  bf16* Qs = Vs + BKV * ST;                  // 2 stages of (BQ, ST)
  bf16* dOs = Qs + 2 * BQ * ST;              // 2 stages of (BQ, ST)
  float* L2s = reinterpret_cast<float*>(dOs + 2 * BQ * ST);  // 2 x BQ
  float* Ds = L2s + 2 * BQ;                  // 2 x BQ

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = warp % 4;                   // the warp's 16 keys
  // warp-uniform roles: every warp both, or at d 256 dV (0-3) and dK (4-7)
  const bool do_dv = !TL::kSplit || warp < 4;
  const bool do_dk = !TL::kSplit || warp >= 4;
  const int k_lo = blockIdx.x * BKV;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int split = blockIdx.z;
  const int g = Hq / Hkv;
  const int h_begin = hk * g + split * g / splits;
  const int n_h = hk * g + (split + 1) * g / splits - h_begin;
  const int off = Sk - Sq;
  const size_t kv_base = ((size_t)b * Hkv + hk) * (size_t)Sk * D;

  int qt_begin, n_qt;
  query_tiles(k_lo, min(k_lo + BKV, Sk) - 1, Sq, off, causal, window, BQ,
              &qt_begin, &n_qt);
  const int n_it = n_qt * n_h;

  // step it: head h_begin + it / n_qt, query tile qt_begin + it % n_qt
  auto stage = [&](int it, int buf) {
    const int h = h_begin + it / n_qt;
    const int q_lo = (qt_begin + it % n_qt) * BQ;
    const size_t q_base = ((size_t)b * Hq + h) * (size_t)Sq;
    stage_rows<D, BQ, ST, NT>(Qs + buf * BQ * ST, q + q_base * D, q_lo, Sq);
    stage_rows<D, BQ, ST, NT>(dOs + buf * BQ * ST, dO + q_base * D, q_lo, Sq);
    if (threadIdx.x < BQ) {
      const int r = q_lo + threadIdx.x;
      L2s[buf * BQ + threadIdx.x] =
          r < Sq ? lse[q_base + r] * kLog2e : pos_inf();
      Ds[buf * BQ + threadIdx.x] = r < Sq ? delta[q_base + r] : 0.f;
    }
  };

  stage_rows<D, BKV, ST, NT>(Ks, k + kv_base, k_lo, Sk);
  stage_rows<D, BKV, ST, NT>(Vs, v + kv_base, k_lo, Sk);
  cp_async_commit();
  if (n_it > 0) stage(0, 0);
  cp_async_commit();

  float acc[NACC][ND][4];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int j = 0; j < ND; ++j)
      acc[a][j][0] = acc[a][j][1] = acc[a][j][2] = acc[a][j][3] = 0.f;

  const uint32_t ka = a_addr(Ks + kw * 16 * ST, ST, lane);
  const uint32_t va = a_addr(Vs + kw * 16 * ST, ST, lane);
  // element e of an n-block of S^T: key row kr0 + 8 (e / 2), query column
  // 8 j + 2 (lane % 4) + e % 2
  const int kr0 = k_lo + kw * 16 + lane / 4;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      stage(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q_lo = (qt_begin + it % n_qt) * BQ;
    const bf16* qb = Qs + buf * BQ * ST;
    const bf16* dob = dOs + buf * BQ * ST;
    const float* l2 = L2s + buf * BQ;
    const float* dd = Ds + buf * BQ;

    // S^T = K Q^T and (dK warps) dP^T = V dO^T: 16 keys x BQ queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    const uint32_t qbt = bt_addr(qb, ST, lane);
    const uint32_t dobt = bt_addr(dob, ST, lane);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, ka + ks * 32);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, qbt + (j * 8 * ST + ks * 16) * 2);
        mma_bf16(st[j], a, bf[0], bf[1]);
        mma_bf16(st[j + 1], a, bf[2], bf[3]);
      }
      if (do_dk) {
        ldmatrix_x4(a, va + ks * 32);
#pragma unroll
        for (int j = 0; j < NQ; j += 2) {
          uint32_t bf[4];
          ldmatrix_x4(bf, dobt + (j * 8 * ST + ks * 16) * 2);
          mma_bf16(dpt[j], a, bf[0], bf[1]);
          mma_bf16(dpt[j + 1], a, bf[2], bf[3]);
        }
      }
    }

    // P^T = exp2(S^T scale log2 e - L log2 e), 0 where not seen; dS^T
    const bool edge = k_lo + BKV > Sk || q_lo + BQ > Sq ||
                      (causal && k_lo + BKV - 1 > q_lo + off) ||
                      (window > 0 && k_lo <= q_lo + BQ - 1 + off - window);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * (lane % 4) + (e % 2);
        float p = exp2f(st[j][e] * scale_log2 - l2[qc]);
        if (edge && !visible(kr0 + 8 * (e / 2), q_lo + qc, Sq, Sk, off,
                             causal, window))
          p = 0.f;
        st[j][e] = p;
        if (do_dk) dpt[j][e] = p * (dpt[j][e] - dd[qc]);
      }

    // dV += P^T dO and dK += dS^T Q: A from the accumulators (bf16), B the
    // tiles' rows transposed
    const uint32_t dob_b = b_addr(dob, ST, lane);
    const uint32_t qb_b = b_addr(qb, ST, lane);
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks) {
      uint32_t a[4];
      if (do_dv) {
        acc_to_a(a, st, ks);
#pragma unroll
        for (int j = 0; j < ND; j += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, dob_b + (ks * 16 * ST + j * 8) * 2);
          mma_bf16(acc[0][j], a, bf[0], bf[1]);
          mma_bf16(acc[0][j + 1], a, bf[2], bf[3]);
        }
      }
      if (do_dk) {
        acc_to_a(a, dpt, ks);
#pragma unroll
        for (int j = 0; j < ND; j += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, qb_b + (ks * 16 * ST + j * 8) * 2);
          mma_bf16(acc[NACC - 1][j], a, bf[0], bf[1]);
          mma_bf16(acc[NACC - 1][j + 1], a, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  const size_t n = (size_t)gridDim.y * Sk * D;   // B * Hkv * Sk * D
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kc = kr0 + 8 * i;
    if (kc >= Sk) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const size_t at = kv_base + (size_t)kc * D + 8 * j + 2 * (lane % 4);
      if (do_dv) {
        const float x0 = acc[0][j][2 * i], x1 = acc[0][j][2 * i + 1];
        if (splits == 1)
          *reinterpret_cast<__nv_bfloat162*>(dv + at) =
              __floats2bfloat162_rn(x0, x1);
        else
          *reinterpret_cast<float2*>(part + (2 * split + 1) * n + at) =
              make_float2(x0, x1);
      }
      if (do_dk) {
        const float x0 = acc[NACC - 1][j][2 * i] * scale;
        const float x1 = acc[NACC - 1][j][2 * i + 1] * scale;
        if (splits == 1)
          *reinterpret_cast<__nv_bfloat162*>(dk + at) =
              __floats2bfloat162_rn(x0, x1);
        else
          *reinterpret_cast<float2*>(part + 2 * split * n + at) =
              make_float2(x0, x1);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MmaTile<D>::kQThreads) fa2_bwd_mma_dq(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk, int causal,
    int window, float scale, float scale_log2) {
  using TL = MmaTile<D>;
  constexpr int BM = TL::BM, BKQ = TL::BKQ, ST = TL::ST;
  constexpr int NT = TL::kQThreads;
  constexpr int NS = BKQ / 8;     // key n-blocks of S
  constexpr int ND = D / 8;       // n-blocks of dQ
  extern __shared__ __align__(16) unsigned char bsm[];
  bf16* Qs = reinterpret_cast<bf16*>(bsm);   // (BM, ST)
  bf16* dOs = Qs + BM * ST;                  // (BM, ST)
  bf16* Ks = dOs + BM * ST;                  // 2 stages of (BKQ, ST)
  bf16* Vs = Ks + 2 * BKQ * ST;              // 2 stages of (BKQ, ST)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BM;   // last tile first
  const int off = Sk - Sq;
  const size_t q_base = (size_t)bh * Sq;
  const size_t kv_base = ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const int q_hi = min(q_lo + BM, Sq) - 1;

  int kt_begin, kt_end;
  key_tiles(q_lo, q_hi, Sk, off, causal, window, BKQ, &kt_begin, &kt_end);

  stage_rows<D, BM, ST, NT>(Qs, q + q_base * D, q_lo, Sq);
  stage_rows<D, BM, ST, NT>(dOs, dO + q_base * D, q_lo, Sq);
  cp_async_commit();
  if (kt_begin < kt_end) {
    stage_rows<D, BKQ, ST, NT>(Ks, k + kv_base, kt_begin * BKQ, Sk);
    stage_rows<D, BKQ, ST, NT>(Vs, v + kv_base, kt_begin * BKQ, Sk);
  }
  cp_async_commit();

  // this lane's rows: r_lo and r_lo + 8
  const int r_lo = q_lo + warp * 16 + lane / 4;
  float l2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    l2[i] = r < Sq ? lse[q_base + r] * kLog2e : pos_inf();
    dd[i] = r < Sq ? delta[q_base + r] : 0.f;
  }
  const uint32_t qa = a_addr(Qs + warp * 16 * ST, ST, lane);
  const uint32_t doa = a_addr(dOs + warp * 16 * ST, ST, lane);

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      stage_rows<D, BKQ, ST, NT>(Ks + (buf ^ 1) * BKQ * ST, k + kv_base,
                                 (kt + 1) * BKQ, Sk);
      stage_rows<D, BKQ, ST, NT>(Vs + (buf ^ 1) * BKQ * ST, v + kv_base,
                                 (kt + 1) * BKQ, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kb = Ks + buf * BKQ * ST;
    const bf16* vb = Vs + buf * BKQ * ST;

    // S = Q K^T and dP = dO V^T: 16 rows x BKQ keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    const uint32_t kbt = bt_addr(kb, ST, lane);
    const uint32_t vbt = bt_addr(vb, ST, lane);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, qa + ks * 32);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kbt + (j * 8 * ST + ks * 16) * 2);
        mma_bf16(s[j], a, bf[0], bf[1]);
        mma_bf16(s[j + 1], a, bf[2], bf[3]);
      }
      ldmatrix_x4(a, doa + ks * 32);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, vbt + (j * 8 * ST + ks * 16) * 2);
        mma_bf16(dp[j], a, bf[0], bf[1]);
        mma_bf16(dp[j + 1], a, bf[2], bf[3]);
      }
    }

    // dS = P (dP - D); element e of s[j]: row r_lo + 8 (e / 2), key
    // kv_lo + 8 j + 2 (lane % 4) + e % 2
    const int kv_lo = kt * BKQ;
    const bool edge = kv_lo + BKQ > Sk ||
                      (causal && kv_lo + BKQ - 1 > q_lo + off) ||
                      (window > 0 && kv_lo <= q_hi + off - window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e] * scale_log2 - l2[e / 2]);
        if (edge && !visible(kv_lo + 8 * j + 2 * (lane % 4) + (e % 2),
                             r_lo + 8 * (e / 2), Sq, Sk, off, causal, window))
          p = 0.f;
        s[j][e] = p * (dp[j][e] - dd[e / 2]);
      }

    // dQ += dS K: A from the accumulators (bf16), K's rows transposed
    const uint32_t kb_b = b_addr(kb, ST, lane);
#pragma unroll
    for (int ks = 0; ks < BKQ / 16; ++ks) {
      uint32_t a[4];
      acc_to_a(a, s, ks);
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, kb_b + (ks * 16 * ST + j * 8) * 2);
        mma_bf16(acc[j], a, bf[0], bf[1]);
        mma_bf16(acc[j + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dq + (q_base + r) * D + 8 * j +
                                         2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[j][0 + 2 * i] * scale,
                                acc[j][1 + 2 * i] * scale);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  float *delta, *part;
  void *dq, *dk, *dv;
  int B, Hq, Hkv, Sq, Sk, causal, window, splits;
  float scale;
  cudaStream_t stream;
};

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
cudaError_t launch_delta(const Args& a, int d) {
  const long long rows = (long long)a.B * a.Hq * a.Sq;
  const long long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fa2_bwd_delta<T><<<(unsigned)blocks, 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dO), a.delta, rows,
      d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sum_parts(const Args& a, int d) {
  const long long n = (long long)a.B * a.Hkv * a.Sk * d;
  const long long want = (n + 255) / 256;
  const long long blocks = want < 65535LL * 8 ? want : 65535LL * 8;
  fa2_bwd_sum_parts<T><<<(unsigned)blocks, 256, 0, a.stream>>>(
      a.part, static_cast<T*>(a.dk), static_cast<T*>(a.dv), n, a.splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma(const Args& a) {
  using TL = FmaTile<D>;
  cudaError_t e = launch_delta<float>(a, D);
  if (e != cudaSuccess) return e;
  auto kv = fa2_bwd_fma_dkdv<D>;
  if ((e = allow_smem(kv, TL::smem_kv)) != cudaSuccess) return e;
  dim3 grid_kv((a.Sk + TL::BK - 1) / TL::BK, a.B * a.Hkv, a.splits);
  kv<<<grid_kv, kFmaThreads, TL::smem_kv, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dO), a.lse,
      a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.part,
      a.Hq, a.Hkv, a.Sq, a.Sk, a.causal, a.window, a.scale, a.splits);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (a.splits > 1 && (e = launch_sum_parts<float>(a, D)) != cudaSuccess)
    return e;
  auto qk = fa2_bwd_fma_dq<D>;
  if ((e = allow_smem(qk, TL::smem_q)) != cudaSuccess) return e;
  dim3 grid_q((a.Sq + TL::BQ - 1) / TL::BQ, a.B * a.Hq);
  qk<<<grid_q, kFmaThreads, TL::smem_q, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dO), a.lse,
      a.delta, static_cast<float*>(a.dq), a.Hq, a.Hkv, a.Sq, a.Sk, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Args& a) {
  using TL = MmaTile<D>;
  cudaError_t e = launch_delta<bf16>(a, D);
  if (e != cudaSuccess) return e;
  const float scale_log2 = a.scale * kLog2e;
  auto kv = fa2_bwd_mma_dkdv<D>;
  if ((e = allow_smem(kv, TL::smem_kv)) != cudaSuccess) return e;
  dim3 grid_kv((a.Sk + TL::BKV - 1) / TL::BKV, a.B * a.Hkv, a.splits);
  kv<<<grid_kv, TL::kKvThreads, TL::smem_kv, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dO), a.lse,
      a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.part,
      a.Hq, a.Hkv, a.Sq, a.Sk, a.causal, a.window, a.scale, scale_log2,
      a.splits);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (a.splits > 1 && (e = launch_sum_parts<bf16>(a, D)) != cudaSuccess)
    return e;
  auto qk = fa2_bwd_mma_dq<D>;
  if ((e = allow_smem(qk, TL::smem_q)) != cudaSuccess) return e;
  const int n_qt = (a.Sq + TL::BM - 1) / TL::BM;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  dim3 grid_q(a.B * a.Hq, n_qt);
  qk<<<grid_q, TL::kQThreads, TL::smem_q, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dO), a.lse,
      a.delta, static_cast<bf16*>(a.dq), a.Hq, a.Hkv, a.Sq, a.Sk, a.causal,
      a.window, a.scale, scale_log2);
  return cudaGetLastError();
}

cudaError_t launch_f32(int d, const Args& a) {
  switch (d) {
    case 16: return launch_fma<16>(a);
    case 32: return launch_fma<32>(a);
    case 64: return launch_fma<64>(a);
    case 80: return launch_fma<80>(a);
    case 128: return launch_fma<128>(a);
    case 256: return launch_fma<256>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bf16(int d, const Args& a) {
  // 16-byte cp.async rows need 16-byte aligned bases
  if (((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.o |
       (uintptr_t)a.dO | (uintptr_t)a.dq | (uintptr_t)a.dk |
       (uintptr_t)a.dv) % 16 != 0)
    return cudaErrorMisalignedAddress;
  switch (d) {
    case 16: return launch_mma<16>(a);
    case 32: return launch_mma<32>(a);
    case 64: return launch_mma<64>(a);
    case 80: return launch_mma<80>(a);
    case 128: return launch_mma<128>(a);
    case 256: return launch_mma<256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, dq: (B, Hq, Sq, d); k, v, dk, dv:
// (B, Hkv, Sk, d); o, dO: q's shape and dtype; lse: float32 (B, Hq, Sq);
// delta: float32 scratch of (B, Hq, Sq); part: float32 scratch of
// (splits, 2, B, Hkv, Sk, d), unused (may be null) when splits == 1.
// Returns a cudaError_t code (0 = ok).
extern "C" int flash_attention_bwd_launch(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dO, const float* lse, float* delta, float* part, void* dq,
    void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk, int d,
    int causal, int window, int splits, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      (long long)B * Hq > 65535 || splits < 1 || splits > Hq / Hkv ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,      o,      dO,     lse,   delta,
               part, dq, dk, dv,     B,      Hq,     Hkv,   Sq,
               Sk,   causal, window, splits, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_f32(d, a);
  if (dtype == 1) return (int)launch_bf16(d, a);
  return (int)cudaErrorInvalidValue;
}

// Keys a dK/dV block (the grid's x extent is ceil(Sk / it)) by dtype, the
// same at every head dim; 0 for an unknown dtype. The wrapper sizes its
// GQA group splits by it.
extern "C" int flash_attention_bwd_key_block(int dtype) {
  if (dtype == 0) return FmaTile<128>::BK;
  if (dtype == 1) return MmaTile<128>::BKV;
  return 0;
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
