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
// ms for its 63 MB of inputs and outputs. The two kernels below recompute
// S and dP in the dQ pass (seven products, not five: 0.18 ms at that rate),
// the price of a fixed order of summation without atomics.
//
// Routes, by (dtype, head dim); ``flash_attention_bwd_route`` names them:
//   * bfloat16, d 64 and 128: TMA + wgmma (Hopper), WgTile below;
//   * bfloat16, d 256: TMA + wgmma, PartTile below (two warpgroups split
//     dV and dK of the same keys);
//   * bfloat16, d 16, 32 and 80: mma.sync (the first kernels);
//   * float32, d 64 and 128: TMA + wgmma on 3xBF16, PartTile below: each
//     float32 operand as two bf16 parts, each product as three bf16 ones;
//   * float32, d 16, 32, 80 and 256: FMA (the first kernels).
// The launcher's `kernel` argument runs the first version (mma.sync at d
// 256, FMA at any float32 head dim) in place of the route, to time one
// against the other. Every route sums in a fixed order: no atomics, so two
// calls give the same bits. The FMA and mma.sync routes run three kernels a
// call (D, dK/dV, dQ), the wgmma routes two (D, or in float32 D with the
// operands' bf16 parts; then the dK/dV and dQ blocks in one launch); one
// more when the GQA group is split.
//   * D: one warp a row, lanes over the head dim (16-byte loads in bf16),
//     a butterfly of shuffles.
//   * dK/dV: one block per (b, kv head, key block), and per part of the
//     GQA group when there are too few such blocks to fill the card
//     (recurrentgemma-2b: one kv head, 32 key blocks a row). The block keeps
//     its keys' K and V in shared memory and loops over its group's q heads
//     and over the query tiles that the causal window lets see its keys,
//     recomputing P from L, with dK and dV in registers. A split group
//     writes float32 partials that a fourth kernel adds in split order.
//   * dQ: one block per (b, q head, query rows), looping over the key tiles
//     its rows see, dQ in registers, the last row tile first.
// The two loops share no sum, so the wgmma route launches their blocks as
// one grid, the dK/dV blocks first: the dQ blocks fill the SMs that the
// dK/dV blocks' causal tail leaves idle.
//
// TMA + wgmma (bf16, d 64 and 128). Each block is three warpgroups: two
// consumers and a producer whose first warp issues TMA loads into a ring
// of three stages in shared memory, each completing on an mbarrier that
// carries its byte count (the producer drops to 24 registers, the
// consumers rise to 240). Tensors are read through 3-D maps (d, S, B H)
// with 128-byte swizzle, so a tile never reaches into the next head's rows
// and rows past S arrive as zeros (ragged Sq and Sk need no special case;
// the masks zero P there). Against the mma.sync kernels' limits:
//   * a warp's 16 keys read the whole Q and dO tiles from shared memory
//     four times a step (8 multiply-adds a byte): here a warpgroup's 64 keys
//     run wgmma m64n64k16 for S^T = K Q^T and dP^T = V dO^T (both operands
//     in shared memory) and m64nDk16 for dV += P^T dO and dK += dS^T Q with
//     P^T and dS^T from registers (the accumulator's layout is the A
//     fragment's) and dO and Q read MN-major through the transpose bit;
//   * 32-row query steps at d 128 (a warp's dK and dV took 128 registers a
//     thread): a step is 64 rows, dK and dV of 64 keys x d are 128
//     registers a consumer thread at d 128;
//   * low occupancy, the compute warps issuing the loads, and a causal
//     tail: the producer warp alone loads, three stages deep; blocks are
//     ordered so that under a causal mask those that see the most tiles
//     start first (key block 0, the last row tile), and the dQ blocks
//     follow the dK/dV blocks in the same launch.
// dK/dV: 128 keys a block (64 a consumer), (Q, dO, L log2 e, D) a stage for
// 64 query rows of one q head; dQ: 128 rows a block (64 a consumer),
// (K, V) a stage for 64 keys, S = Q K^T and dP = dO V^T as m64n64k16 and
// dQ += dS K with K read MN-major. P and dS are rounded to bf16 in
// registers before their products, as in the mma.sync kernels. The
// consumers' CUDA-core work between the products is kept short: P's
// exponent is one ex2.approx.ftz, and only the tiles that a mask edge
// (causal, window, Sq, Sk) crosses test each element.
//
// mma.sync (bf16 d 16, 32 and 80, and 256 on request): tensor cores
// through mma.sync m16n8k16 (bf16 in, f32 accumulate), with the forward's
// fragment tricks: an accumulator tile of m16n8 has the A fragment's
// layout, so P^T and dS^T (dK/dV) and dS (dQ) feed the next product from
// registers; P and dS are rounded to bf16 before their products, as the
// forward rounds P before P V. In dK/dV (64 keys a block) a warp owns 16
// keys and computes S^T = K Q^T and dP^T = V dO^T with keys as rows; Q and
// dO tiles (with L and D) stream through a two-stage cp.async ring. At d
// 256 one warp's dK and dV accumulators alone would be 256 f32 registers a
// thread, so eight warps split the work: warps 0-3 compute P^T and dV,
// warps 4-7 P^T again, dP^T, dS^T and dK, each for the same 16 keys (P^T
// is recomputed rather than passed through shared memory). dQ keeps the
// forward's shape: four warps of 16 rows, K and V tiles (64 rows, 32 at d
// 256) in a two-stage ring.
//
// FMA (float32 at d 16, 32, 80 and 256, and at 64 and 128 on request):
// tiles in shared memory as f32 (rows padded by one float), each of 128
// threads owning a (2 x 4) patch of the score tile and a (2 x d/8) patch of
// the accumulators; 32 keys a dK/dV block, 32 rows a dQ block.
//
// TMA + wgmma on bf16 parts (bf16 d 256, float32 d 64 and 128; PartTile):
// WgTile's producer warp, ring and consumer warpgroups, with (a) the
// operands as NP bf16 parts: float32 x = hi + lo, hi = bf16(x), lo =
// bf16(x - hi), written by a first kernel with D for q, k, v and dO (and
// split in registers for P and dS), and each product summed as lo hi + hi
// lo + hi hi in float32 (3xBF16: within 2^-16 of the float32 product, and
// the transpose bit reads Q, dO and K MN-major as in bf16; tf32's wgmma
// reads only K-major operands); (b) at 256 bf16 columns a row (bf16 d 256,
// float32 d 128) the dK/dV block's two consumer warpgroups on the same 64
// keys, warpgroup 0 computing S^T, P^T and dV, warpgroup 1 dP^T, dS^T and
// dK with P^T handed across through shared memory (dK and dV of 64 keys x
// 256 would be 256 accumulator registers a thread), two (Q, dO) stages of
// 64 rows beside K and V; dQ blocks of 64 rows whose two warpgroups take
// alternate 64-key steps, K and V in rings of their own. The bound at the
// arithmetic it runs, for float32: three bf16 products a float32 one at
// bf16's rate.
//
// Every device kernel's name starts with fa2_bwd_ (a profile sums them by
// that). Head dims 16, 32, 64, 80, 128 and 256, one instantiation each.
// Ragged Sq and Sk are masked in the kernels; tiles that no row sees are
// never loaded.

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention.cuh"   // the mask and tile ranges, mma.sync and wgmma
                            // products, TMA tiles (hopper.cuh beneath)

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

// ---------------------------------------------------------------------------
// D = rowsum(dO * O), float32: one warp a row
// ---------------------------------------------------------------------------

// sum of a[i] b[i] over V consecutive elements, in order (V = 8: one
// 16-byte load of bfloat16 each)
template <int V, typename T>
__device__ __forceinline__ float dot_run(const T* a, const T* b) {
  if constexpr (V == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(a);
    const uint4 y = *reinterpret_cast<const uint4*>(b);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
    const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s += __uint_as_float(xs[i] << 16) * __uint_as_float(ys[i] << 16);
      s += __uint_as_float(xs[i] & 0xffff0000u) *
           __uint_as_float(ys[i] & 0xffff0000u);
    }
    return s;
  } else {
    return to_f32(*a) * to_f32(*b);
  }
}

// V elements a load: 8 in bfloat16 (rows are 16-byte aligned: d is a
// multiple of 8 and the bases are checked), 1 in float32
template <typename T, int V>
__global__ void __launch_bounds__(256) fa2_bwd_delta(
    const T* __restrict__ o, const T* __restrict__ dO,
    float* __restrict__ delta, long long rows, int d) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;   // the whole warp leaves together
  const T* a = o + row * d;
  const T* b = dO + row * d;
  float s = 0.f;
  for (int c = lane * V; c < d; c += 32 * V) s += dot_run<V>(a + c, b + c);
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
// bfloat16 at d 64 and 128: TMA ring + wgmma (Hopper)
// ---------------------------------------------------------------------------

// 128-byte-swizzled tiles: a (R, D) bf16 tile is D / 64 column chunks of R
// rows of 128 bytes, chunk c at c R 128 bytes; TMA writes and wgmma reads
// it through the same swizzle (chunks 1024-byte aligned)
template <int D>
struct WgTile {
  static constexpr int kThreads = 384;   // consumer warpgroups 0-1, producer 2
  static constexpr int kStages = 3;
  static constexpr int BKV = 128;        // keys a dK/dV block, 64 a warpgroup
  static constexpr int BQ = 64;          // queries a dK/dV step
  static constexpr int BM = 128;         // rows a dQ block, 64 a warpgroup
  static constexpr int BKQ = 64;         // keys a dQ step
  static constexpr int kQTile = BQ * D * 2;     // bytes of a (64, D) tile
  static constexpr int kBigTile = 128 * D * 2;  // bytes of a (128, D) tile
  // dK/dV: K, V; stages of Q, dO; stages of L log2 e and D; barriers
  static constexpr int kKvLd = 2 * kBigTile + 2 * kStages * kQTile;
  static constexpr int kKvBars = kKvLd + 2 * kStages * BQ * 4;
  static constexpr size_t smem_kv = 1024 + kKvBars + (2 * kStages + 1) * 8;
  // dQ: Q, dO; stages of K, V; barriers
  static constexpr int kQBars = 2 * kBigTile + 2 * kStages * kQTile;
  static constexpr size_t smem_q = 1024 + kQBars + (2 * kStages + 1) * 8;
};

// The head dims of WgTile's kernels in bfloat16 (at d 256 a warpgroup's
// dK and dV of 64 keys would need 256 accumulator registers a thread: the
// PartTile kernels below split them; d 16, 32 and 80 rows are not whole
// 128-byte swizzle chunks and keep mma.sync)
__host__ __device__ constexpr bool wgmma_head_dim(int d) {
  return d == 64 || d == 128;
}

// dK and dV of block (col, kb): column col = (b Hkv + kv head) splits +
// split of the GQA group, 128 keys from kb 128. Warpgroups 0 and 1 each own
// 64 keys; warpgroup 2's first warp streams (Q, dO, L log2 e, D) for each
// (q head, query tile) step through the stage ring. n_bkv = B Hkv.
template <int D>
__device__ __forceinline__ void dkdv_block(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, const CUtensorMap& map_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
    int Hq, int Hkv, int Sq, int Sk, int causal, int window, float scale,
    float scale_log2, int splits, int col, int kb, int n_bkv) {
  using TL = WgTile<D>;
  constexpr int BKV = TL::BKV, BQ = TL::BQ, S = TL::kStages;
  extern __shared__ __align__(1024) unsigned char wsm[];
  const uint32_t raw = smem_u32(wsm);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = wsm + (base - raw);
  const uint32_t k_tile = base, v_tile = base + TL::kBigTile;
  auto q_tile = [&](int s) { return base + 2 * TL::kBigTile + s * TL::kQTile; };
  auto do_tile = [&](int s) { return q_tile(S + s); };
  float* l2s = reinterpret_cast<float*>(gbase + TL::kKvLd);   // S x BQ
  float* ds = l2s + S * BQ;                                     // S x BQ
  const uint32_t bars = base + TL::kKvBars;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  const uint32_t kv_bar = bars + 8 * 2 * S;

  const int split = col % splits;
  const int bkv = col / splits;                   // b * Hkv + kv head
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int k_lo = kb * BKV;
  const int g = Hq / Hkv;
  const int h_begin = hk * g + split * g / splits;
  const int n_h = hk * g + (split + 1) * g / splits - h_begin;
  const int off = Sk - Sq;
  int qt_begin, n_qt;
  query_tiles(k_lo, min(k_lo + BKV, Sk) - 1, Sq, off, causal, window, BQ,
              &qt_begin, &n_qt);
  const int n_it = n_qt * n_h;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);     // the producer warp's lanes
      mbar_init(empty(s), 8);     // each consumer warp
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x / 32 == 8) {
      const int lane = threadIdx.x % 32;
      if (n_it > 0 && lane == 0) {
        mbar_expect_tx(kv_bar, 2 * TL::kBigTile);
        tma_tile<D, BKV>(k_tile, &map_k, kv_bar, k_lo, bkv);
        tma_tile<D, BKV>(v_tile, &map_v, kv_bar, k_lo, bkv);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(empty(s), (it / S - 1) & 1);
        const int bh = b * Hq + h_begin + it / n_qt;
        const int q_lo = (qt_begin + it % n_qt) * BQ;
        const size_t q_base = (size_t)bh * Sq;
        for (int r = lane; r < BQ; r += 32) {
          const int qr = q_lo + r;
          l2s[s * BQ + r] = qr < Sq ? lse[q_base + qr] * kLog2e : pos_inf();
          ds[s * BQ + r] = qr < Sq ? delta[q_base + qr] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * TL::kQTile);
          tma_tile<D, BQ>(q_tile(s), &map_q, full(s), q_lo, bh);
          tma_tile<D, BQ>(do_tile(s), &map_do, full(s), q_lo, bh);
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
    const int kw = k_lo + 64 * wg;                 // this warpgroup's keys
    const int kr0 = kw + 16 * w + lane / 4;        // + 8 h: this thread's
    float acc_v[D / 2], acc_k[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_v[i] = acc_k[i] = 0.f;
    if (n_it > 0) mbar_wait(kv_bar, 0);

    for (int it = 0; it < n_it; ++it) {
      const int s = it % S;
      mbar_wait(full(s), (it / S) & 1);
      const int q_lo = (qt_begin + it % n_qt) * BQ;
      // none of the tile's rows sees this warpgroup's keys
      const bool idle = kw >= Sk || (causal && kw > q_lo + BQ - 1 + off) ||
                        (window > 0 && kw + 63 <= q_lo + off - window);
      if (!idle) {
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, two groups
        float st[32], dpt[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(st, kmajor_desc<BKV>(k_tile, 64 * wg, kk),
                       kmajor_desc<BQ>(q_tile(s), 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dpt, kmajor_desc<BKV>(v_tile, 64 * wg, kk),
                       kmajor_desc<BQ>(do_tile(s), 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(st);

        // P^T = exp2(S^T scale log2 e - L log2 e), 0 where not seen; this
        // thread's query columns come in pairs: 8 j + 2 (lane % 4) + {0, 1}
        const float2* l2 =
            reinterpret_cast<const float2*>(l2s + s * BQ) + lane % 4;
        const float2* dd =
            reinterpret_cast<const float2*>(ds + s * BQ) + lane % 4;
        const bool edge = kw + 64 > Sk || q_lo + BQ > Sq ||
                          (causal && kw + 63 > q_lo + off) ||
                          (window > 0 && kw <= q_lo + BQ - 1 + off - window);
        if (edge) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l = l2[4 * j];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qr = q_lo + 8 * j + 2 * (lane % 4) + (e % 2);
              const float p =
                  exp2_ftz(st[4 * j + e] * scale_log2 - (e % 2 ? l.y : l.x));
              st[4 * j + e] = visible(kr0 + 8 * (e / 2), qr, Sq, Sk, off,
                                      causal, window) ? p : 0.f;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l = l2[4 * j];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              st[4 * j + e] =
                  exp2_ftz(st[4 * j + e] * scale_log2 - (e % 2 ? l.y : l.x));
          }
        }
        wgmma_wait<0>();
        fence_regs(dpt);
        // dS^T = P^T (dP^T - D)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 dj = dd[4 * j];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * j + e] =
                st[4 * j + e] * (dpt[4 * j + e] - (e % 2 ? dj.y : dj.x));
        }
        uint32_t pa[4][4], dsa[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          wg_acc_to_a(pa[ks], st, ks);
          wg_acc_to_a(dsa[ks], dpt, ks);
        }

        // dV += P^T dO and dK += dS^T Q: A from registers (bf16), B the
        // tiles read MN-major
        fence_regs(acc_v);
        fence_regs(acc_k);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_rs<D>(acc_v, pa[ks], mnmajor_desc<BQ>(do_tile(s), ks));
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_rs<D>(acc_k, dsa[ks], mnmajor_desc<BQ>(q_tile(s), ks));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_v);
        fence_regs(acc_k);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));   // this warp is done with s
    }

    const size_t kv_base = (size_t)bkv * Sk * D;
    const size_t n = (size_t)n_bkv * Sk * D;      // B Hkv Sk D
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kc = kr0 + 8 * i;
      if (kc >= Sk) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const size_t at = kv_base + (size_t)kc * D + 8 * j + 2 * (lane % 4);
        const float v0 = acc_v[4 * j + 2 * i], v1 = acc_v[4 * j + 2 * i + 1];
        const float k0 = acc_k[4 * j + 2 * i] * scale;
        const float k1 = acc_k[4 * j + 2 * i + 1] * scale;
        if (splits == 1) {
          *reinterpret_cast<__nv_bfloat162*>(dv + at) =
              __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(dk + at) =
              __floats2bfloat162_rn(k0, k1);
        } else {
          *reinterpret_cast<float2*>(part + (2 * split + 1) * n + at) =
              make_float2(v0, v1);
          *reinterpret_cast<float2*>(part + 2 * split * n + at) =
              make_float2(k0, k1);
        }
      }
    }
  }
}

// dQ of block (bh, qt): b Hq + q head, 128 rows from qt 128; warpgroups 0
// and 1 each own 64 rows, warpgroup 2's first warp streams (K, V) tiles of
// 64 keys through the stage ring.
template <int D>
__device__ __forceinline__ void dq_block(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, const CUtensorMap& map_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk, int causal,
    int window, float scale, float scale_log2, int bh, int qt) {
  using TL = WgTile<D>;
  constexpr int BM = TL::BM, BKQ = TL::BKQ, S = TL::kStages;
  extern __shared__ __align__(1024) unsigned char wsm[];
  const uint32_t base = (smem_u32(wsm) + 1023) & ~1023u;
  const uint32_t q_tile = base, do_tile = base + TL::kBigTile;
  auto k_tile = [&](int s) { return base + 2 * TL::kBigTile + s * TL::kQTile; };
  auto v_tile = [&](int s) { return k_tile(S + s); };
  const uint32_t bars = base + TL::kQBars;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  const uint32_t q_bar = bars + 8 * 2 * S;

  const int b = bh / Hq, h = bh % Hq, bkv = b * Hkv + h / (Hq / Hkv);
  const int q_lo = qt * BM;
  const int off = Sk - Sq;
  int kt_begin, kt_end;
  key_tiles(q_lo, min(q_lo + BM, Sq) - 1, Sk, off, causal, window, BKQ,
            &kt_begin, &kt_end);
  const int n_it = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);     // each consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256 && n_it > 0) {
      mbar_expect_tx(q_bar, 2 * TL::kBigTile);
      tma_tile<D, BM>(q_tile, &map_q, q_bar, q_lo, bh);
      tma_tile<D, BM>(do_tile, &map_do, q_bar, q_lo, bh);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(empty(s), (it / S - 1) & 1);
        const int kv_lo = (kt_begin + it) * BKQ;
        mbar_expect_tx(full(s), 2 * TL::kQTile);
        tma_tile<D, BKQ>(k_tile(s), &map_k, full(s), kv_lo, bkv);
        tma_tile<D, BKQ>(v_tile(s), &map_v, full(s), kv_lo, bkv);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
    const int rw = q_lo + 64 * wg;                 // this warpgroup's rows
    const int r0 = rw + 16 * w + lane / 4;         // + 8 h: this thread's
    const size_t q_base = (size_t)bh * Sq;
    float l2[2], dd[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      l2[i] = r < Sq ? lse[q_base + r] * kLog2e : pos_inf();
      dd[i] = r < Sq ? delta[q_base + r] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    if (n_it > 0) mbar_wait(q_bar, 0);

    for (int it = 0; it < n_it; ++it) {
      const int s = it % S;
      mbar_wait(full(s), (it / S) & 1);
      const int kv_lo = (kt_begin + it) * BKQ;
      // none of this warpgroup's rows sees the tile's keys
      const bool idle = rw >= Sq || (causal && kv_lo > rw + 63 + off) ||
                        (window > 0 && kv_lo + BKQ - 1 <= rw + off - window);
      if (!idle) {
        // S = Q K^T and dP = dO V^T: 64 rows x 64 keys, two groups
        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(sc, kmajor_desc<BM>(q_tile, 64 * wg, kk),
                       kmajor_desc<BKQ>(k_tile(s), 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dp, kmajor_desc<BM>(do_tile, 64 * wg, kk),
                       kmajor_desc<BKQ>(v_tile(s), 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);

        // P; element 4 j + 2 h + e: row r0 + 8 h, key kv_lo + 8 j +
        // 2 (lane % 4) + e
        if (edge_tile(rw, 64, kv_lo, BKQ, Sk, off, causal, window)) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p =
                  exp2_ftz(sc[4 * j + e] * scale_log2 - l2[e / 2]);
              sc[4 * j + e] =
                  visible(kv_lo + 8 * j + 2 * (lane % 4) + (e % 2),
                          r0 + 8 * (e / 2), Sq, Sk, off, causal, window)
                      ? p
                      : 0.f;
            }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[4 * j + e] =
                  exp2_ftz(sc[4 * j + e] * scale_log2 - l2[e / 2]);
        }
        wgmma_wait<0>();
        fence_regs(dp);
        // dS = P (dP - D)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dd[e / 2]);
        uint32_t dsa[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wg_acc_to_a(dsa[ks], sc, ks);

        // dQ += dS K: A from registers (bf16), K read MN-major
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_rs<D>(acc, dsa[ks], mnmajor_desc<BKQ>(k_tile(s), ks));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));   // this warp is done with s
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= Sq) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dq + (q_base + r) * D + 8 * j +
                                           2 * (lane % 4)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale,
                                  acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// dK/dV and dQ in one launch of n_kv + q_cols n_qt blocks: the dK/dV
// blocks first, key block 0 first (under a causal mask the blocks that see
// the most query tiles), then the dQ blocks, the last row tile first; the
// dQ blocks take the SMs that the dK/dV blocks' tail leaves. kv_cols =
// B Hkv splits, n_kv = kv_cols x key blocks, q_cols = B Hq.
template <int D>
__global__ void __launch_bounds__(WgTile<D>::kThreads, 1) fa2_bwd_wgmma(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq,
    bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
    int Hq, int Hkv, int Sq, int Sk, int causal, int window, float scale,
    float scale_log2, int splits, int kv_cols, int n_kv, int q_cols,
    int n_qt) {
  const int blk = blockIdx.x;
  if (blk < n_kv) {
    dkdv_block<D>(map_q, map_k, map_v, map_do, lse, delta, dk, dv, part, Hq,
                  Hkv, Sq, Sk, causal, window, scale, scale_log2, splits,
                  blk % kv_cols, blk / kv_cols, kv_cols / splits);
  } else {
    const int r = blk - n_kv;
    dq_block<D>(map_q, map_k, map_v, map_do, lse, delta, dq, Hq, Hkv, Sq, Sk,
                causal, window, scale, scale_log2, r % q_cols,
                n_qt - 1 - r / q_cols);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at d 256 and float32 at d 64 and 128: TMA ring + wgmma on bf16
// parts
// ---------------------------------------------------------------------------

// The operands as NP bf16 parts (PartLayout, attention.cuh): NP = 1 is
// bfloat16 itself, NP = 2 float32 as [hi | lo] rows (fa2_bwd_prep_f32
// writes q, k, v and dO so; P and dS are split in registers), each product
// three bf16 ones.
//
// Tiles: W / 64 swizzled chunks of R rows x 128 bytes, as WgTile's
// (tma_tile's boxes of 64 rows). At W = 256 (bf16 d 256, float32 d 128) a
// warpgroup's dK and dV of 64 keys would be 256 accumulator registers a
// thread, so the two consumer warpgroups split them (kWide): both take
// the same 64 keys, warpgroup 0 computing S^T, P^T and dV += P^T dO,
// warpgroup 1 dP^T, then dS^T and dK += dS^T Q with P^T handed across in
// float32 through two 16 KB buffers in shared memory under named barriers
// (two products each a step; recomputing S^T in warpgroup 1 instead makes
// five a step); K and V take 64 KB, a (Q, dO) stage of 64 rows 64 KB, so
// two stages. Its dQ blocks take 64 rows (Q and dO: 64 KB); warpgroup w
// takes key steps w, w + 2, ... of 64 keys into its own dQ accumulator,
// and the two are added in that order at the end (kWide; 128-row blocks
// would leave room only for 32-key steps, whose S and dP read Q and dO
// from shared memory twice as often a product). K and V come through rings
// of their own, three K tiles and two V tiles (V is released after dP, K
// only after dQ += dS K), so the next step's tiles load while a warpgroup
// computes. At W = 128 (float32 d 64) the tiles are WgTile<128>'s: 128
// keys a dK/dV block, each warpgroup both dK and dV of its 64; 128 rows a
// dQ block, 64 each.
template <int D, int NP>
struct PartTile : PartLayout<D, NP> {
  static constexpr int W = PartLayout<D, NP>::W;   // bf16 columns a row
  // the two consumer warpgroups share a block's 64 keys (dK/dV: dV in
  // one, dK in the other) and its 64 rows (dQ: alternate key steps)
  static constexpr bool kWide = W == 256;
  static constexpr int kThreads = 384;   // consumers: warpgroups 0-1
  static constexpr int BKV = kWide ? 64 : 128;    // keys a dK/dV block
  static constexpr int BQ = 64;             // queries a dK/dV step
  static constexpr int kKvStages = kWide ? 2 : 3;
  static constexpr int BM = kWide ? 64 : 128;     // rows a dQ block
  static constexpr int BKQ = 64;                  // keys a dQ step
  static constexpr int kKStages = kWide ? 3 : 4;  // K tiles in flight
  static constexpr int kVStages = kWide ? 2 : 4;  // V tiles
  static constexpr int kKvTile = BKV * W * 2;     // bytes of K or V
  static constexpr int kQTile = BQ * W * 2;       // of Q or dO, a step
  static constexpr int kKvLd = 2 * kKvTile + 2 * kKvStages * kQTile;
  static constexpr int kPBuf = kKvLd + 2 * kKvStages * BQ * 4;
  // with kWide two buffers of a 64 x 64 float32 P^T tile
  static constexpr int kKvBars = kPBuf + (kWide ? 2 * 64 * 64 * 4 : 0);
  static constexpr size_t smem_kv = 1024 + kKvBars + (2 * kKvStages + 1) * 8;
  static constexpr int kMTile = BM * W * 2;       // of Q or dO, a dQ block
  static constexpr int kKTile = BKQ * W * 2;      // of K or V, a dQ step
  static constexpr int kQBars = 2 * kMTile + (kKStages + kVStages) * kKTile;
  static constexpr size_t smem_q =
      1024 + kQBars + (2 * (kKStages + kVStages) + 1) * 8;
  static constexpr size_t smem = smem_kv > smem_q ? smem_kv : smem_q;
  static_assert(smem <= 232448, "PartTile: over 227 KB of shared memory");
};

// dK and dV of block (col, kb), as dkdv_block's: column col = (b Hkv + kv
// head) splits + split of the GQA group, BKV keys from kb BKV; T the
// outputs' type (bf16, or float for NP = 2).
template <int D, int NP, typename T>
__device__ __forceinline__ void dkdv_parts(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, const CUtensorMap& map_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part, int Hq,
    int Hkv, int Sq, int Sk, int causal, int window, float scale,
    float scale_log2, int splits, int col, int kb, int n_bkv) {
  using TL = PartTile<D, NP>;
  constexpr int BKV = TL::BKV, BQ = TL::BQ, S = TL::kKvStages, W = TL::W;
  constexpr bool kWide = TL::kWide;
  constexpr int NACC = kWide ? 1 : 2;    // dV in acc[0], dK in acc[NACC - 1]
  extern __shared__ __align__(1024) unsigned char wsm[];
  const uint32_t raw = smem_u32(wsm);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = wsm + (base - raw);
  const uint32_t k_tile = base, v_tile = base + TL::kKvTile;
  auto q_tile = [&](int s) { return base + 2 * TL::kKvTile + s * TL::kQTile; };
  auto do_tile = [&](int s) { return q_tile(S + s); };
  float* l2s = reinterpret_cast<float*>(gbase + TL::kKvLd);   // S x BQ
  float* ds = l2s + S * BQ;                                     // S x BQ
  float* pbuf = reinterpret_cast<float*>(gbase + TL::kPBuf);  // 2 x 64 x 64
  const uint32_t bars = base + TL::kKvBars;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  const uint32_t kv_bar = bars + 8 * 2 * S;

  const int split = col % splits;
  const int bkv = col / splits;                   // b * Hkv + kv head
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int k_lo = kb * BKV;
  const int g = Hq / Hkv;
  const int h_begin = hk * g + split * g / splits;
  const int n_h = hk * g + (split + 1) * g / splits - h_begin;
  const int off = Sk - Sq;
  int qt_begin, n_qt;
  query_tiles(k_lo, min(k_lo + BKV, Sk) - 1, Sq, off, causal, window, BQ,
              &qt_begin, &n_qt);
  const int n_it = n_qt * n_h;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);     // the producer warp's lanes
      mbar_init(empty(s), 8);     // each consumer warp
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x / 32 == 8) {
      const int lane = threadIdx.x % 32;
      if (n_it > 0 && lane == 0) {
        mbar_expect_tx(kv_bar, 2 * TL::kKvTile);
        tma_tile<W, BKV>(k_tile, &map_k, kv_bar, k_lo, bkv);
        tma_tile<W, BKV>(v_tile, &map_v, kv_bar, k_lo, bkv);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(empty(s), (it / S - 1) & 1);
        const int bh = b * Hq + h_begin + it / n_qt;
        const int q_lo = (qt_begin + it % n_qt) * BQ;
        const size_t q_base = (size_t)bh * Sq;
        for (int r = lane; r < BQ; r += 32) {
          const int qr = q_lo + r;
          l2s[s * BQ + r] = qr < Sq ? lse[q_base + qr] * kLog2e : pos_inf();
          ds[s * BQ + r] = qr < Sq ? delta[q_base + qr] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * TL::kQTile);
          tma_tile<W, BQ>(q_tile(s), &map_q, full(s), q_lo, bh);
          tma_tile<W, BQ>(do_tile(s), &map_do, full(s), q_lo, bh);
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
    // warpgroup-uniform roles: with kWide both warpgroups take the same 64
    // keys, 0 computing S^T, P^T and dV, 1 dP^T, dS^T and dK with P^T
    // handed across; else each its own 64 keys, all of it
    const int kr = kWide ? 0 : 64 * wg;           // its keys in the tile
    const bool do_dv = !kWide || wg == 0;
    const bool do_dk = !kWide || wg == 1;
    const int kw = k_lo + kr;                      // this warpgroup's keys
    const int kr0 = kw + 16 * w + lane / 4;        // + 8 h: this thread's
    float acc[NACC][D / 2];
#pragma unroll
    for (int a = 0; a < NACC; ++a)
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[a][i] = 0.f;
    if (n_it > 0) mbar_wait(kv_bar, 0);
    // part i's chunks of the (K, V) and (Q, dO) tiles
    auto kpart = [](uint32_t tile, int i) {
      return tile + TL::template part<BKV>(i);
    };
    auto qpart = [](uint32_t tile, int i) {
      return tile + TL::template part<BQ>(i);
    };
    int handed = 0;   // P^T tiles handed across (kWide), alternate buffers

    for (int it = 0; it < n_it; ++it) {
      const int s = it % S;
      mbar_wait(full(s), (it / S) & 1);
      const int q_lo = (qt_begin + it % n_qt) * BQ;
      // none of the tile's rows sees this warpgroup's keys
      const bool idle = kw >= Sk || (causal && kw > q_lo + BQ - 1 + off) ||
                        (window > 0 && kw + 63 <= q_lo + off - window);
      if (!idle) {
        // S^T = K Q^T (dV's warpgroup) and dP^T = V dO^T (dK's): 64 keys x
        // 64 queries, over the parts
        float st[32], dpt[32];
        wgmma_fence();
        if (do_dv) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
            for (int p = 0; p < TL::kPairs; ++p)
              wgmma_ss_n64(st, kmajor_desc<BKV>(kpart(k_tile, TL::part_a(p)),
                                                kr, kk),
                           kmajor_desc<BQ>(qpart(q_tile(s), TL::part_b(p)), 0,
                                           kk),
                           kk > 0 || p > 0);
          wgmma_commit();
        }
        if (do_dk) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
            for (int p = 0; p < TL::kPairs; ++p)
              wgmma_ss_n64(dpt, kmajor_desc<BKV>(kpart(v_tile, TL::part_a(p)),
                                                 kr, kk),
                           kmajor_desc<BQ>(qpart(do_tile(s), TL::part_b(p)), 0,
                                           kk),
                           kk > 0 || p > 0);
          wgmma_commit();
        }
        const float2* dd =
            reinterpret_cast<const float2*>(ds + s * BQ) + lane % 4;
        if (do_dv) {
          if (do_dk)
            wgmma_wait<1>();
          else
            wgmma_wait<0>();
          fence_regs(st);
          // P^T = exp2(S^T scale log2 e - L log2 e), 0 where not seen; this
          // thread's query columns: 8 j + 2 (lane % 4) + {0, 1}
          const float2* l2 =
              reinterpret_cast<const float2*>(l2s + s * BQ) + lane % 4;
          const bool edge = kw + 64 > Sk || q_lo + BQ > Sq ||
                            (causal && kw + 63 > q_lo + off) ||
                            (window > 0 && kw <= q_lo + BQ - 1 + off - window);
          if (edge) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 l = l2[4 * j];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qr = q_lo + 8 * j + 2 * (lane % 4) + (e % 2);
                const float p = exp2_ftz(st[4 * j + e] * scale_log2 -
                                         (e % 2 ? l.y : l.x));
                st[4 * j + e] = visible(kr0 + 8 * (e / 2), qr, Sq, Sk, off,
                                        causal, window) ? p : 0.f;
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 l = l2[4 * j];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                st[4 * j + e] = exp2_ftz(st[4 * j + e] * scale_log2 -
                                         (e % 2 ? l.y : l.x));
            }
          }
        }
        if constexpr (kWide) {
          // P^T from warpgroup 0 to 1 through buffer buf (its layout the
          // accumulators': thread t's 32 at [i 128 + t]): named barriers
          // 1 + buf (full: 0 arrives, 1 waits) and 3 + buf (empty: 1
          // arrives, 0 waits before reusing it)
          const int buf = handed & 1;
          float* pb = pbuf + buf * 32 * 128;
          if (wg == 0) {
            if (handed >= 2) named_sync(3 + buf, 256);
#pragma unroll
            for (int i = 0; i < 32; ++i) pb[i * 128 + tid] = st[i];
            named_arrive(1 + buf, 256);
          } else {
            wgmma_wait<0>();
            fence_regs(dpt);
            named_sync(1 + buf, 256);
#pragma unroll
            for (int i = 0; i < 32; ++i) st[i] = pb[i * 128 + tid];
            named_arrive(3 + buf, 256);
          }
          ++handed;
        } else {
          wgmma_wait<0>();
          fence_regs(dpt);
        }
        uint32_t pa[4][NP][4], dsa[4][NP][4];
        if (do_dk) {
          // dS^T = P^T (dP^T - D)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 dj = dd[4 * j];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[4 * j + e] =
                  st[4 * j + e] * (dpt[4 * j + e] - (e % 2 ? dj.y : dj.x));
          }
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) acc_to_a_parts<NP>(dsa[ks], dpt, ks);
        }
        if (do_dv) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) acc_to_a_parts<NP>(pa[ks], st, ks);
        }

        // dV += P^T dO and dK += dS^T Q: A from registers, B the tiles read
        // MN-major, over the parts
#pragma unroll
        for (int a = 0; a < NACC; ++a) fence_regs(acc[a]);
        wgmma_fence();
        if (do_dv) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int p = 0; p < TL::kPairs; ++p)
              rs_mn<D, BQ>(acc[0], pa[ks][TL::part_a(p)],
                           qpart(do_tile(s), TL::part_b(p)), ks);
        }
        if (do_dk) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int p = 0; p < TL::kPairs; ++p)
              rs_mn<D, BQ>(acc[NACC - 1], dsa[ks][TL::part_a(p)],
                           qpart(q_tile(s), TL::part_b(p)), ks);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int a = 0; a < NACC; ++a) fence_regs(acc[a]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));   // this warp is done with s
    }
    if constexpr (kWide) {
      // the last two buffers' empty arrivals, which no later hand waited on
      if (wg == 0)
        for (int u = handed < 2 ? 0 : handed - 2; u < handed; ++u)
          named_sync(3 + (u & 1), 256);
    }

    const size_t kv_base = (size_t)bkv * Sk * D;
    const size_t n = (size_t)n_bkv * Sk * D;      // B Hkv Sk D
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kc = kr0 + 8 * i;
      if (kc >= Sk) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const size_t at = kv_base + (size_t)kc * D + 8 * j + 2 * (lane % 4);
        if (do_dv) {
          const float v0 = acc[0][4 * j + 2 * i];
          const float v1 = acc[0][4 * j + 2 * i + 1];
          if (splits == 1)
            store2(dv + at, v0, v1);
          else
            store2(part + (2 * split + 1) * n + at, v0, v1);
        }
        if (do_dk) {
          const float k0 = acc[NACC - 1][4 * j + 2 * i] * scale;
          const float k1 = acc[NACC - 1][4 * j + 2 * i + 1] * scale;
          if (splits == 1)
            store2(dk + at, k0, k1);
          else
            store2(part + 2 * split * n + at, k0, k1);
        }
      }
    }
  }
}

// dQ of block (bh, qt), as dq_block's: BM rows from qt BM, 64 a consumer
// warpgroup (with kWide both warpgroups on the same 64 rows, taking
// alternate key steps); K and V tiles of BKQ keys through rings of their
// own, V released after dP, K after dQ += dS K.
template <int D, int NP, typename T>
__device__ __forceinline__ void dq_parts(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, const CUtensorMap& map_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk, int causal,
    int window, float scale, float scale_log2, int bh, int qt) {
  using TL = PartTile<D, NP>;
  constexpr int BM = TL::BM, BKQ = TL::BKQ, W = TL::W;
  constexpr int SK = TL::kKStages, SV = TL::kVStages;
  constexpr bool kWide = TL::kWide;
  constexpr int NS = BKQ / 2;     // score registers a thread
  extern __shared__ __align__(1024) unsigned char wsm[];
  const uint32_t base = (smem_u32(wsm) + 1023) & ~1023u;
  const uint32_t q_tile = base, do_tile = base + TL::kMTile;
  auto k_tile = [&](int s) { return base + 2 * TL::kMTile + s * TL::kKTile; };
  auto v_tile = [&](int s) { return k_tile(SK + s); };
  const uint32_t bars = base + TL::kQBars;
  auto full_k = [&](int s) { return bars + 8 * s; };
  auto empty_k = [&](int s) { return bars + 8 * (SK + s); };
  auto full_v = [&](int s) { return bars + 8 * (2 * SK + s); };
  auto empty_v = [&](int s) { return bars + 8 * (2 * SK + SV + s); };
  const uint32_t q_bar = bars + 8 * (2 * SK + 2 * SV);

  const int b = bh / Hq, h = bh % Hq, bkv = b * Hkv + h / (Hq / Hkv);
  const int q_lo = qt * BM;
  const int off = Sk - Sq;
  int kt_begin, kt_end;
  key_tiles(q_lo, min(q_lo + BM, Sq) - 1, Sk, off, causal, window, BKQ,
            &kt_begin, &kt_end);
  const int n_it = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    constexpr int consumers = kWide ? 4 : 8;   // the warps that read a tile
    for (int s = 0; s < SK; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(empty_k(s), consumers);
    }
    for (int s = 0; s < SV; ++s) {
      mbar_init(full_v(s), 1);
      mbar_init(empty_v(s), consumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256 && n_it > 0) {
      mbar_expect_tx(q_bar, 2 * TL::kMTile);
      tma_tile<W, BM>(q_tile, &map_q, q_bar, q_lo, bh);
      tma_tile<W, BM>(do_tile, &map_do, q_bar, q_lo, bh);
      for (int it = 0; it < n_it; ++it) {
        const int kv_lo = (kt_begin + it) * BKQ;
        const int sk = it % SK, sv = it % SV;
        if (it >= SK) mbar_wait(empty_k(sk), (it / SK - 1) & 1);
        mbar_expect_tx(full_k(sk), TL::kKTile);
        tma_tile<W, BKQ>(k_tile(sk), &map_k, full_k(sk), kv_lo, bkv);
        if (it >= SV) mbar_wait(empty_v(sv), (it / SV - 1) & 1);
        mbar_expect_tx(full_v(sv), TL::kKTile);
        tma_tile<W, BKQ>(v_tile(sv), &map_v, full_v(sv), kv_lo, bkv);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
    const int rr = kWide ? 0 : 64 * wg;             // its rows in the tile
    const int rw = q_lo + rr;                      // this warpgroup's rows
    const int r0 = rw + 16 * w + lane / 4;         // + 8 h: this thread's
    const size_t q_base = (size_t)bh * Sq;
    float l2[2], dd[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      l2[i] = r < Sq ? lse[q_base + r] * kLog2e : pos_inf();
      dd[i] = r < Sq ? delta[q_base + r] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    if (n_it > 0) mbar_wait(q_bar, 0);
    // part i's chunks of the (Q, dO) and (K, V) tiles
    auto mpart = [](uint32_t tile, int i) {
      return tile + TL::template part<BM>(i);
    };
    auto kpart = [](uint32_t tile, int i) {
      return tile + TL::template part<BKQ>(i);
    };

    for (int it = kWide ? wg : 0; it < n_it; it += kWide ? 2 : 1) {
      const int sk = it % SK, sv = it % SV;
      mbar_wait(full_k(sk), (it / SK) & 1);
      mbar_wait(full_v(sv), (it / SV) & 1);
      const int kv_lo = (kt_begin + it) * BKQ;
      // none of this warpgroup's rows sees the tile's keys
      const bool idle = rw >= Sq || (causal && kv_lo > rw + 63 + off) ||
                        (window > 0 && kv_lo + BKQ - 1 <= rw + off - window);
      float sc[NS], dp[NS];
      if (!idle) {
        // S = Q K^T and dP = dO V^T: 64 rows x BKQ keys, over the parts
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
          for (int p = 0; p < TL::kPairs; ++p)
            wgmma_ss<BKQ>(sc,
                          kmajor_desc<BM>(mpart(q_tile, TL::part_a(p)), rr, kk),
                          kmajor_desc<BKQ>(kpart(k_tile(sk), TL::part_b(p)),
                                           0, kk),
                          kk > 0 || p > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
          for (int p = 0; p < TL::kPairs; ++p)
            wgmma_ss<BKQ>(dp,
                          kmajor_desc<BM>(mpart(do_tile, TL::part_a(p)), rr,
                                          kk),
                          kmajor_desc<BKQ>(kpart(v_tile(sv), TL::part_b(p)),
                                           0, kk),
                          kk > 0 || p > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);

        // P; element 4 j + 2 h + e: row r0 + 8 h, key kv_lo + 8 j +
        // 2 (lane % 4) + e
        if (edge_tile(rw, 64, kv_lo, BKQ, Sk, off, causal, window)) {
#pragma unroll
          for (int j = 0; j < BKQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p =
                  exp2_ftz(sc[4 * j + e] * scale_log2 - l2[e / 2]);
              sc[4 * j + e] =
                  visible(kv_lo + 8 * j + 2 * (lane % 4) + (e % 2),
                          r0 + 8 * (e / 2), Sq, Sk, off, causal, window)
                      ? p
                      : 0.f;
            }
        } else {
#pragma unroll
          for (int j = 0; j < BKQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[4 * j + e] =
                  exp2_ftz(sc[4 * j + e] * scale_log2 - l2[e / 2]);
        }
        wgmma_wait<0>();
        fence_regs(dp);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v(sv));   // this warp is done with V
      if (!idle) {
        // dS = P (dP - D)
#pragma unroll
        for (int j = 0; j < BKQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dd[e / 2]);
        uint32_t dsa[BKQ / 16][NP][4];
#pragma unroll
        for (int ks = 0; ks < BKQ / 16; ++ks)
          acc_to_a_parts<NP>(dsa[ks], sc, ks);

        // dQ += dS K: A from registers, K read MN-major, over the parts
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BKQ / 16; ++ks)
#pragma unroll
          for (int p = 0; p < TL::kPairs; ++p)
            rs_mn<D, BKQ>(acc, dsa[ks][TL::part_a(p)],
                          kpart(k_tile(sk), TL::part_b(p)), ks);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k(sk));   // and with K
    }

    if constexpr (kWide) {
      // warpgroup 1's dQ handed to warpgroup 0 through the K and V rings,
      // which every load has reached and every product left (named barrier
      // 1 over the 256 consumer threads), and added after its own
      float* red = reinterpret_cast<float*>(wsm + (k_tile(0) - smem_u32(wsm)));
      named_sync(1, 256);
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) red[i * 128 + tid] = acc[i];
      }
      named_sync(1, 256);
      if (wg == 1) return;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += red[i * 128 + tid];
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= Sq) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(dq + (q_base + r) * D + 8 * j + 2 * (lane % 4),
               acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// dK/dV and dQ in one launch, ordered as fa2_bwd_wgmma's: the dK/dV blocks
// first (key block 0 first), then the dQ blocks (the last row tile first).
// Blocks restricted by `only` (1: the dK/dV blocks, 2: the dQ blocks) skip
// the others' work, for chip_profile.py's split of a call; 0 runs both.
template <int D, int NP, typename T>
__global__ void __launch_bounds__(PartTile<D, NP>::kThreads, 1)
    fa2_bwd_wgmma_parts(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        T* __restrict__ dk, T* __restrict__ dv,
                        float* __restrict__ part, int Hq, int Hkv, int Sq,
                        int Sk, int causal, int window, float scale,
                        float scale_log2, int splits, int kv_cols, int n_kv,
                        int q_cols, int n_qt, int only) {
  const int blk = blockIdx.x;
  if (blk < n_kv) {
    if (only == 2) return;
    dkdv_parts<D, NP, T>(map_q, map_k, map_v, map_do, lse, delta, dk, dv,
                         part, Hq, Hkv, Sq, Sk, causal, window, scale,
                         scale_log2, splits, blk % kv_cols, blk / kv_cols,
                         kv_cols / splits);
  } else {
    if (only == 1) return;
    const int r = blk - n_kv;
    dq_parts<D, NP, T>(map_q, map_k, map_v, map_do, lse, delta, dq, Hq, Hkv,
                       Sq, Sk, causal, window, scale, scale_log2, r % q_cols,
                       n_qt - 1 - r / q_cols);
  }
}

// float32 at d 64 and 128: D = rowsum(dO O) (as fa2_bwd_delta<float, 1>
// sums it) and q and dO split into their two bf16 parts, one warp a row of
// (B Hq Sq); then k and v split, one warp a row of (B Hkv Sk). A row of d
// floats becomes a row of 2 d bf16: hi's d, then lo's.
__global__ void __launch_bounds__(256) fa2_bwd_prep_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o,
    const float* __restrict__ dO, float* __restrict__ delta,
    bf16* __restrict__ qs, bf16* __restrict__ ks, bf16* __restrict__ vs,
    bf16* __restrict__ dos, long long q_rows, long long kv_rows, int d) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row < q_rows) {
    const float* a = o + row * d;
    const float* b = dO + row * d;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s += a[c] * b[c];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) delta[row] = s;
    split_row(q + row * d, qs + row * 2 * d, d, lane);
    split_row(b, dos + row * 2 * d, d, lane);
  } else if (row < q_rows + kv_rows) {
    const long long r = row - q_rows;
    split_row(k + r * d, ks + r * 2 * d, d, lane);
    split_row(v + r * d, vs + r * 2 * d, d, lane);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  float *delta, *part;
  bf16* split;
  void *dq, *dk, *dv;
  int B, Hq, Hkv, Sq, Sk, causal, window, splits, only;
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
  fa2_bwd_delta<T, sizeof(T) == 2 ? 8 : 1>
      <<<(unsigned)blocks, 256, 0, a.stream>>>(
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

template <int D>
cudaError_t launch_wgmma(const Args& a) {
  using TL = WgTile<D>;
  cudaError_t e = launch_delta<bf16>(a, D);
  if (e != cudaSuccess) return e;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mdo;
  if (!encode_heads(&mq, enc, a.q, D, a.Sq, a.B * a.Hq) ||
      !encode_heads(&mk, enc, a.k, D, a.Sk, a.B * a.Hkv) ||
      !encode_heads(&mv, enc, a.v, D, a.Sk, a.B * a.Hkv) ||
      !encode_heads(&mdo, enc, a.dO, D, a.Sq, a.B * a.Hq))
    return cudaErrorInvalidValue;
  const float scale_log2 = a.scale * kLog2e;
  auto kern = fa2_bwd_wgmma<D>;
  constexpr size_t smem =
      TL::smem_kv > TL::smem_q ? TL::smem_kv : TL::smem_q;
  if ((e = allow_smem(kern, smem)) != cudaSuccess) return e;
  const long long kv_cols = (long long)a.B * a.Hkv * a.splits;
  const long long n_kv = kv_cols * ((a.Sk + TL::BKV - 1) / TL::BKV);
  const long long q_cols = (long long)a.B * a.Hq;
  const long long n_qt = (a.Sq + TL::BM - 1) / TL::BM;
  if (n_kv + q_cols * n_qt > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)(n_kv + q_cols * n_qt), TL::kThreads, smem, a.stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, static_cast<bf16*>(a.dq),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.part, a.Hq,
      a.Hkv, a.Sq, a.Sk, a.causal, a.window, a.scale, scale_log2, a.splits,
      (int)kv_cols, (int)n_kv, (int)q_cols, (int)n_qt);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (a.splits > 1) return launch_sum_parts<bf16>(a, D);
  return cudaGetLastError();
}

// TMA + wgmma on NP bf16 parts: bfloat16 at d 256 (NP 1), float32 at d 64
// and 128 (NP 2: fa2_bwd_prep_f32 first writes q, k, v and dO's parts into
// `split`, with D)
template <int D, int NP>
cudaError_t launch_parts(const Args& a) {
  using TL = PartTile<D, NP>;
  using T = typename std::conditional<NP == 2, float, bf16>::type;
  // cuTensorMapEncodeTiled needs q's context current on this thread (the
  // backward runs on autograd's thread, where no runtime call may have
  // bound it yet)
  cudaPointerAttributes pa;
  cudaError_t e = cudaPointerGetAttributes(&pa, a.q);
  if (e == cudaSuccess) e = cudaSetDevice(pa.device);
  if (e != cudaSuccess) return e;
  const void *tq = a.q, *tk = a.k, *tv = a.v, *tdo = a.dO;
  if constexpr (NP == 2) {
    if (a.split == nullptr || (uintptr_t)a.split % 16 != 0)
      return cudaErrorInvalidValue;
    const long long q_rows = (long long)a.B * a.Hq * a.Sq;
    const long long kv_rows = (long long)a.B * a.Hkv * a.Sk;
    const long long blocks = (q_rows + kv_rows + 7) / 8;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    bf16* qs = a.split;
    bf16* dos = qs + q_rows * 2 * D;
    bf16* ks = dos + q_rows * 2 * D;
    bf16* vs = ks + kv_rows * 2 * D;
    fa2_bwd_prep_f32<<<(unsigned)blocks, 256, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.o),
        static_cast<const float*>(a.dO), a.delta, qs, ks, vs, dos, q_rows,
        kv_rows, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    tq = qs;
    tk = ks;
    tv = vs;
    tdo = dos;
  } else {
    if ((e = launch_delta<bf16>(a, D)) != cudaSuccess) return e;
  }
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mdo;
  if (!encode_heads(&mq, enc, tq, TL::W, a.Sq, a.B * a.Hq) ||
      !encode_heads(&mk, enc, tk, TL::W, a.Sk, a.B * a.Hkv) ||
      !encode_heads(&mv, enc, tv, TL::W, a.Sk, a.B * a.Hkv) ||
      !encode_heads(&mdo, enc, tdo, TL::W, a.Sq, a.B * a.Hq))
    return cudaErrorInvalidValue;
  const float scale_log2 = a.scale * kLog2e;
  auto kern = fa2_bwd_wgmma_parts<D, NP, T>;
  if ((e = allow_smem(kern, TL::smem)) != cudaSuccess) return e;
  const long long kv_cols = (long long)a.B * a.Hkv * a.splits;
  const long long n_kv = kv_cols * ((a.Sk + TL::BKV - 1) / TL::BKV);
  const long long q_cols = (long long)a.B * a.Hq;
  const long long n_qt = (a.Sq + TL::BM - 1) / TL::BM;
  if (n_kv + q_cols * n_qt > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)(n_kv + q_cols * n_qt), TL::kThreads, TL::smem,
         a.stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, static_cast<T*>(a.dq),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.part, a.Hq, a.Hkv,
      a.Sq, a.Sk, a.causal, a.window, a.scale, scale_log2, a.splits,
      (int)kv_cols, (int)n_kv, (int)q_cols, (int)n_qt, a.only);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (a.splits > 1) return launch_sum_parts<T>(a, D);
  return cudaSuccess;
}

// The routes, as the getters number them
enum Route { kFma = 0, kMma = 1, kWgmma = 2, kWgmma3xBf16 = 3 };

bool head_dim(int d) {
  return d == 16 || d == 32 || d == 64 || d == 80 || d == 128 || d == 256;
}

// The route a (dtype, d) call runs: bfloat16 TMA + wgmma at d 64, 128 and
// 256, mma.sync at 16, 32 and 80; float32 TMA + wgmma on 3xBF16 at d 64
// and 128, FMA at 16, 32, 80 and 256; -1 for an unknown dtype or head dim
int route_of(int dtype, int d) {
  if (!head_dim(d)) return -1;
  if (dtype == 0) return d == 64 || d == 128 ? kWgmma3xBf16 : kFma;
  if (dtype == 1) return wgmma_head_dim(d) || d == 256 ? kWgmma : kMma;
  return -1;
}

// Whether `route` runs a (dtype, d) call: the one route_of names, or the
// first version of its dtype where that was the route before the wgmma
// kernels took it (FMA at every head dim, mma.sync at d 256), which
// chip_profile.py and the card tests time and hold beside it
bool route_runs(int route, int dtype, int d) {
  if (route_of(dtype, d) < 0) return false;
  return route == route_of(dtype, d) || (dtype == 0 && route == kFma) ||
         (dtype == 1 && route == kMma && !wgmma_head_dim(d));
}

// Keys a dK/dV block of the route at head dim d
int key_block(int route, int d) {
  switch (route) {
    case kFma: return FmaTile<128>::BK;
    case kMma: return MmaTile<80>::BKV;
    case kWgmma: return d == 256 ? PartTile<256, 1>::BKV : WgTile<128>::BKV;
    case kWgmma3xBf16:
      return d == 64 ? PartTile<64, 2>::BKV : PartTile<128, 2>::BKV;
    default: return 0;
  }
}

cudaError_t launch_route(int route, int d, const Args& a) {
  if (route == kMma || route == kWgmma) {
    // 16-byte cp.async rows and TMA need 16-byte aligned bases
    if (((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.o |
         (uintptr_t)a.dO | (uintptr_t)a.dq | (uintptr_t)a.dk |
         (uintptr_t)a.dv) % 16 != 0)
      return cudaErrorMisalignedAddress;
  }
  switch (route) {
    case kFma:
      switch (d) {
        case 16: return launch_fma<16>(a);
        case 32: return launch_fma<32>(a);
        case 64: return launch_fma<64>(a);
        case 80: return launch_fma<80>(a);
        case 128: return launch_fma<128>(a);
        case 256: return launch_fma<256>(a);
        default: return cudaErrorInvalidValue;
      }
    case kMma:
      switch (d) {
        case 16: return launch_mma<16>(a);
        case 32: return launch_mma<32>(a);
        case 80: return launch_mma<80>(a);
        case 256: return launch_mma<256>(a);
        default: return cudaErrorInvalidValue;
      }
    case kWgmma:
      switch (d) {
        case 64: return launch_wgmma<64>(a);
        case 128: return launch_wgmma<128>(a);
        case 256: return launch_parts<256, 1>(a);
        default: return cudaErrorInvalidValue;
      }
    case kWgmma3xBf16:
      switch (d) {
        case 64: return launch_parts<64, 2>(a);
        case 128: return launch_parts<128, 2>(a);
        default: return cudaErrorInvalidValue;
      }
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kernel: 0 = the route
// flash_attention_bwd_route names, else that route + 1 (the first version
// of the dtype, FMA or mma.sync, at any head dim: to time one against the
// other). q, dq: (B, Hq, Sq, d); k, v, dk, dv: (B, Hkv, Sk, d); o, dO: q's
// shape and dtype; lse: float32 (B, Hq, Sq); delta: float32 scratch of (B,
// Hq, Sq); part: float32 scratch of (splits, 2, B, Hkv, Sk, d), unused (may
// be null) when splits == 1; split: bfloat16 scratch of 2 B (2 Hq Sq + 2
// Hkv Sk) d on the 3xBF16 route (q, dO, k and v's parts), else unused.
// only: 0, or on the routes that run dK/dV and dQ blocks in one launch
// (TMA + wgmma at d 256 and 3xBF16) 1 to run only the dK/dV blocks, 2 only
// the dQ blocks (chip_profile.py's split of a call; the outputs of the
// others are left undefined). Returns a cudaError_t code (0 = ok).
extern "C" int flash_attention_bwd_launch(
    int dtype, int kernel, const void* q, const void* k, const void* v,
    const void* o, const void* dO, const float* lse, float* delta,
    float* part, void* split, void* dq, void* dk, void* dv, int B, int Hq,
    int Hkv, int Sq, int Sk, int d, int causal, int window, int splits,
    int only, float scale, void* stream) {
  const int route = kernel == 0 ? route_of(dtype, d) : kernel - 1;
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      (long long)B * Hq > 65535 || splits < 1 || splits > Hq / Hkv ||
      (splits > 1 && part == nullptr) || !route_runs(route, dtype, d) ||
      only < 0 || only > 2 ||
      (only != 0 && route != kWgmma3xBf16 && !(route == kWgmma && d == 256)))
    return (int)cudaErrorInvalidValue;
  const Args a{q,     k,    v,  o,  dO,     lse,    delta, part,
               static_cast<bf16*>(split), dq, dk, dv, B, Hq, Hkv, Sq,
               Sk,    causal, window, splits, only, scale,
               static_cast<cudaStream_t>(stream)};
  return (int)launch_route(route, d, a);
}

// Keys a dK/dV block (the grid has ceil(Sk / it) key blocks) of the
// kernels a (dtype, d, kernel) call runs, kernel as the launcher takes it;
// 0 for a call it refuses. The wrapper sizes its GQA group splits by it.
extern "C" int flash_attention_bwd_key_block(int dtype, int d, int kernel) {
  const int route = kernel == 0 ? route_of(dtype, d) : kernel - 1;
  return route_runs(route, dtype, d) ? key_block(route, d) : 0;
}

// The kernels a (dtype, d) call runs: 0 FMA, 1 mma.sync, 2 TMA + wgmma
// (bfloat16), 3 TMA + wgmma on 3xBF16 (float32); -1 for an unknown dtype
// or head dim.
extern "C" int flash_attention_bwd_route(int dtype, int d) {
  return route_of(dtype, d);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
