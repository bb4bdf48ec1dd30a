// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention_fwd
//           (body _fa_kernel), the Pallas TPU forward kernel.
//
// What it computes: causal or windowed GQA attention. q is (B, Hq, Sq, d),
// k and v are (B, Hkv, Sk, d); q head h reads kv head h / (Hq / Hkv). Query
// row r attends to key column c iff c <= r + (Sk - Sq) (causal) and
// c > r + (Sk - Sq) - window (window > 0). The offset Sk - Sq lets one
// kernel serve a plain prefill (Sk == Sq) and a suffix prefill over a
// cached prefix (Sk = prefix_len + Sq). Online softmax in f32; the output
// is acc / max(l, 1e-30).
//
// What bounds it on the H100: counting each input byte once, the bytes at
// short prefills and the operations past about a thousand tokens (causal
// work grows as Sq*Sk, bytes as Sq+Sk; at the 512-token prefill with 24
// heads of 128 the two bounds are 2.5 and 1.6 us in bf16; at
// recurrentgemma-2b's 2304-token, window-2048 prefill the operations, 27 us
// at the bf16 tensor-core rate).
//
// Four routes, by (dtype, head dim); ``flash_attention_fwd_route`` names
// them:
//
// bfloat16 at d 64, 128 and 256 ("wgmma"): TMA + wgmma (the
// FlashAttention-3 shape, below at flash_fwd_wgmma): a producer warp
// streams K and V tiles by TMA into a two-stage mbarrier ring while one or
// two consumer warpgroups of 64 query rows each run S = Q K^T and O += P V
// as wgmma, the online softmax in registers between them. Against the
// mma.sync kernel's limits (the same warps issued the cp.async copies, the
// ldmatrix loads, the exponentials and the products, one after another, at
// 5.3x the bound at llama3.2-3b's training shape; at d 256 Q re-read from
// shared memory every 32-key tile, 7.3x the bound at recurrentgemma-2b's):
// the loads leave the compute warps, a warpgroup's product is one
// asynchronous instruction a k-step, and a 128-row block reads each K and
// V tile once for two warpgroups. At d 256 a warpgroup's O of 64 rows is
// 128 registers a thread and a row 512 bytes, so the key tiles are 64 rows
// (a 128-row block's Q and two stages of K and V: 192 KB) and a 64-row
// block holds its SM alone. Blocks of 128 or 64 rows by shape
// (``flash_attention_fwd_kernel``).
//
// float32 at d 64 and 128 ("wgmma-3xbf16"): the same kernel on bf16 parts
// (attention.cuh's PartLayout): a first kernel writes q, k and v as [hi |
// lo] rows of 2 d bf16 (hi = bf16(x), lo = bf16(x - hi)), each product is
// the three bf16 products lo hi + hi lo + hi hi into one float32
// accumulator, and P is split into its two parts in registers, not rounded
// (within 1e-4 of the float32 output where one bf16 pass is not; tf32's
// wgmma would read V only K-major). A row of parts at d 128 is 256 bf16
// columns, a bf16 row at d 256: both run one tile plan. Against the FMA
// kernel (4.4x its FMA-rate bound at dist (g)'s shape, never on the tensor
// cores): three bf16 products at the tensor cores' 989 TFLOP/s take a fifth
// of the time one product takes at the FMA rate's 67 (3/989 against 1/67).
//
// bfloat16 at d 16, 32 and 80 ("mma.sync"; the first version, and at any
// head dim on request): tensor cores FlashAttention-2 style, with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate):
//   * grid (B*Hq, ceil(Sq/64)): four warps per block, each owning 16 rows
//     of a 64-row query tile; the query tiles of a head are launched last
//     tile first, so a causal prefill's heaviest tiles start in the first
//     wave and the last wave is light;
//   * Q is staged once and, for d <= 128, held in registers as mma A
//     fragments (ldmatrix); at d = 256 the O accumulator alone is 128 f32
//     registers a thread, so Q is re-read from shared memory per KV tile
//     and the KV tile is 32 rows (64 below);
//   * K and V tiles stream through a two-stage cp.async ring (the next
//     tile loads while this one is consumed); shared rows are padded by 16
//     bytes, so ldmatrix reads them without bank conflicts; V is read with
//     ldmatrix.trans;
//   * S = Q K^T accumulates in f32 registers; scale, causal/window mask
//     (only on tiles that cross a boundary) and the online softmax stay in
//     registers, the row max and sum going across the four lanes that
//     share a row by shuffles;
//   * P is rounded to bf16 (as the TPU kernel does: p.astype(v.dtype)) and
//     fed straight back as the A operand of P V: the accumulator fragment
//     of m16n8k16 has the A fragment's layout, so P never touches shared
//     memory.
// The scores are f32 sums of exact bf16 products, as in the reference, on
// both bf16 routes. Every route runs one device kernel a call but
// "wgmma-3xbf16", which runs two (the parts, then the attention); all are
// named flash_*.
//
// float32 at d 16, 32, 80 and 256 keeps plain FMA (the first version, and
// at any head dim on request): grid (ceil(Sq/BQ), B*Hq), Q, K and V tiles
// in shared memory as f32 (rows padded by one float), each of the 128
// threads owning a (BQ/16 x BK/8) patch of scores and a (BQ/16 x d/8)
// patch of the output.
//
// All: KV tiles entirely in the future (causal with the Sk - Sq offset)
// or entirely outside the window are never loaded; ragged Sq and Sk are
// masked in the kernel; head dims 16, 32, 64, 80 (stablelm-3b), 128 and
// 256, one instantiation each (a dispatch case per head dim, not any
// multiple of 16). At d 80 the bf16 kernel runs 5 k-steps of m16n8k16 for
// Q K^T and 10 n8 tiles for P V; a shared row is 88 elements (176 bytes,
// 11 16-byte chunks), so the 8 rows an ldmatrix reads start at 176 r mod
// 128 = {0, 48, 96, 16, 64, 112, 32, 80}: distinct 16-byte bank groups, no
// conflict, with no swizzle to get wrong; global rows stay 160 bytes.

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

// A call's arguments, as flash_attention_fwd_launch takes them
struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  bf16* split;
  int B, Hq, Hkv, Sq, Sk, causal, window;
  float scale;
  cudaStream_t stream;
};

constexpr int kThreads = 128;   // 16 row groups x 8 column lanes
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }

// max / sum across the 8 lanes that share one row group
__device__ __forceinline__ float group8_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D, int BQ, int BK>
struct Tile {
  static constexpr int RM = BQ / 16;      // query rows per thread
  static constexpr int CN = BK / 8;       // score columns per thread
  static constexpr int DN = D / 8;        // output columns per thread
  static constexpr int QST = D + 1;       // padded row stride of Q and K
  static constexpr int PST = BK + 8 / RM; // padded row stride of P
  static constexpr size_t smem_bytes =
      sizeof(float) * ((size_t)BQ * QST + (size_t)BK * QST + (size_t)BK * D +
                       (size_t)BQ * PST);
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv, int Sq,
    int Sk, int causal, int window, float scale) {
  using TL = Tile<D, BQ, BK>;
  constexpr int RM = TL::RM, CN = TL::CN, DN = TL::DN;
  constexpr int QST = TL::QST, PST = TL::PST;

  extern __shared__ float smem[];
  float* Qs = smem;              // (BQ, QST)
  float* Ks = Qs + BQ * QST;     // (BK, QST)
  float* Vs = Ks + BK * QST;     // (BK, D)
  float* Ps = Vs + BK * D;       // (BQ, PST)

  const int tid = threadIdx.x;
  const int tx = tid & 7;        // column lane within the row group
  const int ty = tid >> 3;       // row group, 0..15
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q_lo = blockIdx.x * BQ;
  const int off = Sk - Sq;

  const T* qp = q + (size_t)bh * Sq * D;
  const T* kp = k + ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const T* vp = v + ((size_t)b * Hkv + hk) * (size_t)Sk * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qr = q_lo + r;
    Qs[r * QST + c] = qr < Sq ? to_f32(qp[(size_t)qr * D + c]) : 0.f;
  }

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  // the KV columns any row of this tile can see: [k_begin, k_end)
  const int q_hi = min(q_lo + BQ, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = min(k_end, q_hi + off + 1);
  const int k_begin = window > 0 ? max(0, q_lo + off - window + 1) : 0;
  const int kt_begin = k_begin / BK;
  const int kt_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * BK;
    __syncthreads();   // the previous tile's K, V and P are consumed
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kc = k_lo + r;
      const bool in = kc < Sk;
      Ks[r * QST + c] = in ? to_f32(kp[(size_t)kc * D + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vp[(size_t)kc * D + c]) : 0.f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = Qs[(ty * RM + i) * QST + kk];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = Ks[(tx + 8 * j) * QST + kk];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qr = q_lo + ty * RM + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kc = k_lo + tx + 8 * j;
        s[i][j] = visible(kc, qr, Sq, Sk, off, causal, window)
                      ? s[i][j] * scale
                      : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group8_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kc = k_lo + tx + 8 * j;
        const float p = visible(kc, qr, Sq, Sk, off, causal, window)
                            ? expf(s[i][j] - m_new)
                            : 0.f;
        Ps[(ty * RM + i) * PST + tx + 8 * j] = p;
        sum += p;
      }
      sum = group8_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();   // P complete

    for (int c = 0; c < BK; ++c) {
      float pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = Ps[(ty * RM + i) * PST + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const float vv = Vs[c * D + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

  T* op = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qr = q_lo + ty * RM + i;
    if (qr < Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DN; ++j)
        store_as(&op[(size_t)qr * D + tx + 8 * j], acc[i][j] / denom);
      if (lse != nullptr && tx == 0)
        lse[(size_t)bh * Sq + qr] =
            l[i] > 0.f ? m[i] + logf(l[i]) : __int_as_float(0x7f800000);
    }
  }
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch_tile(const Args& a) {
  const size_t smem = Tile<D, BQ, BK>::smem_bytes;
  auto kern = flash_fwd_kernel<T, D, BQ, BK>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.Hq);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.Hq, a.Hkv,
      a.Sq, a.Sk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(int d, const Args& a) {
  using T = float;
  switch (d) {
    case 16: return launch_tile<T, 16, 64, 64>(a);
    case 32: return launch_tile<T, 32, 64, 64>(a);
    case 64: return launch_tile<T, 64, 64, 64>(a);
    case 80: return launch_tile<T, 80, 64, 64>(a);
    case 128: return launch_tile<T, 128, 64, 64>(a);
    case 256: return launch_tile<T, 256, 32, 32>(a);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync.m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;   // 4 warps x 16 query rows
constexpr int kMmaBQ = 64;

template <int D>
struct MmaTile {
  static constexpr int BKV = D == 256 ? 32 : 64;   // KV rows a stage
  static constexpr bool kQRegs = D <= 128;         // Q fragments in regs
  static constexpr int ST = D + 8;                 // row stride: +16 bytes
  static constexpr size_t smem_bytes =
      sizeof(__nv_bfloat16) * (size_t)ST * (kMmaBQ + 4 * BKV);
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// rows [r0, r0 + R) of a (rows, D) bf16 matrix into s (row stride ST),
// zero past the last row; one cp.async group is committed by the caller
template <int D, int R, int ST>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* s,
                                           const __nv_bfloat16* g, int r0,
                                           int rows) {
  constexpr int CPR = D / 8;               // 16-byte chunks a row
  for (int e = threadIdx.x; e < R * CPR; e += kMmaThreads) {
    const int r = e / CPR, c = (e % CPR) * 8;
    const bool in = r0 + r < rows;
    cp_async16(smem_u32(s + r * ST + c),
               in ? g + (size_t)(r0 + r) * D + c : g, in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk, int causal,
    int window, float scale_log2) {
  using TL = MmaTile<D>;
  constexpr int BKV = TL::BKV, ST = TL::ST;
  constexpr int NS = BKV / 8;     // score n-blocks a warp holds
  constexpr int ND = D / 8;       // output n-blocks
  extern __shared__ __align__(16) unsigned char fa_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* Ks = Qs + kMmaBQ * ST;    // 2 stages of (BKV, ST)
  __nv_bfloat16* Vs = Ks + 2 * BKV * ST;   // 2 stages of (BKV, ST)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * kMmaBQ;   // last first
  const int off = Sk - Sq;

  const __nv_bfloat16* qp = q + (size_t)bh * Sq * D;
  const __nv_bfloat16* kp = k + ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const __nv_bfloat16* vp = v + ((size_t)b * Hkv + hk) * (size_t)Sk * D;

  // the KV columns any row of this tile can see: [k_begin, k_end)
  const int q_hi = min(q_lo + kMmaBQ, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = min(k_end, q_hi + off + 1);
  const int k_begin = window > 0 ? max(0, q_lo + off - window + 1) : 0;
  const int kt_begin = k_begin / BKV;
  const int kt_end = k_end > 0 ? (k_end + BKV - 1) / BKV : 0;

  stage_rows<D, kMmaBQ, ST>(Qs, qp, q_lo, Sq);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (kt_begin < kt_end) {
    stage_rows<D, BKV, ST>(Ks, kp, kt_begin * BKV, Sk);
    stage_rows<D, BKV, ST>(Vs, vp, kt_begin * BKV, Sk);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // this lane's rows of the tile: r_lo and r_lo + 8
  const int r_lo = q_lo + warp * 16 + lane / 4;
  const uint32_t q_row = smem_u32(Qs + (warp * 16 + lane % 16) * ST +
                                  8 * (lane / 16));
  uint32_t qf[TL::kQRegs ? D / 16 : 1][4];
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  if constexpr (TL::kQRegs) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) ldmatrix_x4(qf[ks], q_row + ks * 32);
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {neg_inf(), neg_inf()};
  float l_r[2] = {0.f, 0.f};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      stage_rows<D, BKV, ST>(Ks + (buf ^ 1) * BKV * ST, kp, (kt + 1) * BKV,
                             Sk);
      stage_rows<D, BKV, ST>(Vs + (buf ^ 1) * BKV * ST, vp, (kt + 1) * BKV,
                             Sk);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const __nv_bfloat16* kb = Ks + buf * BKV * ST;
    const __nv_bfloat16* vb = Vs + buf * BKV * ST;

    // S = Q K^T: lanes 8i..8i+7 address matrix i = (n-block j + i/2,
    // k half i%2) of K's rows
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const uint32_t k_row =
        smem_u32(kb + (8 * (lane / 16) + lane % 8) * ST + 8 * ((lane / 8) % 2));
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      if constexpr (TL::kQRegs) {
        a[0] = qf[ks][0], a[1] = qf[ks][1], a[2] = qf[ks][2], a[3] = qf[ks][3];
      } else {
        ldmatrix_x4(a, q_row + ks * 32);
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, k_row + (j * 8 * ST + ks * 16) * 2);
        mma_bf16(s[j], a, bf[0], bf[1]);
        mma_bf16(s[j + 1], a, bf[2], bf[3]);
      }
    }

    // scale (log2 domain), mask on tiles that cross a boundary, online
    // softmax; element e of s[j] is row r_lo + 8 (e / 2), column
    // kv_lo + 8 j + 2 (lane % 4) + e % 2
    const int kv_lo = kt * BKV;
    const bool edge = kv_lo + BKV > Sk ||
                      (causal && kv_lo + BKV - 1 > q_lo + off) ||
                      (window > 0 && kv_lo <= q_hi + off - window);
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int c = kv_lo + 8 * j + 2 * (lane % 4) + (e % 2);
          const int r = r_lo + 8 * (e / 2) + off;
          if (c >= Sk || (causal && c > r) || (window > 0 && c <= r - window))
            x = neg_inf();
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      m_use[i] = m_new == neg_inf() ? 0.f : m_new;   // nothing visible yet
      alpha[i] = exp2f(m_r[i] - m_use[i]);
      m_r[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_use[e / 2]);
        s[j][e] = p;
        sum[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + sum[i];
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0], acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1], acc[j][3] *= alpha[1];
    }

    // O += P V: P's accumulator fragments are the A fragments of the
    // product; lanes 8i..8i+7 address matrix i = (k half i%2, n-block
    // j + i/2) of V's rows, transposed on load
    const uint32_t v_row =
        smem_u32(vb + (lane % 8 + 8 * ((lane / 8) % 2)) * ST + 8 * (lane / 16));
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks) {
      const uint32_t a[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                             pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                             pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                             pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, v_row + (ks * 16 * ST + j * 8) * 2);
        mma_bf16(acc[j], a, bf[0], bf[1]);
        mma_bf16(acc[j + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  __nv_bfloat16* op = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int r = r_lo + 8 * i;
    if (r >= Sq) continue;
    // the row's log-sum-exp in natural units: m_r is in log2 units
    if (lse != nullptr && lane % 4 == 0)
      lse[(size_t)bh * Sq + r] =
          l > 0.f ? m_r[i] * 0.6931471805599453f + logf(l) : -neg_inf();
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + (size_t)r * D + 8 * j +
                                         2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
  }
}

template <int D>
cudaError_t launch_mma(const Args& a) {
  constexpr size_t smem = MmaTile<D>::smem_bytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_qt = (a.Sq + kMmaBQ - 1) / kMmaBQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  dim3 grid(a.B * a.Hq, n_qt);
  flash_mma_kernel<D><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.Hq,
      a.Hkv, a.Sq, a.Sk, a.causal, a.window, a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// TMA ring + wgmma (Hopper): bfloat16 at d 64, 128 and 256, float32 at d 64
// and 128 on bf16 parts (3xBF16)
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// flash_attention_fwd_launch's dtype codes
constexpr int kF32 = 0, kBf16 = 1;

// The (dtype, d) calls the wgmma kernels take: bfloat16 at d 64, 128 and
// 256, float32 at d 64 and 128 as two bf16 parts a value (PartLayout), a
// row of W = 128 or 256 bf16 columns either way. Every other call takes a
// first kernel: d 16, 32 and 80 rows are not whole 128-byte swizzle
// chunks, and a float32 row at d 256 would be 512 bf16 columns, whose O
// and tiles fit no block.
__host__ __device__ constexpr bool wgmma_call(int dtype, int d) {
  return d == 64 || d == 128 || (dtype == kBf16 && d == 256);
}
// bf16 columns a row of the wgmma kernels' tiles
__host__ __device__ constexpr int wgmma_width(int dtype, int d) {
  return dtype == kF32 ? 2 * d : d;
}

// A block is NWG consumer warpgroups of 64 query rows each and one producer
// warpgroup whose first thread issues the TMA loads: Q once, then K and V
// tiles of BN keys through a ring of two stages, K and V each completing
// on its own mbarrier (K's product can start before V lands) and released
// on its own: a K tile once its S product has completed, a V tile once its
// P V product has; the producer refills a slot when every consumer warp
// has arrived on its empty barrier, and loads K a tile ahead of V. Rows
// are W = NP D bf16 columns (PartLayout: NP 2 is float32 as [hi | lo]);
// an (R, W) tile is W / 64 swizzled column chunks of R rows of 128 bytes
// (chunks 1024-byte aligned). Two shapes:
//   * NWG 2: 128 rows, 384 threads, one block an SM, consumers at 240
//     registers; BN 128, or 64 at W 256 (Q 64 KB and two stages of K and
//     V 128 KB: 192 KB);
//   * NWG 1: 64 rows, 256 threads (launch bounds cap a thread at 128
//     registers; the producer gives 104 of them to the consumer, at 232);
//     BN 64; two blocks an SM below W 256, so that two blocks' rings fit at
//     W 128 (at d 64 too, where short prefills ran faster on 64-key tiles
//     than on 128-key ones), one at W 256 (160 KB).
template <int D, int NWG, int NP = 1>
struct FwdWg : PartLayout<D, NP> {
  static constexpr int W = PartLayout<D, NP>::W;       // bf16 columns a row
  static constexpr bool kWide = W == 256;
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kMinBlocks = NWG == 1 ? 2 : 1;  // launch bounds
  static constexpr int kSmBlocks = NWG == 1 && !kWide ? 2 : 1;  // resident
  static constexpr int kConsumerRegs = NWG == 1 ? 232 : 240;
  static constexpr int BM = 64 * NWG;                  // query rows a block
  static constexpr int BN = kWide ? 64 : 64 * NWG;     // keys a tile
  static constexpr int kStages = 2;
  static constexpr int kQBytes = BM * W * 2;
  static constexpr int kKvBytes = BN * W * 2;          // one K or V tile
  static constexpr int kBars = kQBytes + 2 * kStages * kKvBytes;
  // full and empty barriers of K and V a stage, and Q's
  static constexpr size_t smem = 1024 + kBars + (4 * kStages + 2) * 8;
  // 227 KB a block, 228 KB an SM with 1 KB of each block's reserved
  static_assert(smem <= 232448 && kSmBlocks * (smem + 1024) <= 233472,
                "FwdWg: over the SM's shared memory");
};

// Query rows a block, from the shapes alone (W: bf16 columns a row).
// Below W 256: 128 (two consumer warpgroups share each K and V tile,
// taking turns) for queries of 1024 rows and more whose 128-row tiles give
// every SM of an H100 (132) a work item; 64 (two blocks an SM, 64-key
// tiles) otherwise: at 512-768 rows the 64-row tiles' finer diagonal and
// the second block an SM win (llama3.2-3b's 512-token prefill, 96 tiles of
// 128 rows or 192 of 64), and a grid of fewer 128-row tiles than SMs
// leaves SMs idle. At W 256 a 64-row block holds its SM alone, so the
// second block's reason is gone: 128 wherever the 128-row tiles give every
// SM a work item, 64 only where they would leave SMs idle (recurrentgemma's
// short prefills). PERF.md gives the times that set this.
constexpr int kLongRows = 1024;
constexpr long long kSms = 132;
__host__ __device__ constexpr int wgmma_block_rows(long long bhs, int Sq,
                                                   int W) {
  return (W == 256 || Sq >= kLongRows) && bhs * ((Sq + 127) / 128) >= kSms
             ? 128
             : 64;
}

// float32 at d 64 and 128: q, k and v as their two bf16 parts, [hi | lo] a
// row (split_row), one warp a row of (B Hq Sq) for q, then of (B Hkv Sk)
// for k and v
__global__ void __launch_bounds__(256) flash_fwd_prep_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, bf16* __restrict__ qs,
    bf16* __restrict__ ks, bf16* __restrict__ vs, long long q_rows,
    long long kv_rows, int d) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row < q_rows) {
    split_row(q + row * d, qs + row * 2 * d, d, lane);
  } else if (row < q_rows + kv_rows) {
    const long long r = row - q_rows;
    split_row(k + r * d, ks + r * 2 * d, d, lane);
    split_row(v + r * d, vs + r * 2 * d, d, lane);
  }
}

// Work item i of n_items = bhs n_qt: b Hq + q head = i % bhs, query tile
// n_qt - 1 - i / bhs (the last tiles, which see the most keys under a
// causal mask, come first). The grid is persistent: block c of G takes the
// items of index r G + c in even rounds r and r G + G - 1 - c in odd ones
// (a snake over the longest-first order evens the blocks' work), so the
// producer loads the next item's Q, K and V while the consumers finish
// this one's last products and its output. Each consumer warpgroup keeps
// its 64 rows' O (64 x D), row max m and partial sum l in registers and
// walks the item's key tiles (key_tiles of its rows) in a software
// pipeline, FlashAttention-3's:
//   * S = Q K^T of tile j+1 (wgmma SS, both K-major) and O += P_j V_j
//     (wgmma RS: P_j in registers, the accumulator's layout being the A
//     fragment's; V MN-major) are issued together; the softmax of tile
//     j+1 runs while P_j V_j is still on the tensor cores; then O is
//     rescaled and P_{j+1} packed;
//   * each product is kPairs bf16 products over the parts (float32: lo hi
//     + hi lo + hi hi into one float32 accumulator, P split into its two
//     parts in registers; bfloat16: the one product, P rounded to bf16
//     before P V, as the TPU kernel does);
//   * the two warpgroups of a 128-row block take turns to issue their
//     products (named barriers 1 and 2), so one's softmax runs under the
//     other's products;
//   * the softmax in the log2 domain on raw scores: m is the running max of
//     Q K^T, p = 2^(scale log2 e (s - m)) one FFMA and one ex2; the scores
//     of a tile are tested one by one only where a mask edge crosses it
//     (edge_tile, a warpgroup's 64 rows at a time), against visible's
//     rule as a key range a row (visible_keys).
// O is written as acc / max(l, 1e-30) in the inputs' dtype straight from
// registers, and L (when lse is not null) as m scale + ln l in natural
// units. No atomics: two calls give the same bits, with or without L,
// whatever the grid; at W 256 every block shape walks 64-key tiles, so the
// block's rows change no bit either.
template <int D, int NWG, int NP>
__global__ void __launch_bounds__(FwdWg<D, NWG, NP>::kThreads,
                                  FwdWg<D, NWG, NP>::kMinBlocks)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    std::conditional_t<NP == 2, float, bf16>* __restrict__ o,
                    float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                    int causal, int window, float scale_log2, int bhs,
                    int n_qt) {
  using TL = FwdWg<D, NWG, NP>;
  constexpr int BM = TL::BM, BN = TL::BN, S = TL::kStages, W = TL::W;
  extern __shared__ __align__(1024) unsigned char fsm[];
  const uint32_t base = (smem_u32(fsm) + 1023) & ~1023u;
  const uint32_t q_tile = base;
  auto k_tile = [&](int s) { return base + TL::kQBytes + s * TL::kKvBytes; };
  auto v_tile = [&](int s) { return k_tile(S + s); };
  const uint32_t bars = base + TL::kBars;
  auto full_k = [&](int s) { return bars + 8 * s; };
  auto full_v = [&](int s) { return bars + 8 * (S + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 * S + s); };
  auto empty_v = [&](int s) { return bars + 8 * (3 * S + s); };
  const uint32_t q_full = bars + 8 * 4 * S, q_empty = q_full + 8;

  const int off = Sk - Sq, n_items = bhs * n_qt, G = gridDim.x;
  // the r-th item of this block (-1 past the last round's end), its head
  // and rows, and its key tiles
  auto item = [&](int r) {
    const int i = r * G + (r % 2 ? G - 1 - (int)blockIdx.x : blockIdx.x);
    return i < n_items ? i : -1;
  };
  auto tiles = [&](int i, int* bh, int* q_lo, int* kt_begin) {
    *bh = i % bhs;
    *q_lo = (n_qt - 1 - i / bhs) * BM;
    int kt_end;
    key_tiles(*q_lo, imin(*q_lo + BM, Sq) - 1, Sk, off, causal, window, BN,
              kt_begin, &kt_end);
    return kt_end - *kt_begin;
  };
  const int rounds = (n_items + G - 1) / G;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * NWG);   // each consumer warp
      mbar_init(empty_v(s), 4 * NWG);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * NWG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 128 * NWG) return;
    // tile g of this block's stream of K (is_v 0) or V (1) tiles into its
    // slot, once the slot's tile g - S has been released
    auto load = [&](int g, int is_v, int kv_lo, int bkv) {
      const int s = g % S;
      if (g >= S) mbar_wait(is_v ? empty_v(s) : empty_k(s), (g / S - 1) & 1);
      const uint32_t bar = is_v ? full_v(s) : full_k(s);
      mbar_expect_tx(bar, TL::kKvBytes);
      tma_tile<W, BN>(is_v ? v_tile(s) : k_tile(s), is_v ? &map_v : &map_k,
                      bar, kv_lo, bkv);
    };
    int g = 0, nq = 0;   // K/V tiles and Q tiles loaded so far
    for (int r = 0; r < rounds; ++r) {
      const int i = item(r);
      if (i < 0) continue;
      int bh, q_lo, kt_begin;
      const int n_it = tiles(i, &bh, &q_lo, &kt_begin);
      if (n_it == 0) continue;
      const int bkv = bh / Hq * Hkv + bh % Hq / (Hq / Hkv);
      if (nq > 0) mbar_wait(q_empty, (nq - 1) & 1);
      mbar_expect_tx(q_full, TL::kQBytes);
      tma_tile<W, BM>(q_tile, &map_q, q_full, q_lo, bh);
      ++nq;
      load(g, 0, kt_begin * BN, bkv);
      for (int it = 0; it < n_it; ++it) {
        if (it + 1 < n_it) load(g + it + 1, 0, (kt_begin + it + 1) * BN, bkv);
        load(g + it, 1, (kt_begin + it) * BN, bkv);
      }
      g += n_it;
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      TL::kConsumerRegs));
  const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
  float acc[D / 2];
  float m[2], l[2];
  // S of the tile in flight (element 4 j + 2 h + e: row r0 + 8 h, key
  // kv_lo + 8 j + 2 (lane % 4) + e), then its P; P of the tile before as
  // the A fragments of P V, in its NP parts
  float sc[BN / 2];
  uint32_t pa[BN / 16][NP][4];
  int rw, r0, kv_first;   // this warpgroup's and thread's rows, item's keys

  // the products' turns: this warpgroup issues after the other's
  // named_arrive (NWG 2)
  auto turn = [&]() {
    if constexpr (NWG == 2) named_sync(1 + wg, 256);
  };
  auto done = [&]() {
    if constexpr (NWG == 2) named_arrive(2 - wg, 256);
  };
  // part i's chunks of the Q tile and of a K or V tile
  auto qpart = [&](int i) { return q_tile + TL::template part<BM>(i); };
  auto kvpart = [](uint32_t tile, int i) {
    return tile + TL::template part<BN>(i);
  };
  auto issue_s = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int p = 0; p < TL::kPairs; ++p)
        wgmma_ss<BN>(sc, kmajor_desc<BM>(qpart(TL::part_a(p)), 64 * wg, kk),
                     kmajor_desc<BN>(kvpart(k_tile(s), TL::part_b(p)), 0, kk),
                     kk > 0 || p > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int s) {
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks)
#pragma unroll
      for (int p = 0; p < TL::kPairs; ++p)
        rs_mn<D, BN>(acc, pa[ks][TL::part_a(p)],
                     kvpart(v_tile(s), TL::part_b(p)), ks);
    wgmma_commit();
  };
  // the online softmax of the scores in sc (the item's key tile it): P
  // into sc, m and l updated; returns O's rescale factors in alpha
  auto softmax = [&](int it, float* alpha) {
    const int kv_lo = kv_first + it * BN;
    if (edge_tile(rw, 64, kv_lo, BN, Sk, off, causal, window)) {
      // visible's rule as a key range a row, relative to this thread's
      // first column: two compares an element
      int lo[2], hi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        visible_keys(r0 + 8 * h, Sq, Sk, off, causal, window, &lo[h], &hi[h]);
        lo[h] -= kv_lo + 2 * (lane % 4);
        hi[h] -= kv_lo + 2 * (lane % 4);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + e % 2 < lo[e / 2] || 8 * j + e % 2 > hi[e / 2])
            sc[4 * j + e] = neg_inf();
    }
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
    float mb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      const float m_use = m_new == neg_inf() ? 0.f : m_new;   // none yet
      alpha[h] = exp2_ftz((m[h] - m_use) * scale_log2);
      mb[h] = m_use * scale_log2;
      m[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_ftz(fmaf(sc[4 * j + e], scale_log2, -mb[e / 2]));
        sc[4 * j + e] = p;
        sum[e / 2] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
  };
  // after P V of the tile before has completed: O rescaled, P packed
  auto rescale_pack = [&](const float* alpha) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha[0], acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1], acc[4 * j + 3] *= alpha[1];
    }
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) acc_to_a_parts<NP>(pa[ks], sc, ks);
  };
  auto release = [&](uint32_t bar) {        // this warp is done with a slot
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  int g = 0, nq = 0;   // K/V tiles and Q tiles consumed so far
  for (int r = 0; r < rounds; ++r) {
    const int i = item(r);
    if (i < 0) continue;
    int bh, q_lo, kt_begin;
    const int n_it = tiles(i, &bh, &q_lo, &kt_begin);
    rw = q_lo + 64 * wg;
    r0 = rw + 16 * w + lane / 4;
    kv_first = kt_begin * BN;
#pragma unroll
    for (int k = 0; k < D / 2; ++k) acc[k] = 0.f;
    m[0] = m[1] = neg_inf();
    l[0] = l[1] = 0.f;

    if (n_it > 0) {
      float alpha[2];
      mbar_wait(q_full, nq & 1);
      if (NWG == 2 && wg == 1) done();       // warpgroup 0 issues first
      mbar_wait(full_k(g % S), (g / S) & 1);
      turn();
      fence_regs(acc);
      wgmma_fence();
      issue_s(g % S);
      done();
      wgmma_wait<0>();
      fence_regs(sc);
      release(empty_k(g % S));
      softmax(0, alpha);
      rescale_pack(alpha);
      for (int it = 1; it < n_it; ++it) {
        const int s = (g + it) % S, sp = (g + it - 1) % S;
        mbar_wait(full_k(s), ((g + it) / S) & 1);
        mbar_wait(full_v(sp), ((g + it - 1) / S) & 1);
        turn();
        fence_regs(acc);
        wgmma_fence();
        issue_s(s);
        issue_pv(sp);
        done();
        wgmma_wait<1>();
        fence_regs(sc);
        release(empty_k(s));
        softmax(it, alpha);
        wgmma_wait<0>();
        fence_regs(acc);
        release(empty_v(sp));
        rescale_pack(alpha);
      }
      release(q_empty);                      // Q's last product is done
      ++nq;
      const int sl = (g + n_it - 1) % S;
      mbar_wait(full_v(sl), ((g + n_it - 1) / S) & 1);
      turn();
      fence_regs(acc);
      wgmma_fence();
      issue_pv(sl);
      if (wg == 0) done();                   // warpgroup 1 issues last
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty_v(sl));
      g += n_it;
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row_q = r0 + 8 * h;
      if (row_q >= Sq) continue;
      const size_t row = (size_t)bh * Sq + row_q;
      if (lse != nullptr && lane % 4 == 0)
        lse[row] = lt > 0.f ? m[h] * scale_log2 * kLn2 + logf(lt)
                            : -neg_inf();
      const float inv = 1.f / fmaxf(lt, 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(o + row * D + 8 * j + 2 * (lane % 4), acc[4 * j + 2 * h] * inv,
               acc[4 * j + 2 * h + 1] * inv);
    }
  }
}

// The wgmma kernel with NWG consumer warpgroups on NP bf16 parts a value:
// for NP 2 flash_fwd_prep_f32 first writes q, k and v's parts into
// a.split, which the tensor maps then read
template <int D, int NWG, int NP>
cudaError_t launch_wgmma(const Args& a) {
  using TL = FwdWg<D, NWG, NP>;
  using T = std::conditional_t<NP == 2, float, bf16>;
  // cuTensorMapEncodeTiled needs q's context current on this thread (a
  // recompute under torch.utils.checkpoint runs on autograd's backward
  // thread, where no runtime call may have bound it yet)
  cudaPointerAttributes pa;
  cudaError_t e = cudaPointerGetAttributes(&pa, a.q);
  if (e == cudaSuccess) e = cudaSetDevice(pa.device);
  if (e != cudaSuccess) return e;
  if (pa.device < 0 || pa.device >= 32) return cudaErrorInvalidDevice;
  const void *tq = a.q, *tk = a.k, *tv = a.v;
  if constexpr (NP == 2) {
    if (a.split == nullptr || (uintptr_t)a.split % 16 != 0)
      return cudaErrorInvalidValue;
    const long long q_rows = (long long)a.B * a.Hq * a.Sq;
    const long long kv_rows = (long long)a.B * a.Hkv * a.Sk;
    const long long blocks = (q_rows + kv_rows + 7) / 8;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    bf16* qs = a.split;
    bf16* ks = qs + q_rows * 2 * D;
    bf16* vs = ks + kv_rows * 2 * D;
    flash_fwd_prep_f32<<<(unsigned)blocks, 256, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), qs, ks, vs, q_rows, kv_rows, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    tq = qs;
    tk = ks;
    tv = vs;
  }
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!encode_heads(&mq, enc, tq, TL::W, a.Sq, a.B * a.Hq) ||
      !encode_heads(&mk, enc, tk, TL::W, a.Sk, a.B * a.Hkv) ||
      !encode_heads(&mv, enc, tv, TL::W, a.Sk, a.B * a.Hkv))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma<D, NWG, NP>;
  static int sms[32] = {0};   // a device's SMs, once its attribute is set
  if (sms[pa.device] == 0) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TL::smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[pa.device],
                                 cudaDevAttrMultiProcessorCount, pa.device);
    if (e != cudaSuccess) return e;
  }
  const long long bhs = (long long)a.B * a.Hq;
  const long long n_qt = (a.Sq + TL::BM - 1) / TL::BM;
  if (bhs * n_qt > 0x7fffffffLL) return cudaErrorInvalidValue;
  // persistent: as many blocks as fit the card at once, fewer when there
  // are fewer work items
  const long long fit = (long long)sms[pa.device] * TL::kSmBlocks;
  const unsigned grid = (unsigned)(bhs * n_qt < fit ? bhs * n_qt : fit);
  kern<<<grid, TL::kThreads, TL::smem, a.stream>>>(
      mq, mk, mv, static_cast<T*>(a.o), a.lse, a.Hq, a.Hkv, a.Sq, a.Sk,
      a.causal, a.window, a.scale * kLog2e, (int)bhs, (int)n_qt);
  return cudaGetLastError();
}

// The kernels, as flash_attention_fwd_kernel numbers them (and
// flash_attention_fwd_launch's `kernel`, that number + 1, asks for one):
// FMA (float32), mma.sync (bfloat16), wgmma with 64- and 128-row blocks
constexpr int kFma = 0, kMma = 1, kWg64 = 2, kWg128 = 3;

int default_kernel(int dtype, int d, int B, int Hq, int Sq) {
  if (!wgmma_call(dtype, d)) return dtype == kF32 ? kFma : kMma;
  return wgmma_block_rows((long long)B * Hq, Sq, wgmma_width(dtype, d)) == 128
             ? kWg128
             : kWg64;
}

// Whether `kernel` runs a (dtype, d) call: the first version of each dtype
// (FMA, mma.sync) at every head dim, which chip_profile.py and the card
// tests time and hold beside the wgmma kernels, and those where
// wgmma_call says
bool kernel_runs(int kernel, int dtype, int d) {
  switch (kernel) {
    case kFma: return dtype == kF32;
    case kMma: return dtype == kBf16;
    case kWg64:
    case kWg128: return wgmma_call(dtype, d);
    default: return false;
  }
}

template <int D, int NP>
cudaError_t launch_wgmma_rows(int kernel, const Args& a) {
  return kernel == kWg64 ? launch_wgmma<D, 1, NP>(a)
                         : launch_wgmma<D, 2, NP>(a);
}

cudaError_t launch_kernel(int kernel, int dtype, int d, const Args& a) {
  if (kernel == kFma) return launch_f32(d, a);
  // bfloat16: 16-byte cp.async rows and TMA need 16-byte aligned bases;
  // float32 on the wgmma kernels: 8-byte output stores (the prep kernel
  // reads q, k and v a float at a time)
  if (dtype == kBf16 &&
      ((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.o) %
              16 != 0)
    return cudaErrorMisalignedAddress;
  if (dtype == kF32 && (uintptr_t)a.o % 8 != 0)
    return cudaErrorMisalignedAddress;
  if (kernel == kMma) {
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
  if (dtype == kF32)
    return d == 64 ? launch_wgmma_rows<64, 2>(kernel, a)
                   : launch_wgmma_rows<128, 2>(kernel, a);
  switch (d) {
    case 64: return launch_wgmma_rows<64, 1>(kernel, a);
    case 128: return launch_wgmma_rows<128, 1>(kernel, a);
    default: return launch_wgmma_rows<256, 1>(kernel, a);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: null, or float32 (B, Hq, Sq) that
// receives each row's log-sum-exp of its scaled scores (+inf on a row that
// sees no key), for the backward; out is the same bits either way.
// kernel: 0 = the one flash_attention_fwd_kernel names for these shapes,
// else that number + 1 (1 FMA, float32; 2 mma.sync, bfloat16; 3 and 4 the
// wgmma kernel with 64- and 128-row blocks, where flash_attention_fwd_route
// names TMA + wgmma): a given kernel, to time one against another. split:
// bfloat16 scratch of 2 B (Hq Sq + 2 Hkv Sk) d for float32 on the wgmma
// kernels (q, k and v's parts), else unused (may be null). Returns a
// cudaError_t code (0 = ok).
extern "C" int flash_attention_fwd_launch(int dtype, int kernel,
                                          const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          void* split, int B, int Hq,
                                          int Hkv, int Sq, int Sk, int d,
                                          int causal, int window, float scale,
                                          void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      (long long)B * Hq > 65535 || (dtype != kF32 && dtype != kBf16))
    return (int)cudaErrorInvalidValue;
  const int kern =
      kernel == 0 ? default_kernel(dtype, d, B, Hq, Sq) : kernel - 1;
  if (!kernel_runs(kern, dtype, d)) return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,      o,     lse, static_cast<bf16*>(split),
               B,  Hq, Hkv,    Sq,    Sk,  causal,
               window, scale, static_cast<cudaStream_t>(stream)};
  return (int)launch_kernel(kern, dtype, d, a);
}

// The route a (dtype, d) call takes: 0 FMA, 1 mma.sync, 2 TMA + wgmma
// (bfloat16), 3 TMA + wgmma on 3xBF16 (float32); -1 for an unknown dtype.
extern "C" int flash_attention_fwd_route(int dtype, int d) {
  if (dtype != kF32 && dtype != kBf16) return -1;
  if (wgmma_call(dtype, d)) return dtype == kF32 ? 3 : 2;
  return dtype == kF32 ? 0 : 1;
}

// The kernel a call at these shapes runs by default: 0 FMA, 1 mma.sync, 2
// and 3 wgmma with 64- and 128-row blocks; -1 for an unknown dtype.
extern "C" int flash_attention_fwd_kernel(int dtype, int d, int B, int Hq,
                                          int Sq) {
  if (dtype != kF32 && dtype != kBf16) return -1;
  return default_kernel(dtype, d, B, Hq, Sq);
}

// The wgmma kernel's plan for query tile qt of `rows` rows against key
// tiles of `keys` keys, as the kernel computes it (key_tiles, edge_tile):
// *kt_begin and *kt_end bound the key tiles the tile's rows see; bit t of
// *edges (t < 64) is set when tile kt_begin + t crosses a mask edge.
extern "C" void flash_attention_fwd_plan(int Sq, int Sk, int causal,
                                         int window, int rows, int keys,
                                         int qt, int* kt_begin, int* kt_end,
                                         unsigned long long* edges) {
  const int off = Sk - Sq, q_lo = qt * rows;
  key_tiles(q_lo, imin(q_lo + rows, Sq) - 1, Sk, off, causal, window, keys,
            kt_begin, kt_end);
  *edges = 0;
  for (int t = *kt_begin; t < *kt_end && t - *kt_begin < 64; ++t)
    if (edge_tile(q_lo, rows, t * keys, keys, Sk, off, causal, window))
      *edges |= 1ull << (t - *kt_begin);
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
