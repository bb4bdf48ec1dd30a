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
// Two kernels, chosen by dtype:
//
// bfloat16 runs on the tensor cores, FlashAttention-2 style, with
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
// The scores are f32 sums of exact bf16 products, as in the reference.
// This is the step that puts K2 on the tensor cores at all; wgmma with a
// warp-specialised ping-pong of softmax and products (the FlashAttention-3
// shape) is later work.
//
// float32 keeps plain FMA (tensor cores would mean TF32, outside the f32
// tolerance): grid (ceil(Sq/BQ), B*Hq), Q, K and V tiles in shared memory
// as f32 (rows padded by one float), each of the 128 threads owning a
// (BQ/16 x BK/8) patch of scores and a (BQ/16 x d/8) patch of the output.
//
// Both: KV tiles entirely in the future (causal with the Sk - Sq offset)
// or entirely outside the window are never loaded; ragged Sq and Sk are
// masked in the kernel; head dims 16, 32, 64, 80 (stablelm-3b), 128 and
// 256, one instantiation each (a dispatch case per head dim, not any
// multiple of 16). At d 80 the bf16 kernel runs 5 k-steps of m16n8k16 for
// Q K^T and 10 n8 tiles for P V; a shared row is 88 elements (176 bytes,
// 11 16-byte chunks), so the 8 rows an ldmatrix reads start at 176 r mod
// 128 = {0, 48, 96, 16, 64, 112, 32, 80}: distinct 16-byte bank groups, no
// conflict, with no swizzle to get wrong; global rows stay 160 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ bool visible(int kc, int qr, int Sk, int off,
                                        int causal, int window) {
  bool ok = kc < Sk;
  if (causal) ok = ok && kc <= qr + off;
  if (window > 0) ok = ok && kc > qr + off - window;
  return ok;
}

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
        s[i][j] = visible(kc, qr, Sk, off, causal, window) ? s[i][j] * scale
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
        const float p = visible(kc, qr, Sk, off, causal, window)
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
cudaError_t launch_tile(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                        int causal, int window, float scale,
                        cudaStream_t stream) {
  const size_t smem = Tile<D, BQ, BK>::smem_bytes;
  auto kern = flash_fwd_kernel<T, D, BQ, BK>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hkv, Sq, Sk,
      causal, window, scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(int d, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int Hq, int Hkv, int Sq,
                       int Sk, int causal, int window, float scale,
                       cudaStream_t stream) {
  using T = float;
  switch (d) {
    case 16:
      return launch_tile<T, 16, 64, 64>(
          q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, window, scale, stream);
    case 32:
      return launch_tile<T, 32, 64, 64>(
          q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, window, scale, stream);
    case 64:
      return launch_tile<T, 64, 64, 64>(
          q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, window, scale, stream);
    case 80:
      return launch_tile<T, 80, 64, 64>(
          q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, window, scale, stream);
    case 128:
      return launch_tile<T, 128, 64, 64>(
          q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, window, scale, stream);
    case 256:
      return launch_tile<T, 256, 32, 32>(
          q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
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
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = MmaTile<D>::smem_bytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_qt = (Sq + kMmaBQ - 1) / kMmaBQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  dim3 grid(B * Hq, n_qt);
  flash_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, Hq, Hkv, Sq, Sk, causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t launch_bf16(int d, const void* q, const void* k, const void* v,
                        void* o, float* lse, int B, int Hq, int Hkv, int Sq,
                        int Sk, int causal, int window, float scale,
                        cudaStream_t stream) {
  // 16-byte cp.async rows need 16-byte aligned bases
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return cudaErrorMisalignedAddress;
  switch (d) {
    case 16:
      return launch_mma<16>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal,
                            window, scale, stream);
    case 32:
      return launch_mma<32>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal,
                            window, scale, stream);
    case 64:
      return launch_mma<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal,
                            window, scale, stream);
    case 80:
      return launch_mma<80>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal,
                            window, scale, stream);
    case 128:
      return launch_mma<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal,
                             window, scale, stream);
    case 256:
      return launch_mma<256>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal,
                             window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: null, or float32 (B, Hq, Sq) that
// receives each row's log-sum-exp of its scaled scores (+inf on a row that
// sees no key), for the backward; out is the same bits either way.
// Returns a cudaError_t code (0 = ok).
extern "C" int flash_attention_fwd_launch(int dtype, const void* q,
                                          const void* k, const void* v,
                                          void* o, float* lse, int B, int Hq,
                                          int Hkv, int Sq, int Sk, int d,
                                          int causal, int window, float scale,
                                          void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_f32(d, q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal,
                           window, scale, s);
  if (dtype == 1)
    return (int)launch_bf16(d, q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal,
                            window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
