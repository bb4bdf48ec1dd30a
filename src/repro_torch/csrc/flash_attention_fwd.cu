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
// heads of 128 the two bounds are 2.5 and 1.6 us in bf16). This first
// version uses plain f32 FMA from shared memory (no tensor cores), so it
// runs far from both; wgmma with TMA-fed tiles is later work.
//
// What the design does:
//   * grid (ceil(Sq/BQ), B*Hq): one block per query tile, the KV loop runs
//     inside the block (on the TPU the KV grid axis ran in order; here
//     blocks run in parallel, so the loop carries m, l, acc in registers);
//   * Q, K and V tiles sit in shared memory in f32 (rows padded by one
//     float to dodge bank conflicts); each of the 128 threads owns a
//     (BQ/16 x BK/8) patch of scores and a (BQ/16 x d/8) patch of the
//     output accumulator;
//   * KV tiles entirely in the future (causal with the Sk - Sq offset) or
//     entirely outside the window are never loaded;
//   * ragged edges are masked in the kernel, so Sq and Sk need not tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 16 row groups x 8 column lanes
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
    T* __restrict__ o, int Hq, int Hkv, int Sq, int Sk, int causal, int window,
    float scale) {
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
    }
  }
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch_tile(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hkv, int Sq, int Sk, int causal,
                        int window, float scale, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Sk, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(int d, const void* q, const void* k, const void* v,
                         void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                         int causal, int window, float scale,
                         cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_tile<T, 16, 64, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk,
                                        causal, window, scale, stream);
    case 32:
      return launch_tile<T, 32, 64, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk,
                                        causal, window, scale, stream);
    case 64:
      return launch_tile<T, 64, 64, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk,
                                        causal, window, scale, stream);
    case 128:
      return launch_tile<T, 128, 64, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk,
                                         causal, window, scale, stream);
    case 256:
      return launch_tile<T, 256, 32, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk,
                                         causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code (0 = ok).
extern "C" int flash_attention_fwd_launch(int dtype, const void* q,
                                          const void* k, const void* v,
                                          void* o, int B, int Hq, int Hkv,
                                          int Sq, int Sk, int d, int causal,
                                          int window, float scale,
                                          void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_typed<float>(d, q, k, v, o, B, Hq, Hkv, Sq, Sk, causal,
                                    window, scale, s);
  if (dtype == 1)
    return (int)launch_typed<__nv_bfloat16>(d, q, k, v, o, B, Hq, Hkv, Sq, Sk,
                                            causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
