// Paged-attention decode for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention/kernel.py:paged_attention_pallas
//           (body _pa_kernel), the Pallas TPU kernel of one decode tick.
//
// What it computes: for slot b and kv head h, the query group
// q[b, h*g:(h+1)*g, :] (g = Hq / n_kv) attends over the slot's KV history,
// which lives in pages of a global pool (n_kv, n_pages, page_size, hd)
// addressed through the page table row table[b, :]. Keys at positions
// < lengths[b] (and > lengths[b]-1-window with a window) count. Softmax is
// online across pages in f32; the output is acc / max(l, 1e-30).
//
// What bounds it on the H100: bytes. Each live K and V position is read
// once and used for g (3 for llama3.2-3b) dot products of length hd, so the
// work is ~2*g flops per byte -- far below the ~295 flop/byte ridge of the
// card. The least time is (bytes of live K+V pages) / 3.35 TB/s.
//
// What the design does about it:
//   * one block per (kv head, slot, split): K/V pages are read once per kv
//     head and never replicated per q head (GQA). A slot's live tiles are
//     cut into n_split contiguous ranges (split-K), so a decode batch of
//     B x n_kv = 64 (llama3.2-3b, 8 slots) still fills the 132 SMs with
//     several blocks each; a second small kernel merges the splits'
//     (max, denominator, accumulator) triples. With one split the main
//     kernel writes the output itself;
//   * the block loads its own table row and length (no scalar prefetch)
//     and walks ONLY the live pages -- ceil(len/ps) of them, starting at the
//     first page inside the window -- so dead pages are neither computed
//     nor loaded (the load elision the Pallas kernel left undone);
//   * a page is staged through shared memory in tiles of 2048 elements (16
//     tokens at hd=128) with 16-byte loads; the next tile's loads are issued
//     into registers before this tile is computed (and its page id one tile
//     earlier still), so one memory round trip per tile is overlapped;
//   * the group size g is a template parameter (exact for 1, 2, 3, 4 and 8;
//     bounded by 16 otherwise), so the per-row loops unroll to exactly g;
//   * scores: TT tokens x (128/TT) threads per token, each thread a strided
//     slice of the head dim, reduced with shuffles inside the token's lanes;
//   * page ids are clamped to [0, n_pages-1]; positions outside
//     [window start, length) are never loaded (zeros are staged instead)
//     and are excluded from the softmax by selection, never by an additive
//     bias, so garbage in dead positions cannot reach the output.
// cp.async/TMA staging and tensor-core group products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;                 // q heads per kv head
constexpr int kMaxHeadDim = 256;
constexpr int kColsPerThread = kMaxHeadDim / kThreads;
constexpr int kTileElems = 2048;              // K (and V) elements per tile
constexpr int kBlocksPerSm = 4;               // split-K target occupancy
constexpr int kMinTilesPerSplit = 4;
constexpr int kMaxSplits = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of T -> 16 / sizeof(T) floats
__device__ __forceinline__ void unpack(const uint4& r, float* f,
                                       const float*) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* f,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = __bfloat1622float2(h[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// tokens per staged tile for head dim hd and page size ps
__host__ __device__ __forceinline__ int tile_tokens(int ps, int hd) {
  const int tt = kTileElems / hd;
  return ps < tt ? ps : tt;
}

// threads that share one token's dot products (a power of two <= 32)
__host__ __device__ __forceinline__ int threads_per_token(int tt) {
  int tpt = 1;
  while (tpt * 2 * tt <= kThreads && tpt < 32) tpt *= 2;
  return tpt;
}

// padded row stride of the staged keys: == tpt (mod 32), so the lanes of
// one warp (tokens x slices) hit distinct banks
__host__ __device__ __forceinline__ int key_stride(int hd, int tpt) {
  return hd + ((tpt - hd % 32) % 32 + 32) % 32;
}

__host__ __device__ __forceinline__ size_t smem_floats(int G, int ps,
                                                       int hd) {
  const int tt = tile_tokens(ps, hd);
  const int hs = key_stride(hd, threads_per_token(tt));
  return (size_t)tt * hd + (size_t)G * hd + (size_t)tt * hs +
         (size_t)G * tt + 3 * (size_t)G;
}

// G: the group size when kExact, else its upper bound (runtime g <= G).
// With n_split > 1 the block writes its split's unnormalised accumulator
// and (max, denominator) to part_acc / part_ml instead of the output.
template <typename T, int G, bool kExact>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ table,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int Hq,
    int n_kv, int n_pages, int ps, int hd, int mp, int window, float scale,
    int n_split) {
  constexpr int VE = 16 / sizeof(T);            // elements per 16-byte load
  constexpr int VPT = kTileElems / VE / kThreads;  // loads per thread, per tile
  const int h = blockIdx.x;   // kv head
  const int b = blockIdx.y;   // slot
  const int split = blockIdx.z;
  const int g = kExact ? G : Hq / n_kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sh = __ffs(hd) - 1;                // hd is a power of two
  const int TT = tile_tokens(ps, hd);
  const int tpp = (ps + TT - 1) / TT;          // tiles per page
  const int tpt = threads_per_token(TT);
  const int hs = key_stride(hd, tpt);
  const int my_t = tid / tpt;                  // scores: my token ...
  const int my_s = tid % tpt;                  // ... and my head-dim slice

  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);  // (TT, hd) staged values
  float* qs = vs + TT * hd;     // (G, hd)  query group in f32
  float* ks = qs + G * hd;      // (TT, hs) staged keys
  float* ss = ks + TT * hs;     // (G, TT)  scores, then probabilities
  float* m_s = ss + G * TT;     // (G,) running max
  float* l_s = m_s + G;         // (G,) running denominator
  float* a_s = l_s + G;         // (G,) rescale factor of the current tile

  const int length = lengths[b];
  const T* qb = q + ((size_t)b * Hq + (size_t)h * g) * hd;
  for (int e = tid; e < g * hd; e += kThreads) qs[e] = to_f32(qb[e]);
  for (int i = tid; i < G; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  float acc[G][kColsPerThread];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[i][c] = 0.f;

  // live key columns are [lo, hi): walk only the tiles that hold them,
  // and of those only this split's contiguous share
  const int lo = window > 0 ? max(0, length - window) : 0;
  const int hi = min(length, mp * ps);
  int j_begin = 0, j_end = 0;
  if (hi > lo) {
    j_begin = (lo / ps) * tpp + (lo % ps) / TT;
    j_end = ((hi - 1) / ps) * tpp + ((hi - 1) % ps) / TT + 1;
    const int chunk = (j_end - j_begin + n_split - 1) / n_split;
    j_begin += split * chunk;
    j_end = min(j_end, j_begin + chunk);
  }
  auto page_id = [&](int j) {
    return min(max(table[(size_t)b * mp + j / tpp], 0), n_pages - 1);
  };

  // raw K/V of one tile, 16 bytes per load, held in registers until staged
  uint4 kr[VPT], vr[VPT];
  auto load_tile = [&](int j, int page) {
    const int t0 = (j % tpp) * TT;
    const int nt = min(TT, ps - t0);
    const int col0 = (j / tpp) * ps + t0;
    const size_t base = (((size_t)h * n_pages + page) * ps + t0) * hd;
    const uint4* kp = reinterpret_cast<const uint4*>(k_pages + base);
    const uint4* vp = reinterpret_cast<const uint4*>(v_pages + base);
#pragma unroll
    for (int u = 0; u < VPT; ++u) {
      const int ev = tid + u * kThreads;
      const int t = (ev * VE) >> sh;
      if (t < nt && col0 + t >= lo && col0 + t < hi) {
        kr[u] = __ldg(kp + ev);
        vr[u] = __ldg(vp + ev);
      }
    }
  };
  auto stage_tile = [&](int j) {
    const int t0 = (j % tpp) * TT;
    const int nt = min(TT, ps - t0);
    const int col0 = (j / tpp) * ps + t0;
#pragma unroll
    for (int u = 0; u < VPT; ++u) {
      const int e = (tid + u * kThreads) * VE;
      const int t = e >> sh, d = e & (hd - 1);
      if (t < nt) {
        float kf[VE], vf[VE];
        if (col0 + t >= lo && col0 + t < hi) {
          unpack(kr[u], kf, static_cast<const T*>(nullptr));
          unpack(vr[u], vf, static_cast<const T*>(nullptr));
        } else {
#pragma unroll
          for (int k = 0; k < VE; ++k) kf[k] = vf[k] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < VE; ++k) ks[t * hs + d + k] = kf[k];
#pragma unroll
        for (int k = 0; k < VE; k += 4)
          *reinterpret_cast<float4*>(vs + t * hd + d + k) =
              make_float4(vf[k], vf[k + 1], vf[k + 2], vf[k + 3]);
      }
    }
  };

  int page_next = 0;   // page id of tile j + 1, loaded one tile early
  if (j_begin < j_end) {
    load_tile(j_begin, page_id(j_begin));
    if (j_begin + 1 < j_end) page_next = page_id(j_begin + 1);
  }
  for (int j = j_begin; j < j_end; ++j) {
    __syncthreads();   // the previous tile is consumed; qs, m, l are set
    stage_tile(j);
    __syncthreads();
    if (j + 1 < j_end) {             // next tile's loads fly during compute
      load_tile(j + 1, page_next);
      if (j + 2 < j_end) page_next = page_id(j + 2);
    }
    const int t0 = (j % tpp) * TT;
    const int nt = min(TT, ps - t0);
    const int col0 = (j / tpp) * ps + t0;

    // scores: tpt threads per token, each a strided slice of the head dim
    {
      float part[G];
#pragma unroll
      for (int i = 0; i < G; ++i) part[i] = 0.f;
      if (my_t < nt) {
        const float* krow = ks + my_t * hs;
#pragma unroll 4
        for (int d = my_s; d < hd; d += tpt) {
          const float kv = krow[d];
#pragma unroll
          for (int i = 0; i < G; ++i)
            if (kExact || i < g) part[i] += qs[i * hd + d] * kv;
        }
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        for (int o = tpt >> 1; o > 0; o >>= 1)
          part[i] += __shfl_xor_sync(0xffffffffu, part[i], o);
      }
      if (my_t < nt && my_s == 0) {
        const int col = col0 + my_t;
        const bool live = col >= lo && col < hi;
#pragma unroll
        for (int i = 0; i < G; ++i)
          if (kExact || i < g)
            ss[i * TT + my_t] = live ? part[i] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per query row, lanes across the tile
    for (int i = warp; i < g; i += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, ss[i * TT + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const int col = col0 + t;
        const bool live = col >= lo && col < hi;
        const float p = live ? expf(ss[i * TT + t] - m_new) : 0.f;
        ss[i * TT + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    // PV: each thread owns head-dim columns tid and tid + kThreads
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int d = tid + c * kThreads;
      if (d < hd) {
#pragma unroll
        for (int i = 0; i < G; ++i)
          if (kExact || i < g) acc[i][c] *= a_s[i];
#pragma unroll 4
        for (int t = 0; t < nt; ++t) {
          const float vv = vs[t * hd + d];
#pragma unroll
          for (int i = 0; i < G; ++i)
            if (kExact || i < g) acc[i][c] += ss[i * TT + t] * vv;
        }
      }
    }
  }
  __syncthreads();

  if (n_split == 1) {
    T* ob = out + ((size_t)b * Hq + (size_t)h * g) * hd;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int d = tid + c * kThreads;
      if (d < hd) {
#pragma unroll
        for (int i = 0; i < G; ++i)
          if (kExact || i < g)
            store_as(&ob[i * hd + d], acc[i][c] / fmaxf(l_s[i], 1e-30f));
      }
    }
    return;
  }
  const size_t row = (((size_t)b * n_kv + h) * n_split + split) * g;
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    const int d = tid + c * kThreads;
    if (d < hd) {
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (kExact || i < g) part_acc[(row + i) * hd + d] = acc[i][c];
    }
  }
  for (int i = tid; i < g; i += kThreads) {
    part_ml[(row + i) * 2] = m_s[i];
    part_ml[(row + i) * 2 + 1] = l_s[i];
  }
}

// Merge the n_split partial softmaxes of each (slot, kv head) row group.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_combine(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ out, int Hq, int n_kv, int hd, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = Hq / n_kv;
  const size_t bh = (size_t)b * n_kv + h;
  for (int e = threadIdx.x; e < g * hd; e += kThreads) {
    const int i = e / hd, d = e % hd;
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s)
      M = fmaxf(M, part_ml[((bh * n_split + s) * g + i) * 2]);
    float L = 0.f, O = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t r = (bh * n_split + s) * g + i;
      const float w = expf(part_ml[r * 2] - M);
      L += w * part_ml[r * 2 + 1];
      O += w * part_acc[r * hd + d];
    }
    store_as(&out[((size_t)b * Hq + (size_t)h * g + i) * hd + d],
             O / fmaxf(L, 1e-30f));
  }
}

template <typename T, int G, bool kExact>
cudaError_t launch_group(const void* q, const void* k, const void* v,
                         const void* table, const void* lengths, void* out,
                         float* part_acc, float* part_ml, int B, int Hq,
                         int n_kv, int n_pages, int ps, int hd, int mp,
                         int window, float scale, int n_split,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(G, ps, hd);
  auto kern = paged_attention_kernel<T, G, kExact>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(n_kv, B, n_split);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), part_acc,
      part_ml, Hq, n_kv, n_pages, ps, hd, mp, window, scale, n_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return e;
  paged_attention_combine<T><<<dim3(n_kv, B), kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), Hq, n_kv, hd, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* table, const void* lengths, void* out,
                         float* part_acc, float* part_ml, int B, int Hq,
                         int n_kv, int n_pages, int ps, int hd, int mp,
                         int window, float scale, int n_split,
                         cudaStream_t stream) {
#define PA_LAUNCH(G, EXACT)                                                 \
  return launch_group<T, G, EXACT>(q, k, v, table, lengths, out, part_acc,  \
                                   part_ml, B, Hq, n_kv, n_pages, ps, hd, mp, \
                                   window, scale, n_split, stream)
  switch (Hq / n_kv) {
    case 1: PA_LAUNCH(1, true);
    case 2: PA_LAUNCH(2, true);
    case 3: PA_LAUNCH(3, true);
    case 4: PA_LAUNCH(4, true);
    case 8: PA_LAUNCH(8, true);
    default: PA_LAUNCH(kMaxGroup, false);
  }
#undef PA_LAUNCH
}

bool is_pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// Split-K factor for a launch: enough (kv head, slot, split) blocks for
// about kBlocksPerSm per SM, but at least kMinTilesPerSplit tiles of the
// longest slot the table can hold per split. Chosen from shapes only, so
// the host never waits on the device's lengths; the caller sizes the
// part_acc / part_ml scratch from it.
extern "C" int paged_attention_num_splits(int B, int n_kv, int mp, int ps,
                                          int hd, int sm_count) {
  if (B <= 0 || n_kv <= 0 || mp <= 0 || ps <= 0 || hd <= 0) return 1;
  const int tt = tile_tokens(ps, hd);
  const long long tiles = (long long)mp * ((ps + tt - 1) / tt);
  const long long blocks = (long long)B * n_kv;
  const long long want = (kBlocksPerSm * (long long)sm_count + blocks - 1) /
                         blocks;
  long long n = want < tiles / kMinTilesPerSplit ? want
                                                 : tiles / kMinTilesPerSplit;
  if (n > kMaxSplits) n = kMaxSplits;
  return n < 1 ? 1 : (int)n;
}

// dtype: 0 = float32, 1 = bfloat16. part_acc (B, n_kv, n_split, g, hd) and
// part_ml (B, n_kv, n_split, g, 2) are float32 scratch, unused when
// n_split == 1. Returns a cudaError_t code (0 = ok).
extern "C" int paged_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, const void* table,
                                      const void* lengths, void* out,
                                      void* part_acc, void* part_ml, int B,
                                      int Hq, int n_kv, int n_pages, int ps,
                                      int hd, int mp, int window, float scale,
                                      int n_split, void* stream) {
  if (B <= 0 || n_kv <= 0 || Hq % n_kv != 0 || Hq / n_kv > kMaxGroup ||
      !is_pow2(hd) || hd < 16 || hd > kMaxHeadDim || ps <= 0 || mp <= 0 ||
      n_pages <= 0 || n_split <= 0 || n_split > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == 0)
    return (int)launch_typed<float>(q, k, v, table, lengths, out, pa, pm, B,
                                    Hq, n_kv, n_pages, ps, hd, mp, window,
                                    scale, n_split, s);
  if (dtype == 1)
    return (int)launch_typed<__nv_bfloat16>(q, k, v, table, lengths, out, pa,
                                            pm, B, Hq, n_kv, n_pages, ps, hd,
                                            mp, window, scale, n_split, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
