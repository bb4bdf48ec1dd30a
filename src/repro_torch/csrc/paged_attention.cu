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
//   * the work is cut by position, not by slot: block (kv head, slot, span)
//     owns the positions [s * span, (s + 1) * span) of its slot, with span
//     = span_pages whole pages chosen from shapes (ops.py:span_pages). A
//     block whose span holds no live position exits at once, so the
//     longest slot is cut as finely as the shortest and the host never
//     reads the lengths. With one span a block writes the output itself;
//     else it writes its (max, denominator, accumulator) triple and a
//     second kernel merges the live spans of each (slot, kv head);
//   * a block loads its own table row and length (no scalar prefetch), walks
//     only the live tiles of its span and clamps page ids to [0,
//     n_pages-1]; positions outside [window start, length) are zero-filled
//     on staging and excluded from the softmax by selection, never by an
//     additive bias, so garbage in dead positions cannot reach the output.
//
// Two kernels, chosen by ops.py:kernel_choice from dtype, group and head
// dim (a pure function of shapes):
//
// "mma", bfloat16 with hd 16, 32, 64, 80 or 128, on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate):
//   * the GQA group (up to 16 query heads) is stacked as the 16 rows of the
//     MMA, padded with zero rows; Q is held in registers as A fragments;
//   * each of the 4 warps owns every fourth 16-token tile of the span, and
//     streams its tiles through its own 3-stage ring of 16-byte cp.async
//     copies, K and V kept in bf16 in shared memory (rows padded by 16
//     bytes, so ldmatrix reads them without bank conflicts): several pages
//     are in flight per warp and no block barrier is paid per tile;
//   * S = Q K^T and O += P V run on the tensor cores; the online softmax
//     stays in registers, each warp with its own (max, denominator,
//     accumulator); P is rounded to bf16 as the plain version rounds it and
//     fed back as the A operand of P V without touching shared memory;
//   * the warps' triples merge once, through shared memory, at the end;
//   * hd 80 (stablelm-3b, MHA: g = 1 fills one of the 16 MMA rows, the
//     others are zero rows whose outputs are never stored) runs 5 k-steps
//     for S and 10 n8 tiles for P V; its 88-element shared rows (176 bytes)
//     put the 8 rows of an ldmatrix on distinct 16-byte bank groups, as the
//     power-of-two dims' rows do. The pool keeps its (n_kv, n_pages, ps,
//     80) layout: 160-byte rows, every 16-byte copy aligned.
//
// "fma", float32 (tensor cores would mean TF32, outside the f32 tolerance)
// and bf16 at hd 256 (its accumulator would not fit the registers):
//   * a tile of 2048 elements (16 tokens at hd=128) is staged through
//     shared memory in f32 with 16-byte loads; the next tile's loads are
//     issued into registers before this tile is computed;
//   * the group size g is a template parameter (exact for 1, 2, 3, 4 and 8;
//     bounded by 16 otherwise), so the per-row loops unroll to exactly g;
//   * scores: TT tokens x (128/TT) threads per token, each thread a strided
//     slice of the head dim, reduced with shuffles inside the token's lanes;
//   * any head dim of HEAD_DIMS: a 16-byte load's token and column come
//     from a division by hd, so 80 is staged like the powers of two.
//
// Head dims: 16, 32, 64, 80, 128 and 256 (head_dim_ok; ops.py:HEAD_DIMS).

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
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// The live positions of span s of a slot: [lo, hi) of the slot (window
// start, length) cut to the span's [s * span_tok, (s + 1) * span_tok).
struct Span {
  int lo, hi;
  __device__ __forceinline__ Span(int length, int window, int ps, int mp,
                                  int span_tok, int s) {
    const int slo = window > 0 ? max(0, length - window) : 0;
    const int shi = min(length, mp * ps);
    lo = max(slo, s * span_tok);
    hi = min(shi, (s + 1) * span_tok);
  }
  __device__ __forceinline__ bool empty() const { return hi <= lo; }
  // [first, last + 1) of the tiles of tt tokens (tpp a page) it touches
  __device__ __forceinline__ int first_tile(int ps, int tt, int tpp) const {
    return (lo / ps) * tpp + (lo % ps) / tt;
  }
  __device__ __forceinline__ int end_tile(int ps, int tt, int tpp) const {
    return ((hi - 1) / ps) * tpp + ((hi - 1) % ps) / tt + 1;
  }
};

// ---------------------------------------------------------------------------
// "fma": float32, and bfloat16 at hd 256
// ---------------------------------------------------------------------------

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
// With n_spans > 1 the block writes its span's unnormalised accumulator
// and (max in log2 units, denominator) to part_acc / part_ml instead of
// the output.
template <typename T, int G, bool kExact>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ table,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int Hq,
    int n_kv, int n_pages, int ps, int hd, int mp, int window, float scale,
    int span_pages, int n_spans) {
  constexpr int VE = 16 / sizeof(T);            // elements per 16-byte load
  constexpr int VPT = kTileElems / VE / kThreads;  // loads per thread, per tile
  const int h = blockIdx.x;   // kv head
  const int b = blockIdx.y;   // slot
  const int span = blockIdx.z;
  const int g = kExact ? G : Hq / n_kv;
  const Span sp(lengths[b], window, ps, mp, span_pages * ps, span);
  if (sp.empty() && n_spans > 1) return;       // past the live range
  const int lo = sp.lo, hi = sp.hi;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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

  // live key columns are [lo, hi): walk only the tiles that hold them
  int j_begin = 0, j_end = 0;
  if (!sp.empty()) {
    j_begin = sp.first_tile(ps, TT, tpp);
    j_end = sp.end_tile(ps, TT, tpp);
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
      const int t = (ev * VE) / hd;
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
      const int t = e / hd, d = e - t * hd;
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

  if (n_spans == 1) {
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
  const size_t row = (((size_t)b * n_kv + h) * n_spans + span) * g;
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
    part_ml[(row + i) * 2] = m_s[i] * kLog2e;
    part_ml[(row + i) * 2 + 1] = l_s[i];
  }
}

// ---------------------------------------------------------------------------
// "mma": bfloat16 on the tensor cores (mma.sync.m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kTok = 16;      // tokens of one staged tile: one k16 step of P V
constexpr int kRing = 3;      // stages of each warp's ring

template <int D>
struct MmaTile {
  static constexpr int ST = D + 8;                  // row stride: +16 bytes
  static constexpr int stage = 2 * kTok * ST;       // K then V, bf16
  static constexpr size_t q_bytes = 2 * 16 * (size_t)ST;
  static constexpr size_t ring_bytes = 2 * (size_t)kMmaWarps * kRing * stage;
  // the warps' (accumulator, max, denominator) of 16 rows, in f32
  static constexpr size_t merge_bytes = 4 * (size_t)kMmaWarps * 16 * (D + 2);
  static constexpr size_t smem_bytes =
      q_bytes + (ring_bytes > merge_bytes ? ring_bytes : merge_bytes);
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

template <int D>
__global__ void __launch_bounds__(kMmaThreads) paged_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ table,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int Hq,
    int n_kv, int n_pages, int ps, int mp, int window, float scale_log2,
    int span_pages, int n_spans) {
  using TL = MmaTile<D>;
  constexpr int ST = TL::ST, ND = D / 8, KS = D / 16, CPR = D / 8;
  extern __shared__ __align__(16) unsigned char pa_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(pa_smem);
  __nv_bfloat16* ring = Qs + 16 * ST;

  const int h = blockIdx.x, b = blockIdx.y, span = blockIdx.z;
  const int g = Hq / n_kv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Span sp(lengths[b], window, ps, mp, span_pages * ps, span);
  if (sp.empty() && n_spans > 1) return;       // past the live range
  const int tpp = (ps + kTok - 1) / kTok;      // tiles a page
  int u_begin = 0, u_end = 0;
  if (!sp.empty()) {
    u_begin = sp.first_tile(ps, kTok, tpp);
    u_end = sp.end_tile(ps, kTok, tpp);
  }

  // the query group as the 16 rows of the MMA, zero past g
  const __nv_bfloat16* qb = q + ((size_t)b * Hq + (size_t)h * g) * D;
  for (int e = tid; e < 16 * CPR; e += kMmaThreads) {
    const int r = e / CPR, c = (e % CPR) * 8;
    *reinterpret_cast<uint4*>(Qs + r * ST + c) =
        r < g ? *reinterpret_cast<const uint4*>(qb + r * D + c)
              : make_uint4(0, 0, 0, 0);
  }

  // this warp's tiles: u_begin + warp + kMmaWarps * k, k < my_n
  __nv_bfloat16* wring = ring + warp * kRing * TL::stage;
  const int my_n = u_end - u_begin > warp
                       ? (u_end - u_begin - warp + kMmaWarps - 1) / kMmaWarps
                       : 0;
  auto load = [&](int k) {
    const int u = u_begin + warp + kMmaWarps * k;
    const int pj = u / tpp, off = (u % tpp) * kTok;
    const int page = min(max(table[(size_t)b * mp + pj], 0), n_pages - 1);
    const size_t base = (((size_t)h * n_pages + page) * ps + off) * D;
    __nv_bfloat16* Ks = wring + (k % kRing) * TL::stage;
    __nv_bfloat16* Vs = Ks + kTok * ST;
    const int pos0 = pj * ps + off;
#pragma unroll
    for (int e = lane; e < kTok * CPR; e += 32) {
      const int r = e / CPR, c = (e % CPR) * 8;
      const bool in = off + r < ps && pos0 + r >= sp.lo && pos0 + r < sp.hi;
      const size_t src = base + (size_t)r * D + c;
      cp_async16(smem_u32(Ks + r * ST + c), in ? k_pages + src : k_pages,
                 in ? 16 : 0);
      cp_async16(smem_u32(Vs + r * ST + c), in ? v_pages + src : v_pages,
                 in ? 16 : 0);
    }
  };
#pragma unroll
  for (int k = 0; k < kRing; ++k) {
    if (k < my_n) load(k);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  __syncthreads();                             // Qs is staged
  uint32_t qf[KS][4];
  const uint32_t q_row = smem_u32(Qs + (lane % 16) * ST + 8 * (lane / 16));
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qf[ks], q_row + ks * 32);

  // lanes 8i..8i+7 address matrix i of an ldmatrix.x4: K as (n-block i/2,
  // k half i%2), V transposed as (k half i%2, n-block i/2)
  const uint32_t k_off =
      ((8 * (lane / 16) + lane % 8) * ST + 8 * ((lane / 8) % 2)) * 2;
  const uint32_t v_off =
      ((lane % 8 + 8 * ((lane / 8) % 2)) * ST + 8 * (lane / 16)) * 2;
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {neg_inf(), neg_inf()};
  float l_r[2] = {0.f, 0.f};

  for (int k = 0; k < my_n; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
    __syncwarp();
    const __nv_bfloat16* Ks = wring + (k % kRing) * TL::stage;
    const uint32_t kb = smem_u32(Ks) + k_off;
    const uint32_t vb = smem_u32(Ks + kTok * ST) + v_off;

    // S = Q K^T: 16 group rows x 16 tokens
    float s[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bf[4];
      ldmatrix_x4(bf, kb + ks * 32);
      mma_bf16(s[0], qf[ks], bf[0], bf[1]);
      mma_bf16(s[1], qf[ks], bf[2], bf[3]);
    }

    // element e of s[j] is row lane/4 + 8 (e / 2), token 8 j + 2 (lane % 4)
    // + e % 2 of the tile; dead tokens are selected away
    const int u = u_begin + warp + kMmaWarps * k;
    const int off = (u % tpp) * kTok;
    const int pos0 = (u / tpp) * ps + off;
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * (lane % 4) + (e & 1);
        const bool live =
            off + col < ps && pos0 + col >= sp.lo && pos0 + col < sp.hi;
        const float x = live ? s[j][e] * scale_log2 : neg_inf();
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      m_use[i] = m_new == neg_inf() ? 0.f : m_new;   // nothing live yet
      const float alpha = exp2f(m_r[i] - m_use[i]);
      m_r[i] = m_new;
      l_r[i] *= alpha;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * i] *= alpha;
        acc[j][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[j][e] == neg_inf() ? 0.f
                                             : exp2f(s[j][e] - m_use[e >> 1]);
        s[j][e] = p;
        l_r[e >> 1] += p;
      }

    // O += P V: P's accumulator fragments are the A fragment of the product
    const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]),
                           pack_bf16(s[0][2], s[0][3]),
                           pack_bf16(s[1][0], s[1][1]),
                           pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < ND; j += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, vb + j * 16);
      mma_bf16(acc[j], a, bf[0], bf[1]);
      mma_bf16(acc[j + 1], a, bf[2], bf[3]);
    }
    __syncwarp();                              // the stage is consumed
    if (k + kRing < my_n) load(k + kRing);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // merge the warps' triples through shared memory (the ring is free)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  __syncthreads();
  float* macc = reinterpret_cast<float*>(ring);   // (warps, 16, D)
  float* mm = macc + kMmaWarps * 16 * D;          // (warps, 16)
  float* ml = mm + kMmaWarps * 16;                // (warps, 16)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = lane / 4 + 8 * i;
    if (lane % 4 == 0) {
      mm[warp * 16 + r] = m_r[i];
      ml[warp * 16 + r] = l_r[i];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<float2*>(macc + (warp * 16 + r) * D + 8 * j +
                                 2 * (lane % 4)) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
  }
  __syncthreads();
  const size_t row = (((size_t)b * n_kv + h) * n_spans + span) * g;
  for (int e = tid; e < g * D; e += kMmaThreads) {
    const int i = e / D, d = e % D;
    float M = neg_inf();
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) M = fmaxf(M, mm[w * 16 + i]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float mw = mm[w * 16 + i];
      const float wt = mw == neg_inf() ? 0.f : exp2f(mw - M);
      L += wt * ml[w * 16 + i];
      O += wt * macc[(w * 16 + i) * D + d];
    }
    if (n_spans == 1) {
      out[((size_t)b * Hq + (size_t)h * g + i) * D + d] =
          __float2bfloat16(O / fmaxf(L, 1e-30f));
    } else {
      part_acc[(row + i) * D + d] = O;
      if (d == 0) {
        part_ml[(row + i) * 2] = M;
        part_ml[(row + i) * 2 + 1] = L;
      }
    }
  }
}

// Merge the live spans' partial softmaxes of each (slot, kv head) row
// group (maxima in log2 units), in one online pass: a thread owns 4
// columns of one row. A slot with no live position gets zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_combine(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, T* __restrict__ out, int Hq, int n_kv,
    int hd, int ps, int mp, int window, int span_pages, int n_spans) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = Hq / n_kv;
  const size_t bh = (size_t)b * n_kv + h;
  const int span_tok = span_pages * ps;
  const Span all(lengths[b], window, ps, mp, mp * ps, 0);
  const int s0 = all.lo / span_tok;
  const int s1 = all.empty() ? s0 - 1 : (all.hi - 1) / span_tok;
  const int q4 = hd / 4;
  for (int e = threadIdx.x; e < g * q4; e += kThreads) {
    const int i = e / q4, d = 4 * (e % q4);
    float M = neg_inf(), L = 0.f;
    float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = s0; s <= s1; ++s) {
      const size_t r = (bh * n_spans + s) * g + i;
      const float2 ml = *reinterpret_cast<const float2*>(part_ml + r * 2);
      const float4 a = *reinterpret_cast<const float4*>(part_acc + r * hd + d);
      const float m_new = fmaxf(M, ml.x);
      const float c = exp2f(M - m_new), w = exp2f(ml.x - m_new);
      L = L * c + w * ml.y;
      O.x = O.x * c + w * a.x;
      O.y = O.y * c + w * a.y;
      O.z = O.z * c + w * a.z;
      O.w = O.w * c + w * a.w;
      M = m_new;
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    T* o = out + ((size_t)b * Hq + (size_t)h * g + i) * hd + d;
    store_as(o, O.x * inv);
    store_as(o + 1, O.y * inv);
    store_as(o + 2, O.z * inv);
    store_as(o + 3, O.w * inv);
  }
}

template <typename T>
cudaError_t launch_combine(const float* part_acc, const float* part_ml,
                           const void* lengths, void* out, int B, int Hq,
                           int n_kv, int hd, int ps, int mp, int window,
                           int span_pages, int n_spans, cudaStream_t stream) {
  if (n_spans == 1) return cudaSuccess;
  paged_attention_combine<T><<<dim3(n_kv, B), kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<const int*>(lengths),
      static_cast<T*>(out), Hq, n_kv, hd, ps, mp, window, span_pages,
      n_spans);
  return cudaGetLastError();
}

template <typename T, int G, bool kExact>
cudaError_t launch_group(const void* q, const void* k, const void* v,
                         const void* table, const void* lengths, void* out,
                         float* part_acc, float* part_ml, int B, int Hq,
                         int n_kv, int n_pages, int ps, int hd, int mp,
                         int window, float scale, int span_pages,
                         int n_spans, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(G, ps, hd);
  auto kern = paged_attention_kernel<T, G, kExact>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(n_kv, B, n_spans);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), part_acc,
      part_ml, Hq, n_kv, n_pages, ps, hd, mp, window, scale, span_pages,
      n_spans);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_combine<T>(part_acc, part_ml, lengths, out, B, Hq, n_kv, hd,
                           ps, mp, window, span_pages, n_spans, stream);
}

template <typename T>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const void* table, const void* lengths, void* out,
                       float* part_acc, float* part_ml, int B, int Hq,
                       int n_kv, int n_pages, int ps, int hd, int mp,
                       int window, float scale, int span_pages, int n_spans,
                       cudaStream_t stream) {
#define PA_LAUNCH(G, EXACT)                                                 \
  return launch_group<T, G, EXACT>(q, k, v, table, lengths, out, part_acc,  \
                                   part_ml, B, Hq, n_kv, n_pages, ps, hd, mp, \
                                   window, scale, span_pages, n_spans, stream)
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

template <int D>
cudaError_t launch_mma_d(const void* q, const void* k, const void* v,
                         const void* table, const void* lengths, void* out,
                         float* part_acc, float* part_ml, int B, int Hq,
                         int n_kv, int n_pages, int ps, int mp, int window,
                         float scale, int span_pages, int n_spans,
                         cudaStream_t stream) {
  constexpr size_t smem = MmaTile<D>::smem_bytes;
  static bool attr_set = false;
  if (!attr_set) {
    // the most shared memory an SM can carve out, so two blocks fit
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(paged_attention_mma_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  using bf16 = __nv_bfloat16;
  paged_attention_mma_kernel<D>
      <<<dim3(n_kv, B, n_spans), kMmaThreads, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const int*>(table),
          static_cast<const int*>(lengths), static_cast<bf16*>(out),
          part_acc, part_ml, Hq, n_kv, n_pages, ps, mp, window,
          scale * kLog2e, span_pages, n_spans);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_combine<bf16>(part_acc, part_ml, lengths, out, B, Hq, n_kv, D,
                              ps, mp, window, span_pages, n_spans, stream);
}

cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* table, const void* lengths, void* out,
                       float* part_acc, float* part_ml, int B, int Hq,
                       int n_kv, int n_pages, int ps, int hd, int mp,
                       int window, float scale, int span_pages, int n_spans,
                       cudaStream_t stream) {
  // 16-byte cp.async rows and uint4 query loads need 16-byte aligned bases
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0)
    return cudaErrorMisalignedAddress;
#define PA_MMA(D_)                                                          \
  return launch_mma_d<D_>(q, k, v, table, lengths, out, part_acc, part_ml, \
                          B, Hq, n_kv, n_pages, ps, mp, window, scale,     \
                          span_pages, n_spans, stream)
  switch (hd) {
    case 16: PA_MMA(16);
    case 32: PA_MMA(32);
    case 64: PA_MMA(64);
    case 80: PA_MMA(80);
    case 128: PA_MMA(128);
    default: return cudaErrorInvalidValue;
  }
#undef PA_MMA
}

// the head dims both kernels are built and checked for ("mma": <= 128)
bool head_dim_ok(int hd) {
  return hd == 16 || hd == 32 || hd == 64 || hd == 80 || hd == 128 ||
         hd == 256;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; kernel: 0 = "fma", 1 = "mma" (bfloat16,
// hd <= 128 only); hd one of head_dim_ok's. Block (kv head, slot, span) owns positions [s *
// span_pages * ps, (s + 1) * span_pages * ps); n_spans = ceil(mp /
// span_pages). part_acc (B, n_kv, n_spans, g, hd) and part_ml (B, n_kv,
// n_spans, g, 2) are float32 scratch, unused when n_spans == 1. Returns a
// cudaError_t code (0 = ok).
extern "C" int paged_attention_launch(int dtype, int kernel, const void* q,
                                      const void* k, const void* v,
                                      const void* table, const void* lengths,
                                      void* out, void* part_acc,
                                      void* part_ml, int B, int Hq, int n_kv,
                                      int n_pages, int ps, int hd, int mp,
                                      int window, float scale,
                                      int span_pages, void* stream) {
  if (B <= 0 || n_kv <= 0 || Hq % n_kv != 0 || Hq / n_kv > kMaxGroup ||
      !head_dim_ok(hd) || ps <= 0 || mp <= 0 ||
      n_pages <= 0 || span_pages <= 0 || B > 65535 || n_kv > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_spans = (mp + span_pages - 1) / span_pages;
  if (n_spans > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (kernel == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)launch_mma(q, k, v, table, lengths, out, pa, pm, B, Hq, n_kv,
                           n_pages, ps, hd, mp, window, scale, span_pages,
                           n_spans, s);
  }
  if (kernel != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_fma<float>(q, k, v, table, lengths, out, pa, pm, B, Hq,
                                  n_kv, n_pages, ps, hd, mp, window, scale,
                                  span_pages, n_spans, s);
  if (dtype == 1)
    return (int)launch_fma<__nv_bfloat16>(q, k, v, table, lengths, out, pa,
                                          pm, B, Hq, n_kv, n_pages, ps, hd,
                                          mp, window, scale, span_pages,
                                          n_spans, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
