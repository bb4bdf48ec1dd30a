// Attention building blocks shared by the flash-attention forward and
// backward (flash_attention_fwd.cu, flash_attention_bwd.cu): the causal /
// window rule and the tile ranges it gives, the mma.sync fragments of the
// first kernels, and the TMA tiles, descriptors and bf16 wgmma products of
// the Hopper kernels, their named barriers, and the bf16 parts (3xBF16) of
// the kernels that run float32 and 256-column rows on them. Each source
// that includes it compiles on its own, so every definition lives in an
// anonymous namespace; kernels/_build.py hashes this header with each
// source.

#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"   // mbarriers, TMA, wgmma descriptors and fences

namespace {

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// ---------------------------------------------------------------------------
// the mask: query row qr sees key kc iff kc <= qr + off (causal) and
// kc > qr + off - window (window > 0), off = Sk - Sq; rows past Sq and keys
// past Sk see nothing
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ bool visible(int kc, int qr, int Sq,
                                                 int Sk, int off, int causal,
                                                 int window) {
  bool ok = kc < Sk && qr < Sq;
  if (causal) ok = ok && kc <= qr + off;
  if (window > 0) ok = ok && kc > qr + off - window;
  return ok;
}

// visible's keys of row qr as one range: kc is seen iff *lo <= kc <= *hi
// (empty for a row past Sq)
__host__ __device__ __forceinline__ void visible_keys(int qr, int Sq, int Sk,
                                                      int off, int causal,
                                                      int window, int* lo,
                                                      int* hi) {
  *hi = qr >= Sq ? -1 : causal ? imin(Sk - 1, qr + off) : Sk - 1;
  *lo = window > 0 ? qr + off - window + 1 : 0;
}

// The queries that keys [k_lo, k_hi] can be seen by, as query tiles of BQ
// rows: [*qt_begin, *qt_begin + *n_qt)
__host__ __device__ __forceinline__ void query_tiles(int k_lo, int k_hi,
                                                     int Sq, int off,
                                                     int causal, int window,
                                                     int BQ, int* qt_begin,
                                                     int* n_qt) {
  const int r_begin = causal ? imax(0, k_lo - off) : 0;
  int r_end = Sq;
  if (window > 0) r_end = imin(r_end, k_hi - off + window);
  *qt_begin = r_begin / BQ;
  *n_qt = r_end > r_begin ? (r_end + BQ - 1) / BQ - *qt_begin : 0;
}

// The keys rows [q_lo, q_hi] can see, as key tiles of BK rows:
// [*kt_begin, *kt_end)
__host__ __device__ __forceinline__ void key_tiles(int q_lo, int q_hi,
                                                   int Sk, int off,
                                                   int causal, int window,
                                                   int BK, int* kt_begin,
                                                   int* kt_end) {
  int k_end = Sk;
  if (causal) k_end = imin(k_end, q_hi + off + 1);
  const int k_begin = window > 0 ? imax(0, q_lo + off - window + 1) : 0;
  *kt_begin = k_begin / BK;
  *kt_end = k_end > k_begin ? (k_end + BK - 1) / BK : *kt_begin;
}

// Whether rows [q_lo, q_lo + BQ) meet keys [k_lo, k_lo + BK) on a mask
// edge (Sk, the causal diagonal or the window's start), so that the tile's
// scores are tested one by one; a tile in key_tiles' range that is not an
// edge is seen whole by every row below Sq
__host__ __device__ __forceinline__ bool edge_tile(int q_lo, int BQ, int k_lo,
                                                   int BK, int Sk, int off,
                                                   int causal, int window) {
  return k_lo + BK > Sk || (causal && k_lo + BK - 1 > q_lo + off) ||
         (window > 0 && k_lo <= q_lo + BQ - 1 + off - window);
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16 (bf16 in, f32 accumulate) and its fragments
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// TMA + wgmma (bf16 tiles: both directions' bf16 at head dims 64, 128 and
// 256 and their float32 at 64 and 128 as bf16 parts)
// ---------------------------------------------------------------------------

// rows [r0, r0 + R) of head bh into an (R, D) swizzled tile at dst: D / 64
// x R / 64 boxes of 8 KB; rows past S arrive as zeros
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int r0, int bh) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int rr = 0; rr < R / 64; ++rr)
      tma_load_3d(dst + c * R * 128 + rr * 64 * 128, map, bar, 64 * c,
                  r0 + 64 * rr, bh);
}

// an (R, D) tile as an MN-major B operand (its rows the k index, the head
// dim the n index), k-step ks: 16 rows; 64-column chunks R 128 bytes apart
template <int R>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int ks) {
  return wgmma_desc(tile + ks * 16 * 128, R * 128, 1024);
}

// 2^x on the special-function unit, results below 2^-126 flushed to 0
// (P is rounded to bf16 before its products; a flushed P is a term under
// 2^-126)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= A (64 x 16, K-major, shared) . B (16 x 64, K-major, shared)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (+)= A (64 x 16, K-major, shared) . B (16 x 128, K-major, shared)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int acc) {
  static_assert(N == 64 || N == 128, "wgmma_ss: n 64 or 128");
  if constexpr (N == 128)
    wgmma_ss_n128(d, da, db, acc);
  else
    wgmma_ss_n64(d, da, db, acc);
}

// d += A (64 x 16, registers) . B (16 x 64, MN-major: transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (64 x 16, registers) . B (16 x 128, MN-major: transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}

// the A fragment of columns [16 ks, 16 ks + 16) of a 64-row wgmma
// accumulator (element 4 j + 2 h + e: row 16 warp + lane / 4 + 8 h, column
// 8 j + 2 (lane % 4) + e): the accumulator's layout is the A fragment's
__device__ __forceinline__ void wg_acc_to_a(uint32_t* a, const float* x,
                                            int ks) {
  a[0] = pack_bf16(x[8 * ks + 0], x[8 * ks + 1]);
  a[1] = pack_bf16(x[8 * ks + 2], x[8 * ks + 3]);
  a[2] = pack_bf16(x[8 * ks + 4], x[8 * ks + 5]);
  a[3] = pack_bf16(x[8 * ks + 6], x[8 * ks + 7]);
}

// named barrier `id` over `n` threads: wait for all n, or arrive only
// (barrier 0 is __syncthreads'; the kernels whose consumer warpgroups take
// turns or hand tiles across use ids from 1)
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// bf16 parts: float32 on the bf16 tensor cores (3xBF16), and bf16 rows of
// 256 columns, in one tile plan (both directions' wgmma kernels on parts)
// ---------------------------------------------------------------------------

// The operands as NP bf16 parts of D columns each, a row of W = NP D bf16
// columns: NP = 1 is bfloat16 itself; NP = 2 is float32 x = hi + lo + e,
// hi = bf16(x) and lo = bf16(x - hi) both rounded to nearest, |e| <=
// 2^-18 |x| (a first kernel writes the inputs so, [hi | lo] a row, with
// split_row; P and dS are split in registers, acc_to_a_parts). A float32
// product is then the three bf16 products lo hi + hi lo + hi hi into one
// float32 accumulator, in that order (3xBF16; lo lo, under 2^-16 of the
// whole, is dropped): bf16's wgmma reads an MN-major B operand through the
// transpose bit, which tf32's does not, and three bf16 products cost what
// 1.5 TF32 ones do. A tile of R rows is W / 64 swizzled chunks of R rows x
// 128 bytes (tma_tile's boxes), part i's chunks after part i - 1's.
template <int D, int NP>
struct PartLayout {
  static constexpr int W = D * NP;          // bf16 columns a row
  static constexpr int kPairs = NP == 1 ? 1 : 3;  // products a product
  // product p of a pair: A's part and B's part (lo hi, hi lo, hi hi)
  static __device__ __forceinline__ int part_a(int p) {
    return NP == 1 ? 0 : p == 0;
  }
  static __device__ __forceinline__ int part_b(int p) {
    return NP == 1 ? 0 : p == 1;
  }
  // the byte offset of part i's chunks in an R-row tile
  template <int R>
  static __device__ __forceinline__ uint32_t part(int i) {
    return i * (D / 64) * R * 128;
  }
};

// acc (64 x D) += A (64 x 16, registers) . B (16 x D), B rows [16 ks, 16 ks
// + 16) of the R-row tile at `tile` read MN-major (the transpose bit)
template <int D, int R>
__device__ __forceinline__ void rs_mn(float* acc, const uint32_t* a,
                                      uint32_t tile, int ks) {
  if constexpr (D == 64) {
    wgmma_rs_n64(acc, a, mnmajor_desc<R>(tile, ks));
  } else {
#pragma unroll
    for (int h = 0; h < D / 128; ++h)
      wgmma_rs_n128(acc + 64 * h, a, mnmajor_desc<R>(tile + h * 2 * R * 128,
                                                     ks));
  }
}

// the A fragments of columns [16 ks, 16 ks + 16) of a 64-row accumulator
// as NP bf16 parts (wg_acc_to_a's layout): part 0 x rounded to bf16, part 1
// the remainder rounded
template <int NP>
__device__ __forceinline__ void acc_to_a_parts(uint32_t (&a)[NP][4],
                                               const float* x, int ks) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = x[8 * ks + 2 * i], x1 = x[8 * ks + 2 * i + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    a[0][i] = *reinterpret_cast<const uint32_t*>(&h);
    if constexpr (NP == 2) {
      const float2 hf = __bfloat1622float2(h);
      a[1][i] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}

// a row of d floats as its two bf16 parts, a row of 2 d: hi's d, then lo's
// (one warp a row)
__device__ __forceinline__ void split_row(const float* x, __nv_bfloat16* y,
                                          int d, int lane) {
  for (int c = lane; c < d; c += 32) {
    const float v = x[c];
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    y[c] = hi;
    y[d + c] = __float2bfloat16_rn(v - __bfloat162float(hi));
  }
}

// a contiguous (BH, S, d) bf16 tensor as a 3-D map (d, S, BH), boxes of 64
// columns x 64 rows of one head, 128-byte swizzle: a box never reaches into
// the next head's rows, and rows past S arrive as zeros
inline bool encode_heads(CUtensorMap* map, EncodeTiledFn enc, const void* ptr,
                         int d, int S, int BH) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)S * d * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
