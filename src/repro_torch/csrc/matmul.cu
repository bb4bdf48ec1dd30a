// Blocked matrix product for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/matmul/kernel.py:matmul_pallas (body
//           _mm_kernel), the Pallas TPU kernel.
//
// What it computes: C = A @ B for A (M, K) and B (K, N), both row-major,
// float32 or bfloat16, with a float32 sum over K and C written in the
// inputs' dtype, for any M, N, K.
//
// What bounds it on the H100: operations, at any shape the serving models
// give it (llama3.2-3b's MLP products at 512 tokens do 2*M*N*K = 25.8 GFLOP
// against 60-100 MB of operands). The bound is the tensor cores' rate for
// bfloat16 (989 TFLOP/s) and the FMA units' for float32 (67 TFLOP/s).
//
// Two kernels; which one runs, and at which tile, is a function of
// (M, N, K, dtype) alone, chosen by kernels/matmul/ops.py:kernel_choice
// before the launch and passed in. The same shape therefore always runs
// the same code and gives the same bits (the fig5 native and container-
// bound calls compare bit for bit); two shapes' tiles may differ, and in
// bfloat16 the tensor cores' order of summation is their own.
//
// 1. Tensor cores (bfloat16, K and N multiples of 8, so TMA can describe
//    the rows): one producer warp keeps a ring of 4 shared-memory stages
//    full with TMA tile loads of A (BM x 64) and B (64 x BN), each stage
//    completing on an mbarrier; BM/64 consumer warpgroups issue
//    wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulators in registers)
//    on the stages that have landed and hand each stage back through a
//    second mbarrier. Both tiles use TMA's 128-byte swizzle, matched by the
//    wgmma shared-memory descriptors: A is K-major; B stays as it is in
//    memory (N-major) and wgmma's transpose bit reads it so. TMA zero-fills
//    out-of-range loads, so ragged M, N and K need no masks; the epilogue
//    rounds to bf16 and stores in range. Tiles: 128 x 256 and 128 x 128
//    (the table in ops.py), so that a shape fills the 132 SMs.
// 2. FMA (float32, where TF32 would break the float32 tolerance, and
//    bfloat16 shapes TMA cannot describe): one 256-thread block per
//    (BM, BN) output tile walks K 32 at a time through two shared-memory
//    stages filled by 16-byte cp.async (zero-filled past the edges) while
//    the other stage is consumed; rows whose byte length is not a multiple
//    of 16 are staged element by element instead. Each thread keeps a
//    (BM/16) x (BN/16) float32 accumulator and reads A four k at a time and
//    B four columns at a time. Each output is one float32 chain of FMAs
//    over k = 0..K-1 in order. Tiles: 128 x 128 and 64 x 64.

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// 2. FMA kernel
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;   // a 16 x 16 grid of threads per block
constexpr int kFmaBK = 32;

template <typename T>
struct Fma {
  // A tile rows padded by 16 bytes: 16-byte cp.async destinations stay
  // aligned and the two row groups of a warp read different banks
  static constexpr int kAPad = 16 / sizeof(T);
  static constexpr int kAStride = kFmaBK + kAPad;
};

// four consecutive elements as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// Stage rows [r0, r0 + R) x columns [c0, c0 + C) of the row-major (rows,
// cols) matrix g into s (row stride sst elements), zero past the edges.
template <typename T, int R, int C, bool VEC>
__device__ __forceinline__ void stage_tile(T* s, int sst, const T* g,
                                           int rows, int cols, int r0,
                                           int c0) {
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T);      // elements per 16-byte chunk
    constexpr int CPR = C / E;             // chunks per row
    for (int e = threadIdx.x; e < R * CPR; e += kFmaThreads) {
      const int r = e / CPR, c = (e % CPR) * E;
      const int gr = r0 + r, gc = c0 + c;
      int bytes = 0;
      if (gr < rows && gc < cols) bytes = min(cols - gc, E) * (int)sizeof(T);
      const T* src = bytes ? g + (size_t)gr * cols + gc : g;
      cp_async16(smem_u32(s + r * sst + c), src, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < R * C; e += kFmaThreads) {
      const int r = e / C, c = e % C;
      const int gr = r0 + r, gc = c0 + c;
      s[r * sst + c] = (gr < rows && gc < cols) ? g[(size_t)gr * cols + gc]
                                                : from_f32<T>(0.f);
    }
  }
}

template <typename T, int BM, int BN>
constexpr size_t fma_smem_bytes() {
  return 2 * sizeof(T) * ((size_t)BM * Fma<T>::kAStride + (size_t)kFmaBK * BN);
}

template <typename T, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(kFmaThreads)
    fma_kernel(const T* __restrict__ A, const T* __restrict__ B,
               T* __restrict__ C, int M, int N, int K) {
  constexpr int TM = BM / 16;     // rows a thread owns: ty + 16 i
  constexpr int TN = BN / 16;     // columns: 4 tx + 64 j + c, c < 4
  constexpr int AST = Fma<T>::kAStride;
  constexpr int ASZ = BM * AST, BSZ = kFmaBK * BN;
  extern __shared__ __align__(16) unsigned char fma_smem[];
  T* As = reinterpret_cast<T*>(fma_smem);      // 2 stages of (BM, AST)
  T* Bs = As + 2 * ASZ;                         // 2 stages of (BK, BN)

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int nk = (K + kFmaBK - 1) / kFmaBK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  auto stage = [&](int kt, int buf) {
    stage_tile<T, BM, kFmaBK, VEC>(As + buf * ASZ, AST, A, M, K, m0,
                                   kt * kFmaBK);
    stage_tile<T, kFmaBK, BN, VEC>(Bs + buf * BSZ, BN, B, K, N, kt * kFmaBK,
                                   n0);
    if constexpr (VEC) asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (nk > 0) stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      stage(kt + 1, buf ^ 1);
      if constexpr (VEC) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else if constexpr (VEC) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const T* as = As + buf * ASZ;
    const T* bs = Bs + buf * BSZ;
#pragma unroll 2
    for (int k4 = 0; k4 < kFmaBK; k4 += 4) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = load4(as + (ty + 16 * i) * AST + k4);
        a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float b[TN];
#pragma unroll
        for (int j = 0; j < TN / 4; ++j) {
          const float4 v = load4(bs + (k4 + u) * BN + 4 * tx + 64 * j);
          b[4 * j] = v.x, b[4 * j + 1] = v.y, b[4 * j + 2] = v.z,
          b[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][u], b[j], acc[i][j]);
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = m0 + ty + 16 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = n0 + 4 * tx + 64 * (j / 4) + j % 4;
      if (gc < N) C[(size_t)gr * N + gc] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, bool VEC>
cudaError_t run_fma(const void* a, const void* b, void* c, int M, int N,
                    int K, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = fma_smem_bytes<T, BM, BN>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fma_kernel<T, BM, BN, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  fma_kernel<T, BM, BN, VEC><<<grid, kFmaThreads, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(c), M, N, K);
  return cudaGetLastError();
}

template <typename T, int BM, int BN>
cudaError_t launch_fma(const void* a, const void* b, void* c, int M, int N,
                       int K, cudaStream_t s) {
  // 16-byte staging needs 16-byte rows and bases
  const bool vec = (K * sizeof(T)) % 16 == 0 && (N * sizeof(T)) % 16 == 0 &&
                   ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
  return vec ? run_fma<T, BM, BN, true>(a, b, c, M, N, K, s)
             : run_fma<T, BM, BN, false>(a, b, c, M, N, K, s);
}

template <typename T>
cudaError_t launch_fma_tile(int bm, int bn, const void* a, const void* b,
                            void* c, int M, int N, int K, cudaStream_t s) {
  if (bm == 128 && bn == 128)
    return launch_fma<T, 128, 128>(a, b, c, M, N, K, s);
  if (bm == 64 && bn == 64) return launch_fma<T, 64, 64>(a, b, c, M, N, K, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// 1. Tensor-core kernel: TMA -> 4-stage ring -> wgmma
// ---------------------------------------------------------------------------

constexpr int kTcBK = 64;        // 64 bf16 = one 128-byte swizzle row
constexpr int kTcStages = 4;

template <int BM, int BN>
struct TcTile {
  static constexpr int kConsumers = BM / 64;          // warpgroups
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kABytes = BM * kTcBK * 2;
  static constexpr int kBChunk = kTcBK * 128;         // 64 k rows x 64 n
  static constexpr int kBBytes = (BN / 64) * kBChunk;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // stages, 1024 bytes to align them for the swizzle, full + empty barriers
  static constexpr int kSmem = kTcStages * kStageBytes + 1024 +
                               2 * kTcStages * 8;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// d += A(64 x 16, K-major) . B(16 x N, N-major: transpose bit set)
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2,"
      " %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, "
      "1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2,"
      " %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
      "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, "
      "%95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "
      "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128,"
      " %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]),
        "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256k16(d, da, db);
  else
    wgmma_m64n128k16(d, da, db);
}

template <int BM, int BN>
__global__ void __launch_bounds__(TcTile<BM, BN>::kThreads, 1)
    tc_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b,
              __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  using TL = TcTile<BM, BN>;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t base = (smem_u32(tc_smem) + 1023) & ~1023u;
  const uint32_t bars = base + kTcStages * TL::kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kTcStages + s); };
  auto a_stage = [&](int s) { return base + s * TL::kStageBytes; };
  auto b_stage = [&](int s) { return a_stage(s) + TL::kABytes; };

  const int wg = threadIdx.x / 128;
  const int nk = (K + kTcBK - 1) / kTcBK;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), TL::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == TL::kConsumers) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == TL::kConsumers * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kTcStages;
        if (kt >= kTcStages) mbar_wait(empty(s), (kt / kTcStages - 1) & 1);
        mbar_expect_tx(full(s), TL::kStageBytes);
        tma_load_2d(a_stage(s), &map_a, full(s), kt * kTcBK, m0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(b_stage(s) + c * TL::kBChunk, &map_b, full(s),
                      n0 + 64 * c, kt * kTcBK);
      }
    }
  } else {
    // consumer warpgroup wg: output rows m0 + 64 wg .. + 63
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kTcStages;
      mbar_wait(full(s), (kt / kTcStages) & 1);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        // A: 64 rows of 128 bytes, 8-row swizzle atoms 1024 bytes apart;
        // k advances 32 bytes inside the row
        const uint64_t da =
            wgmma_desc(a_stage(s) + wg * 64 * 128 + kk * 32, 16, 1024);
        // B: k rows of 128 bytes (64 n), 8-row atoms 1024 bytes apart,
        // 64-column chunks kBChunk apart; k advances 16 rows
        const uint64_t db =
            wgmma_desc(b_stage(s) + kk * 16 * 128, TL::kBChunk, 1024);
        wgmma_tile<BN>(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (threadIdx.x % 128 == 0) mbar_arrive(empty(s));
    }

    // accumulator fragment: row 16 w + lane/4 (+8), column 8 j + 2 (lane%4)
    const int lane = threadIdx.x % 32;
    const int w = (threadIdx.x % 128) / 32;
    const int r0 = m0 + wg * 64 + w * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * N + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a row-major (rows, cols) bf16 matrix, tiles of box_rows x 64 columns
bool encode_bf16(CUtensorMap* map, EncodeTiledFn enc, const void* ptr,
                 int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN>
cudaError_t launch_tc(const void* a, const void* b, void* c, int M, int N,
                      int K, cudaStream_t s) {
  using TL = TcTile<BM, BN>;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap map_a, map_b;
  if (!encode_bf16(&map_a, enc, a, M, K, BM) ||
      !encode_bf16(&map_b, enc, b, K, N, kTcBK))
    return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        tc_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TL::kSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  tc_kernel<BM, BN><<<grid, TL::kThreads, TL::kSmem, s>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(c), M, N, K);
  return cudaGetLastError();
}

cudaError_t launch_tc_tile(int bm, int bn, const void* a, const void* b,
                           void* c, int M, int N, int K, cudaStream_t s) {
  // TMA: 16-byte global row strides and bases
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 ||
      ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) % 16 != 0)
    return cudaErrorInvalidValue;
  if (bm == 128 && bn == 256) return launch_tc<128, 256>(a, b, c, M, N, K, s);
  if (bm == 128 && bn == 128) return launch_tc<128, 128>(a, b, c, M, N, K, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (a, b and c share it). kernel: 0 FMA, 1
// tensor cores (bfloat16 only); (bm, bn) one of that kernel's tiles, as
// ops.py:kernel_choice names them. a: (M, K), b: (K, N), c: (M, N), all
// contiguous row-major; M, N >= 1, K >= 0 (K = 0 writes zeros, FMA only).
// Returns a cudaError_t code.
extern "C" int matmul_launch(int dtype, int kernel, int bm, int bn,
                             const void* a, const void* b, void* c, int M,
                             int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 1)
    return dtype == 1 ? (int)launch_tc_tile(bm, bn, a, b, c, M, N, K, s)
                      : (int)cudaErrorInvalidValue;
  if (kernel != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_fma_tile<float>(bm, bn, a, b, c, M, N, K, s);
  if (dtype == 1)
    return (int)launch_fma_tile<__nv_bfloat16>(bm, bn, a, b, c, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
