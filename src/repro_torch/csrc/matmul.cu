// Blocked matrix product for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/matmul/kernel.py:matmul_pallas (body
//           _mm_kernel), the Pallas TPU kernel.
//
// What it computes: C = A @ B for A (M, K) and B (K, N), both row-major,
// float32 or bfloat16, with a float32 sum over K and C written in the
// inputs' dtype, for any M, N, K. Each output is one float32 chain of FMAs
// over k = 0..K-1 in order, so the result does not depend on the tile
// shape: two calls with other blocks give the same bits.
//
// What bounds it on the H100: operations, at any shape the serving models
// give it (llama3.2-3b's MLP products at 512 tokens do 2*M*N*K = 25.8 GFLOP
// against 60-100 MB of operands). The bound is the tensor cores' rate for
// bfloat16 (989 TFLOP/s) and the FMA units' for float32 (67 TFLOP/s).
//
// What the design does: the TPU kernel keeps a (bm, bn) float32 accumulator
// in VMEM across a sequential K grid axis. Here one block of 256 threads
// owns one (BM, BN) output tile and walks K itself, BK columns at a time:
// it stages the A tile (transposed, padded against bank conflicts) and the
// B tile in shared memory as float32, and each thread keeps a
// (BM/16) x (BN/16) accumulator in registers, its rows and columns strided
// by 16 so a warp reads shared memory without conflicts and writes C in
// 64-byte runs. Ragged edges are masked: out-of-range loads read zero and
// out-of-range stores are skipped, so the one compiled tile, the wrapper's
// h100 block-table entry (128 x 128 x 32, 33 KB of shared memory), takes
// every shape. Plain FMA on the FMA units, no tensor cores, one stage: a
// simple kernel that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of threads per block
// the tile: ops.py's BLOCK_TABLE["h100"]
constexpr int kBM = 128, kBN = 128, kBK = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  T* __restrict__ C, int M, int N, int K) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  __shared__ float As[BK][BM + 1];   // A tile, transposed: As[k][m]
  __shared__ float Bs[BK][BN];       // B tile: Bs[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // consecutive threads read consecutive addresses: along K for A,
    // along N for B
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int gr = m0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? to_f32(A[(size_t)gr * K + gc]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = n0 + c;
      Bs[r][c] = (gr < K && gc < N) ? to_f32(B[(size_t)gr * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = m0 + ty + 16 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = n0 + tx + 16 * j;
      if (gc < N) C[(size_t)gr * N + gc] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  matmul_kernel<T, kBM, kBN, kBK><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (a, b and c share it). a: (M, K), b: (K, N),
// c: (M, N), all contiguous row-major; M, N >= 1, K >= 0 (K = 0 writes
// zeros). Returns a cudaError_t code.
extern "C" int matmul_launch(int dtype, const void* a, const void* b, void* c,
                             int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, c, M, N, K, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, c, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
