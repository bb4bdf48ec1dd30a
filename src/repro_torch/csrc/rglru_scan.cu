// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rglru_scan/kernel.py:rglru_scan_pallas
//           (body _rglru_kernel), the Pallas TPU kernel.
//
// What it computes: h_t = a_t * h_{t-1} + b_t along axis 1 of (B, S, R)
// float32 inputs, with h_{-1} = 0, for any S and R.
//
// What bounds it on the H100: bytes. Each step is one FMA per channel, so
// the least time is reading a and b and writing h once (3 * B*S*R * 4
// bytes). The recurrence is serial in time: one thread per channel
// walking all of S, as the TPU kernel walks its time grid axis with h in
// VMEM scratch, gives only B*R/128 blocks (20 at recurrentgemma-2b's
// R = 2560, B = 1) for 132 SMs, and each thread's chain of dependent
// loads then runs at memory latency, not bandwidth.
//
// What the design does: it cuts time into chunks of T steps so that
// B * ceil(R/128) * ceil(S/T) blocks fill the card (about four per SM).
//   1. rglru_summary_kernel: per (batch, chunk, channel) the chunk's
//      product of a and its local scan end from h = 0 (skipped when there
//      is one chunk);
//   2. rglru_scan_kernel: per (batch, chunk, channel) the carry entering
//      the chunk, from the summaries of the chunks before it (a short
//      serial walk that hits L2), then the chunk's scan from that carry,
//      writing h.
// Threads of a block own consecutive channels, so every load and store of
// a time step is one coalesced row segment; each thread loads 8 steps of a
// and b ahead of the FMAs that use them. The summaries add a second read
// of a and b: 5 passes over (B, S, R) floats against the bound's 3.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kAhead = 8;       // time steps loaded before they are used

__global__ void __launch_bounds__(kThreads) rglru_summary_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ prod, float* __restrict__ hend, int S, int R, int T,
    int nT) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int k = blockIdx.y;
  const int bi = blockIdx.z;
  if (r >= R) return;
  const int t0 = k * T;
  const int t1 = min(t0 + T, S);
  const float* ap = a + (size_t)bi * S * R + r;
  const float* bp = b + (size_t)bi * S * R + r;
  float p = 1.f, h = 0.f;
  int t = t0;
  for (; t + kAhead <= t1; t += kAhead) {
    float av[kAhead], bv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      av[u] = ap[(size_t)(t + u) * R];
      bv[u] = bp[(size_t)(t + u) * R];
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      h = av[u] * h + bv[u];
      p *= av[u];
    }
  }
  for (; t < t1; ++t) {
    const float at = ap[(size_t)t * R];
    h = at * h + bp[(size_t)t * R];
    p *= at;
  }
  const size_t s = ((size_t)bi * nT + k) * R + r;
  prod[s] = p;
  hend[s] = h;
}

__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ prod, const float* __restrict__ hend,
    float* __restrict__ hout, int S, int R, int T, int nT) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int k = blockIdx.y;
  const int bi = blockIdx.z;
  if (r >= R) return;
  // the carry entering chunk k: fold the summaries of chunks 0..k-1
  float h = 0.f;
  for (int q = 0; q < k; ++q) {
    const size_t s = ((size_t)bi * nT + q) * R + r;
    h = prod[s] * h + hend[s];
  }
  const int t0 = k * T;
  const int t1 = min(t0 + T, S);
  const size_t base = (size_t)bi * S * R + r;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = hout + base;
  int t = t0;
  for (; t + kAhead <= t1; t += kAhead) {
    float av[kAhead], bv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      av[u] = ap[(size_t)(t + u) * R];
      bv[u] = bp[(size_t)(t + u) * R];
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      h = av[u] * h + bv[u];
      hp[(size_t)(t + u) * R] = h;
    }
  }
  for (; t < t1; ++t) {
    h = ap[(size_t)t * R] * h + bp[(size_t)t * R];
    hp[(size_t)t * R] = h;
  }
}

}  // namespace

// a, b, h: (B, S, R) float32; prod, hend: (B, ceil(S/T), R) float32
// scratch, unused (may be null) when S <= T. Returns a cudaError_t code.
extern "C" int rglru_scan_launch(const void* a, const void* b, void* h,
                                 void* prod, void* hend, int B, int S, int R,
                                 int T, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || T <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int nT = (S + T - 1) / T;
  if (nT > 65535 || (nT > 1 && (prod == nullptr || hend == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + kThreads - 1) / kThreads, nT, B);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* pf = static_cast<float*>(prod);
  float* ef = static_cast<float*>(hend);
  if (nT > 1) {
    // the last chunk's summary is never read
    const dim3 sgrid(grid.x, nT - 1, B);
    rglru_summary_kernel<<<sgrid, kThreads, 0, s>>>(af, bf, pf, ef, S, R, T,
                                                    nT);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rglru_scan_kernel<<<grid, kThreads, 0, s>>>(af, bf, pf, ef,
                                              static_cast<float*>(h), S, R, T,
                                              nT);
  return (int)cudaGetLastError();
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
