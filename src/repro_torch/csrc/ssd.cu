// Chunked Mamba-2 SSD (state-space duality) scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd/kernel.py:ssd_pallas (body _ssd_kernel),
//           the Pallas TPU kernel.
//
// What it computes, per batch row and head, with x (b,S,H,P), dt (b,S,H),
// A (H,), B and C (b,S,N), all float32, time cut into chunks of Q steps:
//   cum_i     = inclusive cumsum of dt*A over the chunk, seg = cum_{Q-1}
//   y_i       = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) C_i . S                 (S: state entering)
//   S        <- exp(seg) S + sum_j exp(seg - cum_j) dt_j B_j (x) x_j
// with every exponent clipped to [-60, 0], as the model's chunked XLA path
// (kernels/ssd/ref.py:_ssd_chunked) does. Outputs y (b,S,H,P) and, unlike the
// TPU kernel, the final state (b,H,N,P), which serving's prefill hands to
// decode.
//
// What bounds it on the H100: operations. Per chunk and head the work is
// three products of Q x N x P and a causal Q x Q x P, against Q*(N+P)
// floats read: at mamba2-2.7b's Q=256, N=128, P=64 that is ~50 flops a
// byte, above f32's ~20 (67 TFLOP/s over 3.35 TB/s). This first version
// runs plain f32 FMA from shared memory (no tensor cores).
//
// What the design does:
//   * ssd_scores_kernel computes the head-shared C.B^T of every chunk once
//     (64 x 64 tiles at or below the diagonal) into a float32 scratch of
//     (b*S/Q, Q, Q), where the TPU kernel kept it in VMEM per grid step;
//   * ssd_chunk_kernel runs one block per (batch, head, slice of PB head
//     columns), walking the chunks in order inside the block (the TPU's
//     sequential chunk grid axis). The state slice (N x PB floats) stays in
//     shared memory across chunks. The TPU kernel held a whole Q x Q decay
//     tile per head in VMEM (256 KiB at Q=256, more than a block's 227 KiB
//     here); this kernel walks 64-row query tiles and, for each, only the
//     64-column key tiles at or below the diagonal;
//   * y of a chunk is written from the state entering it, before the state
//     update, as the reference orders them;
//   * splitting the head dim P into slices doubles the grid (160 blocks at
//     mamba2-2.7b's 80 heads) at the cost of each slice re-deriving the
//     decay tile, which is elementwise work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int QT = 64;           // rows of a query tile, columns of a key tile
constexpr int kMaxChunk = 256;
constexpr int kMaxState = 128;
constexpr int kScoreK = 32;      // depth of one score-tile slab

__device__ __forceinline__ float clipped_exp(float v) {
  return expf(fminf(fmaxf(v, -60.f), 0.f));
}

// G[bc, i, j] = sum_n C[bc*Q + i, n] * B[bc*Q + j, n] for the tiles at or
// below the diagonal (the others are never read). Grid (nt, nt, b*S/Q).
__global__ void __launch_bounds__(kThreads) ssd_scores_kernel(
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    float* __restrict__ G, int Q, int N) {
  const int jt = blockIdx.x, it = blockIdx.y;
  if (jt > it) return;
  const size_t bc = blockIdx.z;
  const float* Cb = Cm + bc * Q * N;
  const float* Bb = Bm + bc * Q * N;
  float* Gb = G + bc * Q * Q;
  __shared__ float Cs[QT][kScoreK + 1];
  __shared__ float Bs[QT][kScoreK + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;      // 16 x 16 threads, 4 x 4 each
  const int i0 = it * QT, j0 = jt * QT;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int n0 = 0; n0 < N; n0 += kScoreK) {
    for (int e = tid; e < QT * kScoreK; e += kThreads) {
      const int r = e / kScoreK, k = e % kScoreK;
      const int n = n0 + k;
      Cs[r][k] = (i0 + r < Q && n < N) ? Cb[(size_t)(i0 + r) * N + n] : 0.f;
      Bs[r][k] = (j0 + r < Q && n < N) ? Bb[(size_t)(j0 + r) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kScoreK; ++k) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = Cs[ty * 4 + r][k];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bs[tx + 16 * c][k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += cv[r] * bv[c];
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= Q) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < Q) Gb[(size_t)i * Q + j] = acc[r][c];
    }
  }
}

// One block per (slice of PB head columns, head, batch row); the chunks run
// in order inside the block. Shared memory, in floats:
//   Ss  N x PB       running state slice
//   cum, dts, wts    Q each: cumsum of dt*A, dt, exp(seg - cum) dt
//   Ts  QT x (N+1)   a tile of C rows (y phase) or of w-scaled B rows
//   Ms  QT x (QT+1)  scores * decay of one (query, key) tile pair
//   Xs  QT x PB      x rows of one key tile, this block's columns
template <int PB>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ G,
    float* __restrict__ y, float* __restrict__ state, int S, int H, int P,
    int N, int Q) {
  constexpr int CN = PB / 8;            // head columns per thread: tx + 8c
  constexpr int RM = QT / 32;           // query rows per thread
  constexpr int RN = kMaxState / 32;    // state rows per thread: ty + 32r
  constexpr int MST = QT + 1;
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;
  const int p0 = blockIdx.x * PB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = S / Q;
  const int NS = N + 1;

  extern __shared__ float smem[];
  float* Ss = smem;
  float* cum = Ss + N * PB;
  float* dts = cum + Q;
  float* wts = dts + Q;
  float* Ts = wts + Q;
  float* Ms = Ts + QT * NS;
  float* Xs = Ms + QT * MST;

  const float a_h = A[h];
  for (int e = tid; e < N * PB; e += kThreads) Ss[e] = 0.f;
  const int ntile = (Q + QT - 1) / QT;

  for (int c = 0; c < nc; ++c) {
    const size_t row0 = (size_t)b * S + (size_t)c * Q;   // first step's row
    const float* Gc = G + ((size_t)b * nc + c) * Q * Q;
    __syncthreads();             // the previous chunk is done with cum/dts
    for (int i = tid; i < Q; i += kThreads) {
      const float d = dt[(row0 + i) * H + h];
      dts[i] = d;
      cum[i] = d * a_h;
    }
    __syncthreads();
    if (tid < 32) {              // inclusive cumsum: serial per lane, then a
      const int per = (Q + 31) / 32;       // warp scan of the lane totals
      const int lo = min(tid * per, Q), hi = min(lo + per, Q);
      float s = 0.f;
      for (int i = lo; i < hi; ++i) {
        s += cum[i];
        cum[i] = s;
      }
      float incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const float excl = incl - s;
      for (int i = lo; i < hi; ++i) cum[i] += excl;
    }
    __syncthreads();
    const float seg = cum[Q - 1];
    for (int i = tid; i < Q; i += kThreads)
      wts[i] = clipped_exp(seg - cum[i]) * dts[i];

    // ---- y of every query tile, from the state entering the chunk ----
    for (int qt = 0; qt < ntile; ++qt) {
      const int i0 = qt * QT;
      float acc[RM][CN];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int k = 0; k < CN; ++k) acc[r][k] = 0.f;
      __syncthreads();           // Ts, Ms, Xs are free
      for (int e = tid; e < QT * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        Ts[r * NS + n] = (i0 + r < Q) ? Cm[(row0 + i0 + r) * N + n] : 0.f;
      }
      __syncthreads();
      // inter-chunk: exp(cum_i) C_i . S
      for (int n = 0; n < N; ++n) {
        float sv[CN];
#pragma unroll
        for (int k = 0; k < CN; ++k) sv[k] = Ss[n * PB + tx + 8 * k];
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float cv = Ts[(ty * RM + r) * NS + n];
#pragma unroll
          for (int k = 0; k < CN; ++k) acc[r][k] += cv * sv[k];
        }
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int i = i0 + ty * RM + r;
        const float g = i < Q ? clipped_exp(cum[i]) : 0.f;
#pragma unroll
        for (int k = 0; k < CN; ++k) acc[r][k] *= g;
      }
      // intra-chunk: key tiles at or below the diagonal
      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * QT;
        __syncthreads();         // the previous pair's Ms and Xs are consumed
        for (int e = tid; e < QT * QT; e += kThreads) {
          const int r = e / QT, col = e % QT;
          const int i = i0 + r, j = j0 + col;
          float m = 0.f;
          if (i < Q && j <= i)
            m = Gc[(size_t)i * Q + j] * clipped_exp(cum[i] - cum[j]) * dts[j];
          Ms[r * MST + col] = m;
        }
        for (int e = tid; e < QT * PB; e += kThreads) {
          const int r = e / PB, col = e % PB;
          const int j = j0 + r;
          Xs[e] = j < Q ? x[((row0 + j) * H + h) * P + p0 + col] : 0.f;
        }
        __syncthreads();
        const int jn = min(QT, Q - j0);
        for (int j = 0; j < jn; ++j) {
          float xv[CN];
#pragma unroll
          for (int k = 0; k < CN; ++k) xv[k] = Xs[j * PB + tx + 8 * k];
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            const float mv = Ms[(ty * RM + r) * MST + j];
#pragma unroll
            for (int k = 0; k < CN; ++k) acc[r][k] += mv * xv[k];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int i = i0 + ty * RM + r;
        if (i < Q) {
          float* yp = y + ((row0 + i) * H + h) * P + p0;
#pragma unroll
          for (int k = 0; k < CN; ++k) yp[tx + 8 * k] = acc[r][k];
        }
      }
    }

    // ---- state: S <- exp(seg) S + sum_j (w_j B_j) (x) x_j ----
    float sacc[RN][CN];
#pragma unroll
    for (int r = 0; r < RN; ++r)
#pragma unroll
      for (int k = 0; k < CN; ++k) sacc[r][k] = 0.f;
    for (int kt = 0; kt < ntile; ++kt) {
      const int j0 = kt * QT;
      __syncthreads();           // y phase (or the previous key tile) done
      for (int e = tid; e < QT * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        const int j = j0 + r;
        Ts[r * NS + n] = j < Q ? Bm[(row0 + j) * N + n] * wts[j] : 0.f;
      }
      for (int e = tid; e < QT * PB; e += kThreads) {
        const int r = e / PB, col = e % PB;
        const int j = j0 + r;
        Xs[e] = j < Q ? x[((row0 + j) * H + h) * P + p0 + col] : 0.f;
      }
      __syncthreads();
      const int jn = min(QT, Q - j0);
      for (int j = 0; j < jn; ++j) {
        float xv[CN];
#pragma unroll
        for (int k = 0; k < CN; ++k) xv[k] = Xs[j * PB + tx + 8 * k];
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          const int n = ty + 32 * r;
          if (n < N) {
            const float bv = Ts[j * NS + n];
#pragma unroll
            for (int k = 0; k < CN; ++k) sacc[r][k] += bv * xv[k];
          }
        }
      }
    }
    // every read of the entering state (y phase) happened before the key
    // loop's first barrier; each thread updates only its own elements
    const float g = clipped_exp(seg);
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int n = ty + 32 * r;
      if (n < N) {
#pragma unroll
        for (int k = 0; k < CN; ++k) {
          float* sp = &Ss[n * PB + tx + 8 * k];
          *sp = g * *sp + sacc[r][k];
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * PB; e += kThreads) {
    const int n = e / PB, col = e % PB;
    state[(((size_t)b * H + h) * N + n) * P + p0 + col] = Ss[e];
  }
}

size_t chunk_smem_bytes(int N, int Q, int PB) {
  return sizeof(float) * ((size_t)N * PB + 3 * (size_t)Q +
                          (size_t)QT * (N + 1) + (size_t)QT * (QT + 1) +
                          (size_t)QT * PB);
}

template <int PB>
cudaError_t launch_chunks(const float* x, const float* dt, const float* A,
                          const float* Bm, const float* Cm, const float* G,
                          float* y, float* state, int b, int S, int H, int P,
                          int N, int Q, cudaStream_t stream) {
  const size_t smem = chunk_smem_bytes(N, Q, PB);
  auto kern = ssd_chunk_kernel<PB>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(P / PB, H, b);
  kern<<<grid, kThreads, smem, stream>>>(x, dt, A, Bm, Cm, G, y, state, S, H,
                                         P, N, Q);
  return cudaGetLastError();
}

}  // namespace

// x (b,S,H,P), dt (b,S,H), A (H,), B and C (b,S,N) in; y (b,S,H,P), state
// (b,H,N,P) out; scores: (b*S/chunk, chunk, chunk) float32 scratch. pb is
// the head-dim slice one block owns (16 or 32, dividing P). Returns a
// cudaError_t code (0 = ok).
extern "C" int ssd_launch(const void* x, const void* dt, const void* A,
                          const void* B, const void* C, void* y, void* state,
                          void* scores, int b, int S, int H, int P, int N,
                          int chunk, int pb, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || N <= 0 || N > kMaxState || chunk <= 0 ||
      chunk > kMaxChunk || S % chunk != 0 || (pb != 16 && pb != 32) ||
      P % pb != 0 || b > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* Bf = static_cast<const float*>(B);
  const float* Cf = static_cast<const float*>(C);
  float* G = static_cast<float*>(scores);
  const int nt = (chunk + QT - 1) / QT;
  const dim3 sgrid(nt, nt, (unsigned)b * (S / chunk));
  ssd_scores_kernel<<<sgrid, kThreads, 0, s>>>(Bf, Cf, G, chunk, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  if (pb == 32)
    e = launch_chunks<32>(xf, dtf, Af, Bf, Cf, G, yf, sf, b, S, H, P, N,
                          chunk, s);
  else
    e = launch_chunks<16>(xf, dtf, Af, Bf, Cf, G, yf, sf, b, S, H, P, N,
                          chunk, s);
  return (int)e;
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
