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
// byte. The products run on the tensor cores in 3xTF32: each float32
// operand is split into a TF32 high part and a TF32 remainder, and
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi is summed in float32 (mma.sync
// m16n8k8), which keeps about float32's accuracy at a third of the TF32
// rate (one TF32 product keeps about three decimal digits, too few for the
// 1e-4 bound over sums of 128 and 256 terms).
//
// What the design does: the chunks run in parallel, in _ssd_chunked's own
// phases, as three kernels on one stream:
//   1. ssd_state_kernel, one block per (chunk, head, 64 state rows, P
//      slice): the chunk's cumsum (written to a scratch the later kernels
//      read) and its own state s_chunk = (w.B)^T X, w_j = exp(seg - cum_j)
//      dt_j. Further blocks of the same launch compute the head-shared
//      C.B^T of every chunk, 64 x 64 tiles at or below the diagonal, into a
//      float32 scratch;
//   2. ssd_pass_kernel, the only recurrence: S_k = exp(seg_k) S_{k-1} +
//      s_chunk_k over the chunks of each (batch row, head), elementwise on
//      N x P, writing the state entering each chunk to a second scratch and
//      the final state to the output (a sequence of one chunk skips it:
//      its own state is the final one);
//   3. ssd_out_kernel, one block per (64 query rows, head, chunk, P slice),
//      dispatched so the longest k loops (late rows of late chunks) start
//      first: y = (C e^cum) S_prev + (G o L) X as one k loop over the state
//      rows, then over the key columns up to the diagonal. The first chunk
//      has no entering state and skips the first part.
// Each k step of 32 streams its two operand tiles (x, B, C, the scores or
// the entering state) into a three-stage ring of 16-byte cp.async copies,
// zero-filling ragged edges (4-byte copies where B and C rows are not
// 16-byte aligned), so the next steps' loads fly while this one is
// computed. A block's 64 x PT output is four warp tiles of 32 x PT / 2
// (2 x PT / 16 MMA fragments): a warp reads every fragment element once
// from shared memory, applies in registers what belongs to it (w to B,
// exp(cum_i) to C, and to the scores the decay L = exp(cum_i - cum_j) dt_j
// from cum in shared memory and the causal mask), splits it, and reuses it
// across the products of its row or column: shared-memory traffic, not the
// tensor cores, is what smaller warp tiles run out of. The two small
// products of every fragment are issued before the large ones, so no
// product waits on the one issued just before it. Rows are padded so every
// fragment read is free of bank conflicts. Ragged chunks (Q not a multiple
// of 32), state sizes and head dims are zero-filled on load and masked on
// store. P is cut into slices of PT = 16, 32, 64 or 128 columns (the
// smallest that covers P); only P > 128 takes more than one slice.
//
// What holds it back: each warp of a block issues its copies and builds
// its fragments (loads, scaling, splits) between bursts of products, and
// the tensor pipe idles meanwhile; 3xTF32 triples the products, and
// mma.sync does not reach wgmma's TF32 rate. TMA-fed wgmma with a producer
// warp and operands split once in shared memory is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 256;
constexpr int kMaxState = 128;
constexpr int KT = 32;            // k depth of one staged tile
constexpr int kStages = 3;
constexpr int kThreads = 128;     // 2 x 2 warps of 32 rows x PT / 2
constexpr int WM = 32;            // rows of a warp tile (2 m16 fragments)
constexpr int QB = 64;            // rows of a block: query rows, state rows,
                                  // or the edge of a C.B^T tile
constexpr int RST = KT + 4;       // row stride of (row, k) tiles: banks 4g+t
constexpr int BST = QB + 8;       // row stride of (k, state row): 8t+g

__device__ __forceinline__ float clipped_exp(float v) {
  return expf(fminf(fmaxf(v, -60.f), 0.f));
}

// the same through the fast exponential (ex2.approx of v log2 e: relative
// error below 4e-6 on [-60, 0]), for the decay of every score
__device__ __forceinline__ float clipped_exp_fast(float v) {
  return __expf(fminf(fmaxf(v, -60.f), 0.f));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four floats of one row into shared memory: src[0, valid) are real, the
// rest are zero-filled. ``vec`` (uniform over the block) says every row
// the block reads is 16-byte aligned: then one 16-byte copy of 4 valid
// floats' bytes; else four 4-byte copies. ``base`` is any valid global
// address, used when nothing is read.
__device__ __forceinline__ void cp_piece(float* dst, const float* src,
                                         int valid, const float* base,
                                         bool vec) {
  const uint32_t d = smem_u32(dst);
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(valid > 0 ? src : base), "r"(4 * valid)
                 : "memory");
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     d + 4 * k),
                 "l"(k < valid ? src + k : base), "r"(k < valid ? 4 : 0)
                 : "memory");
}

// the block's rows are all 16-byte aligned: every base pointer is, and so
// is a row of B and C (N floats); x rows (P floats, P % 16 == 0) always are
__device__ __forceinline__ bool rows_aligned(const float* a, const float* b,
                                             const float* c, int N) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0 && N % 4 == 0;
}

__device__ __forceinline__ int clamp4(int n) {
  return n < 0 ? 0 : n > 4 ? 4 : n;
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo + e, hi and lo TF32 (x's top 19 bits, then the remainder's,
// both by truncation), |e| <= 2^-20 |x|: three integer and float ops where
// two round-to-nearest conversions cost several times more
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  constexpr uint32_t kTf32 = 0xffffe000u;
  hi = __float_as_uint(x) & kTf32;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k8 step of a warp tile of MF x NF fragments in 3xTF32. a[mf] holds
// A's elements (g,t), (g+8,t), (g,t+4), (g+8,t+4) of the fragment; b[nf]
// holds B's (t,g), (t+4,g). Each operand is split once; the small products
// of every fragment go first, then the large ones, into one float32
// accumulator.
template <int MF, int NF>
__device__ __forceinline__ void mma3_step(float (&acc)[MF][NF][4],
                                          const float (&a)[MF][4],
                                          const float (&b)[NF][2]) {
  uint32_t ah[MF][4], al[MF][4], bh[NF][2], bl[NF][2];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int e = 0; e < 4; ++e) split(a[mf][e], ah[mf][e], al[mf][e]);
#pragma unroll
  for (int nf = 0; nf < NF; ++nf)
#pragma unroll
    for (int e = 0; e < 2; ++e) split(b[nf][e], bh[nf][e], bl[nf][e]);
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
      mma_tf32(acc[mf][nf], al[mf], bh[nf][0], bh[nf][1]);
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
      mma_tf32(acc[mf][nf], ah[mf], bl[nf][0], bl[nf][1]);
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
      mma_tf32(acc[mf][nf], ah[mf], bh[nf][0], bh[nf][1]);
}

// B fragments of one k8 step from a (k, column) tile of row stride ST
template <int NF>
__device__ __forceinline__ void b_frags(float (&b)[NF][2], const float* Bs,
                                        int ST, int k0, int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) {
    const float* p = Bs + (k0 + t) * ST + col0 + 8 * nf + g;
    b[nf][0] = p[0];
    b[nf][1] = p[4 * ST];
  }
}

// A block's tiles: 64 rows x PT columns, four warps of 32 rows x PT / 2.
template <int PT>
struct Cfg {
  static constexpr int NF = PT / 16;          // n8 fragments of a warp
  static constexpr int XST = PT + 8;          // row stride of (k, p) tiles
  // shared memory, in floats: a stage of the ring holds a (k, state row)
  // or (row, k) tile and a (k, p) tile, or a C tile and a B tile; then cum
  // and dt of the chunk
  static constexpr int stage_ab = KT * BST > QB * RST ? KT * BST : QB * RST;
  static constexpr int stage = stage_ab + (KT * XST > QB * RST ? KT * XST
                                                                : QB * RST);
  static constexpr int floats = kStages * stage + 2 * kMaxChunk;
};

// Grid (H * n_slab * n_psl + score tiles, b * nc). Blocks below that: the
// state of one (chunk, head, slab of 64 state rows, P slice); the others:
// one 64 x 64 tile of the chunk's C.B^T at or below the diagonal.
template <int PT>
__global__ void __launch_bounds__(kThreads) ssd_state_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float* __restrict__ G,
    float* __restrict__ cum_g, float* __restrict__ states, int H, int P,
    int N, int Q, int Qp, int n_slab, int n_psl) {
  using C_ = Cfg<PT>;
  constexpr int NF = C_::NF, XST = C_::XST;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* cum = ring + kStages * C_::stage;
  float* dts = cum + kMaxChunk;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bc = blockIdx.y;
  const size_t row0 = (size_t)bc * Q;         // first time step of the chunk
  const int n_state = H * n_slab * n_psl;
  const int mrow = WM * (warp & 1);           // the warp's 32 rows ...
  const int wc = warp >> 1;                   // ... and column half
  const bool vec = rows_aligned(x, Bm, Cm, N);

  if ((int)blockIdx.x >= n_state) {
    // ---- one 64 x 64 tile of C.B^T -----------------------------------------
    int tile = blockIdx.x - n_state, it = 0;
    while (tile > it) tile -= ++it;           // tile = it*(it+1)/2 + jt
    const int jt = tile;
    const int i0 = it * QB, j0 = jt * QB;
    const int nk = (N + KT - 1) / KT;
    auto load = [&](int u, int s) {
      float* Cs = ring + s * C_::stage;
      float* Bs = Cs + C_::stage_ab;
      const int n0 = u * KT;
#pragma unroll
      for (int e = tid; e < 2 * QB * (KT / 4); e += kThreads) {
        const int which = e / (QB * (KT / 4));
        const int r = (e / (KT / 4)) % QB, c = (e % (KT / 4)) * 4;
        const int row = (which ? j0 : i0) + r;
        const float* src = (which ? Bm : Cm) + (row0 + row) * N + n0 + c;
        cp_piece((which ? Bs : Cs) + r * RST + c, src,
                 row < Q ? clamp4(N - n0 - c) : 0, Cm, vec);
      }
    };
    const int ncol = 32 * wc;
    float acc[2][4][4] = {};
    load(0, 0);
    cp_commit();
    if (nk > 1) load(1, 1);
    cp_commit();
    for (int u = 0; u < nk; ++u) {
      if (u + 2 < nk) load(u + 2, (u + 2) % kStages);
      cp_commit();
      cp_wait<2>();
      __syncthreads();
      const float* Cs = ring + (u % kStages) * C_::stage;
      const float* Bs = Cs + C_::stage_ab;
#pragma unroll
      for (int k0 = 0; k0 < KT; k0 += 8) {
        float a[2][4], b[4][2];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          const float* p = Cs + (mrow + 16 * mf + g) * RST + k0 + t;
          a[mf][0] = p[0];
          a[mf][1] = p[8 * RST];
          a[mf][2] = p[4];
          a[mf][3] = p[8 * RST + 4];
        }
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {      // B^T: row n = k, column j
          const float* p = Bs + (ncol + 8 * nf + g) * RST + k0 + t;
          b[nf][0] = p[0];
          b[nf][1] = p[4];
        }
        mma3_step(acc, a, b);
      }
      __syncthreads();
    }
    float* Gb = G + (size_t)bc * Q * Qp;
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + mrow + 16 * mf + g + 8 * (e >> 1);
          const int j = j0 + ncol + 8 * nf + 2 * t + (e & 1);
          if (i < Q && j < Q) Gb[(size_t)i * Qp + j] = acc[mf][nf][e];
        }
    return;
  }

  // ---- the chunk's own state: (w.B)^T X, 64 state rows, PT columns -------
  const int h = blockIdx.x / (n_slab * n_psl);
  const int slab = (blockIdx.x / n_psl) % n_slab;
  const int n0 = slab * QB, p0 = (blockIdx.x % n_psl) * PT;
  const int nk = (Q + KT - 1) / KT;
  auto load = [&](int u, int s) {
    float* Bs = ring + s * C_::stage;
    float* Xs = Bs + C_::stage_ab;
    const int j0 = u * KT;
#pragma unroll
    for (int e = tid; e < KT * (QB / 4); e += kThreads) {
      const int r = e / (QB / 4), c = (e % (QB / 4)) * 4;
      const int j = j0 + r;
      cp_piece(Bs + r * BST + c, Bm + (row0 + j) * N + n0 + c,
               j < Q ? clamp4(N - n0 - c) : 0, Bm, vec);
    }
#pragma unroll
    for (int e = tid; e < KT * (PT / 4); e += kThreads) {
      const int r = e / (PT / 4), c = (e % (PT / 4)) * 4;
      const int j = j0 + r;
      cp_piece(Xs + r * XST + c, x + ((row0 + j) * H + h) * P + p0 + c,
               j < Q ? clamp4(P - p0 - c) : 0, x, vec);
    }
  };
  load(0, 0);
  cp_commit();
  if (nk > 1) load(1, 1);
  cp_commit();

  const float a_h = A[h];
  for (int i = tid; i < kMaxChunk; i += kThreads) {
    const float d = i < Q ? dt[(row0 + i) * H + h] : 0.f;
    dts[i] = d;
    cum[i] = d * a_h;
  }
  __syncthreads();
  if (tid < 32) {              // inclusive cumsum: serial per lane, then a
    const int per = (Q + 31) / 32;          // warp scan of the lane totals
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
  if (slab == 0 && p0 == 0)
    for (int i = tid; i < Q; i += kThreads)
      cum_g[((size_t)bc * H + h) * Q + i] = cum[i];

  const int pcol = wc * (PT / 2);             // the warp's columns
  const bool live = n0 + mrow < N;
  float acc[2][NF][4] = {};
  for (int u = 0; u < nk; ++u) {
    if (u + 2 < nk) load(u + 2, (u + 2) % kStages);
    cp_commit();
    cp_wait<2>();
    __syncthreads();
    const float* Bs = ring + (u % kStages) * C_::stage;
    const float* Xs = Bs + C_::stage_ab;
    if (live) {
#pragma unroll
      for (int k0 = 0; k0 < KT; k0 += 8) {
        // A = (w.B)^T: A[n][j] = w_j B[j][n], w_j = exp(seg - cum_j) dt_j
        // (zero past the chunk, where dt is zero)
        const int ja = u * KT + k0 + t, jb = ja + 4;
        const float w0 = clipped_exp(seg - cum[ja]) * dts[ja];
        const float w1 = clipped_exp(seg - cum[jb]) * dts[jb];
        float a[2][4], b[NF][2];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          const float* p = Bs + (k0 + t) * BST + mrow + 16 * mf + g;
          a[mf][0] = p[0] * w0;
          a[mf][1] = p[8] * w0;
          a[mf][2] = p[4 * BST] * w1;
          a[mf][3] = p[4 * BST + 8] * w1;
        }
        b_frags<NF>(b, Xs, XST, k0, pcol);
        mma3_step(acc, a, b);
      }
    }
    __syncthreads();
  }
  if (!live) return;
  float* sb = states + ((size_t)bc * H + h) * N * P;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = n0 + mrow + 16 * mf + g + 8 * hf;
        const int p = p0 + pcol + 8 * nf + 2 * t;
        if (n < N && p < P)
          *reinterpret_cast<float2*>(sb + (size_t)n * P + p) =
              make_float2(acc[mf][nf][2 * hf], acc[mf][nf][2 * hf + 1]);
      }
}

// S_k = exp(seg_k) S_{k-1} + s_chunk_k over the chunks of each (batch row,
// head), four state entries a thread: ``prev`` gets the state entering
// each chunk, ``state_out`` the final one. Grid (ceil(N*P/1024), H, b).
__global__ void __launch_bounds__(256) ssd_pass_kernel(
    const float4* __restrict__ chunk_states, float4* __restrict__ prev,
    const float* __restrict__ cum_g, float4* __restrict__ state_out, int H,
    int np4, int Q, int nc) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= np4) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const size_t bh = ((size_t)b * nc + c) * H + h;
    const float4 v = chunk_states[bh * np4 + e];
    const float gc = clipped_exp(cum_g[bh * Q + Q - 1]);
    prev[bh * np4 + e] = s;
    s = make_float4(gc * s.x + v.x, gc * s.y + v.y, gc * s.z + v.z,
                    gc * s.w + v.w);
  }
  state_out[((size_t)b * H + h) * np4 + e] = s;
}

// Grid (H * n_psl, b * nc, ceil(Q/64)): 64 query rows of one chunk and
// head, PT columns of x. Blocks are dispatched heads first, then chunks
// and query rows from the last, so the longest k loops (late rows of late
// chunks) start in the first wave. k loop: the state rows (inter-chunk
// part, chunks after the first), then the key columns up to the diagonal.
template <int PT>
__global__ void __launch_bounds__(kThreads) ssd_out_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Cm, const float* __restrict__ G,
    const float* __restrict__ cum_g, const float* __restrict__ prev,
    float* __restrict__ y, int H, int P, int N, int Q, int Qp, int nc,
    int n_psl) {
  using C_ = Cfg<PT>;
  constexpr int NF = C_::NF, XST = C_::XST;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* cum = ring + kStages * C_::stage;
  float* dts = cum + kMaxChunk;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x / n_psl, p0 = (blockIdx.x % n_psl) * PT;
  const int bc = gridDim.y - 1 - blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * QB;
  const size_t row0 = (size_t)bc * Q;
  const float* cb = cum_g + ((size_t)bc * H + h) * Q;
  const float* sb = prev + ((size_t)bc * H + h) * N * P;
  const float* Gb = G + (size_t)bc * Q * Qp;
  const int mrow = WM * (warp & 1), pcol = (warp >> 1) * (PT / 2);
  const bool vec = rows_aligned(x, Cm, Cm, N);  // scratch rows always are

  const int n_inter = bc % nc ? (N + KT - 1) / KT : 0;
  const int n_intra = (min(i0 + QB, Q) + KT - 1) / KT;
  const int nk = n_inter + n_intra;
  auto load = [&](int u, int s) {
    float* As = ring + s * C_::stage;
    float* Bs = As + C_::stage_ab;
    if (u < n_inter) {                        // C rows and entering state
      const int n0 = u * KT;
#pragma unroll
      for (int e = tid; e < QB * (KT / 4); e += kThreads) {
        const int r = e / (KT / 4), c = (e % (KT / 4)) * 4;
        const int i = i0 + r;
        cp_piece(As + r * RST + c, Cm + (row0 + i) * N + n0 + c,
                 i < Q ? clamp4(N - n0 - c) : 0, Cm, vec);
      }
#pragma unroll
      for (int e = tid; e < KT * (PT / 4); e += kThreads) {
        const int r = e / (PT / 4), c = (e % (PT / 4)) * 4;
        const int n = n0 + r;
        cp_piece(Bs + r * XST + c, sb + (size_t)n * P + p0 + c,
                 n < N ? clamp4(P - p0 - c) : 0, prev, vec);
      }
    } else {                                  // score rows and x rows
      const int j0 = (u - n_inter) * KT;
#pragma unroll
      for (int e = tid; e < QB * (KT / 4); e += kThreads) {
        const int r = e / (KT / 4), c = (e % (KT / 4)) * 4;
        const int i = i0 + r;
        cp_piece(As + r * RST + c, Gb + (size_t)i * Qp + j0 + c,
                 i < Q ? 4 : 0, G, vec);
      }
#pragma unroll
      for (int e = tid; e < KT * (PT / 4); e += kThreads) {
        const int r = e / (PT / 4), c = (e % (PT / 4)) * 4;
        const int j = j0 + r;
        cp_piece(Bs + r * XST + c, x + ((row0 + j) * H + h) * P + p0 + c,
                 j < Q ? clamp4(P - p0 - c) : 0, x, vec);
      }
    }
  };

  load(0, 0);
  cp_commit();
  if (nk > 1) load(1, 1);
  cp_commit();
  for (int i = tid; i < Q; i += kThreads) {
    cum[i] = cb[i];
    dts[i] = dt[(row0 + i) * H + h];
  }
  __syncthreads();

  // this lane's rows: i0 + mrow + 16 mf + g + 8 hf
  float cum_r[2][2], e_r[2][2];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = i0 + mrow + 16 * mf + g + 8 * hf;
      cum_r[mf][hf] = i < Q ? cum[i] : 0.f;
      e_r[mf][hf] = i < Q ? clipped_exp(cum[i]) : 0.f;
    }
  const int r_first = i0 + mrow, r_last = r_first + WM - 1;
  const bool live = r_first < Q;
  float acc[2][NF][4] = {};
  for (int u = 0; u < nk; ++u) {
    if (u + 2 < nk) load(u + 2, (u + 2) % kStages);
    cp_commit();
    cp_wait<2>();
    __syncthreads();
    const float* As = ring + (u % kStages) * C_::stage;
    const float* Bs = As + C_::stage_ab;
    if (live && u < n_inter) {
#pragma unroll
      for (int k0 = 0; k0 < KT; k0 += 8) {
        float a[2][4], b[NF][2];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          const float* p = As + (mrow + 16 * mf + g) * RST + k0 + t;
          a[mf][0] = p[0] * e_r[mf][0];
          a[mf][1] = p[8 * RST] * e_r[mf][1];
          a[mf][2] = p[4] * e_r[mf][0];
          a[mf][3] = p[8 * RST + 4] * e_r[mf][1];
        }
        b_frags<NF>(b, Bs, XST, k0, pcol);
        mma3_step(acc, a, b);
      }
    } else if (live) {
      const int j0 = (u - n_inter) * KT;
#pragma unroll
      for (int k0 = 0; k0 < KT; k0 += 8) {
        if (j0 + k0 > r_last) break;          // above the diagonal
        const int ja = j0 + k0 + t, jb = ja + 4;
        const float cja = cum[ja], cjb = cum[jb];
        const float dja = dts[ja], djb = dts[jb];
        float a[2][4], b[NF][2];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          const int ia = r_first + 16 * mf + g, ib = ia + 8;
          const float* p = As + (mrow + 16 * mf + g) * RST + k0 + t;
          a[mf][0] = ja <= ia && ia < Q
              ? p[0] * clipped_exp_fast(cum_r[mf][0] - cja) * dja : 0.f;
          a[mf][1] = ja <= ib && ib < Q
              ? p[8 * RST] * clipped_exp_fast(cum_r[mf][1] - cja) * dja : 0.f;
          a[mf][2] = jb <= ia && ia < Q
              ? p[4] * clipped_exp_fast(cum_r[mf][0] - cjb) * djb : 0.f;
          a[mf][3] = jb <= ib && ib < Q
              ? p[8 * RST + 4] * clipped_exp_fast(cum_r[mf][1] - cjb) * djb
              : 0.f;
        }
        b_frags<NF>(b, Bs, XST, k0, pcol);
        mma3_step(acc, a, b);
      }
    }
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = r_first + 16 * mf + g + 8 * hf;
        const int p = p0 + pcol + 8 * nf + 2 * t;
        if (i < Q && p < P)
          *reinterpret_cast<float2*>(y + ((row0 + i) * H + h) * P + p) =
              make_float2(acc[mf][nf][2 * hf], acc[mf][nf][2 * hf + 1]);
      }
}

template <int PT>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bm, const float* Cm, float* y, float* state,
                   float* G, float* cum, float* states, float* prev, int b,
                   int S, int H, int P, int N, int Q, cudaStream_t stream) {
  const int nc = S / Q;
  const int Qp = (Q + KT - 1) / KT * KT;
  const int n_slab = (N + QB - 1) / QB;
  const int n_psl = (P + PT - 1) / PT;
  const int nt = (Q + QB - 1) / QB;
  const long long grid_a =
      (long long)H * n_slab * n_psl + (long long)nt * (nt + 1) / 2;
  const long long bcs = (long long)b * nc;
  if (bcs > 65535 || (long long)H * n_psl > 65535 || grid_a > 0x7fffffff)
    return cudaErrorInvalidValue;

  const size_t smem = sizeof(float) * Cfg<PT>::floats;
  static bool attr_set = false;
  if (!attr_set) {
    // dynamic shared memory past 48 KB, and the most shared memory an SM
    // can carve out, so four blocks fit
    cudaError_t e = cudaSuccess;
    const void* kernels[2] = {(const void*)ssd_state_kernel<PT>,
                              (const void*)ssd_out_kernel<PT>};
    for (const void* k : kernels) {
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            k, cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
    }
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  // a single chunk enters with no state, so its own state is the final
  // one: the state kernel writes it out and the pass is not launched
  ssd_state_kernel<PT><<<dim3((unsigned)grid_a, (unsigned)bcs), kThreads,
                         smem, stream>>>(x, dt, A, Bm, Cm, G, cum,
                                         nc == 1 ? state : states, H, P, N,
                                         Q, Qp, n_slab, n_psl);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (nc > 1) {
    const int np4 = N * P / 4;                // P is a multiple of 16
    ssd_pass_kernel<<<dim3((np4 + 255) / 256, H, b), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(states),
        reinterpret_cast<float4*>(prev), cum,
        reinterpret_cast<float4*>(state), H, np4, Q, nc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  ssd_out_kernel<PT><<<dim3(H * n_psl, (unsigned)bcs, nt), kThreads, smem,
                       stream>>>(x, dt, Cm, G, cum, prev, y, H, P, N, Q, Qp,
                                 nc, n_psl);
  return cudaGetLastError();
}

}  // namespace

// x (b,S,H,P), dt (b,S,H), A (H,), B and C (b,S,N) in; y (b,S,H,P), state
// (b,H,N,P) out. Float32 scratch: scores (b*S/chunk, chunk, Qp) with Qp =
// chunk rounded up to 32, cum (b*S/chunk, H, chunk), the chunks' own states
// and the states entering them, each (b*S/chunk, H, N, P). pt: the P slice
// (16, 32, 64 or 128). Returns a cudaError_t code (0 = ok).
extern "C" int ssd_launch(const void* x, const void* dt, const void* A,
                          const void* B, const void* C, void* y, void* state,
                          void* scores, void* cum, void* states, void* prev,
                          int b, int S, int H, int P, int N, int chunk,
                          int pt, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || N <= 0 || N > kMaxState || chunk <= 0 ||
      chunk > kMaxChunk || S % chunk != 0 || P <= 0 || P % 16 != 0 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(B);
  const float* Cf = static_cast<const float*>(C);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  float* Gf = static_cast<float*>(scores);
  float* cf = static_cast<float*>(cum);
  float* stf = static_cast<float*>(states);
  float* pvf = static_cast<float*>(prev);
#define SSD_LAUNCH(PT_)                                                     \
  return (int)launch<PT_>(xf, dtf, Af, Bf, Cf, yf, sf, Gf, cf, stf, pvf, b, \
                          S, H, P, N, chunk, s)
  switch (pt) {
    case 16: SSD_LAUNCH(16);
    case 32: SSD_LAUNCH(32);
    case 64: SSD_LAUNCH(64);
    case 128: SSD_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSD_LAUNCH
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
