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
//
// The backward (ssd_bwd_launch) is the vjp of the same chunked function,
// the gradient the JAX package's custom_vjp takes (its _bwd_vjp, at
// src/repro/kernels/ssd/ops.py:39, is the vjp of the chunked XLA path:
// the TPU has no backward kernel); each clipped exponent passes its
// gradient as torch.clamp does (none below -60, all at the bounds). It
// recomputes C.B^T, cum and the entering states with the forward's first
// two kernels instead of keeping them from the forward: the entering
// states alone are half of x's bytes at mamba2-2.7b's chunk of 256, and a
// training step would hold them for every ssm layer from its forward to
// its backward, while the two kernels are a small part of the backward's
// time. Then, on the same stream, in _ssd_chunked's phases run backwards:
//   ssd_bwd_u_kernel, the state kernel's product with C and dY:
//     u_k = (e^cum C)^T dY_k;
//   ssd_bwd_pass_kernel, the only recurrence, serial over the chunks of
//     each (batch row, head): lam_k, the gradient of the state leaving
//     chunk k (lam_last = the final state's cotangent, lam_{k-1} =
//     exp(seg_k) lam_k + u_k), and dg_k = <lam_k, S_prev_k>;
//   ssd_bwd_dp_kernel, per 64 x 64 tile of a chunk at or below the
//     diagonal and a group of heads, one head after another: dP = dY X^T,
//     dG = sum_h dP o L and the gradients of L's exponents (summed over
//     the head groups in order by ssd_bwd_dg_sum_kernel);
//   ssd_bwd_dx_kernel, shaped like the output kernel with its operands
//     transposed: dX = (G o L)^T dY + diag(w) B lam_k, and on the way the
//     row dots that give w's and e^cum's gradients;
//   ssd_bwd_dbc_kernel, per 64 rows and 64 state columns of a chunk and a
//     group of heads: dC = dG B + sum_h diag(e^cum) dY S_prev^T, dB = dG^T
//     C + sum_h diag(w) X lam^T (its parts summed by ssd_bwd_dbc_sum_kernel);
//   ssd_bwd_dt_kernel and ssd_bwd_da_sum_kernel: d(dt A), ddt and dA.
// Products run in 3xTF32 on mma.sync, with the forward's ring and
// fragment helpers. Every sum across heads, tiles, chunks or batch rows
// has one order (the head groups follow from the shape alone, their
// parts are summed in order) and nothing uses atomics, so two calls give
// the same bits. Every exponent is a sum of d(dt A) over a range of the
// chunk, and its gradient goes to each position of the range directly
// (the pairs that straddle it, prefix and suffix sums): a reverse cumsum
// of row sums less column sums would cancel terms and lose float32 digits
// at a strong decay. w's clip is tested on the sum of d(dt A) after j
// itself, which is exactly 0 over a zero tail, where seg - cum_j of the
// forward's scan may round above 0.
//
// What bounds the backward: operations, as the forward's, about twice its
// products (kernels/ssd/ops.py:cost_bwd). What holds it back: the
// forward's limits, and besides, its loops over heads: the dP kernel
// walks its group of heads tile by tile, each head's epilogue (the decay,
// row and column sums; on a diagonal tile a serial prefix over R)
// stalling the tensor pipe, and the dB/dC kernel's inter-chunk product
// runs over H x P, in long k loops over few blocks.

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


// ===========================================================================
// The backward: the vjp of the chunked algorithm (ssd_bwd_launch below)
// ===========================================================================

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 1 where clamp(v, -60, 0) passes its gradient (the bounds included)
__device__ __forceinline__ float in_clip(float v) {
  return v >= -60.f && v <= 0.f ? 1.f : 0.f;
}

// The sum over a block of 256 threads, in one fixed order (a shuffle tree
// in each warp, then the eight warp sums in order); thread 0 holds it.
// ``red`` is 8 floats of shared memory; every thread must call it.
__device__ __forceinline__ float block_sum256(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < 8; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Inclusive suffix (and prefix) sums over a block of 256 threads, in one
// fixed order: a shuffle scan in each warp, then the later (earlier) warps'
// totals in order. ``wsum`` is 8 floats of shared memory; every thread
// must call them.
__device__ __forceinline__ float block_suffix256(float v, float* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v += u;
  }
  if (lane == 0) wsum[warp] = v;
  __syncthreads();
  for (int w = 7; w > warp; --w) v += wsum[w];
  __syncthreads();
  return v;
}

__device__ __forceinline__ float block_prefix256(float v, float* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += wsum[w];
  __syncthreads();
  return v;
}

// Grid (H * n_slab * n_psl, b * nc): u_k = (e^cum C)^T dY over chunk k,
// 64 state rows and a P slice a block, into ``u`` (b*nc, H, N, P); the
// forward's state product with C for B and dY for x. The first chunk of
// each row is skipped: the reverse pass never reads its u.
template <int PT>
__global__ void __launch_bounds__(kThreads) ssd_bwd_u_kernel(
    const float* __restrict__ Cm, const float* __restrict__ gy,
    const float* __restrict__ cum_g, float* __restrict__ u, int H, int P,
    int N, int Q, int nc, int n_slab, int n_psl) {
  using C_ = Cfg<PT>;
  constexpr int NF = C_::NF, XST = C_::XST;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* es = ring + kStages * C_::stage;

  const int bc = blockIdx.y;
  if (bc % nc == 0) return;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)bc * Q;
  const int h = blockIdx.x / (n_slab * n_psl);
  const int slab = (blockIdx.x / n_psl) % n_slab;
  const int n0 = slab * QB, p0 = (blockIdx.x % n_psl) * PT;
  const int mrow = WM * (warp & 1), pcol = (warp >> 1) * (PT / 2);
  const bool vec = rows_aligned(Cm, gy, Cm, N);
  const int nk = (Q + KT - 1) / KT;
  auto load = [&](int v, int s) {
    float* Cs = ring + s * C_::stage;
    float* Ys = Cs + C_::stage_ab;
    const int j0 = v * KT;
#pragma unroll
    for (int e = tid; e < KT * (QB / 4); e += kThreads) {
      const int r = e / (QB / 4), c = (e % (QB / 4)) * 4;
      const int j = j0 + r;
      cp_piece(Cs + r * BST + c, Cm + (row0 + j) * N + n0 + c,
               j < Q ? clamp4(N - n0 - c) : 0, Cm, vec);
    }
#pragma unroll
    for (int e = tid; e < KT * (PT / 4); e += kThreads) {
      const int r = e / (PT / 4), c = (e % (PT / 4)) * 4;
      const int j = j0 + r;
      cp_piece(Ys + r * XST + c, gy + ((row0 + j) * H + h) * P + p0 + c,
               j < Q ? clamp4(P - p0 - c) : 0, gy, vec);
    }
  };
  load(0, 0);
  cp_commit();
  if (nk > 1) load(1, 1);
  cp_commit();
  const float* cb = cum_g + ((size_t)bc * H + h) * Q;
  for (int i = tid; i < kMaxChunk; i += kThreads)
    es[i] = i < Q ? clipped_exp(cb[i]) : 0.f;
  __syncthreads();

  const bool live = n0 + mrow < N;
  float acc[2][NF][4] = {};
  for (int v = 0; v < nk; ++v) {
    if (v + 2 < nk) load(v + 2, (v + 2) % kStages);
    cp_commit();
    cp_wait<2>();
    __syncthreads();
    const float* Cs = ring + (v % kStages) * C_::stage;
    const float* Ys = Cs + C_::stage_ab;
    if (live) {
#pragma unroll
      for (int k0 = 0; k0 < KT; k0 += 8) {
        // A = (e.C)^T: A[n][j] = e_j C[j][n]
        const int ja = v * KT + k0 + t, jb = ja + 4;
        const float e0 = es[ja], e1 = es[jb];
        float a[2][4], b[NF][2];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          const float* p = Cs + (k0 + t) * BST + mrow + 16 * mf + g;
          a[mf][0] = p[0] * e0;
          a[mf][1] = p[8] * e0;
          a[mf][2] = p[4 * BST] * e1;
          a[mf][3] = p[4 * BST + 8] * e1;
        }
        b_frags<NF>(b, Ys, XST, k0, pcol);
        mma3_step(acc, a, b);
      }
    }
    __syncthreads();
  }
  if (!live) return;
  float* ub = u + ((size_t)bc * H + h) * N * P;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = n0 + mrow + 16 * mf + g + 8 * hf;
        const int p = p0 + pcol + 8 * nf + 2 * t;
        if (n < N && p < P)
          *reinterpret_cast<float2*>(ub + (size_t)n * P + p) =
              make_float2(acc[mf][nf][2 * hf], acc[mf][nf][2 * hf + 1]);
      }
}

// The reverse pass over the chunks of each (batch row, head), four state
// entries a thread, grid (n_eb, H, b): lam_last = gstate (0 when null),
// lam_{k-1} = exp(seg_k) lam_k + u_k; writes lam_k, the gradient of the
// state leaving chunk k, and this block's part of dg_k = <lam_k, S_prev_k>
// (0 for the first chunk, which enters with no state).
__global__ void __launch_bounds__(256) ssd_bwd_pass_kernel(
    const float4* __restrict__ u, const float4* __restrict__ prev,
    const float* __restrict__ cum_g, const float4* __restrict__ gstate,
    float4* __restrict__ lam, float* __restrict__ dg_part, int H, int np4,
    int Q, int nc) {
  __shared__ float red[8];
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, n_eb = gridDim.x;
  const bool on = e < np4;
  float4 l = make_float4(0.f, 0.f, 0.f, 0.f);
  if (on && gstate) l = gstate[((size_t)b * H + h) * np4 + e];
  for (int c = nc - 1; c >= 0; --c) {
    const size_t bh = ((size_t)b * nc + c) * H + h;
    if (on) lam[bh * np4 + e] = l;
    float d = 0.f;
    if (c > 0 && on) {
      const float4 pv = prev[bh * np4 + e];
      d = l.x * pv.x + l.y * pv.y + l.z * pv.z + l.w * pv.w;
    }
    d = block_sum256(d, red);
    if (threadIdx.x == 0) dg_part[bh * n_eb + blockIdx.x] = d;
    if (c > 0 && on) {
      const float gc = clipped_exp(cum_g[bh * Q + Q - 1]);
      const float4 v = u[bh * np4 + e];
      l = make_float4(gc * l.x + v.x, gc * l.y + v.y, gc * l.z + v.z,
                      gc * l.w + v.w);
    }
  }
}

// Shared memory of ssd_bwd_dp_kernel, in floats: a ring of dY and x tiles
// (64 rows x 32 columns each), the block's C.B^T tile, a diagonal tile's
// R, and the row and column sums of two warps
constexpr int RS = QB + 1;        // row stride of R: rows and columns both
                                  // conflict-free
struct DpCfg {
  static constexpr int stage = 2 * QB * RST;
  static constexpr int gtile = QB * BST;
  static constexpr int floats = kStages * stage + gtile + QB * RS + 6 * QB;
};

// Grid (score tiles, head groups, b * nc): one 64 x 64 tile (it, jt) of a
// chunk at or below the diagonal, over the heads of one group in order.
// For each head dP = dY X^T (k over P), then per element, with L = E dt_j,
// E = exp(clip(cum_i - cum_j)) where j <= i:
//   dG += dP L (summed over the group's heads into dGp, this group's part);
//   R = dP G E dt_j where j < i and the clip passes: the gradient of
//   cum_i - cum_j, the sum of d(dt A) over (j, i], so each position m
//   in (j, i] gets R_ij. Off the diagonal every pair straddles the tiles'
//   boundary: R's row sums go to rsum[., jt, i], its column sums to
//   csum[., it, j], and ssd_bwd_dt_kernel adds them over the positions
//   between. On a diagonal tile each m gets sum_{i >= m > j} R_ij here
//   (row prefixes of R over j, then column sums over i), into sdiag;
//   the column sums of dP G E (ddt's direct term from L) into dsum[., it, j].
__global__ void __launch_bounds__(kThreads) ssd_bwd_dp_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ gy, const float* __restrict__ G,
    const float* __restrict__ cum_g, float* __restrict__ dGp,
    float* __restrict__ rsum, float* __restrict__ csum,
    float* __restrict__ dsum, float* __restrict__ sdiag, int H, int P, int Q,
    int Qp, int nt, int hg_size) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* Gs = ring + kStages * DpCfg::stage;
  float* Rs = Gs + DpCfg::gtile;              // [64][RS]: a diagonal tile
  float* red_r = Rs + QB * RS;                // [2][64]: column warps
  float* red_c = red_r + 2 * QB;              // [2][64]: row warps
  float* red_d = red_c + 2 * QB;              // [2][64]: row warps

  const int tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  int tile = blockIdx.x, it = 0;
  while (tile > it) tile -= ++it;             // tile = it*(it+1)/2 + jt
  const int jt = tile;
  const int i0 = it * QB, j0 = jt * QB;
  const int bc = blockIdx.z;
  const int h0 = blockIdx.y * hg_size, h1 = min(H, h0 + hg_size);
  const size_t row0 = (size_t)bc * Q;
  const int mrow = WM * (warp & 1), ncol = 32 * (warp >> 1);
  const int wr = warp & 1, wc = warp >> 1;
  const bool vec = rows_aligned(x, gy, gy, P);
  const int npc = (P + KT - 1) / KT;
  const int nk = (h1 - h0) * npc;

  auto load = [&](int v, int s) {
    float* Ys = ring + s * DpCfg::stage;
    float* Xs = Ys + QB * RST;
    const int h = h0 + v / npc, p0 = (v % npc) * KT;
#pragma unroll
    for (int e = tid; e < 2 * QB * (KT / 4); e += kThreads) {
      const int which = e / (QB * (KT / 4));
      const int r = (e / (KT / 4)) % QB, c = (e % (KT / 4)) * 4;
      const int row = (which ? j0 : i0) + r;
      cp_piece((which ? Xs : Ys) + r * RST + c,
               (which ? x : gy) + ((row0 + row) * H + h) * P + p0 + c,
               row < Q ? clamp4(P - p0 - c) : 0, x, vec);
    }
  };
  load(0, 0);
  cp_commit();
  if (nk > 1) load(1, 1);
  cp_commit();
  const float* Gb = G + (size_t)bc * Q * Qp;
  for (int e = tid; e < QB * QB; e += kThreads) {
    const int r = e / QB, c = e % QB, i = i0 + r, j = j0 + c;
    Gs[r * BST + c] = i < Q && j <= i ? Gb[(size_t)i * Qp + j] : 0.f;
  }
  // this lane's rows i0 + mrow + 16 mf + g + 8 hf and columns
  // j0 + ncol + 8 nf + 2 t + e1
  float dGa[2][4][4] = {}, acc[2][4][4] = {};
  for (int v = 0; v < nk; ++v) {
    if (v + 2 < nk) load(v + 2, (v + 2) % kStages);
    cp_commit();
    cp_wait<2>();
    __syncthreads();
    const float* Ys = ring + (v % kStages) * DpCfg::stage;
    const float* Xs = Ys + QB * RST;
#pragma unroll
    for (int k0 = 0; k0 < KT; k0 += 8) {
      float a[2][4], b[4][2];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        const float* p = Ys + (mrow + 16 * mf + g) * RST + k0 + t;
        a[mf][0] = p[0];
        a[mf][1] = p[8 * RST];
        a[mf][2] = p[4];
        a[mf][3] = p[8 * RST + 4];
      }
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {        // X^T: row p = k, column j
        const float* p = Xs + (ncol + 8 * nf + g) * RST + k0 + t;
        b[nf][0] = p[0];
        b[nf][1] = p[4];
      }
      mma3_step(acc, a, b);
    }
    __syncthreads();
    if ((v + 1) % npc) continue;
    // ---- the head's dP is complete: its products with the decay ---------
    const int h = h0 + v / npc;
    const float* cb = cum_g + ((size_t)bc * H + h) * Q;
    float ci[2][2], cj[4][2], dj[4][2];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = i0 + mrow + 16 * mf + g + 8 * hf;
        ci[mf][hf] = i < Q ? cb[i] : 0.f;
      }
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int j = j0 + ncol + 8 * nf + 2 * t + e1;
        cj[nf][e1] = j < Q ? cb[j] : 0.f;
        dj[nf][e1] = j < Q ? dt[(row0 + j) * H + h] : 0.f;
      }
    const bool diag = it == jt;
    float rowp[2][2] = {}, colR[4][2] = {}, colD[4][2] = {};
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1, e1 = e & 1;
          const int r = mrow + 16 * mf + g + 8 * hf;
          const int c = ncol + 8 * nf + 2 * t + e1;
          const bool ok = i0 + r < Q && j0 + c <= i0 + r;
          const float d = ci[mf][hf] - cj[nf][e1];
          const float E = ok ? clipped_exp(d) : 0.f;
          const float dp = acc[mf][nf][e];
          dGa[mf][nf][e] += dp * (E * dj[nf][e1]);
          const float t1 = dp * Gs[r * BST + c] * E;
          // the diagonal's exponent is 0 whatever cum is: no gradient
          const float R = j0 + c < i0 + r ? t1 * dj[nf][e1] * in_clip(d)
                                          : 0.f;
          if (diag) {
            Rs[r * RS + c] = R;
          } else {
            rowp[mf][hf] += R;
            colR[nf][e1] += R;
          }
          colD[nf][e1] += t1;
          acc[mf][nf][e] = 0.f;
        }
    if (!diag) {
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float s = rowp[mf][hf];
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          if (t == 0) red_r[wc * QB + mrow + 16 * mf + 8 * hf + g] = s;
        }
    }
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        float s = colR[nf][e1], sd = colD[nf][e1];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, o);
          sd += __shfl_xor_sync(0xffffffffu, sd, o);
        }
        if (g == 0) {
          red_c[wr * QB + ncol + 8 * nf + 2 * t + e1] = s;
          red_d[wr * QB + ncol + 8 * nf + 2 * t + e1] = sd;
        }
      }
    __syncthreads();
    const size_t bh = (size_t)bc * H + h;
    if (tid < QB) {
      if (diag) {                             // R's row: exclusive prefix
        float run = 0.f;
        for (int c = 0; c < QB; ++c) {
          const float v = Rs[tid * RS + c];
          Rs[tid * RS + c] = run;
          run += v;
        }
      } else if (i0 + tid < Q) {
        rsum[(bh * nt + jt) * Q + i0 + tid] = red_r[tid] + red_r[QB + tid];
      }
    } else {
      const int c = tid - QB;
      if (j0 + c < Q) {
        if (!diag)
          csum[(bh * nt + it) * Q + j0 + c] = red_c[c] + red_c[QB + c];
        dsum[(bh * nt + it) * Q + j0 + c] = red_d[c] + red_d[QB + c];
      }
    }
    __syncthreads();
    if (diag) {                               // sum_{i >= m} prefix_i(m)
      if (tid < QB && i0 + tid < Q) {
        float s = 0.f;
        for (int r = tid; r < QB; ++r) s += Rs[r * RS + tid];
        sdiag[bh * Q + i0 + tid] = s;
      }
      __syncthreads();
    }
  }
  float* Db = dGp + ((size_t)blockIdx.y * gridDim.z + bc) * Q * Qp;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + mrow + 16 * mf + g + 8 * (e >> 1);
        const int j = j0 + ncol + 8 * nf + 2 * t + (e & 1);
        if (i < Q && j < Q) Db[(size_t)i * Qp + j] = dGa[mf][nf][e];
      }
}

// dG = the head groups' parts summed in order, over every (chunk, i < Q,
// j < Qp); zero where j >= Q or above the diagonal tiles, so every entry
// the later products read is a number
__global__ void __launch_bounds__(256) ssd_bwd_dg_sum_kernel(
    const float* __restrict__ dGp, float* __restrict__ dG, int Q, int Qp,
    int n_hg, size_t per) {
  const size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= per) return;
  const int j = (int)(idx % Qp), i = (int)((idx / Qp) % Q);
  float s = 0.f;
  if (j < Q && j / QB <= i / QB)
    for (int k = 0; k < n_hg; ++k) s += dGp[(size_t)k * per + idx];
  dG[idx] = s;
}

// Shared memory of ssd_bwd_dx_kernel, in floats: the forward's ring, cum
// and dt of the chunk, the row sums of two warps
template <int PT>
struct DxCfg {
  static constexpr int floats = Cfg<PT>::floats + 2 * QB;
};

// Grid (H * n_psl, b * nc, ceil(Q/64)): 64 rows r of one chunk and head,
// PT columns of x. Three k loops:
//   (C S_prev) over the state rows (chunks after the first): its row dot
//   with dY is de_r, the gradient of exp(cum_r), into de_part;
//   (B lam_k) over the state rows: its row dot with x is dw_r, the
//   gradient of w_r, into dw_part; then scaled by w_r, it is dX's state
//   term;
//   (G o L)^T dY over the rows i >= r: dX's intra-chunk term.
// de_part and dw_part hold one part a P slice: (b*nc, H, n_psl, Q).
template <int PT>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dx_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ gy, const float* __restrict__ G,
    const float* __restrict__ cum_g, const float* __restrict__ prev,
    const float* __restrict__ lam, float* __restrict__ dx,
    float* __restrict__ dw_part, float* __restrict__ de_part, int H, int P,
    int N, int Q, int Qp, int nc, int n_psl) {
  using C_ = Cfg<PT>;
  constexpr int NF = C_::NF, XST = C_::XST;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* cum = ring + kStages * C_::stage;
  float* dts = cum + kMaxChunk;
  float* red = dts + kMaxChunk;               // [2][64]: column warps

  const int tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x / n_psl, psl = blockIdx.x % n_psl;
  const int p0 = psl * PT;
  const int bc = blockIdx.y, r0 = blockIdx.z * QB;
  const size_t row0 = (size_t)bc * Q, bh = (size_t)bc * H + h;
  const int mrow = WM * (warp & 1), pcol = (warp >> 1) * (PT / 2);
  const int wc = warp >> 1;
  const bool vec = rows_aligned(Bm, Cm, x, N) && aligned16(gy);
  const float* sp = prev + bh * N * P;
  const float* sl = lam + bh * N * P;

  const int nN = (N + KT - 1) / KT;
  const int n3 = bc % nc ? nN : 0;            // C S_prev: not the first chunk
  const int n13 = n3 + nN;                    // then B lam
  const int nk = n13 + (Q - r0 + KT - 1) / KT;  // then i from r0 up
  auto load = [&](int v, int s) {
    float* As = ring + s * C_::stage;
    float* Bs = As + C_::stage_ab;
    if (v < n13) {                            // (row r, k n); (k n, p)
      const float* Mr = v < n3 ? Cm : Bm;
      const float* St = v < n3 ? sp : sl;
      const int n0 = (v < n3 ? v : v - n3) * KT;
#pragma unroll
      for (int e = tid; e < QB * (KT / 4); e += kThreads) {
        const int r = e / (KT / 4), c = (e % (KT / 4)) * 4;
        const int i = r0 + r;
        cp_piece(As + r * RST + c, Mr + (row0 + i) * N + n0 + c,
                 i < Q ? clamp4(N - n0 - c) : 0, Bm, vec);
      }
#pragma unroll
      for (int e = tid; e < KT * (PT / 4); e += kThreads) {
        const int r = e / (PT / 4), c = (e % (PT / 4)) * 4;
        const int n = n0 + r;
        cp_piece(Bs + r * XST + c, St + (size_t)n * P + p0 + c,
                 n < N ? clamp4(P - p0 - c) : 0, lam, vec);
      }
    } else {                                  // (k i, r) of G; (k i, p) of dY
      const int ik = r0 + (v - n13) * KT;
#pragma unroll
      for (int e = tid; e < KT * (QB / 4); e += kThreads) {
        const int r = e / (QB / 4), c = (e % (QB / 4)) * 4;
        const int i = ik + r;
        cp_piece(As + r * BST + c, G + (row0 + i) * Qp + r0 + c,
                 i < Q ? clamp4(Q - r0 - c) : 0, G, vec);
      }
#pragma unroll
      for (int e = tid; e < KT * (PT / 4); e += kThreads) {
        const int r = e / (PT / 4), c = (e % (PT / 4)) * 4;
        const int i = ik + r;
        cp_piece(Bs + r * XST + c, gy + ((row0 + i) * H + h) * P + p0 + c,
                 i < Q ? clamp4(P - p0 - c) : 0, gy, vec);
      }
    }
  };
  load(0, 0);
  cp_commit();
  if (nk > 1) load(1, 1);
  cp_commit();
  const float* cb = cum_g + bh * Q;
  for (int i = tid; i < kMaxChunk; i += kThreads) {
    cum[i] = i < Q ? cb[i] : 0.f;
    dts[i] = i < Q ? dt[(row0 + i) * H + h] : 0.f;
  }
  if (!n3 && tid < QB && r0 + tid < Q)        // the first chunk: de = 0
    de_part[(bh * n_psl + psl) * Q + r0 + tid] = 0.f;
  __syncthreads();

  // this lane's rows r_first + 16 mf + g + 8 hf
  const int r_first = r0 + mrow;
  const bool live = r_first < Q;
  const float seg = cum[Q - 1];
  float cr[2][2], dr[2][2], wr[2][2];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r_first + 16 * mf + g + 8 * hf;
      cr[mf][hf] = r < Q ? cum[r] : 0.f;
      dr[mf][hf] = r < Q ? dts[r] : 0.f;
      wr[mf][hf] = r < Q ? clipped_exp(seg - cum[r]) * dts[r] : 0.f;
    }
  // the lane's row dots of acc with dY or x over its columns, summed
  // over the block's columns into part[., psl, r]
  auto row_dot = [&](const float (&acc)[2][NF][4], const float* V,
                     float* part) {
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r_first + 16 * mf + g + 8 * hf;
        float s = 0.f;
        if (r < Q)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) {
            const int p = p0 + pcol + 8 * nf + 2 * t;
            if (p < P) {
              const float2 vv = *reinterpret_cast<const float2*>(
                  V + ((row0 + r) * H + h) * P + p);
              s += acc[mf][nf][2 * hf] * vv.x + acc[mf][nf][2 * hf + 1] * vv.y;
            }
          }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (t == 0) red[wc * QB + mrow + 16 * mf + 8 * hf + g] = s;
      }
    __syncthreads();
    if (tid < QB && r0 + tid < Q)
      part[(bh * n_psl + psl) * Q + r0 + tid] = red[tid] + red[QB + tid];
    __syncthreads();
  };

  float acc[2][NF][4] = {};
  for (int v = 0; v < nk; ++v) {
    if (v + 2 < nk) load(v + 2, (v + 2) % kStages);
    cp_commit();
    cp_wait<2>();
    __syncthreads();
    const float* As = ring + (v % kStages) * C_::stage;
    const float* Bs = As + C_::stage_ab;
    if (live && v < n13) {
#pragma unroll
      for (int k0 = 0; k0 < KT; k0 += 8) {
        float a[2][4], b[NF][2];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          const float* p = As + (mrow + 16 * mf + g) * RST + k0 + t;
          a[mf][0] = p[0];
          a[mf][1] = p[8 * RST];
          a[mf][2] = p[4];
          a[mf][3] = p[8 * RST + 4];
        }
        b_frags<NF>(b, Bs, XST, k0, pcol);
        mma3_step(acc, a, b);
      }
    } else if (live) {
      const int ik = r0 + (v - n13) * KT;
#pragma unroll
      for (int k0 = 0; k0 < KT; k0 += 8) {
        if (ik + k0 + 7 < r_first) continue;  // every i below the warp's rows
        const int ia = ik + k0 + t, ib = ia + 4;
        const float cia = cum[ia], cib = cum[ib];
        float a[2][4], b[NF][2];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          // A[r][i] = G[i][r] exp(cum_i - cum_r) dt_r, i >= r
          const int ra = r_first + 16 * mf + g, rb = ra + 8;
          const float* p = As + (k0 + t) * BST + mrow + 16 * mf + g;
          a[mf][0] = ia >= ra && ia < Q && ra < Q
              ? p[0] * clipped_exp_fast(cia - cr[mf][0]) * dr[mf][0] : 0.f;
          a[mf][1] = ia >= rb && ia < Q && rb < Q
              ? p[8] * clipped_exp_fast(cia - cr[mf][1]) * dr[mf][1] : 0.f;
          a[mf][2] = ib >= ra && ib < Q && ra < Q
              ? p[4 * BST] * clipped_exp_fast(cib - cr[mf][0]) * dr[mf][0]
              : 0.f;
          a[mf][3] = ib >= rb && ib < Q && rb < Q
              ? p[4 * BST + 8] * clipped_exp_fast(cib - cr[mf][1]) *
                    dr[mf][1]
              : 0.f;
        }
        b_frags<NF>(b, Bs, XST, k0, pcol);
        mma3_step(acc, a, b);
      }
    }
    __syncthreads();
    if (v == n3 - 1) {                        // (C S_prev) done: de
      row_dot(acc, gy, de_part);
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.f;
    } else if (v == n13 - 1) {                // (B lam) done: dw, then w
      row_dot(acc, x, dw_part);
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mf][nf][e] *= wr[mf][e >> 1];
    }
  }
  if (!live) return;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r_first + 16 * mf + g + 8 * hf;
        const int p = p0 + pcol + 8 * nf + 2 * t;
        if (r < Q && p < P)
          *reinterpret_cast<float2*>(dx + ((row0 + r) * H + h) * P + p) =
              make_float2(acc[mf][nf][2 * hf], acc[mf][nf][2 * hf + 1]);
      }
}

// Grid (2 * nt * n_ns, head groups, b * nc): 64 rows r and 64 state
// columns n of a chunk's dC (which 0) or dB (which 1), this head group's
// part, into part[group][which] (b*S, N):
//   dC_i = sum_{j<=i} dG_ij B_j + sum_h e^cum_i(h) sum_p dY_ihp S_prev_h[n][p]
//   dB_j = sum_{i>=j} dG_ij C_i + sum_h w_j(h) sum_p x_jhp lam_h[n][p]
// The first group adds the intra-chunk term; each group loops over its
// heads in order, k over P in slices of 32.
__global__ void __launch_bounds__(kThreads) ssd_bwd_dbc_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ gy, const float* __restrict__ dG,
    const float* __restrict__ cum_g, const float* __restrict__ prev,
    const float* __restrict__ lam, float* __restrict__ part, int H, int P,
    int N, int Q, int Qp, int nc, int nt, int n_ns, int hg_size,
    int rows_total) {
  using C_ = Cfg<64>;
  constexpr int XST = C_::XST;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int which = blockIdx.x / (nt * n_ns);
  const int r0 = (blockIdx.x / n_ns) % nt * QB, n0 = blockIdx.x % n_ns * QB;
  const int hg = blockIdx.y, bc = blockIdx.z;
  const int h0 = hg * hg_size, h1 = min(H, h0 + hg_size);
  const size_t row0 = (size_t)bc * Q;
  const int mrow = WM * (warp & 1), ncol = 32 * (warp >> 1);
  const bool vec = rows_aligned(Bm, Cm, x, N) && aligned16(gy);
  const float* V = which ? x : gy;
  const float* Rw = which ? Cm : Bm;
  const float* M = which ? lam : prev;
  const int npc = (P + KT - 1) / KT;
  const int n_intra = hg ? 0
      : which ? (Q - r0 + KT - 1) / KT : (min(r0 + QB, Q) + KT - 1) / KT;
  const int n_inter = !which && bc % nc == 0 ? 0 : (h1 - h0) * npc;
  const int nk = n_intra + n_inter;
  auto load = [&](int v, int s) {
    float* As = ring + s * C_::stage;
    float* Bs = As + C_::stage_ab;
    if (v < n_intra) {
      const int k0 = (which ? r0 : 0) + v * KT;
      if (!which) {                           // (row i, k j) of dG
#pragma unroll
        for (int e = tid; e < QB * (KT / 4); e += kThreads) {
          const int r = e / (KT / 4), c = (e % (KT / 4)) * 4;
          const int i = r0 + r;
          cp_piece(As + r * RST + c, dG + (row0 + i) * Qp + k0 + c,
                   i < Q ? 4 : 0, dG, vec);
        }
      } else {                                // (k i, row j) of dG
#pragma unroll
        for (int e = tid; e < KT * (QB / 4); e += kThreads) {
          const int r = e / (QB / 4), c = (e % (QB / 4)) * 4;
          const int i = k0 + r;
          cp_piece(As + r * BST + c, dG + (row0 + i) * Qp + r0 + c,
                   i < Q ? clamp4(Q - r0 - c) : 0, dG, vec);
        }
      }
#pragma unroll
      for (int e = tid; e < KT * (QB / 4); e += kThreads) {  // (k, n)
        const int r = e / (QB / 4), c = (e % (QB / 4)) * 4;
        const int k = k0 + r;
        cp_piece(Bs + r * XST + c, Rw + (row0 + k) * N + n0 + c,
                 k < Q ? clamp4(N - n0 - c) : 0, Bm, vec);
      }
    } else {
      const int u = v - n_intra, h = h0 + u / npc, p0 = (u % npc) * KT;
#pragma unroll
      for (int e = tid; e < QB * (KT / 4); e += kThreads) {  // (row, k p)
        const int r = e / (KT / 4), c = (e % (KT / 4)) * 4;
        const int i = r0 + r;
        cp_piece(As + r * RST + c, V + ((row0 + i) * H + h) * P + p0 + c,
                 i < Q ? clamp4(P - p0 - c) : 0, x, vec);
      }
#pragma unroll
      for (int e = tid; e < QB * (KT / 4); e += kThreads) {  // (n, k p)
        const int r = e / (KT / 4), c = (e % (KT / 4)) * 4;
        const int n = n0 + r;
        cp_piece(Bs + r * RST + c,
                 M + (((size_t)bc * H + h) * N + n) * P + p0 + c,
                 n < N ? clamp4(P - p0 - c) : 0, lam, vec);
      }
    }
  };
  load(0, 0);
  cp_commit();
  if (nk > 1) load(1, 1);
  cp_commit();

  const int r_first = r0 + mrow;
  const bool live = r_first < Q;
  float sc[2][2] = {};                        // the rows' scale for a head
  float acc[2][4][4] = {};
  for (int v = 0; v < nk; ++v) {
    if (v + 2 < nk) load(v + 2, (v + 2) % kStages);
    cp_commit();
    cp_wait<2>();
    __syncthreads();
    const float* As = ring + (v % kStages) * C_::stage;
    const float* Bs = As + C_::stage_ab;
    if (live && v < n_intra) {
#pragma unroll
      for (int k0 = 0; k0 < KT; k0 += 8) {
        float a[2][4], b[4][2];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          if (!which) {
            const float* p = As + (mrow + 16 * mf + g) * RST + k0 + t;
            a[mf][0] = p[0];
            a[mf][1] = p[8 * RST];
            a[mf][2] = p[4];
            a[mf][3] = p[8 * RST + 4];
          } else {
            const float* p = As + (k0 + t) * BST + mrow + 16 * mf + g;
            a[mf][0] = p[0];
            a[mf][1] = p[8];
            a[mf][2] = p[4 * BST];
            a[mf][3] = p[4 * BST + 8];
          }
        }
        b_frags<4>(b, Bs, XST, k0, ncol);
        mma3_step(acc, a, b);
      }
    } else if (live) {
      const int u = v - n_intra;
      if (u % npc == 0) {                     // a new head: the rows' scale
        const int h = h0 + u / npc;
        const float* cb = cum_g + ((size_t)bc * H + h) * Q;
        const float seg = cb[Q - 1];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = r_first + 16 * mf + g + 8 * hf;
            sc[mf][hf] = r >= Q ? 0.f
                : which ? clipped_exp(seg - cb[r]) * dt[(row0 + r) * H + h]
                        : clipped_exp(cb[r]);
          }
      }
#pragma unroll
      for (int k0 = 0; k0 < KT; k0 += 8) {
        float a[2][4], b[4][2];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          const float* p = As + (mrow + 16 * mf + g) * RST + k0 + t;
          a[mf][0] = p[0] * sc[mf][0];
          a[mf][1] = p[8 * RST] * sc[mf][1];
          a[mf][2] = p[4] * sc[mf][0];
          a[mf][3] = p[8 * RST + 4] * sc[mf][1];
        }
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {      // M^T: row p = k, column n
          const float* p = Bs + (ncol + 8 * nf + g) * RST + k0 + t;
          b[nf][0] = p[0];
          b[nf][1] = p[4];
        }
        mma3_step(acc, a, b);
      }
    }
    __syncthreads();
  }
  if (!live) return;
  float* pb = part + ((size_t)(hg * 2 + which) * rows_total + row0) * N;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r_first + 16 * mf + g + 8 * (e >> 1);
        const int n = n0 + ncol + 8 * nf + 2 * t + (e & 1);
        if (r < Q && n < N) pb[(size_t)r * N + n] = acc[mf][nf][e];
      }
}

// dC and dB: the head groups' parts summed in order
__global__ void __launch_bounds__(256) ssd_bwd_dbc_sum_kernel(
    const float* __restrict__ part, float* __restrict__ dC,
    float* __restrict__ dB, size_t n, int n_hg) {
  const size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= 2 * n) return;
  const int which = idx >= n;
  const size_t k = idx - (which ? n : 0);
  float s = 0.f;
  for (int gi = 0; gi < n_hg; ++gi) s += part[(size_t)(gi * 2 + which) * n + k];
  (which ? dB : dC)[k] = s;
}

// Grid (H, b * nc), one thread a position m of the chunk: d(dt A)_m, the
// gradient of every clipped exponent that sums d(dt A) over a range
// holding m:
//   cum_i - cum_j over (j, i]: sum_{i >= m > j} R_ij, from the diagonal
//   tile's own sum (sdiag), the off-diagonal tiles' column sums at
//   positions j < m of m's tile, their row sums at positions i >= m of
//   it, and the whole of every tile pair m lies between;
//   cum_i (e^cum) over [0, i]: a suffix sum of de_i e_i;
//   seg - cum_j (w) over (j, Q): a prefix sum of dw_j w_j before m, the
//   clip tested on the sum of d(dt A) after j (exactly 0 over a zero
//   tail, where seg - cum_j may round above it);
//   seg (g) over the chunk: dg_k g_k at every m.
// Then ddt = d(dt A) A + L's and w's direct terms, and this chunk's part
// of dA = sum d(dt A) dt.
__global__ void __launch_bounds__(256) ssd_bwd_dt_kernel(
    const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ cum_g, const float* __restrict__ rsum,
    const float* __restrict__ csum, const float* __restrict__ dsum,
    const float* __restrict__ sdiag, const float* __restrict__ dw_part,
    const float* __restrict__ de_part, const float* __restrict__ dg_part,
    float* __restrict__ ddt, float* __restrict__ dA_part, int H, int Q,
    int nt, int n_psl, int n_eb) {
  constexpr int kMaxTiles = kMaxChunk / QB;
  __shared__ float red[8], sA[kMaxChunk], sB[kMaxChunk];
  __shared__ float tot[kMaxTiles][8], extra;
  const int h = blockIdx.x, bc = blockIdx.y, i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5, ti = i / QB;
  const size_t bh = (size_t)bc * H + h, row0 = (size_t)bc * Q;
  const float* cb = cum_g + bh * Q;
  const float seg = cb[Q - 1], a_h = A[h];
  float U = 0.f, dce = 0.f, dwv = 0.f, direct = 0.f, dti = 0.f, da = 0.f;
  float a_i = 0.f, b_i = 0.f;
  if (i < Q) {
    const float ci = cb[i];
    dti = dt[(row0 + i) * H + h];
    da = dti * a_h;
    U = sdiag[bh * Q + i];
    float ds = 0.f, dw = 0.f, de = 0.f;
    for (int k = ti + 1; k < nt; ++k) a_i += csum[(bh * nt + k) * Q + i];
    for (int k = 0; k < ti; ++k) b_i += rsum[(bh * nt + k) * Q + i];
    for (int k = ti; k < nt; ++k) ds += dsum[(bh * nt + k) * Q + i];
    for (int k = 0; k < n_psl; ++k) {
      dw += dw_part[(bh * n_psl + k) * Q + i];
      de += de_part[(bh * n_psl + k) * Q + i];
    }
    const float W = clipped_exp(seg - ci);
    dce = de * clipped_exp(ci) * in_clip(ci);
    dwv = dw * (W * dti);
    direct = ds + dw * W;
  }
  sA[i] = a_i;
  sB[i] = b_i;
  // each tile pair's whole: column sums of tile row k over tile column
  // ti, two warps a tile column
#pragma unroll
  for (int k = 0; k < kMaxTiles; ++k) {
    float v = i < Q && k > ti && k < nt ? csum[(bh * nt + k) * Q + i] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) tot[k][warp] = v;
  }
  // d(dt A) after m: a sum of non-positive terms, 0 over a zero tail
  const float after = block_suffix256(da, red) - da;
  if (i < Q) {
    const int t0 = ti * QB, t1 = min(t0 + QB, Q);
    for (int j = t0; j < i; ++j) U += sA[j];
    for (int k = i; k < t1; ++k) U += sB[k];
    for (int k = ti + 1; k < nt; ++k)
      for (int jt = 0; jt < ti; ++jt) U += tot[k][2 * jt] + tot[k][2 * jt + 1];
  }
  const float dwe = dwv * in_clip(after);
  const float w_before = block_prefix256(dwe, red) - dwe;
  const float e_after = block_suffix256(dce, red);
  if (i == 0) {
    float dg = 0.f;
    for (int k = 0; k < n_eb; ++k) dg += dg_part[bh * n_eb + k];
    extra = dg * clipped_exp(seg) * in_clip(seg);
  }
  __syncthreads();
  const float dda = U + e_after + w_before + extra;
  if (i < Q) ddt[(row0 + i) * H + h] = dda * a_h + direct;
  const float dap = block_sum256(i < Q ? dda * dti : 0.f, red);
  if (i == 0) dA_part[bh] = dap;
}

// dA = the chunks' parts summed in order, one thread a head
__global__ void __launch_bounds__(256) ssd_bwd_da_sum_kernel(
    const float* __restrict__ dA_part, float* __restrict__ dA, int H,
    int bcs) {
  const int h = blockIdx.x * 256 + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int k = 0; k < bcs; ++k) s += dA_part[(size_t)k * H + h];
  dA[h] = s;
}

// the scratch of one backward launch, in the order ssd_bwd_launch takes
// the pointers (shapes: kernels/ssd/ops.py:bwd_scratch_shapes)
enum BwdScratch {
  kScores, kCum, kStates, kPrev, kLam, kDgPart, kDGp, kDG, kRsum, kCsum,
  kDsum, kSdiag, kDwPart, kDePart, kDbcPart, kDaPart, kNumScratch
};

cudaError_t set_smem(const void* k, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

template <int PT>
cudaError_t launch_bwd(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, const float* gy,
                       const float* gstate, float* dx, float* ddt, float* dA,
                       float* dB, float* dC, float* const* sc, int b, int S,
                       int H, int P, int N, int Q, int hg_dp, int hg_dbc,
                       cudaStream_t stream) {
  const int nc = S / Q;
  const int Qp = (Q + KT - 1) / KT * KT;
  const int n_slab = (N + QB - 1) / QB;
  const int n_psl = (P + PT - 1) / PT;
  const int nt = (Q + QB - 1) / QB;
  const int n_tiles = nt * (nt + 1) / 2;
  const long long grid_a = (long long)H * n_slab * n_psl + n_tiles;
  const long long bcs = (long long)b * nc;
  const int np4 = N * P / 4;                  // P is a multiple of 16
  const int n_eb = (np4 + 255) / 256;
  const int n_dp = (H + hg_dp - 1) / hg_dp, n_dbc = (H + hg_dbc - 1) / hg_dbc;
  if (bcs > 65535 || (long long)H * n_psl > 65535 || grid_a > 0x7fffffff ||
      n_dp > 65535 || n_dbc > 65535)
    return cudaErrorInvalidValue;

  const size_t smem = sizeof(float) * Cfg<PT>::floats;
  const size_t smem_dx = sizeof(float) * DxCfg<PT>::floats;
  const size_t smem_dp = sizeof(float) * DpCfg::floats;
  const size_t smem_dbc = sizeof(float) * Cfg<64>::floats;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = set_smem((const void*)ssd_state_kernel<PT>, smem);
    if (e == cudaSuccess) e = set_smem((const void*)ssd_bwd_u_kernel<PT>, smem);
    if (e == cudaSuccess)
      e = set_smem((const void*)ssd_bwd_dx_kernel<PT>, smem_dx);
    if (e == cudaSuccess) e = set_smem((const void*)ssd_bwd_dp_kernel, smem_dp);
    if (e == cudaSuccess)
      e = set_smem((const void*)ssd_bwd_dbc_kernel, smem_dbc);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  float* G = sc[kScores];
  float* cum = sc[kCum];
  float* states = sc[kStates];
  float* prev = sc[kPrev];
  float* lam = sc[kLam];
  cudaError_t e;
#define SSD_CHECK()                       \
  do {                                    \
    e = cudaGetLastError();               \
    if (e != cudaSuccess) return e;       \
  } while (0)
  // the forward's first two kernels recompute C.B^T, cum, the chunks'
  // states and the states entering them (the final state goes to lam,
  // which the reverse pass overwrites)
  ssd_state_kernel<PT><<<dim3((unsigned)grid_a, (unsigned)bcs), kThreads,
                         smem, stream>>>(x, dt, A, Bm, Cm, G, cum, states, H,
                                         P, N, Q, Qp, n_slab, n_psl);
  SSD_CHECK();
  if (nc > 1) {
    ssd_pass_kernel<<<dim3(n_eb, H, b), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(states),
        reinterpret_cast<float4*>(prev), cum, reinterpret_cast<float4*>(lam),
        H, np4, Q, nc);
    SSD_CHECK();
    // u_k = (e^cum C)^T dY, into the chunks' states (read by now)
    ssd_bwd_u_kernel<PT><<<dim3(H * n_slab * n_psl, (unsigned)bcs),
                           kThreads, smem, stream>>>(
        Cm, gy, cum, states, H, P, N, Q, nc, n_slab, n_psl);
    SSD_CHECK();
  }
  ssd_bwd_pass_kernel<<<dim3(n_eb, H, b), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(states),
      reinterpret_cast<const float4*>(prev), cum,
      reinterpret_cast<const float4*>(gstate), reinterpret_cast<float4*>(lam),
      sc[kDgPart], H, np4, Q, nc);
  SSD_CHECK();
  ssd_bwd_dp_kernel<<<dim3(n_tiles, n_dp, (unsigned)bcs), kThreads, smem_dp,
                      stream>>>(x, dt, gy, G, cum, sc[kDGp], sc[kRsum],
                                sc[kCsum], sc[kDsum], sc[kSdiag], H, P, Q, Qp,
                                nt, hg_dp);
  SSD_CHECK();
  const size_t per = (size_t)bcs * Q * Qp;
  ssd_bwd_dg_sum_kernel<<<(unsigned)((per + 255) / 256), 256, 0, stream>>>(
      sc[kDGp], sc[kDG], Q, Qp, n_dp, per);
  SSD_CHECK();
  ssd_bwd_dx_kernel<PT><<<dim3(H * n_psl, (unsigned)bcs, nt), kThreads,
                          smem_dx, stream>>>(
      x, dt, Bm, Cm, gy, G, cum, prev, lam, dx, sc[kDwPart], sc[kDePart], H,
      P, N, Q, Qp, nc, n_psl);
  SSD_CHECK();
  const int n_ns = (N + QB - 1) / QB;
  ssd_bwd_dbc_kernel<<<dim3(2 * nt * n_ns, n_dbc, (unsigned)bcs), kThreads,
                       smem_dbc, stream>>>(
      x, dt, Bm, Cm, gy, sc[kDG], cum, prev, lam, sc[kDbcPart], H, P, N, Q,
      Qp, nc, nt, n_ns, hg_dbc, b * S);
  SSD_CHECK();
  const size_t nbs = (size_t)b * S * N;
  ssd_bwd_dbc_sum_kernel<<<(unsigned)((2 * nbs + 255) / 256), 256, 0,
                           stream>>>(sc[kDbcPart], dC, dB, nbs, n_dbc);
  SSD_CHECK();
  ssd_bwd_dt_kernel<<<dim3(H, (unsigned)bcs), 256, 0, stream>>>(
      dt, A, cum, sc[kRsum], sc[kCsum], sc[kDsum], sc[kSdiag], sc[kDwPart],
      sc[kDePart], sc[kDgPart], ddt, sc[kDaPart], H, Q, nt, n_psl, n_eb);
  SSD_CHECK();
  ssd_bwd_da_sum_kernel<<<(H + 255) / 256, 256, 0, stream>>>(
      sc[kDaPart], dA, H, (int)bcs);
  SSD_CHECK();
#undef SSD_CHECK
  return cudaSuccess;
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

// The backward of ssd_launch's function. x, dt, A, B, C as there; gy
// (b,S,H,P) the cotangent of y, gstate (b,H,N,P) the final state's or
// null (no gradient reaches it). Out: dx (b,S,H,P), ddt (b,S,H), dA (H,),
// dB and dC (b,S,N). ``scratch``: kNumScratch float32 buffers, shaped as
// kernels/ssd/ops.py:bwd_scratch_shapes gives them. hg_dp and hg_dbc: the
// heads a block of the dP and the dB/dC kernels sums (1..H). Returns a
// cudaError_t code (0 = ok).
extern "C" int ssd_bwd_launch(const void* x, const void* dt, const void* A,
                              const void* B, const void* C, const void* gy,
                              const void* gstate, void* dx, void* ddt,
                              void* dA, void* dB, void* dC,
                              void* const* scratch, int b, int S, int H,
                              int P, int N, int chunk, int pt, int hg_dp,
                              int hg_dbc, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || N <= 0 || N > kMaxState || chunk <= 0 ||
      chunk > kMaxChunk || S % chunk != 0 || P <= 0 || P % 16 != 0 ||
      H > 65535 || hg_dp < 1 || hg_dp > H || hg_dbc < 1 || hg_dbc > H)
    return (int)cudaErrorInvalidValue;
  float* sc[kNumScratch];
  for (int k = 0; k < kNumScratch; ++k) sc[k] = static_cast<float*>(scratch[k]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(B);
  const float* Cf = static_cast<const float*>(C);
  const float* gyf = static_cast<const float*>(gy);
  const float* gsf = static_cast<const float*>(gstate);
  float* dxf = static_cast<float*>(dx);
  float* ddtf = static_cast<float*>(ddt);
  float* dAf = static_cast<float*>(dA);
  float* dBf = static_cast<float*>(dB);
  float* dCf = static_cast<float*>(dC);
#define SSD_BWD_LAUNCH(PT_)                                                   \
  return (int)launch_bwd<PT_>(xf, dtf, Af, Bf, Cf, gyf, gsf, dxf, ddtf, dAf, \
                              dBf, dCf, sc, b, S, H, P, N, chunk, hg_dp,      \
                              hg_dbc, s)
  switch (pt) {
    case 16: SSD_BWD_LAUNCH(16);
    case 32: SSD_BWD_LAUNCH(32);
    case 64: SSD_BWD_LAUNCH(64);
    case 128: SSD_BWD_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSD_BWD_LAUNCH
}

extern "C" const char* ssd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
