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
// recomputes C.B^T, cum and the entering states instead of keeping them
// from the forward: the entering states alone are half of x's bytes at
// mamba2-2.7b's chunk of 256, and a training step would hold them for
// every ssm layer from its forward to its backward. Eleven device kernels
// on one stream, in _ssd_chunked's phases run backwards:
//   the recompute: the chunks' own states, cum and C.B^T (the forward's
//     state kernel, or ssd_bwd_rows_wg_kernel<true>), then the states
//     entering the chunks (ssd_bwd_fpass_kernel, the forward's pass);
//   u_k = (e^cum C)^T dY, the state kernel's product with C and dY
//     (ssd_bwd_u_kernel, or ssd_bwd_rows_wg_kernel<false>);
//   ssd_bwd_pass_kernel, the only recurrence, serial over the chunks of
//     each (batch row, head): lam_k, the gradient of the state leaving
//     chunk k (lam_last = the final state's cotangent, lam_{k-1} =
//     exp(seg_k) lam_k + u_k), and dg_k = <lam_k, S_prev_k>;
//   dP, per 64 x 64 tile of a chunk at or below the diagonal and a group
//     of heads, one head after another: dP = dY X^T, dG = sum_h dP o L and
//     the gradients of L's exponents (ssd_bwd_dg_sum_kernel sums the head
//     groups' dG in order);
//   dX, shaped like the output kernel with its operands transposed: dX =
//     (G o L)^T dY + diag(w) B lam_k, and on the way the row dots that
//     give w's and e^cum's gradients;
//   dB/dC, per 64 rows and 64 state columns of a chunk and a group of
//     heads: dC = dG B + sum_h diag(e^cum) dY S_prev^T, dB = dG^T C +
//     sum_h diag(w) X lam^T (ssd_bwd_dbc_sum_kernel sums the groups);
//   ssd_bwd_dt_kernel and ssd_bwd_da_sum_kernel: d(dt A), ddt and dA.
// Every sum across heads, tiles, chunks, warps or batch rows has one order
// (the head groups follow from the shape alone, kernels/ssd/ops.py:
// bwd_head_groups; their parts are summed in order) and nothing uses
// atomics, so two calls give the same bits. Every exponent is a sum of
// d(dt A) over a range of the chunk, and its gradient goes to each
// position of the range directly (the pairs that straddle it, prefix and
// suffix sums): a reverse cumsum of row sums less column sums would cancel
// terms and lose float32 digits at a strong decay. w's clip is tested on
// the sum of d(dt A) after j itself, which is exactly 0 over a zero tail,
// where seg - cum_j of the forward's scan may round above 0.
//
// What bounds the backward: operations, as the forward's, about twice its
// products (kernels/ssd/ops.py:cost_bwd), run in 3xTF32: at mamba2-2.7b's
// training shape about 10.8 GFLOP of products with the recompute, 0.066 ms
// at wgmma's TF32 rate over three. Two routes, by shape alone
// (ssd_bwd_route):
//   * P 64, N 128, a chunk a multiple of 64 (mamba2's widths): the product
//     kernels on TMA + wgmma (the section "The backward on TMA + wgmma"
//     below). Against the first (mma.sync) version's limits: operand tiles
//     arrive by TMA into an mbarrier ring, one thread issuing; the B
//     operand is split once in shared memory (the decay, its mask and the
//     transposes done in that pass) and the A fragments in registers, so
//     no warp rebuilds fragments between bursts of products; the dP
//     kernel's per-head epilogue runs without a barrier (its cross-warp
//     sums land a head later) on two warpgroups over the tile's columns,
//     with off-diagonal tiles unmasked; dB/dC's inter-chunk term is a GEMM
//     of (64 x H P) by (H P x 64) over blocks of 64 rows and 64 columns,
//     its head groups sized so the blocks fill the card in the fewest
//     waves; the later kernels are dependent launches, set up while their
//     predecessor runs. What holds it back now: each block's products wait
//     on its own splits and epilogues (a block's steps are not pipelined;
//     the card overlaps two to four blocks an SM), the dP epilogue's
//     per-element work on the CUDA cores, and dX's reads of head-shared
//     rows (C, B and the scores) once for each head.
//   * every other shape: the first version's kernels, 3xTF32 on mma.sync
//     with the forward's cp.async ring and fragment helpers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"   // mbarriers, TMA, wgmma descriptors and fences

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

// The forward's pass (ssd_pass_kernel's S_k = exp(seg_k) S_{k-1} +
// s_chunk_k, the same arithmetic), recomputed for the backward: writes the
// state entering each chunk (the final state is not needed), reading each
// chunk's state and decay a chunk ahead. Grid (n_eb, H, b).
__global__ void __launch_bounds__(256) ssd_bwd_fpass_kernel(
    const float4* __restrict__ chunk_states, float4* __restrict__ prev,
    const float* __restrict__ cum_g, int H, int np4, int Q, int nc) {
  grid_dependency_wait();
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= np4) return;
  auto at = [&](int c) { return ((size_t)b * nc + c) * H + h; };
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v = chunk_states[at(0) * np4 + e];
  float gc = clipped_exp(cum_g[at(0) * Q + Q - 1]);
  for (int c = 0; c < nc - 1; ++c) {
    const float4 vc = v;
    const float gcc = gc;
    v = chunk_states[at(c + 1) * np4 + e];
    gc = clipped_exp(cum_g[at(c + 1) * Q + Q - 1]);
    prev[at(c) * np4 + e] = s;
    s = make_float4(gcc * s.x + vc.x, gcc * s.y + vc.y, gcc * s.z + vc.z,
                    gcc * s.w + vc.w);
  }
  prev[at(nc - 1) * np4 + e] = s;
}

// The reverse pass over the chunks of each (batch row, head), four state
// entries a thread, grid (n_eb, H, b): lam_last = gstate (0 when null),
// lam_{k-1} = exp(seg_k) lam_k + u_k; writes lam_k, the gradient of the
// state leaving chunk k, and each warp's part of dg_k = <lam_k, S_prev_k>
// (0 for the first chunk, which enters with no state) into dg_part (b*nc,
// H, n_eb, 8), no barrier; chunk k - 1's u, S_prev and decay are read
// while chunk k is done.
__global__ void __launch_bounds__(256) ssd_bwd_pass_kernel(
    const float4* __restrict__ u, const float4* __restrict__ prev,
    const float* __restrict__ cum_g, const float4* __restrict__ gstate,
    float4* __restrict__ lam, float* __restrict__ dg_part, int H, int np4,
    int Q, int nc) {
  grid_dependency_wait();
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, n_eb = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool on = e < np4;
  auto at = [&](int c) { return ((size_t)b * nc + c) * H + h; };
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 l = zero, uv = zero, pv = zero;
  float gc = 0.f;
  if (on && gstate) l = gstate[((size_t)b * H + h) * np4 + e];
  auto fetch = [&](int c) {
    if (c > 0 && on) {
      uv = u[at(c) * np4 + e];
      pv = prev[at(c) * np4 + e];
      gc = clipped_exp(cum_g[at(c) * Q + Q - 1]);
    }
  };
  fetch(nc - 1);
  for (int c = nc - 1; c >= 0; --c) {
    const size_t bh = at(c);
    const float4 uc = uv, pc = pv;
    const float gcc = gc;
    fetch(c - 1);
    if (on) lam[bh * np4 + e] = l;
    float d = c > 0 && on
        ? l.x * pc.x + l.y * pc.y + l.z * pc.z + l.w * pc.w : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (lane == 0) dg_part[(bh * n_eb + blockIdx.x) * 8 + warp] = d;
    if (c > 0 && on)
      l = make_float4(gcc * l.x + uc.x, gcc * l.y + uc.y, gcc * l.z + uc.z,
                      gcc * l.w + uc.w);
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
  grid_dependency_wait();
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
  grid_dependency_wait();
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
  grid_dependency_wait();
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
  if (warp == 0) {                  // dg_k: its parts, lanes then a tree
    float dg = 0.f;
    for (int k = lane; k < 8 * n_eb; k += 32) dg += dg_part[bh * 8 * n_eb + k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dg += __shfl_xor_sync(0xffffffffu, dg, o);
    if (lane == 0) extra = dg * clipped_exp(seg) * in_clip(seg);
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
  grid_dependency_wait();
  const int h = blockIdx.x * 256 + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int k = 0; k < bcs; ++k) s += dA_part[(size_t)k * H + h];
  dA[h] = s;
}

// ===========================================================================
// The backward on TMA + wgmma (P 64, N 128, a chunk a multiple of 64)
// ===========================================================================
//
// The product kernels of the backward for Hopper: the recompute's chunk
// states and C.B^T, u, dP, dX and dB/dC (the passes and sums are shared
// with the other route). Every operand tile arrives by TMA from 2-D or
// 3-D tensor maps in boxes of
// 32 floats x 32 rows with 128-byte swizzle, into a ring of stages that
// complete on mbarriers (one thread issues the loads). A product is a
// warpgroup's wgmma m64nNk8 in 3xTF32: A (64 rows x 8) from registers and B
// from shared memory, K-major (tf32 operands in shared memory are K-major
// only). The B operand is split once in shared memory into a TF32 high part
// and its TF32 remainder, in the swizzled K-major layout wgmma reads, by
// the whole warpgroup: a tile that arrives K-major (x in dP, B and C in dX,
// the states in dB/dC) is split in place or piece for piece; the others are
// transposed in the same pass (x and dY in the rows kernel, the scores
// with their decay in dX, B and C in dB/dC's intra-chunk term). The A
// fragments are read from the
// stage, scaled (e^cum, w, or nothing) and split in registers. Each 8-deep k
// step issues A_hi B_lo, A_lo B_hi, then A_hi B_hi into one float32
// accumulator, in that order every time.

constexpr int kWgP = 64;                 // the head dim the route takes
constexpr int kWgN = 128;                // the state size it takes
constexpr int kBox = 32 * 32 * 4;        // bytes of a 32 x 32 float box

__host__ __device__ constexpr bool wg_route(int P, int N, int Q) {
  return P == kWgP && N == kWgN && Q % 64 == 0 && Q <= kMaxChunk;
}

// byte offset of (row, col) in a chunk of 128-byte rows (32 floats) as TMA
// writes it with 128-byte swizzle and wgmma reads it: the 16-byte piece
// col / 4 of a row sits at piece (col / 4) ^ (row % 8) (chunks start
// 1024-byte aligned)
__device__ __forceinline__ uint32_t sw128(int row, int col) {
  return row * 128 + ((((col >> 2) ^ (row & 7)) << 4) | ((col & 3) << 2));
}

__device__ __forceinline__ float lds(const unsigned char* p, uint32_t off) {
  return *reinterpret_cast<const float*>(p + off);
}

// x split into its TF32 high part and TF32 remainder, as floats
__device__ __forceinline__ void split_f(float x, float& hi, float& lo) {
  uint32_t h, l;
  split(x, h, l);
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
}

// a float4 of shared memory split into the hi and lo tiles at the same
// offset (hi may be the source itself)
__device__ __forceinline__ void split4(const unsigned char* src,
                                       unsigned char* hi, unsigned char* lo,
                                       uint32_t off) {
  const float4 v = *reinterpret_cast<const float4*>(src + off);
  float4 h, l;
  split_f(v.x, h.x, l.x);
  split_f(v.y, h.y, l.y);
  split_f(v.z, h.z, l.z);
  split_f(v.w, h.w, l.w);
  *reinterpret_cast<float4*>(hi + off) = h;
  *reinterpret_cast<float4*>(lo + off) = l;
}

// the A fragment of 8-deep k step kk, split: a(m, k) gives A's element of
// row m (of the warpgroup's 64) and column k
template <typename F>
__device__ __forceinline__ void a_frag(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       int kk, F a) {
  const int lane = threadIdx.x & 31;
  const int m = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int k = 8 * kk + (lane & 3);
  split(a(m, k), hi[0], lo[0]);
  split(a(m + 8, k), hi[1], lo[1]);
  split(a(m, k + 4), hi[2], lo[2]);
  split(a(m + 8, k + 4), hi[3], lo[3]);
}

// d += A (64 x 8, registers: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4) of the warp's 16 rows) . B (8 x 64, K-major, shared),
// tf32 in, float32 accumulate
__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
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

// d += A (64 x 8, registers, as wgmma_tf32_n64's) . B (8 x 32, K-major,
// shared), tf32 in, float32 accumulate
__device__ __forceinline__ void wgmma_tf32_n32(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc += A . B over 8-deep k steps [kk0, kk0 + KK) in 3xTF32: B is N rows
// from row r of R-row K-major tiles hi and lo (chunks of 32 k), A's
// fragments ah/al
template <int N, int R, int KK>
__device__ __forceinline__ void wg3(float* acc, const uint32_t (&ah)[KK][4],
                                    const uint32_t (&al)[KK][4], uint32_t bhi,
                                    uint32_t blo, int r, int kk0) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const uint64_t dh = kmajor_desc<R>(bhi, r, kk0 + kk);
    const uint64_t dl = kmajor_desc<R>(blo, r, kk0 + kk);
    if constexpr (N == 32) {
      wgmma_tf32_n32(acc, ah[kk], dl);
      wgmma_tf32_n32(acc, al[kk], dh);
      wgmma_tf32_n32(acc, ah[kk], dh);
    } else {
      wgmma_tf32_n64(acc, ah[kk], dl);
      wgmma_tf32_n64(acc, al[kk], dh);
      wgmma_tf32_n64(acc, ah[kk], dh);
    }
  }
}

// the sums over a warpgroup's 64 accumulator rows of each of its 64
// columns (this thread's cs[jj][e]: column 8 jj + 2 t + e, its two rows
// summed), in one order: lanes of a column, then the four warps in order.
// Thread c < 64 gets column c's sum. red: 256 floats; every thread calls it.
__device__ __forceinline__ float wg_col_sum(float (&cs)[8][2], float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, t = lane & 3;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = cs[jj][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) red[64 * w + 8 * jj + 2 * t + e] = v;
    }
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < 64) {
    const int c = threadIdx.x;
    s = (red[c] + red[64 + c]) + (red[128 + c] + red[192 + c]);
  }
  __syncthreads();
  return s;
}

// The ring of one wgmma kernel: its stages of ``stage`` bytes from
// the block's 1024-aligned base, their mbarriers at ``bars``
struct Ring {
  uint32_t base, bars;
  int stage;
  __device__ uint32_t at(int s) const { return base + s * stage; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
};

__device__ __forceinline__ void ring_init(const Ring& r, int n) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < n; ++s) mbar_init(r.full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Shared memory of ssd_bwd_rows_wg_kernel, bytes from a 1024-aligned base:
// stages of 32 rows j of B or C (x 128 n: four boxes) and of x or dY (x 64
// p: two boxes), or a score tile's C and B rows (64 x 32 each); the split
// B operand (64 x 32, hi and lo); the chunk's row scale, cum and dt
struct UWg {
  static constexpr int kStages = 2;
  static constexpr int stage = 6 * kBox;
  static constexpr int hi = kStages * stage;
  static constexpr int lo = hi + 2 * kBox;
  static constexpr int fac = lo + 2 * kBox;
  static constexpr int cum = fac + 4 * kMaxChunk;
  static constexpr int dts = cum + 4 * kMaxChunk;
  static constexpr int bars = dts + 4 * kMaxChunk;
  static constexpr size_t smem = 1024 + bars + 8 * kStages;
};

// The backward's two products over a chunk's rows j, all 128 state rows n
// and 64 columns p of one head a block (grid (H, b * nc)), into ``out``
// (b*nc, H, N, P): two 64-row products (n 0-63, 64-127) share each split
// (transposed) tile of the 64 columns.
//   kState: the chunk's own state (w B)^T X, w_j = exp(clip(seg - cum_j))
//   dt_j, with the chunk's cumsum of dt A computed here as the forward's
//   state kernel computes it, and written to cum_g; further blocks
//   (blockIdx.x >= H) each compute one 64 x 64 tile (it, jt) of the
//   chunk's C.B^T at or below the diagonal into G (K = N, both operands
//   K-major as they come): the forward's state kernel, recomputed;
//   else: u_k = (e^cum C)^T dY (the chunks after each row's first: the
//   reverse pass never reads the first's), cum read from cum_g.
template <bool kState>
__global__ void __launch_bounds__(128) ssd_bwd_rows_wg_kernel(
    const __grid_constant__ CUtensorMap map_r,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_c, const float* __restrict__ dt,
    const float* __restrict__ A, float* __restrict__ cum_g,
    float* __restrict__ out, float* __restrict__ G, int H, int Q, int Qp,
    int nc) {
  grid_dependency_wait();
  const int bc = blockIdx.y;
  if (!kState && bc % nc == 0) return;
  extern __shared__ __align__(1024) unsigned char wsm[];
  const uint32_t raw = smem_u32(wsm), base = (raw + 1023) & ~1023u;
  unsigned char* gb = wsm + (base - raw);
  float* fac = reinterpret_cast<float*>(gb + UWg::fac);
  const Ring ring{base, base + UWg::bars, UWg::stage};
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = bc * Q;
  const uint32_t bhi = base + UWg::hi, blo = base + UWg::lo;

  if (kState && (int)blockIdx.x >= H) {
    // ---- one 64 x 64 tile of C.B^T ----------------------------------------
    int tile = blockIdx.x - H, it = 0;
    while (tile > it) tile -= ++it;           // tile = it*(it+1)/2 + jt
    const int i0 = it * 64, j0 = tile * 64;
    auto issue = [&](int v) {
      const int s = v % UWg::kStages;
      const uint32_t a = ring.at(s), bar = ring.full(s);
      mbar_expect_tx(bar, 4 * kBox);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        tma_load_2d(a + rr * kBox, &map_c, bar, 32 * v, row0 + i0 + 32 * rr);
        tma_load_2d(a + (2 + rr) * kBox, &map_r, bar, 32 * v,
                    row0 + j0 + 32 * rr);
      }
    };
    ring_init(ring, UWg::kStages);
    __syncthreads();
    constexpr int nk = kWgN / 32;
    if (tid == 0)
      for (int v = 0; v < UWg::kStages; ++v) issue(v);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int v = 0; v < nk; ++v) {
      const int s = v % UWg::kStages;
      const unsigned char* cs = gb + (ring.at(s) - base);
      mbar_wait(ring.full(s), (v / UWg::kStages) & 1);
#pragma unroll
      for (int q = 0; q < 4; ++q)                   // B rows (j, n): K-major
        split4(cs + 2 * kBox, gb + UWg::hi, gb + UWg::lo, 16 * (tid + 128 * q));
      uint32_t ah[4][4], al[4][4];                  // C rows (i, n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        a_frag(ah[kk], al[kk], kk,
               [&](int m, int k) { return lds(cs, sw128(m, k)); });
      fence_proxy_async();
      __syncthreads();
      if (tid == 0 && v + UWg::kStages < nk) issue(v + UWg::kStages);
      wgmma_fence();
      wg3<64, 64, 4>(acc, ah, al, bhi, blo, 0, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncthreads();
    }
    float* Gb = G + (size_t)row0 * Qp;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + 16 * w + g + 8 * hh, j = j0 + 8 * jj + 2 * t;
        *reinterpret_cast<float2*>(Gb + (size_t)i * Qp + j) =
            make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
      }
    return;
  }

  const int h = blockIdx.x;
  const size_t bh = (size_t)bc * H + h;
  const int nk = Q / 32;
  auto issue = [&](int v) {
    const int s = v % UWg::kStages;
    const uint32_t a = ring.at(s), bar = ring.full(s);
    mbar_expect_tx(bar, 6 * kBox);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      tma_load_2d(a + c * kBox, &map_r, bar, 32 * c, row0 + 32 * v);
#pragma unroll
    for (int c = 0; c < 2; ++c)
      tma_load_3d(a + (4 + c) * kBox, &map_v, bar, 32 * c, h, row0 + 32 * v);
  };
  ring_init(ring, UWg::kStages);
  if (kState) {
    // the chunk's inclusive cumsum of dt A, as ssd_state_kernel computes
    // it: serial per lane, then a warp scan of the lane totals
    float* cum = reinterpret_cast<float*>(gb + UWg::cum);
    float* dts = reinterpret_cast<float*>(gb + UWg::dts);
    const float a_h = A[h];
    for (int i = tid; i < kMaxChunk; i += 128) {
      const float d = i < Q ? dt[(size_t)(row0 + i) * H + h] : 0.f;
      dts[i] = d;
      cum[i] = d * a_h;
    }
    __syncthreads();
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      const int lo = min(tid * per, Q), hi = min(lo + per, Q);
      float sv = 0.f;
      for (int i = lo; i < hi; ++i) {
        sv += cum[i];
        cum[i] = sv;
      }
      float incl = sv;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += u;
      }
      const float excl = incl - sv;
      for (int i = lo; i < hi; ++i) cum[i] += excl;
    }
    __syncthreads();
    const float seg = cum[Q - 1];
    for (int i = tid; i < Q; i += 128) {
      cum_g[bh * Q + i] = cum[i];
      fac[i] = clipped_exp(seg - cum[i]) * dts[i];
    }
  } else {
    for (int i = tid; i < Q; i += 128) fac[i] = clipped_exp(cum_g[bh * Q + i]);
  }
  __syncthreads();
  if (tid == 0)
    for (int v = 0; v < nk && v < UWg::kStages; ++v) issue(v);

  float acc[2][32];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
  for (int v = 0; v < nk; ++v) {
    const int s = v % UWg::kStages;
    const unsigned char* cs = gb + (ring.at(s) - base);
    const unsigned char* ys = cs + 4 * kBox;
    mbar_wait(ring.full(s), (v / UWg::kStages) & 1);
    // V^T, K-major (p, j): transposed from the (j, p) rows as they came
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int e = 4 * q + w;
      const int p = 8 * (e & 7) + (lane & 7), j = 4 * (e >> 3) + (lane >> 3);
      float hv, lv;
      split_f(lds(ys, (p >> 5) * kBox + sw128(j, p & 31)), hv, lv);
      *reinterpret_cast<float*>(gb + UWg::hi + sw128(p, j)) = hv;
      *reinterpret_cast<float*>(gb + UWg::lo + sw128(p, j)) = lv;
    }
    // A = (f M)^T: A[n][j] = f_j M[j][n] (M = B or C), n 0-63 and 64-127
    const float* fv = fac + 32 * v;
    uint32_t ah[2][4][4], al[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        a_frag(ah[m][kk], al[m][kk], kk, [&](int r, int k) {
          const int n = 64 * m + r;
          return fv[k] * lds(cs, (n >> 5) * kBox + sw128(k, n & 31));
        });
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && v + UWg::kStages < nk) issue(v + UWg::kStages);
    wgmma_fence();
    wg3<64, 64, 4>(acc[0], ah[0], al[0], bhi, blo, 0, 0);
    wg3<64, 64, 4>(acc[1], ah[1], al[1], bhi, blo, 0, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    __syncthreads();              // every warp's products are done with hi/lo
  }
  float* ob = out + bh * kWgN * kWgP;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = 64 * m + 16 * w + g + 8 * hh, p = 8 * jj + 2 * t;
        *reinterpret_cast<float2*>(ob + n * kWgP + p) =
            make_float2(acc[m][4 * jj + 2 * hh], acc[m][4 * jj + 2 * hh + 1]);
      }
}

// Shared memory of ssd_bwd_dp_wg_kernel, bytes from a 1024-aligned base:
// two stages of a head's dY rows i and x rows j (64 x 64 each: two 32-column
// chunks of 64 rows), x's high part split in place over its stage; x's low
// part; the block's C.B^T tile (rows padded to GST); two heads' cum_i,
// cum_j and dt_j; two heads' column sums of four warps (two arrays) and
// row sums of the two warpgroups
struct DpWg {
  static constexpr int GST = 72;
  static constexpr int stage = 8 * kBox;
  static constexpr int lo = 2 * stage;
  static constexpr int gs = lo + 4 * kBox;
  static constexpr int ec = gs + 4 * 64 * GST;
  static constexpr int red = ec + 4 * 2 * 3 * 64;     // [2][2][4][64]
  static constexpr int rrow = red + 4 * 2 * 2 * 256;  // [2][2][64]
  static constexpr int bars = rrow + 4 * 2 * 2 * 64;
  static constexpr size_t smem = 1024 + bars + 8 * 2;
};

// Grid (score tiles, head groups, b * nc), as ssd_bwd_dp_kernel's and with
// its outputs: one 64 x 64 tile (it, jt) of a chunk at or below the
// diagonal, over the heads of one group in order; two warpgroups, each 32
// of the tile's 64 columns j. Head h's dP = dY X^T (K = P) is 24 wgmma
// m64n32 a warpgroup; its epilogue then runs on the CUDA cores without a
// barrier: dG += dP L, R = dP G E dt_j (j < i, the clip passing), R's row
// sums (each warpgroup's, added in order) and column sums (per warp, over
// the four warps in order) off the diagonal, and on a diagonal tile sum_{i
// >= m > j} R_ij from each warpgroup's row prefixes of R (shuffles in
// registers) plus, for m past the first warpgroup's columns, the suffix
// sum over i >= m of that warpgroup's row sums; dP G E's column sums. The
// sums over warps and warpgroups are added one head later, after the next
// head's barriers. An off-diagonal tile needs no mask (every j < i). The
// next two heads' tiles are in flight meanwhile (two stages), and the next
// head's cum and dt are read a head ahead.
__global__ void __launch_bounds__(256, 2) ssd_bwd_dp_wg_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_gy, const float* __restrict__ dt,
    const float* __restrict__ G, const float* __restrict__ cum_g,
    float* __restrict__ dGp, float* __restrict__ rsum,
    float* __restrict__ csum, float* __restrict__ dsum,
    float* __restrict__ sdiag, int H, int Q, int Qp, int nt, int hg_size) {
  grid_dependency_wait();
  extern __shared__ __align__(1024) unsigned char wsm[];
  const uint32_t raw = smem_u32(wsm), base = (raw + 1023) & ~1023u;
  unsigned char* gb = wsm + (base - raw);
  float* Gs = reinterpret_cast<float*>(gb + DpWg::gs);
  float* ec = reinterpret_cast<float*>(gb + DpWg::ec);
  float* red = reinterpret_cast<float*>(gb + DpWg::red);
  float* rrow = reinterpret_cast<float*>(gb + DpWg::rrow);
  const Ring ring{base, base + DpWg::bars, DpWg::stage};
  constexpr int GST = DpWg::GST;

  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int jc = 32 * wg;                     // this warpgroup's columns
  int tile = blockIdx.x, it = 0;
  while (tile > it) tile -= ++it;             // tile = it*(it+1)/2 + jt
  const int jt = tile;
  const int i0 = it * 64, j0 = jt * 64;
  const bool diag = it == jt;
  const int bc = blockIdx.z;
  const int h0 = blockIdx.y * hg_size, nh = min(H, h0 + hg_size) - h0;
  const int row0 = bc * Q;

  auto issue = [&](int hl) {
    const int s = hl & 1, h = h0 + hl;
    const uint32_t ys = ring.at(s), xs = ys + 4 * kBox, bar = ring.full(s);
    mbar_expect_tx(bar, 8 * kBox);
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        tma_load_3d(ys + (2 * c + rr) * kBox, &map_gy, bar, 32 * c, h,
                    row0 + i0 + 32 * rr);
        tma_load_3d(xs + (2 * c + rr) * kBox, &map_x, bar, 32 * c, h,
                    row0 + j0 + 32 * rr);
      }
  };
  // cum_i, cum_j and dt_j of head hl (threads 0-191, one value each), read
  // a head ahead of their use (pf), then kept in ec[hl % 2]
  float pf = 0.f;
  auto fetch = [&](int hl) {
    if (hl >= nh || tid >= 192) return;
    const int h = h0 + hl;
    const size_t bhq = ((size_t)bc * H + h) * Q;
    pf = tid < 64    ? cum_g[bhq + i0 + tid]
         : tid < 128 ? cum_g[bhq + j0 + tid - 64]
                     : dt[(size_t)(row0 + j0 + tid - 128) * H + h];
  };
  auto stash = [&](int hl) {
    if (tid < 192) ec[192 * (hl & 1) + tid] = pf;
  };
  ring_init(ring, 2);
  const float* Gb = G + (size_t)bc * Q * Qp;
  for (int e = tid; e < 64 * 64; e += 256) {
    const int r = e >> 6, c = e & 63;
    Gs[r * GST + c] = j0 + c <= i0 + r ? Gb[(size_t)(i0 + r) * Qp + j0 + c]
                                       : 0.f;
  }
  fetch(0);
  stash(0);
  fetch(1);
  __syncthreads();
  if (tid == 0) {
    issue(0);
    if (nh > 1) issue(1);
  }

  // head hl's sums over warps and warpgroups, in order, out to csum (or
  // sdiag on a diagonal tile), dsum and rsum; read two barriers after they
  // were written (their buffer hl % 2 is written again two heads later)
  auto flush = [&](int hl) {
    if (tid >= 64) return;
    const size_t bh = (size_t)bc * H + h0 + hl;
    const float* rr = red + 512 * (hl & 1);
    const float* rw = rrow + 128 * (hl & 1);
    float sr = (rr[tid] + rr[64 + tid]) + (rr[128 + tid] + rr[192 + tid]);
    rr += 256;
    const float sd = (rr[tid] + rr[64 + tid]) + (rr[128 + tid] + rr[192 + tid]);
    if (diag) {
      // the first warpgroup's columns j < 32 for rows i >= m, m >= 32: a
      // suffix scan of its row sums over the second warp's lanes
      float suf = tid >= 32 ? rw[tid] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane + o < 32) suf += u;
      }
      if (tid >= 32) sr += suf;
      sdiag[bh * Q + i0 + tid] = sr;
    } else {
      csum[(bh * nt + it) * Q + j0 + tid] = sr;
      rsum[(bh * nt + jt) * Q + i0 + tid] = rw[tid] + rw[64 + tid];
    }
    dsum[(bh * nt + it) * Q + j0 + tid] = sd;
  };

  // this thread's accumulator rows il = 16 w + g + 8 hh, columns jl = jc +
  // 8 jj + 2 t + e: element 4 jj + 2 hh + e
  float dGa[16], acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dGa[i] = 0.f;

  // head hl's epilogue; Diag: a diagonal tile (masks j <= i and j < i)
  auto epilogue_t = [&](int hl, auto diag_t) {
    constexpr bool Diag = decltype(diag_t)::value;
    if (hl > 0) flush(hl - 1);
    const float* ci_s = ec + 192 * (hl & 1);
    const float* cj_s = ci_s + 64;
    const float* dj_s = ci_s + 128;
    float rowp[2] = {0.f, 0.f}, colR[4][2], colD[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) colR[jj][e] = colD[jj][e] = 0.f;
    const float ci[2] = {ci_s[16 * w + g], ci_s[16 * w + g + 8]};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int jb = jc + 8 * jj + 2 * t;
      const float2 cj = *reinterpret_cast<const float2*>(cj_s + jb);
      const float2 dj = *reinterpret_cast<const float2*>(dj_s + jb);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int il = 16 * w + g + 8 * hh;
        const float2 gv = *reinterpret_cast<const float2*>(Gs + il * GST + jb);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = jb + e;
          const float d = ci[hh] - (e ? cj.y : cj.x), djv = e ? dj.y : dj.x;
          const float dc = fminf(fmaxf(d, -60.f), 0.f);
          const float dp = acc[4 * jj + 2 * hh + e];
          // off the diagonal every j < i: no mask
          const float pe = !Diag || jl <= il ? dp * __expf(dc) : 0.f;
          dGa[4 * jj + 2 * hh + e] += pe * djv;
          const float t1 = pe * (e ? gv.y : gv.x);
          // R passes where the clip does (dc == d); the diagonal's exponent
          // is 0 whatever cum is: no gradient
          const float R = (!Diag || jl < il) && dc == d ? t1 * djv : 0.f;
          colD[jj][e] += t1;
          colR[jj][e] += R;
          rowp[hh] += R;
          if (Diag) acc[4 * jj + 2 * hh + e] = R;
        }
      }
    }
    // R's row sums over this warpgroup's columns
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sv = rowp[hh];
      sv += __shfl_xor_sync(0xffffffffu, sv, 1);
      sv += __shfl_xor_sync(0xffffffffu, sv, 2);
      if (t == 0) rrow[128 * (hl & 1) + 64 * wg + 16 * w + g + 8 * hh] = sv;
    }
    if (Diag) {
      // sum_{i >= m} sum_{jc <= j < m} R_ij: each row's exclusive prefix
      // over this warpgroup's 32 columns (pairs, then the row's four lanes,
      // then the four blocks of 8 in order), summed over the rows i >= m
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int il = 16 * w + g + 8 * hh;
        float run = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float r0v = acc[4 * jj + 2 * hh], r1v = acc[4 * jj + 2 * hh + 1];
          float incl = r0v + r1v;
          float up = __shfl_up_sync(0xffffffffu, incl, 1, 4);
          if (t >= 1) incl += up;
          up = __shfl_up_sync(0xffffffffu, incl, 2, 4);
          if (t >= 2) incl += up;
          float excl = __shfl_up_sync(0xffffffffu, incl, 1, 4);
          if (t == 0) excl = 0.f;
          const float tot = __shfl_sync(0xffffffffu, incl, 3, 4);
          const float p0 = run + excl, p1 = p0 + r0v;
          const int m0 = jc + 8 * jj + 2 * t;
          const float v0 = il >= m0 ? p0 : 0.f, v1 = il >= m0 + 1 ? p1 : 0.f;
          if (hh == 0) {
            colR[jj][0] = v0;
            colR[jj][1] = v1;
          } else {
            colR[jj][0] += v0;
            colR[jj][1] += v1;
          }
          run += tot;
        }
      }
    }
    // each warp's column sums over its 16 rows, into red[.][.][w][column]
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float vr = colR[jj][e], vd = colD[jj][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          vr += __shfl_xor_sync(0xffffffffu, vr, o);
          vd += __shfl_xor_sync(0xffffffffu, vd, o);
        }
        if (lane < 4) {
          float* rb = red + 512 * (hl & 1) + 64 * w + jc + 8 * jj + 2 * t + e;
          rb[0] = vr;
          rb[256] = vd;
        }
      }
  };
  auto epilogue = [&](int hl) {
    if (diag)
      epilogue_t(hl, std::true_type{});
    else
      epilogue_t(hl, std::false_type{});
  };

  const uint32_t lo = base + DpWg::lo;
  for (int hl = 0; hl < nh; ++hl) {
    const int s = hl & 1;
    mbar_wait(ring.full(s), (hl >> 1) & 1);
    const unsigned char* ys = gb + (ring.at(s) - base);
    unsigned char* xs = gb + (ring.at(s) + 4 * kBox - base);
#pragma unroll
    for (int q = 0; q < 4; ++q)                     // x: hi in place
      split4(xs, xs, gb + DpWg::lo, 16 * (tid + 256 * q));
    const uint32_t xhi = ring.at(s) + 4 * kBox;
    fence_proxy_async();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    // the 64 p of dY in two halves of A fragments
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        a_frag(ah[kk], al[kk], kk, [&](int m, int k) {
          return lds(ys, half * 2 * kBox + sw128(m, k));
        });
      wgmma_fence();
      wg3<32, 64, 4>(acc, ah, al, xhi, lo, jc, 4 * half);
      wgmma_commit();
      if (half == 0) {
        // ec[(hl + 1) % 2] is free: head hl - 1's epilogue is over
        if (hl + 1 < nh) stash(hl + 1);
        fetch(hl + 2);
      }
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncthreads();              // every warp's products are done: the
    if (tid == 0 && hl + 2 < nh) issue(hl + 2);     // stage and lo are free
    epilogue(hl);
  }
  __syncthreads();
  flush(nh - 1);
  float* Db = dGp + ((size_t)blockIdx.y * gridDim.z + bc) * Q * Qp;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = i0 + 16 * w + g + 8 * hh, j = j0 + jc + 8 * jj + 2 * t;
      *reinterpret_cast<float2*>(Db + (size_t)i * Qp + j) =
          make_float2(dGa[4 * jj + 2 * hh], dGa[4 * jj + 2 * hh + 1]);
    }
}

// Shared memory of ssd_bwd_dx_wg_kernel, bytes from a 1024-aligned base:
// stages of an A source (32 k rows x 64 p: the entering state, lam or dY)
// and a B source (64 r x 32 n of C or B, or 32 i x 64 r of the scores); the
// split B operand (64 r x 32 k, hi and lo); cum and dt of the chunk; the
// column sums of four warps
struct DxWg {
  static constexpr int kStages = 2;
  static constexpr int stage = 4 * kBox;
  static constexpr int hi = kStages * stage;
  static constexpr int lo = hi + 2 * kBox;
  static constexpr int cum = lo + 2 * kBox;
  static constexpr int dts = cum + 4 * kMaxChunk;
  static constexpr int red = dts + 4 * kMaxChunk;
  static constexpr int bars = red + 4 * 256;
  static constexpr size_t smem = 1024 + bars + 8 * kStages;
};

// Grid (H, b * nc, Q / 64): 64 rows r of one chunk and head, all 64
// columns of x, as ssd_bwd_dx_kernel and with its outputs, computed as
// dX^T (rows p, columns r) so the B operand (C and B as they are, the
// scores transposed) carries r. Three k loops:
//   S_prev^T C^T over the state rows (chunks after the first): its column
//   dot with dY^T is de_r, into de_part;
//   lam^T B^T over the state rows: its column dot with x^T is dw_r, into
//   dw_part; then scaled by w_r, dX's state term;
//   dY^T (G o L) over the rows i >= r: dX's intra-chunk term, the decay
//   L = exp(clip(cum_i - cum_r)) dt_r and the mask i >= r applied in the
//   split of the scores.
__global__ void __launch_bounds__(128) ssd_bwd_dx_wg_kernel(
    const __grid_constant__ CUtensorMap map_gy,
    const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_c,
    const __grid_constant__ CUtensorMap map_g,
    const __grid_constant__ CUtensorMap map_prev,
    const __grid_constant__ CUtensorMap map_lam,
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ gy, const float* __restrict__ cum_g,
    float* __restrict__ dx, float* __restrict__ dw_part,
    float* __restrict__ de_part, int H, int Q, int nc) {
  grid_dependency_wait();
  extern __shared__ __align__(1024) unsigned char wsm[];
  const uint32_t raw = smem_u32(wsm), base = (raw + 1023) & ~1023u;
  unsigned char* gb = wsm + (base - raw);
  float* cum = reinterpret_cast<float*>(gb + DxWg::cum);
  float* dts = reinterpret_cast<float*>(gb + DxWg::dts);
  float* red = reinterpret_cast<float*>(gb + DxWg::red);
  const Ring ring{base, base + DxWg::bars, DxWg::stage};

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, bc = blockIdx.y, r0 = blockIdx.z * 64;
  const int row0 = bc * Q;
  const size_t bh = (size_t)bc * H + h;
  const int nrow = (int)bh * kWgN;            // the head's state rows
  const int n1 = bc % nc ? kWgN / 32 : 0;     // C S_prev: not the first chunk
  const int n12 = n1 + kWgN / 32;             // then B lam
  const int nk = n12 + (Q - r0) / 32;         // then i from r0 up

  auto issue = [&](int v) {
    const int s = v % DxWg::kStages;
    const uint32_t a = ring.at(s), b = a + 2 * kBox, bar = ring.full(s);
    mbar_expect_tx(bar, 4 * kBox);
    if (v < n12) {
      const CUtensorMap* ms = v < n1 ? &map_prev : &map_lam;
      const CUtensorMap* mr = v < n1 ? &map_c : &map_b;
      const int n0 = 32 * (v < n1 ? v : v - n1);
      tma_load_2d(a, ms, bar, 0, nrow + n0);
      tma_load_2d(a + kBox, ms, bar, 32, nrow + n0);
      tma_load_2d(b, mr, bar, n0, row0 + r0);
      tma_load_2d(b + kBox, mr, bar, n0, row0 + r0 + 32);
    } else {
      const int i0 = r0 + 32 * (v - n12);
      tma_load_3d(a, &map_gy, bar, 0, h, row0 + i0);
      tma_load_3d(a + kBox, &map_gy, bar, 32, h, row0 + i0);
      tma_load_2d(b, &map_g, bar, r0, row0 + i0);
      tma_load_2d(b + kBox, &map_g, bar, r0 + 32, row0 + i0);
    }
  };
  ring_init(ring, DxWg::kStages);
  // cum of the rows from r0 on (the block's rows r and every i >= r), dt
  // of the block's rows
  for (int i = r0 + tid; i < Q; i += 128) cum[i] = cum_g[bh * Q + i];
  if (tid < 64) {
    dts[r0 + tid] = dt[(size_t)(row0 + r0 + tid) * H + h];
    if (!n1) de_part[bh * Q + r0 + tid] = 0.f;          // the first chunk
  }
  __syncthreads();
  if (tid == 0)
    for (int v = 0; v < nk && v < DxWg::kStages; ++v) issue(v);
  const float seg = cum[Q - 1];
  int rc[2];                                  // the score split's columns
  float cum_r[2], dt_r[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    rc[k] = r0 + 16 * w + 8 * k + (lane & 7);
    cum_r[k] = cum[rc[k]];
    dt_r[k] = dts[rc[k]];
  }

  // this thread's accumulator rows p = 16 w + g + 8 hh and columns r =
  // 8 jj + 2 t + e (element 4 jj + 2 hh + e); the column dot of acc with
  // V^T (dY or x) over p into part[bh, r0 + r]
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  // V^T's elements at this thread's accumulator positions (dY or x), read
  // a loop ahead of their column dot
  float vt[32];
  auto load_vt = [&](const float* V) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * jj + 2 * t + e;
        const float* vr = V + ((size_t)(row0 + r) * H + h) * kWgP + 16 * w + g;
        vt[4 * jj + e] = vr[0];
        vt[4 * jj + 2 + e] = vr[8];
      }
  };
  auto col_dot = [&](float* part) {
    float cs[8][2];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        cs[jj][e] = acc[4 * jj + e] * vt[4 * jj + e] +
                    acc[4 * jj + 2 + e] * vt[4 * jj + 2 + e];
    const float s = wg_col_sum(cs, red);
    if (tid < 64) part[bh * Q + r0 + tid] = s;
  };
  load_vt(n1 ? gy : x);

  const uint32_t bhi = base + DxWg::hi, blo = base + DxWg::lo;
  for (int v = 0; v < nk; ++v) {
    const int s = v % DxWg::kStages;
    const unsigned char* as = gb + (ring.at(s) - base);
    const unsigned char* bs = as + 2 * kBox;
    mbar_wait(ring.full(s), (v / DxWg::kStages) & 1);
    if (v < n12) {
      // C or B rows (r, n): K-major already, split piece for piece
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split4(bs, gb + DxWg::hi, gb + DxWg::lo, 16 * (tid + 128 * q));
    } else {
      // (G o L)[i][r], K-major (r, i): transposed from the score rows i;
      // this thread's columns r are rc[0] and rc[1] at every step
      const int i0 = r0 + 32 * (v - n12);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int r = rc[q & 1] - r0, i = 4 * (q >> 1) + (lane >> 3);
        const int ia = i0 + i;
        const float gv = lds(bs, (r >> 5) * kBox + sw128(i, r & 31));
        const float val = ia >= rc[q & 1]
            ? gv * clipped_exp_fast(cum[ia] - cum_r[q & 1]) * dt_r[q & 1]
            : 0.f;
        float hv, lv;
        split_f(val, hv, lv);
        *reinterpret_cast<float*>(gb + DxWg::hi + sw128(r, i)) = hv;
        *reinterpret_cast<float*>(gb + DxWg::lo + sw128(r, i)) = lv;
      }
    }
    // A[p][k] = the source's (k, p): S_prev, lam or dY, as it came
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      a_frag(ah[kk], al[kk], kk, [&](int m, int k) {
        return lds(as, (m >> 5) * kBox + sw128(k, m & 31));
      });
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && v + DxWg::kStages < nk) issue(v + DxWg::kStages);
    wgmma_fence();
    wg3<64, 64, 4>(acc, ah, al, bhi, blo, 0, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();              // every warp's products are done with hi/lo
    if (v == n1 - 1) {                        // C S_prev done: de
      col_dot(de_part);
      load_vt(x);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    } else if (v == n12 - 1) {                // B lam done: dw, then w
      col_dot(dw_part);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + 8 * jj + 2 * t + e;
          const float wr = clipped_exp(seg - cum[r]) * dts[r];
          acc[4 * jj + e] *= wr;
          acc[4 * jj + 2 + e] *= wr;
        }
    }
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + 8 * jj + 2 * t + e;
      float* dr = dx + ((size_t)(row0 + r) * H + h) * kWgP + 16 * w + g;
      dr[0] = acc[4 * jj + e];
      dr[8] = acc[4 * jj + 2 + e];
    }
}

// Shared memory of ssd_bwd_dbc_wg_kernel, bytes from a 1024-aligned base:
// stages of an A source (64 x 32: dG rows, or dY or x rows of one head; 32
// x 64: dG columns) and a B source (32 x 64 of B or C rows, or 64 x 32 of a
// head's entering state or lam rows); the split B operand (64 n x 32 k, hi
// and lo); two heads' row scales
struct DbcWg {
  static constexpr int kStages = 3;
  static constexpr int stage = 4 * kBox;
  static constexpr int hi = kStages * stage;
  static constexpr int lo = hi + 2 * kBox;
  static constexpr int fac = lo + 2 * kBox;
  static constexpr int bars = fac + 4 * 2 * 64;
  static constexpr size_t smem = 1024 + bars + 8 * kStages;
};

// Grid (2 * (Q / 64) * 2, head groups, b * nc): 64 rows r and 64 of the 128
// state columns of a chunk's dC (which 0) or dB (which 1), this head
// group's part, into part[group][which] (b*S, N), summed as
// ssd_bwd_dbc_kernel's parts are: the last group adds the intra-chunk term
// over the chunk's rows (dG B or dG^T C, B and C transposed in their
// split), then every group the inter-chunk term as a GEMM of (64 x H P) by
// (H P x 64) over its heads in order, k over P in steps of 32: (e^cum dY)
// S_prev^T or (w X) lam^T, the row scale applied to A in registers.
__global__ void __launch_bounds__(128) ssd_bwd_dbc_wg_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_gy,
    const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_c,
    const __grid_constant__ CUtensorMap map_dg,
    const __grid_constant__ CUtensorMap map_prev,
    const __grid_constant__ CUtensorMap map_lam, const float* __restrict__ dt,
    const float* __restrict__ cum_g, float* __restrict__ part, int H, int Q,
    int nc, int hg_size, int rows_total) {
  grid_dependency_wait();
  extern __shared__ __align__(1024) unsigned char wsm[];
  const uint32_t raw = smem_u32(wsm), base = (raw + 1023) & ~1023u;
  unsigned char* gb = wsm + (base - raw);
  float* fac = reinterpret_cast<float*>(gb + DbcWg::fac);
  const Ring ring{base, base + DbcWg::bars, DbcWg::stage};

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nt = Q / 64;
  const int which = blockIdx.x / (2 * nt);
  const int r0 = blockIdx.x / 2 % nt * 64, n0 = blockIdx.x % 2 * 64;
  const int hg = blockIdx.y, bc = blockIdx.z;
  const int h0 = hg * hg_size, nh = min(H, h0 + hg_size) - h0;
  const int row0 = bc * Q;
  // the last group adds the intra-chunk term: it holds the fewest heads
  // where H is not a multiple of the group size
  const int n_intra = hg != (int)gridDim.y - 1 ? 0
      : which ? (Q - r0) / 32 : (r0 + 64) / 32;
  const int n_inter = !which && bc % nc == 0 ? 0 : 2 * nh;
  const int nk = n_intra + n_inter;
  const CUtensorMap* mv = which ? &map_x : &map_gy;
  const CUtensorMap* mm = which ? &map_lam : &map_prev;
  const CUtensorMap* mr = which ? &map_c : &map_b;

  auto issue = [&](int v) {
    const int s = v % DbcWg::kStages;
    const uint32_t a = ring.at(s), b = a + 2 * kBox, bar = ring.full(s);
    mbar_expect_tx(bar, 4 * kBox);
    if (v < n_intra) {
      const int k0 = (which ? r0 : 0) + 32 * v;
      if (!which) {                           // dG rows r0.., columns k0..
        tma_load_2d(a, &map_dg, bar, k0, row0 + r0);
        tma_load_2d(a + kBox, &map_dg, bar, k0, row0 + r0 + 32);
      } else {                                // dG rows k0.., columns r0..
        tma_load_2d(a, &map_dg, bar, r0, row0 + k0);
        tma_load_2d(a + kBox, &map_dg, bar, r0 + 32, row0 + k0);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)             // B or C rows k0.., columns n
        tma_load_2d(b + c * kBox, mr, bar, n0 + 32 * c, row0 + k0);
    } else {
      const int u = v - n_intra, h = h0 + u / 2, p0 = 32 * (u % 2);
      tma_load_3d(a, mv, bar, p0, h, row0 + r0);
      tma_load_3d(a + kBox, mv, bar, p0, h, row0 + r0 + 32);
      const int nrow = (bc * H + h) * kWgN + n0;
#pragma unroll
      for (int c = 0; c < 2; ++c)             // the head's state rows n
        tma_load_2d(b + c * kBox, mm, bar, p0, nrow + 32 * c);
    }
  };
  // the 64 rows' scale for head h0 + hl: e^cum (dC) or w (dB)
  auto row_scale = [&](int hl) {
    if (tid < 64) {
      const int h = h0 + hl;
      const float* cb = cum_g + ((size_t)bc * H + h) * Q;
      const int r = r0 + tid;
      fac[64 * (hl & 1) + tid] =
          which ? clipped_exp(cb[Q - 1] - cb[r]) * dt[(size_t)(row0 + r) * H + h]
                : clipped_exp(cb[r]);
    }
  };
  ring_init(ring, DbcWg::kStages);
  if (n_inter) row_scale(0);
  __syncthreads();
  if (tid == 0)
    for (int v = 0; v < nk && v < DbcWg::kStages; ++v) issue(v);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const uint32_t bhi = base + DbcWg::hi, blo = base + DbcWg::lo;
  for (int v = 0; v < nk; ++v) {
    const int s = v % DbcWg::kStages;
    const unsigned char* as = gb + (ring.at(s) - base);
    const unsigned char* bs = as + 2 * kBox;
    mbar_wait(ring.full(s), (v / DbcWg::kStages) & 1);
    uint32_t ah[4][4], al[4][4];
    if (v < n_intra) {
      // B or C rows (k, n), K-major (n, k): transposed
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int e = 4 * q + w;
        const int n = 8 * (e & 7) + (lane & 7), k = 4 * (e >> 3) + (lane >> 3);
        float hv, lv;
        split_f(lds(bs, (n >> 5) * kBox + sw128(k, n & 31)), hv, lv);
        *reinterpret_cast<float*>(gb + DbcWg::hi + sw128(n, k)) = hv;
        *reinterpret_cast<float*>(gb + DbcWg::lo + sw128(n, k)) = lv;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        a_frag(ah[kk], al[kk], kk, [&](int m, int k) {
          return which ? lds(as, (m >> 5) * kBox + sw128(k, m & 31))  // dG^T
                       : lds(as, sw128(m, k));                          // dG
        });
    } else {
      const int u = v - n_intra, hl = u / 2;
      // the head's state rows (n, p), K-major already
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split4(bs, gb + DbcWg::hi, gb + DbcWg::lo, 16 * (tid + 128 * q));
      const float* f = fac + 64 * (hl & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        a_frag(ah[kk], al[kk], kk,
               [&](int m, int k) { return f[m] * lds(as, sw128(m, k)); });
      // the next head's scale, read after this step's barrier
      if (u % 2 == 0 && hl + 1 < nh) row_scale(hl + 1);
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && v + DbcWg::kStages < nk) issue(v + DbcWg::kStages);
    wgmma_fence();
    wg3<64, 64, 4>(acc, ah, al, bhi, blo, 0, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();              // every warp's products are done with hi/lo
  }
  float* pb = part + ((size_t)(hg * 2 + which) * rows_total + row0 + r0) * kWgN;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * w + g + 8 * hh, n = n0 + 8 * jj + 2 * t;
      *reinterpret_cast<float2*>(pb + (size_t)r * kWgN + n) =
          make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
    }
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

// The tensor maps of the wgmma route: x and dY as (P, H, b*S), B and C as
// (N, b*S), the scores and dG as (Qp, b*S), the entering states and lam as
// (P, b*nc*H*N); boxes of 32 floats x 32 rows (x 1 head), 128-byte swizzle
struct WgMaps {
  CUtensorMap x, gy, b, c, g, dg, prev, lam;
};

bool encode_f32(CUtensorMap* map, EncodeTiledFn enc, const void* ptr,
                int rank, const cuuint64_t* dims, const cuuint64_t* strides) {
  const cuuint32_t box[3] = {32, rank == 3 ? 1u : 32u, 32};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t wg_maps(WgMaps* m, const float* x, const float* gy,
                    const float* Bm, const float* Cm, const float* G,
                    const float* dG, const float* prev, const float* lam,
                    int b, int S, int H, int Q) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t rows = (cuuint64_t)b * S;
  const cuuint64_t xd[3] = {(cuuint64_t)kWgP, (cuuint64_t)H, rows};
  const cuuint64_t xs[2] = {4 * kWgP, 4 * (cuuint64_t)H * kWgP};
  const cuuint64_t bd[2] = {(cuuint64_t)kWgN, rows}, bs[1] = {4 * kWgN};
  const cuuint64_t gd[2] = {(cuuint64_t)Q, rows}, gs[1] = {4 * (cuuint64_t)Q};
  const cuuint64_t sd[2] = {(cuuint64_t)kWgP, rows / Q * H * kWgN};
  const cuuint64_t ss[1] = {4 * kWgP};
  if (!encode_f32(&m->x, enc, x, 3, xd, xs) ||
      !encode_f32(&m->gy, enc, gy, 3, xd, xs) ||
      !encode_f32(&m->b, enc, Bm, 2, bd, bs) ||
      !encode_f32(&m->c, enc, Cm, 2, bd, bs) ||
      !encode_f32(&m->g, enc, G, 2, gd, gs) ||
      !encode_f32(&m->dg, enc, dG, 2, gd, gs) ||
      !encode_f32(&m->prev, enc, prev, 2, sd, ss) ||
      !encode_f32(&m->lam, enc, lam, 2, sd, ss))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// kernel<<<grid, block, smem, stream>>>(args...), and with ``pdl`` as a
// programmatic dependent launch: the kernel (which waits on
// grid_dependency_wait before it reads what the one before it wrote) is
// set up while its predecessor runs
template <typename... Params, typename... Args>
cudaError_t launch_k(bool pdl, void (*kernel)(Params...), dim3 grid,
                     dim3 block, size_t smem, cudaStream_t stream,
                     Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <int PT>
cudaError_t launch_bwd(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, const float* gy,
                       const float* gstate, float* dx, float* ddt, float* dA,
                       float* dB, float* dC, float* const* sc, int b, int S,
                       int H, int P, int N, int Q, int hg_dp, int hg_dbc,
                       const WgMaps* wg, cudaStream_t stream) {
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
  static bool wg_attr_set = false;
  if (wg && !wg_attr_set) {
    cudaError_t e =
        set_smem((const void*)ssd_bwd_rows_wg_kernel<true>, UWg::smem);
    if (e == cudaSuccess)
      e = set_smem((const void*)ssd_bwd_rows_wg_kernel<false>, UWg::smem);
    if (e == cudaSuccess)
      e = set_smem((const void*)ssd_bwd_dp_wg_kernel, DpWg::smem);
    if (e == cudaSuccess)
      e = set_smem((const void*)ssd_bwd_dx_wg_kernel, DxWg::smem);
    if (e == cudaSuccess)
      e = set_smem((const void*)ssd_bwd_dbc_wg_kernel, DbcWg::smem);
    if (e != cudaSuccess) return e;
    wg_attr_set = true;
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
  // recompute C.B^T, cum and the chunks' states (the forward's state
  // kernel, or on the wgmma route its counterpart), then the states
  // entering the chunks
  if (wg)
    ssd_bwd_rows_wg_kernel<true><<<dim3(H + n_tiles, (unsigned)bcs), 128,
                                   UWg::smem, stream>>>(
        wg->b, wg->x, wg->c, dt, A, cum, states, G, H, Q, Qp, nc);
  else
    ssd_state_kernel<PT><<<dim3((unsigned)grid_a, (unsigned)bcs), kThreads,
                           smem, stream>>>(x, dt, A, Bm, Cm, G, cum, states,
                                           H, P, N, Q, Qp, n_slab, n_psl);
  SSD_CHECK();
  // the wgmma route's later kernels are dependent launches (pdl)
  const bool pdl = wg != nullptr;
  if (nc > 1) {
    launch_k(pdl, ssd_bwd_fpass_kernel, dim3(n_eb, H, b), dim3(256), 0,
             stream, reinterpret_cast<const float4*>(states),
             reinterpret_cast<float4*>(prev), cum, H, np4, Q, nc);
    SSD_CHECK();
    // u_k = (e^cum C)^T dY, into the chunks' states (read by now)
    if (wg)
      launch_k(true, ssd_bwd_rows_wg_kernel<false>, dim3(H, (unsigned)bcs),
               dim3(128), UWg::smem, stream, wg->c, wg->gy, wg->c, dt, A, cum,
               states, G, H, Q, Qp, nc);
    else
      ssd_bwd_u_kernel<PT><<<dim3(H * n_slab * n_psl, (unsigned)bcs),
                             kThreads, smem, stream>>>(
          Cm, gy, cum, states, H, P, N, Q, nc, n_slab, n_psl);
    SSD_CHECK();
  }
  launch_k(pdl, ssd_bwd_pass_kernel, dim3(n_eb, H, b), dim3(256), 0, stream,
           reinterpret_cast<const float4*>(states),
           reinterpret_cast<const float4*>(prev), cum,
           reinterpret_cast<const float4*>(gstate),
           reinterpret_cast<float4*>(lam), sc[kDgPart], H, np4, Q, nc);
  SSD_CHECK();
  if (wg)
    launch_k(true, ssd_bwd_dp_wg_kernel, dim3(n_tiles, n_dp, (unsigned)bcs),
             dim3(256), DpWg::smem, stream, wg->x, wg->gy, dt, G, cum,
             sc[kDGp], sc[kRsum], sc[kCsum], sc[kDsum], sc[kSdiag], H, Q, Qp,
             nt, hg_dp);
  else
    ssd_bwd_dp_kernel<<<dim3(n_tiles, n_dp, (unsigned)bcs), kThreads,
                        smem_dp, stream>>>(x, dt, gy, G, cum, sc[kDGp],
                                           sc[kRsum], sc[kCsum], sc[kDsum],
                                           sc[kSdiag], H, P, Q, Qp, nt,
                                           hg_dp);
  SSD_CHECK();
  const size_t per = (size_t)bcs * Q * Qp;
  launch_k(pdl, ssd_bwd_dg_sum_kernel, dim3((unsigned)((per + 255) / 256)),
           dim3(256), 0, stream, sc[kDGp], sc[kDG], Q, Qp, n_dp, per);
  SSD_CHECK();
  if (wg)
    launch_k(true, ssd_bwd_dx_wg_kernel, dim3(H, (unsigned)bcs, nt),
             dim3(128), DxWg::smem, stream, wg->gy, wg->b, wg->c, wg->g,
             wg->prev, wg->lam, x, dt, gy, cum, dx, sc[kDwPart], sc[kDePart],
             H, Q, nc);
  else
    ssd_bwd_dx_kernel<PT><<<dim3(H * n_psl, (unsigned)bcs, nt), kThreads,
                            smem_dx, stream>>>(
        x, dt, Bm, Cm, gy, G, cum, prev, lam, dx, sc[kDwPart], sc[kDePart],
        H, P, N, Q, Qp, nc, n_psl);
  SSD_CHECK();
  const int n_ns = (N + QB - 1) / QB;
  if (wg)
    launch_k(true, ssd_bwd_dbc_wg_kernel, dim3(2 * nt * 2, n_dbc,
                                               (unsigned)bcs),
             dim3(128), DbcWg::smem, stream, wg->x, wg->gy, wg->b, wg->c,
             wg->dg, wg->prev, wg->lam, dt, cum, sc[kDbcPart], H, Q, nc,
             hg_dbc, b * S);
  else
    ssd_bwd_dbc_kernel<<<dim3(2 * nt * n_ns, n_dbc, (unsigned)bcs), kThreads,
                         smem_dbc, stream>>>(
        x, dt, Bm, Cm, gy, sc[kDG], cum, prev, lam, sc[kDbcPart], H, P, N, Q,
        Qp, nc, nt, n_ns, hg_dbc, b * S);
  SSD_CHECK();
  const size_t nbs = (size_t)b * S * N;
  launch_k(pdl, ssd_bwd_dbc_sum_kernel, dim3((unsigned)((2 * nbs + 255) / 256)),
           dim3(256), 0, stream, sc[kDbcPart], dC, dB, nbs, n_dbc);
  SSD_CHECK();
  launch_k(pdl, ssd_bwd_dt_kernel, dim3(H, (unsigned)bcs), dim3(256), 0,
           stream, dt, A, cum, sc[kRsum], sc[kCsum], sc[kDsum], sc[kSdiag],
           sc[kDwPart], sc[kDePart], sc[kDgPart], ddt, sc[kDaPart], H, Q, nt,
           n_psl, n_eb);
  SSD_CHECK();
  launch_k(pdl, ssd_bwd_da_sum_kernel, dim3((H + 255) / 256), dim3(256), 0,
           stream, sc[kDaPart], dA, H, (int)bcs);
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
// heads a block of the dP and the dB/dC kernels sums (1..H). The route is
// the shape's (ssd_bwd_route); the wgmma route reads x, gy, B, C and the
// scratch through tensor maps, which need 16-byte aligned bases
// (cudaErrorMisalignedAddress otherwise). Returns a cudaError_t code (0 =
// ok).
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
  if (wg_route(P, N, chunk)) {
    // TMA reads 16-byte aligned bases; its coordinates are 32-bit
    const uintptr_t any =
        reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gy) |
        reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(C) |
        reinterpret_cast<uintptr_t>(sc[kScores]) |
        reinterpret_cast<uintptr_t>(sc[kDG]) |
        reinterpret_cast<uintptr_t>(sc[kPrev]) |
        reinterpret_cast<uintptr_t>(sc[kLam]);
    if (any % 16 != 0) return (int)cudaErrorMisalignedAddress;
    if ((long long)b * S * H * N / chunk > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    // cuTensorMapEncodeTiled needs x's context current on this thread
    // (autograd runs a backward on a thread of its own, where no runtime
    // call may have bound it yet)
    cudaPointerAttributes pa;
    cudaError_t e = cudaPointerGetAttributes(&pa, x);
    if (e == cudaSuccess) e = cudaSetDevice(pa.device);
    if (e != cudaSuccess) return (int)e;
    WgMaps maps;
    e = wg_maps(&maps, xf, gyf, Bf, Cf, sc[kScores], sc[kDG], sc[kPrev],
                sc[kLam], b, S, H, chunk);
    if (e != cudaSuccess) return (int)e;
    return (int)launch_bwd<kWgP>(xf, dtf, Af, Bf, Cf, gyf, gsf, dxf, ddtf,
                                 dAf, dBf, dCf, sc, b, S, H, P, N, chunk,
                                 hg_dp, hg_dbc, &maps, s);
  }
#define SSD_BWD_LAUNCH(PT_)                                                   \
  return (int)launch_bwd<PT_>(xf, dtf, Af, Bf, Cf, gyf, gsf, dxf, ddtf, dAf, \
                              dBf, dCf, sc, b, S, H, P, N, chunk, hg_dp,      \
                              hg_dbc, nullptr, s)
  switch (pt) {
    case 16: SSD_BWD_LAUNCH(16);
    case 32: SSD_BWD_LAUNCH(32);
    case 64: SSD_BWD_LAUNCH(64);
    case 128: SSD_BWD_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSD_BWD_LAUNCH
}

// The kernels ssd_bwd_launch runs for head dim P, state size N and chunk:
// 1 TMA + wgmma (P 64, N 128, a chunk a multiple of 64), 0 mma.sync.
extern "C" int ssd_bwd_route(int P, int N, int chunk) {
  return wg_route(P, N, chunk) ? 1 : 0;
}

extern "C" const char* ssd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
