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
// bytes). The TPU kernel gets there by walking its time grid axis in order
// with h carried in VMEM scratch; on this card the blocks run in parallel
// and in no order, so the carry between time chunks has to travel between
// blocks.
//
// What the design does: one launch, a single-pass chained scan with
// decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan
// with Decoupled Look-back", 2016) over the affine pairs of the recurrence,
//   (A, B) o (A', B') = (A A', A' B + B')   (first (A, B), then (A', B')),
// so a run of steps is one pair (the product of its a, its h from 0).
//   * A tile is 32 channels (one warp wide: a time step of the tile is one
//     128-byte row segment, coalesced) by T = 8 U steps; warp w of the 8
//     owns steps [w U, (w + 1) U) of the tile, lane c channel c.
//   * A block takes its tile from a ticket (a global atomic counter), not
//     from blockIdx. Tickets run time chunk by time chunk, the (batch,
//     channel slab) columns fastest, and a tile's predecessor in time is
//     ticket - n_cols: it took its ticket earlier, so it is resident or
//     done, and the look-back cannot deadlock whatever order the hardware
//     starts blocks in.
//   * Each thread loads its U steps of a and b into registers once, all
//     loads issued before the first use, and folds them into its pair. The
//     tile is staged in registers rather than shared memory because every
//     value is used by one thread only (in the fold and in the rescan):
//     registers need no copy and no barrier.
//   * The look-back has a fixed order, so a call's h is the same bit for
//     bit every time it runs. Chunks that are multiples of 8 are anchors: a
//     tile of chunk k takes its carry from the inclusive prefix of the
//     nearest anchor before it, j = 8 floor((k - 1) / 8), and the
//     aggregates of chunks j + 1 .. k - 1, composed in time order. So an
//     anchor tile publishes only its inclusive prefix and any other tile
//     only its aggregate, and the window a tile reads is at most 8 chunks,
//     warp w reading chunk k - 1 - w (one L2 round trip for the window).
//     Anchors chain (chunk 16 waits on 8, 8 on 0): S / (64 U) hops in all,
//     each one window.
//   * What a tile publishes is one 16-byte word per channel, written by
//     one vector store and read by one vector load: {status | epoch << 2,
//     A, B, 0} for an aggregate (status AGG) or {status | epoch << 2, 0,
//     h, 0} for an inclusive prefix (status PREFIX). The status travels
//     with its values in the same word, so publishing takes no memory
//     fence and a read takes no second trip, where a flag word per tile
//     beside separate values needs a fence on both sides. (This rests on
//     an aligned 16-byte access by one thread not being torn, as CUB's
//     tile descriptors do.)
//   * The warps' pairs meet in shared memory; warp 0 folds them into the
//     tile's aggregate and publishes it (not an anchor), composes the
//     window into the carry entering the tile, publishes the inclusive
//     prefix (an anchor) and the carry entering each warp's steps.
//   * Each warp rescans its steps from registers with its carry and writes
//     h. HBM traffic is a, b read once and h written once: the bound's 3
//     passes (the two-kernel design this replaces made 5). The scratch (16
//     bytes a channel a tile) stays in L2.
//   * Per-call state without a second launch or a memset: every published
//     word carries the launch's epoch. The epoch, the ticket counter and a
//     done counter live in device memory before the words, and the last
//     block to finish (the done counter) sets both counters back to 0 and
//     advances the epoch, so every word of this launch is stale to the
//     next one. Nothing per call comes from the host, so a CUDA graph
//     replays the kernel as it is. The wrapper zero-fills the scratch only
//     when it allocates it (ops.py counts those fills).
//   * A look-back spin sleeps between polls and traps after kMaxPolls, so
//     a broken invariant ends in a launch failure, not a hung card.
// Ragged S and R: steps past S and channels past R are the identity pair
// (a = 1, b = 0) and are never loaded or stored.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;                   // channels a tile
constexpr unsigned kAgg = 1u, kPrefix = 2u;
constexpr unsigned kEpochMask = 0x3fffffffu;
constexpr unsigned kMaxPolls = 1u << 22;

// The scratch, one zero-filled buffer of 32-bit words: state (ticket,
// done, epoch, unused), then per tile and channel one 16-byte word.
struct Scratch {
  unsigned* state;
  uint4* words;       // (tiles, 32)
};

__device__ __forceinline__ unsigned load_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ uint4 load_word(const uint4* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_word(uint4* p, unsigned status,
                                           float x, float y) {
  asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(status), "r"(__float_as_uint(x)), "r"(__float_as_uint(y)),
               "r"(0u)
               : "memory");
}

// the status of a published word in this launch (0: nothing yet)
__device__ __forceinline__ unsigned status_of(unsigned f, unsigned epoch) {
  return (f >> 2) == (epoch & kEpochMask) ? (f & 3u) : 0u;
}

template <int U>
__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ h, Scratch sc, int S, int R, int n_slabs, int n_cols,
    unsigned n_tiles) {
  __shared__ unsigned s_ticket, s_epoch;
  __shared__ float s_a[kWarps][kCols], s_b[kWarps][kCols];
  __shared__ float s_carry[kWarps][kCols];
  // the look-back window: chunk k - 1 - w's published values
  __shared__ float s_vx[kWarps][kCols], s_vy[kWarps][kCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    s_ticket = atomicAdd(&sc.state[0], 1u);
    s_epoch = load_volatile(&sc.state[2]);
  }
  __syncthreads();
  const unsigned tile = s_ticket, epoch = s_epoch;
  const int k = (int)(tile / n_cols);          // time chunk
  const int col = (int)(tile % n_cols);        // (batch, channel slab)
  const int r = (col % n_slabs) * kCols + lane;
  const bool live = r < R;
  const int t0 = k * (kWarps * U) + warp * U;
  const size_t base = (size_t)(col / n_slabs) * S * R + r;
  const unsigned tag = (epoch & kEpochMask) << 2;
  const bool anchor = k % kWarps == 0;
  uint4* const mine = sc.words + (size_t)tile * kCols + lane;

  float av[U], bv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    if (live && t < S) {
      av[u] = __ldcs(a + base + (size_t)t * R);   // streamed: read once
      bv[u] = __ldcs(b + base + (size_t)t * R);
    } else {
      av[u] = 1.f;                                // the identity pair
      bv[u] = 0.f;
    }
  }
  float pa = 1.f, pb = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    pb = av[u] * pb + bv[u];
    pa *= av[u];
  }
  s_a[warp][lane] = pa;
  s_b[warp][lane] = pb;
  __syncthreads();

  if (warp == 0 && !anchor) {
    float ta = 1.f, tb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      tb = s_a[w][lane] * tb + s_b[w][lane];
      ta *= s_a[w][lane];
    }
    store_word(mine, tag | kAgg, ta, tb);
  }
  float carry = 0.f;   // warp 0: the carry entering the tile
  if (k > 0) {
    // the window: the anchor j's inclusive prefix, then the aggregates of
    // chunks j + 1 .. k - 1, warp w reading chunk k - 1 - w
    const int j = (k - 1) / kWarps * kWarps;
    const int kk = k - 1 - warp;
    if (kk >= j) {
      const unsigned need = kk == j ? kPrefix : kAgg;
      const uint4* p = sc.words + ((size_t)kk * n_cols + col) * kCols + lane;
      uint4 v;
      unsigned polls = 0;
      while (status_of((v = load_word(p)).x, epoch) != need) {
        if (++polls > kMaxPolls) __trap();
        __nanosleep(32);
      }
      s_vx[warp][lane] = __uint_as_float(v.y);
      s_vy[warp][lane] = __uint_as_float(v.z);
    }
    __syncthreads();
    if (warp == 0) {
      carry = s_vy[k - 1 - j][lane];
      for (int w = k - 2 - j; w >= 0; --w)
        carry = s_vx[w][lane] * carry + s_vy[w][lane];
    }
  }
  if (warp == 0) {
    // the carry entering each warp's steps; the last is the tile's
    // inclusive prefix
    float c = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s_carry[w][lane] = c;
      c = s_a[w][lane] * c + s_b[w][lane];
    }
    if (anchor) store_word(mine, tag | kPrefix, 0.f, c);
  }
  __syncthreads();

  float hc = s_carry[warp][lane];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    hc = av[u] * hc + bv[u];
    if (live && t < S) __stcs(h + base + (size_t)t * R, hc);
  }

  // the last block to finish has seen every block take its ticket and
  // end its look-back: it resets the counters and retires this epoch
  if (threadIdx.x == 0) {
    const unsigned done = atomicAdd(&sc.state[1], 1u);
    if (done == n_tiles - 1) {
      sc.state[0] = 0u;
      sc.state[1] = 0u;
      sc.state[2] = epoch + 1u;
    }
  }
}

template <int U>
cudaError_t launch(const float* a, const float* b, float* h, Scratch sc,
                   int S, int R, int n_slabs, int n_cols, unsigned n_tiles,
                   cudaStream_t stream) {
  rglru_scan_kernel<U><<<n_tiles, kThreads, 0, stream>>>(
      a, b, h, sc, S, R, n_slabs, n_cols, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// a, b, h: (B, S, R) float32. steps: U, the time steps each of a block's 8
// warps owns (1, 2, 4, 8 or 16), so a tile is 32 channels x 8 U steps.
// scratch: 4 + 128 * capacity 32-bit words, 16-byte aligned, zero-filled
// when allocated and then kept by the caller for every later call on its
// stream (the kernel leaves it ready for the next launch); capacity >= the
// call's tiles, B * ceil(R / 32) * ceil(S / (8 U)). Returns a cudaError_t
// code.
extern "C" int rglru_scan_launch(const void* a, const void* b, void* h,
                                 void* scratch, long long capacity, int B,
                                 int S, int R, int steps, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || scratch == nullptr ||
      (uintptr_t)scratch % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_slabs = (R + kCols - 1) / kCols;
  const long long n_cols = (long long)B * n_slabs;
  const long long T = (long long)kWarps * steps;
  const long long n_tiles = n_cols * ((S + T - 1) / T);
  if (n_cols > INT_MAX || n_tiles >= INT_MAX || n_tiles > capacity)
    return (int)cudaErrorInvalidValue;
  unsigned* w = static_cast<unsigned*>(scratch);
  Scratch sc;
  sc.state = w;
  sc.words = reinterpret_cast<uint4*>(w + 4);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* hf = static_cast<float*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ns = (int)n_slabs, nc = (int)n_cols;
  const unsigned nt = (unsigned)n_tiles;
  switch (steps) {
    case 1: return (int)launch<1>(af, bf, hf, sc, S, R, ns, nc, nt, s);
    case 2: return (int)launch<2>(af, bf, hf, sc, S, R, ns, nc, nt, s);
    case 4: return (int)launch<4>(af, bf, hf, sc, S, R, ns, nc, nt, s);
    case 8: return (int)launch<8>(af, bf, hf, sc, S, R, ns, nc, nt, s);
    case 16: return (int)launch<16>(af, bf, hf, sc, S, R, ns, nc, nt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
