// Device code of the tile bodies: K1's and K7's stash kernels (csrc/
// meta_stash_fwd.cuh: K1-stash, K1-stash light, K1-scores, K7-stash;
// csrc/meta_stash_bwd.cuh: K1-bwd-stash, K1-bwd-stash light, K7-bwd-stash),
// their recompute backwards (K1-bwd, K7-bwd) and K6-bwd (csrc/
// gate_block_bwd.cu).
//
// A block of 4 R threads owns a tile of E = R / F examples at a time (R =
// kTileRows = 80 rows in the MetaNet backward: 4 examples at F = 19, 5 at
// F = 15; R = kWideTileRows = 96 in the forward and K6-bwd: 5 and 6), so
// that every product of the layer has E F >= 64 rows instead of one
// example's F, and the tile's attention has at most one (head, row) pair
// a thread.  It walks a
// contiguous range of the batch, persistently, one block an SM.  K1 and K6
// sort the range by domain row in windows of kWindow examples (sort_window),
// and the tiles are consecutive examples of that order, so that a tile
// holds one or two domains and each domain's rows are one segment of it.
// The sort runs in the kernel: it adds no launch to the host's queue,
// which sets the pace of a training step.  K7's slots are sorted already
// (ops/dispatch.py: single-domain dispatch tiles of tile_b slots, each
// with its own MetaNet block): its range is one of the occupied slots in
// slot order (occupied_window), and a tile's segments are its runs of one
// dispatch tile.
//
// The products run on the tensor cores as warp-level mma.sync m16n8k8 TF32
// with the 3xTF32 split: a = a_big + a_small with a_big = tf32(a) and
// a_small = tf32(a - a_big), the same for b, and a b = a_big b_big +
// (a_small b_big + a_big b_small) summed in float32 (the dropped a_small
// b_small is below 2^-20 of a b), which keeps the float32 layer's
// accuracy: the JAX reference computes every product in float32.
// block_gemm spreads a product's 16 x 8NT output strips over the warps;
// WTiles sums a weight gradient A^T G over a range of rows into 16 x 8
// tiles that each warp owns, in registers, so that the sums need no
// atomics and run in a fixed order.  The operands are read from shared
// memory through accessors (a row buffer, a transposed weight, a relu, a
// weight split ahead of time), so one routine serves every product of
// every body.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "layer_common.cuh"
#include "tma.cuh"

namespace {

constexpr int kTileRows = 80;     // the backward's tile: E = kTileRows / F
// threads of a tile block: one a (head, row) pair of the attention, whose
// tile has at most 4 heads x kTileRows pairs
constexpr int kTT = 4 * kTileRows;
constexpr int kTW = kTT / 32;     // its warps
constexpr int kRowThreads = 8;    // threads on one row of d = 32 in epilogues
constexpr int kRowsAPass = kTT / kRowThreads;  // two passes cover a tile
static_assert(kTileRows % kRowsAPass == 0, "whole passes");
// the forward's tile (4 kWideTileRows threads): its 6 m-tiles give a
// product's 12 output strips to 12 warps, three on each of the SM's four
// sub-partitions (the MetaNet backward's buffers leave room for kTileRows
// only)
constexpr int kWideTileRows = 96;
constexpr int kWindow = 256;      // examples sorted by domain together

__host__ __device__ constexpr int tile_examples(int F,
                                                int rows = kTileRows) {
  return rows / F;
}

// The shared header of a tile body: 32 bytes for mbarriers, then the
// window's order, domain rows and sort keys (kWindow ints each), then each
// slot's dropout draw.
constexpr int kTileHeader =
    32 + 3 * kWindow * 4 +
    kWideTileRows * static_cast<int>(sizeof(ExampleDraw));
static_assert(kTileHeader % 16 == 0, "16-byte aligned regions");

struct TileHeader {
  int *order, *wdom, *key;
  ExampleDraw* draws;
  __device__ explicit TileHeader(unsigned char* smem)
      : order(reinterpret_cast<int*>(smem + 32)),
        wdom(order + kWindow),
        key(wdom + kWindow),
        draws(reinterpret_cast<ExampleDraw*>(key + kWindow)) {}
};

// Each slot's place in the dropout's draws (ExampleDraw: four divisions),
// once a tile, before the tile's first barrier; the epilogues and the
// attention pairs read it.
__device__ __forceinline__ void tile_draws(ExampleDraw* draws,
                                           const Dropout& drop, const int* ex,
                                           int n) {
  if (drop.on)
    for (int s = threadIdx.x; s < n; s += blockDim.x)
      draws[s] = ExampleDraw(drop, ex[s]);
}

// The examples each block walks: whole tiles, as evenly as the grid allows.
__host__ __device__ inline int block_chunk(int B, int F, int grid,
                                           int rows = kTileRows) {
  const int E = tile_examples(F, rows), tiles = (B + E - 1) / E;
  return (tiles + grid - 1) / grid * E;
}

// The number of blocks a backward tile body uses for B examples of F
// fields on sms SMs: one an SM, or one a tile when there are fewer tiles.
inline int stash_bwd_blocks(int B, int F, int sms, int rows = kTileRows) {
  const int E = tile_examples(F, rows), tiles = (B + E - 1) / E;
  return tiles < sms ? tiles : sms;
}

// x rounded to TF32 (10 mantissa bits), half-ups of the dropped 13 bits
// away from zero, by integer operations (the full-rate ALU, where cvt.rna
// would take the conversion unit's quarter rate); x finite.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32 (3xTF32); x - big is exact in float32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// A weight element split ahead of time (stage_split): its two TF32 halves.
struct Split2 {
  uint32_t big, small;
};

__device__ __forceinline__ void split_tf32(Split2 x, uint32_t& big,
                                           uint32_t& small) {
  big = x.big;
  small = x.small;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 3xTF32 step: hi += a_big b_big, lo += a_small b_big + a_big
// b_small.  hi and lo are separate chains, so the three mmas of a step do
// not wait on each other; the sum is hi + lo at the end.
__device__ __forceinline__ void mma_3xtf32(float (&hi)[4], float (&lo)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(lo, as, bb[0], bb[1]);
  mma_tf32(hi, ab, bb[0], bb[1]);
  mma_tf32(lo, ab, bs[0], bs[1]);
}

// out = A B for the rows of the 16-row m-tiles [mt0, mt1): A(m, k) [. x K],
// B(k, n) [K x N] accessors.  Each warp takes a 16 x 8NT output strip at a
// time, unrolling UNROLL of its K / 8 steps; epi(row, col, v0, v1) receives
// the thread's sums at (row, col) and (row, col + 1) (the mma's C fragment:
// rows g and g + 8 of the strip).
template <int K, int N, int NT, int UNROLL = 4, class AF, class BF,
          class Epi>
__device__ __forceinline__ void block_gemm(int mt0, int mt1, AF a, BF b,
                                           Epi epi) {
  constexpr int NG = N / (8 * NT);
  static_assert(N % (8 * NT) == 0 && K % 8 == 0, "unsupported product");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int u = warp; u < (mt1 - mt0) * NG; u += blockDim.x / 32) {
    const int m0 = (mt0 + u / NG) * 16, n0 = (u % NG) * 8 * NT;
    float acc[NT][4], lo[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = lo[j][c] = 0.f;
    }
#pragma unroll(UNROLL)
    for (int k0 = 0; k0 < K; k0 += 8) {
      uint32_t ab[4], as[4];
      split_tf32(a(m0 + g, k0 + t), ab[0], as[0]);
      split_tf32(a(m0 + g + 8, k0 + t), ab[1], as[1]);
      split_tf32(a(m0 + g, k0 + t + 4), ab[2], as[2]);
      split_tf32(a(m0 + g + 8, k0 + t + 4), ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bb[2], bs[2];
        split_tf32(b(k0 + t, n0 + 8 * j + g), bb[0], bs[0]);
        split_tf32(b(k0 + t + 4, n0 + 8 * j + g), bb[1], bs[1]);
        mma_3xtf32(acc[j], lo[j], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] += lo[j][c];
      epi(m0 + g, n0 + 8 * j + 2 * t, acc[j][0], acc[j][1]);
      epi(m0 + g + 8, n0 + 8 * j + 2 * t, acc[j][2], acc[j][3]);
    }
  }
}

// The 16 x 8 tiles of an [M x N] weight gradient that each of a block's W
// warps owns: tile warp + W i < kTiles, i < WTiles<M, N, W>::kPerWarp, in
// row-major tile order.
template <int M, int N, int W = kTW>
struct WTiles {
  static_assert(M % 16 == 0 && N % 8 == 0, "unsupported weight shape");
  static constexpr int kTiles = (M / 16) * (N / 8);
  static constexpr int kPerWarp = (kTiles + W - 1) / W;
  float acc[kPerWarp][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    }
  }

  // acc += sum over rows r in [r0, r1) of A(r, m) G(r, n), r in order of
  // eight-row steps (the rows outside the range count zero on both sides).
  // The call's products are summed in a fresh accumulator, added to acc
  // once: the tensor cores' float32 accumulation does not round to
  // nearest, and one chain over a block's whole range (tens of thousands
  // of rows) drifts by far more than a float32 sum's rounding.
  template <class AF, class GF>
  __device__ __forceinline__ void add(int r0, int r1, AF a, GF gf) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    float cur[kPerWarp][4];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) cur[i][c] = 0.f;
    }
#pragma unroll 2
    for (int k0 = r0 & ~7; k0 < r1; k0 += 8) {
      const int ra = k0 + t, rb = k0 + t + 4;
      const bool va = ra >= r0 && ra < r1, vb = rb >= r0 && rb < r1;
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const int u = warp + W * i;
        if (kTiles % W && u >= kTiles) break;  // uniform in the warp
        const int m0 = (u / (N / 8)) * 16, n0 = (u % (N / 8)) * 8;
        uint32_t ab[4], as[4], bb[2], bs[2];
        split_tf32(va ? a(ra, m0 + g) : 0.f, ab[0], as[0]);
        split_tf32(va ? a(ra, m0 + g + 8) : 0.f, ab[1], as[1]);
        split_tf32(vb ? a(rb, m0 + g) : 0.f, ab[2], as[2]);
        split_tf32(vb ? a(rb, m0 + g + 8) : 0.f, ab[3], as[3]);
        split_tf32(va ? gf(ra, n0 + g) : 0.f, bb[0], bs[0]);
        split_tf32(vb ? gf(rb, n0 + g) : 0.f, bb[1], bs[1]);
        mma_3xtf32(cur[i], cur[i], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] += cur[i][c];
    }
  }

  // f(m, n, v0, v1) for the thread's elements (m, n) and (m, n + 1)
  template <class Fn>
  __device__ __forceinline__ void each(Fn f) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int u = warp + W * i;
      if (kTiles % W && u >= kTiles) break;
      const int m = (u / (N / 8)) * 16 + g, n = (u % (N / 8)) * 8 + 2 * t;
      f(m, n, acc[i][0], acc[i][1]);
      f(m + 8, n, acc[i][2], acc[i][3]);
    }
  }

  // dst [M][N] (row-major, global memory) += acc, then acc = 0; each
  // element has this one owner
  __device__ __forceinline__ void flush(float* dst) {
    each([&](int m, int n, float v0, float v1) {
      float2* p = reinterpret_cast<float2*>(dst + m * N + n);
      const float2 o = *p;
      *p = make_float2(o.x + v0, o.y + v1);
    });
    zero();
  }

  // dst [M][N] = acc (the block's slice, written once)
  __device__ __forceinline__ void store(float* dst) const {
    each([&](int m, int n, float v0, float v1) {
      *reinterpret_cast<float2*>(dst + m * N + n) = make_float2(v0, v1);
    });
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Closes this thread's open cp.async copies into one group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// dst [ROWS][ds] (shared) <- src [ROWS][COLS] (global, contiguous) by the
// block's 16-byte cp.async copies; the caller waits (cp_async_wait_all)
// and meets a barrier before reading.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_matrix(float* dst, int ds,
                                             const float* src) {
  for (int i = threadIdx.x; i < ROWS * COLS / 4; i += blockDim.x) {
    const int r = i / (COLS / 4), c = 4 * (i % (COLS / 4));
    cp_async16(dst + r * ds + c, src + r * COLS + c);
  }
}

// big [ROWS][ds] and small [ROWS][ds] (shared) <- the 3xTF32 halves of src
// [ROWS][COLS] (global, contiguous), so that a product's weight operand is
// split once a staging instead of once an m-tile; the caller meets a
// barrier before reading.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_split(uint32_t* big, uint32_t* small,
                                            int ds, const float* src) {
  for (int i = threadIdx.x; i < ROWS * COLS / 4; i += blockDim.x) {
    const int r = i / (COLS / 4), c = 4 * (i % (COLS / 4));
    float v[4];
    to4(ldg4(src + r * COLS + c), v);
    uint4 b, s;
    split_tf32(v[0], b.x, s.x);
    split_tf32(v[1], b.y, s.y);
    split_tf32(v[2], b.z, s.z);
    split_tf32(v[3], b.w, s.w);
    *reinterpret_cast<uint4*>(big + r * ds + c) = b;
    *reinterpret_cast<uint4*>(small + r * ds + c) = s;
  }
}

// The examples [w0, w0 + n) of the batch, stably sorted by their clamped
// domain row (out-of-range ids clamped to [0, D) as everywhere in K1):
// order[k] the k-th example, wdom[k] its row.  key is n ints of scratch.
// Every thread calls it; it ends at a barrier.
__device__ __forceinline__ void sort_window(const int* __restrict__ dom,
                                            int w0, int n, int D, int* order,
                                            int* wdom, int* key) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    key[i] = min(max(dom[w0 + i], 0), D - 1);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int d = key[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const int dj = key[j];
      rank += dj < d || (dj == d && j < i);
    }
    order[rank] = w0 + i;
    wdom[rank] = d;
  }
  __syncthreads();
}

// K7's dispatch (ops/dispatch.py): T tiles of tile_b slots, tile t's
// occupied slots the first count[t] of it (all of them where count is
// null; the others are slack).  The occupied slots in slot order are the
// positions that the blocks of a K7 body split between them.

// The occupied slots of dispatch tile t.
__device__ __forceinline__ int tile_occupied(const int* count, int t,
                                             int tile_b) {
  return count ? min(max(__ldg(count + t), 0), tile_b) : tile_b;
}

// The occupied slots of all T tiles.  scan is a warp count of ints of
// shared scratch.  Every thread calls it and gets the same value.
__device__ inline int occupied_total(const int* count, int T, int tile_b,
                                     int* scan) {
  if (!count) return T * tile_b;
  int s = 0;
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    s += tile_occupied(count, t, tile_b);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) scan[threadIdx.x >> 5] = s;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
    total += scan[w];
  __syncthreads();  // scan is free again
  return total;
}

// The occupied slots at positions [w0, w0 + n) of the slot order (n >= 1,
// w0 + n at most occupied_total): order[k] the slot, wdom[k] its dispatch
// tile.  A block-wide prefix sum of the counts, a tile a thread, up to the
// window's end.  scan as above.  Every thread calls it; it ends at a
// barrier.
__device__ inline void occupied_window(const int* count, int T, int tile_b,
                                       int w0, int n, int* order, int* wdom,
                                       int* scan) {
  if (!count) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      order[k] = w0 + k;
      wdom[k] = (w0 + k) / tile_b;
    }
    __syncthreads();
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int c0 = 0, base = 0; c0 < T && base < w0 + n; c0 += blockDim.x) {
    const int t = c0 + threadIdx.x;
    const int c = t < T ? tile_occupied(count, t, tile_b) : 0;
    int v = c;  // inclusive prefix sum in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) scan[warp] = v;
    __syncthreads();
    int start = base + v - c, all = base;
    for (int j = 0; j < warps; ++j) {
      const int sj = scan[j];
      all += sj;
      if (j < warp) start += sj;
    }
    for (int k = max(start, w0); k < min(start + c, w0 + n); ++k) {
      order[k - w0] = t * tile_b + k - start;
      wdom[k - w0] = t;
    }
    __syncthreads();  // scan is read, the window written
    base = all;
  }
}

// Asynchronous loads of the tile's rows of a [B, F, W] array into the
// shared rows dst (stride ds), row s F + f for example ex[s]: 16-byte
// cp.async copies spread over the block's threads, into each thread's
// open group (the caller commits, waits and meets a barrier).  A bulk copy
// of the TMA a row would fit the padded rows too, but on the card issuing
// a tile's hundreds of them held up the issuing warp, and the other warps
// waited for it at the next barrier.
template <int W>
__device__ __forceinline__ void load_rows(float* dst, int ds,
                                          const float* src, const int* ex,
                                          int n, int F) {
  for (int i = threadIdx.x; i < n * F * (W / 4); i += blockDim.x) {
    const int r = i / (W / 4), c = 4 * (i % (W / 4)), s = r / F;
    cp_async16(dst + r * ds + c,
               src + (static_cast<size_t>(ex[s]) * F + r - s * F) * W + c);
  }
}

// The tile's rows (src, stride ss) out to a [B, F, W] array, whole rows of
// float4s by consecutive threads.
template <int W>
__device__ __forceinline__ void store_rows(float* dst, const float* src,
                                           int ss, const int* ex, int n,
                                           int F) {
  for (int i = threadIdx.x; i < n * F * (W / 4); i += blockDim.x) {
    const int r = i / (W / 4), c = 4 * (i % (W / 4)), s = r / F;
    *reinterpret_cast<float4*>(
        dst + (static_cast<size_t>(ex[s]) * F + r - s * F) * W + c) =
        ld4(src + r * ss + c);
  }
}

// Runs fn(d, r0, r1) for each segment of the tile: the rows [r0, r1) of
// the consecutive slots whose row wdom[.] is d (K1 a domain row, K7 a
// dispatch tile).
template <class Fn>
__device__ __forceinline__ void for_segments(const int* dm, int n, int F,
                                             Fn fn) {
  for (int s0 = 0; s0 < n;) {
    const int d = dm[s0];
    int s1 = s0 + 1;
    while (s1 < n && dm[s1] == d) ++s1;
    fn(d, s0 * F, s1 * F);
    s0 = s1;
  }
}

// Runs fn(slot, head, row) for each (head, row) pair of the tile's n
// examples, spread over the block's threads.
template <int NH, class Fn>
__device__ __forceinline__ void for_pairs(int n, int F, Fn fn) {
  const int per = NH * F;
#pragma unroll 1
  for (int p = threadIdx.x; p < n * per; p += blockDim.x) {
    const int s = p / per, q = p - s * per;
    fn(s, q / F, q % F);
  }
}

}  // namespace
