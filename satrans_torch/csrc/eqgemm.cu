// Duplicate-summed row gradients per position, float32 (K3):
//
//   s[f, i, :] = sum_j [ids[f, i] == ids[f, j]] g[f, j, :]
//
// for ids [F, B] int64 (non-negative) and g, s [F, B, W].  Replaces the TPU
// kernel satrans_tpu/ops/pallas/eqgemm.py:eqgemm_positions, which builds
// [TI, B] equality tiles in VMEM and contracts them with g on the MXU in
// one bf16 pass.  The contract here is the JAX package's exact float32
// einsum (its CPU path); the bf16 cast was a TPU precision choice and is
// not kept.
//
// What bounds it.  The function reads ids and g once and writes s once:
// about 84 MB at the AliCCP sota shape (F = 10, B = 8192, W = 128), 25 us
// at 3.35 TB/s.  Almost every product of the TPU's equality GEMM is a
// multiply by zero, and the B^2 compares behind it are not needed either:
// grouping a field's positions by id is a sort, O(B log B).
//
// Design.  P blocks of 1024 threads a field group its positions, block k
// those whose id hashes to bucket k (equal ids share a bucket, so no run
// of duplicates crosses blocks): it counts every bucket of the field (the
// bucket's place in the field's sorted order), gathers its bucket's (id,
// position) pairs in position order into shared memory, and sorts them
// with a stable LSD radix sort over only the bits in which the bucket's
// ids differ (OR ^ AND of its ids: no pass for a bucket of one id, 3 for
// the 21-bit rows of the packed bank), 8-bit digits: each warp counts the
// digits of its contiguous range (8 ballots rank equal digits within a
// batch of 32), one block scan of the [digit][warp] counts, and each warp
// scatters its range in order.  So a field's sorted order is bucket by
// bucket, id by id, position by position, and each run of one id is a
// contiguous range.  The sorted order is cut into chunks of 32 within each
// bucket (a field's chunk slots: bucket k's from the sum of the earlier
// buckets' chunk counts).  A warp sums a chunk: it reads the chunk's rows
// in sorted order (a row of W = 128 is one 16-byte load a lane, 8 rows in
// flight) and adds each run's rows in ascending position; a run inside the
// chunk (the common run of one position is a copy) gets its total stored
// to every member, a run cut by the chunk's bounds leaves its share in the
// chunk's first or last slot of a scratch buffer.  Then each chunk holding
// part of a cut run (the padded tail's zero ids, a field of few values)
// adds the run's shares in chunk order and stores the total to its
// members.  Three launches: eqgemm_group_kernel writes the field's sorted
// order (position, run bounds: int4) and its buckets' starts, and
// eqgemm_slots_kernel, once to sum and once for the cut runs, gives a warp
// to each chunk slot over the card, so a long run is summed by many SMs
// (the grouping blocks summing their own buckets instead took twice as
// long on a padded tail batch, whose run of zero ids lands in one block).
//
// Every member of a run gets the same total from the same additions in
// the same order, so duplicate positions carry byte-identical rows
// (the precondition of the racing scatter K2), and a launch is
// deterministic: no atomics in any sum (the bucket counts are integer).  A
// row whose W is not a multiple of 4 takes a scalar path, one float a
// lane.  Past the shared memory's room (B > 9,440) the sort's arrays live
// in a global scratch.
//
// Each kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kGroupThreads = 1024;  // a grouping block
constexpr int kGroupWarps = kGroupThreads / 32;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kPartBits = 5;
// blocks (buckets) a field: their parts + 1 starts fit a warp's lanes
constexpr int kMaxParts = (1 << kPartBits) - 1;
// the counts [digit][warp], a digit's row padded to 33 ints so that the
// leaders of one warp's digits hit distinct banks
constexpr int kHistRow = kGroupWarps + 1;
constexpr int kHist = kDigits * kHistRow;
constexpr int kChunk = 32;                    // sorted indices a warp
constexpr int kPassWarps = 8;
constexpr int kBatch = 8;                     // rows a lane has in flight
constexpr int kMaxSmem = 232448;              // bytes a block may use
constexpr unsigned kAll = 0xffffffffu;

// The shared header of a grouping block.
struct Header {
  int hist[kHist];
  int wbuf[32];             // block scans
  int wcnt[kGroupWarps];    // the bucket's ids in each warp's range
  int kcnt[kMaxParts + 1];  // the ids of each bucket
  unsigned long long s_or, s_and;  // of the bucket's ids
};
static_assert(sizeof(Header) % 16 == 0, "16-byte aligned arrays");

// The sort's arrays for a bucket of up to B ids, from a 16-byte boundary:
// the ids (uint64), their positions and a ping-pong pair of index buffers
// (int, round4(B) each, so that the pair, which first holds the field's B
// ids as uint64, starts on an 8-byte boundary for any B), and each
// position's bucket (a byte); a slice of them is whole 16-byte words.
__host__ __device__ constexpr size_t round4(int n) {
  return (static_cast<size_t>(n) + 3) & ~static_cast<size_t>(3);
}

__host__ __device__ constexpr size_t sort_bytes(int B) {
  return (8 * static_cast<size_t>(B) + 12 * round4(B) + B + 15) &
         ~static_cast<size_t>(15);
}

__host__ __device__ constexpr bool sort_in_smem(int B) {
  return sizeof(Header) + sort_bytes(B) <= kMaxSmem;
}

__host__ __device__ constexpr int chunks(int n) {
  return (n + kChunk - 1) / kChunk;
}

// A field's chunk slots: its chunks, and at most one short chunk more a
// bucket.
__host__ __device__ constexpr int slots(int B, int parts) {
  return chunks(B) + parts;
}

// The bucket of an id among parts: the top of a multiplicative (Fibonacci)
// hash of its two words.
__device__ __forceinline__ int bucket_of(uint64_t id, int parts) {
  const uint32_t x = static_cast<uint32_t>(id) ^
                     static_cast<uint32_t>(id >> 32);
  return static_cast<int>(__umulhi(x * 0x9E3779B9u, parts));
}

// The exclusive prefix of v over the block's threads in thread order, for
// an associative op with its identity; wbuf holds 32 ints.
template <class Op>
__device__ __forceinline__ int block_exclusive(int v, int* wbuf, int id,
                                               Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl = op(incl, u);
  }
  if (lane == 31) wbuf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kGroupWarps ? wbuf[lane] : id;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kAll, w, o);
      if (lane >= o) w = op(w, u);
    }
    wbuf[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  int before = __shfl_up_sync(kAll, incl, 1);
  if (lane == 0) before = id;
  const int r = op(warp ? wbuf[warp - 1] : id, before);
  __syncthreads();  // wbuf is free again
  return r;
}

// The lanes of the warp whose BITS-bit digit d equals this lane's, among
// the lanes with valid set (meaningful on those): one ballot a bit, as
// warp-level radix sorts rank their digits.
template <int BITS>
__device__ __forceinline__ unsigned peers(int d, bool valid) {
  unsigned m = __ballot_sync(kAll, valid);
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const bool bit = d >> b & 1;
    const unsigned v = __ballot_sync(kAll, bit);
    m &= bit ? v : ~v;
  }
  return m;
}

// A warp's contiguous range of [0, n), whole batches of 32.
__device__ __forceinline__ int2 warp_range(int n) {
  const int per = ((n + kGroupWarps - 1) / kGroupWarps + 31) & ~31;
  const int lo = (threadIdx.x >> 5) * per;
  return make_int2(lo, min(n, lo + per));
}

// One stable counting pass of src into dst (indices of key, n of them) on
// the digit at shift.
__device__ __forceinline__ void radix_pass(const uint64_t* key,
                                           const int* src, int* dst,
                                           Header& hd, int n, int shift) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int2 r = warp_range(n);
  const unsigned below = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < kHist; i += kGroupThreads) hd.hist[i] = 0;
  __syncthreads();
  for (int b = r.x; b < r.y; b += 32) {  // uniform over the warp
    const int i = b + lane;
    const bool valid = i < r.y;
    const int d = valid ? static_cast<int>((key[src[i]] >> shift) &
                                           (kDigits - 1))
                        : 0;
    const unsigned m = peers<kDigitBits>(d, valid);
    if (valid && lane == __ffs(m) - 1)
      hd.hist[d * kHistRow + warp] += __popc(m);
    __syncwarp();
  }
  __syncthreads();
  {  // exclusive scan of the counts in [digit][warp] order (the pads are 0)
    constexpr int kPer = (kHist + kGroupThreads - 1) / kGroupThreads;
    const int i0 = threadIdx.x * kPer;
    int v[kPer], sum = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      sum += v[j] = i0 + j < kHist ? hd.hist[i0 + j] : 0;
    int run = block_exclusive(sum, hd.wbuf, 0,
                              [](int a, int b) { return a + b; });
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (i0 + j < kHist) hd.hist[i0 + j] = run;
      run += v[j];
    }
  }
  __syncthreads();
  for (int b = r.x; b < r.y; b += 32) {
    const int i = b + lane;
    const bool valid = i < r.y;
    int e = 0, d = 0;
    if (valid) {
      e = src[i];
      d = static_cast<int>((key[e] >> shift) & (kDigits - 1));
    }
    const unsigned m = peers<kDigitBits>(d, valid);
    int* h = hd.hist + d * kHistRow + warp;
    const int base = valid ? *h : 0;
    __syncwarp();
    if (valid) {
      dst[base + __popc(m & below)] = e;
      if (lane == __ffs(m) - 1) *h = base + __popc(m);
    }
    __syncwarp();
  }
  __syncthreads();
}

// A bucket grouped: for its sorted index j (of n), the position
// pos[order[j]], the start head[j] and end rend[head[j]] of its run (all
// bucket indices) and the bucket's first sorted index in the field (off).
// The field's counts are Header::kcnt.
struct Bucket {
  const int *order, *pos, *head, *rend;
  int n, off;
};

// The sort arrays of a grouping block: in shared memory past the header,
// or the block's slice of a global scratch.
struct SortArrays {
  uint64_t* key;
  int *pos, *a, *b;
  unsigned char* bucket;
  __device__ SortArrays(unsigned char* smem, unsigned char* sort_scratch,
                        int B) {
    const size_t slice = static_cast<size_t>(blockIdx.y) * gridDim.x +
                         blockIdx.x;
    unsigned char* base = sort_scratch ? sort_scratch + sort_bytes(B) * slice
                                       : smem + sizeof(Header);
    key = reinterpret_cast<uint64_t*>(base);
    pos = reinterpret_cast<int*>(key + B);
    a = pos + round4(B);
    b = a + round4(B);
    bucket = reinterpret_cast<unsigned char*>(b + round4(B));
  }
};

// Groups bucket blockIdx.x of the field blockIdx.y (of gridDim.x buckets)
// whose B ids are fid, with the whole block.
__device__ __forceinline__ Bucket group_bucket(const int64_t* fid, int B,
                                               Header& hd,
                                               const SortArrays& sa) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = blockIdx.x, parts = gridDim.x;
  const long long* ids = reinterpret_cast<const long long*>(fid);
  // the field's ids by position, in the a|b buffers until the sort
  uint64_t* cache = reinterpret_cast<uint64_t*>(sa.a);
  if (tid <= kMaxParts) hd.kcnt[tid] = 0;
  if (tid == 0) {
    hd.s_or = 0ull;
    hd.s_and = ~0ull;
  }
  __syncthreads();
  // every bucket's count, this bucket's in each warp's contiguous range,
  // and the OR and AND of its ids: the loads of kBatch batches of the warp
  // in flight at once
  const int2 r = warp_range(B);
  const unsigned below = (1u << lane) - 1u;
  int mine = 0;
  unsigned long long orv = 0ull, andv = ~0ull;
  for (int i0 = r.x; i0 < r.y; i0 += kBatch * 32) {
    uint64_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + 32 * u + lane;
      v[u] = i < r.y ? static_cast<uint64_t>(__ldg(ids + i)) : 0ull;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + 32 * u + lane;
      if (i0 + 32 * u < r.y) {  // uniform over the warp
        const bool valid = i < r.y;
        const int bk = valid ? bucket_of(v[u], parts) : 0;
        const unsigned m = peers<kPartBits>(bk, valid);
        if (valid && lane == __ffs(m) - 1)
          atomicAdd(&hd.kcnt[bk], __popc(m));
        const bool in = valid && bk == k;
        mine += __popc(__ballot_sync(kAll, in));
        if (valid) {
          cache[i] = v[u];
          sa.bucket[i] = static_cast<unsigned char>(bk);
        }
        if (in) {
          orv |= v[u];
          andv &= v[u];
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    orv |= __shfl_xor_sync(kAll, orv, o);
    andv &= __shfl_xor_sync(kAll, andv, o);
  }
  if (lane == 0) {
    hd.wcnt[warp] = mine;
    atomicOr(&hd.s_or, orv);
    atomicAnd(&hd.s_and, andv);
  }
  __syncthreads();
  int off = 0, run = 0;
  for (int q = 0; q < k; ++q) off += hd.kcnt[q];
  for (int q = 0; q < warp; ++q) run += hd.wcnt[q];
  const int n = hd.kcnt[k];
  // the bucket's ids and positions in position order, each warp's after
  // the earlier warps'
  for (int b0 = r.x; b0 < r.y; b0 += 32) {
    const int i = b0 + lane;
    const bool in = i < r.y && sa.bucket[i] == k;
    const unsigned bal = __ballot_sync(kAll, in);
    if (in) {
      const int j = run + __popc(bal & below);
      sa.key[j] = cache[i];
      sa.pos[j] = i;
    }
    run += __popc(bal);
  }
  __syncthreads();  // the cache is read no more
  for (int j = tid; j < n; j += kGroupThreads) sa.a[j] = j;
  __syncthreads();
  const unsigned long long diff = n > 1 ? hd.s_or ^ hd.s_and : 0ull;
  int *src = sa.a, *dst = sa.b;
  if (diff) {  // uniform
    const int lo = __ffsll(static_cast<long long>(diff)) - 1;
    const int hi = 63 - __clzll(static_cast<long long>(diff));
    for (int sh = lo; sh <= hi; sh += kDigitBits) {
      radix_pass(sa.key, src, dst, hd, n, sh);
      int* t = src;
      src = dst;
      dst = t;
    }
  }
  // the runs: a thread owns ept consecutive sorted indices; head[j] (in
  // dst) is the last run start at or before j
  const int ept = (n + kGroupThreads - 1) / kGroupThreads;
  const int j0 = min(n, tid * ept), j1 = min(n, j0 + ept);
  int last = -1;
  for (int j = j0; j < j1; ++j) {
    if (j == 0 || sa.key[src[j]] != sa.key[src[j - 1]]) last = j;
    dst[j] = last;
  }
  const int before = block_exclusive(
      last, hd.wbuf, -1, [](int x, int y) { return x > y ? x : y; });
  for (int j = j0; j < j1; ++j)
    if (dst[j] < 0) dst[j] = before;
  __syncthreads();  // the heads are whole; the ids are read no more
  int* rend = reinterpret_cast<int*>(sa.key);
  for (int j = j0; j < j1; ++j)
    if (j + 1 == n || dst[j + 1] != dst[j]) rend[dst[j]] = j + 1;
  __syncthreads();
  return {src, sa.pos, dst, rend, n, off};
}

// A lane's columns of a row: 4 floats (a 16-byte access) or 1.
template <bool VEC>
struct Cols;

template <>
struct Cols<true> {
  using T = float4;
  static constexpr int kStep = 128;  // columns of a warp
  __device__ static int col(int lane) { return 4 * lane; }
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T ldg(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  __device__ static T add(T a, T b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
};

template <>
struct Cols<false> {
  using T = float;
  static constexpr int kStep = 32;
  __device__ static int col(int lane) { return lane; }
  __device__ static T zero() { return 0.f; }
  __device__ static T ldg(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, T v) { *p = v; }
  __device__ static T add(T a, T b) { return __fadd_rn(a, b); }
};

// A chunk of the field's sorted order, a warp: sorted indices [k0, k0 + n)
// in slot s of the field's chunk slots; the lane's entry (lanes < n) is
// position p of the run [st, en) (sorted indices of the field).
struct Chunk {
  int k0, n, s;
  int p, st, en;
};

// The sums of chunk c: a run inside it gets its total stored to its
// members' rows of s; a cut run's share of the chunk goes to the slot's
// first row (the run began before the chunk) and its last row (it goes on
// after it) of the field's slots part.
template <bool VEC>
__device__ __forceinline__ void pass_chunk(const Chunk& c, const float* g,
                                           float* s, float* part, int W) {
  using C = Cols<VEC>;
  const int lane = threadIdx.x & 31;
  const bool close =
      lane < c.n && (c.en == c.k0 + lane + 1 || lane == c.n - 1);
  const bool cut = c.st < c.k0 || c.en > c.k0 + c.n;
  const unsigned closes = __ballot_sync(kAll, close);
  const unsigned cuts = __ballot_sync(kAll, close && cut);
  float* pc = part + static_cast<size_t>(c.s) * 2 * W;
  for (int cb = 0; cb < W; cb += C::kStep) {
    const int col = cb + C::col(lane);
    const bool act = col < W;
    typename C::T acc = C::zero();
    for (int j0 = 0; j0 < c.n; j0 += kBatch) {
      typename C::T v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u;
        const int pj = __shfl_sync(kAll, c.p, j & 31);
        v[u] = j < c.n && act
                   ? C::ldg(g + static_cast<size_t>(pj) * W + col)
                   : C::zero();
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u;
        if (j < c.n) {  // uniform, as every branch below
          acc = C::add(acc, v[u]);
          if (closes >> j & 1u) {
            const int sj = __shfl_sync(kAll, c.st, j);
            const int ej = __shfl_sync(kAll, c.en, j);
            if (cuts >> j & 1u) {
              if (act && sj < c.k0) C::store(pc + col, acc);
              if (act && ej > c.k0 + c.n) C::store(pc + W + col, acc);
            } else {
              for (int m = sj - c.k0; m <= j; ++m) {
                const int pm = __shfl_sync(kAll, c.p, m);
                if (act)
                  C::store(s + static_cast<size_t>(pm) * W + col, acc);
              }
            }
            acc = C::zero();
          }
        }
      }
    }
  }
}

// The members of cut runs in chunk c of bucket [off, ...) with its first
// chunk slot choff: each cut run's total is its first chunk's last row
// plus the next chunks' first rows, in chunk order, the same additions for
// every member.
template <bool VEC>
__device__ __forceinline__ void bcast_chunk(const Chunk& c, int off,
                                            int choff, const float* part,
                                            float* s, int W) {
  using C = Cols<VEC>;
  const int lane = threadIdx.x & 31;
  const int s0 = __shfl_sync(kAll, c.st, 0), e0 = __shfl_sync(kAll, c.en, 0);
  const int sl = __shfl_sync(kAll, c.st, c.n - 1);
  const int el = __shfl_sync(kAll, c.en, c.n - 1);
  for (int r = 0; r < 2; ++r) {
    const int x = r ? sl : s0, y = r ? el : e0;
    if (r && x == s0) break;                     // the chunk's one run
    if (x >= c.k0 && y <= c.k0 + c.n) continue;  // whole: stored already
    const int sa = choff + (x - off) / kChunk;
    const int sz = choff + (y - 1 - off) / kChunk;
    const int m0 = max(x, c.k0) - c.k0, m1 = min(y, c.k0 + c.n) - c.k0;
    for (int cb = 0; cb < W; cb += C::kStep) {
      const int col = cb + C::col(lane);
      const bool act = col < W;
      typename C::T acc =
          act ? C::ldg(part + (2 * static_cast<size_t>(sa) + 1) * W + col)
              : C::zero();
      for (int q = sa + 1; q <= sz; q += kBatch) {
        typename C::T v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          v[u] = act && q + u <= sz
                     ? C::ldg(part + 2 * static_cast<size_t>(q + u) * W + col)
                     : C::zero();
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (q + u <= sz) acc = C::add(acc, v[u]);
      }
      for (int m = m0; m < m1; ++m) {
        const int pm = __shfl_sync(kAll, c.p, m);
        if (act) C::store(s + static_cast<size_t>(pm) * W + col, acc);
      }
    }
  }
}

// The grouping: bucket blockIdx.x of field blockIdx.y writes its sorted
// entries (position, run start, run end) into the
// field's info, and block 0 the field's bucket starts and chunk slot
// starts (starts: parts + 1 of each a field).
__global__ void __launch_bounds__(kGroupThreads)
    eqgemm_group_kernel(const int64_t* __restrict__ ids, int4* info,
                        int* starts, unsigned char* sort_scratch, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  Header& hd = *reinterpret_cast<Header*>(smem);
  const int f = blockIdx.y, parts = gridDim.x;
  const Bucket bk = group_bucket(ids + static_cast<size_t>(f) * B, B, hd,
                                 SortArrays(smem, sort_scratch, B));
  int4* out = info + static_cast<size_t>(f) * B + bk.off;
  for (int j = threadIdx.x; j < bk.n; j += kGroupThreads) {
    const int h = bk.head[j];
    out[j] = make_int4(bk.pos[bk.order[j]], bk.off + h, bk.off + bk.rend[h],
                       0);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int* st = starts + static_cast<size_t>(f) * 2 * (parts + 1);
    int off = 0, choff = 0;
    for (int q = 0; q <= parts; ++q) {
      st[q] = off;
      st[parts + 1 + q] = choff;
      if (q < parts) {
        off += hd.kcnt[q];
        choff += chunks(hd.kcnt[q]);
      }
    }
  }
}

// Chunk slot s of field f, from the field's bucket
// and chunk slot starts (lanes <= parts hold them): n = 0 past the last.
// off and choff receive the chunk's bucket's starts.
__device__ __forceinline__ Chunk slot_chunk(const int4* info,
                                            const int* starts, int f, int s,
                                            int B, int parts, int& off,
                                            int& choff) {
  const int lane = threadIdx.x & 31;
  const int* st = starts + static_cast<size_t>(f) * 2 * (parts + 1);
  const int bs = lane <= parts ? st[lane] : 0;
  const int cs = lane <= parts ? st[parts + 1 + lane] : 0;
  const unsigned le = __ballot_sync(kAll, lane < parts && cs <= s);
  const int k = 31 - __clz(le);  // the bucket: the last start at or below s
  const int total = __shfl_sync(kAll, cs, parts);
  off = __shfl_sync(kAll, bs, k);
  choff = __shfl_sync(kAll, cs, k);
  const int end = __shfl_sync(kAll, bs, k + 1);
  Chunk c{off + (s - choff) * kChunk, 0, s, 0, 0, 0};
  if (s >= total) return c;
  c.n = min(kChunk, end - c.k0);
  if (lane < c.n) {
    const int4 e = __ldg(info + static_cast<size_t>(f) * B + c.k0 + lane);
    c.p = e.x;
    c.st = e.y;
    c.en = e.z;
  }
  return c;
}

// The sums (BCAST false) and the cut runs (BCAST true): a warp a chunk
// slot.
template <bool VEC, bool BCAST>
__global__ void __launch_bounds__(kPassWarps * 32, 2)
    eqgemm_slots_kernel(const int4* __restrict__ info,
                        const int* __restrict__ starts,
                        const float* __restrict__ g, float* __restrict__ s,
                        float* part, int F, int B, int W, int parts) {
  const int S = slots(B, parts);
  const long long gw =
      static_cast<long long>(blockIdx.x) * kPassWarps + threadIdx.x / 32;
  if (gw >= static_cast<long long>(F) * S) return;
  const int f = static_cast<int>(gw / S), sl = static_cast<int>(gw % S);
  int off, choff;
  const Chunk c = slot_chunk(info, starts, f, sl, B, parts, off, choff);
  if (c.n <= 0) return;
  const size_t fb = static_cast<size_t>(f) * B * W;
  float* pf = part + static_cast<size_t>(f) * S * 2 * W;
  if (BCAST)
    bcast_chunk<VEC>(c, off, choff, pf, s + fb, W);
  else
    pass_chunk<VEC>(c, g + fb, s + fb, pf, W);
}

size_t round256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

// The scratch regions: the sorted entries (F B int4), the bucket and
// chunk slot starts (F 2 (parts + 1) ints), the chunk slots (F slots 2 W
// floats), and the sort arrays where they do not fit in shared memory.
struct Scratch {
  size_t info, starts, part, sort;
  Scratch(int F, int B, int W, int parts)
      : info(round256(static_cast<size_t>(F) * B * sizeof(int4))),
        starts(round256(static_cast<size_t>(F) * 2 * (parts + 1) * 4)),
        part(round256(static_cast<size_t>(F) * slots(B, parts) * 2 * W * 4)),
        sort(sort_in_smem(B) ? 0
                             : round256(static_cast<size_t>(F) * parts *
                                        sort_bytes(B))) {}
  size_t bytes() const { return info + starts + part + sort; }
};

template <bool VEC>
cudaError_t launch(const int64_t* ids, const float* g, float* s,
                   unsigned char* scratch, int F, int B, int W, int parts,
                   cudaStream_t st) {
  const Scratch sc(F, B, W, parts);
  int4* info = reinterpret_cast<int4*>(scratch);
  int* starts = reinterpret_cast<int*>(scratch + sc.info);
  float* part = reinterpret_cast<float*>(scratch + sc.info + sc.starts);
  unsigned char* sort =
      sc.sort ? scratch + sc.info + sc.starts + sc.part : nullptr;
  const size_t smem = sizeof(Header) + (sort ? 0 : sort_bytes(B));
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        eqgemm_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  eqgemm_group_kernel<<<dim3(parts, F), kGroupThreads, smem, st>>>(
      ids, info, starts, sort, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long warps = static_cast<long long>(F) * slots(B, parts);
  const unsigned grid =
      static_cast<unsigned>((warps + kPassWarps - 1) / kPassWarps);
  eqgemm_slots_kernel<VEC, false><<<grid, kPassWarps * 32, 0, st>>>(
      info, starts, g, s, part, F, B, W, parts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  eqgemm_slots_kernel<VEC, true><<<grid, kPassWarps * 32, 0, st>>>(
      info, starts, g, s, part, F, B, W, parts);
  return cudaGetLastError();
}

}  // namespace

// The most blocks a field may take.
extern "C" int satrans_eqgemm_max_parts() { return kMaxParts; }

// The bytes of satrans_eqgemm_positions' scratch for ids [F, B], rows of
// W and parts blocks a field.
extern "C" long long satrans_eqgemm_scratch_bytes(int F, int B, int W,
                                                  int parts) {
  if (F < 0 || B < 0 || W < 1 || parts < 1 || parts > kMaxParts) return -1;
  return static_cast<long long>(Scratch(F, B, W, parts).bytes());
}

// s = the per-field duplicate sums of g for ids (non-negative, int64), with
// parts (1 to satrans_eqgemm_max_parts()) grouping blocks a field.
// scratch: satrans_eqgemm_scratch_bytes(F, B, W, parts) bytes, 256-byte
// aligned.  Returns a cudaError_t.
extern "C" int satrans_eqgemm_positions(const int64_t* ids, const float* g,
                                        float* s, void* scratch, int F, int B,
                                        int W, int parts, void* stream) {
  if (F < 0 || B < 0 || W < 1 || parts < 1 || parts > kMaxParts ||
      F > 65535 || reinterpret_cast<uintptr_t>(scratch) % 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (F == 0 || B == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(s) % 16 == 0;
  return static_cast<int>(
      vec ? launch<true>(ids, g, s, sc, F, B, W, parts, st)
          : launch<false>(ids, g, s, sc, F, B, W, parts, st));
}
