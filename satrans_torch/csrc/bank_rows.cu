// Row kernels of the sparse bank updates, float32, ids int64:
//
//   satrans_gather_rows     K4  out[a][i] = arr[a][clamp(ids[i], 0, R-1)]
//   satrans_scatter_rows    K2  arr[a][ids[i]] = vals[a][i]   in place
//   satrans_lazy_adam_rows  K5  read, decayed Adam and write of each
//                               touched row of bank, mu and nu, in place
//
// They replace the TPU kernels satrans_tpu/ops/pallas/gather.py:gather_rows
// (K4), ops/pallas/scatter.py:scatter_rows_set (K2) and
// ops/pallas/lazy_tail.py:lazy_adam_rows (K5).  The TPU kernels start one
// DMA per row from a scalar-prefetched id list, fully unrolled over a row
// block, because XLA's TPU gathers and scatters serialise per row; none of
// that structure is kept.  Here one warp moves one row: its lanes cover
// the row's W floats with 16-byte loads and stores (4-byte ones where W is
// not a multiple of 4), neighbouring lanes on neighbouring addresses, and
// a block of 8 warps moves 8 rows.
//
// What bounds them.  Each row moves W * 4 bytes per array in and out and
// does a handful of float operations per element (K5: about 20): all
// three are bound by device memory.  At the AliCCP sota shapes (W = 128,
// N = 81,920 ids, 3 arrays of 1,642,953 rows) K2 and K4 move about 252 MB
// (75 us at 3.35 TB/s) and K5 about 294 MB (88 us).  The design keeps
// enough bytes in flight for that: every lane has one 16-byte access per
// array outstanding and a small register footprint lets 64 warps share an
// SM.
//
// Semantics kept from the TPU kernels:
// * K4 reads ids in [0, R); an id outside is clamped (jnp.take's 'clip',
//   which every caller applies first), so no read leaves the arrays.
// * K2 skips an id outside [0, R) (the TPU kernel's drop_oob predicate; its
//   callers without drop_oob pass ids in range).  Duplicate ids are
//   allowed only where they carry byte-identical values: the writes race.
// * K5 skips an id outside [0, R) (the sentinel R of the lazy update, and
//   negatives); every other id must appear at most once.  Its arithmetic
//   is lazy_tail.py:103-113 in that order, written with the _rn
//   intrinsics so that no multiply-add is contracted and each operation
//   rounds as PyTorch's separate elementwise kernels do:
//     m2 = (1-b1) g + b1 (m d1);  v2 = (1-b2) g^2 + b2 (v d2)
//     w2 = w dw - lr (m2 c1inv) / (sqrt(v2 c2inv) + eps)
//
// Each kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entries return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;     // rows per block, one warp each
constexpr int kMaxArrays = 3;

struct Arrays {
  float* p[kMaxArrays];
};
struct ConstArrays {
  const float* p[kMaxArrays];
};

__device__ __forceinline__ long long warp_row() {
  return static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
}

// copy one row of W floats, src -> dst, by the 32 lanes of a warp
__device__ __forceinline__ void copy_row(const float* src, float* dst, int W,
                                         bool vec, int lane) {
  if (vec) {
    const float4* s = reinterpret_cast<const float4*>(src);
    float4* d = reinterpret_cast<float4*>(dst);
    for (int c = lane; c < W / 4; c += 32) d[c] = s[c];
  } else {
    for (int c = lane; c < W; c += 32) dst[c] = src[c];
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    gather_rows_kernel(const int64_t* __restrict__ ids, long long n,
                       long long rows, int W, int A, ConstArrays src,
                       Arrays out, bool vec) {
  const long long r = warp_row();
  if (r >= n) return;
  long long id = ids[r];
  id = id < 0 ? 0 : (id >= rows ? rows - 1 : id);
  const int lane = threadIdx.x % 32;
  for (int a = 0; a < A; ++a)
    copy_row(src.p[a] + id * W, out.p[a] + r * W, W, vec, lane);
}

__global__ void __launch_bounds__(kWarps * 32)
    scatter_rows_kernel(const int64_t* __restrict__ ids, long long n,
                        long long rows, int W, int A, Arrays arr,
                        ConstArrays vals, bool vec) {
  const long long r = warp_row();
  if (r >= n) return;
  const long long id = ids[r];
  if (id < 0 || id >= rows) return;
  const int lane = threadIdx.x % 32;
  for (int a = 0; a < A; ++a)
    copy_row(vals.p[a] + r * W, arr.p[a] + id * W, W, vec, lane);
}

__global__ void __launch_bounds__(kWarps * 32)
    lazy_adam_rows_kernel(const int64_t* __restrict__ ids, long long n,
                          long long rows, int W, float* __restrict__ bank,
                          float* __restrict__ mu, float* __restrict__ nu,
                          const float* __restrict__ g,
                          const float* __restrict__ dec, float c1inv,
                          float c2inv, float lr, float b1, float b2,
                          float one_minus_b1, float one_minus_b2, float eps) {
  const long long r = warp_row();
  if (r >= n) return;
  const long long id = ids[r];
  if (id < 0 || id >= rows) return;
  const int lane = threadIdx.x % 32;
  const float d1 = dec[3 * r], d2 = dec[3 * r + 1], dw = dec[3 * r + 2];
  float* w_row = bank + id * W;
  float* m_row = mu + id * W;
  float* v_row = nu + id * W;
  const float* g_row = g + r * W;
#pragma unroll 4
  for (int c = lane; c < W; c += 32) {
    const float gg = g_row[c];
    const float m2 = __fadd_rn(__fmul_rn(one_minus_b1, gg),
                               __fmul_rn(b1, __fmul_rn(m_row[c], d1)));
    const float v2 = __fadd_rn(__fmul_rn(one_minus_b2, __fmul_rn(gg, gg)),
                               __fmul_rn(b2, __fmul_rn(v_row[c], d2)));
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v2, c2inv)), eps);
    const float step = __fmul_rn(lr, __fdiv_rn(__fmul_rn(m2, c1inv), den));
    w_row[c] = __fsub_rn(__fmul_rn(w_row[c], dw), step);
    m_row[c] = m2;
    v_row[c] = v2;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" int satrans_gather_rows(const int64_t* ids, long long n,
                                   long long rows, int W, int A,
                                   const float* s0, const float* s1,
                                   const float* s2, float* o0, float* o1,
                                   float* o2, void* stream) {
  if (n < 0 || rows < 1 || W < 1 || A < 1 || A > kMaxArrays)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const ConstArrays src{{s0, s1, s2}};
  const Arrays out{{o0, o1, o2}};
  bool vec = W % 4 == 0;
  for (int a = 0; a < A; ++a)
    vec = vec && aligned16(src.p[a]) && aligned16(out.p[a]);
  gather_rows_kernel<<<blocks_for(n), kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      ids, n, rows, W, A, src, out, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int satrans_scatter_rows(const int64_t* ids, long long n,
                                    long long rows, int W, int A, float* a0,
                                    float* a1, float* a2, const float* v0,
                                    const float* v1, const float* v2,
                                    void* stream) {
  if (n < 0 || rows < 1 || W < 1 || A < 1 || A > kMaxArrays)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Arrays arr{{a0, a1, a2}};
  const ConstArrays vals{{v0, v1, v2}};
  bool vec = W % 4 == 0;
  for (int a = 0; a < A; ++a)
    vec = vec && aligned16(arr.p[a]) && aligned16(vals.p[a]);
  scatter_rows_kernel<<<blocks_for(n), kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      ids, n, rows, W, A, arr, vals, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int satrans_lazy_adam_rows(
    const int64_t* ids, long long n, long long rows, int W, float* bank,
    float* mu, float* nu, const float* g, const float* dec, float c1inv,
    float c2inv, float lr, float b1, float b2, float one_minus_b1,
    float one_minus_b2, float eps, void* stream) {
  if (n < 0 || rows < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  lazy_adam_rows_kernel<<<blocks_for(n), kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      ids, n, rows, W, bank, mu, nu, g, dec, c1inv, c2inv, lr, b1, b2,
      one_minus_b1, one_minus_b2, eps);
  return static_cast<int>(cudaGetLastError());
}
