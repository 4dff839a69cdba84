// Duplicate-summed row gradients per position, float32 (K3):
//
//   s[f, i, :] = sum_j [ids[f, i] == ids[f, j]] g[f, j, :]
//
// for ids [F, B] int64 and g, s [F, B, W].  Replaces the TPU kernel
// satrans_tpu/ops/pallas/eqgemm.py:eqgemm_positions, which builds [TI, B]
// equality tiles in VMEM and contracts them with g on the MXU in one bf16
// pass.  The contract here is the JAX package's exact float32 einsum (its
// CPU path); the bf16 cast was a TPU precision choice and is not kept.
//
// Duplicates are rare in a batch (apart from the padded tail's zero ids),
// so almost every product of the TPU kernel's equality GEMM is a multiply
// by zero.  This kernel does only the compares and the adds that count:
//
// 1. eqgemm_lead_kernel: one warp per position (f, i).  Its 32 lanes walk
//    ids[f, :] 128 at a time (four loads in flight a lane) and ballot the
//    equal ones.  The first equal j is the position's leader (j <= i, i
//    itself if it is the first).  A non-leader stops there and records its
//    leader.  A leader goes on to the end of the field and adds g[f, j] of
//    every equal j in ascending j, each lane owning 4 columns of every
//    128: a sum in one fixed order.
// 2. eqgemm_copy_kernel: every non-leader copies its leader's row.
//
// So all duplicate positions of a field carry the byte-identical total
// (the precondition of the racing scatter K2), and a group of k duplicates
// costs one sum of k rows, not k of them.
//
// What bounds it.  At the AliCCP sota shapes (F = 10, B = 8192, W = 128)
// the bytes are ids in, g in and s out, about 84 MB (25 us at 3.35 TB/s);
// the compares are F * B^2 = 6.7e8, at most one instruction each at 33.5e12
// instructions a second (20 us): bound by bytes on paper.  This version
// spends a load and a ballot on each compare of 64-bit ids, so the
// compares rather than the bytes set its time.
//
// Each kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;    // positions per block, one warp each
constexpr int kStep = 4;     // 32-id chunks loaded at once by a warp
constexpr unsigned kAll = 0xffffffffu;

// ballots of ids[jb + 32 t + lane] == me over kStep chunks; ids outside
// [lo, hi] count as unequal
__device__ __forceinline__ void ballots(const int64_t* fid, int64_t me,
                                        int jb, int lo, int hi, int lane,
                                        unsigned (&m)[kStep]) {
  int64_t v[kStep];
#pragma unroll
  for (int t = 0; t < kStep; ++t) {
    const int j = jb + 32 * t + lane;
    v[t] = j >= lo && j <= hi
               ? __ldg(reinterpret_cast<const long long*>(fid + j))
               : (me ^ 1);
  }
#pragma unroll
  for (int t = 0; t < kStep; ++t) m[t] = __ballot_sync(kAll, v[t] == me);
}

__global__ void __launch_bounds__(kWarps * 32)
    eqgemm_lead_kernel(const int64_t* __restrict__ ids,
                       const float* __restrict__ g, float* __restrict__ s,
                       int* __restrict__ lead, int B, int W) {
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  if (i >= B) return;
  const int f = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int64_t* fid = ids + static_cast<long long>(f) * B;
  const int64_t me = fid[i];

  // the leader: the first j with ids[f, j] == ids[f, i]
  int first = i;
  for (int jb = 0; jb <= i; jb += 32 * kStep) {
    unsigned m[kStep];
    ballots(fid, me, jb, 0, i, lane, m);
    int hit = -1;
#pragma unroll
    for (int t = kStep - 1; t >= 0; --t)
      if (m[t]) hit = jb + 32 * t + __ffs(m[t]) - 1;
    if (hit >= 0) {
      first = hit;
      break;
    }
  }
  if (lane == 0) lead[static_cast<long long>(f) * B + i] = first;
  if (first != i) return;

  // a leader sums every equal position j >= i in ascending j
  const float* gf = g + static_cast<long long>(f) * B * W;
  float* srow = s + (static_cast<long long>(f) * B + i) * W;
  for (int c0 = 0; c0 < W; c0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int jb = i - i % 32; jb < B; jb += 32 * kStep) {
      unsigned m[kStep];
      ballots(fid, me, jb, i, B - 1, lane, m);
#pragma unroll
      for (int t = 0; t < kStep; ++t) {
        while (m[t]) {
          const int jj = jb + 32 * t + __ffs(m[t]) - 1;
          m[t] &= m[t] - 1;
          const float* grow = gf + static_cast<long long>(jj) * W;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = c0 + lane + 32 * q;
            if (c < W) acc[q] = __fadd_rn(acc[q], grow[c]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + lane + 32 * q;
      if (c < W) srow[c] = acc[q];
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    eqgemm_copy_kernel(const int* __restrict__ lead, float* s, int B, int W) {
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  if (i >= B) return;
  const long long fb = static_cast<long long>(blockIdx.y) * B;
  const int from = lead[fb + i];
  if (from == i) return;
  const float* src = s + (fb + from) * W;
  float* dst = s + (fb + i) * W;
  for (int c = threadIdx.x % 32; c < W; c += 32) dst[c] = src[c];
}

}  // namespace

// lead: scratch of F * B ints
extern "C" int satrans_eqgemm_positions(const int64_t* ids, const float* g,
                                        float* s, int* lead, int F, int B,
                                        int W, void* stream) {
  if (F < 0 || B < 0 || W < 1 || F > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (F == 0 || B == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kWarps - 1) / kWarps, F);
  eqgemm_lead_kernel<<<grid, kWarps * 32, 0, st>>>(ids, g, s, lead, B, W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  eqgemm_copy_kernel<<<grid, kWarps * 32, 0, st>>>(lead, s, B, W);
  return static_cast<int>(cudaGetLastError());
}
