// Row copies by the Tensor Memory Accelerator's bulk copies, float32,
// ids int64: the two row-DMA probes of the JAX package's bench.
//
//   satrans_row_dma_scatter  P1  bank[ids[i]] = vals[i]     in place
//   satrans_row_dma_gather   P2  out[a][i] = src[a][ids[i]] 1 to 3 arrays
//
// They replace satrans_tpu/bench/pallas_scatter_probe.py:pallas_scatter
// (P1, pallas_call :118, body _scatter_kernel :42) and
// satrans_tpu/bench/pallas_gather_probe.py:pallas_gather (P2, pallas_call
// :96, body _gather_kernel :46).  Each TPU grid step starts one DMA per
// row of a block of rb rows and then drains them: 'loop' and 'unroll'
// wait on 16 semaphores in turn, 'bulkwait' once for the block's byte
// total.  The probes ask what such per-row copies cost against the
// library's row scatter and gather.
//
// On Hopper the counterpart of a per-row DMA is a bulk copy of the TMA
// (cp.async.bulk): one thread asks for a contiguous run of bytes to be
// moved between device memory and shared memory, and the hardware reports
// its completion to an mbarrier by transaction bytes (a load) or to the
// issuing thread's bulk group (a store).  A block is one warp and moves rb
// rows through one shared-memory buffer of rb * W floats:
//
// * P2: the lanes issue one load per row, src row ids[base + r] into
//   buffer row r; after the wait one lane stores the buffer, the block's
//   contiguous [rb, W] slice of the output, with one bulk copy.  Several
//   arrays go one after another through the same buffer (the store must
//   have read it, wait_group.read, before the next loads).
// * P1: one lane loads the block's contiguous [rb, W] slice of vals with
//   one bulk copy; after the wait one store a row, buffer row r into bank
//   row ids[base + r].
//
// The variant is the drain scheme, the TPU probe's:
// * bulk (bulkwait): P2 one mbarrier expecting the block's byte total and
//   one wait; P1 one lane issues every row's store into one bulk group and
//   waits for it once;
// * slots (loop, unroll): P2 rows round-robin over 16 mbarriers, a wait on
//   each; P1 rows round-robin over 16 lanes, each lane's stores one bulk
//   group, a wait on each.
//
// What bounds them: bytes.  At the probes' shape (R = 1,638,400 rows, W =
// 128, N = 81,920) P1 reads the ids and N rows of vals and writes N rows,
// 84.5 MB (25 us at 3.35 TB/s); P2 reads the ids and each distinct row
// once and writes N rows a array.  A row is 512 bytes, so the design's
// question is how many bulk copies the TMA keeps in flight: one block a SM
// at rb = 256 (128 kB of buffer), three at 128, seven at 64.
//
// Bulk copies need 16-byte aligned addresses and sizes that are multiples
// of 16: the wrapper refuses W % 4 != 0 and unaligned pointers.  An id
// outside [0, R) is clamped (P2, as K4) or skipped (P1, as K2), so no copy
// leaves the arrays.  Each kernel launches on the caller's stream,
// allocates nothing and does not synchronise; the C entries return
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "tma.cuh"

namespace {

constexpr int kSlots = 16;
constexpr int kMaxArrays = 3;

struct Arrays {
  float* p[kMaxArrays];
};
struct ConstArrays {
  const float* p[kMaxArrays];
};

template <bool SLOTS>
__global__ void __launch_bounds__(32)
    row_dma_gather_kernel(const int64_t* __restrict__ ids, long long rows,
                          int W, int rb, int A, ConstArrays src, Arrays out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kSlots];
  constexpr int kBars = SLOTS ? kSlots : 1;
  float* buf = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * rb;
  const uint32_t row_bytes = static_cast<uint32_t>(W) * 4u;
  if (lane < kBars) mbar_init(&bars[lane], 1);
  fence_barrier_init();
  __syncwarp();
  for (int a = 0; a < A; ++a) {
    // one arrival a barrier, expecting its rows' bytes
    if (lane < kBars) mbar_expect_tx(&bars[lane], rb / kBars * row_bytes);
    __syncwarp();
    for (int r = lane; r < rb; r += 32) {
      long long id = ids[base + r];
      id = id < 0 ? 0 : (id >= rows ? rows - 1 : id);
      bulk_load(buf + static_cast<long long>(r) * W, src.p[a] + id * W,
                row_bytes, &bars[r % kBars]);
    }
    for (int s = 0; s < kBars; ++s) mbar_wait(&bars[s], a & 1);
    if (lane == 0) {
      fence_proxy_async();
      bulk_store(out.p[a] + base * W, buf, rb * row_bytes);
      bulk_commit();
      bulk_wait_read();  // the buffer is free for the next array
    }
    __syncwarp();
  }
  if (lane == 0) bulk_wait_all();
}

template <bool SLOTS>
__global__ void __launch_bounds__(32)
    row_dma_scatter_kernel(const int64_t* __restrict__ ids, long long rows,
                           int W, int rb, float* bank,
                           const float* __restrict__ vals) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  constexpr int kIssuers = SLOTS ? kSlots : 1;
  float* buf = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * rb;
  const uint32_t row_bytes = static_cast<uint32_t>(W) * 4u;
  if (lane == 0) mbar_init(&bar, 1);
  fence_barrier_init();
  __syncwarp();
  if (lane == 0) {
    mbar_expect_tx(&bar, rb * row_bytes);
    bulk_load(buf, vals + base * W, rb * row_bytes, &bar);
  }
  mbar_wait(&bar, 0);
  if (lane < kIssuers) {
    fence_proxy_async();
    for (int r = lane; r < rb; r += kIssuers) {
      const long long id = ids[base + r];
      if (id < 0 || id >= rows) continue;
      bulk_store(bank + id * W, buf + static_cast<long long>(r) * W,
                 row_bytes);
    }
    bulk_commit();
    bulk_wait_all();
  }
}

int launch_check() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// out[a][i] = src[a][clamp(ids[i])] for i < n, n a multiple of rb
int satrans_row_dma_gather(const void* ids, long long n, long long rows,
                           int W, int A, int rb, int slots, const void* s0,
                           const void* s1, const void* s2, void* o0, void* o1,
                           void* o2, void* stream) {
  const ConstArrays src{{static_cast<const float*>(s0),
                         static_cast<const float*>(s1),
                         static_cast<const float*>(s2)}};
  const Arrays out{{static_cast<float*>(o0), static_cast<float*>(o1),
                    static_cast<float*>(o2)}};
  const int smem = rb * W * 4;
  const unsigned blocks = static_cast<unsigned>(n / rb);
  auto kernel = slots ? row_dma_gather_kernel<true>
                      : row_dma_gather_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  if (blocks)
    kernel<<<blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(ids), rows, W, rb, A, src, out);
  return launch_check();
}

// bank[ids[i]] = vals[i] in place for i < n, n a multiple of rb
int satrans_row_dma_scatter(const void* ids, long long n, long long rows,
                            int W, int rb, int slots, void* bank,
                            const void* vals, void* stream) {
  const int smem = rb * W * 4;
  const unsigned blocks = static_cast<unsigned>(n / rb);
  auto kernel = slots ? row_dma_scatter_kernel<true>
                      : row_dma_scatter_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  if (blocks)
    kernel<<<blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(ids), rows, W, rb,
        static_cast<float*>(bank), static_cast<const float*>(vals));
  return launch_check();
}

}  // extern "C"
