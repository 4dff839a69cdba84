// Host-side batch assembly of the input pipeline (twin of
// satrans_tpu/native/batcher.cpp).
//
// The per-step hot host op is "gather a shuffled batch of rows from large
// columnar int32/float32 arrays" (the reference's TensorDataset indexing).
// numpy fancy-indexing is single-threaded; these routines parallelise the
// row gather with OpenMP and fuse multi-column assembly into one pass, so
// one call builds the whole [B, num_cols] sparse matrix the trainer copies
// to the card.
//
// Plain C entries, loaded with ctypes by native/__init__.py.

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

// A gather that moves fewer bytes than this runs on the calling thread:
// waking the team costs more than the copy (tens of microseconds, and
// milliseconds where the host's cores are shared).
static const int64_t kParallelBytes = 1 << 18;

extern "C" {

// dst[i, :] = src[idx[i], :] for row_bytes-wide rows.
void gather_rows(const char* src, const int64_t* idx, char* dst,
                 int64_t n_rows, int64_t row_bytes) {
#pragma omp parallel for schedule(static) \
    if (n_rows * row_bytes >= kParallelBytes)
  for (int64_t i = 0; i < n_rows; ++i) {
    std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
  }
}

// Fused multi-column gather: for each of n_cols int32 source columns
// (each a contiguous [n_src] array), dst[i, c] = cols[c][idx[i]].
void gather_columns_i32(const int32_t* const* cols, int64_t n_cols,
                        const int64_t* idx, int32_t* dst, int64_t n_rows) {
#pragma omp parallel for schedule(static) \
    if (n_rows * n_cols * 4 >= kParallelBytes)
  for (int64_t i = 0; i < n_rows; ++i) {
    const int64_t r = idx[i];
    int32_t* out = dst + i * n_cols;
    for (int64_t c = 0; c < n_cols; ++c) {
      out[c] = cols[c][r];
    }
  }
}

// The same for float32 columns (dense features).
void gather_columns_f32(const float* const* cols, int64_t n_cols,
                        const int64_t* idx, float* dst, int64_t n_rows) {
#pragma omp parallel for schedule(static) \
    if (n_rows * n_cols * 4 >= kParallelBytes)
  for (int64_t i = 0; i < n_rows; ++i) {
    const int64_t r = idx[i];
    float* out = dst + i * n_cols;
    for (int64_t c = 0; c < n_cols; ++c) {
      out[c] = cols[c][r];
    }
  }
}

// In-place Fisher-Yates shuffle of an int64 index array drawn from a
// SplitMix64 generator: the JAX package's permutation for the same seed,
// bit for bit.
static inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

void shuffle_indices(int64_t* idx, int64_t n, uint64_t seed) {
  uint64_t s = seed;
  for (int64_t i = n - 1; i > 0; --i) {
    const uint64_t j = splitmix64(&s) % static_cast<uint64_t>(i + 1);
    const int64_t t = idx[i];
    idx[i] = idx[j];
    idx[j] = t;
  }
}

int omp_thread_count() {
#ifdef _OPENMP
  int n = 0;
#pragma omp parallel reduction(+ : n)
  n += 1;
  return n;
#else
  return 1;
#endif
}

}  // extern "C"
