// Forward of one SATrans layer of the gate or bilinear variant, float32,
// with the in-kernel dropout of training (K6-fwd).
//
// Replaces the TPU kernel _sfwd_kernel of
// satrans_tpu/ops/pallas/gate_block.py (:96, with _transform :58),
// launched by _sfwd_call (:273) through pl.pallas_call (:287).  Per
// example e with domain row dm = dom[e] and dropout masks m (all ones
// without dropout):
//
//   q0|k0|v0 = x @ [Wq|Wk|Wv]
//   gate:      q = q0 * TQ[dm] * 2 if apply_q,  k = k0 * TK[dm] * 2 if apply_k
//   bilinear:  q_h = q0_h @ TQ[dm, h] per head h (always),  k = k0
//   P = per head softmax(clamp(q k^T / sqrt(dh), -60, 60)),  o = (P m_s) v
//   y = LN_o(relu?(o @ Wout) m_z + x)
//
// (an unapplied projection is q = q0).  TQ and TK are the per-domain gate
// rows [D, d], or for bilinear the per-(domain, head) [dh, dh] maps as the
// flat table [D, H * dh * dh] (TK unread).  The transforms draw no
// dropout: the masks are the attention's, salts 0..H-1, then the output's,
// salt H (csrc/dropout.cuh with apply_q = apply_k = 0), keyed on each
// example's own index in the batch, on the JAX kernel's tile of fields
// padded to 8 (gate_block.py:382's pad_mult).  The TPU's block-diagonal
// packing of the bilinear maps and of the attention, F padded to 8 (only
// the masks count the padded fields) and B % block_b == 0 (the ragged last
// tile is guarded) are TPU layouts and are dropped.
//
// What bounds it.  Per example at the AliCCP sota shapes (F = 19, d = 32,
// 4 heads) the layer is 0.21 MFLOP: the products x Wqkv and o Wout are
// 0.156 MFLOP of it, the attention, the transform and LN_o the rest,
// against 4.9 kB of x in and y out.  At B = 8192 the products take 7.7 us
// in 3xTF32 at a third of the tensor cores' TF32 peak and the rest 6.4 us
// at the float32 peak; x and y, 39.9 MB, take 11.9 us at 3.35 TB/s: the
// bound is 0.0119 ms, set by bytes.  The body this kernel first ran on
// (PRs 6 to 16: one warp an example, every product on the CUDA cores
// spreading the example's 19 rows over 32 row slots, the weights re-read
// through L1 by every example) took 0.1026 ms there on the H100.
//
// Design: a tile body on the primitives of csrc/stash_tile.cuh.  A block
// of 256 threads, two an SM, walks a contiguous range of the batch in
// tiles of E = 64 / F consecutive examples: the forward sums nothing per
// domain, so nothing is sorted, and each row reads its own domain's table
// row.  Wqkv and Wout are staged once a block, already split into their
// TF32 halves (stage_split), and x Wqkv and o Wout run on the tensor
// cores in 3xTF32 (block_gemm); the tables are staged once a block where
// they fit kTableFloats (the gate's up to 64 rows, the bilinear maps' up
// to 16), else each row's table row is read from device memory through
// L1.  A tile takes three phases between block barriers, the other
// block's work filling each barrier's wait:
//   1. the last tile's LayerNorm (its u in its x buffer), x Wqkv into
//      q0|k0|v0, the slots' draws and domain rows;
//   2. the attention, a thread a (head, row) pair, all pairs in one round
//      (attention_fwd_pair of csrc/layer_common.cuh on a query in
//      registers), the transforms folded into the pair's query: the
//      gate's q0 (2 TQ) (2 TK), the keys' gate moved onto the query since
//      an example's rows share a domain, or the bilinear map of
//      transform_cols; o over q0; the attention dropout hashed in the pass
//      (AttnHash); meanwhile the next tile's x (and its domain ids) comes
//      in by cp.async copies into the other buffer;
//   3. o Wout, whose epilogue forms u = relu?(z) m_z + x over x.
// y goes out from the LayerNorm's threads as whole float4 rows in batch
// order.  On the card (PERF.md §6) 96-row tiles one block an SM ran 3 %
// slower at B = 8192 and keep bits drawn once a tile (AttnBits) ran
// slower than the hashes.
//
// K6-bwd (csrc/gate_block_bwd.cu) recomputes this forward in its own
// body, with the same transform_cols, block_gemm and softmax
// (head_softmax_q): it keeps q0 and k0 beside the transformed q and k for
// the tables' gradient and P for its attention backward, so its transform
// is a phase of its own between barriers.  Sharing its phases would give
// this kernel that phase and those buffers: this kernel's first body, six
// phases a tile with the transform one of them, ran 0.0932 ms at B = 8192
// against 0.0881 for three phases with the transform folded into the
// query, and the buffers (34,736 B more on a 64-row tile at F = 19) pass
// what each of two blocks an SM may have (PERF.md §6).  With K gated, the
// forward's logits round as q0 (2 TQ) (2 TK) . k0 against K6-bwd's
// (q0 2 TQ) . (k0 2 TK): the same function, within float32 rounding.
//
// Other shapes (a library a (d, heads)): two blocks an SM where the body
// fits half an SM's shared memory (d <= 32), else one with the tables'
// budget cut to what is left (d = 64); heads narrower than 4 floats move
// in vectors of their width, the bilinear map's head picked out of its 4
// columns.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include <type_traits>

#include "stash_tile.cuh"

namespace {

// the staged tables' most floats (16 KiB): 64 gate rows of TQ and TK, 16
// rows of bilinear maps at d = 32 with 4 heads
constexpr int kTableFloats = 4096;

// the tile's rows, and the most shared memory each of two blocks on an SM
// may have (the SM's 228 KiB, less a KiB each block reserves, halved)
constexpr int kGateFwdRows = 64, kHalfSmem = 115712;

struct GateFwdArgs {
  const float *x, *wqkv, *tq, *tk, *wout, *lno;
  const int* dom;
  float* y;
  int B, F, D, chunk, apply_q, apply_k, relu_out;
  Dropout drop;
};

// Shared layout of the body: a header of each slot's dropout draw and
// domain row and the domain ids of x's two buffers, then in floats the
// weights' 3xTF32 planes, two x buffers, q|k|v and the staged tables.
// Row strides: +4 shifts an A operand's rows by four banks, +8 a B
// operand's by eight.  Two blocks an SM where the body with its tables'
// budget fits half an SM's shared memory (d <= 32); else one, the tables
// given what the block has left (d = 64: 1,536 floats).
template <int DM, int NH, bool BILINEAR>
struct GateFwdTile {
  static constexpr int ROWS = kGateFwdRows;
  static constexpr int T = BILINEAR ? DM * (DM / NH) : DM;  // a table row
  static constexpr int kTables = BILINEAR ? 1 : 2;          // TQ (and TK)
  static constexpr int TT = 4 * ROWS;  // threads: one a (head, row) pair
  static constexpr int RT = row_threads(DM);  // threads on a row
  static constexpr int kPass = TT / RT;  // rows an epilogue pass
  static constexpr int kPasses = (ROWS + kPass - 1) / kPass;
  static_assert(ROWS % 16 == 0, "whole m-tiles");
  // the draws, the domain rows, the ids as read
  static constexpr int kHeader =
      (ROWS * static_cast<int>(sizeof(ExampleDraw) + 3 * sizeof(int)) +
       15) & ~15;
  static constexpr int WQ = 3 * DM + 8, WO = DM + 8, XS = DM + 4,
                       QS = 3 * DM + 4;
  static constexpr int oWqkv = 0, oWqkvS = DM * WQ, oWout = 2 * DM * WQ,
                       oWoutS = oWout + DM * WO, oX = oWout + 2 * DM * WO,
                       oQKV = oX + 2 * ROWS * XS, oTab = oQKV + ROWS * QS;
  static constexpr int kFixed = kHeader + 4 * oTab;  // bytes but tables
  static constexpr int kBlocks =
      kFixed + 4 * kTableFloats <= kHalfSmem ? 2 : 1;
  static constexpr int kBudget =  // the staged tables' most floats
      kBlocks == 2 ? kTableFloats
      : (kMaxSmem - kFixed) / 16 * 4 < kTableFloats
          ? (kMaxSmem - kFixed) / 16 * 4
          : kTableFloats;
  static_assert(kFixed <= kMaxSmem, "the body does not fit a block");
  static __host__ __device__ bool staged(int D) {
    return kTables * D * T <= kBudget;
  }
  static __host__ __device__ int bytes(int D) {
    return kHeader + 4 * (oTab + (staged(D) ? kTables * D * T : 0));
  }
  static constexpr int kMostBytes = kHeader + 4 * (oTab + kBudget);
};

// The query of head hh of row i (q0 at q0row) with its transforms folded
// in, scaled by 1/sqrt(dh): the gate's q0 (2 TQ[d]) (2 TK[d]) (each factor
// where applied; the keys' gate moves onto the query, since every key row
// of the example shares the domain), or the bilinear map's q0_h @ TQ[d,
// h].  tq and tk are the example's table rows.
template <int DM, int NH, bool BILINEAR>
__device__ __forceinline__ void gate_query(const float* q0row,
                                           const float* tq, const float* tk,
                                           bool on_q, bool on_k, int hh,
                                           float (&q)[DM / NH]) {
  constexpr int DH = DM / NH, V = head_vec<DH>();
  const float scale = 1.f / sqrtf(static_cast<float>(DH));
  if constexpr (BILINEAR && DH < 4) {
    // the 4 columns around the head's, its own picked out
    const int c0 = hh * DH, base = c0 & ~3;
    float v[4];
    transform_cols<DM, NH, true>(q0row, tq, base, v);
#pragma unroll
    for (int j = 0; j < DH; ++j) q[j] = v[c0 - base + j] * scale;
  } else if constexpr (BILINEAR) {
#pragma unroll
    for (int c = 0; c < DH; c += 4) {
      float v[4];
      transform_cols<DM, NH, true>(q0row, tq, hh * DH + c, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) q[c + j] = v[j] * scale;
    }
  } else {
#pragma unroll
    for (int c = 0; c < DH; c += V) {
      float v[V], g[V];
      ldv<V>(q0row + hh * DH + c, v);
      if (on_q) {
        ldv<V>(tq + hh * DH + c, g);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] *= 2.f * g[j];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] *= scale;
      if (on_k) {
        ldv<V>(tk + hh * DH + c, g);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] *= 2.f * g[j];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) q[c + j] = v[j];
    }
  }
}

template <int DM, int NH, bool BILINEAR>
__global__ void __launch_bounds__(4 * kGateFwdRows,
                                  (GateFwdTile<DM, NH, BILINEAR>::kBlocks))
    gate_block_fwd_kernel(const GateFwdArgs a) {
  using L = GateFwdTile<DM, NH, BILINEAR>;
  constexpr int T = L::T, DH = DM / NH, ROWS = L::ROWS, RT = L::RT;
  static_assert(DM % NH == 0, "heads must divide d");

  extern __shared__ __align__(16) unsigned char smem[];
  ExampleDraw* draws = reinterpret_cast<ExampleDraw*>(smem);
  int* sdom = reinterpret_cast<int*>(draws + ROWS);
  int* sids = sdom + ROWS;  // [2][ROWS], beside x's buffers
  float* f0 = reinterpret_cast<float*>(smem + L::kHeader);
  uint32_t* const u0 = reinterpret_cast<uint32_t*>(f0);
  float* sQKV = f0 + L::oQKV;  // q0|k0|v0, then o over q0
  const auto wqkv = [&](int k, int c) {
    return Split2{u0[L::oWqkv + k * L::WQ + c],
                  u0[L::oWqkvS + k * L::WQ + c]};
  };
  const auto wout = [&](int k, int c) {
    return Split2{u0[L::oWout + k * L::WO + c],
                  u0[L::oWoutS + k * L::WO + c]};
  };

  const int tid = threadIdx.x;
  const int F = a.F, D = a.D, E = tile_examples(F, ROWS);
  // the transforms draw no dropout: the heads' salts 0..H-1, the output's H
  const DropSalts salt(0, 0, NH);
  // which of q and k are transformed (the bilinear map: q alone), and
  // their tables, staged once a block where they fit
  const bool on_q = BILINEAR || a.apply_q != 0;
  const bool on_k = !BILINEAR && a.apply_k != 0;
  const bool staged = L::staged(D);
  float* sTab = f0 + L::oTab;  // TQ [D][T], then TK [D][T]
  if (staged)
    for (int i = tid; i < D * T / 4; i += L::TT) {
      if (on_q) cp_async16(sTab + 4 * i, a.tq + 4 * i);
      if (on_k) cp_async16(sTab + D * T + 4 * i, a.tk + 4 * i);
    }

  // x and the domain ids of the n examples from e0 into buffer b, one
  // cp.async group (with the tables' copies, the first); thread s copies
  // example s's id
  const auto load_x = [&](int e0, int n, int b) {
    float* dst = f0 + L::oX + b * ROWS * L::XS;
    const float* src = a.x + static_cast<size_t>(e0) * F * DM;
    for (int i = tid; i < n * F * (DM / 4); i += L::TT)
      cp_async16(dst + (i / (DM / 4)) * L::XS + 4 * (i % (DM / 4)),
                 src + 4 * static_cast<size_t>(i));
    if (tid < n) cp_async4(sids + b * ROWS + tid, a.dom + e0 + tid);
    cp_async_commit();
  };
  const int lo = blockIdx.x * a.chunk, hi = min(a.B, lo + a.chunk);
  load_x(lo, min(E, hi - lo), 0);
  stage_split<DM, 3 * DM>(u0 + L::oWqkv, u0 + L::oWqkvS, L::WQ, a.wqkv);
  stage_split<DM, DM>(u0 + L::oWout, u0 + L::oWoutS, L::WO, a.wout);
  // y = LN_o(u) of the n examples from e0, u in x's buffer b: RT threads
  // a row, whole rows in batch order
  const auto layer_norm = [&](int e0, int n, int b) {
    const float* sU = f0 + L::oX + b * ROWS * L::XS;
    const int c = 4 * (tid % RT);
#pragma unroll
    for (int p = 0; p < L::kPasses; ++p) {
      const int r = p * L::kPass + tid / RT;
      const bool ok = r < n * F;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (ok) to4(ld4(sU + r * L::XS + c), v);
      row_layer_norm<DM>(v, a.lno, c);
      if (ok) st4(a.y + (static_cast<size_t>(e0) * F + r) * DM + c, v);
    }
  };

  // Each tile in three phases between block barriers: (1) the last
  // tile's LayerNorm, x Wqkv and this tile's draws; (2) the attention,
  // while the next tile's x loads; (3) o Wout with the residual.
  int buf = 0;
#pragma unroll 1
  for (int e0 = lo; e0 < hi; e0 += E) {
    const int n = min(E, hi - e0), R = n * F, mt = (R + 15) / 16;
    cp_async_wait<0>();
    __syncthreads();  // x is in; the last tile's o Wout is done
    if (e0 > lo) layer_norm(e0 - E, E, buf ^ 1);
    float* sX = f0 + L::oX + buf * ROWS * L::XS;

    // 1. q0 | k0 | v0 = x @ [Wq | Wk | Wv]; then the slots' draws and
    //    domain rows
    block_gemm<DM, 3 * DM, fit_nt(3 * DM, 6), DM / 8>(
        0, mt, [&](int m, int k) { return sX[m * L::XS + k]; }, wqkv,
        [&](int r, int cc, float v0, float v1) {
          *reinterpret_cast<float2*>(sQKV + r * L::QS + cc) =
              make_float2(v0, v1);
        });
    if (tid < n) {  // the thread's own copy of the id, complete
      sdom[tid] = min(max(sids[buf * ROWS + tid], 0), D - 1);
      if (a.drop.on) draws[tid] = ExampleDraw(a.drop, e0 + tid);
    }
    __syncthreads();
    // the next tile's x into the other buffer, whose u the LayerNorm above
    // has read
    if (e0 + E < hi) load_x(e0 + E, min(E, hi - e0 - E), buf ^ 1);

    // 2. Attention, a thread a (head, row) pair, the transforms folded
    //    into the query: o over q0
    for_pairs<NH>(n, F, [&](int s, int hh, int i) {
      float* qkv = sQKV + s * F * L::QS;
      const int d = sdom[s];
      float q[DH];
      if (staged)
        gate_query<DM, NH, BILINEAR>(qkv + i * L::QS, sTab + d * T,
                                     sTab + (D + d) * T, on_q, on_k, hh, q);
      else
        gate_query<DM, NH, BILINEAR>(qkv + i * L::QS, a.tq + d * T,
                                     a.tk + d * T, on_q, on_k, hh, q);
      attention_fwd_pair<DM, NH, false>(
          q, qkv, L::QS, qkv, L::QS, nullptr, F, hh, i,
          AttnHash{a.drop, draws[s], salt.s + hh});
    });
    __syncthreads();

    // 3. u = relu?(o @ Wout) m_z + x over x, for the LayerNorm beside the
    //    next tile's x Wqkv
    block_gemm<DM, DM, fit_nt(DM, 2), DM / 8>(
        0, mt, [&](int m, int k) { return sQKV[m * L::QS + k]; }, wout,
        [&](int r, int cc, float v0, float v1) {
          if (r >= R) return;
          float z[2] = {v0, v1};
          const int s = r / F, f = r - s * F;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (a.relu_out) z[j] = fmaxf(z[j], 0.f);
            if (a.drop.on)
              z[j] *= draws[s].rows<DM>(a.drop, salt.z, f, cc + j);
          }
          float2* u = reinterpret_cast<float2*>(sX + r * L::XS + cc);
          const float2 xr = *u;
          *u = make_float2(z[0] + xr.x, z[1] + xr.y);
        });
    buf ^= 1;
  }
  __syncthreads();
  layer_norm(lo + (hi - lo - 1) / E * E, (hi - lo - 1) % E + 1, buf ^ 1);
}

// Sets the body's shared memory limit to its most (the tables at their
// budget) and asks for the largest shared carveout, once; returns the
// first call's result.
template <int DM, int NH, bool BILINEAR>
cudaError_t configure() {
  using L = GateFwdTile<DM, NH, BILINEAR>;
  static const cudaError_t err = [] {
    const auto kernel = gate_block_fwd_kernel<DM, NH, BILINEAR>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kMostBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

// Launches the body on at most L::kBlocks blocks an SM of sms, whole
// tiles a block, as evenly as the grid allows.
template <int DM, int NH, bool BILINEAR>
cudaError_t launch(GateFwdArgs a, int sms, cudaStream_t stream) {
  using L = GateFwdTile<DM, NH, BILINEAR>;
  const cudaError_t err = configure<DM, NH, BILINEAR>();
  if (err != cudaSuccess) return err;
  const int E = tile_examples(a.F, L::ROWS), tiles = (a.B + E - 1) / E;
  const int most = max(1, sms) * L::kBlocks;
  const int per = (tiles + most - 1) / most;  // tiles a block
  a.chunk = per * E;
  gate_block_fwd_kernel<DM, NH, BILINEAR>
      <<<(tiles + per - 1) / per, L::TT, L::bytes(a.D), stream>>>(a);
  return cudaGetLastError();
}

// run(integral constant BILINEAR) for the shape (d, heads) this library
// is built for (the defines SATRANS_D and SATRANS_NH, ops/_build.py), else
// cudaErrorInvalidValue.
template <class Run>
cudaError_t with_gate_fwd(int d, int heads, int bilinear, Run run) {
  if (d != SATRANS_D || heads != SATRANS_NH) return cudaErrorInvalidValue;
  return bilinear ? run(std::integral_constant<bool, true>{})
                  : run(std::integral_constant<bool, false>{});
}

}  // namespace

// The shape (d, heads) this library is built for; ops/gate_block.py keeps
// the shapes it builds in KERNEL_SHAPES.  bilinear selects the variant (0: gate), with the
// tables described above; sms is the card's SM count (fewer give each
// block a longer range); drop_on selects the dropout, with the operands of
// struct Dropout (csrc/dropout.cuh).  Returns a cudaError_t.
extern "C" int satrans_gate_block_fwd(
    const float* x, const int* dom, const float* wqkv, const float* tq,
    const float* tk, const float* wout, const float* lno, float* y, int B,
    int F, int d, int heads, int D, int bilinear, int apply_q, int apply_k,
    int relu_out, int sms, int drop_on, unsigned seed, unsigned threshold,
    float scale, int block_b, int fpad, int group, void* stream) {
  if (B < 0 || F < 1 || F > kMaxFields || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (drop_on && (block_b < 1 || fpad < F || group < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const GateFwdArgs a{x,      wqkv,    tq,      tk,      wout,    lno,
                      dom,    y,       B,       F,       D,       0,
                      apply_q, apply_k, relu_out,
                      Dropout{drop_on, seed, threshold, scale, block_b, fpad,
                              group}};
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_gate_fwd(d, heads, bilinear, [&](auto bl) {
    if (B == 0) return cudaSuccess;
    return launch<SATRANS_D, SATRANS_NH, decltype(bl)::value>(a, sms, str);
  }));
}

// The body's dynamic shared memory (bytes) at D table rows, and the
// blocks an SM the card runs it at; -1 for a shape the library is not
// built for.
extern "C" int satrans_gate_block_fwd_smem(int d, int heads, int D,
                                           int bilinear) {
  int n = -1;
  with_gate_fwd(d, heads, bilinear, [&](auto bl) {
    n = GateFwdTile<SATRANS_D, SATRANS_NH, decltype(bl)::value>::bytes(D);
    return cudaSuccess;
  });
  return n;
}

extern "C" int satrans_gate_block_fwd_blocks_per_sm(int d, int heads, int D,
                                                    int bilinear) {
  int n = -1;
  with_gate_fwd(d, heads, bilinear, [&](auto bl) {
    constexpr bool BL = decltype(bl)::value;
    using L = GateFwdTile<SATRANS_D, SATRANS_NH, BL>;
    const cudaError_t err = configure<SATRANS_D, SATRANS_NH, BL>();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, gate_block_fwd_kernel<SATRANS_D, SATRANS_NH, BL>, L::TT,
        L::bytes(D));
  });
  return n;
}
