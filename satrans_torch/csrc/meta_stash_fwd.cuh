// The layer forward on Hopper, every mode of it: K1-fwd, K1-stash,
// K1-stash light, K1-scores and (TILED) K7-fwd and K7-stash, the tile
// body that csrc/meta_block_fwd.cu's C entries launch.
//
// Replaces satrans_tpu/ops/pallas/meta_block.py's _fwd_kernel (:404;
// K1-fwd, mode kNoStash, the forward of serving, evaluation and the JAX
// package's bwd='recompute') and _fwd_kernel_stash (:420), both launched by
// _fwd_call (:1177) through pl.pallas_call (:1212) on the body
// _fwd_compute, the latter in its three uses: the full stash
// (stash_s=True; K1-stash, kFullStash, the JAX package's bwd='stash'), the
// light one (stash_s=False; K1-stash light, kLightStash, bwd='stash_light')
// and fused_meta_layer_with_scores (:502 -> _fused_stash_forward :542; K1-
// scores, kScores, the attention probes), which keeps y and the
// probabilities alone.  The function per example is meta_block_fwd.cu's;
// the residuals are qkv [B, F, 3d], uq and uk [B, F, d], the probabilities
// P [B, H, F, F] before dropout and o [B, F, d], in the batch's order.
// kNoStash writes y alone, by the same instructions as the stash modes, so
// its y equals theirs bit for bit.
//
// What bounds it.  At the AliCCP sota shape (B = 8192, F = 19, d = 32,
// h = 64, 4 heads, QK) the layer is 0.5 MFLOP an example: 23 us of its
// products in 3xTF32 at the tensor cores' TF32 peak and 6 us of attention
// at the float32 one.  K1-fwd moves x in and y out (10 MB, 3 us at 3.35
// TB/s); K1-stash writes 20.4 kB of residuals an example besides: 207 MB a
// launch, 62 us.  The template body these modes first ran on (one warp an
// example, a 4-column x few-row register tile a lane, the weights read
// through L1 by every example) took 0.32 ms for K1-stash and 0.22 for
// K1-fwd: its products masked 40 % of their FMA slots (19 rows over 32 row
// slots), issued about one load per FMA, and every example re-read its
// domain's MetaNet matrices.
//
// Design.  A block of 384 threads owns a tile of E = 96 / F examples (5 at F =
// 19: 95 rows) of the batch sorted by domain (csrc/stash_tile.cuh), one block
// an SM, walking its range of tiles.  Every product (x Wqkv, each MetaNet
// matrix on its segment's rows, o Wout) runs on the tensor cores in 3xTF32
// (block_gemm), its warps' output strips sized so that the 12 warps take the
// tile's 6 m-tiles in one round, three warps on each of the SM's four
// sub-partitions (with 80-row tiles and 10 warps, two sub-partitions idled a
// third of every product), its k-steps unrolled.  The weights are staged in
// shared memory already split into their TF32 halves (stage_split): Wqkv and
// Wout once a block, a domain's MetaNet matrices once a segment (again only
// when the domain or the table changes), so a product splits only its
// activations; a 3-matrix MetaNet has room for its MetaNet's halves only, and
// Wqkv and Wout stay float32.  Distinct Q and K tables (the pos tables) keep
// each MetaNet's block in a region of its own where the shared memory holds
// two (2-matrix: K1-fwd and K1-stash light at every F), so that a tile in the
// last one's domain stages nothing; else the MetaNet staged last goes first.
// x comes in by 16-byte cp.async copies into two buffers, so that the next
// tile's x loads while this tile computes (one buffer with a 3-matrix
// MetaNet, whose h2 lies over the probabilities' buffer, sized for h2 alone
// where no mode keeps P).  An item's LayerNorm epilogue runs beside the next
// item's first product.  The LayerNorms (8 threads a row, shuffles), the
// dropout masks (csrc/dropout.cuh, keyed on each example's own index in the
// batch, never its sorted place, so that K1-bwd's recomputed forward draws
// the same; each slot's draw computed once a tile) and the attention
// (attention_fwd_pair, a thread a (head, row) pair, all pairs in one round)
// stay on the CUDA cores in float32 with the first body's device code, so
// K1-scores' P equals K1-stash's bit for bit.  The residuals and y go out as
// whole rows of float4s (P as each example's contiguous [H, F, F]), back in
// the batch's order.  Shared memory at F = 19: 211 KiB (K1-stash,
// K1-scores), 182 KiB (K1-fwd, K1-stash light; 220 KiB with the second
// MetaNet region); 215 and 212 KiB with a 3-matrix MetaNet.
//
// Other shapes.  A library holds one shape (d, h1, h2, heads); FwdTile
// picks its layout: the first of FwdParts::plan's that fits a block at
// every F <= 20 (the layout above at 96 rows; then fewer rows; then Wqkv
// and Wout float32; then the MetaNet read from device memory through L1
// in its products, at d = 64, whose split weights alone would take 282.6
// kB).  Every other step is the shape's: d / 4 threads a row in the
// epilogues, the products' strips cut to the widths (fit_nt), a head's
// values in vectors of its width (1 or 2 floats at d = 8 or 16 with 8
// heads).  P goes out a float a thread where an example's NH F^2 floats
// would misalign float4s (1 or 2 heads at odd F).
//
// K7 (TILED).  With TILED it replaces satrans_tpu/ops/pallas/tiled_meta.py's
// _fwd_kernel (:141; K7-fwd, kNoStash) and _fwd_kernel_stash (:155;
// K7-stash, kFullStash), launched by _fwd_call (:521) through
// pl.pallas_call (:546) on the body _fwd_compute (:92): the layer (and its
// full stash) on the slots of dispatched single-domain tiles
// (ops/dispatch.py; tile t of tile_b slots takes the MetaNet block of row t
// of the per-tile [T, d, h], [T, h, h2] and [T, HL, d] weights), the masks
// keyed on each slot's index with the dispatch tile as the dropout's tile.
// The slots come sorted: a segment is a run of one dispatch tile (slot /
// tile_b), nothing is sorted, and a segment's MetaNet block is staged once
// a segment as K1's domain block is.  The blocks walk contiguous ranges of
// whole body tiles of the occupied slots (the first count[t] of tile t,
// occupied_window in csrc/stash_tile.cuh; every slot when count is null),
// and write y (and the residuals) in slot order; y and every residual of
// the slack slots are written as zeros (the head reads every slot, and its
// weight gradient multiplies each slot's zero upstream gradient by them).
// The template body both modes first ran on (a warp an example, no tensor
// cores, every slot computed) took 0.29 ms (K7-fwd) and 0.43 ms (K7-stash)
// at the AliCCP multicol shape on the H100.

#pragma once

#include "stash_tile.cuh"

namespace {

struct StashFwdArgs {
  const float *x, *wqkv, *lnq, *lnk, *wout, *lno;
  const int* dom;  // K1's domain rows
  MetaW mw;
  float* y;
  Stash st;
  // K1: B examples, D domain rows.  K7: B slots, D dispatch tiles.
  int B, F, D, chunk, apply_q, apply_k, relu_out;
  Dropout drop;
  int two;  // distinct Q and K tables, each MetaNet's block in a region
  // K7: tile_b slots a tile, count[t] of tile t occupied (null: all)
  const int* count;
  int tile_b;
};

// A layout of the forward tile body (FwdTile): its tile rows, whether Wqkv
// and Wout are staged split into their 3xTF32 halves (else float32, split
// in the products), whether a domain's MetaNet block is staged split in
// shared memory once a segment (else each product reads it through L1 from
// device memory), and x's buffers (two: the next tile's x loads while this
// one computes).
struct FwdPlan {
  int rows;
  bool split_dense, stage_meta;
  int xbufs;
};

// The parts of the forward tile body's shared layout, in floats after the
// header (kTileHeader): row strides (+4 shifts an A operand's rows by four
// banks, +8 a B operand's by eight) and the floats of each region under a
// plan.
template <class SH>
struct FwdParts {
  static constexpr int DM = SH::DM, HID = SH::HID, HID2 = SH::HID2,
                       HL = SH::HL, NH = SH::NH;
  static constexpr int WQ = 3 * DM + 8, WO = DM + 8, W1S = HID + 8,
                       WMS = HID2 + 8, W2S = DM + 8;
  static constexpr int XS = DM + 4, QS = 3 * DM + 4, HS = SH::HMAX + 4,
                       TS = DM + 4;
  static __host__ __device__ constexpr int dense(bool split) {
    return (split ? 2 : 1) * DM * (WQ + WO);
  }
  // one MetaNet block, staged split
  static __host__ __device__ constexpr int meta(bool staged) {
    return staged ? 2 * (DM * W1S + (HID2 ? HID * WMS : 0) + HL * W2S) : 0;
  }
  // x, q0|k0|v0, the hidden rows and t of the tile's rows
  static __host__ __device__ constexpr int rows(int n, int xbufs) {
    return n * (xbufs * XS + QS + HS + TS);
  }
  // the probabilities of E examples (E NH F^2 <= NH rows F floats; at F =
  // 0 the most at any F), which a 3-matrix MetaNet's h2 shares: h2 lives
  // in the MetaNet phase, P in the attention
  static __host__ __device__ constexpr int probs(int n, int F, bool with_p) {
    const int p = !with_p ? 0
                  : F   ? tile_examples(F, n) * NH * F * F
                        : most_probs(n, NH);
    const int h2 = HID2 ? n * HS : 0;
    return ((p > h2 ? p : h2) + 3) & ~3;
  }
  // bytes under plan c at F fields (0: the most at any F), with the
  // probabilities and a second MetaNet region for distinct Q and K tables
  static __host__ __device__ constexpr int bytes(FwdPlan c, int F,
                                                 bool with_p, bool two) {
    return kTileHeader +
           4 * (dense(c.split_dense) + meta(c.stage_meta) * (two ? 2 : 1) +
                rows(c.rows, c.xbufs) + probs(c.rows, F, with_p));
  }
  // The first layout whose every mode fits a block at every F: the AliCCP
  // sota one (96 rows; a 2-matrix MetaNet with every weight split and two
  // x buffers, a 3-matrix one with the MetaNet's halves alone and one),
  // then fewer rows; then Wqkv and Wout float32; then the MetaNet read
  // from device memory (d = 64, whose split weights alone take 282.6 kB).
  static __host__ __device__ constexpr FwdPlan plan() {
    const bool two_mat = HID2 == 0;
    for (int k = 0; k < 3; ++k)
      for (int n = kWideTileRows; n >= 32; n -= 16) {
        const FwdPlan c{n, k == 0 && two_mat, k < 2,
                        k == 0 && two_mat ? 2 : 1};
        if (bytes(c, 0, true, false) <= kMaxSmem) return c;
      }
    return FwdPlan{32, false, false, 1};
  }
};

// The shared layout of the forward tile body of shape SH: its plan
// (FwdParts::plan) and region offsets.
template <class SH>
struct FwdTile : FwdParts<SH> {
  using P = FwdParts<SH>;
  using P::DM, P::HID, P::HID2, P::HL, P::WQ, P::WO, P::W1S, P::WMS, P::W2S,
      P::XS, P::QS, P::HS, P::TS;
  static constexpr int kHeader = kTileHeader;  // bytes
  // the tile's rows and the block's threads (one a pair of the attention)
  static constexpr int ROWS = P::plan().rows, TT = kWideTT;
  static constexpr int kRowsAPass = rows_a_pass(TT, DM);  // of the epilogues
  static constexpr bool kSplitDense = P::plan().split_dense;
  static constexpr bool kStageMeta = P::plan().stage_meta;
  static constexpr int kXBufs = P::plan().xbufs;
  static_assert(ROWS % 16 == 0 && ROWS >= kMaxFields, "whole m-tiles");
  static_assert(P::bytes(P::plan(), 0, true, false) <= kMaxSmem,
                "no layout of the forward tile body fits this shape");
  static constexpr int kDenseCopies = kSplitDense ? 2 : 1;
  static constexpr int oWqkv = 0, oWqkvS = oWqkv + DM * WQ,
                       oWout = oWqkv + kDenseCopies * DM * WQ,
                       oWoutS = oWout + DM * WO,
                       oW1 = oWout + kDenseCopies * DM * WO,
                       oW1S = oW1 + DM * W1S, oWm = oW1S + DM * W1S,
                       oWmS = oWm + HID * (HID2 ? WMS : 0),
                       oW2 = oWmS + HID * (HID2 ? WMS : 0),
                       oW2S = oW2 + HL * W2S,
                       oX = oW1 + P::meta(kStageMeta),
                       oQKV = oX + kXBufs * ROWS * XS,
                       oH = oQKV + ROWS * QS, oT = oH + ROWS * HS,
                       oP = oT + ROWS * TS;
  // after the probabilities, where the shared memory holds it, a second
  // MetaNet block (the region [oW1, oX)) for distinct Q and K tables
  static __host__ __device__ int oMeta2(int F, bool with_p) {
    return oP + P::probs(ROWS, F, with_p);
  }
  static __host__ __device__ int bytes(int F, bool with_p, bool two = false) {
    return P::bytes(P::plan(), F, with_p, two && kStageMeta);
  }
};

template <class SH, int MODE, bool TILED>
__global__ void __launch_bounds__(FwdTile<SH>::TT, 1)
    meta_stash_fwd_kernel(const StashFwdArgs a) {
  constexpr int DM = SH::DM, HID = SH::HID, HID2 = SH::HID2, NH = SH::NH;
  constexpr int HL = SH::HL;
  using L = FwdTile<SH>;
  // the residuals qkv, uq, uk and o; the probabilities
  constexpr bool STASH = MODE == kFullStash || MODE == kLightStash;
  constexpr bool STASH_S = MODE == kFullStash || MODE == kScores;
  constexpr int RT = row_threads(DM);  // threads on a row in epilogues
  static_assert(MODE == kFullStash || MODE == kNoStash || !TILED,
                "K7 has no light stash and no scores");

  extern __shared__ __align__(16) unsigned char smem[];
  const TileHeader hd(smem);
  int *const order = hd.order, *const wdom = hd.wdom, *const key = hd.key;
  float* f0 = reinterpret_cast<float*>(smem + L::kHeader);
  // the weights: float32, or the planes of their 3xTF32 halves
  float* sWqkv = f0 + L::oWqkv;
  float* sWout = f0 + L::oWout;
  uint32_t* const u0 = reinterpret_cast<uint32_t*>(f0);
  const auto wqkv = [&](int k, int c) {
    if constexpr (L::kSplitDense)
      return Split2{u0[L::oWqkv + k * L::WQ + c],
                    u0[L::oWqkvS + k * L::WQ + c]};
    else
      return sWqkv[k * L::WQ + c];
  };
  const auto wout = [&](int k, int c) {
    if constexpr (L::kSplitDense)
      return Split2{u0[L::oWout + k * L::WO + c],
                    u0[L::oWoutS + k * L::WO + c]};
    else
      return sWout[k * L::WO + c];
  };
  // the MetaNet block in use: staged in the first region, or (mo = its
  // distance) the second; or where the plan stages none, its matrices in
  // device memory (gw1, gwm, gw2)
  int mo = 0;
  const float *gw1 = nullptr, *gwm = nullptr, *gw2 = nullptr;
  const auto w1 = [&](int k, int c) {
    if constexpr (L::kStageMeta)
      return Split2{u0[mo + L::oW1 + k * L::W1S + c],
                    u0[mo + L::oW1S + k * L::W1S + c]};
    else
      return __ldg(gw1 + k * HID + c);
  };
  const auto wm = [&](int k, int c) {
    if constexpr (L::kStageMeta)
      return Split2{u0[mo + L::oWm + k * L::WMS + c],
                    u0[mo + L::oWmS + k * L::WMS + c]};
    else
      return __ldg(gwm + k * HID2 + c);
  };
  const auto w2 = [&](int k, int c) {
    if constexpr (L::kStageMeta)
      return Split2{u0[mo + L::oW2 + k * L::W2S + c],
                    u0[mo + L::oW2S + k * L::W2S + c]};
    else
      return __ldg(gw2 + k * DM + c);
  };
  float* sQKV = f0 + L::oQKV;
  float* sH = f0 + L::oH;    // hidden h1, then the attention output o
  float* sH2 = f0 + L::oP;   // 3-matrix: hidden h2, over the probabilities
  float* sT = f0 + L::oT;    // the last MetaNet matrix's output, then zlin
  float* sP = f0 + L::oP;    // the tile's probabilities

  const int tid = threadIdx.x;
  const int F = a.F, E = tile_examples(F, L::ROWS);
  const DropSalts salt(a.apply_q, a.apply_k, NH);
  const bool one_table = a.mw.w1q == a.mw.w1k && a.mw.w2q == a.mw.w2k &&
                         a.mw.wmq == a.mw.wmk;

  if constexpr (L::kSplitDense) {
    stage_split<DM, 3 * DM>(u0 + L::oWqkv, u0 + L::oWqkvS, L::WQ, a.wqkv);
    stage_split<DM, DM>(u0 + L::oWout, u0 + L::oWoutS, L::WO, a.wout);
  } else {
    stage_matrix<DM, 3 * DM>(sWqkv, L::WQ, a.wqkv);
    stage_matrix<DM, DM>(sWout, L::WO, a.wout);
    cp_async_wait_all();
  }
  __syncthreads();

  // x of a tile into buffer b, one cp.async group
  const auto load_x = [&](const int* ex, int n, int b) {
    load_rows<DM>(f0 + L::oX + b * L::ROWS * L::XS, L::XS, a.x, ex, n, F);
    cp_async_commit();
  };
  // the MetaNet block (2 row + table) in each region; with distinct tables
  // and room for two, the K MetaNet's block lives in the second
  int staged[2] = {-1, -1};
  const int mo2 = a.two ? L::oMeta2(F, STASH_S) - L::oW1 : 0;
  int buf = 0;
  // The block's range of positions: K1's examples of the batch; K7's
  // occupied slots in slot order, whole tiles of E
  int lo, hi;
  if constexpr (TILED) {
    const int total = occupied_total(a.count, a.D, a.tile_b, key);
    const int grid = static_cast<int>(gridDim.x);
    const int chunk = ((total + E - 1) / E + grid - 1) / grid * E;
    lo = min(total, static_cast<int>(blockIdx.x) * chunk);
    hi = min(total, lo + chunk);
  } else {
    lo = blockIdx.x * a.chunk;
    hi = min(a.B, lo + a.chunk);
  }
#pragma unroll 1
  for (int w0 = lo; w0 < hi; w0 += kWindow) {
    const int nw = min(kWindow, hi - w0);
    if constexpr (TILED)
      occupied_window(a.count, a.D, a.tile_b, w0, nw, order, wdom, key);
    else
      sort_window(a.dom, w0, nw, a.D, order, wdom, key);
    const int ntiles = (nw + E - 1) / E;
    load_x(order, min(E, nw), buf);
#pragma unroll 1
    for (int ti = 0; ti < ntiles; ++ti) {
      const int* ex = order + ti * E;
      const int* dm = wdom + ti * E;
      const int n = min(E, nw - ti * E), R = n * F, mt = (R + 15) / 16;
      // the next tile's x into the other buffer, read last by the tile
      // before this one; then this tile's x, one group older
      if (L::kXBufs == 2 && ti + 1 < ntiles) {
        load_x(ex + E, min(E, nw - (ti + 1) * E), buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      tile_draws(hd.draws, a.drop, ex, n);
      __syncthreads();
      const float* sX = f0 + L::oX + buf * L::ROWS * L::XS;

      // 1. q0 | k0 | v0 = x @ [Wq | Wk | Wv]
      block_gemm<DM, 3 * DM, fit_nt(3 * DM, 6), DM / 8>(
          0, mt, [&](int m, int k) { return sX[m * L::XS + k]; },
          wqkv,
          [&](int r, int c, float v0, float v1) {
            *reinterpret_cast<float2*>(sQKV + r * L::QS + c) =
                make_float2(v0, v1);
          });
      __syncthreads();
      if (STASH) {
        store_rows<3 * DM>(a.st.qkv, sQKV, L::QS, ex, n, F);
        // an untransformed projection's pre-LN sum is q0 (k0) itself
        if (!a.apply_q) store_rows<DM>(a.st.uq, sQKV, L::QS, ex, n, F);
        if (!a.apply_k) store_rows<DM>(a.st.uk, sQKV + DM, L::QS, ex, n, F);
      }

      // 2. Per domain segment, the MetaNet of its domain on q0, then on k0
      //    (its rows' products on the tensor cores), each followed by the
      //    dropout, the residual and the LayerNorm, written over q0 / k0
      //    (the epilogue).  K1-stash keeps the pre-LN sums uq and uk.  The
      //    items are pipelined: an item's epilogue runs beside the next
      //    item's first product, between the same two barriers (they touch
      //    other buffers, or other rows of sQKV).
      const auto epilogue = [&](int w, int r0, int r1) {
        const float* ln = w ? a.lnk : a.lnq;
        float* ures = w ? a.st.uk : a.st.uq;
        const unsigned sl = w ? salt.k : salt.q;
#pragma unroll
        for (int rb = r0; rb < r0 + L::ROWS; rb += L::kRowsAPass) {
          const int r = rb + tid / RT, c = 4 * (tid % RT);
          const bool ok = r < r1;
          const int s = r / F, f = r - s * F;
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          if (ok) {
            float o[4], t0[4];
            to4(ld4(sT + r * L::TS + c), o);
            to4(ld4(sQKV + r * L::QS + w * DM + c), t0);
            if (a.drop.on) {
              const ExampleDraw& ed = hd.draws[s];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                o[j] *= ed.rows<DM>(a.drop, sl, f, c + j);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = o[j] + t0[j];
            if (STASH)
              st4(ures + (static_cast<size_t>(ex[s]) * F + f) * DM + c, v);
          }
          row_layer_norm<DM>(v, ln, c);
          if (ok) st4(sQKV + r * L::QS + w * DM + c, v);
        }
      };
      int pw = -1, pr0 = 0, pr1 = 0;  // the item whose epilogue waits
      for_segments(dm, n, F, [&](int d, int r0, int r1) {
        const int m0 = r0 / 16, m1 = (r1 + 15) / 16;
        // with one region, the MetaNet whose block is staged goes first:
        // with distinct Q and K tables, a segment that goes on where the
        // last one ended stages one block, not two (the items touch
        // separate columns)
        const int first = !one_table && !a.two && staged[0] == 2 * d + 1;
#pragma unroll 1
        for (int i = 0; i < 2; ++i) {
          const int w = i ^ first;
          if (!(w ? a.apply_k : a.apply_q)) continue;  // uniform
          const int blk = 2 * d + (one_table ? 0 : w);
          const int slot = a.two ? w : 0;
          mo = slot ? mo2 : 0;
          const size_t dd = static_cast<size_t>(d);
          if constexpr (!L::kStageMeta) {
            gw1 = (w ? a.mw.w1k : a.mw.w1q) + dd * DM * HID;
            if constexpr (HID2 > 0)
              gwm = (w ? a.mw.wmk : a.mw.wmq) + dd * HID * HID2;
            gw2 = (w ? a.mw.w2k : a.mw.w2q) + dd * HL * DM;
          } else if (blk != staged[slot]) {
            __syncthreads();  // every warp is done with the last block
            stage_split<DM, HID>(u0 + mo + L::oW1, u0 + mo + L::oW1S, L::W1S,
                                 (w ? a.mw.w1k : a.mw.w1q) + dd * DM * HID);
            if constexpr (HID2 > 0)
              stage_split<HID, HID2>(
                  u0 + mo + L::oWm, u0 + mo + L::oWmS, L::WMS,
                  (w ? a.mw.wmk : a.mw.wmq) + dd * HID * HID2);
            stage_split<HL, DM>(u0 + mo + L::oW2, u0 + mo + L::oW2S, L::W2S,
                                (w ? a.mw.w2k : a.mw.w2q) + dd * HL * DM);
            __syncthreads();
            staged[slot] = blk;
          }
          const auto seg_store = [&](float* dst, int ds, bool relu) {
            return [=](int r, int c, float v0, float v1) {
              if (r >= r0 && r < r1)
                *reinterpret_cast<float2*>(dst + r * ds + c) =
                    relu ? make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f))
                         : make_float2(v0, v1);
            };
          };
          // h1 = relu(t0 @ W1), and for a 3-matrix MetaNet h2 = relu(h1 @ Wm)
          block_gemm<DM, HID, fit_nt(HID, 4), DM / 8>(
              m0, m1,
              [&](int m, int k) { return sQKV[m * L::QS + w * DM + k]; },
              w1,
              seg_store(sH, L::HS, true));
          if (pw >= 0) epilogue(pw, pr0, pr1);
          __syncthreads();
          if constexpr (HID2 > 0) {
            block_gemm<HID, HID2, fit_nt(HID2, 4), HID / 8>(
                m0, m1, [&](int m, int k) { return sH[m * L::HS + k]; },
                wm,
                seg_store(sH2, L::HS, true));
            __syncthreads();
          }
          const float* sL = HID2 ? sH2 : sH;
          block_gemm<HL, DM, fit_nt(DM, 2), HL / 8>(
              m0, m1, [&](int m, int k) { return sL[m * L::HS + k]; },
              w2,
              seg_store(sT, L::TS, false));
          __syncthreads();
          pw = w;
          pr0 = r0;
          pr1 = r1;
        }
      });
      if (pw >= 0) epilogue(pw, pr0, pr1);
      __syncthreads();

      // 3. Attention, a thread a (head, row) pair: o into sH's first DM
      //    columns, P (before dropout) into sP
      for_pairs<NH>(n, F, [&](int s, int hh, int i) {
        attention_fwd_pair<DM, NH, STASH_S>(
            sQKV + s * F * L::QS, L::QS, sH + s * F * L::HS, L::HS,
            sP + s * NH * F * F, F, hh, i,
            AttnHash{a.drop, hd.draws[s], salt.s + hh});
      });
      __syncthreads();
      if (STASH_S) {
        // an example's P in float4s where its NH F^2 floats keep them
        // aligned (4 heads, or F even), else one float a thread
        const int pf = NH * F * F, v = pf % 4 ? 1 : 4, per = pf / v;
        for (int i = tid; i < n * per; i += L::TT) {
          const int s = i / per, o = v * (i - s * per);
          float* dst = a.st.s + static_cast<size_t>(ex[s]) * pf + o;
          if (v == 4)
            *reinterpret_cast<float4*>(dst) = ld4(sP + s * pf + o);
          else
            *dst = sP[s * pf + o];
        }
      }
      if (STASH) store_rows<DM>(a.st.o, sH, L::HS, ex, n, F);

      // 4. y = LN_o(relu?(o @ Wout) m_z + x)
      block_gemm<DM, DM, fit_nt(DM, 2), DM / 8>(
          0, mt, [&](int m, int k) { return sH[m * L::HS + k]; },
          wout,
          [&](int r, int c, float v0, float v1) {
            *reinterpret_cast<float2*>(sT + r * L::TS + c) =
                make_float2(v0, v1);
          });
      __syncthreads();
#pragma unroll
      for (int rb = 0; rb < L::ROWS; rb += L::kRowsAPass) {
        const int r = rb + tid / RT, c = 4 * (tid % RT);
        const bool ok = r < R;
        const int s = r / F, f = r - s * F;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (ok) {
          float z[4], xr[4];
          to4(ld4(sT + r * L::TS + c), z);
          to4(ld4(sX + r * L::XS + c), xr);
          const ExampleDraw& ed = hd.draws[s];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[j] = a.relu_out ? fmaxf(z[j], 0.f) : z[j];
            if (a.drop.on) v[j] *= ed.rows<DM>(a.drop, salt.z, f, c + j);
            v[j] += xr[j];
          }
        }
        row_layer_norm<DM>(v, a.lno, c);
        if (ok)
          st4(a.y + (static_cast<size_t>(ex[s]) * F + f) * DM + c, v);
      }
      __syncthreads();  // the tile's buffers are free
      if (L::kXBufs == 1) {
        if (ti + 1 < ntiles) load_x(ex + E, min(E, nw - (ti + 1) * E), 0);
      } else {
        buf ^= 1;
      }
    }
  }
  // K7: y and every residual of the slack slots (the last tile_b - count[t]
  // of tile t) are zeros, finite for the head that reads every slot (and
  // for the next layer, which reads them as its x); the blocks take the
  // dispatch tiles in turn
  if constexpr (TILED) {
    if (a.count) {
      const auto zero = [&](float* p, size_t n) {
        if (n % 4 || reinterpret_cast<uintptr_t>(p) % 16) {
          for (size_t i = tid; i < n; i += L::TT) p[i] = 0.f;
        } else {
          for (size_t i = tid; i < n / 4; i += L::TT)
            reinterpret_cast<float4*>(p)[i] =
                make_float4(0.f, 0.f, 0.f, 0.f);
        }
      };
      for (int t = blockIdx.x; t < a.D; t += gridDim.x) {
        const int cnt = tile_occupied(a.count, t, a.tile_b);
        const size_t s0 = static_cast<size_t>(t) * a.tile_b + cnt,
                     ns = a.tile_b - cnt, row = static_cast<size_t>(F) * DM;
        zero(a.y + s0 * row, ns * row);
        if (STASH) {
          zero(a.st.qkv + 3 * s0 * row, 3 * ns * row);
          zero(a.st.uq + s0 * row, ns * row);
          zero(a.st.uk + s0 * row, ns * row);
          zero(a.st.o + s0 * row, ns * row);
          zero(a.st.s + s0 * NH * F * F, ns * NH * F * F);
        }
      }
    }
  }
}

// Launches the body of mode MODE on a grid of one block an SM (or one a
// tile, when there are fewer tiles; K7: of its slots, occupied or not);
// blocks > 0 sets the grid's upper bound in place of the SM count.
template <class SH, int MODE, bool TILED = false>
cudaError_t launch_stash_fwd(StashFwdArgs a, cudaStream_t stream,
                             int blocks = 0) {
  auto kernel = meta_stash_fwd_kernel<SH, MODE, TILED>;
  int dev = 0, sms = blocks, most = 0;
  cudaGetDevice(&dev);
  if (blocks < 1)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const bool with_p = MODE == kFullStash || MODE == kScores;
  a.two = (a.mw.w1q != a.mw.w1k || a.mw.w2q != a.mw.w2k ||
           a.mw.wmq != a.mw.wmk) &&
          FwdTile<SH>::kStageMeta &&
          FwdTile<SH>::bytes(a.F, with_p, true) <= most;
  const int smem = FwdTile<SH>::bytes(a.F, with_p, a.two);
  if (smem > most) return cudaErrorInvalidValue;
  static int configured = 0;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  constexpr int ROWS = FwdTile<SH>::ROWS;
  const int E = tile_examples(a.F, ROWS);
  const int grid = min(sms, (a.B + E - 1) / E);
  a.chunk = block_chunk(a.B, a.F, grid, ROWS);
  kernel<<<grid, FwdTile<SH>::TT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
