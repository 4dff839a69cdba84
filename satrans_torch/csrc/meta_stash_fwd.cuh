// K1-stash, K1-stash light and K1-scores on Hopper: the tile body of the
// layer forward that writes the backward's residuals (included by
// csrc/meta_block_fwd.cu, whose C entry launches it for those modes).
//
// Replaces satrans_tpu/ops/pallas/meta_block.py's _fwd_kernel_stash
// (:420), launched by _fwd_call (:1177) through pl.pallas_call (:1212) on
// the body _fwd_compute, in its three uses: the full stash (stash_s=True;
// K1-stash, mode kFullStash, the JAX package's bwd='stash'), the light one
// (stash_s=False; K1-stash light, kLightStash, bwd='stash_light') and
// fused_meta_layer_with_scores (:502 -> _fused_stash_forward :542; K1-
// scores, kScores, the attention probes), which keeps y and the
// probabilities alone.  The function per example is meta_block_fwd.cu's;
// the residuals are qkv [B, F, 3d], uq and uk [B, F, d], the probabilities
// P [B, H, F, F] before dropout and o [B, F, d], in the batch's order.
//
// What bounds it.  At the AliCCP sota shape (B = 8192, F = 19, d = 32,
// h = 64, 4 heads, QK) the layer is 0.5 MFLOP an example and K1-stash
// writes 20.4 kB of residuals an example besides x in and y out: 207 MB a
// launch, 62 us at 3.35 TB/s, against 23 us of its products in 3xTF32 at the
// tensor cores' TF32 peak and 6 us of attention at the float32 one.  The
// template body these modes first ran on (one warp an example, a 4-column
// x few-row register tile a lane, the weights read through L1 by every
// example) took 0.32 ms: its products masked 40 % of their FMA slots (19
// rows over 32 row slots), issued about one load per FMA, and every
// example re-read its domain's MetaNet matrices.
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
// two (2-matrix: K1-stash light at every F), so that a tile in the last one's
// domain stages nothing; else the MetaNet staged last goes first.  x comes in
// by 16-byte cp.async copies into two buffers, so that the next tile's x loads
// while this tile computes (one buffer with a 3-matrix MetaNet, whose h2 lies
// over the probabilities' buffer).  An item's LayerNorm epilogue runs beside
// the next item's first product.  The LayerNorms (8 threads a row, shuffles),
// the dropout masks (csrc/dropout.cuh, keyed on each example's own index in
// the batch, never its sorted place; each slot's draw computed once a tile)
// and the attention (attention_fwd_pair, a thread a (head, row) pair, all
// pairs in one round) stay on the CUDA cores in float32 with the first body's
// device code, so K1-scores' P equals K1-stash's bit for bit.  The residuals
// and y go out as whole rows of float4s (P as each example's contiguous [H, F,
// F]), back in the batch's order.  Shared memory at F = 19: 211 KiB (K1-stash,
// K1-scores), 182 KiB (K1-stash light; 220 KiB with the second MetaNet
// region); 215 and 212 KiB with a 3-matrix MetaNet.

#pragma once

#include "stash_tile.cuh"

namespace {

struct StashFwdArgs {
  const float *x, *wqkv, *lnq, *lnk, *wout, *lno;
  const int* dom;
  MetaW mw;
  float* y;
  Stash st;
  int B, F, D, chunk, apply_q, apply_k, relu_out;
  Dropout drop;
  int two;  // distinct Q and K tables, each MetaNet's block in a region
};

// Shared layout of the forward tile body, in floats after the header
// (kTileHeader): row strides (+4 shifts an A operand's rows by four banks,
// +8 a B operand's by eight) and region offsets.
template <class SH>
struct FwdTile {
  static constexpr int DM = SH::DM, HID = SH::HID, HID2 = SH::HID2,
                       HL = SH::HL;
  static constexpr int WQ = 3 * DM + 8, WO = DM + 8, W1S = HID + 8,
                       WMS = HID2 + 8, W2S = DM + 8;
  static constexpr int XS = DM + 4, QS = 3 * DM + 4, HS = SH::HMAX + 4,
                       TS = DM + 4;
  static constexpr int kHeader = kTileHeader;  // bytes
  // the tile's rows and the block's threads (one a pair of the attention)
  static constexpr int ROWS = kWideTileRows, TT = 4 * ROWS;
  static constexpr int kRowsAPass = TT / kRowThreads;  // of the epilogues
  static_assert(ROWS % kRowsAPass == 0, "whole passes");
  // The weights are staged split into their 3xTF32 halves (a big and a
  // small plane each), all of them for a 2-matrix MetaNet; a 3-matrix one
  // has room for the MetaNet's planes alone (Wqkv and Wout stay float32,
  // split in the products) and one x buffer.
  static constexpr bool kSplitDense = HID2 == 0;
  static constexpr int kXBufs = HID2 ? 1 : 2;
  static constexpr int kDenseCopies = kSplitDense ? 2 : 1;
  static constexpr int oWqkv = 0, oWqkvS = oWqkv + DM * WQ,
                       oWout = oWqkv + kDenseCopies * DM * WQ,
                       oWoutS = oWout + DM * WO,
                       oW1 = oWout + kDenseCopies * DM * WO,
                       oW1S = oW1 + DM * W1S, oWm = oW1S + DM * W1S,
                       oWmS = oWm + HID * (HID2 ? WMS : 0),
                       oW2 = oWmS + HID * (HID2 ? WMS : 0),
                       oW2S = oW2 + HL * W2S, oX = oW2S + HL * W2S,
                       oQKV = oX + kXBufs * ROWS * XS,
                       oH = oQKV + ROWS * QS, oT = oH + ROWS * HS,
                       oP = oT + ROWS * TS;
  // the probabilities of E examples (E NH F^2 <= NH ROWS F floats), which
  // a 3-matrix MetaNet's h2 shares: h2 lives in the MetaNet phase, P in
  // the attention; after them, where the shared memory holds it, a second
  // MetaNet block (the region [oW1, oX)) for distinct Q and K tables
  static __host__ __device__ int oMeta2(int F, bool with_p) {
    const int p = with_p ? tile_examples(F, ROWS) * SH::NH * F * F : 0;
    const int h2 = HID2 ? ROWS * HS : 0;
    return oP + (((p > h2 ? p : h2) + 3) & ~3);
  }
  static __host__ __device__ int bytes(int F, bool with_p, bool two = false) {
    return kHeader + 4 * (oMeta2(F, with_p) + (two ? oX - oW1 : 0));
  }
};

template <class SH, int MODE>
__global__ void __launch_bounds__(FwdTile<SH>::TT, 1)
    meta_stash_fwd_kernel(const StashFwdArgs a) {
  constexpr int DM = SH::DM, HID = SH::HID, HID2 = SH::HID2, NH = SH::NH;
  constexpr int HL = SH::HL;
  using L = FwdTile<SH>;
  // the residuals qkv, uq, uk and o; the probabilities
  constexpr bool STASH = MODE != kScores;
  constexpr bool STASH_S = MODE != kLightStash;
  static_assert(DM == 4 * kRowThreads, "epilogues take rows of 32");

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
  // the MetaNet block in use: the first region, or (mo = its distance)
  // the second
  int mo = 0;
  const auto w1 = [&](int k, int c) {
    return Split2{u0[mo + L::oW1 + k * L::W1S + c],
                  u0[mo + L::oW1S + k * L::W1S + c]};
  };
  const auto wm = [&](int k, int c) {
    return Split2{u0[mo + L::oWm + k * L::WMS + c],
                  u0[mo + L::oWmS + k * L::WMS + c]};
  };
  const auto w2 = [&](int k, int c) {
    return Split2{u0[mo + L::oW2 + k * L::W2S + c],
                  u0[mo + L::oW2S + k * L::W2S + c]};
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
  const int lo = blockIdx.x * a.chunk, hi = min(a.B, lo + a.chunk);
#pragma unroll 1
  for (int w0 = lo; w0 < hi; w0 += kWindow) {
    const int nw = min(kWindow, hi - w0);
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
      block_gemm<DM, 3 * DM, 6, DM / 8>(
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
          const int r = rb + tid / kRowThreads, c = 4 * (tid % kRowThreads);
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
          if (blk != staged[slot]) {
            __syncthreads();  // every warp is done with the last block
            const size_t dd = static_cast<size_t>(d);
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
          block_gemm<DM, HID, 4, DM / 8>(
              m0, m1,
              [&](int m, int k) { return sQKV[m * L::QS + w * DM + k]; },
              w1,
              seg_store(sH, L::HS, true));
          if (pw >= 0) epilogue(pw, pr0, pr1);
          __syncthreads();
          if constexpr (HID2 > 0) {
            block_gemm<HID, HID2, 4, HID / 8>(
                m0, m1, [&](int m, int k) { return sH[m * L::HS + k]; },
                wm,
                seg_store(sH2, L::HS, true));
            __syncthreads();
          }
          const float* sL = HID2 ? sH2 : sH;
          block_gemm<HL, DM, 2, HL / 8>(
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
        const ExampleDraw& ed = hd.draws[s];
        attention_fwd_pair<DM, NH, false, STASH_S>(
            sQKV + s * F * L::QS, L::QS, sH + s * F * L::HS, L::HS,
            sP + s * NH * F * F, nullptr, F, hh, i, a.drop, ed, salt.s);
      });
      __syncthreads();
      if (STASH_S) {
        const int per = NH * F * F / 4;  // float4s of an example's P
        for (int i = tid; i < n * per; i += L::TT) {
          const int s = i / per, o = 4 * (i - s * per);
          *reinterpret_cast<float4*>(
              a.st.s + static_cast<size_t>(ex[s]) * NH * F * F + o) =
              ld4(sP + s * NH * F * F + o);
        }
      }
      if (STASH) store_rows<DM>(a.st.o, sH, L::HS, ex, n, F);

      // 4. y = LN_o(relu?(o @ Wout) m_z + x)
      block_gemm<DM, DM, 2, DM / 8>(
          0, mt, [&](int m, int k) { return sH[m * L::HS + k]; },
          wout,
          [&](int r, int c, float v0, float v1) {
            *reinterpret_cast<float2*>(sT + r * L::TS + c) =
                make_float2(v0, v1);
          });
      __syncthreads();
#pragma unroll
      for (int rb = 0; rb < L::ROWS; rb += L::kRowsAPass) {
        const int r = rb + tid / kRowThreads, c = 4 * (tid % kRowThreads);
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
}

// Launches the body of mode MODE on a grid of one block an SM (or one a
// tile, when there are fewer tiles).
template <class SH, int MODE>
cudaError_t launch_stash_fwd(StashFwdArgs a, cudaStream_t stream) {
  auto kernel = meta_stash_fwd_kernel<SH, MODE>;
  int dev = 0, sms = 0, most = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const bool with_p = MODE != kLightStash;
  a.two = (a.mw.w1q != a.mw.w1k || a.mw.w2q != a.mw.w2k ||
           a.mw.wmq != a.mw.wmk) &&
          FwdTile<SH>::bytes(a.F, with_p, true) <= most;
  const int smem = FwdTile<SH>::bytes(a.F, with_p, a.two);
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
