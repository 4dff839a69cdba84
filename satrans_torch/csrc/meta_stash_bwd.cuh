// The tile body of the layer backward on Hopper, every mode of it: K1-bwd,
// K1-bwd-stash, K1-bwd-stash light, K7-bwd-stash and K7-bwd (included by
// csrc/meta_block_bwd.cu after its gradient layout, Strides and
// grad_floats, whose C entries launch it).
//
// Replaces satrans_tpu/ops/pallas/meta_block.py's two backward kernels,
// both launched by _bwd_call (:1227) through pl.pallas_call (:1292):
// _bwd_kernel (:685; K1-bwd, kNoStash, the JAX package's bwd='recompute'),
// which reads no residual and recomputes the forward on chip, and
// _bwd_kernel_stash (:902) in its full mode (stash_s=True; K1-bwd-stash,
// kFullStash, the default bwd='stash'), which reads qkv, uq, uk, the
// probabilities s and o, and its light mode (stash_s=False; K1-bwd-stash
// light, kLightStash, bwd='stash_light'), which recomputes the
// probabilities from the stashed pre-LN sums with the forward's device
// code (attention_probs_pair, csrc/layer_common.cuh), so they equal
// K1-stash's bit for bit.  On the kTiles walk it replaces satrans_tpu/ops/
// pallas/tiled_meta.py's _bwd_kernel_stash (:341, K7-bwd-stash,
// kFullStash, the default bwd='stash') and _bwd_kernel (:178, K7-bwd,
// kNoStash, bwd='recompute'), both launched by _bwd_call (:562) through
// pl.pallas_call (:634): the backward of the layer on the slots of
// dispatched single-domain tiles (ops/dispatch.py; tile t of tile_b slots
// takes the MetaNet block of row t of the per-tile [T, d, h] and [T, h, d]
// weights).  The recompute modes (K1-bwd, K7-bwd) read no residual: they
// compute qkv, the MetaNets' pre-LN sums uq and uk, the LayerNorms, the
// probabilities and o on chip, with the products of the forward tile body
// (block_gemm, 3xTF32) and the backwards' attention pass
// (attention_recompute_pair), into the buffers the stash modes load into.
// The function, the dropout's mirror sites and the gradient layout are
// meta_block_bwd.cu's; K7 writes each dispatch tile's own gradient blocks
// [T, ...], summed over the tile's slots only (autograd of the gather
// table[tile_dom] outside the kernel adds them into the table's rows).
//
// What bounds it.  At the AliCCP sota shape the backward is about 0.9 MFLOP
// an example (the MetaNets' hidden layers and zlin recomputed, then dWout,
// do, the attention backward, dW2, dh, dW1 and dt0 of both MetaNets, dWqkv
// and dx) against 20.4 kB of residuals and 7.3 kB of x, g and dx: 0.1493 ms
// of float32 FMA work, 68 us of bytes at B = 8192 (the recompute modes
// read no residual and do the forward's 0.5 MFLOP more).  The template
// body these modes first ran on (deleted) took 1.145 ms (K1-bwd-stash) and
// 1.336 ms (K1-bwd): two examples a block iteration with 20 block
// barriers around them, 40 % of its FMA slots masked (19 rows over 32 row
// slots), weights re-read from L1/L2 with about one load per FMA, the
// per-domain gradients read and written in L2 once an example (0.5 GB a
// launch), transposed weight copies made each backward, and no tensor
// cores.  K7's backwards first ran on that template too (K7-bwd-stash
// 2.10 ms at 8192 examples in 9984 slots on the H100), with whole
// dispatch tiles a block (312 over 264 blocks: 1.18 waves) and the 1,792
// slack slots computed.
//
// Design.  As the forward's tile body (csrc/meta_stash_fwd.cuh): a block of
// 320 threads, one an SM, owns tiles of E = 80 / F examples of the batch
// sorted by domain, and every product runs on the tensor cores in 3xTF32
// (block_gemm, strips of 16 x 16, which keep the body under the 168
// registers a thread that 10 warps allow), with the weights in shared
// memory in float32 (Wqkv and Wout once a block, a domain's MetaNet block
// once a segment) and read transposed where the backward needs W^T, so no
// transposed copies are made.  The weight gradients are sums over rows
// (WTiles): dWqkv and dWout in 16 x 8 tiles that each warp owns for the
// whole launch, in registers; dW2, dWm and dW1 of the segment's domain
// summed over the segment's rows in registers and added into the block's
// slice of the scratch buffer once a segment, not once an example.  The
// LayerNorm gradients are per-thread column sums, as before, and
// sum_partials adds the slices in block order: deterministic for a grid.
// The residual rows (x, qkv, uq, uk, o) come in by 16-byte cp.async copies
// of all threads, the probabilities by one TMA bulk copy an example on an
// mbarrier; each tile issues the next tile's loads as soon as their buffers
// are free (o after the attention backward, qkv, uq, uk and s after the
// MetaNet backward, x after dx), so they overlap the rest of this tile's
// work (a bulk copy a row held up the issuing warp on the card, see
// load_rows in csrc/stash_tile.cuh).  Attention, LayerNorms
// and masks stay in float32 on the CUDA cores (the per-pair passes of
// csrc/layer_common.cuh, a thread a pair).  dx goes out from the product's
// registers, 8-byte pairs filling whole 32-byte sectors, in the batch's
// order.  Shared memory at F = 19: 208 kB, 226 kB with a 3-matrix MetaNet,
// whose second hidden layer reuses the uq|uk buffer once the LayerNorm
// backward has read it.
//
// Other shapes.  BwdTile picks the rows (80 down to 32) and whether the
// MetaNet block is staged, the first that fits at every F <= 20 (80 rows
// staged up to d = 32 with 4 heads, 64 at d = 32 with 8; at d = 64 32 rows
// with the MetaNet read from device memory); WTiles pads a weight of 8
// rows (d = 8) to its 16-row tile.  The probabilities come in by a bulk
// copy an example where an example's NH F^2 floats keep its copies
// 16-byte aligned, else by 4-byte cp.async copies of all threads.
//
// The walks (BwdWalk).  K1 at up to slice_domains rows (kSlices): each
// block sorts its range of the batch in windows (sort_window) and keeps
// every meta row's MetaNet sums in its slice of the scratch buffer, which
// sum_partials adds in block order.  The slice grows with the rows, so K1
// past slice_domains (kSorted) walks the batch sorted by domain row as a
// whole (sort_rows below: a stable counting sort of the port's own, three
// small launches) and splits the sorted positions between the blocks
// as kTiles splits K7's slots: the owner of a whole run of one row stores
// the run's sums straight into the output, a run shared with the block
// before goes to the head slot and one shared with the block after to the
// tail slot (a run through the whole range: the head slot), and
// sorted_bwd_finish adds a shared run's slots in block order.  The
// scratch is the blocks' dense and LayerNorm slices and two slots of both
// MetaNets' blocks a block, whatever the rows.  Each position is still an
// example of the batch: its rows, its dx and its dropout masks are those
// of its batch index, as in kSlices (K7's masks are keyed by slot).
//
// K7 (kTiles).  The slots come sorted: the segments of a tile are its runs
// of one dispatch tile (slot / tile_b), and nothing is sorted.  The blocks
// split the occupied slots (the first count[t] of tile t, occupied_window
// in csrc/stash_tile.cuh; every slot when count is null) into contiguous
// ranges of whole tiles of E, at least tile_b long, so that a dispatch
// tile lies in the range of one block or of two neighbours; the slack slots
// are skipped (their upstream gradient is zero, and so is every gradient
// they would add).  The owner of a whole dispatch tile adds the tile's
// segment sums straight into the tile's blocks of the output (the first
// segment stores, the next ones add).  A dispatch tile split between
// blocks b and b + 1 gets its partials into b's tail slot and b + 1's head
// slot of a scratch buffer, and tiled_bwd_finish adds the two in block
// order, beside the dense and LayerNorm sums of sum_partials; it also
// writes the zeros of the blocks of empty tiles and unapplied MetaNets and
// of dx on the slack slots.  So the result is deterministic for a grid.
// The recompute modes (K1-bwd, K7-bwd) fill the buffers that the stash
// modes load by computing them, tile by tile (R1, R2 and R4 below): x @
// Wqkv, per segment the MetaNets (each distinct Q and K block staged in
// turn), the LayerNorms, P and o; then they run the same backward phases.
// The recompute adds no shared memory (the forward's hidden rows go where
// the probabilities and the gradient rows go later: h1 in sG, a 3-matrix
// MetaNet's h2 in the dq|dk|dv buffer sD).

#pragma once

#include "stash_tile.cuh"

namespace {

struct StashBwdArgs {
  const float *x, *g, *wqkv, *lnq, *lnk, *wout, *lno;
  const int* dom;  // K1's domain rows
  MetaW mw;
  float *dx, *partial, *grads;
  const float *qkv, *uq, *uk, *s, *o;
  // K1: B examples, D domain rows.  K7: B slots, D dispatch tiles.
  int B, F, D, chunk, apply_q, apply_k, relu_out;
  Dropout drop;
  // K7: tile_b slots a tile, count[t] of tile t occupied (null: all); bnd
  // (K7, K1 kSorted) two slots (head, tail) of both MetaNets' blocks a
  // grid block, and (K7) bnd_tile[b] the tile in block b's tail slot (-1:
  // none)
  const int* count;
  int tile_b;
  float* bnd;
  int* bnd_tile;
  // K1 kSorted: the batch's examples stably sorted by clamped domain row
  // (perm) and their rows (skey), and row d's sorted positions [start[d],
  // start[d + 1])
  const int *perm, *skey, *start;
};

// How the blocks split the positions and where their MetaNet sums go (see
// "The walks" above): K1 up to slice_domains rows, K7, K1 past it.
enum BwdWalk : int { kSlices = 0, kTiles = 1, kSorted = 2 };

// The shared layout of the backward tile body, in floats after the header
// (kTileHeader), as FwdTile's: its tile rows and whether a domain's MetaNet
// block is staged in shared memory once a segment (else each product reads
// it through L1 from device memory): the first, from 80 rows down and
// staged first, whose buffers fit a block at every F (80 rows staged at
// the AliCCP sota shape; 32 rows reading the MetaNet from device memory
// at d = 64, whose float32 MetaNet block alone takes 71.7 kB).
template <class SH>
struct BwdParts {
  static constexpr int DM = SH::DM, HID = SH::HID, HID2 = SH::HID2,
                       HL = SH::HL, NH = SH::NH;
  static constexpr int WQ = 3 * DM + 8, WO = DM + 8, W1S = HID + 8,
                       WMS = HID2 + 8, W2S = DM + 8;
  static constexpr int XS = DM + 4, QS = 3 * DM + 4, US = 2 * DM + 4,
                       NS = 2 * DM + 4, OS = DM + 4, DS = 3 * DM + 4,
                       HS = SH::HMAX + 4;
  static __host__ __device__ constexpr int meta(bool staged) {
    return staged ? DM * W1S + (HID2 ? HID * WMS : 0) + HL * W2S : 0;
  }
  // x, qkv, uq|uk, q|k, o, dq|dk|dv and du of the tile's rows
  static __host__ __device__ constexpr int rows(int n) {
    return n * (XS + QS + US + NS + OS + DS + XS);
  }
  // the probabilities (and in the MetaNet phases the hidden layer h1); at
  // F = 0 the most at any F
  static __host__ __device__ constexpr int g_floats(int n, int F) {
    const int p = F ? tile_examples(F, n) * NH * F * F : most_probs(n, NH);
    const int h = n * HS;
    return ((p > h ? p : h) + 3) & ~3;
  }
  static __host__ __device__ constexpr int bytes(int n, bool staged, int F) {
    return kTileHeader +
           4 * (DM * (WQ + WO) + meta(staged) + rows(n) + g_floats(n, F));
  }
  // the rows and the staging of the first layout that fits (rows * 2 +
  // staged, so that one int carries both)
  static __host__ __device__ constexpr int plan() {
    for (int staged = 1; staged >= 0; --staged)
      for (int n = 80; n >= 32; n -= 16)
        if (bytes(n, staged, 0) <= kMaxSmem) return 2 * n + staged;
    return 2 * 32;
  }
};

template <class SH>
struct BwdTile : BwdParts<SH> {
  using P = BwdParts<SH>;
  using P::DM, P::HID, P::HID2, P::HL, P::NH, P::WQ, P::WO, P::W1S, P::WMS,
      P::W2S, P::XS, P::QS, P::US, P::NS, P::OS, P::DS, P::HS;
  static_assert(HS <= US || HID2 == 0, "h2 must fit the uq|uk buffer");
  static_assert(HS <= DS, "the recomputed h2 must fit the dq|dk|dv "
                          "buffer");
  static constexpr int ROWS = P::plan() / 2;
  static constexpr bool kStageMeta = P::plan() % 2;
  static constexpr int kRowsAPass = rows_a_pass(kTT, DM);  // of epilogues
  static_assert(ROWS % 16 == 0 && ROWS >= kMaxFields, "whole m-tiles");
  static_assert(P::bytes(ROWS, kStageMeta, 0) <= kMaxSmem,
                "no layout of the backward tile body fits this shape");
  static constexpr int kHeader = kTileHeader;  // bytes
  static constexpr int oWqkv = 0, oWout = oWqkv + DM * WQ,
                       oW1 = oWout + DM * WO, oWm = oW1 + DM * W1S,
                       oW2 = oWm + HID * (HID2 ? WMS : 0),
                       oX = oW1 + P::meta(kStageMeta),
                       oQKV = oX + ROWS * XS, oU = oQKV + ROWS * QS,
                       oN = oU + ROWS * US, oO = oN + ROWS * NS,
                       oD = oO + ROWS * OS, oDU = oD + ROWS * DS,
                       oG = oDU + ROWS * XS;
  // the LayerNorm sums' reduction at the end reuses the tile's buffers
  static_assert(P::rows(ROWS) - ROWS * XS + ROWS * HS >=
                    kTT * kLnRows * 4, "room for the LayerNorm sums");
  static __host__ __device__ int bytes(int F) {
    return P::bytes(ROWS, kStageMeta, F);
  }
};

// K7's boundary slot of grid block b: tail (1) or head (0), both MetaNets'
// W1 | Wm | W2 blocks.
template <class SH>
__device__ __forceinline__ float* boundary_slot(float* bnd, int b,
                                                int tail) {
  return bnd + (static_cast<size_t>(b) * 2 + tail) * 2 * Strides<SH>::kMeta;
}

template <class SH, int MODE, int WALK>
__global__ void __launch_bounds__(kTT, 1)
    meta_stash_bwd_kernel(const StashBwdArgs a) {
  constexpr int DM = SH::DM, HID = SH::HID, HID2 = SH::HID2, NH = SH::NH;
  constexpr int HL = SH::HL;
  using L = BwdTile<SH>;
  using S = Strides<SH>;
  constexpr bool FULL = MODE == kFullStash;
  constexpr bool RECOMPUTE = MODE == kNoStash;  // K1-bwd, K7-bwd
  constexpr bool TILED = WALK == kTiles, SORTED = WALK == kSorted;
  constexpr bool SPLIT = TILED || SORTED;  // runs split between blocks
  constexpr int RT = row_threads(DM);  // threads on a row in epilogues
  static_assert(MODE != kLightStash || !TILED, "K7 has no light stash");

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // the s loads
  const TileHeader hd(smem);
  int *const order = hd.order, *const wdom = hd.wdom, *const key = hd.key;
  float* f0 = reinterpret_cast<float*>(smem + L::kHeader);
  float* sWqkv = f0 + L::oWqkv;
  float* sWout = f0 + L::oWout;
  float* sW1 = f0 + L::oW1;
  float* sWm = f0 + L::oWm;
  float* sW2 = f0 + L::oW2;
  // the MetaNet block in use, element (k, c) of W1, Wm and W2: staged in
  // shared memory, or where the plan stages none, in device memory (gw1,
  // gwm, gw2)
  const float *gw1 = nullptr, *gwm = nullptr, *gw2 = nullptr;
  const auto W1 = [&](int k, int cc) {
    if constexpr (L::kStageMeta)
      return sW1[k * L::W1S + cc];
    else
      return __ldg(gw1 + k * HID + cc);
  };
  const auto Wm = [&](int k, int cc) {
    if constexpr (L::kStageMeta)
      return sWm[k * L::WMS + cc];
    else
      return __ldg(gwm + k * HID2 + cc);
  };
  const auto W2 = [&](int k, int cc) {
    if constexpr (L::kStageMeta)
      return sW2[k * L::W2S + cc];
    else
      return __ldg(gw2 + k * DM + cc);
  };
  float* sX = f0 + L::oX;
  float* sQKV = f0 + L::oQKV;
  float* sU = f0 + L::oU;    // uq|uk; 3-matrix: h2, then dh2
  float* sN = f0 + L::oN;    // q|k after their LayerNorms; then dy_q|dy_k
  float* sO = f0 + L::oO;    // o, then do
  float* sD = f0 + L::oD;    // dz (cols 0..DM), zlin (2DM..); dq|dk|dv
  float* sDU = f0 + L::oDU;  // the outer LayerNorm's du
  float* sG = f0 + L::oG;    // P, then dS; h1, then dh1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int F = a.F, E = tile_examples(F, L::ROWS), D = a.D;
  const DropSalts salt(a.apply_q, a.apply_k, NH);
  const bool one_table = a.mw.w1q == a.mw.w1k && a.mw.w2q == a.mw.w2k &&
                         a.mw.wmq == a.mw.wmk;
  // the block's slice: dense | LayerNorms | (kSlices) per-domain blocks
  // of Q, of K.  K7's per-tile blocks and K1 kSorted's per-domain ones lie
  // in the gradient buffer, in the same layout (K7's D tiles in place of
  // the domains).
  float* out = a.partial + static_cast<size_t>(blockIdx.x) *
                               grad_floats<SH>(SPLIT ? 0 : D);
  float* dom_out = SPLIT ? a.grads + S::kDense + kLnRows * DM
                         : out + S::kDense + kLnRows * DM;

  stage_matrix<DM, 3 * DM>(sWqkv, L::WQ, a.wqkv);
  stage_matrix<DM, DM>(sWout, L::WO, a.wout);
  if (!SPLIT)
    for (int i = tid; i < 2 * D * S::kMeta; i += kTT) dom_out[i] = 0.f;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  cp_async_wait_all();
  __syncthreads();

  // The block's range of positions: K1's examples of the batch (kSorted:
  // of the batch sorted by domain row); K7's occupied slots in slot order,
  // whole tiles of E and at least tile_b of them a block; and (K7,
  // kSorted) the rows split with the block before (head) and after (tail).
  int lo, hi, head = -1, tail = -1;
  if constexpr (TILED) {
    const int total = occupied_total(a.count, D, a.tile_b, key);
    const int least = (a.tile_b + E - 1) / E * E;
    const int chunk = max(
        ((total + E - 1) / E + static_cast<int>(gridDim.x) - 1) /
            static_cast<int>(gridDim.x) * E,
        least);
    lo = min(total, static_cast<int>(blockIdx.x) * chunk);
    hi = min(total, lo + chunk);
    if (lo < hi) {
      occupied_window(a.count, D, a.tile_b, lo, 1, order, wdom, key);
      if (order[0] != wdom[0] * a.tile_b) head = wdom[0];
      __syncthreads();
      occupied_window(a.count, D, a.tile_b, hi - 1, 1, order, wdom, key);
      const int t = wdom[0];
      if (hi < total &&
          order[0] - t * a.tile_b + 1 < tile_occupied(a.count, t, a.tile_b))
        tail = t;
      __syncthreads();
    }
    if (tid == 0) a.bnd_tile[blockIdx.x] = tail;
  } else {
    lo = blockIdx.x * a.chunk;
    hi = min(a.B, lo + a.chunk);
    if (SORTED && lo < hi) {
      const int first = __ldg(a.skey + lo), last = __ldg(a.skey + hi - 1);
      if (lo > 0 && __ldg(a.skey + lo - 1) == first) head = first;
      if (hi < a.B && __ldg(a.skey + hi) == last && last != head)
        tail = last;
    }
  }

  WTiles<DM, 3 * DM> dwqkv;
  WTiles<DM, DM> dwout;
  dwqkv.zero();
  dwout.zero();
  float ln_acc[kLnRows][4];
#pragma unroll
  for (int j = 0; j < kLnRows; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) ln_acc[j][c] = 0.f;
  }
  int staged = -1;  // the MetaNet block in shared memory: 2 row + table
  unsigned parity = 0;  // the phase of the s loads' barrier
  int flushed[2] = {-1, -1};  // K7, kSorted: the row each MetaNet's sums
                              // went to
  // the loads of a tile's residuals: group 0 x, 1 o, 2 qkv, uq and uk by
  // cp.async (one group each), and with them the probabilities, one bulk
  // copy an example by warp 0's lanes on the barrier where an example's
  // NH F^2 floats keep the copies 16-byte aligned (4 heads, or F even),
  // else with the rest of group 2, a float a copy; the recompute modes load
  // x alone
  const int pf = NH * F * F;
  const bool bulk = FULL && pf % 4 == 0;
  const auto load = [&](int group, const int* ex, int n) {
    if (group == 0) {
      load_rows<DM>(sX, L::XS, a.x, ex, n, F);
    } else if (RECOMPUTE) {
    } else if (group == 1) {
      load_rows<DM>(sO, L::OS, a.o, ex, n, F);
    } else {
      load_rows<3 * DM>(sQKV, L::QS, a.qkv, ex, n, F);
      load_rows<DM>(sU, L::US, a.uq, ex, n, F);
      load_rows<DM>(sU + DM, L::US, a.uk, ex, n, F);
      if (bulk && warp == 0) {
        if (lane == 0) mbar_expect_tx(bar, n * pf * 4u);
        __syncwarp();
        for (int s = lane; s < n; s += 32)
          bulk_load(sG + s * pf, a.s + static_cast<size_t>(ex[s]) * pf,
                    pf * 4u, bar);
      } else if (FULL) {
        for (int i = tid; i < n * pf; i += kTT) {
          const int s = i / pf;
          cp_async4(sG + i, a.s + static_cast<size_t>(ex[s]) * pf + i -
                                s * pf);
        }
      }
    }
    cp_async_commit();
  };
  // the MetaNet block of row d (a domain, a dispatch tile) of MetaNet w
  // into shared memory, unless it is there
  const auto stage_meta = [&](int w, int d) {
    const int blk = 2 * d + (one_table ? 0 : w);
    const size_t dd = static_cast<size_t>(d);
    if constexpr (!L::kStageMeta) {
      gw1 = (w ? a.mw.w1k : a.mw.w1q) + dd * DM * HID;
      if constexpr (HID2 > 0)
        gwm = (w ? a.mw.wmk : a.mw.wmq) + dd * HID * HID2;
      gw2 = (w ? a.mw.w2k : a.mw.w2q) + dd * HL * DM;
      staged = blk;
      return;
    }
    if (blk == staged) return;
    __syncthreads();  // every warp is done with the last block
    stage_matrix<DM, HID>(sW1, L::W1S,
                          (w ? a.mw.w1k : a.mw.w1q) + dd * DM * HID);
    if constexpr (HID2 > 0)
      stage_matrix<HID, HID2>(sWm, L::WMS,
                              (w ? a.mw.wmk : a.mw.wmq) + dd * HID * HID2);
    stage_matrix<HL, DM>(sW2, L::W2S,
                         (w ? a.mw.w2k : a.mw.w2q) + dd * HL * DM);
    cp_async_wait_all();
    __syncthreads();
    staged = blk;
  };
  // the row epilogues: RT threads a row, rows rb + tid / RT
  const int c = 4 * (tid % RT);

#pragma unroll 1
  for (int w0 = lo; w0 < hi; w0 += kWindow) {
    const int nw = min(kWindow, hi - w0);
    if constexpr (TILED) {
      occupied_window(a.count, D, a.tile_b, w0, nw, order, wdom, key);
    } else if constexpr (SORTED) {
      for (int k = tid; k < nw; k += kTT) {
        order[k] = __ldg(a.perm + w0 + k);
        wdom[k] = __ldg(a.skey + w0 + k);
      }
      __syncthreads();
    } else {
      sort_window(a.dom, w0, nw, D, order, wdom, key);
    }
    const int ntiles = (nw + E - 1) / E;
    for (int grp = 0; grp < 3; ++grp) load(grp, order, min(E, nw));
#pragma unroll 1
    for (int ti = 0; ti < ntiles; ++ti) {
      const int* ex = order + ti * E;
      const int* dm = wdom + ti * E;
      const int n = min(E, nw - ti * E), R = n * F, mt = (R + 15) / 16;
      const bool next = ti + 1 < ntiles;
      const int* ex1 = ex + E;
      const int n1 = next ? min(E, nw - (ti + 1) * E) : 0;
      cp_async_wait<0>();
      if (bulk) {
        mbar_wait(bar, parity);
        parity ^= 1u;
      }
      tile_draws(hd.draws, a.drop, ex, n);
      __syncthreads();

      if constexpr (RECOMPUTE) {
        // R1. q0|k0|v0 = x @ [Wq|Wk|Wv] -> sQKV
        block_gemm<DM, 3 * DM, fit_nt(3 * DM, 2)>(
            0, mt, [&](int m, int k) { return sX[m * L::XS + k]; },
            [&](int k, int cc) { return sWqkv[k * L::WQ + cc]; },
            [&](int r, int cc, float v0, float v1) {
              *reinterpret_cast<float2*>(sQKV + r * L::QS + cc) =
                  make_float2(v0, v1);
            });
        __syncthreads();
        // R2. Per segment, the MetaNets' pre-LN sums u = MetaNet(t0) m +
        //     t0 -> sU (the residuals uq|uk): h1 = relu(t0 W1) into sG,
        //     (3-matrix) h2 = relu(h1 Wm) into sD, then hL W2
        for_segments(dm, n, F, [&](int d, int r0, int r1) {
          const int m0 = r0 / 16, m1 = (r1 + 15) / 16;
          const int first = !one_table && staged == 2 * d + 1;
          for (int i = 0; i < 2; ++i) {
            const int w = i ^ first;
            if (!(w ? a.apply_k : a.apply_q)) continue;  // uniform
            stage_meta(w, d);
            const auto seg_relu = [&](float* dst) {
              return [=](int r, int cc, float v0, float v1) {
                if (r >= r0 && r < r1)
                  *reinterpret_cast<float2*>(dst + r * L::HS + cc) =
                      make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
              };
            };
            block_gemm<DM, HID, fit_nt(HID, 2)>(
                m0, m1,
                [&](int m, int k) { return sQKV[m * L::QS + w * DM + k]; },
                W1, seg_relu(sG));
            __syncthreads();
            if constexpr (HID2 > 0) {
              block_gemm<HID, HID2, fit_nt(HID2, 2)>(
                  m0, m1, [&](int m, int k) { return sG[m * L::HS + k]; },
                  Wm, seg_relu(sD));
              __syncthreads();
            }
            const float* sL = HID2 ? sD : sG;
            const unsigned sl = w ? salt.k : salt.q;
            block_gemm<HL, DM, fit_nt(DM, 2)>(
                m0, m1, [&](int m, int k) { return sL[m * L::HS + k]; },
                W2,
                [&](int r, int cc, float v0, float v1) {
                  if (r >= r0 && r < r1) {
                    if (a.drop.on) {
                      const int s = r / F, f = r - s * F;
                      const ExampleDraw& ed = hd.draws[s];
                      v0 *= ed.rows<DM>(a.drop, sl, f, cc);
                      v1 *= ed.rows<DM>(a.drop, sl, f, cc + 1);
                    }
                    const float2 t0 = *reinterpret_cast<const float2*>(
                        sQKV + r * L::QS + w * DM + cc);
                    *reinterpret_cast<float2*>(sU + r * L::US + w * DM +
                                               cc) =
                        make_float2(v0 + t0.x, v1 + t0.y);
                  }
                });
            __syncthreads();
          }
        });
      }

      // F3. q|k: the LayerNorms of the pre-LN sums (an untransformed
      //     projection copied through) -> sN; the light stash's
      //     probabilities recomputed from them into sG, the recompute
      //     modes' and o into sO (R4)
#pragma unroll
      for (int rb = 0; rb < L::ROWS; rb += L::kRowsAPass) {
        const int r = rb + tid / RT;
        const bool ok = r < R;
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          if (w ? a.apply_k : a.apply_q) {
            float v[4] = {0.f, 0.f, 0.f, 0.f};
            if (ok) to4(ld4(sU + r * L::US + w * DM + c), v);
            ln_xhat<DM>(v);
            const float* ln = w ? a.lnk : a.lnq;
            const float4 sc = ldg4(ln + c), bi = ldg4(ln + DM + c);
            const float nv[4] = {v[0] * sc.x + bi.x, v[1] * sc.y + bi.y,
                                 v[2] * sc.z + bi.z, v[3] * sc.w + bi.w};
            if (ok) st4(sN + r * L::NS + w * DM + c, nv);
          } else if (ok) {
            *reinterpret_cast<float4*>(sN + r * L::NS + w * DM + c) =
                ld4(sQKV + r * L::QS + w * DM + c);
          }
        }
      }
      __syncthreads();
      if constexpr (MODE == kLightStash) {
        for_pairs<NH>(n, F, [&](int s, int hh, int i) {
          attention_probs_pair<DM, NH>(sN + s * F * L::NS, L::NS,
                                       sG + s * NH * F * F, F, hh, i);
        });
        __syncthreads();
      } else if constexpr (RECOMPUTE) {
        for_pairs<NH>(n, F, [&](int s, int hh, int i) {
          attention_recompute_pair<DM, NH>(
              sN + s * F * L::NS, L::NS, sQKV + s * F * L::QS + 2 * DM,
              L::QS, sG + s * NH * F * F, sO + s * F * L::OS, L::OS, F, hh,
              i, AttnHash{a.drop, hd.draws[s], salt.s + hh});
        });
        __syncthreads();
      }

      // F5. zlin = o @ Wout (into dv's columns of sD, free until B2), u =
      //     relu?(zlin) m_z + x, y = LN_o(u); with g the outer LayerNorm's
      //     backward: du into sDU (the residual's share of dx) and dz =
      //     du m_z relu'(zlin) into sD's first DM columns
      block_gemm<DM, DM, fit_nt(DM, 2)>(
          0, mt, [&](int m, int k) { return sO[m * L::OS + k]; },
          [&](int k, int cc) { return sWout[k * L::WO + cc]; },
          [&](int r, int cc, float v0, float v1) {
            *reinterpret_cast<float2*>(sD + r * L::DS + 2 * DM + cc) =
                make_float2(v0, v1);
          });
      __syncthreads();
      {
        const float4 so = ldg4(a.lno + c);
#pragma unroll
        for (int rb = 0; rb < L::ROWS; rb += L::kRowsAPass) {
          const int r = rb + tid / RT;
          const bool ok = r < R;
          const int s = r / F, f = r - s * F;
          float z[4] = {0.f, 0.f, 0.f, 0.f}, v[4] = {0.f, 0.f, 0.f, 0.f};
          float mz[4] = {1.f, 1.f, 1.f, 1.f}, gv[4] = {0.f, 0.f, 0.f, 0.f};
          if (ok) {
            float xr[4];
            to4(ld4(sD + r * L::DS + 2 * DM + c), z);
            to4(ld4(sX + r * L::XS + c), xr);
            if (a.drop.on) {
              const ExampleDraw& ed = hd.draws[s];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                mz[j] = ed.rows<DM>(a.drop, salt.z, f, c + j);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[j] = (a.relu_out ? fmaxf(z[j], 0.f) : z[j]) * mz[j] + xr[j];
            to4(ldg4(a.g + (static_cast<size_t>(ex[s]) * F + f) * DM + c),
                gv);
          }
          const float inv = ln_xhat<DM>(v);
          if (ok) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              ln_acc[4][j] = fmaf(gv[j], v[j], ln_acc[4][j]);
              ln_acc[5][j] += gv[j];
            }
          }
          float du[4];
          ln_bwd<DM>(gv, v, inv, so, du);
          if (ok) {
            st4(sDU + r * L::XS + c, du);
            float dz[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              dz[j] = (a.relu_out && !(z[j] > 0.f)) ? 0.f : du[j] * mz[j];
            st4(sD + r * L::DS + c, dz);
          }
        }
      }
      __syncthreads();

      // B1. dWout += o^T dz, then do = dz @ Wout^T over o
      dwout.add(
          0, R, [&](int r, int m) { return sO[r * L::OS + m]; },
          [&](int r, int cc) { return sD[r * L::DS + cc]; });
      __syncthreads();
      block_gemm<DM, DM, fit_nt(DM, 2)>(
          0, mt, [&](int m, int k) { return sD[m * L::DS + k]; },
          [&](int k, int cc) { return sWout[cc * L::WO + k]; },
          [&](int r, int cc, float v0, float v1) {
            *reinterpret_cast<float2*>(sO + r * L::OS + cc) =
                make_float2(v0, v1);
          });
      __syncthreads();

      // B2. Attention backward, a thread a (head, row) pair in each pass:
      //     dv, then dS over P and dq, then dk, into sD
      for_pairs<NH>(n, F, [&](int s, int hh, int j) {
        attention_bwd_dv<DM, NH>(sG + s * NH * F * F, sO + s * F * L::OS,
                                 L::OS, sD + s * F * L::DS, L::DS, F, hh, j,
                                 AttnHash{a.drop, hd.draws[s], salt.s + hh});
      });
      __syncthreads();
      for_pairs<NH>(n, F, [&](int s, int hh, int i) {
        attention_bwd_dq<DM, NH>(
            sG + s * NH * F * F, sO + s * F * L::OS, L::OS,
            sQKV + s * F * L::QS + 2 * DM, L::QS, sN + s * F * L::NS, L::NS,
            sD + s * F * L::DS, L::DS, F, hh, i,
            AttnHash{a.drop, hd.draws[s], salt.s + hh});
      });
      __syncthreads();
      for_pairs<NH>(n, F, [&](int s, int hh, int j) {
        attention_bwd_dk<DM, NH>(sG + s * NH * F * F, sN + s * F * L::NS,
                                 L::NS, sD + s * F * L::DS, L::DS, F, hh, j);
      });
      __syncthreads();
      if (next) load(1, ex1, n1);  // o is read

      // B3a. The LayerNorm backwards of q and k: du over dq (dk) in sD, the
      //      residual's share of dt0, and dy = du m into sN (free since B2)
#pragma unroll
      for (int rb = 0; rb < L::ROWS; rb += L::kRowsAPass) {
        const int r = rb + tid / RT;
        const bool ok = r < R;
        const int s = r / F, f = r - s * F;
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          if (!(w ? a.apply_k : a.apply_q)) continue;  // uniform
          float dy[4] = {0.f, 0.f, 0.f, 0.f}, xh[4] = {0.f, 0.f, 0.f, 0.f};
          if (ok) {
            to4(ld4(sD + r * L::DS + w * DM + c), dy);
            to4(ld4(sU + r * L::US + w * DM + c), xh);
          }
          const float inv = ln_xhat<DM>(xh);
          if (ok) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              ln_acc[2 * w][j] = fmaf(dy[j], xh[j], ln_acc[2 * w][j]);
              ln_acc[2 * w + 1][j] += dy[j];
            }
          }
          float d[4];
          ln_bwd<DM>(dy, xh, inv, ldg4((w ? a.lnk : a.lnq) + c), d);
          if (ok) {
            st4(sD + r * L::DS + w * DM + c, d);
            if (a.drop.on) {
              const ExampleDraw& ed = hd.draws[s];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                d[j] *= ed.rows<DM>(a.drop, w ? salt.k : salt.q, f, c + j);
            }
            st4(sN + r * L::NS + w * DM + c, d);
          }
        }
      }
      __syncthreads();

      // B3. Per segment, the MetaNet backward of Q, then of K (JAX
      //     _meta_bwd, meta_block.py:869-899), the hidden layers recomputed
      //     on the segment's rows: h1 = t0 W1 into sG and (3-matrix) h2 =
      //     relu(h1) Wm into sU; with hL the layer W2 reads, dW2 +=
      //     relu(hL)^T dy and dhL = (dy W2^T) relu'(hL) over hL; (3-matrix)
      //     dWm += relu(h1)^T dh2 and dh1 = (dh2 Wm^T) relu'(h1) over h1;
      //     dW1 += t0^T dh1 and dt0 = du + dh1 W1^T over du.
      const auto meta_bwd = [&](int w, int d, int r0, int r1) {
        const int m0 = r0 / 16, m1 = (r1 + 15) / 16;
        // the row's gradient blocks of this MetaNet: kSlices' in the
        // block's slice, K7's and kSorted's in the output or, for a row
        // split with a neighbour, in the block's boundary slot
        float *out_w1, *out_wm, *out_w2;
        if (SPLIT && (d == head || d == tail)) {
          out_w1 = boundary_slot<SH>(a.bnd, blockIdx.x, d == tail) +
                   w * S::kMeta;
          out_wm = out_w1 + S::kW1;
          out_w2 = out_wm + S::kWm;
        } else {
          float* base = dom_out + static_cast<size_t>(w) * D * S::kMeta;
          out_w1 = base + static_cast<size_t>(d) * S::kW1;
          out_wm = base + D * S::kW1 + static_cast<size_t>(d) * S::kWm;
          out_w2 = base + D * (S::kW1 + S::kWm) +
                   static_cast<size_t>(d) * S::kW2;
        }
        // K7, kSorted: the row's first segment stores its sums, the next
        // ones add
        const bool store = SPLIT && flushed[w] != d;
        flushed[w] = d;
        const auto put = [&](auto& sums, float* dst) {
          if (store)
            sums.store(dst);
          else
            sums.flush(dst);
        };
        stage_meta(w, d);
        const auto in_seg = [=](int r) { return r >= r0 && r < r1; };
        block_gemm<DM, HID, fit_nt(HID, 2)>(
            m0, m1, [&](int m, int k) { return sQKV[m * L::QS + w * DM + k]; },
            W1,
            [&](int r, int cc, float v0, float v1) {
              if (in_seg(r))
                *reinterpret_cast<float2*>(sG + r * L::HS + cc) =
                    make_float2(v0, v1);
            });
        __syncthreads();
        if constexpr (HID2 > 0) {
          block_gemm<HID, HID2, fit_nt(HID2, 2)>(
              m0, m1,
              [&](int m, int k) { return fmaxf(sG[m * L::HS + k], 0.f); },
              Wm,
              [&](int r, int cc, float v0, float v1) {
                if (in_seg(r))
                  *reinterpret_cast<float2*>(sU + r * L::HS + cc) =
                      make_float2(v0, v1);
              });
          __syncthreads();
        }
        float* sL = HID2 ? sU : sG;  // hL, row stride HS
        const float* dy = sN + w * DM;
        {
          WTiles<HL, DM> dw2;  // the segment's sums, added once
          dw2.zero();
          dw2.add(
              r0, r1,
              [&](int r, int m) { return fmaxf(sL[r * L::HS + m], 0.f); },
              [&](int r, int cc) { return dy[r * L::NS + cc]; });
          put(dw2, out_w2);
        }
        __syncthreads();
        block_gemm<DM, HL, fit_nt(HL, 2)>(
            m0, m1, [&](int m, int k) { return dy[m * L::NS + k]; },
            [&](int k, int cc) { return W2(cc, k); },
            [&](int r, int cc, float v0, float v1) {
              if (in_seg(r)) {
                float2* p = reinterpret_cast<float2*>(sL + r * L::HS + cc);
                const float2 h = *p;
                *p = make_float2(h.x > 0.f ? v0 : 0.f, h.y > 0.f ? v1 : 0.f);
              }
            });
        __syncthreads();
        if constexpr (HID2 > 0) {
          WTiles<HID, HID2> dwm;
          dwm.zero();
          dwm.add(
              r0, r1,
              [&](int r, int m) { return fmaxf(sG[r * L::HS + m], 0.f); },
              [&](int r, int cc) { return sU[r * L::HS + cc]; });
          put(dwm, out_wm);
          __syncthreads();
          block_gemm<HID2, HID, fit_nt(HID, 2)>(
              m0, m1, [&](int m, int k) { return sU[m * L::HS + k]; },
              [&](int k, int cc) { return Wm(cc, k); },
              [&](int r, int cc, float v0, float v1) {
                if (in_seg(r)) {
                  float2* p = reinterpret_cast<float2*>(sG + r * L::HS + cc);
                  const float2 h = *p;
                  *p = make_float2(h.x > 0.f ? v0 : 0.f,
                                   h.y > 0.f ? v1 : 0.f);
                }
              });
          __syncthreads();
        }
        {
          WTiles<DM, HID> dw1;
          dw1.zero();
          dw1.add(
              r0, r1,
              [&](int r, int m) { return sQKV[r * L::QS + w * DM + m]; },
              [&](int r, int cc) { return sG[r * L::HS + cc]; });
          put(dw1, out_w1);
        }
        block_gemm<HID, DM, fit_nt(DM, 2)>(
            m0, m1, [&](int m, int k) { return sG[m * L::HS + k]; },
            [&](int k, int cc) { return W1(cc, k); },
            [&](int r, int cc, float v0, float v1) {
              if (in_seg(r)) {
                float2* p =
                    reinterpret_cast<float2*>(sD + r * L::DS + w * DM + cc);
                const float2 u = *p;
                *p = make_float2(u.x + v0, u.y + v1);
              }
            });
        __syncthreads();
      };
      for_segments(dm, n, F, [&](int d, int r0, int r1) {
        // the MetaNet whose block is staged goes first, as in the forward
        const int first = !one_table && staged == 2 * d + 1;
        for (int i = 0; i < 2; ++i) {
          const int w = i ^ first;
          if (w ? a.apply_k : a.apply_q) meta_bwd(w, d, r0, r1);
        }
      });
      fence_proxy_async();  // the TMA writes s over the threads' h1
      __syncthreads();
      if (next) load(2, ex1, n1);  // qkv, uq|uk, s are read

      // B4. dWqkv += x^T [dq0|dk0|dv]; dx = du + [dq0|dk0|dv] @ Wqkv^T
      dwqkv.add(
          0, R, [&](int r, int m) { return sX[r * L::XS + m]; },
          [&](int r, int cc) { return sD[r * L::DS + cc]; });
      block_gemm<3 * DM, DM, fit_nt(DM, 2)>(
          0, mt, [&](int m, int k) { return sD[m * L::DS + k]; },
          [&](int k, int cc) { return sWqkv[cc * L::WQ + k]; },
          [&](int r, int cc, float v0, float v1) {
            if (r < R) {
              const int s = r / F;
              const float2 u =
                  *reinterpret_cast<const float2*>(sDU + r * L::XS + cc);
              *reinterpret_cast<float2*>(
                  a.dx + (static_cast<size_t>(ex[s]) * F + r - s * F) * DM +
                  cc) = make_float2(v0 + u.x, v1 + u.y);
            }
          });
      __syncthreads();
      if (next) load(0, ex1, n1);  // x is read
    }
  }

  // The block's dense and LayerNorm sums into its slice (the MetaNet
  // blocks are in place): the LayerNorm sums of the threads holding the
  // same columns added in thread order.
  dwqkv.store(out);
  dwout.store(out + 3 * DM * DM);
  float* red = sQKV;  // the tile buffers are free now
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kLnRows; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) red[(tid * kLnRows + j) * 4 + k] = ln_acc[j][k];
  }
  __syncthreads();
  for (int o = tid; o < kLnRows * DM; o += kTT) {
    const int j = o / DM, col = o % DM, cg = col / 4, k = col % 4;
    float s = 0.f;
    for (int m = cg; m < kTT; m += RT)
      s += red[(m * kLnRows + j) * 4 + k];
    out[S::kDense + o] = s;
  }
}

// Element i of MetaNet w's blocks (W1 | Wm | W2) of row t in the gradient
// buffer's per-row part meta (K1's domains, K7's tiles; T rows).
template <class SH>
__device__ __forceinline__ float* meta_grad_at(float* meta, int T, int w,
                                               int t, int i) {
  using S = Strides<SH>;
  float* base = meta + static_cast<size_t>(w) * T * S::kMeta;
  const size_t tt = static_cast<size_t>(t);
  if (i < S::kW1) return base + tt * S::kW1 + i;
  i -= S::kW1;
  if (i < S::kWm) return base + T * S::kW1 + tt * S::kWm + i;
  return base + T * (S::kW1 + S::kWm) + tt * S::kW2 + (i - S::kWm);
}

// CUDA blocks [0, nsum) of the finishing passes: the grid blocks' dense and
// LayerNorm slices added in block order (sum_partials' loop).
template <class SH>
__device__ __forceinline__ void sum_dense(const StashBwdArgs& a, int blocks,
                                          int b) {
  const int total = grad_floats<SH>(0);
  const int i = b * blockDim.x + threadIdx.x;
  if (i < total) {
    float s = 0.f;
    for (int k = 0; k < blocks; ++k)
      s += a.partial[static_cast<size_t>(k) * total + i];
    a.grads[i] = s;
  }
}

// K7's last pass, one launch after the body: CUDA blocks [0, nsum) add the
// grid blocks' dense and LayerNorm slices in block order (sum_dense);
// then one for each dispatch tile t writes the zeros of the blocks of a
// MetaNet that is not applied or of a tile with no occupied slot, and of
// dx on the tile's slack slots; then one for each boundary between grid
// blocks b and b + 1 that splits a tile writes that tile's blocks: b's tail
// slot plus b + 1's head slot.
template <class SH>
__global__ void tiled_bwd_finish(const StashBwdArgs a, int blocks,
                                 int nsum) {
  using S = Strides<SH>;
  constexpr int DM = SH::DM;
  const int T = a.D;
  float* tile_out = a.grads + grad_floats<SH>(0);
  int b = blockIdx.x;
  if (b < nsum) {
    sum_dense<SH>(a, blocks, b);
    return;
  }
  b -= nsum;
  if (b < T) {
    const int cnt = tile_occupied(a.count, b, a.tile_b);
    for (int w = 0; w < 2; ++w) {
      if ((w ? a.apply_k : a.apply_q) && cnt > 0) continue;
      for (int i = threadIdx.x; i < S::kMeta; i += blockDim.x)
        *meta_grad_at<SH>(tile_out, T, w, b, i) = 0.f;
    }
    const int rows = a.F * DM / 4;  // float4s a slot
    float4* p = reinterpret_cast<float4*>(
        a.dx + (static_cast<size_t>(b) * a.tile_b + cnt) * a.F * DM);
    for (int i = threadIdx.x; i < (a.tile_b - cnt) * rows; i += blockDim.x)
      p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  b -= T;
  const int t = a.bnd_tile[b];
  if (t < 0) return;
  const float* tl = boundary_slot<SH>(a.bnd, b, 1);
  const float* hd = boundary_slot<SH>(a.bnd, b + 1, 0);
  for (int w = 0; w < 2; ++w) {
    if (!(w ? a.apply_k : a.apply_q)) continue;
    for (int i = threadIdx.x; i < S::kMeta; i += blockDim.x)
      *meta_grad_at<SH>(tile_out, T, w, t, i) =
          tl[w * S::kMeta + i] + hd[w * S::kMeta + i];
  }
}

// K1 kSorted's last pass, one launch after the body: CUDA blocks [0, nsum)
// add the grid blocks' dense and LayerNorm slices in block order; then
// finish_parts for each domain row d, each a span of kFinishSpan of the
// row's elements of both MetaNets' blocks, write zeros where a MetaNet is
// not applied or no example has row d, and where the grid split the row's
// run [start[d], start[d + 1]) between blocks b0 < b1, b0's tail slot
// plus the head slots of b0 + 1 .. b1 in block order (the owner of a
// whole run stored its sums in the body).  Spans, not a CUDA block a row:
// at d = 64 a row's blocks are 32k floats from about ten slots each.
constexpr int kFinishSpan = 1024;

template <class SH>
__host__ __device__ constexpr int finish_parts() {
  return (2 * Strides<SH>::kMeta + kFinishSpan - 1) / kFinishSpan;
}

template <class SH>
__global__ void sorted_bwd_finish(const StashBwdArgs a, int blocks,
                                  int nsum) {
  using S = Strides<SH>;
  if (static_cast<int>(blockIdx.x) < nsum) {
    sum_dense<SH>(a, blocks, blockIdx.x);
    return;
  }
  const int b = blockIdx.x - nsum, d = b / finish_parts<SH>();
  const int i0 = b % finish_parts<SH>() * kFinishSpan;
  const int i1 = min(i0 + kFinishSpan, 2 * S::kMeta);
  const int s0 = a.start[d], s1 = a.start[d + 1];
  const int b0 = s0 / a.chunk, b1 = (s1 - 1) / a.chunk;
  float* dom_out = a.grads + grad_floats<SH>(0);
  for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    const int w = i / S::kMeta;  // the slots hold Q's blocks, then K's
    const bool on = (w ? a.apply_k : a.apply_q) && s1 > s0;
    if (on && b0 == b1) continue;
    float v = 0.f;
    if (on) {
      v = boundary_slot<SH>(a.bnd, b0, 1)[i];
      for (int k = b0 + 1; k <= b1; ++k)
        v += boundary_slot<SH>(a.bnd, k, 0)[i];
    }
    *meta_grad_at<SH>(dom_out, a.D, w, d, i - w * S::kMeta) = v;
  }
}

// K7's scratch floats for a grid of blocks: the blocks' dense and
// LayerNorm slices, their two boundary slots, then their tail tiles (ints).
template <class SH>
__host__ __device__ size_t tiled_bwd_scratch_floats(int blocks) {
  return static_cast<size_t>(blocks) *
         (grad_floats<SH>(0) + 4 * Strides<SH>::kMeta + 1);
}

// K1 kSorted's sort of the batch by domain row: a stable counting sort in
// three launches of the port's own, on B ints.  Chunks of kSortChunk
// examples: each example's place among its row's examples in its chunk
// (rank), each chunk's count of each row (hist [C][D]), turned
// into the chunk's first sorted position of the row; then each example
// goes to hist[c][row] + rank.  Out-of-range ids are clamped to [0, D) as
// everywhere in K1.
constexpr int kSortChunk = 256;

struct RowSort {
  int *rank, *hist, *start, *perm, *skey;
};

// The sort's scratch ints: rank [B], hist [C][D], start [D + 1], perm [B]
// and skey [B].
__host__ __device__ inline size_t row_sort_ints(int B, int D) {
  const size_t C = (B + kSortChunk - 1) / kSortChunk;
  return 3 * static_cast<size_t>(B) + C * D + D + 1;
}

__host__ __device__ inline RowSort row_sort_scratch(int* p, int B, int D) {
  const size_t C = (B + kSortChunk - 1) / kSortChunk;
  RowSort s;
  s.rank = p;
  s.hist = s.rank + B;
  s.start = s.hist + C * D;
  s.perm = s.start + D + 1;
  s.skey = s.perm + B;
  return s;
}

__device__ __forceinline__ int clamped_row(const int* dom, int i, int D) {
  return min(max(__ldg(dom + i), 0), D - 1);
}

// Pass 1: a block a chunk, a thread an example.
__global__ void __launch_bounds__(kSortChunk)
    sort_rows_count(const int* dom, int B, int D, RowSort s) {
  __shared__ int key[kSortChunk];
  const int t = threadIdx.x, i = blockIdx.x * kSortChunk + t;
  const int k = i < B ? clamped_row(dom, i, D) : -1;
  key[t] = k;
  int* hist = s.hist + static_cast<size_t>(blockIdx.x) * D;
  for (int d = t; d < D; d += kSortChunk) hist[d] = 0;
  __syncthreads();
  if (k < 0) return;
  int before = 0;
  bool last = true;
  for (int j = 0; j < kSortChunk; ++j) {
    before += key[j] == k && j < t;
    last = last && !(key[j] == k && j > t);
  }
  s.rank[i] = before;
  if (last) hist[k] = before + 1;  // the chunk's count of row k
}

// Pass 2, one block: each row's count over the chunks (each thread a few
// consecutive rows), their exclusive prefix sum over the rows (start), and
// hist[c][d] turned into start[d] plus the count of row d in chunks before
// c.
constexpr int kSortScan = 1024;

__global__ void __launch_bounds__(kSortScan)
    sort_rows_offsets(int B, int D, int C, RowSort s) {
  __shared__ int part[kSortScan];
  const int t = threadIdx.x, per = (D + kSortScan - 1) / kSortScan;
  const int d0 = min(D, t * per), d1 = min(D, d0 + per);
  int sum = 0;
  for (int d = d0; d < d1; ++d) {
    int run = 0;
    for (int c = 0; c < C; ++c) {
      int* h = s.hist + static_cast<size_t>(c) * D + d;
      const int v = *h;
      *h = run;
      run += v;
    }
    s.start[d] = run;  // the row's count, for now
    sum += run;
  }
  part[t] = sum;
  __syncthreads();
  for (int o = 1; o < kSortScan; o <<= 1) {  // inclusive scan of part
    const int v = t >= o ? part[t - o] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int base = part[t] - sum;
  for (int d = d0; d < d1; ++d) {
    const int n = s.start[d];
    s.start[d] = base;
    for (int c = 0; c < C; ++c) s.hist[static_cast<size_t>(c) * D + d] += base;
    base += n;
  }
  if (t == 0) s.start[D] = B;
}

// Pass 3: a thread an example, to its sorted position.
__global__ void __launch_bounds__(kSortChunk)
    sort_rows_place(const int* dom, int B, int D, RowSort s) {
  const int i = blockIdx.x * kSortChunk + threadIdx.x;
  if (i >= B) return;
  const int k = clamped_row(dom, i, D);
  const int p = s.hist[static_cast<size_t>(blockIdx.x) * D + k] + s.rank[i];
  s.perm[p] = i;
  s.skey[p] = k;
}

// The three passes on the caller's stream.
inline cudaError_t sort_rows(const int* dom, int B, int D, RowSort s,
                             cudaStream_t stream) {
  const int C = (B + kSortChunk - 1) / kSortChunk;
  sort_rows_count<<<C, kSortChunk, 0, stream>>>(dom, B, D, s);
  sort_rows_offsets<<<1, kSortScan, 0, stream>>>(B, D, C, s);
  sort_rows_place<<<C, kSortChunk, 0, stream>>>(dom, B, D, s);
  return cudaGetLastError();
}

// K1 kSorted's scratch floats for a grid of blocks and B examples on D
// rows: the blocks' dense and LayerNorm slices, their two boundary slots,
// then the sort's ints.
template <class SH>
__host__ __device__ size_t sorted_bwd_scratch_floats(int blocks, int B,
                                                     int D) {
  return static_cast<size_t>(blocks) *
             (grad_floats<SH>(0) + 4 * Strides<SH>::kMeta) +
         row_sort_ints(B, D);
}

// The body and its last pass on the caller's stream (K1 kSorted: after
// sort_rows).  K1 takes at most slice_domains rows in kSlices and
// max_domains in kSorted.
template <class SH, int MODE, int WALK>
cudaError_t launch_stash_bwd(StashBwdArgs a, int blocks,
                             cudaStream_t stream) {
  auto kernel = meta_stash_bwd_kernel<SH, MODE, WALK>;
  const int smem = BwdTile<SH>::bytes(a.F);
  if (smem > kMaxSmem || (WALK == kSlices && a.D > slice_domains<SH>()) ||
      (WALK == kSorted && a.D > max_domains<SH>()))
    return cudaErrorInvalidValue;
  static int configured = 0;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  if (WALK != kTiles)
    a.chunk = block_chunk(a.B, a.F, blocks, BwdTile<SH>::ROWS);
  kernel<<<blocks, kTT, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nsum = (grad_floats<SH>(0) + 255) / 256;
  if constexpr (WALK == kTiles) {
    tiled_bwd_finish<SH><<<nsum + a.D + blocks - 1, 256, 0, stream>>>(
        a, blocks, nsum);
  } else if constexpr (WALK == kSorted) {
    sorted_bwd_finish<SH><<<nsum + a.D * finish_parts<SH>(), 256, 0,
                            stream>>>(a, blocks, nsum);
  } else {
    const int total = grad_floats<SH>(a.D);
    sum_partials<<<(total + 255) / 256, 256, 0, stream>>>(a.partial, a.grads,
                                                          total, blocks);
  }
  return cudaGetLastError();
}

}  // namespace
