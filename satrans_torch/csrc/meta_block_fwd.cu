// Forward of one SATrans meta-transformer layer, float32, with the
// in-kernel dropout of training: the C entries of K1's and K7's forward
// bodies.
//
// Replaces two TPU kernels of satrans_tpu/ops/pallas/meta_block.py, both
// launched by _fwd_call through pl.pallas_call on the body _fwd_compute:
// _fwd_kernel (:404; K1-fwd, kNoStash) and _fwd_kernel_stash (:420), which
// also writes the residuals its backward reads, in its full mode
// (stash_s=True; K1-stash, kFullStash), its light mode (stash_s=False;
// K1-stash light, kLightStash, the JAX package's bwd='stash_light') and as
// fused_meta_layer_with_scores (:502, the showattn / instattn probes:
// _fused_stash_forward :542 -> _fwd_call -> _fwd_kernel_stash with
// stash_s=True, whose [H, B/g, g F, g F] packed probabilities are unpacked
// per example outside the kernel; K1-scores, kScores, which writes y and P
// and no other residual).  All four run on the tile body of
// csrc/meta_stash_fwd.cuh (tiles of several examples sorted by domain,
// products on the tensor cores in 3xTF32), one mode each.  Per example e
// with domain row dm = dom[e] and dropout masks m (all ones without
// dropout):
//
//   q0|k0|v0 = x @ [Wq|Wk|Wv]
//   uq = (relu(q0 @ W1q[dm]) @ W2q[dm]) m_q + q0,  q = LN_q(uq)  if apply_q
//   uk = (relu(k0 @ W1k[dm]) @ W2k[dm]) m_k + k0,  k = LN_k(uk)  if apply_k
//   P = per head softmax(q k^T / sqrt(dh)),  o = (P m_s) v
//   y = LN_o(relu?(o @ Wout) m_z + x)
//
// (an unapplied projection is q = uq = q0).  A 3-matrix MetaNet (units
// [d, h1, h2, d], the body's HID2 > 0) puts its middle matrix between
// the two: relu(relu(q0 @ W1q[dm]) @ Wmq[dm]) @ W2q[dm], and likewise for
// K (the Pallas _meta_apply, meta_block.py:158-195, whose block-diagonal
// [D h1, D h2] packing of Wm is a TPU layout choice: a segment of one
// domain's rows reads its own [h1, h2] block).  K1-stash writes, float32 in
// per-example layout (not the TPU's [H, B/g, n, n] packing), qkv [B, F, 3d],
// uq and uk [B, F, d], the probabilities P [B, H, F, F] BEFORE dropout and
// o [B, F, d]; K1-stash light writes all but P, which its backward
// recomputes from uq and uk; K1-scores writes P alone, per example and cut
// to the real F (the JAX function's [B, H, F, F] return); K1-fwd writes y
// alone.  Every mode computes y, and the residuals it keeps, by the same
// code, so the modes' y (and K1-scores' and K1-stash's P) are equal bit for
// bit.  The masks come from csrc/dropout.cuh, computed inline per element.
//
// The logits are clamped to [-60, 60] before the softmax, as the Pallas
// kernel's _clip_logits does (meta_block.py:61-69), and the softmax then
// subtracts the row maximum (the Pallas kernel skips the max pass, which
// the clamp makes safe; the two agree up to rounding).
//
// TPU layout choices that are dropped here, none of which changes the
// result: masked wide GEMMs over all domains (each domain segment of a tile
// reads its own W1[dm] and W2[dm] of the [D, d, h] and [D, h, d] tables), F
// padded to a multiple of 8 (F is taken as it is; only the dropout masks
// count the padded fields, as the JAX kernel's draws do), block-diagonal
// attention packing with masked heads (each example's heads are computed
// directly), and B % block_b == 0 (the last, ragged tile is guarded).
//
// What bounds it.  Per example and layer at the AliCCP sota shapes
// (F=19, d=32, h=64, 4 heads, both MetaNets on) the arithmetic is about
// 0.5 MFLOP (QKV 117k, MetaNets 311k, attention 46k, output 39k) against
// 4.9 kB of activations in and out: K1-fwd is bound by its products, which
// run in 3xTF32 on the tensor cores (three TF32 mmas a product), not by
// device memory.  A 3-matrix MetaNet [32, 64, 64, 32] adds 2 F h1 h2 =
// 156k FLOP a MetaNet, 0.82 MFLOP an example in all.  The body's design
// is csrc/meta_stash_fwd.cuh's.
//
// K7.  The same body with TILED is K7-fwd (kNoStash) and K7-stash
// (kFullStash), which replace satrans_tpu/ops/pallas/tiled_meta.py's
// _fwd_kernel (:141) and _fwd_kernel_stash (:155), launched by _fwd_call
// (:521) through pl.pallas_call (:546) on the body _fwd_compute (:92): the
// layer on a batch that ops/dispatch.py has sorted into single-domain tiles
// of tile_b slots, each tile with its own MetaNet weights.  The one
// difference is where an example's weights come from: row t = slot /
// tile_b of the per-tile [T, d, h] and [T, h, d] blocks (gathered outside,
// table[tile_dom]) instead of row dom[e] of the per-domain tables; and
// the blocks walk the occupied slots alone where the dispatch's counts are
// given.  The JAX tiled kernel has no light stash and no scores, and the C
// entry refuses them.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include "meta_stash_fwd.cuh"

// The shape (d, h, h2, heads) this library is built for (with_shape, csrc/
// layer_common.cuh; h2 = 0 is a 2-matrix MetaNet, whose middle pointers
// wmq and wmk are null; else the [D, h, h2] middle matrices).  stash
// selects the mode of the tile body (enum StashMode): K1-fwd with every
// residual pointer null, K1-stash writing the five residuals (each float32
// as described above), K1-stash light writing all but s, which must be
// null, or K1-scores writing s [B, heads, F, F] alone (the other four
// null).  blocks bounds the grid (the SM count for the card; fewer give
// each block a longer range of the batch).  drop_on selects the dropout,
// with the operands of struct Dropout (csrc/dropout.cuh).  Returns a
// cudaError_t.
extern "C" int satrans_meta_block_fwd(
    const float* x, const int* dom, const float* wqkv, const float* w1q,
    const float* wmq, const float* w2q, const float* lnq, const float* w1k,
    const float* wmk, const float* w2k, const float* lnk, const float* wout,
    const float* lno, float* y, float* qkv, float* uq, float* uk, float* s,
    float* o, int stash, int B, int F, int d, int h, int h2, int heads,
    int D, int apply_q, int apply_k, int relu_out, int blocks, int drop_on,
    unsigned seed, unsigned threshold, float scale, int block_b, int fpad,
    int group, void* stream) {
  if (B < 0 || F < 1 || F > kMaxFields || D < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (drop_on && (block_b < 1 || fpad < F || group < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!stash_pointers_ok(stash, qkv, uq, uk, s, o) ||
      !middle_pointers_ok(h2, {wmq, wmk}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const Dropout drop{drop_on, seed, threshold, scale, block_b, fpad, group};
  const Stash st{qkv, uq, uk, s, o};
  const MetaW mw{w1q, wmq, w2q, w1k, wmk, w2k};
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_shape(d, h, h2, heads, [&](auto sh) {
    using SH = decltype(sh);
    const StashFwdArgs a{x,  wqkv, lnq, lnk, wout, lno, dom, mw, y, st, B, F,
                         D,  0,    apply_q, apply_k, relu_out, drop};
    switch (stash) {
      case kNoStash:
        return launch_stash_fwd<SH, kNoStash>(a, str, blocks);
      case kFullStash:
        return launch_stash_fwd<SH, kFullStash>(a, str, blocks);
      case kLightStash:
        return launch_stash_fwd<SH, kLightStash>(a, str, blocks);
      default:
        return launch_stash_fwd<SH, kScores>(a, str, blocks);
    }
  }));
}

// The dynamic shared memory (bytes) of the forward tile body in mode stash
// (K1-fwd, K1-stash, K1-stash light or K1-scores; with TILED K7-fwd and
// K7-stash take K1-fwd's and K1-stash's) at F fields, with one MetaNet
// region; -1 for a shape the library is not built for.
extern "C" int satrans_meta_block_fwd_stash_smem(int d, int h, int h2,
                                                 int heads, int F,
                                                 int stash) {
  int n = -1;
  with_shape(d, h, h2, heads, [&](auto sh) {
    n = FwdTile<decltype(sh)>::bytes(F,
                                     stash == kFullStash || stash == kScores);
    return cudaSuccess;
  });
  return n;
}

// K7-fwd and K7-stash: the layer on n_slots = T * tile_b dispatched slots
// whose tile t reads row t of the per-tile weights w1q, w1k [T, d, h],
// wmq, wmk [T, h, h2] (null for h2 = 0) and w2q, w2k [T, h2 or h, d].
// stash is kNoStash (K7-fwd; every residual pointer null) or kFullStash
// (K7-stash; all five set, as K1-stash's), both the forward tile body with
// TILED; the light stash and the scores are refused.  count [T] (int32, or
// null: every slot occupied) gives each tile's occupied slots, the first of
// the tile: both compute those alone and write zeros for y (and the
// residuals) of the others; blocks bounds the grid (the SM count for the
// card; fewer give each block a longer range).  The other operands and the
// dropout are K1's, with drop's block_b the dispatch tile.  Returns a
// cudaError_t.
extern "C" int satrans_tiled_meta_fwd(
    const float* x, const float* wqkv, const float* w1q, const float* wmq,
    const float* w2q, const float* lnq, const float* w1k, const float* wmk,
    const float* w2k, const float* lnk, const float* wout, const float* lno,
    const int* count, float* y, float* qkv, float* uq, float* uk, float* s,
    float* o, int stash, int n_slots, int F, int d, int h, int h2, int heads,
    int T,
    int tile_b, int apply_q, int apply_k, int relu_out, int blocks,
    int drop_on, unsigned seed, unsigned threshold, float scale, int block_b,
    int fpad, int group, void* stream) {
  if (n_slots < 0 || F < 1 || F > kMaxFields || T < 1 || tile_b < 1 ||
      n_slots != T * tile_b || blocks < 1 || stash == kLightStash ||
      stash == kScores)
    return static_cast<int>(cudaErrorInvalidValue);
  if (drop_on && (block_b < 1 || fpad < F || group < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!stash_pointers_ok(stash, qkv, uq, uk, s, o) ||
      !middle_pointers_ok(h2, {wmq, wmk}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots == 0) return static_cast<int>(cudaSuccess);
  const Dropout drop{drop_on, seed, threshold, scale, block_b, fpad, group};
  const Stash st{qkv, uq, uk, s, o};
  const MetaW mw{w1q, wmq, w2q, w1k, wmk, w2k};
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_shape(d, h, h2, heads, [&](auto sh) {
    using SH = decltype(sh);
    const StashFwdArgs a{x,       wqkv,    lnq,      lnk,  wout, lno,
                         nullptr, mw,      y,        st,   n_slots, F,
                         T,       0,       apply_q,  apply_k, relu_out,
                         drop,    0,       count,    tile_b};
    return stash == kNoStash
               ? launch_stash_fwd<SH, kNoStash, true>(a, str, blocks)
               : launch_stash_fwd<SH, kFullStash, true>(a, str, blocks);
  }));
}

// The forward tile body's layout at the library's shape: its tile rows,
// then whether Wqkv and Wout are staged split (1) or float32 (0), whether
// the MetaNet block is staged (1) or read from device memory (0), and x's
// buffers, as rows * 1000 + split * 100 + staged * 10 + buffers.
extern "C" int satrans_meta_block_fwd_plan() {
  using L = FwdTile<BuiltShape>;
  return L::ROWS * 1000 + L::kSplitDense * 100 + L::kStageMeta * 10 +
         L::kXBufs;
}
