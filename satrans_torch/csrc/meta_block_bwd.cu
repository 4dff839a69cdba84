// Backward of one SATrans meta-transformer layer, training, float32, with
// the in-kernel dropout: the gradient layout and the C entries of the tile
// body csrc/meta_stash_bwd.cuh, which runs every mode of the layer
// backward: K1-bwd (kNoStash), K1-bwd-stash (kFullStash), K1-bwd-stash
// light (kLightStash), and with TILED K7-bwd and K7-bwd-stash on
// dispatched tiles (satrans_tiled_meta_bwd).
//
// Replaces two TPU kernels of satrans_tpu/ops/pallas/meta_block.py, both
// launched by _bwd_call (:1227) through pl.pallas_call (:1292; with
// _attn_bwd_heads, _meta_bwd, _layer_norm_bwd and _write_param_grads):
// _bwd_kernel (:685; K1-bwd, the JAX package's bwd='recompute'), which
// recomputes the forward on chip, and _bwd_kernel_stash (:902) in its full
// mode (stash_s=True; K1-bwd-stash, its default bwd='stash'), which reads
// the residuals that K1-stash wrote and recomputes only the MetaNet hidden
// layers and zlin = o @ Wout, and in its light mode (stash_s=False;
// K1-bwd-stash light, bwd='stash_light'), which reads the residuals of
// K1-stash light and also recomputes the probabilities from the stashed
// pre-LN sums uq and uk with the forward's device code, so that they equal
// the forward's bit for bit.  Per example e with domain row dm = dom[e]
// and the dropout masks m of csrc/dropout.cuh (all ones without dropout)
// the forward is
//
//   q0|k0|v0 = x @ [Wq|Wk|Wv]
//   uq = (relu(q0 @ W1q[dm]) @ W2q[dm]) m_q + q0,  q = LN_q(uq)  if apply_q
//   uk = (relu(k0 @ W1k[dm]) @ W2k[dm]) m_k + k0,  k = LN_k(uk)  if apply_k
//   P = per head softmax(q k^T / sqrt(dh)),  o = (P m_s) v
//   y = LN_o(relu?(o @ Wout) m_z + x)
//
// (a 3-matrix MetaNet [d, h1, h2, d] is relu(relu(t0 W1) Wm) W2) and,
// given g = dL/dy, the kernel writes dx and the gradients of every
// operand: dWqkv [d, 3d], dWout [d, d], the LayerNorms' (scale, bias) rows
// for LN_q, LN_k and LN_o, and per-domain dW1q/dW1k [D, d, h1], dWmq/dWmk
// [D, h1, h2] and dW2q/dW2k [D, hL, d], each example adding only into its
// own domain's rows.  An unapplied projection passes its gradient straight
// through and its MetaNet gradients are zero.  The masks are regenerated
// in the forward's draw order at the mirror sites: the MetaNet output's
// gradient is du m (its residual keeps du), the probabilities' gradient dP
// m, dv takes P m, and dz = du m_z relu'.  K1-bwd's recomputed logits are
// clamped to [-60, 60] before the max-subtracted softmax, as the
// forward's (K1-bwd-stash reads the clamped forward's P); the gradient
// passes the clamp as if it were not there, as the Pallas custom VJP's
// does.
//
// Each block sums the parameter gradients of the examples it visits in a
// slice of its own of the partial buffer, laid out as the final gradient
// buffer below, and sum_partials (csrc/layer_common.cuh) adds the slices
// in block order: deterministic for a grid, no atomics.  The tile body
// keeps a block's per-domain sums for at most kMaxDomains rows.
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the C entries return cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>

#include "layer_common.cuh"

namespace {

constexpr int kLnRows = 6;                   // LN_q, LN_k, LN_o x (scale, bias)
constexpr int kMaxSmem = 232448;             // bytes a block may use on sm_90
constexpr int kMaxDomains = 16;              // bounds a block's slice

// The sizes of one domain's MetaNet blocks: W1 [d][h1], the middle Wm
// [h1][h2] (none for a 2-matrix MetaNet) and W2 [HL][d].
template <class SH>
struct Strides {
  static constexpr int DM = SH::DM;
  static constexpr int kDense = 4 * DM * DM;     // dWqkv then dWout
  static constexpr int kW1 = DM * SH::HID;
  static constexpr int kWm = SH::HID * SH::HID2;
  static constexpr int kW2 = SH::HL * DM;
  static constexpr int kMeta = kW1 + kWm + kW2;  // one MetaNet, one domain
};

template <class SH>
__host__ __device__ int grad_floats(int D) {  // a block's partial sums
  return Strides<SH>::kDense + kLnRows * SH::DM +
         2 * D * Strides<SH>::kMeta;
}

}  // namespace

#include "meta_stash_bwd.cuh"

// Shapes (d, h, h2, heads) instantiated here (with_shape, csrc/
// layer_common.cuh; h2 = 0 a 2-matrix MetaNet, whose middle pointers must
// be null).  partial holds blocks x satrans_meta_block_bwd_grad_floats(d,
// h, h2, heads, D) floats; grads receives the summed gradients in the
// layout written above.  Returns -1 for a shape not instantiated.
extern "C" int satrans_meta_block_bwd_grad_floats(int d, int h, int h2,
                                                  int heads, int D) {
  int n = -1;
  with_shape(d, h, h2, heads, [&](auto sh) {
    n = grad_floats<decltype(sh)>(D);
    return cudaSuccess;
  });
  return n;
}

extern "C" int satrans_meta_block_bwd_max_domains() { return kMaxDomains; }

// The blocks K1's backwards use for B examples of F fields on a card of
// sms SMs (one an SM, at most one a tile): the grid of
// satrans_meta_block_bwd and the partial buffer's block count.
extern "C" int satrans_meta_block_bwd_stash_blocks(int B, int F, int sms) {
  return stash_bwd_blocks(B, F, sms);
}

// The dynamic shared memory (bytes) of the backward tile body at F fields,
// the same for every mode; -1 for a shape not instantiated.
extern "C" int satrans_meta_block_bwd_stash_smem(int d, int h, int h2,
                                                 int heads, int F) {
  int n = -1;
  with_shape(d, h, h2, heads, [&](auto sh) {
    n = BwdTile<decltype(sh)>::bytes(F);
    return cudaSuccess;
  });
  return n;
}

// K1's backwards, all on the tile body of csrc/meta_stash_bwd.cuh; stash
// selects the mode (enum StashMode), as the forward's did: K1-bwd
// (kNoStash) with every residual pointer null, recomputing the residuals
// on chip; K1-bwd-stash (kFullStash) reading the residuals qkv, uq, uk, s
// and o that K1-stash wrote; or K1-bwd-stash light (kLightStash) reading
// those of K1-stash light, s null (K1-scores has no backward: kScores is
// refused).  drop_on selects the dropout, with the operands of struct
// Dropout (csrc/dropout.cuh), the same as the forward's.  The body reads
// the weights transposed in shared memory where a product needs W^T.
// blocks is the grid (satrans_meta_block_bwd_stash_blocks for the card;
// fewer give each block a longer range); the result is deterministic for
// a grid.  Returns a cudaError_t.
extern "C" int satrans_meta_block_bwd(
    const float* x, const int* dom, const float* g, const float* wqkv,
    const float* w1q, const float* wmq, const float* w2q, const float* lnq,
    const float* w1k, const float* wmk, const float* w2k, const float* lnk,
    const float* wout, const float* lno, float* dx, float* partial,
    float* grads, const float* qkv, const float* uq, const float* uk,
    const float* s, const float* o, int stash, int B, int F, int d, int h,
    int h2, int heads, int D, int apply_q, int apply_k, int relu_out,
    int blocks, int drop_on, unsigned seed, unsigned threshold, float scale,
    int block_b, int fpad, int group, void* stream) {
  if (B < 1 || F < 1 || F > kMaxFields || D < 1 || blocks < 1 ||
      stash == kScores)
    return static_cast<int>(cudaErrorInvalidValue);
  if (drop_on && (block_b < 1 || fpad < F || group < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!stash_pointers_ok(stash, qkv, uq, uk, s, o) ||
      !middle_pointers_ok(h2, {wmq, wmk}))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop{drop_on, seed, threshold, scale, block_b, fpad, group};
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  const StashBwdArgs t{x,  g,       wqkv,    lnq,      lnk,  wout,
                       lno, dom,    MetaW{w1q, wmq, w2q, w1k, wmk, w2k},
                       dx, partial, grads,   qkv,      uq,   uk,
                       s,  o,       B,       F,        D,    0,
                       apply_q,     apply_k, relu_out, drop};
  return static_cast<int>(with_shape(d, h, h2, heads, [&](auto sh) {
    using SH = decltype(sh);
    switch (stash) {
      case kFullStash:
        return launch_stash_bwd<SH, kFullStash, false>(t, blocks, str);
      case kLightStash:
        return launch_stash_bwd<SH, kLightStash, false>(t, blocks, str);
      default:
        return launch_stash_bwd<SH, kNoStash, false>(t, blocks, str);
    }
  }));
}

// The floats of K7's scratch buffer for a grid of blocks; -1 for a shape
// not instantiated.
extern "C" int satrans_tiled_meta_bwd_scratch_floats(int d, int h, int h2,
                                                     int heads, int blocks) {
  int n = -1;
  with_shape(d, h, h2, heads, [&](auto sh) {
    n = static_cast<int>(tiled_bwd_scratch_floats<decltype(sh)>(blocks));
    return cudaSuccess;
  });
  return n;
}

// K7-bwd and K7-bwd-stash (the tile body of csrc/meta_stash_bwd.cuh with
// TILED): the backward of satrans_tiled_meta_fwd on n_slots = T * tile_b
// dispatched slots, with stash kNoStash (every residual pointer null,
// recomputing them) or kFullStash (the five residuals of K7-stash); the
// light stash is refused.  count [T] (int32, or null: every slot
// occupied) gives each tile's occupied slots, the first of the tile; the
// others must have a zero upstream gradient, get dx = 0 and add nothing.
// scratch holds satrans_tiled_meta_bwd_scratch_floats(d, h, h2, heads,
// blocks) floats (blocks the grid: one an SM for the card, fewer split
// more dispatch tiles between blocks, and blocks without occupied slots
// write zero sums); grads
// receives satrans_meta_block_bwd_grad_floats(d, h, h2, heads, T) floats
// in K1's layout with the T tiles in place of the domains, each tile's
// blocks its own.  Two launches: the body, then tiled_bwd_finish.
// Returns a cudaError_t.
extern "C" int satrans_tiled_meta_bwd(
    const float* x, const float* g, const float* wqkv, const float* w1q,
    const float* wmq, const float* w2q, const float* lnq, const float* w1k,
    const float* wmk, const float* w2k, const float* lnk, const float* wout,
    const float* lno, const int* count, float* dx, float* scratch,
    float* grads, const float* qkv, const float* uq, const float* uk,
    const float* s, const float* o, int stash, int n_slots, int F, int d,
    int h, int h2, int heads, int T, int tile_b, int apply_q, int apply_k,
    int relu_out, int blocks, int drop_on, unsigned seed, unsigned threshold,
    float scale, int block_b, int fpad, int group, void* stream) {
  if (n_slots < 1 || F < 1 || F > kMaxFields || T < 1 || tile_b < 1 ||
      n_slots != T * tile_b || blocks < 1 ||
      (stash != kNoStash && stash != kFullStash))
    return static_cast<int>(cudaErrorInvalidValue);
  if (drop_on && (block_b < 1 || fpad < F || group < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!stash_pointers_ok(stash, qkv, uq, uk, s, o) ||
      !middle_pointers_ok(h2, {wmq, wmk}))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop{drop_on, seed, threshold, scale, block_b, fpad, group};
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_shape(d, h, h2, heads, [&](auto sh) {
    using SH = decltype(sh);
    const size_t dense = static_cast<size_t>(blocks) * grad_floats<SH>(0);
    float* bnd = scratch + dense;
    int* bnd_tile = reinterpret_cast<int*>(
        bnd + static_cast<size_t>(blocks) * 4 * Strides<SH>::kMeta);
    const StashBwdArgs t{x,       g,        wqkv,    lnq,   lnk,  wout,
                         lno,     nullptr,  MetaW{w1q, wmq, w2q, w1k, wmk,
                                                  w2k},
                         dx,      scratch,  grads,   qkv,   uq,   uk,
                         s,       o,        n_slots, F,     T,    0,
                         apply_q, apply_k,  relu_out, drop, count, tile_b,
                         bnd,     bnd_tile};
    return stash == kFullStash
               ? launch_stash_bwd<SH, kFullStash, true>(t, blocks, str)
               : launch_stash_bwd<SH, kNoStash, true>(t, blocks, str);
  }));
}
