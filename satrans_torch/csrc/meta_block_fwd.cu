// Forward of one SATrans meta-transformer layer, float32, with the
// in-kernel dropout of training.
//
// Replaces two TPU kernels of satrans_tpu/ops/pallas/meta_block.py, both
// launched by _fwd_call through pl.pallas_call on the body _fwd_compute:
// _fwd_kernel (:404; K1-fwd, the template below with MODE=kNoStash) and
// _fwd_kernel_stash (:420), which also writes the residuals its backward
// reads, in its full mode (stash_s=True; K1-stash, kFullStash), its light
// mode (stash_s=False; K1-stash light, kLightStash, the JAX package's
// bwd='stash_light') and as fused_meta_layer_with_scores (:502, the
// showattn / instattn probes: _fused_stash_forward :542 -> _fwd_call ->
// _fwd_kernel_stash with stash_s=True, whose [H, B/g, g F, g F] packed
// probabilities are unpacked per example outside the kernel; K1-scores,
// kScores, which writes y and P and no other residual).  Those three modes
// run on the tile body of csrc/meta_stash_fwd.cuh (tiles of several
// examples sorted by domain, products on the tensor cores); the C entry
// below launches it for them.  Per example e with domain row dm = dom[e]
// and dropout masks m (all ones without dropout):
//
//   q0|k0|v0 = x @ [Wq|Wk|Wv]
//   uq = (relu(q0 @ W1q[dm]) @ W2q[dm]) m_q + q0,  q = LN_q(uq)  if apply_q
//   uk = (relu(k0 @ W1k[dm]) @ W2k[dm]) m_k + k0,  k = LN_k(uk)  if apply_k
//   P = per head softmax(q k^T / sqrt(dh)),  o = (P m_s) v
//   y = LN_o(relu?(o @ Wout) m_z + x)
//
// (an unapplied projection is q = uq = q0).  A 3-matrix MetaNet (units
// [d, h1, h2, d], the template's HID2 > 0) puts its middle matrix between
// the two: relu(relu(q0 @ W1q[dm]) @ Wmq[dm]) @ W2q[dm], and likewise for
// K (the Pallas _meta_apply, meta_block.py:158-195, whose block-diagonal
// [D h1, D h2] packing of Wm is a TPU layout choice: a warp owns one
// example and reads its own domain's [h1, h2] block).  The second hidden
// row is formed in registers and written over the first, so the shared
// memory, and the two blocks an SM, stay as they are; no stash gains a
// residual.  K1-stash writes, float32 in
// per-example layout (not the TPU's [H, B/g, n, n] packing), qkv [B, F, 3d],
// uq and uk [B, F, d], the probabilities P [B, H, F, F] BEFORE dropout and
// o [B, F, d]; K1-stash light writes all but P, which its backward
// recomputes from uq and uk; K1-scores writes P alone, per example and cut
// to the real F (the JAX function's [B, H, F, F] return), by the same
// code as K1-stash, so the two P are equal bit for bit.  The masks come
// from csrc/dropout.cuh, computed inline per element.
//
// The logits are clamped to [-60, 60] before the softmax, as the Pallas
// kernel's _clip_logits does (meta_block.py:61-69), and the softmax then
// subtracts the row maximum (the Pallas kernel skips the max pass, which
// the clamp makes safe; the two agree up to rounding).
//
// TPU layout choices that are dropped here, none of which changes the
// result: masked wide GEMMs over all domains (each example reads its own
// W1[dm] and W2[dm], the [D, d, h] and [D, h, d] tables), F padded to a
// multiple of 8 (F is taken as it is; only the dropout masks count the
// padded fields, as the JAX kernel's draws do), block-diagonal attention
// packing with masked heads (each example's heads are computed directly),
// and B % block_b == 0 (the last, ragged tile is guarded).
//
// What bounds it.  Per example and layer at the AliCCP sota shapes
// (F=19, d=32, h=64, 4 heads, both MetaNets on) the arithmetic is about
// 0.5 MFLOP (QKV 117k, MetaNets 311k, attention 46k, output 39k) against
// 4.9 kB of activations in and out, about 100 FLOP per byte: K1-fwd is
// bound by float32 FMA throughput, not by device memory.  A 3-matrix
// MetaNet [32, 64, 64, 32] adds 2 F h1 h2 = 156k FLOP a MetaNet, 0.82
// MFLOP an example in all.  The template's design keeps every intermediate
// of an example on chip, in one warp's slice of shared memory, and feeds
// the FMA units from registers: one warp owns one example, each small GEMM
// gives a lane a 4-column x several-row register tile (all rows of one
// example share one weight matrix, so a weight load feeds every row the
// lane owns), the LayerNorms reduce across the 8 lanes of a row with
// shuffles, and the weights (under 150 kB for all four domains) are read
// through the L1/L2 caches with __ldg.  Device memory sees x once and y
// once.  (The stash modes' 20.4 kB of residuals an example, and their tile
// design, are csrc/meta_stash_fwd.cuh's.)
//
// K7.  The same template with TILED=true is K7-fwd (kNoStash) and
// K7-stash (kFullStash), which replace satrans_tpu/ops/pallas/
// tiled_meta.py's _fwd_kernel (:141) and _fwd_kernel_stash (:155), both
// launched by _fwd_call (:521) through pl.pallas_call (:546) on the body
// _fwd_compute (:92): the layer on a batch that ops/dispatch.py has
// sorted into single-domain tiles of tile_b slots, each tile with its own
// MetaNet weights.  The one difference is where an example's weights come
// from: row dm = slot / tile_b of the per-tile [T, d, h] and [T, h, d]
// blocks (gathered outside, table[tile_dom]) instead of row dom[e] of the
// per-domain tables.  A block's 8 slots lie in one tile when tile_b is a
// multiple of 8 (16 and 32 are the dispatch tiles), so the block reads one
// tile's weights, through L1.  Every other phase is K1's.  The JAX tiled
// kernel has no light stash, and the C entry refuses one.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

#include "layer_common.cuh"
#include "meta_stash_fwd.cuh"

namespace {

constexpr int kWarps = 8;       // examples per block, one warp each
template <int M>
using Mode = std::integral_constant<int, M>;  // a StashMode as a type
constexpr int kGroup = 32;      // threads per example

// Shared memory of one warp: F rows of q|k|v (stride QS), then F rows of
// scratch (stride HS) that holds x, the MetaNet hidden layers (a 3-matrix
// MetaNet's second over its first, in place) and the attention output in
// turn.  The +4 pads shift consecutive rows by four banks.
template <int DM, int HMAX>
struct Smem {
  static constexpr int QS = 3 * DM + 4;
  static constexpr int HS = HMAX + 4;
  static constexpr int XS = DM + 4;
  static constexpr int kRowFloats = QS + HS;
};

template <class SH, int MODE, bool TILED>
__global__ void __launch_bounds__(kWarps * 32, 2)
meta_block_fwd_kernel(const float* __restrict__ x, const int* __restrict__ dom,
                      const float* __restrict__ wqkv, const MetaW mw,
                      const float* __restrict__ lnq,
                      const float* __restrict__ lnk,
                      const float* __restrict__ wout,
                      const float* __restrict__ lno, float* __restrict__ y,
                      int B, int F, int D, int tile_b, int apply_q,
                      int apply_k, int relu_out, const Dropout drop,
                      const Stash st) {
  constexpr int DM = SH::DM, HID = SH::HID, HID2 = SH::HID2, NH = SH::NH;
  constexpr int HL = SH::HL;
  using S = Smem<DM, SH::HMAX>;
  using TD = Tile<DM, kGroup>;
  constexpr int DH = DM / NH;
  // K1-fwd and K7-fwd, or K7-stash: the residuals qkv, uq, uk, s and o
  constexpr bool STASH = MODE == kFullStash;
  static_assert(MODE == kNoStash || (MODE == kFullStash && TILED),
                "K1's stash bodies are meta_stash_fwd.cuh's");
  static_assert(DM % NH == 0 && DH % 4 == 0, "head width must be 4k");

  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + warp;
  if (e >= B) return;  // ragged last tile: the whole warp leaves
  float* sq = reinterpret_cast<float*>(smem4) + warp * F * S::kRowFloats;
  float* sh = sq + F * S::QS;
  const float* xe = x + static_cast<size_t>(e) * F * DM;
  float* ye = y + static_cast<size_t>(e) * F * DM;
  // the weights' row: K1 the example's domain, K7 its slot's tile
  const int dm = TILED ? min(e / tile_b, D - 1) : min(max(dom[e], 0), D - 1);
  const int cgd = lane % TD::LPR, rsd = lane / TD::LPR, cold = 4 * cgd;
  const ExampleDraw ed(drop, e);
  const DropSalts salt(apply_q, apply_k, NH);
  const size_t erow = static_cast<size_t>(e) * F;  // the example's first row

  // 1. x -> scratch
  for (int t = lane; t < F * (DM / 4); t += 32) {
    const int f = t / (DM / 4), c = 4 * (t % (DM / 4));
    *reinterpret_cast<float4*>(sh + f * S::XS + c) = ldg4(xe + f * DM + c);
  }
  __syncwarp();

  // 2. q0 | k0 | v0 = x @ [Wq | Wk | Wv]
#pragma unroll 1
  for (int part = 0; part < 3; ++part) {
    float acc[TD::RPL][4];
    tile_gemm<kGroup, DM, DM>(sh, S::XS, wqkv + part * DM, 3 * DM, F, lane,
                              acc);
#pragma unroll
    for (int i = 0; i < TD::RPL; ++i) {
      const int f = rsd + TD::RS * i;
      if (f < F) {
        st4(sq + f * S::QS + part * DM + cold, acc[i]);
        if (STASH)
          st4(st.qkv + (erow + f) * 3 * DM + part * DM + cold, acc[i]);
      }
    }
  }
  __syncwarp();

  // 3. MetaNet of the example's domain on q0, then on k0, each followed by
  //    the dropout, the residual and its LayerNorm, written over q0 / k0
  //    in place.  K1-stash keeps the pre-LN sum (q0 itself where the
  //    projection is not transformed).
#pragma unroll 1
  for (int which = 0; which < 2; ++which) {
    float* ures = which ? st.uk : st.uq;
    if (!(which == 0 ? apply_q : apply_k)) {  // uniform branch
      if (STASH) {
        for (int t = lane; t < F * (DM / 4); t += 32) {
          const int f = t / (DM / 4), c = 4 * (t % (DM / 4));
          *reinterpret_cast<float4*>(ures + (erow + f) * DM + c) =
              ld4(sq + f * S::QS + which * DM + c);
        }
      }
      continue;
    }
    const float* w1 =
        (which ? mw.w1k : mw.w1q) + static_cast<size_t>(dm) * DM * HID;
    const float* w2 =
        (which ? mw.w2k : mw.w2q) + static_cast<size_t>(dm) * HL * DM;
    float* t0 = sq + which * DM;
    // h1 = relu(t0 @ W1), and for a 3-matrix MetaNet h2 = relu(h1 @ Wm)
    // over it: every lane reads h1 before the barrier, h2 waits in
    // registers
    metanet_matrix<kGroup, DM, HID, false, true>(t0, S::QS, w1, F, lane, sh,
                                                 S::HS, [] {});
    __syncwarp();
    if constexpr (HID2 > 0) {
      const float* wm = (which ? mw.wmk : mw.wmq) +
                        static_cast<size_t>(dm) * HID * HID2;
      metanet_matrix<kGroup, HID, HID2, false, true>(
          sh, S::HS, wm, F, lane, sh, S::HS, [] { __syncwarp(); });
      __syncwarp();
    }
    {
      float acc[TD::RPL][4];
      tile_gemm<kGroup, HL, DM>(sh, S::HS, w2, DM, F, lane, acc);
#pragma unroll
      for (int i = 0; i < TD::RPL; ++i) {
        const int f = rsd + TD::RS * i;
        const bool ok = f < F;
        const float4 r = ok ? ld4(t0 + f * S::QS + cold)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        if (drop.on) {
          const unsigned sl = which ? salt.k : salt.q;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][c] *= ed.rows<DM>(drop, sl, f, cold + c);
        }
        float v[4] = {acc[i][0] + r.x, acc[i][1] + r.y, acc[i][2] + r.z,
                      acc[i][3] + r.w};
        if (STASH && ok) st4(ures + (erow + f) * DM + cold, v);
        row_layer_norm<DM>(v, which ? lnk : lnq, cold);
        if (ok) st4(t0 + f * S::QS + cold, v);
      }
    }
    __syncwarp();
  }

  // 4. Attention (csrc/layer_common.cuh).  The output goes to scratch
  //    columns [0, DM); K7-stash also writes it and P before dropout.
  attention_fwd<DM, NH, kGroup, STASH, STASH>(
      sq, S::QS, sh, S::HS,
      STASH ? st.s + static_cast<size_t>(e) * NH * F * F : nullptr,
      STASH ? st.o + erow * DM : nullptr, F, lane, drop, ed, salt.s);
  __syncwarp();

  // 5. y = LN_o(relu?(o @ Wout) m_z + x)
  {
    float acc[TD::RPL][4];
    tile_gemm<kGroup, DM, DM>(sh, S::HS, wout, DM, F, lane, acc);
#pragma unroll
    for (int i = 0; i < TD::RPL; ++i) {
      const int f = rsd + TD::RS * i;
      const bool ok = f < F;
      const float4 r = ok ? ldg4(xe + f * DM + cold)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = relu_out ? fmaxf(acc[i][c], 0.f) : acc[i][c];
        if (drop.on) v[c] *= ed.rows<DM>(drop, salt.z, f, cold + c);
      }
      v[0] += r.x;
      v[1] += r.y;
      v[2] += r.z;
      v[3] += r.w;
      row_layer_norm<DM>(v, lno, cold);
      if (ok) st4(ye + f * DM + cold, v);
    }
  }
}

template <class SH, int MODE, bool TILED>
cudaError_t launch(const float* x, const int* dom, const float* wqkv,
                   const MetaW& mw, const float* lnq, const float* lnk,
                   const float* wout, const float* lno, float* y, int B,
                   int F, int D, int tile_b, int apply_q, int apply_k,
                   int relu_out, const Dropout& drop, const Stash& st,
                   cudaStream_t stream) {
  using S = Smem<SH::DM, SH::HMAX>;
  auto kernel = meta_block_fwd_kernel<SH, MODE, TILED>;
  static bool configured = false;
  if (!configured) {
    const int most = kWarps * kMaxFields * S::kRowFloats * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const size_t smem =
      static_cast<size_t>(kWarps) * F * S::kRowFloats * sizeof(float);
  const int blocks = (B + kWarps - 1) / kWarps;
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      x, dom, wqkv, mw, lnq, lnk, wout, lno, y, B, F, D, tile_b, apply_q,
      apply_k, relu_out, drop, st);
  return cudaGetLastError();
}

}  // namespace

// Shapes (d, h, h2, heads) instantiated here (with_shape, csrc/
// layer_common.cuh; h2 = 0 is a 2-matrix MetaNet, whose middle pointers
// wmq and wmk are null; else the [D, h, h2] middle matrices).  stash
// selects the body (enum StashMode): K1-fwd (the template) with every
// residual pointer null; or the tile body of csrc/meta_stash_fwd.cuh as
// K1-stash writing the five residuals (each float32 as described above),
// K1-stash light writing all but s, which must be null, or K1-scores
// writing s [B, heads, F, F] alone (the other four null).  drop_on
// selects the dropout, with the operands of struct Dropout
// (csrc/dropout.cuh).  Returns a cudaError_t.
extern "C" int satrans_meta_block_fwd(
    const float* x, const int* dom, const float* wqkv, const float* w1q,
    const float* wmq, const float* w2q, const float* lnq, const float* w1k,
    const float* wmk, const float* w2k, const float* lnk, const float* wout,
    const float* lno, float* y, float* qkv, float* uq, float* uk, float* s,
    float* o, int stash, int B, int F, int d, int h, int h2, int heads,
    int D, int apply_q, int apply_k, int relu_out, int drop_on,
    unsigned seed, unsigned threshold, float scale, int block_b, int fpad,
    int group, void* stream) {
  if (B < 0 || F < 1 || F > kMaxFields || D < 1)
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
    if (stash == kNoStash)
      return launch<SH, kNoStash, false>(x, dom, wqkv, mw, lnq, lnk, wout,
                                         lno, y, B, F, D, 0, apply_q, apply_k,
                                         relu_out, drop, st, str);
    const StashFwdArgs a{x,  wqkv, lnq, lnk, wout, lno, dom, mw, y, st, B, F,
                         D,  0,    apply_q, apply_k, relu_out, drop};
    return stash == kFullStash
               ? launch_stash_fwd<SH, kFullStash>(a, str)
           : stash == kLightStash ? launch_stash_fwd<SH, kLightStash>(a, str)
                                  : launch_stash_fwd<SH, kScores>(a, str);
  }));
}

// The dynamic shared memory (bytes) of the tile body of K1-stash (stash
// kFullStash), K1-stash light or K1-scores at F fields; -1 for a shape not
// instantiated.
extern "C" int satrans_meta_block_fwd_stash_smem(int d, int h, int h2,
                                                 int heads, int F,
                                                 int stash) {
  int n = -1;
  with_shape(d, h, h2, heads, [&](auto sh) {
    n = FwdTile<decltype(sh)>::bytes(F, stash != kLightStash);
    return cudaSuccess;
  });
  return n;
}

// K7-fwd and K7-stash: the layer on n_slots = T * tile_b dispatched slots
// whose tile t reads row t of the per-tile weights w1q, w1k [T, d, h],
// wmq, wmk [T, h, h2] (null for h2 = 0) and w2q, w2k [T, h2 or h, d].
// stash is kNoStash (every residual pointer null) or
// kFullStash (all five set, as K1-stash's); the light stash and the
// scores are refused.
// The other operands and the dropout are K1's, with drop's block_b the
// dispatch tile.  Returns a cudaError_t.
extern "C" int satrans_tiled_meta_fwd(
    const float* x, const float* wqkv, const float* w1q, const float* wmq,
    const float* w2q, const float* lnq, const float* w1k, const float* wmk,
    const float* w2k, const float* lnk, const float* wout, const float* lno,
    float* y, float* qkv, float* uq, float* uk, float* s, float* o,
    int stash, int n_slots, int F, int d, int h, int h2, int heads, int T,
    int tile_b, int apply_q, int apply_k, int relu_out, int drop_on,
    unsigned seed, unsigned threshold, float scale, int block_b, int fpad,
    int group, void* stream) {
  if (n_slots < 0 || F < 1 || F > kMaxFields || T < 1 || tile_b < 1 ||
      n_slots != T * tile_b || stash == kLightStash || stash == kScores)
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
    const auto run = [&](auto mode) {
      return launch<SH, decltype(mode)::value, true>(
          x, nullptr, wqkv, mw, lnq, lnk, wout, lno, y, n_slots, F, T,
          tile_b, apply_q, apply_k, relu_out, drop, st, str);
    };
    return stash == kFullStash ? run(Mode<kFullStash>{})
                               : run(Mode<kNoStash>{});
  }));
}
