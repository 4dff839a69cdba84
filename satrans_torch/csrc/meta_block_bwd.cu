// Backward of one SATrans meta-transformer layer, training, float32, with
// the in-kernel dropout: K1-bwd (the template below) and the C entries of
// the tile body csrc/meta_stash_bwd.cuh (K1-bwd-stash, K1-bwd-stash light,
// and K7-bwd-stash and K7-bwd on dispatched tiles, satrans_tiled_meta_bwd).
//
// Replaces two TPU kernels of satrans_tpu/ops/pallas/meta_block.py, both
// launched by _bwd_call through pl.pallas_call (with _attn_bwd_heads,
// _meta_bwd, _layer_norm_bwd and _write_param_grads): _bwd_kernel (:685;
// K1-bwd, the template below, the JAX package's bwd='recompute'), which
// recomputes the forward on chip, and _bwd_kernel_stash (:902) in its full
// mode (stash_s=True; K1-bwd-stash, kFullStash, its default bwd='stash'),
// which reads the residuals that K1-stash wrote and recomputes only the
// MetaNet hidden layers and zlin = o @ Wout, and in its light mode
// (stash_s=False; K1-bwd-stash light, kLightStash, bwd='stash_light'),
// which reads the residuals of K1-stash light and also recomputes the
// probabilities from the stashed pre-LN sums uq and uk with the forward's
// device code, so that they equal the forward's bit for bit.  The two
// stash modes run on the tile body of csrc/meta_stash_bwd.cuh (tiles of
// several examples sorted by domain, products on the tensor cores,
// per-domain gradients summed a segment at a time); the C entry below
// launches it for them.  Per example
// e with domain row dm = dom[e] and the dropout masks m of
// csrc/dropout.cuh (all ones without dropout) the forward is
//
//   q0|k0|v0 = x @ [Wq|Wk|Wv]
//   uq = (relu(q0 @ W1q[dm]) @ W2q[dm]) m_q + q0,  q = LN_q(uq)  if apply_q
//   uk = (relu(k0 @ W1k[dm]) @ W2k[dm]) m_k + k0,  k = LN_k(uk)  if apply_k
//   P = per head softmax(q k^T / sqrt(dh)),  o = (P m_s) v
//   y = LN_o(relu?(o @ Wout) m_z + x)
//
// and, given g = dL/dy, the kernel writes dx and the gradients of every
// operand: dWqkv [d, 3d], dWout [d, d], the LayerNorms' (scale, bias)
// rows for LN_q, LN_k and LN_o, and per-domain dW1q/dW1k [D, d, h] and
// dW2q/dW2k [D, h, d], each example adding only into its own domain's
// rows.  An unapplied projection passes its gradient straight through and
// its MetaNet gradients are zero.  The masks are regenerated in the
// forward's draw order at the mirror sites: the MetaNet output's gradient
// is du m (its residual keeps du), the probabilities' gradient dP m, dv
// takes P m, and dz = du m_z relu'.  K1-bwd's recomputed logits are
// clamped to [-60, 60] before the max-subtracted softmax, as the forward's
// (K1-bwd-stash reads the clamped forward's P); the gradient passes the
// clamp as if it were not there, as the Pallas custom VJP's does.
//
// What bounds it.  Per example at the AliCCP sota shapes (F=19, d=32,
// h=64, 4 heads, both MetaNets on) the recomputed forward is 0.51 MFLOP and
// the backward another 1.03 MFLOP against 7.3 kB of x, g and dx: K1-bwd is
// bound by float32 FMA throughput.  The design keeps every intermediate of
// an example on chip and reads x and g once and writes dx once.
//
// Design.  A block of 256 threads works on a tile of two examples at a
// time, 128 threads (four warps) on each, and walks over the batch's tiles
// with a grid stride; two blocks per SM, so that one block computes while
// the other waits at a barrier.  The per-example phases (the small
// GEMMs, the LayerNorms, attention) give a thread a register tile of 4
// columns x a few rows, as in the forward kernel; the phases meet at block
// barriers.  The parameter gradients are the hard part on a GPU: the TPU's
// grid runs in order and accumulates into its outputs step by step, while
// CUDA blocks run at once.  Here each block accumulates the gradients of
// every example it visits in sums of its own, each thread owning fixed
// elements, so no atomics are needed and the order of the sums is fixed:
// dWqkv and dWout in shared memory, the LayerNorm gradients in registers,
// and the per-domain dW1/dW2 (32,768 floats at D=4, too many to leave room
// for a second block in shared memory) in the block's slice of a scratch
// buffer in global memory, which stays in L2.  At the end each block
// writes the rest of its sums to its slice and a second small kernel adds
// the slices of all blocks in block order.  The result is deterministic
// for a given grid size.  Shared memory holds the dense sums and two
// examples' intermediates (x, q0|k0|v0, the normalised q|k and their
// xhat, the MetaNet hidden layer, the probabilities, the gradient rows):
// 95 kB at F=19.  The MetaNet hidden layer is recomputed in the backward instead
// of stored.
//
// 3-matrix MetaNets.  With units [d, h1, h2, d] (the template's HID2 > 0;
// the Pallas _meta_bwd at meta_block.py:869-899 and _write_param_grads
// :667) the MetaNet is relu(relu(t0 W1) Wm) W2, and its backward adds
// dh2 = (dy W2^T) [h2 > 0], dWm += relu(h1)^T dh2 and dh1 = (dh2 Wm^T)
// [h1 > 0].  The backward recomputes h2 (2 F h1 h2 FLOP a MetaNet) into a
// second hidden buffer of its own, 10.3 kB more shared memory at F=19
// (105.5 kB a block, two blocks an SM still fit), and the per-domain sums
// gain dWmq and dWmk [D][h1 h2]: 16,384 floats a domain a block for both
// MetaNets, 277 MB of scratch at D = kMaxDomains over 264 blocks.  As
// for 2-matrix MetaNets no residual is stashed for the hidden layers.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>

#include "layer_common.cuh"

namespace {

constexpr int kThreads = 256;                // two blocks per SM
constexpr int kTile = 2;                     // examples per block iteration
constexpr int kGroup = kThreads / kTile;     // threads per example
constexpr int kLnRows = 6;                   // LN_q, LN_k, LN_o x (scale, bias)
constexpr int kMaxSmem = 232448;             // bytes a block may use on sm_90
constexpr int kMaxDomains = 16;              // bounds the scratch buffer

// Row strides (floats) of the shared buffers; +4 shifts rows by 4 banks.
// The sizes of one domain's MetaNet blocks: W1 [d][h1], the middle Wm
// [h1][h2] (none for a 2-matrix MetaNet) and W2 [HL][d].
template <class SH>
struct Strides {
  static constexpr int DM = SH::DM;
  static constexpr int XS = DM + 4;       // x
  static constexpr int QS = 3 * DM + 4;   // q0|k0|v0, and dq|dk|dv
  static constexpr int NS = 2 * DM + 4;   // normalised q|k, their xhat
  static constexpr int HS = SH::HID + 4;  // MetaNet hidden h1; o and do
  static constexpr int H2S = SH::HID2 ? SH::HID2 + 4 : 0;  // hidden h2
  static constexpr int kDense = 4 * DM * DM;     // dWqkv then dWout
  static constexpr int kW1 = DM * SH::HID;
  static constexpr int kWm = SH::HID * SH::HID2;
  static constexpr int kW2 = SH::HL * DM;
  static constexpr int kMeta = kW1 + kWm + kW2;  // one MetaNet, one domain
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Floats of one tile's working buffers (also the end-of-kernel scratch).
template <class SH>
__host__ __device__ int work_floats(int F) {
  using S = Strides<SH>;
  const int R = kTile * F;
  const int n = R * (S::XS + S::QS + 2 * S::NS + S::HS + S::H2S + S::QS) +
                round4(2 * R) + kTile * SH::NH * F * F;
  return n > kThreads * kLnRows * 4 ? n : kThreads * kLnRows * 4;
}

template <class SH>
__host__ __device__ int smem_bytes(int F) {
  return sizeof(float) * (Strides<SH>::kDense + work_floats<SH>(F));
}

template <class SH>
__host__ __device__ int grad_floats(int D) {  // the block's partial sums
  return Strides<SH>::kDense + kLnRows * SH::DM +
         2 * D * Strides<SH>::kMeta;
}

struct Args {
  const float *x, *g, *wqkv, *wqkvT, *w1q, *wmq, *w2q, *w1qT, *wmqT, *w2qT,
      *lnq, *w1k, *wmk, *w2k, *w1kT, *wmkT, *w2kT, *lnk, *wout, *woutT, *lno;
  const int* dom;
  float *dx, *partial, *grads;
  int B, F, D, apply_q, apply_k, relu_out;
  Dropout drop;
};

template <class SH>
__global__ void __launch_bounds__(kThreads, 2)
meta_block_bwd_kernel(const Args a) {
  constexpr int DM = SH::DM, HID = SH::HID, HID2 = SH::HID2, NH = SH::NH;
  constexpr int HL = SH::HL;
  using S = Strides<SH>;
  using TD = Tile<DM, kGroup>;
  constexpr int DH = DM / NH;
  static_assert(DM % NH == 0 && DH % 4 == 0, "head width must be 4k");

  extern __shared__ float4 smem4[];
  const int t = threadIdx.x, slot = t / kGroup, gt = t % kGroup;
  const int F = a.F, D = a.D, R = kTile * F;

  // Shared: dWqkv [DM][3DM] | dWout [DM][DM] sums, then the tile's
  // working buffers, rows r = slot * F + f.  Global, the block's slice of
  // the scratch buffer: the dense and LayerNorm sums, then the per-domain
  // dW1q [D][kW1], dWmq [D][kWm], dW2q [D][kW2], and the same three of K
  // (no dWm blocks for a 2-matrix MetaNet).
  float* acc = reinterpret_cast<float*>(smem4);
  float* out = a.partial + static_cast<size_t>(blockIdx.x) *
                               grad_floats<SH>(D);
  float* acc_dom = out + S::kDense + kLnRows * DM;
  float* sX = acc + S::kDense;
  float* sQKV = sX + R * S::XS;
  float* sN = sQKV + R * S::QS;     // q|k after their LayerNorms
  float* sXH = sN + R * S::NS;      // xhat of those LayerNorms
  float* sINV = sXH + R * S::NS;    // their 1/sqrt(var + eps), [R][2]
  float* sH = sINV + round4(2 * R);
  float* sH2 = sH + R * S::HS;      // 3-matrix: the second hidden layer
  float* sP = sH2 + R * S::H2S;     // [kTile][NH][F][F]: P, then dS
  float* sD = sP + kTile * NH * F * F;  // dz, then dq|dk|dv
  for (int i = t; i < S::kDense; i += kThreads) acc[i] = 0.f;
  for (int i = t; i < 2 * D * S::kMeta; i += kThreads) acc_dom[i] = 0.f;

  float ln_acc[kLnRows][4];
#pragma unroll
  for (int j = 0; j < kLnRows; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) ln_acc[j][c] = 0.f;
  }
  const int cgd = gt % TD::LPR, rsd = gt / TD::LPR, cold = 4 * cgd;
  // a grid stride over the batch's tiles of two examples
  const int tiles = (a.B + kTile - 1) / kTile;
  const DropSalts salt(a.apply_q, a.apply_k, NH);
  __syncthreads();

#pragma unroll 1
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int e0 = tile * kTile;
    const int nvalid = min(kTile, a.B - e0);
    const int ex = e0 + slot;
    // live is uniform over the group's four whole warps, so the shuffles
    // inside stay full-warp
    const bool live = slot < nvalid;
    int doms[kTile];  // the domain rows of the tile's examples
#pragma unroll
    for (int e = 0; e < kTile; ++e)
      doms[e] = e >= nvalid ? 0 : min(max(a.dom[e0 + e], 0), D - 1);
    const int dm = doms[slot];
    float* X = sX + slot * F * S::XS;
    float* QKV = sQKV + slot * F * S::QS;
    float* Nm = sN + slot * F * S::NS;
    float* XH = sXH + slot * F * S::NS;
    float* INV = sINV + slot * F * 2;
    float* H = sH + slot * F * S::HS;  // also o, then do (stride HS)
    float* H2 = sH2 + slot * F * S::H2S;
    float* P = sP + slot * NH * F * F;
    float* Dg = sD + slot * F * S::QS;
    const size_t base = static_cast<size_t>(ex) * F * DM;
    const ExampleDraw ed(a.drop, ex);

    // F1. x -> shared
    if (live) {
      for (int i = gt; i < F * (DM / 4); i += kGroup) {
        const int f = i / (DM / 4), c = 4 * (i % (DM / 4));
        *reinterpret_cast<float4*>(X + f * S::XS + c) =
            ldg4(a.x + base + f * DM + c);
      }
    }
    __syncthreads();

    // F2. q0 | k0 | v0 = x @ [Wq | Wk | Wv]
    if (live) {
#pragma unroll 1
      for (int part = 0; part < 3; ++part) {
        float o[TD::RPL][4];
        tile_gemm<kGroup, DM, DM>(X, S::XS, a.wqkv + part * DM, 3 * DM, F,
                                  gt, o);
#pragma unroll
        for (int i = 0; i < TD::RPL; ++i) {
          const int f = rsd + TD::RS * i;
          if (f < F) st4(QKV + f * S::QS + part * DM + cold, o[i]);
        }
      }
    }
    __syncthreads();

    // F3. MetaNets on q0 and k0 with their dropout and LayerNorms -> N, XH,
    //     INV; an unapplied projection is copied through.
#pragma unroll 1
    for (int w = 0; w < 2; ++w) {
      const float* t0 = QKV + w * DM;
      const float* w1 = (w ? a.w1k : a.w1q) + static_cast<size_t>(dm) * S::kW1;
      const float* wm = (w ? a.wmk : a.wmq) + static_cast<size_t>(dm) * S::kWm;
      const float* w2 = (w ? a.w2k : a.w2q) + static_cast<size_t>(dm) * S::kW2;
      const float* ln = w ? a.lnk : a.lnq;
      if (!(w ? a.apply_k : a.apply_q)) {  // uniform branch
        if (live) {
          for (int i = gt; i < F * (DM / 4); i += kGroup) {
            const int f = i / (DM / 4), c = 4 * (i % (DM / 4));
            *reinterpret_cast<float4*>(Nm + f * S::NS + w * DM + c) =
                ld4(t0 + f * S::QS + c);
          }
        }
        continue;
      }
      float o[TD::RPL][4];  // the MetaNet output, masked
      // the hidden layers before their relus: h1 into H and, for a
      // 3-matrix MetaNet, h2 = relu(h1) @ Wm into H2
      if (live)
        metanet_matrix<kGroup, DM, HID, false, false>(t0, S::QS, w1, F, gt,
                                                      H, S::HS, [] {});
      __syncthreads();
      if constexpr (HID2 > 0) {
        if (live)
          metanet_matrix<kGroup, HID, HID2, true, false>(
              H, S::HS, wm, F, gt, H2, S::H2S, [] {});
        __syncthreads();
      }
      if (live) {
        tile_gemm<kGroup, HL, DM, true>(HID2 ? H2 : H,
                                        HID2 ? S::H2S : S::HS, w2, DM, F,
                                        gt, o);
        if (a.drop.on) {
          const unsigned sl = w ? salt.k : salt.q;
#pragma unroll
          for (int i = 0; i < TD::RPL; ++i) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              o[i][c] *= ed.rows<DM>(a.drop, sl, rsd + TD::RS * i, cold + c);
          }
        }
      }
      if (live) {
        const float4 sc = ldg4(ln + cold), bi = ldg4(ln + DM + cold);
#pragma unroll
        for (int i = 0; i < TD::RPL; ++i) {
          const int f = rsd + TD::RS * i;
          const bool ok = f < F;
          const float4 r = ok ? ld4(t0 + f * S::QS + cold)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
          float v[4] = {o[i][0] + r.x, o[i][1] + r.y, o[i][2] + r.z,
                        o[i][3] + r.w};
          const float inv = ln_xhat<DM>(v);
          if (ok) {
            st4(XH + f * S::NS + w * DM + cold, v);
            if (cgd == 0) INV[f * 2 + w] = inv;
            const float n[4] = {v[0] * sc.x + bi.x, v[1] * sc.y + bi.y,
                                v[2] * sc.z + bi.z, v[3] * sc.w + bi.w};
            st4(Nm + f * S::NS + w * DM + cold, n);
          }
        }
      }
      __syncthreads();
    }
    __syncthreads();  // the copy of an unapplied projection has none

    // F4. Attention: P (normalised, before dropout) and o = (P m_s) v
    //     into H.  A thread owns (head, query row) pairs.
    if (live) {
      attention_recompute<DM, NH, kGroup>(Nm, S::NS, QKV + 2 * DM, S::QS, P,
                                          H, S::HS, F, gt, a.drop, ed,
                                          salt.s);
    }
    __syncthreads();

    // F5. Output: zlin = o @ Wout, u = relu?(zlin) m_z + x, y = LN_o(u);
    //     with g the outer LayerNorm's backward: du (kept in registers, the
    //     residual's share of dx) and dz = du m_z relu'(zlin) into Dg.
    float du[TD::RPL][4];
#pragma unroll
    for (int i = 0; i < TD::RPL; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) du[i][c] = 0.f;
    }
    if (live) {
      float z[TD::RPL][4];
      tile_gemm<kGroup, DM, DM>(H, S::HS, a.wout, DM, F, gt, z);
      const float4 so = ldg4(a.lno + cold);
#pragma unroll
      for (int i = 0; i < TD::RPL; ++i) {
        const int f = rsd + TD::RS * i;
        const bool ok = f < F;
        const float4 xr = ok ? ld4(X + f * S::XS + cold)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        float mz[4] = {1.f, 1.f, 1.f, 1.f};
        if (a.drop.on) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            mz[c] = ed.rows<DM>(a.drop, salt.z, f, cold + c);
        }
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[c] = (a.relu_out ? fmaxf(z[i][c], 0.f) : z[i][c]) * mz[c];
        v[0] += xr.x;
        v[1] += xr.y;
        v[2] += xr.z;
        v[3] += xr.w;
        const float inv = ln_xhat<DM>(v);
        float gv[4] = {0.f, 0.f, 0.f, 0.f};
        if (ok) to4(ldg4(a.g + base + f * DM + cold), gv);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ln_acc[4][c] = fmaf(gv[c], v[c], ln_acc[4][c]);
          ln_acc[5][c] += gv[c];
        }
        ln_bwd<DM>(gv, v, inv, so, du[i]);
        if (ok) {
          float dz[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dz[c] = (a.relu_out && !(z[i][c] > 0.f)) ? 0.f
                                                      : du[i][c] * mz[c];
          st4(Dg + f * S::QS + cold, dz);
        }
      }
    }
    __syncthreads();

    // B1. dWout += o^T dz over the tile's rows, then do = dz @ Wout^T over o.
    wgrad<kThreads, DM, DM>(sH, S::HS, sD, S::QS, nvalid * F,
                            acc + 3 * DM * DM, DM, t);
    __syncthreads();
    if (live) {
      float o[TD::RPL][4];
      tile_gemm<kGroup, DM, DM>(Dg, S::QS, a.woutT, DM, F, gt, o);
#pragma unroll
      for (int i = 0; i < TD::RPL; ++i) {
        const int f = rsd + TD::RS * i;
        if (f < F) st4(H + f * S::HS + cold, o[i]);
      }
    }
    __syncthreads();

    // B2. Attention backward (csrc/layer_common.cuh): dv, then dS over P
    //     and dq, then dk, into Dg.
    attention_bwd<DM, NH, kGroup>(live, P, H, S::HS, QKV + 2 * DM, S::QS, Nm,
                                  S::NS, Dg, S::QS, F, gt, a.drop, ed, salt.s);

    // B3. MetaNet backward of Q, then of K (JAX _meta_bwd, meta_block.py:
    //     869-899): the LayerNorm backward gives du, kept in the
    //     projection's columns of N (free since B2), and dy = du m over dq
    //     (or dk); the hidden layers recomputed, h1 into H and (3-matrix)
    //     h2 = relu(h1) @ Wm into H2; with hL the layer W2 reads (h1, or
    //     h2), dW2[dm] += relu(hL)^T dy and dhL = (dy @ W2^T) relu'(hL) in
    //     place over hL; for a 3-matrix MetaNet then dWm[dm] += relu(h1)^T
    //     dh2 and dh1 = (dh2 @ Wm^T) relu'(h1) in place over H; then
    //     dW1[dm] += t0^T dh1 and dt0 = du + dh1 @ W1^T over dy.  An
    //     unapplied projection keeps its gradient as it is.
#pragma unroll 1
    for (int w = 0; w < 2; ++w) {
      if (!(w ? a.apply_k : a.apply_q)) continue;  // uniform branch
      float* dt = Dg + w * DM;
      const float* t0 = QKV + w * DM;
      const size_t d1 = static_cast<size_t>(dm) * S::kW1,
                   dmid = static_cast<size_t>(dm) * S::kWm,
                   d2 = static_cast<size_t>(dm) * S::kW2;
      const float* w1 = (w ? a.w1k : a.w1q) + d1;
      const float* w1T = (w ? a.w1kT : a.w1qT) + d1;
      const float* wm = (w ? a.wmk : a.wmq) + dmid;
      const float* wmT = (w ? a.wmkT : a.wmqT) + dmid;
      const float* w2T = (w ? a.w2kT : a.w2qT) + d2;
      float* acc_w1 = acc_dom + static_cast<size_t>(w) * D * S::kMeta;
      float* acc_wm = acc_w1 + D * S::kW1;
      float* acc_w2 = acc_wm + D * S::kWm;
      // the rows of the layer W2 reads, hL: h1 (H) or h2 (H2)
      constexpr int LS = HID2 ? S::H2S : S::HS;
      float* const sL = HID2 ? sH2 : sH;
      if (live) {
        const float4 sc = ldg4((w ? a.lnk : a.lnq) + cold);
#pragma unroll
        for (int i = 0; i < TD::RPL; ++i) {
          const int f = rsd + TD::RS * i;
          const bool ok = f < F;
          float dy[4] = {0.f, 0.f, 0.f, 0.f}, xh[4] = {0.f, 0.f, 0.f, 0.f};
          float inv = 0.f;
          if (ok) {
            to4(ld4(dt + f * S::QS + cold), dy);
            to4(ld4(XH + f * S::NS + w * DM + cold), xh);
            inv = INV[f * 2 + w];
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            ln_acc[2 * w][c] = fmaf(dy[c], xh[c], ln_acc[2 * w][c]);
            ln_acc[2 * w + 1][c] += dy[c];
          }
          float d[4];
          ln_bwd<DM>(dy, xh, inv, sc, d);
          if (ok) {
            st4(Nm + f * S::NS + w * DM + cold, d);
            if (a.drop.on) {
#pragma unroll
              for (int c = 0; c < 4; ++c)
                d[c] *= ed.rows<DM>(a.drop, w ? salt.k : salt.q, f, cold + c);
            }
            st4(dt + f * S::QS + cold, d);
          }
        }
        metanet_matrix<kGroup, DM, HID, false, false>(t0, S::QS, w1, F, gt,
                                                      H, S::HS, [] {});
      }
      __syncthreads();
      if constexpr (HID2 > 0) {
        if (live)
          metanet_matrix<kGroup, HID, HID2, true, false>(H, S::HS, wm, F, gt,
                                                         H2, S::H2S, [] {});
        __syncthreads();
      }
#pragma unroll 1
      for (int e = 0; e < nvalid; ++e)
        wgrad<kThreads, HL, DM, true>(sL + e * F * LS, LS,
                                      sD + e * F * S::QS + w * DM, S::QS, F,
                                      acc_w2 + doms[e] * S::kW2, DM, t);
      __syncthreads();
      if (live)
        metanet_matrix_bwd<kGroup, DM, HL>(dt, S::QS, w2T, F, gt,
                                           sL + slot * F * LS, LS);
      __syncthreads();
      if constexpr (HID2 > 0) {
#pragma unroll 1
        for (int e = 0; e < nvalid; ++e)
          wgrad<kThreads, HID, HID2, true>(sH + e * F * S::HS, S::HS,
                                           sH2 + e * F * S::H2S, S::H2S, F,
                                           acc_wm + doms[e] * S::kWm, HID2,
                                           t);
        __syncthreads();  // relu(h1) is read before dh1 overwrites it
        if (live)
          metanet_matrix_bwd<kGroup, HID2, HID>(H2, S::H2S, wmT, F, gt, H,
                                                S::HS);
        __syncthreads();
      }
#pragma unroll 1
      for (int e = 0; e < nvalid; ++e)
        wgrad<kThreads, DM, HID>(sQKV + e * F * S::QS + w * DM, S::QS,
                       sH + e * F * S::HS, S::HS, F,
                       acc_w1 + doms[e] * S::kW1, HID, t);
      if (live) {
        float o[TD::RPL][4];
        tile_gemm<kGroup, HID, DM>(H, S::HS, w1T, DM, F, gt, o);
#pragma unroll
        for (int i = 0; i < TD::RPL; ++i) {
          const int f = rsd + TD::RS * i;
          if (f < F) {
            const float4 r = ld4(Nm + f * S::NS + w * DM + cold);
            const float v[4] = {o[i][0] + r.x, o[i][1] + r.y, o[i][2] + r.z,
                                o[i][3] + r.w};
            st4(dt + f * S::QS + cold, v);
          }
        }
      }
      __syncthreads();
    }

    // B4. dWqkv += x^T [dq0|dk0|dv]; dx = du + [dq0|dk0|dv] @ Wqkv^T.
#pragma unroll 1
    for (int part = 0; part < 3; ++part)
      wgrad<kThreads, DM, DM>(sX, S::XS, sD + part * DM, S::QS, nvalid * F,
                    acc + part * DM, 3 * DM, t);
    if (live) {
      float o[TD::RPL][4];
      tile_gemm<kGroup, 3 * DM, DM>(Dg, S::QS, a.wqkvT, DM, F, gt, o);
#pragma unroll
      for (int i = 0; i < TD::RPL; ++i) {
        const int f = rsd + TD::RS * i;
        if (f < F) {
          const float v[4] = {o[i][0] + du[i][0], o[i][1] + du[i][1],
                              o[i][2] + du[i][2], o[i][3] + du[i][3]};
          st4(a.dx + base + f * DM + cold, v);
        }
      }
    }
    __syncthreads();
  }

  // The block's partial sums, laid out as the final gradient buffer:
  // dWqkv | dWout | LN_q, LN_k, LN_o (scale row, bias row) | dW1q | dWmq |
  // dW2q | dW1k | dWmk | dW2k (no dWm without a middle matrix), the
  // MetaNet blocks already in place.  The LayerNorm sums of
  // the threads holding the same columns are added in thread order.
  float* red = sX;  // the working buffers are free now
#pragma unroll
  for (int j = 0; j < kLnRows; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) red[(t * kLnRows + j) * 4 + c] = ln_acc[j][c];
  }
  __syncthreads();
  for (int o = t; o < kLnRows * DM; o += kThreads) {
    const int j = o / DM, col = o % DM, cg = col / 4, c = col % 4;
    float s = 0.f;
    for (int m = cg; m < kThreads; m += TD::LPR)
      s += red[(m * kLnRows + j) * 4 + c];
    out[S::kDense + o] = s;
  }
  for (int i = t; i < S::kDense; i += kThreads) out[i] = acc[i];
}

template <class SH>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  auto kernel = meta_block_bwd_kernel<SH>;
  const size_t smem = smem_bytes<SH>(a.F);
  if (smem > kMaxSmem || a.D > kMaxDomains) return cudaErrorInvalidValue;
  static size_t configured = 0;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = grad_floats<SH>(a.D);
  sum_partials<<<(total + 255) / 256, 256, 0, stream>>>(a.partial, a.grads,
                                                        total, blocks);
  return cudaGetLastError();
}

}  // namespace

#include "meta_stash_bwd.cuh"

// Shapes (d, h, h2, heads) instantiated here (with_shape, csrc/
// layer_common.cuh; h2 = 0 a 2-matrix MetaNet, whose middle pointers must
// be null).  partial holds blocks x satrans_meta_block_bwd_grad_floats(d,
// h, h2, heads, D) floats (two blocks per SM fill the card); grads
// receives the summed gradients in the layout written above.  Returns
// -1 for a shape not instantiated.
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

// The blocks K1-bwd-stash and K1-bwd-stash light use for B examples of F
// fields on a card of sms SMs (one an SM, at most one a tile): the partial
// buffer's block count for those modes.
extern "C" int satrans_meta_block_bwd_stash_blocks(int B, int F, int sms) {
  return stash_bwd_blocks(B, F, sms);
}

// The dynamic shared memory (bytes) of the tile body of K1-bwd-stash and
// K1-bwd-stash light at F fields; -1 for a shape not instantiated.
extern "C" int satrans_meta_block_bwd_stash_smem(int d, int h, int h2,
                                                 int heads, int F) {
  int n = -1;
  with_shape(d, h, h2, heads, [&](auto sh) {
    n = BwdTile<decltype(sh)>::bytes(F);
    return cudaSuccess;
  });
  return n;
}

// stash selects the body (enum StashMode), as the forward's did: K1-bwd
// (the template) with every residual pointer null, recomputing them;
// K1-bwd-stash (the tile body of csrc/meta_stash_bwd.cuh) reading the
// residuals qkv, uq, uk, s and o that K1-stash wrote; or K1-bwd-stash
// light (the same tile body) reading those of K1-stash light, s null
// (K1-scores has no backward: kScores is refused).  drop_on selects the
// dropout, with the operands of struct Dropout (csrc/dropout.cuh), the
// same as the forward's.  K1-bwd reads the weights' transposes wqkvT,
// woutT and the MetaNet matrices' per-row W1T [D, h, d], WmT [D, h2, h],
// W2T [D, d, HL]; the tile body reads the weights transposed in shared
// memory and ignores them (they may be null).  blocks is the grid: for
// the tile body satrans_meta_block_bwd_stash_blocks.  Returns a
// cudaError_t.
extern "C" int satrans_meta_block_bwd(
    const float* x, const int* dom, const float* g, const float* wqkv,
    const float* wqkvT, const float* w1q, const float* wmq, const float* w2q,
    const float* w1qT, const float* wmqT, const float* w2qT,
    const float* lnq, const float* w1k, const float* wmk, const float* w2k,
    const float* w1kT, const float* wmkT, const float* w2kT,
    const float* lnk, const float* wout, const float* woutT,
    const float* lno, float* dx, float* partial, float* grads,
    const float* qkv, const float* uq, const float* uk, const float* s,
    const float* o, int stash, int B, int F, int d, int h, int h2, int heads,
    int D, int apply_q, int apply_k, int relu_out, int blocks, int drop_on,
    unsigned seed, unsigned threshold, float scale, int block_b, int fpad,
    int group, void* stream) {
  if (B < 1 || F < 1 || F > kMaxFields || D < 1 || blocks < 1 ||
      stash == kScores)
    return static_cast<int>(cudaErrorInvalidValue);
  if (drop_on && (block_b < 1 || fpad < F || group < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!stash_pointers_ok(stash, qkv, uq, uk, s, o) ||
      !middle_pointers_ok(h2, {wmq, wmk}) ||
      (stash == kNoStash && !middle_pointers_ok(h2, {wmqT, wmkT})))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop{drop_on, seed, threshold, scale, block_b, fpad, group};
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  if (stash != kNoStash) {
    const StashBwdArgs t{x,  g,       wqkv,    lnq,      lnk,  wout,
                         lno, dom,    MetaW{w1q, wmq, w2q, w1k, wmk, w2k},
                         dx, partial, grads,   qkv,      uq,   uk,
                         s,  o,       B,       F,        D,    0,
                         apply_q,     apply_k, relu_out, drop};
    return static_cast<int>(with_shape(d, h, h2, heads, [&](auto sh) {
      using SH = decltype(sh);
      return stash == kFullStash
                 ? launch_stash_bwd<SH, kFullStash, false>(t, blocks, str)
                 : launch_stash_bwd<SH, kLightStash, false>(t, blocks, str);
    }));
  }
  const Args a{x,     g,    wqkv, wqkvT, w1q,  wmq,  w2q,  w1qT,
               wmqT,  w2qT, lnq,  w1k,   wmk,  w2k,  w1kT, wmkT,
               w2kT,  lnk,  wout, woutT, lno,  dom,  dx,   partial,
               grads, B,    F,    D,     apply_q, apply_k, relu_out, drop};
  return static_cast<int>(with_shape(d, h, h2, heads, [&](auto sh) {
    return launch<decltype(sh)>(a, blocks, str);
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
