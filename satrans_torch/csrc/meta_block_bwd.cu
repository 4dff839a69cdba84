// Backward of one SATrans meta-transformer layer, training, float32, with
// the in-kernel dropout.
//
// Replaces two TPU kernels of satrans_tpu/ops/pallas/meta_block.py, both
// launched by _bwd_call through pl.pallas_call (with _attn_bwd_heads,
// _meta_bwd, _layer_norm_bwd and _write_param_grads): _bwd_kernel (:685;
// K1-bwd, the template's STASH=false, the JAX package's
// bwd='recompute'), which recomputes the forward on chip, and
// _bwd_kernel_stash (:902, full mode; K1-bwd-stash, STASH=true, its
// default bwd='stash'), which reads the residuals that K1-stash wrote
// (csrc/meta_block_fwd.cu) and recomputes only the MetaNet hidden layers
// and zlin = o @ Wout.  Per example e with domain row dm = dom[e] and the
// dropout masks m of csrc/dropout.cuh (all ones without dropout) the
// forward is
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
// takes P m, and dz = du m_z relu'.  The softmax subtracts the row
// maximum (the Pallas kernel's [-60, 60] logit clamp differs only beyond
// 60).
//
// What bounds it.  Per example at the AliCCP sota shapes (F=19, d=32,
// h=64, 4 heads, both MetaNets on) the recomputed forward is 0.51 MFLOP and
// the backward another 1.03 MFLOP against 7.3 kB of x, g and dx: K1-bwd is
// bound by float32 FMA throughput.  K1-bwd-stash reads 20.4 kB of
// residuals an example in place of 0.35 MFLOP of recompute (the QKV GEMM,
// the second MetaNet matrices, the attention forward), still bound by its
// arithmetic.  The design keeps every intermediate of an example on chip
// and reads x, g and each residual once and writes dx once.
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
// 95 kB at F=19, the same for both variants (K1-bwd-stash loads into the
// buffers K1-bwd computes into).  The MetaNet hidden layer is recomputed
// in the backward instead of stored.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>

#include "dropout.cuh"

namespace {

constexpr int kThreads = 256;                // two blocks per SM
constexpr int kTile = 2;                     // examples per block iteration
constexpr int kGroup = kThreads / kTile;     // threads per example
constexpr int kMaxFields = 20;               // most fields an example may have
constexpr int kLnRows = 6;                   // LN_q, LN_k, LN_o x (scale, bias)
constexpr int kMaxSmem = 232448;             // bytes a block may use on sm_90
constexpr int kMaxDomains = 16;              // bounds the scratch buffer

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void to4(float4 a, float (&v)[4]) {
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// Register tile of a group GEMM with N output columns: a thread of the
// example's 128 owns 4 adjacent columns of rows rs, rs + RS, ...
template <int N>
struct Tile {
  static_assert(N % 4 == 0 && kGroup % (N / 4) == 0, "unsupported width");
  static constexpr int LPR = N / 4;                       // threads per row
  static constexpr int RS = kGroup / LPR;                 // row sets
  static constexpr int RPL = (kMaxFields + RS - 1) / RS;  // rows per thread
};

// acc[i][c] = sum_k a(act[f][k]) * w[k][4 cg + c] for f = rs + RS i < F,
// a = relu if RELU else identity.  act lies in shared memory (row stride
// as), w in global memory (row stride ws).  The sum runs over k in order.
template <int K, int N, bool RELU = false>
__device__ __forceinline__ void group_gemm(const float* act, int as,
                                           const float* __restrict__ w,
                                           int ws, int F, int gt,
                                           float (&acc)[Tile<N>::RPL][4]) {
  using T = Tile<N>;
  const int cg = gt % T::LPR, rs = gt / T::LPR;
#pragma unroll
  for (int i = 0; i < T::RPL; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }
  const float* wc = w + 4 * cg;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 wk[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) wk[u] = ldg4(wc + (k + u) * ws);
#pragma unroll
    for (int i = 0; i < T::RPL; ++i) {
      const int f = rs + T::RS * i;
      if (f < F) {
        float a[4];
        to4(ld4(act + f * as + k), a);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float av = RELU ? fmaxf(a[u], 0.f) : a[u];
          acc[i][0] = fmaf(av, wk[u].x, acc[i][0]);
          acc[i][1] = fmaf(av, wk[u].y, acc[i][1]);
          acc[i][2] = fmaf(av, wk[u].z, acc[i][2]);
          acc[i][3] = fmaf(av, wk[u].w, acc[i][3]);
        }
      }
    }
  }
}

// Sum over the LPR consecutive lanes that hold one row.
template <int N>
__device__ __forceinline__ float row_sum(float s) {
#pragma unroll
  for (int o = Tile<N>::LPR / 2; o > 0; o >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// v -> xhat in place (eps 1e-6, two-pass moments, as the forward kernel);
// returns 1 / sqrt(var + eps).  Every lane of the warp must call it.
template <int N>
__device__ __forceinline__ float ln_xhat(float (&v)[4]) {
  const float mean = row_sum<N>((v[0] + v[1]) + (v[2] + v[3])) * (1.f / N);
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[c] -= mean;
    q = fmaf(v[c], v[c], q);
  }
  const float inv = rsqrtf(row_sum<N>(q) * (1.f / N) + 1e-6f);
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] *= inv;
  return inv;
}

// du for y = xhat * scale + bias given dy (the JAX _layer_norm_bwd):
// du = (gg - mean(gg) - xhat mean(gg xhat)) inv, gg = dy * scale.
template <int N>
__device__ __forceinline__ void ln_bwd(const float (&dy)[4],
                                       const float (&xh)[4], float inv,
                                       float4 scale, float (&du)[4]) {
  const float gg[4] = {dy[0] * scale.x, dy[1] * scale.y, dy[2] * scale.z,
                       dy[3] * scale.w};
  float m = (gg[0] + gg[1]) + (gg[2] + gg[3]);
  float mx = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) mx = fmaf(gg[c], xh[c], mx);
  m = row_sum<N>(m) * (1.f / N);
  mx = row_sum<N>(mx) * (1.f / N);
#pragma unroll
  for (int c = 0; c < 4; ++c) du[c] = (gg[c] - m - xh[c] * mx) * inv;
}

// Parameter-gradient accumulation over the whole block:
// acc[k][n] += sum_{r < R} a(A[r][k]) * G[r][n] (acc in shared or global
// memory, row stride accs) for the thread's own elements: columns 4 (t % (N/4)) .. +3 of rows
// t / (N/4) + KS j.  Each element has one owner, so the sums need no
// atomics and run in a fixed order.
template <int M, int N, bool RELU = false>
__device__ __forceinline__ void wgrad(const float* A, int as, const float* G,
                                      int gs, int R, float* acc, int accs,
                                      int t) {
  constexpr int CG = N / 4, KS = kThreads / CG, KPT = M / KS;
  static_assert(kThreads % CG == 0 && M % KS == 0, "unsupported shape");
  const int n = 4 * (t % CG), k0 = t / CG;
  float s[KPT][4];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
  }
#pragma unroll 2
  for (int r = 0; r < R; ++r) {
    const float4 gv = ld4(G + r * gs + n);
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      float a = A[r * as + k0 + KS * j];
      if (RELU) a = fmaxf(a, 0.f);
      s[j][0] = fmaf(a, gv.x, s[j][0]);
      s[j][1] = fmaf(a, gv.y, s[j][1]);
      s[j][2] = fmaf(a, gv.z, s[j][2]);
      s[j][3] = fmaf(a, gv.w, s[j][3]);
    }
  }
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    float* p = acc + (k0 + KS * j) * accs + n;
    float v[4];
    to4(ld4(p), v);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] += s[j][c];
    st4(p, v);
  }
}

// Row strides (floats) of the shared buffers; +4 shifts rows by 4 banks.
template <int DM, int HID>
struct Strides {
  static constexpr int XS = DM + 4;       // x
  static constexpr int QS = 3 * DM + 4;   // q0|k0|v0, and dq|dk|dv
  static constexpr int NS = 2 * DM + 4;   // normalised q|k, their xhat
  static constexpr int HS = HID + 4;      // MetaNet hidden; o and do
  static constexpr int kDense = 4 * DM * DM;     // dWqkv then dWout
  static constexpr int kDomain = DM * HID;       // one W1 or W2, one domain
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Floats of one tile's working buffers (also the end-of-kernel scratch).
template <int DM, int HID, int NH>
__host__ __device__ int work_floats(int F) {
  using S = Strides<DM, HID>;
  const int R = kTile * F;
  const int n = R * (S::XS + S::QS + 2 * S::NS + S::HS + S::QS) +
                round4(2 * R) + kTile * NH * F * F;
  return n > kThreads * kLnRows * 4 ? n : kThreads * kLnRows * 4;
}

template <int DM, int HID, int NH>
__host__ __device__ int smem_bytes(int F) {
  return sizeof(float) * (Strides<DM, HID>::kDense + work_floats<DM, HID, NH>(F));
}

template <int DM, int HID>
__host__ __device__ int grad_floats(int D) {  // the block's partial sums
  return Strides<DM, HID>::kDense + kLnRows * DM +
         4 * D * Strides<DM, HID>::kDomain;
}

struct Args {
  const float *x, *g, *wqkv, *wqkvT, *w1q, *w2q, *w1qT, *w2qT, *lnq, *w1k,
      *w2k, *w1kT, *w2kT, *lnk, *wout, *woutT, *lno;
  const int* dom;
  float *dx, *partial;
  int B, F, D, apply_q, apply_k, relu_out;
  // K1-stash's residuals (STASH only): qkv [B, F, 3d], uq, uk, o [B, F, d],
  // the probabilities before dropout s [B, H, F, F]
  const float *qkv, *uq, *uk, *s, *o;
  Dropout drop;
};

template <int DM, int HID, int NH, bool STASH>
__global__ void __launch_bounds__(kThreads, 2)
meta_block_bwd_kernel(const Args a) {
  using S = Strides<DM, HID>;
  using TD = Tile<DM>;
  using TH = Tile<HID>;
  constexpr int DH = DM / NH;
  static_assert(DM % NH == 0 && DH % 4 == 0, "head width must be 4k");

  extern __shared__ float4 smem4[];
  const int t = threadIdx.x, slot = t / kGroup, gt = t % kGroup;
  const int F = a.F, D = a.D, R = kTile * F;
  constexpr int dsz = S::kDomain;

  // Shared: dWqkv [DM][3DM] | dWout [DM][DM] sums, then the tile's
  // working buffers, rows r = slot * F + f.  Global, the block's slice of
  // the scratch buffer: the per-domain dW1q, dW2q, dW1k, dW2k sums, each
  // [D][DM*HID], after the dense and LayerNorm sums.
  float* acc = reinterpret_cast<float*>(smem4);
  float* out = a.partial + static_cast<size_t>(blockIdx.x) *
                               grad_floats<DM, HID>(D);
  float* acc_dom = out + S::kDense + kLnRows * DM;
  float* sX = acc + S::kDense;
  float* sQKV = sX + R * S::XS;
  float* sN = sQKV + R * S::QS;     // q|k after their LayerNorms
  float* sXH = sN + R * S::NS;      // xhat of those LayerNorms
  float* sINV = sXH + R * S::NS;    // their 1/sqrt(var + eps), [R][2]
  float* sH = sINV + round4(2 * R);
  float* sP = sH + R * S::HS;       // [kTile][NH][F][F]: P, then dS
  float* sD = sP + kTile * NH * F * F;  // dz, then dq|dk|dv
  for (int i = t; i < S::kDense; i += kThreads) acc[i] = 0.f;
  for (int i = t; i < 4 * D * dsz; i += kThreads) acc_dom[i] = 0.f;

  float ln_acc[kLnRows][4];
#pragma unroll
  for (int j = 0; j < kLnRows; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) ln_acc[j][c] = 0.f;
  }
  const int cgd = gt % TD::LPR, rsd = gt / TD::LPR, cold = 4 * cgd;
  const int cgh = gt % TH::LPR, rsh = gt / TH::LPR, colh = 4 * cgh;
  const float scale = 1.f / sqrtf(static_cast<float>(DH));
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
    int doms[kTile];
#pragma unroll
    for (int e = 0; e < kTile; ++e)
      doms[e] = e < nvalid ? min(max(a.dom[e0 + e], 0), D - 1) : 0;
    const int dm = doms[slot];
    float* X = sX + slot * F * S::XS;
    float* QKV = sQKV + slot * F * S::QS;
    float* Nm = sN + slot * F * S::NS;
    float* XH = sXH + slot * F * S::NS;
    float* INV = sINV + slot * F * 2;
    float* H = sH + slot * F * S::HS;  // also o, then do (stride HS)
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

    // F2. q0 | k0 | v0 = x @ [Wq | Wk | Wv], or their stash
    if (live && STASH) {
      for (int i = gt; i < F * (3 * DM / 4); i += kGroup) {
        const int f = i / (3 * DM / 4), c = 4 * (i % (3 * DM / 4));
        *reinterpret_cast<float4*>(QKV + f * S::QS + c) =
            ldg4(a.qkv + 3 * base + f * 3 * DM + c);
      }
    } else if (live) {
#pragma unroll 1
      for (int part = 0; part < 3; ++part) {
        float o[TD::RPL][4];
        group_gemm<DM, DM>(X, S::XS, a.wqkv + part * DM, 3 * DM, F, gt, o);
#pragma unroll
        for (int i = 0; i < TD::RPL; ++i) {
          const int f = rsd + TD::RS * i;
          if (f < F) st4(QKV + f * S::QS + part * DM + cold, o[i]);
        }
      }
    }
    __syncthreads();

    // F3. MetaNets on q0 and k0 with their dropout and LayerNorms (or the
    //     LayerNorms of the stashed pre-LN sums) -> N, XH, INV; an
    //     unapplied projection is copied through.
#pragma unroll 1
    for (int w = 0; w < 2; ++w) {
      const float* t0 = QKV + w * DM;
      const float* w1 = (w ? a.w1k : a.w1q) + static_cast<size_t>(dm) * dsz;
      const float* w2 = (w ? a.w2k : a.w2q) + static_cast<size_t>(dm) * dsz;
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
      if (live && !STASH) {
        float hd[TH::RPL][4];
        group_gemm<DM, HID>(t0, S::QS, w1, HID, F, gt, hd);
#pragma unroll
        for (int i = 0; i < TH::RPL; ++i) {
          const int f = rsh + TH::RS * i;
          if (f < F) st4(H + f * S::HS + colh, hd[i]);  // before the relu
        }
      }
      if (!STASH) __syncthreads();
      if (live && !STASH) {
        group_gemm<HID, DM, true>(H, S::HS, w2, DM, F, gt, o);
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
        const float* u = w ? a.uk : a.uq;
#pragma unroll
        for (int i = 0; i < TD::RPL; ++i) {
          const int f = rsd + TD::RS * i;
          const bool ok = f < F;
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          if (STASH) {
            if (ok) to4(ldg4(u + base + f * DM + cold), v);
          } else {
            const float4 r = ok ? ld4(t0 + f * S::QS + cold)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
            v[0] = o[i][0] + r.x;
            v[1] = o[i][1] + r.y;
            v[2] = o[i][2] + r.z;
            v[3] = o[i][3] + r.w;
          }
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
    //     into H, or their stash.  A thread owns (head, query row) pairs.
    if (live && STASH) {
      const float* se = a.s + static_cast<size_t>(ex) * NH * F * F;
      for (int i = gt; i < NH * F * F; i += kGroup) P[i] = __ldg(se + i);
      for (int i = gt; i < F * (DM / 4); i += kGroup) {
        const int f = i / (DM / 4), c = 4 * (i % (DM / 4));
        *reinterpret_cast<float4*>(H + f * S::HS + c) =
            ldg4(a.o + base + f * DM + c);
      }
    } else if (live) {
#pragma unroll 1
      for (int p = gt; p < NH * F; p += kGroup) {
        const int hh = p / F, i = p % F;
        float q[DH];
#pragma unroll
        for (int c = 0; c < DH; c += 4) {
          const float4 v = ld4(Nm + i * S::NS + hh * DH + c);
          q[c] = v.x * scale;
          q[c + 1] = v.y * scale;
          q[c + 2] = v.z * scale;
          q[c + 3] = v.w * scale;
        }
        float s[kMaxFields];
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < kMaxFields; ++j) {
          if (j < F) {
            const float* kj = Nm + j * S::NS + DM + hh * DH;
            float acc_s = 0.f;
#pragma unroll
            for (int c = 0; c < DH; c += 4) {
              const float4 v = ld4(kj + c);
              acc_s = fmaf(q[c], v.x, acc_s);
              acc_s = fmaf(q[c + 1], v.y, acc_s);
              acc_s = fmaf(q[c + 2], v.z, acc_s);
              acc_s = fmaf(q[c + 3], v.w, acc_s);
            }
            s[j] = acc_s;
            m = fmaxf(m, acc_s);
          }
        }
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxFields; ++j) {
          if (j < F) {
            s[j] = expf(s[j] - m);
            sum += s[j];
          }
        }
        const float inv = 1.f / sum;
        float o[DH];
#pragma unroll
        for (int c = 0; c < DH; ++c) o[c] = 0.f;
        float* prow = P + (hh * F + i) * F;
#pragma unroll
        for (int j = 0; j < kMaxFields; ++j) {
          if (j < F) {
            prow[j] = s[j] * inv;
            const float pj =
                a.drop.on ? prow[j] * ed.attn(a.drop, salt.s + hh, i, j)
                          : prow[j];
            const float* vj = QKV + j * S::QS + 2 * DM + hh * DH;
#pragma unroll
            for (int c = 0; c < DH; c += 4) {
              const float4 v = ld4(vj + c);
              o[c] = fmaf(pj, v.x, o[c]);
              o[c + 1] = fmaf(pj, v.y, o[c + 1]);
              o[c + 2] = fmaf(pj, v.z, o[c + 2]);
              o[c + 3] = fmaf(pj, v.w, o[c + 3]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < DH; c += 4) {
          const float v[4] = {o[c], o[c + 1], o[c + 2], o[c + 3]};
          st4(H + i * S::HS + hh * DH + c, v);
        }
      }
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
      group_gemm<DM, DM>(H, S::HS, a.wout, DM, F, gt, z);
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
    wgrad<DM, DM>(sH, S::HS, sD, S::QS, nvalid * F, acc + 3 * DM * DM, DM, t);
    __syncthreads();
    if (live) {
      float o[TD::RPL][4];
      group_gemm<DM, DM>(Dg, S::QS, a.woutT, DM, F, gt, o);
#pragma unroll
      for (int i = 0; i < TD::RPL; ++i) {
        const int f = rsd + TD::RS * i;
        if (f < F) st4(H + f * S::HS + cold, o[i]);
      }
    }
    __syncthreads();

    // B2. Attention backward.  dv_j = sum_i P_ij m_ij do_i, per (head, key
    //     row).
    if (live) {
#pragma unroll 1
      for (int p = gt; p < NH * F; p += kGroup) {
        const int hh = p / F, j = p % F;
        float dv[DH];
#pragma unroll
        for (int c = 0; c < DH; ++c) dv[c] = 0.f;
#pragma unroll 4
        for (int i = 0; i < F; ++i) {
          float pij = P[(hh * F + i) * F + j];
          if (a.drop.on) pij *= ed.attn(a.drop, salt.s + hh, i, j);
          const float* doi = H + i * S::HS + hh * DH;
#pragma unroll
          for (int c = 0; c < DH; c += 4) {
            const float4 v = ld4(doi + c);
            dv[c] = fmaf(pij, v.x, dv[c]);
            dv[c + 1] = fmaf(pij, v.y, dv[c + 1]);
            dv[c + 2] = fmaf(pij, v.z, dv[c + 2]);
            dv[c + 3] = fmaf(pij, v.w, dv[c + 3]);
          }
        }
#pragma unroll
        for (int c = 0; c < DH; c += 4) {
          const float v[4] = {dv[c], dv[c + 1], dv[c + 2], dv[c + 3]};
          st4(Dg + j * S::QS + 2 * DM + hh * DH + c, v);
        }
      }
    }
    __syncthreads();
    //     dS_ij = P_ij (dP_ij - sum_j P_ij dP_ij) with dP_ij = (do_i . v_j)
    //     m_ij, written over P; dq_i = scale sum_j dS_ij k_j, per (head,
    //     query row).
    if (live) {
#pragma unroll 1
      for (int p = gt; p < NH * F; p += kGroup) {
        const int hh = p / F, i = p % F;
        float doi[DH];
#pragma unroll
        for (int c = 0; c < DH; c += 4) {
          const float4 v = ld4(H + i * S::HS + hh * DH + c);
          doi[c] = v.x;
          doi[c + 1] = v.y;
          doi[c + 2] = v.z;
          doi[c + 3] = v.w;
        }
        float* prow = P + (hh * F + i) * F;
        float dp[kMaxFields];
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxFields; ++j) {
          if (j < F) {
            const float* vj = QKV + j * S::QS + 2 * DM + hh * DH;
            float s = 0.f;
#pragma unroll
            for (int c = 0; c < DH; c += 4) {
              const float4 v = ld4(vj + c);
              s = fmaf(doi[c], v.x, s);
              s = fmaf(doi[c + 1], v.y, s);
              s = fmaf(doi[c + 2], v.z, s);
              s = fmaf(doi[c + 3], v.w, s);
            }
            if (a.drop.on) s *= ed.attn(a.drop, salt.s + hh, i, j);
            dp[j] = s;
            rs = fmaf(prow[j], s, rs);
          }
        }
        float dq[DH];
#pragma unroll
        for (int c = 0; c < DH; ++c) dq[c] = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxFields; ++j) {
          if (j < F) {
            const float ds = prow[j] * (dp[j] - rs);
            prow[j] = ds;
            const float* kj = Nm + j * S::NS + DM + hh * DH;
#pragma unroll
            for (int c = 0; c < DH; c += 4) {
              const float4 v = ld4(kj + c);
              dq[c] = fmaf(ds, v.x, dq[c]);
              dq[c + 1] = fmaf(ds, v.y, dq[c + 1]);
              dq[c + 2] = fmaf(ds, v.z, dq[c + 2]);
              dq[c + 3] = fmaf(ds, v.w, dq[c + 3]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < DH; c += 4) {
          const float v[4] = {dq[c] * scale, dq[c + 1] * scale,
                              dq[c + 2] * scale, dq[c + 3] * scale};
          st4(Dg + i * S::QS + hh * DH + c, v);
        }
      }
    }
    __syncthreads();
    //     dk_j = scale sum_i dS_ij q_i, per (head, key row).
    if (live) {
#pragma unroll 1
      for (int p = gt; p < NH * F; p += kGroup) {
        const int hh = p / F, j = p % F;
        float dk[DH];
#pragma unroll
        for (int c = 0; c < DH; ++c) dk[c] = 0.f;
#pragma unroll 4
        for (int i = 0; i < F; ++i) {
          const float ds = P[(hh * F + i) * F + j];
          const float* qi = Nm + i * S::NS + hh * DH;
#pragma unroll
          for (int c = 0; c < DH; c += 4) {
            const float4 v = ld4(qi + c);
            dk[c] = fmaf(ds, v.x, dk[c]);
            dk[c + 1] = fmaf(ds, v.y, dk[c + 1]);
            dk[c + 2] = fmaf(ds, v.z, dk[c + 2]);
            dk[c + 3] = fmaf(ds, v.w, dk[c + 3]);
          }
        }
#pragma unroll
        for (int c = 0; c < DH; c += 4) {
          const float v[4] = {dk[c] * scale, dk[c + 1] * scale,
                              dk[c + 2] * scale, dk[c + 3] * scale};
          st4(Dg + j * S::QS + DM + hh * DH + c, v);
        }
      }
    }
    __syncthreads();

    // B3. MetaNet backward of Q, then of K (JAX _meta_bwd): the LayerNorm
    //     backward gives du, kept in the projection's columns of N (free
    //     since B2), and dy = du m over dq (or dk); the hidden layer
    //     recomputed into H, dW2[dm] += relu(hid)^T dy, dhid = (dy @ W2^T)
    //     relu'(hid) in place over H, dW1[dm] += t0^T dhid, dt0 = du +
    //     dhid @ W1^T over dy.  An unapplied projection keeps its gradient
    //     as it is.
#pragma unroll 1
    for (int w = 0; w < 2; ++w) {
      if (!(w ? a.apply_k : a.apply_q)) continue;  // uniform branch
      float* dt = Dg + w * DM;
      const float* t0 = QKV + w * DM;
      const float* w1 = (w ? a.w1k : a.w1q) + static_cast<size_t>(dm) * dsz;
      const float* w1T = (w ? a.w1kT : a.w1qT) + static_cast<size_t>(dm) * dsz;
      const float* w2T = (w ? a.w2kT : a.w2qT) + static_cast<size_t>(dm) * dsz;
      float* acc_w1 = acc_dom + 2 * w * D * dsz;
      float* acc_w2 = acc_w1 + D * dsz;
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
        float o[TH::RPL][4];
        group_gemm<DM, HID>(t0, S::QS, w1, HID, F, gt, o);
#pragma unroll
        for (int i = 0; i < TH::RPL; ++i) {
          const int f = rsh + TH::RS * i;
          if (f < F) st4(H + f * S::HS + colh, o[i]);
        }
      }
      __syncthreads();
#pragma unroll 1
      for (int e = 0; e < nvalid; ++e)
        wgrad<HID, DM, true>(sH + e * F * S::HS, S::HS,
                             sD + e * F * S::QS + w * DM, S::QS, F,
                             acc_w2 + doms[e] * dsz, DM, t);
      __syncthreads();
      if (live) {
        float o[TH::RPL][4];
        group_gemm<DM, HID>(dt, S::QS, w2T, HID, F, gt, o);
#pragma unroll
        for (int i = 0; i < TH::RPL; ++i) {
          const int f = rsh + TH::RS * i;
          if (f < F) {
            const float4 hv = ld4(H + f * S::HS + colh);
            const float v[4] = {hv.x > 0.f ? o[i][0] : 0.f,
                                hv.y > 0.f ? o[i][1] : 0.f,
                                hv.z > 0.f ? o[i][2] : 0.f,
                                hv.w > 0.f ? o[i][3] : 0.f};
            st4(H + f * S::HS + colh, v);
          }
        }
      }
      __syncthreads();
#pragma unroll 1
      for (int e = 0; e < nvalid; ++e)
        wgrad<DM, HID>(sQKV + e * F * S::QS + w * DM, S::QS,
                       sH + e * F * S::HS, S::HS, F,
                       acc_w1 + doms[e] * dsz, HID, t);
      if (live) {
        float o[TD::RPL][4];
        group_gemm<HID, DM>(H, S::HS, w1T, DM, F, gt, o);
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
      wgrad<DM, DM>(sX, S::XS, sD + part * DM, S::QS, nvalid * F,
                    acc + part * DM, 3 * DM, t);
    if (live) {
      float o[TD::RPL][4];
      group_gemm<3 * DM, DM>(Dg, S::QS, a.wqkvT, DM, F, gt, o);
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
  // dWqkv | dWout | LN_q, LN_k, LN_o (scale row, bias row) | dW1q | dW2q |
  // dW1k | dW2k, the last four already in place.  The LayerNorm sums of
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

// out[i] = sum over blocks b, in order, of partial[b][i].
__global__ void sum_partials(const float* __restrict__ partial,
                             float* __restrict__ out, int total, int blocks) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b)
      s += partial[static_cast<size_t>(b) * total + i];
    out[i] = s;
  }
}

template <int DM, int HID, int NH, bool STASH>
cudaError_t launch(const Args& a, float* grads, int blocks,
                   cudaStream_t stream) {
  auto kernel = meta_block_bwd_kernel<DM, HID, NH, STASH>;
  const size_t smem = smem_bytes<DM, HID, NH>(a.F);
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
  const int total = grad_floats<DM, HID>(a.D);
  sum_partials<<<(total + 255) / 256, 256, 0, stream>>>(a.partial, grads,
                                                        total, blocks);
  return cudaGetLastError();
}

}  // namespace

// Shapes (d, h, heads) instantiated here; ops/meta_block.py keeps the same
// list in KERNEL_SHAPES.  partial holds blocks x satrans_meta_block_bwd_
// grad_floats(d, h, D) floats (two blocks per SM fill the card); grads
// receives the summed gradients in the layout written above.  Returns a
// cudaError_t.
extern "C" int satrans_meta_block_bwd_grad_floats(int d, int h, int D) {
  if (d == 32 && h == 64) return grad_floats<32, 64>(D);
  return -1;
}

extern "C" int satrans_meta_block_bwd_max_domains() { return kMaxDomains; }

// With qkv non-null the launch is K1-bwd-stash, reading the residuals
// qkv, uq, uk, s and o that K1-stash wrote; else K1-bwd, recomputing them.
// drop_on selects the dropout, with the operands of struct Dropout
// (csrc/dropout.cuh), the same as the forward's.
extern "C" int satrans_meta_block_bwd(
    const float* x, const int* dom, const float* g, const float* wqkv,
    const float* wqkvT, const float* w1q, const float* w2q,
    const float* w1qT, const float* w2qT, const float* lnq, const float* w1k,
    const float* w2k, const float* w1kT, const float* w2kT, const float* lnk,
    const float* wout, const float* woutT, const float* lno, float* dx,
    float* partial, float* grads, const float* qkv, const float* uq,
    const float* uk, const float* s, const float* o, int B, int F, int d,
    int h, int heads, int D, int apply_q, int apply_k, int relu_out,
    int blocks, int drop_on, unsigned seed, unsigned threshold, float scale,
    int block_b, int fpad, int group, void* stream) {
  if (B < 1 || F < 1 || F > kMaxFields || D < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (drop_on && (block_b < 1 || fpad < F || group < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool stash = qkv != nullptr;
  if (stash && !(uq && uk && s && o))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,   g,    wqkv, wqkvT, w1q,  w2q,     w1qT, w2qT,
               lnq, w1k,  w2k,  w1kT,  w2kT, lnk,     wout, woutT,
               lno, dom,  dx,   partial, B,  F,       D,    apply_q,
               apply_k, relu_out, qkv, uq, uk, s, o,
               Dropout{drop_on, seed, threshold, scale, block_b, fpad,
                       group}};
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  if (d == 32 && h == 64 && heads == 4)
    return static_cast<int>(
        stash ? launch<32, 64, 4, true>(a, grads, blocks, str)
              : launch<32, 64, 4, false>(a, grads, blocks, str));
  return static_cast<int>(cudaErrorInvalidValue);
}
