// Forward of one SATrans meta-transformer layer, float32, with the
// in-kernel dropout of training.
//
// Replaces two TPU kernels of satrans_tpu/ops/pallas/meta_block.py, both
// launched by _fwd_call through pl.pallas_call on the body _fwd_compute:
// _fwd_kernel (:404; K1-fwd, the template's STASH=false) and
// _fwd_kernel_stash (:420, full mode; K1-stash, STASH=true), which also
// writes the residuals its backward reads.  Per example e with domain row
// dm = dom[e] and dropout masks m (all ones without dropout):
//
//   q0|k0|v0 = x @ [Wq|Wk|Wv]
//   uq = (relu(q0 @ W1q[dm]) @ W2q[dm]) m_q + q0,  q = LN_q(uq)  if apply_q
//   uk = (relu(k0 @ W1k[dm]) @ W2k[dm]) m_k + k0,  k = LN_k(uk)  if apply_k
//   P = per head softmax(q k^T / sqrt(dh)),  o = (P m_s) v
//   y = LN_o(relu?(o @ Wout) m_z + x)
//
// (an unapplied projection is q = uq = q0).  K1-stash writes, float32 in
// per-example layout (not the TPU's [H, B/g, n, n] packing), qkv [B, F, 3d],
// uq and uk [B, F, d], the probabilities P [B, H, F, F] BEFORE dropout and
// o [B, F, d].  The masks come from csrc/dropout.cuh, computed inline per
// element.
//
// The softmax subtracts the row maximum, as jax.nn.softmax does on the JAX
// package's XLA path and as the plain PyTorch version does.  The Pallas
// kernel instead clamps the logits to [-60, 60] and skips the max pass;
// the two agree unless a logit exceeds 60 in magnitude.
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
// bound by float32 FMA throughput (no tensor cores in this version), not
// by device memory.  K1-stash adds 20.4 kB of residual writes an example
// (the probabilities 5.8 kB of it), which at 3.35 TB/s take about as long
// as the arithmetic at the float32 peak.  The design therefore keeps every
// intermediate of an example on chip, in one warp's slice of shared
// memory, and feeds the FMA units from registers: one warp owns one
// example, each small GEMM gives a lane a 4-column x several-row register
// tile (all rows of one example share one weight matrix, so a weight load
// feeds every row the lane owns), the LayerNorms reduce across the 8 lanes
// of a row with shuffles, and the weights (under 150 kB for all four
// domains) are read through the L1/L2 caches with __ldg.  Device memory
// sees x once and y once, and each residual once.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>

#include "dropout.cuh"

namespace {

constexpr int kWarps = 8;      // examples per block, one warp each
constexpr int kMaxFields = 20; // most fields an example may have

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Register tile of a warp GEMM with N output columns: a lane owns 4
// adjacent columns of rows rs, rs + RS, rs + 2 RS, ...
template <int N>
struct Tile {
  static_assert(N % 4 == 0 && 32 % (N / 4) == 0, "unsupported width");
  static constexpr int LPR = N / 4;                       // lanes per row
  static constexpr int RS = 32 / LPR;                     // row sets
  static constexpr int RPL = (kMaxFields + RS - 1) / RS;  // rows per lane
};

// acc[i][c] = sum_k act[f][k] * w[k][4 cg + c] for f = rs + RS i < F.
// act lies in shared memory (row stride astride), w in global memory
// (row stride wstride).  The sum runs over k in order.
template <int K, int N>
__device__ __forceinline__ void warp_gemm(const float* act, int astride,
                                          const float* __restrict__ w,
                                          int wstride, int F, int lane,
                                          float (&acc)[Tile<N>::RPL][4]) {
  using T = Tile<N>;
  const int cg = lane % T::LPR, rs = lane / T::LPR;
#pragma unroll
  for (int i = 0; i < T::RPL; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }
  const float* wc = w + 4 * cg;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    const float4 w0 = ldg4(wc + (k + 0) * wstride);
    const float4 w1 = ldg4(wc + (k + 1) * wstride);
    const float4 w2 = ldg4(wc + (k + 2) * wstride);
    const float4 w3 = ldg4(wc + (k + 3) * wstride);
#pragma unroll
    for (int i = 0; i < T::RPL; ++i) {
      const int f = rs + T::RS * i;
      if (f < F) {
        const float4 a = ld4(act + f * astride + k);
        acc[i][0] = fmaf(a.x, w0.x, acc[i][0]);
        acc[i][1] = fmaf(a.x, w0.y, acc[i][1]);
        acc[i][2] = fmaf(a.x, w0.z, acc[i][2]);
        acc[i][3] = fmaf(a.x, w0.w, acc[i][3]);
        acc[i][0] = fmaf(a.y, w1.x, acc[i][0]);
        acc[i][1] = fmaf(a.y, w1.y, acc[i][1]);
        acc[i][2] = fmaf(a.y, w1.z, acc[i][2]);
        acc[i][3] = fmaf(a.y, w1.w, acc[i][3]);
        acc[i][0] = fmaf(a.z, w2.x, acc[i][0]);
        acc[i][1] = fmaf(a.z, w2.y, acc[i][1]);
        acc[i][2] = fmaf(a.z, w2.z, acc[i][2]);
        acc[i][3] = fmaf(a.z, w2.w, acc[i][3]);
        acc[i][0] = fmaf(a.w, w3.x, acc[i][0]);
        acc[i][1] = fmaf(a.w, w3.y, acc[i][1]);
        acc[i][2] = fmaf(a.w, w3.z, acc[i][2]);
        acc[i][3] = fmaf(a.w, w3.w, acc[i][3]);
      }
    }
  }
}

// LayerNorm (eps 1e-6, two-pass moments) of a row of N values spread over
// the LPR lanes of its row set, 4 per lane at columns col..col+3.  ln holds
// the scale row then the bias row.  Every lane of the warp must call it.
template <int N>
__device__ __forceinline__ void row_layer_norm(float (&v)[4],
                                               const float* __restrict__ ln,
                                               int col) {
  float s = (v[0] + v[1]) + (v[2] + v[3]);
#pragma unroll
  for (int o = Tile<N>::LPR / 2; o > 0; o >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s * (1.f / N);
  float dv[4];
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    dv[c] = v[c] - mean;
    q = fmaf(dv[c], dv[c], q);
  }
#pragma unroll
  for (int o = Tile<N>::LPR / 2; o > 0; o >>= 1)
    q += __shfl_xor_sync(0xffffffffu, q, o);
  const float inv = rsqrtf(q * (1.f / N) + 1e-6f);
  const float4 g = ldg4(ln + col), b = ldg4(ln + N + col);
  v[0] = dv[0] * inv * g.x + b.x;
  v[1] = dv[1] * inv * g.y + b.y;
  v[2] = dv[2] * inv * g.z + b.z;
  v[3] = dv[3] * inv * g.w + b.w;
}

// Shared memory of one warp: F rows of q|k|v (stride QS), then F rows of
// scratch (stride HS) that holds x, the MetaNet hidden layer and the
// attention output in turn.  The +4 pads shift consecutive rows by four
// banks.
template <int DM, int HID>
struct Smem {
  static constexpr int QS = 3 * DM + 4;
  static constexpr int HS = HID + 4;
  static constexpr int XS = DM + 4;
  static constexpr int kRowFloats = QS + HS;
};

// K1-stash's residuals, per example (unused when STASH is false).
struct Stash {
  float *qkv, *uq, *uk, *s, *o;
};

template <int DM, int HID, int NH, bool STASH>
__global__ void __launch_bounds__(kWarps * 32, 2)
meta_block_fwd_kernel(const float* __restrict__ x, const int* __restrict__ dom,
                      const float* __restrict__ wqkv,
                      const float* __restrict__ w1q,
                      const float* __restrict__ w2q,
                      const float* __restrict__ lnq,
                      const float* __restrict__ w1k,
                      const float* __restrict__ w2k,
                      const float* __restrict__ lnk,
                      const float* __restrict__ wout,
                      const float* __restrict__ lno, float* __restrict__ y,
                      int B, int F, int D, int apply_q, int apply_k,
                      int relu_out, const Dropout drop, const Stash st) {
  using S = Smem<DM, HID>;
  using TD = Tile<DM>;
  using TH = Tile<HID>;
  constexpr int DH = DM / NH;
  static_assert(DM % NH == 0 && DH % 4 == 0, "head width must be 4k");

  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + warp;
  if (e >= B) return;  // ragged last tile: the whole warp leaves
  float* sq = reinterpret_cast<float*>(smem4) + warp * F * S::kRowFloats;
  float* sh = sq + F * S::QS;
  const float* xe = x + static_cast<size_t>(e) * F * DM;
  float* ye = y + static_cast<size_t>(e) * F * DM;
  const int dm = min(max(dom[e], 0), D - 1);
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
    warp_gemm<DM, DM>(sh, S::XS, wqkv + part * DM, 3 * DM, F, lane, acc);
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
        (which ? w1k : w1q) + static_cast<size_t>(dm) * DM * HID;
    const float* w2 =
        (which ? w2k : w2q) + static_cast<size_t>(dm) * HID * DM;
    float* t0 = sq + which * DM;
    {
      float acc[TH::RPL][4];
      warp_gemm<DM, HID>(t0, S::QS, w1, HID, F, lane, acc);
      const int cgh = lane % TH::LPR, rsh = lane / TH::LPR;
#pragma unroll
      for (int i = 0; i < TH::RPL; ++i) {
        const int f = rsh + TH::RS * i;
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = fmaxf(acc[i][c], 0.f);
        if (f < F) st4(sh + f * S::HS + 4 * cgh, v);
      }
    }
    __syncwarp();
    {
      float acc[TD::RPL][4];
      warp_gemm<HID, DM>(sh, S::HS, w2, DM, F, lane, acc);
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

  // 4. Attention.  A lane owns (head, query row) pairs; the output goes to
  //    scratch columns [0, DM).  The row sum is taken before dropout, which
  //    multiplies each probability on its way to the values.
  const float scale = 1.f / sqrtf(static_cast<float>(DH));
#pragma unroll 1
  for (int p = lane; p < NH * F; p += 32) {
    const int hh = p / F, i = p % F;
    float q[DH];
#pragma unroll
    for (int c = 0; c < DH; c += 4) {
      const float4 t = ld4(sq + i * S::QS + hh * DH + c);
      q[c] = t.x * scale;
      q[c + 1] = t.y * scale;
      q[c + 2] = t.z * scale;
      q[c + 3] = t.w * scale;
    }
    float s[kMaxFields];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxFields; ++j) {
      if (j < F) {
        const float* kj = sq + j * S::QS + DM + hh * DH;
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < DH; c += 4) {
          const float4 t = ld4(kj + c);
          a = fmaf(q[c], t.x, a);
          a = fmaf(q[c + 1], t.y, a);
          a = fmaf(q[c + 2], t.z, a);
          a = fmaf(q[c + 3], t.w, a);
        }
        s[j] = a;
        m = fmaxf(m, a);
      }
    }
    float o[DH];
#pragma unroll
    for (int c = 0; c < DH; ++c) o[c] = 0.f;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxFields; ++j) {
      if (j < F) {
        s[j] = expf(s[j] - m);
        sum += s[j];
        const float pj =
            drop.on ? s[j] * ed.attn(drop, salt.s + hh, i, j) : s[j];
        const float* vj = sq + j * S::QS + 2 * DM + hh * DH;
#pragma unroll
        for (int c = 0; c < DH; c += 4) {
          const float4 t = ld4(vj + c);
          o[c] = fmaf(pj, t.x, o[c]);
          o[c + 1] = fmaf(pj, t.y, o[c + 1]);
          o[c + 2] = fmaf(pj, t.z, o[c + 2]);
          o[c + 3] = fmaf(pj, t.w, o[c + 3]);
        }
      }
    }
    const float inv = 1.f / sum;
#pragma unroll
    for (int c = 0; c < DH; c += 4) {
      const float v[4] = {o[c] * inv, o[c + 1] * inv, o[c + 2] * inv,
                          o[c + 3] * inv};
      st4(sh + i * S::HS + hh * DH + c, v);
      if (STASH) st4(st.o + (erow + i) * DM + hh * DH + c, v);
    }
    if (STASH) {
      float* prow = st.s + ((static_cast<size_t>(e) * NH + hh) * F + i) * F;
#pragma unroll
      for (int j = 0; j < kMaxFields; ++j)
        if (j < F) prow[j] = s[j] * inv;
    }
  }
  __syncwarp();

  // 5. y = LN_o(relu?(o @ Wout) m_z + x)
  {
    float acc[TD::RPL][4];
    warp_gemm<DM, DM>(sh, S::HS, wout, DM, F, lane, acc);
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

template <int DM, int HID, int NH, bool STASH>
cudaError_t launch(const float* x, const int* dom, const float* wqkv,
                   const float* w1q, const float* w2q, const float* lnq,
                   const float* w1k, const float* w2k, const float* lnk,
                   const float* wout, const float* lno, float* y, int B,
                   int F, int D, int apply_q, int apply_k, int relu_out,
                   const Dropout& drop, const Stash& st,
                   cudaStream_t stream) {
  using S = Smem<DM, HID>;
  auto kernel = meta_block_fwd_kernel<DM, HID, NH, STASH>;
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
      x, dom, wqkv, w1q, w2q, lnq, w1k, w2k, lnk, wout, lno, y, B, F, D,
      apply_q, apply_k, relu_out, drop, st);
  return cudaGetLastError();
}

}  // namespace

// Shapes (d, h, heads) instantiated here; ops/meta_block.py keeps the same
// list in KERNEL_SHAPES.  With qkv non-null the launch is K1-stash and
// writes the five residuals (each [B, F, *] float32 as described above),
// else K1-fwd.  drop_on selects the dropout, with the operands of
// struct Dropout (csrc/dropout.cuh).  Returns a cudaError_t.
extern "C" int satrans_meta_block_fwd(
    const float* x, const int* dom, const float* wqkv, const float* w1q,
    const float* w2q, const float* lnq, const float* w1k, const float* w2k,
    const float* lnk, const float* wout, const float* lno, float* y,
    float* qkv, float* uq, float* uk, float* s, float* o, int B, int F,
    int d, int h, int heads, int D, int apply_q, int apply_k, int relu_out,
    int drop_on, unsigned seed, unsigned threshold, float scale, int block_b,
    int fpad, int group, void* stream) {
  if (B < 0 || F < 1 || F > kMaxFields || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (drop_on && (block_b < 1 || fpad < F || group < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool stash = qkv != nullptr;
  if (stash && !(uq && uk && s && o))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const Dropout drop{drop_on, seed, threshold, scale, block_b, fpad, group};
  const Stash st{qkv, uq, uk, s, o};
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  if (d == 32 && h == 64 && heads == 4)
    return static_cast<int>(
        stash ? launch<32, 64, 4, true>(x, dom, wqkv, w1q, w2q, lnq, w1k,
                                        w2k, lnk, wout, lno, y, B, F, D,
                                        apply_q, apply_k, relu_out, drop, st,
                                        str)
              : launch<32, 64, 4, false>(x, dom, wqkv, w1q, w2q, lnq, w1k,
                                         w2k, lnk, wout, lno, y, B, F, D,
                                         apply_q, apply_k, relu_out, drop,
                                         st, str));
  return static_cast<int>(cudaErrorInvalidValue);
}
