// Forward of one SATrans layer of the gate or bilinear variant, float32,
// with the in-kernel dropout of training (K6-fwd).
//
// Replaces the TPU kernel _sfwd_kernel of
// satrans_tpu/ops/pallas/gate_block.py (:96), launched by _sfwd_call (:273)
// through pl.pallas_call (:287).  Per example e with domain row
// dm = dom[e] and dropout masks m (all ones without dropout):
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
// salt H (csrc/dropout.cuh with apply_q = apply_k = 0), on the JAX
// kernel's tile of fields padded to 8 (gate_block.py:382's pad_mult).
//
// TPU layout choices that are dropped here, none of which changes the
// result: the bilinear maps packed block-diagonally into a [d, D*d] matrix
// applied by a masked wide GEMM over all domains (each example reads its
// own domain's per-head maps and multiplies each head's 8 columns
// directly), F padded to 8 (only the dropout masks count the padded
// fields), block-diagonal attention packing, and B % block_b == 0 (the
// ragged last tile is guarded).
//
// What bounds it.  Per example at the AliCCP sota shapes (F=19, d=32,
// 4 heads) the arithmetic is about 0.2 MFLOP (QKV 117k, attention 46k,
// output 39k, the transform 1-10k) against 4.9 kB of x and y, about 40
// FLOP per byte: at the card's float32 rate (67 TFLOP/s) and HBM rate
// (3.35 TB/s) the two bounds are of the same order, the arithmetic the
// larger.  The design is K1-fwd's (csrc/meta_block_fwd.cu), with its
// device code (csrc/layer_common.cuh): one warp owns one example and keeps
// all its intermediates in its slice of shared memory, each small GEMM
// gives a lane a register tile of 4 columns x a few rows fed by float4
// weight loads through the read-only cache, the LayerNorm reduces across
// a row's 8 lanes with shuffles, and device memory sees x once (and again
// for the residual, from L2) and y once.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>

#include "layer_common.cuh"

namespace {

constexpr int kWarps = 8;   // examples per block, one warp each
constexpr int kGroup = 32;  // threads per example

// Shared memory of one warp: F rows of q|k|v (stride QS), then F rows of
// scratch (stride XS) that holds x and then the attention output.  The +4
// pads shift consecutive rows by four banks.
template <int DM>
struct Smem {
  static constexpr int QS = 3 * DM + 4;
  static constexpr int XS = DM + 4;
  static constexpr int kRowFloats = QS + XS;
};

template <int DM, int NH, bool BILINEAR>
__global__ void __launch_bounds__(kWarps * 32, 2)
gate_block_fwd_kernel(const float* __restrict__ x, const int* __restrict__ dom,
                      const float* __restrict__ wqkv,
                      const float* __restrict__ tq,
                      const float* __restrict__ tk,
                      const float* __restrict__ wout,
                      const float* __restrict__ lno, float* __restrict__ y,
                      int B, int F, int D, int apply_q, int apply_k,
                      int relu_out, const Dropout drop) {
  using S = Smem<DM>;
  using TD = Tile<DM, kGroup>;
  constexpr int DH = DM / NH;
  constexpr int T = BILINEAR ? NH * DH * DH : DM;  // table row width
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
  const DropSalts salt(0, 0, NH);

  // 1. x -> scratch
  for (int t = lane; t < F * (DM / 4); t += 32) {
    const int f = t / (DM / 4), c = 4 * (t % (DM / 4));
    *reinterpret_cast<float4*>(sh + f * S::XS + c) = ldg4(xe + f * DM + c);
  }
  __syncwarp();

  // 2. q0 | k0 | v0 = x @ [Wq | Wk | Wv]; the gate multiplies Q and K on
  //    the way out
#pragma unroll 1
  for (int part = 0; part < 3; ++part) {
    float acc[TD::RPL][4];
    tile_gemm<kGroup, DM, DM>(sh, S::XS, wqkv + part * DM, 3 * DM, F, lane,
                              acc);
    const bool gated = !BILINEAR && (part == 0 ? apply_q
                                     : part == 1 ? apply_k : 0);
    float4 gm = make_float4(1.f, 1.f, 1.f, 1.f);  // exact when ungated
    if (gated) {
      gm = ldg4((part == 0 ? tq : tk) + static_cast<size_t>(dm) * T + cold);
      gm = make_float4(2.f * gm.x, 2.f * gm.y, 2.f * gm.z, 2.f * gm.w);
    }
#pragma unroll
    for (int i = 0; i < TD::RPL; ++i) {
      const int f = rsd + TD::RS * i;
      if (f < F) {
        const float v[4] = {acc[i][0] * gm.x, acc[i][1] * gm.y,
                            acc[i][2] * gm.z, acc[i][3] * gm.w};
        st4(sq + f * S::QS + part * DM + cold, v);
      }
    }
  }
  __syncwarp();

  // 3. bilinear: q_h = q0_h @ TQ[dm, h], in registers first (a row's head
  //    spans two lanes), then over q0
  if (BILINEAR) {
    const int hh = cold / DH, c0 = cold % DH;
    const float* bm = tq + static_cast<size_t>(dm) * T + hh * DH * DH + c0;
    float acc[TD::RPL][4];
#pragma unroll
    for (int i = 0; i < TD::RPL; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < DH; ++k) {
      const float4 w = ldg4(bm + k * DH);
#pragma unroll
      for (int i = 0; i < TD::RPL; ++i) {
        const int f = rsd + TD::RS * i;
        if (f < F) {
          const float a = sq[f * S::QS + hh * DH + k];
          acc[i][0] = fmaf(a, w.x, acc[i][0]);
          acc[i][1] = fmaf(a, w.y, acc[i][1]);
          acc[i][2] = fmaf(a, w.z, acc[i][2]);
          acc[i][3] = fmaf(a, w.w, acc[i][3]);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < TD::RPL; ++i) {
      const int f = rsd + TD::RS * i;
      if (f < F) st4(sq + f * S::QS + cold, acc[i]);
    }
    __syncwarp();
  }

  // 4. Attention (csrc/layer_common.cuh); the output goes to scratch
  //    columns [0, DM).
  attention_fwd<DM, NH, kGroup, false, false>(sq, S::QS, sh, S::XS, nullptr,
                                              nullptr, F, lane, drop, ed,
                                              salt.s);
  __syncwarp();

  // 5. y = LN_o(relu?(o @ Wout) m_z + x)
  {
    float acc[TD::RPL][4];
    tile_gemm<kGroup, DM, DM>(sh, S::XS, wout, DM, F, lane, acc);
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

template <int DM, int NH, bool BILINEAR>
cudaError_t launch(const float* x, const int* dom, const float* wqkv,
                   const float* tq, const float* tk, const float* wout,
                   const float* lno, float* y, int B, int F, int D,
                   int apply_q, int apply_k, int relu_out,
                   const Dropout& drop, cudaStream_t stream) {
  using S = Smem<DM>;
  auto kernel = gate_block_fwd_kernel<DM, NH, BILINEAR>;
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
  kernel<<<blocks, kWarps * 32, smem, stream>>>(x, dom, wqkv, tq, tk, wout,
                                                lno, y, B, F, D, apply_q,
                                                apply_k, relu_out, drop);
  return cudaGetLastError();
}

}  // namespace

// Shapes (d, heads) instantiated here; ops/gate_block.py keeps the same
// list in KERNEL_SHAPES.  bilinear selects the variant (0: gate), with the
// tables described above; drop_on selects the dropout, with the operands
// of struct Dropout (csrc/dropout.cuh).  Returns a cudaError_t.
extern "C" int satrans_gate_block_fwd(
    const float* x, const int* dom, const float* wqkv, const float* tq,
    const float* tk, const float* wout, const float* lno, float* y, int B,
    int F, int d, int heads, int D, int bilinear, int apply_q, int apply_k,
    int relu_out, int drop_on, unsigned seed, unsigned threshold,
    float scale, int block_b, int fpad, int group, void* stream) {
  if (B < 0 || F < 1 || F > kMaxFields || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (drop_on && (block_b < 1 || fpad < F || group < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const Dropout drop{drop_on, seed, threshold, scale, block_b, fpad, group};
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  if (d == 32 && heads == 4)
    return static_cast<int>(
        bilinear ? launch<32, 4, true>(x, dom, wqkv, tq, tk, wout, lno, y, B,
                                       F, D, apply_q, apply_k, relu_out, drop,
                                       str)
                 : launch<32, 4, false>(x, dom, wqkv, tq, tk, wout, lno, y,
                                        B, F, D, apply_q, apply_k, relu_out,
                                        drop, str));
  return static_cast<int>(cudaErrorInvalidValue);
}
