// Backward of one SATrans layer of the gate or bilinear variant, training,
// float32, with the in-kernel dropout (K6-bwd).
//
// Replaces the TPU kernel _sbwd_kernel of
// satrans_tpu/ops/pallas/gate_block.py (:131, with _transform_bwd :82),
// launched by _sbwd_call (:303) through pl.pallas_call (:318).  It
// recomputes the forward of csrc/gate_block_fwd.cu on chip (the Pallas
// variant has no stash):
//
//   q0|k0|v0 = x @ [Wq|Wk|Wv]
//   gate:      q = q0 * TQ[dm] * 2 if apply_q,  k = k0 * TK[dm] * 2 if apply_k
//   bilinear:  q_h = q0_h @ TQ[dm, h] per head h (always),  k = k0
//   P = per head softmax(clamp(q k^T / sqrt(dh), -60, 60)),  o = (P m_s) v
//   y = LN_o(relu?(o @ Wout) m_z + x)
//
// and, given g = dL/dy, writes dx and the gradients of every operand:
// dWqkv [d, 3d], dWout [d, d], LN_o's (scale, bias) rows, and the tables'
// dTQ and dTK [D, T] (T = d for the gate rows, H * dh * dh for the flat
// bilinear maps), each example adding only into its own domain's row.
// The gate's table gradient is dt * t0 * 2 summed over the example's
// rows and its input gradient dt * TQ[dm] * 2; the bilinear map's is
// t0_h^T dt_h per head and its input gradient dt_h @ TQ[dm, h]^T.  An
// unapplied projection passes its gradient straight through and its
// table gradient is zero.  The logit clamp passes the gradient as if it
// were not there, as the Pallas custom VJP's does.  The masks are
// regenerated in the forward's draw order (csrc/dropout.cuh, salts
// 0..H-1 for the heads and H for the output): dv takes P m, dS takes
// dP m, and dz = du m_z relu'.
//
// What bounds it.  Per example at the AliCCP sota shapes (F=19, d=32,
// 4 heads) the recomputed forward is about 0.2 MFLOP and the backward
// about 0.45 MFLOP (dWout and do 78k, the attention backward 92k, dWqkv
// and dx 233k, the transform 1-20k) against 7.3 kB of x, g and dx: it is
// bound by float32 FMA throughput.
//
// Design: K1-bwd's (csrc/meta_block_bwd.cu), with its device code
// (csrc/layer_common.cuh).  A block of 256 threads works on a tile of two
// examples, 128 threads on each, and walks over the batch's tiles with a
// grid stride; two blocks per SM.  The per-example
// phases give a thread a register tile of 4 columns x a few rows and meet
// at block barriers.  Each block sums the parameter gradients of the
// examples it visits in sums of its own, each element owned by one
// thread, so the order of the sums is fixed and no atomics are needed:
// dWqkv and dWout in shared memory, LN_o's in registers, the per-domain
// table gradients in the block's slice of a scratch buffer in global
// memory (L2).  A second small kernel adds the slices in block order, so
// the result is deterministic for a given grid.  Shared memory holds the
// dense sums and two examples' x, q0|k0|v0, the transformed q|k, the
// attention output, the probabilities and the gradient rows: 81 kB at
// F=19.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>

#include "layer_common.cuh"

namespace {

constexpr int kThreads = 256;             // two blocks per SM
constexpr int kTile = 2;                  // examples per block iteration
constexpr int kGroup = kThreads / kTile;  // threads per example
constexpr int kLnRows = 2;                // LN_o's (scale, bias)
constexpr int kMaxSmem = 232448;          // bytes a block may use on sm_90
constexpr int kMaxDomains = 16;           // bounds the scratch buffer

// Row strides (floats) of the shared buffers; +4 shifts rows by 4 banks.
template <int DM>
struct Strides {
  static constexpr int XS = DM + 4;      // x; o, then do
  static constexpr int QS = 3 * DM + 4;  // q0|k0|v0, and dz, then dq|dk|dv
  static constexpr int NS = 2 * DM + 4;  // the transformed q|k
  static constexpr int kDense = 4 * DM * DM;  // dWqkv then dWout
};

// Floats of one tile's working buffers (also the end-of-kernel scratch).
template <int DM, int NH>
__host__ __device__ int work_floats(int F) {
  using S = Strides<DM>;
  const int R = kTile * F;
  const int n = R * (2 * S::XS + 2 * S::QS + S::NS) + kTile * NH * F * F;
  return n > kThreads * kLnRows * 4 ? n : kThreads * kLnRows * 4;
}

template <int DM, int NH>
__host__ __device__ int smem_bytes(int F) {
  return sizeof(float) * (Strides<DM>::kDense + work_floats<DM, NH>(F));
}

// A table row's width: the gate's d, or the bilinear maps' H * dh * dh.
template <int DM, int NH, bool BILINEAR>
__host__ __device__ constexpr int table_width() {
  return BILINEAR ? DM * (DM / NH) : DM;
}

template <int DM, int NH, bool BILINEAR>
__host__ __device__ int grad_floats(int D) {  // the block's partial sums
  return Strides<DM>::kDense + kLnRows * DM +
         2 * D * table_width<DM, NH, BILINEAR>();
}

struct Args {
  const float *x, *g, *wqkv, *wqkvT, *tq, *tk, *wout, *woutT, *lno;
  const int* dom;
  float *dx, *partial;
  int B, F, D, apply_q, apply_k, relu_out;
  Dropout drop;
};

template <int DM, int NH, bool BILINEAR>
__global__ void __launch_bounds__(kThreads, 2)
gate_block_bwd_kernel(const Args a) {
  using S = Strides<DM>;
  using TD = Tile<DM, kGroup>;
  constexpr int DH = DM / NH;
  constexpr int T = table_width<DM, NH, BILINEAR>();
  static_assert(DM % NH == 0 && DH % 4 == 0, "head width must be 4k");

  extern __shared__ float4 smem4[];
  const int t = threadIdx.x, slot = t / kGroup, gt = t % kGroup;
  const int F = a.F, D = a.D, R = kTile * F;

  // Shared: dWqkv [DM][3DM] | dWout [DM][DM] sums, then the tile's
  // working buffers, rows r = slot * F + f.  Global, the block's slice of
  // the scratch buffer: the per-domain dTQ and dTK sums, each [D][T],
  // after the dense and LayerNorm sums.
  float* acc = reinterpret_cast<float*>(smem4);
  float* out = a.partial + static_cast<size_t>(blockIdx.x) *
                               grad_floats<DM, NH, BILINEAR>(D);
  float* acc_dom = out + S::kDense + kLnRows * DM;
  float* sX = acc + S::kDense;
  float* sQKV = sX + R * S::XS;
  float* sN = sQKV + R * S::QS;  // q|k after their transforms
  float* sH = sN + R * S::NS;    // o, then do
  float* sP = sH + R * S::XS;    // [kTile][NH][F][F]: P, then dS
  float* sD = sP + kTile * NH * F * F;  // dz, then dq|dk|dv, then dq0|dk0
  for (int i = t; i < S::kDense; i += kThreads) acc[i] = 0.f;
  for (int i = t; i < 2 * D * T; i += kThreads) acc_dom[i] = 0.f;

  float ln_acc[kLnRows][4];
#pragma unroll
  for (int j = 0; j < kLnRows; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) ln_acc[j][c] = 0.f;
  }
  const int cgd = gt % TD::LPR, rsd = gt / TD::LPR, cold = 4 * cgd;
  const int tiles = (a.B + kTile - 1) / kTile;
  const DropSalts salt(0, 0, NH);
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
    float* H = sH + slot * F * S::XS;
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

    // F3. The transforms: q|k -> N (an unapplied projection copied).
    if (live) {
#pragma unroll 1
      for (int w = 0; w < 2; ++w) {
        const bool on = BILINEAR ? w == 0 : (w ? a.apply_k : a.apply_q);
        const float* tab =
            (w ? a.tk : a.tq) + static_cast<size_t>(dm) * T;
        float4 gm = make_float4(1.f, 1.f, 1.f, 1.f);  // exact when off
        if (on && !BILINEAR) {
          gm = ldg4(tab + cold);
          gm = make_float4(2.f * gm.x, 2.f * gm.y, 2.f * gm.z, 2.f * gm.w);
        }
        const int hh = cold / DH, c0 = cold % DH;
#pragma unroll
        for (int i = 0; i < TD::RPL; ++i) {
          const int f = rsd + TD::RS * i;
          if (f >= F) continue;
          float v[4];
          if (BILINEAR && on) {
            v[0] = v[1] = v[2] = v[3] = 0.f;
#pragma unroll
            for (int k = 0; k < DH; ++k) {
              const float4 m = ldg4(tab + hh * DH * DH + k * DH + c0);
              const float q = QKV[f * S::QS + hh * DH + k];
              v[0] = fmaf(q, m.x, v[0]);
              v[1] = fmaf(q, m.y, v[1]);
              v[2] = fmaf(q, m.z, v[2]);
              v[3] = fmaf(q, m.w, v[3]);
            }
          } else {
            const float4 r = ld4(QKV + f * S::QS + w * DM + cold);
            v[0] = r.x * gm.x;
            v[1] = r.y * gm.y;
            v[2] = r.z * gm.z;
            v[3] = r.w * gm.w;
          }
          st4(Nm + f * S::NS + w * DM + cold, v);
        }
      }
    }
    __syncthreads();

    // F4. Attention (csrc/layer_common.cuh): P (normalised, before
    //     dropout) and o = (P m_s) v into H.
    if (live)
      attention_recompute<DM, NH, kGroup>(Nm, S::NS, QKV + 2 * DM, S::QS, P,
                                          H, S::XS, F, gt, a.drop, ed,
                                          salt.s);
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
      tile_gemm<kGroup, DM, DM>(H, S::XS, a.wout, DM, F, gt, z);
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
          ln_acc[0][c] = fmaf(gv[c], v[c], ln_acc[0][c]);
          ln_acc[1][c] += gv[c];
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
    wgrad<kThreads, DM, DM>(sH, S::XS, sD, S::QS, nvalid * F,
                            acc + 3 * DM * DM, DM, t);
    __syncthreads();
    if (live) {
      float o[TD::RPL][4];
      tile_gemm<kGroup, DM, DM>(Dg, S::QS, a.woutT, DM, F, gt, o);
#pragma unroll
      for (int i = 0; i < TD::RPL; ++i) {
        const int f = rsd + TD::RS * i;
        if (f < F) st4(H + f * S::XS + cold, o[i]);
      }
    }
    __syncthreads();

    // B2. Attention backward (csrc/layer_common.cuh): dv, then dS over P
    //     and dq, then dk, into Dg.
    attention_bwd<DM, NH, kGroup>(live, P, H, S::XS, QKV + 2 * DM, S::QS, Nm,
                                  S::NS, Dg, S::QS, F, gt, a.drop, ed, salt.s);

    // B3. The transforms' backward (JAX _transform_bwd), Q then K.  The
    //     table sums first, each element by one thread over the tile's
    //     examples in order, from t0 = q0 (or k0) and dt = dq (or dk):
    //     gate dT[dm][c] += sum_f dt[f][c] t0[f][c] 2; bilinear
    //     dT[dm][h][k][c] += sum_f t0[f][h dh + k] dt[f][h dh + c].  Then
    //     dt0 over dt: gate dt TQ[dm] 2; bilinear dt_h @ TQ[dm, h]^T, in
    //     registers first (a row's head spans two threads).
#pragma unroll 1
    for (int w = 0; w < 2; ++w) {
      if (!(BILINEAR ? w == 0 : (w ? a.apply_k : a.apply_q))) continue;
      float* accw = acc_dom + w * D * T;
      for (int el = t; el < T; el += kThreads) {
        const int col = BILINEAR ? (el / (DH * DH)) * DH + el % DH : el;
        const int row = BILINEAR ? (el / (DH * DH)) * DH + (el / DH) % DH
                                 : el;
#pragma unroll 1
        for (int e = 0; e < nvalid; ++e) {
          const float* t0 = sQKV + e * F * S::QS + w * DM;
          const float* dt = sD + e * F * S::QS + w * DM;
          float s = 0.f;
          for (int f = 0; f < F; ++f)
            s = fmaf(t0[f * S::QS + row], dt[f * S::QS + col], s);
          accw[doms[e] * T + el] += BILINEAR ? s : 2.f * s;
        }
      }
      __syncthreads();
      float v[TD::RPL][4];
      const float* tab = (w ? a.tk : a.tq) + static_cast<size_t>(dm) * T;
      float* dt = Dg + w * DM;
      if (live) {
        const int hh = cold / DH, c0 = cold % DH;
        const float4 gm = BILINEAR ? make_float4(0.f, 0.f, 0.f, 0.f)
                                   : ldg4(tab + cold);
#pragma unroll
        for (int i = 0; i < TD::RPL; ++i) {
          const int f = rsd + TD::RS * i;
          if (f >= F) continue;
          if (BILINEAR) {
            // dt0[f][h dh + c0 + c] = sum_l dt[f][h dh + l] TQ[dm][h][c0+c][l]
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float* m = tab + hh * DH * DH + (c0 + c) * DH;
              float s = 0.f;
#pragma unroll
              for (int l = 0; l < DH; l += 4) {
                const float4 mv = ldg4(m + l);
                const float4 dv = ld4(dt + f * S::QS + hh * DH + l);
                s = fmaf(dv.x, mv.x, s);
                s = fmaf(dv.y, mv.y, s);
                s = fmaf(dv.z, mv.z, s);
                s = fmaf(dv.w, mv.w, s);
              }
              v[i][c] = s;
            }
          } else {
            const float4 r = ld4(dt + f * S::QS + cold);
            v[i][0] = r.x * gm.x * 2.f;
            v[i][1] = r.y * gm.y * 2.f;
            v[i][2] = r.z * gm.z * 2.f;
            v[i][3] = r.w * gm.w * 2.f;
          }
        }
      }
      __syncthreads();
      if (live) {
#pragma unroll
        for (int i = 0; i < TD::RPL; ++i) {
          const int f = rsd + TD::RS * i;
          if (f < F) st4(dt + f * S::QS + cold, v[i]);
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
  // dWqkv | dWout | LN_o (scale row, bias row) | dTQ | dTK, the last two
  // already in place.  The LayerNorm sums of the threads holding the same
  // columns are added in thread order.
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

template <int DM, int NH, bool BILINEAR>
cudaError_t launch(const Args& a, float* grads, int blocks,
                   cudaStream_t stream) {
  auto kernel = gate_block_bwd_kernel<DM, NH, BILINEAR>;
  const size_t smem = smem_bytes<DM, NH>(a.F);
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
  const int total = grad_floats<DM, NH, BILINEAR>(a.D);
  sum_partials<<<(total + 255) / 256, 256, 0, stream>>>(a.partial, grads,
                                                        total, blocks);
  return cudaGetLastError();
}

}  // namespace

// Shapes (d, heads) instantiated here; ops/gate_block.py keeps the same
// list in KERNEL_SHAPES.  partial holds blocks x satrans_gate_block_bwd_
// grad_floats(d, heads, D, bilinear) floats (two blocks per SM fill the
// card); grads receives the summed gradients in the layout written above.
// Returns a cudaError_t.
extern "C" int satrans_gate_block_bwd_grad_floats(int d, int heads, int D,
                                                  int bilinear) {
  if (d == 32 && heads == 4)
    return bilinear ? grad_floats<32, 4, true>(D)
                    : grad_floats<32, 4, false>(D);
  return -1;
}

extern "C" int satrans_gate_block_bwd_max_domains() { return kMaxDomains; }

// The same operands as satrans_gate_block_fwd, with g, the transposed
// weights wqkvT [3d, d] and woutT, dx and the scratch buffers.
extern "C" int satrans_gate_block_bwd(
    const float* x, const int* dom, const float* g, const float* wqkv,
    const float* wqkvT, const float* tq, const float* tk, const float* wout,
    const float* woutT, const float* lno, float* dx, float* partial,
    float* grads, int B, int F, int d, int heads, int D, int bilinear,
    int apply_q, int apply_k, int relu_out, int blocks, int drop_on,
    unsigned seed, unsigned threshold, float scale, int block_b, int fpad,
    int group, void* stream) {
  if (B < 1 || F < 1 || F > kMaxFields || D < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (drop_on && (block_b < 1 || fpad < F || group < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,       g,  wqkv,    wqkvT,   tq,      tk,
               wout,    woutT, lno,  dom,     dx,      partial,
               B,       F,  D,       apply_q, apply_k, relu_out,
               Dropout{drop_on, seed, threshold, scale, block_b, fpad, group}};
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  if (d == 32 && heads == 4)
    return static_cast<int>(bilinear
                                ? launch<32, 4, true>(a, grads, blocks, str)
                                : launch<32, 4, false>(a, grads, blocks, str));
  return static_cast<int>(cudaErrorInvalidValue);
}
