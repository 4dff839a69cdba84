// Backward of one SATrans layer of the gate or bilinear variant, training,
// float32, with the in-kernel dropout (K6-bwd).
//
// Replaces the TPU kernel _sbwd_kernel of
// satrans_tpu/ops/pallas/gate_block.py (:131, with _transform_bwd :79),
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
// dTQ [D, T] and (the gate) dTK [D, T] (T = d for the gate rows, H * dh *
// dh for the flat bilinear maps), each example adding only into its own
// domain's row, at any D.
// The gate's table gradient is dt * t0 * 2 summed over the example's
// rows and its input gradient dt * TQ[dm] * 2; the bilinear map's is
// t0_h^T dt_h per head and its input gradient dt_h @ TQ[dm, h]^T.  An
// unapplied projection passes its gradient straight through and its
// table gradient is zero.  The logit clamp passes the gradient as if it
// were not there, as the Pallas custom VJP's does.  The masks are
// regenerated in the forward's draw order (csrc/dropout.cuh, salts
// 0..H-1 for the heads and H for the output, keyed on each example's own
// index in the batch, never its sorted place): dv takes P m, dS takes
// dP m, and dz = du m_z relu'.
//
// What bounds it.  Per example at the AliCCP sota shapes (F = 19, d = 32,
// 4 heads) the recomputed forward is about 0.2 MFLOP and the backward
// about 0.45 MFLOP (dWout and do 78k, the attention backward 92k, dWqkv
// and dx 233k, the transform 1-20k) against 7.3 kB of x, g and dx.  Its
// products (all but the attention's and the transform's) are 3xTF32 on
// the tensor cores; the attention is float32 on the CUDA cores.  The
// two-example body this kernel first ran on (deleted) took 0.60 ms at B =
// 8192 on the H100: 256 threads a block on tiles of two examples with a
// block barrier after every phase, every product on the CUDA cores with 19
// rows over 32 row slots, the weights read through L1 by every example,
// transposed weight copies made each backward, the per-domain table sums
// read and written in L2 once an example, and the bilinear map re-read
// for every row.
//
// Design: the tile body of the layer backward (csrc/meta_stash_bwd.cuh),
// on its primitives (csrc/stash_tile.cuh) and per-pair attention passes
// (csrc/layer_common.cuh), with the gate or bilinear transform where that
// body has its MetaNets and their LayerNorms.  A block of 384 threads,
// one an SM, walks a contiguous range of the batch in tiles of E = 96 / F
// examples (the forward tile body's 12 warps: its buffers, without the
// MetaNets', leave room for them), sorted by domain row in windows of 256
// (sort_window), so that each domain's rows are one segment of a tile.  Every product runs on the
// tensor cores in 3xTF32 (block_gemm) with Wqkv and Wout in shared memory
// in float32, staged once a block and read transposed where the backward
// needs W^T: no transposed copies.  dWqkv and dWout are sums over rows in
// 16 x 8 tiles each warp owns in registers (WTiles, each tile's products
// summed in a fresh accumulator).  The tables of every domain (2 x 128 B
// a row for the gate, 1 kB for the bilinear maps, at d = 32 with 4 heads)
// are staged in shared memory once a block where they fit beside the tile
// buffers (at d = 32, 4 heads and F = 19 up to 133 gate rows or 33
// bilinear ones), so the transform reads each row's own domain there;
// else from device memory.  The table gradients are summed over a
// segment's rows by one thread an element, in registers, and added into
// the block's slice of the scratch buffer once a segment (the slice holds
// dTQ and dTK of every row for the gate, dTQ alone for the bilinear map,
// which transforms Q only: 2 D d floats, or D d^2 / H); the LayerNorm
// sums are per-thread column sums; sum_partials adds the slices in block
// order, so the result is deterministic for a grid.  The transform and its
// backward (a few k operations an example) stay float32 on the CUDA cores,
// as in K6-fwd.  The attention dropout's keep bits are drawn once a tile,
// a word a (head, row), and the three passes that apply them read the
// bits (drawing them in each pass cost 0.11 ms of 0.51 at B = 8192,
// dropout 0.1 on the H100).
// x comes in by 16-byte cp.async copies, the next tile's as soon as this
// tile's dWqkv has read it; dx goes out from the product's registers in
// the batch's order.  Shared memory at F = 19 with 4 table rows: 199 kB
// (gate), 202 kB (bilinear); 215 kB with 16 bilinear rows.
//
// Other shapes (a library a (d, heads)): GateTile's rows are the most,
// from 96 down, whose buffers fit at every F (96 up to d = 32; 48 at d =
// 64, 32 with 8 heads); the tables are staged where they fit beside them,
// else each row's table row is read from device memory (a 64 x 64
// bilinear map a row at d = 64 with one head: 16 kB); the table sums loop
// over a segment's elements, one thread an element at a time.
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

#include "stash_tile.cuh"

namespace {

// the body's threads: a thread a (head, row) pair of its attention, RT
// threads a row in the epilogues.  96 rows on 12 warps (the forward tile
// body's) ran faster than 80 rows on 10 on the H100: the attention passes
// run a thread a pair, and 12 warps hide more of their latency.  The tile
// rows are a function of the shape (GateTile).
constexpr int kThreads = kWideTT;
constexpr int kLnRows = 2;         // LN_o's (scale, bias)

// A table row's width: the gate's d, or the bilinear maps' H * dh * dh.
template <int DM, int NH, bool BILINEAR>
__host__ __device__ constexpr int table_width() {
  return BILINEAR ? DM * (DM / NH) : DM;
}

// The tables a variant transforms with: TQ and TK (the gate), TQ alone
// (the bilinear maps).
template <bool BILINEAR>
__host__ __device__ constexpr int table_count() {
  return BILINEAR ? 1 : 2;
}

// The gradient buffer (and each block's slice of the scratch): dWqkv |
// dWout | LN_o (scale row, bias row) | dTQ [D][T] | (the gate) dTK [D][T].
template <int DM, int NH, bool BILINEAR>
__host__ __device__ size_t grad_floats(int D) {
  return 4 * DM * DM + kLnRows * DM +
         static_cast<size_t>(table_count<BILINEAR>()) * D *
             table_width<DM, NH, BILINEAR>();
}

struct GateBwdArgs {
  const float *x, *g, *wqkv, *tq, *tk, *wout, *lno;
  const int* dom;
  float *dx, *partial;
  int B, F, D, chunk, apply_q, apply_k, relu_out;
  Dropout drop;
};

// Shared layout of the body, in floats after the header (kTileHeader): row
// strides (+4 shifts an A operand's rows by four banks, +8 a B operand's
// by eight) and region offsets; the tables last, sized by D, where they
// fit (else the transforms read them from device memory through L1).
// The tile rows: the most, from 96 down, whose buffers fit a block at
// every F (96 at d <= 32, 48 at d = 64 with 1, 2 or 4 heads, 32 with 8).
template <int DM, int NH, bool BILINEAR>
struct GateTile {
  static constexpr int T = table_width<DM, NH, BILINEAR>();
  static constexpr int kTables = table_count<BILINEAR>();
  static constexpr int WQ = 3 * DM + 8, WO = DM + 8;
  static constexpr int XS = DM + 4, QS = 3 * DM + 4, NS = 2 * DM + 4,
                       OS = DM + 4, DS = 3 * DM + 4;
  // the bytes of n tile rows at F fields (0: the most at any F) with D
  // table rows staged
  static __host__ __device__ constexpr int layout_bytes(int n, int F,
                                                        int D) {
    const int p = F ? tile_examples(F, n) * NH * F * F : most_probs(n, NH);
    return kTileHeader +
           4 * (DM * (WQ + WO) + n * (XS + QS + NS + OS + DS + XS) +
                ((p + 3) & ~3) + n * NH + kTables * D * T);
  }
  static __host__ __device__ constexpr int plan() {
    for (int n = kWideTileRows; n > 32; n -= 16)
      if (layout_bytes(n, 0, 0) <= kMaxSmem) return n;
    return 32;
  }
  static constexpr int ROWS = plan();
  static constexpr int RT = row_threads(DM);  // threads on a row
  static constexpr int kPass = kThreads / RT;  // rows an epilogue pass
  static constexpr int kPasses = (ROWS + kPass - 1) / kPass;
  static_assert(layout_bytes(ROWS, 0, 0) <= kMaxSmem,
                "no layout of K6-bwd's body fits this shape");
  static constexpr int oWqkv = 0, oWout = oWqkv + DM * WQ,
                       oX = oWout + DM * WO, oQKV = oX + ROWS * XS,
                       oN = oQKV + ROWS * QS, oO = oN + ROWS * NS,
                       oD = oO + ROWS * OS, oDU = oD + ROWS * DS,
                       oG = oDU + ROWS * XS;
  // the probabilities of the tile's examples
  static __host__ __device__ int g_floats(int F) {
    return (tile_examples(F, ROWS) * NH * F * F + 3) & ~3;
  }
  // then the attention dropout's keep bits (a word a head and row), then
  // the tables
  static __host__ __device__ int oBits(int F) { return oG + g_floats(F); }
  static __host__ __device__ int oTab(int F) {
    return oBits(F) + ROWS * NH;
  }
  // whether D table rows are staged at F fields
  static __host__ __device__ bool staged(int F, int D) {
    return layout_bytes(ROWS, F, D) <= kMaxSmem;
  }
  static __host__ __device__ int bytes(int F, int D) {
    return layout_bytes(ROWS, F, staged(F, D) ? D : 0);
  }
};

template <int DM, int NH, bool BILINEAR>
__global__ void __launch_bounds__(kThreads, 1)
    gate_stash_bwd_kernel(const GateBwdArgs a) {
  using L = GateTile<DM, NH, BILINEAR>;
  constexpr int DH = DM / NH, T = L::T, ROWS = L::ROWS, RT = L::RT;
  constexpr int kPass = L::kPass, V = head_vec<DH>();
  static_assert(DM % NH == 0, "heads must divide d");

  extern __shared__ __align__(16) unsigned char smem[];
  const TileHeader hd(smem);
  int *const order = hd.order, *const wdom = hd.wdom, *const key = hd.key;
  const int tid = threadIdx.x;
  const int F = a.F, E = tile_examples(F, ROWS), D = a.D;
  float* f0 = reinterpret_cast<float*>(smem + kTileHeader);
  float* sWqkv = f0 + L::oWqkv;
  float* sWout = f0 + L::oWout;
  float* sX = f0 + L::oX;
  float* sQKV = f0 + L::oQKV;  // q0|k0|v0
  float* sN = f0 + L::oN;      // q|k after their transforms
  float* sO = f0 + L::oO;      // o, then do
  float* sD = f0 + L::oD;      // dz (cols 0..DM), zlin (2DM..); dq|dk|dv
  float* sDU = f0 + L::oDU;    // the outer LayerNorm's du
  float* sG = f0 + L::oG;      // P, then dS
  // the keep bits of the attention dropout, [E][NH][F] words
  unsigned* sBits = reinterpret_cast<unsigned*>(f0 + L::oBits(F));
  float* sTab = f0 + L::oTab(F);  // TQ [D][T], then TK [D][T]
  const bool staged = L::staged(F, D);
  // table w's row d: staged, or in device memory
  const auto trow = [&](int w, int d) -> const float* {
    return staged ? sTab + (w * D + d) * T : (w ? a.tk : a.tq) + d * T;
  };
  // the transforms draw no dropout: the heads' salts 0..H-1, the output's H
  const DropSalts salt(0, 0, NH);
  // which of q and k are transformed (the bilinear map: q alone)
  const bool on[2] = {BILINEAR || a.apply_q != 0,
                      !BILINEAR && a.apply_k != 0};

  // the block's slice: dense | LN_o | dTQ | dTK
  float* out = a.partial + blockIdx.x * grad_floats<DM, NH, BILINEAR>(D);
  float* tab_out = out + 4 * DM * DM + kLnRows * DM;

  stage_matrix<DM, 3 * DM>(sWqkv, L::WQ, a.wqkv);
  stage_matrix<DM, DM>(sWout, L::WO, a.wout);
#pragma unroll
  for (int w = 0; w < L::kTables; ++w)
    if (staged && on[w]) {
      const float* tab = w ? a.tk : a.tq;
      for (int i = tid; i < D * T / 4; i += kThreads)
        cp_async16(sTab + w * D * T + 4 * i, tab + 4 * i);
    }
  for (int i = tid; i < L::kTables * D * T; i += kThreads) tab_out[i] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  const int lo = blockIdx.x * a.chunk, hi = min(a.B, lo + a.chunk);
  WTiles<DM, 3 * DM, kThreads / 32> dwqkv;
  WTiles<DM, DM, kThreads / 32> dwout;
  dwqkv.zero();
  dwout.zero();
  float ln_acc[kLnRows][4];
#pragma unroll
  for (int j = 0; j < kLnRows; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) ln_acc[j][k] = 0.f;
  }
  const auto load_x = [&](const int* ex, int n) {
    load_rows<DM>(sX, L::XS, a.x, ex, n, F);
    cp_async_commit();
  };
  // the row epilogues: RT threads a row, rows rb + tid / RT
  const int c = 4 * (tid % RT);

#pragma unroll 1
  for (int w0 = lo; w0 < hi; w0 += kWindow) {
    const int nw = min(kWindow, hi - w0);
    sort_window(a.dom, w0, nw, D, order, wdom, key);
    const int ntiles = (nw + E - 1) / E;
    load_x(order, min(E, nw));
#pragma unroll 1
    for (int ti = 0; ti < ntiles; ++ti) {
      const int* ex = order + ti * E;
      const int* dm = wdom + ti * E;
      const int n = min(E, nw - ti * E), R = n * F, mt = (R + 15) / 16;
      cp_async_wait<0>();
      tile_draws(hd.draws, a.drop, ex, n);
      __syncthreads();

      // 1. q0|k0|v0 = x @ [Wq|Wk|Wv] -> sQKV
      block_gemm<DM, 3 * DM, fit_nt(3 * DM, 2)>(
          0, mt, [&](int m, int k) { return sX[m * L::XS + k]; },
          [&](int k, int cc) { return sWqkv[k * L::WQ + cc]; },
          [&](int r, int cc, float v0, float v1) {
            *reinterpret_cast<float2*>(sQKV + r * L::QS + cc) =
                make_float2(v0, v1);
          });
      __syncthreads();

      // 2. The transforms, each row with its own domain's table row: q|k
      //    -> sN (an unapplied projection copied through); beside them the
      //    attention dropout's keep bits, a thread a (head, row), drawn
      //    once for the three passes that apply them
#pragma unroll
      for (int rb = 0; rb < ROWS; rb += kPass) {
        const int r = rb + tid / RT;
        if (r >= R) continue;
        const int d = dm[r / F];
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const float* t0 = sQKV + r * L::QS + w * DM;
          float v[4];
          if (on[w])
            transform_cols<DM, NH, BILINEAR>(t0, trow(w, d), c, v);
          else
            to4(ld4(t0 + c), v);
          st4(sN + r * L::NS + w * DM + c, v);
        }
      }
      if (a.drop.on)
        for_pairs<NH>(n, F, [&](int s, int hh, int i) {
          sBits[(s * NH + hh) * F + i] =
              attn_keep_row(a.drop, hd.draws[s], salt.s + hh, i, F);
        });
      __syncthreads();
      // the multipliers of example s's head hh
      const auto keep = [&](int s, int hh) {
        return AttnBits{sBits + (s * NH + hh) * F, a.drop};
      };

      // 3. P (before dropout) into sG and o = (P m_s) v into sO, a thread a
      //    (head, row) pair
      for_pairs<NH>(n, F, [&](int s, int hh, int i) {
        attention_recompute_pair<DM, NH>(
            sN + s * F * L::NS, L::NS, sQKV + s * F * L::QS + 2 * DM, L::QS,
            sG + s * NH * F * F, sO + s * F * L::OS, L::OS, F, hh, i,
            keep(s, hh));
      });
      __syncthreads();

      // 4. zlin = o @ Wout (into dv's columns of sD, free until B2), u =
      //    relu?(zlin) m_z + x, y = LN_o(u); with g the outer LayerNorm's
      //    backward: du into sDU (the residual's share of dx) and dz =
      //    du m_z relu'(zlin) into sD's first DM columns
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
        for (int rb = 0; rb < ROWS; rb += kPass) {
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
              ln_acc[0][j] = fmaf(gv[j], v[j], ln_acc[0][j]);
              ln_acc[1][j] += gv[j];
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

      // 5. dWout += o^T dz, then do = dz @ Wout^T over o
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

      // 6. Attention backward, a thread a (head, row) pair in each pass:
      //    dv, then dS over P and dq, then dk, into sD
      for_pairs<NH>(n, F, [&](int s, int hh, int j) {
        attention_bwd_dv<DM, NH>(sG + s * NH * F * F, sO + s * F * L::OS,
                                 L::OS, sD + s * F * L::DS, L::DS, F, hh, j,
                                 keep(s, hh));
      });
      __syncthreads();
      for_pairs<NH>(n, F, [&](int s, int hh, int i) {
        attention_bwd_dq<DM, NH>(
            sG + s * NH * F * F, sO + s * F * L::OS, L::OS,
            sQKV + s * F * L::QS + 2 * DM, L::QS, sN + s * F * L::NS, L::NS,
            sD + s * F * L::DS, L::DS, F, hh, i, keep(s, hh));
      });
      __syncthreads();
      for_pairs<NH>(n, F, [&](int s, int hh, int j) {
        attention_bwd_dk<DM, NH>(sG + s * NH * F * F, sN + s * F * L::NS,
                                 L::NS, sD + s * F * L::DS, L::DS, F, hh, j);
      });
      __syncthreads();

      // 7. The transforms' backward (JAX _transform_bwd), from t0 = q0
      //    (k0) in sQKV and dt = dq (dk) in sD.  The table sums, per
      //    segment, one thread an element over the segment's rows in
      //    order, added into the block's slice once a segment: gate
      //    dT[d][c] += 2 sum_r t0[r][c] dt[r][c]; bilinear dT[d][h][k][c]
      //    += sum_r t0[r][h dh + k] dt[r][h dh + c].  Beside them dt0 in
      //    registers: gate dt TQ[d] 2, bilinear dt_h @ TQ[d, h]^T; written
      //    over dt after a barrier.
      constexpr int kElems = BILINEAR ? T : 2 * DM;
      for_segments(dm, n, F, [&](int d, int r0, int r1) {
        for (int e = tid; e < kElems; e += kThreads) {
          const int w = BILINEAR ? 0 : e / DM;
          if (!on[w]) continue;
          const int col = BILINEAR ? (e / (DH * DH)) * DH + e % DH : e % DM;
          const int row = BILINEAR ? (e / (DH * DH)) * DH + (e / DH) % DH
                                   : col;
          float s = 0.f;
#pragma unroll 4
          for (int r = r0; r < r1; ++r)
            s = fmaf(sQKV[r * L::QS + w * DM + row],
                     sD[r * L::DS + w * DM + col], s);
          tab_out[(w * D + d) * T + (BILINEAR ? e : col)] +=
              BILINEAR ? s : 2.f * s;
        }
      });
      float dt0[L::kPasses][2][4];
#pragma unroll
      for (int p = 0; p < L::kPasses; ++p) {
        const int r = p * kPass + tid / RT;
        if (r >= R) continue;
        const int d = dm[r / F];
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          if (!on[w]) continue;
          const float* dt = sD + r * L::DS + w * DM;
          if (BILINEAR) {
            // dt0[h dh + c0] = sum_l dt[h dh + l] TQ[d][h][c0][l], each of
            // the thread's 4 columns in its own head
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int hh = (c + j) / DH, c0 = (c + j) % DH;
              const float* m = trow(0, d) + hh * DH * DH + c0 * DH;
              float s = 0.f;
#pragma unroll
              for (int l = 0; l < DH; l += V) {
                float mv[V], dv[V];
                ldv<V>(m + l, mv);
                ldv<V>(dt + hh * DH + l, dv);
#pragma unroll
                for (int k = 0; k < V; ++k) s = fmaf(dv[k], mv[k], s);
              }
              dt0[p][w][j] = s;
            }
          } else {
            const float4 t = ld4(dt + c);
            const float4 gm = ld4(trow(w, d) + c);
            dt0[p][w][0] = t.x * gm.x * 2.f;
            dt0[p][w][1] = t.y * gm.y * 2.f;
            dt0[p][w][2] = t.z * gm.z * 2.f;
            dt0[p][w][3] = t.w * gm.w * 2.f;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int p = 0; p < L::kPasses; ++p) {
        const int r = p * kPass + tid / RT;
        if (r >= R) continue;
#pragma unroll
        for (int w = 0; w < 2; ++w)
          if (on[w]) st4(sD + r * L::DS + w * DM + c, dt0[p][w]);
      }
      __syncthreads();

      // 8. dWqkv += x^T [dq0|dk0|dv]; dx = du + [dq0|dk0|dv] @ Wqkv^T
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
      if (ti + 1 < ntiles) load_x(ex + E, min(E, nw - (ti + 1) * E));
    }
  }

  // The block's dense and LayerNorm sums into its slice (the table sums
  // are in place): the LayerNorm sums of the threads holding the same
  // columns added in thread order.
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
  for (int o = tid; o < kLnRows * DM; o += kThreads) {
    const int j = o / DM, col = o % DM, cg = col / 4, k = col % 4;
    float s = 0.f;
    for (int m = cg; m < kThreads; m += RT)
      s += red[(m * kLnRows + j) * 4 + k];
    out[4 * DM * DM + o] = s;
  }
}

template <int DM, int NH, bool BILINEAR>
cudaError_t launch(GateBwdArgs a, float* grads, int blocks,
                   cudaStream_t stream) {
  using L = GateTile<DM, NH, BILINEAR>;
  auto kernel = gate_stash_bwd_kernel<DM, NH, BILINEAR>;
  const int smem = L::bytes(a.F, a.D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static int configured = 0;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  a.chunk = block_chunk(a.B, a.F, blocks, L::ROWS);
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = static_cast<int>(grad_floats<DM, NH, BILINEAR>(a.D));
  sum_partials<<<(total + 255) / 256, 256, 0, stream>>>(a.partial, grads,
                                                        total, blocks);
  return cudaGetLastError();
}

// run(integral constant BILINEAR) for the shape (d, heads) this library
// is built for (the defines SATRANS_D and SATRANS_NH, ops/_build.py), else
// cudaErrorInvalidValue.
template <class Run>
cudaError_t with_gate_shape(int d, int heads, int bilinear, Run run) {
  if (d == SATRANS_D && heads == SATRANS_NH)
    return bilinear ? run(std::integral_constant<bool, true>{})
                    : run(std::integral_constant<bool, false>{});
  return cudaErrorInvalidValue;
}

}  // namespace

// The shape (d, heads) this library is built for; ops/gate_block.py keeps
// the shapes it builds in KERNEL_SHAPES.  partial holds blocks x
// satrans_gate_block_bwd_grad_floats(d, heads, D, bilinear) floats; grads
// receives the summed gradients in the layout written above.  -1 for a
// shape the library is not built for.
extern "C" int satrans_gate_block_bwd_grad_floats(int d, int heads, int D,
                                                  int bilinear) {
  int n = -1;
  with_gate_shape(d, heads, bilinear, [&](auto bl) {
    n = static_cast<int>(
        grad_floats<SATRANS_D, SATRANS_NH, decltype(bl)::value>(D));
    return cudaSuccess;
  });
  return n;
}

// The grid for B examples of F fields on a card of sms SMs: one block an
// SM, at most one a tile of the library's shape.
extern "C" int satrans_gate_block_bwd_blocks(int B, int F, int sms) {
  return stash_bwd_blocks(B, F, sms,
                          GateTile<SATRANS_D, SATRANS_NH, false>::ROWS);
}

// The body's dynamic shared memory (bytes) at F fields and D table rows
// (their tables staged where they fit); -1 for a shape the library is not
// built for.
extern "C" int satrans_gate_block_bwd_smem(int d, int heads, int D,
                                           int bilinear, int F) {
  int n = -1;
  with_gate_shape(d, heads, bilinear, [&](auto bl) {
    n = GateTile<SATRANS_D, SATRANS_NH, decltype(bl)::value>::bytes(F, D);
    return cudaSuccess;
  });
  return n;
}

// The same operands as satrans_gate_block_fwd, with g, dx and the scratch
// buffers; blocks is the grid (satrans_gate_block_bwd_blocks for the card;
// fewer give each block a longer range), and the result is deterministic
// for a grid.  Returns a cudaError_t.
extern "C" int satrans_gate_block_bwd(
    const float* x, const int* dom, const float* g, const float* wqkv,
    const float* tq, const float* tk, const float* wout, const float* lno,
    float* dx, float* partial, float* grads, int B, int F, int d, int heads,
    int D, int bilinear, int apply_q, int apply_k, int relu_out, int blocks,
    int drop_on, unsigned seed, unsigned threshold, float scale, int block_b,
    int fpad, int group, void* stream) {
  if (B < 1 || F < 1 || F > kMaxFields || D < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (drop_on && (block_b < 1 || fpad < F || group < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const GateBwdArgs a{x,       g,       wqkv,     tq,      tk,
                      wout,    lno,     dom,      dx,      partial,
                      B,       F,       D,        0,       apply_q,
                      apply_k, relu_out,
                      Dropout{drop_on, seed, threshold, scale, block_b, fpad,
                              group}};
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_gate_shape(d, heads, bilinear, [&](auto bl) {
    return launch<SATRANS_D, SATRANS_NH, decltype(bl)::value>(a, grads,
                                                              blocks, str);
  }));
}
