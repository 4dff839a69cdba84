// Device code shared by the layer kernels: K1 and K7 (meta_block_fwd.cu,
// meta_block_bwd.cu and the tile bodies meta_stash_fwd.cuh,
// meta_stash_bwd.cuh) and K6 (gate_block_fwd.cu, gate_block_bwd.cu).
//
// The LayerNorms reduce across a row's N/4 threads with shuffles, the
// backwards' blocks sum parameter gradients with one owner per element and
// sum_partials adds the blocks' sums in order, the gate and bilinear
// transform of K6 takes a row's 4 columns a thread (transform_cols), and
// the attention passes give a thread a (head, row) pair (the *_pair
// functions, which the tile bodies call on each example of their tiles).
// The attention logits are clamped to [-60, 60] before a
// max-subtracted softmax, as the Pallas kernels' _clip_logits
// (satrans_tpu/ops/pallas/meta_block.py:61-69); the backward passes the
// gradient through the clamp as if it were not there, as the Pallas custom VJPs
// do.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <initializer_list>

#include "dropout.cuh"

namespace {

constexpr int kMaxFields = 20;       // most fields an example may have
constexpr float kLogitClamp = 60.f;  // the Pallas kernels' _clip_logits

// A shape K1 and K7 are instantiated for: width d, MetaNet hidden widths
// h1 and h2 (h2 = 0: a 2-matrix MetaNet [d, h1, d]; else 3-matrix [d, h1,
// h2, d], whose middle matrix maps h1 to h2), heads.  HL is the width the
// last MetaNet matrix reads, HMAX the widest hidden row.
template <int DM_, int HID_, int HID2_, int NH_>
struct Shape {
  static constexpr int DM = DM_, HID = HID_, HID2 = HID2_, NH = NH_;
  static constexpr int HL = HID2 ? HID2 : HID;
  static constexpr int HMAX = HID2 > HID ? HID2 : HID;
};

// run(Shape<...>{}) for an instantiated (d, h1, h2, heads), else
// cudaErrorInvalidValue.  ops/meta_block.py keeps the same list in
// KERNEL_SHAPES.
template <typename Run>
cudaError_t with_shape(int d, int h, int h2, int heads, Run run) {
  if (d == 32 && h == 64 && heads == 4) {
    if (h2 == 0) return run(Shape<32, 64, 0, 4>{});
    if (h2 == 64) return run(Shape<32, 64, 64, 4>{});
  }
  return cudaErrorInvalidValue;
}

// The middle matrices' pointers (Q's and K's, and their transposes in the
// backward) are all set for a 3-matrix MetaNet (h2 > 0), all null else.
inline bool middle_pointers_ok(int h2, std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if ((p != nullptr) != (h2 > 0)) return false;
  return true;
}

// K1's residual stash (meta_block_fwd.cu, meta_block_bwd.cu): none (K1-fwd,
// K1-bwd), the full stash qkv, uq, uk, s and o (K1-stash, K1-bwd-stash),
// or the light one without the probabilities s (K1-stash light, K1-bwd-
// stash light).  kScores (K1-scores, forward only: the attention probes)
// writes the probabilities s and none of the other residuals.
enum StashMode : int {
  kNoStash = 0,
  kFullStash = 1,
  kLightStash = 2,
  kScores = 3
};

// Whether the residual pointers fit the stash mode: all null without a
// stash, all set in the full one, all but s (null) in the light one, s
// alone under kScores.
inline bool stash_pointers_ok(int mode, const void* qkv, const void* uq,
                              const void* uk, const void* s, const void* o) {
  const bool rest = qkv && uq && uk && o;
  switch (mode) {
    case kNoStash:
      return !(qkv || uq || uk || s || o);
    case kFullStash:
      return rest && s;
    case kLightStash:
      return rest && !s;
    case kScores:
      return s && !(qkv || uq || uk || o);
  }
  return false;
}

// K1's residuals, per example (none under kNoStash; s alone under
// kScores; all but s under kLightStash).
struct Stash {
  float *qkv, *uq, *uk, *s, *o;
};

// The MetaNet matrices of Q and K: W1 [rows, d, h1], the middle Wm [rows,
// h1, h2] (null for a 2-matrix MetaNet) and W2 [rows, HL, d].
struct MetaW {
  const float *w1q, *wmq, *w2q, *w1k, *wmk, *w2k;
};

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

// Sum over the N/4 consecutive lanes that hold one row of N values.
template <int N>
__device__ __forceinline__ float row_sum(float s) {
#pragma unroll
  for (int o = N / 8; o > 0; o >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// LayerNorm (eps 1e-6, two-pass moments) of a row of N values spread over
// its N/4 lanes, 4 per lane at columns col..col+3.  ln holds the scale row
// then the bias row.  Every lane of the warp must call it.
template <int N>
__device__ __forceinline__ void row_layer_norm(float (&v)[4],
                                               const float* __restrict__ ln,
                                               int col) {
  const float mean = row_sum<N>((v[0] + v[1]) + (v[2] + v[3])) * (1.f / N);
  float dv[4];
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    dv[c] = v[c] - mean;
    q = fmaf(dv[c], dv[c], q);
  }
  const float inv = rsqrtf(row_sum<N>(q) * (1.f / N) + 1e-6f);
  const float4 g = ldg4(ln + col), b = ldg4(ln + N + col);
  v[0] = dv[0] * inv * g.x + b.x;
  v[1] = dv[1] * inv * g.y + b.y;
  v[2] = dv[2] * inv * g.z + b.z;
  v[3] = dv[3] * inv * g.w + b.w;
}

// v -> xhat in place (as row_layer_norm); returns 1 / sqrt(var + eps).
// Every lane of the warp must call it.
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

// K6's transform of the 4 columns c..c+3 of one row of q0 (or k0) at t0,
// with the row's own domain's table row trow (in shared or device
// memory): the gate's t0 * trow * 2, or the bilinear map of the head that
// holds column c, q_h = q0_h @ trow[h] (trow the head's [dh, dh] maps in
// turn, row-major).  Into v.
template <int DM, int NH, bool BILINEAR>
__device__ __forceinline__ void transform_cols(const float* t0,
                                               const float* trow, int c,
                                               float (&v)[4]) {
  constexpr int DH = DM / NH;
  if constexpr (BILINEAR) {
    // q[h dh + c0 + j] = sum_k q0[h dh + k] T[h][k][c0 + j]
    const int hh = c / DH, c0 = c % DH;
    const float* m = trow + hh * DH * DH + c0;
    v[0] = v[1] = v[2] = v[3] = 0.f;
#pragma unroll
    for (int k = 0; k < DH; ++k) {
      const float q = t0[hh * DH + k];
      const float4 mk = ld4(m + k * DH);
      v[0] = fmaf(q, mk.x, v[0]);
      v[1] = fmaf(q, mk.y, v[1]);
      v[2] = fmaf(q, mk.z, v[2]);
      v[3] = fmaf(q, mk.w, v[3]);
    }
  } else {
    const float4 t = ld4(t0 + c);
    const float4 gm = ld4(trow + c);
    v[0] = t.x * (2.f * gm.x);
    v[1] = t.y * (2.f * gm.y);
    v[2] = t.z * (2.f * gm.z);
    v[3] = t.w * (2.f * gm.w);
  }
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

// q[c] = scale * row[c] for the DH values of a head.
template <int DH>
__device__ __forceinline__ void scaled_head(const float* row, float scale,
                                            float (&q)[DH]) {
#pragma unroll
  for (int c = 0; c < DH; c += 4) {
    const float4 v = ld4(row + c);
    q[c] = v.x * scale;
    q[c + 1] = v.y * scale;
    q[c + 2] = v.z * scale;
    q[c + 3] = v.w * scale;
  }
}

// acc[c] += p v[c] over the DH values of a head.
template <int DH>
__device__ __forceinline__ void axpy_head(float p, const float* v,
                                          float (&acc)[DH]) {
#pragma unroll
  for (int c = 0; c < DH; c += 4) {
    const float4 t = ld4(v + c);
    acc[c] = fmaf(p, t.x, acc[c]);
    acc[c + 1] = fmaf(p, t.y, acc[c + 1]);
    acc[c + 2] = fmaf(p, t.z, acc[c + 2]);
    acc[c + 3] = fmaf(p, t.w, acc[c + 3]);
  }
}

// The softmax of one (head, query row) pair from the head's query q (in
// registers, scaled by 1/sqrt(dh)) against the F key rows at k (row
// stride ks): the logits clamped, exponentiated after the row maximum is
// subtracted, into s, each passed on to visit(j, s[j]) as it is formed;
// returns their sum.  The keys go in groups of four without a branch
// inside a group, so that the loads, and a visit's dropout hashes, of one
// key overlap another's arithmetic: a key j past F in the last group reads
// row F - 1, counts as a -inf logit (s[j] = 0) and is visited as (F - 1,
// 0), which adds nothing, so the result is the per-key loop's bit for bit.
// Every pass that forms probabilities goes through it, so the
// probabilities a backward recomputes equal the forward's bit for bit.
template <int DH, typename Visit>
__device__ __forceinline__ float head_softmax_q(const float (&q)[DH],
                                                const float* k, int ks,
                                                int F,
                                                float (&s)[kMaxFields],
                                                Visit visit) {
  constexpr int G = 4;
  static_assert(kMaxFields % G == 0, "whole groups");
  float m = -INFINITY;
#pragma unroll
  for (int g = 0; g < kMaxFields; g += G) {
    if (g < F) {
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int j = g + u;
        const float* kj = k + min(j, F - 1) * ks;
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < DH; c += 4) {
          const float4 v = ld4(kj + c);
          a = fmaf(q[c], v.x, a);
          a = fmaf(q[c + 1], v.y, a);
          a = fmaf(q[c + 2], v.z, a);
          a = fmaf(q[c + 3], v.w, a);
        }
        a = fminf(fmaxf(a, -kLogitClamp), kLogitClamp);
        s[j] = j < F ? a : -INFINITY;
        m = fmaxf(m, s[j]);
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int g = 0; g < kMaxFields; g += G) {
    if (g < F) {
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int j = g + u;
        s[j] = expf(s[j] - m);
        sum += s[j];
        visit(min(j, F - 1), s[j]);
      }
    }
  }
  return sum;
}

// head_softmax_q of the head's q row at q_row, scaled here.
template <int DH, typename Visit>
__device__ __forceinline__ float head_softmax(const float* q_row,
                                              const float* k, int ks, int F,
                                              float (&s)[kMaxFields],
                                              Visit visit) {
  float q[DH];
  scaled_head<DH>(q_row, 1.f / sqrtf(static_cast<float>(DH)), q);
  return head_softmax_q<DH>(q, k, ks, F, s, visit);
}

// The probabilities of one (head hh, query row i) pair, normalised and
// before dropout, into row i of head hh of P ([NH][F][F]): those
// attention_fwd_pair stashes, bit for bit.  q|k lie in the rows of qk
// (stride ns) at columns 0 and DM.
template <int DM, int NH>
__device__ __forceinline__ void attention_probs_pair(const float* qk, int ns,
                                                     float* P, int F, int hh,
                                                     int i) {
  constexpr int DH = DM / NH;
  float s[kMaxFields];
  const float inv =
      1.f / head_softmax<DH>(qk + i * ns + hh * DH, qk + DM + hh * DH, ns, F,
                             s, [](int, float) {});
  float* prow = P + (hh * F + i) * F;
#pragma unroll
  for (int j = 0; j < kMaxFields; ++j)
    if (j < F) prow[j] = s[j] * inv;
}

// The attention dropout's multipliers m of one head's probabilities, for
// the backwards' passes: m.on() whether the dropout is on, m(i, j) the
// multiplier of probability (i, j).  AttnHash draws it from the hash
// (csrc/dropout.cuh) at each use; AttnBits reads it from bits drawn once a
// tile (attn_keep_row), bit j of word i of the head's rows: the same
// multipliers.
struct AttnHash {
  const Dropout& drop;
  const ExampleDraw& ed;
  unsigned salt;  // the head's draw
  __device__ bool on() const { return drop.on; }
  __device__ float operator()(int i, int j) const {
    return ed.attn(drop, salt, i, j);
  }
};

struct AttnBits {
  const unsigned* rows;  // the head's F words
  const Dropout& drop;
  __device__ bool on() const { return drop.on; }
  __device__ float operator()(int i, int j) const {
    return rows[i] >> j & 1u ? drop.scale : 0.f;
  }
};

// The keep bits of row i of a head's attention draw (salt): bit j set
// where probability (i, j) is kept.
__device__ __forceinline__ unsigned attn_keep_row(const Dropout& drop,
                                                  const ExampleDraw& ed,
                                                  unsigned salt, int i,
                                                  int F) {
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kMaxFields; ++j)
    if (j < F && ed.attn_kept(drop, salt, i, j)) bits |= 1u << j;
  return bits;
}

// One (head hh, query row i) pair of the forwards' attention from the
// head's query q (in registers, scaled by 1/sqrt(dh)): P =
// softmax(clamp(q k^T)) and o = (P m_s) v, accumulated from the
// unnormalised terms as they are formed and normalised at the end.  k|v
// lie in the rows of qkv (stride qs) at columns DM and 2 DM; o goes to row
// i of out (stride os), which may be q's own row of qkv.  m the head's
// dropout multipliers (AttnHash, AttnBits).  With STASH_S P before
// dropout goes to ps ([NH][F][F]).
template <int DM, int NH, bool STASH_S, class Keep>
__device__ __forceinline__ void attention_fwd_pair(
    const float (&q)[DM / NH], const float* qkv, int qs, float* out, int os,
    float* ps, int F, int hh, int i, const Keep& m) {
  constexpr int DH = DM / NH;
  float o[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) o[c] = 0.f;
  float s[kMaxFields];
  const float sum = head_softmax_q<DH>(
      q, qkv + DM + hh * DH, qs, F, s, [&](int j, float e) {
        const float pj = m.on() ? e * m(i, j) : e;
        axpy_head<DH>(pj, qkv + j * qs + 2 * DM + hh * DH, o);
      });
  const float inv = 1.f / sum;
#pragma unroll
  for (int c = 0; c < DH; c += 4) {
    const float v[4] = {o[c] * inv, o[c + 1] * inv, o[c + 2] * inv,
                        o[c + 3] * inv};
    st4(out + i * os + hh * DH + c, v);
  }
  if (STASH_S) {
    float* prow = ps + (hh * F + i) * F;
#pragma unroll
    for (int j = 0; j < kMaxFields; ++j)
      if (j < F) prow[j] = s[j] * inv;
  }
}

// The same with the query read from q's row i of qkv (column 0).
template <int DM, int NH, bool STASH_S, class Keep>
__device__ __forceinline__ void attention_fwd_pair(const float* qkv, int qs,
                                                   float* out, int os,
                                                   float* ps, int F, int hh,
                                                   int i, const Keep& m) {
  constexpr int DH = DM / NH;
  float q[DH];
  scaled_head<DH>(qkv + i * qs + hh * DH,
                  1.f / sqrtf(static_cast<float>(DH)), q);
  attention_fwd_pair<DM, NH, STASH_S>(q, qkv, qs, out, os, ps, F, hh, i, m);
}

// One (head hh, query row i) pair of the backwards' recomputed attention:
// P (normalised, before dropout) into row i of head hh of P ([NH][F][F])
// and o = (P m_s) v into row i of out (stride os).  q|k lie in the rows of
// qk (stride ns) at columns 0 and DM, v in the rows of v (stride vs); m
// the head's multipliers (AttnHash, AttnBits).
template <int DM, int NH, class Keep>
__device__ __forceinline__ void attention_recompute_pair(
    const float* qk, int ns, const float* v, int vs, float* P, float* out,
    int os, int F, int hh, int i, const Keep& m) {
  constexpr int DH = DM / NH;
  float s[kMaxFields];
  const float inv =
      1.f / head_softmax<DH>(qk + i * ns + hh * DH, qk + DM + hh * DH, ns, F,
                             s, [](int, float) {});
  float o[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) o[c] = 0.f;
  float* prow = P + (hh * F + i) * F;
#pragma unroll
  for (int j = 0; j < kMaxFields; ++j) {
    if (j < F) {
      prow[j] = s[j] * inv;
      const float pj = m.on() ? prow[j] * m(i, j) : prow[j];
      axpy_head<DH>(pj, v + j * vs + hh * DH, o);
    }
  }
#pragma unroll
  for (int c = 0; c < DH; c += 4) {
    const float w[4] = {o[c], o[c + 1], o[c + 2], o[c + 3]};
    st4(out + i * os + hh * DH + c, w);
  }
}

// The three passes of the attention backward of one example, each for
// one (head, row) pair; a pass may start only when the one before it has
// ended for every pair of the example.  do lies in the rows of dout
// (stride dos), v in v (stride vs), q|k in qk (stride ns) at columns 0 and
// DM; dq|dk|dv go to the rows of dqkv (stride ds) at columns 0, DM and
// 2 DM.  P ([NH][F][F]) holds the probabilities before dropout, m the
// head's dropout multipliers (AttnHash, AttnBits).
//
// Pass 1, per (head hh, key row j): dv_j = sum_i P_ij m_ij do_i.
template <int DM, int NH, class Keep>
__device__ __forceinline__ void attention_bwd_dv(
    const float* P, const float* dout, int dos, float* dqkv, int ds, int F,
    int hh, int j, const Keep& m) {
  constexpr int DH = DM / NH;
  float dv[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) dv[c] = 0.f;
#pragma unroll 4
  for (int i = 0; i < F; ++i) {
    float pij = P[(hh * F + i) * F + j];
    if (m.on()) pij *= m(i, j);
    axpy_head<DH>(pij, dout + i * dos + hh * DH, dv);
  }
#pragma unroll
  for (int c = 0; c < DH; c += 4) {
    const float w[4] = {dv[c], dv[c + 1], dv[c + 2], dv[c + 3]};
    st4(dqkv + j * ds + 2 * DM + hh * DH + c, w);
  }
}

// Pass 2, per (head hh, query row i): dS_ij = P_ij (dP_ij - sum_j P_ij
// dP_ij) with dP_ij = (do_i . v_j) m_ij, written over P, and dq_i = scale
// sum_j dS_ij k_j.
template <int DM, int NH, class Keep>
__device__ __forceinline__ void attention_bwd_dq(
    float* P, const float* dout, int dos, const float* v, int vs,
    const float* qk, int ns, float* dqkv, int ds, int F, int hh, int i,
    const Keep& m) {
  constexpr int DH = DM / NH;
  const float scale = 1.f / sqrtf(static_cast<float>(DH));
  float doi[DH];
  scaled_head<DH>(dout + i * dos + hh * DH, 1.f, doi);
  float* prow = P + (hh * F + i) * F;
  float dp[kMaxFields];
  float rs = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxFields; ++j) {
    if (j < F) {
      const float* vj = v + j * vs + hh * DH;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < DH; c += 4) {
        const float4 w = ld4(vj + c);
        s = fmaf(doi[c], w.x, s);
        s = fmaf(doi[c + 1], w.y, s);
        s = fmaf(doi[c + 2], w.z, s);
        s = fmaf(doi[c + 3], w.w, s);
      }
      if (m.on()) s *= m(i, j);
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
      const float dsij = prow[j] * (dp[j] - rs);
      prow[j] = dsij;
      axpy_head<DH>(dsij, qk + j * ns + DM + hh * DH, dq);
    }
  }
#pragma unroll
  for (int c = 0; c < DH; c += 4) {
    const float w[4] = {dq[c] * scale, dq[c + 1] * scale, dq[c + 2] * scale,
                        dq[c + 3] * scale};
    st4(dqkv + i * ds + hh * DH + c, w);
  }
}

// Pass 3, per (head hh, key row j): dk_j = scale sum_i dS_ij q_i.
template <int DM, int NH>
__device__ __forceinline__ void attention_bwd_dk(const float* P,
                                                 const float* qk, int ns,
                                                 float* dqkv, int ds, int F,
                                                 int hh, int j) {
  constexpr int DH = DM / NH;
  const float scale = 1.f / sqrtf(static_cast<float>(DH));
  float dk[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) dk[c] = 0.f;
#pragma unroll 4
  for (int i = 0; i < F; ++i)
    axpy_head<DH>(P[(hh * F + i) * F + j], qk + i * ns + hh * DH, dk);
#pragma unroll
  for (int c = 0; c < DH; c += 4) {
    const float w[4] = {dk[c] * scale, dk[c + 1] * scale, dk[c + 2] * scale,
                        dk[c + 3] * scale};
    st4(dqkv + j * ds + DM + hh * DH + c, w);
  }
}

}  // namespace
