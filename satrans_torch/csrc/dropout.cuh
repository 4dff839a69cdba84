// In-kernel dropout of the meta-transformer layer, shared by
// meta_block_fwd.cu and meta_block_bwd.cu.
//
// The masks are those of the JAX package's interpret-mode in-kernel
// generator (satrans_tpu/ops/pallas/meta_block.py:94-147), the contract its
// tests pin, and of the plain version ops/prng.py:dropout_masks: a
// stateless counter hash, so the forward and the backward regenerate the
// same mask from (seed, draw, element) and no mask is kept in device
// memory.  The JAX kernel's tile is block_b examples of fpad fields (F
// rounded up to the kernel's field multiple, ops/prng.py:pad_fields); tile
// t is seeded with seed + t (uint32), and its draws in order are the Q
// MetaNet output and the K MetaNet output (each only if transformed), the
// attention probabilities once per head, and the output
// projection; draw k mixes in salt k.  An element's index is its row-major
// place in the draw's shape on that tile: [block_b * fpad, d] for the
// MetaNet outputs and the output projection, [block_b / g, g fpad, g fpad]
// for a head's probabilities, g examples packed block-diagonally.  The
// element is kept, and scaled by float32(1) / float32(1 - rate), when its
// 32 bits are at least int(rate * 2^32) (computed on the host).

#pragma once

struct Dropout {
  int on;              // 0: no dropout (inference, or rate 0)
  unsigned seed;       // the layer's seed; tile t draws with seed + t
  unsigned threshold;  // int(rate * 2^32)
  float scale;         // float32(1) / float32(1 - rate)
  int block_b;         // examples per JAX kernel tile
  int fpad;            // fields per example in the tile
  int group;           // examples per attention draw block
};

// lowbias32 of the mixed counter (meta_block.py:129-136).
__device__ __forceinline__ unsigned drop_bits(unsigned idx, unsigned seed_mix,
                                              unsigned salt) {
  unsigned x = idx ^ seed_mix;
  x += salt * 0x85EBCA6Bu + 0xC2B2AE35u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// One example's place in its tile's draws.
struct ExampleDraw {
  unsigned seed_mix;  // (seed + tile) * 0x9E3779B9
  unsigned row0;      // first row of the example in an N-shaped draw
  unsigned arow0;     // first row of the example in an attention draw
  unsigned acol0;     // its first column there
  unsigned n;         // group * fpad: the attention draw's row length

  __device__ ExampleDraw(const Dropout& d, int e) {
    const unsigned tile = static_cast<unsigned>(e / d.block_b);
    const unsigned loc = static_cast<unsigned>(e % d.block_b);
    seed_mix = (d.seed + tile) * 0x9E3779B9u;
    row0 = loc * d.fpad;
    n = static_cast<unsigned>(d.group * d.fpad);
    acol0 = (loc % d.group) * d.fpad;
    arow0 = (loc / d.group) * n + acol0;
  }

  // Multiplier of element (f, c) of an N-shaped site of width W.
  template <int W>
  __device__ __forceinline__ float rows(const Dropout& d, unsigned salt,
                                        int f, int c) const {
    const unsigned idx = (row0 + f) * W + c;
    return drop_bits(idx, seed_mix, salt) >= d.threshold ? d.scale : 0.f;
  }

  // Whether probability (i, j) of the head with draw salt is kept.
  __device__ __forceinline__ bool attn_kept(const Dropout& d, unsigned salt,
                                            int i, int j) const {
    const unsigned idx = (arow0 + i) * n + acol0 + j;
    return drop_bits(idx, seed_mix, salt) >= d.threshold;
  }

  // Multiplier of probability (i, j) of the head with draw salt.
  __device__ __forceinline__ float attn(const Dropout& d, unsigned salt,
                                        int i, int j) const {
    return attn_kept(d, salt, i, j) ? d.scale : 0.f;
  }
};

// Draw salts of the four sites: Q, K, the first head, the output.
struct DropSalts {
  unsigned q, k, s, z;
  __host__ __device__ DropSalts(int apply_q, int apply_k, int heads)
      : q(0), k(apply_q ? 1u : 0u),
        s(static_cast<unsigned>((apply_q ? 1 : 0) + (apply_k ? 1 : 0))),
        z(s + heads) {}
};
