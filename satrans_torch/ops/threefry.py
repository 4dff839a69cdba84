"""The part of ``jax.random`` that the JAX package's dropout draws from.

A twin of JAX's default PRNG (threefry2x32 with
``jax_threefry_partitionable=True``, the default of JAX 0.9): the JAX
package's model and Trainer turn their keys into one int32 seed per layer
(``satrans_tpu/models/satrans.py:448-450``, ``train/trainer.py:616``,
``:655``), and the port draws the same seeds from the same keys.  Its
XLA layers and the baseline zoo draw their dropout masks with
``jax.random.bernoulli`` (``satrans_tpu/nn/core.py:59-64``);
:func:`bernoulli` draws the same masks bit for bit.

A key is a pair of uint32 words ``(k1, k2)``.  Each word is a Python int
or an int64 tensor holding uint32 values (many keys at once); every
uint32 operation runs in int64 and is masked back to 32 bits, so the same
code runs on torch tensors and on Python ints.  The model and the Trainer
draw their few seeds a step with ints: one hash costs a few microseconds
there against about a millisecond as a chain of scalar torch ops.

Here are :func:`PRNGKey`, :func:`split`, :func:`fold_in`, :func:`randint`
with ``shape=()`` and int32 bounds, and :func:`random_bits`,
:func:`uniform` and :func:`bernoulli` in float32 at any shape, on tensors
of the caller's device.  The module imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """JAX's ``threefry2x32_p``: the 20-round Threefry-2x32 hash of the
    counter words ``(x1, x2)`` under the key ``(k1, k2)``, elementwise with
    broadcasting (``prng.py:_threefry2x32_lowering``)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1, x2 = (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def PRNGKey(seed: int):
    """``jax.random.PRNGKey(seed)`` for an int32 seed: the words
    ``(0, seed mod 2**32)``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside int32")
    return 0, seed & _M32


def split(key, num: int = 2):
    """``jax.random.split(key, num)`` as a list of ``num`` keys: the hashes
    of the counters ``(0, i)`` (``_threefry_split_foldlike``)."""
    return [threefry2x32(*key, 0, i) for i in range(num)]


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` for uint32 ``data``: the hash of
    the counter words ``(0, data)`` (``_threefry_fold_in``)."""
    return threefry2x32(*key, 0, data & _M32)


def randint(key, minval: int = 0, maxval: int = 2 ** 31 - 1):
    """``jax.random.randint(key, (), minval, maxval, jnp.int32)`` for
    ``-2**31 <= minval < maxval < 2**31`` (``random.py:_randint``): 32 bits
    from each half of ``split(key)`` (the xored words of the hash of the
    counter ``(0, 0)``), combined modulo the span in wrapping uint32
    arithmetic."""
    if not -2 ** 31 <= minval < maxval < 2 ** 31:
        raise ValueError(f"bounds [{minval}, {maxval}) outside int32")
    hi, lo = (b1 ^ b2 for b1, b2 in (threefry2x32(*k, 0, 0)
                                      for k in split(key)))
    span = maxval - minval
    # JAX squares 2**16 mod span in uint32: 0 for spans past 2**16
    mult = ((2 ** 16 % span) ** 2 & _M32) % span
    off = (((hi % span) * mult & _M32) + lo % span) & _M32
    return minval + off % span


def layer_seeds(key, layers: int) -> list[int]:
    """The per-layer dropout seeds of one step under ``key``:
    ``randint(fold_in(key, i))`` for each layer ``i``, as the JAX SATrans
    draws them (models/satrans.py:448-450)."""
    return [int(randint(fold_in(key, i))) for i in range(layers)]


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` (``prng.py:
    _threefry_random_bits_partitionable``) as an int64 tensor of uint32
    values on ``device``: element ``i`` (row-major) is the xor of the two
    words of the hash of the 64-bit counter ``i``, split into its high and
    low 32 bits (``iota_2x32_shape``)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(*(int(k) for k in key), idx >> 32, idx & _M32)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in ``[0, 1)``
    (``random.py:_uniform``): the top 23 bits of :func:`random_bits` as
    the mantissa of a float in ``[1, 2)``, minus 1."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key, p: float, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float32 ``p``
    (``random.py:_bernoulli``, mode 'low'): a bool tensor, ``uniform <
    float32(p)``."""
    return uniform(key, shape, device) < torch.tensor(
        p, dtype=torch.float32, device=device)
