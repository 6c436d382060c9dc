"""The JAX package's initial-weight draws, reproduced in numpy.

The reference draws ``mlp_teacher``'s initial weights with
``jax.random.normal`` under ``jax.random.PRNGKey(seed)`` and
``jax.random.split``.  Those are counter-based: Threefry-2x32 (20 rounds)
over an iota of counters, the 32 output bits turned into a uniform in
(−1, 1) through the mantissa, and that uniform into a normal through
XLA's single-precision ``erf_inv`` polynomial.  This module computes the
same steps on the host, so the port starts from the reference's weights
without importing JAX:

* the key, the split, the bits and the uniforms are integer arithmetic
  and bitwise the reference's (JAX's partitionable Threefry layout: the
  counter of element i is the 64-bit i as two 32-bit words, and the
  output is the two result words XOR-ed);
* ``erf_inv`` is the same polynomial with the same constants, evaluated
  with fused multiply-adds as XLA compiles it on the CPU.  ``log1p`` is
  numpy's, not XLA's, so about 1 % of the normals differ from the
  reference's by 1–3 ulps (``tests/test_torch_campaign.py`` states the
  bound).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's ErfInv32 (xla/client/lib/math.cc; StableHLO's chlo.erf_inv
# decomposition): Horner coefficients for w < 5 and for w >= 5
_ERFINV_SMALL = np.array(
    [2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941], np.float32)
_ERFINV_LARGE = np.array(
    [-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
     2.83297682], np.float32)

Key = Tuple[np.uint32, np.uint32]


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key: Key, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32 with 20 rounds on uint32 counter words."""
    k1, k2 = _U32(key[0]), _U32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    a, b = x1.astype(_U32), x2.astype(_U32)
    with np.errstate(over="ignore"):
        a = a + ks[0]
        b = b + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def _counters(shape) -> Tuple[np.ndarray, np.ndarray]:
    n = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    return ((n >> np.uint64(32)).astype(_U32).reshape(shape),
            (n & np.uint64(0xFFFFFFFF)).astype(_U32).reshape(shape))


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed below 2³²."""
    return _U32((seed >> 32) & 0xFFFFFFFF), _U32(seed & 0xFFFFFFFF)


def split(key: Key, num: int = 2):
    """``jax.random.split(key, num)`` as a list of keys."""
    hi, lo = threefry2x32(key, *_counters((num,)))
    return [(hi[i], lo[i]) for i in range(num)]


def random_bits(key: Key, shape) -> np.ndarray:
    """32 random bits per element of ``shape``."""
    hi, lo = threefry2x32(key, *_counters(shape))
    return hi ^ lo


def _erf_inv(x: np.ndarray) -> np.ndarray:
    w = -np.log1p((-x) * x)
    small = w < np.float32(5)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3)).astype(np.float32)
    p = np.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    w64 = w.astype(np.float64)
    for i in range(1, len(_ERFINV_SMALL)):
        c = np.where(small, _ERFINV_SMALL[i], _ERFINV_LARGE[i])
        # a fused multiply-add: the product is exact in float64
        p = (c.astype(np.float64) + p.astype(np.float64) * w64) \
            .astype(np.float32)
    return (p * x).astype(np.float32)


def normal(key: Key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    hi = np.float32(1.0)
    mant = (random_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    u = mant.view(np.float32) - np.float32(1.0)
    u = np.maximum(lo, u * (hi - lo) + lo)
    return (np.float32(np.sqrt(2)) * _erf_inv(u)).astype(np.float32)
