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
  with fused multiply-adds as XLA compiles it on the CPU, and so is its
  ``log1p``: XLA's rational Cephes form for |x| < √2 − 1 and, above it,
  XLA's CPU ``log`` of 1 + x (the Cephes polynomial over the mantissa).
  numpy's own ``log1p`` differs from it in the last bit for about one
  argument in six, which moved about 1 % of the normals by 1–3 ulps.
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


# XLA's Log1p for |x| < sqrt(2) - 1: x - x²/2 + x³·P(x)/Q(x) (Cephes)
_LOG1P_NUM = np.array(
    [4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
     6.5787325942061044846969E0, 2.9911919328553073277375E1,
     6.0949667980987787057556E1, 5.7112963590585538103336E1,
     2.0039553499201281259648E1], np.float32)
_LOG1P_DEN = np.array(
    [1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
     2.2176239823732856465394E2, 3.0909872225312059774938E2,
     2.1642788614495947685003E2, 6.0118660497603843919306E1], np.float32)
# XLA's CPU log (Cephes): the polynomial over the reduced mantissa
_LOG_P = np.array(
    [7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
     1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
     3.3333331174E-1], np.float32)


def _fma(a, b, c) -> np.ndarray:
    """a·b + c rounded once to float32 (the fp32 product is exact in
    float64)."""
    return (np.float64(1) * a * b + c).astype(np.float32)


def _log_xla(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log`` on the CPU, for positive normal ``x``: split
    off the exponent, reduce the mantissa to [√½, √2), then the Cephes
    polynomial with its products fused into adds as XLA contracts them."""
    f32 = np.float32
    bits = x.astype(f32).view(np.uint32)
    e = ((bits >> _U32(23)).astype(np.int32) - 0x7F).astype(f32) + f32(1)
    m = ((bits & _U32(0x807FFFFF)) | f32(0.5).view(np.uint32)).view(f32)
    low = m < f32(0.707106781186547524)
    m = (m - f32(1)) + np.where(low, m, f32(0))
    e = e - np.where(low, f32(1), f32(0))
    x2 = m * m
    x3 = x2 * m
    P = _LOG_P
    y = _fma(m, P[0], P[1])
    y1 = _fma(m, P[3], P[4])
    y2 = _fma(m, P[6], P[7])
    y = _fma(y, m, P[2])
    y1 = _fma(y1, m, P[5])
    y2 = _fma(y2, m, P[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, f32(-2.12194440e-4) * e)
    m = _fma(f32(-0.5), x2, m) + y
    return _fma(f32(0.693359375), e, m)


def _log1p_xla(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log1p`` on the CPU, for x in (−1, 0]."""
    f32 = np.float32
    num = np.zeros_like(x)
    den = np.zeros_like(x)
    for a, b in zip(_LOG1P_NUM, _LOG1P_DEN):
        num = _fma(num, x, a)
        den = _fma(den, x, b)
    x2 = x * x
    small = x + _fma(f32(-0.5), x2, (x * x2) * (num / den))
    return np.where(np.abs(x) < f32(0.41421356237309504880), small,
                    _log_xla(x + f32(1)))


def _erf_inv(x: np.ndarray) -> np.ndarray:
    w = -_log1p_xla((-x) * x)
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
