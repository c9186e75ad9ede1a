"""A NumPy twin of the parts of ``jax.random`` the capacity drift draws from.

``CapacityDrift`` (``core/time_model.py``) derives each cycle's capacity
factors from ``jax.random`` in the reference, and those factors decide the
integer allocations, so the port must draw the same numbers. A
``torch.Generator`` gives other bits; this module computes the reference's
own: the Threefry-2x32 block cipher (20 rounds) keyed as ``jax.random.key``
keys it, ``fold_in`` and ``split`` as jax derives keys, and float32
``uniform`` and ``normal`` as jax maps bits to floats.

It follows jax's partitionable Threefry layout (``jax_threefry_partitionable``
is True, the default since jax 0.5): element ``i`` of a draw is the cipher
of the 64-bit counter ``i``, and ``split(key, n)[i]`` equals
``fold_in(key, i)``.

Exactness: ``uniform`` is bitwise, since its bits go straight into the
mantissa. ``normal`` maps the uniform through XLA's float32 ``erf_inv``,
which this module repeats operation for operation as XLA evaluates it on the
CPU (its ``log1p`` and ``log`` approximations, its fused multiply-adds).
That agrees with jax bitwise on the draws the tests check, but XLA is free
to evaluate its approximations otherwise on another backend or release, so
the guarantee held is a normal draw within 2 float32 ulp of jax's.

A key is a (2,) uint32 array; every function also takes a (..., 2) array
of keys and draws for each, so a whole path of cycles is one NumPy call.
Seeds are integers in [0, 2**63); the key holds them as two uint32 words.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fold_in", "key", "normal", "random_bits", "split", "threefry2x32",
           "uniform"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 cipher of the counter words ``(x0, x1)`` under
    ``key``, a (..., 2) uint32 array of keys; keys and counters broadcast."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for block in range(5):
            for r in _ROTATIONS[block % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(block + 1) % 3]
            x[1] = x[1] + ks[(block + 2) % 3] + np.uint32(block + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s two uint32 words (as jax makes them from
    a 64-bit seed)."""
    seed = int(seed)
    if not 0 <= seed < 2**63:
        raise ValueError(f"seed must lie in [0, 2**63), got {seed}")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def fold_in(k: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in(k, data)`` for ``0 <= data < 2**32``; ``data``
    may be an array, giving one key for each of its elements."""
    data = np.asarray(data, np.uint64)
    if data.size and data.max() >= 2**32:
        raise ValueError("fold_in data must lie in [0, 2**32)")
    y0, y1 = threefry2x32(k, np.uint32(0), data.astype(np.uint32))
    return np.stack([y0, y1], axis=-1)


def _cipher_of_counters(k: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The cipher of the 64-bit counters 0..n-1 under each key of ``k``:
    (..., n) words."""
    counters = np.arange(n, dtype=np.uint64)
    hi = (counters >> np.uint64(32)).astype(np.uint32)
    lo = (counters & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return threefry2x32(np.asarray(k, np.uint32)[..., None, :], hi, lo)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)`` of each key of ``k``: (..., num, 2)."""
    y0, y1 = _cipher_of_counters(k, num)
    return np.stack([y0, y1], axis=-1)


def random_bits(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.bits(k, (n,), uint32)`` of each key of ``k``: (..., n)."""
    y0, y1 = _cipher_of_counters(k, n)
    return y0 ^ y1


def uniform(k: np.ndarray, n: int, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(k, (n,), float32, minval, maxval)`` of each key
    of ``k``, bitwise: (..., n). XLA fuses the scaling into one multiply-add."""
    lo, hi = np.float32(minval), np.float32(maxval)
    mant = (random_bits(k, n) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = mant.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


# XLA's float32 erf_inv on the CPU, operation for operation: the Giles
# polynomial over XLA's log1p (a Cephes rational approximation below
# sqrt(2) - 1, else the Cephes log of 1 + x). XLA evaluates the polynomials
# with fused multiply-adds; ``_fma`` computes one exactly in float64 (a
# float32 product is exact there) and rounds once more to float32.
_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
           0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
           1.50140941)
_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
           0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
           2.83297682)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_F32 = np.float32


def _fma(a, b, c) -> np.ndarray:
    a, b, c = (np.asarray(v, _F32).astype(np.float64) for v in (a, b, c))
    return (a * b + c).astype(_F32)


def _log_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log`` for x > 0 (the Cephes/Eigen approximation)."""
    x = np.maximum(np.asarray(x, _F32), _F32(1.17549435e-38))
    bits = x.view(np.uint32)
    m = ((bits & np.uint32(0x807FFFFF)) | _F32(0.5).view(np.uint32)).view(_F32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 0x7F).astype(_F32) + _F32(1.0)
    below = m < _F32(0.707106781186547524)
    e = e - np.where(below, _F32(1.0), _F32(0.0))
    m = (m - _F32(1.0)) + np.where(below, m, _F32(0.0))
    x2 = m * m
    x3 = x2 * m
    p = [_F32(c) for c in _LOG_P]
    y = _fma(_fma(p[0], m, p[1]), m, p[2])
    y1 = _fma(_fma(p[3], m, p[4]), m, p[5])
    y2 = _fma(_fma(p[6], m, p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _F32(-2.12194440e-4))
    m = _fma(-x2, _F32(0.5), m) + y
    return _fma(e, _F32(0.693359375), m)


def _horner(x: np.ndarray, coefs) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coefs:
        p = _fma(p, x, _F32(c))
    return p


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log1p`` for x > -1."""
    x = np.asarray(x, _F32)
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + _fma(_F32(-0.5), x2, small)
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small,
                    _log_f32(x + _F32(1.0)))


def _erf_inv_f32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, _F32)
    w = -_log1p_f32(x * -x)
    small = w < _F32(5.0)
    w = np.where(small, w - _F32(2.5), np.sqrt(w) - _F32(3.0))
    p = np.where(small, _F32(_W_LT_5[0]), _F32(_W_GE_5[0]))
    for a, b in zip(_W_LT_5[1:], _W_GE_5[1:]):
        p = _fma(p, w, np.where(small, _F32(a), _F32(b)))
    with np.errstate(invalid="ignore", over="ignore"):
        edge = x * _F32(np.inf)
    return np.where(np.abs(x) == _F32(1.0), edge, p * x)


def normal(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.normal(k, (n,), float32)`` of each key of ``k``:
    (..., n) (see the module docstring)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(k, n, lo, np.float32(1.0))
    return np.float32(np.sqrt(2)) * _erf_inv_f32(u)
