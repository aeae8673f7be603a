"""Sampled picks: the JAX package's ``jax.random.categorical`` draw,
transcribed to numpy.

The JAX engine picks a sampled token with

    key = fold_in(fold_in(PRNGKey(seed), rid), len(out_tokens))
    categorical(key, row / temperature)

under JAX's default PRNG (``threefry2x32``) with partitionable counters
(``jax_threefry_partitionable = True``).  ``categorical`` is the Gumbel-max
trick: ``argmax(row + gumbel)``, the noise ``-log(-log(u))`` of uniforms
``u`` in ``[tiny, 1)`` made from the mantissa bits of 32 random bits per
vocabulary entry.  This module computes the same key, bits and uniforms
bit for bit on the host (the card has no JAX), and the noise with numpy's
float32 ``log``, which differs from XLA's by an ulp on some inputs: the
noise agrees to 2 ulp, and a pick can differ only where the perturbed
row's top two are closer than that.  The pick stays on the host in
float32, so the card and the CPU differ only by their logits.

The examples draw their prompts and frames as the JAX package's do, with
:func:`randint` (``jax.random.randint``, bit for bit) and :func:`normal`
(``jax.random.normal``, within an ulp of the draws' largest magnitude).

The static batch loop draws differently (``Engine.generate_static``): one
key split per step, ``key, sub = split(key)``, and one
``categorical(sub, logits[B, V])`` over the whole batch, whose noise is
the ``B * V`` uniforms of ``sub`` in row-major order.
"""

from __future__ import annotations

import numpy as np

__all__ = ["prng_key", "fold_in", "split", "random_bits", "uniform", "gumbel",
           "randint", "normal", "pick_key", "sample", "categorical"]

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)
_TINY = np.finfo(np.float32).tiny


def _threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x0, x1)``
    (uint32 arrays of one shape) under the key ``(k0, k1)``."""
    ks = (_U32(k0), _U32(k1), _U32(k0) ^ _U32(k1) ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 += x1
            x1 = (x1 << _U32(r)) | (x1 >> _U32(32 - r))
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as JAX builds it with 64-bit types off:
    the seed's low 32 bits, under a zero high word."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the counter pair ``(0, data)``."""
    with np.errstate(over="ignore"):
        y0, y1 = _threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                               np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` with partitionable counters: key ``i``
    is the hash of the counter pair ``(0, i)``, as :func:`fold_in` of
    ``i``.  Returns [num, 2] uint32."""
    with np.errstate(over="ignore"):
        y0, y1 = _threefry2x32(key[0], key[1], np.zeros(num, np.uint32),
                               np.arange(num, dtype=np.uint32))
    return np.stack([y0, y1], axis=1)


def random_bits(key: np.ndarray, n: int) -> np.ndarray:
    """32 random bits for each of ``n`` draws (``jax.random.bits``):
    partitionable counters, so draw ``i`` hashes the pair ``(0, i)`` and
    keeps the xor of the two output words."""
    with np.errstate(over="ignore"):
        y0, y1 = _threefry2x32(key[0], key[1], np.zeros(n, np.uint32),
                               np.arange(n, dtype=np.uint32))
    return y0 ^ y1


def uniform(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.uniform(key, (n,), minval=tiny, maxval=1)`` in float32:
    the top 23 bits as the mantissa of a float in [1, 2), less one, then
    clamped from below at ``tiny``."""
    bits = (random_bits(key, n) >> _U32(9)) | _U32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(np.float32(_TINY), floats + np.float32(_TINY))


def gumbel(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.gumbel`` noise (its default low-range mode) in float32."""
    return -np.log(-np.log(uniform(key, n)))


def randint(key: np.ndarray, shape, lo: int, hi: int) -> np.ndarray:
    """``jax.random.randint(key, shape, lo, hi)`` (int32, ``lo < hi``):
    ``k1, k2 = split(key)``, 32 bits of each per draw, then
    ``((bits(k1) % span) * m + bits(k2) % span) % span`` with
    ``m = (2**16 % span)**2 % span``, every product in uint32 that wraps,
    as JAX computes it.  A multi-dimensional draw's bits are its
    row-major flat index's."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    span = _U32(hi - lo)
    k1, k2 = split(key)
    with np.errstate(over="ignore"):
        m = _U32(1 << 16) % span
        m = (m * m) % span
        off = ((random_bits(k1, n) % span) * m + random_bits(k2, n) % span) % span
    return (np.int32(lo) + off.astype(np.int32)).reshape(shape)


# the coefficients of Giles' single-precision erfinv, as XLA evaluates it
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                        -4.39150654e-06, 0.00021858087, -0.00125372503,
                        -0.00417768164, 0.246640727, 1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                        -0.00367342844, 0.00573950773, -0.0076224613,
                        0.00943887047, 1.00167406, 2.83297682], np.float32)


def _erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` (Giles' polynomial in ``w = -log1p(-x²)``),
    each Horner step a fused multiply-add (float64, rounded once)."""
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
    for lo_c, hi_c in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, lo_c, hi_c)
        p = (p.astype(np.float64) * w + c).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max,
                    p * x).astype(np.float32)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32: ``sqrt(2) *
    erfinv(u)``, ``u`` uniform in ``[nextafter(-1, 0), 1)`` from the draws'
    mantissa bits.  The uniforms are JAX's bit for bit; the draws agree to
    an ulp of their largest magnitude (XLA's ``log1p`` is not numpy's)."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    bits = (random_bits(key, n) >> _U32(9)) | _U32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    u = np.maximum(lo, floats * (np.float32(1) - lo) + lo)
    return (np.float32(np.sqrt(2)) * _erfinv(u)).reshape(shape)


def pick_key(seed: int, rid: int, position: int) -> np.ndarray:
    """The key of request ``rid``'s pick of its ``position``-th token."""
    return fold_in(fold_in(prng_key(seed), rid), position)


def sample(row: np.ndarray, temperature: float, key: np.ndarray) -> int:
    """The sampled pick from one float32 logits row: ``argmax(row /
    temperature + noise)`` (no division at temperature 1, as in the JAX
    engine)."""
    row = np.asarray(row, np.float32)
    if temperature != 1.0:
        row = row / np.float32(temperature)
    return int(np.argmax(gumbel(key, row.shape[0]) + row))


def categorical(key: np.ndarray, logits: np.ndarray) -> np.ndarray:
    """``jax.random.categorical(key, logits)`` over the last axis of float32
    ``logits`` [..., V]: ``argmax(logits + gumbel)``, the noise the
    ``logits.size`` draws of ``key`` in row-major order.  Returns the
    picks [...] (int64)."""
    logits = np.asarray(logits, np.float32)
    noise = gumbel(key, logits.size).reshape(logits.shape)
    return np.argmax(noise + logits, axis=-1)
