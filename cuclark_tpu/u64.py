"""64-bit integer emulation as (hi, lo) uint32 pairs.

All k-mer math in the compute path runs on explicit (hi, lo) uint32
pairs — shifts with static amounts, bitwise ops, and comparisons — so
the device program needs no 64-bit integers: JAX's x64 mode is a
process-wide switch, and 32-bit lanes lower to plain vector ops on any
backend.  Whether native 64-bit integers would be faster on the H100 is
not measured.  Host-side code uses real numpy uint64 and converts at
the boundary.

A "pair" is a plain tuple (hi, lo) of equal-shape uint32 arrays.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32


def from_lo(lo):
    """Pair from a uint32 (hi = 0)."""
    lo = lo.astype(U32)
    return jnp.zeros_like(lo), lo


def from_np64(x: np.ndarray):
    """numpy uint64 array -> (hi, lo) device pair."""
    x = np.asarray(x, dtype=np.uint64)
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return jnp.asarray(hi), jnp.asarray(lo)


def to_np64(pair) -> np.ndarray:
    """(hi, lo) pair -> numpy uint64 array (host)."""
    hi, lo = pair
    hi = np.asarray(hi, dtype=np.uint64)
    lo = np.asarray(lo, dtype=np.uint64)
    return (hi << np.uint64(32)) | lo


def shl(pair, n: int):
    """Logical shift left by a static amount n in [0, 64]."""
    hi, lo = pair
    if n == 0:
        return hi, lo
    if n >= 64:
        z = jnp.zeros_like(lo)
        return z, z
    if n >= 32:
        return (lo << (n - 32)).astype(U32) if n > 32 else lo, jnp.zeros_like(lo)
    # 0 < n < 32
    new_hi = ((hi << n) | (lo >> (32 - n))).astype(U32)
    new_lo = (lo << n).astype(U32)
    return new_hi, new_lo


def shr(pair, n: int):
    """Logical shift right by a static amount n in [0, 64]."""
    hi, lo = pair
    if n == 0:
        return hi, lo
    if n >= 64:
        z = jnp.zeros_like(lo)
        return z, z
    if n >= 32:
        return jnp.zeros_like(hi), (hi >> (n - 32)).astype(U32) if n > 32 else hi
    new_lo = ((lo >> n) | (hi << (32 - n))).astype(U32)
    new_hi = (hi >> n).astype(U32)
    return new_hi, new_lo


def or_(a, b):
    return (a[0] | b[0], a[1] | b[1])


def and_(a, b):
    return (a[0] & b[0], a[1] & b[1])


def xor(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def not_(a):
    return (~a[0], ~a[1])


def eq(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


def lt(a, b):
    """Unsigned a < b."""
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def select(mask, a, b):
    return (jnp.where(mask, a[0], b[0]), jnp.where(mask, a[1], b[1]))


def min_(a, b):
    return select(lt(a, b), a, b)


def full_like(pair, value: int):
    """Constant pair broadcast to the shape of `pair`."""
    hi, lo = pair
    v = np.uint64(value)
    return (
        jnp.full_like(hi, np.uint32(v >> np.uint64(32))),
        jnp.full_like(lo, np.uint32(v & np.uint64(0xFFFFFFFF))),
    )
