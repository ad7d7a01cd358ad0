"""Arithmetic DEFLATE symbol mappings (gather-free).

The RFC 1951 length/distance code tables follow a strict geometric
pattern, so value→symbol/base/extra# are pure arithmetic — a handful of
dense ops in place of value-indexed table gathers.

Verified exhaustively against the constant tables in tests/test_config.py.
"""
from __future__ import annotations

import jax.numpy as jnp


def _bitlen(x):
    """floor(log2(x)) + 1 for x >= 1, exact (15 dense compares)."""
    n = jnp.zeros_like(x)
    for k in range(1, 16):
        n = n + (x >= (1 << k)).astype(x.dtype)
    return n + 1


def dist_symbol(dist):
    """Distance (1..32768) → dist symbol (0..29)."""
    d1 = jnp.maximum(dist, 1) - 1
    bl = _bitlen(jnp.maximum(d1, 1))        # bitlen(d-1)
    k = jnp.maximum(bl - 2, 0)              # extra bits for this range
    high = 2 * (k + 1) + ((d1 >> k) & 1)
    return jnp.where(dist <= 4, d1, high).astype(jnp.int32)


def dist_extra(dist):
    """(extra bit count, extra bit value) for a distance."""
    d1 = jnp.maximum(dist, 1) - 1
    bl = _bitlen(jnp.maximum(d1, 1))
    k = jnp.where(dist <= 4, 0, jnp.maximum(bl - 2, 0))
    base1 = jnp.where(dist <= 4, d1, ((2 + ((d1 >> k) & 1)) << k))
    return k.astype(jnp.int32), (d1 - base1).astype(jnp.int32)


def len_symbol(length):
    """Match length (3..258) → litlen symbol (257..285)."""
    m = jnp.clip(length - 3, 0, 255)
    bl = _bitlen(jnp.maximum(m, 1))
    e = jnp.maximum(bl - 3, 0)
    high = 257 + 4 * (e + 1) + ((m >> e) & 3)
    sym = jnp.where(m < 8, 257 + m, high)
    return jnp.where(length >= 258, 285, sym).astype(jnp.int32)


def len_extra(length):
    """(extra bit count, extra bit value) for a match length."""
    m = jnp.clip(length - 3, 0, 255)
    bl = _bitlen(jnp.maximum(m, 1))
    e = jnp.where(m < 8, 0, jnp.maximum(bl - 3, 0))
    base_m = jnp.where(m < 8, m, (4 + ((m >> e) & 3)) << e)
    en = jnp.where(length >= 258, 0, e)
    ev = jnp.where(length >= 258, 0, m - base_m)
    return en.astype(jnp.int32), ev.astype(jnp.int32)


def onehot_rows(idx, n, dtype=jnp.float32):
    """One-hot of idx (…,) over [0, n) — built densely for matmul lookups."""
    iota = jnp.arange(n, dtype=jnp.int32)
    return (idx[..., None] == iota).astype(dtype)
