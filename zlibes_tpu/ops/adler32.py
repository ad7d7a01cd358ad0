"""Tiled Adler-32 modular reduction (device-side).

Reference analog: the scalar two-accumulator loop at src/adler32.ts:1-10.
Device formulation: Adler-32 is associative under per-tile partials —
for a tile at byte offset o with local digits d_j:

    s1 += sum(d_j)
    s2 contribution = (n - o) * sum(d_j) - sum(j * d_j)   (mod 65521)

so the whole checksum is two masked reductions plus a tiny combine, all
int32-safe (no x64), fully vectorized.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..spec.constants import ADLER_MOD

_M = ADLER_MOD
_CHUNK = 2048  # sum(j*d_j) <= 255*2048^2/2 ≈ 5.3e8 < 2^31


def _mulmod(a, b):
    """(a*b) mod 65521 for 0 <= a,b < 65521 without int64.

    Splits b into high/low bytes so every intermediate stays < 2^31.
    """
    bh = b >> 8
    bl = b & 0xFF
    return ((a * bh) % _M * 256 + a * bl) % _M


def _modsum(x):
    """Sum of values each < 65521, reduced mod 65521, int32-safe."""
    n = x.shape[0]
    if n > 16384:
        pad = (-n) % 16384
        x = jnp.pad(x, (0, pad))
        x = jnp.sum(x.reshape(-1, 16384 // 512, 512), axis=-1) % _M
        x = x.reshape(-1)
    return jnp.sum(x) % _M


@partial(jax.jit, static_argnums=())
def _adler32_padded(data: jax.Array, n: jax.Array) -> jax.Array:
    """Adler-32 of data[:n]; data is uint8 padded to a multiple of _CHUNK."""
    npad = data.shape[0]
    nc = npad // _CHUNK
    d = data.reshape(nc, _CHUNK).astype(jnp.int32)
    idx = jax.lax.broadcasted_iota(jnp.int32, (nc, _CHUNK), 0) * _CHUNK + \
        jax.lax.broadcasted_iota(jnp.int32, (nc, _CHUNK), 1)
    d = jnp.where(idx < n, d, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (nc, _CHUNK), 1)
    a_c = jnp.sum(d, axis=1) % _M                 # sum of digits per chunk
    b_c = jnp.sum(j * d, axis=1) % _M             # sum of j*d_j per chunk
    offs = jnp.arange(nc, dtype=jnp.int32) * _CHUNK
    w = jnp.where(a_c > 0, (n - offs) % _M, 0)
    terms = (_mulmod(w, a_c) - b_c) % _M
    s1 = (1 + _modsum(a_c)) % _M
    s2 = (n % _M + _modsum(terms)) % _M
    return (s2.astype(jnp.uint32) << 16) | s1.astype(jnp.uint32)


def adler32(data: bytes | np.ndarray) -> int:
    """Device Adler-32 over a host byte buffer."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    n = arr.size
    # pad to a chunk multiple, bucketed to limit recompiles
    target = max(_CHUNK, 1 << (max(n, 1) - 1).bit_length())
    target = -(-target // _CHUNK) * _CHUNK
    padded = np.zeros(target, dtype=np.uint8)
    padded[:n] = arr
    return int(_adler32_padded(jnp.asarray(padded), jnp.int32(n)))


def adler32_device(data: jax.Array, n) -> jax.Array:
    """Jittable Adler-32 over a device uint8 array (padded, first n valid)."""
    pad = (-data.shape[0]) % _CHUNK
    if pad:
        data = jnp.pad(data, (0, pad))
    return _adler32_padded(data, jnp.asarray(n, jnp.int32))
