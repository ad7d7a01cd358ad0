"""On-device length-limited Huffman construction (SURVEY.md §2 C7).

The reference builds encode tables with a scalar merge-round loop
(/root/reference/src/huffman.ts:55-153).  This is the Larmore–Hirschberg
package-merge in matrix form, expressed entirely in jittable XLA ops —
histogram in, code lengths out, no host round-trip: package membership is
tracked as count vectors, each merge round is a pad + add + sort.

Semantically identical to deflate_pipeline.package_merge_np (the host
NumPy twin used where a dispatch round-trip would cost more than the
work).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# int32 throughout (x64 is disabled by default).  _BIG is the
# inactive-slot sentinel; BIG+BIG = 2^30 < 2^31 so pair sums never wrap,
# and frequencies are clipped so real package weights stay below _BIG.
_BIG = 1 << 29


@partial(jax.jit, static_argnames=("max_len",))
def package_merge_device(freqs: jax.Array, max_len: int) -> jax.Array:
    """Optimal length-limited code lengths for one histogram.

    freqs: (S,) int — symbol frequencies (0 = unused)
    Returns (S,) int32 code lengths with max <= max_len.  Matches
    package_merge_np's coded size exactly for frequencies below 2^29/4S
    (larger counts are clipped — the length-limited optimum is
    insensitive to scale at that magnitude); tie-breaking matches
    (stable order by weight, singletons before equal-weight packages).
    """
    S = freqs.shape[0]
    cap = _BIG // (4 * S)
    freqs = jnp.minimum(freqs.astype(jnp.int32), cap)
    used = freqs > 0
    n_active = jnp.sum(used.astype(jnp.int32))

    # singletons sorted by (weight, original index) — stable
    sw = jnp.where(used, freqs, _BIG).astype(jnp.int32)
    order = jnp.argsort(sw, stable=True)
    sw_sorted = sw[order]
    sm_sorted = jax.nn.one_hot(order, S, dtype=jnp.int32)  # (S, S) rows
    sm_sorted = jnp.where(used[order][:, None], sm_sorted, 0)

    # each round: packages = adjacent pairs of the previous list; merge
    # with the singletons; stable sort by weight.  List length is padded
    # to 2S (inactive slots carry weight BIG and empty membership).
    M = 2 * S

    def pad_to(w, m, length):
        return (jnp.full(length, _BIG, jnp.int32).at[: w.shape[0]].set(w),
                jnp.zeros((length, S), jnp.int32).at[: m.shape[0]].set(m))

    mw, mm = pad_to(sw_sorted, sm_sorted, M)
    swp, smp = pad_to(sw_sorted, sm_sorted, M)

    def round_fn(carry, _):
        mw, mm = carry
        pw = mw[0 : M - 1 : 2] + mw[1:M:2]
        pm = mm[0 : M - 1 : 2] + mm[1:M:2]
        pw = jnp.where(pw >= _BIG, _BIG, pw)
        pm = jnp.where((pw < _BIG)[:, None], pm, 0)
        allw = jnp.concatenate([swp, jnp.pad(pw, (0, M - pw.shape[0]),
                                             constant_values=_BIG)
                                ]).astype(jnp.int32)
        allm = jnp.concatenate([smp, jnp.pad(pm, ((0, M - pm.shape[0]),
                                                  (0, 0)))])
        o = jnp.argsort(allw, stable=True)[:M]
        return (allw[o], allm[o]), None

    (mw, mm), _ = jax.lax.scan(round_fn, (mw, mm), None, length=max_len - 1)

    take = jnp.arange(M) < (2 * n_active - 2)
    lengths = jnp.sum(jnp.where(take[:, None], mm, 0), axis=0)
    # single-symbol special case: one used symbol gets length 1
    single = jnp.where(used & (n_active == 1), 1, 0)
    return jnp.where(n_active == 1, single,
                     lengths).astype(jnp.int32)


@partial(jax.jit, static_argnames=("max_len",))
def limited_lengths_pair(ll_freq: jax.Array, d_freq: jax.Array,
                         max_len: int) -> tuple[jax.Array, jax.Array]:
    """Both encode-table length arrays in ONE dispatch (litlen + dist).

    The production entry point for on-device entropy construction
    (north star: "package-merge builder → on-device sort+prefix ops";
    reference analog /root/reference/src/huffman.ts:55-153): called by
    the shared-table turbo encode between its two device phases and by
    the sharded dynamic-table encode after the histogram psum.  Ensures
    at least one distance code (RFC 1951 wants HDIST >= 1), matching the
    host twin's ``d_len[0] = 1`` fixup.
    """
    ll = package_merge_device(ll_freq, max_len)
    d = package_merge_device(d_freq, max_len)
    d = jnp.where(jnp.max(d) == 0, d.at[0].set(1), d)
    return ll, d
