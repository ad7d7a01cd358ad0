"""Vectorized LZ77 match finding + greedy/lazy token selection.

Reference analog: the scalar hash-chain scan at src/lz77.ts:24-119 (exact
3-byte keys, newest-first candidates, greedy emission).  Device
redesign, built around dense ops and sorts instead of random element
gathers.

  * **Sort-based candidate discovery** (gather-free candidates): stable-sort
    (key, pos) per block; the J nearest previous occurrences of a
    position's key are its J predecessors in sorted order — *dense shifts*
    of the sorted arrays, no chain-walking gathers.
  * **Shared match-length probes**: gather S 32-bit windows per position
    once (S gathers/position total), then compare against shifted rows for
    every candidate at zero gather cost.  Match length = first XOR
    mismatch, counted in trailing zero bytes.  Caps at 4S+3 bytes.
  * **Run detection via scans**: dist-1 matches (the 258-byte RLE cases the
    cap would miss) from a reverse-cummin constant-run scan, no gathers.
  * **Segment-parallel greedy selection**: the left-to-right match/literal
    choice is a sequential cursor walk, so it runs as a batched while_loop
    over 4 KiB segment lanes (cursor resets at segment boundaries; matches
    clamp at segment end — a <0.1% ratio cost that buys ~1000× lane
    parallelism).  One-step lazy matching included (beats the reference's
    pure greedy, config[3]).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import constants as C

# match-length probe words per position (cap = 4*S_WORDS + 3 bytes)
S_WORDS = 16
# sorted-order candidates examined per position
J_CANDS = 16
# greedy selection segment (decode anchors reuse this granularity)
SEG = 4096


def _trailing_eq_bytes(x: jax.Array) -> jax.Array:
    """Number of trailing zero bytes of a uint32 XOR value (0..4)."""
    b0 = (x & 0xFF) == 0
    b1 = (x & 0xFFFF) == 0
    b2 = (x & 0xFFFFFF) == 0
    full = x == 0
    return jnp.where(
        full, 4, b0.astype(jnp.int32) + b1.astype(jnp.int32) + b2.astype(jnp.int32)
    )


@partial(jax.jit, static_argnames=("N", "S", "J", "reset", "two_phase"))
def find_matches(
    data: jax.Array,   # uint8 (B, N + 8) padded block bytes
    n_valid: jax.Array,  # int32 (B,) true byte count per block
    N: int,
    S: int = S_WORDS,  # probe words (match length cap = 4*S + 3)
    J: int = J_CANDS,  # sorted-order candidates per position
    reset: int = 0,    # window reset span (power of two): matches never
                       # reach back across a reset boundary, making every
                       # ``reset``-byte chunk independently resolvable (the
                       # turbo profile's window resets)
    two_phase: bool = False,  # rank candidates by their first probe word
                       # and exact-evaluate only the top two (the turbo
                       # speed profile; ~2x less matcher memory traffic)
    ctx_start: jax.Array | None = None,  # int32 (B,): first REAL byte of
                       # each row.  Rows with a context prefix (preset
                       # dictionary, RFC 1950 FDICT) left-pad it to a fixed
                       # width; positions below ctx_start are padding that
                       # the decoder does not have, so they must never be
                       # match sources (they'd emit distances reaching
                       # beyond dictionary + output — invalid streams)
):
    """Best match per position: packed int32 ``(len << 16) | dist``.

    len==0 where no match of ≥3 bytes exists.  Matches are intra-block
    (self-contained blocks), ≤ 32 KiB back, and clamped to the block tail.
    """
    B = data.shape[0]
    d32 = data.astype(jnp.uint32)
    # little-endian 32-bit windows at every byte position
    w32 = (
        d32[:, :N]
        | (d32[:, 1 : N + 1] << 8)
        | (d32[:, 2 : N + 2] << 16)
        | (d32[:, 3 : N + 3] << 24)
    )
    pos = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (B, N))
    key = (w32 & 0xFFFFFF).astype(jnp.int32)
    # invalidate tail keys (need 3 readable bytes) and context-padding
    # keys with unique sentinels
    valid_key = pos + 3 <= n_valid[:, None]
    if ctx_start is not None:
        valid_key = valid_key & (pos >= ctx_start[:, None])
    key = jnp.where(valid_key, key, 0x1000000 + pos)

    # the S probe windows ride the sort as extra operands instead of a
    # take_along_axis gather per window.
    # Probe word 0 does NOT ride: its low 3 bytes ARE the key, and its top
    # byte packs into the position operand's spare bits — one whole sort
    # operand saved (stable sort keeps equal-key order, so the packed high
    # bits never perturb candidate ordering).
    POSH = 20
    assert N <= 1 << POSH, "positions must fit the packed-pos field"
    pos_packed = pos | ((w32 >> 24).astype(jnp.int32) << POSH)
    wp = jnp.pad(w32, ((0, 0), (0, 4 * S)))
    ops = (key, pos_packed) + tuple(wp[:, 4 * s : 4 * s + N]
                                    for s in range(1, S))
    # window-reset profiles: matches never cross a ``reset`` boundary, so
    # the sort decomposes into independent ``reset``-element row sorts —
    # N/reset-fold shallower merge networks
    nrow = N // reset if (reset and N % reset == 0) else 1
    if nrow > 1:
        ops = tuple(o.reshape(B * nrow, reset) for o in ops)
    # chunked multi-operand sort: each lax.sort carries <= 15 payload
    # operands (17 total with key+pos), which bounds the sort program a
    # compiler has to build for large S.  Stable sorts keyed by the
    # IDENTICAL key array produce the identical permutation, so later
    # probe chunks splice in exactly.
    MAXP = 15
    head = jax.lax.sort(ops[: 2 + MAXP], dimension=1, is_stable=True,
                        num_keys=1)
    skey, sposp = head[0], head[1]
    sorted_probes = list(head[2:])
    for g0 in range(2 + MAXP, len(ops), MAXP):
        chunk = jax.lax.sort((ops[0],) + ops[g0 : g0 + MAXP], dimension=1,
                             is_stable=True, num_keys=1)
        sorted_probes += list(chunk[1:])
    sorted_ops = (skey, sposp, *sorted_probes)
    spos = sposp & ((1 << POSH) - 1)
    # probe word 0 reconstructed from (key, packed byte 3); sentinel-key
    # rows reconstruct garbage, but every use is masked by key equality
    probe0 = ((skey & 0xFFFFFF) | (sposp >> POSH << 24)).astype(w32.dtype)
    probes = jnp.stack([probe0] + list(sorted_ops[2:]))

    nv_row = jnp.repeat(n_valid, nrow) if nrow > 1 else n_valid
    limit = jnp.minimum(nv_row[:, None] - spos, C.MAX_MATCH)

    # candidate loop as fori_loop (compile-time stays O(1), not O(J));
    # pad once, slide with dynamic slices
    Bn, Nn = spos.shape
    spos_p = jnp.pad(spos, ((0, 0), (J, 0)))
    skey_p = jnp.pad(skey, ((0, 0), (J, 0)), constant_values=-1)
    probes_p = jnp.pad(probes, ((0, 0), (0, 0), (J, 0)))

    def cand_score(jj):
        """(validity, word-0 trailing bytes, dist) of candidate jj."""
        def sl(a):
            return jax.lax.dynamic_slice_in_dim(a, J - jj, Nn, axis=a.ndim - 1)

        cpos = sl(spos_p)
        ckey = sl(skey_p)
        dist = spos - cpos
        ok = (ckey == skey) & (dist >= 1) & (dist <= C.WINDOW_SIZE)
        if reset:
            assert reset & (reset - 1) == 0, "reset must be a power of two"
            ok = ok & ((cpos // reset) == (spos // reset))
        return ok, dist

    def full_len(jj, ok, dist):
        """Exact match length of candidate jj (trailing-eq over all S)."""
        def sl(a):
            return jax.lax.dynamic_slice_in_dim(a, J - jj, Nn, axis=a.ndim - 1)

        t = _trailing_eq_bytes(probes ^ sl(probes_p))
        alive = jnp.cumprod(
            jnp.concatenate([jnp.ones((1, Bn, Nn), jnp.int32),
                             (t[:-1] == 4).astype(jnp.int32)]), axis=0)
        ml = jnp.sum(t * alive, axis=0)
        ml = jnp.minimum(ml, limit)
        return jnp.where(ok & (ml >= C.MIN_MATCH), ml, 0)

    if two_phase:
        # Phase A: rank candidates by the word-0 trailing-equal bytes
        # (cheap: one XOR pass per candidate instead of S) and keep the
        # top two (nearest wins ties); phase B computes exact lengths for
        # those two only.  The rounds are memory-bound on the (S, B, N)
        # probe array, so this cuts the matcher's traffic ~S/2-fold at a
        # small quality cost (a farther candidate that ties the top two
        # on the first 4 bytes but runs longer may be missed).
        def rank_body(jj, carry):
            s1, j1, s2, j2 = carry
            ok, dist = cand_score(jj)
            t0 = _trailing_eq_bytes(
                probes[0] ^ jax.lax.dynamic_slice_in_dim(
                    probes_p[0], J - jj, Nn, axis=1))
            sc = jnp.where(ok, jnp.minimum(t0, limit), -1)
            b1 = sc > s1
            b2 = ~b1 & (sc > s2)
            s2n = jnp.where(b1, s1, jnp.where(b2, sc, s2))
            j2n = jnp.where(b1, j1, jnp.where(b2, jj, j2))
            s1n = jnp.where(b1, sc, s1)
            j1n = jnp.where(b1, jj, j1)
            return (s1n, j1n, s2n, j2n)

        neg = jnp.full((Bn, Nn), -1, jnp.int32)
        zero = jnp.zeros((Bn, Nn), jnp.int32)
        s1, j1, s2, j2 = jax.lax.fori_loop(
            1, J + 1, rank_body, (neg, zero, neg, zero))

        def eval_sel(jsel, valid):
            """Exact length/dist of the per-position candidate jsel:
            assemble the finalist's shifted probe rows with J dense
            selects per probe word, then one trailing-eq chain.

            ``valid`` is an explicit per-position validity lane: where it
            is False the finalist slot was never filled, and the zero-init
            accumulator below would otherwise alias a fake candidate with
            ckey=0/cpos=0 — which *matches real data* on zero-byte runs
            (the round-2 turbo corruption: a claimed (len,dist) at any
            position whose window contains zero triples).  Validity is
            decided by the caller from the phase-A score lane, never from
            a sentinel jsel value.
            """
            def gather_shift(arr2d):
                def body(jj, acc):
                    sh = jax.lax.dynamic_slice_in_dim(
                        arr2d, J - jj, Nn, axis=1)
                    return jnp.where(jsel == jj, sh, acc)
                return jax.lax.fori_loop(1, J + 1, body,
                                         jnp.zeros((Bn, Nn), arr2d.dtype))

            cpos = gather_shift(spos_p)
            ckey = gather_shift(skey_p)
            dist = spos - cpos
            ok = valid & (ckey == skey) & (dist >= 1) & (dist <= C.WINDOW_SIZE)
            if reset:
                ok = ok & ((cpos // reset) == (spos // reset))
            csel = jnp.stack([gather_shift(probes_p[s]) for s in range(S)])
            t = _trailing_eq_bytes(probes ^ csel)
            alive = jnp.cumprod(
                jnp.concatenate([jnp.ones((1, Bn, Nn), jnp.int32),
                                 (t[:-1] == 4).astype(jnp.int32)]), axis=0)
            ml = jnp.sum(t * alive, axis=0)
            ml = jnp.minimum(ml, limit)
            return jnp.where(ok & (ml >= C.MIN_MATCH), ml, 0), dist

        # evaluate both finalists only; a score of 0 is a *valid*
        # candidate (equal key, no shared word-0 bytes beyond the key —
        # it can still run >= MIN_MATCH via later probe words)
        ml1, d1 = eval_sel(j1, s1 >= 0)
        ml2, d2 = eval_sel(j2, s2 >= 0)
        better2 = ml2 > ml1
        best_ml = jnp.where(better2, ml2, ml1)
        best_dist = jnp.where(better2, d2, d1)
    else:
        def cand_body(jj, best):
            best_ml, best_dist = best
            ok, dist = cand_score(jj)
            ml = full_len(jj, ok, dist)
            better = ml > best_ml
            return (jnp.where(better, ml, best_ml),
                    jnp.where(better, dist, best_dist))

        best_ml, best_dist = jax.lax.fori_loop(
            1, J + 1, cand_body,
            (jnp.zeros((Bn, Nn), jnp.int32), jnp.zeros((Bn, Nn), jnp.int32)),
        )

    packed_sorted = (best_ml << 16) | best_dist
    # un-permute to position order with a second sort (scatter-free)
    _, packed = jax.lax.sort((spos, packed_sorted), dimension=1, num_keys=1)
    if nrow > 1:
        packed = packed.reshape(B, N)

    # dist-1 runs (covers long RLE matches beyond the probe cap):
    # clen[p] = length of the constant-byte run starting at p
    eq = (data[:, :N] == data[:, 1 : N + 1]) & (pos + 1 < n_valid[:, None])
    stop = jnp.where(eq, N, pos)  # first non-extending position ≥ p
    z = jax.lax.associative_scan(jnp.minimum, stop, reverse=True, axis=1)
    clen = z - pos + 1
    run_ml = jnp.minimum(
        jnp.minimum(jnp.pad(clen, ((0, 0), (1, 0)))[:, :N] - 1, C.MAX_MATCH),
        n_valid[:, None] - pos,
    )
    run_ok = (run_ml >= C.MIN_MATCH) & (pos >= 1)
    if reset:
        run_ok = run_ok & (pos % reset != 0)  # dist-1 source is pos-1
    if ctx_start is not None:
        run_ok = run_ok & (pos - 1 >= ctx_start[:, None])
    cur_ml = packed >> 16
    use_run = run_ok & (run_ml > cur_ml)
    packed = jnp.where(use_run, (run_ml << 16) | 1, packed)
    return packed


@partial(jax.jit, static_argnames=("N", "SEG_SIZE", "lazy", "start",
                                   "split_far"))
def select_tokens(
    data: jax.Array,     # uint8 (B, N + 8)
    matches: jax.Array,  # int32 (B, N) packed (len<<16)|dist
    n_valid: jax.Array,  # int32 (B,)
    N: int,
    SEG_SIZE: int = SEG,
    lazy: bool = True,
    start: int = 0,
    split_far: bool = False,  # turbo profile: cap (len>=131, dist>=2049)
    # matches at len 130 so no coded token exceeds 32 bits (the turbo
    # packer's one-word-boundary-per-token contract)
):
    """Greedy(+lazy) tokenization over segment lanes.

    Lane k of block b covers [start + k*SEG_SIZE, start + (k+1)*SEG_SIZE);
    matches are clamped at segment end so each segment's token cover is
    independent.  ``start`` > 0 marks a preset-dictionary context prefix:
    bytes below it are match targets but never tokenized.  Returns
    (toks_val (L, T), toks_dist (L, T), count (L,)) with
    L = B * (N-start)/SEG_SIZE lanes, token j of lane l at column j.
    """
    B = matches.shape[0]
    nseg = (N - start) // SEG_SIZE
    L = B * nseg
    T = SEG_SIZE

    mflat = matches.reshape(-1)
    dflat = data[:, :N].reshape(-1).astype(jnp.int32)

    lane = jnp.arange(L, dtype=jnp.int32)
    blk = lane // nseg
    seg0 = blk * N + start + (lane % nseg) * SEG_SIZE
    nv = n_valid[blk]
    seg_end = jnp.minimum(seg0 + SEG_SIZE, blk * N + nv)

    toks_val = jnp.zeros((T, L), jnp.int32)
    toks_dist = jnp.zeros((T, L), jnp.int32)
    count = jnp.zeros(L, jnp.int32)
    cursor = seg0
    active = seg0 < seg_end

    def cond(state):
        t, _c, active, _cnt, _tv, _td = state
        return (t < T) & jnp.any(active)

    def body(state):
        t, c, active, count, toks_val, toks_dist = state
        csafe = jnp.minimum(c, B * N - 1)
        pb = mflat[csafe]
        ml = pb >> 16
        dist = pb & 0xFFFF
        lit = dflat[csafe]
        ml = jnp.minimum(ml, seg_end - c)  # clamp at segment end
        if split_far:
            ml = jnp.where((ml >= 131) & (dist >= 2049), 130, ml)
        use = ml >= C.MIN_MATCH
        if lazy:
            pb1 = mflat[jnp.minimum(csafe + 1, B * N - 1)]
            ml1 = pb1 >> 16
            defer = use & (ml < C.MAX_MATCH) & (ml1 > ml) & (c + 1 < seg_end)
            use = use & ~defer
        tv = jnp.where(use, ml, lit)
        td = jnp.where(use, dist, 0)
        adv = jnp.where(use, ml, 1)
        emit = active
        tv = jnp.where(emit, tv, 0)
        td = jnp.where(emit, td, 0)
        toks_val = jax.lax.dynamic_update_slice(toks_val, tv[None, :], (t, 0))
        toks_dist = jax.lax.dynamic_update_slice(toks_dist, td[None, :], (t, 0))
        count = count + emit.astype(jnp.int32)
        c = jnp.where(active, c + adv, c)
        active = active & (c < seg_end)
        return (t + 1, c, active, count, toks_val, toks_dist)

    state = (jnp.int32(0), cursor, active, count, toks_val, toks_dist)
    _t, _c, _a, count, toks_val, toks_dist = jax.lax.while_loop(cond, body, state)
    return toks_val.T, toks_dist.T, count
