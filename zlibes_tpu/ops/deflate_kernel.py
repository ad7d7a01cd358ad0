"""Device-side DEFLATE encode stages: symbol mapping, histograms, bit-packing.

Reference analog: the per-symbol encode loop at src/deflate.ts:183-226,
which calls BitWriteStream.write once *per bit*.  Device redesign:
tokens map to (code, nbits) fields via table gathers, bit offsets come from
an exclusive scan of field widths, and the payload is materialized with
word scatter-adds (each ≤15-bit field touches at most two u32 words).
Everything is batched over all blocks/segment-lanes of a dispatch.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import constants as C

# value→symbol/base/extra mappings are arithmetic (ops/symbol_math.py);
# no device-resident lookup tables remain on the encode path


@partial(jax.jit, static_argnames=("nseg",))
def token_symbols(
    toks_val: jax.Array,   # int32 (L, T)
    toks_dist: jax.Array,  # int32 (L, T)
    count: jax.Array,      # int32 (L,)
    nseg: int,             # segment lanes per block
):
    """Map tokens to litlen/dist symbols and build per-block histograms.

    Returns (lsym, dsym, valid, ll_freq (B,288), d_freq (B,32)); dsym is -1
    for literals.  Symbol mapping is arithmetic (ops/symbol_math.py).
    """
    from .symbol_math import dist_symbol, len_symbol

    L, T = toks_val.shape
    B = L // nseg
    tidx = jax.lax.broadcasted_iota(jnp.int32, (L, T), 1)
    valid = tidx < count[:, None]
    is_match = valid & (toks_dist > 0)
    vs = jnp.clip(toks_val, 0, C.MAX_MATCH)
    lsym = jnp.where(is_match, len_symbol(vs), toks_val)
    lsym = jnp.where(valid, lsym, 0)
    ds = jnp.clip(toks_dist, 0, C.WINDOW_SIZE)
    dsym = jnp.where(is_match, dist_symbol(ds), -1)

    # histograms via per-block sort + boundary bisection: a one-hot
    # matmul would materialize a (B, nseg*T, S) tensor; a 1-operand row
    # sort is cheap, and counts are differences of log-bisection ranks at
    # the S+1 class boundaries — no scatters, no one-hot.
    def hist(sym, mask, S):
        n = nseg * T
        rows = jnp.sort(jnp.where(mask, sym, S).reshape(B, n), axis=1)
        bounds = jnp.broadcast_to(
            jnp.arange(1, S + 1, dtype=jnp.int32)[None, :], (B, S))
        # batched monotone bisection: cnt[b] = #elements < b, all S
        # boundaries at once (one (B, S) gather per halving step)
        cnt = jnp.zeros((B, S), jnp.int32)
        step = 1 << (n - 1).bit_length()
        while step:
            mid = cnt + step
            v = jnp.take_along_axis(rows, jnp.minimum(mid, n) - 1, axis=1)
            cnt = jnp.where((mid <= n) & (v < bounds), mid, cnt)
            step //= 2
        ranks = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), cnt], axis=1)
        return jnp.diff(ranks, axis=1)

    ll_freq = hist(lsym, valid, C.NUM_LITLEN_SYMBOLS)
    d_freq = hist(jnp.where(is_match, dsym, C.NUM_DIST_SYMBOLS),
                  is_match, C.NUM_DIST_SYMBOLS)
    return lsym, dsym, valid, ll_freq, d_freq


@partial(jax.jit, static_argnames=("nseg", "W", "sub_every"))
def pack_payload(
    toks_val: jax.Array,    # int32 (L, T)
    toks_dist: jax.Array,   # int32 (L, T)
    lsym: jax.Array,        # int32 (L, T)
    dsym: jax.Array,        # int32 (L, T) (-1 for literals)
    valid: jax.Array,       # bool (L, T)
    ll_code: jax.Array,     # uint32 (B, 288) bit-reversed codes (LSB-first)
    ll_len: jax.Array,      # int32 (B, 288)
    d_code: jax.Array,      # uint32 (B, 32)
    d_len: jax.Array,       # int32 (B, 32)
    hdr_bits: jax.Array,    # int32 (B,) header length (incl. 3-bit prefix)
    enabled: jax.Array,     # bool (B,) pack this block (not stored)
    nseg: int,
    W: int,                 # u32 words per block buffer
    sub_every: int = 0,     # >0: also return per-lane sub-anchor splits
):
    """Scatter all token bit-fields into per-block word buffers.

    Returns (words (B, W) uint32, payload_end_bits (B,), lane_bit0 (L,)):
    payload_end_bits = bit offset just after the last token (EOB not
    included — the host appends it); lane_bit0 = bit offset of each segment
    lane's first token (the decode anchors).

    ``sub_every`` > 0 appends (sub_bit (L, T//sub_every), sub_out (L,
    T//sub_every)): for every ``sub_every``-byte output boundary j within
    the lane, the bit offset (relative to the block start) and within-lane
    output offset of the FIRST token starting at-or-after byte
    j*sub_every, or 2^30 sentinels when no such token exists in this lane
    (the host back-fills from the next boundary).  These are the uniform
    128-B anchors of the default-profile lane decoder
    (ops/lane_decode.py).
    """
    from .symbol_math import dist_extra, len_extra, onehot_rows

    L, T = toks_val.shape
    B = L // nseg
    blk2 = jax.lax.broadcasted_iota(jnp.int32, (L, T), 0) // nseg
    is_match = valid & (toks_dist > 0)

    vs = jnp.clip(toks_val, 0, C.MAX_MATCH)
    ds = jnp.clip(toks_dist, 0, C.WINDOW_SIZE)

    # per-block code/length lookups as batched one-hot matmuls (bf16 one-
    # hot is exact for 0/1; table values split into <=255 lo/hi columns so
    # every bf16 product is exact with f32 accumulation) — replaces 4
    # value-gathers per token
    def table_lookup(sym, codes, lens, S):
        oh = onehot_rows(jnp.clip(sym, 0, S - 1).reshape(B, nseg * T),
                         S, jnp.bfloat16)
        tab = jnp.stack([
            (codes & 0xFF).astype(jnp.bfloat16),
            (codes >> 8).astype(jnp.bfloat16),
            lens.astype(jnp.bfloat16),
        ], axis=2)  # (B, S, 3)
        r = jax.lax.dot_general(
            oh, tab, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)  # (B, nseg*T, 3)
        r = r.reshape(L, T, 3)
        code = (r[..., 0].astype(jnp.uint32)
                | (r[..., 1].astype(jnp.uint32) << 8))
        return code, r[..., 2].astype(jnp.int32)

    f1v, f1n = table_lookup(lsym, ll_code, ll_len, C.NUM_LITLEN_SYMBOLS)
    f1n = jnp.where(valid, f1n, 0)
    f3v, f3n = table_lookup(jnp.where(is_match, dsym, 0), d_code, d_len,
                            C.NUM_DIST_SYMBOLS)
    f3v = jnp.where(is_match, f3v, 0)
    f3n = jnp.where(is_match, f3n, 0)
    le_n, le_v = len_extra(vs)
    f2v = jnp.where(is_match, le_v, 0).astype(jnp.uint32)
    f2n = jnp.where(is_match, le_n, 0)
    de_n, de_v = dist_extra(ds)
    f4v = jnp.where(is_match, de_v, 0).astype(jnp.uint32)
    f4n = jnp.where(is_match, de_n, 0)

    tb = f1n + f2n + f3n + f4n  # total bits per token

    # bit offsets: within-lane exclusive scan + per-lane base within block
    lane_tot = jnp.sum(tb, axis=1)
    lane_cum = jnp.cumsum(lane_tot) - lane_tot  # global over lanes
    lane_id = jnp.arange(L, dtype=jnp.int32)
    blk_first = (lane_id // nseg) * nseg
    lane_base = lane_cum - lane_cum[blk_first]  # reset at block starts
    within = jnp.cumsum(tb, axis=1) - tb
    blk1 = lane_id // nseg
    tok_off = (lane_base + hdr_bits[blk1])[:, None] + within
    lane_bit0 = lane_base + hdr_bits[blk1]
    payload_end = jnp.zeros(B, jnp.int32).at[blk1].add(lane_tot) + hdr_bits

    words = jnp.zeros(B * W, jnp.uint32)
    en = enabled[blk2] & valid

    # combine the four fields into one <=48-bit (lo64, hi64) pair per
    # token, then scatter at most three words (instead of the naive 8)
    def _shr32m(x, s):
        return (x >> (jnp.uint32(31) - s)) >> 1  # x >> (32-s); 0 at s == 0

    def append_field(lo, hi, nb, v, n):
        v = v.astype(jnp.uint32) & ((jnp.uint32(1) << jnp.uint32(
            jnp.clip(n, 0, 31))) - 1)
        nbu = (nb & 31).astype(jnp.uint32)
        below = nb < 32
        lo = lo | jnp.where(below, v << nbu, 0)
        hi = hi | jnp.where(below, _shr32m(v, nbu), v << nbu)
        return lo, hi, nb + n

    zero = jnp.zeros_like(f1v)
    lo64, hi64, nb = append_field(zero, zero, jnp.zeros_like(f1n), f1v, f1n)
    lo64, hi64, nb = append_field(lo64, hi64, nb, f2v, f2n)
    lo64, hi64, nb = append_field(lo64, hi64, nb, f3v, f3n)
    lo64, hi64, nb = append_field(lo64, hi64, nb, f4v, f4n)

    w = blk2 * W + (tok_off >> 5)
    sh = (tok_off & 31).astype(jnp.uint32)
    w0v = lo64 << sh
    w1v = _shr32m(lo64, sh) | (hi64 << sh)
    w2v = _shr32m(hi64, sh)
    use = en & (tb > 0)
    OOB = B * W
    words = words.at[jnp.where(use, w, OOB).reshape(-1)].add(
        w0v.reshape(-1), mode="drop")
    words = words.at[jnp.where(use & (w1v > 0), w + 1, OOB).reshape(-1)].add(
        w1v.reshape(-1), mode="drop")
    words = words.at[jnp.where(use & (w2v > 0), w + 2, OOB).reshape(-1)].add(
        w2v.reshape(-1), mode="drop")

    if not sub_every:
        return words.reshape(B, W), payload_end, lane_bit0

    # wide-profile sub-anchors: first token at-or-after every sub_every-
    # byte output boundary of the lane (wout is nondecreasing along T, so
    # a masked min per boundary is exact)
    adv = jnp.where(valid, jnp.where(toks_dist > 0, vs, 1), 0)
    wout = jnp.cumsum(adv, axis=1) - adv
    BIGS = jnp.int32(1 << 30)
    sub_bits = []
    sub_outs = []
    within_abs = lane_bit0[:, None] + within
    for j in range(T // sub_every):
        m = valid & (wout >= j * sub_every)
        sub_bits.append(jnp.min(jnp.where(m, within_abs, BIGS), axis=1))
        sub_outs.append(jnp.min(jnp.where(m, wout, BIGS), axis=1))
    sub_bit = jnp.stack(sub_bits, axis=1)
    sub_out = jnp.stack(sub_outs, axis=1)
    return words.reshape(B, W), payload_end, lane_bit0, sub_bit, sub_out


def _seg_or_scan(c0: jax.Array, first: jax.Array) -> jax.Array:
    """Inclusive segmented OR along axis 1; ``first`` marks segment starts."""
    def comb(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf > 0, bv, av | bv), af | bf

    vv, _ = jax.lax.associative_scan(
        comb, (c0, first.astype(jnp.uint32)), axis=1)
    return vv


@partial(jax.jit, static_argnames=("nseg", "W", "R"))
def pack_payload_fast(
    toks_val: jax.Array,    # int32 (L, T)
    toks_dist: jax.Array,   # int32 (L, T)
    lsym: jax.Array,        # int32 (L, T)
    dsym: jax.Array,        # int32 (L, T) (-1 for literals)
    valid: jax.Array,       # bool (L, T)
    ll_code: jax.Array,     # uint32 (B, 288) bit-reversed codes (LSB-first)
    ll_len: jax.Array,      # int32 (B, 288)
    d_code: jax.Array,      # uint32 (B, 32)
    d_len: jax.Array,       # int32 (B, 32)
    hdr_bits: jax.Array,    # int32 (B,)
    enabled: jax.Array,     # bool (B,)
    nseg: int,
    W: int,                 # u32 words per block buffer
    R: int,                 # u32 words per lane row (>= max lane bits/32 + 2)
):
    """Scatter-free payload packing for <=32-bit tokens (turbo profile).

    pack_payload scatter-adds three words per token.  When every
    token fits 32 coded bits (CodecConfig.turbo() guarantees this via
    split_far), the bit stream has special structure: a token crosses at
    most ONE word boundary, so consecutive tokens' word indices advance by
    at most 1, every word owns a contiguous token run, and only the LAST
    token of a word's run carries bits into the next word.  Packing then
    decomposes into dense ops:

      1. per-token word index / shift from the bit-offset exclusive scan;
      2. segmented OR-scan accumulates each word's in-word contributions
         (the carry into word w+1 lives only in the run-end token, and its
         bits are disjoint from word w+1's own contributions — so byte-
         plane SUMS are exact ORs);
      3. run-end values place into per-lane word rows with ONE one-hot
         matmul over R word slots (exact: 0/1 one-hot x <=255 byte planes
         in bf16, f32 accumulation);
      4. one per-lane row scatter splices rows into the block buffers
         (L*R indices instead of 3*L*T).

    Same contract as pack_payload.
    """
    from .symbol_math import dist_extra, len_extra, onehot_rows

    L, T = toks_val.shape
    B = L // nseg
    blk2 = jax.lax.broadcasted_iota(jnp.int32, (L, T), 0) // nseg
    is_match = valid & (toks_dist > 0)

    vs = jnp.clip(toks_val, 0, C.MAX_MATCH)
    ds = jnp.clip(toks_dist, 0, C.WINDOW_SIZE)

    def table_lookup(sym, codes, lens, S):
        oh = onehot_rows(jnp.clip(sym, 0, S - 1).reshape(B, nseg * T),
                         S, jnp.bfloat16)
        tab = jnp.stack([
            (codes & 0xFF).astype(jnp.bfloat16),
            (codes >> 8).astype(jnp.bfloat16),
            lens.astype(jnp.bfloat16),
        ], axis=2)
        r = jax.lax.dot_general(
            oh, tab, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)
        r = r.reshape(L, T, 3)
        code = (r[..., 0].astype(jnp.uint32)
                | (r[..., 1].astype(jnp.uint32) << 8))
        return code, r[..., 2].astype(jnp.int32)

    f1v, f1n = table_lookup(lsym, ll_code, ll_len, C.NUM_LITLEN_SYMBOLS)
    f1n = jnp.where(valid, f1n, 0)
    f3v, f3n = table_lookup(jnp.where(is_match, dsym, 0), d_code, d_len,
                            C.NUM_DIST_SYMBOLS)
    f3v = jnp.where(is_match, f3v, 0)
    f3n = jnp.where(is_match, f3n, 0)
    le_n, le_v = len_extra(vs)
    f2v = jnp.where(is_match, le_v, 0).astype(jnp.uint32)
    f2n = jnp.where(is_match, le_n, 0)
    de_n, de_v = dist_extra(ds)
    f4v = jnp.where(is_match, de_v, 0).astype(jnp.uint32)
    f4n = jnp.where(is_match, de_n, 0)

    tb = f1n + f2n + f3n + f4n  # total bits per token, <= 32 by profile

    # combined <=32-bit field value (shift amounts clamped so a wider-than-
    # contract token corrupts only itself, not the lane)
    n12 = (f1n + f2n).astype(jnp.uint32)
    val = f1v | (f2v << f1n.astype(jnp.uint32))
    val = val | jnp.where(n12 < 32, f3v << jnp.minimum(n12, 31), 0)
    n123 = n12 + f3n.astype(jnp.uint32)
    val = val | jnp.where(n123 < 32, f4v << jnp.minimum(n123, 31), 0)

    # bit offsets (identical bookkeeping to pack_payload)
    lane_tot = jnp.sum(tb, axis=1)
    lane_cum = jnp.cumsum(lane_tot) - lane_tot
    lane_id = jnp.arange(L, dtype=jnp.int32)
    blk_first = (lane_id // nseg) * nseg
    lane_base = lane_cum - lane_cum[blk_first]
    within = jnp.cumsum(tb, axis=1) - tb
    blk1 = lane_id // nseg
    lane_bit0 = lane_base + hdr_bits[blk1]
    payload_end = jnp.zeros(B, jnp.int32).at[blk1].add(lane_tot) + hdr_bits

    en = enabled[blk2] & valid & (tb > 0)
    lane_word0 = lane_bit0 >> 5
    rel = within + (lane_bit0 & 31)[:, None]     # bit offset within lane row
    dw = jnp.where(en, rel >> 5, R)              # word slot; R = inactive
    sh = (rel & 31).astype(jnp.uint32)
    c0 = jnp.where(en, val << sh, 0)
    c1 = jnp.where(en, (val >> (jnp.uint32(31) - sh)) >> 1, 0)

    first = dw > jnp.pad(dw, ((0, 0), (1, 0)), constant_values=-1)[:, :T]
    acc = _seg_or_scan(c0, first)
    dw_next = jnp.pad(dw, ((0, 0), (0, 1)), constant_values=1 << 30)[:, 1:]
    is_end = (dw_next > dw) & en

    # place run-end values: ONE one-hot matmul; cols 0-3 = word w bytes,
    # cols 4-7 = the carry bytes (shifted one word right afterwards)
    oh = onehot_rows(jnp.where(is_end, dw, R), R, jnp.bfloat16)  # (L, T, R)
    vals8 = jnp.stack(
        [((acc >> (8 * k)) & 0xFF).astype(jnp.bfloat16) for k in range(4)]
        + [((c1 >> (8 * k)) & 0xFF).astype(jnp.bfloat16) for k in range(4)],
        axis=2)  # (L, T, 8)
    placed = jax.lax.dot_general(
        oh, vals8, dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)  # (L, R, 8)
    placed = placed.astype(jnp.int32).astype(jnp.uint32)

    def u32(b4):  # (L, R, 4) byte planes -> (L, R) words
        return (b4[..., 0] | (b4[..., 1] << 8) | (b4[..., 2] << 16)
                | (b4[..., 3] << 24))

    main = u32(placed[..., 0:4])
    carry = u32(placed[..., 4:8])
    rows = main | jnp.pad(carry, ((0, 0), (1, 0)))[:, :R]

    # splice lane rows into block buffers (single-word overlaps at lane
    # boundaries are disjoint-bit, so add == or)
    lane_en = enabled[blk1]
    OOB = B * W
    base = jnp.where(lane_en, blk1 * W + lane_word0, OOB)
    idx = base[:, None] + jax.lax.broadcasted_iota(jnp.int32, (L, R), 1)
    idx = jnp.where(idx < (blk1 * W + W)[:, None], idx, OOB)
    words = jnp.zeros(B * W + 1, jnp.uint32).at[idx.reshape(-1)].add(
        rows.reshape(-1), mode="drop")[: B * W]

    return words.reshape(B, W), payload_end, lane_bit0


def _token_fields(toks_val, toks_dist, valid, ll_code, ll_len, d_code,
                  d_len):
    """Per-token combined (value, nbits) field for <=32-bit tokens, from
    one shared code table pair (row 0 of the per-block arrays): litlen
    code, length extra, dist code, dist extra, packed LSB-first."""
    from .symbol_math import dist_extra, dist_symbol, len_extra, len_symbol

    ism = valid & (toks_dist > 0)
    lsym = jnp.where(ism, len_symbol(jnp.clip(toks_val, 3, C.MAX_MATCH)),
                     jnp.clip(toks_val, 0, C.NUM_LITLEN_SYMBOLS - 1))
    dsym = jnp.where(ism, dist_symbol(jnp.clip(toks_dist, 1, C.WINDOW_SIZE)),
                     0)
    code1 = jnp.take(ll_code[0], lsym).astype(jnp.uint32)
    n1 = jnp.where(valid, jnp.take(ll_len[0], lsym), 0)
    code3 = jnp.where(ism, jnp.take(d_code[0], dsym), 0).astype(jnp.uint32)
    n3 = jnp.where(ism, jnp.take(d_len[0], dsym), 0)
    le_n, le_v = len_extra(toks_val)
    len_en = jnp.where(ism, le_n, 0)
    len_ev = jnp.where(ism, le_v, 0).astype(jnp.uint32)
    de_n, de_v = dist_extra(toks_dist)
    dist_en = jnp.where(ism, de_n, 0)
    dist_ev = jnp.where(ism, de_v, 0).astype(jnp.uint32)
    n12 = n1 + len_en
    n123 = n12 + n3
    val = code1 | (len_ev << n1.astype(jnp.uint32))
    val = val | jnp.where(n12 < 32,
                          code3 << jnp.minimum(n12, 31).astype(jnp.uint32), 0)
    val = val | jnp.where(n123 < 32,
                          dist_ev << jnp.minimum(n123, 31).astype(jnp.uint32),
                          0)
    return val, n123 + dist_en


def _pack_rows_turbo(
    toks_val: jax.Array,    # int32 (L, T)
    toks_dist: jax.Array,   # int32 (L, T)
    valid: jax.Array,       # bool (L, T)
    ll_code: jax.Array,     # uint32 (B, 288) bit-reversed codes (LSB-first)
    ll_len: jax.Array,      # int32 (B, 288)
    d_code: jax.Array,      # uint32 (B, 32)
    d_len: jax.Array,       # int32 (B, 32)
    hdr_bits: jax.Array,    # int32 (B,)
    enabled: jax.Array,     # bool (B,)
    nseg: int,
    R: int,                 # u32 words per lane row (>= max lane bits/32 + 2)
):
    """Shared turbo pack core: per-token fields from the shared tables +
    per-lane sort compaction of run-end words into (L, R) lane rows.

    Tokens' word indices advance by <=1 (every coded token fits 32 bits,
    CodecConfig.turbo()'s split_far contract), so each word owns exactly
    one run-end token and compacting run-ends by word index IS the word
    buffer.

    Returns (rows (L, R) uint32, lane_tot (L,), lane_bit0 (L,),
    payload_end (B,), split_bit (L,), split_out (L,)); rows[l, j] is word
    j of lane l's coded bit run, relative to the lane's first stream word
    (lane_bit0 >> 5).  split_bit/split_out are the mid-segment
    anchor split — bit/output offsets (relative to the lane's first token)
    of the first token starting at-or-after output byte
    TURBO_SEG_SPAN/2 of the lane, 2^30 when every token starts earlier
    (the caller anchors the split at the lane end).  They pair each
    segment lane into two decode lanes (codec/lanes.py).
    """
    L, T = toks_val.shape
    B = L // nseg
    val, nb = _token_fields(toks_val, toks_dist, valid, ll_code, ll_len,
                            d_code, d_len)
    tb = jnp.where(valid, nb, 0)

    # bit offsets (identical bookkeeping to pack_payload)
    lane_tot = jnp.sum(tb, axis=1)
    lane_cum = jnp.cumsum(lane_tot) - lane_tot
    lane_id = jnp.arange(L, dtype=jnp.int32)
    blk_first = (lane_id // nseg) * nseg
    lane_base = lane_cum - lane_cum[blk_first]
    within = jnp.cumsum(tb, axis=1) - tb
    blk1 = lane_id // nseg
    lane_bit0 = lane_base + hdr_bits[blk1]
    payload_end = jnp.zeros(B, jnp.int32).at[blk1].add(lane_tot) + hdr_bits

    # mid-segment anchor split: first token whose output start >= half
    adv = jnp.where(valid, jnp.where(toks_dist > 0, toks_val, 1), 0)
    wout = jnp.cumsum(adv, axis=1) - adv
    cond = wout >= C.TURBO_SEG_SPAN // 2  # monotone along T
    BIGS = jnp.int32(1 << 30)
    split_bit = jnp.min(jnp.where(cond, within, BIGS), axis=1)
    split_out = jnp.min(jnp.where(cond, wout, BIGS), axis=1)

    blk2 = jax.lax.broadcasted_iota(jnp.int32, (L, T), 0) // nseg
    en = enabled[blk2] & valid & (tb > 0)
    lane_word0 = lane_bit0 >> 5
    rel = within + (lane_bit0 & 31)[:, None]     # bit offset within lane row
    BIG = jnp.int32(0x3FFFFFFF)
    dw = jnp.where(en, rel >> 5, BIG)            # word slot; BIG = inactive
    sh = (rel & 31).astype(jnp.uint32)
    c0 = jnp.where(en, val << sh, 0)
    c1 = jnp.where(en, (val >> (jnp.uint32(31) - sh)) >> 1, 0)

    first = dw > jnp.pad(dw, ((0, 0), (1, 0)), constant_values=-1)[:, :T]
    acc = _seg_or_scan(c0, first)
    dw_next = jnp.pad(dw, ((0, 0), (0, 1)), constant_values=1 << 30)[:, 1:]
    is_end = (dw_next > dw) & en

    # compact run-end (acc, carry) pairs to their word slots: dw is
    # nondecreasing with steps ∈ {0, 1}, so run-end tokens' dw values are
    # exactly 0..nwords-1 — a stable sort by (is_end ? dw : BIG) places
    # word w's value in column w
    key = jnp.where(is_end, dw, BIG)
    skey, sacc, sc1 = jax.lax.sort((key, acc, c1), dimension=1,
                                   is_stable=False, num_keys=1)
    iota_r = jax.lax.broadcasted_iota(jnp.int32, (L, R), 1)
    ok = skey[:, :R] == iota_r                   # self-validating mask
    main = jnp.where(ok, sacc[:, :R], 0)
    carry = jnp.where(ok, sc1[:, :R], 0)
    rows = main | jnp.pad(carry, ((0, 0), (1, 0)))[:, :R]
    lane_tot_masked = jnp.where(enabled[blk1], lane_tot, 0)
    return rows, lane_tot_masked, lane_bit0, payload_end, split_bit, split_out


@partial(jax.jit, static_argnames=("nseg", "W", "R"))
def pack_payload_turbo(
    toks_val: jax.Array,    # int32 (L, T)
    toks_dist: jax.Array,   # int32 (L, T)
    valid: jax.Array,       # bool (L, T)
    ll_code: jax.Array,     # uint32 (B, 288) bit-reversed codes (LSB-first)
    ll_len: jax.Array,      # int32 (B, 288)
    d_code: jax.Array,      # uint32 (B, 32)
    d_len: jax.Array,       # int32 (B, 32)
    hdr_bits: jax.Array,    # int32 (B,) header length (incl. 3-bit prefix)
    enabled: jax.Array,     # bool (B,) pack this block (not stored)
    nseg: int,
    W: int,                 # u32 words per block buffer
    R: int,                 # u32 words per lane row (>= max lane bits/32 + 2)
):
    """Shared-table payload packing (turbo profile): per-token fields from
    the shared tables + sort-compacted word placement into per-block
    W-word buffers (see _pack_rows_turbo).  Symbol mapping happens inside
    — no lsym/dsym inputs.

    Returns (words (B, W), payload_end (B,), lane_bit0 (L,),
    split_bit (L,), split_out (L,)): the last two are the mid-segment
    anchor split of _pack_rows_turbo.
    """
    L, T = toks_val.shape
    B = L // nseg
    rows, _lt, lane_bit0, payload_end, split_bit, split_out = \
        _pack_rows_turbo(toks_val, toks_dist, valid, ll_code, ll_len,
                         d_code, d_len, hdr_bits, enabled, nseg, R)
    blk1 = jnp.arange(L, dtype=jnp.int32) // nseg
    lane_word0 = lane_bit0 >> 5

    # splice lane rows into block buffers (single-word overlaps at lane
    # boundaries are disjoint-bit, so add == or)
    lane_en = enabled[blk1]
    OOB = B * W
    base = jnp.where(lane_en, blk1 * W + lane_word0, OOB)
    idx = base[:, None] + jax.lax.broadcasted_iota(jnp.int32, (L, R), 1)
    idx = jnp.where(idx < (blk1 * W + W)[:, None], idx, OOB)
    words = jnp.zeros(B * W + 1, jnp.uint32).at[idx.reshape(-1)].add(
        rows.reshape(-1), mode="drop")[: B * W]

    return words.reshape(B, W), payload_end, lane_bit0, split_bit, split_out


@partial(jax.jit, static_argnames=("nseg", "R", "F"))
def pack_payload_turbo_dense(
    toks_val: jax.Array,    # int32 (L, T)
    toks_dist: jax.Array,   # int32 (L, T)
    valid: jax.Array,       # bool (L, T)
    ll_code: jax.Array,     # uint32 (B, 288) bit-reversed codes (LSB-first)
    ll_len: jax.Array,      # int32 (B, 288)
    d_code: jax.Array,      # uint32 (B, 32)
    d_len: jax.Array,       # int32 (B, 32)
    hdr_bits: jax.Array,    # int32 (B,) header length (incl. 3-bit prefix)
    enabled: jax.Array,     # bool (B,)
    eob_len: jax.Array,     # int32 scalar: EOB code length (sizes the
                            # per-block tail word the host ORs EOB into)
    nseg: int,
    R: int,                 # u32 words per lane row (>= max lane bits/32 + 2)
    F: int = 80,            # filler slots per block (>= header words + 3)
):
    """Turbo pack straight to a COMPACTED stream image (round 4).

    Replaces pack_payload_turbo's per-block W-word buffers + host-driven
    gather_compressed download (a ~620K-index scatter-add plus an extra
    device round-trip) with device-side dense compaction:

      1. per-lane exclusive word regions: lane l owns dense words
         [blk_off[b] + W0[l], ... + W0[l+1]) of its block's compacted
         span (the last content lane extends to the block's used_words =
         (payload_end + eob_len + 31) // 32 + 1, covering the EOB tail
         word the host fills);
      2. the ONE shared word at each lane boundary is pre-merged (lane
         l+1's word 0 ORs lane l's carry — bit-disjoint by construction);
      3. a single global 2-operand sort by dense position splices every
         lane row AND compacts across blocks in one shot — no scatter.
         Filler elements cover each block's header words (device leaves
         [0, hdr_bits) zero for the host to OR the header into).

    The caller must know used_words exactly (it does: phase-1 per-block
    histograms x the shared code lengths give payload_end bit-exactly),
    so the downloaded image needs no device round-trip to size.

    Returns (dense (L*R + B*F,) uint32 — the first sum(used_words) words
    are the compacted stream image — payload_end (B,), lane_bit0 (L,),
    split_bit (L,), split_out (L,)).
    """
    L, T = toks_val.shape
    B = L // nseg
    rows, lane_tot, lane_bit0, payload_end, split_bit, split_out = \
        _pack_rows_turbo(toks_val, toks_dist, valid, ll_code, ll_len,
                         d_code, d_len, hdr_bits, enabled, nseg, R)
    lane_id = jnp.arange(L, dtype=jnp.int32)
    blk1 = lane_id // nseg
    used_words = (payload_end + eob_len + 31) // 32 + 1      # (B,)
    blk_off = jnp.cumsum(used_words) - used_words
    W0 = lane_bit0 >> 5
    lane_in_blk = lane_id % nseg
    is_last = lane_in_blk == nseg - 1
    has_bits = lane_tot > 0
    W0_next = jnp.pad(W0, (0, 1))[1:]
    succ_has = jnp.pad(has_bits, (0, 1))[1:] & ~is_last
    # empty segment lanes only trail a block (every covered segment emits
    # >= 1 token), so a content lane with no content successor owns the
    # block's tail words through used_words
    n_l = jnp.where(has_bits,
                    jnp.where(succ_has, W0_next - W0, used_words[blk1] - W0),
                    0)
    # pre-merge the shared boundary word into the successor's word 0
    carry = jnp.take_along_axis(rows, jnp.clip(n_l, 0, R - 1)[:, None],
                                axis=1)[:, 0]
    carry_in = jnp.pad(carry, (1, 0))[:L]
    carry_in = jnp.where(lane_in_blk == 0, 0, carry_in)
    rows = jnp.concatenate(
        [rows[:, :1] | carry_in[:, None].astype(rows.dtype), rows[:, 1:]],
        axis=1)

    BIGK = jnp.int32(0x3FFFFFFF)
    jrel = jax.lax.broadcasted_iota(jnp.int32, (L, R), 1)
    gkey = jnp.where(jrel < n_l[:, None],
                     (blk_off[blk1] + W0)[:, None] + jrel, BIGK)
    # filler: the header words of content blocks, or the whole used span
    # of content-free (empty / padded) blocks
    blk_has = jnp.any(has_bits.reshape(B, nseg), axis=1)
    fill_n = jnp.where(blk_has, hdr_bits >> 5, used_words)
    fm = jax.lax.broadcasted_iota(jnp.int32, (B, F), 1)
    fkey = jnp.where(fm < fill_n[:, None], blk_off[:, None] + fm, BIGK)

    keys = jnp.concatenate([gkey.reshape(-1), fkey.reshape(-1)])
    vals = jnp.concatenate([rows.reshape(-1),
                            jnp.zeros(B * F, rows.dtype)])
    _, dense = jax.lax.sort((keys, vals), dimension=0, is_stable=False,
                            num_keys=1)
    return dense, payload_end, lane_bit0, split_bit, split_out


@jax.jit
def gather_compressed(words_flat: jax.Array, idx: jax.Array) -> jax.Array:
    """Compact per-block word buffers into one dense array for download."""
    return words_flat[idx]
