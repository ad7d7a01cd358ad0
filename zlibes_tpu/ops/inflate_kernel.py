"""Batched table-driven DEFLATE payload decode + parallel LZ resolution.

The general device redesign of the reference's bit-serial decoder
(src/inflate.ts:237-291, one BitReadStream.read() call per bit, plus the
byte-at-a-time back-copy loop at :287-290).

Formulation:
  * Decode lanes are *chunks* of a block delimited by sync anchors the
    encoder records (bit offset + output offset at a token boundary, every
    ~4 KiB of output).  The symbol decode while_loop is latency-bound per
    iteration, so throughput = lanes/iteration — anchors turn one 128 KiB
    block (~45k sequential symbols) into ~32 lanes of ~1.4k symbols each.
    Each iteration decodes one symbol per lane: a 32-bit stream window from
    two gathers, a flat Huffman-table gather, data-dependent cursor advance.
  * LZ back-references are resolved *globally* in parallel (chunks of one
    block legally reference each other): scatter+cumsum maps every output
    byte to its producing token, overlapping copies (dist < len) fold
    closed-form via modular indexing, and pointer-doubling with path
    compression resolves all chains in O(log depth) gather rounds.

All shapes are static per (B, T, M, D, O) bucket so XLA compiles a small
number of programs.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .huffman import KIND_EOB, KIND_LENGTH


def make_windows(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Host-side precompute: per-byte-position 32-bit little-endian windows.

    Returns (w32, padded_bytes); window(bitpos) in the kernel is
    ``(w32[p] >> s) | (bytes[p+4] << (24-s) << 8)`` with p=bitpos>>3,
    s=bitpos&7, giving 32 valid stream bits at any bit offset.
    """
    b = np.concatenate([np.frombuffer(data, dtype=np.uint8), np.zeros(8, np.uint8)])
    w32 = (
        b[:-8].astype(np.uint32)
        | (b[1:-7].astype(np.uint32) << 8)
        | (b[2:-6].astype(np.uint32) << 16)
        | (b[3:-5].astype(np.uint32) << 24)
    )
    return w32, b


def _window(w32, bytes_u8, bitpos):
    """32 valid stream bits starting at bit offset ``bitpos`` (LSB-first)."""
    p = (bitpos >> 3).astype(jnp.int32)
    s = (bitpos & 7).astype(jnp.uint32)
    lo = w32[p] >> s
    hi = (bytes_u8[p + 4].astype(jnp.uint32) << (jnp.uint32(24) - s)) << 8
    return lo | hi


@partial(jax.jit, static_argnames=("T", "M", "D"))
def decode_tokens(
    w32: jax.Array,        # uint32 (Nb,) stream windows
    bytes_u8: jax.Array,   # uint8 (Nb+8,) stream bytes
    litlen_tab: jax.Array, # int32 (NB, 2^M) per-block tables
    dist_tab: jax.Array,   # int32 (NB, 2^D)
    table_row: jax.Array,  # int32 (B,) lane → owning block's table row
    bit0: jax.Array,       # int32 (B,) lane start bit offsets
    end_bit: jax.Array,    # int32 (B,) lane end bit offsets (exact)
    active0: jax.Array,    # bool (B,) lanes to decode
    T: int, M: int, D: int,
):
    """Decode up to T tokens per lane.  Token j of lane b is at column j.

    A lane completes when it hits EOB or its cursor reaches end_bit.
    Returns (toks_val, toks_dist, count, bitpos, active, err):
      toks_val: literal byte (dist==0) or match length (dist>0)
      count:    tokens emitted per lane
      bitpos:   bit cursor after the last consumed symbol
      active:   lanes still mid-chunk after T tokens (caller resumes)
      err:      invalid code / cursor overshot end_bit
    """
    ll_flat = litlen_tab.reshape(-1)
    d_flat = dist_tab.reshape(-1)
    lane_ll = table_row << M
    lane_d = table_row << D
    mmask = jnp.uint32((1 << M) - 1)
    dmask = jnp.uint32((1 << D) - 1)
    B = bit0.shape[0]

    toks_val = jnp.zeros((T, B), dtype=jnp.int32)
    toks_dist = jnp.zeros((T, B), dtype=jnp.int32)
    count = jnp.zeros(B, dtype=jnp.int32)
    err = jnp.zeros(B, dtype=jnp.bool_)

    def cond(state):
        t, _bitpos, active, _err, _c, _tv, _td = state
        return (t < T) & jnp.any(active)

    def body(state):
        t, bitpos, active, err, count, toks_val, toks_dist = state
        # one 64-bit window (two gathers) serves both lookups: the dist
        # code starts ≤20 bits in, needs ≤28 more → bit 48 < 55 available
        p = (bitpos >> 3).astype(jnp.int32)
        s = (bitpos & 7).astype(jnp.uint32)
        A = w32[p]
        Bw = w32[p + 4]
        w = jnp.where(s == 0, A, (A >> s) | (Bw << (jnp.uint32(32) - s)))
        whi = Bw >> s
        e = ll_flat[lane_ll + (w & mmask).astype(jnp.int32)]
        L = (e & 15).astype(jnp.uint32)
        kind = (e >> 4) & 3
        val = (e >> 6) & 1023
        eb = ((e >> 16) & 7).astype(jnp.uint32)
        length = val + ((w >> L) & ((jnp.uint32(1) << eb) - 1)).astype(jnp.int32)
        k = L + eb  # 1..20
        p2 = bitpos + k.astype(jnp.int32)
        w2 = (w >> k) | (whi << (jnp.uint32(32) - k))
        de = d_flat[lane_d + (w2 & dmask).astype(jnp.int32)]
        dL = (de & 15).astype(jnp.uint32)
        deb = ((de >> 4) & 15).astype(jnp.uint32)
        dbase = (de >> 8) & 0xFFFF
        dist = dbase + ((w2 >> dL) & ((jnp.uint32(1) << deb) - 1)).astype(jnp.int32)

        is_len = kind == KIND_LENGTH
        is_eob = kind == KIND_EOB
        bad = (L == 0) | (kind == 3) | (is_len & ((dL == 0) | (((de >> 24) & 1) == 1)))
        newpos = jnp.where(
            is_len, p2 + (dL + deb).astype(jnp.int32), bitpos + L.astype(jnp.int32)
        )
        bad = bad | (newpos > end_bit)

        emit = active & ~bad & ~is_eob
        tv = jnp.where(emit, jnp.where(is_len, length, val), 0)
        td = jnp.where(emit, jnp.where(is_len, dist, 0), 0)
        toks_val = jax.lax.dynamic_update_slice(toks_val, tv[None, :], (t, 0))
        toks_dist = jax.lax.dynamic_update_slice(toks_dist, td[None, :], (t, 0))
        count = count + emit.astype(jnp.int32)
        err = err | (active & bad)
        bitpos = jnp.where(active & ~bad, newpos, bitpos)
        active = active & ~bad & ~is_eob & (newpos < end_bit)
        return (t + 1, bitpos, active, err, count, toks_val, toks_dist)

    state = (jnp.int32(0), bit0, active0, err, count, toks_val, toks_dist)
    _t, bitpos, active, err, count, toks_val, toks_dist = jax.lax.while_loop(
        cond, body, state
    )
    return toks_val.T, toks_dist.T, count, bitpos, active, err


@partial(jax.jit, static_argnames=("O",))
def resolve_global(
    toks_val: jax.Array,   # int32 (B, T)
    toks_dist: jax.Array,  # int32 (B, T)
    count: jax.Array,      # int32 (B,)
    out_base: jax.Array,   # int32 (B,) lane output offsets (≥ prefix length)
    total: jax.Array,      # int32 scalar: prefix + window output bytes
    prefix: jax.Array,     # uint8 (P,) already-resolved bytes at [0, P)
    O: int,
):
    """Expand per-lane token streams into one global output byte array.

    Coordinates: [0, P) is the pre-resolved prefix (the 32 KiB halo when
    resolving a large stream in windows — positions there are known);
    lanes' output ranges tile [P, total).  Copies may reference any earlier
    coordinate (self-contained *blocks*, not chunks).  A token may start
    before P (a copy straddling the window boundary); its pre-P positions
    are served by the prefix.  Returns (out (O,) uint8, err scalar) where
    err marks references below coordinate 0.  O ≤ 2^23 (source positions
    pack into 23 bits of the combined resolve state).

    The design minimizes indexed passes: ONE token scatter (packed val|dist), ONE token-start scatter +
    cummax forward-fill (replacing a marks-scatter + per-byte gathers),
    and ONE per-byte gather for token metadata; then pointer-doubling
    rounds touch only the shrinking unresolved set (sort-compacted).
    """
    assert O <= 1 << 23, "resolve dispatch output must be ≤ 8 MiB"
    B, T = toks_val.shape
    P = prefix.shape[0]
    tidx = jax.lax.broadcasted_iota(jnp.int32, (B, T), 1)
    valid = tidx < count[:, None]
    is_copy = valid & (toks_dist > 0)
    tok_len = jnp.where(valid, jnp.where(is_copy, toks_val, 1), 0)
    ends = jnp.cumsum(tok_len, axis=1)
    g_end = out_base[:, None] + ends
    g_start = g_end - tok_len

    # Tokens overlapping [P, O) scatter at their first in-window byte.
    # Positions are unique: at most one token can straddle any boundary,
    # and tokens ending at/before P are dropped.
    in_win = valid & (g_end > P) & (g_start < O)
    posf = jnp.where(in_win, jnp.maximum(g_start, P), O).reshape(-1)
    # val ≤ 258 (9 bits) << 16 | dist ≤ 32768 (16 bits): one packed scatter
    packed = ((toks_val << 16) | toks_dist).reshape(-1)
    svd = jnp.zeros(O, jnp.int32).at[posf].set(packed, mode="drop")
    # forward-fill the covering token's true start (monotonic → cummax)
    sstart = jnp.full(O, -1, jnp.int32).at[posf].set(
        g_start.reshape(-1), mode="drop")
    o_q = jax.lax.cummax(sstart)

    # ONE per-byte gather: token metadata lives at the token's scatter slot
    q = jnp.arange(O, dtype=jnp.int32)
    vd = svd[jnp.clip(jnp.maximum(o_q, P), 0, O - 1)]
    d_q = vd & 0xFFFF
    v_q = vd >> 16
    incopy = (d_q > 0) & (q >= P) & (q < total)
    dsafe = jnp.maximum(d_q, 1)
    src = jnp.where(incopy, o_q - d_q + ((q - o_q) % dsafe), q)
    err = jnp.any(incopy & (src < 0))
    src = jnp.clip(src, 0, O - 1)

    # Combined per-byte state, one gather per pointer-doubling round:
    #   resolved: bit31 set, value in bits 0-7
    #   unresolved: source position in bits 8-30 (O must be ≤ 2^23)
    flag = jnp.int32(-0x80000000)
    pref_pad = jnp.zeros(O - P, dtype=jnp.uint8)
    pref_vals = jnp.concatenate([prefix, pref_pad]).astype(jnp.int32)
    literal_val = jnp.where(q < P, pref_vals, v_q & 0x1FF)
    state = jnp.where(incopy, src << 8, (literal_val & 0xFF) | flag)

    def full_round(state):
        # one hop with path doubling: a resolved source yields its value,
        # an unresolved one yields its own (already-jumped) source pointer
        e2 = state[jnp.where(state >= 0, state >> 8, 0)]
        return jnp.where(state < 0, state, e2)

    # phase 1: full-width doubling rounds (one gather per byte per
    # round, depth halves each round) while the unresolved set is too big
    # to be worth compacting
    A = max(O // 8, 1024)

    def phase1_cond(carry):
        state, n = carry
        return n > A

    def phase1_body(carry):
        state, _ = carry
        state = full_round(state)
        return state, jnp.sum((state >= 0).astype(jnp.int32))

    state, n_unres = jax.lax.while_loop(
        phase1_cond, phase1_body,
        (state, jnp.sum((state >= 0).astype(jnp.int32))))

    # phase 2: sort-compact the unresolved positions (sort ≈ 4× cheaper
    # than a full-width scatter) and iterate on the small set with path
    # compression (deep chains — periodic data — are rare but unbounded)
    cq = jnp.sort(jnp.where(state >= 0, q, jnp.int32(0x7FFFFFFF)))[:A]
    cq = jnp.clip(cq, 0, O - 1)

    def tail_cond(carry):
        state, active = carry
        return jnp.any(active)

    def tail_body(carry):
        state, _ = carry
        sq = state[cq]
        e2 = state[jnp.where(sq >= 0, sq >> 8, 0)]
        newv = jnp.where(sq < 0, sq, e2)
        state = state.at[cq].set(newv)
        return state, newv >= 0

    state, _ = jax.lax.while_loop(
        tail_cond, tail_body, (state, state[cq] >= 0))
    return (state & 0xFF).astype(jnp.uint8), err
