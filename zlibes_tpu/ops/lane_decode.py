"""Lane-parallel DEFLATE payload decode and LZ resolve for indexed streams.

Reference analog: the bit-serial symbol loop and byte-at-a-time back-copy
of the reference inflater (src/inflate.ts:237-291).

A *lane* is the run of tokens between two decode anchors of a
StreamIndex: it starts at a known bit offset (a token boundary) and at a
known output offset, and ends at the next anchor's bit offset.  Every lane
of a stream decodes at once, one token per lane per step:

  * ``decode_lanes`` turns lanes into packed tokens.  Each step reads 64
    stream bits at the lane's cursor straight from the stream words and
    looks the symbols up in two-level tables (9-bit litlen root, 6-bit
    dist root, sub-tables for longer codes — zlib's ENOUGH bounds).  It has
    two implementations of one step function: a ``lax.while_loop`` over
    all lanes (``decode_lanes_xla``, the reference and the CPU route) and a
    Pallas kernel for the Triton backend (``decode_lanes_kernel``) that
    keeps each lane's state in one GPU thread's registers.
  * ``resolve_lanes`` expands the tokens into bytes: every token lands at
    its output position, each byte finds its covering token by a running
    maximum, copies map to their source byte (overlapping copies fold by
    modular indexing), and pointer doubling resolves copy chains in
    O(log depth) gather rounds.

Token packing: val (literal byte / match length, 9 bits) | dist (16 bits
@ 9) | is_match (bit 25).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from ..spec import constants as C
from ..spec.errors import CorruptError
from . import huffman

# litlen table: 9-bit root (512) + sub region (512; zlib ENOUGH_LENS
# proves <= 852 total entries for 286 symbols / root 9 / 15-bit codes)
LL_ROOT_BITS = 9
LL_ROOT = 1 << LL_ROOT_BITS
LL_SUB = 512
LL_W = LL_ROOT + LL_SUB
# dist table: 6-bit root padded to 128 entries + sub region (zlib
# ENOUGH_DISTS proves <= 592 total entries for 30 symbols / root 6 /
# 15-bit codes -> sub <= 528)
D_ROOT_BITS = 6
D_ROOT = 1 << D_ROOT_BITS
D_SUB_OFF = 128
D_SUB = 576
D_W = D_SUB_OFF + 640
# one table row per distinct (litlen, dist) code pair: litlen then dist
TAB_W = LL_W + D_W

TOK_VAL_MASK = 0x1FF
TOK_DIST_SHIFT = 9
TOK_DIST_MASK = 0xFFFF
TOK_MATCH_BIT = 1 << 25
# marks a token's first byte in resolve_lanes' per-byte scatter
_TOK_START_BIT = 1 << 26

_KIND_LIT, _KIND_EOB, _KIND_LEN, _KIND_INVALID = 0, 1, 2, 3
_SUB_FLAG = 1 << 30

# lanes per Triton program: one lane per thread of four warps
KERNEL_LANES = 128


# ---------------------------------------------------------------------------
# two-level table construction (host, header-sized work per block)

def _fill_two_level(lengths: np.ndarray, root_bits: int, sub_off: int,
                    sub_cap: int, width: int, base: np.ndarray,
                    with_len: np.ndarray, subptr_fn) -> np.ndarray:
    """Build two-level LSB-first decode tables, one row per code.

    lengths (n, S): code lengths per row.  Codes of length <= root_bits
    fill the root directly (replicated every 2^len); longer codes group by
    their root-bit stream prefix, each prefix (in ascending order) getting
    a 2^(maxlen-root) sub-span addressed by the NEXT stream bits, with the
    root entry holding a sub-pointer.  Symbol s's entry is base[s] | its
    length where with_len[s].  Same layout the native scanner uses
    (runtime/zscan.cc two-level builder).
    """
    lengths = np.asarray(lengths, np.int64)
    n, S = lengths.shape
    tab = np.zeros((n, width), np.int32)
    codes = huffman.canonical_codes_batch(lengths)
    nz = lengths > 0
    # LSB-first index of each code
    rev = np.zeros((n, S), np.int64)
    rev[nz] = huffman._REV16[codes[nz].astype(np.uint32)] >> (16 - lengths[nz])
    ent = (base[None, :] | np.where(with_len[None, :], lengths, 0)).astype(
        np.int32)
    # short codes -> root
    for l in range(1, root_bits + 1):
        r, sym = np.nonzero(lengths == l)
        idx = rev[r, sym][:, None] + (np.arange(1 << (root_bits - l)) << l)
        tab[r[:, None], idx] = ent[r, sym][:, None]
    # long codes: group by (row, root prefix), prefixes in ascending order
    r, sym = np.nonzero(lengths > root_bits)
    if r.size == 0:
        return tab
    key = r * (1 << root_bits) + (rev[r, sym] & ((1 << root_bits) - 1))
    order = np.argsort(key, kind="stable")
    r, sym, key = r[order], sym[order], key[order]
    groups, first, inv = np.unique(key, return_index=True,
                                   return_inverse=True)
    ln = lengths[r, sym]
    wmax = np.maximum.reduceat(ln, first) - root_bits
    span = np.int64(1) << wmax
    grow = groups >> root_bits
    ends = np.cumsum(span)
    row_start = np.searchsorted(grow, grow, side="left")
    sub = ends - span - (ends - span)[row_start]   # exclusive, per row
    if (sub + span > sub_cap).any():
        raise CorruptError("two-level sub-table overflow "
                           "(non-canonical code lengths)")
    tab[grow, groups & ((1 << root_bits) - 1)] = subptr_fn(wmax, sub)
    # each long code fills its sub-span every 2^(len - root) entries
    hi = rev[r, sym] >> root_bits
    reps = wmax[inv] - (ln - root_bits)
    for c in np.unique(reps):
        m = reps == c
        idx = (sub_off + sub[inv][m] + hi[m])[:, None] + (
            np.arange(1 << int(c)) << (ln[m] - root_bits)[:, None])
        tab[r[m][:, None], idx] = ent[r[m], sym[m]][:, None]
    return tab


def _symbol_entries():
    """Per-symbol entry bits (without the code length) and whether the
    length is ORed in, for the litlen and dist alphabets."""
    ll = np.zeros(C.NUM_LITLEN_SYMBOLS, np.int64)
    ll[:256] = (_KIND_LIT << 4) | (np.arange(256) << 9)
    ll[C.END_OF_BLOCK] = _KIND_EOB << 4
    ll[257:286] = ((_KIND_LEN << 4) | (C.LENGTH_EXTRA_BITS[:29] << 6)
                   | (C.LENGTH_BASE[:29] << 9))
    ll[286:] = _KIND_INVALID << 4
    d = np.zeros(C.NUM_DIST_SYMBOLS, np.int64)
    d[:30] = (C.DIST_EXTRA_BITS[:30] << 4) | (C.DIST_BASE[:30] << 8)
    # reserved distance symbols 30, 31 stay 0: invalid
    return (ll, np.ones(ll.size, bool), d, np.arange(d.size) < 30)


_LL_BASE, _LL_WITH_LEN, _D_BASE, _D_WITH_LEN = _symbol_entries()


def decode_tables(ll_len: np.ndarray, d_len: np.ndarray) -> np.ndarray:
    """Two-level decode tables, one row per code pair: (n, TAB_W) int32
    from (n, <=288) litlen and (n, <=32) dist code lengths, the litlen
    table at [0, LL_W) and the dist table at [LL_W, TAB_W).

    litlen entry: codelen(4b) | kind(2b @4) | extra#(3b @6) | base(9b @9)
    litlen subptr (root only): subw(4b @0) | sub base(9b @9) | bit 30
    dist entry:   codelen(4b) | extra#(4b @4) | base(15b @8)
    dist subptr:  base(10b @8) | subw(4b @24) | bit 30
    codelen 0 marks an invalid bit pattern.
    """
    ll_len = np.asarray(ll_len, np.int64)
    d_len = np.asarray(d_len, np.int64)
    if int(ll_len.max(initial=0)) > 15 or int(d_len.max(initial=0)) > 15:
        raise CorruptError("code lengths exceed the RFC 1951 15-bit cap")
    ll = np.zeros((ll_len.shape[0], C.NUM_LITLEN_SYMBOLS), np.int64)
    ll[:, : ll_len.shape[1]] = ll_len
    d = np.zeros((d_len.shape[0], C.NUM_DIST_SYMBOLS), np.int64)
    d[:, : d_len.shape[1]] = d_len
    lt = _fill_two_level(ll, LL_ROOT_BITS, LL_ROOT, LL_SUB, LL_W, _LL_BASE,
                         _LL_WITH_LEN,
                         lambda w, base: _SUB_FLAG | w | (base << 9))
    dt = _fill_two_level(d, D_ROOT_BITS, D_SUB_OFF, D_SUB, D_W, _D_BASE,
                         _D_WITH_LEN,
                         lambda w, base: _SUB_FLAG | (base << 8) | (w << 24))
    return np.concatenate([lt, dt], axis=1)


# ---------------------------------------------------------------------------
# one decode step, shared by the XLA loop and the Triton kernel

def _shl32m(x, s):
    """x << (32 - s) for s in [0, 32); 0 at s == 0 (no shift reaches 32)."""
    return (x << (jnp.uint32(31) - s)) << 1


def _step(word_at, tab_at, w0, tbase, endb, bitpos, active, err):
    """Decode one token for every lane.

    ``word_at(i)`` reads stream words (uint32), ``tab_at(i)`` table
    entries; ``bitpos``/``endb`` are bit offsets from word ``w0``.  Flags
    are int32 0/1.  Returns (tok, emit, bitpos, active, err).
    """
    widx = w0 + (bitpos >> 5)
    s = (bitpos & 31).astype(jnp.uint32)
    wa, wb, wc = word_at(widx), word_at(widx + 1), word_at(widx + 2)
    lo = (wa >> s) | _shl32m(wb, s)          # stream bits [0, 32)
    hi = (wb >> s) | _shl32m(wc, s)          # stream bits [32, 64)
    # --- litlen symbol: 9-bit root, sub-table for longer codes
    loi = lo.astype(jnp.int32)
    e1 = tab_at(tbase + (loi & (LL_ROOT - 1)))
    subw = jnp.minimum(e1 & 15, 6)
    sidx = ((e1 >> 9) & 511) + ((loi >> LL_ROOT_BITS)
                                & ((jnp.int32(1) << subw) - 1))
    e = jnp.where((e1 & _SUB_FLAG) != 0,
                  tab_at(tbase + LL_ROOT + jnp.minimum(sidx, LL_SUB - 1)), e1)
    ln = e & 15
    kind = (e >> 4) & 3
    eb = (e >> 6) & 7
    base = (e >> 9) & 511
    extra = ((lo >> ln.astype(jnp.uint32))
             & ((jnp.uint32(1) << eb.astype(jnp.uint32)) - 1)).astype(jnp.int32)
    is_len = kind == _KIND_LEN
    val = jnp.where(is_len, base + extra, base)
    k1 = (ln + eb).astype(jnp.uint32)        # <= 22
    lo2 = ((lo >> k1) | _shl32m(hi, k1)).astype(jnp.int32)  # >= 42 bits left
    # --- dist symbol: 6-bit root, sub-table for longer codes
    d1 = tab_at(tbase + LL_W + (lo2 & (D_ROOT - 1)))
    dsw = jnp.minimum((d1 >> 24) & 15, 9)
    dsidx = ((d1 >> 8) & 1023) + ((lo2 >> D_ROOT_BITS)
                                  & ((jnp.int32(1) << dsw) - 1))
    de = jnp.where((d1 & _SUB_FLAG) != 0,
                   tab_at(tbase + LL_W + D_SUB_OFF + jnp.minimum(dsidx, 639)),
                   d1)
    dln = de & 15
    deb = (de >> 4) & 15
    dist = ((de >> 8) & 0x7FFF) + (
        (lo2 >> dln) & ((jnp.int32(1) << deb) - 1))  # dln + deb <= 28
    is_eob = kind == _KIND_EOB
    newpos = bitpos + (ln + eb) + jnp.where(is_len, dln + deb, 0)
    bad = ((ln == 0) | (kind == _KIND_INVALID)
           | (is_len & ((dln == 0) | (dist > C.WINDOW_SIZE)))
           | (newpos > endb))
    live = active > 0
    emit = live & ~bad & ~is_eob
    tok = jnp.where(is_len, val | (dist << TOK_DIST_SHIFT) | TOK_MATCH_BIT,
                    val)
    tok = jnp.where(emit, tok, 0)
    err = err | (live & bad).astype(jnp.int32)
    bitpos = jnp.where(live & ~bad, newpos, bitpos)
    active = (emit & (newpos < endb)).astype(jnp.int32)
    return tok, emit.astype(jnp.int32), bitpos, active, err


# ---------------------------------------------------------------------------
# stage 1: lane decode

@partial(jax.jit, static_argnames=("T",))
def decode_lanes_xla(words: jax.Array,   # (NW,) uint32 stream words
                     lanes: jax.Array,   # (4, L) int32: w0, bit0, endb, trow
                     tables: jax.Array,  # (NT, TAB_W) int32
                     T: int):
    """Decode up to T tokens per lane with a ``lax.while_loop``.

    Lane l starts at bit ``bit0`` (0..31) of stream word ``w0``, ends at
    bit ``endb`` (same origin) and decodes with table row ``trow``.
    Returns (tokens (T, L) int32 packed, zero past each lane's count;
    meta (4, L) int32: token count, end bit, error flag, still-active
    flag — the last two are both errors).
    """
    w0, bit0, endb, trow = lanes
    nw = words.shape[0]
    flat = tables.reshape(-1)
    tbase = trow * TAB_W

    def word_at(i):
        return words[jnp.minimum(i, nw - 1)]

    def tab_at(i):
        return flat[i]

    def cond(c):
        t, _bp, active, _err, _cnt, _toks = c
        return (t < T) & jnp.any(active > 0)

    def body(c):
        t, bitpos, active, err, count, toks = c
        tok, emit, bitpos, active, err = _step(word_at, tab_at, w0, tbase,
                                               endb, bitpos, active, err)
        toks = jax.lax.dynamic_update_slice(toks, tok[None], (t, 0))
        return t + 1, bitpos, active, err, count + emit, toks

    zero = jnp.zeros_like(bit0)
    init = (jnp.int32(0), bit0, (bit0 < endb).astype(jnp.int32), zero, zero,
            jnp.zeros((T, bit0.shape[0]), jnp.int32))
    _t, bitpos, active, err, count, toks = jax.lax.while_loop(cond, body,
                                                              init)
    return toks, jnp.stack([count, bitpos, err, active])


def _decode_kernel(words_ref, tab_ref, lanes_ref, tok_ref, meta_ref, *,
                   T: int):
    w0 = lanes_ref[0, :]
    bit0 = lanes_ref[1, :]
    endb = lanes_ref[2, :]
    tbase = lanes_ref[3, :] * TAB_W
    nw = words_ref.shape[0]

    def word_at(i):
        return words_ref[jnp.minimum(i, nw - 1)]

    def tab_at(i):
        return tab_ref[i]

    def cond(c):
        t, _bp, active, _err, _cnt = c
        return (t < T) & (jnp.max(active) > 0)

    def body(c):
        t, bitpos, active, err, count = c
        tok, emit, bitpos, active, err = _step(word_at, tab_at, w0, tbase,
                                               endb, bitpos, active, err)
        tok_ref[t, :] = tok
        return t + 1, bitpos, active, err, count + emit

    zero = jnp.zeros_like(bit0)
    init = (jnp.int32(0), bit0, (bit0 < endb).astype(jnp.int32), zero, zero)
    _t, bitpos, active, err, count = jax.lax.while_loop(cond, body, init)
    meta_ref[0, :] = count
    meta_ref[1, :] = bitpos
    meta_ref[2, :] = err
    meta_ref[3, :] = active


@partial(jax.jit, static_argnames=("T", "interpret"))
def decode_lanes_kernel(words: jax.Array, lanes: jax.Array,
                        tables: jax.Array, T: int, interpret: bool = False):
    """``decode_lanes_xla`` as a Pallas kernel for the Triton backend: one
    lane per thread, KERNEL_LANES lanes per program, lane state in
    registers; stream words and table entries load by index from global
    memory.  Token rows past a program's last step are left unwritten —
    consumers mask by the count in meta row 0."""
    L = lanes.shape[1]
    Lp = -(-L // KERNEL_LANES) * KERNEL_LANES
    # padded lanes are empty (endb == bit0 == 0) and stay inactive
    lanes = jnp.pad(lanes, ((0, 0), (0, Lp - L)))
    spec = partial(pl.BlockSpec, index_map=lambda i: (0, i))
    toks, meta = pl.pallas_call(
        partial(_decode_kernel, T=T),
        grid=(Lp // KERNEL_LANES,),
        in_specs=[pl.BlockSpec(), pl.BlockSpec(),
                  spec((4, KERNEL_LANES))],
        out_specs=(spec((T, KERNEL_LANES)), spec((4, KERNEL_LANES))),
        out_shape=(jax.ShapeDtypeStruct((T, Lp), jnp.int32),
                   jax.ShapeDtypeStruct((4, Lp), jnp.int32)),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=KERNEL_LANES // 32,
                                            num_stages=1),
        interpret=interpret,
        name="decode_lanes",
    )(words, tables.reshape(-1), lanes)
    return toks[:, :L], meta[:, :L]


def decode_route() -> str:
    """The decode implementation for the default backend: the Triton
    kernel on a GPU, the XLA loop on the CPU.  Any other platform is an
    error, not a silent fallback."""
    platform = jax.default_backend()
    if platform == "gpu":
        return "kernel"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no lane-decode route for platform {platform!r}")


def decode_lanes(words, lanes, tables, T: int):
    """Lane decode by the route ``decode_route`` picks (same contract as
    ``decode_lanes_xla``; token rows past a lane's count are unspecified)."""
    if decode_route() == "kernel":
        return decode_lanes_kernel(words, lanes, tables, T=T)
    return decode_lanes_xla(words, lanes, tables, T=T)


# ---------------------------------------------------------------------------
# stage 2: LZ resolve into block rows

@partial(jax.jit, static_argnames=("O",))
def resolve_lanes(tokens: jax.Array,    # (T, L) int32 packed tokens
                  count: jax.Array,     # (L,) int32 tokens per lane
                  lane_out: jax.Array,  # (L,) int32 flat output position of
                                        # each lane's first token
                  row_len: jax.Array,   # (R,) int32 valid bytes per row
                  O: int):              # row width in bytes
    """Expand lane tokens into R rows of O bytes (one row per block;
    back-references stay inside their row).

    Returns (out (R*O,) uint8, lane_bytes (L,) int32 — output bytes each
    lane produced — and err, a scalar flag for a valid byte that no token
    covers or that copies from before its row).  Bytes past a row's
    valid length are unspecified.
    """
    T, L = tokens.shape
    n = row_len.shape[0] * O
    valid = jax.lax.broadcasted_iota(jnp.int32, (T, L), 0) < count[None]
    ism = (tokens & TOK_MATCH_BIT) != 0
    ln = jnp.where(valid, jnp.where(ism, tokens & TOK_VAL_MASK, 1), 0)
    ends = jnp.cumsum(ln, axis=0)
    pos = jnp.where(valid, lane_out[None] + ends - ln, n)
    # every token lands on its first byte; each byte's covering token is
    # the last start at or before it (positions are unique)
    tokat = jnp.zeros(n, jnp.int32).at[pos.reshape(-1)].set(
        (tokens | _TOK_START_BIT).reshape(-1), mode="drop")
    q = jnp.arange(n, dtype=jnp.int32)
    o_q = jax.lax.cummax(jnp.where(tokat != 0, q, -1))
    vd = tokat[jnp.maximum(o_q, 0)]
    row0 = q - q % O
    in_row = (q - row0) < row_len[q // O]
    d = (vd >> TOK_DIST_SHIFT) & TOK_DIST_MASK
    copy = (vd & TOK_MATCH_BIT) != 0
    src = o_q - d + (q - o_q) % jnp.maximum(d, 1)
    bad = in_row & ((o_q < row0) | (copy & (src < row0)))
    err = jnp.any(bad)

    # combined per-byte state: resolved bytes are negative (bit 31 | value),
    # unresolved ones hold their source position; corrupt bytes resolve to
    # 0 so every chain ends
    flag = jnp.int32(-0x80000000)
    state = jnp.where(copy & ~bad & (o_q >= 0), src, (vd & 255) | flag)

    def cond(c):
        i, s = c
        return (i < 32) & jnp.any(s >= 0)

    def body(c):
        i, s = c
        return i + 1, jnp.where(s < 0, s, s[jnp.maximum(s, 0)])

    _i, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    return (state & 255).astype(jnp.uint8), ends[-1], err
