"""Inflate pipeline: host structure parse + device payload decode.

Two decode strategies (SURVEY.md §2 "Block-parallel inflate"):

  * **Indexed** (``index=`` a StreamIndex from our own encoder): every
    ~4 KiB anchor chunk of every block decodes simultaneously as a vector
    lane of a batched device dispatch, then one global parallel LZ-resolve
    pass builds the output — the high-throughput path.
  * **Scan** (foreign streams, e.g. CPython zlib output): block boundaries
    are only discoverable by decoding, so blocks stream through the device
    decoder one at a time (single-lane), then LZ resolution runs globally
    (cross-block back-references are legal in foreign streams).

Container framing, header parsing and table *construction* are host work
(header-sized, not payload-sized); payload symbol decode, LZ resolution and
Adler-32 all run on device.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops import huffman
from ..ops.adler32 import adler32_device
from ..ops.inflate_kernel import decode_tokens, make_windows, resolve_global
from ..spec import constants as C
from ..spec.errors import (
    BlockTypeError,
    ChecksumError,
    CorruptError,
    HeaderError,
    StoredBlockError,
    TruncatedError,
)
from ..spec.refmodel import (
    BitReader,
    BlockInfo,
    StreamIndex,
    read_dynamic_code_lengths,
)

_FIXED_LITLEN_LENGTHS = C.fixed_litlen_code_lengths()
_FIXED_DIST_LENGTHS = C.fixed_dist_code_lengths()

# Batched path sizing: decode lanes per dispatch.
_LANES = 8192
_SCAN_CHUNK_TOKENS = 65536


def _bucket(n: int, lo: int = 4096) -> int:
    return max(lo, 1 << (max(n, 1) - 1).bit_length())


class _Stream:
    """Device-resident view of the compressed stream."""

    def __init__(self, data: bytes):
        from ..utils.cache import enable_persistent_cache

        enable_persistent_cache()
        w32, b = make_windows(data)
        nb = _bucket(w32.size)
        self.w32 = jnp.asarray(np.pad(w32, (0, nb - w32.size)))
        self.bytes = jnp.asarray(np.pad(b, (0, nb + 8 - b.size)))
        self.total_bits = len(data) * 8


def _block_code_lengths(data: bytes, blk: BlockInfo):
    """Host-parse a compressed block's header → (litlen, dist) code lengths."""
    if blk.btype == C.BTYPE_FIXED:
        return _FIXED_LITLEN_LENGTHS, _FIXED_DIST_LENGTHS
    br = BitReader(data)
    br.bitpos = blk.start_bit + 3
    ll, dl = read_dynamic_code_lengths(br)
    if blk.payload_start_bit and br.bitpos != blk.payload_start_bit:
        raise CorruptError("index does not match stream")
    return ll, dl


def _decode_one_block(stream: _Stream, bitpos: int, ll_len, d_len):
    """Scan-path decode of a single block's payload (one device lane)."""
    M = C.MAX_CODELEN_BITS  # fixed width → one compiled program
    D = C.MAX_CODELEN_BITS
    ll_tab = jnp.asarray(huffman.build_litlen_tables(np.asarray(ll_len)[None, :], M))
    d_tab = jnp.asarray(huffman.build_dist_tables(np.asarray(d_len)[None, :], D))
    vals, dists = [], []
    bit = jnp.asarray([bitpos], jnp.int32)
    end = jnp.asarray([stream.total_bits], jnp.int32)
    row = jnp.zeros(1, jnp.int32)
    active = jnp.asarray([True])
    while True:
        tv, td, cnt, bit, active, err = decode_tokens(
            stream.w32, stream.bytes, ll_tab, d_tab, row, bit, end, active,
            T=_SCAN_CHUNK_TOKENS, M=M, D=D,
        )
        if bool(err[0]):
            raise CorruptError("invalid Huffman data in block payload")
        n = int(cnt[0])
        vals.append(np.asarray(tv[0, :n]))
        dists.append(np.asarray(td[0, :n]))
        if not bool(active[0]):
            break
    return np.concatenate(vals), np.concatenate(dists), int(bit[0])


_RESOLVE_WINDOW = 1 << 22  # 4 MiB resolve windows (foreign streams)


def _resolve_tokens_device(vals: np.ndarray, dists: np.ndarray,
                       dictionary: bytes | None = None) -> np.ndarray:
    """Resolve one global token stream into output bytes (device).

    Streams larger than one resolve dispatch are processed in 4 MiB output
    windows with the previous 32 KiB (the max back-reference distance) as a
    pre-resolved prefix halo; the first window's halo carries the preset
    dictionary, if any.
    """
    lens = np.where(dists > 0, vals.astype(np.int64), 1)
    total = int(lens.sum())
    starts = np.concatenate([[0], np.cumsum(lens)])
    out = np.empty(total, dtype=np.uint8)
    P = C.WINDOW_SIZE  # fixed halo width → one compiled program
    first_halo = np.zeros(P, dtype=np.uint8)
    if dictionary:
        dt = np.frombuffer(bytes(dictionary[-P:]), np.uint8)
        first_halo[P - dt.size :] = dt
    a = 0
    while a < total:
        b = min(total, a + _RESOLVE_WINDOW)
        t0 = int(np.searchsorted(starts[1:], a, side="right"))
        t1 = int(np.searchsorted(starts[:-1], b, side="left"))
        n = t1 - t0
        T = _bucket(max(n, 1), lo=1024)
        tv = np.zeros(T, dtype=np.int32)
        td = np.zeros(T, dtype=np.int32)
        tv[:n] = vals[t0:t1]
        td[:n] = dists[t0:t1]
        out_base = P + int(starts[t0]) - a
        O = _bucket(P + (b - a), lo=4096)
        if a == 0:
            prefix = first_halo
        elif a >= P:
            prefix = out[a - P : a]
        else:
            prefix = np.concatenate([first_halo[a:], out[:a]])
        res, err = resolve_global(
            jnp.asarray(tv[None, :]), jnp.asarray(td[None, :]),
            jnp.asarray([n], jnp.int32), jnp.asarray([out_base], jnp.int32),
            jnp.int32(P + (b - a)), jnp.asarray(prefix), O=O,
        )
        if bool(err):
            raise CorruptError("back-reference before start of output")
        out[a:b] = np.asarray(res[P : P + (b - a)])
        a = b
    return out


def inflate_raw_scan(data: bytes, byte_offset: int = 0,
                     dictionary: bytes | None = None):
    """Sequential-structure inflate of an arbitrary conformant stream.

    Returns (output bytes ndarray, list[BlockInfo], end_bit, adler) —
    ``adler`` is the Adler-32 of the output when the native pipeline
    computed it in-pass, else None.

    Uses the native C++ runtime when available: ONE fused call runs the
    speculative-parallel span scan (rapidgzip-style: per-span
    block-boundary search, splice-on-match, serial rescan on
    mis-speculation) while a resolver thread trails the merge frontier,
    expanding tokens into the output and folding its Adler-32 into the
    same cache-hot pass.  Falls back to single-lane device decode + the
    windowed device resolve when no C++ toolchain exists.
    """
    from ..runtime import native

    dict_tail = bytes(dictionary[-C.WINDOW_SIZE:]) if dictionary else None
    if native.available():
        # host C++ path: the output returns to the host anyway, and the
        # device global resolve pays several pointer-doubling gather
        # rounds over the whole window where sequential memcpy splicing is
        # memory-speed.  Device-resident consumers (inflate_to_device, the
        # indexed lane paths) keep the device resolvers.
        out, index, end_bit, adler = native.decode(
            data, bit_offset=byte_offset * 8, dictionary=dict_tail)
        return out, index.blocks, end_bit, adler

    stream = _Stream(data)
    br = BitReader(data, byte_offset)
    vals_parts: list[np.ndarray] = []
    dists_parts: list[np.ndarray] = []
    blocks: list[BlockInfo] = []
    out_count = 0
    while True:
        start_bit = br.bitpos
        try:
            bfinal = br.read_bits(1)
            btype = br.read_bits(2)
        except TruncatedError:
            raise TruncatedError("stream ended before final block")
        if btype == C.BTYPE_STORED:
            br.align_to_byte()
            payload_start = br.bitpos
            pos = br.bitpos >> 3
            if pos + 4 > len(data):
                raise TruncatedError("stored block header truncated")
            length = data[pos] | (data[pos + 1] << 8)
            nlen = data[pos + 2] | (data[pos + 3] << 8)
            if length != (~nlen & 0xFFFF):
                raise StoredBlockError("LEN/NLEN mismatch")
            pos += 4
            if pos + length > len(data):
                raise TruncatedError("stored block data truncated")
            raw = np.frombuffer(data, dtype=np.uint8, count=length, offset=pos)
            vals_parts.append(raw.astype(np.int32))
            dists_parts.append(np.zeros(length, dtype=np.int32))
            br.bitpos = (pos + length) * 8
            out_len = length
        elif btype in (C.BTYPE_FIXED, C.BTYPE_DYNAMIC):
            if btype == C.BTYPE_FIXED:
                ll_len, d_len = _FIXED_LITLEN_LENGTHS, _FIXED_DIST_LENGTHS
            else:
                ll_len, d_len = read_dynamic_code_lengths(br)
            payload_start = br.bitpos
            vals, dists, endbit = _decode_one_block(stream, br.bitpos, ll_len, d_len)
            vals_parts.append(vals)
            dists_parts.append(dists)
            br.bitpos = endbit
            out_len = int(np.where(dists > 0, vals, 1).sum())
        else:
            raise BlockTypeError("reserved BTYPE 3")
        blocks.append(
            BlockInfo(
                btype=btype, bfinal=bool(bfinal), start_bit=start_bit,
                payload_start_bit=payload_start, end_bit=br.bitpos,
                out_start=out_count, out_len=out_len,
            )
        )
        out_count += out_len
        if bfinal:
            break
    vals = np.concatenate(vals_parts) if vals_parts else np.zeros(0, np.int32)
    dists = np.concatenate(dists_parts) if dists_parts else np.zeros(0, np.int32)
    out = _resolve_tokens_device(vals, dists, dictionary=dict_tail)
    return out, blocks, br.bitpos, None


def _index_lanes(index: StreamIndex):
    """Flatten a StreamIndex into per-lane (bit0, end_bit, out_base, out_len,
    block_id) arrays for the compressed blocks."""
    na = index.anchor_bit.size
    lane_bit0 = index.anchor_bit.astype(np.int64)
    lane_block = index.anchor_block.astype(np.int64)
    lane_out = index.anchor_out.astype(np.int64)
    lane_end = np.empty(na, dtype=np.int64)
    lane_outlen = np.empty(na, dtype=np.int64)
    for i in range(na):
        blk = index.blocks[int(lane_block[i])]
        if i + 1 < na and lane_block[i + 1] == lane_block[i]:
            lane_end[i] = lane_bit0[i + 1]
            lane_outlen[i] = lane_out[i + 1] - lane_out[i]
        else:
            lane_end[i] = blk.end_bit
            lane_outlen[i] = blk.out_start + blk.out_len - lane_out[i]
    return lane_bit0, lane_end, lane_out, lane_outlen, lane_block


class _GroupPlan:
    """Host-prepared arguments for one indexed decode dispatch."""

    __slots__ = ("ll_tab", "d_tab", "rows", "bit0", "endb", "active",
                 "out_base", "B", "M", "D", "T", "O", "d_base", "d_total",
                 "lane_end")


def plan_groups(data: bytes, index: StreamIndex) -> list[_GroupPlan]:
    """Group anchor lanes into device dispatches (whole blocks per group,
    ≤ _LANES lanes, ≤ 2^23-byte output span — the resolve pointer width).

    For non-self-contained (foreign) indexes, groups additionally split at
    stored blocks so back-references never point into an unresolved gap —
    stored content reaches later groups through the chained prefix.
    """
    lane_bit0, lane_end, lane_out, lane_outlen, lane_block = _index_lanes(index)
    split_at_stored = not getattr(index, "self_contained", True)
    nlanes = lane_bit0.size
    if nlanes == 0:
        return []
    max_span = int(lane_outlen.max(initial=1))
    T = _bucket(max_span + 16, lo=512)
    max_span_bytes = (1 << 23) - C.BLOCK_MAX_BUFFER_LEN
    groups: list[tuple[int, int]] = []
    gstart = 0
    i = 0
    while i < nlanes:
        j = i
        while j < nlanes and lane_block[j] == lane_block[i]:
            j += 1
        span = int(lane_out[j - 1] + lane_outlen[j - 1] - lane_out[gstart])
        gap = (split_at_stored and i > gstart
               and lane_block[i] != lane_block[i - 1] + 1)
        if (j - gstart > _LANES or span > max_span_bytes or gap) and i > gstart:
            groups.append((gstart, i))
            gstart = i
        i = j
    if gstart < nlanes:
        groups.append((gstart, nlanes))

    plans = []
    for g0, g1 in groups:
        p = _GroupPlan()
        B = g1 - g0
        Bp = _bucket(B, lo=64)
        block_ids = sorted(set(int(b) for b in lane_block[g0:g1]))
        row_of = {b: r for r, b in enumerate(block_ids)}
        NB = _bucket(len(block_ids), lo=8)
        ll_lens = np.zeros((len(block_ids), C.NUM_LITLEN_SYMBOLS), dtype=np.int64)
        d_lens = np.zeros((len(block_ids), C.NUM_DIST_SYMBOLS), dtype=np.int64)
        for b, r in row_of.items():
            ll, dl = _block_code_lengths(data, index.blocks[b])
            ll_lens[r, : ll.size] = ll
            d_lens[r, : dl.size] = dl
        # fixed table widths → one compiled decode program for all streams
        # (15 is the RFC cap; the (NB, 2^15) table gather cost is unchanged)
        p.M = C.MAX_CODELEN_BITS
        p.D = C.MAX_CODELEN_BITS
        ll_tab = np.zeros((NB, 1 << p.M), dtype=np.int32)
        d_tab = np.zeros((NB, 1 << p.D), dtype=np.int32)
        ll_tab[: len(block_ids)] = huffman.build_litlen_tables(ll_lens, p.M)
        d_tab[: len(block_ids)] = huffman.build_dist_tables(d_lens, p.D)
        bit0 = np.zeros(Bp, np.int32)
        endb = np.zeros(Bp, np.int32)
        rows = np.zeros(Bp, np.int32)
        active = np.zeros(Bp, bool)
        bit0[:B] = lane_bit0[g0:g1]
        endb[:B] = lane_end[g0:g1]
        rows[:B] = [row_of[int(b)] for b in lane_block[g0:g1]]
        active[:B] = True
        # upload once at plan time (tables dominate H2D traffic)
        p.ll_tab = jnp.asarray(ll_tab)
        p.d_tab = jnp.asarray(d_tab)
        p.bit0 = jnp.asarray(bit0)
        p.endb = jnp.asarray(endb)
        p.rows = jnp.asarray(rows)
        p.active = jnp.asarray(active)
        p.lane_end = lane_end[g0:g1]
        p.B = B
        p.T = T
        p.d_base = int(lane_out[g0])
        p.d_total = int(lane_out[g1 - 1] + lane_outlen[g1 - 1]) - p.d_base
        # bucketed per-group output span: padding to the worst case would
        # double-to-quadruple the resolve's per-byte passes; the handful of
        # distinct (B,T,O) buckets each compile once
        p.O = _bucket(p.d_total, lo=4096)
        out_base = np.zeros(Bp, np.int32)
        out_base[:B] = lane_out[g0:g1] - p.d_base
        p.out_base = jnp.asarray(out_base)
        plans.append(p)
    return plans


def run_group(stream: _Stream, p: _GroupPlan, check: bool = True,
              prefix: np.ndarray | None = None):
    """Dispatch one planned group; returns the device output array.

    ``prefix``: the 32 KiB of output preceding this group, for streams
    whose blocks are not self-contained (foreign indexed streams) — groups
    then resolve in order, each seeded with the previous tail.  The
    returned array has the prefix at [0, P); payload at [P, P+d_total).
    """
    tv, td, cnt, endpos, still, err = decode_tokens(
        stream.w32, stream.bytes, p.ll_tab, p.d_tab,
        p.rows, p.bit0, p.endb, p.active, T=p.T, M=p.M, D=p.D,
    )
    if check:
        if np.asarray(err)[: p.B].any() or np.asarray(still)[: p.B].any():
            raise CorruptError("invalid Huffman data in indexed block")
        if not (np.asarray(endpos)[: p.B] == p.lane_end).all():
            raise CorruptError("lane did not end at its anchor boundary")
    # slice the token axis to the occupied prefix: resolve's token
    # scatters scale with B*T, and the worst-case T (all-literal lane) is
    # ~8x the typical token count
    Tc = _bucket(int(cnt.max()) + 1, lo=256)
    if Tc < p.T:
        tv, td = tv[:, :Tc], td[:, :Tc]
    P = 0 if prefix is None else prefix.size
    out_base = np.asarray(p.out_base) + P if P else p.out_base
    dev_out, rerr = resolve_global(
        tv, td, cnt, jnp.asarray(out_base), jnp.int32(P + p.d_total),
        jnp.zeros(0, jnp.uint8) if prefix is None else jnp.asarray(prefix),
        O=p.O if not P else _bucket(P + p.d_total, lo=4096),
    )
    if check and bool(rerr):
        raise CorruptError("back-reference escapes its resolve span")
    return dev_out


def inflate_raw_indexed(data: bytes, index: StreamIndex,
                        dictionary: bytes | None = None) -> np.ndarray:
    """Anchor-parallel inflate using a recorded stream layout.

    Requires self-contained blocks (no back-references across block
    boundaries) — guaranteed for streams produced by this framework and by
    the reference encoder (SURVEY.md §2 C13 note).  Violations surface as
    CorruptError (caller may fall back to the scan path).

    ``dictionary`` (FDICT streams): the preset dictionary tail seeds the
    resolve prefix of every group overlapping the first 32 KiB of output —
    only the first block may reference it (RFC 1950 §2.2, and how our
    encoder emits FDICT members).
    """
    stream = _Stream(data)
    out = np.empty(index.total_out, dtype=np.uint8)
    chained = not getattr(index, "self_contained", True)
    dict_tail = None
    if dictionary:
        # fixed 32 KiB halo (zero left-pad) → one compiled resolve bucket
        dict_tail = np.zeros(C.WINDOW_SIZE, np.uint8)
        t = np.frombuffer(bytes(dictionary[-C.WINDOW_SIZE:]), np.uint8)
        dict_tail[C.WINDOW_SIZE - t.size :] = t

    # stored blocks: straight host copies (byte-aligned payloads); in
    # chained mode they must land first so group prefixes can see them
    for b in index.blocks:
        if b.btype == C.BTYPE_STORED and b.out_len:
            pos = (b.payload_start_bit >> 3) + 4
            out[b.out_start : b.out_start + b.out_len] = np.frombuffer(
                data, np.uint8, count=b.out_len, offset=pos
            )

    for p in plan_groups(data, index):
        if chained and p.d_base:
            P = min(C.WINDOW_SIZE, p.d_base)
            prefix = out[p.d_base - P : p.d_base]
            if dict_tail is not None and P < C.WINDOW_SIZE:
                need = min(C.WINDOW_SIZE - P, dict_tail.size)
                prefix = np.concatenate([dict_tail[dict_tail.size - need:],
                                         prefix])
        elif dict_tail is not None and p.d_base < C.WINDOW_SIZE:
            # first block(s) may reference the preset dictionary
            if p.d_base:
                prefix = np.concatenate([dict_tail, out[: p.d_base]]
                                        )[-C.WINDOW_SIZE:]
            else:
                prefix = dict_tail
        else:
            prefix = None
        dev_out = run_group(stream, p, prefix=prefix)
        P = 0 if prefix is None else prefix.size
        out[p.d_base : p.d_base + p.d_total] = np.asarray(
            dev_out[P : P + p.d_total])
    return out


def inflate_range(data: bytes, index: StreamIndex, start: int,
                  length: int) -> bytes:
    """Random-access decode of output bytes [start, start+length).

    The sidecar StreamIndex makes decode seekable/restartable (SURVEY.md §5
    "checkpoint/resume": the per-block index is the restartable unit the
    reference's 128 KiB block split hints at but never exposes).  Only the
    self-contained blocks overlapping the range are decoded, so cost is
    O(length + block_size) regardless of stream size.

    ``start``/``length`` address *decompressed* output coordinates; the
    container header offset is already baked into the index bit offsets.
    """
    total = index.total_out
    if start < 0 or length < 0 or start + length > total:
        raise ValueError(
            f"range [{start}, {start + length}) outside output [0, {total})")
    if not getattr(index, "self_contained", True):
        raise CorruptError(
            "inflate_range requires self-contained blocks (indexes from this "
            "framework's encoder); foreign chained streams must decode from "
            "the start")
    if length == 0:
        return b""
    end = start + length
    keep = [i for i, b in enumerate(index.blocks)
            if b.out_len and b.out_start < end and b.out_start + b.out_len > start]
    out_lo = index.blocks[keep[0]].out_start
    keep_arr = np.asarray(keep, np.int32)
    mask = np.isin(index.anchor_block, keep_arr)
    sub = StreamIndex(
        [BlockInfo(b.btype, b.bfinal, b.start_bit, b.payload_start_bit,
                   b.end_bit, b.out_start - out_lo, b.out_len)
         for b in (index.blocks[i] for i in keep)],
        index.anchor_bit[mask],
        index.anchor_out[mask] - out_lo,
        np.searchsorted(keep_arr, index.anchor_block[mask]).astype(np.int32),
        True,
        getattr(index, "chunk_reset", 0),
        getattr(index, "turbo", False),
        getattr(index, "max_tokens", 0),
        getattr(index, "wide", False),
    )
    # profile flags propagate into the sub-index so seeks ride the same
    # lane decode as full-stream decode; anchor geometry is per block, so
    # a sub-index of whole blocks keeps it
    if sub.turbo or sub.wide:
        from .lanes import inflate_raw_lanes

        out = inflate_raw_lanes(data, sub)
    else:
        out = inflate_raw_indexed(data, sub)
    return out[start - out_lo : end - out_lo].tobytes()


def inflate_to_device(data: bytes, index: StreamIndex):
    """Decompress into device memory: returns (list of (device_array, base,
    nbytes)) without any device→host transfer of payload data.

    The device-resident consumption path (e.g. decompressing dataset
    shards straight into accelerator memory), with no host round trip for
    the payload.
    """
    if not getattr(index, "self_contained", True):
        raise CorruptError(
            "inflate_to_device requires self-contained blocks (streams "
            "produced by this framework); use inflate() for foreign streams"
        )
    if getattr(index, "turbo", False) or getattr(index, "wide", False):
        from .lanes import LanePlan, run_lanes

        plan = LanePlan.build(data, index)
        if plan.R and plan.contiguous:
            rows = run_lanes(plan, check=False)
            return [(rows.reshape(-1), 0, plan.total_out)]
        # non-contiguous layouts (stored content blocks) splice on host
    stream = _Stream(data)
    outs = []
    for p in plan_groups(data, index):
        outs.append((run_group(stream, p, check=False), p.d_base, p.d_total))
    return outs


def inflate(data: bytes, verify_checksum: bool = True, index=None,
            dictionary: bytes | None = None) -> bytes:
    """zlib-container inflate on the device pipeline."""
    data = bytes(data)
    if len(data) < 6:
        raise TruncatedError("zlib stream shorter than minimal frame")
    cmf, flg = data[0], data[1]
    if cmf & 0x0F != C.ZLIB_CM_DEFLATE:
        raise HeaderError("not compressed by deflate")
    if (cmf >> 4) > 7:
        raise HeaderError("invalid CINFO (window > 32 KiB)")
    if (cmf * 256 + flg) % 31 != 0:
        raise HeaderError("FCHECK failed")
    offset = 2
    if flg & 0x20:
        if dictionary is None:
            raise HeaderError("stream requires a preset dictionary (FDICT)")
        if len(data) < 10:
            raise TruncatedError("missing DICTID")
        from ..spec.refmodel import adler32 as _adler_host

        if int.from_bytes(data[2:6], "big") != _adler_host(dictionary):
            raise HeaderError("DICTID does not match supplied dictionary")
        offset = 6
    else:
        dictionary = None
    known_adler = None
    if index is not None:
        if getattr(index, "turbo", False) and dictionary is not None:
            raise HeaderError("turbo streams never carry FDICT")
        if ((getattr(index, "turbo", False) or getattr(index, "wide", False))
                and dictionary is None
                and getattr(index, "self_contained", True)):
            # this encoder's streams (turbo and levels 1-9): anchor-lane
            # device decode + block-row resolve
            from .lanes import inflate_raw_lanes

            out = inflate_raw_lanes(data, index)
            end_bit = index.blocks[-1].end_bit
        else:
            from ..runtime import native

            if native.available():
                # full-stream decode of foreign / unpaired indexed streams
                # is faster through the native structure scan + resolve
                # than through the gather-bound XLA indexed decoder
                # (measured ~10x on the bench corpus); the XLA path keeps
                # serving the mesh
                out, _blocks, end_bit, known_adler = inflate_raw_scan(
                    data, byte_offset=offset, dictionary=dictionary)
                # the index wasn't needed for the decode, but a caller
                # passing a MISMATCHED index must still get an error,
                # not silent success (API contract)
                if (index.blocks[-1].end_bit != end_bit
                        or index.total_out != out.size):
                    raise CorruptError(
                        "index does not match this stream "
                        "(block layout / output size disagree)")
            else:
                out = inflate_raw_indexed(data, index,
                                          dictionary=dictionary)
                end_bit = index.blocks[-1].end_bit
    else:
        out, _blocks, end_bit, known_adler = inflate_raw_scan(
            data, byte_offset=offset, dictionary=dictionary)
    if verify_checksum:
        trailer_pos = (end_bit + 7) >> 3
        if trailer_pos + 4 > len(data):
            raise TruncatedError("missing Adler-32 trailer")
        expect = int.from_bytes(data[trailer_pos : trailer_pos + 4], "big")
        from ..runtime import native as _nat

        if known_adler is not None:
            # the native pipelined decode folded Adler into its resolve
            # pass — no extra whole-output traversal
            actual = known_adler
        elif _nat.available():
            # out is host-resident here; the C++ Adler avoids a device
            # upload just to checksum
            actual = _nat.adler32(out.tobytes())
        else:
            actual = int(adler32_device(jnp.asarray(out), out.size))
        if expect != actual:
            raise ChecksumError(f"Adler-32 mismatch: {expect:#x} != {actual:#x}")
    return out.tobytes()
