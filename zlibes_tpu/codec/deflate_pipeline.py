"""Deflate pipeline: device match-find/select/pack + host entropy setup.

Block-data-parallel encode (SURVEY.md §2 "Block-parallel deflate"):
input splits into ≤128 KiB blocks; per dispatch a batch of blocks runs

  device: sort-based match finding → segment-lane greedy/lazy selection
          → symbol mapping + per-block histograms (+ for the shared-table
          profile: device package-merge code lengths riding the same
          fused readback — the whole encode pays TWO host syncs)
  host:   header RLE/serialization; per-block stored/fixed/dynamic choice
          (general path only; header-sized work)
  device: payload bit-pack — scan + word placement; the turbo profile
          packs straight to a COMPACTED multi-block stream image via one
          global sort splice (pack_payload_turbo_dense)
  host:   splice blocks byte-aligned (each non-final compressed block is
          followed by an empty stored "sync" block, so every block starts
          on a byte boundary — ~5 bytes per 128 KiB), container framing

The encoder always returns a StreamIndex (blocks + 4 KiB anchors) — the
fuel for anchor-parallel inflate.  Emitted streams are self-contained per
block and decodable by canonical zlib.

Improvements over the reference encoder (allowed by the capability
contract): lazy matching, per-block stored/fixed/dynamic choice
(the reference always emits dynamic blocks and its stored-block writer is
dead code, src/deflate.ts:41-54), correct tiny-input handling.
"""
from __future__ import annotations

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp

from ..ops import huffman, lz77
from ..ops.adler32 import adler32_device
from ..ops.deflate_kernel import (gather_compressed, pack_payload,
                                  pack_payload_turbo, token_symbols)
from ..ops.lz77 import SEG, find_matches, select_tokens
from ..spec import constants as C
from ..spec.refmodel import BitWriter, BlockInfo, StreamIndex, _rle_code_lengths
from ..config import DEFAULT_CONFIG, CodecConfig, CodecStats, trace

_RLE_EXTRA_BITS = {16: 2, 17: 3, 18: 7}
_BLOCKS_PER_DISPATCH = 16
_FIXED_LL_LEN = C.fixed_litlen_code_lengths()
_FIXED_D_LEN = C.fixed_dist_code_lengths()


def _bucket(n: int, lo: int = 1) -> int:
    return max(lo, 1 << (max(n, 1) - 1).bit_length())


def package_merge_np(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Length-limited Huffman lengths via matrix-form package-merge.

    Same algorithm as spec.refmodel.package_merge_lengths but with package
    membership tracked as count vectors (rows), so each merge round is a
    couple of NumPy array ops instead of tuple concatenations.
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    S = freqs.size
    lengths = np.zeros(S, dtype=np.int32)
    active = np.nonzero(freqs)[0]
    n = active.size
    if n == 0:
        return lengths
    if n == 1:
        lengths[active[0]] = 1
        return lengths
    order = np.argsort(freqs[active], kind="stable")
    sw = freqs[active][order]
    sm = np.eye(n, dtype=np.int32)[order]
    mw, mm = sw, sm
    for _ in range(max_len - 1):
        k = (mw.size // 2) * 2
        pw = mw[0:k:2] + mw[1:k:2]
        pm = mm[0:k:2] + mm[1:k:2]
        mw = np.concatenate([sw, pw])
        mm = np.concatenate([sm, pm])
        o = np.argsort(mw, kind="stable")
        mw, mm = mw[o], mm[o]
    sel = mm[: 2 * n - 2].sum(axis=0)
    lengths[active] = sel
    return lengths


def _encode_tables(ll_len: np.ndarray, d_len: np.ndarray):
    """Canonical codes (bit-reversed, ready for LSB-first packing)."""
    codes_ll = huffman.canonical_codes_batch(ll_len[None, :])[0]
    codes_d = huffman.canonical_codes_batch(d_len[None, :])[0]
    rev = huffman._REV16
    ll_code = np.where(
        ll_len > 0, rev[codes_ll.astype(np.uint32)] >> (16 - np.maximum(ll_len, 1)), 0
    ).astype(np.uint32)
    d_code = np.where(
        d_len > 0, rev[codes_d.astype(np.uint32)] >> (16 - np.maximum(d_len, 1)), 0
    ).astype(np.uint32)
    return ll_code, d_code


def _dynamic_header(ll_len: np.ndarray, d_len: np.ndarray, bfinal: int) -> bytes | tuple:
    """Build a dynamic block header bit-string (incl. 3-bit block prefix).

    Returns (bits_as_bytes, nbits).  Reference analog: the HLIT/HDIST/HCLEN
    emission at src/deflate.ts:151-181, rebuilt from RFC 1951 §3.2.7.
    """
    bw = BitWriter()
    bw.write_bits(bfinal, 1)
    bw.write_bits(C.BTYPE_DYNAMIC, 2)
    hlit = max(257, int(np.nonzero(ll_len)[0].max(initial=256)) + 1)
    hdist = max(1, int(np.nonzero(d_len)[0].max(initial=0)) + 1)
    all_lengths = np.concatenate([ll_len[:hlit], d_len[:hdist]])
    rle = _rle_code_lengths(all_lengths)
    clc_freq = np.zeros(C.NUM_CODELEN_SYMBOLS, dtype=np.int64)
    for sym, _ in rle:
        clc_freq[sym] += 1
    clc_len = package_merge_np(clc_freq, C.MAX_CLC_BITS)
    clc_codes = huffman.canonical_codes_batch(clc_len[None, :].astype(np.int64))[0]
    hclen = 19
    while hclen > 4 and clc_len[int(C.CODELEN_ORDER[hclen - 1])] == 0:
        hclen -= 1
    bw.write_bits(hlit - 257, 5)
    bw.write_bits(hdist - 1, 5)
    bw.write_bits(hclen - 4, 4)
    for i in range(hclen):
        bw.write_bits(int(clc_len[int(C.CODELEN_ORDER[i])]), 3)
    for sym, extra in rle:
        bw.write_code(int(clc_codes[sym]), int(clc_len[sym]))
        if sym in _RLE_EXTRA_BITS:
            bw.write_bits(extra, _RLE_EXTRA_BITS[sym])
    nbits = bw.bit_length
    return bytes(bw.out) + (bytes([bw.bitbuf]) if bw.bitcnt else b""), nbits


def _payload_bits(ll_freq, d_freq, ll_len, d_len) -> int:
    """Exact coded payload size (tokens only, EOB excluded)."""
    bits = int((ll_freq * ll_len).sum()) + int((d_freq * d_len).sum())
    lf = ll_freq[257:286]
    bits += int((lf * C.LENGTH_EXTRA_BITS[: lf.size]).sum())
    df = d_freq[:30]
    bits += int((df * C.DIST_EXTRA_BITS[: df.size]).sum())
    return bits


def _or_bits(buf: np.ndarray, bit_off: int, value: int, nbits: int) -> None:
    """OR an LSB-first bit-string into a byte buffer at a bit offset."""
    v = value << (bit_off & 7)
    pos = bit_off >> 3
    nbytes = (nbits + (bit_off & 7) + 7) // 8
    for i in range(nbytes):
        buf[pos + i] |= (v >> (8 * i)) & 0xFF


def _stored_stream(arr: np.ndarray, stats) -> tuple:
    """Level-0 path: raw stored blocks only (no device work)."""
    parts: list[bytes] = []
    blocks: list[BlockInfo] = []
    bit = 0
    pos = 0
    n = arr.size
    while True:
        chunk = arr[pos : pos + 65535]
        last = pos + 65535 >= n
        part = bytes([1 if last else 0]) + len(chunk).to_bytes(2, "little") + \
            ((~len(chunk)) & 0xFFFF).to_bytes(2, "little") + chunk.tobytes()
        blocks.append(BlockInfo(C.BTYPE_STORED, last, bit, bit + 8,
                                bit + len(part) * 8, pos, len(chunk)))
        parts.append(part)
        bit += len(part) * 8
        pos += 65535
        if last:
            break
    body = b"".join(parts)
    stats.bytes_out += len(body)
    stats.blocks += len(blocks)
    index = StreamIndex(blocks, np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(0, np.int32))
    return body, index


class _BlockPlan:
    __slots__ = ("btype", "raw", "hdr_bytes", "hdr_bits", "ll_code", "ll_len",
                 "d_code", "d_len", "eob_code", "eob_len", "bfinal")


_ADLER_CHUNK = 2048


@jax.jit
def _adler_terms(dev_bytes: jax.Array, n_valid: jax.Array):
    """Per-2048-byte-chunk Adler partial terms (A, B) for already-uploaded
    block rows: A = Σ d_j mod m, B = Σ j·d_j mod m.  The host combines
    them across dispatches (s2 term of chunk at global offset o is
    (n-o)·A - B), so the deflate trailer needs no extra device round-trip
    — the tiled device reduction rides the phase-1 dispatch (C9)."""
    from ..ops.adler32 import _M

    Bp, Npad = dev_bytes.shape
    N = Npad - 8
    d = dev_bytes[:, :N].astype(jnp.int32)
    pos = jax.lax.broadcasted_iota(jnp.int32, (Bp, N), 1)
    d = jnp.where(pos < n_valid[:, None], d, 0)
    dd = d.reshape(Bp, N // _ADLER_CHUNK, _ADLER_CHUNK)
    jj = jax.lax.broadcasted_iota(jnp.int32, dd.shape, 2)
    a_c = jnp.sum(dd, axis=2) % _M
    b_c = jnp.sum(dd * jj, axis=2) % _M
    return a_c.reshape(-1), b_c.reshape(-1)


def _deflate_turbo(arr: np.ndarray, N: int, cfg: CodecConfig,
                   stats: CodecStats):
    """Shared-table encode (the turbo profile, and the de-Pythoned entropy
    stage in general): ONE stream-wide length-limited table pair replaces
    the per-block host package-merge loop.

    Phase 1 runs match-find/select/histogram per dispatch on device and
    accumulates global symbol frequencies; the host then builds a single
    (litlen, dist) code pair (capped at cfg.max_code_bits) and one block
    header; phase 2 packs every block's payload with the shared codes.
    Every block header is identical except BFINAL — canonical zlib decodes
    the stream like any other dynamic-Huffman member.
    """
    n = arr.size
    nblocks = -(-n // N)
    SEG_SIZE = cfg.seg_size
    nseg = N // SEG_SIZE
    Bp = cfg.blocks_per_dispatch
    # memory cap: beyond it phase 2 recomputes match+select (bit-exact —
    # the pipeline is deterministic; see CodecConfig.phase1_cache_blocks)
    keep_tokens = nblocks <= cfg.phase1_cache_blocks

    def run_dispatch(d0: int, d1: int):
        B = d1 - d0
        blk_bytes = np.zeros((Bp, N + 8), dtype=np.uint8)
        n_valid = np.zeros(Bp, dtype=np.int32)
        for i, bi in enumerate(range(d0, d1)):
            chunk = arr[bi * N : (bi + 1) * N]
            blk_bytes[i, : chunk.size] = chunk
            n_valid[i] = chunk.size
        dev_bytes = jnp.asarray(blk_bytes)
        dev_nv = jnp.asarray(n_valid)
        ad_a, ad_b = _adler_terms(dev_bytes, dev_nv)
        with stats.timer("match"), trace("zlibes.match"):
            matches = find_matches(dev_bytes, dev_nv, N=N,
                                   S=cfg.probe_words, J=cfg.candidates,
                                   reset=cfg.chunk_reset,
                                   two_phase=cfg.max_code_bits <= 9)
        with stats.timer("select"), trace("zlibes.select"):
            tv, td, cnt = select_tokens(
                dev_bytes, matches, dev_nv, N=N, SEG_SIZE=SEG_SIZE,
                lazy=cfg.lazy, split_far=cfg.max_code_bits <= 9)
        return tv, td, cnt, n_valid, ad_a, ad_b

    # --- phase 1: ALL dispatches launch before the single fused
    # readback (jax async dispatch overlaps device work across spans, and
    # every np.asarray is a host sync)
    nh = C.NUM_LITLEN_SYMBOLS
    nd = C.NUM_DIST_SYMBOLS
    kept = {}
    nv_all = {}
    handles = []
    ll_parts = []
    d_parts = []
    spans = [(d0, min(nblocks, d0 + Bp)) for d0 in range(0, nblocks, Bp)]
    nchunks = N // _ADLER_CHUNK
    nt = Bp * nchunks
    for d0, d1 in spans:
        tv, td, cnt, n_valid, ad_a, ad_b = run_dispatch(d0, d1)
        with stats.timer("symbols"), trace("zlibes.symbols"):
            lsym, dsym, valid, ll_freq, d_freq = token_symbols(
                tv, td, cnt, nseg=nseg)
        # per-BLOCK histograms ride the fused readback: they give the host
        # the exact per-block payload bit count once the shared lengths
        # exist, so phase 2 needs no sizing round-trip
        handles.append(jnp.concatenate(
            [ll_freq.reshape(-1), d_freq.reshape(-1), jnp.max(cnt)[None],
             ad_a, ad_b]))
        ll_parts.append(jnp.sum(ll_freq, axis=0))
        d_parts.append(jnp.sum(d_freq, axis=0))
        nv_all[d0] = n_valid
        if keep_tokens:
            kept[d0] = (tv, td, cnt, valid)
        stats.dispatches += 1
    # the shared length-limited code lengths are built ON DEVICE from the
    # device-side global histogram sum (ops/entropy.py package-merge —
    # north star C7) and ride the SAME fused readback: the whole encode
    # pays exactly TWO host syncs (this one + the phase-2 image download)
    with stats.timer("entropy"):
        from ..ops.entropy import limited_lengths_pair

        ll_tot_d = sum(ll_parts).at[C.END_OF_BLOCK].add(nblocks)
        d_tot_d = sum(d_parts)
        ll_d, d_d = limited_lengths_pair(
            jnp.minimum(ll_tot_d, 1 << 28).astype(jnp.int32),
            jnp.minimum(d_tot_d, 1 << 28).astype(jnp.int32),
            cfg.max_code_bits)
        handles.append(ll_d.astype(jnp.int32))
        handles.append(d_d.astype(jnp.int32))
    with stats.timer("readback"):
        hist_all = np.asarray(jnp.concatenate(handles)).astype(np.int64)
    ll_len = hist_all[-(nh + nd) : -nd]
    d_len = hist_all[-nd:]
    hist_all = hist_all[: -(nh + nd)]
    per = Bp * nh + Bp * nd + 1 + 2 * nt
    ll_blocks = np.zeros((len(spans), Bp, nh), np.int64)
    d_blocks = np.zeros((len(spans), Bp, nd), np.int64)
    max_tokens = 0
    s1_sum = 0
    s2_sum = 0
    _M = 65521
    for k, (d0, d1) in enumerate(spans):
        h = hist_all[k * per : (k + 1) * per]
        ll_blocks[k] = h[: Bp * nh].reshape(Bp, nh)
        d_blocks[k] = h[Bp * nh : Bp * (nh + nd)].reshape(Bp, nd)
        max_tokens = max(max_tokens, int(h[Bp * (nh + nd)]))
        a_c = h[-2 * nt : -nt]
        b_c = h[-nt:]
        offs = ((np.arange(nt, dtype=np.int64) // nchunks + d0) * N
                + (np.arange(nt, dtype=np.int64) % nchunks) * _ADLER_CHUNK)
        s1_sum += int(a_c.sum())
        s2_sum += int((((n - offs) % _M) * a_c - b_c).sum())
    stats.adler = (((n + s2_sum) % 65521) << 16) | ((1 + s1_sum) % 65521)

    # --- host side of the entropy stage: header serialization + canonical
    # code assignment (~50 bytes of work; the lengths came off the device
    # in the phase-1 readback above)
    with stats.timer("entropy"):
        hdr0, hb0 = _dynamic_header(ll_len, d_len, 0)
        hdr1, hb1 = _dynamic_header(ll_len, d_len, 1)
        ll_code, d_code = _encode_tables(ll_len, d_len)
        eob_code = int(ll_code[C.END_OF_BLOCK])
        eob_len = int(ll_len[C.END_OF_BLOCK])
    ll_code_b = jnp.asarray(np.broadcast_to(ll_code, (Bp, ll_code.size)))
    ll_len_b = jnp.asarray(np.broadcast_to(ll_len, (Bp, ll_len.size)))
    d_code_b = jnp.asarray(np.broadcast_to(d_code, (Bp, d_code.size)))
    d_len_b = jnp.asarray(np.broadcast_to(d_len, (Bp, d_len.size)))
    enabled = jnp.ones(Bp, bool)

    # --- phase 2: pack straight to compacted per-span stream images
    # (pack_payload_turbo_dense) — every span dispatched before ONE fused
    # [meta, image] readback; the host knows each block's exact word span
    # from the phase-1 histograms, so no sizing sync is needed
    out_parts: list[bytes] = []
    blocks: list[BlockInfo] = []
    anchor_bit: list[int] = []
    anchor_out: list[int] = []
    anchor_block: list[int] = []
    stream_bit = 0
    R = cfg.pack_row_width(SEG_SIZE)
    F = 80  # filler slots per block (header + EOB tail words)
    if hb0 // 32 + 3 > F or hb1 // 32 + 3 > F:
        raise RuntimeError("dynamic header exceeds the filler budget")
    L_ = Bp * nseg
    eob_dev = jnp.int32(eob_len)
    from ..ops.deflate_kernel import pack_payload_turbo_dense

    layout = []
    handles2 = []
    dense_cap = L_ * R + Bp * F
    for k, (d0, d1) in enumerate(spans):
        B = d1 - d0
        hdr_bits_arr = np.full(Bp, hb0, np.int32)
        if d1 == nblocks:
            hdr_bits_arr[B - 1] = hb1
        pe_h = np.zeros(Bp, np.int64)
        for i in range(Bp):
            pe_h[i] = hdr_bits_arr[i] + _payload_bits(
                ll_blocks[k, i], d_blocks[k, i], ll_len, d_len)
        used = (pe_h + eob_len + 31) // 32 + 1
        blk_off = np.concatenate([[0], np.cumsum(used)]).astype(np.int64)
        if int(blk_off[-1]) > dense_cap:
            # a silent clamp here would shorten the span_dense slices below
            # and emit a corrupt stream — fail loudly instead,
            # mirroring the filler-budget RuntimeError above
            raise RuntimeError(
                f"packed word spans ({int(blk_off[-1])}) exceed the dense "
                f"pack capacity ({dense_cap})")
        total_pad = min(dense_cap, -(-int(blk_off[-1]) // 2048) * 2048)
        layout.append((pe_h, blk_off, total_pad, hdr_bits_arr))

        if keep_tokens:
            tv, td, cnt, valid = kept.pop(d0)
        else:
            tv, td, cnt, _nv, _aa, _ab = run_dispatch(d0, d1)
            _ls, _ds, valid, _lf, _df = token_symbols(tv, td, cnt, nseg=nseg)
        with stats.timer("pack"), trace("zlibes.pack"):
            dense, pe, lb, sb, so = pack_payload_turbo_dense(
                tv, td, valid, ll_code_b, ll_len_b, d_code_b, d_len_b,
                jnp.asarray(hdr_bits_arr), enabled, eob_dev,
                nseg=nseg, R=R, F=F)
            meta = jnp.concatenate([pe, lb, sb, so])
            handles2.append(jnp.concatenate(
                [meta,
                 jax.lax.bitcast_convert_type(dense[:total_pad], jnp.int32)]))
    with stats.timer("readback"):
        blob = np.asarray(jnp.concatenate(handles2))

    pos = 0
    for k, (d0, d1) in enumerate(spans):
        pe_h, blk_off, total_pad, hdr_bits_arr = layout[k]
        B = d1 - d0
        n_valid = nv_all[d0]
        mlen = Bp + 3 * L_
        meta = blob[pos : pos + mlen]
        span_dense = blob[pos + mlen : pos + mlen + total_pad]
        pos += mlen + total_pad
        payload_end_np = meta[:Bp]
        lane_bit0_np = meta[Bp : Bp + L_]
        split_bit_np = meta[Bp + L_ : Bp + 2 * L_]
        split_out_np = meta[Bp + 2 * L_ :]
        if not np.array_equal(payload_end_np.astype(np.int64), pe_h):
            raise RuntimeError(
                "host/device payload layout desync (per-block histogram "
                "bit counts disagree with the packed payload ends)")

        for i in range(B):
            bi = d0 + i
            bfinal = 1 if bi == nblocks - 1 else 0
            nb = int(n_valid[i])
            out_start = bi * N
            hdr = hdr1 if bfinal else hdr0
            hdr_bits = hb1 if bfinal else hb0
            buf = span_dense[int(blk_off[i]) : int(blk_off[i + 1])].view(
                np.uint8).copy()
            end_bits = int(payload_end_np[i])
            hb = np.frombuffer(hdr, dtype=np.uint8)
            buf[: hb.size] |= hb
            _or_bits(buf, end_bits, eob_code, eob_len)
            end_bits += eob_len
            start_bit = stream_bit
            blocks.append(BlockInfo(
                C.BTYPE_DYNAMIC, bool(bfinal), start_bit,
                start_bit + hdr_bits, start_bit + end_bits, out_start, nb))
            for s in range(-(-nb // SEG_SIZE)):
                lane = i * nseg + s
                lb_ = int(lane_bit0_np[lane])
                anchor_bit.append(start_bit + lb_)
                anchor_out.append(out_start + s * SEG_SIZE)
                anchor_block.append(len(blocks) - 1)
                # mid-segment split anchor (paired decode lanes); when no
                # token starts at-or-after SUB, the split is the lane end
                # (empty second half-lane)
                lane_end = (int(lane_bit0_np[lane + 1]) if s + 1 < nseg
                            else int(payload_end_np[i]))
                sb_, so_ = int(split_bit_np[lane]), int(split_out_np[lane])
                if sb_ >= 1 << 30:
                    sb_, so_ = lane_end - lb_, min(nb - s * SEG_SIZE,
                                                   SEG_SIZE)
                anchor_bit.append(start_bit + lb_ + sb_)
                anchor_out.append(out_start + s * SEG_SIZE + so_)
                anchor_block.append(len(blocks) - 1)
            if bfinal:
                nbytes = (end_bits + 7) // 8
                out_parts.append(buf[:nbytes].tobytes())
                stream_bit += nbytes * 8
            else:
                sync_start = end_bits
                nbytes = (end_bits + 3 + 7) // 8
                part = buf[:nbytes].tobytes() + b"\x00\x00\xff\xff"
                out_parts.append(part)
                blocks.append(BlockInfo(
                    C.BTYPE_STORED, False, start_bit + sync_start,
                    start_bit + nbytes * 8,
                    stream_bit + len(part) * 8, out_start + nb, 0))
                stream_bit += len(part) * 8

    body = b"".join(out_parts)
    stats.bytes_out += len(body)
    stats.blocks += len(blocks)
    is_turbo = (cfg.max_code_bits <= 9 and cfg.chunk_reset == 4096
                and cfg.seg_size == 512)
    index = StreamIndex(
        blocks,
        np.asarray(anchor_bit, np.int64),
        np.asarray(anchor_out, np.int64),
        np.asarray(anchor_block, np.int32),
        chunk_reset=cfg.chunk_reset,
        turbo=is_turbo,
        max_tokens=max_tokens,
    )
    return body, index


def deflate_raw(data: bytes, block_size: int = C.BLOCK_MAX_BUFFER_LEN,
                    config: CodecConfig | None = None,
                    stats: CodecStats | None = None,
                    dictionary: bytes | None = None):
    """Encode a raw DEFLATE stream on device.  Returns (bytes, StreamIndex).

    ``dictionary``: preset dictionary (RFC 1950 FDICT) — its 32 KiB tail
    rides as a context prefix on the FIRST block's dispatch rows (the
    matcher sees it through ``find_matches(ctx_start=)``, the selector
    never tokenizes it via ``select_tokens(start=)``); later blocks are
    self-contained, exactly as without a dictionary.  Runs the general
    per-block-table path (the shared-tables/turbo profile ignores
    dictionaries — its 4 KiB window resets could never reach one).
    """
    from ..utils.cache import enable_persistent_cache

    enable_persistent_cache()
    cfg = config or DEFAULT_CONFIG
    stats = stats if stats is not None else CodecStats()
    # a reused CodecStats must not leak a previous stream's fused Adler
    # into this call's trailer (paths that don't fold Adler terms into
    # their dispatches leave it None and deflate() recomputes on device)
    stats.adler = None
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    n = arr.size
    stats.bytes_in += n
    if n == 0:
        body = b"\x01\x00\x00\xff\xff"
        blocks = [BlockInfo(C.BTYPE_STORED, True, 0, 8, 40, 0, 0)]
        return body, StreamIndex(blocks, np.zeros(0, np.int64),
                                 np.zeros(0, np.int64), np.zeros(0, np.int32))
    N = block_size
    SEG_SIZE = cfg.seg_size
    if N % SEG_SIZE:
        raise ValueError("block_size must be a multiple of config.seg_size")
    nblocks = -(-n // N)
    nseg = N // SEG_SIZE

    if cfg.force_stored:
        return _stored_stream(arr, stats)

    dict_np = (np.frombuffer(bytes(dictionary[-C.WINDOW_SIZE:]), np.uint8)
               if dictionary else None)
    if cfg.shared_tables and not dictionary:
        if N % _ADLER_CHUNK:
            raise ValueError(
                f"shared-tables encode requires block_size to be a "
                f"multiple of {_ADLER_CHUNK} (fused Adler tiling); got {N}")
        return _deflate_turbo(arr, N, cfg, stats)
    # context prefix width: 32 KiB for the dictionary case, 0 otherwise
    # (zero keeps the compiled programs identical to the plain path)
    CTX = C.WINDOW_SIZE if dict_np is not None else 0

    out_parts: list[bytes] = []
    blocks: list[BlockInfo] = []
    anchor_bit: list[int] = []
    anchor_out: list[int] = []
    anchor_block: list[int] = []
    stream_bit = 0  # always byte-aligned at block starts

    for d0 in range(0, nblocks, cfg.blocks_per_dispatch):
        d1 = min(nblocks, d0 + cfg.blocks_per_dispatch)
        B = d1 - d0
        Bp = cfg.blocks_per_dispatch  # fixed batch → one compiled program set
        stats.dispatches += 1
        blk_bytes = np.zeros((Bp, CTX + N + 8), dtype=np.uint8)
        n_valid = np.zeros(Bp, dtype=np.int32)
        ctx_np = np.full(Bp, CTX, np.int32)
        for i, bi in enumerate(range(d0, d1)):
            chunk = arr[bi * N : (bi + 1) * N]
            blk_bytes[i, CTX : CTX + chunk.size] = chunk
            n_valid[i] = chunk.size
        if CTX and d0 == 0:
            # the dictionary tail prefixes block 0 only; padding below it
            # (and every other block's whole prefix) is masked from the
            # matcher via ctx_start
            blk_bytes[0, CTX - dict_np.size : CTX] = dict_np
            ctx_np[0] = CTX - dict_np.size

        dev_bytes = jnp.asarray(blk_bytes)
        dev_nv = jnp.asarray(n_valid) + CTX
        ctx_dev = jnp.asarray(ctx_np) if CTX else None
        with stats.timer("match"), trace("zlibes.match"):
            if cfg.candidates > 0:
                matches = find_matches(dev_bytes, dev_nv, N=CTX + N,
                                       S=cfg.probe_words, J=cfg.candidates,
                                       reset=cfg.chunk_reset,
                                       ctx_start=ctx_dev)
            else:  # level 0: literals only
                matches = jnp.zeros((Bp, CTX + N), jnp.int32)
        with stats.timer("select"), trace("zlibes.select"):
            tv, td, cnt = select_tokens(dev_bytes, matches, dev_nv,
                                        N=CTX + N, SEG_SIZE=SEG_SIZE,
                                        lazy=cfg.lazy, start=CTX)
        with stats.timer("symbols"), trace("zlibes.symbols"):
            lsym, dsym, valid, ll_freq, d_freq = token_symbols(tv, td, cnt, nseg=nseg)
        ll_freq_np = np.asarray(ll_freq)
        d_freq_np = np.asarray(d_freq)

        # --- host: per-block coding decision + tables
        plans: list[_BlockPlan] = []
        ll_code_arr = np.zeros((Bp, C.NUM_LITLEN_SYMBOLS), np.uint32)
        ll_len_arr = np.zeros((Bp, C.NUM_LITLEN_SYMBOLS), np.int32)
        d_code_arr = np.zeros((Bp, C.NUM_DIST_SYMBOLS), np.uint32)
        d_len_arr = np.zeros((Bp, C.NUM_DIST_SYMBOLS), np.int32)
        hdr_bits_arr = np.zeros(Bp, np.int32)
        enabled = np.zeros(Bp, bool)
        for i in range(B):
            bi = d0 + i
            bfinal = 1 if bi == nblocks - 1 else 0
            nb = int(n_valid[i])
            llf = ll_freq_np[i].astype(np.int64)
            llf[C.END_OF_BLOCK] += 1
            dfq = d_freq_np[i].astype(np.int64)
            ll_len = package_merge_np(llf, C.MAX_CODELEN_BITS)
            d_len = package_merge_np(dfq, C.MAX_CODELEN_BITS)
            if d_len.max(initial=0) == 0:
                d_len[0] = 1
            hdr, hdr_nbits = _dynamic_header(ll_len, d_len, bfinal)
            dyn_bits = hdr_nbits + _payload_bits(llf, dfq, ll_len, d_len) \
                + int(ll_len[C.END_OF_BLOCK])
            fix_bits = 3 + _payload_bits(llf, dfq, _FIXED_LL_LEN, _FIXED_D_LEN) \
                + int(_FIXED_LL_LEN[C.END_OF_BLOCK])
            stored_bytes = nb + 5 * (-(-nb // 65535))
            plan = _BlockPlan()
            plan.bfinal = bfinal
            if stored_bytes < min(dyn_bits, fix_bits) // 8:
                plan.btype = C.BTYPE_STORED
                plan.raw = arr[bi * N : bi * N + nb]
            elif fix_bits <= dyn_bits:
                plan.btype = C.BTYPE_FIXED
                plan.hdr_bytes = bytes([bfinal | (C.BTYPE_FIXED << 1)])
                plan.hdr_bits = 3
                plan.ll_len, plan.d_len = _FIXED_LL_LEN, _FIXED_D_LEN
            else:
                plan.btype = C.BTYPE_DYNAMIC
                plan.hdr_bytes = hdr
                plan.hdr_bits = hdr_nbits
                plan.ll_len, plan.d_len = ll_len, d_len
            if plan.btype != C.BTYPE_STORED:
                plan.ll_code, plan.d_code = _encode_tables(plan.ll_len, plan.d_len)
                plan.eob_code = int(plan.ll_code[C.END_OF_BLOCK])
                plan.eob_len = int(plan.ll_len[C.END_OF_BLOCK])
                ll_code_arr[i] = plan.ll_code
                ll_len_arr[i] = plan.ll_len
                d_code_arr[i] = plan.d_code
                d_len_arr[i] = plan.d_len
                hdr_bits_arr[i] = plan.hdr_bits
                enabled[i] = True
            plans.append(plan)

        # --- device: payload packing (+ the per-128-B sub-anchor splits
        # that drive the default-profile lane decoder)
        W = (15 * N + 4096) // 32
        words, payload_end, lane_bit0, sub_bit, sub_out = pack_payload(
            tv, td, lsym, dsym, valid,
            jnp.asarray(ll_code_arr), jnp.asarray(ll_len_arr),
            jnp.asarray(d_code_arr), jnp.asarray(d_len_arr),
            jnp.asarray(hdr_bits_arr), jnp.asarray(enabled),
            nseg=nseg, W=W, sub_every=C.WIDE_ANCHOR_SPAN,
        )
        # one fused readback for all packing metadata
        meta_np = np.asarray(jnp.concatenate(
            [payload_end, lane_bit0, sub_bit.reshape(-1),
             sub_out.reshape(-1)]))
        L_ = Bp * nseg
        nsub_lane = SEG_SIZE // C.WIDE_ANCHOR_SPAN
        payload_end_np = meta_np[:Bp]
        lane_bit0_np = meta_np[Bp : Bp + L_]
        sub_bit_np = meta_np[Bp + L_ : Bp + L_ + L_ * nsub_lane].reshape(
            L_, nsub_lane)
        sub_out_np = meta_np[Bp + L_ + L_ * nsub_lane :].reshape(
            L_, nsub_lane)

        # compacted download of used words only
        used_words = np.zeros(B, np.int64)
        for i in range(B):
            if plans[i].btype != C.BTYPE_STORED:
                used_words[i] = (int(payload_end_np[i]) + plans[i].eob_len + 31) // 32 + 1
        idx_parts = [np.arange(used_words[i], dtype=np.int64) + i * W
                     for i in range(B)]
        if idx_parts and sum(u.size for u in idx_parts):
            flat_idx = np.concatenate(idx_parts)
            dense = np.asarray(gather_compressed(
                words.reshape(-1), jnp.asarray(flat_idx.astype(np.int32))))
        else:
            dense = np.zeros(0, np.uint32)
        offs = np.concatenate([[0], np.cumsum(used_words)]).astype(np.int64)

        # --- host: splice blocks
        for i in range(B):
            bi = d0 + i
            plan = plans[i]
            nb = int(n_valid[i])
            out_start = bi * N
            if plan.btype == C.BTYPE_STORED:
                pos = 0
                raw = plan.raw
                while True:
                    chunk = raw[pos : pos + 65535]
                    last_chunk = pos + 65535 >= raw.size
                    bf = plan.bfinal if last_chunk else 0
                    start_bit = stream_bit
                    hdrb = bytes([bf])  # BTYPE=00 in bits 1-2, pad to byte
                    ln = chunk.size
                    part = hdrb + ln.to_bytes(2, "little") + \
                        (~ln & 0xFFFF).to_bytes(2, "little") + chunk.tobytes()
                    out_parts.append(part)
                    blocks.append(BlockInfo(
                        C.BTYPE_STORED, bool(bf), start_bit,
                        start_bit + 8, stream_bit + len(part) * 8,
                        out_start + pos, ln))
                    stream_bit += len(part) * 8
                    pos += 65535
                    if last_chunk:
                        break
                continue
            w0, w1 = int(offs[i]), int(offs[i + 1])
            buf = dense[w0:w1].view(np.uint8).copy()
            end_bits = int(payload_end_np[i])
            # OR the header bits in (device left [0, hdr_bits) untouched)
            hb = np.frombuffer(plan.hdr_bytes, dtype=np.uint8)
            buf[: hb.size - 1] |= hb[:-1]
            if hb.size:
                buf[hb.size - 1] |= hb[-1]
            # EOB
            _or_bits(buf, end_bits, plan.eob_code, plan.eob_len)
            end_bits += plan.eob_len
            start_bit = stream_bit
            blocks.append(BlockInfo(
                plan.btype, bool(plan.bfinal), start_bit,
                start_bit + plan.hdr_bits, start_bit + end_bits,
                out_start, nb))
            # uniform 128-B anchors for this block (wide-profile decode
            # lanes).  A boundary with no token starting at-or-after it in
            # its own selection lane back-fills from the NEXT boundary:
            # the valid (bit, out) pairs are nondecreasing in boundary
            # order, so a suffix-min over the flattened per-block arrays
            # (end-of-block appended) is exactly that back-fill — repeated
            # anchors mark empty decode lanes.
            na_b = -(-nb // C.WIDE_ANCHOR_SPAN)
            lanes_i = slice(i * nseg, (i + 1) * nseg)
            flat_bit = np.concatenate(
                [sub_bit_np[lanes_i].reshape(-1)[:na_b],
                 [end_bits]]).astype(np.int64)
            flat_out = np.concatenate(
                [(np.arange(nseg, dtype=np.int64)[:, None] * SEG_SIZE
                  + sub_out_np[lanes_i]).reshape(-1)[:na_b],
                 [nb]])
            fb = np.minimum.accumulate(flat_bit[::-1])[::-1][:-1]
            fo = np.minimum.accumulate(flat_out[::-1])[::-1][:-1]
            anchor_bit.extend(start_bit + fb)
            anchor_out.extend(out_start + fo)
            anchor_block.extend([len(blocks) - 1] * na_b)
            if plan.bfinal:
                nbytes = (end_bits + 7) // 8
                out_parts.append(buf[:nbytes].tobytes())
                stream_bit += nbytes * 8
            else:
                # empty stored sync block → next block starts byte-aligned
                sync_start = end_bits  # 3 zero bits then pad
                nbytes = (end_bits + 3 + 7) // 8
                part = buf[:nbytes].tobytes() + b"\x00\x00\xff\xff"
                out_parts.append(part)
                blocks.append(BlockInfo(
                    C.BTYPE_STORED, False, start_bit + sync_start,
                    start_bit + nbytes * 8,
                    stream_bit + len(part) * 8, out_start + nb, 0))
                stream_bit += len(part) * 8

    body = b"".join(out_parts)
    stats.bytes_out += len(body)
    stats.blocks += len(blocks)
    index = StreamIndex(
        blocks,
        np.asarray(anchor_bit, np.int64),
        np.asarray(anchor_out, np.int64),
        np.asarray(anchor_block, np.int32),
        chunk_reset=cfg.chunk_reset,
        # dictionary streams' first block references the preset dictionary,
        # which the lane resolve does not halo — they keep the
        # scan/indexed decode paths
        wide=dict_np is None,
    )
    return body, index


def deflate(data: bytes, block_size: int | None = None, with_index: bool = False,
            level: int | None = None, config: CodecConfig | None = None,
            stats: CodecStats | None = None,
            dictionary: bytes | None = None):
    """zlib-container deflate on the device pipeline.

    ``level`` (0..9) selects a CodecConfig preset; ``config`` overrides.
    ``dictionary`` emits an FDICT member (RFC 1950 §2.2): the first
    block's matcher sees the dictionary tail as a device-side context
    prefix (deflate_raw) and the header carries DICTID.
    """
    data = bytes(data)
    if config is None and level is not None:
        config = CodecConfig.from_level(level)
    if stats is None:
        stats = CodecStats()
    body, index = deflate_raw(data, block_size or C.BLOCK_MAX_BUFFER_LEN,
                                  config=config, stats=stats,
                                  dictionary=dictionary)
    if stats.adler is not None:
        # device Adler terms rode the encode dispatches (no extra upload)
        trailer = stats.adler.to_bytes(4, "big")
    else:
        arr = jnp.asarray(np.frombuffer(data, dtype=np.uint8))
        trailer = int(adler32_device(arr, len(data))).to_bytes(4, "big")
    if dictionary is not None:
        from ..spec.refmodel import adler32 as adler32_host

        flg = 0x20 + (2 << 6)
        flg += (31 - (0x78 * 256 + flg) % 31) % 31
        header = bytes([0x78, flg]) + adler32_host(dictionary).to_bytes(
            4, "big")
    else:
        header = C.ZLIB_HEADER
    # container framing counts toward the emitted bytes
    stats.bytes_out += len(header) + len(trailer)
    out = header + body + trailer
    if with_index:
        return out, index.shifted(len(header) * 8)
    return out
