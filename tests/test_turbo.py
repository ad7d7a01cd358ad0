"""Turbo profile: shared-table encode + anchor-lane inflate.

Oracle strategy per SURVEY.md §4: CPython zlib must accept every stream we
emit; our turbo inflate must reproduce the input bit-exactly.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from zlibes_tpu.codec import deflate_pipeline as dp
from zlibes_tpu.codec import inflate_pipeline as ip
from zlibes_tpu.codec.lanes import inflate_raw_lanes
from zlibes_tpu.config import CodecConfig
from zlibes_tpu.spec.errors import CorruptError

CFG = CodecConfig.turbo(candidates=4, probe_words=4)
BS = 16384  # small blocks keep CPU compiles fast


def _mixed_data(n=40000, seed=0):
    rng = np.random.default_rng(seed)
    text = (b"the quick brown fox jumps over the lazy dog. " * 200)
    rnd = rng.integers(0, 256, n // 4, dtype=np.uint8).tobytes()
    rle = b"A" * 1200 + b"ab" * 700 + bytes(range(256)) * 4
    out = (text + rnd + rle) * 3
    return out[:n]


@pytest.fixture(scope="module")
def turbo_stream():
    data = _mixed_data()
    comp, index = dp.deflate(data, with_index=True, config=CFG, block_size=BS)
    return data, comp, index


def test_turbo_stream_is_conformant(turbo_stream):
    data, comp, index = turbo_stream
    assert zlib.decompress(comp) == data
    assert index.turbo
    # paired anchors: segment starts every 512 B interleaved with the
    # mid-segment split anchor (first token starting at-or-after byte 256)
    ao = index.anchor_out
    assert ao.size % 2 == 0
    spans = np.arange(ao.size // 2) * 512
    assert np.array_equal(ao[0::2], spans)
    assert (ao[1::2] >= spans).all() and (ao[1::2] <= spans + 512).all()
    assert (ao[1::2][:-1] >= spans[:-1] + 256).all()  # full segments
    assert (np.diff(index.anchor_bit) >= 0).all()


def test_turbo_inflate_roundtrip(turbo_stream):
    data, comp, index = turbo_stream
    out = inflate_raw_lanes(comp, index)
    assert out.tobytes() == data


def test_turbo_via_public_inflate(turbo_stream):
    data, comp, index = turbo_stream
    from zlibes_tpu.codec.inflate_pipeline import inflate

    assert inflate(comp, index=index) == data


def test_turbo_rle_and_long_matches():
    data = b"x" * 5000 + b"yz" * 3000 + b"x" * 300
    comp, index = dp.deflate(data, with_index=True, config=CFG, block_size=BS)
    assert zlib.decompress(comp) == data
    out = inflate_raw_lanes(comp, index)
    assert out.tobytes() == data


def test_turbo_incompressible():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 12000, dtype=np.uint8).tobytes()
    comp, index = dp.deflate(data, with_index=True, config=CFG, block_size=BS)
    assert zlib.decompress(comp) == data
    out = inflate_raw_lanes(comp, index)
    assert out.tobytes() == data


def test_turbo_corruption_detected(turbo_stream):
    """Every payload corruption must surface as a typed error through the
    public inflate: structural damage raises CorruptError in the kernel
    checks; value-only damage (e.g. a flipped literal whose code length is
    unchanged) is caught by the Adler-32 verify."""
    from zlibes_tpu.codec.inflate_pipeline import inflate
    from zlibes_tpu.spec.errors import ChecksumError

    data, comp, index = turbo_stream
    rng = np.random.default_rng(3)
    hits = 0
    for _ in range(6):
        bad = bytearray(comp)
        pos = int(rng.integers(16, len(bad) - 8))
        bad[pos] ^= int(rng.integers(1, 256))
        try:
            out = inflate(bytes(bad), index=index)
            assert out == data  # flip landed in a skipped header bit-gap
        except (CorruptError, ChecksumError):
            hits += 1
    assert hits >= 4  # most flips must be detected


def test_turbo_rejects_non_turbo_index():
    """A default-profile index claiming the turbo profile fails the turbo
    anchor geometry (a pair per 512 B segment)."""
    data = _mixed_data(20000)
    comp, index = dp.deflate(data, with_index=True, block_size=BS)
    assert not index.turbo
    index.turbo = True
    with pytest.raises(CorruptError):
        inflate_raw_lanes(comp, index)


def test_pack_payload_turbo_matches_pack_payload_fast():
    """The shared-table field lookup + sort-placement packer must be
    bit-exact vs the one-hot reference packer on real tokens (incl.
    zero-run data)."""
    import jax.numpy as jnp

    from zlibes_tpu.codec.deflate_pipeline import (_encode_tables,
                                                   package_merge_np)
    from zlibes_tpu.ops.deflate_kernel import (pack_payload_fast,
                                               pack_payload_turbo,
                                               token_symbols)
    from zlibes_tpu.ops.lz77 import find_matches, select_tokens
    from zlibes_tpu.spec import constants as C

    cfg = CodecConfig.turbo(candidates=4, probe_words=4)
    N = BS
    nseg = N // cfg.seg_size
    Bp = 2
    data = bytes([4, 255, 255, 255]) + bytes(64) + _mixed_data(2 * N)
    arr = np.frombuffer(data, np.uint8)
    blk = np.zeros((Bp, N + 8), np.uint8)
    nv = np.zeros(Bp, np.int32)
    for i in range(Bp):
        c = arr[i * N : (i + 1) * N]
        blk[i, : c.size] = c
        nv[i] = c.size
    m = find_matches(jnp.asarray(blk), jnp.asarray(nv), N=N,
                     S=cfg.probe_words, J=cfg.candidates,
                     reset=cfg.chunk_reset, two_phase=True)
    tv, td, cnt = select_tokens(jnp.asarray(blk), m, jnp.asarray(nv),
                                N=N, SEG_SIZE=cfg.seg_size, lazy=True,
                                split_far=True)
    lsym, dsym, valid, llf, dfq = token_symbols(tv, td, cnt, nseg=nseg)
    llt = np.asarray(llf).astype(np.int64).sum(0)
    dft = np.asarray(dfq).astype(np.int64).sum(0)
    llt[C.END_OF_BLOCK] += 1
    ll_len = package_merge_np(llt, 9)
    d_len = package_merge_np(dft, 9)
    if d_len.max(initial=0) == 0:
        d_len[0] = 1
    ll_code, d_code = _encode_tables(ll_len, d_len)
    d_code = np.pad(d_code, (0, 32 - d_code.size))
    d_len = np.pad(d_len, (0, 32 - d_len.size))
    tabs = (jnp.asarray(np.broadcast_to(ll_code, (Bp, 288))),
            jnp.asarray(np.broadcast_to(ll_len, (Bp, 288))),
            jnp.asarray(np.broadcast_to(d_code, (Bp, 32))),
            jnp.asarray(np.broadcast_to(d_len, (Bp, 32))))
    hdrb = jnp.asarray(np.array([100, 77], np.int32))
    en = jnp.ones(Bp, bool)
    W = (15 * N + 4096) // 32
    R = cfg.pack_row_width()
    w1, pe1, lb1 = pack_payload_fast(tv, td, lsym, dsym, valid, *tabs,
                                     hdrb, en, nseg=nseg, W=W, R=R)
    w2, pe2, lb2, _sb, _so = pack_payload_turbo(tv, td, valid, *tabs,
                                                hdrb, en, nseg=nseg, W=W, R=R)
    assert (np.asarray(pe1) == np.asarray(pe2)).all()
    assert (np.asarray(lb1) == np.asarray(lb2)).all()
    assert (np.asarray(w1) == np.asarray(w2)).all()


def test_turbo_fuzz_batched_lanes():
    """>=1000 corruptions through the turbo lane path — batched as
    parallel decode lanes (one corruption per 512 B anchor segment => each
    dispatch carries hundreds of simultaneous corruptions).  Oracle per
    corrupted segment: the decode either flags the lane (err / ran past
    its anchor — Huffman codes self-synchronize, so many flips re-sync to
    the right end bit) or produces wrong bytes there (which the
    stream-level Adler turns into ChecksumError — also asserted via the
    public inflate)."""
    from zlibes_tpu.codec.lanes import LanePlan, stream_words
    from zlibes_tpu.ops import lane_decode as ld
    from zlibes_tpu.spec.errors import ChecksumError

    data = _mixed_data(260000, seed=11)
    comp, index = dp.deflate(data, with_index=True, config=CFG,
                             block_size=BS)
    plan = LanePlan.build(comp, index)
    arr = np.frombuffer(data, np.uint8)
    rng = np.random.default_rng(5)
    total_corruptions = 0
    detected = 0
    while total_corruptions < 1000:
        bad = bytearray(comp)
        corrupted_segs = []
        spans = index.anchor_bit[0::2] // 8
        for k in range(len(spans)):
            lo = int(spans[k]) + 1
            hi = int(index.anchor_bit[min(2 * k + 2, index.anchor_bit.size
                                          - 1)] // 8)
            if hi <= lo:
                continue
            pos = int(rng.integers(lo, hi))
            if pos < len(bad) - 8:
                bad[pos] ^= int(rng.integers(1, 256))
                corrupted_segs.append(k)
        total_corruptions += len(corrupted_segs)
        with pytest.raises((CorruptError, ChecksumError)):
            ip.inflate(bytes(bad), index=index)
        # per-lane oracle: decode the corrupted payload (with the clean
        # stream's tables — a flip may hit a block header) unchecked and
        # compare each 256 B half-segment against the true bytes; every
        # block row but the last is full, so segment k owns lanes 2k, 2k+1
        tokens, meta = ld.decode_lanes(stream_words(bytes(bad)), plan.lanes,
                                       plan.tables, T=plan.T)
        meta = np.asarray(meta)
        flagged = ((meta[2] > 0) | (meta[3] > 0)
                   | (meta[1] != np.asarray(plan.lanes[2])))
        rows, _lb, _err = ld.resolve_lanes(tokens, jnp.asarray(meta[0]),
                                           plan.lane_out, plan.row_len,
                                           O=plan.O)
        out = np.asarray(rows)[: plan.total_out]
        ndiff = out != arr
        for k in corrupted_segs:
            lanes_bad = bool(flagged[2 * k]) or bool(flagged[2 * k + 1])
            seg_bytes_bad = bool(ndiff[512 * k : 512 * (k + 1)].any())
            detected += int(lanes_bad or seg_bytes_bad)
    assert total_corruptions >= 1000
    # a flip may (rarely) decode to byte-identical output via a different
    # token sequence; everything else must be caught at lane granularity
    assert detected >= 0.98 * total_corruptions, (
        detected, total_corruptions)


def test_pack_dense_matches_block_buffers():
    """The compacted-image packer must produce byte-identical stream words
    to the per-block-buffer packer for every block (same lane rows, same
    bit offsets — only the splice differs)."""
    import jax.numpy as jnp

    from zlibes_tpu.codec.deflate_pipeline import (_encode_tables,
                                                   package_merge_np)
    from zlibes_tpu.ops.deflate_kernel import (pack_payload_turbo,
                                               pack_payload_turbo_dense,
                                               token_symbols)
    from zlibes_tpu.ops.lz77 import find_matches, select_tokens
    from zlibes_tpu.spec import constants as C

    cfg = CodecConfig.turbo(candidates=4, probe_words=4)
    N = BS
    nseg = N // cfg.seg_size
    Bp = 3  # includes a SHORT last block (trailing empty lanes) + padding
    data = _mixed_data(2 * N + 5000, seed=9)
    arr = np.frombuffer(data, np.uint8)
    blk = np.zeros((Bp + 1, N + 8), np.uint8)
    nv = np.zeros(Bp + 1, np.int32)
    for i in range(Bp):
        c = arr[i * N : (i + 1) * N]
        blk[i, : c.size] = c
        nv[i] = c.size
    m = find_matches(jnp.asarray(blk), jnp.asarray(nv), N=N,
                     S=cfg.probe_words, J=cfg.candidates,
                     reset=cfg.chunk_reset, two_phase=True)
    tv, td, cnt = select_tokens(jnp.asarray(blk), m, jnp.asarray(nv),
                                N=N, SEG_SIZE=cfg.seg_size, lazy=True,
                                split_far=True)
    _ls, _ds, valid, llf, dfq = token_symbols(tv, td, cnt, nseg=nseg)
    llt = np.asarray(llf).astype(np.int64).sum(0)
    dft = np.asarray(dfq).astype(np.int64).sum(0)
    llt[C.END_OF_BLOCK] += 1
    ll_len = package_merge_np(llt, 9)
    d_len = package_merge_np(dft, 9)
    if d_len.max(initial=0) == 0:
        d_len[0] = 1
    ll_code, d_code = _encode_tables(ll_len, d_len)
    d_code = np.pad(d_code, (0, 32 - d_code.size))
    d_len = np.pad(d_len, (0, 32 - d_len.size))
    B = Bp + 1
    tabs = (jnp.asarray(np.broadcast_to(ll_code, (B, 288))),
            jnp.asarray(np.broadcast_to(ll_len, (B, 288))),
            jnp.asarray(np.broadcast_to(d_code, (B, 32))),
            jnp.asarray(np.broadcast_to(d_len, (B, 32))))
    hdrb = jnp.asarray(np.array([100, 77, 13, 100], np.int32))
    en = jnp.ones(B, bool)
    W = (15 * N + 4096) // 32
    R = cfg.pack_row_width()
    eob_len = int(ll_len[C.END_OF_BLOCK])

    words, pe_a, lb_a, sb_a, so_a = pack_payload_turbo(
        tv, td, valid, *tabs, hdrb, en, nseg=nseg, W=W, R=R)
    dense, pe_b, lb_b, sb_b, so_b = pack_payload_turbo_dense(
        tv, td, valid, *tabs, hdrb, en, jnp.int32(eob_len), nseg=nseg, R=R)
    for x, y in ((pe_a, pe_b), (lb_a, lb_b), (sb_a, sb_b), (so_a, so_b)):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    pe = np.asarray(pe_a).astype(np.int64)
    used = (pe + eob_len + 31) // 32 + 1
    off = np.concatenate([[0], np.cumsum(used)])
    words_np = np.asarray(words)
    dense_np = np.asarray(dense)
    for i in range(B):
        w = int(used[i])
        assert np.array_equal(
            dense_np[int(off[i]) : int(off[i]) + w].astype(np.uint32),
            words_np[i, :w].astype(np.uint32)), f"block {i}"
