"""Wide-profile (default levels 1-9) device decode path.

The two-level-table lane decoder + block-row resolve
(ops/lane_decode.py, codec/lanes.py) must decode every stream this
encoder's general per-block-table path emits, bit-exactly, under the
CPython-zlib oracle — the device path for per-block 15-bit tables
(reference analog src/inflate.ts:237-291).
"""
import zlib
from pathlib import Path

import numpy as np
import pytest

from zlibes_tpu.codec.deflate_pipeline import deflate, deflate_raw
from zlibes_tpu.codec.inflate_pipeline import inflate, inflate_range
from zlibes_tpu.codec.lanes import LanePlan, inflate_raw_lanes
from zlibes_tpu.config import CodecConfig
from zlibes_tpu.spec.errors import CorruptError


def golden_raw() -> bytes:
    return (Path(__file__).parent / "golden" / "raw.bin").read_bytes()


def _roundtrip(data: bytes, level: int, block_size: int = 16384):
    body, index = deflate_raw(data, block_size=block_size,
                                  config=CodecConfig.from_level(level))
    # oracle: canonical zlib must accept the raw stream
    d = zlib.decompressobj(-15)
    assert d.decompress(body) == data
    assert index.wide
    out = inflate_raw_lanes(body, index)
    assert bytes(out) == data
    return body, index


def test_text_roundtrip_multiblock():
    data = (b"It was the best of times, it was the worst of times. " * 1500)
    _roundtrip(data, level=4)


def test_rle_skipping_subspans():
    # 258-byte matches skip whole 128-B sub-spans: empty decode lanes +
    # boundary-covering tokens found several lanes back
    rng = np.random.default_rng(7)
    data = (b"A" * 5000 + b"xyz" + b"B" * 9000
            + rng.integers(0, 256, 100, dtype=np.uint8).tobytes()) * 3
    _roundtrip(data, level=4)


def test_incompressible_stored_only():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()
    _roundtrip(data, level=4)  # all-stored stream: pure host copies


def test_mixed_stored_and_coded_blocks():
    rng = np.random.default_rng(5)
    data = ((b"the quick brown fox jumps " * 800)
            + rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
            + (b"lorem ipsum dolor " * 900))
    _roundtrip(data, level=4)


def test_literal_heavy_big_lane_window():
    # low-ratio coded data maximizes per-lane stream words (SW bucket)
    rng = np.random.default_rng(11)
    data = rng.integers(0, 16, 120000, dtype=np.uint8).tobytes()
    body, index = _roundtrip(data, level=4)
    lanes = np.asarray(LanePlan.build(body, index).lanes)
    assert (lanes[2] - lanes[1]).max() >= 20 * 32  # lane bit span


def test_tiny_inputs():
    for data in (b"a", b"This is zlib.es", b"ab" * 5):
        _roundtrip(data, level=4)


def test_corpus_container_route_and_oracle():
    raw = golden_raw()
    out, index = deflate(raw, with_index=True,
                         config=CodecConfig.from_level(3))
    assert zlib.decompress(out) == raw
    assert index.wide and not index.turbo
    assert inflate(out, index=index) == raw


def test_range_seeks_ride_wide_path(monkeypatch):
    raw = golden_raw()
    out, index = deflate(raw, with_index=True,
                         config=CodecConfig.from_level(3))
    calls = []
    import zlibes_tpu.codec.lanes as lanes_mod
    real = lanes_mod.inflate_raw_lanes

    def spy(data, idx, check=True):
        calls.append(idx.total_out)
        return real(data, idx, check)

    monkeypatch.setattr(lanes_mod, "inflate_raw_lanes", spy)
    for s, l in [(0, 100), (131070, 300), (400000, 80000), (262144, 1)]:
        assert inflate_range(out, index, s, l) == raw[s : s + l]
    assert len(calls) == 4  # every seek decoded through the lane path


def test_corrupt_payload_detected():
    data = (b"some repetitive data " * 3000)
    body, index = deflate_raw(data, block_size=16384,
                                  config=CodecConfig.from_level(2))
    bad = bytearray(body)
    bad[len(bad) // 2] ^= 0x41
    # structural damage raises; value-only damage must change the bytes
    # (the container's Adler-32 then rejects them)
    try:
        out = inflate_raw_lanes(bytes(bad), index)
    except CorruptError:
        return
    assert bytes(out) != data, "corruption not detected"


def test_mismatched_anchor_counts_rejected():
    data = b"hello world " * 2000
    body, index = deflate_raw(data, block_size=16384,
                                  config=CodecConfig.from_level(2))
    index.anchor_bit = index.anchor_bit[:-1]
    index.anchor_out = index.anchor_out[:-1]
    index.anchor_block = index.anchor_block[:-1]
    with pytest.raises(CorruptError):
        inflate_raw_lanes(body, index)


@pytest.mark.parametrize("ndev", [2, 8])
def test_mesh_sharded_wide_inflate(ndev):
    from zlibes_tpu.parallel.block_parallel import make_mesh, parallel_inflate

    raw = golden_raw()
    body, index = deflate_raw(raw, block_size=16384,
                                  config=CodecConfig.from_level(3))
    assert index.wide
    out = parallel_inflate(body, index, make_mesh(ndev))
    assert out == raw


def test_decode_tables_two_level_long_codes():
    # craft a code with >9-bit litlen lengths to exercise sub-tables
    from zlibes_tpu.ops.lane_decode import LL_ROOT, LL_W, decode_tables

    ll = np.zeros(288, np.int64)
    # a complete canonical code: two short codes + a deep tail
    ll[0] = 1
    ll[1] = 2
    ll[2] = 3
    ll[3] = 4
    ll[4] = 5
    ll[5] = 6
    ll[6] = 7
    ll[7] = 8
    ll[8] = 9
    ll[9] = 11
    ll[10] = 12
    ll[11] = 13
    ll[12] = 15
    ll[13] = 15
    ll[14] = 15
    ll[15] = 15
    ll[256] = 15
    ll[257] = 15
    ll[258] = 15
    ll[259] = 15
    d = np.zeros(32, np.int64)
    d[0] = 1
    d[1] = 1
    lt = decode_tables(ll[None], d[None])[0, :LL_W]
    # root entries for >9-bit prefixes carry the sub flag
    assert (lt[:LL_ROOT] & (1 << 30)).any()
    # every defined symbol decodes back through the table pair
    from zlibes_tpu.ops import huffman

    codes = huffman.canonical_codes_batch(ll[None])[0]
    for sym in np.nonzero(ll)[0]:
        l = int(ll[sym])
        rev = int(huffman._REV16[int(codes[sym])] >> (16 - l))
        e = int(lt[rev & (LL_ROOT - 1)])
        if e & (1 << 30):
            w = e & 15
            base = (e >> 9) & 511
            e = int(lt[LL_ROOT + base + ((rev >> 9) & ((1 << w) - 1))])
        assert (e & 15) == l, sym
