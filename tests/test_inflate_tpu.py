"""Device inflate pipeline vs oracle (CPython zlib) and the reference model."""
import zlib as pyzlib
from pathlib import Path

import numpy as np
import pytest

from zlibes_tpu.codec import inflate_pipeline as ip
from zlibes_tpu.ops import adler32 as adler_ops
from zlibes_tpu.spec import errors
from zlibes_tpu.spec import refmodel as rm

GOLDEN = Path(__file__).parent / "golden"
RAW = GOLDEN.joinpath("raw.bin").read_bytes()
COMPRESSED = GOLDEN.joinpath("compressed.bin").read_bytes()
PLAIN = b"This is zlib.es"
VEC_STORED = bytes([120, 156, 1, 15, 0, 240, 255, 84, 104, 105, 115, 32, 105,
                    115, 32, 122, 108, 105, 98, 46, 101, 115, 43, 35, 5, 108])
VEC_FIXED = bytes([120, 156, 11, 201, 200, 44, 86, 0, 162, 170, 156, 204, 36,
                   189, 212, 98, 0, 43, 35, 5, 108])
VEC_DYNAMIC = bytes([120, 156, 13, 194, 65, 9, 0, 0, 8, 3, 192, 42, 38, 48,
                     141, 9, 4, 193, 129, 191, 253, 150, 126, 194, 213, 130,
                     241, 116, 232, 28, 26, 43, 35, 5, 108])


def test_adler32_device():
    import jax.numpy as jnp

    for data in [b"", b"a", PLAIN, RAW[:100000], bytes(range(256)) * 1000]:
        assert adler_ops.adler32(data) == pyzlib.adler32(data)


def test_golden_vectors():
    assert ip.inflate(VEC_STORED) == PLAIN
    assert ip.inflate(VEC_FIXED) == PLAIN
    assert ip.inflate(VEC_DYNAMIC) == PLAIN


def test_corpus_inflate_scan():
    """configs[0-1]: full inflate of the reference corpus fixture."""
    assert ip.inflate(COMPRESSED) == RAW


def test_inflate_foreign_levels():
    data = RAW[:150000]
    for level in [0, 1, 6, 9]:
        assert ip.inflate(pyzlib.compress(data, level)) == data


def test_inflate_overlapping_copies():
    """dist < len runs (RLE-style) exercise the modular source mapping."""
    data = b"a" * 5000 + b"abc" * 2000 + bytes(np.arange(256, dtype=np.uint8))
    assert ip.inflate(pyzlib.compress(data, 9)) == data


def test_inflate_indexed_from_refmodel_stream():
    """Indexed anchor-parallel decode of a multi-block refmodel stream."""
    data = RAW[:300000]
    comp, index = rm.deflate(data, with_index=True)
    assert rm.inflate(comp) == data  # stream itself is conformant
    out = ip.inflate(comp, index=index)
    assert out == data


def test_inflate_indexed_small_anchors():
    data = RAW[:262144]
    comp, index = rm.deflate(data, block_size=8192, with_index=True,
                             anchor_every=1024)
    out = ip.inflate(comp, index=index)
    assert out == data


def test_inflate_indexed_incompressible():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 200000, dtype=np.uint8).tobytes()
    comp, index = rm.deflate(data, with_index=True)
    out = ip.inflate(comp, index=index)
    assert out == data


def test_indexed_wrong_index_rejected():
    data = RAW[:100000]
    comp, index = rm.deflate(data, with_index=True)
    other, other_index = rm.deflate(RAW[100000:200000], with_index=True)
    with pytest.raises((errors.CorruptError, errors.ChecksumError)):
        ip.inflate(other, index=index)


def test_checksum_verification():
    bad = bytearray(pyzlib.compress(PLAIN))
    bad[-1] ^= 0xFF
    with pytest.raises(errors.ChecksumError):
        ip.inflate(bytes(bad))


def test_corrupt_stream_detected():
    comp = bytearray(pyzlib.compress(RAW[:50000], 9))
    comp[40] ^= 0x5A  # flip bits mid-payload
    with pytest.raises((errors.CorruptError, errors.ChecksumError,
                        errors.TruncatedError, errors.StoredBlockError)):
        ip.inflate(bytes(comp))


def test_inflate_range():
    """Seekable random-access decode via the sidecar index (SURVEY.md §5
    checkpoint/resume: per-block index makes decode restartable)."""
    rng = np.random.default_rng(7)
    data = RAW[:200000] + rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    comp, index = rm.deflate(data, block_size=32768, with_index=True,
                             anchor_every=2048)
    for start, length in [(0, 100), (1, 1), (50000, 40000), (100000, 0),
                          (len(data) - 17, 17), (32768 - 5, 10), (0, len(data))]:
        assert ip.inflate_range(comp, index, start, length) == \
            data[start : start + length]
    with pytest.raises(ValueError):
        ip.inflate_range(comp, index, 0, len(data) + 1)
    with pytest.raises(ValueError):
        ip.inflate_range(comp, index, -1, 5)
