"""Device deflate pipeline vs oracle (CPython zlib) and round-trips."""
import zlib as pyzlib
from pathlib import Path

import numpy as np
import pytest

from zlibes_tpu.codec import deflate_pipeline as dp
from zlibes_tpu.codec import inflate_pipeline as ip
from zlibes_tpu.spec import refmodel as rm

GOLDEN = Path(__file__).parent / "golden"
RAW = GOLDEN.joinpath("raw.bin").read_bytes()


def test_package_merge_np_matches_refmodel():
    rng = np.random.default_rng(0)
    for _ in range(20):
        freqs = rng.integers(0, 1000, 288)
        freqs[rng.random(288) < 0.5] = 0
        a = dp.package_merge_np(freqs, 15)
        b = rm.package_merge_lengths(freqs, 15)
        # both must be valid (Kraft ≤ 1, here tight) and equally optimal
        assert (a[freqs == 0] == 0).all() and (a[freqs > 0] > 0).all()
        assert ((freqs > 0) * (1 << (15 - np.maximum(a, 1)))).sum() <= 1 << 15
        assert (freqs * a).sum() == (freqs * b).sum()


@pytest.mark.parametrize("payload", [
    b"",
    b"Q",
    b"This is zlib.es",
    b"0123456789" * 100,           # 258-match repeats
    b"a" * 100000,                 # long RLE, stored/dynamic choice
    RAW[:100000],
    RAW[:300000],                  # multi-block
])
def test_deflate_oracle_roundtrip(payload):
    out = dp.deflate(payload)
    assert out[:2] == bytes([0x78, 0x9C])
    assert pyzlib.decompress(out) == payload
    assert ip.inflate(out) == payload


def test_deflate_incompressible_uses_stored():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 200000, dtype=np.uint8).tobytes()
    out = dp.deflate(data)
    assert pyzlib.decompress(out) == data
    # stored blocks keep overhead tiny
    assert len(out) < len(data) * 1.001 + 64


def test_deflate_index_feeds_indexed_inflate():
    data = RAW[:300000]
    out, index = dp.deflate(data, with_index=True)
    assert pyzlib.decompress(out) == data
    assert ip.inflate(out, index=index) == data


def test_deflate_size_competitive():
    """config[3]: ≤ reference encoder output — 191,734 bytes on this
    corpus, pinned via tools/reference_size.py (see BASELINE.md)."""
    out = dp.deflate(RAW)
    assert pyzlib.decompress(out) == RAW
    assert len(out) <= 191734


def test_turbo_size_bar():
    """Per-profile size bars are explicit, not silent.

    The turbo profile trades ratio for kernel-decodable structure (4 KiB
    window resets, 9-bit code cap, one shared table pair, split far
    matches) — a documented decision.  Fence per the
    measured size (201,595 B on raw.bin) + 0.5% drift budget, so ratio
    regressions >0.5% fail CI instead of hiding under the old
    zlib-level-2 ceiling.  The DEFAULT profile is the one that must beat
    the reference encoder (191,734 B) — asserted above."""
    from zlibes_tpu.config import CodecConfig

    out = dp.deflate(RAW, config=CodecConfig.turbo())
    assert pyzlib.decompress(out) == RAW
    assert len(out) <= int(201595 * 1.005)
