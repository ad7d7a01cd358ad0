"""Native C++ runtime: structure scanner, resolver, foreign-stream indexes."""
import zlib as pyzlib
from pathlib import Path

import numpy as np
import pytest

from zlibes_tpu.runtime import native
from zlibes_tpu.spec import errors

GOLDEN = Path(__file__).parent / "golden"
RAW = GOLDEN.joinpath("raw.bin").read_bytes()

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native runtime unavailable")


def test_scan_resolve_roundtrip():
    comp = pyzlib.compress(RAW, 6)
    tv, td, index, end_bit, out_len = native.scan(comp, bit_offset=16)
    assert out_len == len(RAW)
    out = native.resolve(tv, td, out_len)
    assert bytes(out) == RAW
    assert (end_bit + 7) // 8 + 4 == len(comp)


def test_scan_all_levels_and_block_types():
    data = RAW[:120000]
    for level in [0, 1, 6, 9]:
        comp = pyzlib.compress(data, level)
        tv, td, index, _, out_len = native.scan(comp, 16)
        assert bytes(native.resolve(tv, td, out_len)) == data


def test_scan_detects_cross_block_refs():
    comp = pyzlib.compress(RAW, 6)  # multi-block, shared window
    _, _, index, _, _ = native.scan(comp, 16)
    if len(index.blocks) > 1:
        assert not index.self_contained
    from zlibes_tpu.spec import refmodel as rm
    ours, ours_idx = rm.deflate(RAW[:200000], with_index=True)
    _, _, scanned, _, _ = native.scan(ours, 16)
    assert scanned.self_contained  # our encoder's blocks are independent


def test_scan_error_taxonomy():
    with pytest.raises(errors.TruncatedError):
        native.scan(pyzlib.compress(RAW[:5000])[:40], 16)
    bad = bytearray(pyzlib.compress(RAW[:5000], 9))
    bad[30] ^= 0x7F
    with pytest.raises((errors.CorruptError, errors.TruncatedError,
                        errors.BlockTypeError, errors.StoredBlockError)):
        tv, td, _, _, ol = native.scan(bytes(bad), 16)
        native.resolve(tv, td, ol)


def test_native_adler():
    assert native.adler32(RAW) == pyzlib.adler32(RAW)


def test_foreign_indexed_chained_decode():
    """build_index on a foreign stream → chained-prefix device decode."""
    import zlibes_tpu
    data = RAW * 4
    comp = pyzlib.compress(data, 6)
    idx = zlibes_tpu.build_index(comp)
    assert zlibes_tpu.inflate(comp, index=idx) == data


def test_index_save_load(tmp_path):
    import zlibes_tpu
    comp, idx = zlibes_tpu.deflate_indexed(RAW[:100000], backend="refmodel")
    p = tmp_path / "stream.idx.npz"
    idx.save(p)
    from zlibes_tpu import StreamIndex
    idx2 = StreamIndex.load(p)
    assert zlibes_tpu.inflate(comp, index=idx2) == RAW[:100000]


def _scan_tuple(comp, **kw):
    tv, td, idx, eb, ol = native.scan(comp, **kw)
    blocks = [(b.btype, b.bfinal, b.start_bit, b.payload_start_bit,
               b.end_bit, b.out_start, b.out_len) for b in idx.blocks]
    return (tv.tobytes(), td.tobytes(), blocks, idx.anchor_bit.tobytes(),
            idx.anchor_out.tobytes(), idx.anchor_block.tobytes(), eb, ol)


def test_parallel_scan_bit_identical():
    """Speculative-parallel scan splices spans bit-identically to the
    serial scan across stream shapes."""
    import numpy as np
    data = RAW * 6  # ~2.9 MB in
    for lvl in (1, 6, 9):
        comp = pyzlib.compress(data, lvl)[2:-4]
        a = _scan_tuple(comp, threads=1)
        b = _scan_tuple(comp, threads=2, span_bytes=1 << 17)
        assert a == b, f"level {lvl} parallel scan diverged"


def test_parallel_scan_misspeculation_fallback():
    """Spans landing inside one giant block find no (or a wrong) block
    boundary — the merge must serial-rescan those spans and still produce
    the exact serial result."""
    import numpy as np

    from zlibes_tpu.spec import refmodel as rm

    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 220000, dtype=np.uint8).tobytes()
    # one giant dynamic block: every 64 KiB span boundary is mid-block
    comp = rm.deflate(data, block_size=1 << 20)[2:-4]
    assert len(comp) > (1 << 16) * 2
    a = _scan_tuple(comp, threads=1)
    b = _scan_tuple(comp, threads=2, span_bytes=1 << 16)
    assert a == b
    # and the resolved output is still exact
    tv, td, _, _, ol = native.scan(comp, threads=2, span_bytes=1 << 16)
    assert native.resolve(tv, td, ol).tobytes() == data


def test_parallel_scan_stored_spans():
    """Stored-block streams (incompressible input) splice via the
    LEN/NLEN candidate filter."""
    import numpy as np

    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 1 << 21, dtype=np.uint8).tobytes()
    comp = pyzlib.compress(data, 6)[2:-4]
    a = _scan_tuple(comp, threads=1)
    b = _scan_tuple(comp, threads=0, span_bytes=1 << 17)
    assert a == b


def test_parallel_scan_fixed_block_stream_fallback():
    """Z_FIXED streams contain only fixed-Huffman blocks; the candidate
    filter deliberately never matches them (every bit pattern parses as a
    fixed block, so they carry no signal) — the whole scan must fall back
    serially and still be exact."""
    co = pyzlib.compressobj(6, pyzlib.DEFLATED, 15, 8, pyzlib.Z_FIXED)
    data = RAW * 4
    comp = (co.compress(data) + co.flush())[2:-4]
    assert len(comp) > (1 << 18)
    a = _scan_tuple(comp, threads=1)
    b = _scan_tuple(comp, threads=2, span_bytes=1 << 18)
    assert a == b
