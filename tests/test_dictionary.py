"""Preset dictionary (RFC 1950 FDICT) + shared-dictionary batch codec."""
import zlib as pyzlib

import jax
import numpy as np
import pytest

import zlibes_tpu
from zlibes_tpu.parallel.batch import compress_batch, decompress_batch
from zlibes_tpu.parallel import make_mesh
from zlibes_tpu.spec import errors

from pathlib import Path

RAW = (Path(__file__).parent / "golden" / "raw.bin").read_bytes()
DICT = b"the quick brown fox jumps over the lazy dog " * 40
DATA = b"a lazy dog jumps; the quick brown fox naps " * 30


def test_deflate_with_dictionary_oracle():
    out = zlibes_tpu.deflate(DATA, dictionary=DICT)
    plain = zlibes_tpu.deflate(DATA)
    assert len(out) < len(plain)  # the dictionary must actually help
    d = pyzlib.decompressobj(zdict=DICT)
    assert d.decompress(out) == DATA


def test_inflate_with_dictionary_both_directions():
    ours = zlibes_tpu.deflate(DATA, dictionary=DICT)
    assert zlibes_tpu.inflate(ours, dictionary=DICT) == DATA
    co = pyzlib.compressobj(6, pyzlib.DEFLATED, 15, 8, 0, DICT)
    foreign = co.compress(DATA) + co.flush()
    assert zlibes_tpu.inflate(foreign, dictionary=DICT) == DATA


def test_dictionary_errors():
    out = zlibes_tpu.deflate(DATA, dictionary=DICT)
    with pytest.raises(errors.HeaderError):
        zlibes_tpu.inflate(out)  # missing dictionary
    with pytest.raises(errors.HeaderError):
        zlibes_tpu.inflate(out, dictionary=b"wrong dictionary")


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_compress_batch_mesh_broadcast():
    rng = np.random.default_rng(5)
    payloads = [
        (b"fox dog quick lazy " * rng.integers(3, 40)) +
        rng.integers(0, 256, int(rng.integers(0, 200)), dtype=np.uint8).tobytes()
        for _ in range(37)
    ]
    mesh = make_mesh(8)
    members = compress_batch(payloads, DICT, mesh=mesh)
    assert len(members) == len(payloads)
    for m, p in zip(members, payloads):
        d = pyzlib.decompressobj(zdict=DICT)
        assert d.decompress(m) == p  # canonical-zlib oracle
    got = decompress_batch(members, DICT)
    assert got == [bytes(p) for p in payloads]


def test_compress_batch_single_device():
    payloads = [DATA, b"", b"x", DICT[:100]]
    members = compress_batch(payloads, DICT, mesh=make_mesh(1))
    for m, p in zip(members, payloads):
        d = pyzlib.decompressobj(zdict=DICT)
        assert d.decompress(m) == p


def test_indexed_inflate_with_dictionary():
    """index= and dictionary= compose — the first
    group's resolve prefix is seeded with the dictionary tail."""
    from zlibes_tpu.codec.inflate_pipeline import inflate as dev_inflate
    from zlibes_tpu.spec import refmodel as rm

    data = (DATA + bytes(np.random.default_rng(5).integers(
        0, 256, 3000, dtype=np.uint8))) * 4
    comp, index = rm.deflate(data, block_size=4096, with_index=True,
                             anchor_every=1024, dictionary=DICT)
    d = pyzlib.decompressobj(zdict=DICT)
    assert d.decompress(comp) == data  # oracle accepts the FDICT member
    assert dev_inflate(comp, index=index, dictionary=DICT) == data
    # wrong dictionary must be rejected via the DICTID check
    with pytest.raises(errors.HeaderError):
        dev_inflate(comp, index=index, dictionary=b"wrong dict")


def test_single_stream_dictionary_device_path():
    """deflate(dictionary=) runs the device pipeline (the
    first block's matcher sees the dictionary as a context prefix), not
    the host refmodel; the dictionary must still help."""
    raw = RAW[:100000]
    dictionary = raw[:20000]
    data = raw[15000:80000]
    out = zlibes_tpu.deflate(data, dictionary=dictionary)
    d = pyzlib.decompressobj(zdict=dictionary)
    assert d.decompress(out) == data
    assert zlibes_tpu.inflate(out, dictionary=dictionary) == data
    plain = zlibes_tpu.deflate(data)
    assert len(out) < len(plain), "dictionary should shrink the member"


def test_short_dictionary_zero_run_payload():
    """Round-4 regression: the 32 KiB context prefix is left-padded for
    short dictionaries; matches into the padding would emit distances the
    decoder cannot serve (found+fixed via find_matches(ctx_start=)).
    Covers both the single-stream and the batch encoder."""
    from zlibes_tpu.parallel.batch import compress_batch

    sd = b"short dict 123"
    pz = b"\x00\x00\x00\x00" + b"short dict 123 tail" * 4
    out = zlibes_tpu.deflate(pz, dictionary=sd)
    d = pyzlib.decompressobj(zdict=sd)
    assert d.decompress(out) == pz

    members = compress_batch([pz, b"\x00" * 7 + sd], sd)
    for m, want in zip(members, [pz, b"\x00" * 7 + sd]):
        db = pyzlib.decompressobj(zdict=sd)
        assert db.decompress(m) == want
