"""CodecConfig levels, stats, and observability."""
import zlib as pyzlib
from pathlib import Path

import pytest

import zlibes_tpu
from zlibes_tpu import CodecConfig, CodecStats

RAW = (Path(__file__).parent / "golden" / "raw.bin").read_bytes()[:131072]


def test_level_presets():
    sizes = {}
    for level in [0, 1, 6]:
        out = zlibes_tpu.deflate(RAW, level=level)
        assert pyzlib.decompress(out) == RAW
        sizes[level] = len(out)
    assert sizes[0] > len(RAW)  # stored
    assert sizes[6] < sizes[1] < sizes[0]


def test_level_validation():
    with pytest.raises(ValueError):
        CodecConfig.from_level(10)


def test_stats_collection():
    st = CodecStats()
    out = zlibes_tpu.deflate(RAW, stats=st)
    assert st.bytes_in == len(RAW)
    assert st.bytes_out > 0 and st.bytes_out < len(RAW)
    assert st.blocks >= 1 and st.dispatches >= 1
    assert 0 < st.ratio < 1
    assert "match" in st.stage_s


def test_custom_config_seg_size():
    cfg = CodecConfig(seg_size=1024)
    out = zlibes_tpu.deflate(RAW[:65536], config=cfg, block_size=32768)
    assert pyzlib.decompress(out) == RAW[:65536]


def test_device_package_merge_matches_host():
    """SURVEY §2 C7: on-device length-limited table builder (histogram ->
    sort -> prefix membership counts) matches the host package-merge."""
    import numpy as np

    from zlibes_tpu.codec.deflate_pipeline import package_merge_np
    from zlibes_tpu.ops.entropy import package_merge_device

    rng = np.random.default_rng(0)
    cases = [
        np.zeros(19, np.int64),
        np.eye(19, dtype=np.int64)[3] * 7,
        np.array([5, 5, 5, 5], np.int64),
        rng.integers(0, 1000, 288).astype(np.int64),
        np.minimum(rng.zipf(1.3, 288), (1 << 29) // (4 * 288)).astype(np.int64),
        np.array([1, 1, 1, 1000000], np.int64),
    ]
    for max_len in (7, 9, 15):
        for f in cases:
            if int((f > 0).sum()) > (1 << max_len):
                continue  # infeasible: no prefix code exists (never
                # requested by the codec: 7-bit caps only serve the
                # 19-symbol code-length alphabet)
            host = package_merge_np(f, max_len)
            dev = np.asarray(package_merge_device(f, max_len))
            # identical Kraft-optimal length multisets => identical coded
            # size; canonical assignment then yields identical tables
            assert ((f > 0) == (dev > 0)).all()
            assert int((host * f).sum()) == int((dev * f).sum()), (
                max_len, host[f > 0], dev[f > 0])
            assert dev.max(initial=0) <= max_len


def test_stats_reuse_across_configs():
    """Reusing one CodecStats across calls must not
    leak the previous stream's fused Adler into the next trailer."""
    st = CodecStats()
    a = RAW[:16384]
    b = bytes(reversed(RAW[:20480]))
    out_turbo = zlibes_tpu.deflate(a, config=CodecConfig.turbo(), stats=st)
    assert pyzlib.decompress(out_turbo) == a
    out_plain = zlibes_tpu.deflate(b, stats=st)       # non-shared-tables
    assert pyzlib.decompress(out_plain) == b
    out_stored = zlibes_tpu.deflate(b, level=0, stats=st)
    assert pyzlib.decompress(out_stored) == b


def test_shared_tables_block_size_validation():
    """Shared-tables path needs block_size % 2048 == 0
    for the fused Adler tiling; reject others with a clear error."""
    cfg = CodecConfig(seg_size=512, shared_tables=True)
    with pytest.raises(ValueError, match="multiple of 2048"):
        zlibes_tpu.deflate(RAW[:4096], config=cfg, block_size=1536)


def test_level_presets_monotone_effort():
    """from_level effort knobs are monotone in level."""
    prev = None
    for level in range(1, 10):
        cfg = CodecConfig.from_level(level)
        effort = (cfg.probe_words, cfg.candidates, int(cfg.lazy))
        if prev is not None:
            assert cfg.probe_words >= prev[0], f"level {level}"
            assert cfg.candidates >= prev[1], f"level {level}"
            assert effort >= prev, f"level {level}"
        prev = effort


def test_index_sidecar_versioning(tmp_path):
    """Pre-v2 sidecars fail with an explicit versioning
    error, not a generic corruption message downstream."""
    import numpy as np

    from zlibes_tpu.spec.refmodel import StreamIndex

    _, idx = zlibes_tpu.deflate_indexed(RAW[:8192])
    p = tmp_path / "s.npz"
    idx.save(p)
    idx2 = StreamIndex.load(p)
    assert np.array_equal(idx2.anchor_bit, idx.anchor_bit)

    # strip the version field -> a v1-era sidecar
    z = dict(np.load(p))
    del z["version"]
    p1 = tmp_path / "v1.npz"
    np.savez(p1, **z)
    with pytest.raises(ValueError, match="format v1"):
        StreamIndex.load(p1)


def test_level_size_ordering():
    """Level-9 size <= level-6 size <= reference (191,734
    on raw.bin).  Uses the full corpus — sizes are deterministic."""
    raw = (Path(__file__).parent / "golden" / "raw.bin").read_bytes()
    s6 = len(zlibes_tpu.deflate(raw, level=6))
    s9 = len(zlibes_tpu.deflate(raw, level=9))
    assert s9 <= s6 <= 191734, (s9, s6)


def test_phase2_recompute_path_bit_exact():
    """Inputs beyond phase1_cache_blocks re-run match+select in phase 2
    (the >32 MiB memory cap): the recomputed tokens
    must reproduce the cached path's stream bit-for-bit."""
    import dataclasses

    from zlibes_tpu.codec.deflate_pipeline import deflate_raw
    from zlibes_tpu.config import CodecConfig

    data = (RAW[:200000] * 2)[:300000]
    cfg = CodecConfig.turbo(candidates=4, probe_words=4)
    body_cached, _ = deflate_raw(data, block_size=16384, config=cfg)
    cfg2 = dataclasses.replace(cfg, phase1_cache_blocks=2)
    body_recomputed, idx = deflate_raw(data, block_size=16384,
                                           config=cfg2)
    assert body_recomputed == body_cached
    import zlib

    d = zlib.decompressobj(-15)
    assert d.decompress(body_recomputed) == data
