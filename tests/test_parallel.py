"""Multi-device block-parallel codec on the virtual CPU mesh."""
import zlib as pyzlib
from pathlib import Path

import numpy as np
import pytest
import jax

from zlibes_tpu.parallel import make_mesh, parallel_deflate, parallel_inflate
from zlibes_tpu.spec import refmodel as rm

needs_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@needs_multidevice
def test_parallel_deflate_roundtrip():
    rng = np.random.default_rng(3)
    data = (b"mesh-sharded deflate " * 500) + rng.integers(
        0, 256, 2048, dtype=np.uint8).tobytes()
    mesh = make_mesh(8)
    comp = parallel_deflate(data, mesh, block_size=2048, seg_size=256)
    assert pyzlib.decompress(comp) == data
    assert rm.inflate(comp) == data


@needs_multidevice
def test_parallel_deflate_adler_psum():
    """The psum-combined Adler-32 trailer must match the canonical value."""
    data = b"adler over the mesh" * 321
    mesh = make_mesh(8)
    comp = parallel_deflate(data, mesh, block_size=1024, seg_size=256)
    assert int.from_bytes(comp[-4:], "big") == pyzlib.adler32(data)


@needs_multidevice
def test_parallel_inflate_matches():
    data = (b"0123456789abcdef" * 2000) + b"tail"
    mesh = make_mesh(8)
    comp, index = rm.deflate(data, block_size=4096, with_index=True,
                             anchor_every=1024)
    out = parallel_inflate(comp, index, mesh)
    assert out == data


@needs_multidevice
def test_parallel_single_device_mesh():
    """Degenerate 1-device mesh must also work (the real-chip case)."""
    data = b"single device mesh " * 100
    mesh = make_mesh(1)
    comp = parallel_deflate(data, mesh, block_size=1024, seg_size=256)
    assert pyzlib.decompress(comp) == data


@needs_multidevice
def test_parallel_dynamic_deflate_ratio():
    """the sharded path uses dynamic tables (one shared
    psum-combined pair) and lands near the single-device pipeline ratio."""
    import zlib as pyzlib

    from zlibes_tpu.codec import deflate_pipeline as dp

    data = (Path(__file__).parent / "golden" / "raw.bin").read_bytes()[:200000]
    mesh = make_mesh(8)
    comp_dyn = parallel_deflate(data, mesh, block_size=16384)
    comp_fix = parallel_deflate(data, mesh, block_size=16384, dynamic=False)
    assert pyzlib.decompress(comp_dyn) == data
    assert pyzlib.decompress(comp_fix) == data
    assert len(comp_dyn) < len(comp_fix) * 0.92  # dynamic must clearly win
    single = dp.deflate(data, block_size=16384)
    assert len(comp_dyn) <= len(single) * 1.10  # near the per-block-table ratio


@needs_multidevice
def test_parallel_turbo_roundtrip():
    """the FLAGSHIP (turbo) pipeline under the mesh — the
    sharded encode runs the two-phase matcher + Pallas lock-step selection
    + scatter-free pack; the sharded inflate runs extract/shift/
    decode_turbo/resolve_turbo on every device's lane shard."""
    data = (Path(__file__).parent / "golden" / "raw.bin").read_bytes()[:131072]
    mesh = make_mesh(8)
    comp, index = parallel_deflate(data, mesh, block_size=16384, turbo=True,
                                   with_index=True)
    assert pyzlib.decompress(comp) == data  # oracle gate
    assert index.turbo
    out = parallel_inflate(comp, index, mesh)
    assert out == data


@needs_multidevice
def test_parallel_turbo_inflate_of_host_stream():
    """A turbo stream from the single-device encoder decodes on the mesh."""
    from zlibes_tpu.codec import deflate_pipeline as dp
    from zlibes_tpu.config import CodecConfig

    data = (Path(__file__).parent / "golden" / "raw.bin").read_bytes()[:98304]
    comp, index = dp.deflate(data, with_index=True,
                             config=CodecConfig.turbo(candidates=4,
                                                      probe_words=4),
                             block_size=16384)
    mesh = make_mesh(8)
    out = parallel_inflate(comp, index, mesh)
    assert out == data
