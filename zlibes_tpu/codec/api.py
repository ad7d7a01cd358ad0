"""Public API (reference analog src/zlib.ts:11,25 — two functions), plus
the device extensions: indexed streams and device-resident output.

``backend="device"`` (the default) runs the JAX
pipelines; ``backend="refmodel"`` runs the NumPy reference model.
"""
from __future__ import annotations

from ..spec import refmodel as _rm
from . import deflate_pipeline as _dp
from . import inflate_pipeline as _ip

_BACKENDS = ("device", "refmodel")


def _check_backend(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {_BACKENDS}")


def deflate(data: bytes, *, backend: str = "device", block_size: int | None = None,
            level: int | None = None, config=None, stats=None,
            dictionary: bytes | None = None) -> bytes:
    """Compress ``data`` into a zlib stream (header 0x78 0x9C + Adler-32).

    ``level`` 0..9 selects a speed/ratio preset (zlib-style); ``config``
    (a CodecConfig) overrides; ``stats`` (a CodecStats) collects per-call
    observability.
    """
    _check_backend(backend)
    kw = {"block_size": block_size} if block_size else {}
    if backend != "refmodel":
        return _dp.deflate(bytes(data), level=level, config=config,
                           stats=stats, dictionary=dictionary, **kw)
    if dictionary is not None:
        return _rm.deflate(bytes(data), dictionary=dictionary, **kw)
    return _rm.deflate(bytes(data), **kw)


def deflate_indexed(data: bytes, *, backend: str = "device",
                    block_size: int | None = None, level: int | None = None,
                    config=None):
    """Compress and return (zlib_bytes, StreamIndex).

    The index (block layout + decode anchors) unlocks anchor-parallel
    ``inflate(..., index=)`` and seekable access.  The stream itself is
    plain conformant zlib — the index is a sidecar.  ``level`` and
    ``config`` select the encoder preset as in ``deflate`` (e.g.
    ``config=CodecConfig.turbo()``).
    """
    _check_backend(backend)
    kw = {"block_size": block_size} if block_size else {}
    if backend != "refmodel":
        return _dp.deflate(bytes(data), with_index=True, level=level,
                           config=config, **kw)
    return _rm.deflate(bytes(data), with_index=True, **kw)


def inflate(data: bytes, *, backend: str = "device", verify_checksum: bool = True,
            index=None, dictionary: bytes | None = None) -> bytes:
    """Decompress a zlib stream, verifying the Adler-32 trailer.

    ``index=`` (a StreamIndex) selects the block/anchor-parallel device
    path; without it, foreign streams decode via the sequential-structure
    scan path.  ``dictionary=`` supplies the preset dictionary for FDICT
    streams (RFC 1950 §2.2).
    """
    _check_backend(backend)
    if backend != "refmodel":
        return _ip.inflate(bytes(data), verify_checksum=verify_checksum,
                           index=index, dictionary=dictionary)
    return _rm.inflate(bytes(data), verify_checksum=verify_checksum,
                       dictionary=dictionary)


def inflate_to_device(data: bytes, index):
    """Decompress straight into device memory (no device→host transfer).

    Returns a list of (device_array, out_offset, nbytes) spans covering the
    output — e.g. decompressing dataset shards directly into device memory
    for training input pipelines.
    """
    return _ip.inflate_to_device(bytes(data), index)


def inflate_range(data: bytes, index, start: int, length: int) -> bytes:
    """Random-access decode: output bytes [start, start+length) only.

    Seekable reads over a compressed stream using its sidecar StreamIndex —
    decodes just the self-contained blocks covering the range, so cost is
    O(length + block_size) regardless of stream size.
    """
    return _ip.inflate_range(bytes(data), index, start, length)


def build_index(data: bytes, anchor_every: int = 4096):
    """Scan any conformant zlib stream into a StreamIndex (block layout +
    decode anchors) for subsequent anchor-parallel/seekable decodes —
    rapidgzip-style two-pass for foreign streams.  Requires the native
    runtime scanner.
    """
    from ..runtime import native

    if not native.available():
        raise RuntimeError("native runtime unavailable")
    _, _, index, _, _ = native.scan(bytes(data), bit_offset=16)
    return index
