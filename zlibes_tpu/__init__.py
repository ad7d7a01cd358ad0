"""zlibes_tpu — a zlib/DEFLATE codec framework in JAX (XLA and Pallas).

Brand-new implementation with the capabilities of zprodev/zlib.es
(RFC 1950 container + RFC 1951 DEFLATE, two-function API), re-designed
for accelerators: block-data-parallel encode/decode over device meshes, batched
table-driven Huffman decode, vectorized LZ77 match finding, scan-based
bit packing, and tiled Adler-32 reduction.

Public API (reference analog src/zlib.ts:11,25):
    deflate(data) -> bytes
    inflate(data) -> bytes
"""

from .codec.api import (  # noqa: F401
    build_index,
    deflate,
    deflate_indexed,
    inflate,
    inflate_range,
    inflate_to_device,
)
from .spec import constants, errors  # noqa: F401
from .spec.refmodel import StreamIndex  # noqa: F401
from .config import CodecConfig, CodecStats  # noqa: F401

__version__ = "0.1.0"
__all__ = [
    "deflate", "deflate_indexed", "inflate", "inflate_range",
    "inflate_to_device", "build_index", "StreamIndex", "CodecConfig",
    "CodecStats", "constants", "errors",
]
