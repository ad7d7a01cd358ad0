from .block_parallel import (  # noqa: F401
    make_mesh,
    parallel_deflate,
    parallel_inflate,
    parallel_inflate_lanes,
    sharded_deflate_step,
    sharded_inflate_step,
    sharded_lane_inflate_step,
)
from . import multihost  # noqa: F401
from .batch import compress_batch, decompress_batch  # noqa: F401
