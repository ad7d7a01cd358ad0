"""Multi-host runtime glue (SURVEY.md §2 "Multi-host runtime").

One process per host, ``jax.distributed.initialize``, then the same
block-parallel codec runs over the global mesh — the code path is
identical, the mesh is just bigger.  On a single machine this module is
exercised with the virtual CPU mesh (``dryrun_multichip``).

Typical usage (one process per host):

    from zlibes_tpu.parallel import multihost
    multihost.initialize(addr, n, i)  # coordinator, process count, rank
    mesh = multihost.global_mesh()
    comp = parallel_deflate(data, mesh)   # each host feeds its shard
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the multi-process runtime (idempotent).

    With no arguments, relies on the platform's auto-detection of a
    cluster; on machines without one, pass all three arguments.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def global_mesh() -> Mesh:
    """1-D mesh over every device of every participating process."""
    return Mesh(np.array(jax.devices()), ("blocks",))


def host_shard(total_rows: int) -> tuple[int, int]:
    """This process's contiguous [start, end) row range of a
    ``(total_rows, ...)`` array sharded ``P("blocks")`` over the global
    1-D mesh (``global_mesh()``: process-major device order, equal rows
    per device).  This is the range a ``block_provider`` passed to
    ``parallel_deflate`` must be able to serve — jax asks each process
    only for these rows, so feeding per-host input through it keeps
    every host's memory at ~1/num_processes of the total input.
    ``total_rows`` must be a multiple of the device count (the codec
    pads block batches to D*Bd rows)."""
    all_devs = jax.devices()
    D = len(all_devs)
    if total_rows % D:
        raise ValueError(f"total_rows {total_rows} not divisible by {D}")
    per_dev = total_rows // D
    # position in jax.devices() order (= mesh row order), NOT device.id —
    # ids are not globally dense across processes
    pos = sorted(all_devs.index(d) for d in jax.local_devices())
    assert pos[-1] - pos[0] + 1 == len(pos), "local devices not contiguous"
    return pos[0] * per_dev, (pos[-1] + 1) * per_dev
