"""Multi-host worker: one process of a 2-process jax.distributed run.

Launched by tests/test_multihost.py:
    python tests/mh_worker.py <coordinator> <nproc> <pid> <outdir>
Each process owns 4 virtual CPU devices; the global mesh has 8.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax

jax.config.update("jax_platforms", "cpu")

from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    coordinator, nproc, pid, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    # distributed init must precede anything that touches the backend —
    # including package imports that build device constants
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=nproc, process_id=pid)
    from zlibes_tpu.parallel import multihost
    from zlibes_tpu.parallel.block_parallel import (
        parallel_deflate, parallel_inflate)
    from zlibes_tpu.spec import refmodel as rm
    assert jax.process_count() == nproc
    assert len(jax.devices()) == 4 * nproc, jax.devices()
    mesh = multihost.global_mesh()

    rng = np.random.default_rng(42)  # same generator on every host
    base = (b"multi host deflate over DCN " * 700
            + rng.integers(0, 256, 3000, dtype=np.uint8).tobytes())
    data = (base * 3)[: 16 * 8192]  # 16 blocks -> tiles the 8-device mesh

    # --- per-host input feeding: each process serves ONLY
    # its addressable block rows through a provider; jax.make_array_from_
    # callback never asks for the rest, so per-process staging memory is
    # ~1/nproc of the input.  The provider asserts the access pattern.
    N = 8192
    n = len(data)
    D = len(jax.devices())
    nblocks = -(-n // N)
    DBd = D * (-(-nblocks // D))
    lo, hi = multihost.host_shard(DBd)
    assert (hi - lo) * nproc == DBd, (lo, hi, DBd)
    served = []

    def provider(i):
        assert lo <= i < hi, (
            f"host {pid} asked for non-addressable block {i} "
            f"(shard [{lo}, {hi}))")
        served.append(i)
        # a real deployment reads only [i*N, (i+1)*N) from its source;
        # the full-buffer slice here stands in for that range read
        return data[i * N : (i + 1) * N]

    comp = parallel_deflate(None, mesh, block_size=N, seg_size=1024,
                            n_bytes=n, block_provider=provider)
    assert served, "block_provider was never consulted"
    assert set(served) <= set(range(lo, hi))
    staged = sum(1 for i in served if i < nblocks) * N
    # the hard bound is rows-per-host; with nblocks == DBd it is exactly
    # 1/nproc of the input
    assert staged <= (hi - lo) * N < n, (
        f"host {pid} staged {staged} B of {n} — not a 1/{nproc} shard")
    import zlib

    assert zlib.decompress(comp) == data, "oracle reject on host %d" % pid

    # round-trip through the block-parallel inflate on the same mesh
    stream2, index2 = rm.deflate(data, block_size=8192, with_index=True,
                                 anchor_every=2048)
    out = parallel_inflate(stream2, index2, mesh)
    assert out == data, "parallel inflate mismatch on host %d" % pid

    if pid == 0:
        Path(outdir, "comp.bin").write_bytes(comp)
        Path(outdir, "ok").write_text(
            f"procs={jax.process_count()} devices={len(jax.devices())}")
    print(f"worker {pid} OK", flush=True)


if __name__ == "__main__":
    main()
