"""Scaling benchmark: block-parallel codec GB/s at 1/2/4/8 mesh devices.

Runs on the virtual CPU mesh (absolute numbers are CPU-bound and
meaningless for an accelerator; the *shape* of the scaling curve is the artifact —
near-linear device scaling of the sharded deflate/inflate steps).
Emits one JSON line; paste the table into BASELINE.md.

  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/bench_scaling.py
"""
import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    """Measures the TURBO pipeline under the mesh: the
    sharded two-phase match + Pallas lock-step select + scatter-free pack
    on the encode side, and the sharded extract/decode_turbo/resolve_turbo
    lanes on the inflate side.  Pass ``--legacy`` for the round-1 XLA
    kernel pipeline."""
    import zlib

    from zlibes_tpu.parallel import make_mesh, parallel_deflate, parallel_inflate
    from zlibes_tpu.spec import refmodel as rm

    turbo = "--legacy" not in sys.argv
    raw = (Path(__file__).resolve().parent.parent
           / "tests" / "golden" / "raw.bin").read_bytes()
    data = b"".join(raw[i * 60000:] + raw[: i * 60000] for i in range(4))
    if turbo:
        mesh8 = make_mesh(8)
        stream, index = parallel_deflate(data, mesh8, block_size=65536,
                                         turbo=True, with_index=True)
    else:
        stream, index = rm.deflate(data, block_size=65536, with_index=True,
                                   anchor_every=4096)
    from zlibes_tpu.parallel import block_parallel as bp

    results = {}
    overhead = {}
    for nd in (1, 2, 4, 8):
        mesh = make_mesh(nd)
        # warm (compile) — first-call wall is the per-mesh compile cost
        t0 = time.perf_counter()
        parallel_deflate(data, mesh, block_size=65536, turbo=turbo)
        compile_def = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(3):
            comp = parallel_deflate(data, mesh, block_size=65536, turbo=turbo)
        t_def = (time.perf_counter() - t0) / 3
        t0 = time.perf_counter()
        parallel_inflate(stream, index, mesh)
        compile_inf = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(3):
            out = parallel_inflate(stream, index, mesh)
        t_inf = (time.perf_counter() - t0) / 3
        # per-call host-overhead phases (one instrumented call each way)
        bp.LAST_TIMINGS.clear()
        parallel_deflate(data, mesh, block_size=65536, turbo=turbo)
        parallel_inflate(stream, index, mesh)
        ov = dict(bp.LAST_TIMINGS)
        overhead[nd] = {k: (round(v, 4) if isinstance(v, float) else v)
                        for k, v in ov.items()}
        overhead[nd]["compile_first_call_s"] = round(
            compile_def + compile_inf, 1)
        assert out == data
        assert zlib.decompress(comp) == data
        results[nd] = (len(data) / t_def / 1e9, len(data) / t_inf / 1e9)
        print(f"devices={nd}: deflate {results[nd][0]:.4f} GB/s, "
              f"inflate {results[nd][1]:.4f} GB/s, overhead {overhead[nd]}",
              file=sys.stderr, flush=True)
    base_d, base_i = results[1]
    print(json.dumps({
        "metric": "virtual_mesh_scaling",
        "pipeline": "turbo" if turbo else "legacy",
        "unit": "GB/s (CPU mesh; shape matters, not magnitude)",
        "deflate": {str(k): round(v[0], 4) for k, v in results.items()},
        "inflate": {str(k): round(v[1], 4) for k, v in results.items()},
        "deflate_speedup_8x": round(results[8][0] / base_d, 2),
        "inflate_speedup_8x": round(results[8][1] / base_i, 2),
        # host-side overhead growth with mesh size: staging (array
        # placement callbacks), dispatch (jit call until handles exist),
        # readback (fetch + splice inputs), host_splice (byte assembly),
        # dispatch count, and first-call compile seconds
        "host_overhead": {str(k): v for k, v in overhead.items()},
    }))


if __name__ == "__main__":
    main()
