"""Interim benchmark: public-path codec timings on one GPU.

    python bench.py [--size-mib 64] [--seed 0] [--runs 5]

Times deflate, deflate_indexed + inflate(index=), inflate_to_device and a
foreign-stream inflate on seeded text-like data (chip_smoke.make_data),
each the median of --runs calls after one warm-up, ending in
block_until_ready.  Prints the device and the card's name and power limit,
then one JSON line of GB/s of uncompressed bytes.  Fails without a GPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import zlib

import jax

import zlibes_tpu
from chip_smoke import card_line, make_data


def median_s(fn, runs: int) -> float:
    jax.block_until_ready(fn())
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size-mib", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        return 1
    print(f"device: {dev.device_kind} x {len(jax.devices())}; card: "
          f"{card_line()}", flush=True)
    data = make_data(args.size_mib << 20, args.seed)
    comp, index = zlibes_tpu.deflate_indexed(data)
    foreign = zlib.compress(data, 6)
    assert zlib.decompress(comp) == data
    cases = {
        "deflate": lambda: zlibes_tpu.deflate(data),
        "inflate_indexed": lambda: zlibes_tpu.inflate(comp, index=index),
        "inflate_to_device": lambda: [
            a for a, _b, _n in zlibes_tpu.inflate_to_device(comp, index)],
        "inflate_foreign": lambda: zlibes_tpu.inflate(foreign),
    }
    result = {"device": dev.device_kind, "bytes": len(data),
              "ratio": len(comp) / len(data)}
    for name, fn in cases.items():
        result[f"{name}_gbps"] = len(data) / median_s(fn, args.runs) / 1e9
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
