"""Per-level (size, wall, device-stage) table on tests/golden/raw.bin.

The reference has no levels, so the level contract is ours
to keep coherent — this records what each preset actually buys.  Run on
the GPU for meaningful times; sizes are deterministic everywhere.

  python tools/bench_levels.py            # all levels 0-9 + turbo
  python tools/bench_levels.py 1 6 9      # subset

Paste the JSON into BASELINE.md's level table.
"""
from __future__ import annotations

import json
import sys
import time
import zlib as pyzlib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def main() -> None:
    from zlibes_tpu.codec import deflate_pipeline as dp
    from zlibes_tpu.config import CodecConfig, CodecStats

    raw = (Path(__file__).resolve().parent.parent
           / "tests" / "golden" / "raw.bin").read_bytes()
    n = len(raw)
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    levels = [int(a) for a in args] if args else list(range(10))
    rows = {}
    for level in levels:
        cfg = CodecConfig.from_level(level)
        st = CodecStats()
        out = dp.deflate(raw, config=cfg, stats=st)   # warm compile
        assert pyzlib.decompress(out) == raw
        st = CodecStats()
        t0 = time.perf_counter()
        out = dp.deflate(raw, config=cfg, stats=st)
        wall = time.perf_counter() - t0
        rows[str(level)] = {
            "size": len(out),
            "ratio": round(len(out) / n, 4),
            "wall_s": round(wall, 3),
            "stages_s": {k: round(v, 3) for k, v in st.stage_s.items()},
        }
        print(f"level {level}: {rows[str(level)]}", file=sys.stderr,
              flush=True)
    if not args:
        st = CodecStats()
        out = dp.deflate(raw, config=CodecConfig.turbo(), stats=st)
        assert pyzlib.decompress(out) == raw
        st = CodecStats()
        t0 = time.perf_counter()
        out = dp.deflate(raw, config=CodecConfig.turbo(), stats=st)
        rows["turbo"] = {
            "size": len(out),
            "ratio": round(len(out) / n, 4),
            "wall_s": round(time.perf_counter() - t0, 3),
            "stages_s": {k: round(v, 3) for k, v in st.stage_s.items()},
        }
        print(f"turbo: {rows['turbo']}", file=sys.stderr, flush=True)
        # monotonicity contract (also asserted in tests/test_config.py)
        assert rows["9"]["size"] <= rows["6"]["size"] <= 191734
    print(json.dumps({"metric": "level_table", "corpus": "raw.bin",
                      "bytes_in": n, "levels": rows}))


if __name__ == "__main__":
    main()
