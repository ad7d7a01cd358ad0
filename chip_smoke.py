"""Chip smoke test: the codec's public entry points, once, on a GPU.

    python chip_smoke.py              # one GPU, 256 MiB of data
    python chip_smoke.py --chips 4    # the four-GPU mesh phase only

Phases (one GPU): the device and the native library; the decode kernel
compiled for the card, compared byte for byte with the plain XLA decode and
timed against it (stage and whole indexed inflate); then deflate,
deflate_indexed -> inflate(index=), inflate_to_device, inflate_range seeks,
the turbo profile and a foreign zlib stream, every result checked against
CPython's zlib.  With --chips 4 it runs only the mesh-sharded codec on four
devices and compares it with the same call on one device and with zlib.

The data is rotated and mutated copies of tests/golden/raw.bin, made from
--seed.  Every line but the last is a log line; the last line is one JSON
object.  Any failure exits non-zero before that line is printed.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
import zlib
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
RUNS = 7  # timed runs per measurement, after one warm-up
WHOLE_RUNS = 15  # turns of the kernel-vs-XLA whole inflate (host-noisy)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def make_data(n: int, seed: int) -> bytes:
    """n bytes of text-like data: 64 KiB pieces of the corpus at random
    rotations, with 1 byte in 64 replaced by a random corpus byte."""
    raw = np.frombuffer((ROOT / "tests" / "golden" / "raw.bin").read_bytes(),
                        np.uint8)
    rng = np.random.default_rng(seed)
    piece, per = 1 << 16, 256
    out = np.empty(-(-n // piece) * piece, np.uint8)
    for a in range(0, out.size, piece * per):
        k = min(per, (out.size - a) // piece)
        starts = rng.integers(0, raw.size, k)
        chunk = raw[(starts[:, None] + np.arange(piece)) % raw.size].ravel()
        hit = rng.random(chunk.size) < 1 / 64
        chunk[hit] = raw[rng.integers(0, raw.size, int(hit.sum()))]
        out[a : a + chunk.size] = chunk
    return out[:n].tobytes()


class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations (a
    persistent compile cache, where the machine keeps one, shortens the
    backend part)."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax.monitoring

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_kw):
        if event in self.EVENTS:
            self.total += duration


class Smoke:
    def __init__(self, card: str):
        self.card = card
        self.clock = CompileClock()

    @contextmanager
    def phase(self, name: str):
        c0 = self.clock.total
        t0 = time.perf_counter()
        yield
        wall = time.perf_counter() - t0
        log(f"phase {name}: wall {wall:.3f} s, of which compile "
            f"{self.clock.total - c0:.3f} s [{self.card}]")

    def timed(self, name: str, fn, prep=None) -> float:
        """Median of RUNS calls of fn (of fn(prep()) when prep is given,
        with prep's own time left out)."""
        import jax

        t = []
        for _ in range(RUNS + 1):  # the first run is the warm-up
            arg = (jax.block_until_ready(prep()),) if prep else ()
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*arg))
            t.append(time.perf_counter() - t0)
        return self._report(name, t[1:])

    def _report(self, name: str, t: list) -> float:
        med = statistics.median(t)
        log(f"time {name}: median {med * 1e3:.3f} ms of {len(t)} "
            f"(min {min(t) * 1e3:.3f}, max {max(t) * 1e3:.3f}) [{self.card}]")
        return med

    def paired(self, fns: dict, runs: int = RUNS) -> dict:
        """Median of `runs` timed calls of each function after one warm-up,
        each ending in block_until_ready; the functions take turns in
        alternating order (a, b, b, a, ...) so drift hits all alike.  For
        two functions it also reports the turn-by-turn difference."""
        import jax

        for fn in fns.values():
            jax.block_until_ready(fn())
        ts = {name: [] for name in fns}
        order = list(fns)
        for i in range(runs):
            for name in order if i % 2 == 0 else order[::-1]:
                t0 = time.perf_counter()
                jax.block_until_ready(fns[name]())
                ts[name].append(time.perf_counter() - t0)
        med = {name: self._report(name, t) for name, t in ts.items()}
        if len(order) == 2:
            a, b = order
            diff = [x - y for x, y in zip(ts[a], ts[b])]
            log(f"diff ({a}) - ({b}): median {statistics.median(diff) * 1e3:.3f}"
                f" ms per turn, first faster in {sum(d < 0 for d in diff)} of "
                f"{runs} turns [{self.card}]")
        return med


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"ok: {what}")


def kernel_phase(s: Smoke, name: str, data: bytes, comp: bytes, index):
    """Decode kernel vs plain XLA decode at this stream's real widths: one
    compile each, a byte-for-byte comparison, memory analysis, stage and
    whole-inflate timings."""
    import jax
    import jax.numpy as jnp

    import zlibes_tpu
    from zlibes_tpu.codec.lanes import LanePlan, run_lanes
    from zlibes_tpu.ops import lane_decode as ld

    plan = LanePlan.build(comp, index)
    args = (plan.words, plan.lanes, plan.tables)
    log(f"{name} lanes: {plan.lanes.shape[1]}, T {plan.T}, rows {plan.R} "
        f"x {plan.O} B")
    with s.phase(f"{name} decode kernel compile"):
        kern = ld.decode_lanes_kernel.lower(*args, T=plan.T).compile()
    log(f"{name} kernel memory_analysis: {kern.memory_analysis()}")
    with s.phase(f"{name} decode xla compile"):
        xla = ld.decode_lanes_xla.lower(*args, T=plan.T).compile()
    log(f"{name} xla memory_analysis: {xla.memory_analysis()}")
    tk, mk = kern(*args)
    tx, mx = xla(*args)

    @jax.jit
    def same(tx, mx, tk, mk):
        valid = jnp.arange(tx.shape[0])[:, None] < mx[0][None]
        return (jnp.array_equal(mx, mk)
                & jnp.array_equal(jnp.where(valid, tx, 0),
                                  jnp.where(valid, tk, 0)))

    check(bool(same(tx, mx, tk, mk)),
          f"{name} kernel tokens and meta == XLA decode")
    s.paired({f"{name} decode stage kernel": lambda: kern(*args),
              f"{name} decode stage xla": lambda: xla(*args)})
    s.timed(f"{name} resolve stage xla", lambda: ld.resolve_lanes(
        tx, mx[0], plan.lane_out, plan.row_len, O=plan.O))

    def routed(route, fn):
        def call():
            with mock.patch.object(ld, "decode_route", lambda: route):
                return fn()
        return call

    for route in ("kernel", "xla"):
        check(routed(route, lambda: zlibes_tpu.inflate(comp, index=index))()
              == data, f"{name} inflate(index=) with the {route} decode "
              "== data")
    # device pipeline alone (plan built once), then the whole public call
    s.paired({f"{name} decode+resolve+checks with {r} decode":
              routed(r, lambda: run_lanes(plan)) for r in ("kernel", "xla")})
    s.paired({f"{name} whole inflate(index=) with {r} decode":
              routed(r, lambda: zlibes_tpu.inflate(comp, index=index))
              for r in ("kernel", "xla")}, runs=WHOLE_RUNS)
    host_split(s, name, comp, index)


def host_split(s: Smoke, name: str, comp: bytes, index) -> None:
    """The host parts of inflate(index=), timed one by one (the device
    part is the decode+resolve+checks line): the lane plan with its
    uploads, the readback and assembly of the output, the output copy to
    bytes and the native Adler-32."""
    from zlibes_tpu.codec.lanes import LanePlan, assemble, run_lanes
    from zlibes_tpu.runtime import native

    def build():
        p = LanePlan.build(comp, index)
        return p.words, p.lanes, p.tables, p.lane_out, p.lane_out_end, \
            p.row_len

    s.timed(f"{name} host LanePlan.build (with uploads)", build)
    plan = LanePlan.build(comp, index)
    s.timed(f"{name} readback + assemble",
            lambda rows: assemble(plan, comp, rows),
            prep=lambda: run_lanes(plan))
    out = assemble(plan, comp, run_lanes(plan))
    s.timed(f"{name} host out.tobytes()", out.tobytes)
    raw = out.tobytes()
    s.timed(f"{name} host Adler-32 (native)", lambda: native.adler32(raw))


def encode_stage_phase(s: Smoke, data: bytes):
    """The turbo encoder's XLA stages that replaced kernels (select,
    per-token fields + pack), timed on one dispatch of real blocks."""
    import jax.numpy as jnp

    from zlibes_tpu.codec.deflate_pipeline import (_encode_tables,
                                                   package_merge_np)
    from zlibes_tpu.config import CodecConfig
    from zlibes_tpu.ops.deflate_kernel import (pack_payload_turbo_dense,
                                               token_symbols)
    from zlibes_tpu.ops.lz77 import find_matches, select_tokens
    from zlibes_tpu.spec import constants as C

    cfg = CodecConfig.turbo()
    N = cfg.block_size
    Bp = min(cfg.blocks_per_dispatch, len(data) // N)
    nseg = N // cfg.seg_size
    blk = np.zeros((Bp, N + 8), np.uint8)
    blk[:, :N] = np.frombuffer(data[: Bp * N], np.uint8).reshape(Bp, N)
    blk, nv = jnp.asarray(blk), jnp.full(Bp, N, jnp.int32)
    m = find_matches(blk, nv, N=N, S=cfg.probe_words, J=cfg.candidates,
                     reset=cfg.chunk_reset, two_phase=True)
    sel = lambda: select_tokens(blk, m, nv, N=N, SEG_SIZE=cfg.seg_size,
                                lazy=True, split_far=True)
    s.timed(f"turbo select stage xla ({Bp} x {N} B)", sel)
    tv, td, cnt = sel()
    _ls, _ds, valid, llf, dfq = token_symbols(tv, td, cnt, nseg=nseg)
    llt = np.asarray(llf).astype(np.int64).sum(0)
    llt[C.END_OF_BLOCK] += Bp
    ll_len = package_merge_np(llt, 9)
    d_len = package_merge_np(np.asarray(dfq).astype(np.int64).sum(0), 9)
    ll_code, d_code = _encode_tables(ll_len, d_len)
    tabs = [jnp.asarray(np.broadcast_to(x, (Bp, x.size)))
            for x in (ll_code, ll_len.astype(np.int32), d_code,
                      d_len.astype(np.int32))]
    hdr = jnp.full(Bp, 100, jnp.int32)
    s.timed(f"turbo fields+pack stage xla ({Bp} x {N} B)",
            lambda: pack_payload_turbo_dense(
                tv, td, valid, *tabs, hdr, jnp.ones(Bp, bool),
                jnp.int32(int(ll_len[C.END_OF_BLOCK])), nseg=nseg,
                R=cfg.pack_row_width()))


def one_chip(s: Smoke, size: int, seed: int) -> None:
    import jax

    import zlibes_tpu
    from zlibes_tpu.config import CodecConfig

    with s.phase(f"make data ({size} B, seed {seed})"):
        data = make_data(size, seed)

    with s.phase("deflate (default level)"):
        comp = zlibes_tpu.deflate(data)
    check(zlib.decompress(comp) == data, "deflate -> zlib.decompress == data")
    log(f"deflate ratio {len(comp) / len(data):.4f} ({len(comp)} B)")

    with s.phase("deflate_indexed"):
        comp_i, index = zlibes_tpu.deflate_indexed(data)
    check(index.wide and comp_i == comp,
          "deflate_indexed: wide index, same stream as deflate")
    kernel_phase(s, "wide", data, comp_i, index)

    with s.phase("inflate_to_device"):
        spans = zlibes_tpu.inflate_to_device(comp_i, index)
        jax.block_until_ready([a for a, _b, _n in spans])
    out = np.zeros(len(data), np.uint8)
    for arr, base, nbytes in spans:
        out[base : base + nbytes] = np.asarray(arr[:nbytes])
    check(out.tobytes() == data, "inflate_to_device spans == data")

    rng = np.random.default_rng(seed + 1)
    with s.phase("inflate_range seeks"):
        for _ in range(4):
            a = int(rng.integers(0, len(data) - 1))
            n = int(rng.integers(1, min(1 << 20, len(data) - a) + 1))
            check(zlibes_tpu.inflate_range(comp_i, index, a, n)
                  == data[a : a + n], f"inflate_range({a}, {n})")

    with s.phase("deflate_indexed (turbo)"):
        comp_t, index_t = zlibes_tpu.deflate_indexed(
            data, config=CodecConfig.turbo())
    check(index_t.turbo and zlib.decompress(comp_t) == data,
          "turbo deflate -> zlib.decompress == data, turbo index")
    log(f"turbo ratio {len(comp_t) / len(data):.4f} ({len(comp_t)} B)")
    kernel_phase(s, "turbo", data, comp_t, index_t)
    encode_stage_phase(s, data)

    with s.phase("zlib.compress level 6 (host, set-up)"):
        foreign = zlib.compress(data, 6)
    with s.phase("inflate (foreign level-6 stream, native scan)"):
        check(zlibes_tpu.inflate(foreign) == data,
              "inflate(zlib.compress(data, 6)) == data")


def mesh_size(want: int, limit: int, probe: int = 8 << 20) -> int:
    """The largest of want, want/2, ... at which the mesh phase's 1-device
    comparison fits in `limit` device bytes.  Its largest programs are the
    general profile's two deflate steps (the matcher sorts every input
    position at once; the packer's one-hot lookups): their
    memory_analysis at `probe` bytes, which grows in proportion to the
    blocks, is scaled to each size.  Prints the readings and any cut."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from zlibes_tpu.parallel import make_mesh
    from zlibes_tpu.parallel.block_parallel import (sharded_histogram_step,
                                                    sharded_pack_step)

    mesh1, N, seg = make_mesh(1), 32768, 1024
    row = NamedSharding(mesh1, P("blocks"))
    nb = probe // N
    sds = lambda shape, dt=jnp.int32, sh=None: jax.ShapeDtypeStruct(
        shape, dt, sharding=sh)
    hist = sharded_histogram_step.lower(
        sds((nb, N + 8), jnp.uint8, row), sds((nb,), sh=row),
        jnp.int32(probe), jnp.int32(nb), mesh=mesh1, N=N, SEG_SIZE=seg,
    ).compile()
    pack = sharded_pack_step.lower(
        *hist.out_info[:3], sds((288,), jnp.uint32), sds((288,)),
        sds((32,), jnp.uint32), sds((32,)), sds((nb,), sh=row), mesh=mesh1,
        N=N, SEG_SIZE=seg, W=(15 * N + 4096) // 32,
    ).compile()
    total = lambda m: (m.argument_size_in_bytes + m.output_size_in_bytes
                       + m.temp_size_in_bytes)
    h, p = hist.memory_analysis(), pack.memory_analysis()
    # the pack step runs while the staged input blocks are still held
    peak = max(total(h), total(p) + h.argument_size_in_bytes)
    log(f"1-device general deflate at {probe >> 20} MiB (memory_analysis):"
        f" histogram step {total(h)} B (temp {h.temp_size_in_bytes}), pack "
        f"step {total(p)} B (temp {p.temp_size_in_bytes}); peak {peak} B")
    size = want
    while size > probe and peak * (size // probe) > limit:
        log(f"1-device comparison at {size >> 20} MiB: about "
            f"{peak * (size // probe)} B, over the {limit} B device limit")
        size //= 2
    log(f"1-device comparison at {size >> 20} MiB: about "
        f"{peak * max(1, size // probe)} B of the {limit} B device limit")
    if size < want:
        log(f"cut: the mesh phase runs at {size >> 20} MiB, not "
            f"{want >> 20} MiB: its 1-device comparison does not fit one "
            "device at the larger size (readings above)")
    return size


def four_chips(s: Smoke, size: int, seed: int) -> None:
    """Mesh-sharded codec on four devices vs the same call on one device
    and vs zlib."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from zlibes_tpu.codec import deflate_pipeline as dp
    from zlibes_tpu.codec.lanes import LanePlan
    from zlibes_tpu.parallel import make_mesh, parallel_deflate
    from zlibes_tpu.parallel.block_parallel import (
        _put, parallel_inflate, sharded_histogram_step,
        sharded_lane_inflate_step)
    from zlibes_tpu.spec.refmodel import StreamIndex

    mesh4, mesh1 = make_mesh(4), make_mesh(1)
    with s.phase(f"make data ({size} B, seed {seed})"):
        data = make_data(size, seed)

    for turbo in (False, True):
        name = f"parallel_deflate ({'turbo' if turbo else 'general'})"
        with s.phase(f"{name} on 4 devices"):
            comp, index = parallel_deflate(data, mesh4, turbo=turbo,
                                           with_index=True)
        with s.phase(f"{name} on 1 device"):
            comp1 = parallel_deflate(data, mesh1, turbo=turbo)
        check(comp == comp1, f"{name}: 4-device stream == 1-device stream")
        check(zlib.decompress(comp) == data, f"{name} -> zlib == data")
    comp_t, index_t = comp, index

    # the Adler-32 / histogram psum of the sharded step is a cross-device
    # all-reduce (XLA:GPU runs it through NCCL)
    N = 32768
    DBd = -(-(-(-size // N)) // 4) * 4
    row = NamedSharding(mesh4, P("blocks"))
    hlo = sharded_histogram_step.lower(
        jax.ShapeDtypeStruct((DBd, N + 8), jnp.uint8, sharding=row),
        jax.ShapeDtypeStruct((DBd,), jnp.int32, sharding=row),
        jnp.int32(size), jnp.int32(0), mesh=mesh4, N=N, SEG_SIZE=1024,
    ).compile().as_text()
    ops = re.findall(r"\s(all-reduce[\w-]*)\(", hlo)
    log(f"all-reduce ops in the compiled sharded deflate step: "
        f"{sorted(set(ops))} x {len(ops)}")
    check(len(ops) > 0, "sharded deflate step all-reduces across the "
          "4-GPU mesh")

    with s.phase("deflate_indexed on 1 device (set-up)"):
        comp_w, index_w = dp.deflate(data, with_index=True)
    for name, comp, index in (("turbo lanes", comp_t, index_t),
                              ("wide lanes", comp_w, index_w)):
        with s.phase(f"parallel_inflate ({name}) on 4 devices"):
            out4 = parallel_inflate(comp, index, mesh4)
        with s.phase(f"parallel_inflate ({name}) on 1 device"):
            out1 = parallel_inflate(comp, index, mesh1)
        check(out4 == out1 == data,
              f"parallel_inflate ({name}): 4 devices == 1 device == data")

    plan = LanePlan.build(comp_w, index_w, row_align=4)
    col = NamedSharding(mesh4, P(None, "blocks"))
    rows, _flags = sharded_lane_inflate_step(
        plan.words, _put(np.asarray(plan.lanes), col), plan.tables,
        _put(np.asarray(plan.lane_out), row),
        _put(np.asarray(plan.lane_out_end), row),
        _put(np.asarray(plan.row_len), row), mesh=mesh4, T=plan.T, O=plan.O)
    log(f"sharded lane inflate rows: {rows.sharding.device_set}")
    check(len(rows.sharding.device_set) == 4, "output rows on 4 devices")

    # the general XLA path resolves at most 8 MiB per device; it takes
    # every anchor as a lane, so repeated (empty-lane) anchors go
    small = data[: 8 << 20]
    if len(small) < len(data):
        log("cut: the general XLA mesh inflate runs on the first 8 MiB "
            "(its resolve covers at most 8 MiB per device)")
    comp_s, idx = dp.deflate(small, with_index=True)
    keep = np.ones(idx.anchor_bit.size, bool)
    keep[1:] = ((np.diff(idx.anchor_bit) != 0)
                | (np.diff(idx.anchor_block) != 0))
    index_s = StreamIndex(idx.blocks, idx.anchor_bit[keep],
                          idx.anchor_out[keep], idx.anchor_block[keep])
    with s.phase("parallel_inflate (general XLA path, 8 MiB) on 4 devices"):
        out4 = parallel_inflate(comp_s, index_s, mesh4)
    with s.phase("parallel_inflate (general XLA path, 8 MiB) on 1 device"):
        out1 = parallel_inflate(comp_s, index_s, mesh1)
    check(out4 == out1 == small,
          "parallel_inflate (general): 4 devices == 1 device == data")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    ap.add_argument("--size-mib", type=int, default=256,
                    help="data size; the mesh phase halves it until its "
                    "1-device comparison fits one device")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    size = args.size_mib << 20

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < args.chips:
        print(f"chip_smoke: needs {args.chips} GPU(s); JAX found "
              f"{[d.platform for d in devs]}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from zlibes_tpu.runtime import native
    from zlibes_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    card = card_line()
    log(f"device: {devs[0].device_kind} x {len(devs)}, jax {jax.__version__}")
    log(f"card (name, power limit): {card}")
    if args.chips == 1:
        check(native.available(), "native library built (native.available())")
    s = Smoke(card.splitlines()[0])
    if args.chips == 1:
        if size < 256 << 20:
            log(f"cut: {size >> 20} MiB instead of 256 MiB (--size-mib)")
        one_chip(s, size, args.seed)
    else:
        with s.phase("mesh size (1-device memory_analysis)"):
            size = mesh_size(size, devs[0].memory_stats()["bytes_limit"])
        four_chips(s, size, args.seed)
    log(f"card (name, power limit): {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
