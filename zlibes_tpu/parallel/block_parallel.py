"""Multi-chip block-parallel codec over a jax.sharding.Mesh.

New capability mandated by the north star (the reference is single-threaded
JS with zero parallelism — SURVEY.md §2 "Parallelism strategies").  DEFLATE
blocks are the unit of data parallelism: they are independently codable
(our encoder emits self-contained, byte-aligned blocks), so both directions
shard block batches across chips with XLA collectives:

  * deflate: every device match-finds, tokenizes and bit-packs its shard of
    blocks (fixed-Huffman — no host round-trip, the whole step is one jit);
    Adler-32 partials combine across the mesh with a real ``psum`` (the
    checksum is associative under per-shard (sum, weighted-sum) terms).
  * inflate: anchor lanes shard across devices; each device decodes and
    LZ-resolves its contiguous span of blocks.

The mesh is one flat ``("blocks",)`` axis; XLA lowers the collectives
to the backend's own (NCCL between GPUs).  Multi-process meshes work once
``jax.distributed`` is initialized — same code path, bigger mesh.
Validated on a virtual CPU mesh (tests/conftest.py) and via
``__graft_entry__.dryrun_multichip``.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.adler32 import _M, _modsum, _mulmod
from ..ops.deflate_kernel import (pack_payload, pack_payload_turbo,
                                  token_symbols)
from ..ops.inflate_kernel import decode_tokens, resolve_global
from ..ops.lz77 import find_matches, select_tokens
from ..spec import constants as C
import time as _time

# per-call phase timings for the scaling report (tools/bench_scaling.py):
# callers clear LAST_TIMINGS, run one codec call, then read
# {host_stage, dispatch, host_splice} seconds + dispatch count — the
# virtual CPU mesh cannot show compute speedup, but per-device HOST
# overhead growth is measurable and reported
LAST_TIMINGS: dict = {}


class _phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = _time.perf_counter()
        return self

    def __exit__(self, *exc):
        LAST_TIMINGS[self.name] = (LAST_TIMINGS.get(self.name, 0.0)
                                   + _time.perf_counter() - self.t0)
        if self.name == "dispatch":
            LAST_TIMINGS["dispatches"] = LAST_TIMINGS.get("dispatches", 0) + 1
        return False



def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("blocks",))


def _fixed_tables(Bd: int):
    """Per-block fixed-Huffman encode tables (device constants)."""
    from ..codec.deflate_pipeline import _encode_tables, _FIXED_LL_LEN, _FIXED_D_LEN

    ll_code, d_code = _encode_tables(_FIXED_LL_LEN, _FIXED_D_LEN)
    return (
        jnp.tile(jnp.asarray(ll_code)[None, :], (Bd, 1)),
        jnp.tile(jnp.asarray(_FIXED_LL_LEN)[None, :], (Bd, 1)),
        jnp.tile(jnp.asarray(d_code)[None, :], (Bd, 1)),
        jnp.tile(jnp.asarray(_FIXED_D_LEN)[None, :], (Bd, 1)),
    )


def _adler_shard_terms(blocks, n_valid, global_off):
    """Per-shard Adler-32 partial terms (combined across the mesh by psum).

    For a shard holding bytes d_j at global offsets o+j:
      A = Σ d_j (mod m),  T = Σ (n_total - o - j)·d_j expressed as
      (n - o)·A - Σ j·d_j so each shard only needs its offset and n.
    """
    Bd, Npad = blocks.shape
    N = Npad - 8
    d = blocks[:, :N].astype(jnp.int32)
    pos = jax.lax.broadcasted_iota(jnp.int32, (Bd, N), 1)
    mask = pos < n_valid[:, None]
    d = jnp.where(mask, d, 0)
    # per-block partials, then fold into shard partials (int32-safe)
    chunk = min(2048, N)
    dd = d.reshape(Bd, N // chunk, chunk)
    jj = jax.lax.broadcasted_iota(jnp.int32, dd.shape, 2)
    a_c = jnp.sum(dd, axis=2) % _M
    b_c = jnp.sum(dd * jj, axis=2) % _M
    # global offset of chunk (b, c): global_off[b] + c*chunk
    offs = global_off[:, None] + jnp.arange(N // chunk, dtype=jnp.int32)[None, :] * chunk
    return a_c.reshape(-1), b_c.reshape(-1), offs.reshape(-1)


@partial(jax.jit, static_argnames=("mesh", "N", "SEG_SIZE", "W", "S", "J"))
def sharded_deflate_step(
    blocks: jax.Array,   # uint8 (D*Bd, N+8) sharded over "blocks"
    n_valid: jax.Array,  # int32 (D*Bd,)
    n_total: jax.Array,  # int32 scalar (replicated): total input bytes
    mesh: Mesh,
    N: int,
    SEG_SIZE: int,
    W: int,
    S: int = 16,
    J: int = 16,
):
    """One fully-jitted block-parallel deflate step (fixed-Huffman blocks).

    Returns (words (D*Bd, W) uint32 sharded, payload_end (D*Bd,),
    lane_bit0 (D*Bd*nseg,), adler32 (uint32, replicated via psum)).
    """
    DBd = blocks.shape[0]
    D = mesh.devices.size
    Bd = DBd // D
    nseg = N // SEG_SIZE

    def body(blocks, n_valid):
        shard = jax.lax.axis_index("blocks")
        matches = find_matches(blocks, n_valid, N=N, S=S, J=J)
        tv, td, cnt = select_tokens(blocks, matches, n_valid, N=N,
                                    SEG_SIZE=SEG_SIZE)
        lsym, dsym, valid, _llf, _dfq = token_symbols(tv, td, cnt, nseg=nseg)
        ll_code, ll_len, d_code, d_len = _fixed_tables(Bd)
        hdr = jnp.full(Bd, 3, jnp.int32)  # BFINAL/BTYPE only
        en = jnp.ones(Bd, bool)
        words, payload_end, lane_bit0 = pack_payload(
            tv, td, lsym, dsym, valid, ll_code, ll_len, d_code, d_len,
            hdr, en, nseg=nseg, W=W,
        )
        # Adler-32 via psum combine
        g_off = (shard * Bd + jnp.arange(Bd, dtype=jnp.int32)) * N
        a_c, b_c, offs = _adler_shard_terms(blocks, n_valid, g_off)
        w = jnp.where(a_c > 0, (n_total - offs) % _M, 0)
        terms = (_mulmod(w, a_c) - b_c) % _M
        s1p = _modsum(a_c)
        s2p = _modsum(terms)
        s1 = (1 + jax.lax.psum(s1p, "blocks")) % _M
        s2 = (n_total % _M + jax.lax.psum(s2p, "blocks")) % _M
        adler = (s2.astype(jnp.uint32) << 16) | s1.astype(jnp.uint32)
        return words, payload_end, lane_bit0, adler

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("blocks"), P("blocks")),
        out_specs=(P("blocks"), P("blocks"), P("blocks"), P()),
        check_vma=False,
    )(blocks, n_valid)


@partial(jax.jit, static_argnames=("mesh", "N", "SEG_SIZE", "S", "J",
                                   "max_code_bits", "reset", "turbo"))
def sharded_histogram_step(
    blocks: jax.Array,   # uint8 (D*Bd, N+8) sharded over "blocks"
    n_valid: jax.Array,  # int32 (D*Bd,)
    n_total: jax.Array,  # int32 scalar: total input bytes
    eob_add: jax.Array,  # int32 scalar: EOB count to add (= nblocks)
    mesh: Mesh,
    N: int, SEG_SIZE: int, S: int = 16, J: int = 16,
    max_code_bits: int = 15,
    reset: int = 0,      # LZ window reset span (turbo: 4096)
    turbo: bool = False,  # two-phase matcher + split far matches
):
    """Phase 1 of dynamic-table sharded deflate: match-find + tokenize on
    every device, a real psum combines the global symbol histograms (and
    the Adler-32 partials) across the mesh, then the LENGTH-LIMITED CODE
    LENGTHS are built on device in the same dispatch (ops/entropy.py
    package-merge — north star C7; reference analog
    /root/reference/src/huffman.ts:55-153).  No host round-trip sits
    between the histogram and the code lengths.

    Returns (tv, td, cnt — sharded token streams kept on device for
    phase 2; ll_len (288,), d_len (32,), adler — replicated).
    """
    from ..ops.entropy import limited_lengths_pair

    DBd = blocks.shape[0]
    D = mesh.devices.size
    Bd = DBd // D
    nseg = N // SEG_SIZE

    def body(blocks, n_valid):
        shard = jax.lax.axis_index("blocks")
        matches = find_matches(blocks, n_valid, N=N, S=S, J=J,
                               reset=reset, two_phase=turbo)
        tv, td, cnt = select_tokens(blocks, matches, n_valid, N=N,
                                    SEG_SIZE=SEG_SIZE, split_far=turbo)
        _ls, _ds, _v, llf, dfq = token_symbols(tv, td, cnt, nseg=nseg)
        ll_tot = jax.lax.psum(jnp.sum(llf, axis=0), "blocks")
        d_tot = jax.lax.psum(jnp.sum(dfq, axis=0), "blocks")
        ll_tot = ll_tot.at[C.END_OF_BLOCK].add(eob_add)
        ll_len, d_len = limited_lengths_pair(ll_tot, d_tot, max_code_bits)
        g_off = (shard * Bd + jnp.arange(Bd, dtype=jnp.int32)) * N
        a_c, b_c, offs = _adler_shard_terms(blocks, n_valid, g_off)
        w = jnp.where(a_c > 0, (n_total - offs) % _M, 0)
        terms = (_mulmod(w, a_c) - b_c) % _M
        s1 = (1 + jax.lax.psum(_modsum(a_c), "blocks")) % _M
        s2 = (n_total % _M + jax.lax.psum(_modsum(terms), "blocks")) % _M
        adler = (s2.astype(jnp.uint32) << 16) | s1.astype(jnp.uint32)
        return tv, td, cnt, ll_len, d_len, adler

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("blocks"), P("blocks")),
        out_specs=(P("blocks"), P("blocks"), P("blocks"), P(), P(), P()),
        check_vma=False,
    )(blocks, n_valid)


@partial(jax.jit, static_argnames=("mesh", "N", "SEG_SIZE", "W", "R"))
def sharded_pack_step(
    tv: jax.Array, td: jax.Array, cnt: jax.Array,  # sharded token streams
    ll_code: jax.Array, ll_len: jax.Array,          # replicated shared tables
    d_code: jax.Array, d_len: jax.Array,
    hdr_bits: jax.Array,  # int32 (D*Bd,) per-block header bit length
    mesh: Mesh, N: int, SEG_SIZE: int, W: int,
    R: int = 0,  # >0: scatter-free turbo pack with this row width
):
    """Phase 2: bit-pack every device's token shard with the shared codes.

    ``R > 0`` routes through ``pack_payload_turbo`` (shared-table fields
    + sort-placement packer; requires <=32-bit tokens, i.e. a 9-bit-capped
    shared table and split far matches)."""
    DBd = cnt.shape[0] // (N // SEG_SIZE)
    D = mesh.devices.size
    Bd = DBd // D
    nseg = N // SEG_SIZE

    def body(tv, td, cnt, hdrb):
        lsym, dsym, valid, _llf, _dfq = token_symbols(tv, td, cnt, nseg=nseg)
        llc = jnp.broadcast_to(ll_code, (Bd, ll_code.size))
        lll = jnp.broadcast_to(ll_len, (Bd, ll_len.size))
        dc = jnp.broadcast_to(d_code, (Bd, d_code.size))
        dl = jnp.broadcast_to(d_len, (Bd, d_len.size))
        en = jnp.ones(Bd, bool)
        if R:
            return pack_payload_turbo(tv, td, valid, llc, lll,
                                      dc, dl, hdrb, en, nseg=nseg, W=W, R=R)
        w, pe, lb = pack_payload(tv, td, lsym, dsym, valid, llc, lll, dc, dl,
                                 hdrb, en, nseg=nseg, W=W)
        big = jnp.full(lb.shape, 1 << 30, jnp.int32)  # no split anchors
        return w, pe, lb, big, big

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("blocks"), P("blocks"), P("blocks"), P("blocks")),
        out_specs=(P("blocks"), P("blocks"), P("blocks"), P("blocks"),
                   P("blocks")),
        check_vma=False,
    )(tv, td, cnt, hdr_bits)


@partial(jax.jit, static_argnames=("mesh", "T", "M", "D_BITS", "O"))
def sharded_inflate_step(
    w32: jax.Array,        # uint32 (Nb,) replicated stream windows
    bytes_u8: jax.Array,   # uint8 (Nb+8,) replicated
    litlen_tab: jax.Array, # int32 (D*NBd, 2^M) sharded table rows
    dist_tab: jax.Array,   # int32 (D*NBd, 2^D_BITS)
    table_row: jax.Array,  # int32 (D*Ld,) sharded lane → local table row
    bit0: jax.Array,       # int32 (D*Ld,)
    end_bit: jax.Array,    # int32 (D*Ld,)
    active: jax.Array,     # bool (D*Ld,)
    out_base: jax.Array,   # int32 (D*Ld,) lane offset within device span
    span: jax.Array,       # int32 (D,) output bytes per device
    mesh: Mesh,
    T: int, M: int, D_BITS: int, O: int,
):
    """Block-parallel inflate: each device decodes + resolves its span.

    Returns (out (D, O) uint8 sharded, err (D,) bool sharded).
    """
    def body(ll_tab, d_tab, rows, bit0, endb, act, ob, span):
        tv, td, cnt, _pos, still, err = decode_tokens(
            w32, bytes_u8, ll_tab, d_tab, rows, bit0, endb, act,
            T=T, M=M, D=D_BITS,
        )
        out, rerr = resolve_global(
            tv, td, cnt, ob, span[0], jnp.zeros(0, jnp.uint8), O=O,
        )
        bad = jnp.any(err) | jnp.any(still) | rerr
        return out[None, :], bad[None]

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("blocks"), P("blocks"), P("blocks"), P("blocks"),
                  P("blocks"), P("blocks"), P("blocks"), P("blocks")),
        out_specs=(P("blocks"), P("blocks")),
        check_vma=False,
    )(litlen_tab, dist_tab, table_row, bit0, end_bit, active, out_base, span)


@partial(jax.jit, static_argnames=("mesh", "T", "O"))
def sharded_lane_inflate_step(
    words: jax.Array,         # (NW,) uint32 replicated stream words
    lanes: jax.Array,         # (4, L) int32 lane arrays, cols sharded
    tables: jax.Array,        # (NT, TAB_W) int32 replicated decode tables
    lane_out: jax.Array,      # (L,) int32 flat output offsets, sharded
    lane_out_end: jax.Array,  # (L,) int32 expected lane output ends
    row_len: jax.Array,       # (R,) int32 valid bytes per row, sharded
    mesh: Mesh, T: int, O: int,
):
    """Mesh-sharded anchor-lane inflate (turbo and default profiles): every
    device decodes and resolves its contiguous span of whole block rows.
    Blocks are self-contained, so the only cross-device traffic is the
    input broadcast.

    Requires the row count to be a multiple of the device count (whole
    rows per device; LanePlan.build(row_align=D)).  Returns (rows (R*O,)
    uint8 sharded over rows, errors (D, 4) bool per-device integrity
    flags — see codec.lanes.raise_lane_errors)."""
    from ..codec.lanes import _lane_errors
    from ..ops import lane_decode as ld

    def body(lanes, lane_out, lane_out_end, row_len):
        # lane output offsets are global; each device resolves its rows
        base = jax.lax.axis_index("blocks") * (row_len.shape[0] * O)
        tokens, meta = ld.decode_lanes(words, lanes, tables, T=T)
        out, lane_bytes, rerr = ld.resolve_lanes(
            tokens, meta[0], lane_out - base, row_len, O=O)
        flags = _lane_errors(meta, lanes, lane_out - base,
                             lane_out_end - base, lane_bytes, rerr)
        return out, flags[None]

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, "blocks"), P("blocks"), P("blocks"), P("blocks")),
        out_specs=(P("blocks"), P("blocks")),
        check_vma=False,
    )(lanes, lane_out, lane_out_end, row_len)


def parallel_inflate_lanes(data: bytes, index, mesh: Mesh,
                           check: bool = True) -> bytes:
    """Mesh-sharded anchor-lane inflate (whole block rows split across
    devices) of a turbo- or default-profile indexed stream."""
    from ..codec.lanes import LanePlan, assemble, raise_lane_errors

    D = mesh.devices.size
    with _phase("host_stage"):
        plan = LanePlan.build(bytes(data), index, row_align=D)
        if not plan.R:
            raise ValueError("all-stored stream has no device work")
        sh = NamedSharding(mesh, P("blocks"))
        args = (
            plan.words,
            _put(np.asarray(plan.lanes), NamedSharding(mesh, P(None,
                                                               "blocks"))),
            plan.tables,
            _put(np.asarray(plan.lane_out), sh),
            _put(np.asarray(plan.lane_out_end), sh),
            _put(np.asarray(plan.row_len), sh),
        )
    with _phase("dispatch"):
        rows, flags = sharded_lane_inflate_step(*args, mesh=mesh, T=plan.T,
                                                O=plan.O)
    with _phase("readback"):
        if check:
            raise_lane_errors(_to_host(flags))
        rows_np = _to_host(rows).reshape(plan.R, plan.O)
    return assemble(plan, bytes(data), rows_np).tobytes()


def _put(arr: np.ndarray, sharding) -> jax.Array:
    """Create a (possibly multi-process) global array from host data.

    Every process passes the same logical array; each contributes only its
    addressable shards — works identically for a single-process mesh."""
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def _to_host(arr: jax.Array) -> np.ndarray:
    """Fetch a (possibly multi-process) global array to every host."""
    if jax.process_count() == 1:
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def parallel_deflate(data: bytes | None, mesh: Mesh, block_size: int = 32768,
                     seg_size: int = 1024, dynamic: bool = True,
                     max_code_bits: int = 15, turbo: bool = False,
                     with_index: bool = False,
                     n_bytes: int | None = None,
                     block_provider=None):
    """Block-parallel deflate across the mesh → zlib stream.

    ``dynamic=True`` (default): two sharded phases — a psum-combined
    global histogram with on-device package-merge, then a shared
    length-limited table pair packs every device's token shard.
    ``dynamic=False`` keeps the single-phase fixed-Huffman step.
    ``turbo=True`` runs the turbo profile under the mesh: two-phase
    matcher + lazy selection with split far matches + scatter-free pack,
    emitting lane-decodable structure (512 B anchors, 4 KiB resets, 9-bit
    shared tables); ``with_index=True`` additionally returns the
    StreamIndex that feeds ``parallel_inflate``.

    **Per-host input feeding** (multi-process runs): pass ``data=None``
    with ``n_bytes`` (total logical input size) and ``block_provider``
    — a callable ``(block_idx) -> bytes`` invoked ONLY for the block
    rows addressable by this process (jax.make_array_from_callback asks
    each process for its own shards), so no host ever materializes more
    than ~1/num_processes of the input.  ``multihost.host_shard`` gives
    the row range a provider must be able to serve.
    """
    from ..spec.refmodel import BlockInfo, StreamIndex

    if turbo:
        seg_size, max_code_bits, dynamic = 512, 9, True
        if block_size % 4096:
            raise ValueError("turbo needs a 4 KiB-aligned block size")
    reset = 4096 if turbo else 0
    D = mesh.devices.size
    N = block_size
    if data is not None:
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        n = arr.size

        def block_provider(i, _arr=arr, _N=N):  # noqa: A001 — default feed
            return _arr[i * _N : (i + 1) * _N]
    else:
        if n_bytes is None or block_provider is None:
            raise ValueError("data=None requires n_bytes and block_provider")
        n = n_bytes
    if n == 0:
        out = (C.ZLIB_HEADER + b"\x01\x00\x00\xff\xff"
               + (1).to_bytes(4, "big"))
        if with_index:
            blocks = [BlockInfo(C.BTYPE_STORED, True, 0, 8, 40, 0, 0)]
            return out, StreamIndex(blocks, np.zeros(0, np.int64),
                                    np.zeros(0, np.int64),
                                    np.zeros(0, np.int32)).shifted(16)
        return out
    nblocks = -(-n // N)
    Bd = -(-nblocks // D)
    DBd = D * Bd
    # block staging is callback-driven: each process materializes ONLY the
    # rows jax asks it for (its addressable shards) — per-host memory is
    # O(input / num_processes), and single-process runs skip the dense
    # (DBd, N+8) intermediate copy entirely
    n_valid = np.clip(n - np.arange(DBd, dtype=np.int64) * N, 0, N
                      ).astype(np.int32)

    def _blocks_cb(idx):
        rows = range(*idx[0].indices(DBd))
        out = np.zeros((len(rows), N + 8), np.uint8)
        for k, i in enumerate(rows):
            if i < nblocks:
                chunk = np.frombuffer(bytes(block_provider(i)), np.uint8)
                out[k, : chunk.size] = chunk
        return out

    W = (15 * N + 4096) // 32
    nseg = N // seg_size
    sharding = NamedSharding(mesh, P("blocks"))
    with _phase("host_stage"):
        blocks_gl = jax.make_array_from_callback((DBd, N + 8), sharding,
                                                 _blocks_cb)
    from ..codec.deflate_pipeline import (
        _FIXED_D_LEN, _FIXED_LL_LEN, _dynamic_header, _encode_tables,
        _or_bits)

    max_tokens = 0
    if dynamic:
        with _phase("dispatch"):
            tv, td, cnt, ll_len_d, d_len_d, adler = sharded_histogram_step(
                blocks_gl, _put(n_valid, sharding), jnp.int32(n),
                jnp.int32(nblocks), mesh=mesh, N=N, SEG_SIZE=seg_size,
                max_code_bits=max_code_bits, reset=reset, turbo=turbo,
            )
        # code lengths were built on device (package-merge inside the
        # histogram dispatch); only the ~50-byte header serialization and
        # the canonical code assignment stay host-side
        ll_len = np.asarray(ll_len_d).astype(np.int64)
        d_len = np.asarray(d_len_d).astype(np.int64)
        hdr0, hb0 = _dynamic_header(ll_len, d_len, 0)
        hdr1, hb1 = _dynamic_header(ll_len, d_len, 1)
        ll_code, d_code = _encode_tables(ll_len, d_len)
        hdr_bits = np.full(DBd, hb0, np.int32)
        hdr_bits[nblocks - 1] = hb1
        from ..config import CodecConfig

        R = CodecConfig.turbo().pack_row_width(seg_size) if turbo else 0
        with _phase("dispatch"):
            words, payload_end, lane_bit0, split_bit, split_out = \
                sharded_pack_step(
                    tv, td, cnt,
                    jnp.asarray(ll_code),
                    jnp.asarray(ll_len.astype(np.int32)),
                    jnp.asarray(d_code), jnp.asarray(d_len.astype(np.int32)),
                    _put(hdr_bits, sharding), mesh=mesh, N=N,
                    SEG_SIZE=seg_size, W=W, R=R,
                )
        headers = {0: (hdr0, hb0), 1: (hdr1, hb1)}
        if with_index:
            max_tokens = int(_to_host(cnt).max(initial=0))
            if turbo:
                split_bit_np = _to_host(split_bit)
                split_out_np = _to_host(split_out)
    else:
        words, payload_end, lane_bit0, adler = sharded_deflate_step(
            blocks_gl, _put(n_valid, sharding),
            jnp.int32(n), mesh=mesh, N=N, SEG_SIZE=seg_size, W=W,
        )
        ll_code, _ = _encode_tables(_FIXED_LL_LEN, _FIXED_D_LEN)
        ll_len = _FIXED_LL_LEN
    with _phase("readback"):
        words_np = _to_host(words)
        pe = _to_host(payload_end)
        lane_bit0_np = _to_host(lane_bit0)
    if not (turbo and with_index):
        split_bit_np = split_out_np = None

    eob_code = int(ll_code[C.END_OF_BLOCK])
    eob_len = int(ll_len[C.END_OF_BLOCK])
    _splice_t = _phase("host_splice")
    _splice_t.__enter__()
    parts = []
    binfos: list = []
    anchor_bit: list = []
    anchor_out: list = []
    anchor_block: list = []
    stream_bit = 0
    for i in range(nblocks):
        bfinal = 1 if i == nblocks - 1 else 0
        end_bits = int(pe[i])
        nbytes = (end_bits + eob_len + 3 + 7) // 8
        buf = words_np[i].view(np.uint8)[: nbytes + 4].copy()
        if dynamic:
            hdr, hb = headers[bfinal]
            hb_arr = np.frombuffer(hdr, dtype=np.uint8)
            buf[: hb_arr.size] |= hb_arr
        else:
            buf[0] |= bfinal | (C.BTYPE_FIXED << 1)
            hb = 3
        _or_bits(buf, end_bits, eob_code, eob_len)
        end_bits += eob_len
        start_bit = stream_bit
        nb = int(n_valid[i])
        binfos.append(BlockInfo(
            C.BTYPE_DYNAMIC if dynamic else C.BTYPE_FIXED, bool(bfinal),
            start_bit, start_bit + hb, start_bit + end_bits, i * N, nb))
        for s in range(-(-nb // seg_size)):
            lane = i * nseg + s
            lb = int(lane_bit0_np[lane])
            anchor_bit.append(start_bit + lb)
            anchor_out.append(i * N + s * seg_size)
            anchor_block.append(len(binfos) - 1)
            if split_bit_np is None:
                continue
            lane_end = (int(lane_bit0_np[lane + 1]) if s + 1 < nseg
                        else int(pe[i]))
            sb, so = int(split_bit_np[lane]), int(split_out_np[lane])
            if sb >= 1 << 30:
                sb, so = lane_end - lb, min(nb - s * seg_size, seg_size)
            anchor_bit.append(start_bit + lb + sb)
            anchor_out.append(i * N + s * seg_size + so)
            anchor_block.append(len(binfos) - 1)
        if bfinal:
            nby = (end_bits + 7) // 8
            parts.append(buf[:nby].tobytes())
            stream_bit += nby * 8
        else:
            sync_start = end_bits
            nby = (end_bits + 3 + 7) // 8
            part = buf[:nby].tobytes() + b"\x00\x00\xff\xff"
            parts.append(part)
            binfos.append(BlockInfo(
                C.BTYPE_STORED, False, start_bit + sync_start,
                start_bit + nby * 8, stream_bit + len(part) * 8,
                i * N + nb, 0))
            stream_bit += len(part) * 8
    body = b"".join(parts)
    _splice_t.__exit__()
    trailer = int(adler).to_bytes(4, "big")
    out = C.ZLIB_HEADER + body + trailer
    if with_index:
        index = StreamIndex(
            binfos,
            np.asarray(anchor_bit, np.int64),
            np.asarray(anchor_out, np.int64),
            np.asarray(anchor_block, np.int32),
            chunk_reset=reset,
            turbo=turbo,
            max_tokens=max_tokens,
        ).shifted(16)
        return out, index
    return out


def parallel_inflate(data: bytes, index, mesh: Mesh) -> bytes:
    """Block-parallel inflate of an indexed stream across the mesh.

    Turbo-profile streams (shared 9-bit tables, 512 B anchors, 4 KiB
    resets) and default-profile streams (per-block 15-bit tables, 128 B
    anchors) take the sharded anchor-lane pipeline; other indexed streams
    use the general XLA decode/resolve kernels."""
    if ((getattr(index, "turbo", False) or getattr(index, "wide", False))
            and getattr(index, "self_contained", True)
            and any(b.btype != C.BTYPE_STORED and b.out_len
                    for b in index.blocks)):
        return parallel_inflate_lanes(data, index, mesh)
    from ..codec.inflate_pipeline import (
        _Stream, _block_code_lengths, _bucket, _index_lanes,
    )
    from ..ops import huffman

    data = bytes(data)
    stream = _Stream(data)
    lane_bit0, lane_end, lane_out, lane_outlen, lane_block = _index_lanes(index)
    D = mesh.devices.size
    nlanes = lane_bit0.size

    # split whole blocks across devices, balanced by lane count
    ends = []  # lane index where each device's span ends
    target = -(-nlanes // D)
    i = 0
    for _d in range(D):
        j = min(nlanes, i + target)
        while j < nlanes and lane_block[j] == lane_block[j - 1]:
            j += 1
        ends.append(j)
        i = j
    starts = [0] + ends[:-1]

    Ld = max(1, max(e - s for s, e in zip(starts, ends)))
    Ld = _bucket(Ld, lo=8)
    NBd = _bucket(max(1, max((len(set(lane_block[s:e].tolist())) for s, e in
                              zip(starts, ends) if e > s), default=1)), lo=4)
    all_blocks = index.blocks
    M = D_BITS = 1
    ll_lens = np.zeros((D * NBd, C.NUM_LITLEN_SYMBOLS), np.int64)
    d_lens = np.zeros((D * NBd, C.NUM_DIST_SYMBOLS), np.int64)
    rows = np.zeros(D * Ld, np.int32)
    bit0 = np.zeros(D * Ld, np.int32)
    endb = np.zeros(D * Ld, np.int32)
    act = np.zeros(D * Ld, bool)
    ob = np.zeros(D * Ld, np.int32)
    span = np.zeros(D, np.int32)
    max_tok = 1
    for d, (s, e) in enumerate(zip(starts, ends)):
        if e <= s:
            continue
        bids = sorted(set(int(b) for b in lane_block[s:e]))
        row_of = {b: r for r, b in enumerate(bids)}
        for b, r in row_of.items():
            ll, dl = _block_code_lengths(data, all_blocks[b])
            ll_lens[d * NBd + r, : ll.size] = ll
            d_lens[d * NBd + r, : dl.size] = dl
        base = int(lane_out[s])
        span[d] = int(lane_out[e - 1] + lane_outlen[e - 1]) - base
        for k in range(e - s):
            rows[d * Ld + k] = row_of[int(lane_block[s + k])]
            bit0[d * Ld + k] = lane_bit0[s + k]
            endb[d * Ld + k] = lane_end[s + k]
            act[d * Ld + k] = True
            ob[d * Ld + k] = lane_out[s + k] - base
        max_tok = max(max_tok, int(lane_outlen[s:e].max()))
    # fixed table widths (the RFC cap) → one compiled program per (T, O)
    # bucket for all streams, like the single-device path
    M = D_BITS = C.MAX_CODELEN_BITS
    T = _bucket(max_tok + 16, lo=512)
    O = _bucket(int(span.max()), lo=4096)

    sh = NamedSharding(mesh, P("blocks"))
    ll_tab = huffman.build_litlen_tables(ll_lens, M)
    d_tab = huffman.build_dist_tables(d_lens, D_BITS)
    out, err = sharded_inflate_step(
        stream.w32, stream.bytes,
        _put(ll_tab, sh), _put(d_tab, sh),
        _put(rows, sh), _put(bit0, sh),
        _put(endb, sh), _put(act, sh),
        _put(ob, sh), _put(span, sh),
        mesh=mesh, T=T, M=M, D_BITS=D_BITS, O=O,
    )
    from ..spec.errors import CorruptError

    if _to_host(err).any():
        raise CorruptError("parallel inflate failed (corrupt or mis-indexed)")
    out_np = _to_host(out)
    total = index.total_out
    result = np.empty(total, np.uint8)
    for d, (s, e) in enumerate(zip(starts, ends)):
        if e <= s:
            continue
        base = int(lane_out[s])
        result[base : base + span[d]] = out_np[d, : span[d]]
    # stored blocks (byte-aligned) are host copies
    for b in all_blocks:
        if b.btype == C.BTYPE_STORED and b.out_len:
            pos = (b.payload_start_bit >> 3) + 4
            result[b.out_start : b.out_start + b.out_len] = np.frombuffer(
                data, np.uint8, count=b.out_len, offset=pos)
    return result.tobytes()
