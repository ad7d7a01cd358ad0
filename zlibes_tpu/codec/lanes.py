"""Anchor-lane inflate: the device decode path for indexed streams from
this encoder — the default profile (levels 1-9: per-block 15-bit tables,
one anchor per 128 B of output) and the turbo profile (one shared table
pair, an anchor pair per 512 B).

Every coded block is one output row; its anchors are its decode lanes
(ops/lane_decode.py).  The host parses block headers into decode tables
(one per distinct code pair) and turns anchors into per-lane word offsets;
the device decodes all lanes and resolves all rows in two stages.
Reference analog: src/inflate.ts:237-291.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import lane_decode as ld
from ..spec import constants as C
from ..spec.errors import CorruptError
from ..spec.refmodel import StreamIndex


def _anchors_per_block(out_len: np.ndarray, turbo: bool) -> np.ndarray:
    """Anchor count the encoder records for a coded block of out_len
    bytes: a (start, split) pair per turbo segment, else one per wide
    sub-span."""
    if turbo:
        return 2 * (-(-out_len // C.TURBO_SEG_SPAN))
    return -(-out_len // C.WIDE_ANCHOR_SPAN)


def _header_bits(data: bytes, b) -> int:
    """A coded block's header bits after BFINAL/BTYPE, as one integer
    (blocks with equal headers share their decode table)."""
    lo, hi = b.start_bit + 3, b.payload_start_bit
    if hi <= lo:
        return 0
    raw = int.from_bytes(data[lo >> 3 : (hi + 7) >> 3], "little")
    return (raw >> (lo & 7)) & ((1 << (hi - lo)) - 1)


def stream_words(data: bytes) -> jax.Array:
    """The stream as little-endian uint32 words, padded past its end so
    a lane's 64-bit window read never leaves the array."""
    raw = np.frombuffer(data, np.uint8)
    pad = (-raw.size) % 4 + 16
    return jnp.asarray(np.concatenate([raw, np.zeros(pad, np.uint8)])
                       .view("<u4"))


class LanePlan:
    """Host-prepared device arrays for one indexed stream."""

    __slots__ = ("words", "lanes", "tables", "lane_out", "lane_out_end",
                 "row_len", "T", "O", "R", "coded", "stored", "total_out",
                 "contiguous")

    @staticmethod
    def build(data: bytes, index: StreamIndex,
              row_align: int = 1) -> "LanePlan":
        """``row_align`` pads the row count to a multiple (a mesh-sharded
        run passes its device count so every device gets whole rows)."""
        from ..utils.cache import enable_persistent_cache
        from .inflate_pipeline import _block_code_lengths

        enable_persistent_cache()
        turbo = bool(getattr(index, "turbo", False))
        if not (turbo or getattr(index, "wide", False)):
            raise CorruptError("stream index carries no decode-lane anchors")
        if not getattr(index, "self_contained", True):
            raise CorruptError("lane decode requires self-contained blocks")
        p = LanePlan()
        blocks = index.blocks
        coded_ids = [i for i, b in enumerate(blocks) if b.out_len
                     and b.btype in (C.BTYPE_FIXED, C.BTYPE_DYNAMIC)]
        p.coded = [blocks[i] for i in coded_ids]
        p.stored = [b for b in blocks
                    if b.btype == C.BTYPE_STORED and b.out_len]
        p.total_out = index.total_out
        if turbo and p.stored:
            raise CorruptError("turbo streams contain no stored data")
        if not p.coded:
            # all-stored stream (incompressible input): pure host copies
            p.R = 0
            p.contiguous = False
            return p

        ncb = len(p.coded)
        row_of = np.full(len(blocks), -1, np.int64)
        row_of[coded_ids] = np.arange(ncb)
        out_start = np.array([b.out_start for b in p.coded], np.int64)
        out_len = np.array([b.out_len for b in p.coded], np.int64)
        end_bit = np.array([b.end_bit for b in p.coded], np.int64)
        pay_bit = np.array([b.payload_start_bit for b in p.coded], np.int64)

        abit = np.asarray(index.anchor_bit, np.int64)
        aout = np.asarray(index.anchor_out, np.int64)
        ablk = np.asarray(index.anchor_block, np.int64)
        if ablk.size and (ablk.min() < 0 or ablk.max() >= len(blocks)):
            raise CorruptError("anchor refers to a missing block")
        row = row_of[ablk]
        expect = _anchors_per_block(out_len, turbo)
        if (row < 0).any() or np.diff(row).min(initial=0) < 0 or \
                not np.array_equal(np.bincount(row, minlength=ncb), expect):
            raise CorruptError(
                "index anchors do not match the "
                f"{'turbo' if turbo else 'wide'} lane geometry")
        first = np.concatenate([[0], np.cumsum(expect)[:-1]])
        k = np.arange(row.size) - first[row]          # lane within its row
        rel = aout - out_start[row]
        last = k == expect[row] - 1
        nxt_bit = np.append(abit[1:], 0)
        nxt_rel = np.append(rel[1:], 0)
        lane_end = np.where(last, end_bit[row], nxt_bit)
        rel_end = np.where(last, out_len[row], nxt_rel)
        if ((k == 0) & ((rel != 0) | (abit != pay_bit[row]))).any() or \
                (lane_end < abit).any() or (rel_end < rel).any() or \
                (rel_end > out_len[row]).any():
            raise CorruptError("index anchors are not monotone within blocks")

        # decode tables, one per distinct block header (a turbo stream has
        # one): headers are parsed once each, tables built in one batch
        rows_of: dict[tuple, int] = {}
        ll_lens = np.zeros((ncb, C.NUM_LITLEN_SYMBOLS), np.int64)
        d_lens = np.zeros((ncb, C.NUM_DIST_SYMBOLS), np.int64)
        trow = np.empty(ncb, np.int32)
        for r, b in enumerate(p.coded):
            key = (b.btype, _header_bits(data, b))
            if key not in rows_of:
                rows_of[key] = n = len(rows_of)
                ll, dl = _block_code_lengths(data, b)
                ll_lens[n, : len(ll)] = ll
                d_lens[n, : len(dl)] = dl
            trow[r] = rows_of[key]
        p.tables = jnp.asarray(ld.decode_tables(ll_lens[: len(rows_of)],
                                                d_lens[: len(rows_of)]))

        sub = C.TURBO_SEG_SPAN // 2 if turbo else C.WIDE_ANCHOR_SPAN
        p.T = sub + 16        # tokens start in a <= sub-byte span, + EOB
        p.O = int(-(-out_len.max() // C.TURBO_SEG_SPAN) * C.TURBO_SEG_SPAN)
        p.R = -(-ncb // row_align) * row_align
        if p.R * p.O >= 1 << 31:
            raise ValueError("stream output exceeds the 2 GiB lane-plan limit")
        lpr = int(expect.max())
        L = p.R * lpr
        lane = row * lpr + k
        w0 = abit >> 5
        lanes = np.zeros((4, L), np.int64)
        lanes[0, lane] = w0
        lanes[1, lane] = abit & 31
        lanes[2, lane] = lane_end - (w0 << 5)
        lanes[3, lane] = trow[row]
        if lanes[2].max() >= 1 << 31:
            raise CorruptError("anchor span exceeds the lane bit range")
        p.lanes = jnp.asarray(lanes.astype(np.int32))
        lane_out = np.zeros(L, np.int64)
        lane_out[lane] = row * p.O + rel
        lane_out_end = np.zeros(L, np.int64)
        lane_out_end[lane] = row * p.O + rel_end
        p.lane_out = jnp.asarray(lane_out.astype(np.int32))
        p.lane_out_end = jnp.asarray(lane_out_end.astype(np.int32))
        row_len = np.zeros(p.R, np.int32)
        row_len[:ncb] = out_len
        p.row_len = jnp.asarray(row_len)
        p.words = stream_words(data)
        # rows flatten straight into the output iff coded blocks tile it
        # back-to-back at O bytes each
        p.contiguous = not p.stored and bool(
            (out_start == np.arange(ncb) * p.O).all())
        return p


@jax.jit
def _lane_errors(meta, lanes, lane_out, lane_out_end, lane_bytes, rerr):
    """Device-side integrity flags: (bad Huffman data, lane ran past T
    tokens or off its end bit, lane output off its anchors, bad
    back-reference)."""
    return jnp.stack([
        jnp.any(meta[2] > 0),
        jnp.any(meta[3] > 0) | jnp.any(meta[1] != lanes[2]),
        jnp.any(lane_out + lane_bytes != lane_out_end),
        rerr,
    ])


_LANE_ERRORS = (
    "invalid Huffman data in a decode lane",
    "decode lane did not end at its anchor",
    "decode lane output does not match its anchors",
    "back-reference before the start of its block",
)


def raise_lane_errors(flags: np.ndarray) -> None:
    for bad, msg in zip(np.asarray(flags).reshape(-1, 4).any(axis=0),
                        _LANE_ERRORS):
        if bad:
            raise CorruptError(msg)


def run_lanes(plan: LanePlan, check: bool = True):
    """Decode and resolve every lane; returns (R, O) uint8 block rows
    (device-resident)."""
    tokens, meta = ld.decode_lanes(plan.words, plan.lanes, plan.tables,
                                   T=plan.T)
    out, lane_bytes, rerr = ld.resolve_lanes(tokens, meta[0], plan.lane_out,
                                             plan.row_len, O=plan.O)
    if check:
        raise_lane_errors(jax.device_get(_lane_errors(
            meta, plan.lanes, plan.lane_out, plan.lane_out_end, lane_bytes,
            rerr)))
    return out.reshape(plan.R, plan.O)


def assemble(plan: LanePlan, data: bytes, rows) -> np.ndarray:
    """Host output bytes from device block rows (stored blocks copied from
    the stream)."""
    if plan.R and plan.contiguous:
        return np.asarray(rows.reshape(-1)[: plan.total_out])
    out = np.empty(plan.total_out, np.uint8)
    if plan.R:
        rows_np = np.asarray(rows)
        for i, b in enumerate(plan.coded):
            out[b.out_start : b.out_start + b.out_len] = rows_np[i, : b.out_len]
    for b in plan.stored:
        pos = (b.payload_start_bit >> 3) + 4
        out[b.out_start : b.out_start + b.out_len] = np.frombuffer(
            data, np.uint8, count=b.out_len, offset=pos)
    return out


def inflate_raw_lanes(data: bytes, index: StreamIndex,
                      check: bool = True) -> np.ndarray:
    """Full anchor-lane inflate; returns decompressed bytes (host array)."""
    plan = LanePlan.build(data, index)
    rows = run_lanes(plan, check=check) if plan.R else None
    return assemble(plan, data, rows)
