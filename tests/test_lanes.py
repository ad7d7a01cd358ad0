"""Anchor-lane decode and resolve (ops/lane_decode.py, codec/lanes.py).

The Triton decode kernel runs here in Pallas interpret mode and must match
the plain XLA decode token for token, on clean and corrupted lanes of both
stream profiles; the XLA resolve must reproduce the reference model.  Tests
marked ``gpu`` compile the kernel for the card and skip elsewhere.
"""
import hashlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zlibes_tpu.codec import deflate_pipeline as dp
from zlibes_tpu.codec.lanes import LanePlan, assemble, run_lanes
from zlibes_tpu.config import CodecConfig
from zlibes_tpu.ops import lane_decode as ld
from zlibes_tpu.spec import refmodel as rm

RAW = (Path(__file__).parent / "golden" / "raw.bin").read_bytes()
CONFIGS = {
    "wide": CodecConfig.from_level(3),
    "turbo": CodecConfig.turbo(candidates=4, probe_words=4),
}


@pytest.fixture(scope="module")
def streams():
    data = RAW[:60000]
    return {name: (data,) + dp.deflate(data, with_index=True, config=cfg,
                                       block_size=16384)
            for name, cfg in CONFIGS.items()}


def _corrupt(comp: bytes, plan: LanePlan, n: int = 8) -> bytes:
    """Flip one byte inside each of n lanes spread over the stream."""
    lanes = np.asarray(plan.lanes)
    span = lanes[2] - lanes[1]
    cand = np.nonzero(span > 96)[0]
    bad = bytearray(comp)
    for lane in cand[:: max(1, cand.size // n)][:n]:
        bit = lanes[0, lane] * 32 + lanes[1, lane] + span[lane] // 2
        bad[bit // 8] ^= 0x5A
    return bytes(bad)


def _masked(tokens, meta):
    t = np.arange(tokens.shape[0])[:, None]
    return np.where(t < np.asarray(meta)[0][None], np.asarray(tokens), 0)


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("profile", ["wide", "turbo"])
def test_decode_kernel_interpret_matches_xla(streams, profile, corrupt):
    _data, comp, index = streams[profile]
    plan = LanePlan.build(comp, index)
    clean = ld.decode_lanes_xla(plan.words, plan.lanes, plan.tables, T=plan.T)
    if corrupt:
        plan = LanePlan.build(_corrupt(comp, plan), index)
    tx, mx = ld.decode_lanes_xla(plan.words, plan.lanes, plan.tables,
                                 T=plan.T)
    tk, mk = ld.decode_lanes_kernel(plan.words, plan.lanes, plan.tables,
                                    T=plan.T, interpret=True)
    assert np.array_equal(np.asarray(mx), np.asarray(mk))
    assert np.array_equal(_masked(tx, mx), _masked(tk, mk))
    # the corrupted lanes really decode differently (flagged or not)
    assert np.array_equal(_masked(tx, mx), _masked(*clean)) != corrupt


@pytest.mark.parametrize("profile", ["wide", "turbo"])
def test_lane_inflate_matches_refmodel(streams, profile):
    data, comp, index = streams[profile]
    plan = LanePlan.build(comp, index)
    out = assemble(plan, comp, run_lanes(plan))
    assert out.tobytes() == rm.inflate(comp) == data


def _expand(tokens):
    """Plain LZ77 expansion of (val, dist) tokens: the reference model's
    back-copy loop."""
    out = bytearray()
    for val, dist in tokens:
        if dist:
            for _ in range(val):
                out.append(out[-dist])
        else:
            out.append(val)
    return bytes(out)


def _pack(val, dist):
    return val | (dist << ld.TOK_DIST_SHIFT) | (ld.TOK_MATCH_BIT if dist
                                                else 0)


def test_resolve_lanes_overlapping_copies():
    """Two rows; copies with dist < len, chains through earlier copies and
    a copy spanning a lane boundary resolve to the serial expansion."""
    O = 64
    row0 = [[(97, 0), (98, 0), (5, 1), (9, 2)], [(7, 4), (99, 0), (10, 11)]]
    row1 = [[(120, 0), (30, 1)], [(121, 0), (8, 3), (4, 33)]]
    lanes = row0 + row1
    T = max(len(x) for x in lanes)
    toks = np.zeros((T, len(lanes)), np.int32)
    count = np.array([len(x) for x in lanes], np.int32)
    lane_out, expect = [], []
    for r, row in enumerate((row0, row1)):
        pos = 0
        for lane in row:
            lane_out.append(r * O + pos)
            pos += sum(v if d else 1 for v, d in lane)
        expect.append(_expand([t for lane in row for t in lane]))
    for i, lane in enumerate(lanes):
        for j, (v, d) in enumerate(lane):
            toks[j, i] = _pack(v, d)
    row_len = np.array([len(e) for e in expect], np.int32)
    out, lane_bytes, err = ld.resolve_lanes(
        jnp.asarray(toks), jnp.asarray(count),
        jnp.asarray(np.array(lane_out, np.int32)), jnp.asarray(row_len), O=O)
    out = np.asarray(out).reshape(2, O)
    assert not bool(err)
    for r in range(2):
        assert out[r, : row_len[r]].tobytes() == expect[r]
    assert list(np.asarray(lane_bytes)) == [
        sum(v if d else 1 for v, d in lane) for lane in lanes]


def test_resolve_flags_reference_before_row():
    """A copy reaching before its row start is an error, not a read of the
    previous row."""
    toks = np.array([[_pack(65, 0), _pack(66, 0)],
                     [_pack(3, 1), _pack(3, 2)]], np.int32)
    out, _lb, err = ld.resolve_lanes(
        jnp.asarray(toks), jnp.asarray(np.array([2, 2], np.int32)),
        jnp.asarray(np.array([0, 16], np.int32)),
        jnp.asarray(np.array([4, 4], np.int32)), O=16)
    assert bool(err)
    toks[1, 1] = _pack(3, 1)
    out, _lb, err = ld.resolve_lanes(
        jnp.asarray(toks), jnp.asarray(np.array([2, 2], np.int32)),
        jnp.asarray(np.array([0, 16], np.int32)),
        jnp.asarray(np.array([4, 4], np.int32)), O=16)
    assert not bool(err)
    assert np.asarray(out)[16:20].tobytes() == b"BBBB"


@pytest.mark.parametrize("platform,route", [
    ("cpu", "xla"), ("gpu", "kernel"), ("tpu", None)])
def test_decode_route(monkeypatch, platform, route):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if route is None:
        with pytest.raises(RuntimeError, match="no lane-decode route"):
            ld.decode_route()
    else:
        assert ld.decode_route() == route


def test_turbo_stream_bytes_unchanged():
    """Turbo deflate's bytes and anchors are those of the lock-step
    selection kernel that select_tokens(split_far=True) replaced (hashes
    recorded from that implementation)."""
    rng = np.random.default_rng(21)
    text = b"the quick brown fox jumps over the lazy dog. " * 200
    rnd = rng.integers(0, 256, (3 * 16384 + 777) // 4,
                       dtype=np.uint8).tobytes()
    rle = b"A" * 1200 + b"ab" * 700 + bytes(range(256)) * 4
    data = ((text + rnd + rle) * 7)[: 3 * 16384 + 777]
    comp, index = dp.deflate(data, with_index=True,
                             config=CONFIGS["turbo"], block_size=16384)
    assert hashlib.sha256(comp).hexdigest() == (
        "5a63e357f187909c396ab068d4b8c9566e3d37bd603453d4e3d8c2a2cf66c95a")
    anchors = (np.asarray(index.anchor_bit, np.int64).tobytes()
               + np.asarray(index.anchor_out, np.int64).tobytes())
    assert hashlib.sha256(anchors).hexdigest() == (
        "55a4d2cebbd832f6ba4902e7a06eae8afc587c3626de80b4767e40c360b2d6dc")


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_dir_rule(monkeypatch, tmp_path, env_set):
    from zlibes_tpu.utils import cache

    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = Path(__file__).resolve().parents[1]
        assert Path(cache.cache_dir()) == root / ".jax_cache"


def test_decode_kernel_lowers_for_cuda():
    """The kernel's Triton lowering (no card needed) accepts every
    primitive and block shape at a real lane count."""
    words = jax.ShapeDtypeStruct((1 << 20,), jnp.uint32)
    lanes = jax.ShapeDtypeStruct((4, 1 << 16), jnp.int32)
    tables = jax.ShapeDtypeStruct((64, ld.TAB_W), jnp.int32)
    for T in (144, 272):
        low = jax.jit(lambda w, l, t, T=T: ld.decode_lanes_kernel(
            w, l, t, T=T)).trace(words, lanes, tables).lower(
                lowering_platforms=("cuda",))
        assert "triton" in low.as_text()


@pytest.mark.gpu
@pytest.mark.parametrize("profile", ["wide", "turbo"])
def test_decode_kernel_on_card(gpu, streams, profile):
    data, comp, index = streams[profile]
    plan = LanePlan.build(comp, index)
    tx, mx = ld.decode_lanes_xla(plan.words, plan.lanes, plan.tables,
                                 T=plan.T)
    tk, mk = ld.decode_lanes_kernel(plan.words, plan.lanes, plan.tables,
                                    T=plan.T)
    assert np.array_equal(np.asarray(mx), np.asarray(mk))
    assert np.array_equal(_masked(tx, mx), _masked(tk, mk))
    assert assemble(plan, comp, run_lanes(plan)).tobytes() == data
