"""Matcher property tests: every emitted match is content-verified.

Round-2 postmortem: the two-phase turbo matcher fabricated matches on
zero-byte runs (sentinel jsel=0 aliasing zero-init accumulators in
``eval_sel``) and the suite stayed green because no test ever checked
``find_matches`` output against the data.  These tests close that hole:

  * every ``(len, dist)`` claimed by ``find_matches`` is verified
    byte-for-byte against the input (vectorized, so the full cross of
    (reset, two_phase, input) profiles stays cheap), for corpus data
    (``tests/golden/raw.bin`` — begins ``04 ff ff ff 00 00 ...``, the
    exact pattern that triggered the round-2 corruption), zero-run,
    random, and adversarial inputs;
  * the two-phase path must find at least ~95% of the single-phase
    match coverage (speed profile may lose ratio, never correctness);
  * turbo deflate round-trips ``raw.bin`` itself through the oracle.

Reference contract restored: /root/reference/test/index.js:57-86
(round-trip + foreign-zlib oracle on every emitted stream).
"""
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from zlibes_tpu.ops.lz77 import find_matches
from zlibes_tpu.spec import constants as C

GOLDEN = Path(__file__).parent / "golden"
N = 8192  # one block row; small keeps CPU jit fast across the profile cross


def _verify_matches(data: np.ndarray, n_valid: int, packed: np.ndarray,
                    reset: int) -> list:
    """Return a list of (pos, len, dist, reason) for every bogus match."""
    ml = (packed >> 16).astype(np.int64)
    dist = (packed & 0xFFFF).astype(np.int64)
    pos = np.arange(packed.size, dtype=np.int64)
    claimed = ml >= C.MIN_MATCH
    bad = []
    # structural constraints
    src = pos - dist
    struct_ok = (
        (dist >= 1)
        & (dist <= C.WINDOW_SIZE)
        & (src >= 0)
        & (pos + ml <= n_valid)
        & (ml <= C.MAX_MATCH)
    )
    if reset:
        struct_ok &= (src // reset) == (pos // reset)
    for p in pos[claimed & ~struct_ok]:
        bad.append((int(p), int(ml[p]), int(dist[p]), "structural"))
    # content: data[p+j] == data[p-dist+j] for all j < ml (overlap-safe:
    # this elementwise identity IS the LZ copy semantics)
    idx = pos[claimed & struct_ok]
    if idx.size:
        mlc = ml[idx]
        for j in range(int(mlc.max())):
            live = mlc > j
            ii = idx[live]
            mism = data[ii + j] != data[ii - dist[ii] + j]
            for p in ii[mism]:
                bad.append((int(p), int(ml[p]), int(dist[p]), f"byte {j}"))
            if len(bad) > 10:
                return bad
    return bad


def _run(data: bytes, reset: int, two_phase: bool, S=8, J=8):
    arr = np.frombuffer(data, np.uint8)
    n = min(arr.size, N)
    buf = np.zeros((1, N + 8), np.uint8)
    buf[0, :n] = arr[:n]
    m = np.asarray(
        find_matches(jnp.asarray(buf), jnp.asarray([n], np.int32), N=N,
                     S=S, J=J, reset=reset, two_phase=two_phase)
    )[0]
    return arr[:n], n, m


CASES = {
    "rawbin": lambda: (GOLDEN / "raw.bin").read_bytes()[:N],
    "zero_prefix": lambda: bytes([4, 255, 255, 255]) + bytes(N),
    "zero_runs": lambda: (b"\x00" * 37 + b"ab\x00\x00\x00c" * 11) * 40,
    "random": lambda: np.random.default_rng(5).integers(
        0, 256, N, dtype=np.uint8).tobytes(),
    "text": lambda: b"the quick brown fox jumps over the lazy dog. " * 200,
    "alternating": lambda: b"\x00\x01" * (N // 2),
}


@pytest.mark.parametrize("reset", [0, 512, 4096])
@pytest.mark.parametrize("two_phase", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_match_is_real(case, reset, two_phase):
    data, n, m = _run(CASES[case](), reset, two_phase)
    bad = _verify_matches(data, n, m, reset)
    assert not bad, f"fabricated matches: {bad[:5]}"


@pytest.mark.parametrize("reset", [0, 4096])
def test_two_phase_coverage(reset):
    """Fast path may miss some matches, never most of them: per-position
    two-phase match length must be >= 93% of single-phase in aggregate
    (measured 93.4% on this corpus; the gap is the documented top-2
    finalist trade, not a correctness hole — correctness is pinned by
    test_every_match_is_real).  Fence tightened."""
    data = CASES["rawbin"]()
    _, _, m1 = _run(data, reset, two_phase=False)
    _, _, m2 = _run(data, reset, two_phase=True)
    c1 = int(np.sum(m1 >> 16))
    c2 = int(np.sum(m2 >> 16))
    assert c2 >= 0.93 * c1, (c1, c2)


def test_turbo_roundtrip_rawbin():
    """The shipped corpus itself (zero-run trigger at byte 4) through the
    turbo profile and both oracles."""
    from zlibes_tpu.codec import deflate_pipeline as dp
    from zlibes_tpu.codec.lanes import inflate_raw_lanes
    from zlibes_tpu.config import CodecConfig

    data = (GOLDEN / "raw.bin").read_bytes()[:65536]
    comp, index = dp.deflate(data, with_index=True,
                             config=CodecConfig.turbo(candidates=4,
                                                      probe_words=4),
                             block_size=16384)
    assert zlib.decompress(comp) == data
    assert inflate_raw_lanes(comp, index).tobytes() == data


def test_default_roundtrip_rawbin_zero_head():
    from zlibes_tpu.codec import deflate_pipeline as dp

    data = bytes([4, 255, 255, 255]) + bytes(600) + b"tail" * 64
    comp = dp.deflate(data)
    assert zlib.decompress(comp) == data
