"""Batch compression with a shared preset dictionary, mesh-parallel.

The production use of preset dictionaries: compressing many small related
payloads (documents, rows, RPC bodies) where each becomes its own zlib
member referencing one shared dictionary (RFC 1950 FDICT).  Device
mapping (SURVEY.md §2 "Dictionary broadcast"):

  * payload rows shard across the mesh (data parallelism);
  * the dictionary is **replicated** — one broadcast — and every
    lane's match finder sees it as a 32 KiB context prefix;
  * per-payload Adler-32 and bit-packing happen on device; the host only
    frames each member (6-byte FDICT header + trailer).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..ops.deflate_kernel import pack_payload, token_symbols
from ..ops.lz77 import find_matches, select_tokens
from ..spec import constants as C
from ..spec.refmodel import adler32 as adler32_host
from .block_parallel import _fixed_tables, make_mesh

_DICT = C.WINDOW_SIZE  # context prefix size (dictionary tail)


@partial(jax.jit, static_argnames=("mesh", "P_CAP", "SEG_SIZE", "W"))
def _batch_step(dict_row, dict_start, payloads, n_valid, mesh, P_CAP,
                SEG_SIZE, W):
    """Fixed-Huffman encode of payload rows with a replicated dictionary.

    ``dict_start``: first real dictionary byte within the 32 KiB context
    prefix (the prefix is left-padded for short dictionaries; padding
    positions must never be match sources — the decoder doesn't have
    them, so matches there would emit invalid distances)."""
    DB = payloads.shape[0]
    D = mesh.devices.size
    Bd = DB // D
    N = _DICT + P_CAP
    nseg = P_CAP // SEG_SIZE

    def body(dict_row, rows, nv):
        data = jnp.concatenate(
            [jnp.broadcast_to(dict_row[None, :], (Bd, _DICT)), rows], axis=1
        )
        nv_full = nv + _DICT
        ctx = jnp.broadcast_to(dict_start, (Bd,))
        matches = find_matches(data, nv_full, N=N, S=8, J=8, ctx_start=ctx)
        tv, td, cnt = select_tokens(data, matches, nv_full, N=N,
                                    SEG_SIZE=SEG_SIZE, start=_DICT)
        lsym, dsym, valid, _lf, _df = token_symbols(tv, td, cnt, nseg=nseg)
        ll_code, ll_len, d_code, d_len = _fixed_tables(Bd)
        hdr = jnp.full(Bd, 3, jnp.int32)
        en = jnp.ones(Bd, bool)
        words, payload_end, _b0 = pack_payload(
            tv, td, lsym, dsym, valid, ll_code, ll_len, d_code, d_len,
            hdr, en, nseg=nseg, W=W,
        )
        # per-payload Adler-32 (each payload is its own zlib member)
        d32 = rows[:, :P_CAP].astype(jnp.int32)
        pos = jax.lax.broadcasted_iota(jnp.int32, (Bd, P_CAP), 1)
        mask = pos < nv[:, None]
        d32 = jnp.where(mask, d32, 0)
        m = C.ADLER_MOD
        # chunked int32-safe reduction per row
        ck = min(2048, P_CAP)
        dd = d32.reshape(Bd, P_CAP // ck, ck)
        jj = jax.lax.broadcasted_iota(jnp.int32, dd.shape, 2)
        a_c = jnp.sum(dd, axis=2) % m
        b_c = jnp.sum(dd * jj, axis=2) % m
        offs = jnp.arange(P_CAP // ck, dtype=jnp.int32)[None, :] * ck
        w = jnp.where(a_c > 0, (nv[:, None] - offs) % m, 0)
        wh, wl = w >> 8, w & 0xFF
        terms = ((a_c * wh) % m * 256 + a_c * wl - b_c) % m
        s1 = (1 + jnp.sum(a_c, axis=1) % m) % m
        s2 = (nv % m + jnp.sum(terms, axis=1) % m) % m
        adler = (s2.astype(jnp.uint32) << 16) | s1.astype(jnp.uint32)
        return words, payload_end, adler

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(), P("blocks"), P("blocks")),
        out_specs=(P("blocks"), P("blocks"), P("blocks")),
        check_vma=False,
    )(dict_row, payloads, n_valid)


def compress_batch(payloads: list[bytes], dictionary: bytes,
                   mesh: Mesh | None = None, seg_size: int = 1024) -> list[bytes]:
    """Compress many payloads against one shared dictionary.

    Returns one FDICT zlib member per payload, each independently
    decodable with ``inflate(member, dictionary=dictionary)`` (or by any
    zlib via ``decompressobj(zdict=...)``).  Payloads are padded to a
    common power-of-two row and sharded across the mesh; the dictionary is
    broadcast (replicated) once.
    """
    if mesh is None:
        mesh = make_mesh(1)
    if not payloads:
        return []
    dict_tail = np.zeros(_DICT, np.uint8)
    dt = np.frombuffer(bytes(dictionary[-_DICT:]), np.uint8)
    dict_tail[_DICT - dt.size :] = dt

    pmax = max(len(p) for p in payloads)
    P_CAP = max(seg_size, 1 << (max(pmax, 1) - 1).bit_length())
    if P_CAP % seg_size:
        raise ValueError("seg_size must divide the payload row size")
    D = mesh.devices.size
    nb = len(payloads)
    Bd = -(-nb // D)
    DB = D * Bd
    rows = np.zeros((DB, P_CAP + 8), np.uint8)
    n_valid = np.zeros(DB, np.int32)
    for i, p in enumerate(payloads):
        rows[i, : len(p)] = np.frombuffer(bytes(p), np.uint8)
        n_valid[i] = len(p)

    W = (15 * P_CAP + 4096) // 32
    sh = NamedSharding(mesh, P("blocks"))
    words, payload_end, adler = _batch_step(
        jnp.asarray(dict_tail), jnp.int32(_DICT - dt.size),
        jax.device_put(rows, sh),
        jax.device_put(n_valid, sh), mesh=mesh, P_CAP=P_CAP,
        SEG_SIZE=seg_size, W=W,
    )
    words_np = np.asarray(words)
    pe = np.asarray(payload_end)
    adler_np = np.asarray(adler)

    from ..codec.deflate_pipeline import _encode_tables, _FIXED_LL_LEN, _FIXED_D_LEN, _or_bits

    ll_code, _ = _encode_tables(_FIXED_LL_LEN, _FIXED_D_LEN)
    eob_code, eob_len = int(ll_code[C.END_OF_BLOCK]), int(_FIXED_LL_LEN[C.END_OF_BLOCK])
    dictid = adler32_host(dictionary).to_bytes(4, "big")
    flg_base = 0x78 * 256 + 0x20 + (2 << 6)
    flg = 0x20 + (2 << 6) + (31 - flg_base % 31) % 31
    header = bytes([0x78, flg]) + dictid

    members = []
    for i in range(nb):
        end_bits = int(pe[i])
        nbytes = (end_bits + eob_len + 7) // 8
        buf = words_np[i].view(np.uint8)[: nbytes + 4].copy()
        buf[0] |= 1 | (C.BTYPE_FIXED << 1)  # BFINAL=1, fixed block
        _or_bits(buf, end_bits, eob_code, eob_len)
        body = buf[: (end_bits + eob_len + 7) // 8].tobytes()
        members.append(header + body + int(adler_np[i]).to_bytes(4, "big"))
    return members


def decompress_batch(members: list[bytes], dictionary: bytes) -> list[bytes]:
    """Inverse of compress_batch (host loop over the native/scan path)."""
    from ..codec import inflate_pipeline as ip

    return [ip.inflate(m, dictionary=dictionary) for m in members]
