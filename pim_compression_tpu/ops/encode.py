"""Data-parallel block encoder (pure XLA, portable).

The reference compressor is a serial hash-table probe loop
(``snappy_compress.c:284-413``). The format does not require any particular
match finder — the reference's own DPU kernel already uses a different hash
(``dpu-compress/dpu_compress.c:202-212``) — so this encoder is a from-scratch
data-parallel design:

1. **Exact previous-occurrence matching**: stable-sort (4-gram, position)
   pairs per block; the predecessor with an equal gram is the *most recent
   previous occurrence* — strictly better match candidates than the
   reference's collision-prone 2^14-entry hash table.
2. **Match lengths**: 64 lock-step shifted byte comparisons (copy elements
   cap at 64 output bytes anyway; longer matches continue as chained copies
   exactly like the reference's 64-byte chunking, because each subsequent
   gram finds its own previous occurrence at the same distance).
3. **Greedy parse**: ``step(p) = p + match_len(p)`` (or +1 literal); the
   chosen elements are the orbit of 0 under ``step`` — pointer doubling
   again, no serial walk.
4. **Literal coalescing**: runs of chosen literal bytes merge into single
   literal elements via segment scans (head detection + reverse cummin).
5. **Emission**: per-element sizes -> exclusive cumsum -> every output byte
   finds its element via ``searchsorted`` and computes itself (header-byte
   select or literal-data gather). No scatters in the emit path.

Output is decodable by any conforming decoder and compresses the corpus
*smaller* than the reference (exact matching beats hashed matching); the
oracle remains the arbiter for round-trip tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pim_compression_tpu.format import constants as C
from pim_compression_tpu.ops import primitives as P
from pim_compression_tpu.ops.decode import padded_capacity  # noqa: F401  (shared capacity model)

_INF = 1 << 30


def _previous_occurrences(
    gram: jax.Array, valid: jax.Array, prev_k: int
) -> list[jax.Array]:
    """The ``prev_k`` most recent q < p with gram[q] == gram[p] (-1 = none).

    Stable sort by gram keeps positions ascending within equal grams, so
    the k-th in-sort predecessor with an equal key is exactly the k-th most
    recent previous occurrence. One sort serves every k (exact 32-bit
    keys, any block size).
    """
    n = gram.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    gram_s, pos_s = jax.lax.sort((gram, pos), num_keys=1, is_stable=True)
    prevs = []
    for k in range(1, prev_k + 1):
        same_k = gram_s[k:] == gram_s[:-k]
        cand = jnp.concatenate(
            [jnp.full((k,), -1, jnp.int32), jnp.where(same_k, pos_s[:-k], -1)]
        )
        prev = jnp.zeros((n,), jnp.int32).at[pos_s].set(cand)
        prevs.append(jnp.where(valid, prev, -1))
    return prevs


def _match_lengths(
    data_i32: jax.Array,
    prev: jax.Array,
    n: jax.Array,
    block_size: int,
    cap: int = C.MAX_COPY_LEN,
    start: jax.Array | None = None,
) -> jax.Array:
    """Common-prefix length between p and prev[p], capped at ``cap``.

    ``start`` (per-position) resumes counting from a known-equal prefix —
    the select-then-extend pattern: candidates get a cheap capped probe and
    only the winner pays the full extension, resuming where the probe
    stopped.
    """
    pos = jnp.arange(block_size, dtype=jnp.int32)
    prev_c = jnp.maximum(prev, 0)
    ml0 = jnp.zeros((block_size,), jnp.int32) if start is None else start
    limit = block_size + C.MAX_COPY_LEN - 1

    def body(t, carry):
        alive, ml = carry
        q = ml0 + t
        # data_i32 is padded with MAX_COPY_LEN zeros; reads stay clamped.
        a = jnp.take(data_i32, jnp.minimum(pos + q, limit))
        b = jnp.take(data_i32, jnp.minimum(prev_c + q, limit))
        alive = alive & (a == b) & (pos + q < n) & (q < C.MAX_COPY_LEN)
        return alive, ml + alive.astype(jnp.int32)

    _, ml = jax.lax.fori_loop(0, cap, body, (prev >= 0, ml0))
    return ml


def _encode_one_block(
    data: jax.Array,  # uint8[block_size]
    n: jax.Array,  # int32 scalar, true length
    *,
    block_size: int,
    prev_k: int,
    sel_cap: int,
) -> tuple[jax.Array, jax.Array]:
    cap = padded_capacity(block_size)
    pos = jnp.arange(block_size, dtype=jnp.int32)
    d32 = jnp.pad(data, (0, C.MAX_COPY_LEN)).astype(jnp.int32)

    gram = (
        d32[:block_size]
        | (d32[1 : block_size + 1] << 8)
        | (d32[2 : block_size + 2] << 16)
        | (d32[3 : block_size + 3] << 24)
    )
    gram_valid = pos + C.MIN_MATCH_LEN <= n
    cands = _previous_occurrences(gram, gram_valid, prev_k)
    if prev_k == 1:
        prev = cands[0]
        ml = _match_lengths(d32, prev, n, block_size)
    else:
        # Select-then-extend over the prev-k ladder: every candidate gets a
        # cheap sel_cap-byte probe; the nearest longest-probing candidate
        # wins and resumes its extension from the probed prefix. The k-th
        # most recent occurrence often matches far longer than the nearest
        # (xml @64K: 0.7715 at k=2 vs 0.7090 at k=1).
        probes = [
            _match_lengths(d32, c, n, block_size, cap=sel_cap)
            for c in cands
        ]
        prev = cands[0]
        best = probes[0]
        for c, p in zip(cands[1:], probes[1:]):
            better = p > best
            prev = jnp.where(better, c, prev)
            best = jnp.where(better, p, best)
        ml = _match_lengths(
            d32, prev, n, block_size, cap=C.MAX_COPY_LEN - sel_cap,
            start=best,
        )
    ml = jnp.where(ml >= C.MIN_MATCH_LEN, ml, 0)
    # Lazy-1 matching: defer a copy when the next position matches longer
    # (an elementwise pre-transform of the match lengths).
    nxt_ml = jnp.concatenate([ml[1:], jnp.zeros((1,), ml.dtype)])
    ml = jnp.where(nxt_ml > ml, 0, ml)

    # Greedy parse: orbit of 0 under step.
    step_to = jnp.where(ml > 0, pos + ml, pos + 1)
    nxt = jnp.minimum(jnp.append(step_to, n), n)
    nxt = jnp.where(jnp.arange(block_size + 1) >= n, n, nxt)
    elem_pos = P.orbit_positions(nxt, block_size)  # <= block_size elements
    e_valid = elem_pos < n

    safe_pos = jnp.clip(elem_pos, 0, block_size - 1)
    e_ml = jnp.where(e_valid, jnp.take(ml, safe_pos), 0)
    e_iscopy = e_valid & (e_ml > 0)
    e_islit = e_valid & (e_ml == 0)
    e_off = jnp.where(e_iscopy, safe_pos - jnp.take(prev, safe_pos), 0)

    # Literal-run coalescing. Consecutive chosen literals are consecutive
    # positions, so a run spans from its head to the next copy/stream end.
    prev_islit = jnp.concatenate([jnp.array([False]), e_islit[:-1]])
    head = e_islit & ~prev_islit
    nonlit_pos = jnp.where(e_iscopy, elem_pos, jnp.where(e_valid, _INF, n))
    run_end = jax.lax.cummin(nonlit_pos, reverse=True)
    run_len = jnp.where(head, jnp.minimum(run_end, n) - elem_pos, 0)

    # Per-element emitted sizes.
    lit_ext = jnp.where(run_len - 1 < 60, 0, jnp.where(run_len - 1 < 256, 1, 2))
    lit_size = jnp.where(head, 1 + lit_ext + run_len, 0)
    copy1 = e_iscopy & (e_ml < 12) & (e_off < C.COPY1_MAX_OFFSET)
    copy_size = jnp.where(e_iscopy, jnp.where(copy1, 2, 3), 0)
    e_size = lit_size + copy_size
    e_emit = head | e_iscopy
    e_start = P.exclusive_cumsum(e_size)
    comp_size = e_start[-1] + e_size[-1]

    # Header bytes (up to 3 per element).
    L1 = run_len - 1
    h0 = jnp.where(
        e_iscopy,
        jnp.where(
            copy1,
            C.ElementType.COPY_1_BYTE_OFFSET | ((e_ml - 4) << 2) | ((e_off >> 8) << 5),
            C.ElementType.COPY_2_BYTE_OFFSET | ((e_ml - 1) << 2),
        ),
        jnp.where(lit_ext == 0, L1 << 2, jnp.where(lit_ext == 1, 60 << 2, 61 << 2)),
    )
    h1 = jnp.where(
        e_iscopy,
        e_off & 0xFF,
        jnp.where(lit_ext >= 1, L1 & 0xFF, 0),
    )
    h2 = jnp.where(e_iscopy, (e_off >> 8) & 0xFF, jnp.where(lit_ext == 2, (L1 >> 8) & 0xFF, 0))
    hdr_len = jnp.where(e_iscopy, jnp.where(copy1, 2, 3), 1 + lit_ext)

    # Emit: every output byte derives itself from its covering element.
    # e_start is nondecreasing; absorbed/invalid elements have size 0 and so
    # share the *next* emitter's start, which makes "last element with
    # start <= q" always land on an emitting element.
    del e_emit
    q = jnp.arange(cap, dtype=jnp.int32)
    cov = jnp.searchsorted(e_start, q, side="right").astype(jnp.int32) - 1
    cov = jnp.clip(cov, 0, block_size - 1)
    c_start = jnp.take(e_start, cov)
    c_hdr = jnp.take(hdr_len, cov)
    c_pos = jnp.take(elem_pos, cov)
    rel = q - c_start
    hdr_byte = jnp.where(
        rel == 0,
        jnp.take(h0, cov),
        jnp.where(rel == 1, jnp.take(h1, cov), jnp.take(h2, cov)),
    )
    data_byte = jnp.take(d32, jnp.clip(c_pos + (rel - c_hdr), 0, block_size - 1))
    out = jnp.where(rel < c_hdr, hdr_byte, data_byte)
    out = jnp.where(q < comp_size, out, 0).astype(jnp.uint8)
    return out, comp_size.astype(jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("block_size", "prev_k", "sel_cap")
)
def encode_blocks(
    data: jax.Array,  # uint8[num_blocks, block_size]
    lens: jax.Array,  # int32[num_blocks]
    *,
    block_size: int = C.DEFAULT_BLOCK_SIZE,
    prev_k: int = 2,
    sel_cap: int = 16,
) -> tuple[jax.Array, jax.Array]:
    """Compress a batch of independent blocks.

    Returns ``(comp, sizes)``: padded payloads uint8[num_blocks, cap] and
    true compressed sizes int32[num_blocks] (u32 frames are added at
    assembly time by the runtime, like the reference's host-side header
    writes, ``snappy_compress.c:522-525``).

    Defaults (``prev_k=2, sel_cap=16``) put the portable engine's ratio
    above the reference compressor at EVERY block size it accepts — the
    exact 2-key sort has no position-packing limit, so this is also the
    64 KB-block encode path (xml @64K: 0.7715 vs the reference's 0.7408).
    """
    fn = functools.partial(
        _encode_one_block, block_size=block_size, prev_k=prev_k,
        sel_cap=sel_cap,
    )
    return jax.vmap(fn)(data, lens)
