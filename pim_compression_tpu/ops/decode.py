"""Fully data-parallel block decoder (pure XLA).

The reference decodes each block with a byte-serial tag-dispatch loop
(host: ``snappy_decompress.c:218-289``; DPU: ``dpu-decompress/
dpu_decompress.c:224-299``). A serial loop leaves a vector machine idle, so
this decoder is a redesign, not a translation — every stage is a
fixed-depth batch of vector ops:

1. **Speculative tag decode** — decode a tag at *every* byte position of the
   padded compressed block at once (shifted-view arithmetic on the byte
   array; each position computes its element kind, output length, offset,
   and stream advance as if a tag started there).
2. **Tag-chain discovery** — the true tags are the orbit of position 0 under
   the per-position ``advance`` successor. Jump-table doubling
   (``primitives.orbit_positions``) finds all of them in ceil(log2(E))
   gathers, no serial walk.
3. **Output layout** — per-element output lengths -> exclusive cumsum ->
   ``searchsorted`` maps every output byte to its covering element.
4. **Copy resolution** — every output byte gets a source pointer: a negative
   literal index into the compressed bytes, or ``i - offset`` for copies.
   Pointer doubling (``primitives.resolve_copy_chains``) collapses arbitrary
   copy chains — including offset<length RLE replication
   (``snappy_decompress.c:174-181`` semantics) — in ceil(log2(B)) gathers.
5. **Literal gather** — one final gather from the compressed bytes.

Everything is static-shape: blocks are padded to the worst-case compressed
capacity (the SPMD translation of the reference's rank-transfer padding,
``snappy_compress.c:575-584``) and true sizes ride in sidecar int32 arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pim_compression_tpu.format import constants as C
from pim_compression_tpu.ops import primitives as P

# Error flag bits (per block).
ERR_LENGTH_MISMATCH = 1  # decoded size != expected size
ERR_BAD_OFFSET = 2  # copy offset 0 or reaching before block start
ERR_ELEMENT_OVERRUN = 4  # element extends past the compressed payload

# Sentinel added to oversized length/offset fields so they stay in int32
# while still tripping the validity checks (real values are < 2**17).
_TOO_BIG = 1 << 26


def padded_capacity(block_size: int) -> int:
    """Static per-block compressed capacity, 128-lane aligned."""
    cap = C.max_compressed_length(block_size)
    return (cap + 127) // 128 * 128


def _speculative_tags(comp_i32: jax.Array, cap: int) -> dict[str, jax.Array]:
    """Decode a tag at every position p of the padded block.

    ``comp_i32`` is int32[cap + 4] (4 trailing zeros so shifted views are
    always in bounds). Returns per-position element descriptors.
    """
    c0 = comp_i32[:cap]
    c1 = comp_i32[1 : cap + 1]
    c2 = comp_i32[2 : cap + 2]
    c3 = comp_i32[3 : cap + 3]
    c4 = comp_i32[4 : cap + 4]

    kind = c0 & 3
    lf = c0 >> 2

    # Literal lengths: inline (lf < 60) or lf-59 extra LE bytes whose value+1
    # is the length. A 4th length byte would exceed any block size; clamp via
    # sentinel instead of overflowing int32.
    k = lf - 59  # 1..4 when lf >= 60
    ext_len = jnp.where(k >= 1, c1, 0)
    ext_len = ext_len + jnp.where(k >= 2, c2 << 8, 0)
    ext_len = ext_len + jnp.where(k >= 3, c3 << 16, 0)
    ext_len = ext_len + jnp.where((k >= 4) & (c4 > 0), _TOO_BIG, 0)
    lit_len = jnp.where(lf < 60, lf + 1, ext_len + 1)
    lit_hdr = jnp.where(lf < 60, 1, 1 + k)

    copy1_len = ((c0 >> 2) & 7) + C.MIN_MATCH_LEN
    copy1_off = ((c0 >> 5) << 8) | c1
    copy2_len = lf + 1
    copy2_off = c1 | (c2 << 8)
    copy4_off = c1 | (c2 << 8) | (c3 << 16)
    copy4_off = copy4_off + jnp.where(c4 > 0, _TOO_BIG, 0)

    is_lit = kind == C.ElementType.LITERAL
    is_copy1 = kind == C.ElementType.COPY_1_BYTE_OFFSET
    is_copy2 = kind == C.ElementType.COPY_2_BYTE_OFFSET

    out_len = jnp.where(
        is_lit,
        lit_len,
        jnp.where(is_copy1, copy1_len, copy2_len),  # copy2/copy4 share lf+1
    )
    offset = jnp.where(
        is_lit, 0, jnp.where(is_copy1, copy1_off, jnp.where(is_copy2, copy2_off, copy4_off))
    )
    hdr = jnp.where(is_lit, lit_hdr, jnp.where(is_copy1, 2, jnp.where(is_copy2, 3, 5)))
    advance = hdr + jnp.where(is_lit, lit_len, 0)

    return {
        "is_lit": is_lit,
        "out_len": out_len,
        "offset": offset,
        "advance": advance,
        "lit_data_start": jnp.arange(cap, dtype=jnp.int32) + lit_hdr,
    }


def _decode_one_block(
    comp: jax.Array,  # uint8[cap]
    comp_len: jax.Array,  # int32 scalar
    out_len: jax.Array,  # int32 scalar
    *,
    block_size: int,
) -> tuple[jax.Array, jax.Array]:
    cap = comp.shape[0]
    max_elems = cap // 2 + 2  # every element consumes >= 2 compressed bytes

    comp_i32 = jnp.pad(comp, (0, 4)).astype(jnp.int32)
    d = _speculative_tags(comp_i32, cap)

    # Successor over [0, cap]: node comp_len self-loops as the terminal.
    pos_idx = jnp.arange(cap + 1, dtype=jnp.int32)
    adv = jnp.pad(d["advance"], (0, 1))
    nxt = jnp.minimum(pos_idx + adv, comp_len)
    nxt = jnp.where(pos_idx >= comp_len, comp_len, nxt)

    # True tag positions = orbit of 0.
    elem_pos = P.orbit_positions(nxt, max_elems)
    elem_valid = elem_pos < comp_len

    gather = lambda a: jnp.take(a, jnp.clip(elem_pos, 0, cap - 1))
    e_outlen = jnp.where(elem_valid, gather(d["out_len"]), 0)
    e_islit = gather(d["is_lit"]) & elem_valid
    e_off = gather(d["offset"])
    e_lit_start = gather(d["lit_data_start"])
    e_adv = jnp.where(elem_valid, gather(d["advance"]), 0)

    e_start = P.exclusive_cumsum(e_outlen)
    total = e_start[-1] + e_outlen[-1]

    err = jnp.where(total != out_len, ERR_LENGTH_MISMATCH, 0)
    bad_off = elem_valid & ~e_islit & ((e_off <= 0) | (e_start - e_off < 0))
    err = err | jnp.where(jnp.any(bad_off), ERR_BAD_OFFSET, 0)
    overrun = elem_valid & (elem_pos + e_adv > comp_len)
    err = err | jnp.where(jnp.any(overrun), ERR_ELEMENT_OVERRUN, 0)

    # Map each output byte to its covering element, then to a source pointer.
    cov = P.covering_element(e_start, block_size)
    i_idx = jnp.arange(block_size, dtype=jnp.int32)
    cov_start = jnp.take(e_start, cov)
    cov_islit = jnp.take(e_islit, cov)
    cov_off = jnp.take(e_off, cov)
    cov_lit = jnp.take(e_lit_start, cov)

    lit_src = -(cov_lit + (i_idx - cov_start)) - 1
    copy_src = i_idx - jnp.maximum(cov_off, 0)
    src = jnp.where(cov_islit, lit_src, copy_src)
    src = jnp.where(i_idx < total, src, -1)

    src = P.resolve_copy_chains(src, P.ceil_log2(block_size))

    out = jnp.take(comp_i32, jnp.clip(-src - 1, 0, cap - 1)).astype(jnp.uint8)
    out = jnp.where(i_idx < out_len, out, 0).astype(jnp.uint8)
    return out, err.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("block_size",))
def decode_blocks(
    comp: jax.Array,  # uint8[num_blocks, cap]
    comp_len: jax.Array,  # int32[num_blocks]
    out_len: jax.Array,  # int32[num_blocks]
    *,
    block_size: int = C.DEFAULT_BLOCK_SIZE,
) -> tuple[jax.Array, jax.Array]:
    """Decode a batch of independent blocks.

    Returns ``(out, err)`` with ``out`` uint8[num_blocks, block_size]
    (zero-padded past each block's true length) and ``err`` int32 flags per
    block (0 = ok).
    """
    fn = functools.partial(_decode_one_block, block_size=block_size)
    return jax.vmap(fn)(comp, comp_len, out_len)
