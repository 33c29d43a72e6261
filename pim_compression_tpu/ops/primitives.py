"""Shared data-parallel primitives for the codec kernels.

Everything here is pure XLA (gathers, cumsums, selects — no scatter in the
hot paths and no data-dependent Python control flow), so the same code runs
on the GPU and on the CPU test mesh alike.

The key primitive family is *pointer doubling* over a functional successor
``next: [0, n] -> [0, n]``. The reference resolves both its tag chains and
its copy chains byte-serially (``snappy_decompress.c:232-286``); on a vector
machine we instead square the successor function log2(n) times, which turns
every serial chain walk into a fixed number of batched gathers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def ceil_log2(n: int) -> int:
    return max(1, (int(n) - 1).bit_length())


def orbit_positions(next_fn: jax.Array, num_steps: int) -> jax.Array:
    """Positions visited by iterating ``next_fn`` from node 0.

    ``next_fn`` is an int32 array mapping node -> successor (terminal nodes
    must self-loop). Returns ``pos`` with ``pos[j] = next_fn^j(0)`` for
    ``j in [0, num_steps)``, computed with one gather per bit of ``j``
    (powers of one function commute, so bits can be applied in any order).
    """
    steps = jnp.arange(num_steps, dtype=jnp.int32)
    pos0 = jnp.zeros((num_steps,), dtype=jnp.int32)

    def body(bit, carry):
        pos, jump = carry
        pos = jnp.where((steps >> bit) & 1 == 1, jnp.take(jump, pos), pos)
        return pos, jnp.take(jump, jump)

    pos, _ = jax.lax.fori_loop(0, ceil_log2(num_steps), body, (pos0, next_fn))
    return pos


def resolve_copy_chains(src: jax.Array, num_rounds: int) -> jax.Array:
    """Resolve backreference chains by pointer doubling.

    ``src[i] >= 0`` means "output position i copies from output position
    src[i]" (strictly src[i] < i for valid streams); ``src[i] < 0`` encodes a
    terminal (literal) source as ``-(index)-1``. Rounds are adaptive: each
    doubling squares the resolved chain length, and real streams resolve in
    2-5 rounds, so the loop exits as soon as no pointers remain (up to the
    ``num_rounds`` = log2(n) worst case). Invalid self-loops (src[i] == i)
    stay non-negative, hit the round cap, and are caught by the caller's
    error flags — no possibility of divergence.
    """
    n = src.shape[-1]

    def cond(carry):
        r, s = carry
        return (r < num_rounds) & jnp.any(s >= 0)

    def body(carry):
        r, s = carry
        hop = jnp.take(s, jnp.clip(s, 0, n - 1), axis=-1)
        return r + 1, jnp.where(s >= 0, hop, s)

    _, src = jax.lax.while_loop(cond, body, (jnp.int32(0), src))
    return src


def exclusive_cumsum(x: jax.Array) -> jax.Array:
    return jnp.cumsum(x, axis=-1) - x


def covering_element(starts: jax.Array, num_out: int) -> jax.Array:
    """For each output index i in [0, num_out), the index j of the covering
    element: max{j : starts[j] <= i} with ``starts`` nondecreasing.

    This is the vectorized replacement for "which element am I inside" that
    the serial decoders answer implicitly by walking the stream.
    """
    idx = jnp.arange(num_out, dtype=jnp.int32)
    j = jnp.searchsorted(starts, idx, side="right").astype(jnp.int32) - 1
    return jnp.maximum(j, 0)
