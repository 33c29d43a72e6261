"""Device mesh + sharding for the block axis.

The reference's two-level decomposition (blocks -> DPUs -> tasklets,
``snappy_compress.c:494-520``) collapses to a 1-D data-parallel device mesh
over the block axis: blocks are independent by format design, so XLA
partitions the vmapped kernels with zero communication. Topology is a
runtime property (``jax.devices()``), not a compile-time constant like the
reference's ``NR_DPUS``/``NR_TASKLETS`` (``Makefile:10-12``).

Multi-host: under ``jax.distributed``, each process feeds its local shard of
the block axis (``jax.make_array_from_process_local_data``); the only
cross-host data movement in the whole codec is the host-side concatenation
of per-host output segments — the device-mesh analog of the reference's
ordered per-DPU fwrite (``snappy_compress.c:697-703``).
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BLOCK_AXIS = "blocks"


@functools.lru_cache(maxsize=None)
def get_mesh(num_devices: int | None = None) -> Mesh:
    """1-D mesh over the first ``num_devices`` LOCAL devices (default: all).

    Local, not global: under ``jax.distributed`` the cross-process split is
    ownership of block ranges (``distributed.process_block_range``), and each
    process codecs its range on its own addressable devices — a global-device
    mesh would make the runtime ``device_put`` onto non-addressable devices.
    """
    devices = jax.local_devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(devices, (BLOCK_AXIS,))


def block_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (block) axis across the mesh."""
    return NamedSharding(mesh, P(BLOCK_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m
