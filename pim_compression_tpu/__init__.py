"""pim_compression_tpu — a block-parallel Snappy codec framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
UBC-ECE-Sasha/PIM-compression (a UPMEM processing-in-memory Snappy codec):
the same block-parallel modified-Snappy wire format, with the reference's
DPU×tasklet decomposition replaced by data parallelism over a
``jax.sharding.Mesh`` of devices, speculative fully-data-parallel
decode/encode kernels, and a C++ native host codec as the fast sequential
path.
"""

import os
import pathlib

import jax

from pim_compression_tpu.format import constants, oracle, varint  # noqa: F401

__version__ = "0.1.0"

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def compile_cache_dir() -> str:
    """Where JAX keeps compiled programs across processes:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path, so later runs from the same checkout hit it)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT / ".jax_cache"
    )


# Runs on package import, before any codec call compiles.
jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
