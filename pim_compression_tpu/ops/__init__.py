"""Device compute kernels (XLA): block decode and encode."""

from pim_compression_tpu.ops import decode, encode, primitives  # noqa: F401
