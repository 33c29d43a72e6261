"""Single runtime configuration (role of the reference's two-tier flag
system, SURVEY.md §5.6 — but with no compile-time topology: mesh size comes
from ``jax.devices()`` at runtime)."""

from __future__ import annotations

import dataclasses

from pim_compression_tpu.format import constants as C

ENGINES = ("xla", "native", "oracle")


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Knobs for the codec paths.

    block_size: decompressed bytes per independent block (reference default
        32 KB, max 64 KB — ``dpu_snappy.c:100``).
    batch_blocks: blocks per device dispatch (the analog of
        ``blocks_per_dpu``); padded to a multiple of the mesh size.
    engine: "xla" (vectorized device kernels), "native" (C++ host codec),
        "oracle" (pure Python).
    num_threads: host-codec thread fan-out (0 = all CPUs).
    """

    block_size: int = C.DEFAULT_BLOCK_SIZE
    batch_blocks: int = 1024
    engine: str = "xla"
    num_threads: int = 0
    validate: bool = True
    # Incompressible fast path (the reference's skip heuristic,
    # snappy_compress.c:333-348, lifted to whole blocks): host triage
    # diverts near-random blocks (zero sampled duplicate 4-grams AND
    # near-maximal byte entropy — conservative: snappy cannot compress a
    # block with no repeated 4-gram) to raw literal frames with ZERO device
    # work. Text corpora are never diverted (their streams are unchanged).
    raw_triage: bool = True
    # On-device encode verification (the reference harness's cmp check,
    # snappy/Makefile:54-60, moved onto the device): decode every freshly
    # encoded batch with the production decoder ON DEVICE and compare
    # against the input blocks; any mismatch or decoder error flag raises
    # SnappyError before assembly. Costs one decode pass per batch.
    verify: bool = False
    # Device-batch pipelining: up to this many batches in flight; h2d+kernel
    # of batch i+1 overlap d2h of batch i. <=1 = fully synchronous batches
    # (exact per-phase timing attribution, the reference's phase taxonomy).
    pipeline_depth: int = 2
    # Devices in the 1-D block mesh (None = all local devices). The scaling
    # sweep's analog of the reference's NR_DPUS axis
    # (snappy/scripts/asplos21/dpu_tasklet_tradeoff.py:10).
    mesh_devices: int | None = None

    def __post_init__(self) -> None:
        if not 0 < self.block_size <= C.MAX_BLOCK_SIZE:
            raise ValueError(f"block_size must be in (0, {C.MAX_BLOCK_SIZE}]")
        if self.engine not in ENGINES:
            raise ValueError(
                f"unknown engine {self.engine!r} (expected one of {ENGINES})"
            )
