"""Multi-host orchestration (SURVEY.md §5.8: the reference is single-host —
one process drives all DPU ranks; this framework scales across hosts with
``jax.distributed``).

Design: the file's block axis is split into contiguous per-process ranges
(the host-level analog of the reference's contiguous blocks-per-DPU
assignment, ``snappy_compress.c:494-520``). Each process codecs its own
range on its local devices; the only cross-host traffic is

- compress: an all-gather of per-process compressed segment sizes (over
  DCN, a few bytes per process) to compute global file offsets, then
  per-process ordered writes at those offsets — the multi-host translation
  of the reference's ordered per-tasklet fwrite (``snappy_compress.c:697``).
- decompress: nothing at all — decompressed geometry is static (block i at
  ``i * block_size``), so every process writes its slice independently.

All functions degrade to plain single-process behavior when
``jax.process_count() == 1``, which is how the CPU test mesh exercises them.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

import numpy as np
import jax

from pim_compression_tpu.runtime import api as _api
from pim_compression_tpu.runtime.profiling import PhaseTimer
from pim_compression_tpu.utils.config import CodecConfig


def _count_gpus() -> int:
    """Cards on this host, counted without starting a JAX backend (which
    must not start before ``jax.distributed.initialize``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-L"], capture_output=True, text=True, check=True
        ).stdout
    except (OSError, subprocess.CalledProcessError):
        return 0
    return sum(line.startswith("GPU ") for line in out.splitlines())


def local_device_ids(local_rank: int, num_gpus: int) -> list[int] | None:
    """The one card a process drives: the card numbered by its local rank.

    None on a host without cards (each process keeps its CPU backend).
    Without this every process would reserve memory on every card of the
    host, so a rank with no card of its own fails here, loudly."""
    if num_gpus == 0:
        return None
    if not 0 <= local_rank < num_gpus:
        raise RuntimeError(
            f"local rank {local_rank} has no card of its own: this host has "
            f"{num_gpus}; run at most one process per card"
        )
    return [local_rank]


def maybe_initialize(num_gpus: int | None = None) -> bool:
    """Join a multi-process job when ``PIM_NUM_PROCESSES`` > 1.

    The job is described by ``PIM_NUM_PROCESSES``, ``PIM_PROCESS_ID``,
    ``PIM_COORDINATOR`` (``host:port`` of process 0) and ``PIM_LOCAL_RANK``
    (this process's index on its host; defaults to ``PIM_PROCESS_ID``,
    i.e. one host). Call before any other JAX work. Returns whether it
    initialized.
    """
    nproc = int(os.environ.get("PIM_NUM_PROCESSES", "1"))
    if nproc <= 1 or jax.distributed.is_initialized():
        return False
    pid = int(os.environ["PIM_PROCESS_ID"])
    local_rank = int(os.environ.get("PIM_LOCAL_RANK", pid))
    jax.distributed.initialize(
        coordinator_address=os.environ["PIM_COORDINATOR"],
        num_processes=nproc,
        process_id=pid,
        local_device_ids=local_device_ids(
            local_rank, _count_gpus() if num_gpus is None else num_gpus
        ),
    )
    return True


def process_block_range(num_blocks: int) -> tuple[int, int]:
    """Contiguous block range owned by this process."""
    nproc = jax.process_count()
    pid = jax.process_index()
    per = (num_blocks + nproc - 1) // nproc
    lo = min(pid * per, num_blocks)
    return lo, min(lo + per, num_blocks)


def _allgather_sizes(local_size: int) -> np.ndarray:
    """All processes learn every process's segment size (DCN all-gather)."""
    if jax.process_count() == 1:
        return np.array([local_size], dtype=np.int64)
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(np.array([local_size], np.int64))
    ).reshape(-1)


def compress_to_file(
    data_path: str | pathlib.Path,
    out_path: str | pathlib.Path,
    config: CodecConfig | None = None,
    timer: PhaseTimer | None = None,
) -> dict:
    """Compress a file cooperatively across all processes.

    Each process reads only its own block range, compresses it locally, and
    pwrites its segment at the globally agreed offset. Returns stats.
    """
    config = config or CodecConfig()
    timer = timer if timer is not None else PhaseTimer()
    data_path = pathlib.Path(data_path)
    bs = config.block_size

    total = data_path.stat().st_size
    num_blocks = (total + bs - 1) // bs
    lo, hi = process_block_range(num_blocks)

    with timer.phase("pre"):
        with open(data_path, "rb") as f:
            f.seek(lo * bs)
            local = f.read((hi - lo) * bs)

    # Local segment compressed as a headerless run of framed blocks.
    segment = _api.compress(local, config, timer) if local else b""
    if segment:
        # Strip the local header (varints) — the global header is written by
        # process 0; frames are position-independent.
        from pim_compression_tpu.format.varint import decode_varint32

        _, pos = decode_varint32(segment, 0)
        _, pos = decode_varint32(segment, pos)
        segment = segment[pos:]

    from pim_compression_tpu.format.varint import encode_varint32

    header = encode_varint32(total) + encode_varint32(bs)
    sizes = _allgather_sizes(len(segment))
    my_off = len(header) + int(sizes[: jax.process_index()].sum())
    file_size = len(header) + int(sizes.sum())

    out_path = pathlib.Path(out_path)
    if jax.process_index() == 0:
        with open(out_path, "wb") as f:
            f.truncate(file_size)
            f.write(header)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        # Barrier wait (rank 0's header write) stays OUTSIDE the timed
        # phases: it measures the slowest peer, not this process's codec.
        multihost_utils.sync_global_devices("pim_compress_header")
    with timer.phase("post"):
        with open(out_path, "r+b") as f:
            f.seek(my_off)
            f.write(segment)

    return {
        "total": total,
        "compressed": file_size,
        "blocks": num_blocks,
        "process_blocks": (lo, hi),
    }


def _walk_frame_table(stream_path: pathlib.Path) -> dict:
    """Frame geometry by seeking over the 4-byte frame headers only.

    Per-process memory stays O(#frames), never O(file): each frame header
    encodes the payload size, so the walk seeks payload bytes instead of
    reading them (a whole-stream read would defeat range ownership on large
    files). Mirrors the native scanner's traversal
    (``snappy_native.cpp`` ScanFrames) including the trailing-frame rule.
    """
    from pim_compression_tpu.format.varint import read_varint32_stream
    from pim_compression_tpu.utils.errors import SnappyError, SnappyStatus

    offs: list[int] = []
    sizes: list[int] = []
    outs: list[int] = []
    with open(stream_path, "rb") as f:
        total, bs = read_varint32_stream(f), read_varint32_stream(f)
        file_size = stream_path.stat().st_size
        out_off = 0
        while True:
            pos = f.tell()
            hdr = f.read(4)
            if not hdr:
                break
            if len(hdr) < 4 or out_off >= total:
                raise SnappyError(
                    SnappyStatus.INVALID_INPUT, "bad frame trailer"
                )
            psize = int.from_bytes(hdr, "little")
            if pos + 4 + psize > file_size:
                raise SnappyError(
                    SnappyStatus.INVALID_INPUT, "frame exceeds stream"
                )
            out_size = min(bs, total - out_off)
            offs.append(pos + 4)
            sizes.append(psize)
            outs.append(out_size)
            out_off += out_size
            f.seek(psize, 1)
        if out_off != total:
            raise SnappyError(
                SnappyStatus.INVALID_INPUT, "stream shorter than header claims"
            )
    return {
        "total_len": total,
        "block_size": bs,
        "payload_off": offs,
        "payload_size": sizes,
        "out_size": outs,
    }


def decompress_to_file(
    stream_path: str | pathlib.Path,
    out_path: str | pathlib.Path,
    config: CodecConfig | None = None,
    timer: PhaseTimer | None = None,
) -> dict:
    """Decompress a file cooperatively: zero cross-host communication.

    Each process reads ONLY the byte range of its owned frames (header walk
    + one seek/read), so peak RSS per process tracks its segment size, not
    the file size."""
    config = config or CodecConfig()
    timer = timer if timer is not None else PhaseTimer()
    stream_path = pathlib.Path(stream_path)

    with timer.phase("pre"):
        info = _walk_frame_table(stream_path)
        nb = len(info["payload_off"])
        bs = int(info["block_size"])
        total = int(info["total_len"])
        lo, hi = process_block_range(nb)

    # Rebuild a local stream containing only this process's frames.
    from pim_compression_tpu.format.varint import encode_varint32

    if hi > lo:
        first = int(info["payload_off"][lo]) - 4
        last = int(info["payload_off"][hi - 1]) + int(info["payload_size"][hi - 1])
        local_total = int(
            sum(int(info["out_size"][i]) for i in range(lo, hi))
        )
        with open(stream_path, "rb") as f:
            f.seek(first)
            owned = f.read(last - first)
        local_stream = (
            encode_varint32(local_total) + encode_varint32(bs) + owned
        )
        local_out = _api.decompress(local_stream, config, timer)
    else:
        local_out = b""

    out_path = pathlib.Path(out_path)
    if jax.process_index() == 0:
        with open(out_path, "wb") as f:
            f.truncate(total)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        # Barrier wait stays OUTSIDE the timed phases (see compress).
        multihost_utils.sync_global_devices("pim_decompress_alloc")
    with timer.phase("post"):
        with open(out_path, "r+b") as f:
            f.seek(lo * bs)
            f.write(local_out)

    return {"total": total, "blocks": nb, "process_blocks": (lo, hi)}
