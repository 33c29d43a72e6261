"""Public codec API: ``compress`` / ``decompress`` with engine dispatch.

Engines (SURVEY.md §2.1 parity):
- ``oracle``: pure-Python arbiter (role of the reference host codec as
  correctness oracle).
- ``native``: C++ threaded host codec (fast sequential path).
- ``xla``: vectorized device kernels (pointer-doubling decode, sort-match
  encode) compiled by XLA for the default backend, batched and sharded
  over a 1-D device mesh.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from pim_compression_tpu.format import oracle
from pim_compression_tpu.ops import decode as decode_ops
from pim_compression_tpu.ops import encode as encode_ops
from pim_compression_tpu.parallel import block_sharding, get_mesh, pad_to_multiple
from pim_compression_tpu.runtime import pipeline
from pim_compression_tpu.runtime.profiling import PhaseTimer
from pim_compression_tpu.utils.config import CodecConfig
from pim_compression_tpu.utils.errors import SnappyError, SnappyStatus


def _device_batches(num_blocks: int, config: CodecConfig, mesh) -> tuple[int, int]:
    """(padded_total, batch) — batch is a multiple of the mesh size."""
    nd = mesh.devices.size
    batch = max(nd, pad_to_multiple(min(config.batch_blocks, max(num_blocks, 1)), nd))
    return pad_to_multiple(max(num_blocks, 1), batch), batch


def decompress(
    stream: bytes,
    config: CodecConfig | None = None,
    timer: PhaseTimer | None = None,
) -> bytes | bytearray:
    """Decompress a framed stream (returns a bytes-like object: device
    engines fill one output buffer in place and return it without a
    detaching copy; small results and host engines return bytes)."""
    config = config or CodecConfig()
    timer = timer if timer is not None else PhaseTimer()

    if config.engine == "oracle":
        with timer.phase("kernel"):
            return oracle.decompress(stream)
    if config.engine == "native":
        from pim_compression_tpu import native

        with timer.phase("kernel"):
            return native.decompress(stream, num_threads=config.num_threads)

    with timer.phase("pre"):
        info = pipeline.scan_frames(stream)
        nb = len(info["payload_off"])
        block_size = int(info["block_size"])
        total_len = int(info["total_len"])
        if nb == 0:
            return b""
        mesh = get_mesh(config.mesh_devices)
        padded, batch = _device_batches(nb, config, mesh)
        comp, comp_len, out_len = pipeline.blockize_compressed(
            stream, info, padded, zero_pad=False
        )

    sharding = block_sharding(mesh)
    # The final output buffer, allocated ONCE and written exactly once:
    # each batch drain lands its rows directly at byte offset start *
    # block_size (the fixed geometry the modified format exists to provide,
    # snappy/README.md:5-33), so decode has no separate host assembly pass.
    from pim_compression_tpu import native as _native

    result = (
        _native.uninit_bytearray(total_len)
        if _native.available()
        else bytearray(total_len)
    )
    flat = np.frombuffer(result, dtype=np.uint8)
    # Bounded-depth pipelining: with depth > 1 and several batches, h2d +
    # kernel dispatch of batch i+1 overlap the d2h drain of batch i (JAX
    # async dispatch); the depth bound keeps the number of queued device
    # dispatches small. Sync mode (depth <= 1 or a single batch) blocks at
    # every phase for exact reference-taxonomy timing attribution.
    depth = max(1, config.pipeline_depth)
    sync = depth <= 1 or padded <= batch
    inflight: list[tuple[int, object, object]] = []

    def drain_one():
        start, out, err = inflight.pop(0)
        with timer.phase("d2h"):
            out_h = np.asarray(out)
            err_h = np.asarray(err)
        if config.validate and err_h.any():
            bad = int(np.nonzero(err_h)[0][0]) + start
            raise SnappyError(
                SnappyStatus.INVALID_INPUT,
                f"block {bad} failed validation (flags={int(err_h.max())})",
            )
        take = min(nb, start + batch) - start
        if take > 0:
            lo = start * block_size
            dst = flat[lo : min(lo + take * block_size, total_len)]
            rows = len(dst) // block_size
            dst[: rows * block_size] = out_h[:rows].reshape(-1)
            if rows < take:  # final partial block
                rem = len(dst) - rows * block_size
                dst[rows * block_size :] = out_h[rows, :rem]

    for start in range(0, padded, batch):
        sl = slice(start, start + batch)
        with timer.phase("h2d"):
            comp_d = jax.device_put(comp[sl], sharding)
            clen_d = jax.device_put(comp_len[sl], sharding)
            olen_d = jax.device_put(out_len[sl], sharding)
        with timer.phase("kernel"):
            out, err = decode_ops.decode_blocks(
                comp_d, clen_d, olen_d, block_size=block_size
            )
            if sync:
                jax.block_until_ready(out)
        inflight.append((start, out, err))
        if sync or len(inflight) >= depth:
            drain_one()
    while inflight:
        drain_one()

    with timer.phase("post"):
        return bytes(result) if total_len < (1 << 20) else result


def compress(
    data: bytes,
    config: CodecConfig | None = None,
    timer: PhaseTimer | None = None,
) -> bytes | bytearray:
    """Compress to a framed stream (bytes-like: the device engines'
    assembly fills one output buffer in place and returns it without a
    detaching copy; host engines return bytes)."""
    config = config or CodecConfig()
    timer = timer if timer is not None else PhaseTimer()

    if config.engine == "oracle":
        with timer.phase("kernel"):
            return oracle.compress(data, config.block_size)
    if config.engine == "native":
        from pim_compression_tpu import native

        with timer.phase("kernel"):
            return native.compress(
                data, config.block_size, num_threads=config.num_threads
            )

    block_size = config.block_size
    with timer.phase("pre"):
        nb = (len(data) + block_size - 1) // block_size
        if nb == 0:
            return (
                oracle.compress(b"", block_size)  # header-only stream
            )
        mesh = get_mesh(config.mesh_devices)
        blocks, lens = pipeline.blockize_plain(data, block_size, nb)
        # Incompressible fast path (reference skip-heuristic analog,
        # snappy_compress.c:333-348): near-random blocks divert to raw
        # literal frames on the host; only the rest pay device work.
        raw_mask = (
            pipeline.triage_incompressible(blocks, lens)
            if config.raw_triage
            else np.zeros(nb, dtype=bool)
        )
        dev_idx = np.flatnonzero(~raw_mask)
        ndev = int(dev_idx.size)
        if nb - ndev:
            timer.notes["raw_blocks"] = int(nb - ndev)
        if ndev:
            padded, batch = _device_batches(ndev, config, mesh)
            dblocks = np.zeros((padded, block_size), dtype=np.uint8)
            dblocks[:ndev] = blocks[dev_idx]
            dlens = np.zeros(padded, dtype=np.int32)
            dlens[:ndev] = lens[dev_idx]
        else:
            padded = batch = 0

    cap = decode_ops.padded_capacity(block_size)
    sharding = block_sharding(mesh)
    comp_np = np.empty((nb, cap), dtype=np.uint8)
    sizes_np = np.empty(nb, dtype=np.int32)
    # Same bounded-depth pipelining scheme as decompress (see above).
    depth = max(1, config.pipeline_depth)
    sync = depth <= 1 or padded <= batch
    inflight: list[tuple[int, object, object, object]] = []

    def drain_one():
        start, comp, sizes, vbad = inflight.pop(0)
        with timer.phase("d2h"):
            comp_h = np.asarray(comp)
            sizes_h = np.asarray(sizes)
            vbad_h = np.asarray(vbad) if vbad is not None else None
        take = min(ndev, start + batch) - start
        if take > 0:
            rows = dev_idx[start : start + take]
            comp_np[rows] = comp_h[:take]
            sizes_np[rows] = sizes_h[:take]
            if vbad_h is not None and int(vbad_h[:take].sum()):
                bad = rows[np.flatnonzero(vbad_h[:take])]
                raise SnappyError(
                    SnappyStatus.INVALID_INPUT,
                    f"on-device verify failed for blocks {bad[:8].tolist()}",
                )

    # batch == 0 when the triage diverted EVERY block (pure-random input):
    # zero device dispatches, straight to the raw-frame fill + assembly.
    for start in range(0, padded, batch) if batch else ():
        sl = slice(start, start + batch)
        with timer.phase("h2d"):
            blocks_d = jax.device_put(dblocks[sl], sharding)
            lens_d = jax.device_put(dlens[sl], sharding)
        with timer.phase("kernel"):
            comp, sizes = encode_ops.encode_blocks(
                blocks_d, lens_d, block_size=block_size
            )
            vbad = None
            if config.verify:
                # On-device decode-after-encode (the reference harness's
                # cmp check, snappy/Makefile:54-60, moved onto the chip):
                # decode the freshly encoded blocks with the production
                # decoder and compare against the inputs, all on device;
                # only a per-block flag word comes back.
                out_v, err_v = decode_ops.decode_blocks(
                    comp, sizes, lens_d, block_size=block_size
                )
                rows_v = jnp.arange(block_size, dtype=jnp.int32)[None, :]
                mism = jnp.any(
                    (out_v != blocks_d) & (rows_v < lens_d[:, None]), axis=1
                )
                vbad = mism.astype(jnp.int32) | (err_v != 0).astype(jnp.int32)
            if sync:
                jax.block_until_ready(comp)
        inflight.append((start, comp, sizes, vbad))
        if sync or len(inflight) >= depth:
            drain_one()
    while inflight:
        drain_one()

    with timer.phase("post"):
        if nb - ndev:
            pipeline.raw_literal_frames(
                blocks, lens, comp_np, sizes_np, np.flatnonzero(raw_mask)
            )
        if config.validate and int(sizes_np.max(initial=0)) > cap:
            raise SnappyError(SnappyStatus.BUFFER_TOO_SMALL, "encoder overflow")
        return pipeline.assemble_compressed(
            comp_np, sizes_np, len(data), block_size, nb
        )
