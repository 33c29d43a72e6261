"""Command-line driver (role of the reference CLI, ``dpu_snappy.c:93-236``).

Flag-compatible with the reference binary:

    -d          use the device (xla) engine        [reference: use DPUs]
    -c          compress (default is decompress)
    -b <size>   decompressed block size (default 32768)
    -i <file>   input file (required)
    -o <file>   output file (default "output.txt")

Extensions: ``--engine {oracle,native,xla}`` overrides ``-d``,
``--threads`` for the native engine, ``--json`` for structured metrics.
The human output preserves the reference's stdout contract (its benchmark
scripts parse "Compression ratio:" and per-phase lines — SURVEY.md §5.5):
ratio is printed as ``1 - compressed/original`` exactly like
``dpu_snappy.c:212-219``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pim-compression-tpu",
        description="Block-parallel Snappy codec for JAX devices",
    )
    p.add_argument("-d", action="store_true", help="use the device (xla) engine")
    p.add_argument("-c", action="store_true", help="compress instead of decompress")
    p.add_argument("-b", type=int, default=None, metavar="SIZE", help="block size")
    p.add_argument("-i", required=True, metavar="IN", help="input file")
    p.add_argument("-o", default="output.txt", metavar="OUT", help="output file")
    p.add_argument(
        "--engine",
        choices=["oracle", "native", "xla"],
        default=None,
        help="codec engine (overrides -d; default: native, or xla with -d)",
    )
    p.add_argument("--threads", type=int, default=0, help="native engine threads")
    p.add_argument(
        "--verify", action="store_true",
        help="on-device decode-after-encode verification: every encoded "
        "batch is decoded by the production decoder on the device and "
        "compared against the input before assembly (the reference "
        "harness's cmp check, on-chip)",
    )
    p.add_argument(
        "--no-triage", action="store_true",
        help="disable the incompressible fast path (host triage that "
        "diverts near-random blocks to raw literal frames with zero "
        "device work)",
    )
    p.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="device batches in flight (1 = synchronous phases, exact "
        "per-phase timing breakdown)",
    )
    p.add_argument("--json", action="store_true", help="emit structured metrics")
    p.add_argument(
        "--profile",
        metavar="DIR",
        default=None,
        help="capture a jax.profiler trace of the codec run into DIR "
        "(device-level tracing, the analog of the reference's per-tasklet "
        "cycle counters)",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from pim_compression_tpu import runtime
    from pim_compression_tpu.format import constants as C
    from pim_compression_tpu.format.varint import decode_varint32
    from pim_compression_tpu.runtime.profiling import PhaseTimer
    from pim_compression_tpu.utils.config import CodecConfig
    from pim_compression_tpu.utils.errors import SnappyError

    engine = args.engine or ("xla" if args.d else "native")
    block_size = args.b or C.DEFAULT_BLOCK_SIZE
    try:
        config = CodecConfig(
            block_size=block_size, engine=engine, num_threads=args.threads,
            pipeline_depth=args.pipeline_depth, raw_triage=not args.no_triage,
            verify=args.verify,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    in_path = pathlib.Path(args.i)
    if not in_path.is_file():
        print(f"error: input file not found: {in_path}", file=sys.stderr)
        return 2
    data = in_path.read_bytes()

    timer = PhaseTimer()
    profiler_ctx = None
    if args.profile:
        import jax

        profiler_ctx = jax.profiler.trace(args.profile)
        profiler_ctx.__enter__()
    try:
        if args.c:
            result = runtime.compress(data, config, timer)
            original, compressed = len(data), len(result)
        else:
            result = runtime.decompress(data, config, timer)
            original, compressed = len(result), len(data)
            try:  # report the stream's own block size, not the -b default
                _, pos = decode_varint32(data, 0)
                block_size, _ = decode_varint32(data, pos)
            except ValueError:
                pass
    except (SnappyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if profiler_ctx is not None:
            profiler_ctx.__exit__(None, None, None)
            print(f"profiler trace written to {args.profile}")

    pathlib.Path(args.o).write_bytes(result)

    mode = "compression" if args.c else "decompression"
    print(f"Using {engine} engine for {mode} (block size {block_size})")
    if original:
        # Ratio formula per the reference CLI (dpu_snappy.c:212-219).
        ratio = 1.0 - compressed / original
        print(f"Compression ratio: {ratio:.6f}")
    print(timer.human())
    if args.json:
        print(
            timer.json(
                engine=engine,
                mode=mode,
                block_size=block_size,
                original_bytes=original,
                compressed_bytes=compressed,
            )
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
