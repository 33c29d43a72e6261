#!/usr/bin/env python3
"""Benchmark sweep driver (role of the reference's asplos21/run_tests.py).

The reference rebuilds its binaries per (NR_DPUS, NR_TASKLETS) point and
sweeps the corpus; topology here is a runtime property, so the sweep axes
are engines x block sizes x corpus files (the seeded corpus of
``pim_compression_tpu.utils.corpus``). Results land in a CSV consumed by
the chart scripts.

Sweep axes (each optional, comma-separated):
  --engines       native,xla,oracle
  --block-sizes   4096,32768
  --mesh-sizes    1,2,4,8                (devices in the block mesh — the
                                          NR_DPUS axis analog; sweepable on
                                          the 8-device CPU mesh)
  --synth-sizes   10,25,84               (MB; synthesizes the reference's
                                          large-corpus tier,
                                          reference/README.md:8-19, for the
                                          speedup-vs-filesize chart)

Usage:
    python scripts/run_benchmarks.py [--engines native,xla] [--files xml]
        [--block-sizes 4096,32768] [--iters 3] [--out results.csv]
"""

from __future__ import annotations

import argparse
import csv
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engines", default="native,xla")
    ap.add_argument("--files", default=None)
    ap.add_argument("--block-sizes", default="32768")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0, help="corpus seed")
    ap.add_argument("--mesh-sizes", default="")
    ap.add_argument(
        "--synth-sizes", default="",
        help="comma-separated MB sizes; adds synthetic large-tier inputs",
    )
    ap.add_argument("--out", default="bench_results.csv")
    args = ap.parse_args()

    from pim_compression_tpu import runtime
    from pim_compression_tpu.runtime.profiling import PHASES, PhaseTimer
    from pim_compression_tpu.utils import corpus
    from pim_compression_tpu.utils.config import CodecConfig

    engines = args.engines.split(",")
    block_sizes = [int(b) for b in args.block_sizes.split(",")]
    mesh_sizes = (
        [int(m) for m in args.mesh_sizes.split(",")] if args.mesh_sizes else [None]
    )
    names = args.files.split(",") if args.files else corpus.NAMES
    files = [(name, corpus.generate(name, args.seed)) for name in names]
    # The reference's large-corpus tier (dickens 10 MB .. spamfile 84 MB,
    # reference/README.md:8-19), as seeded text of the requested sizes.
    for mb in (int(s) for s in args.synth_sizes.split(",") if s):
        files.append(
            (f"synth{mb}mb", corpus.text_like(mb * 1_000_000, args.seed))
        )

    rows = []
    for name, plain in files:
        for engine in engines:
            for bs, meshn in (
                (b, d) for b in block_sizes for d in mesh_sizes
            ):
                cfg = CodecConfig(
                    block_size=bs, engine=engine, num_threads=args.threads,
                    mesh_devices=meshn,
                )
                # Warm-up (compile) round
                stream = runtime.compress(plain, cfg)
                out = runtime.decompress(stream, cfg)
                assert out == plain, f"round-trip failure: {name}/{engine}/{bs}"

                for direction in ("compress", "decompress"):
                    timer = PhaseTimer()
                    t0 = time.perf_counter()
                    for _ in range(args.iters):
                        if direction == "compress":
                            stream = runtime.compress(plain, cfg, timer)
                        else:
                            runtime.decompress(stream, cfg, timer)
                    wall = (time.perf_counter() - t0) / args.iters
                    row = {
                        "file": name,
                        "engine": engine,
                        "block_size": bs,
                        "mesh_devices": meshn if meshn else "",
                        "direction": direction,
                        "bytes": len(plain),
                        "compressed_bytes": len(stream),
                        "ratio": 1 - len(stream) / len(plain),
                        "wall_s": wall,
                        "gbps": len(plain) / wall / 1e9,
                    }
                    for p in PHASES:
                        row[f"{p}_s"] = timer.seconds.get(p, 0.0) / args.iters
                    rows.append(row)
                    print(
                        f"{name:10s} {engine:7s} bs={bs:<6d} "
                        f"mesh={meshn or 'all':4} "
                        f"{direction:10s} "
                        f"{row['gbps']:.3f} GB/s ratio={row['ratio']:.3f}"
                    )

    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {len(rows)} rows to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
