#!/usr/bin/env python3
"""Host pre/post phase throughput.

The host-side blockize/assembly must outrun the device kernels, or it
becomes the Amdahl term (it did when it ran as single-thread NumPy fancy
indexing). This bench measures the native (C++ ParallelFor memcpy) host
phases in steady state — pooled, page-warm staging, exactly how the
runtime drives them — on seeded XML-like data.

    python scripts/host_phase_bench.py [--mb 32] [--out bench_out/host_phases.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=32)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument(
        "--out", default="bench_out/host_phases.json"
    )
    args = ap.parse_args()

    from pim_compression_tpu import native
    from pim_compression_tpu.runtime import pipeline
    from pim_compression_tpu.utils import corpus

    plain = corpus.xml_like(args.mb * 1_000_000, seed=0)
    stream = native.compress(plain)
    info = native.scan_frames(stream)
    nb = len(info["payload_off"])
    pad = -(-nb // 1024) * 1024
    bs = int(info["block_size"])

    comp, cl, _ = pipeline.blockize_compressed(stream, info, pad)
    blocks, _ = pipeline.blockize_plain(plain, bs, pad)

    cases = [
        # decode pre: framed payloads -> padded slots (zero_pad=False is
        # the runtime's configuration — the decoder masks >= comp_len)
        ("decode_pre_blockize", len(stream),
         lambda: pipeline.blockize_compressed(stream, info, pad, zero_pad=False)),
        # encode post: padded payloads -> framed stream
        ("encode_post_assemble", len(stream),
         lambda: pipeline.assemble_compressed(
             comp, cl, info["total_len"], bs, nb)),
        # encode pre: plain bytes -> padded block slots
        ("encode_pre_blockize", len(plain),
         lambda: pipeline.blockize_plain(plain, bs, pad)),
        # decode post: the runtime drains device batches DIRECTLY into the
        # final output buffer (runtime/api.py decompress), so its post
        # phase is a per-batch parallel copy; measured here as one pass.
        ("decode_post_drain_copy", len(plain),
         lambda: pipeline.assemble_decompressed(blocks[:nb], len(plain))),
    ]

    results = {"input_mb": args.mb, "blocks": nb, "block_size": bs}
    for name, nbytes, fn in cases:
        fn(), fn()  # warm the pool + pages
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        dt = (time.perf_counter() - t0) / args.reps
        results[name + "_gbps"] = round(nbytes / dt / 1e9, 2)
        print(f"{name}: {nbytes / dt / 1e9:.2f} GB/s")

    outp = REPO / args.out
    outp.parent.mkdir(parents=True, exist_ok=True)
    outp.write_text(json.dumps(results, indent=1) + "\n")
    print(f"wrote {outp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
