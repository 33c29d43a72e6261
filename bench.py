"""Benchmark entry point (driver contract: print ONE JSON line).

Compresses and decompresses seeded XML-like data
(``pim_compression_tpu.utils.corpus.xml_like``) through the ``xla`` engine
on JAX's default backend, in this process, verifies the round trip, and
reports GB/s with ``vs_baseline`` = speedup over the native C++ host codec
on one thread (the reference publishes no absolute numbers, BASELINE.md).
The JSON line names the device the numbers were taken on.

Env knobs: PIM_BENCH_BLOCK (block size, default 32768 — the reference's
own operating point, dpu_snappy.c:100), PIM_BENCH_MB (input MiB, default
32: one 1024-block batch at 32 KB), PIM_BENCH_ITERS (timed runs, default 2).
"""

from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    import jax

    from pim_compression_tpu import native, runtime
    from pim_compression_tpu.runtime.profiling import PhaseTimer
    from pim_compression_tpu.utils import corpus
    from pim_compression_tpu.utils.config import CodecConfig

    block = int(os.environ.get("PIM_BENCH_BLOCK", "32768"))
    mib = float(os.environ.get("PIM_BENCH_MB", "32"))
    iters = int(os.environ.get("PIM_BENCH_ITERS", "2"))
    plain = corpus.xml_like(int(mib * (1 << 20)), seed=0)
    dev = jax.devices()[0]

    # Baseline: the native host codec on one thread.
    t0 = time.perf_counter()
    bstream = native.compress(plain, block, num_threads=1)
    if native.decompress(bstream, num_threads=1) != plain:
        raise SystemExit("native codec round trip failed")
    base = 2 * len(plain) / (time.perf_counter() - t0) / 1e9

    cfg = CodecConfig(engine="xla", block_size=block)
    t0 = time.perf_counter()
    stream = runtime.compress(plain, cfg)  # first call compiles
    if runtime.decompress(stream, cfg) != plain:
        raise SystemExit("bit-exactness failure")
    compile_s = time.perf_counter() - t0

    enc_s = dec_s = 0.0
    for _ in range(iters):
        t = PhaseTimer()
        stream = runtime.compress(plain, cfg, t)
        enc_s += t.total
        t = PhaseTimer()
        out = runtime.decompress(stream, cfg, t)
        dec_s += t.total
    if out != plain:
        raise SystemExit("bit-exactness failure")
    n = len(plain) * iters
    value = 2 * n / (enc_s + dec_s) / 1e9
    print(
        json.dumps(
            {
                "metric": (
                    f"encode+decode GB/s (xla engine, bs={block}, "
                    f"xml-like {mib:g} MiB)"
                ),
                "value": round(value, 4),
                "unit": "GB/s",
                "vs_baseline": round(value / base, 3),
                "ratio": round(1 - len(stream) / len(plain), 4),
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    print(
        f"# {dev.device_kind}: enc {n / enc_s / 1e9:.4f} / dec "
        f"{n / dec_s / 1e9:.4f} GB/s; native one-thread {base:.3f} GB/s; "
        f"first calls (compile) {compile_s:.1f}s",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
