#!/usr/bin/env python3
"""Per-kernel device time of one warm codec call, from a jax.profiler trace.

    python scripts/trace_kernels.py [--block-size 32768] [--blocks 1024]
        [--out bench_out/trace]

Compresses and decompresses ``--blocks`` blocks of seeded XML-like data
through the ``xla`` engine on one device (one batch, synchronous), once to
compile and once under the profiler for each direction. It then sums the
device events of each trace by kernel name and prints, per direction: the
traced call's wall time, the device's busy time (union of kernel
intervals) and idle share over the call, and the kernels that take the
most device time, with the HLO op they came from. A summary JSON lands in
``--out``. Needs an accelerator: the CPU backend writes no device plane.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _stat(event, *keys):
    stats = dict(event.stats)
    for k in keys:
        if k in stats:
            return str(stats[k])
    return ""


def reduce_trace(path: str) -> dict:
    """Kernel totals and busy time of the device planes of one trace."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(path)
    kernels: dict[str, list] = collections.defaultdict(lambda: [0, 0, ""])
    intervals = []
    line_names = []
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = list(plane.lines)
        line_names += [f"{plane.name}/{line.name}" for line in lines]
        # Stream lines carry the kernels as they ran; the "XLA Ops" /
        # "XLA Modules" lines repeat them under HLO names.
        streams = [line for line in lines if line.name.startswith("Stream")]
        for line in streams or [ln for ln in lines if ln.name == "XLA Ops"]:
            for ev in line.events:
                k = kernels[ev.name]
                k[0] += ev.duration_ns
                k[1] += 1
                k[2] = k[2] or _stat(ev, "hlo_op", "tf_op", "long_name")
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    intervals.sort()
    busy, end = 0.0, float("-inf")
    for a, b in intervals:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "device_busy_ms": busy / 1e6,
        "device_span_ms": span / 1e6,
        "kernel_ms_total": sum(v[0] for v in kernels.values()) / 1e6,
        "lines": line_names,
        "kernels": [
            {"name": n, "ms": v[0] / 1e6, "calls": v[1], "hlo": v[2]}
            for n, v in top
        ],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--block-size", type=int, default=32768)
    ap.add_argument("--blocks", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default="bench_out/trace")
    args = ap.parse_args()

    import jax

    from pim_compression_tpu import runtime
    from pim_compression_tpu.runtime.profiling import PhaseTimer
    from pim_compression_tpu.utils import corpus
    from pim_compression_tpu.utils.config import CodecConfig

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX's default backend is {dev.platform}")
    bs, nb = args.block_size, args.blocks
    plain = corpus.xml_like(bs * nb, args.seed)
    cfg = CodecConfig(
        engine="xla", block_size=bs, batch_blocks=nb, mesh_devices=1,
        pipeline_depth=1,
    )
    stream = runtime.compress(plain, cfg)  # compile both directions
    if runtime.decompress(stream, cfg) != plain:
        raise SystemExit("round trip failed")

    out = pathlib.Path(args.out)
    summary = {
        "device": dev.device_kind, "platform": dev.platform,
        "block_size": bs, "blocks": nb, "bytes": len(plain),
        "ratio": 1 - len(stream) / len(plain),
    }
    for direction, call in (
        ("compress", lambda t: runtime.compress(plain, cfg, t)),
        ("decompress", lambda t: runtime.decompress(stream, cfg, t)),
    ):
        tdir = out / direction
        timer = PhaseTimer()
        with jax.profiler.trace(str(tdir)):
            t0 = time.perf_counter()
            call(timer)
            wall = time.perf_counter() - t0
        (path,) = glob.glob(str(tdir / "plugins/profile/*/*.xplane.pb"))
        red = reduce_trace(path)
        red["wall_ms"] = wall * 1e3
        red["phases_ms"] = {k: v * 1e3 for k, v in timer.seconds.items()}
        red["idle_share"] = (
            1 - red["device_busy_ms"] / red["wall_ms"] if wall else None
        )
        summary[direction] = red
        print(
            f"{dev.device_kind} {direction} {nb} x {bs} B: wall "
            f"{red['wall_ms']:.2f} ms, device busy {red['device_busy_ms']:.2f}"
            f" ms (idle share {red['idle_share']:.3f}), kernels "
            f"{red['kernel_ms_total']:.2f} ms; phases "
            + " ".join(f"{k} {v:.2f}" for k, v in red["phases_ms"].items())
        )
        for k in red["kernels"][: args.top]:
            print(f"  {k['ms']:9.3f} ms  x{k['calls']:<4d} {k['name'][:60]}"
                  f"  [{k['hlo'][:90]}]")
    out.mkdir(parents=True, exist_ok=True)
    (out / "summary.json").write_text(json.dumps(summary, indent=1) + "\n")
    print(f"wrote {out / 'summary.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
