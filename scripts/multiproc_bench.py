#!/usr/bin/env python3
"""Multi-process scaling benchmark (BASELINE.md's >= 2 hosts axis).

Runs the production cooperative codec (`distributed.compress_to_file` /
`decompress_to_file`) across N real OS processes under a live
`jax.distributed` coordinator — the process-level reality of the
reference's DPU-rank fan-out (snappy_compress.c:553-618) — and reports
wall time, aggregate GB/s, scaling efficiency vs N=1 (each process pinned
to one codec thread so processes are the only parallelism axis), and per-process
peak RSS (which must track the owned segment, not the file: the range-
read decompress path). Single-host stand-in for multi-host: each process
is a "host" with its own block range; the collective layer (size
all-gather, barriers) is the real gloo backend, not a mock.

    python scripts/multiproc_bench.py [--procs 1,2,4] [--mb 48]
        [--engine native] [--out bench_out/sweep_procs.csv]

Engine rows merge into one CSV (keyed procs/engine/block_size). Workers
run on the CPU backend (``JAX_PLATFORMS=cpu``), so ``--engine xla`` rows
show coordination and correctness of the device engine under real
multi-process gloo, not device speed; the native rows measure how the
codec work divides across processes (see cpu_eff).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def synth_input(mb: int) -> bytes:
    from pim_compression_tpu.utils import corpus

    return corpus.text_like(mb * 1_000_000, seed=0)


def run_n(nproc: int, src: pathlib.Path, tmp: pathlib.Path, engine: str,
          block_size: int, pin: bool = True) -> dict:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_NUM_CPU_DEVICES", None)
    if pin:
        # One codec thread per process (argv num_threads=1): cap the
        # ambient pools too so codec time measures the codec, not Eigen/
        # OpenMP worker churn. Do NOT taskset-pin to single cores: the
        # process's own background threads (gloo heartbeat, JAX pools)
        # then compete with the codec thread for that one core, which
        # measured the N=1 baseline 40-70% slow and masqueraded as
        # super-linear scaling.
        env["OMP_NUM_THREADS"] = "1"
        env["OPENBLAS_NUM_THREADS"] = "1"
        if engine not in ("native", "oracle"):
            # Device-engine workers run the kernels INSIDE XLA:CPU, whose
            # Eigen intra-op pool defaults to all cores — N workers then
            # oversubscribe the VM and fake sub-linear scaling. One
            # compute thread per process keeps processes the only
            # parallelism axis (same discipline as num_threads=1 for the
            # native codec).
            env["XLA_FLAGS"] = (
                env.get("XLA_FLAGS", "")
                + " --xla_cpu_multi_thread_eigen=false"
            ).strip()
    out = tmp / f"n{nproc}.snappy"
    dec = tmp / f"n{nproc}.out"
    worker = REPO / "tests" / "multiproc_worker.py"
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), str(nproc), str(port),
             str(src), str(out), str(dec), str(block_size), engine, "1"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(nproc)
    ]
    stats = []
    for p in procs:
        so, se = p.communicate(timeout=1200)
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{se[-2000:]}")
        stats.append(json.loads(so.strip().splitlines()[-1]))
    wall = time.perf_counter() - t0
    assert dec.read_bytes() == src.read_bytes(), "round-trip mismatch"
    n = src.stat().st_size
    # Codec time = max over processes of summed phase seconds (the
    # reference's max-over-parallel-units discipline) — wall time is
    # dominated by interpreter+JAX startup per process (~seconds), which a
    # real long-lived multi-host job pays once, not per file.
    comp_s = max(sum(s["compress_phases_s"].values()) for s in stats)
    dec_s = max(sum(s["decompress_phases_s"].values()) for s in stats)
    codec_s = comp_s + dec_s
    # Kernel-only time (the analog of the reference's max-cycles-per-
    # tasklet observable): excludes the pre/post file IO, whose page-cache
    # and scheduler noise on a small shared VM otherwise dominates the
    # scaling signal.
    kern_s = max(
        s["compress_phases_s"].get("kernel", 0.0) for s in stats
    ) + max(s["decompress_phases_s"].get("kernel", 0.0) for s in stats)
    # Work-conservation observables: max per-process CPU seconds consumed
    # by the codec (what each "host" actually computed) and the sum across
    # processes (total work). cpu_s * N ~ sum_cpu_s ~ N=1 codec_s means the
    # work divides perfectly and any wall-clock efficiency below 100% on a
    # procs ~ cores VM is scheduler timesharing, not coordination overhead.
    cpu_s = max(
        s.get("compress_cpu_s", 0.0) + s.get("decompress_cpu_s", 0.0)
        for s in stats
    )
    sum_cpu_s = sum(
        s.get("compress_cpu_s", 0.0) + s.get("decompress_cpu_s", 0.0)
        for s in stats
    )
    return {
        "procs": nproc,
        "engine": engine,
        "block_size": block_size,
        "cores": os.cpu_count(),  # procs > cores rows are oversubscribed
        "bytes": n,
        "wall_s": round(wall, 3),
        "codec_s": round(codec_s, 3),
        "kernel_s": round(kern_s, 3),
        "compress_s": round(comp_s, 3),
        "decompress_s": round(dec_s, 3),
        "gbps": round(2 * n / codec_s / 1e9, 4),  # compress + decompress
        "kernel_gbps": round(2 * n / kern_s / 1e9, 4) if kern_s else 0.0,
        "cpu_s": round(cpu_s, 3),
        "sum_cpu_s": round(sum_cpu_s, 3),
        "compressed": stats[0]["compressed"],
        "max_rss_mb": max(s["peak_rss_mb"] for s in stats),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", default="1,2,4")
    ap.add_argument("--mb", type=int, default=48)
    ap.add_argument("--engine", default="native")
    ap.add_argument("--block-size", type=int, default=32768)
    ap.add_argument("--repeat", type=int, default=3,
                    help="runs per N; keeps the fastest (least interference)")
    ap.add_argument(
        "--sweeps", type=int, default=1,
        help="repeat the WHOLE sweep this many times and keep the fastest "
        "row per N (external shared-VM load only ever slows a run; "
        "interleaving the N values across sweeps stops a noisy window "
        "from landing entirely on the N=1 baseline and faking "
        "super-linear scaling)",
    )
    ap.add_argument("--no-pin", action="store_true",
                    help="skip taskset core pinning + thread-pool caps")
    ap.add_argument("--out", default="bench_out/sweep_procs.csv")
    ap.add_argument("--fresh", action="store_true",
                    help="overwrite the CSV instead of merging rows")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        src = tmp / "input.bin"
        src.write_bytes(synth_input(args.mb))
        procs = [int(x) for x in args.procs.split(",")]
        # Interleave N values across whole-sweep passes and keep the
        # fastest row per N: external load on the shared VM only ever
        # slows a run, and per-N repetition alone lets a noisy window
        # land entirely on one N (observed: a slowed N=1 baseline faking
        # 110% "efficiency" at N=4).
        best: dict[int, dict] = {}
        for _ in range(max(1, args.sweeps)):
            for nproc in procs:
                r = min(
                    (run_n(nproc, src, tmp, args.engine, args.block_size,
                           pin=not args.no_pin)
                     for _ in range(max(1, args.repeat))),
                    key=lambda x: x["kernel_s"],
                )
                if nproc not in best or r["kernel_s"] < best[nproc]["kernel_s"]:
                    best[nproc] = r
        rows = []
        for nproc in procs:
            r = best[nproc]
            if rows:
                base = rows[0]
                scale = r["procs"] / base["procs"]
                r["speedup"] = round(base["kernel_s"] / r["kernel_s"], 3)
                r["efficiency"] = round(r["speedup"] / scale, 3)
                r["allphase_eff"] = round(
                    base["codec_s"] / r["codec_s"] / scale, 3
                )
                # CPU-time efficiency: slowest process's actual codec
                # compute vs a perfect 1/N share of the N=1 CPU time.
                # This is the codec-scaling observable that a procs ~
                # cores VM cannot corrupt with scheduler timesharing.
                r["cpu_eff"] = (
                    round(base["cpu_s"] / r["cpu_s"] / scale, 3)
                    if r["cpu_s"]
                    else 0.0
                )
            else:
                r["speedup"] = 1.0
                r["efficiency"] = 1.0
                r["allphase_eff"] = 1.0
                r["cpu_eff"] = 1.0
            rows.append(r)
            print(
                f"N={r['procs']}: kernel {r['kernel_gbps']:.3f} GB/s "
                f"speedup {r['speedup']}x eff {r['efficiency']:.0%} "
                f"(all-phase {r['gbps']:.3f} GB/s, eff "
                f"{r['allphase_eff']:.0%}; cpu-work eff {r['cpu_eff']:.0%}) "
                f"peak RSS {r['max_rss_mb']} MB"
            )
    outp = REPO / args.out
    outp.parent.mkdir(parents=True, exist_ok=True)
    # Append rows for other engines/sweeps; rewrite when the schema grew
    # (--fresh or a header mismatch).
    existing = []
    if outp.exists() and not args.fresh:
        with open(outp, newline="") as f:
            rdr = csv.DictReader(f)
            if rdr.fieldnames == list(rows[0].keys()):
                key = ("procs", "engine", "block_size")
                new = {tuple(str(r[k]) for k in key) for r in rows}
                existing = [
                    r for r in rdr
                    if tuple(r.get(k, "") for k in key) not in new
                ]
    with open(outp, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(existing + rows)
    print(f"wrote {outp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
