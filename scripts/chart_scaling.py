#!/usr/bin/env python3
"""Scaling-vs-device-count chart (role of scripts/asplos21/chart_dpu_speedup.py
and chart_tasklet_speedup.py).

The reference sweeps NR_DPUS x NR_TASKLETS ({16..128} x {4..24},
scripts/asplos21/dpu_tasklet_tradeoff.py:10-11) and charts speedup per
shape; the device analog's one topology axis is the 1-D block-mesh size.
Feed this a run_benchmarks.py CSV produced with --mesh-sizes 1,2,4,8:
plots per-direction throughput normalized to the 1-device point, plus the
ideal-linear guide line.
"""

from __future__ import annotations

import argparse
import csv
from collections import defaultdict

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("csv", nargs="?", default="bench_results.csv")
    ap.add_argument("--file", default=None, help="corpus file to plot")
    ap.add_argument("--out", default="scaling.png")
    args = ap.parse_args()

    rows = [r for r in csv.DictReader(open(args.csv)) if r["mesh_devices"]]
    if args.file:
        rows = [r for r in rows if r["file"] == args.file]
    if not rows:
        raise SystemExit("no mesh_devices rows — run with --mesh-sizes")

    # (engine, direction) -> {ndev: gbps}
    series: dict[tuple[str, str], dict[int, float]] = defaultdict(dict)
    for r in rows:
        key = (r["engine"], r["direction"])
        series[key][int(r["mesh_devices"])] = float(r["gbps"])

    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    max_n = 1
    min_n = None
    for (engine, direction), pts in sorted(series.items()):
        ns = sorted(pts)
        base = pts[ns[0]]  # baseline = smallest mesh present
        ax.plot(
            ns,
            [pts[n] / base for n in ns],
            marker="o",
            label=f"{engine} {direction}",
        )
        max_n = max(max_n, ns[-1])
        min_n = ns[0] if min_n is None else min(min_n, ns[0])
    ideal = list(range(min_n, max_n + 1))
    ax.plot(
        ideal, [n / min_n for n in ideal], "k--", lw=0.8, label="ideal linear"
    )
    ax.set_xlabel("mesh devices")
    ax.set_ylabel(f"speedup vs {min_n} device(s)")
    ax.set_xticks(ideal)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
