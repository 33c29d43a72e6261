#!/usr/bin/env python3
"""Stacked runtime-breakdown chart (role of asplos21/chart_breakdown.py).

Reads the sweep CSV from run_benchmarks.py and renders per-phase stacked
bars (pre / h2d / kernel / d2h / post) per file+engine, the device translation
of the reference's Setup/CopyIn/Run/CopyOut taxonomy.
"""

from __future__ import annotations

import argparse
import csv

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

PHASES = ["pre", "h2d", "kernel", "d2h", "post"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("csv", nargs="?", default="bench_results.csv")
    ap.add_argument("--direction", default="decompress")
    ap.add_argument("--out", default="breakdown.png")
    args = ap.parse_args()

    rows = [
        r
        for r in csv.DictReader(open(args.csv))
        if r["direction"] == args.direction
    ]
    if not rows:
        print("no rows")
        return 1
    labels = [f"{r['file']}\n{r['engine']}" for r in rows]
    fig, ax = plt.subplots(figsize=(max(6, len(rows) * 0.9), 4.5))
    bottom = [0.0] * len(rows)
    for phase in PHASES:
        vals = [float(r.get(f"{phase}_s", 0)) * 1e3 for r in rows]
        ax.bar(labels, vals, bottom=bottom, label=phase)
        bottom = [b + v for b, v in zip(bottom, vals)]
    ax.set_ylabel("time (ms)")
    ax.set_title(f"{args.direction} runtime breakdown")
    ax.legend()
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
