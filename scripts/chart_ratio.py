#!/usr/bin/env python3
"""Compression-ratio tradeoff chart (role of chart_compr_vs_blksize.py /
compr_cycle_tradeoff.py): ratio vs block size per file, one line per file."""

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
    ap.add_argument("--engine", default=None, help="filter to one engine")
    ap.add_argument("--out", default="ratio.png")
    args = ap.parse_args()

    rows = [
        r
        for r in csv.DictReader(open(args.csv))
        if r["direction"] == "compress"
        and (args.engine is None or r["engine"] == args.engine)
    ]
    series: dict[str, list[tuple[int, float]]] = defaultdict(list)
    for r in rows:
        key = f"{r['file']}/{r['engine']}"
        series[key].append((int(r["block_size"]), float(r["ratio"])))

    fig, ax = plt.subplots(figsize=(7, 4.5))
    for label, pts in sorted(series.items()):
        pts.sort()
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", label=label)
    ax.set_xscale("log", base=2)
    ax.set_xlabel("block size (bytes)")
    ax.set_ylabel("compression ratio (1 - out/in)")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
