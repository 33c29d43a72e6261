#!/usr/bin/env python3
"""Golden-corpus check through a chosen engine, single process.

The reference's `make test` harness cmp's every decompressed corpus file
against its golden twin (snappy/Makefile:54-60). This driver does the same
through any engine on the seeded corpus (``pim_compression_tpu.utils.
corpus``: each ``.snappy`` twin is the native codec's stream), in ONE
process, so device programs compile once and serve every file.

    python scripts/corpus_check.py [--engine xla] [--compress] [--files a,b]

Decompression: byte-compare against the plain file. With --compress, also
re-compress every plain file and require the stream to be oracle-valid and
no larger than the twin.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="xla")
    ap.add_argument("--block-size", type=int, default=32768)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--files", default=None, help="e.g. alice,xml (default: all)")
    ap.add_argument("--seed", type=int, default=0, help="corpus seed")
    args = ap.parse_args()

    from pim_compression_tpu import runtime
    from pim_compression_tpu.format import oracle
    from pim_compression_tpu.utils import corpus
    from pim_compression_tpu.utils.config import CodecConfig

    cfg = CodecConfig(engine=args.engine, block_size=args.block_size)
    names = args.files.split(",") if args.files else corpus.NAMES
    failures = 0
    for name in names:
        want = corpus.generate(name, args.seed)
        stream = corpus.twin(want)
        out = runtime.decompress(stream, cfg)
        ok = out == want
        print(f"{'OK' if ok else 'FAIL'} decompress {name} ({len(out)} B)")
        failures += not ok
        if args.compress:
            enc = runtime.compress(want, cfg)
            ok = oracle.decompress(bytes(enc)) == want
            ok_size = len(enc) <= len(stream)
            print(
                f"{'OK' if ok and ok_size else 'FAIL'} compress   {name} "
                f"({len(enc)} B vs native {len(stream)} B"
                f"{'' if ok_size else ' — LARGER'})"
            )
            failures += not (ok and ok_size)
    print("corpus check:", "PASS" if not failures else f"{failures} FAILURES")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
