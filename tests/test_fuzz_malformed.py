"""Malformed-stream fuzz tier.

Systematic bit-flip / truncation / random-payload mutations over real
corpus streams, driven through every engine. The format carries no
checksums (same as the reference, snappy/README.md), so a mutated stream
may legitimately decode to different bytes — the contract under test is
*error-not-crash* with bounded writes:

- every engine either returns bytes or raises a typed error
  (``SnappyError`` / ``ValueError``) — never a segfault or an unbounded
  write (the native path is C++, the one that could actually scribble;
  its decoder validates offsets and lengths like the reference's,
  ``snappy_decompress.c:164-184``);
- engines agree on error-vs-success classification on >= 99% of cases
  (they implement the same validation semantics; the xla engine surfaces
  block flags through ``validate=True``).

The host tier fuzzes 1000+ mutants through oracle + native; the device
tier (xla, on the CPU mesh) runs a smaller subset — batched decodes keep
it inside the test budget — and checks that all three engines agree.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from pim_compression_tpu import native
from pim_compression_tpu.format import oracle
from pim_compression_tpu.utils.errors import SnappyError

from conftest import corpus_pair


def _mutants(stream: bytes, rng: random.Random, n: int):
    """Yield n mutated copies: bit flips (header-biased), truncations,
    byte stomps, and garbage tails."""
    for _ in range(n):
        b = bytearray(stream)
        kind = rng.randrange(4)
        if kind == 0:  # single bit flip, header-biased
            pos = (
                rng.randrange(min(16, len(b)))
                if rng.random() < 0.5
                else rng.randrange(len(b))
            )
            b[pos] ^= 1 << rng.randrange(8)
        elif kind == 1:  # truncate
            b = b[: rng.randrange(len(b))]
        elif kind == 2:  # stomp a run of bytes
            pos = rng.randrange(len(b))
            run = min(len(b) - pos, rng.randrange(1, 9))
            for i in range(run):
                b[pos + i] = rng.randrange(256)
        else:  # garbage tail
            b = b[: rng.randrange(len(b))] + bytes(
                rng.randrange(256) for _ in range(rng.randrange(1, 32))
            )
        yield bytes(b)


def _classify(fn, stream):
    """(ok, payload_len) — ok=False for a typed error; crashes propagate."""
    try:
        out = fn(stream)
        return True, len(out)
    except (SnappyError, ValueError, OverflowError):
        return False, -1


def _host_engines():
    yield "oracle", oracle.decompress
    if native.available():
        yield "native", lambda s: native.decompress(s, num_threads=1)


def test_fuzz_host_engines_error_not_crash():
    rng = random.Random(0xF0)
    base = [corpus_pair("alice")[1], corpus_pair("coding")[1]]
    total = agree = 0
    for stream in base:
        for mut in _mutants(stream, rng, 600):
            results = {}
            for name, fn in _host_engines():
                ok, n = _classify(fn, mut)
                results[name] = (ok, n)
            total += 1
            vals = list(results.values())
            if all(v[0] == vals[0][0] for v in vals):
                # same classification; successful decodes must also agree
                # on length (both implement the same stream semantics)
                if vals[0][0]:
                    assert all(v[1] == vals[0][1] for v in vals), results
                agree += 1
    assert total >= 1000
    assert agree / total >= 0.99, f"host engines agree on {agree}/{total}"


def test_fuzz_four_engine_agreement():
    # Smaller subset through all three engines (oracle, native, xla on the
    # CPU mesh). Device decode works on pre-scanned frames, so
    # structurally broken streams error in the host scan (pre phase) and
    # payload corruption surfaces via validate flags.
    from pim_compression_tpu import runtime
    from pim_compression_tpu.utils.config import CodecConfig

    rng = random.Random(0xF1)
    stream = corpus_pair("alice")[1]
    cfgs = {"xla": CodecConfig(engine="xla", validate=True)}
    total = agree = 0
    disagreements = []
    for mut in _mutants(stream, rng, 48):
        results = {}
        for name, fn in _host_engines():
            results[name] = _classify(fn, mut)
        for name, cfg in cfgs.items():
            results[name] = _classify(
                lambda s, cfg=cfg: bytes(runtime.decompress(s, cfg)), mut
            )
        total += 1
        oks = {k: v[0] for k, v in results.items()}
        if len(set(oks.values())) == 1:
            agree += 1
            if all(oks.values()):
                lens = {k: v[1] for k, v in results.items()}
                assert len(set(lens.values())) == 1, lens
        else:
            disagreements.append(oks)
    # Tolerate ONE semantic borderline (e.g. the oracle accepting a
    # stream whose final copy the block-parallel path flags) — at 48
    # mutants a percentage threshold would demand exact unanimity.
    assert agree >= total - 1, f"agree {agree}/{total}: {disagreements[:4]}"
