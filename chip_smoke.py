#!/usr/bin/env python3
"""End-to-end smoke run of the codec's main path on one GPU.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # only the 4-card mesh path

Drives ``runtime.compress`` / ``runtime.decompress`` through the ``xla``
engine (and the CLI's ``-d`` path, in-process) on seeded data at the sizes
users run: 96 MiB of XML-like text in 32 KB blocks (three 1,024-block
batches, so the pipelined dispatch overlaps), 16 MiB each at 4 KB and at
64 KB blocks, a mixed object with incompressible thirds, and malformed
streams. Every output is checked bit-exactly against the native C++ codec
and, on a sample of blocks, the pure-Python oracle; every stream must be
no larger than the native codec's at the same block size. The codec is
integer-only, so the tolerance is zero.

Fails (exit code != 0, no result line) when JAX finds no GPU. Prints the
card's name and power limit, first-call (compile) seconds, warm GB/s and
phase times for information, and as its last line the JSON result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
One process drives the card(s): JAX reserves most of a card's memory when
it starts, so nothing here starts a second JAX process.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

MIB = 1 << 20


class SmokeFailure(Exception):
    """A check of the smoke run failed."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    """``name, power limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return " | ".join(line.strip() for line in out.splitlines() if line.strip())


def require_gpu(count: int):
    """The GPU devices this run uses; fails on a host without enough."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeFailure(
            f"no GPU: JAX's default backend is {devs[0].platform!r}"
        )
    check(len(devs) >= count, f"needs {count} GPUs, JAX sees {len(devs)}")
    return devs[:count]


def _phases(timer) -> str:
    return " ".join(
        f"{k} {v:.3f}" for k, v in timer.seconds.items() if v
    ) + " s"


def oracle_sample(stream: bytes, plain: bytes, samples: int) -> None:
    """The oracle restores ``samples`` evenly spaced blocks bit-exactly."""
    from pim_compression_tpu.format import oracle

    _, bs, frames = oracle.scan_block_frames(stream)
    picks = sorted({
        round(i * (len(frames) - 1) / max(samples - 1, 1))
        for i in range(min(samples, len(frames)))
    })
    view = memoryview(stream)
    for b in picks:
        off, size = frames[b]
        out = bytearray()
        oracle.decompress_block(view[off : off + size], out, 0)
        check(
            bytes(out) == plain[b * bs : (b + 1) * bs],
            f"oracle: block {b} of the xla stream decodes wrong",
        )


def roundtrip(label: str, plain: bytes, block_size: int, *,
              mesh_devices: int | None = 1, oracle_blocks: int = 16,
              log=print) -> dict:
    """Compress + decompress ``plain`` through the xla engine and check it
    against the native codec (and the oracle on a sample of blocks)."""
    from pim_compression_tpu import native, runtime
    from pim_compression_tpu.runtime.profiling import PhaseTimer
    from pim_compression_tpu.utils.config import CodecConfig

    cfg = CodecConfig(
        engine="xla", block_size=block_size, mesh_devices=mesh_devices
    )
    t0 = time.perf_counter()
    stream = bytes(runtime.compress(plain, cfg))
    enc_first = time.perf_counter() - t0
    check(native.decompress(stream) == plain,
          f"{label}: native decode of the xla stream differs")
    oracle_sample(stream, plain, oracle_blocks)
    nstream = native.compress(plain, block_size)
    check(len(stream) <= len(nstream),
          f"{label}: xla stream {len(stream)} B > native {len(nstream)} B")
    t0 = time.perf_counter()
    back = runtime.decompress(stream, cfg)
    dec_first = time.perf_counter() - t0
    check(back == plain, f"{label}: xla decode of the xla stream differs")
    check(runtime.decompress(nstream, cfg) == plain,
          f"{label}: xla decode of the native stream differs")

    # Warm runs: the programs are compiled now.
    et, dt = PhaseTimer(), PhaseTimer()
    t0 = time.perf_counter()
    again = runtime.compress(plain, cfg, et)
    enc_s = time.perf_counter() - t0
    check(bytes(again) == stream, f"{label}: compress is not deterministic")
    t0 = time.perf_counter()
    back = runtime.decompress(stream, cfg, dt)
    dec_s = time.perf_counter() - t0
    check(back == plain, f"{label}: warm xla decode differs")
    res = {
        "label": label,
        "bytes": len(plain),
        "block_size": block_size,
        "ratio": 1 - len(stream) / len(plain),
        "native_ratio": 1 - len(nstream) / len(plain),
        "compress_first_s": enc_first,
        "decompress_first_s": dec_first,
        "compress_gbps": len(plain) / enc_s / 1e9,
        "decompress_gbps": len(plain) / dec_s / 1e9,
        "raw_blocks": et.notes.get("raw_blocks", 0),
    }
    log(
        f"{label}: ratio {res['ratio']:.4f} (native {res['native_ratio']:.4f}); "
        f"first calls {enc_first:.1f} s / {dec_first:.1f} s; warm compress "
        f"{res['compress_gbps']:.3f} GB/s [{_phases(et)}], decompress "
        f"{res['decompress_gbps']:.3f} GB/s [{_phases(dt)}]"
    )
    return res


def phase_blocks(sizes: dict[int, int], seed: int, log=print) -> list[dict]:
    """XML-like data at each block size: {block_size: bytes}."""
    from pim_compression_tpu.utils import corpus

    return [
        roundtrip(f"{bs // 1024} KB blocks, {n / MIB:g} MiB",
                  corpus.xml_like(n, seed), bs, log=log)
        for bs, n in sizes.items()
    ]


def phase_mixed(third: int, block_size: int, seed: int, log=print) -> dict:
    """Text, random bytes and markup in thirds: triage diverts the random
    third to raw literal frames beside the device-encoded blocks."""
    from pim_compression_tpu.utils import corpus

    plain = (
        corpus.text_like(third, seed)
        + corpus.incompressible(third, seed)
        + corpus.xml_like(third, seed)
    )
    res = roundtrip(f"mixed object, {len(plain) / MIB:g} MiB", plain,
                    block_size, log=log)
    # Triage is conservative: a random block whose sampled 4-grams happen
    # to repeat stays on the device, which costs speed, not correctness.
    random_blocks = third // block_size
    check(res["raw_blocks"] >= 0.9 * random_blocks,
          f"triage diverted {res['raw_blocks']} of {random_blocks} random "
          "blocks")
    return res


def phase_cli(size: int, block_size: int, seed: int, log=print) -> None:
    """``-d -c`` then ``-d`` through the CLI's own main(), in-process."""
    import contextlib
    import io

    from pim_compression_tpu import cli, native
    from pim_compression_tpu.utils import corpus

    plain = corpus.text_like(size, seed)
    with tempfile.TemporaryDirectory() as td:
        src, comp, out = (pathlib.Path(td) / n for n in ("in", "c", "out"))
        src.write_bytes(plain)
        for argv in (["-d", "-c", "-b", str(block_size), "-i", str(src),
                      "-o", str(comp)],
                     ["-d", "-i", str(comp), "-o", str(out)]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            check(rc == 0, f"cli {' '.join(argv[:2])} exited {rc}")
            check("Using xla engine" in buf.getvalue(),
                  "cli -d did not use the xla engine")
        check(out.read_bytes() == plain, "cli round trip differs")
        check(native.decompress(comp.read_bytes()) == plain,
              "native decode of the cli stream differs")
    log(f"cli -d: {size / MIB:g} MiB at {block_size // 1024} KB blocks OK")


def _reframe(stream: bytes, index: int, payload: bytes) -> bytes:
    """``stream`` with block ``index``'s payload replaced."""
    from pim_compression_tpu.format import oracle

    _, _, frames = oracle.scan_block_frames(stream)
    off, size = frames[index]
    return (
        stream[: off - 4] + len(payload).to_bytes(4, "little") + payload
        + stream[off + size :]
    )


def _copy2(length: int, offset: int) -> bytes:
    return bytes([2 | ((length - 1) << 2), offset & 0xFF, offset >> 8])


def _bad_offset_payload(block_size: int) -> bytes:
    """A block that decodes to exactly ``block_size`` bytes but whose first
    copy reaches back 5 bytes from output position 1."""
    body = bytes([0 << 2]) + b"A" + _copy2(64, 5)  # literal "A", bad copy
    rest = block_size - 65
    while rest:
        n = min(rest, 64)
        body += _copy2(n, 1)
        rest -= n
    return body


def phase_malformed(stream: bytes, block_size: int, log=print) -> None:
    """Truncated frames, a bad offset and an oversized length raise
    SnappyError through the xla engine; the process carries on."""
    from pim_compression_tpu import runtime
    from pim_compression_tpu.format import oracle
    from pim_compression_tpu.utils.config import CodecConfig
    from pim_compression_tpu.utils.errors import SnappyError

    _, _, frames = oracle.scan_block_frames(stream)
    mid = len(frames) // 2
    oversized = bytes([61 << 2, 0xFF, 0xFF]) + b"x" * 16  # a 64 KiB literal
    cases = {
        "truncated frame": stream[: frames[mid][0] + frames[mid][1] // 2],
        "bad offset": _reframe(stream, mid, _bad_offset_payload(block_size)),
        "oversized length": _reframe(stream, mid, oversized),
    }
    cfg = CodecConfig(engine="xla", block_size=block_size, mesh_devices=1)
    for what, bad in cases.items():
        try:
            runtime.decompress(bad, cfg)
        except SnappyError:
            continue
        raise SmokeFailure(f"malformed stream ({what}) decoded without error")
    log(f"malformed streams: {', '.join(cases)} raise SnappyError")


def run_one_card(seed: int, scale: float = 1.0, log=print) -> None:
    from pim_compression_tpu import runtime
    from pim_compression_tpu.utils import corpus
    from pim_compression_tpu.utils.config import CodecConfig

    def size(n):
        return max(int(n * scale), 1)

    # Sizes keep to three programs per direction (1,024-block batches at
    # 4 and 32 KB, one 256-block batch at 64 KB), so compilation stays a
    # small part of the run.
    phase_blocks({32768: size(96 * MIB)}, seed, log=log)
    phase_blocks({4096: size(16 * MIB), 65536: size(16 * MIB)}, seed, log=log)
    phase_mixed(size(16 * MIB), 32768, seed, log=log)
    phase_cli(size(4 * MIB), 4096, seed, log=log)
    plain = corpus.xml_like(size(32 * MIB), seed)
    stream = bytes(runtime.compress(
        plain, CodecConfig(engine="xla", mesh_devices=1)
    ))
    phase_malformed(stream, 32768, log=log)


def run_four_cards(seed: int, scale: float = 1.0, log=print) -> None:
    """The phase-2 data x4, block axis sharded over four cards, against
    the same calls on one card: streams and outputs byte-identical, and
    every card did its share."""
    import jax

    from pim_compression_tpu import runtime
    from pim_compression_tpu.ops import decode, encode
    from pim_compression_tpu.utils import corpus
    from pim_compression_tpu.utils.config import CodecConfig

    plain = corpus.xml_like(max(int(4 * 96 * MIB * scale), 1), seed)
    # 4,096-block batches: each card runs the one-card program's shape.
    four = CodecConfig(engine="xla", mesh_devices=4, batch_blocks=4096)
    one = CodecConfig(engine="xla", mesh_devices=1)
    # Record which devices hold a shard of every kernel output.
    holders: dict[str, set] = {"encode_blocks": set(), "decode_blocks": set()}
    real = {"encode_blocks": encode.encode_blocks,
            "decode_blocks": decode.decode_blocks}

    def spy(mod, name):
        def call(*a, **kw):
            out = real[name](*a, **kw)
            holders[name].update(
                s.device for s in out[0].addressable_shards if s.data.size
            )
            return out
        setattr(mod, name, call)

    spy(encode, "encode_blocks")
    spy(decode, "decode_blocks")
    try:
        t0 = time.perf_counter()
        s4 = bytes(runtime.compress(plain, four))
        o4 = runtime.decompress(s4, four)
        first4 = time.perf_counter() - t0
    finally:
        encode.encode_blocks = real["encode_blocks"]
        decode.decode_blocks = real["decode_blocks"]
    want = set(jax.local_devices()[:4])
    for name, devs in holders.items():
        check(devs == want, f"{name}: shards on {sorted(map(str, devs))}, "
              f"want all of {sorted(map(str, want))}")
    t0 = time.perf_counter()
    s1 = bytes(runtime.compress(plain, one))
    o1 = runtime.decompress(s1, one)
    first1 = time.perf_counter() - t0
    check(s4 == s1, "4-card stream differs from the 1-card stream")
    check(o4 == o1 == plain, "4-card output differs from the 1-card output")
    log(
        f"four cards: {len(plain) / MIB:g} MiB, streams and outputs "
        f"byte-identical to one card; first calls {first4:.1f} s (4 cards) / "
        f"{first1:.1f} s (1 card); every kernel output sharded over "
        f"{len(want)} cards"
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh path and its 1-card twin")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1
    import jax

    try:
        dev = require_gpu(count)[0]
        card = card_line()
        print(f"device: {dev.device_kind} x{count} (JAX sees "
              f"{len(jax.devices())}); card: {card}")

        def log(msg):
            print(f"[{card}] {msg}", flush=True)

        if args.four_cards:
            run_four_cards(args.seed, log=log)
        else:
            run_one_card(args.seed, log=log)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": count},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
