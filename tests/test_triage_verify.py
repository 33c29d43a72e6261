"""Incompressible fast path (host triage) + on-device verify flag.

Reference analogs: the compressor's skip heuristic
(``snappy_compress.c:333-348``) and the make-harness cmp check
(``snappy/Makefile:54-60``).
"""

from __future__ import annotations

import numpy as np
import pytest

from pim_compression_tpu import runtime
from pim_compression_tpu.format import oracle
from pim_compression_tpu.runtime import pipeline
from pim_compression_tpu.runtime.profiling import PhaseTimer
from pim_compression_tpu.utils.config import CodecConfig

BS = 1024


def _cfg(**kw):
    return CodecConfig(engine="xla", block_size=BS, **kw)


def test_triage_mask_random_vs_text():
    rng = np.random.default_rng(11)
    text = (b"the quick brown fox jumps over the lazy dog. " * 200)[: 4 * BS]
    blocks = np.zeros((9, BS), np.uint8)
    lens = np.full(9, BS, np.int32)
    for i in range(4):
        blocks[i] = rng.integers(0, 256, BS, np.uint8)
    for i in range(4):
        blocks[4 + i] = np.frombuffer(text[i * BS : (i + 1) * BS], np.uint8)
    blocks[8, :100] = rng.integers(0, 256, 100, np.uint8)
    lens[8] = 100  # partial block: never triaged
    mask = pipeline.triage_incompressible(blocks, lens)
    assert mask[:4].all(), "random full blocks must triage"
    assert not mask[4:].any(), "text and partial blocks must stay on device"


def test_triage_conservative_on_disguised_redundancy():
    # High byte entropy but perfectly compressible: one random KB repeated.
    rng = np.random.default_rng(12)
    unit = rng.integers(0, 256, 256, np.uint8)
    blocks = np.tile(unit, (1, BS // 256))
    lens = np.full(1, BS, np.int32)
    assert not pipeline.triage_incompressible(blocks, lens).any()


def test_raw_literal_frames_decode():
    rng = np.random.default_rng(13)
    for n in (1, 59, 60, 256, 300, BS):
        blocks = np.zeros((1, BS), np.uint8)
        blocks[0, :n] = rng.integers(0, 256, n, np.uint8)
        lens = np.array([n], np.int32)
        comp = np.zeros((1, BS + 8), np.uint8)
        sizes = np.zeros(1, np.int32)
        pipeline.raw_literal_frames(blocks, lens, comp, sizes, np.array([0]))
        # Build a one-block stream by hand and decode with the oracle.
        from pim_compression_tpu.format.varint import encode_varint32

        s = (
            encode_varint32(n)
            + encode_varint32(BS)
            + int(sizes[0]).to_bytes(4, "little")
            + comp[0, : sizes[0]].tobytes()
        )
        assert oracle.decompress(s) == blocks[0, :n].tobytes()


def test_compress_random_all_triaged_no_device_work():
    rng = np.random.default_rng(14)
    data = rng.integers(0, 256, 6 * BS, dtype=np.uint8).tobytes()
    t = PhaseTimer()
    stream = runtime.compress(data, _cfg(), t)
    assert t.notes.get("raw_blocks") == 6
    assert oracle.decompress(stream) == data
    # Overhead per triaged 1 KB block: 3-byte literal header + 4-byte frame.
    assert len(stream) <= len(data) + 6 * 7 + 10


def test_compress_text_triage_is_identity():
    text = (b"block-parallel snappy on device lanes " * 300)[: 6 * BS]
    t = PhaseTimer()
    s_on = runtime.compress(text, _cfg(), t)
    assert "raw_blocks" not in t.notes
    s_off = runtime.compress(text, _cfg(raw_triage=False))
    assert s_on == s_off
    assert oracle.decompress(s_on) == text


def test_compress_mixed_roundtrip():
    rng = np.random.default_rng(15)
    data = (
        rng.integers(0, 256, 2 * BS, dtype=np.uint8).tobytes()
        + (b"abcdefgh" * 256)[: 2 * BS]
        + rng.integers(0, 256, 500, dtype=np.uint8).tobytes()
    )
    t = PhaseTimer()
    stream = runtime.compress(data, _cfg(), t)
    assert t.notes.get("raw_blocks") == 2
    assert oracle.decompress(stream) == data


def test_verify_on_device_roundtrip():
    text = (b"verify me on the device, byte for byte. " * 200)[: 4 * BS]
    stream = runtime.compress(text, _cfg(verify=True))
    assert oracle.decompress(stream) == text


def test_verify_catches_decoder_disagreement(monkeypatch):
    # Force the verification decoder to produce garbage: the flag must trip.
    from pim_compression_tpu.ops import decode
    from pim_compression_tpu.utils.errors import SnappyError

    real = decode.decode_blocks

    def corrupted(comp, comp_len, out_len, **kw):
        out, err = real(comp, comp_len, out_len, **kw)
        return out ^ 0xFF, err

    monkeypatch.setattr(decode, "decode_blocks", corrupted)
    text = (b"corruption must be caught before assembly " * 200)[: 2 * BS]
    with pytest.raises(SnappyError):
        runtime.compress(text, _cfg(verify=True))
