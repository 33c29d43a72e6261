"""XLA encoder tests: outputs must decode correctly (oracle is the arbiter)
and compress at least as well as the reference on the corpus."""

import random

import numpy as np
import pytest

from pim_compression_tpu.format import constants as C
from pim_compression_tpu.format import oracle
from pim_compression_tpu.ops import encode
from pim_compression_tpu.ops.decode import padded_capacity

from conftest import CORPUS_PAIRS, corpus_pair


def _encode_and_check(data: bytes, block_size: int = C.DEFAULT_BLOCK_SIZE) -> int:
    """Encode via the XLA kernel, decode via the oracle; returns stream size."""
    nb = max(1, (len(data) + block_size - 1) // block_size)
    blocks = np.zeros((nb, block_size), dtype=np.uint8)
    lens = np.zeros(nb, dtype=np.int32)
    raw = np.frombuffer(data, dtype=np.uint8)
    for i in range(nb):
        chunk = raw[i * block_size : (i + 1) * block_size]
        blocks[i, : len(chunk)] = chunk
        lens[i] = len(chunk)
    comp, sizes = encode.encode_blocks(blocks, lens, block_size=block_size)
    comp, sizes = np.asarray(comp), np.asarray(sizes)
    assert sizes.max(initial=0) <= padded_capacity(block_size)

    # Reassemble a framed stream and decode with the oracle.
    from pim_compression_tpu.format.varint import encode_varint32

    stream = bytearray(encode_varint32(len(data)) + encode_varint32(block_size))
    if len(data):
        for i in range(nb):
            stream += int(sizes[i]).to_bytes(4, "little")
            stream += comp[i, : sizes[i]].tobytes()
    assert oracle.decompress(bytes(stream)) == data
    return len(stream)


@pytest.mark.parametrize("name", CORPUS_PAIRS)
def test_encode_corpus_roundtrip_and_ratio(corpus_dir, name):
    txt, snappy = corpus_pair(name)
    size = _encode_and_check(txt)
    # Exact previous-occurrence matching must not lose to the reference's
    # collision-prone hash table (BASELINE.md target: size <= reference).
    assert size <= len(snappy), f"{name}: {size} > reference {len(snappy)}"


def test_encode_adversarial_buffers():
    rng = random.Random(11)
    cases = [
        b"",
        b"a",
        b"abc",
        b"aaaa",
        b"a" * 100,
        b"a" * 70000,
        bytes(range(256)) * 300,
        rng.randbytes(1000),
        rng.randbytes(65536 + 17),
        b"ab" * 40000,
        (b"0123456789abcdef" * 5000)[:70001],
    ]
    for data in cases:
        _encode_and_check(data)


def test_encode_literal_run_boundaries():
    rng = random.Random(12)
    for n in [59, 60, 61, 255, 256, 257, 4096]:
        _encode_and_check(rng.randbytes(n))


def test_encode_block_sizes():
    data = (b"the quick brown fox jumps " * 3000)[:70000]
    for bs in [1024, 8192, 65536]:
        _encode_and_check(data, block_size=bs)


def test_xla_engine_64k_blocks_beat_reference_sizes():
    # The portable engine has no position-packing limit (exact 2-key sort)
    # and its prev-k select-then-extend defaults put its ratio above the
    # reference AT THE FORMAT'S 64 KB MAX block size (snappy/README.md:7):
    # no block size <= 64K emits a larger stream than the reference
    # compressor's 32 KB stream (the corpus twin).
    from pim_compression_tpu import runtime
    from pim_compression_tpu.utils.config import CodecConfig

    for name in ("terror2", "coding"):
        data, snappy = corpus_pair(name)
        ref_size = len(snappy)
        cfg = CodecConfig(engine="xla", block_size=65536)
        stream = runtime.compress(data, cfg)
        assert oracle.decompress(bytes(stream)) == data
        assert len(stream) <= ref_size, (name, len(stream), ref_size)
        assert runtime.decompress(stream, cfg) == data
