"""End-to-end runtime tests on the 8-device CPU mesh: engine parity,
sharded batching, phase profiling."""

import random

import jax
import pytest

from pim_compression_tpu import runtime
from pim_compression_tpu.format import oracle
from pim_compression_tpu.runtime.profiling import PhaseTimer
from pim_compression_tpu.utils.config import CodecConfig
from pim_compression_tpu.utils.errors import SnappyError

from conftest import CORPUS_PAIRS, corpus_pair


def test_mesh_has_8_cpu_devices():
    assert len(jax.devices()) == 8  # conftest forces the virtual CPU mesh


@pytest.mark.parametrize("name", CORPUS_PAIRS)
def test_runtime_decompress_corpus(corpus_dir, name):
    txt, snappy = corpus_pair(name)
    assert runtime.decompress(snappy, CodecConfig(engine="xla")) == txt


@pytest.mark.parametrize("name", ["alice", "terror2", "plrabn12"])
def test_runtime_compress_corpus(corpus_dir, name):
    txt, snappy = corpus_pair(name)
    stream = runtime.compress(txt, CodecConfig(engine="xla"))
    assert oracle.decompress(stream) == txt
    assert len(stream) <= len(snappy)


def test_runtime_roundtrip_engines():
    data = (b"engine parity test " * 3000) + random.Random(3).randbytes(10000)
    for engine in ("oracle", "native", "xla"):
        cfg = CodecConfig(engine=engine)
        stream = runtime.compress(data, cfg)
        assert runtime.decompress(stream, cfg) == data
        # cross-engine: everyone decodes everyone
        assert runtime.decompress(stream, CodecConfig(engine="oracle")) == data


def test_runtime_small_batches_force_multiple_dispatches():
    data = random.Random(4).randbytes(300_000)  # 10 blocks @ 32K
    cfg = CodecConfig(engine="xla", batch_blocks=4)
    stream = runtime.compress(data, cfg)
    assert runtime.decompress(stream, cfg) == data


def test_runtime_pipeline_depths_agree():
    # Sync (depth 1) and pipelined (depth 3) batch schedules must produce
    # identical streams and round-trip across several in-flight batches.
    data = random.Random(5).randbytes(500_000)  # 16 blocks @ 32K
    streams = []
    for depth in (1, 3):
        cfg = CodecConfig(engine="xla", batch_blocks=4, pipeline_depth=depth)
        stream = runtime.compress(data, cfg)
        assert runtime.decompress(stream, cfg) == data
        streams.append(stream)
    assert streams[0] == streams[1]


def test_runtime_empty_and_tiny():
    for engine in ("xla", "native", "oracle"):
        cfg = CodecConfig(engine=engine)
        for data in (b"", b"x", b"hello"):
            assert runtime.decompress(runtime.compress(data, cfg), cfg) == data


def test_runtime_validation_rejects_corrupt():
    stream = runtime.compress(b"validate me " * 5000, CodecConfig(engine="xla"))
    bad = bytearray(stream)
    bad[len(bad) // 2] ^= 0xFF
    try:
        out = runtime.decompress(bytes(bad), CodecConfig(engine="xla"))
        # Silent corruption is possible (no checksums, same as reference) —
        # but structural damage must raise, so accept either wrong bytes...
        assert isinstance(out, bytes)
    except (SnappyError, ValueError):
        pass  # ...or a typed validation error


def test_runtime_phase_timer():
    timer = PhaseTimer()
    data = b"profile me " * 10000
    runtime.compress(data, CodecConfig(engine="xla"), timer)
    assert timer.seconds["kernel"] > 0
    assert "kernel time:" in timer.human()
    assert "phases_s" in timer.json()


def test_phase_timer_taxonomy():
    t = PhaseTimer()
    with t.phase("pre"):
        pass
    human = t.human()
    for p in ("pre", "h2d", "kernel", "d2h", "post"):
        assert f"{p} time:" in human


@pytest.mark.parametrize("engine", ["pallas", "gpu", ""])
def test_unknown_engines_rejected(engine):
    with pytest.raises(ValueError, match="unknown engine"):
        CodecConfig(engine=engine)


@pytest.mark.parametrize(
    "num_blocks,mesh_devices,batch_blocks,expected",
    [
        (1, 1, 1024, (1, 1)),
        (164, 1, 1024, (164, 164)),
        (3072, 1, 1024, (3072, 1024)),
        (3073, 1, 1024, (4096, 1024)),
        (5, 8, 1024, (8, 8)),
        (10, 4, 4, (12, 4)),
    ],
)
def test_device_batches(num_blocks, mesh_devices, batch_blocks, expected):
    # Batches are a multiple of the mesh size; the total pads to whole
    # batches.
    from pim_compression_tpu.parallel import get_mesh
    from pim_compression_tpu.runtime.api import _device_batches

    cfg = CodecConfig(batch_blocks=batch_blocks)
    assert _device_batches(num_blocks, cfg, get_mesh(mesh_devices)) == expected
