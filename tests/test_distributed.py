"""Multi-host orchestration tests (single-process degenerate path on the CPU
mesh; block-range math tested across simulated process counts)."""

import pathlib

import numpy as np
import pytest

from pim_compression_tpu.format import oracle
from pim_compression_tpu.parallel import distributed
from pim_compression_tpu.utils.config import CodecConfig

from conftest import corpus_pair


def test_process_block_range_partition(monkeypatch):
    import jax

    for nproc in (1, 2, 3, 8):
        monkeypatch.setattr(jax, "process_count", lambda: nproc)
        ranges = []
        for pid in range(nproc):
            monkeypatch.setattr(jax, "process_index", lambda p=pid: p)
            ranges.append(distributed.process_block_range(10))
        # contiguous, ordered, covering exactly [0, 10)
        assert ranges[0][0] == 0
        assert ranges[-1][1] == 10
        for (a0, a1), (b0, b1) in zip(ranges, ranges[1:]):
            assert a1 == b0
        assert all(lo <= hi for lo, hi in ranges)


def test_compress_to_file_roundtrip(tmp_path, corpus_dir):
    txt, snappy = corpus_pair("terror2")
    src = tmp_path / "in.txt"
    src.write_bytes(txt)
    out = tmp_path / "out.snappy"
    stats = distributed.compress_to_file(src, out, CodecConfig(engine="native"))
    assert stats["total"] == len(txt)
    # single-process native path must be byte-identical to the reference
    assert out.read_bytes() == snappy


def test_decompress_to_file_roundtrip(tmp_path, corpus_dir):
    txt, snappy = corpus_pair("world192")
    src = tmp_path / "in.snappy"
    src.write_bytes(snappy)
    out = tmp_path / "out.txt"
    stats = distributed.decompress_to_file(src, out, CodecConfig(engine="native"))
    assert stats["total"] == len(txt)
    assert out.read_bytes() == txt


def test_distributed_xla_engine(tmp_path, corpus_dir):
    txt, _ = corpus_pair("plrabn12")
    src = tmp_path / "in.txt"
    src.write_bytes(txt)
    comp = tmp_path / "c.snappy"
    rt = tmp_path / "rt.txt"
    distributed.compress_to_file(src, comp, CodecConfig(engine="xla"))
    assert oracle.decompress(comp.read_bytes()) == txt
    distributed.decompress_to_file(comp, rt, CodecConfig(engine="xla"))
    assert rt.read_bytes() == txt


def test_simulated_two_process_segments(tmp_path, corpus_dir, monkeypatch):
    """Emulate two processes by running each rank's segment logic in turn and
    checking the cooperative output equals the single-process stream."""
    import jax

    txt, snappy = corpus_pair("plrabn12")
    src = tmp_path / "in.txt"
    src.write_bytes(txt)
    out = tmp_path / "out.snappy"

    sizes_by_rank = {}
    monkeypatch.setattr(jax, "process_count", lambda: 2)

    def fake_allgather(local_size):
        sizes_by_rank[jax.process_index()] = local_size
        return np.array(
            [sizes_by_rank.get(0, 0), sizes_by_rank.get(1, 0)], np.int64
        )

    monkeypatch.setattr(distributed, "_allgather_sizes", fake_allgather)
    monkeypatch.setattr(
        "jax.experimental.multihost_utils.sync_global_devices", lambda name: None
    )
    # pass 1 records each rank's segment size; pass 2 reruns with both sizes
    # known so every rank's global offset is correct.
    for _ in range(2):
        for pid in (0, 1):
            monkeypatch.setattr(jax, "process_index", lambda p=pid: p)
            distributed.compress_to_file(src, out, CodecConfig(engine="native"))
    assert oracle.decompress(out.read_bytes()) == txt
    # with 32K blocks both rank segments concatenate to the reference stream
    assert out.read_bytes() == snappy


@pytest.mark.parametrize("nproc,engine", [(2, "native"), (3, "native"),
                                          (2, "xla")])
def test_real_multiprocess_compress_decompress(
    tmp_path, corpus_dir, nproc, engine
):
    """REAL multi-process run: N OS processes, a live
    jax.distributed coordinator, gloo CPU collectives — the production
    all-gather + ordered-pwrite path with zero monkeypatching. Output must
    be byte-identical to the single-process stream, and the round trip must
    restore the input. Reference analog: DPU rank fan-out
    (snappy_compress.c:553-618)."""
    import json
    import os
    import socket
    import subprocess
    import sys

    txt, snappy = corpus_pair("plrabn12")
    src = tmp_path / "in.txt"
    src.write_bytes(txt)
    out = tmp_path / "out.snappy"
    dec = tmp_path / "roundtrip.txt"

    with socket.socket() as s:  # free coordinator port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    worker = pathlib.Path(__file__).parent / "multiproc_worker.py"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_NUM_CPU_DEVICES", None)
    procs = [
        subprocess.Popen(
            [
                sys.executable, str(worker), str(pid), str(nproc), str(port),
                str(src), str(out), str(dec),
                "32768" if engine == "native" else "1024", engine,
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(nproc)
    ]
    stats = []
    for p in procs:
        so, se = p.communicate(timeout=240)
        assert p.returncode == 0, f"worker failed:\n{se[-2000:]}"
        stats.append(json.loads(so.strip().splitlines()[-1]))

    # Cooperative stream == single-process stream, byte for byte (for the
    # native engine at 32K that IS the reference stream; the xla engine
    # emits its own conforming stream - require the round trip instead).
    if engine == "native":
        assert out.read_bytes() == snappy
    else:
        assert oracle.decompress(out.read_bytes()) == txt
    assert dec.read_bytes() == txt
    # Every process owned a real, disjoint share and reported phase times.
    ranges = sorted(tuple(s["process_blocks"]) for s in stats)
    assert ranges[0][0] == 0
    for (a0, a1), (b0, b1) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(s["compress_phases_s"]["kernel"] >= 0 for s in stats)


def test_walk_frame_table_rejects_zero_total_trailer(tmp_path):
    # Reviewer finding: a malformed stream claiming 0 decompressed bytes
    # but carrying frames must be rejected like the native scanner and
    # oracle do, not walked as zero-output blocks.
    from pim_compression_tpu.format.varint import encode_varint32
    from pim_compression_tpu.parallel.distributed import _walk_frame_table
    from pim_compression_tpu.utils.errors import SnappyError

    bad = tmp_path / "zero_total.snappy"
    bad.write_bytes(
        encode_varint32(0) + encode_varint32(32768)
        + (2).to_bytes(4, "little") + b"\x00\x00"
    )
    with pytest.raises(SnappyError):
        _walk_frame_table(bad)


@pytest.mark.parametrize(
    "local_rank,num_gpus,expected",
    [(0, 4, [0]), (3, 4, [3]), (1, 2, [1]), (0, 0, None), (5, 0, None)],
)
def test_local_device_ids_one_card_per_process(local_rank, num_gpus, expected):
    assert distributed.local_device_ids(local_rank, num_gpus) == expected


@pytest.mark.parametrize("local_rank,num_gpus", [(4, 4), (1, 1), (-1, 2)])
def test_local_device_ids_fails_without_a_card(local_rank, num_gpus):
    with pytest.raises(RuntimeError, match="no card of its own"):
        distributed.local_device_ids(local_rank, num_gpus)


def test_maybe_initialize_passes_the_rank_card(monkeypatch):
    # Four processes on one host of four cards: process 2 asks JAX for
    # card 2 alone, at the coordinator it was given.
    import jax

    seen = {}
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: seen.update(kw)
    )
    monkeypatch.setenv("PIM_NUM_PROCESSES", "4")
    monkeypatch.setenv("PIM_PROCESS_ID", "2")
    monkeypatch.setenv("PIM_COORDINATOR", "localhost:4321")
    monkeypatch.delenv("PIM_LOCAL_RANK", raising=False)
    assert distributed.maybe_initialize(num_gpus=4)
    assert seen == dict(
        coordinator_address="localhost:4321", num_processes=4, process_id=2,
        local_device_ids=[2],
    )
    monkeypatch.setenv("PIM_NUM_PROCESSES", "1")
    assert not distributed.maybe_initialize(num_gpus=4)
