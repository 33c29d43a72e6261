"""CLI tests: flag compatibility, stdout contract, error paths."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def run_cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "pim_compression_tpu.cli", *args],
        capture_output=True,
        text=True,
        cwd=cwd,
        env={
            "PATH": "/usr/bin:/bin",
            "PYTHONPATH": str(REPO),
            "JAX_PLATFORMS": "cpu",
            "HOME": os.environ.get("HOME", ""),
        },
    )


@pytest.fixture
def tmp_cwd(tmp_path):
    return tmp_path


def test_cli_decompress_golden(corpus_dir, tmp_cwd):
    r = run_cli("-i", str(corpus_dir / "coding.snappy"), "-o", "out.bin", cwd=tmp_cwd)
    assert r.returncode == 0, r.stderr
    assert "Compression ratio:" in r.stdout
    assert "kernel time:" in r.stdout
    assert (tmp_cwd / "out.bin").read_bytes() == (corpus_dir / "coding.txt").read_bytes()


def test_cli_compress_bit_exact(corpus_dir, tmp_cwd):
    r = run_cli("-c", "-i", str(corpus_dir / "coding.txt"), "-o", "out.snappy", cwd=tmp_cwd)
    assert r.returncode == 0, r.stderr
    assert (tmp_cwd / "out.snappy").read_bytes() == (
        corpus_dir / "coding.snappy"
    ).read_bytes()


def test_cli_block_size_flag(tmp_cwd):
    src = tmp_cwd / "in.txt"
    src.write_bytes(b"block size flag test " * 500)
    r = run_cli("-c", "-b", "1024", "-i", str(src), "-o", "c.snappy", cwd=tmp_cwd)
    assert r.returncode == 0, r.stderr
    r = run_cli("-i", "c.snappy", "-o", "rt.txt", cwd=tmp_cwd)
    assert r.returncode == 0, r.stderr
    assert (tmp_cwd / "rt.txt").read_bytes() == src.read_bytes()


def test_cli_json_metrics(corpus_dir, tmp_cwd):
    r = run_cli(
        "-c", "-i", str(corpus_dir / "alice.txt"), "-o", "a.snappy", "--json",
        cwd=tmp_cwd,
    )
    assert r.returncode == 0
    import json

    line = [l for l in r.stdout.splitlines() if l.startswith("{")][0]
    m = json.loads(line)
    assert m["engine"] == "native"
    assert m["original_bytes"] == 312


def test_cli_missing_input(tmp_cwd):
    r = run_cli("-i", "nope.bin", cwd=tmp_cwd)
    assert r.returncode == 2
    assert "not found" in r.stderr


def test_cli_bad_block_size(tmp_cwd):
    (tmp_cwd / "x").write_bytes(b"x")
    r = run_cli("-c", "-b", "999999", "-i", "x", cwd=tmp_cwd)
    assert r.returncode == 2
    assert "block_size" in r.stderr


def test_cli_corrupt_stream(tmp_cwd):
    (tmp_cwd / "bad.snappy").write_bytes(b"\xff" * 40)
    r = run_cli("-i", "bad.snappy", cwd=tmp_cwd)
    assert r.returncode == 1
    assert "error" in r.stderr


def test_cli_d_selects_xla_engine(tmp_path, capsys):
    # -d is the reference's "use the device" flag; it maps to the xla
    # engine, in-process (both directions).
    import pim_compression_tpu.cli as cli

    src = tmp_path / "in.txt"
    src.write_bytes(b"device flag check " * 400)
    comp, back = tmp_path / "c.snappy", tmp_path / "rt.txt"
    assert cli.main(["-d", "-c", "-i", str(src), "-o", str(comp)]) == 0
    assert "Using xla engine for compression" in capsys.readouterr().out
    assert cli.main(["-d", "-i", str(comp), "-o", str(back)]) == 0
    assert "Using xla engine for decompression" in capsys.readouterr().out
    assert back.read_bytes() == src.read_bytes()


def test_cli_rejects_pallas_engine(tmp_path):
    (tmp_path / "x").write_bytes(b"x")
    r = run_cli("--engine", "pallas", "-c", "-i", "x", cwd=tmp_path)
    assert r.returncode == 2
    assert "invalid choice" in r.stderr
