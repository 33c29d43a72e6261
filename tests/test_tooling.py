"""Smoke tests for the benchmark/chart/parser tooling (SURVEY §2.3): every
script analog of the reference's Python tooling must run end-to-end on
synthetic inputs — the reference's own scripts shipped with latent bugs
(run_tests.py generator-in-division, undefined args.d; SURVEY §2.3 notes),
so CI-exercised tooling is part of the parity story."""

import csv
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"


def run(args, **kw):
    proc = subprocess.run(
        [sys.executable, *args], capture_output=True, text=True,
        cwd=REPO, timeout=600, **kw,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def test_parse_output_human_and_json():
    sys.path.insert(0, str(SCRIPTS))
    import parse_output

    text = (
        "pre time: 0.001s\nkernel time: 0.5s\nCompression ratio: 0.741\n"
        '{"ratio": 0.741, "phases_s": {"kernel": 0.5}}\n'
    )
    r = parse_output.parse(text)
    assert r["ratio"] == pytest.approx(0.741)
    assert r["phases_s"]["kernel"] == pytest.approx(0.5)


def _bench_csv(tmp_path, rows):
    path = tmp_path / "bench.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    return path


BASE = {
    "file": "xml", "engine": "native", "block_size": 32768,
    "mesh_devices": "", "direction": "compress",
    "bytes": 1000000, "compressed_bytes": 300000, "ratio": 0.7,
    "wall_s": 0.5, "gbps": 2.0,
    "pre_s": 0.1, "h2d_s": 0.0, "kernel_s": 0.3, "d2h_s": 0.0,
    "post_s": 0.1,
}


def _rows(**variants):
    out = []
    keys = list(variants)
    for vals in zip(*variants.values()):
        r = dict(BASE)
        r.update(dict(zip(keys, vals)))
        out.append(r)
    return out


@pytest.mark.parametrize(
    "script,rows,extra",
    [
        (
            "chart_breakdown.py",
            _rows(engine=["native", "xla"]),
            ["--direction", "compress"],
        ),
        (
            "chart_ratio.py",
            _rows(block_size=[4096, 32768]),
            [],
        ),
        (
            "chart_speedup.py",
            _rows(engine=["native", "xla"], direction=["decompress"] * 2),
            [],
        ),
        (
            "chart_scaling.py",
            _rows(engine=["xla"] * 3, mesh_devices=[1, 2, 4],
                  gbps=[1.0, 1.9, 3.5]),
            [],
        ),
        (
            "chart_filesize.py",
            _rows(file=["a", "b"], bytes=[10**6, 10**7], gbps=[1.0, 2.0]),
            [],
        ),
    ],
)
def test_chart_scripts_render(tmp_path, script, rows, extra):
    csv_path = _bench_csv(tmp_path, rows)
    out = tmp_path / "chart.png"
    run([str(SCRIPTS / script), str(csv_path), "--out", str(out), *extra])
    assert out.exists() and out.stat().st_size > 1000


def test_run_benchmarks_oracle_smoke(tmp_path):
    out = tmp_path / "r.csv"
    run(
        [
            str(SCRIPTS / "run_benchmarks.py"), "--engines", "oracle",
            "--files", "alice", "--block-sizes", "32768", "--iters", "1",
            "--out", str(out),
        ]
    )
    rows = list(csv.DictReader(open(out)))
    assert {r["direction"] for r in rows} == {"compress", "decompress"}
    assert all(float(r["gbps"]) > 0 for r in rows)


def test_corpus_check_oracle():
    out = run([
        str(SCRIPTS / "corpus_check.py"), "--engine", "oracle", "--compress",
        "--files", "alice,coding,terror2",
    ])
    assert "corpus check: PASS" in out
    assert out.count("OK decompress") == 3


def test_bench_driver_contract():
    # bench.py prints ONE JSON line that names the device it measured
    # (here the CPU backend, at a small size).
    import json
    import os

    env = dict(os.environ)
    env.update(PIM_BENCH_MB="1", PIM_BENCH_ITERS="1")
    proc = subprocess.run(
        [sys.executable, str(REPO / "bench.py")],
        capture_output=True, text=True, cwd=REPO, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-1500:]
    lines = [l for l in proc.stdout.splitlines() if l.strip().startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(rec)
    assert rec["value"] > 0
    assert rec["device"]["platform"] == "cpu" and rec["device"]["kind"]


def test_cli_profile_smoke(tmp_path):
    # --profile writes a jax.profiler trace directory next to the output.
    src = tmp_path / "in.txt"
    src.write_bytes(b"profile me " * 2000)
    out = tmp_path / "out.snappy"
    run(
        [
            "-m", "pim_compression_tpu.cli", "-c", "-i", str(src),
            "-o", str(out), "--engine", "native",
            "--profile", str(tmp_path / "trace"),
        ]
    )
    assert out.exists()
    assert any((tmp_path / "trace").rglob("*")), "no profiler artifacts"
