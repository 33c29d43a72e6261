"""chip_smoke.py on the CPU: it refuses to report without a GPU, and its
phases pass at small sizes on the 8-device CPU mesh."""

import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_main_fails_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_main_fails_outside_the_repo(tmp_path):
    # A directory holding chip_smoke.py and nothing else of the repo.
    (tmp_path / "chip_smoke.py").write_bytes(
        (REPO / "chip_smoke.py").read_bytes()
    )
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("block_size", [1024, 4096, 65536])
def test_phase_blocks(block_size):
    (res,) = chip_smoke.phase_blocks({block_size: 3 * block_size + 777},
                                     seed=1, log=lambda m: None)
    assert res["ratio"] >= res["native_ratio"]


def test_phase_mixed():
    res = chip_smoke.phase_mixed(16 * 1024, 1024, seed=2, log=lambda m: None)
    assert res["raw_blocks"] >= 15


def test_phase_cli(capsys):
    chip_smoke.phase_cli(64 * 1024, 4096, seed=3)
    assert "cli -d" in capsys.readouterr().out


def test_phase_malformed():
    from pim_compression_tpu import runtime
    from pim_compression_tpu.utils import corpus
    from pim_compression_tpu.utils.config import CodecConfig

    stream = bytes(runtime.compress(
        corpus.xml_like(5 * 32768, 4), CodecConfig(engine="xla")
    ))
    chip_smoke.phase_malformed(stream, 32768, log=lambda m: None)


def test_bad_offset_payload_is_exact_length():
    # Only the offset is wrong: the oracle sees a full block and rejects
    # the backreference.
    from pim_compression_tpu.format import oracle

    payload = chip_smoke._bad_offset_payload(32768)
    with pytest.raises(ValueError, match="backreference"):
        oracle.decompress_block(memoryview(payload), bytearray(), 0)


def test_phase_malformed_catches_a_silent_decoder(monkeypatch):
    # A decoder that accepts everything must fail the phase.
    from pim_compression_tpu import runtime
    from pim_compression_tpu.utils import corpus
    from pim_compression_tpu.utils.config import CodecConfig

    stream = bytes(runtime.compress(
        corpus.xml_like(3 * 32768, 5), CodecConfig(engine="xla")
    ))
    monkeypatch.setattr(runtime, "decompress", lambda s, cfg: b"")
    with pytest.raises(chip_smoke.SmokeFailure, match="without error"):
        chip_smoke.phase_malformed(stream, 32768, log=lambda m: None)


def test_four_cards_path_on_cpu_mesh(capsys):
    chip_smoke.run_four_cards(seed=6, scale=1 / 2048)
    assert "byte-identical to one card" in capsys.readouterr().out


@pytest.mark.gpu
def test_one_card_path_on_gpu(capsys):
    # Every phase of the one-card run, at 1/16 of its size, on the card.
    chip_smoke.run_one_card(seed=7, scale=1 / 16)
    out = capsys.readouterr().out
    assert "malformed streams" in out and "cli -d" in out
