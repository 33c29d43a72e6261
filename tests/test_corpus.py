"""The seeded corpus: pinned twins, the reference's sizes, and the
compile-cache location the package picks on import."""

import pathlib

import pytest

import pim_compression_tpu
from pim_compression_tpu.format import oracle
from pim_compression_tpu.utils import corpus

from conftest import corpus_pair


@pytest.mark.parametrize("name", corpus.NAMES)
def test_twin_digest_pinned(name):
    # The generator and the native codec reproduce the committed twins.
    _, snappy = corpus_pair(name)
    assert corpus.digest(snappy) == corpus.DIGESTS[name]


@pytest.mark.parametrize(
    "name,size", [*corpus.TEXT_SIZES.items(), ("xml", 5_345_280)]
)
def test_reference_sizes(name, size):
    plain, snappy = corpus_pair(name)
    assert len(plain) == size
    assert oracle.scan_block_frames(snappy)[0] == size


def test_seed_changes_content():
    assert corpus.generate("coding", 0) != corpus.generate("coding", 1)
    assert corpus.generate("coding", 1) == corpus.generate("coding", 1)


def test_random_is_incompressible():
    plain, snappy = corpus_pair("random")
    assert len(snappy) > len(plain)


def test_write_corpus(tmp_path):
    d = corpus.write(tmp_path / "c")
    assert sorted(p.name for p in d.iterdir()) == sorted(
        f"{n}.{ext}" for n in corpus.NAMES for ext in ("txt", "snappy")
    )
    assert (d / "alice.snappy").read_bytes() == corpus_pair("alice")[1]


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert pim_compression_tpu.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = pathlib.Path(__file__).resolve().parent.parent
    assert pim_compression_tpu.compile_cache_dir() == str(repo / ".jax_cache")


def test_compile_cache_dir_set_on_import():
    import jax

    assert jax.config.jax_compilation_cache_dir == (
        pim_compression_tpu.compile_cache_dir()
    )
