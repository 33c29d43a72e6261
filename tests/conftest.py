"""Test configuration.

Tests run on a virtual 8-device CPU mesh (the analog of the reference's DPU
functional simulator, see SURVEY.md §4); the device count is set here,
before any JAX backend starts. The corpus is the seeded stand-in from
``pim_compression_tpu.utils.corpus``. Tests that need a GPU carry the
``gpu`` marker and skip on hosts without one.
"""

import functools

import jax
import pytest

jax.config.update("jax_num_cpu_devices", 8)

from pim_compression_tpu.utils import corpus  # noqa: E402

CORPUS_PAIRS = list(corpus.TEXT_SIZES)


@functools.lru_cache(maxsize=None)
def corpus_pair(name: str) -> tuple[bytes, bytes]:
    """(plain, .snappy twin) of one corpus file."""
    plain = corpus.generate(name)
    return plain, corpus.twin(plain)


@pytest.fixture(scope="session")
def corpus_dir(tmp_path_factory):
    """The corpus written to disk as ``<name>.txt`` / ``<name>.snappy``."""
    return corpus.write(tmp_path_factory.mktemp("corpus"))


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` skip on hosts without one (decided per test,
    never at import, so every xdist worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU")
