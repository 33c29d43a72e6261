# Top-level convenience targets (role of the reference's snappy/Makefile).

.PHONY: all native test test-corpus smoke bench clean

all: native

native:
	$(MAKE) -C pim_compression_tpu/native

# Every engine's correctness gates, on a virtual 8-device CPU mesh
# (tests/conftest.py).
test: native
	python -m pytest tests/ -x -q

# Golden-file corpus check, mirroring the reference's `make test` cmp
# harness (snappy/Makefile:44-60), through the device engine on the
# seeded corpus. With COMPRESS=1 the re-compressed streams must be
# oracle-valid and no larger than the native codec's.
test-corpus: native
	python scripts/corpus_check.py --engine xla $(if $(COMPRESS),--compress)

# The main path end to end on one GPU (fails on a host without one).
smoke: native
	python chip_smoke.py

# Compiled programs persist in $$JAX_COMPILATION_CACHE_DIR when it is set,
# else in <checkout>/.jax_cache, so a second run skips compilation.
bench: native
	python bench.py

clean:
	$(MAKE) -C pim_compression_tpu/native clean
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
