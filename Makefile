# Convenience targets.  Tests run on the CPU; GPU runs go through
# chip_smoke.py / bench.py on a machine with a card.

PY_CPU := env JAX_PLATFORMS=cpu python3

.PHONY: test test-fast bench smoke native clean snapshot-check

native:
	python3 -c "from ndsm_tpu.native import build; print(build(force=True))"

test: native
	$(PY_CPU) -m pytest tests/ -q

test-fast: native
	$(PY_CPU) -m pytest tests/ -q -m "not slow"

bench:
	python3 bench.py

smoke:
	python3 chip_smoke.py

clean:
	rm -rf ndsm_tpu/native/_build
	find . -name __pycache__ -type d -exec rm -rf {} +

# Pre-snapshot gate: the suite and the graft entry must pass.  Exits
# nonzero on any failure.
snapshot-check: test
	env JAX_PLATFORMS=cpu \
	  XLA_FLAGS=--xla_force_host_platform_device_count=8 python3 -c \
	  "import __graft_entry__ as g; g.dryrun_multichip(8); \
	  fn, args = g.entry(); import jax; jax.block_until_ready(fn(*args)); \
	  print('graft entry OK')"
	@git status --porcelain || true
	@echo "snapshot-check PASSED"
