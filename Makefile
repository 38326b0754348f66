# Development targets.  The reference enforced pylint inside its test
# run (reference setup.cfg:4-6); here `make lint` + tests/test_lint.py
# provide the equivalent gate with the in-repo linter (tools/lint.py).

PYTHON ?= python

.PHONY: lint test bench smoke all

all: lint test

lint:
	$(PYTHON) tools/lint.py

test:
	$(PYTHON) -m pytest tests/ -q

bench:
	$(PYTHON) bench.py

smoke:
	$(PYTHON) chip_smoke.py
