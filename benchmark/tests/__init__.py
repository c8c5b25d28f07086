"""CPU tests of the benchmark harness (``python -m pytest benchmark/tests -q``)."""
