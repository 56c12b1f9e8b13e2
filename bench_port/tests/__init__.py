"""CPU tests of the benchmark (python -m pytest bench_port/tests -q)."""
