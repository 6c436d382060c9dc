"""CPU tests of the benchmark (see conftest.py)."""
