"""Command line of the port's perf guard (counterpart of the reference's
``benchmarks/bench_guard.py`` shim): runs the ``bench_guard`` cell
(``experiments/cells/bench_guard.py``) against the port's floor file.

    PYTHONPATH=src python -m repro_torch.experiments.bench_guard [--floor-scale 100] [--write-floor]
"""

from repro_torch.experiments.cells.bench_guard import main

if __name__ == "__main__":
    raise SystemExit(main())
