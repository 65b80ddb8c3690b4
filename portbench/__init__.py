"""The port's benchmark: one cell of BENCHMARK.json per run (``run.py``)."""
