"""One reader per per-layer metric, found by the metric's name.

Each module ``<metric>.py`` defines ``read(records) -> float | None`` over
a traced run's :class:`portbench.harness.Records`; ``None`` means it found
nothing to read, and the metric is left out of the result.
"""
