"""The import guard: no module of the JAX side may be loaded in a run.

A module counts by its top-level name, the part before the first dot,
compared whole: ``repro_torch`` is the program, ``repro`` is the JAX
package it was ported from.
"""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(modules) -> list[str]:
    """The forbidden top-level names among the names in ``modules``."""
    return sorted({name.split(".", 1)[0] for name in modules}
                  & FORBIDDEN)
