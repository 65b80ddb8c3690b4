"""Decode graph of the hybrid MoE cell: ``decode_step_ms``'s reading (host
milliseconds from each traced batch's first ``cudaGraphLaunch`` to the
return of ``ServeEngine.run``, over the graph launches), for the cell
whose captured step runs Mamba2, attention and the MoE capacity
dispatch."""

from portbench.metrics.decode_step_ms import read  # noqa: F401
