"""Decode graph: host milliseconds from each traced batch's first
``cudaGraphLaunch`` to the return of ``ServeEngine.run``, over the graph
launches of the batches (the replay and the engine's host work of each
step)."""


def read(rec):
    spent_ns, steps = 0, 0
    for start, end in rec.trace.batches:
        launches = [t for t in rec.trace.graph_launches if start <= t < end]
        if not launches:
            return None
        spent_ns += end - launches[0]
        steps += len(launches)
    return spent_ns / 1e6 / steps
