"""Engine prefill: host milliseconds from each traced batch's call to
``ServeEngine.run`` to its first ``cudaGraphLaunch`` (the prefill and
the host work before the first decode step), summed over the batches,
per 1000 prompt tokens that the requests asked for (padding not
counted)."""


def read(rec):
    spent_ns, tokens = 0, 0
    for (start, end), batch in zip(rec.trace.batches, rec.batches):
        first = next((t for t in rec.trace.graph_launches
                      if start <= t < end), None)
        if first is None:
            return None
        spent_ns += first - start
        tokens += sum(batch.prompts)
    return spent_ns / 1e6 / (tokens / 1000) if tokens else None
