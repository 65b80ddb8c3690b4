"""Engine host work between decode steps: the device's wait on the
engine, in milliseconds, averaged over the decode steps that have a next
step: from the end of the step's ``repro_torch.serve.sync`` span (the
stream drained, the token on the host) to the start of the first device
operation after it, the next step's token copy (the graph's own kernels
may start later, once its launch is enqueued)."""

import bisect

from portbench import spans


def read(rec):
    syncs = spans.in_batches(rec, "sync")
    if syncs is None:
        return None
    starts = [s for _, s, _ in rec.trace.ops]
    gaps = []
    for batch in syncs:
        for _, end in batch[:-1]:
            i = bisect.bisect_left(starts, end)
            if i < len(starts):
                gaps.append(starts[i] - end)
    return sum(gaps) / len(gaps) / 1e6 if gaps else None
