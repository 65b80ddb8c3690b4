"""Decode graph: the share of decode row-steps that a request keeps, the
batches' generated tokens over their rows times their decode steps (the
engine's ``repro_torch.serve.launch`` spans, one a step); a static batch
computes every row at every step, done or not."""

from portbench import spans


def read(rec):
    launches = spans.in_batches(rec, "launch")
    if launches is None:
        return None
    kept = sum(sum(b.generated) for b in rec.batches)
    row_steps = sum(b.size * len(steps)
                    for b, steps in zip(rec.batches, launches))
    return 100.0 * kept / row_steps
