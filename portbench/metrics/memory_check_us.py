"""Memory watch (the accountant and the predictor, paper §3.2.2): the mean
host microseconds of the engine's ``repro_torch.serve.memory`` span, one
a decode step."""

from portbench import spans


def read(rec):
    checks = spans.in_batches(rec, "memory")
    if checks is None:
        return None
    took = [e - s for batch in checks for s, e in batch]
    return sum(took) / len(took) / 1e3
