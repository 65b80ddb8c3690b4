"""MoE FFN in the prefill: the host milliseconds of the engine's
``repro_torch.serve.moe`` spans (one a layer's routed and shared experts
in the prefill, the device drained at both ends, so each is the FFN's own
time), summed over the traced batches, per 1000 prompt tokens that the
requests asked for (padding not counted)."""

from portbench import spans


def read(rec):
    moe = spans.in_batches(rec, "moe")
    if moe is None:
        return None
    spent_ns = sum(e - s for batch in moe for s, e in batch)
    tokens = sum(sum(b.prompts) for b in rec.batches)
    return spent_ns / 1e6 / (tokens / 1000) if tokens else None
