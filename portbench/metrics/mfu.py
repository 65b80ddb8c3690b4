"""Whole step: the model FLOPs that the traced batches' requests asked for
(the model module's ``request_flops``: every matrix product of each
prompt token and each generated token fed back, the SSD at its least
work, the output head for the logits used; no padding), over the traced
window's seconds, as a share of the card's bf16 peak."""

from portbench import work


def read(rec):
    lo, hi = rec.trace.window
    if hi <= lo:
        return None
    flops = sum(rec.reference.request_flops(rec.model, p, g)
                for b in rec.batches for p, g in zip(b.prompts, b.generated))
    return 100.0 * flops / ((hi - lo) / 1e9) / work.PEAK_BF16_FLOPS
