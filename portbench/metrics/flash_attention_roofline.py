"""Kernels: the flash-attention kernel's share of its roofline.  The least
time of every flash launch in the traced batches (the larger of its
operations, two products of 2 D a visible query-key pair, at the bf16 peak
and its bytes, q, k, v and o once in bf16, at the memory peak;
``work.attention_work`` at the batch's padded prompt length, causal, with
the model module's heads, KV heads and head dim), summed, over the
launches' summed device time.  Nothing is read unless the model module
gives the attention's shape and every attention layer of every traced
batch launched the kernel once."""

from portbench import work

#: the common part of both routes' kernel names (flash_fwd_sm90_kernel,
#: flash_fwd_kernel)
KERNEL = "flash_fwd"
BF16_BYTES = 2


def read(rec):
    shape = getattr(rec.reference, "attention_shape", None)
    if shape is None:
        return None
    layers, h, kh, d = shape(rec.model)
    launches = [(s, e) for name, s, e in rec.trace.ops if KERNEL in name]
    if not launches or len(launches) != layers * len(rec.batches):
        return None
    bound = 0.0
    for b in rec.batches:
        nbytes, flops = work.attention_work(b.size, h, kh, b.padded, d,
                                            BF16_BYTES, True, None)
        bound += layers * work.bound_s(flops, nbytes)
    spent = sum(e - s for s, e in launches) / 1e9
    return 100.0 * bound / spent
