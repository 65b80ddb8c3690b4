"""Kernels: the SSD chunk-scan kernel's share of its roofline.  The least
time of every SSD launch in the traced batches (the larger of the least
FLOPs over blockings at the bf16 peak and the bytes read and written once
at the memory peak, at the batch's padded prompt length and the
configuration's own state size N), summed, over the launches' summed
device time.  Nothing is read unless the model module gives the SSD's
shape and every layer of every traced batch launched the kernel once."""

from portbench import work

KERNEL = "ssd_scan"


def read(rec):
    shape = getattr(rec.reference, "ssd_shape", None)
    if shape is None:
        return None
    layers, h, p, n = shape(rec.model)
    launches = [(s, e) for name, s, e in rec.trace.ops if KERNEL in name]
    if not launches or len(launches) != layers * len(rec.batches):
        return None
    bound = sum(layers * work.bound_s(
        work.ssd_least_flops(b.size, b.padded, h, p, n),
        work.ssd_work(b.size, b.padded, h, p, n, 1, 2)[0])
        for b in rec.batches)
    spent = sum(e - s for s, e in launches) / 1e9
    return 100.0 * bound / spent
