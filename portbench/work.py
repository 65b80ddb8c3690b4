"""Operations and bytes counted from shapes: the benchmark's yardstick.

``attention_work``, ``ssd_work`` and ``ssd_least_flops`` are frozen copies
of ``chip_smoke.py``'s functions of those names; the work a model's served
request asks for is its reference module's ``request_flops``
(:mod:`portbench.reference`).  The peaks are those of one NVIDIA H100 SXM
(the data sheet; dense, at the 700 W limit).  Nothing here imports the
program.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def attention_work(b, h, kh, s, d, itemsize, causal, window):
    """Bytes (q, k, v read once, o written once) and FLOPs (2 products of
    2*D per visible query-key pair) of one attention call."""
    pairs = 0
    for qpos in range(s):
        lo = 0 if window is None else max(0, qpos - window + 1)
        hi = qpos + 1 if causal else s
        pairs += hi - lo
    nbytes = itemsize * d * s * b * (2 * h + 2 * kh)
    return nbytes, 4 * d * pairs * b * h


def ssd_work(b, s, h, p, n, chunk, itemsize):
    """Bytes (x, dt, a, B, C read once; y and the final state written once)
    and the FLOPs the function needs: per (b, chunk) one causal C B^T (2 N
    per pair i <= j; B and C are shared by the heads), and per (b, h,
    chunk) scores @ dt x over the same pairs (2 P each), the state update
    (2 Q N P) and, after the first chunk, whose state is zero, C . state
    (2 Q N P)."""
    nbytes = (2 * itemsize * b * s * h * p
              + 4 * (b * s * h + h + 2 * b * s * n + b * h * p * n))
    flops = 0
    for start in range(0, s, chunk):
        q = min(chunk, s - start)
        pairs = q * (q + 1) // 2
        inter = 2 * q * n * p if start else 0
        flops += b * 2 * n * pairs + b * h * (2 * p * pairs
                                              + 2 * q * n * p + inter)
    return nbytes, flops


def ssd_least_flops(b, s, h, p, n):
    """The least FLOPs of the function over every blocking of the sequence
    (the result does not depend on it): ssd_work's count at the chunk that
    needs fewest, which is one row, the plain recurrence."""
    return min(ssd_work(b, s, h, p, n, q, 4)[1] for q in range(1, s + 1))


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card needs: the larger of the operations at
    the bf16 peak and the bytes at the memory peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)

