"""The one traffic generator: batches of requests from a mix file's
parameters and the seed.

A mix gives the distribution of prompt and new-token lengths, each
log-uniform between ``{"low": a, "high": b}``.  Every batch of B
requests takes the B quantiles at (i + 0.5) / B of each distribution
(rounded to whole tokens), so every batch, and every seed, serves the same
set of lengths; the seed deals the prompt lengths and the new-token
lengths to the rows in an order of its own for each batch, and draws the
prompt tokens uniformly from the vocabulary.  The context a cell's engine
needs is the longest prompt plus the most new tokens.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def quantiles(dist: dict, n: int) -> list[int]:
    lo, hi = dist["low"], dist["high"]
    return [int(round(math.exp(math.log(lo) + (i + 0.5) / n
                               * math.log(hi / lo)))) for i in range(n)]


def context(mix: dict) -> int:
    return math.ceil(mix["prompt_tokens"]["high"] + mix["new_tokens"]["high"])


@dataclasses.dataclass
class Planned:
    """One request as the generator dealt it."""
    prompt: np.ndarray
    max_new_tokens: int


class Traffic:
    """Batches of ``batch`` requests from ``mix`` for a vocabulary of
    ``vocab`` tokens; ``stream`` separates independent uses of one seed."""

    def __init__(self, mix: dict, batch: int, vocab: int, seed: int,
                 stream: int) -> None:
        self.rng = np.random.default_rng([seed, stream])
        self.vocab = vocab
        self.prompts = quantiles(mix["prompt_tokens"], batch)
        self.news = quantiles(mix["new_tokens"], batch)

    def batch(self) -> list[Planned]:
        prompts = self.rng.permutation(self.prompts)
        news = self.rng.permutation(self.news)
        return [Planned(self.rng.integers(0, self.vocab, int(p),
                                          dtype=np.int32), int(n))
                for p, n in zip(prompts, news)]
