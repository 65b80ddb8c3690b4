"""How ``correct`` is decided: the served tokens against the reference.

Once the window has closed, a sample of the finished requests, drawn from
the seed, is read again by the plain reference.  The engine pads each
prompt with token 0 to its batch's longest prompt, takes a first token
from the prefill's last logits, feeds it to the first decode step and
returns the tokens of the decode steps; so a request's row is its padded
prompt, that first token and every returned token but the last, and the
reference's logits at the last prompt position and after it give, for
the first token and each returned one, the gap by which its logit lies
below the reference's best.  The widest gap over the sample is
the number compared with the cell's limit.  Greedy serving of the same
function gives gaps of rounding size only where two logits nearly tie.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import exact


@dataclasses.dataclass
class Chosen:
    """A finished request: its prompt, its batch's padded prompt length,
    and the tokens the engine chose for it: the prefill's first and those
    it returned."""
    prompt: np.ndarray
    padded: int
    tokens: list[int]

    def row(self) -> np.ndarray:
        """The tokens the engine fed: padded prompt, then every chosen
        token but the last."""
        out = np.zeros(self.padded + len(self.tokens) - 1, np.int64)
        out[:len(self.prompt)] = self.prompt
        out[self.padded:] = self.tokens[:-1]
        return out


def sample(served: list[Chosen], rng: np.random.Generator, tokens: int,
           rows: int) -> list[Chosen]:
    """The request with the most served tokens, the one with the longest
    row, then requests in a random order until the sample holds at least
    ``tokens`` served tokens and ``rows`` requests."""
    if not served:
        return []
    first = {max(range(len(served)), key=lambda i: len(served[i].tokens)),
             max(range(len(served)), key=lambda i: len(served[i].row()))}
    order = list(first) + [int(i) for i in rng.permutation(len(served))
                           if int(i) not in first]
    out: list[Chosen] = []
    for i in order:
        if (sum(len(s.tokens) for s in out) >= tokens
                and len(out) >= rows):
            break
        out.append(served[i])
    return out


@torch.no_grad()
def logits_at(ref, weights: dict, m: dict, rows: list[Chosen],
              device: torch.device, cast=exact,
              block_tokens: int = 16384) -> torch.Tensor:
    """The logits [K, vocab] of the model module ``ref`` (the one the
    configuration names under ``reference/``) at every served position of
    ``rows``, in order, computed a block of rows at a time."""
    order = sorted(range(len(rows)), key=lambda i: len(rows[i].row()))
    blocks, cur = [], []
    for i in order:
        longest = len(rows[i].row())
        if cur and (len(cur) + 1) * longest > block_tokens:
            blocks.append(cur)
            cur = []
        cur.append(i)
    if cur:
        blocks.append(cur)
    found: dict[int, torch.Tensor] = {}
    for block in blocks:
        seqs = [rows[i].row() for i in block]
        toks = np.zeros((len(seqs), max(len(s) for s in seqs)), np.int64)
        for j, s in enumerate(seqs):
            toks[j, :len(s)] = s
        x = ref.hidden(weights, m, torch.from_numpy(toks).to(device), cast)
        for j, i in enumerate(block):
            lo = rows[i].padded - 1
            found[i] = ref.logits(weights, m,
                                  x[j, lo:lo + len(rows[i].tokens)], cast)
        del x
    return torch.cat([found[i] for i in range(len(rows))])


def widest_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which ``tokens`` [K] lie below the best of
    ``ref_logits`` [K, V]."""
    best = ref_logits.max(dim=-1).values
    chosen = ref_logits.gather(-1, tokens[:, None].long())[:, 0]
    return float((best - chosen).max())


def chosen_tokens(rows: list[Chosen], device) -> torch.Tensor:
    return torch.tensor([t for r in rows for t in r.tokens],
                        dtype=torch.int64, device=device)


def precise_matmuls() -> None:
    """float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
