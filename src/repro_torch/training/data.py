"""Deterministic synthetic data pipeline (own copy of the reference's
``repro/training/data.py`` generator).

Token batches come from a Zipf-ish bigram stream with local structure, so
the loss actually decreases, plus the stub-frontend tensors of the audio
and VLM families.  Generation is host-side numpy with the reference's exact
``np.random.default_rng`` call sequence, so a seed gives the reference's
tokens and labels bit for bit; each batch is then moved to an explicit
device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class DataConfig:
    batch: int
    seq: int
    seed: int = 0


class SyntheticLM:
    """Markov-ish synthetic corpus: learnable structure, zero I/O."""

    def __init__(self, cfg: ModelConfig, data: DataConfig,
                 device: str | torch.device = "cpu") -> None:
        self.cfg = cfg
        self.data = data
        self.device = torch.device(device)
        self.rng = np.random.default_rng(data.seed)
        v = min(cfg.vocab, 32768)
        self._vocab = v
        # sparse bigram table: each token has a few likely successors
        self._succ = self.rng.integers(0, v, size=(v, 4))

    def _sample_sequence(self, length: int) -> np.ndarray:
        v = self._vocab
        out = np.empty(length, np.int32)
        tok = int(self.rng.integers(0, v))
        for i in range(length):
            out[i] = tok
            if self.rng.random() < 0.8:  # follow the bigram structure
                tok = int(self._succ[tok, self.rng.integers(0, 4)])
            else:
                tok = int(self.rng.integers(0, v))
        return out

    def _stub(self, n: int) -> torch.Tensor:
        """[B, n, d] stub-frontend embeddings, drawn in f64 and stored in
        bf16 as the reference stores them."""
        b, d = self.data.batch, self.cfg.d_model
        x = self.rng.standard_normal((b, n, d)) * 0.02
        return torch.from_numpy(x).to(self.device, torch.bfloat16)

    def shapes(self) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """``{key: (shape, dtype)}`` of every batch :meth:`batches`
        yields."""
        b, s, d = self.data.batch, self.data.seq, self.cfg.d_model
        out = {"tokens": ((b, s), torch.int64),
               "labels": ((b, s), torch.int64)}
        if self.cfg.family == "audio":
            out["frames"] = ((b, self.cfg.enc_seq, d), torch.bfloat16)
        if self.cfg.family == "vlm" and self.cfg.vision_tokens:
            out["patches"] = ((b, self.cfg.vision_tokens, d), torch.bfloat16)
        return out

    def batches(self) -> Iterator[dict]:
        """Endless batches: ``tokens``/``labels`` [B, S] int64 (labels are
        the tokens shifted by one), and ``frames`` (audio) or ``patches``
        (VLM) where the config has them."""
        b, s = self.data.batch, self.data.seq
        while True:
            toks = torch.from_numpy(
                np.stack([self._sample_sequence(s + 1) for _ in range(b)])
            ).long()
            batch = {"tokens": toks[:, :-1].to(self.device),
                     "labels": toks[:, 1:].to(self.device)}
            if self.cfg.family == "audio":
                batch["frames"] = self._stub(self.cfg.enc_seq)
            if self.cfg.family == "vlm" and self.cfg.vision_tokens:
                batch["patches"] = self._stub(self.cfg.vision_tokens)
            yield batch


def shard_batch(batch: dict, mesh, specs) -> dict:
    """Each tensor of ``batch`` as a DTensor on ``mesh``, placed by its
    entry of ``specs`` (a dict of per-key placements, or one placement
    list for every key), as the reference's ``device_put`` with a
    sharding per key."""
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(v, mesh, specs[k] if isinstance(specs, dict)
                                 else specs) for k, v in batch.items()}
