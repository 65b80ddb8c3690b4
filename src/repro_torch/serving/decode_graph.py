"""The decode step, compiled once and replayed at every position: the
port's counterpart of the reference engine's ``jax.jit`` of
``decode_step`` (``repro/serving/engine.py:70-71``), called there with a
traced position.

:class:`DecodeGraph` is built for one (params, cfg, batch, max_context,
device) on the card.  It owns the step's static buffers: the caches of
``registry.init_caches``, a [B,1] int64 token, a 0-dim int64 position on
the device, and the logits that the captured ``registry.decode_step``
writes.  It captures the step once as a ``torch.cuda.CUDAGraph`` in a
memory pool of its own, after warm-up calls on a side stream (the torch
docs' recipe).  Each :meth:`DecodeGraph.step` copies the token in, fills
the position and replays; the caches are updated in place, as the eager
step updates them.  MoE layers run the capacity dispatch
(``capacity_moe=True``), the reference's own decode dispatch, which reads
nothing on the host; the dropless ``moe_tokens`` counts tokens per expert
on the host and stays with the prefill.

The warm-up and the capture write the caches at their position, so the
constructor zeroes every cache tensor afterwards, and :meth:`reset` zeroes
them again before another run: the caches then equal a fresh
``init_caches``, from which the prefill starts.

There is no fallback.  :class:`DecodeGraph` refuses any device but the
card, and a capture or replay that fails raises.  :class:`EagerDecode` is
the same interface run op by op, with the position as a device tensor all
the same, for a caller who asked for the CPU; :func:`decoder_for` picks
one of the two by the device asked for.
"""

from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry
from repro_torch.models.module import tree_leaves

#: eager calls before the capture, on a side stream (lazy initialisation of
#: cuBLAS handles and workspaces happens there, not inside the capture)
WARMUP_STEPS = 2


class EagerDecode:
    """Decode steps run op by op on ``device``, with the position passed
    as a 0-dim int64 tensor there, on caches it owns."""

    def __init__(self, params: dict, cfg: ModelConfig, batch: int,
                 max_context: int, device: str | torch.device) -> None:
        self.params, self.cfg = params, cfg
        self.device = torch.device(device)
        self.batch, self.max_context = batch, max_context
        with torch.inference_mode():
            self.caches = registry.init_caches(cfg, batch, max_context,
                                               self.device)

    def _run(self, token: torch.Tensor, index) -> torch.Tensor:
        logits, _ = registry.decode_step(self.params, self.cfg, token, index,
                                         self.caches, capacity_moe=True)
        return logits

    @torch.inference_mode()
    def step(self, token: torch.Tensor, index: int) -> torch.Tensor:
        """The logits [B,1,V] of one step at position ``index``, writing
        the caches there."""
        return self._run(token, torch.tensor(index, dtype=torch.int64,
                                             device=self.device))

    @torch.inference_mode()
    def reset(self) -> None:
        """Zero every cache tensor, as ``init_caches`` makes them."""
        for leaf in tree_leaves(self.caches):
            leaf.zero_()


class DecodeGraph(EagerDecode):
    """One decode step captured as a CUDA graph (see the module
    docstring).  ``capture_s`` is the host seconds that the warm-up and the
    capture took."""

    def __init__(self, params: dict, cfg: ModelConfig, batch: int,
                 max_context: int, device: str | torch.device) -> None:
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a decode graph is captured on the card, not "
                             f"on {device}; use EagerDecode there")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        super().__init__(params, cfg, batch, max_context, device)
        t0 = time.perf_counter()
        with torch.inference_mode(), torch.cuda.device(device):
            self.token = torch.zeros((batch, 1), dtype=torch.int64,
                                     device=device)
            self.index = torch.zeros((), dtype=torch.int64, device=device)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self._run(self.token, self.index)
            torch.cuda.current_stream(device).wait_stream(side)
            self.pool = torch.cuda.graph_pool_handle()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=self.pool):
                self.logits = self._run(self.token, self.index)
        self.reset()
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    @torch.inference_mode()
    def step(self, token: torch.Tensor, index: int) -> torch.Tensor:
        """Replay the step at position ``index`` on ``token`` [B,1]; the
        logits [B,1,V] come back in the graph's own buffer, which the next
        replay overwrites."""
        self.token.copy_(token)
        self.index.fill_(index)
        self.graph.replay()
        return self.logits


def decoder_for(params: dict, cfg: ModelConfig, batch: int,
                max_context: int, device: torch.device) -> EagerDecode:
    """A :class:`DecodeGraph` on the card, else an :class:`EagerDecode`
    on the device the caller asked for."""
    cls = DecodeGraph if torch.device(device).type == "cuda" else EagerDecode
    return cls(params, cfg, batch, max_context, device)
