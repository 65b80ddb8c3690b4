"""The train step, compiled once and replayed at every step: the port's
counterpart of the reference's ``jax.jit`` of its train step
(``repro/launch/train.py:53``, ``examples/quickstart.py:36``).

:class:`TrainGraph` is built for one (state, cfg, optimizer config, batch
shapes, microbatches, device) on the card.  It owns the step's static
buffers: one per batch key, one gradient per param, and the 0-dim
``loss``, ``aux_loss``, ``grad_norm`` and ``lr`` that the captured step
writes.  It captures forward, backward and the AdamW update once as a
``torch.cuda.CUDAGraph`` in a memory pool of its own, after warm-up steps
on a side stream (the torch docs' whole-network recipe), and each
:meth:`TrainGraph.step` copies the batch in and replays.  Params, moments
and the step counter are updated in place, as the eager step updates them.

What the capture needed, each solved here:

* **Gradients.** ``train_step`` sets every ``.grad`` to None, so each
  backward allocates new ones.  Here each param's gradient is a buffer the
  trainer owns for its lifetime, attached as ``.grad`` and zeroed in place
  at the top of the step; backward accumulates into it (autograd adds in
  place into an existing ``.grad``), and AdamW reads it.  A param that no
  loss reaches keeps a zero gradient, the eager step's ``zeros_like``.
  ``0 + g`` is ``g`` to the bit but for the sign of a zero, which no AdamW
  output keeps, so the step equals ``train_step`` bit for bit
  (``tests/test_torch_train_graph.py``).
* **Microbatches.** ``n_microbatches`` slices of the static batch are
  views; the captured region holds every slice's forward and backward,
  accumulating as the eager step does (``train_step.accumulate_grads``).
* **Checkpointing.** ``remat_layer``'s non-reentrant checkpoint reruns each
  layer's forward inside backward; both passes run on the capturing
  stream, so the graph holds them.  The layers draw no random numbers
  (``preserve_rng_state=False``), so no RNG state is read.
* **Warm-up and state.** The warm-up steps make cuBLAS handles and
  workspaces and autograd's lazy state outside the capture, but they also
  update the state.  The state is copied to the host before them and
  copied back after the capture (which runs nothing), so the first replay
  starts from the state the caller gave.
* **AdamW** keeps its step as a 0-dim int32 device tensor and computes the
  learning rate and bias corrections from it on the card; nothing reads a
  device value on the host (``tests/test_torch_train_graph.py`` runs the
  step on ``meta`` under a mode that refuses such reads).
* **Resume.** ``load_checkpoint`` returns new tensors, so a trainer is
  built after a resume, on the loaded state.

There is no fallback.  :class:`TrainGraph` refuses any device but the
card, and a capture or replay that fails raises.  :class:`EagerTrain` runs
the same step op by op, with the same gradient buffers, for a caller who
asked for the CPU; :func:`trainer_for` picks one of the two by the device
asked for.
"""

from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.training.optimizer import AdamWConfig, adamw_update
from repro_torch.training.train_step import accumulate_grads

#: eager steps before the capture, on a side stream (lazy initialisation of
#: cuBLAS handles and workspaces and of autograd happens there)
WARMUP_STEPS = 2


class EagerTrain:
    """Train steps run op by op on the state's device, into gradient
    buffers the trainer owns (see the module docstring)."""

    def __init__(self, state: dict, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 batch_shapes: dict, n_microbatches: int = 1) -> None:
        self.state, self.cfg, self.opt_cfg = state, cfg, opt_cfg
        self.batch_shapes = dict(batch_shapes)
        self.n_microbatches = n_microbatches
        params = state["params"]
        self.leaves = tree_leaves(params)
        self.device = self.leaves[0].device
        with torch.no_grad():
            self.grads = [torch.zeros_like(p) for p in self.leaves]
        by_param = {id(p): g for p, g in zip(self.leaves, self.grads)}
        self.grad_tree = tree_map(lambda p: by_param[id(p)], params)

    def _run(self, batch: dict) -> dict:
        """One step on ``batch``: the gradients attached and zeroed, the
        loss and its backward over the microbatches, the AdamW update."""
        for p, g in zip(self.leaves, self.grads):
            p.grad = g
            g.zero_()
        loss, aux = accumulate_grads(self.state["params"], self.cfg, batch,
                                     self.n_microbatches)
        _, _, info = adamw_update(self.state["params"], self.grad_tree,
                                  self.state["opt"], self.opt_cfg)
        return {"loss": loss, "aux_loss": aux, **info}

    def _check(self, batch: dict) -> None:
        got = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
        want = {k: (tuple(s), d) for k, (s, d) in self.batch_shapes.items()}
        if got != want:
            raise ValueError(f"batch {got} is not the trainer's {want}")

    def step(self, batch: dict) -> dict:
        """One optimizer step; the state is updated in place.  Returns
        ``loss``, ``aux_loss``, ``grad_norm`` and ``lr`` as 0-dim f32
        tensors."""
        self._check(batch)
        return self._run(batch)


class TrainGraph(EagerTrain):
    """One train step captured as a CUDA graph (see the module docstring).
    ``capture_s`` is the host seconds that the warm-up and the capture
    took, the state's round trip to the host included."""

    def __init__(self, state: dict, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 batch_shapes: dict, n_microbatches: int = 1) -> None:
        device = tree_leaves(state["params"])[0].device
        if device.type != "cuda":
            raise ValueError(f"a train graph is captured on the card, not "
                             f"on {device}; use EagerTrain there")
        t0 = time.perf_counter()
        super().__init__(state, cfg, opt_cfg, batch_shapes, n_microbatches)
        with torch.cuda.device(device):
            self.batch = {k: torch.zeros(shape, dtype=dtype, device=device)
                          for k, (shape, dtype) in self.batch_shapes.items()}
            kept = [t.detach().to("cpu", copy=True)
                    for t in tree_leaves(state)]
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self._run(self.batch)
            torch.cuda.current_stream(device).wait_stream(side)
            self.pool = torch.cuda.graph_pool_handle()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=self.pool):
                self.metrics = self._run(self.batch)
            with torch.no_grad():
                for t, host in zip(tree_leaves(state), kept):
                    t.copy_(host)
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    def step(self, batch: dict) -> dict:
        """Copy ``batch`` into the static inputs and replay; the metrics
        come back in the graph's own buffers, which the next replay
        overwrites."""
        self._check(batch)
        for k, buf in self.batch.items():
            buf.copy_(batch[k])
        self.graph.replay()
        return self.metrics


def trainer_for(state: dict, cfg: ModelConfig, opt_cfg: AdamWConfig,
                batch_shapes: dict, n_microbatches: int,
                device: torch.device) -> EagerTrain:
    """A :class:`TrainGraph` on the card, else an :class:`EagerTrain`;
    the state must lie on ``device``."""
    device = torch.device(device)
    on = tree_leaves(state["params"])[0].device
    if on.type != device.type:
        raise ValueError(f"the state lies on {on}, not on {device}")
    cls = TrainGraph if device.type == "cuda" else EagerTrain
    return cls(state, cfg, opt_cfg, batch_shapes, n_microbatches)
