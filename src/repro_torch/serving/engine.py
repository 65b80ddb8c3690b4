"""Batched serving engine with allocator instrumentation.

The engine runs prefill + greedy decode for a batch of requests; the
:class:`MemoryAccountant` records per-iteration requested/live bytes
(params, KV cache growth, activation churn), and the
:class:`PeakMemoryPredictor` watches the series.  When the converged
prediction exceeds the partition the engine raises
:class:`NeedsLargerPartition` (the early restart) and the launcher
regrows the slice.  Same fields, accounting and restart trade as the
reference engine (``repro.serving.engine``); prefill is one forward over
the prompt batch that fills the caches
(:func:`repro_torch.models.registry.prefill_caches`), after the encoder
has filled the cross K/V for the encoder-decoder, from zero frames as in
the reference.  On the card the decode loop replays one captured CUDA
graph of the step (:class:`~repro_torch.serving.decode_graph.DecodeGraph`,
the counterpart of the reference's ``jax.jit`` of ``decode_step``), kept
per (batch, max_context) and captured at the first run of that shape; the
prefill runs eagerly into the graph's caches.  On the CPU the same loop
runs op by op (:class:`~repro_torch.serving.decode_graph.EagerDecode`).
Either way the position is a device tensor and MoE layers decode through
the capacity dispatch, the reference's decode dispatch.

Each stage of :meth:`ServeEngine.run` is a span named ``SPAN + stage``
(:func:`repro_torch.obs.trace.wall_span`): a ``record_function`` range
while a ``torch.profiler`` records, and a record in the engine's wall
:class:`~repro_torch.obs.trace.Tracer` when it has one; the stages are
``run``, ``capture`` (a new decode step's warm-up and capture), ``reset``
(a seen shape's caches zeroed), ``prefill``, and per decode step
``launch`` (the token in, the replay enqueued), ``sync`` (the next token
on the host), ``tokens`` (appended) and ``memory`` (the accountant and the
predictor).  ``restart`` is an instant where the early restart is raised.
With a tracer, each run ends with one counter of each of: the batch's
padding (``padding_tokens``: B x padded length - the prompt tokens), its
decode row-steps (``decode_row_steps``: steps x B) and those of rows
already done (``decode_rows_done``), the accountant's peak
(``accountant_peak_bytes``), the allocator's on the card
(``allocator_peak_bytes``: the caller resets it), and whether the run
raised the early restart (``restarts``); for a model with routed experts
also the decode steps' expert rows the requests asked for
(``moe_routed_rows``: the tokens decoded x k x MoE layers) and those the
capacity dispatch computed (``moe_expert_rows``: steps x B x capacity x
experts x MoE layers).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.memory.accountant import MemoryAccountant, pytree_nbytes
from repro_torch.core.memory.timeseries import PeakMemoryPredictor
from repro_torch.core.partition_state import PartitionBackend, PartitionProfile
from repro_torch.core.restart import NeedsLargerPartition, early_restart_target
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models.moe import capacity
from repro_torch.models.module import tree_leaves
from repro_torch.obs.trace import Tracer, wall_instant, wall_span
from repro_torch.serving.decode_graph import EagerDecode, decoder_for

GB = 1024 ** 3
#: the prefix of the engine's span, instant and counter names
SPAN = "repro_torch.serve."


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_context: int = 512
    partition_gb: float | None = None      # slice the engine believes it has
    predict: bool = True                   # paper: time-series early restart
    #: SLO-aware restart trade: when both are set, the engine restarts as
    #: soon as the predictor's graded OOM risk prices the expected crash
    #: (``risk * crash_cost_s``) above one restart (``restart_cost_s``).
    #: Left at 0.0, the paper's binary trigger is unchanged.
    crash_cost_s: float = 0.0
    restart_cost_s: float = 0.0


class ServeEngine:
    """Greedy batched decode over a fixed request batch, on ``device``
    (the card unless the caller passes ``device='cpu'``); ``tracer``, a
    :meth:`Tracer.wall`, records its spans and counters (``None``: the
    untraced path)."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 engine_cfg: EngineConfig,
                 backend: PartitionBackend | None = None,
                 device: str | torch.device | None = None,
                 tracer: Tracer | None = None) -> None:
        self.device = resolve_device(device)
        for leaf in tree_leaves(params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"params on {leaf.device}, engine on "
                                 f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.ecfg = engine_cfg
        self.backend = backend
        self.tracer = tracer
        self._reset_run_state()
        self._params_bytes = pytree_nbytes(params)
        #: the decode step per (batch, max_context): a captured graph on
        #: the card, reused (its caches zeroed) by later runs of the shape
        self.decoders: dict[tuple[int, int], EagerDecode] = {}

    def _reset_run_state(self) -> None:
        """Fresh per-run accounting: a second batch on the same engine must
        not inherit the previous run's live watermark nor its predictor."""
        self.accountant = MemoryAccountant()
        self.predictor = PeakMemoryPredictor(max_iter=self.ecfg.max_context)
        self._last_live = 0.0

    # -- serving loop ------------------------------------------------------------

    @torch.inference_mode()
    def run(self, requests: list[Request]) -> list[Request]:
        cfg, ecfg, tracer = self.cfg, self.ecfg, self.tracer
        if len(requests) > ecfg.max_batch:
            raise ValueError(f"{len(requests)} requests > max_batch "
                             f"{ecfg.max_batch}")
        self._reset_run_state()
        b = len(requests)
        prompt_len = max(len(r.prompt) for r in requests)
        prompt_tokens = sum(len(r.prompt) for r in requests)
        kept_before = sum(len(r.generated) for r in requests)
        steps = restarts = 0
        try:
            with wall_span(tracer, SPAN + "run", batch=b, padded=prompt_len,
                           prompt_tokens=prompt_tokens):
                decoder = self._decoder(b)
                caches = decoder.caches

                # prefill: one forward over the padded prompt batch fills
                # the cache
                with wall_span(tracer, SPAN + "prefill"):
                    toks = np.zeros((b, prompt_len), np.int64)
                    for i, r in enumerate(requests):
                        toks[i, :len(r.prompt)] = r.prompt
                    tokens = torch.from_numpy(toks).to(self.device)
                    if cfg.family == "audio":
                        frames = torch.zeros((b, cfg.enc_seq, cfg.d_model),
                                             dtype=torch.bfloat16,
                                             device=self.device)
                        caches = registry.prefill_encoder(
                            self.params, cfg, {"frames": frames}, caches)
                    logits, caches = registry.prefill_caches(
                        self.params, cfg, tokens, caches)
                    self._note_iteration(caches, prompt_len)
                    next_tok = torch.argmax(logits[:, -1, :cfg.vocab],
                                            dim=-1)[:, None]

                # decode
                for step in range(max(r.max_new_tokens for r in requests)):
                    pos = prompt_len + step
                    if pos >= ecfg.max_context:
                        break
                    with wall_span(tracer, SPAN + "launch"):
                        logits = decoder.step(next_tok, pos)
                    steps += 1
                    with wall_span(tracer, SPAN + "sync"):
                        next_tok = torch.argmax(logits[:, -1, :cfg.vocab],
                                                dim=-1)[:, None]
                        toks_np = next_tok[:, 0].cpu().numpy()
                    with wall_span(tracer, SPAN + "tokens"):
                        for i, r in enumerate(requests):
                            if not r.done:
                                r.generated.append(int(toks_np[i]))
                    with wall_span(tracer, SPAN + "memory"):
                        self._check_memory(caches, pos, step)
        except NeedsLargerPartition:
            restarts = 1
            raise
        finally:
            if tracer is not None:
                kept = sum(len(r.generated) for r in requests) - kept_before
                counts = {"padding_tokens": b * prompt_len - prompt_tokens,
                          "decode_row_steps": steps * b,
                          "decode_rows_done": steps * b - kept,
                          "accountant_peak_bytes":
                              self.accountant.peak_in_use,
                          "restarts": restarts}
                counts.update(_moe_rows(cfg, b, steps, kept))
                if self.device.type == "cuda":
                    counts["allocator_peak_bytes"] = (
                        torch.cuda.max_memory_allocated(self.device))
                t = tracer.wall_seconds(time.time_ns())
                for name, value in counts.items():
                    tracer.counter(SPAN + name, value, t=t)
        return requests

    def _decoder(self, batch: int) -> EagerDecode:
        """The decode step for ``batch`` requests, its caches zeroed: a
        shape seen before reuses its capture."""
        key = (batch, self.ecfg.max_context)
        decoder = self.decoders.get(key)
        if decoder is None:
            with wall_span(self.tracer, SPAN + "capture"):
                decoder = self.decoders[key] = decoder_for(
                    self.params, self.cfg, batch, self.ecfg.max_context,
                    self.device)
        else:
            with wall_span(self.tracer, SPAN + "reset"):
                decoder.reset()
        return decoder

    # -- instrumentation (paper §3.2.2) --------------------------------------------

    def _live_bytes(self, caches, upto: int) -> float:
        """Live = params + the *used* prefix of the KV cache + activations.

        The cache tensor is preallocated at max_context; physically-used
        bytes grow with the context, the growth the predictor must catch.
        """
        cache_total = pytree_nbytes(caches)
        frac = min(1.0, upto / self.ecfg.max_context)
        if self.cfg.family == "ssm":
            frac = 1.0  # constant-size recurrent state
        # the hybrid MoE's Mamba2 states are whole from the start; its K/V
        # grow with the context
        fixed = (pytree_nbytes(caches["ssm"])
                 if self.cfg.family == "hybrid_moe" else 0)
        act = self._params_bytes * 0.002 + 4 * self.cfg.d_model * 1024
        return (self._params_bytes + fixed + (cache_total - fixed) * frac
                + act)

    def _note_iteration(self, caches, upto: int) -> None:
        live = self._live_bytes(caches, upto)
        churn = 2 * self.cfg.d_model * max(self.cfg.d_ff, self.cfg.d_model) \
            * 2e-3 + live * 0.01
        self.accountant.note_alloc(churn + max(0.0, live - self._last_live))
        self.accountant.note_live(live)
        self._last_live = live
        self.accountant.end_iteration()

    def _restart_now(self, partition_bytes: float, pred) -> bool:
        """The early-restart decision: the graded SLO trade when priced
        (expected crash seconds vs one restart), else the paper's binary
        converged-prediction threshold."""
        if self.ecfg.crash_cost_s > 0.0 and self.ecfg.restart_cost_s > 0.0:
            if not pred.converged:
                return False
            risk = self.predictor.oom_risk(partition_bytes, pred)
            return risk * self.ecfg.crash_cost_s > self.ecfg.restart_cost_s
        return self.predictor.will_oom(partition_bytes, pred)

    def _check_memory(self, caches, upto: int, step: int) -> None:
        self._note_iteration(caches, upto)
        if not (self.ecfg.predict and self.ecfg.partition_gb):
            return
        stats = self.accountant.history[-1]
        pred = self.predictor.observe(stats.requested_bytes,
                                      stats.reuse_ratio)
        if self._restart_now(self.ecfg.partition_gb * GB, pred):
            target = None
            if self.backend is not None:
                target = early_restart_target(self.backend,
                                              pred.peak_mem_bytes / GB)
            target = target or _synthetic_profile(pred.peak_mem_bytes / GB)
            wall_instant(self.tracer, SPAN + "restart", step=step,
                         peak_gib=pred.peak_mem_bytes / GB,
                         target=target.name)
            raise NeedsLargerPartition(target)


def _moe_rows(cfg: ModelConfig, batch: int, steps: int, kept: int
              ) -> dict[str, int]:
    """The decode steps' expert rows: those the requests routed (``kept``
    tokens decoded, k experts each, in every MoE layer) and those the
    captured step's capacity dispatch computed (every expert its capacity
    at one token a group, for each of the ``batch`` rows, every step);
    none without experts."""
    layers = registry.moe_layers(cfg)
    if not layers:
        return {}
    return {"moe_routed_rows": kept * cfg.top_k * layers,
            "moe_expert_rows": (steps * batch * capacity(cfg, 1)
                                * cfg.n_experts * layers)}


def _synthetic_profile(mem_gb: float) -> PartitionProfile:
    return PartitionProfile(name=f"needs-{mem_gb:.1f}gb", mem_gb=mem_gb,
                            compute_fraction=0.0)
