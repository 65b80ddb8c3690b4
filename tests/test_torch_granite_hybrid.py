"""IBM Granite 4.0-H Small, the port's hybrid MoE family
(``models/hybrid_moe.py``), against its plain float32 reference
(``tests/plain_granite_hybrid.py``, a copy of the benchmark's
``portbench/reference/granite_hybrid.py``).

On the CPU, at the smoke config's size, which keeps a whole period: five
Mamba2 layers and the attention layer at index 5, 8 experts top-2, the
shared expert and every published multiplier.  Float32 comparisons hold
two computations of one function in other orders of summation (1e-4).
The card tests (marked ``cuda``) hold the flash kernel's softmax scale
and the family's captured decode step.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
from pathlib import Path

import numpy as np
import plain_granite_hybrid as plain
import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.configs.granite_4_0_h_small import CONFIG, ONE_CARD
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import flash_mha
from repro_torch.kernels.ref import attention_ref
from repro_torch.launch import serve as serve_mod
from repro_torch.models import hybrid_moe, moe, registry
from repro_torch.models.layers import mlp
from repro_torch.models.module import cast_tree, param_count, tree_leaves
from repro_torch.obs.trace import Tracer
from repro_torch.serving.engine import (SPAN, EngineConfig, Request,
                                        ServeEngine)

ARCH = "granite-4.0-h-small"
ROOT = Path(__file__).resolve().parents[1]
#: two float32 computations of one function in other orders of summation
F32_TOL = 1e-4


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def smoke(**changes):
    """The smoke config (both kernels' switches as given) and its float32
    weights from the port's own initialiser."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **changes)
    params, _ = registry.init_params(torch.Generator().manual_seed(0), cfg)
    return cfg, cast_tree(params, torch.float32)


@pytest.fixture(scope="module")
def model():
    return smoke()


def model_block(cfg) -> dict:
    """The reference's view of a config (the benchmark's ``model`` block)."""
    return dataclasses.asdict(cfg)


# -- the configuration ------------------------------------------------------


def test_all_archs_stays_the_references_ten():
    from repro.configs import ALL_ARCHS as REF_ALL_ARCHS
    assert sorted(configs.ALL_ARCHS) == sorted(REF_ALL_ARCHS)
    assert ARCH not in configs.ALL_ARCHS
    assert configs.SERVED_ARCHS == configs.ALL_ARCHS + [ARCH]
    assert configs.get_config(ARCH) is CONFIG


def test_the_config_holds_the_published_widths():
    c = CONFIG
    assert (c.n_layers, c.d_model, c.vocab, c.norm_eps) == (40, 4096, 100352,
                                                            1e-5)
    assert (c.ssm_heads, c.ssm_state, c.ssm_expand, c.ssm_chunk,
            c.conv_width) == (128, 128, 2, 256, 4)
    assert (c.n_heads, c.n_kv_heads, c.head_dim) == (32, 8, 128)
    assert (c.n_experts, c.top_k, c.d_ff, c.shared_ff) == (72, 10, 768, 1536)
    assert (c.embedding_multiplier, c.residual_multiplier,
            c.attention_multiplier, c.logits_scaling, c.nope) == (
                12.0, 0.22, 1 / 128, 16.0, True)
    assert c.attn_layers == (5, 15, 25, 35) and c.tie_embeddings
    assert ONE_CARD == dataclasses.replace(CONFIG, n_layers=20)


@pytest.mark.parametrize("layers,attention", [(40, [5, 15, 25, 35]),
                                              (20, [5, 15]), (6, [5]),
                                              (3, [])])
def test_a_cut_in_depth_keeps_the_attention_layers_it_reaches(layers,
                                                              attention):
    cfg = dataclasses.replace(CONFIG, n_layers=layers)
    stacks = hybrid_moe.layer_stacks(cfg)
    assert [i for i, (kind, _) in enumerate(stacks)
            if kind == "attention"] == attention
    assert stacks == plain.layer_kinds(model_block(cfg))
    params, _ = registry.init_params(None, cfg, "meta")
    assert ("attention_layers" in params) == bool(attention)
    assert param_count(params) == plain.parameters(model_block(cfg))
    caches = registry.init_caches(cfg, 2, 16, "meta")
    assert set(caches) == ({"ssm", "k", "v"} if attention else {"ssm"})


def test_the_parameters_of_the_one_card_cut_and_the_whole_model():
    for cfg, want in ((ONE_CARD, 16_309_191_936), (CONFIG, 32_207_337_984)):
        params, _ = registry.init_params(None, cfg, "meta")
        assert param_count(params) == plain.parameters(model_block(cfg)) \
            == want


# -- the model against the plain reference ------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_matches_the_plain_reference(impl):
    """Both switches: the plain path, and the kernels' wrappers (their CPU
    versions, the flash one with the softmax scale 1/128 of the config's
    attention multiplier)."""
    cfg, w = smoke(attn_impl=impl, ssm_impl=impl)
    tokens = torch.randint(0, cfg.vocab, (2, 70),
                           generator=torch.Generator().manual_seed(1))
    want = registry.forward(w, cfg, {"tokens": tokens}).logits
    m = model_block(cfg)
    x = plain.hidden(w, m, tokens)
    got = plain.logits(w, m, x.reshape(-1, x.shape[-1]))
    assert rel(got, want[..., :cfg.vocab].reshape(got.shape)) < F32_TOL


def _serve(cfg, w, tracer=None):
    """Three ragged prompts, right-padded to 33, served through the
    engine; (requests, the prefill's logits, the engine)."""
    rng = np.random.default_rng(4)
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32), k)
            for i, (n, k) in enumerate([(9, 6), (33, 4), (21, 8)])]
    engine = ServeEngine(cfg, w, EngineConfig(max_batch=3, max_context=48,
                                              predict=False),
                         device="cpu", tracer=tracer)
    seen = []
    prefill = registry.prefill_caches

    def keep(*args):
        out = prefill(*args)
        seen.append(out[0])
        return out

    registry.prefill_caches = keep
    try:
        engine.run(reqs)
    finally:
        registry.prefill_caches = prefill
    return reqs, seen[0], engine


def test_served_tokens_lie_on_the_references_best():
    """The engine's prefill and decode through the mixed cache (Mamba2
    conv and state, the attention layer's K/V) on ragged prompts: every
    chosen token (the prefill's first and each returned one) is the
    reference's best for its row but for rounding."""
    cfg, w = smoke(attn_impl="pallas", ssm_impl="pallas")
    reqs, prefill_logits, _ = _serve(cfg, w)
    m = model_block(cfg)
    first = prefill_logits[:, -1, :cfg.vocab].argmax(-1).tolist()
    for f, r in zip(first, reqs):
        chosen = [f] + r.generated
        row = np.zeros(33 + len(chosen) - 1, np.int64)
        row[:len(r.prompt)] = r.prompt
        row[33:] = chosen[:-1]
        x = plain.hidden(w, m, torch.from_numpy(row)[None])[0]
        logits = plain.logits(w, m, x[32:])
        gaps = logits.max(-1).values - logits[torch.arange(len(chosen)),
                                              chosen]
        assert float(gaps.max()) < F32_TOL
    assert [len(r.generated) for r in reqs] == [6, 4, 8]


@pytest.mark.parametrize("capacity_moe", [False, True])
def test_decode_through_the_cache_matches_the_forward(model, capacity_moe):
    """The prefill of 11 tokens, then 9 decode steps with a tensor
    position, routed token by token or by the capacity dispatch at one
    token a group, against the full forward's logits at each position."""
    cfg, w = model
    tokens = torch.randint(0, cfg.vocab, (2, 20),
                           generator=torch.Generator().manual_seed(2))
    want = registry.forward(w, cfg, {"tokens": tokens}).logits
    caches = registry.init_caches(cfg, 2, 24)
    got, _ = registry.prefill_caches(w, cfg, tokens[:, :11], caches)
    steps = [got]
    for pos in range(11, 20):
        logits, _ = registry.decode_step(
            w, cfg, tokens[:, pos:pos + 1], torch.tensor(pos), caches,
            capacity_moe=capacity_moe)
        steps.append(logits)
    assert rel(torch.cat(steps, dim=1), want[:, 10:]) < F32_TOL


def _per_token_ffn(fp, sp, h, k):
    """GraniteMoe's FFN written token by token: a softmax over the token's
    top-k router logits weights its experts, then the shared expert."""
    out = []
    for x in h.reshape(-1, h.shape[-1]):
        top, experts = (x @ fp["router"]).topk(k)
        y = sum(g * (F.silu(x @ fp["w_gate"][e]) * (x @ fp["w_up"][e]))
                @ fp["w_down"][e]
                for g, e in zip(torch.softmax(top, -1), experts.tolist()))
        out.append(y + (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"]))
                   @ sp["w_down"])
    return torch.stack(out).reshape(h.shape)


def test_routed_and_shared_ffn_match_a_per_token_loop(model):
    """Both of the port's dispatches of a layer's MoE, plus its shared
    expert, against the loop; the capacity dispatch at one token a group
    (the captured decode step's) drops nothing."""
    cfg, w = model
    fp = {k: v[3] for k, v in w["moe_layers"].items()}
    sp = {k: v[3] for k, v in w["shared_mlp"].items()}
    h = torch.randn(2, 7, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    want = _per_token_ffn(fp, sp, h, cfg.top_k)
    shared = mlp(sp, h, cfg)
    assert rel(moe.moe_tokens(fp, h, cfg) + shared, want) < F32_TOL
    for row in h.reshape(-1, 1, 1, cfg.d_model):
        got = moe.moe_layer(fp, row, cfg)[0] + mlp(sp, row, cfg)
        assert rel(got, _per_token_ffn(fp, sp, row, cfg.top_k)) < F32_TOL


def test_the_two_reference_copies_are_equal(model):
    """The benchmark's reference and this copy: the same source, and the
    same logits on the same weights."""
    bench = importlib.import_module("portbench.reference.granite_hybrid")
    assert Path(bench.__file__).read_text() == Path(
        plain.__file__).read_text()
    cfg, w = model
    m = model_block(cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(5))
    assert torch.equal(bench.logits(w, m, bench.hidden(w, m, tokens)[0]),
                       plain.logits(w, m, plain.hidden(w, m, tokens)[0]))
    assert bench.request_flops(m, 9, 4) == plain.request_flops(m, 9, 4)


def test_request_flops_count_each_position_once():
    m = model_block(ONE_CARD)
    assert plain.request_flops(m, 1, 0) == (plain.token_flops(m)
                                            + 2 * 4 * 128 * 32
                                            + plain.head_flops(m))
    # a prompt of 3 and 2 returned tokens: 5 positions, 15 visible pairs
    assert plain.request_flops(m, 3, 2) == (
        5 * plain.token_flops(m) + 2 * 4 * 128 * 32 * 15
        + 3 * plain.head_flops(m))
    assert plain.ssd_shape(m) == (18, 128, 64, 128)
    assert plain.attention_shape(m) == (2, 32, 8, 128)


# -- the engine's accounting, spans and counters --------------------------------


def test_the_engine_counts_the_state_whole_and_the_kv_as_it_grows(model):
    """The accountant's live bytes after the prefill and the first decode
    step (positions 0-32 of 48 written) and after the second (0-33): the
    params, every Mamba2 state and conv window, and the attention K/V's
    used share."""
    cfg, w = model
    reqs, _, engine = _serve(cfg, w)
    caches = registry.init_caches(cfg, 3, 48)
    fixed = sum(t.numel() * t.element_size()
                for t in tree_leaves(caches["ssm"]))
    kv = sum(t.numel() * t.element_size() for t in (caches["k"],
                                                   caches["v"]))
    act = engine._params_bytes * 0.002 + 4 * cfg.d_model * 1024
    for upto, stats in zip((33, 33, 34), engine.accountant.history):
        assert stats.in_use_bytes == pytest.approx(
            engine._params_bytes + fixed + kv * upto / 48 + act)


def test_counters_give_the_decode_steps_routed_and_computed_rows(model):
    cfg, w = model
    tracer = Tracer.wall()
    reqs, _, _ = _serve(cfg, w, tracer)
    counters = {r["name"][len(SPAN):]: r["value"] for r in tracer.records
                if r["type"] == "counter"}
    steps, b = 8, 3
    assert counters["moe_routed_rows"] == 18 * cfg.top_k * cfg.n_layers
    assert counters["moe_expert_rows"] == (steps * b * cfg.top_k
                                           * cfg.n_experts * cfg.n_layers)


def test_the_prefill_marks_each_moe_ffn_with_a_span(model):
    from torch.profiler import ProfilerActivity, profile
    cfg, w = model
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(cfg, w)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    prefill, = [(s, e) for n, s, e in events if n == SPAN + "prefill"]
    moe_spans = [(s, e) for n, s, e in events if n == hybrid_moe.MOE_SPAN]
    assert len(moe_spans) == cfg.n_layers
    assert all(prefill[0] <= s and e <= prefill[1] for s, e in moe_spans)


def test_serve_serves_the_smoke_config_and_prints_the_moe_rows(tmp_path,
                                                               capsys):
    path = tmp_path / "serve.jsonl"
    serve_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "2", "--max-new", "3", "--trace",
                    str(path)])
    out = capsys.readouterr().out
    line, = [x for x in out.splitlines() if x.startswith("[serve] trace:")]
    cfg = configs.get_smoke_config(ARCH)
    # two rows, 3 steps, 6 tokens kept
    assert (f"moe rows routed/computed {6 * cfg.top_k * cfg.n_layers}/"
            f"{3 * 2 * cfg.top_k * cfg.n_experts * cfg.n_layers}") in line


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    return torch.device("cuda")


def _qkv(b, s, h, kh, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, n, d),
                                                 dtype=np.float32)).to(dtype)
            for n in (h, kh, kh)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kh,d", [(2, 200, 32, 8, 128),
                                        (8, 512, 32, 8, 128)])
def test_sm90_flash_with_the_granite_scale_matches_plain(card, b, s, h, kh,
                                                         d):
    """The attention multiplier 1/128 in place of 1/sqrt(128), at Granite's
    head layout, on the sm90 route, within its tolerance (2e-2)."""
    q, k, v = (x.to(card) for x in _qkv(b, s, h, kh, d, torch.bfloat16, s))
    before = dict(fa.launches_by_route)
    out = flash_mha(q, k, v, causal=True, scale=1 / 128)
    torch.cuda.synchronize()
    assert fa.launches_by_route["sm90"] - before["sm90"] == 1
    ref = attention_ref(*(x.transpose(1, 2) for x in (q, k, v)),
                        causal=True, scale=1 / 128).transpose(1, 2)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    default = flash_mha(q, k, v, causal=True)
    assert not torch.equal(out, default)


#: SHA-256 of flash_mha's causal outputs before the scale argument existed:
#: both kernels built from the sources that preceded it and run on an NVIDIA
#: H100 80GB HBM3 (torch 2.11.0+cu128) on ``_qkv``'s inputs at seed 7;
#: (dtype, b, s, h, kh, d) -> digest.  Five cases take the sm90 route, three
#: the simt route.
DEFAULT_SCALE_DIGESTS = {
    ('bfloat16', 2, 200, 32, 8, 128):
        "0a4a812baef1742869c30f96af9a62bdb662bac90b6b1568369b80870c03556f",
    ('bfloat16', 8, 512, 16, 8, 128):
        "1ae519c1d5e40a98d1159d04fd8b0e64e12a8ea72c66e3903afdaec2e37ae5f1",
    ('bfloat16', 2, 200, 4, 2, 64):
        "cab5a8a62265eca6a985d127af67844c9f7ddc3261bf7a5d85eceb87e0935f20",
    ('bfloat16', 1, 256, 8, 1, 256):
        "697a4edda49924a70e6d09ca3bad6ff9b18112f47efd45d69856f6a73555b2b5",
    ('bfloat16', 2, 200, 32, 32, 112):
        "6d10fc362e9172773b0cdfa7ccdfc8e987a6568d30f20355c7f3f75ae8614c8d",
    ('float32', 2, 200, 32, 8, 128):
        "bb247dc328be971d55251bc096476f9275eab51d760578049c41bfb7701adcdb",
    ('float32', 2, 128, 4, 2, 64):
        "8d308eada48e889b82244433b1c90f411fab3a09cb55d0e9ea0b09692cfeb1a6",
    ('bfloat16', 2, 128, 4, 2, 32):
        "184405a2f2857ffd02c08af42d5f52a37d84ac9525c5932b5cd70ecfe3e039ca",
}


def _digest(x: torch.Tensor) -> str:
    return hashlib.sha256(x.contiguous().cpu().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("key", sorted(DEFAULT_SCALE_DIGESTS))
def test_the_default_scale_is_the_kernel_before_the_argument(card, key):
    """Without a scale both routes give, bit for bit, what they gave before
    the argument existed."""
    dtype, b, s, h, kh, d = key
    q, k, v = (x.to(card) for x in _qkv(b, s, h, kh, d,
                                        getattr(torch, dtype), 7))
    assert _digest(flash_mha(q, k, v, causal=True)) \
        == DEFAULT_SCALE_DIGESTS[key]


@pytest.mark.cuda
def test_the_captured_decode_step_equals_the_eager_step(card):
    """A bf16 cut with the attention layer (head dim 64, the sm90 flash
    route) and the state-update kernel: 6 prompt tokens prefilled into the
    graph's caches, then 10 steps replayed and run eagerly through the
    capacity dispatch on a copy of the caches: logits and every cache leaf
    equal bit for bit."""
    from repro_torch.serving.decode_graph import DecodeGraph
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH),
                              head_dim=64, attn_impl="pallas",
                              ssm_impl="pallas")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = cast_tree(registry.init_params(gen, cfg)[0], torch.bfloat16)
    tok = torch.randint(0, cfg.vocab, (2, 16), device=card,
                        generator=torch.Generator(device="cuda")
                        .manual_seed(1))
    with torch.inference_mode():
        graph = DecodeGraph(params, cfg, 2, 24, card)
        registry.prefill_caches(params, cfg, tok[:, :6], graph.caches)
        eager = registry.init_caches(cfg, 2, 24, card)
        for mine, theirs in zip(tree_leaves(eager),
                                tree_leaves(graph.caches)):
            mine.copy_(theirs)
        for pos in range(6, 16):
            t = tok[:, pos:pos + 1]
            got = graph.step(t, pos).clone()
            want, _ = registry.decode_step(params, cfg, t, pos, eager,
                                           capacity_moe=True)
            assert torch.equal(got, want), pos
    for mine, theirs in zip(tree_leaves(eager), tree_leaves(graph.caches)):
        assert torch.equal(mine, theirs)
