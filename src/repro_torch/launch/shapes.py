"""Input-shape presets and their ``meta`` tensors.

    train_4k     seq=4,096    global_batch=256   (training)
    prefill_32k  seq=32,768   global_batch=32    (inference-prefill)
    decode_32k   seq=32,768   global_batch=128   (inference-decode: ONE new
                                                  token, KV cache of seq)
    long_500k    seq=524,288  global_batch=1     (long-context decode;
                                                  sub-quadratic archs only)

The port's copy of the reference's ``repro/launch/shapes.py``; where the
reference builds ``jax.ShapeDtypeStruct`` stand-ins, these are tensors on
the ``meta`` device: shaped and typed, holding no memory.  Token ids are
int64, the port's index dtype.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry


@dataclasses.dataclass(frozen=True)
class ShapePreset:
    name: str
    kind: str            # train | prefill | decode
    seq: int
    batch: int
    long_context: bool = False
    microbatches: int = 8


SHAPES: dict[str, ShapePreset] = {
    "train_4k": ShapePreset("train_4k", "train", 4096, 256,
                            microbatches=8),
    "prefill_32k": ShapePreset("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapePreset("decode_32k", "decode", 32768, 128),
    "long_500k": ShapePreset("long_500k", "decode", 524288, 1,
                             long_context=True),
}


def applicable(cfg: ModelConfig, preset: ShapePreset) -> tuple[bool, str]:
    """(runs?, reason-if-skipped): long-context decode needs
    sub-quadratic attention."""
    if preset.long_context and not cfg.has_subquadratic_attention:
        return False, "pure full-attention arch: 500k decode excluded"
    return True, ""


def spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, preset: ShapePreset) -> dict:
    """``meta`` stand-ins for every model input of this preset."""
    b, s = preset.batch, preset.seq
    if preset.kind == "train":
        out = {"tokens": spec((b, s), torch.int64),
               "labels": spec((b, s), torch.int64)}
    elif preset.kind == "prefill":
        out = {"tokens": spec((b, s), torch.int64)}
    else:  # decode: ONE new token; the KV cache carries `seq` positions
        out = {"tokens": spec((b, 1), torch.int64)}
    if cfg.family == "audio" and preset.kind != "decode":
        # seq_len applies to the DECODER token stream; the encoder always
        # sees the model's native frame count (whisper: 1500)
        out["frames"] = spec((b, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm" and cfg.vision_tokens and preset.kind != "decode":
        out["patches"] = spec((b, cfg.vision_tokens, cfg.d_model),
                              torch.bfloat16)
    return out


def cache_shapes(cfg: ModelConfig, preset: ShapePreset) -> dict:
    """The decode caches at this preset's context, on ``meta``."""
    return registry.init_caches(cfg, preset.batch, preset.seq, device="meta")
