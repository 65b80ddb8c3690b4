"""Architecture configs the port supports (one module per arch, cited)."""
import importlib

from repro_torch.configs.base import ModelConfig, reduce_for_smoke

ARCH_MODULES = {
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b",
}


#: configurations the port runs that the reference has not; kept out of
#: ALL_ARCHS, which the parity tests against the reference walk
PORT_ARCH_MODULES = {
    "granite-4.0-h-small": "repro_torch.configs.granite_4_0_h_small",
}


def _module(arch: str):
    modules = {**ARCH_MODULES, **PORT_ARCH_MODULES}
    if arch not in modules:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(modules)}")
    return importlib.import_module(modules[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


#: the reference's ten configurations
ALL_ARCHS = list(ARCH_MODULES)
#: every configuration the port serves
SERVED_ARCHS = ALL_ARCHS + list(PORT_ARCH_MODULES)

#: layers of the configs whose bf16 weights outgrow one 80 GB card at full
#: depth (grok-1-314b 588 GiB, llama4-maverick 739 GiB), cut so that they
#: fit, widths and expert counts as published; llama4's cut keeps its
#: dense/MoE interleave and its one global layer in four.  chip_smoke.py's
#: phase 4f and launch/profile_serve.py serve them at these depths.
ONE_CARD_LAYERS = {"grok-1-314b": 6, "llama4-maverick-400b-a17b": 4}

__all__ = ["ALL_ARCHS", "ModelConfig", "ONE_CARD_LAYERS", "SERVED_ARCHS",
           "get_config", "get_smoke_config", "reduce_for_smoke"]
