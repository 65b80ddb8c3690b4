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
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    return importlib.import_module(ARCH_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    return importlib.import_module(ARCH_MODULES[arch]).smoke()


ALL_ARCHS = list(ARCH_MODULES)

__all__ = ["ALL_ARCHS", "ModelConfig", "get_config", "get_smoke_config",
           "reduce_for_smoke"]
