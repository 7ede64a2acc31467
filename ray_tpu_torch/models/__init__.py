"""Model definitions."""

from .llama import PRESETS, LlamaConfig, init_params

__all__ = ["LlamaConfig", "PRESETS", "init_params"]
