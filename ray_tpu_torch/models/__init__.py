"""Model definitions."""

from .llama import (PRESETS, LlamaConfig, forward, forward_hidden,
                    init_params, loss_fn, train_flops_per_token)

__all__ = ["LlamaConfig", "PRESETS", "forward", "forward_hidden",
           "init_params", "loss_fn", "train_flops_per_token"]
