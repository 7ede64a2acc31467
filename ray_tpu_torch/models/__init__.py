"""Model definitions: the Llama-3-family decoder and its routed-expert
(MoE) MLP."""

from .llama import (PRESETS, LlamaConfig, forward, forward_hidden,
                    init_params, loss_fn, param_axes, train_flops_per_token)

__all__ = ["LlamaConfig", "PRESETS", "forward", "forward_hidden",
           "init_params", "loss_fn", "param_axes", "train_flops_per_token"]
