"""Paged-KV LLM serving: engine, executor and model programs."""

from .engine import InferenceEngine, PageAllocator, QueueFullError, Request
from .executor import (LocalEngineExecutor, resolve_attention_impl,
                       resolve_device)
from .tokenizer import ByteTokenizer
from .weights import pages_from_numpy, params_from_numpy

__all__ = ["ByteTokenizer", "InferenceEngine", "LocalEngineExecutor",
           "PageAllocator", "QueueFullError", "Request", "pages_from_numpy",
           "params_from_numpy", "resolve_attention_impl", "resolve_device"]
