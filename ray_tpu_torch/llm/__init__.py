"""Paged-KV LLM serving: engine, executor, model programs and speculative
decoding."""

from .engine import InferenceEngine, PageAllocator, QueueFullError, Request
from .executor import (LocalEngineExecutor, resolve_attention_impl,
                       resolve_device)
from .model import decode_step, init_pages, prefill_chunk
from .speculative import Drafter, NgramDrafter, SpeculationConfig
from .tokenizer import ByteTokenizer
from .weights import pages_from_numpy, params_from_numpy

__all__ = ["ByteTokenizer", "Drafter", "InferenceEngine",
           "LocalEngineExecutor", "NgramDrafter", "PageAllocator",
           "QueueFullError", "Request", "SpeculationConfig", "decode_step",
           "init_pages", "pages_from_numpy", "params_from_numpy",
           "prefill_chunk", "resolve_attention_impl", "resolve_device"]
