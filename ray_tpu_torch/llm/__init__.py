"""Paged-KV LLM serving: engine, executor, model programs, speculative
decoding, multi-LoRA serving, KV migration, the host tiers of KV pages
and weights, and request deadlines with the flight recorder and spans."""

from ..observability.loop_recorder import RequestTimeline
from .engine import InferenceEngine, PageAllocator, QueueFullError, Request
from .executor import (LocalEngineExecutor, resolve_attention_impl,
                       resolve_device)
from .lora import LoRAManager, LoRAServingConfig
from .migration import KVMigrationSource, receive_kv_stream
from .model import decode_step, init_pages, prefill_chunk, write_pages
from .speculative import Drafter, NgramDrafter, SpeculationConfig
from .tenancy import AdapterCapacityError
from .tokenizer import ByteTokenizer
from .weights import (WeightBroadcastSource, host_to_device,
                      pages_from_numpy, params_fingerprint,
                      params_from_numpy, receive_weight_stream, tree_bytes,
                      tree_to_host)

__all__ = ["AdapterCapacityError", "ByteTokenizer", "Drafter",
           "InferenceEngine", "KVMigrationSource", "LoRAManager",
           "LoRAServingConfig", "LocalEngineExecutor", "NgramDrafter",
           "PageAllocator", "QueueFullError", "Request", "RequestTimeline",
           "SpeculationConfig",
           "WeightBroadcastSource", "decode_step", "host_to_device",
           "init_pages", "pages_from_numpy", "params_fingerprint",
           "params_from_numpy", "prefill_chunk", "receive_kv_stream",
           "receive_weight_stream", "resolve_attention_impl",
           "resolve_device", "tree_bytes", "tree_to_host", "write_pages"]
