"""Batch LLM inference over Data: the Processor pipeline.

Equivalent of the reference's
``python/ray/llm/_internal/batch/processor/base.py`` (``Processor`` /
``ProcessorConfig`` / ``build_llm_processor``): a composable stage
pipeline over a ``Dataset`` — preprocess → continuous-batching LLM
inference on stateful engine actors → postprocess. The inference stage
is a ``map_batches`` over an actor pool whose workers each own an
``InferenceEngine``; every batch's prompts are admitted TOGETHER so the
engine's continuous batching (shared decode steps, paged KV, prefix
reuse) applies within the batch — the reference gets this from vLLM.

The port of ``ray_tpu/llm/batch.py``. ``use_tpu`` has no meaning on the
card: the config takes ``device`` instead (``None``: the card, as every
port entry point), and on the card each engine actor holds a ``GPU``
lease of ``num_gpus``; ``device="cpu"`` takes no lease.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass
class LLMProcessorConfig:
    """Engine + stage settings (reference ``ProcessorConfig`` +
    ``vLLMEngineProcessorConfig``)."""

    preset: str = "debug-128"
    concurrency: int = 1          # engine actors in the pool
    batch_size: int = 16          # prompts per map_batches call
    max_slots: int = 8
    max_len: int = 256
    page_size: int = 16
    prefill_chunk_size: int = 64
    decode_steps_per_dispatch: int = 8
    # sampling defaults (overridable per-row via a "sampling_params" column)
    max_tokens: int = 32
    temperature: float = 0.0
    # Where each engine actor's engine runs (None: the card); on the card
    # the actor holds a GPU lease of num_gpus.
    device: str | None = None
    num_gpus: float = 1.0
    seed: int = 0

    def on_card(self) -> bool:
        return self.device is None or str(self.device).startswith("cuda")


class _EngineWorker:
    """One engine actor of the inference stage: constructed once per
    actor (model init + compile happen once), then every batch flows
    through continuous batching."""

    def __init__(self, config: LLMProcessorConfig):
        from .engine import InferenceEngine, Request
        from .tokenizer import ByteTokenizer

        self._Request = Request
        self.engine = InferenceEngine(
            config.preset,
            max_slots=config.max_slots,
            max_len=config.max_len,
            page_size=config.page_size,
            prefill_chunk_size=config.prefill_chunk_size,
            decode_steps_per_dispatch=config.decode_steps_per_dispatch,
            seed=config.seed,
            device=config.device,
        )
        self.tokenizer = ByteTokenizer()
        self.config = config
        self._counter = 0

    def __call__(self, batch: dict) -> dict:
        prompts = [str(p) for p in batch["prompt"]]
        max_tokens_col = batch.get("max_tokens")
        temp_col = batch.get("temperature")
        reqs = []
        for i, prompt in enumerate(prompts):
            self._counter += 1
            req = self._Request(
                f"batch-{self._counter}",
                self.tokenizer.encode(prompt),
                int(max_tokens_col[i]) if max_tokens_col is not None
                else self.config.max_tokens,
                float(temp_col[i]) if temp_col is not None
                else self.config.temperature,
                eos_id=self.tokenizer.eos_id,
            )
            reqs.append(req)
            self.engine.add_request(req)
        # Drive the shared continuous-batching loop until this batch is
        # fully decoded (other prompts keep the decode batch full).
        while not all(r.done for r in reqs):
            self.engine.step()
        out = dict(batch)
        out["generated_text"] = [self.tokenizer.decode(r.generated) for r in reqs]
        out["num_generated_tokens"] = [len(r.generated) for r in reqs]
        return out


class Processor:
    """A runnable pipeline: ``processor(ds)`` returns the transformed
    Dataset (reference ``Processor.__call__``)."""

    def __init__(self, config: LLMProcessorConfig,
                 preprocess: Callable | None = None,
                 postprocess: Callable | None = None):
        self.config = config
        self._pre = preprocess
        self._post = postprocess

    def __call__(self, ds):
        from ..data import ActorPoolStrategy

        if self._pre is not None:
            ds = ds.map(self._pre)
        ds = ds.map_batches(
            _EngineWorker,
            batch_format="numpy",
            compute=ActorPoolStrategy(size=self.config.concurrency),
            fn_constructor_args=(self.config,),
            ray_actor_options=(
                {"num_gpus": self.config.num_gpus}
                if self.config.on_card() else None),
        )
        if self._post is not None:
            ds = ds.map(self._post)
        return ds


def build_llm_processor(config: LLMProcessorConfig,
                        preprocess: Callable | None = None,
                        postprocess: Callable | None = None) -> Processor:
    """Reference ``build_llm_processor``: rows in, rows with
    ``generated_text`` out. ``preprocess`` maps a row to include a
    ``prompt`` (and optional ``sampling_params``); ``postprocess`` maps
    the generated row to its final shape."""
    return Processor(config, preprocess, postprocess)
