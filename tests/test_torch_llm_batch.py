"""Data batch inference in the port (``ray_tpu_torch.llm.batch``): the
JAX package's ``test_batch_llm_processor`` rows on a port cluster with
``device="cpu"`` (preprocess, the engine actor pool, postprocess; a
per-row ``max_tokens`` column honoured), each text equal to an
in-process port engine's with the same seed and prompts; and the
config's device rule: the card by default, a ``GPU`` lease of
``num_gpus`` on it, none on the CPU.
"""

import pytest
import torch  # noqa: F401  (read by the skipif condition)

import ray_tpu_torch as rt
from ray_tpu_torch import data as rd
from ray_tpu_torch.llm import (ByteTokenizer, InferenceEngine,
                               LLMProcessorConfig, build_llm_processor)
from ray_tpu_torch.llm.batch import _EngineWorker

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]


def test_batch_llm_processor_rows_and_texts():
    # defined here, so the workers get them by value (a test module's
    # functions are pickled by reference, and workers cannot import it)
    def _pre(row):
        return {"prompt": f"say {row['word']}",
                "max_tokens": 4 + (row["id"] % 3),
                "word": row["word"], "id": row["id"]}

    def _post(row):
        return {"word": row["word"], "text": row["generated_text"],
                "n": row["num_generated_tokens"]}

    config = LLMProcessorConfig(preset="debug-128", concurrency=1,
                                batch_size=8, max_slots=4, max_len=128,
                                max_tokens=6, device="cpu")
    rt.init(num_cpus=4)
    try:
        processor = build_llm_processor(config, preprocess=_pre,
                                        postprocess=_post)
        rows = [{"id": i, "word": w} for i, w in enumerate(WORDS)]
        out = processor(rd.from_items(rows, parallelism=2)).take_all()
    finally:
        rt.shutdown()
    assert len(out) == 6
    by_word = {r["word"]: r for r in out}
    assert set(by_word) == set(WORDS)
    eng = InferenceEngine("debug-128", max_slots=4, max_len=128,
                          page_size=config.page_size,
                          prefill_chunk_size=config.prefill_chunk_size,
                          decode_steps_per_dispatch=(
                              config.decode_steps_per_dispatch),
                          seed=config.seed, device="cpu")
    tok = ByteTokenizer()
    for i, w in enumerate(WORDS):
        assert by_word[w]["n"] == 4 + (i % 3)  # per-row max_tokens honored
        want = eng.generate(tok.encode(f"say {w}"), max_new_tokens=4 + i % 3)
        assert by_word[w]["text"] == tok.decode(want)


def test_config_defaults_to_the_card():
    config = LLMProcessorConfig()
    assert config.device is None and config.on_card()
    ds = rd.from_items([{"prompt": "x"}])
    op = build_llm_processor(config)(ds)._last_op
    assert op.ray_actor_options == {"num_gpus": 1.0}
    cpu = LLMProcessorConfig(device="cpu", num_gpus=0.5)
    assert build_llm_processor(cpu)(ds)._last_op.ray_actor_options is None
    assert LLMProcessorConfig(device="cuda:0", num_gpus=0.5).on_card()


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the behaviour without a CUDA device")
def test_engine_actor_raises_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _EngineWorker(LLMProcessorConfig())
