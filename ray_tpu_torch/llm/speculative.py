"""Speculative decoding: host-side drafting for the verify dispatch.

The port's own copy of ``ray_tpu/llm/speculative.py`` (it imports nothing
of the JAX package). Plain decode costs one target-model forward per
token. A cheap **drafter** proposes K tokens per active slot, then ONE
forward (``model.verify_block``) scores all K+1 positions of every slot
and accepts the longest prefix of the draft the target agrees with. The
output is lossless: greedy acceptance is exact argmax equality, and at
temperature > 0 rejection sampling keeps the target distribution.

The built-in drafter is model-free **n-gram / prompt-lookup
self-drafting**: the continuation of the longest recent n-gram that
already occurred earlier in the sequence is proposed verbatim. A draft
model slots in by implementing ``Drafter``; the engine only sees the
interface.
"""

from __future__ import annotations

from dataclasses import dataclass


class Drafter:
    """Proposes up to ``k`` continuation tokens for one sequence.

    ``tokens`` is the full token history (prompt + generated so far);
    the proposal is a guess at the NEXT ``k`` tokens. Returning fewer
    than ``k`` (or ``[]``) is always safe — the verify dispatch treats
    missing positions as auto-rejected padding, and a step with no
    drafts at all falls back to the plain fused decode burst."""

    def draft(self, tokens: list[int], k: int) -> list[int]:
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Prompt-lookup self-drafter: match the sequence's trailing n-gram
    (longest first, ``ngram_max`` down to ``ngram_min``) against its own
    earlier tokens and propose the continuation of the MOST RECENT
    earlier occurrence. Zero model cost; accuracy comes entirely from
    repetition in the traffic (multi-turn resends, retrieval quotes,
    structured output)."""

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1):
        self.ngram_max = max(1, ngram_max)
        self.ngram_min = max(1, min(ngram_min, self.ngram_max))

    def draft(self, tokens: list[int], k: int) -> list[int]:
        n_tok = len(tokens)
        if k <= 0 or n_tok < self.ngram_min + 1:
            return []
        for n in range(min(self.ngram_max, n_tok - 1), self.ngram_min - 1, -1):
            pattern = tokens[n_tok - n:]
            # Most recent earlier occurrence whose continuation exists:
            # scan right-to-left over starts j with j + n < n_tok.
            for j in range(n_tok - n - 1, -1, -1):
                if tokens[j:j + n] == pattern:
                    return list(tokens[j + n:j + n + k])
        return []


@dataclass
class SpeculationConfig:
    """Engine/serving knobs for speculative decoding.

    num_draft_tokens: K — drafted tokens verified per dispatch (the
        verify program scores K+1 positions; emitted tokens per dispatch
        range 1..K+1, so acceptance 0 still advances one token).
    drafter: ``"ngram"`` (the built-in self-drafter) or a ``Drafter``
        instance (e.g. a small draft model wrapper).
    ngram_max/ngram_min: n-gram lengths the lookup tries, longest first.
    """

    num_draft_tokens: int = 4
    drafter: object = "ngram"
    ngram_max: int = 3
    ngram_min: int = 1

    def __post_init__(self):
        self.num_draft_tokens = max(1, int(self.num_draft_tokens))

    @classmethod
    def normalize(cls, value) -> "SpeculationConfig | None":
        """None | dict | SpeculationConfig -> SpeculationConfig | None
        (what ``InferenceEngine(speculation_config=...)`` accepts)."""
        if value is None:
            return None
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(
            f"speculation_config must be None, a dict, or a "
            f"SpeculationConfig, got {type(value).__name__}")

    def build_drafter(self) -> Drafter:
        if isinstance(self.drafter, Drafter):
            return self.drafter
        if self.drafter == "ngram":
            return NgramDrafter(self.ngram_max, self.ngram_min)
        raise ValueError(f"unknown drafter {self.drafter!r} "
                         "(use 'ngram' or a Drafter instance)")
